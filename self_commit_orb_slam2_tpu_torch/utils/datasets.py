"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV.

The port's copy of the JAX package's utils/datasets.py (host-side IO
mirroring the reference's Example drivers):
  * TUM RGB-D (reference Examples/RGB-D/rgbd_tum.cc + associate tooling):
    rgb.txt / depth.txt timestamp lists, nearest-timestamp association,
    DepthMapFactor scaling (5000 for TUM PNGs).
  * KITTI odometry (Examples/Stereo/stereo_kitti.cc): image_0/ image_1/
    grayscale sequences, times.txt, calib.txt P0/P1 projection rows.
  * EuRoC (Examples/Stereo/stereo_euroc.cc): mav0/camN/data + data.csv.

Images decode through the native library (utils/native_io.py) and fall back
to PIL where it cannot be built or cannot read the format; DECODES counts
the images each decoder read.  Everything yields float32 grayscale in
0..255 (16-bit sources keep their raw counts).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

# images decoded per decoder since the process started
DECODES = {"native": 0, "pil": 0}


def _load_gray(path: str) -> np.ndarray:
    # fast path: native C++ decoder (csrc/slamio.cc)
    from . import native_io

    arr = native_io.load_gray(path)
    if arr is not None:
        DECODES["native"] += 1
        return arr

    from PIL import Image

    img = Image.open(path)
    if img.mode not in ("L", "I", "I;16", "F"):
        img = img.convert("L")
    DECODES["pil"] += 1
    return np.asarray(img).astype(np.float32)


def _read_timestamp_file(path: str) -> list[tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


@dataclass
class RgbdFrame:
    timestamp: float
    image: np.ndarray   # [H, W] float32 grayscale 0..255
    depth: np.ndarray   # [H, W] float32 meters (0 = invalid)


class TumRgbdDataset:
    """TUM RGB-D sequence directory (rgb.txt + depth.txt + png folders)."""

    def __init__(self, root: str, max_dt: float = 0.02,
                 depth_factor: float = 5000.0):
        self.root = root
        self.depth_factor = depth_factor
        rgb = _read_timestamp_file(os.path.join(root, "rgb.txt"))
        dep = _read_timestamp_file(os.path.join(root, "depth.txt"))
        dep_ts = np.array([t for t, _ in dep])
        self.pairs: list[tuple[float, str, str]] = []
        for t, rgb_file in rgb:
            j = int(np.argmin(np.abs(dep_ts - t)))
            if abs(dep_ts[j] - t) <= max_dt:
                self.pairs.append((t, rgb_file, dep[j][1]))

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, i: int) -> RgbdFrame:
        t, rgb_file, dep_file = self.pairs[i]
        img = _load_gray(os.path.join(self.root, rgb_file))
        depth_raw = _load_gray(os.path.join(self.root, dep_file))
        return RgbdFrame(t, img, depth_raw / self.depth_factor)

    def __iter__(self) -> Iterator[RgbdFrame]:
        for i in range(len(self)):
            yield self[i]


@dataclass
class StereoFrame:
    timestamp: float
    left: np.ndarray
    right: np.ndarray


class KittiOdometryDataset:
    """KITTI odometry sequence dir (image_0/, image_1/, times.txt, calib.txt)."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "times.txt")) as f:
            self.times = [float(x) for x in f.read().split()]
        self.left_dir = os.path.join(root, "image_0")
        self.right_dir = os.path.join(root, "image_1")
        self.names = sorted(os.listdir(self.left_dir))
        self.calib = self._read_calib(os.path.join(root, "calib.txt"))

    @staticmethod
    def _read_calib(path: str) -> dict:
        out = {}
        if not os.path.exists(path):
            return out
        with open(path) as f:
            for line in f:
                if ":" in line:
                    key, vals = line.split(":", 1)
                    out[key.strip()] = np.array([float(v) for v in vals.split()]).reshape(3, 4)
        return out

    @property
    def camera_params(self) -> dict:
        """fx, fy, cx, cy, bf from P0/P1 (reference KITTIyy.yaml values)."""
        P0 = self.calib.get("P0")
        P1 = self.calib.get("P1")
        if P0 is None:
            return {}
        out = {"fx": P0[0, 0], "fy": P0[1, 1], "cx": P0[0, 2], "cy": P0[1, 2]}
        if P1 is not None:
            out["bf"] = -P1[0, 3]  # P1[0,3] = -fx * baseline
        return out

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, i: int) -> StereoFrame:
        name = self.names[i]
        return StereoFrame(
            self.times[i] if i < len(self.times) else float(i),
            _load_gray(os.path.join(self.left_dir, name)),
            _load_gray(os.path.join(self.right_dir, name)),
        )


class EurocDataset:
    """EuRoC MAV stereo (mav0/cam0/data + cam1/data + data.csv)."""

    def __init__(self, root: str, max_dt_ns: int = 2_000_000):
        self.root = root
        self.cam0 = self._read_csv(os.path.join(root, "mav0", "cam0", "data.csv"))
        self.cam1 = self._read_csv(os.path.join(root, "mav0", "cam1", "data.csv"))
        ts1 = np.array([t for t, _ in self.cam1], dtype=np.int64)
        self.pairs = []
        for t, f0 in self.cam0:
            j = int(np.argmin(np.abs(ts1 - t)))
            if abs(int(ts1[j]) - t) <= max_dt_ns:
                self.pairs.append((t, f0, self.cam1[j][1]))

    @staticmethod
    def _read_csv(path: str) -> list[tuple[int, str]]:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, name = line.split(",")[:2]
                out.append((int(ts), name.strip()))
        return out

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, i: int) -> StereoFrame:
        t, f0, f1 = self.pairs[i]
        return StereoFrame(
            t * 1e-9,
            _load_gray(os.path.join(self.root, "mav0", "cam0", "data", f0)),
            _load_gray(os.path.join(self.root, "mav0", "cam1", "data", f1)),
        )
