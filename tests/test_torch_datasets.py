"""Host IO of the PyTorch port against the JAX package: the dataset loaders,
the settings loader, the native decoder and its prefetcher, and the viewer's
PNG writer (mirrors tests/test_datasets.py and tests/test_native_io.py).

Everything here is exact: the same directories (written with PIL) give the
same arrays and timestamps in both packages, the same settings file the
same configuration fields, and the port's own build of csrc/slamio.cc
decodes every file as the JAX package's library does."""

import os
import pathlib

import numpy as np
import pytest
from PIL import Image

from self_commit_orb_slam2_tpu.utils import config_io as jconfig_io
from self_commit_orb_slam2_tpu.utils import datasets as jdatasets
from self_commit_orb_slam2_tpu.utils import native_io as jnative_io
from self_commit_orb_slam2_tpu.utils import rectify as jrectify
from self_commit_orb_slam2_tpu_torch.utils import config_io, datasets, native_io, rectify, viewer

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _save_png(path, arr):
    Image.fromarray(arr).save(path)   # uint8: L, uint16: I;16, [H, W, 3] uint8: RGB


@pytest.fixture
def tum_dir(tmp_path, rng):
    root = tmp_path / "tum"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb_lines, dep_lines = [], []
    for i in range(4):
        t = 1000.0 + i / 30.0
        _save_png(str(root / "rgb" / f"{t:.6f}.png"),
                  rng.integers(0, 255, (48, 64), dtype=np.uint8))
        _save_png(str(root / "depth" / f"{t + 0.005:.6f}.png"),
                  (rng.uniform(0.5, 4.0, (48, 64)) * 5000).astype(np.uint16))
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep_lines.append(f"{t + 0.005:.6f} depth/{t + 0.005:.6f}.png")
    rgb_lines.append("1000.500000 rgb/unpaired.png")   # no depth within 20 ms: dropped
    (root / "rgb.txt").write_text("# comment\n" + "\n".join(rgb_lines))
    (root / "depth.txt").write_text("\n".join(dep_lines))
    return str(root)


@pytest.fixture
def kitti_dir(tmp_path, rng):
    root = tmp_path / "kitti" / "00"
    (root / "image_0").mkdir(parents=True)
    (root / "image_1").mkdir()
    for i in range(3):
        for d in ("image_0", "image_1"):
            _save_png(str(root / d / f"{i:06d}.png"),
                      rng.integers(0, 255, (37, 120), dtype=np.uint8))
    (root / "times.txt").write_text("\n".join(f"{i * 0.1:.6f}" for i in range(3)))
    (root / "calib.txt").write_text(
        "P0: 718.856 0 607.19 0 0 718.856 185.2 0 0 0 1 0\n"
        "P1: 718.856 0 607.19 -386.14 0 718.856 185.2 0 0 0 1 0\n")
    return str(root)


@pytest.fixture
def euroc_dir(tmp_path, rng):
    root = tmp_path / "euroc"
    for cam in ("cam0", "cam1"):
        (root / "mav0" / cam / "data").mkdir(parents=True)
        lines = ["#timestamp [ns],filename"]
        for i in range(3):
            ts = 1403636579763555584 + i * 50_000_000 + (1_000_000 if cam == "cam1" else 0)
            _save_png(str(root / "mav0" / cam / "data" / f"{ts}.png"),
                      rng.integers(0, 255, (30, 47), dtype=np.uint8))
            lines.append(f"{ts},{ts}.png")
        (root / "mav0" / cam / "data.csv").write_text("\n".join(lines))
    return str(root)


def _assert_frames_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for field in a.__dataclass_fields__:
        x, y = getattr(a, field), getattr(b, field)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, field
            np.testing.assert_array_equal(x, y, err_msg=field)
        else:
            assert x == y, field


@pytest.mark.parametrize("kind", ["tum", "kitti", "euroc"])
def test_loaders_match_jax(kind, tum_dir, kitti_dir, euroc_dir):
    root = {"tum": tum_dir, "kitti": kitti_dir, "euroc": euroc_dir}[kind]
    cls = {"tum": "TumRgbdDataset", "kitti": "KittiOdometryDataset",
           "euroc": "EurocDataset"}[kind]
    ours, theirs = getattr(datasets, cls)(root), getattr(jdatasets, cls)(root)
    assert len(ours) == len(theirs) == (4 if kind == "tum" else 3)
    for i in range(len(ours)):
        _assert_frames_equal(ours[i], theirs[i])
    if kind == "kitti":
        assert ours.camera_params == theirs.camera_params
        assert abs(ours.camera_params["bf"] - 386.14) < 1e-9
    if kind == "euroc":
        assert ours.pairs == theirs.pairs and ours[0].timestamp > 1.4e9
    if kind == "tum":
        assert [f.timestamp for f in ours] == [p[0] for p in theirs.pairs]
        assert 0.4 < np.median(ours[0].depth) < 4.2   # metres after / 5000


TUM1 = """%YAML:1.0
# Camera calibration and distortion parameters (OpenCV)
Camera.fx: 517.306408
Camera.fy: 516.469215
Camera.cx: 318.643040
Camera.cy: 255.313989
Camera.k1: 0.262383
Camera.k2: -0.953104
Camera.p1: -0.005358
Camera.p2: 0.002628
Camera.k3: 1.163314
Camera.width: 640
Camera.height: 480
Camera.fps: 30.0
Camera.bf: 40.0
Camera.RGB: 1
ThDepth: 40.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

KITTI00 = """%YAML:1.0
Camera.fx: 718.856
Camera.fy: 718.856
Camera.cx: 607.1928
Camera.cy: 185.2157
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 1241
Camera.height: 376
Camera.fps: 10.0
Camera.bf: 386.1448
Camera.RGB: 1
ThDepth: 35
ORBextractor.nFeatures: 2000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

EUROC = """%YAML:1.0
Camera.fx: 435.2046959714599
Camera.fy: 435.2046959714599
Camera.cx: 367.4517211914062
Camera.cy: 252.2008514404297
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 752
Camera.height: 480
Camera.fps: 20.0
Camera.bf: 47.90639384423901
ThDepth: 35
LEFT.height: 480
LEFT.width: 752
LEFT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
LEFT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0.0, 0.0, 1.0]
LEFT.R: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.999966347530033, -0.001422739138722922, 0.008079580483432283, 0.001365741834644127, 0.9999741760894847, 0.007055629199258132, -0.008089410156878961, -0.007044357138835809, 0.9999424675829176]
LEFT.P: !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, 0,  0, 435.2046959714599, 252.2008514404297, 0,  0, 0, 1, 0]
RIGHT.height: 480
RIGHT.width: 752
RIGHT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0]
RIGHT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [457.587, 0.0, 379.999, 0.0, 456.134, 255.238, 0.0, 0.0, 1]
RIGHT.R: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.9999633526194376, -0.003625811871560086, 0.007755443660172947, 0.003680398547259526, 0.9999684752771629, -0.007035845251224894, -0.007729688520722713, 0.007064130529506649, 0.999945173484644]
RIGHT.P: !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, -47.90639384423901, 0, 435.2046959714599, 252.2008514404297, 0, 0, 0, 1, 0]
ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _as_dict(nt):
    return {k: (_as_dict(v) if hasattr(v, "_asdict") else v) for k, v in nt._asdict().items()}


@pytest.mark.parametrize("name,text,sensor", [("TUM1", TUM1, "rgbd"), ("KITTI00", KITTI00, "stereo"),
                                              ("EuRoC", EUROC, "stereo"), ("none", None, "mono")])
def test_load_settings_matches_jax(tmp_path, name, text, sensor):
    path = None
    if text is not None:
        path = str(tmp_path / f"{name}.yaml")
        pathlib.Path(path).write_text(text)
    ours = config_io.load_settings(path, sensor=sensor)
    theirs = jconfig_io.load_settings(path, sensor=sensor)
    a, b = _as_dict(ours), _as_dict(theirs)
    b["orb"] = {k: v for k, v in b["orb"].items() if k in a["orb"]}   # the TPU-only switch
    assert a == b
    if name == "TUM1":
        assert ours.camera.has_distortion and ours.tracking.max_frames_between_kf == 30
        assert abs(ours.depth_map_factor - 1 / 5000.0) < 1e-12
    if name == "EuRoC":
        r_ours = rectify.load_rectification_from_settings(path)
        r_theirs = jrectify.load_rectification_from_settings(path)
        for f in ("m1l", "m2l", "m1r", "m2r"):
            np.testing.assert_array_equal(getattr(r_ours, f), getattr(r_theirs, f), err_msg=f)


def _write_image(tmp_path, kind, rng):
    if kind == "png8":
        arr = rng.integers(0, 255, (37, 53), dtype=np.uint8)
        _save_png(str(tmp_path / "g8.png"), arr)
        return str(tmp_path / "g8.png"), arr.astype(np.float32)
    if kind == "png16":
        arr = rng.integers(0, 65535, (24, 31), dtype=np.uint16)
        _save_png(str(tmp_path / "g16.png"), arr)
        return str(tmp_path / "g16.png"), arr.astype(np.float32)
    if kind == "rgb":
        arr = rng.integers(0, 255, (16, 20, 3), dtype=np.uint8)
        _save_png(str(tmp_path / "rgb.png"), arr)
        return str(tmp_path / "rgb.png"), None
    if kind == "pgm":
        arr = rng.integers(0, 255, (12, 17), dtype=np.uint8)
        p = str(tmp_path / "img.pgm")
        with open(p, "wb") as f:
            f.write(b"P5\n17 12\n255\n" + arr.tobytes())
        return p, arr.astype(np.float32)
    arr = rng.integers(0, 1000, (5, 7))      # ASCII 16-bit PGM with a comment
    p = str(tmp_path / "img2.pgm")
    with open(p, "w") as f:
        f.write("P2\n# a comment\n7 5\n65535\n" + " ".join(str(v) for v in arr.reshape(-1)))
    return p, arr.astype(np.float32)


@pytest.mark.parametrize("kind", ["png8", "png16", "rgb", "pgm", "pgm_ascii"])
def test_native_decoder_matches_jax(tmp_path, rng, kind):
    """The port's own build (in its _build/ directory) decodes every format
    exactly as the JAX package's library does."""
    assert native_io.available(), native_io.build_error
    assert pathlib.Path(native_io.library_path).parent == (
        ROOT / "self_commit_orb_slam2_tpu_torch" / "_build")
    path, want = _write_image(tmp_path, kind, rng)
    got = native_io.load_gray(path)
    assert got is not None and got.dtype == np.float32
    np.testing.assert_array_equal(got, jnative_io.load_gray(path))
    if want is not None:
        np.testing.assert_array_equal(got, want)
    assert native_io.load_gray(str(tmp_path / "missing.png")) is None


def test_decoder_counts_and_fallback(tmp_path, rng, monkeypatch):
    path, want = _write_image(tmp_path, "png8", rng)
    before = dict(datasets.DECODES)
    np.testing.assert_array_equal(datasets._load_gray(path), want)
    assert datasets.DECODES["native"] == before["native"] + 1
    monkeypatch.setattr(native_io, "load_gray", lambda p: None)   # no native library
    np.testing.assert_array_equal(datasets._load_gray(path), want)
    assert datasets.DECODES["pil"] == before["pil"] + 1


@pytest.mark.parametrize("capacity", [1, 2, 8])
def test_prefetcher_keeps_order(tmp_path, rng, capacity):
    paths, arrays = [], []
    for i in range(7):
        arr = rng.integers(0, 255, (10, 11 + i), dtype=np.uint8)
        paths.append(str(tmp_path / f"f{i}.png"))
        _save_png(paths[-1], arr)
        arrays.append(arr.astype(np.float32))
    pf = native_io.Prefetcher(paths, capacity=capacity)
    outs = list(pf)
    pf.close()
    assert len(outs) == len(arrays)
    for got, want in zip(outs, arrays):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb"])
def test_save_png_decodes_to_the_same_array(tmp_path, rng, kind):
    """The stdlib PNG writer: PIL and the native decoder read back the array."""
    arr = {"gray8": rng.integers(0, 255, (33, 41), dtype=np.uint8),
           "gray16": rng.integers(0, 65535, (33, 41), dtype=np.uint16),
           "rgb": rng.integers(0, 255, (33, 41, 3), dtype=np.uint8)}[kind]
    path = str(tmp_path / f"{kind}.png")
    viewer.save_png(path, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    if kind != "rgb":
        np.testing.assert_array_equal(native_io.load_gray(path), arr.astype(np.float32))
    with pytest.raises(ValueError):
        viewer.save_png(path, arr.astype(np.float32))
    assert os.path.getsize(path) > 0
