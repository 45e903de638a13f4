"""Stereo undistort-rectify maps + remap (EuRoC stereo preprocessing).

The reference's EuRoC stereo example program builds per-camera
undistort-rectify maps once (cv::initUndistortRectifyMap from the LEFT.*/RIGHT.* K, D, R, P blocks
of EuRoC.yaml) and remaps every incoming pair before tracking
(reference Examples/Stereo/stereo_euroc.cc:45-80 region).  This module is the
same preprocessing built from the algorithm spec (radial-tangential model):

  for every RECTIFIED pixel (u, v):
      [x, y, w]   = (P[:3,:3] @ R)^-1 . [u, v, 1]
      (x, y)      = (x/w, y/w)                       # rectified normalized
      (xd, yd)    = radtan_distort(x, y; D)          # into the raw camera
      map_x[v,u]  = K00*xd + K02 ;  map_y[v,u] = K11*yd + K12

Maps are computed once on the host (numpy, double precision), identical in
role to the OpenCV call; the per-frame remap is a vectorized bilinear sample.

Counterpart of the JAX package's utils/rectify.py: the numpy half is a copy,
remap_bilinear_torch is the device-side twin of its remap_bilinear_jnp.
"""

from __future__ import annotations

import numpy as np
import torch


def radtan_distort(x: np.ndarray, y: np.ndarray, D: np.ndarray):
    """Plumb-bob distortion of normalized coords. D = [k1 k2 p1 p2 (k3)]."""
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if len(D) > 4 else 0.0
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def init_undistort_rectify_map(
    K: np.ndarray,       # [3,3] raw intrinsics
    D: np.ndarray,       # [4] or [5] distortion
    R: np.ndarray,       # [3,3] rectifying rotation (raw cam -> rectified)
    P: np.ndarray,       # [3,3] or [3,4] new (rectified) projection
    width: int,
    height: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (map_x, map_y) [H, W] float32 — source pixel for each
    rectified destination pixel (cv::initUndistortRectifyMap semantics)."""
    K = np.asarray(K, np.float64)
    D = np.asarray(D, np.float64).reshape(-1)
    R = np.asarray(R, np.float64)
    Pn = np.asarray(P, np.float64)[:3, :3]
    A_inv = np.linalg.inv(Pn @ R)

    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    ones = np.ones_like(u)
    xyw = np.einsum("ij,jhw->ihw", A_inv, np.stack([u, v, ones]))
    x = xyw[0] / xyw[2]
    y = xyw[1] / xyw[2]
    xd, yd = radtan_distort(x, y, D)
    map_x = K[0, 0] * xd + K[0, 1] * yd + K[0, 2]
    map_y = K[1, 1] * yd + K[1, 2]
    return map_x.astype(np.float32), map_y.astype(np.float32)


def remap_bilinear(image: np.ndarray, map_x: np.ndarray,
                   map_y: np.ndarray) -> np.ndarray:
    """Bilinear remap with zero border (cv::remap INTER_LINEAR parity)."""
    h, w = image.shape[:2]
    x0 = np.floor(map_x).astype(np.int64)
    y0 = np.floor(map_y).astype(np.int64)
    fx = (map_x - x0).astype(np.float32)
    fy = (map_y - y0).astype(np.float32)

    def sample(yy, xx):
        ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        val = image[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(ok, val, 0).astype(np.float32), ok

    v00, o00 = sample(y0, x0)
    v01, o01 = sample(y0, x0 + 1)
    v10, o10 = sample(y0 + 1, x0)
    v11, o11 = sample(y0 + 1, x0 + 1)
    out = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    any_ok = o00 | o01 | o10 | o11
    return np.where(any_ok, out, 0.0).astype(np.float32)


def remap_bilinear_torch(image: torch.Tensor, map_x: torch.Tensor,
                         map_y: torch.Tensor) -> torch.Tensor:
    """Device-side bilinear remap of [..., H, W] images through [H, W] maps:
    four clipped gathers, each zeroed outside the image, weighted in the
    order of remap_bilinear.  Written out rather than through grid_sample,
    whose coordinate normalization rounds differently: a last-ulp change in
    a pixel flips FAST tests at the threshold."""
    h, w = image.shape[-2:]
    x0f = torch.floor(map_x)
    y0f = torch.floor(map_y)
    fx = map_x - x0f
    fy = map_y - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    flat = image.reshape(*image.shape[:-2], h * w)

    def sample(yy, xx):
        ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        idx = torch.clamp(yy, 0, h - 1) * w + torch.clamp(xx, 0, w - 1)
        return torch.where(ok, flat[..., idx], 0.0)

    return (sample(y0, x0) * (1 - fx) * (1 - fy)
            + sample(y0, x0 + 1) * fx * (1 - fy)
            + sample(y0 + 1, x0) * (1 - fx) * fy
            + sample(y0 + 1, x0 + 1) * fx * fy)


class StereoRectifier:
    """Holds both cameras' maps; call .rectify(left, right) per pair."""

    def __init__(self, left: dict, right: dict, width: int, height: int):
        self.m1l, self.m2l = init_undistort_rectify_map(
            left["K"], left["D"], left["R"], left["P"], width, height)
        self.m1r, self.m2r = init_undistort_rectify_map(
            right["K"], right["D"], right["R"], right["P"], width, height)

    def rectify(self, img_l: np.ndarray, img_r: np.ndarray):
        return (remap_bilinear(img_l, self.m1l, self.m2l),
                remap_bilinear(img_r, self.m1r, self.m2r))


def _opencv_matrix(node) -> np.ndarray:
    if isinstance(node, dict) and "data" in node:
        return np.asarray(node["data"], np.float64).reshape(
            int(node["rows"]), int(node["cols"]))
    return np.asarray(node, np.float64)


def load_rectification_from_settings(path: str) -> "StereoRectifier | None":
    """Parse the LEFT.*/RIGHT.* rectification blocks of a reference-style
    stereo settings YAML (EuRoC.yaml).  Returns None if absent (pre-rectified
    datasets like KITTI)."""
    import yaml

    with open(path) as f:
        text = f.read().replace("%YAML:1.0", "").replace("!!opencv-matrix", "")
    data = yaml.safe_load(text) or {}
    keys = ["LEFT.K", "LEFT.D", "LEFT.R", "LEFT.P",
            "RIGHT.K", "RIGHT.D", "RIGHT.R", "RIGHT.P",
            "LEFT.width", "LEFT.height"]
    if not all(k in data for k in keys):
        return None
    left = {k: _opencv_matrix(data[f"LEFT.{k}"]) for k in ("K", "D", "R", "P")}
    right = {k: _opencv_matrix(data[f"RIGHT.{k}"]) for k in ("K", "D", "R", "P")}
    return StereoRectifier(left, right, int(data["LEFT.width"]),
                           int(data["LEFT.height"]))
