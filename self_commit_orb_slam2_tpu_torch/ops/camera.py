"""Pinhole camera model: projection, distortion, stereo, frustum.

Counterpart of the JAX package's ops/camera.py (reference Frame::isInFrustum,
UndistortKeyPoints, ComputeImageBounds and UnprojectStereo,
src/Frame.cc:608-706, :899-1023, :1464).  Everything is batched over points.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CameraParams(NamedTuple):
    """Camera intrinsics as plain Python floats (the settings-YAML block of
    reference src/Tracking.cc:93-218): fx fy cx cy, distortion k1 k2 p1 p2
    k3, stereo baseline*fx (`bf`), image size."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    p1: float
    p2: float
    k3: float
    bf: float
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, bf=0.0,
               width=640, height=480) -> "CameraParams":
        return CameraParams(float(fx), float(fy), float(cx), float(cy),
                            float(k1), float(k2), float(p1), float(p2),
                            float(k3), float(bf), int(width), int(height))

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    @property
    def K(self) -> torch.Tensor:
        """[3, 3] float32 intrinsic matrix (on the CPU)."""
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32)

    @property
    def has_distortion(self) -> bool:
        return abs(self.k1) + abs(self.k2) + abs(self.p1) + abs(self.p2) + abs(self.k3) > 0


def project(cam: CameraParams, pts_cam: torch.Tensor):
    """Camera-frame points [..., 3] -> (pixels [..., 2], depth [...]); no
    distortion (matching runs in the undistorted pixel domain)."""
    z = pts_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * pts_cam[..., 0] * inv_z + cam.cx
    v = cam.fy * pts_cam[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1), z


def project_stereo(cam: CameraParams, pts_cam: torch.Tensor):
    """Camera-frame points [..., 3] -> ((u, v, u_right) [..., 3], depth [...])
    with u_right = u - bf / z (the stereo observation model of g2o's
    EdgeStereoSE3ProjectXYZ)."""
    uv, z = project(cam, pts_cam)
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    ur = uv[..., 0] - cam.bf * inv_z
    return torch.cat([uv, ur[..., None]], dim=-1), z


def backproject(cam: CameraParams, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] + depth [...] -> camera-frame points [..., 3]."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def distort_normalized(cam: CameraParams, xn: torch.Tensor) -> torch.Tensor:
    """Radial-tangential distortion of normalized coords [..., 2]."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: CameraParams, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Undistort pixel coords [..., 2] by fixed-point iteration
    (cv::undistortPoints as used by Frame::UndistortKeyPoints)."""
    xd = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 * r2 * r2
        dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        inv_r = 1.0 / torch.clamp_min(radial, 1e-6)
        xn = torch.stack([(xd[..., 0] - dx) * inv_r, (xd[..., 1] - dy) * inv_r], dim=-1)
    return torch.stack([cam.fx * xn[..., 0] + cam.cx, cam.fy * xn[..., 1] + cam.cy], dim=-1)


def compute_image_bounds(cam: CameraParams) -> tuple[float, float, float, float]:
    """Undistorted image bounds (min_x, max_x, min_y, max_y) from the four
    undistorted corners (reference Frame::ComputeImageBounds,
    src/Frame.cc:967-1023); host floats."""
    corners = torch.tensor([[0.0, 0.0], [cam.width, 0.0], [0.0, cam.height],
                            [cam.width, cam.height]], dtype=torch.float32)
    und = undistort_points(cam, corners)
    return (float(torch.minimum(und[0, 0], und[2, 0])), float(torch.maximum(und[1, 0], und[3, 0])),
            float(torch.minimum(und[0, 1], und[1, 1])), float(torch.maximum(und[2, 1], und[3, 1])))


def in_frustum(cam: CameraParams, Tcw: torch.Tensor, pts_w: torch.Tensor,
               normals_w: torch.Tensor, min_dist: torch.Tensor,
               max_dist: torch.Tensor, bounds: tuple[float, float, float, float],
               view_cos_limit: float = 0.5):
    """Frustum + viewing-angle + distance-band check for map points.
    Returns (visible [N], uv [N, 2], dist [N], view_cos [N])."""
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    pc = pts_w @ R.T + t
    uv, z = project(cam, pc)
    min_x, max_x, min_y, max_y = bounds
    cam_center = -R.T @ t
    po = pts_w - cam_center
    dist = torch.linalg.norm(po, dim=-1)
    view_cos = torch.sum(po * normals_w, dim=-1) / torch.clamp_min(dist, 1e-9)
    ok = ((z > 0.0)
          & (uv[..., 0] >= min_x) & (uv[..., 0] <= max_x)
          & (uv[..., 1] >= min_y) & (uv[..., 1] <= max_y)
          & (dist >= min_dist) & (dist <= max_dist)
          & (view_cos > view_cos_limit))
    return ok, uv, dist, view_cos
