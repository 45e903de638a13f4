"""The synthetic room and the camera arc, frozen.

A copy of the port's utils/synthetic.py pieces that make a room from a seed
(`make_room`, `value_noise_texture`: numpy's generator, so a seed gives the
textures `generate_sequence(seed=...)` gives), the fr1_desk-style arc
(`lookat_trajectory`) and the numpy ray cast (`Scene.render`), which the
device cast in cast.py is held to.  Frozen here so that the benchmark's
inputs do not move when the program's copy changes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


def value_noise_texture(rng: np.random.Generator, size: int = 1024,
                        octaves: int = 5, sharp_features: int = 400) -> np.ndarray:
    """Band-limited value noise + random high-contrast rectangles/discs.

    The sharp features give FAST strong corners; the noise gives BRIEF
    discriminative local structure.  Returns [size, size] float32 in 0..255.
    """
    tex = np.zeros((size, size), np.float32)
    for o in range(octaves):
        n = 2 ** (o + 3)
        grid = rng.normal(size=(n, n)).astype(np.float32)
        # bilinear upsample to full resolution
        idx = np.linspace(0, n - 1, size)
        xi = np.clip(idx.astype(int), 0, n - 2)
        fx = idx - xi
        rows = grid[xi][:, xi] * (1 - fx)[None, :] + grid[xi][:, xi + 1] * fx[None, :]
        rows2 = grid[xi + 1][:, xi] * (1 - fx)[None, :] + grid[xi + 1][:, xi + 1] * fx[None, :]
        up = rows * (1 - fx)[:, None] + rows2 * fx[:, None]
        tex += up / (2**o)
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-9)

    # Sharp rectangles and discs (random contrast polarity).
    for _ in range(sharp_features):
        cx, cy = rng.integers(0, size, 2)
        wgt = rng.uniform(-0.7, 0.7)
        if rng.random() < 0.5:
            w, h = rng.integers(4, 40, 2)
            tex[cy : cy + h, cx : cx + w] = np.clip(tex[cy : cy + h, cx : cx + w] + wgt, 0, 1)
        else:
            r = int(rng.integers(3, 20))
            y0, y1 = max(cy - r, 0), min(cy + r + 1, size)
            x0, x1 = max(cx - r, 0), min(cx + r + 1, size)
            yy, xx = np.mgrid[y0:y1, x0:x1]
            m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            tex[y0:y1, x0:x1][m] = np.clip(tex[y0:y1, x0:x1][m] + wgt, 0, 1)
    return (tex * 255.0).astype(np.float32)


@dataclass
class Plane:
    """A textured rectangle: origin + two basis vectors spanning it."""

    origin: np.ndarray       # [3] world point = texture (0,0)
    u_axis: np.ndarray       # [3] world direction of texture u (unit * extent)
    v_axis: np.ndarray       # [3] world direction of texture v
    texture: np.ndarray      # [S, S] float32

    def normal(self) -> np.ndarray:
        n = np.cross(self.u_axis, self.v_axis)
        return n / np.linalg.norm(n)


@dataclass
class Scene:
    planes: Sequence[Plane]

    def render(self, K: np.ndarray, Tcw: np.ndarray,
               width: int, height: int) -> tuple[np.ndarray, np.ndarray]:
        """Render grayscale image + depth map from camera pose Tcw (world->cam).

        Inverse ray casting: per pixel, intersect the ray with every plane,
        keep the nearest hit inside its rectangle, bilinear-sample its texture.
        """
        R = Tcw[:3, :3]
        t = Tcw[:3, 3]
        cam_center = -R.T @ t
        xs, ys = np.meshgrid(np.arange(width), np.arange(height))
        rays_cam = np.stack(
            [(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs, np.float64)],
            axis=-1,
        )
        rays_w = rays_cam @ R  # R^T applied to each ray: (R.T @ r) = r @ R
        img = np.zeros((height, width), np.float32)
        depth = np.full((height, width), np.inf, np.float32)
        for plane in self.planes:
            n = plane.normal()
            denom = rays_w @ n
            denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            lam = ((plane.origin - cam_center) @ n) / denom
            pts = cam_center + lam[..., None] * rays_w  # [H, W, 3]
            rel = pts - plane.origin
            ulen2 = plane.u_axis @ plane.u_axis
            vlen2 = plane.v_axis @ plane.v_axis
            u = (rel @ plane.u_axis) / ulen2
            v = (rel @ plane.v_axis) / vlen2
            z_cam = pts @ R[2] + t[2]  # depth along optical axis
            hit = (lam > 0.05) & (u >= 0) & (u < 1) & (v >= 0) & (v < 1) & (z_cam > 0)
            closer = hit & (z_cam < depth)
            s = plane.texture.shape[0]
            tu = np.clip(u * (s - 1), 0, s - 1.0001)
            tv = np.clip(v * (s - 1), 0, s - 1.0001)
            iu, iv = tu.astype(int), tv.astype(int)
            fu, fv = tu - iu, tv - iv
            tex = plane.texture
            val = (
                tex[iv, iu] * (1 - fu) * (1 - fv)
                + tex[iv, iu + 1] * fu * (1 - fv)
                + tex[iv + 1, iu] * (1 - fu) * fv
                + tex[iv + 1, iu + 1] * fu * fv
            )
            img = np.where(closer, val.astype(np.float32), img)
            depth = np.where(closer, z_cam.astype(np.float32), depth)
        depth = np.where(np.isinf(depth), 0.0, depth)
        return img, depth


def make_room(rng: np.random.Generator, size: float = 6.0,
              tex_size: int = 768) -> Scene:
    """A box room: back wall + two side walls + floor + ceiling, each textured."""
    s = size

    def tex():
        return value_noise_texture(rng, tex_size, sharp_features=300)

    planes = [
        # back wall at z = s, spanning x,y in [-s/2, s/2] (world z forward)
        Plane(np.array([-s / 2, -s / 2, s]), np.array([s, 0, 0.0]), np.array([0, s, 0.0]), tex()),
        # left wall x = -s/2
        Plane(np.array([-s / 2, -s / 2, 0.0]), np.array([0, 0, s]), np.array([0, s, 0.0]), tex()),
        # right wall x = +s/2
        Plane(np.array([s / 2, -s / 2, 0.0]), np.array([0, 0, s]), np.array([0, s, 0.0]), tex()),
        # floor y = +s/2 (y down convention: floor below camera)
        Plane(np.array([-s / 2, s / 2, 0.0]), np.array([s, 0, 0.0]), np.array([0, 0, s]), tex()),
        # ceiling y = -s/2
        Plane(np.array([-s / 2, -s / 2, 0.0]), np.array([s, 0, 0.0]), np.array([0, 0, s]), tex()),
    ]
    # front wall at z = 0 closes the box (visible when orbiting behind the
    # cluster)
    planes.append(
        Plane(np.array([-s / 2, -s / 2, 0.0]), np.array([s, 0, 0.0]),
              np.array([0, s, 0.0]), tex())
    )

    # A 3D cluster of tilted textured panels around (0, 0, s/2): the "desk".
    # Rich structure with real depth diversity at the scene center — the
    # look-at trajectories orbit this cluster the way TUM fr1_desk orbits a
    # desk.  A narrow depth band would make lateral translation vs yaw
    # unobservable for any SLAM system.
    cz = s / 2
    panel_specs = [
        (np.array([-0.9, -0.5, cz + 0.3]), 0.9, 0.35),
        (np.array([0.2, -0.4, cz - 0.5]), 0.8, -0.3),
        (np.array([-0.3, 0.0, cz + 0.7]), 1.1, 0.15),
        (np.array([0.6, -0.1, cz + 0.1]), 0.7, 0.5),
        (np.array([-0.8, 0.3, cz - 0.3]), 0.8, -0.45),
        (np.array([0.1, 0.35, cz + 0.4]), 0.9, 0.25),
        (np.array([-0.2, -0.9, cz]), 1.0, -0.15),
    ]
    for origin, extent, tilt in panel_specs:
        u = np.array([np.cos(tilt), 0.0, np.sin(tilt)]) * extent
        v = np.array([0.0, np.cos(tilt * 0.5), np.sin(tilt * 0.5)]) * extent
        planes.append(Plane(origin, u, v, tex()))
    return Scene(planes)


def lookat_trajectory(
    n_frames: int,
    target: np.ndarray | None = None,
    radius: float = 2.0,
    sweep: float = 0.7,
    frames_per_cycle: int = 160,
    height_amp: float = 0.25,
) -> np.ndarray:
    """Arc orbit around a target, camera always facing it (fr1_desk-style).

    The camera swings on a +-`sweep`-radian arc of radius `radius` around
    `target` with a gentle vertical bob, giving continuous parallax on the
    cluster while keeping it framed.  Returns Tcw [n, 4, 4].
    """
    if target is None:
        target = np.array([0.0, 0.0, 3.0])
    poses = []
    for i in range(n_frames):
        ph = 2 * np.pi * i / frames_per_cycle
        th = sweep * np.sin(ph)
        c = target + np.array(
            [radius * np.sin(th), height_amp * np.sin(2 * ph), -radius * np.cos(th)]
        )
        z_axis = target - c
        z_axis = z_axis / np.linalg.norm(z_axis)
        x_axis = np.cross(np.array([0.0, 1.0, 0.0]), z_axis)
        x_axis = x_axis / np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        Rwc = np.stack([x_axis, y_axis, z_axis], axis=1)
        Rcw = Rwc.T
        T = np.eye(4)
        T[:3, :3] = Rcw
        T[:3, 3] = -Rcw @ c
        poses.append(T)
    return np.stack(poses).astype(np.float32)
