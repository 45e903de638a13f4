"""Synthetic textured-scene renderer with exact ground truth.

The port's own copy of the JAX package's utils/synthetic.py (numpy only; the
vocabulary-training corpus textures are left out), so the same seed gives the
same arrays in both packages: a procedurally textured 3D room rendered along
an exact camera trajectory, yielding grayscale images, dense depth maps and
ground-truth poses for ATE evaluation.
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


def orbit_trajectory(n_frames: int, radius: float = 0.55,
                     forward: float = 1.4, yaw_amp: float = 0.12,
                     frames_per_orbit: int = 120) -> np.ndarray:
    """Smooth exploratory camera path (world->cam poses Tcw [n, 4, 4]).

    Sideways arc + slight forward drift + yaw oscillation: enough parallax for
    triangulation and enough rotation to exercise orientation handling.
    frames_per_orbit sets the speed (~0.04 m/frame at the default radius,
    comparable to TUM handheld sequences at 30 fps).
    """
    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * i / frames_per_orbit
        # camera center in world
        c = np.array([radius * np.sin(a), 0.15 * np.sin(2 * a), forward + 0.3 * np.sin(a)])
        yaw = yaw_amp * np.sin(a)
        cy, sy = np.cos(yaw), np.sin(yaw)
        Rwc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rcw = Rwc.T
        tcw = -Rcw @ c
        T = np.eye(4)
        T[:3, :3] = Rcw
        T[:3, 3] = tcw
        poses.append(T)
    return np.stack(poses).astype(np.float32)


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


def circle_trajectory(
    n_frames: int,
    radius: float = 1.8,
    frames_per_rev: int = 160,
    center: np.ndarray | None = None,
    face_offset: float = 0.5,
) -> np.ndarray:
    """Camera driving a closed circle, facing `face_offset` radians OUTWARD
    of the tangent — the KITTI-00-style loop scenario: continuous forward
    translation with a lateral component relative to the view direction
    (parallax for mono init), each sector left behind and revisited exactly
    one revolution later.  Radius must clear the room's central panel
    cluster (~1.1 m half-extent).  Returns Tcw [n, 4, 4]."""
    if center is None:
        center = np.array([0.0, 0.0, 3.0])
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * i / frames_per_rev
        c = center + np.array([radius * np.sin(th), 0.0,
                               -radius * np.cos(th)])
        a = th + face_offset   # view yaw = tangent rotated outward
        z_axis = np.array([np.cos(a), 0.0, np.sin(a)])
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


def spin_trajectory(
    n_frames: int,
    center: np.ndarray | None = None,
    frames_per_rev: int = 72,
) -> np.ndarray:
    """Full in-place yaw rotation: the canonical loop-closure scenario
    (camera sees the room walls sector by sector and returns to the first
    view).  Returns Tcw [n, 4, 4]."""
    if center is None:
        center = np.array([0.0, 0.0, 1.3])
    poses = []
    for i in range(n_frames):
        yaw = 2 * np.pi * i / frames_per_rev
        cy, sy = np.cos(yaw), np.sin(yaw)
        Rwc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rcw = Rwc.T
        T = np.eye(4)
        T[:3, :3] = Rcw
        T[:3, 3] = -Rcw @ center
        poses.append(T)
    return np.stack(poses).astype(np.float32)


@dataclass
class SyntheticSequence:
    """A fully rendered sequence with ground truth."""

    images: np.ndarray       # [n, H, W] float32 grayscale
    depths: np.ndarray       # [n, H, W] float32 (0 = no depth)
    poses_gt: np.ndarray     # [n, 4, 4] Tcw
    K: np.ndarray            # [3, 3]
    timestamps: np.ndarray   # [n]
    right_images: np.ndarray | None = None  # stereo


def generate_sequence(
    n_frames: int = 30,
    width: int = 320,
    height: int = 240,
    fx: float = 260.0,
    seed: int = 0,
    stereo_baseline: float = 0.0,
    trajectory: np.ndarray | None = None,
) -> SyntheticSequence:
    rng = np.random.default_rng(seed)
    scene = make_room(rng)
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1.0]])
    poses = trajectory if trajectory is not None else lookat_trajectory(n_frames)
    n_frames = len(poses)
    imgs, deps, rights = [], [], []
    for i in range(n_frames):
        img, dep = scene.render(K, poses[i], width, height)
        imgs.append(img)
        deps.append(dep)
        if stereo_baseline > 0:
            # Right camera: shifted by +baseline along camera x axis.
            T_rl = np.eye(4)
            T_rl[0, 3] = -stereo_baseline
            img_r, _ = scene.render(K, T_rl @ poses[i], width, height)
            rights.append(img_r)
    return SyntheticSequence(
        images=np.stack(imgs),
        depths=np.stack(deps),
        poses_gt=np.asarray(poses, np.float32),
        K=K.astype(np.float32),
        timestamps=np.arange(n_frames, dtype=np.float64) / 30.0,
        right_images=np.stack(rights) if rights else None,
    )


def _rotvec(v) -> np.ndarray:
    """Rotation matrix of a rotation vector (Rodrigues)."""
    th = np.linalg.norm(v)
    if th < 1e-12:
        return np.eye(3)
    k = np.asarray(v) / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def euroc_like_sequence(n_frames: int, width: int, height: int, fx: float,
                        baseline: float, seed: int = 5,
                        rot_l=(0.004, -0.009, 0.003), rot_r=(-0.006, 0.007, -0.002)):
    """Synthetic EuRoC-style stereo: each raw eye is rendered with a small
    camera-frame rotation (the misalignment real rigs have, ~0.5 degrees by
    default), and the returned undistort-rectify maps rotate both eyes back
    into the ideal row-aligned pair, so a run on it pays the two remaps per
    frame of the reference's EuRoC preprocessing
    (Examples/Stereo/stereo_euroc.cc:45-80) with exact geometry.  Distortion
    coefficients are zero; the rotation is what makes the remap
    load-bearing.  Returns (SyntheticSequence of raw eyes at 20 fps,
    (mx_l, my_l, mx_r, my_r))."""
    from .rectify import init_undistort_rectify_map

    scene = make_room(np.random.default_rng(seed))
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1.0]])
    poses = lookat_trajectory(n_frames)
    R_l, R_r = _rotvec(rot_l), _rotvec(rot_r)
    T_l, T_r, T_rl = np.eye(4), np.eye(4), np.eye(4)
    T_l[:3, :3], T_r[:3, :3], T_rl[0, 3] = R_l, R_r, -baseline
    imgs_l = [scene.render(K, T_l @ poses[i], width, height)[0] for i in range(n_frames)]
    imgs_r = [scene.render(K, T_r @ T_rl @ poses[i], width, height)[0]
              for i in range(n_frames)]
    # the rectifying rotation maps raw camera coordinates to rectified ones:
    # x_raw = R_eye x_rect  =>  R = R_eye^T
    D = np.zeros(4)
    mxl, myl = init_undistort_rectify_map(K, D, R_l.T, K, width, height)
    mxr, myr = init_undistort_rectify_map(K, D, R_r.T, K, width, height)
    seq = SyntheticSequence(
        images=np.stack(imgs_l),
        depths=np.zeros((n_frames, height, width), np.float32),
        poses_gt=np.asarray(poses, np.float32),
        K=K.astype(np.float32),
        timestamps=np.arange(n_frames, dtype=np.float64) / 20.0,
        right_images=np.stack(imgs_r),
    )
    return seq, (mxl, myl, mxr, myr)
