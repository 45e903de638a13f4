"""Headless visualization: frame overlays and top-down map renders.

The port's copy of the JAX package's utils/viewer.py (the reference's
Pangolin GUI stack, FrameDrawer.cc:54 DrawFrame keypoint overlay,
MapDrawer.cc:58-232 points/keyframes/graph, as pure-numpy image synthesis
with no GL dependency).  render_system reads a port System; save_png writes
with the standard library (zlib + struct), so it needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

GREEN = np.array([40, 220, 60], np.uint8)
BLUE = np.array([80, 140, 255], np.uint8)
RED = np.array([230, 60, 40], np.uint8)
WHITE = np.array([240, 240, 240], np.uint8)
YELLOW = np.array([250, 220, 40], np.uint8)


def draw_frame(image: np.ndarray, xy: np.ndarray, valid: np.ndarray,
               tracked: np.ndarray | None = None, size: int = 2) -> np.ndarray:
    """Keypoint overlay (reference FrameDrawer::DrawFrame): tracked points in
    green squares, untracked detections in blue.  Returns [H, W, 3] uint8."""
    h, w = image.shape
    canvas = np.repeat(np.clip(image, 0, 255).astype(np.uint8)[:, :, None], 3, axis=2)
    xs = xy[:, 0].astype(int)
    ys = xy[:, 1].astype(int)
    for i in np.nonzero(valid)[0]:
        x, y = xs[i], ys[i]
        if not (size <= x < w - size and size <= y < h - size):
            continue
        color = GREEN if (tracked is not None and tracked[i]) else BLUE
        canvas[y - size : y + size + 1, x - size] = color
        canvas[y - size : y + size + 1, x + size] = color
        canvas[y - size, x - size : x + size + 1] = color
        canvas[y + size, x - size : x + size + 1] = color
    return canvas


def _to_px(pts_xz, bounds, size):
    (x0, x1, z0, z1) = bounds
    sx = (size - 1) / max(x1 - x0, 1e-6)
    sz = (size - 1) / max(z1 - z0, 1e-6)
    s = min(sx, sz)
    px = ((pts_xz[:, 0] - x0) * s).astype(int)
    py = (size - 1 - (pts_xz[:, 1] - z0) * s).astype(int)
    return px, py


def draw_map_topdown(pt_pos: np.ndarray, pt_valid: np.ndarray,
                     kf_centers: np.ndarray, kf_valid: np.ndarray,
                     trajectory_centers: np.ndarray | None = None,
                     size: int = 512) -> np.ndarray:
    """Top-down (x-z plane) map view (reference MapDrawer::DrawMapPoints +
    DrawKeyFrames): map points white, keyframes red, trajectory yellow."""
    canvas = np.zeros((size, size, 3), np.uint8)
    pts = pt_pos[pt_valid]
    allxz = [pts[:, [0, 2]]] if len(pts) else []
    kfc = kf_centers[kf_valid]
    if len(kfc):
        allxz.append(kfc[:, [0, 2]])
    if trajectory_centers is not None and len(trajectory_centers):
        allxz.append(trajectory_centers[:, [0, 2]])
    if not allxz:
        return canvas
    cat = np.concatenate(allxz)
    pad = 0.5
    bounds = (cat[:, 0].min() - pad, cat[:, 0].max() + pad,
              cat[:, 1].min() - pad, cat[:, 1].max() + pad)

    if len(pts):
        px, py = _to_px(pts[:, [0, 2]], bounds, size)
        ok = (px >= 0) & (px < size) & (py >= 0) & (py < size)
        canvas[py[ok], px[ok]] = WHITE
    if trajectory_centers is not None and len(trajectory_centers):
        px, py = _to_px(trajectory_centers[:, [0, 2]], bounds, size)
        for i in range(len(px) - 1):
            n = max(abs(px[i + 1] - px[i]), abs(py[i + 1] - py[i]), 1)
            xs = np.linspace(px[i], px[i + 1], n + 1).astype(int)
            ys = np.linspace(py[i], py[i + 1], n + 1).astype(int)
            ok = (xs >= 0) & (xs < size) & (ys >= 0) & (ys < size)
            canvas[ys[ok], xs[ok]] = YELLOW
    if len(kfc):
        px, py = _to_px(kfc[:, [0, 2]], bounds, size)
        for x, y in zip(px, py):
            if 1 <= x < size - 1 and 1 <= y < size - 1:
                canvas[y - 1 : y + 2, x - 1 : x + 2] = RED
    return canvas


def render_system(slam) -> np.ndarray:
    """One-call top-down snapshot of a port System's map + trajectory."""
    from ..models import map_state as ms

    m = slam.map
    centers = ms.keyframe_positions(m).cpu().numpy()
    _, poses = slam.get_trajectory()
    traj_c = (
        -np.einsum("nij,ni->nj", poses[:, :3, :3], poses[:, :3, 3])
        if len(poses) else None
    )
    return draw_map_topdown(
        m.pt_pos.cpu().numpy(), m.pt_valid.cpu().numpy(),
        centers, m.kf_valid.cpu().numpy(), traj_c,
    )


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def save_png(path: str, image: np.ndarray) -> None:
    """Write [H, W] uint8 or uint16 grayscale, or [H, W, 3] uint8 RGB, as a
    PNG (no filter, one IDAT chunk; 16-bit samples big-endian as the format
    stores them)."""
    image = np.asarray(image)
    if image.ndim == 3 and image.shape[2] == 3 and image.dtype == np.uint8:
        color, depth, rows = 2, 8, image.reshape(image.shape[0], -1)
    elif image.ndim == 2 and image.dtype == np.uint8:
        color, depth, rows = 0, 8, image
    elif image.ndim == 2 and image.dtype == np.uint16:
        color, depth, rows = 0, 16, image.astype(">u2").view(np.uint8)
    else:
        raise ValueError(f"save_png: unsupported image {image.shape} {image.dtype}")
    h, w = image.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0 per row
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
