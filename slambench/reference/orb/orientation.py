"""Intensity-centroid keypoint orientation from dense moments (the dense
forms).

Counterpart of the JAX package's ops/orb/orientation.py (reference IC_Angle,
src/ORBextractor.cc:108-170): the patch moments m10 = sum(dx * I) and
m01 = sum(dy * I) over the radius-15 disc.  The extraction chain takes them
per keypoint from 48-px patches (sample.orient_and_describe); these forms
serve images smaller than a patch (extractor._stacked_features) and the
unbatched callers: angle_map as one 31x31 correlation, keypoint_angles from
rank-10 separable moment maps, keypoint_angles_slab as one gather and one
[N, 961] x [961, 2] product.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .common import from_numpy

HALF_PATCH = 15  # reference HALF_PATCH_SIZE (src/ORBextractor.cc:92)


def _circular_mask() -> np.ndarray:
    """Point-symmetric boolean disc of radius 15 (the reference's umax rows,
    src/ORBextractor.cc:579-608)."""
    d = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    return (d[None, :] ** 2 + d[:, None] ** 2) <= HALF_PATCH**2 + HALF_PATCH


_MASK = _circular_mask()
_DX = (np.arange(-HALF_PATCH, HALF_PATCH + 1)[None, :] * _MASK).astype(np.float32)
_DY = (np.arange(-HALF_PATCH, HALF_PATCH + 1)[:, None] * _MASK).astype(np.float32)


def _moment_arrays():
    return _DX, _DY


def moment_kernels(device):
    """The [31, 31] float32 x and y moment kernels on `device`."""
    return from_numpy(_moment_arrays, device=device)


def angle_map(image: torch.Tensor) -> torch.Tensor:
    """Dense orientation map [H, W] in radians for every pixel (zero-padded
    31x31 correlations, as the JAX package's "SAME" convolution)."""
    img4 = image[None, None]
    kx, ky = (k[None, None] for k in moment_kernels(image.device))
    m10 = torch.nn.functional.conv2d(img4, kx, padding=HALF_PATCH)[0, 0]
    m01 = torch.nn.functional.conv2d(img4, ky, padding=HALF_PATCH)[0, 0]
    return torch.atan2(m01, m10)


@functools.lru_cache(maxsize=None)
def _separable_factors(kernel_key: str, rank: int = 10):
    """SVD-separate the 31x31 moment kernel into `rank` (col, row) vector
    pairs; rank 10 reproduces the disc-masked kernels to ~1e-6 relative."""
    K = {"dx": _DX, "dy": _DY}[kernel_key].astype(np.float64)
    U, S, Vt = np.linalg.svd(K)
    cols = (U[:, :rank] * S[:rank]).astype(np.float32)   # [31, r]
    rows = Vt[:rank].astype(np.float32)                  # [r, 31]
    return cols, rows


@functools.lru_cache(maxsize=None)
def _band_matrix(n: int, vec: tuple) -> np.ndarray:
    """[n, n] banded matrix applying 1D correlation with `vec` (zero pad)."""
    v = np.asarray(vec, np.float64)
    r = len(v) // 2
    M = np.zeros((n, n), np.float64)
    for i in range(n):
        for dj, kv in zip(range(-r, r + 1), v):
            j = i + dj
            if 0 <= j < n:
                M[i, j] += kv
    return M.astype(np.float32)


def _moment_map(image: torch.Tensor, kernel_key: str) -> torch.Tensor:
    """Dense [H, W] patch moment as a sum of rank-1 terms, each two banded
    matmuls."""
    h, w = image.shape
    cols, rows = _separable_factors(kernel_key)
    out = torch.zeros((h, w), dtype=torch.float32, device=image.device)
    for r in range(cols.shape[1]):
        Bv = from_numpy(_band_matrix, h, tuple(cols[:, r].tolist()), device=image.device)
        Bh = from_numpy(_band_matrix, w, tuple(rows[r].tolist()), device=image.device)
        out = out + torch.matmul(torch.matmul(Bv, image), Bh.T)
    return out


def _disc_offsets(w: int) -> np.ndarray:
    """[961] int64 flat offsets of the 31x31 taps in a row of width w."""
    d = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    return (d[:, None] * w + d[None, :]).reshape(-1)


def _moment_columns() -> np.ndarray:
    return np.stack([_DX.reshape(-1), _DY.reshape(-1)], axis=-1)


def keypoint_angles_slab(slab: torch.Tensor, xy: torch.Tensor,
                         level: torch.Tensor) -> torch.Tensor:
    """Angles for keypoints across all slices of a [L, H0, W0] slab in one
    gather: xy [N, 2] slice-local integer positions, level [N] slice index.
    Keypoints keep a >= 16-px border and the disc radius is 15, so every tap
    of a valid keypoint lands inside its slice; an invalid row's taps are
    clamped to the slab (its angle is never read)."""
    L, h, w = slab.shape
    off = from_numpy(_disc_offsets, w, device=slab.device)
    xi = xy[:, 0].to(torch.int64)
    yi = xy[:, 1].to(torch.int64)
    base = level.to(torch.int64) * (h * w) + yi * w + xi
    lin = torch.clamp(base[:, None] + off[None, :], 0, slab.numel() - 1)
    patches = slab.reshape(-1)[lin]                                 # [N, 961]
    kern = from_numpy(_moment_columns, device=slab.device)          # [961, 2]
    m = torch.matmul(patches, kern)
    return torch.atan2(m[:, 1], m[:, 0])


def keypoint_angles(image: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Angles (radians) for keypoints at integer positions xy [N, 2] of an
    [H, W] image, read from the dense moment maps."""
    h, w = image.shape
    m10 = _moment_map(image, "dx")
    m01 = _moment_map(image, "dy")
    xi = torch.clamp(xy[:, 0].to(torch.int64), 0, w - 1)
    yi = torch.clamp(xy[:, 1].to(torch.int64), 0, h - 1)
    lin = yi * w + xi
    return torch.atan2(m01.reshape(-1)[lin], m10.reshape(-1)[lin])
