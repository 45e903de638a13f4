"""Per-keypoint orientation (intensity centroid) + rotated BRIEF.

Counterpart of the JAX package's ops/orb/sample.py::orient_and_describe
(reference IC_Angle and computeOrbDescriptor, src/ORBextractor.cc:108-230).
The JAX version resolves every sample position with one-hot matmuls shaped
for the TPU's matrix unit; here they are plain gathers that give the same
values.  Same patch geometry: a 48x48 patch per keypoint, the 7x7 sigma=2
Gaussian applied on the patch (edge-replicate at its border), moments over
the radius-15 disc of the raw patch, bit = blurred I(a) < I(b).

Descriptors are [N, 8] int32 words holding the bits of the JAX package's
uint32 words (torch.uint32 has almost no operators).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .common import from_numpy, stored
from .brief import pack_bits, rotated_pattern
from .orientation import HALF_PATCH, moment_kernels

PATCH = 48


@functools.lru_cache(maxsize=None)
def _patch_blur_matrix(ps: int, ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    """[ps, ps] banded separable Gaussian; out-of-range taps fold onto the
    edge element (replicate-pad semantics)."""
    half = ksize // 2
    k = np.exp(-0.5 * ((np.arange(ksize) - half) / sigma) ** 2)
    k /= k.sum()
    B = np.zeros((ps, ps), np.float32)
    for i in range(ps):
        for j in range(ksize):
            B[i, min(max(i - half + j, 0), ps - 1)] += k[j]
    return B


def _gather_patch(patch: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor) -> torch.Tensor:
    """patch[n, rows[n, i, j], cols[n, i, j]], zero where an index falls
    outside the patch (the one-hot selectors of the JAX version select
    nothing there)."""
    ps = patch.shape[-1]
    inside = (rows >= 0) & (rows < ps) & (cols >= 0) & (cols < ps)
    flat = (rows.clamp(0, ps - 1) * ps + cols.clamp(0, ps - 1)).reshape(rows.shape[0], -1)
    vals = torch.gather(patch.reshape(patch.shape[0], -1), 1, flat.long())
    return torch.where(inside, vals.reshape(rows.shape), 0.0)


def orient_and_describe(slab: torch.Tensor, xy: torch.Tensor,
                        level: torch.Tensor):
    """Angles [N] and descriptors [N, 8] int32 for all keypoints at once.

    slab: [L, H0, W0] padded pyramid stack; xy: [N, 2] level-LOCAL keypoint
    positions; level: [N] int32 slice index into the slab."""
    L, H0, W0 = slab.shape
    ps = PATCH
    if H0 < ps or W0 < ps:
        raise ValueError("image smaller than the sampling patch")
    dev = slab.device
    N = xy.shape[0]
    iota = torch.arange(ps, dtype=torch.int64, device=dev)

    r = ps // 2 - 2
    xi = xy[:, 0].to(torch.int64)
    yi = xy[:, 1].to(torch.int64)
    x0 = torch.clamp(xi - r, 0, W0 - ps)
    y0 = torch.clamp(yi - r, 0, H0 - ps)

    # raw patch [N, ps, ps] gathered straight from the slab
    rowidx = level.to(torch.int64)[:, None] * H0 + y0[:, None] + iota[None, :]
    colidx = x0[:, None] + iota[None, :]
    raw = slab.reshape(L * H0, W0)[rowidx[:, :, None], colidx[:, None, :]]

    Bm = from_numpy(_patch_blur_matrix, ps, device=dev)
    blur = stored(torch.matmul(torch.matmul(Bm, raw), Bm.T))

    # orientation: 31x31 disc moments from the raw patch
    d = torch.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=torch.int64, device=dev)
    oy = (yi - y0)[:, None] + d[None, :]
    ox = (xi - x0)[:, None] + d[None, :]
    p31 = _gather_patch(raw, oy[:, :, None].expand(N, 31, 31),
                        ox[:, None, :].expand(N, 31, 31))
    kx, ky = moment_kernels(dev)
    m10 = torch.sum(p31 * kx, dim=(1, 2))
    m01 = torch.sum(p31 * ky, dim=(1, 2))
    angle = torch.atan2(m01, m10)

    # rotated BRIEF from the blurred patch
    rx, ry = rotated_pattern(angle)
    lx = torch.clamp((xy[:, 0:1] + rx).to(torch.int64) - x0[:, None], 0, ps - 1)
    ly = torch.clamp((xy[:, 1:2] + ry).to(torch.int64) - y0[:, None], 0, ps - 1)
    samples = _gather_patch(blur, ly, lx)                   # [N, 512]
    return angle, pack_bits(samples)
