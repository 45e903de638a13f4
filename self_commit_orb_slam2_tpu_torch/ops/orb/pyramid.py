"""Image pyramid (reference ORBextractor::ComputePyramid, src/ORBextractor.cc:
1674-1734: 8 levels, scale 1.2, bilinear resize) and the separable Gaussian.

Counterpart of the JAX package's ops/orb/pyramid.py.  Each resize and each
blur is two banded fp32 matmuls (out = Rv @ img @ Rh^T) with the same
matrices; levels >= 1 differ from the JAX package in the last ulp only,
because the sums run in another order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import from_numpy


def level_shapes(height: int, width: int, n_levels: int, scale: float) -> list[tuple[int, int]]:
    shapes = []
    for lv in range(n_levels):
        inv = 1.0 / (scale ** lv)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] bilinear (half-pixel-centre) resampling matrix."""
    M = np.zeros((n_out, n_in), np.float64)
    s = n_in / n_out
    for i in range(n_out):
        x = (i + 0.5) * s - 0.5
        x = min(max(x, 0.0), n_in - 1.0)
        lo = int(np.floor(x))
        hi = min(lo + 1, n_in - 1)
        f = x - lo
        M[i, lo] += 1.0 - f
        M[i, hi] += f
    return M.astype(np.float32)


def resize_linear(image: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [..., H, W] via two banded matmuls."""
    h_in, w_in = image.shape[-2:]
    h_out, w_out = shape
    Rv = from_numpy(_resize_matrix, h_out, h_in, device=image.device)
    Rh = from_numpy(_resize_matrix, w_out, w_in, device=image.device)
    return torch.matmul(torch.matmul(Rv, image), Rh.T)


def build_pyramid(image: torch.Tensor, n_levels: int, scale: float) -> list[torch.Tensor]:
    """[..., H, W] float32 -> list of n_levels tensors, level 0 = input; each
    level is resized from the previous one (the reference's chained resize)."""
    h, w = image.shape[-2:]
    shapes = level_shapes(h, w, n_levels, scale)
    levels = [image]
    for lv in range(1, n_levels):
        levels.append(resize_linear(levels[-1], shapes[lv]))
    return levels


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _blur_matrix(n: int, ksize: int, sigma: float) -> np.ndarray:
    """[n, n] banded Gaussian with edge-replicate boundary folded in."""
    k = gaussian_kernel_1d(ksize, sigma).astype(np.float64)
    r = ksize // 2
    M = np.zeros((n, n), np.float64)
    for i in range(n):
        for dj, kv in zip(range(-r, r + 1), k):
            M[i, min(max(i + dj, 0), n - 1)] += kv
    return M.astype(np.float32)


def gaussian_blur(image: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian of [..., H, W] with replicate padding, as two
    banded matmuls.  The reference blurs each level with a 7x7 sigma=2
    Gaussian before computing descriptors (src/ORBextractor.cc:1629-1643,
    BORDER_REFLECT_101; edge-replicate here, as in the JAX package: the
    difference stays in the outer 3 px, inside the keypoint border)."""
    h, w = image.shape[-2:]
    Bv = from_numpy(_blur_matrix, h, ksize, sigma, device=image.device)
    Bh = from_numpy(_blur_matrix, w, ksize, sigma, device=image.device)
    return torch.matmul(torch.matmul(Bv, image), Bh.T)


def _pad_edge_to(level: torch.Tensor, H0: int, W0: int) -> torch.Tensor:
    """Edge-replicate pad [..., h, w] up to [..., H0, W0] (bottom/right)."""
    h, w = level.shape[-2:]
    if (h, w) == (H0, W0):
        return level
    ri = torch.clamp(torch.arange(H0, device=level.device), max=h - 1)
    ci = torch.clamp(torch.arange(W0, device=level.device), max=w - 1)
    return level[..., ri, :][..., ci]


def stack_slab(levels: list[torch.Tensor]) -> torch.Tensor:
    """List of [h, w] levels -> [L, H0, W0], each level edge-padded to
    level-0 size."""
    H0, W0 = levels[0].shape[-2:]
    return torch.stack([_pad_edge_to(l, H0, W0) for l in levels])


def stack_slab_batch(levels: list[torch.Tensor]) -> torch.Tensor:
    """List of [B, h, w] levels -> [B, L, H0, W0], each level edge-padded to
    level-0 size (FAST sees a uniform field in the padding)."""
    H0, W0 = levels[0].shape[-2:]
    return torch.stack([_pad_edge_to(l, H0, W0) for l in levels], dim=1)
