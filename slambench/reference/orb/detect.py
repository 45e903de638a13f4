"""Keypoint selection: cell-wise top-1 with the 20 -> 7 threshold fallback,
then the top cells of each slice.

Counterpart of the JAX package's ops/orb/detect.py (the reference's quad-tree
distribution, ORBextractor::DistributeOctTree, src/ORBextractor.cc:706-1050,
as one fixed-depth grid): select_keypoints_bands reads the 16-row band
maxima of the FAST band kernel (16x16 cells), select_keypoints_slab the full
score maps of the FAST NMS kernel (any cell size).  Tie order follows
jax.lax.top_k (indexing.top_k): equal responses keep the lowest cell index
first; a cell's argmax is its first maximal pixel in raster order, as jnp.argmax.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .common import constant, from_numpy
from .common import top_k


class LevelKeypoints(NamedTuple):
    xy: torch.Tensor        # [N, 2] float32 (x, y) in level-local pixel coords
    response: torch.Tensor  # [N] float32
    valid: torch.Tensor     # [N] bool


class SlabKeypoints(NamedTuple):
    """All slices' keypoints concatenated in per-slice budget order."""

    xy: torch.Tensor        # [N, 2] float32, level-LOCAL pixel coords
    response: torch.Tensor  # [N] float32
    level: torch.Tensor     # [N] int32 slice index
    valid: torch.Tensor     # [N] bool


@functools.lru_cache(maxsize=None)
def _layout(budgets: tuple, kmax: int):
    """Per output row: (slice, rank in the slice's top list, rank < kmax)."""
    g = np.repeat(np.arange(len(budgets)), budgets)
    starts = np.cumsum((0,) + budgets[:-1])
    rank = np.arange(sum(budgets)) - np.repeat(starts, budgets)
    return g, np.minimum(rank, kmax - 1), rank < kmax


def _top_cells(best: torch.Tensor, x_all: torch.Tensor, y_all: torch.Tensor,
               budgets: list[int]) -> SlabKeypoints:
    """Per slice, the top cells by response (lax.top_k order) laid out in
    per-slice budget order.  best, x_all, y_all: [G, ncells]."""
    kmax = min(max(budgets), best.shape[1])
    top, idx = top_k(best, kmax)
    x = torch.gather(x_all, 1, idx)
    y = torch.gather(y_all, 1, idx)

    dev = best.device
    g, r, live = from_numpy(_layout, tuple(int(b) for b in budgets), kmax, device=dev)
    resp = torch.where(live, top[g, r], 0.0)
    return SlabKeypoints(
        xy=torch.stack([torch.where(live, x[g, r], 0.0),
                        torch.where(live, y[g, r], 0.0)], dim=-1),
        response=resp,
        level=g.to(torch.int32),
        valid=live & (resp > 0.0),
    )


@functools.lru_cache(maxsize=8)
def _border_mask(G: int, H0: int, W0: int, dims: tuple, border: int,
                 device: torch.device) -> torch.Tensor:
    """[G, H0, W0] bool: inside slice g's own level dims minus `border`,
    built on the device once per shape (cached; callers only read it)."""
    d = constant(dims, torch.int64, device)                      # [G, 2]
    rows = torch.arange(H0, device=device)[None, :, None]
    cols = torch.arange(W0, device=device)[None, None, :]
    return ((rows >= border) & (rows < d[:, 0, None, None] - border)
            & (cols >= border) & (cols < d[:, 1, None, None] - border))


def select_keypoints_slab(score_hi: torch.Tensor, score_lo: torch.Tensor,
                          budgets: list[int], level_dims, cell: int = 16,
                          border: int = 16) -> SlabKeypoints:
    """Inputs are [G, H0, W0] NMS'd FAST scores, every slice padded to the
    slab size; level_dims gives each slice's own (h, w).  The border mask
    zeroes the padding and a `border` margin; slices are zero-padded to a
    multiple of the cell."""
    G, H0, W0 = score_hi.shape
    dims = tuple((int(h), int(w)) for h, w in level_dims)
    mask = _border_mask(G, H0, W0, dims, border, score_hi.device)
    ph = (-H0) % cell
    pw = (-W0) % cell
    ncy, ncx = (H0 + ph) // cell, (W0 + pw) // cell
    lane = torch.arange(cell * cell, dtype=torch.int32, device=score_hi.device)

    def per_cell(score):
        score = torch.nn.functional.pad(torch.where(mask, score, 0.0), (0, pw, 0, ph))
        flat = score.reshape(G, ncy, cell, ncx, cell).permute(0, 1, 3, 2, 4).reshape(
            G, ncy * ncx, cell * cell)
        best = flat.amax(-1)
        arg = torch.where(flat == best[..., None], lane, cell * cell).amin(-1)
        return best, arg

    hi_best, hi_arg = per_cell(score_hi)
    lo_best, lo_arg = per_cell(score_lo)
    use_hi = hi_best > 0.0
    best = torch.where(use_hi, hi_best, lo_best)        # [G, ncells]
    arg = torch.where(use_hi, hi_arg, lo_arg)
    ci = torch.arange(ncy * ncx, dtype=torch.int32, device=score_hi.device)
    y_all = ((ci // ncx) * cell + arg // cell).to(torch.float32)
    x_all = ((ci % ncx) * cell + arg % cell).to(torch.float32)
    return _top_cells(best, x_all, y_all, budgets)


def select_keypoints(score_hi: torch.Tensor, score_lo: torch.Tensor, n_keep: int,
                     cell: int = 16, border: int = 16) -> LevelKeypoints:
    """Up to n_keep spatially spread corners from one level's [H, W] NMS'd
    responses at thresholds 20 / 7 (reference iniThFAST / minThFAST,
    src/ORBextractor.cc:1104-1157): select_keypoints_slab on one slice."""
    kps = select_keypoints_slab(score_hi[None], score_lo[None], [n_keep],
                                [tuple(score_hi.shape)], cell=cell, border=border)
    return LevelKeypoints(xy=kps.xy, response=kps.response, valid=kps.valid)


def select_keypoints_bands(
    hi_max: torch.Tensor, hi_arg: torch.Tensor,
    lo_max: torch.Tensor, lo_arg: torch.Tensor,
    budgets: list[int], G: int, H0p: int,
) -> SlabKeypoints:
    """Inputs are [G*H0p//16, wp] band max/argrow per threshold, already
    border-masked by the band kernel; wp is a multiple of 16."""
    dev = hi_max.device
    nby = H0p // 16
    wp = hi_max.shape[1]
    ncx = wp // 16

    def cells(mx, ar):
        m4 = mx.reshape(G, nby, ncx, 16)
        best = m4.amax(-1)
        lane = torch.arange(16, dtype=torch.int32, device=dev)
        c16 = torch.where(m4 == best[..., None], lane, 16).amin(-1)  # first column
        rw = torch.gather(ar.reshape(G, nby, ncx, 16), 3,
                          c16[..., None].long())[..., 0]
        return best, c16, rw

    hb, hc, hrw = cells(hi_max, hi_arg)
    lb, lc, lrw = cells(lo_max, lo_arg)
    use_hi = hb > 0.0
    best = torch.where(use_hi, hb, lb)
    c16 = torch.where(use_hi, hc, lc)
    rw = torch.where(use_hi, hrw, lrw)

    band_i = torch.arange(nby, dtype=torch.int32, device=dev)[None, :, None]
    col_i = torch.arange(ncx, dtype=torch.int32, device=dev)[None, None, :]
    y_all = (band_i * 16 + rw).to(torch.float32).reshape(G, -1)
    x_all = (col_i * 16 + c16).to(torch.float32).reshape(G, -1)
    return _top_cells(best.reshape(G, -1), x_all, y_all, budgets)
