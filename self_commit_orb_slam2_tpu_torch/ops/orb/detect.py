"""Keypoint selection from 16-row band maxima: cell-wise top-1 with the
20 -> 7 threshold fallback, then the top cells of each slice.

Counterpart of the JAX package's ops/orb/detect.py::select_keypoints_bands
(the reference's quad-tree distribution, ORBextractor::DistributeOctTree,
src/ORBextractor.cc:706-1050, as one fixed-depth grid).  Tie order follows
jax.lax.top_k: equal responses keep the lowest cell index first, which a
stable descending sort gives (torch.topk promises no order among ties).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


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

    ncells = nby * ncx
    kmax = min(max(budgets), ncells)
    top, idx = torch.sort(best.reshape(G, ncells), dim=1, descending=True,
                          stable=True)
    top, idx = top[:, :kmax], idx[:, :kmax]
    x = torch.gather(x_all, 1, idx)
    y = torch.gather(y_all, 1, idx)

    g_np, r_np, live_np = _layout(tuple(int(b) for b in budgets), kmax)
    g = torch.from_numpy(g_np).to(dev)
    r = torch.from_numpy(r_np).to(dev)
    live = torch.from_numpy(live_np).to(dev)
    resp = torch.where(live, top[g, r], 0.0)
    return SlabKeypoints(
        xy=torch.stack([torch.where(live, x[g, r], 0.0),
                        torch.where(live, y[g, r], 0.0)], dim=-1),
        response=resp,
        level=g.to(torch.int32),
        valid=live & (resp > 0.0),
    )
