"""Masked matching primitives: window/level masks, best match with ratio
test, mutual best match, rotation-consistency histogram.

Counterpart of the JAX package's ops/matching/core.py (reference
src/ORBmatcher.cc: TH_HIGH/TH_LOW, the 30-bin rotation histogram with
ComputeThreeMaxima).  Argmin ties resolve to the first index, as in JAX.
The masks and matchers take leading batch dims (the JAX package vmaps them
over keyframes).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .hamming import INVALID_DIST, hamming_table

TH_HIGH = 100  # reference ORBmatcher.cc:49
TH_LOW = 50    # reference ORBmatcher.cc:50
HISTO_LENGTH = 30  # reference ORBmatcher.cc:51


class MatchResult(NamedTuple):
    idx: torch.Tensor    # [N] int32 best match in the target set (-1 = none)
    dist: torch.Tensor   # [N] int32 best Hamming distance
    valid: torch.Tensor  # [N] bool


def window_mask(pred_uv: torch.Tensor, target_uv: torch.Tensor,
                radius: torch.Tensor) -> torch.Tensor:
    """[..., N, M]: target j within radius[..., i] (Chebyshev) of prediction
    i (Frame::GetFeaturesInArea's square window, src/Frame.cc:741-830)."""
    du = torch.abs(pred_uv[..., :, None, 0] - target_uv[..., None, :, 0])
    dv = torch.abs(pred_uv[..., :, None, 1] - target_uv[..., None, :, 1])
    r = radius[..., :, None]
    return (du <= r) & (dv <= r)


def level_mask(pred_level: torch.Tensor, target_level: torch.Tensor,
               min_offset: int = 0, max_offset: int = 1) -> torch.Tensor:
    """[..., N, M]: target octave within [pred + min_offset, pred + max_offset]."""
    diff = target_level[..., None, :] - pred_level[..., :, None]
    return (diff >= min_offset) & (diff <= max_offset)


def _best_match(table: torch.Tensor, valid_q: torch.Tensor, max_dist: int,
                ratio: float | None) -> MatchResult:
    best, best_idx = torch.min(table, dim=-1)  # first index of the minimum
    best_idx = best_idx.to(torch.int32)
    ok = (best <= max_dist) & valid_q
    if ratio is not None:
        cols = torch.arange(table.shape[-1], device=table.device)
        second = torch.where(cols == best_idx[..., None], INVALID_DIST,
                             table).amin(dim=-1)
        ok &= best.to(torch.float32) < ratio * second.to(torch.float32)
    return MatchResult(idx=torch.where(ok, best_idx, -1), dist=best, valid=ok)


def masked_best_match(desc_q, desc_t, mask, valid_q, valid_t,
                      max_dist: int = TH_HIGH, ratio: float | None = None) -> MatchResult:
    """Best target per query under a compatibility mask; ratio: require
    best < ratio * second best (reference mfNNratio)."""
    table = torch.where(mask, hamming_table(desc_q, desc_t, valid_q, valid_t),
                        INVALID_DIST)
    return _best_match(table, valid_q, max_dist, ratio)


def mutual_best_match(desc_q, desc_t, mask, valid_q, valid_t,
                      max_dist: int = TH_LOW, ratio: float | None = 0.9) -> MatchResult:
    """Best match that is also the best in the reverse direction."""
    table = torch.where(mask, hamming_table(desc_q, desc_t, valid_q, valid_t),
                        INVALID_DIST)
    res = _best_match(table, valid_q, max_dist, ratio)
    rev_best = torch.argmin(table, dim=-2)      # [..., M], first index of the minimum
    j = torch.where(res.valid, res.idx, 0).long()
    mutual = rev_best.gather(-1, j) == torch.arange(desc_q.shape[-2], device=desc_q.device)
    ok = res.valid & mutual
    return MatchResult(idx=torch.where(ok, res.idx, -1), dist=res.dist, valid=ok)


def _top3_desc(counts: torch.Tensor):
    """jax.lax.top_k(counts, 3): largest first, ties by lowest index."""
    vals, idx = torch.sort(counts, descending=True, stable=True)
    return vals[:3], idx[:3]


def rotation_consistency_mask(angle_q: torch.Tensor, angle_t: torch.Tensor,
                              match: MatchResult) -> torch.Tensor:
    """Keep matches whose angle difference falls in the 3 dominant of 30 bins,
    dropping bins below 0.1x the max count (src/ORBmatcher.cc:1866-1911)."""
    j = torch.where(match.valid, match.idx, 0).long()
    two_pi = 2.0 * math.pi
    diff = torch.remainder(angle_q - angle_t[j], two_pi)
    bin_idx = torch.clamp((diff * (HISTO_LENGTH / two_pi)).to(torch.int64), 0,
                          HISTO_LENGTH - 1)
    counts = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=angle_q.device)
    counts = counts.scatter_add(0, bin_idx, match.valid.to(torch.int32))
    top3, top3_idx = _top3_desc(counts)
    keep = top3.to(torch.float32) > 0.1 * top3[0].to(torch.float32)
    keep = keep | (torch.arange(keep.shape[0], device=keep.device) == 0)  # the top bin stays
    keep_bin = torch.zeros(HISTO_LENGTH, dtype=torch.bool, device=angle_q.device)
    keep_bin = keep_bin.scatter(0, top3_idx, keep)
    return match.valid & keep_bin[bin_idx]
