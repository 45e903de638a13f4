"""Stereo keypoint matching: row-band Hamming search + SAD subpixel refine.

Counterpart of the JAX package's ops/matching/stereo.py (reference
Frame::ComputeStereoMatches, src/Frame.cc:1026-1420): the per-row candidate
table is a dense [NL, NR] compatibility mask; the per-keypoint 11x11 SAD
slide is a batched patch gather over the pyramid slabs with a vectorized
parabola fit.  Also the RGB-D pseudo-stereo synthesis
(Frame::ComputeStereoFromRGBD, src/Frame.cc:1423-1461).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import constant
from .core import TH_HIGH, TH_LOW
from .hamming import INVALID_DIST, hamming_table

SAD_HALF = 5  # 11x11 window (reference w=5, src/Frame.cc:1233)
SLIDE = 5     # +-5 px disparity slide (reference L=5, :1245)


class StereoMatches(NamedTuple):
    u_right: torch.Tensor  # [NL] float32, -1 where unmatched
    depth: torch.Tensor    # [NL] float32, -1 where unmatched
    valid: torch.Tensor    # [NL] bool


def stereo_from_depth(xy: torch.Tensor, valid: torch.Tensor,
                      depth_map: torch.Tensor, bf: float,
                      depth_factor: float = 1.0) -> StereoMatches:
    """Read the depth at each (distorted) keypoint and synthesize
    u_right = u - bf / d.  Batched over leading dims: xy [..., N, 2],
    valid [..., N], depth_map [..., H, W]."""
    h, w = depth_map.shape[-2:]
    xi = torch.clamp(xy[..., 0].to(torch.int64), 0, w - 1)
    yi = torch.clamp(xy[..., 1].to(torch.int64), 0, h - 1)
    flat = depth_map.reshape(*depth_map.shape[:-2], h * w)
    d = torch.gather(flat, -1, yi * w + xi) * depth_factor
    ok = valid & (d > 0.0)
    ur = xy[..., 0] - bf / torch.clamp_min(d, 1e-6)
    return StereoMatches(u_right=torch.where(ok, ur, -1.0),
                         depth=torch.where(ok, d, -1.0), valid=ok)


def match_stereo(xy_l: torch.Tensor, level_l: torch.Tensor, desc_l: torch.Tensor,
                 valid_l: torch.Tensor, xy_r: torch.Tensor, level_r: torch.Tensor,
                 desc_r: torch.Tensor, valid_r: torch.Tensor,
                 slab_l: torch.Tensor, slab_r: torch.Tensor, bf: float, min_z: float,
                 scale_factors: torch.Tensor, level_dims) -> StereoMatches:
    """Match left keypoints to right keypoints along epipolar rows, for a
    batch of pairs: keypoint fields [B, N, ...], pyramid slabs [B, L, H0, W0]
    (ops/orb/extractor.extract_batch), level_dims the (h, w) of each level.

    Coordinates are level-0 pixels; the SAD refinement reads each keypoint's
    own octave (reference :1220-1275).  min_z is the least expected depth
    (the reference uses the baseline, src/Frame.cc:1033), so the largest
    disparity is bf / min_z.
    """
    B, N = xy_l.shape[:2]
    dev = xy_l.device
    max_d = bf / min_z
    ll, lr = level_l.long(), level_r.long()
    # --- candidate mask (reference :1072-1216) ---
    row_tol = 2.0 * scale_factors[lr]          # band half-width from the right octave
    row_ok = torch.abs(xy_l[:, :, None, 1] - xy_r[:, None, :, 1]) <= row_tol[:, None, :]
    lvl_ok = torch.abs(level_l[:, :, None] - level_r[:, None, :]) <= 1
    disp = xy_l[:, :, None, 0] - xy_r[:, None, :, 0]
    mask = row_ok & lvl_ok & (disp >= -1.0) & (disp <= max_d)  # tiny negative: noise

    table = hamming_table(desc_l, desc_r, valid_l, valid_r)
    table = torch.where(mask, table, INVALID_DIST)
    best_dist, best_idx = torch.min(table, dim=2)   # first index of the minimum
    th_orb = (TH_HIGH + TH_LOW) // 2                # reference :1105 region
    coarse_ok = (best_dist < th_orb) & valid_l

    # --- SAD subpixel refinement at each keypoint's octave (reference :1220+) ---
    j = torch.where(coarse_ok, best_idx, 0)         # a row with no candidate reads 0
    ur0 = xy_r[..., 0].gather(1, j)
    inv_scale = 1.0 / scale_factors
    win = 2 * SAD_HALF + 1          # 11
    wr = win + 2 * SLIDE            # 21-wide right strip
    L, H0, W0 = slab_l.shape[1:]
    lh = constant(tuple(int(d[0]) for d in level_dims), torch.int32, dev)[ll]
    lw = constant(tuple(int(d[1]) for d in level_dims), torch.int32, dev)[ll]

    # .to(int32) truncates toward zero, as the JAX package's astype does
    su = (xy_l[..., 0] * inv_scale[ll]).to(torch.int32)
    sv = (xy_l[..., 1] * inv_scale[ll]).to(torch.int32)
    sur = (ur0 * inv_scale[ll]).to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    y0 = torch.clamp(sv - SAD_HALF, zero, torch.clamp_min(lh - win, 0))
    xl0 = torch.clamp(su - SAD_HALF, zero, torch.clamp_min(lw - win, 0))
    xr0 = torch.clamp(sur - SAD_HALF - SLIDE, zero, torch.clamp_min(lw - wr, 0))

    def fetch(slab, x0, width):
        """[B, N, 11, width] patches whose top-left corner is (y0, x0) of
        each keypoint's level, gathered from the slab by flat index."""
        rows = (ll * H0 + y0)[..., None] + torch.arange(win, device=dev)     # [B, N, 11]
        cols = x0[..., None].long() + torch.arange(width, device=dev)        # [B, N, w]
        idx = rows[..., :, None] * W0 + cols[..., None, :]
        return slab.reshape(B, L * H0 * W0).gather(1, idx.reshape(B, -1)).reshape(
            B, N, win, width)

    patch_l = fetch(slab_l, xl0, win)
    strip_r = fetch(slab_r, xr0, wr)
    # centre-normalize like the reference (IL - IL(centre), :1255 region)
    patch_l = patch_l - patch_l[..., SAD_HALF, SAD_HALF][..., None, None]
    # 11 sliding windows: SAD over centres xr0 + SAD_HALF + inc
    sads = []
    for inc in range(2 * SLIDE + 1):
        window = strip_r[..., inc:inc + win]
        window = window - window[..., SAD_HALF, SAD_HALF][..., None, None]
        sads.append(torch.sum(torch.abs(patch_l - window), dim=(-2, -1)))
    sads = torch.stack(sads, dim=-1)                # [B, N, 11]
    sad_best, k = torch.min(sads, dim=-1)           # first index of the minimum
    # parabola fit on (k-1, k, k+1) (reference :1262-1270)
    s_m = sads.gather(-1, torch.clamp(k - 1, 0, 2 * SLIDE)[..., None])[..., 0]
    s_p = sads.gather(-1, torch.clamp(k + 1, 0, 2 * SLIDE)[..., None])[..., 0]
    denom = s_m + s_p - 2.0 * sad_best
    delta = torch.where(denom > 1e-6,
                        (s_m - s_p) / (2.0 * torch.clamp_min(denom, 1e-6)), 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)

    # window k's centre column is xr0 + SAD_HALF + k (== sur + k - SLIDE
    # unless the strip was clipped at the image border)
    ur_refined = scale_factors[ll] * ((xr0 + SAD_HALF + k).to(torch.float32) + delta)
    disparity = xy_l[..., 0] - ur_refined
    ok = coarse_ok & (disparity > 1e-3) & (disparity <= max_d)

    # --- median-based outlier cut (reference :1380-1420) ---
    n_ok = torch.sum(ok, dim=1, keepdim=True)
    sorted_sad, _ = torch.sort(torch.where(ok, sad_best, torch.inf), dim=1)
    median = sorted_sad.gather(1, torch.clamp(n_ok // 2, 0, N - 1))
    th = 1.5 * 1.4 * torch.where(torch.isfinite(median), median, 0.0)
    ok = ok & ((sad_best <= th) | (n_ok < 5))

    depth = bf / torch.clamp_min(disparity, 1e-6)
    return StereoMatches(u_right=torch.where(ok, ur_refined, -1.0),
                         depth=torch.where(ok, depth, -1.0), valid=ok)
