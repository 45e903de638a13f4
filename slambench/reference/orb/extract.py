"""ORB extraction of a frame batch, as the settings file states it: the
pyramid, FAST with the 20 -> 7 fallback in 16-px cells, the per-level
budgets, orientation and rotated BRIEF.  Frozen from the port's
ops/orb/extractor.py (its 16-px cell path), with the band kernel replaced
by its plain function (bands.py)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import bands, brief, detect, orientation, pyramid, sample
from .common import scale_factors


class OrbSettings(NamedTuple):
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold_hi: float = 20.0
    fast_threshold_lo: float = 7.0
    cell_size: int = 16
    border: int = 16

    def level_budgets(self) -> list[int]:
        f = 1.0 / self.scale_factor
        n_first = self.n_features * (1 - f) / (1 - f**self.n_levels)
        budgets, acc = [], 0
        for lv in range(self.n_levels - 1):
            b = int(round(n_first * f**lv))
            budgets.append(b)
            acc += b
        budgets.append(max(self.n_features - acc, 0))
        return budgets

    def feat_capacity(self) -> int:
        cap = sum(self.level_budgets())
        return cap + (-cap) % 128

    def scale_factors(self) -> np.ndarray:
        return self.scale_factor ** np.arange(self.n_levels, dtype=np.float32)


FIELDS = ("xy", "response", "angle", "level", "desc", "valid")


def _orient_and_describe(slab, kps, dims):
    H0, W0 = dims[0]
    if H0 >= sample.PATCH and W0 >= sample.PATCH:
        return sample.orient_and_describe(slab, kps.xy, kps.level)
    ang = orientation.keypoint_angles_slab(slab, kps.xy, kps.level)
    desc = brief.describe_slab(pyramid.gaussian_blur(slab), kps.xy, kps.level, ang, dims)
    return ang, desc


def extract_batch(images: torch.Tensor, orb: OrbSettings) -> dict:
    """[B, H, W] float32 images (0..255) -> dict of FIELDS, each [B, N, ...]
    with N = orb.feat_capacity(); xy in level-0 pixels."""
    if orb.cell_size != 16:
        raise ValueError("the frozen extractor has the 16-px cell path only")
    B = images.shape[0]
    L = orb.n_levels
    budgets = orb.level_budgets()
    levels = pyramid.build_pyramid(images, L, orb.scale_factor)
    dims = [tuple(lv.shape[-2:]) for lv in levels]
    H0, W0 = dims[0]
    slab = pyramid.stack_slab_batch(levels).reshape(B * L, H0, W0)
    H0p = H0 + (-H0) % 16
    if H0p != H0:
        rows = torch.clamp(torch.arange(H0p, device=slab.device), max=H0 - 1)
        slab = slab[:, rows]
    G = B * L
    hi_max, hi_arg, lo_max, lo_arg = bands.fast_bands(
        slab.reshape(G * H0p, W0).contiguous(), orb.fast_threshold_hi,
        orb.fast_threshold_lo, H0p, tuple(dims[:L]), orb.border, L)
    kps = detect.select_keypoints_bands(hi_max, hi_arg, lo_max, lo_arg,
                                        budgets * B, G, H0p)
    ang, desc = _orient_and_describe(slab, kps, dims * B)
    capL = sum(budgets)
    pad = orb.feat_capacity() - capL
    lvl = kps.level % L
    scales = scale_factors(orb, images.device)

    def rs(x):
        x = x.reshape(B, capL, *x.shape[1:])
        if pad:
            x = torch.cat([x, x.new_zeros((B, pad, *x.shape[2:]))], dim=1)
        return x

    return dict(xy=rs(kps.xy * scales[lvl.long()][:, None]), response=rs(kps.response),
                angle=rs(ang), level=rs(lvl), desc=rs(desc), valid=rs(kps.valid))
