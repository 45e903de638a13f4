"""End-to-end ORB extraction: pyramid -> FAST kernel -> select -> orient ->
describe.

Counterpart of the JAX package's ops/orb/extractor.py (reference
ORBextractor::operator(), src/ORBextractor.cc:1544-1668), with its two
kernel branches: the FAST band kernel and band selection for the default
16-px cells, the FAST NMS kernel and slab selection for any other cell size.
A whole frame batch stacks into one [B*L, H0, W0] slab, so the FAST kernel
runs once per batch; extract is that chain at B = 1.  Orientation and BRIEF
come from 48-px patches, or, for images smaller than a patch, from the dense
forms (orientation.py, brief.py on the blurred slab).  Keypoint xy is scaled
back to level-0 pixels; `level` is the pyramid octave.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import brief, detect, fast_band, fast_nms, orientation, pyramid, sample


class OrbConfig(NamedTuple):
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold_hi: float = 20.0  # reference iniThFAST
    fast_threshold_lo: float = 7.0   # reference minThFAST
    cell_size: int = 16
    border: int = 16

    def level_budgets(self) -> list[int]:
        """Geometric per-level feature budget (reference ctor :539-554)."""
        f = 1.0 / self.scale_factor
        n_first = self.n_features * (1 - f) / (1 - f**self.n_levels)
        budgets = []
        acc = 0
        for lv in range(self.n_levels - 1):
            b = int(round(n_first * f**lv))
            budgets.append(b)
            acc += b
        budgets.append(max(self.n_features - acc, 0))
        return budgets

    def feat_capacity(self) -> int:
        """Feature array capacity: the JAX package's (budget rounded up to
        128), so every state shape matches it."""
        cap = sum(self.level_budgets())
        return cap + (-cap) % 128

    def scale_factors(self) -> np.ndarray:
        return self.scale_factor ** np.arange(self.n_levels, dtype=np.float32)

    def sigma2(self) -> np.ndarray:
        return self.scale_factors() ** 2


class OrbFeatures(NamedTuple):
    """Fixed-capacity feature set, leading batch dim [B, N, ...]."""

    xy: torch.Tensor        # [B, N, 2] float32, level-0 pixel coords (distorted)
    response: torch.Tensor  # [B, N] float32
    angle: torch.Tensor     # [B, N] float32 radians
    level: torch.Tensor     # [B, N] int32 pyramid octave
    desc: torch.Tensor      # [B, N, 8] int32 (bits of the 256-bit descriptor)
    valid: torch.Tensor     # [B, N] bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]


def _stacked_features(slab: torch.Tensor, budgets_g: list[int],
                      dims: list[tuple[int, int]], config: OrbConfig):
    """FAST kernel + selection + orientation/BRIEF over a [G, H0, W0]
    stacked slab (G = frames x levels)."""
    G, H0, W0 = slab.shape
    if config.cell_size != 16:
        # full score maps of the slices stacked tall (cross-slice halo reads
        # land inside the border mask)
        hi, lo = fast_nms.fast_nms_hi_lo(slab.reshape(G * H0, W0).contiguous(),
                                         config.fast_threshold_hi,
                                         config.fast_threshold_lo)
        kps = detect.select_keypoints_slab(hi.reshape(G, H0, W0), lo.reshape(G, H0, W0),
                                           budgets_g, dims, cell=config.cell_size,
                                           border=config.border)
        return kps, *_orient_and_describe(slab, kps, dims)
    # slices padded to a 16-multiple height so bands never straddle slices
    H0p = H0 + (-H0) % 16
    if H0p != H0:
        rows = torch.clamp(torch.arange(H0p, device=slab.device), max=H0 - 1)
        slab = slab[:, rows]
    hi_max, hi_arg, lo_max, lo_arg = fast_band.fast_nms_bands_hi_lo(
        slab.reshape(G * H0p, W0).contiguous(),
        config.fast_threshold_hi, config.fast_threshold_lo,
        H0p, tuple(dims[:config.n_levels]), config.border, config.n_levels,
    )
    kps = detect.select_keypoints_bands(hi_max, hi_arg, lo_max, lo_arg,
                                        budgets_g, G, H0p)
    return kps, *_orient_and_describe(slab, kps, dims)


def _orient_and_describe(slab: torch.Tensor, kps: detect.SlabKeypoints, dims):
    """Angles and descriptors: from patches, or for an image smaller than a
    patch (level 0 of dims) from the dense forms on the whole (blurred) slab."""
    H0, W0 = dims[0]
    if H0 >= sample.PATCH and W0 >= sample.PATCH:
        return sample.orient_and_describe(slab, kps.xy, kps.level)
    ang = orientation.keypoint_angles_slab(slab, kps.xy, kps.level)
    desc = brief.describe_slab(pyramid.gaussian_blur(slab), kps.xy, kps.level, ang, dims)
    return ang, desc


def extract_batch(images: torch.Tensor, config: OrbConfig):
    """ORB extraction for a frame batch [B, H, W] float32 (0..255) through one
    kernel chain.  Returns (OrbFeatures [B, N, ...], slab [B, L, H0, W0]).
    The single-frame extraction is this at B = 1."""
    B = images.shape[0]
    L = config.n_levels
    budgets = config.level_budgets()
    levels = pyramid.build_pyramid(images, L, config.scale_factor)
    dims = [tuple(l.shape[-2:]) for l in levels]
    H0, W0 = dims[0]
    slab = pyramid.stack_slab_batch(levels)           # [B, L, H0, W0]

    kps, ang, desc = _stacked_features(slab.reshape(B * L, H0, W0),
                                       budgets * B, dims * B, config)

    capL = sum(budgets)
    pad = config.feat_capacity() - capL
    lvl = kps.level % L   # stacked slice index (b*L + l) -> octave
    scales = torch.from_numpy(config.scale_factors()).to(images.device)

    def rs(x):
        x = x.reshape(B, capL, *x.shape[1:])
        if pad:
            x = torch.cat([x, x.new_zeros((B, pad, *x.shape[2:]))], dim=1)
        return x

    feats = OrbFeatures(
        xy=rs(kps.xy * scales[lvl.long()][:, None]),
        response=rs(kps.response),
        angle=rs(ang),
        level=rs(lvl),
        desc=rs(desc),
        valid=rs(kps.valid),
    )
    return feats, slab


def extract_pair(image_l: torch.Tensor, image_r: torch.Tensor, config: OrbConfig):
    """ORB extraction for both stereo eyes ([H, W] each) through one kernel
    chain: extract_batch at B = 2 on the stacked eyes.  Returns (feats_l,
    feats_r, slab_l, slab_r) with no batch dim: features [N, ...] and slabs
    [L, H0, W0], which feed the stereo SAD matcher."""
    feats, slabs = extract_batch(torch.stack([image_l, image_r]), config)
    return (OrbFeatures(*(x[0] for x in feats)), OrbFeatures(*(x[1] for x in feats)),
            slabs[0], slabs[1])


def extract(image: torch.Tensor, config: OrbConfig, return_slab: bool = False):
    """ORB features of one [H, W] float32 image (0..255): extract_batch at
    B = 1, so the same kernel chain runs.  Returns OrbFeatures [N, ...], and
    with return_slab the padded [L, H0, W0] pyramid slab too."""
    feats, slab = extract_batch(image[None], config)
    feats = OrbFeatures(*(x[0] for x in feats))
    return (feats, slab[0]) if return_slab else feats


def build_extractor(config: OrbConfig):
    """extract(image) bound to `config` (the JAX package jit-compiles this
    closure; eager torch runs it as it is)."""
    return functools.partial(extract, config=config)
