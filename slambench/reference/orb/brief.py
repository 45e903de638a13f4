"""Rotated (steered) BRIEF-256 descriptors as batched gathers (the dense
forms).

Counterpart of the JAX package's ops/orb/brief.py (reference
computeOrbDescriptor, src/ORBextractor.cc:173-230): all N keypoints x 512
pattern samples are gathered from the blurred image in one indexed read,
compared pairwise and packed into [N, 8] words.  The extraction chain reads
them from 48-px patches (sample.orient_and_describe); these forms serve
images smaller than a patch and the unbatched callers.

Rotation convention of the reference's GET_VALUE:
    x' = round(px*cos - py*sin), y' = round(px*sin + py*cos)
with (px, py) from the published 256-pair pattern (brief_pattern.py).
Words are int32 holding the bits of the JAX package's uint32 words
(pack_bits, which sample.py shares).
"""

from __future__ import annotations

import numpy as np
import torch

from .common import constant, from_numpy
from .brief_pattern import BIT_PATTERN_31

# [512, 2] sample points: pairs interleaved (a0, b0, a1, b1, ...).
_PATTERN_XY = BIT_PATTERN_31.reshape(512, 2).astype(np.float32)


def _pattern_xy() -> np.ndarray:
    return _PATTERN_XY


def pack_bits(samples: torch.Tensor) -> torch.Tensor:
    """[N, 512] samples -> [N, 8] int32 words; bit = I(a) < I(b), word j
    bit k = pair 32j + k (the reference's `t0 < t1` test)."""
    bits = (samples[:, 0::2] < samples[:, 1::2]).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=samples.device)
    words = torch.sum(bits.reshape(-1, 8, 32) << shifts, dim=-1)   # [0, 2**32)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def rotated_pattern(angle: torch.Tensor):
    """The 512 pattern points rotated by each angle [N] and rounded:
    (rx, ry), [N, 512] each."""
    pat = from_numpy(_pattern_xy, device=angle.device)
    px, py = pat[None, :, 0], pat[None, :, 1]
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    return torch.round(px * ca - py * sa), torch.round(px * sa + py * ca)


def describe_slab(blurred: torch.Tensor, xy: torch.Tensor, level: torch.Tensor,
                  angle: torch.Tensor, level_dims: list) -> torch.Tensor:
    """Descriptors for keypoints across all slices of a [L, H0, W0] blurred
    slab in one gather: xy [N, 2] slice-local positions, level [N], angle
    [N] radians; sample coordinates clip to each slice's own level_dims."""
    L, h, w = blurred.shape
    dims = constant(tuple(tuple(int(v) for v in d) for d in level_dims), torch.int64,
                    blurred.device)
    lv = level.to(torch.int64)
    hs, ws = dims[lv, 0], dims[lv, 1]
    rx, ry = rotated_pattern(angle)
    gx = torch.minimum(torch.clamp_min((xy[:, 0:1] + rx).to(torch.int64), 0), ws[:, None] - 1)
    gy = torch.minimum(torch.clamp_min((xy[:, 1:2] + ry).to(torch.int64), 0), hs[:, None] - 1)
    lin = (lv * (h * w))[:, None] + gy * w + gx
    return pack_bits(blurred.reshape(-1)[lin])


def describe(blurred: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Descriptors [N, 8] for keypoints xy [N, 2] (level-local pixels) with
    orientation angle [N] (radians) on one [H, W] Gaussian-blurred image."""
    h, w = blurred.shape
    rx, ry = rotated_pattern(angle)
    gx = torch.clamp((xy[:, 0:1] + rx).to(torch.int64), 0, w - 1)
    gy = torch.clamp((xy[:, 1:2] + ry).to(torch.int64), 0, h - 1)
    return pack_bits(blurred.reshape(-1)[gy * w + gx])
