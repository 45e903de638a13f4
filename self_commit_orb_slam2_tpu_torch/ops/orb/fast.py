"""Dense FAST-9-16 corner response and 3x3 NMS over whole images (plain torch).

Counterpart of the JAX package's ops/orb/fast.py (the reference's per-cell
cv::FAST of ORBextractor::ComputeKeyPointsOctTree, src/ORBextractor.cc:
1052-1199, run densely).  These are the plain versions behind the FAST band
kernel (fast_band.py): the ring sums accumulate in RING_OFFSETS order, the
order the CUDA kernel uses, so the two agree bitwise.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 (the standard FAST-16 ring, clockwise from
# 12 o'clock) as (dy, dx) offsets, the ring cv::FAST uses.
RING_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LENGTH = 9  # FAST-9: need >= 9 contiguous brighter/darker ring pixels.


def _pad_edge(image: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-replicate pad of the last two dims of [..., H, W]."""
    h, w = image.shape[-2:]
    lead = image.shape[:-2]
    flat = image.reshape(-1, 1, h, w)
    return F.pad(flat, (pad, pad, pad, pad), mode="replicate").reshape(
        *lead, h + 2 * pad, w + 2 * pad)


def _has_arc(bits: torch.Tensor) -> torch.Tensor:
    acc = bits
    for k in range(1, ARC_LENGTH):
        acc = acc & (((bits << k) | (bits >> (16 - k))) & 0xFFFF)
    return acc != 0


def has_arc_doubling(bits: torch.Tensor) -> torch.Tensor:
    """`_has_arc` as the CUDA kernels compute it (csrc/fast_common.cuh): the
    16-bit mask copied into both halves of a word, so that a rotate is a
    shift; runs of 2, 4 and 8 by doubling, then 9."""
    x = bits | (bits << 16)
    run = x & (x >> 1)
    run = run & (run >> 2)
    run = run & (run >> 4)
    run = run & (x >> 8)
    return (run & 0xFFFF) != 0


def ring_masks(image: torch.Tensor, threshold: float):
    """(brighter, darker) 16-bit ring masks [..., H, W] int64 of
    `fast_response`'s compares at one threshold: bit k is set where ring tap
    k is > p + t (< p - t)."""
    h, w = image.shape[-2:]
    padded = _pad_edge(image, 3)
    t = torch.tensor(threshold, dtype=torch.float32, device=image.device)
    hi = image + t
    lo = image - t
    bits_b = torch.zeros(image.shape, dtype=torch.int64, device=image.device)
    bits_d = torch.zeros_like(bits_b)
    for k, (dy, dx) in enumerate(RING_OFFSETS.tolist()):
        ring = padded[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
        bits_b = bits_b | ((ring > hi).to(torch.int64) << k)
        bits_d = bits_d | ((ring < lo).to(torch.int64) << k)
    return bits_b, bits_d


def compass_pass(bits_b: torch.Tensor, bits_d: torch.Tensor) -> torch.Tensor:
    """The kernels' pre-test on the four compass taps (k = 0, 4, 8, 12) of
    `ring_masks`: a 9-arc always covers two neighbouring compass taps, so a
    pixel passes where (N or S) and (E or W) are both brighter, or both
    darker.  False only where no 9-arc can exist."""
    def two(bits):
        n, e, s, w = ((bits >> k) & 1 for k in (0, 4, 8, 12))
        return ((n | s) & (e | w)) != 0
    return two(bits_b) | two(bits_d)


def fast_response(image: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9 corner response [..., H, W]; 0 where not a corner.

    Response = max(sum of (ring - p - t) over the brighter set, sum of
    (p - t - ring) over the darker set)."""
    h, w = image.shape[-2:]
    padded = _pad_edge(image, 3)
    p = image
    t = torch.tensor(threshold, dtype=torch.float32, device=image.device)
    hi = p + t
    lo = p - t
    bits_b = torch.zeros(p.shape, dtype=torch.int32, device=p.device)
    bits_d = torch.zeros_like(bits_b)
    sum_b = torch.zeros_like(p)
    sum_d = torch.zeros_like(p)
    for k, (dy, dx) in enumerate(RING_OFFSETS.tolist()):
        ring = padded[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
        bright = ring > hi
        dark = ring < lo
        bits_b = bits_b | (bright.to(torch.int32) << k)
        bits_d = bits_d | (dark.to(torch.int32) << k)
        sum_b = sum_b + torch.where(bright, ring - p - t, 0.0)
        sum_d = sum_d + torch.where(dark, lo - ring, 0.0)
    corner = _has_arc(bits_b) | _has_arc(bits_d)
    return torch.where(corner, torch.maximum(sum_b, sum_d), 0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Zero out non-maxima in each 3x3 neighbourhood (ties keep the first in
    raster order: strict against earlier neighbours).  [..., H, W]."""
    h, w = score.shape[-2:]
    lead = score.shape[:-2]
    padded = F.pad(score.reshape(-1, h, w), (1, 1, 1, 1), value=-1.0).reshape(
        *lead, h + 2, w + 2)
    keep = torch.ones(score.shape, dtype=torch.bool, device=score.device)
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            neigh = padded[..., dy:dy + h, dx:dx + w]
            if dy < 1 or (dy == 1 and dx < 1):
                keep &= score > neigh
            else:
                keep &= score >= neigh
    return torch.where(keep, score, 0.0)
