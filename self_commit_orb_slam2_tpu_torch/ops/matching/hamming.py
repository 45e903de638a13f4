"""256-bit Hamming distances between ORB descriptors.

Counterpart of the JAX package's ops/matching/hamming.py (reference
ORBmatcher::DescriptorDistance, src/ORBmatcher.cc:1913-1933).  Descriptors
are [..., 8] int32 words holding the JAX package's uint32 bits.  A full
table is one fp32 matmul of +-1 unpacked bits: hamming = (256 - s1 . s2) / 2.
Exact: every product is +-1 and every partial sum an integer below 2**24,
and TF32 is off (package __init__).  Tables take leading batch dims.
"""

from __future__ import annotations

import torch

INVALID_DIST = 10_000  # sentinel > any possible 256-bit distance


def hamming_distance(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Elementwise distance between [..., 8] descriptors (broadcasting):
    popcount of the XOR, counted in int64 so the sign bit of an int32 word
    is an ordinary bit."""
    x = torch.bitwise_xor(d1, d2).to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return torch.sum(x, dim=-1).to(torch.int32)


def unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 -> [..., 256] float32 in {-1, +1} (bit = 1 -> +1)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., None] >> shifts) & 1       # bit k of each word
    return (bits.to(torch.float32) * 2 - 1).reshape(*desc.shape[:-1], 256)


def hamming_table(desc1: torch.Tensor, desc2: torch.Tensor,
                  valid1: torch.Tensor | None = None,
                  valid2: torch.Tensor | None = None) -> torch.Tensor:
    """[..., N, 8] x [..., M, 8] -> [..., N, M] int32; invalid rows/cols get
    INVALID_DIST."""
    dot = unpack_pm1(desc1) @ unpack_pm1(desc2).transpose(-1, -2)
    table = ((256.0 - dot) * 0.5).to(torch.int32)
    if valid1 is not None:
        table = torch.where(valid1[..., :, None], table, INVALID_DIST)
    if valid2 is not None:
        table = torch.where(valid2[..., None, :], table, INVALID_DIST)
    return table
