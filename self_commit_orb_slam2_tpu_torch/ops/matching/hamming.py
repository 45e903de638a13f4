"""256-bit Hamming distances between ORB descriptors.

Counterpart of the JAX package's ops/matching/hamming.py (reference
ORBmatcher::DescriptorDistance, src/ORBmatcher.cc:1913-1933).  Descriptors
are [N, 8] int32 words.  A full table is one fp32 matmul of +-1 unpacked
bits: hamming = (256 - s1 . s2) / 2.  Exact: every product is +-1 and every
partial sum an integer below 2**24, and TF32 is off (package __init__).
"""

from __future__ import annotations

import torch

INVALID_DIST = 10_000  # sentinel > any possible 256-bit distance


def unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 -> [N, 256] float32 in {-1, +1} (bit = 1 -> +1)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1      # bit k of each word
    return (bits.to(torch.float32) * 2 - 1).reshape(desc.shape[0], 256)


def hamming_table(desc1: torch.Tensor, desc2: torch.Tensor,
                  valid1: torch.Tensor | None = None,
                  valid2: torch.Tensor | None = None) -> torch.Tensor:
    """[N, 8] x [M, 8] -> [N, M] int32; invalid rows/cols get INVALID_DIST."""
    dot = unpack_pm1(desc1) @ unpack_pm1(desc2).T
    table = ((256.0 - dot) * 0.5).to(torch.int32)
    if valid1 is not None:
        table = torch.where(valid1[:, None], table, INVALID_DIST)
    if valid2 is not None:
        table = torch.where(valid2[None, :], table, INVALID_DIST)
    return table
