"""Robust-kernel weights and chi-square constants (reference g2o usage:
Huber delta = sqrt(5.991) mono / sqrt(7.815) stereo, src/Optimizer.cc:
141-142, 514-517).  Counterpart of the JAX package's ops/optim/robust.py."""

from __future__ import annotations

import math

import torch

CHI2_MONO = 5.991    # 95% quantile, 2 DoF
CHI2_STEREO = 7.815  # 95% quantile, 3 DoF


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight of the Huber kernel as a function of the squared
    (information-weighted) error: 1 inside, delta/|e| outside."""
    e = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    delta = torch.sqrt(delta2) if torch.is_tensor(delta2) else math.sqrt(delta2)
    return torch.where(chi2 <= delta2, 1.0, delta / e)
