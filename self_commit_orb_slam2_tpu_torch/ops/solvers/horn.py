"""Horn 1987 closed-form absolute orientation (3D-3D alignment), batched.

Counterpart of the JAX package's ops/solvers/horn.py: the core of the
reference Sim3Solver (src/Sim3Solver.cc:309-448 ComputeSim3: quaternion from
the 4x4 N-matrix eigenvector, optional scale) and the control-point
alignment step of EPnP.  Batched over leading dims, so hundreds of RANSAC
hypotheses solve in one call.  The eigenvector's sign is free (q and -q give
one rotation), so the result does not depend on the eigensolver.

The symmetric 4x4 eigenproblem is solved by cyclic Jacobi in plain tensor
ops (ops/solvers/jacobi.py), not torch.linalg.eigh: on the card eigh reads
its error code back to the host, which stalls the stream and breaks a CUDA
graph capture.  JACOBI_SWEEPS sweeps of three rounds of two disjoint
rotations each, in float64, converge on random and on nearly degenerate
spectra, to well within fp32 eigh's error; a zero matrix (no weight) stays
the identity and gives the identity rotation, which loses its RANSAC vote.
"""

from __future__ import annotations

import torch

from .. import se3
from .jacobi import extreme_eigenvector

JACOBI_SWEEPS = 5
# the rounds of a sweep: two disjoint (p, q) pairs each, every pair once
_ROUNDS = (((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 3), (1, 2)))


def top_eigenvector(A: torch.Tensor, sweeps: int = JACOBI_SWEEPS) -> torch.Tensor:
    """Unit eigenvector [..., 4] of the largest eigenvalue of symmetric
    [..., 4, 4] A, by cyclic Jacobi with no host read."""
    return extreme_eigenvector(A, sweeps, largest=True, rounds=_ROUNDS)


def horn_align(src: torch.Tensor, dst: torch.Tensor,
               weights: torch.Tensor | None = None, with_scale: bool = False):
    """Least-squares (s, R, t) with dst ~= s R src + t.

    src/dst: [..., N, 3]; weights: [..., N] optional.
    Returns (s [...], R [..., 3, 3], t [..., 3]).
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights[..., None]
    n = torch.clamp_min(torch.sum(weights, dim=-1, keepdim=True)[..., None], 1e-9)
    mu_s = torch.sum(src * w, dim=-2, keepdim=True) / n
    mu_d = torch.sum(dst * w, dim=-2, keepdim=True) / n
    xs = (src - mu_s) * w
    xd = dst - mu_d

    # cross-covariance M = sum xs_i xd_i^T  (src -> dst)
    M = torch.einsum("...ni,...nj->...ij", xs, xd)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]

    # Horn's 4x4 N matrix (quaternion w, x, y, z)
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    q_wxyz = top_eigenvector(N)
    q_xyzw = torch.stack([q_wxyz[..., 1], q_wxyz[..., 2], q_wxyz[..., 3],
                          q_wxyz[..., 0]], -1)
    R = se3.quat_to_rot(q_xyzw)

    if with_scale:
        # symmetric scale (reference Sim3Solver.cc:430 uses Horn's ratio)
        num = torch.einsum("...ni,...ni->...", xd * w,
                           torch.einsum("...ij,...nj->...ni", R, src - mu_s))
        den = torch.sum(torch.sum((src - mu_s) ** 2, -1) * weights, -1)
        s = num / torch.clamp_min(den, 1e-12)
    else:
        s = torch.ones(M.shape[:-2], dtype=src.dtype, device=src.device)

    t = mu_d[..., 0, :] - s[..., None] * torch.einsum(
        "...ij,...j->...i", R, mu_s[..., 0, :])
    return s, R, t
