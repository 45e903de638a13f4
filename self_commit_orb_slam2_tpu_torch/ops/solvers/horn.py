"""Horn 1987 closed-form absolute orientation (3D-3D alignment), batched.

Counterpart of the JAX package's ops/solvers/horn.py: the core of the
reference Sim3Solver (src/Sim3Solver.cc:309-448 ComputeSim3: quaternion from
the 4x4 N-matrix eigenvector, optional scale) and the control-point
alignment step of EPnP.  Batched over leading dims, so hundreds of RANSAC
hypotheses solve in one call.  The eigenvector's sign is free (q and -q give
one rotation), so the result does not depend on the eigensolver.

The symmetric 4x4 eigenproblem is solved by cyclic Jacobi in plain tensor
ops (top_eigenvector), not torch.linalg.eigh: on the card eigh reads its
error code back to the host, which stalls the stream and breaks a CUDA
graph capture.  JACOBI_SWEEPS parallel-ordered sweeps (three rounds of two
disjoint rotations each) in float64 converge on random and on nearly
degenerate spectra, to well within fp32 eigh's error; a zero matrix (no
weight) stays the identity and gives the identity rotation, which loses its
RANSAC vote.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import se3
from ..constants import from_numpy

JACOBI_SWEEPS = 5
# the rounds of a sweep: two disjoint (p, q) pairs each, every pair once
_ROUNDS = ((0, 1, 2, 3), (0, 2, 1, 3), (0, 3, 1, 2))


def _round_placements() -> np.ndarray:
    """[3, 4, 4, 4] float64: for each round, where (c1, s1, c2, s2) go in
    its rotation J (J[p, p] = J[q, q] = c, J[p, q] = s, J[q, p] = -s)."""
    M = np.zeros((len(_ROUNDS), 4, 4, 4), np.float64)
    for r, (p1, q1, p2, q2) in enumerate(_ROUNDS):
        for k, (p, q) in enumerate(((p1, q1), (p2, q2))):
            M[r, 2 * k, p, p] = M[r, 2 * k, q, q] = 1.0
            M[r, 2 * k + 1, p, q], M[r, 2 * k + 1, q, p] = 1.0, -1.0
    return M


def top_eigenvector(A: torch.Tensor, sweeps: int = JACOBI_SWEEPS) -> torch.Tensor:
    """Unit eigenvector [..., 4] of the largest eigenvalue of symmetric
    [..., 4, 4] A, by cyclic Jacobi with no host read."""
    dtype = A.dtype
    A = A.to(torch.float64)
    place = from_numpy(_round_placements, device=A.device)
    V = torch.eye(4, dtype=torch.float64, device=A.device).expand(A.shape)
    for _ in range(sweeps):
        for r, (p1, q1, p2, q2) in enumerate(_ROUNDS):
            app = torch.stack([A[..., p1, p1], A[..., p2, p2]], -1)
            aqq = torch.stack([A[..., q1, q1], A[..., q2, q2]], -1)
            apq = torch.stack([A[..., p1, q1], A[..., p2, q2]], -1)
            # the smaller of the two angles that zero A[p, q] (Rutishauser)
            live = apq != 0
            tau = (aqq - app) / torch.where(live, 2.0 * apq, 1.0)
            t = torch.where(tau >= 0, 1.0, -1.0) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(live, t, 0.0)
            c = torch.rsqrt(1.0 + t * t)
            cs = torch.stack([c, t * c], -1).reshape(*c.shape[:-1], 4)   # c1, s1, c2, s2
            J = torch.einsum("...k,kij->...ij", cs, place[r])
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    top = torch.argmax(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1)
    return torch.gather(V, -1, top[..., None, None].expand(*V.shape[:-1], 1))[..., 0].to(dtype)


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
