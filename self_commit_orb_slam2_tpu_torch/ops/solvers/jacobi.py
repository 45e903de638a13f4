"""Symmetric eigensolver by cyclic Jacobi in plain tensor ops, batched.

Stands in for torch.linalg.eigh where a captured program needs one (Horn's
4x4 quaternion matrix, EPnP's 3x3 point covariance and 12x12 M'M): on the
card eigh reads its error code back to the host, which stalls the stream
and breaks a CUDA graph capture.  Here nothing is read back.

A sweep rotates every off-diagonal pair (p, q) once, in rounds of disjoint
pairs (a round-robin tournament; an odd n sits one index out per round), so
one round is one batched rotation A <- J^T A J, V <- V J.  Each rotation
takes the smaller of the two angles that zero A[p, q] (Rutishauser), in
float64.  A fixed number of sweeps runs, whatever the input: on random,
nearly degenerate and rank-deficient spectra the callers' counts converge to
within 1e-6 of float64 eigh (tests/test_torch_reloc_graph.py).  Non-finite
input gives non-finite output and raises nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import from_numpy


def round_robin(n: int) -> tuple:
    """Rounds of disjoint (p, q) pairs, p < q, that together hold every pair
    of range(n) once (the circle method; index n pads an odd n)."""
    m = n + (n % 2)
    ring = list(range(1, m))
    rounds = []
    for _ in range(m - 1):
        players = [0] + ring
        pairs = [tuple(sorted((players[i], players[m - 1 - i]))) for i in range(m // 2)]
        rounds.append(tuple(sorted(pq for pq in pairs if pq[1] < n)))
        ring = ring[-1:] + ring[:-1]
    return tuple(rounds)


def _placements(rounds: tuple, n: int):
    """float64 [R, 2P, n, n] where each round's (c_k, s_k) go in its
    rotation J (J[p, p] = J[q, q] = c, J[p, q] = s, J[q, p] = -s); float64
    [R, n, n], the identity on the indices a round leaves out; int64 [R, P]
    and [R, P], the rounds' p and q."""
    R, P = len(rounds), len(rounds[0])
    place = np.zeros((R, 2 * P, n, n), np.float64)
    rest = np.zeros((R, n, n), np.float64)
    ps = np.zeros((R, P), np.int64)
    qs = np.zeros((R, P), np.int64)
    for r, pairs in enumerate(rounds):
        for k, (p, q) in enumerate(pairs):
            place[r, 2 * k, p, p] = place[r, 2 * k, q, q] = 1.0
            place[r, 2 * k + 1, p, q], place[r, 2 * k + 1, q, p] = 1.0, -1.0
            ps[r, k], qs[r, k] = p, q
        for i in set(range(n)) - {x for pq in pairs for x in pq}:
            rest[r, i, i] = 1.0
    return place, rest, ps, qs


def jacobi(A: torch.Tensor, sweeps: int, rounds: tuple | None = None):
    """(diag [..., n], V [..., n, n]), float64 and unsorted, with
    A ~= V diag(diag) V^T, for symmetric [..., n, n] A.  `rounds`: the pair
    schedule (default round_robin(n)); all rounds hold the same number of
    pairs."""
    n = A.shape[-1]
    rounds = rounds if rounds is not None else round_robin(n)
    place, rest, ps, qs = from_numpy(_placements, rounds, n, device=A.device)
    A = A.to(torch.float64)
    V = torch.eye(n, dtype=torch.float64, device=A.device).expand(A.shape)
    for _ in range(sweeps):
        for r, pairs in enumerate(rounds):
            p, q = ps[r], qs[r]
            d = torch.diagonal(A, dim1=-2, dim2=-1)
            app, aqq, apq = d[..., p], d[..., q], A[..., p, q]
            # the smaller of the two angles that zero A[p, q] (Rutishauser)
            live = apq != 0
            tau = (aqq - app) / torch.where(live, 2.0 * apq, 1.0)
            t = torch.where(tau >= 0, 1.0, -1.0) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(live, t, 0.0)
            c = torch.rsqrt(1.0 + t * t)
            cs = torch.stack([c, t * c], -1).reshape(*c.shape[:-1], 2 * len(pairs))
            J = torch.einsum("...k,kij->...ij", cs, place[r])
            if 2 * len(pairs) < n:
                J = J + rest[r]
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    return torch.diagonal(A, dim1=-2, dim2=-1), V


def eigh(A: torch.Tensor, sweeps: int):
    """torch.linalg.eigh of symmetric [..., n, n] A with no host read:
    (eigenvalues [..., n] ascending, eigenvectors [..., n, n] as columns),
    in A's dtype.  Eigenvector signs are free, as eigh's are."""
    diag, V = jacobi(A, sweeps)
    order = torch.argsort(diag, dim=-1, stable=True)
    vals = torch.gather(diag, -1, order)
    vecs = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return vals.to(A.dtype), vecs.to(A.dtype)


def extreme_eigenvector(A: torch.Tensor, sweeps: int, largest: bool,
                        rounds: tuple | None = None) -> torch.Tensor:
    """Unit eigenvector [..., n] of the largest (or smallest) eigenvalue of
    symmetric [..., n, n] A, in A's dtype."""
    diag, V = jacobi(A, sweeps, rounds)
    pick = torch.argmax(diag, dim=-1) if largest else torch.argmin(diag, dim=-1)
    return torch.gather(V, -1, pick[..., None, None].expand(*V.shape[:-1], 1))[..., 0].to(A.dtype)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-300)


def svd3(A: torch.Tensor, sweeps: int):
    """torch.linalg.svd of [..., 3, 3] A of rank 2 or 3 with no host read:
    (U, S descending, Vh), in A's dtype.  V and the singular values come
    from Jacobi on A^T A in float64; u_k = A v_k / |A v_k| for the two
    largest (the second made orthogonal to the first), and u_3 = u_1 x u_2
    with the sign of A v_3, so that A = U diag(S) Vh also where sigma_3 is 0
    (rank-2 F and E), where A v_3 carries no direction.  Singular-vector
    signs are free, as svd's are."""
    A64 = A.to(torch.float64)
    _, V = eigh(A64.transpose(-1, -2) @ A64, sweeps)
    V = V.flip(-1)                                   # descending
    AV = A64 @ V
    s1 = torch.linalg.norm(AV[..., 0], dim=-1)
    u1 = _unit(AV[..., 0])
    a2 = AV[..., 1]
    u2 = _unit(a2 - torch.sum(u1 * a2, -1, keepdim=True) * u1)
    s2 = torch.sum(u2 * a2, -1)
    u3 = torch.linalg.cross(u1, u2, dim=-1)
    s3 = torch.sum(u3 * AV[..., 2], -1)
    sign3 = torch.where(s3 < 0, -1.0, 1.0)
    U = torch.stack([u1, u2, u3 * sign3[..., None]], -1)
    S = torch.stack([s1, s2, torch.abs(s3)], -1)
    return U.to(A.dtype), S.to(A.dtype), V.transpose(-1, -2).to(A.dtype)
