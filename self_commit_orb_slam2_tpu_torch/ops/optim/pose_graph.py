"""Sim(3) pose-graph (essential graph) optimization.

Counterpart of the JAX package's ops/optim/pose_graph.py (reference
Optimizer::OptimizeEssentialGraph, src/Optimizer.cc:1017-1362): keyframe
poses are Sim3 vertices; loop, spanning-tree and strong-covisibility edges
constrain relative Sim3s; Gauss-Newton over all 7K DoF with the loop anchor
fixed.  The edge list is a fixed-capacity masked array, each edge's 7x14
Jacobian is the exact one in closed form (where the JAX package takes
jax.jacfwd of the residual: the two are held equal in the tests), and the
normal equations assemble into one dense [7K, 7K] system (448 x 448 at 64
keyframes) by index_add_ over the edges, solved with a damped LU 20 times;
a non-finite step is dropped.  No host sync.  The scatter-add sums in a
fixed order on the card (indexing.index_add_fixed), so repeated runs agree
to the bit; the card agrees with the CPU (another order) to a tolerance.

The closed form: with E0 = meas^-1 . S_i . S_j^-1 and r0 = log(E0),
perturbing S_i by exp(xi_i) gives exp(Ad(meas^-1) xi_i) . E0 and perturbing
S_j by exp(xi_j) gives E0 . exp(-xi_j) = exp(-Ad(E0) xi_j) . E0, so
d r / d xi_i = Jl(r0)^-1 Ad(meas^-1) and d r / d xi_j = -Jl(r0)^-1 Ad(E0),
with Jl the left Jacobian of Sim3, sum over n of ad(r0)^n / (n + 1)!.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import se3, sim3
from ..indexing import index_add_fixed


class PoseGraphResult(NamedTuple):
    kf_sim3: torch.Tensor   # [K, 8] optimized Sim3 poses (world -> camera)
    mean_residual: torch.Tensor


def edge_residual(S_i: torch.Tensor, S_j: torch.Tensor, meas_ij: torch.Tensor) -> torch.Tensor:
    """r = log(meas_ij^-1 . S_i . S_j^-1) [..., 7]; meas_ij is the measured
    relative Sim3 S_i . S_j^-1."""
    rel = sim3.compose(S_i, sim3.inverse(S_j))
    return sim3.log(sim3.compose(sim3.inverse(meas_ij), rel))


def adjoint(S: torch.Tensor) -> torch.Tensor:
    """Ad(S) [..., 7, 7] in (rho, phi, sigma): exp(Ad(S) x) = S exp(x) S^-1,
    [[s R, hat(t) R, -t], [0, R, 0], [0, 0, 1]]."""
    R, t, s = sim3.rotation(S), sim3.translation(S), sim3.scale(S)
    top = torch.cat([s[..., None, None] * R, se3.hat(t) @ R, -t[..., None]], -1)
    mid = torch.cat([torch.zeros_like(R), R, torch.zeros_like(t)[..., None]], -1)
    bot = torch.cat([torch.zeros_like(S[..., :6]), torch.ones_like(S[..., :1])], -1)
    return torch.cat([top, mid, bot[..., None, :]], -2)


def _ad(x: torch.Tensor) -> torch.Tensor:
    """ad(x) [..., 7, 7], the Lie bracket [x, .] in (rho, phi, sigma):
    [[hat(phi) + sigma I, hat(rho), -rho], [0, hat(phi), 0], [0, 0, 0]]."""
    rho, phi, sigma = x[..., :3], x[..., 3:6], x[..., 6]
    P = se3.hat(phi)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    col = torch.zeros_like(rho)[..., None]
    top = torch.cat([P + sigma[..., None, None] * eye, se3.hat(rho), -rho[..., None]], -1)
    mid = torch.cat([torch.zeros_like(P), P, col], -1)
    return torch.cat([top, mid, torch.zeros_like(x)[..., None, :]], -2)


def _left_jacobian(x: torch.Tensor, n_terms: int = 20) -> torch.Tensor:
    """Jl(x) = sum_{n <= n_terms} ad(x)^n / (n + 1)! by Horner's rule (the
    series is entire; 20 terms leave < 1e-9 for |x| <= 2)."""
    a = _ad(x)
    eye = torch.eye(7, dtype=x.dtype, device=x.device)
    J = eye.expand_as(a)
    for k in range(n_terms, 0, -1):
        J = eye + (a @ J) / (k + 1)
    return J


def edge_jacobians(S_i: torch.Tensor, S_j: torch.Tensor, meas: torch.Tensor):
    """d r / d xi_i and d r / d xi_j at 0 for [E] edges, each vertex
    perturbed on the left (exp(xi) . S): two [E, 7, 7]."""
    M_inv = sim3.inverse(meas)
    E0 = sim3.compose(M_inv, sim3.compose(S_i, sim3.inverse(S_j)))
    X = torch.linalg.solve_ex(_left_jacobian(sim3.log(E0)),
                              torch.cat([adjoint(M_inv), adjoint(E0)], -1))[0]
    return X[..., :7], -X[..., 7:]


def normal_equations(S: torch.Tensor, ei: torch.Tensor, ej: torch.Tensor,
                     edge_meas: torch.Tensor, edge_valid: torch.Tensor,
                     free: torch.Tensor):
    """The Gauss-Newton system of the edges (ei, ej) at the poses S [K, 8]:
    H [K * K, 7, 7] (block (a, b) at row a * K + b) and b [K, 7], summed by
    index_add_ over the edges; fixed vertices get no column."""
    K = S.shape[0]
    f32 = torch.float32
    w = edge_valid.to(f32)[:, None, None]
    Si, Sj = S[ei], S[ej]
    r = edge_residual(Si, Sj, edge_meas)                            # [E, 7]
    Ji, Jj = edge_jacobians(Si, Sj, edge_meas)
    Ji = Ji * free[ei][:, None, None].to(f32)
    Jj = Jj * free[ej][:, None, None].to(f32)
    wJi, wJj = Ji * w, Jj * w
    JtJ = torch.cat([torch.einsum("eai,eaj->eij", a, b)
                     for a, b in ((wJi, Ji), (wJj, Jj), (wJi, Jj), (wJj, Ji))])
    blocks = torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei])
    H = index_add_fixed(torch.zeros(K * K, 7, 7, dtype=f32, device=S.device), 0, blocks, JtJ)
    b = index_add_fixed(
        torch.zeros(K, 7, dtype=f32, device=S.device), 0, torch.cat([ei, ej]),
        torch.cat([torch.einsum("eai,ea->ei", wJi, r), torch.einsum("eai,ea->ei", wJj, r)]))
    return H, b


def damped_update(S: torch.Tensor, H: torch.Tensor, b: torch.Tensor, free: torch.Tensor,
                  damping: float) -> torch.Tensor:
    """One damped Gauss-Newton step from the normal equations: the dense
    [7K, 7K] system with fixed vertices pinned, LU-solved; a non-finite step
    is dropped.  Returns exp(dx) . S."""
    K = S.shape[0]
    free7 = free.repeat_interleave(7)
    Hd = H.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(K * 7, K * 7)
    Hd = torch.where(free7[:, None] & free7[None, :], Hd, 0.0)
    Hd = Hd + torch.diag(torch.where(free7, damping, 1.0))
    Hd = Hd + damping * torch.diag(torch.diagonal(Hd))
    dx = torch.linalg.solve_ex(Hd, -b.reshape(K * 7))[0].reshape(K, 7)
    dx = torch.where(torch.all(torch.isfinite(dx)), dx, 0.0)
    return sim3.compose(sim3.exp(dx), S)


def optimize_pose_graph(kf_sim3: torch.Tensor,     # [K, 8]
                        edge_i: torch.Tensor,      # [E] int
                        edge_j: torch.Tensor,      # [E] int
                        edge_meas: torch.Tensor,   # [E, 8] measured S_i . S_j^-1
                        edge_valid: torch.Tensor,  # [E] bool
                        kf_fixed: torch.Tensor,    # [K] bool (loop anchor / invalid slots)
                        n_iters: int = 20, damping: float = 1e-6) -> PoseGraphResult:
    ei, ej = edge_i.long(), edge_j.long()
    free = ~kf_fixed
    S = kf_sim3
    for _ in range(n_iters):
        H, b = normal_equations(S, ei, ej, edge_meas, edge_valid, free)
        S = damped_update(S, H, b, free, damping)
    r = edge_residual(S[ei], S[ej], edge_meas)
    wv = edge_valid.to(torch.float32)
    mean = torch.sum(torch.sum(r * r, -1) * wv) / torch.clamp_min(torch.sum(wv), 1.0)
    return PoseGraphResult(kf_sim3=S, mean_residual=mean)
