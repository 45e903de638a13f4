"""Sim(3) similarity-transform algebra for loop closing.

Counterpart of the JAX package's ops/sim3.py (reference g2o::Sim3,
Thirdparty/g2o/g2o/types/sim3.h, as Sim3Solver / OptimizeSim3 /
OptimizeEssentialGraph use it).  A Sim3 is a [..., 8] vector
(q_xyzw[4], t[3], s[1]), the layout both packages' checkpoints store in
`loop_meas`; to_matrix gives the 4x4 form with scaled rotation, the
reference's `Scw` convention (src/LoopClosing.cc:337-569).

The tangent space is [..., 7]: (rho[3], phi[3], sigma[1]); exp follows
Strasdat's "Scale Drift-Aware Large Scale Monocular SLAM" (g2o's sim3).
Every function is batched over leading dims.
"""

from __future__ import annotations

import torch

from . import se3

_EPS = 1e-8


def _scales(s, like: torch.Tensor, shape) -> torch.Tensor:
    """s (a tensor, or a Python number as a device fill, never a copy of
    host data) as `like`'s dtype on its device, expanded to `shape`."""
    if torch.is_tensor(s):
        return s.to(dtype=like.dtype, device=like.device).expand(shape)
    return like.new_full(tuple(shape), float(s))


def make(R: torch.Tensor, t: torch.Tensor, s) -> torch.Tensor:
    """Pack rotation [..., 3, 3], translation [..., 3], scale [...] -> [..., 8]."""
    q = se3.rot_to_quat(R)
    s = _scales(s, R, q.shape[:-1])
    return torch.cat([q, t.expand(*q.shape[:-1], 3), s[..., None]], dim=-1)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([0, 0, 0, 1, 0, 0, 0, 1], dtype=dtype, device=device)


def rotation(S: torch.Tensor) -> torch.Tensor:
    return se3.quat_to_rot(S[..., :4])


def translation(S: torch.Tensor) -> torch.Tensor:
    return S[..., 4:7]


def scale(S: torch.Tensor) -> torch.Tensor:
    return S[..., 7]


def to_matrix(S: torch.Tensor) -> torch.Tensor:
    """[..., 8] -> [..., 4, 4] with top-left block s*R (reference Scw form)."""
    return se3.rt_to_mat(scale(S)[..., None, None] * rotation(S), translation(S))


def from_se3(T: torch.Tensor, s=1.0) -> torch.Tensor:
    return make(T[..., :3, :3], T[..., :3, 3], _scales(s, T, T.shape[:-2]))


def to_se3(S: torch.Tensor) -> torch.Tensor:
    """Drop the scale: [R, t/s], the reference's pose recovery after the
    essential-graph optimization (src/Optimizer.cc:1297-1320)."""
    t = translation(S) / torch.clamp_min(scale(S)[..., None], _EPS)
    return se3.rt_to_mat(rotation(S), t)


def apply(S: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [..., 8] to [..., N, 3] points: s R p + t."""
    return (scale(S)[..., None, None] * torch.einsum("...ij,...nj->...ni", rotation(S), pts)
            + translation(S)[..., None, :])


def apply_point(S: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply [..., 8] to [..., 3] points (broadcast over the leading dims)."""
    return (scale(S)[..., None] * torch.einsum("...ij,...j->...i", rotation(S), p)
            + translation(S))


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Group product A*B: (sA RA, tA) . (sB RB, tB) = (sA sB RA RB, sA RA tB + tA)."""
    RA, RB = rotation(A), rotation(B)
    sA = scale(A)
    t = sA[..., None] * torch.einsum("...ij,...j->...i", RA, translation(B)) + translation(A)
    return make(RA @ RB, t, sA * scale(B))


def inverse(S: torch.Tensor) -> torch.Tensor:
    Rt = rotation(S).transpose(-1, -2)
    s = torch.clamp_min(scale(S), _EPS)
    t = -torch.einsum("...ij,...j->...i", Rt, translation(S)) / s[..., None]
    return make(Rt, t, 1.0 / s)


def _w_coefficients(sigma: torch.Tensor, theta2: torch.Tensor):
    """The (a, b, c) of W = a I + b Omega + c Omega^2 in the four
    (sigma, theta) small / large cases (Strasdat thesis, g2o sim3.h), with
    every sqrt and division fed only sanitized inputs."""
    eps = 1e-5
    sigma_small = torch.abs(sigma) < eps
    theta_small = theta2 < eps * eps
    s = torch.exp(sigma)
    th = torch.sqrt(torch.where(theta_small, 1.0, theta2))
    sg = torch.where(sigma_small, 1.0, sigma)
    t2s2 = th * th + sg * sg
    one = torch.ones_like(sigma)
    # A: sigma ~ 0, theta ~ 0
    A_a, A_b, A_c = one, 0.5 * one, one / 6.0
    # B: sigma ~ 0, theta large
    B_a = one
    B_b = (1.0 - torch.cos(th)) / (th * th)
    B_c = (th - torch.sin(th)) / (th * th * th)
    # C: sigma large, theta ~ 0
    C_a = (s - 1.0) / sg
    C_b = ((sg - 1.0) * s + 1.0) / (sg * sg)
    C_c = ((0.5 * sg * sg - sg + 1.0) * s - 1.0) / (sg * sg * sg)
    # D: both large (the general closed form)
    sin_t, cos_t = torch.sin(th), torch.cos(th)
    D_a = (s - 1.0) / sg
    D_b = (sg * (s * sin_t) + (1.0 - s * cos_t) * th) / (th * t2s2)
    D_c = (D_a - ((s * cos_t - 1.0) * sg + s * sin_t * th) / t2s2) / (th * th)

    def pick(A, B, C, D):
        return torch.where(sigma_small, torch.where(theta_small, A, B),
                           torch.where(theta_small, C, D))

    return pick(A_a, B_a, C_a, D_a), pick(A_b, B_b, C_b, D_b), pick(A_c, B_c, C_c, D_c), s


def _w_matrix(phi: torch.Tensor, sigma: torch.Tensor):
    a, b, c, s = _w_coefficients(sigma, torch.sum(phi * phi, dim=-1))
    Om = se3.hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(Om.shape)
    W = a[..., None, None] * eye + b[..., None, None] * Om + c[..., None, None] * (Om @ Om)
    return W, s


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent [..., 7] (rho, phi, sigma) -> Sim3 [..., 8]: R = exp(phi),
    s = exp(sigma), t = W rho."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    W, s = _w_matrix(phi, sigma)
    return make(se3.so3_exp(phi), torch.einsum("...ij,...j->...i", W, rho), s)


def log(S: torch.Tensor) -> torch.Tensor:
    """Sim3 [..., 8] -> tangent [..., 7], the inverse of exp (W rho = t solved)."""
    sigma = torch.log(torch.clamp_min(scale(S), _EPS))
    phi = se3.so3_log(rotation(S))
    W, _ = _w_matrix(phi, sigma)
    rho = torch.linalg.solve_ex(W, translation(S)[..., None])[0][..., 0]   # no host sync
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
