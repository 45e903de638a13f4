"""Relative Sim3 refinement over matched point pairs.

Counterpart of the JAX package's ops/optim/sim3_opt.py (reference
Optimizer::OptimizeSim3, src/Optimizer.cc:1364-1592): given 3D points in
each keyframe's camera frame and their pixel observations in the OTHER
image, Gauss-Newton refines the relative Sim3 with paired forward / inverse
projection residuals, Huber weights and the chi2 = 10 outlier gate between
two stages (n_iters // 2, then n_iters, fixed counts: no host sync).  The
Jacobian in the 7-dof tangent is written out in closed form, where the JAX
package takes jax.jacfwd of the residual (the two are held equal in the
tests; the closed form costs a few dozen kernels instead of a forward-mode
pass over the whole residual); the scale column is masked for stereo /
RGB-D (bFixScale).

Takes one optional leading batch dimension (the loop closer verifies its
candidates as one batch); each batch entry drops its own non-finite step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import se3, sim3
from ..constants import constant
from ..camera import CameraParams
from .robust import huber_weight

CHI2_TH = 10.0  # reference :1524


class Sim3OptResult(NamedTuple):
    S12: torch.Tensor       # [..., 8]
    inliers: torch.Tensor   # [..., N]
    n_inliers: torch.Tensor


def _proj(cam: CameraParams, p: torch.Tensor) -> torch.Tensor:
    z = torch.where(torch.abs(p[..., 2]) < 1e-6, 1e-6, p[..., 2])
    return torch.stack([cam.fx * p[..., 0] / z + cam.cx, cam.fy * p[..., 1] / z + cam.cy], -1)


def _residuals(cam: CameraParams, S12, p1, p2, uv1, uv2) -> torch.Tensor:
    """[..., N, 4]: forward (S12 p2 -> image 1) and inverse (S12^-1 p1 -> image 2)."""
    e1 = _proj(cam, sim3.apply(S12, p2)) - uv1
    e2 = _proj(cam, sim3.apply(sim3.inverse(S12), p1)) - uv2
    return torch.cat([e1, e2], dim=-1)


def _proj_jacobian(cam: CameraParams, p: torch.Tensor) -> torch.Tensor:
    """d _proj / d p: [..., 2, 3] (no depth column where _proj floors |z|)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    live = torch.abs(z) >= 1e-6
    zs = torch.where(live, z, 1e-6)
    zero = torch.zeros_like(z)
    dz = torch.where(live, 1.0, 0.0) / (zs * zs)
    return torch.stack([torch.stack([cam.fx / zs, zero, -cam.fx * x * dz], -1),
                        torch.stack([zero, cam.fy / zs, -cam.fy * y * dz], -1)], -2)


def _dexp_point(q: torch.Tensor) -> torch.Tensor:
    """d (exp(xi) q) / d xi at xi = 0: [..., 3, 7] = [I, -hat(q), q]."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(*q.shape[:-1], 3, 3)
    return torch.cat([eye, -se3.hat(q), q[..., None]], dim=-1)


def residual_jacobian(cam: CameraParams, S, p1, p2, uv1, uv2) -> torch.Tensor:
    """d residuals / d xi at xi = 0 of exp(xi) . S: [..., N, 4, 7], in
    closed form (the forward-mode Jacobian of the JAX package, exactly):
    forward  S' p2 = exp(xi) (S p2);
    inverse  S'^-1 p1 = S^-1 (exp(-xi) p1), whose linear part is R^T / s."""
    q = sim3.apply(S, p2)
    Sinv = sim3.inverse(S)
    J1 = _proj_jacobian(cam, q) @ _dexp_point(q)
    L = sim3.rotation(S).transpose(-1, -2) / sim3.scale(S)[..., None, None]
    J2 = -(_proj_jacobian(cam, sim3.apply(Sinv, p1)) @ L[..., None, :, :]) @ _dexp_point(p1)
    return torch.cat([J1, J2], dim=-2)


def optimize_sim3(cam: CameraParams,
                  S12_init: torch.Tensor,  # [(B,) 8]
                  p1: torch.Tensor,        # [(B,) N, 3] points in camera-1 frame
                  p2: torch.Tensor,        # [(B,) N, 3] points in camera-2 frame
                  uv1: torch.Tensor,       # [(B,) N, 2] observations in image 1
                  uv2: torch.Tensor,       # [(B,) N, 2] observations in image 2
                  valid: torch.Tensor,     # [(B,) N]
                  fix_scale: bool = True, n_iters: int = 10,
                  damping: float = 1e-4) -> Sim3OptResult:
    batched = S12_init.ndim == 2
    if not batched:
        S12_init, p1, p2, uv1, uv2, valid = (x[None] for x in (S12_init, p1, p2, uv1, uv2,
                                                                valid))
    dev, f32 = S12_init.device, torch.float32
    args = (p1, p2, uv1, uv2)
    dof_mask = constant((1.0,) * 6 + (0.0 if fix_scale else 1.0,), f32, dev)
    eye7 = torch.eye(7, dtype=f32, device=dev)
    frozen = torch.diag(1.0 - dof_mask)

    def stage(S, active, n):
        for _ in range(n):
            r = _residuals(cam, S, *args)                              # [B, N, 4]
            Jm = residual_jacobian(cam, S, *args) * dof_mask           # [B, N, 4, 7]
            chi2 = torch.sum(r[..., :2] ** 2, -1) + torch.sum(r[..., 2:] ** 2, -1)
            w = huber_weight(chi2, CHI2_TH) * active
            H = torch.einsum("bnai,bn,bnaj->bij", Jm, w, Jm)
            b = torch.einsum("bnai,bna->bi", Jm, r * w[..., None])
            H = H + damping * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) \
                + 1e-8 * eye7 + frozen
            dx = torch.linalg.solve_ex(H, -b)[0] * dof_mask
            ok = torch.all(torch.isfinite(dx), dim=-1, keepdim=True)
            S = sim3.compose(sim3.exp(torch.where(ok, dx, 0.0)), S)
        return S

    def gate(S):
        r = _residuals(cam, S, *args)
        return (valid & (torch.sum(r[..., :2] ** 2, -1) < CHI2_TH)
                & (torch.sum(r[..., 2:] ** 2, -1) < CHI2_TH))

    S = stage(S12_init, valid.to(f32), n_iters // 2)
    S = stage(S, gate(S).to(f32), n_iters)
    inl = gate(S)
    res = Sim3OptResult(S12=S, inliers=inl, n_inliers=torch.sum(inl, -1).to(torch.int32))
    return res if batched else Sim3OptResult(*(x[0] for x in res))
