"""Motion-only bundle adjustment (pose optimization).

Counterpart of the JAX package's ops/optim/pose_opt.py (reference
Optimizer::PoseOptimization, src/Optimizer.cc:363-627): 4 rounds of up to 10
Gauss-Newton iterations, Huber in the first two rounds, chi2
reclassification (5.991 / 7.815) between rounds, information 1/sigma2.

The JAX version leaves each round's loop once a step moves the pose by less
than 1e-6 (squared).  Here every round runs its 10 iterations and freezes the
pose after the first such step: the same fixed point, and no host sync on the
card to decide whether to go on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import se3
from ..constants import constant
from ..camera import CameraParams
from .robust import CHI2_MONO, CHI2_STEREO, huber_weight


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor        # [4, 4] optimized pose
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # scalar int32
    chi2: torch.Tensor       # [N] final per-observation chi2


def _residuals_jacobians(cam: CameraParams, Tcw, pts_w, obs, is_stereo):
    """Residuals [N, 3] and Jacobians [N, 3, 6] wrt a left se3 update (third
    row zero for mono).  obs: [N, 3] = (u, v, u_right), u_right < 0 = mono."""
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    pc = pts_w @ R.T + t
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    res = torch.stack([u - obs[:, 0], v - obs[:, 1],
                       torch.where(is_stereo, ur - obs[:, 2], 0.0)], dim=-1)

    zero = torch.zeros_like(z)
    du_dpc = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], dim=-1)
    dv_dpc = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
    dur_dpc = du_dpc + torch.stack([zero, zero, cam.bf * inv_z2], dim=-1)
    duvw_dpc = torch.stack([du_dpc, dv_dpc, dur_dpc], dim=-2)      # [N, 3, 3]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    dpc_dxi = torch.cat([eye, -se3.hat(pc)], dim=-1)                # [N, 3, 6]
    J = duvw_dpc @ dpc_dxi
    row_w = torch.stack([torch.ones_like(z), torch.ones_like(z),
                         is_stereo.to(J.dtype)], dim=-1)
    return res, J * row_w[:, :, None]


def _chi2(res, inv_sigma2, is_stereo):
    e2 = torch.sum(res[:, :2] ** 2, dim=-1) + torch.where(is_stereo, res[:, 2] ** 2, 0.0)
    return e2 * inv_sigma2


def pose_optimize(cam: CameraParams, Tcw0: torch.Tensor, pts_w: torch.Tensor,
                  obs: torch.Tensor, sigma2: torch.Tensor, valid: torch.Tensor,
                  n_rounds: int = 4, n_iters: int = 10, damping: float = 1e-5,
                  ur_weight: float = 1.0) -> PoseOptResult:
    """Optimize Tcw against map points; invalid rows are zero-weighted.

    ur_weight: extra information on the u_right (disparity) residual; RGB-D
    depth is far more precise than one pixel of disparity."""
    dev = Tcw0.device
    is_stereo = obs[:, 2] >= 0.0
    inv_sigma2 = 1.0 / torch.clamp_min(sigma2, 1e-9)
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    sw = constant((1.0, 1.0, ur_weight**0.5), torch.float32, dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def gn_iteration(T, active, use_huber):
        res, J = _residuals_jacobians(cam, T, pts_w, obs, is_stereo)
        res = res * sw
        J = J * sw[:, None]
        chi2 = _chi2(res, inv_sigma2, is_stereo)
        w_rob = huber_weight(chi2, chi2_th) if use_huber else torch.ones_like(chi2)
        w = inv_sigma2 * w_rob * active.to(res.dtype)
        Jw = J * w[:, None, None]
        H = torch.einsum("nij,nik->jk", Jw, J)
        b = torch.einsum("nij,ni->j", Jw, res)
        H = H + damping * torch.diag(torch.diag(H)) + 1e-9 * eye6
        dx = torch.linalg.solve_ex(H, -b)[0]
        ok = torch.all(torch.isfinite(dx)) & (torch.linalg.norm(dx) < 1e3)
        return se3.update_left(T, torch.where(ok, dx, 0.0))

    T = Tcw0
    active = valid
    for round_idx in range(n_rounds):
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(n_iters):
            T_new = gn_iteration(T, active, round_idx < 2)
            delta = torch.sum((T_new[:3] - T[:3]) ** 2)
            T = torch.where(done, T, T_new)
            done = done | (delta <= 1e-6)
        res, _ = _residuals_jacobians(cam, T, pts_w, obs, is_stereo)
        active = valid & (_chi2(res, inv_sigma2, is_stereo) <= chi2_th)
    res, _ = _residuals_jacobians(cam, T, pts_w, obs, is_stereo)
    chi2 = _chi2(res, inv_sigma2, is_stereo)
    return PoseOptResult(Tcw=T, inliers=active,
                         n_inliers=torch.sum(active).to(torch.int32), chi2=chi2)
