"""Bundle adjustment with a dense Schur-complement reduced camera system.

Counterpart of the JAX package's ops/optim/bundle_adjust.py (reference
Optimizer::LocalBundleAdjustment, src/Optimizer.cc:629-1014): observations on
the [K, N] keyframe-feature grid, Huber-weighted Gauss-Newton with LM
diagonal damping, points eliminated through their 3x3 blocks, the reduced
[6K, 6K] camera system solved densely; fixed keyframes and points have
their Jacobians zeroed.  Two stages (Huber, chi2 outlier removal, plain),
information 1/sigma2.

Differences of form, not of result:
  * the per-(keyframe, point) grouping is a scatter-add (index_add_) over
    the observations instead of the JAX package's one-hot [K, N, P] matmul,
    which was shaped for the TPU's matrix unit;
  * each stage runs its whole iteration budget and freezes the state after
    the first step whose squared size is <= 1e-8, where the JAX package
    leaves its while_loop: the same fixed point, and no host sync on the
    card to decide whether to go on.
The scatter-add sums in a nondeterministic order on the card, so the
results there agree with the CPU to a tolerance, not to the bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import se3
from ..camera import CameraParams
from .robust import CHI2_MONO, CHI2_STEREO, huber_weight


class BAResult(NamedTuple):
    kf_Tcw: torch.Tensor      # [K, 4, 4] optimized poses
    pt_pos: torch.Tensor      # [P, 3] optimized points
    obs_inlier: torch.Tensor  # [K, N] surviving observations
    mean_chi2: torch.Tensor


def _residuals(cam: CameraParams, kf_Tcw, pt_pos, obs_pt, obs_uvr, active):
    """Per-observation residuals and Jacobians over the [K, N] grid:
    res [K, N, 3], J_c [K, N, 3, 6], J_p [K, N, 3, 3], is_stereo [K, N]."""
    P = pt_pos.shape[0]
    pw = pt_pos[torch.clamp(obs_pt, 0, P - 1).long()]          # [K, N, 3]
    R = kf_Tcw[:, :3, :3]
    t = kf_Tcw[:, :3, 3]
    pc = torch.einsum("kij,knj->kni", R, pw) + t[:, None, :]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    is_stereo = obs_uvr[..., 2] >= 0.0
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    res = torch.stack([u - obs_uvr[..., 0], v - obs_uvr[..., 1],
                       torch.where(is_stereo, ur - obs_uvr[..., 2], 0.0)], dim=-1)

    zeros = torch.zeros_like(z)
    du = torch.stack([cam.fx * inv_z, zeros, -cam.fx * x * inv_z2], dim=-1)
    dv = torch.stack([zeros, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
    dur = (du + torch.stack([zeros, zeros, cam.bf * inv_z2], dim=-1)) \
        * is_stereo[..., None].to(du.dtype)
    duvw = torch.stack([du, dv, dur], dim=-2)                   # d(res)/d(pc)

    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(*pc.shape, 3)
    dpc_dxi = torch.cat([eye, -se3.hat(pc)], dim=-1)            # [K, N, 3, 6]
    J_c = duvw @ dpc_dxi
    J_p = torch.einsum("knij,kjl->knil", duvw, R)               # d(pc)/d(pw) = R
    act = active[..., None].to(res.dtype)
    return res * act, J_c * act[..., None], J_p * act[..., None], is_stereo


def _chi2(res, inv_sigma2, is_stereo):
    e2 = res[..., 0] ** 2 + res[..., 1] ** 2 + torch.where(is_stereo, res[..., 2] ** 2, 0.0)
    return e2 * inv_sigma2


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det) of [..., 3, 3]."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d  # noqa: E741
    det = a * A + b * D + c * G
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack([torch.stack([A, B, C], -1),
                       torch.stack([D, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    return adj * inv_det[..., None, None]


def bundle_adjust(cam: CameraParams,
                  kf_Tcw: torch.Tensor,     # [K, 4, 4]
                  pt_pos: torch.Tensor,     # [P, 3]
                  obs_pt: torch.Tensor,     # [K, N] local point index (-1 = none)
                  obs_uvr: torch.Tensor,    # [K, N, 3] (u, v, u_right < 0 for mono)
                  obs_sigma2: torch.Tensor, # [K, N]
                  obs_valid: torch.Tensor,  # [K, N]
                  kf_free: torch.Tensor,    # [K] bool: optimize this pose
                  pt_free: torch.Tensor,    # [P] bool: optimize this point
                  n_iters_pre: int = 5, n_iters_post: int = 10,
                  damping: float = 1e-4, ur_weight: float = 1.0) -> BAResult:
    K, N = obs_pt.shape
    P = pt_pos.shape[0]
    dev, f32 = pt_pos.device, torch.float32
    inv_sigma2 = 1.0 / torch.clamp_min(obs_sigma2, 1e-9)
    # extra information on the u_right component (see pose_opt.pose_optimize)
    sw = torch.tensor([1.0, 1.0, ur_weight**0.5], dtype=f32, device=dev)
    pid = torch.clamp(obs_pt, 0, P - 1).long()
    kf_free_f = kf_free.to(f32)
    pt_free_f = pt_free.to(f32)
    free6 = kf_free.repeat_interleave(6)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    blk = torch.arange(K * 6, device=dev).reshape(K, 6)

    def iteration(kf_Tcw, pt_pos, active, use_huber):
        res, J_c, J_p, is_stereo = _residuals(cam, kf_Tcw, pt_pos, obs_pt, obs_uvr, active)
        res = res * sw
        J_c = J_c * sw[:, None]
        J_p = J_p * sw[:, None]
        chi2 = _chi2(res, inv_sigma2, is_stereo)
        w_rob = (huber_weight(chi2, torch.where(is_stereo, CHI2_STEREO, CHI2_MONO))
                 if use_huber else torch.ones_like(chi2))
        w = inv_sigma2 * w_rob * active
        J_c = J_c * kf_free_f[:, None, None, None]
        J_p = J_p * pt_free_f[pid][..., None, None]

        Wres = res * w[..., None]
        Jw_c = J_c * w[..., None, None]
        H_cc = torch.einsum("knia,knib->kab", Jw_c, J_c)           # [K, 6, 6]
        b_c = torch.einsum("knia,kni->ka", J_c, Wres)              # [K, 6]
        U = torch.einsum("knia,knib->knab", Jw_c, J_p)             # [K, N, 6, 3]
        Hpp_obs = torch.einsum("knia,knib->knab", J_p * w[..., None, None], J_p)
        bp_obs = torch.einsum("knia,kni->kna", J_p, Wres)          # [K, N, 3]

        # group observations by (keyframe, point): inactive ones go to the
        # sink column P
        col = torch.where(active > 0, pid, P)
        flat = (torch.arange(K, device=dev)[:, None] * (P + 1) + col).reshape(-1)
        packed = torch.cat([U.reshape(K, N, 18), Hpp_obs.reshape(K, N, 9), bp_obs],
                           dim=-1).reshape(K * N, 30)
        grouped = torch.zeros(K * (P + 1), 30, dtype=f32, device=dev).index_add_(
            0, flat, packed).reshape(K, P + 1, 30)[:, :P]           # [K, P, 30]
        A = grouped[..., :18].reshape(K, P, 6, 3)                  # per (k, p): J_c^T W J_p
        H_pp = grouped[..., 18:27].sum(0).reshape(P, 3, 3)
        b_p = grouped[..., 27:30].sum(0)                           # [P, 3]

        H_pp = H_pp + damping * (eye3 * H_pp) + 1e-6 * eye3
        Hpp_inv = inv3x3(H_pp) * pt_free_f[:, None, None]          # [P, 3, 3]

        # S = Hcc (block diagonal) - A Hpp^-1 A^T, one [6K, 3P] x [3P, 6K] product
        Ar = A.permute(0, 2, 1, 3).reshape(K * 6, P * 3)           # rows (k, a), cols (p, i)
        Br = torch.einsum("kpai,pij->kapj", A, Hpp_inv).reshape(K * 6, P * 3)
        S = torch.zeros(K * 6, K * 6, dtype=f32, device=dev)
        diag_cc = torch.eye(6, dtype=f32, device=dev) * H_cc
        S[blk[:, :, None], blk[:, None, :]] += H_cc + damping * diag_cc
        S = S - Br @ Ar.T
        S = torch.where(free6[:, None] & free6[None, :], S, 0.0)
        S = S + torch.diag(torch.where(free6, 1e-8, 1.0))

        c_p = torch.einsum("pij,pj->pi", Hpp_inv, b_p)             # [P, 3]
        rhs = ((-b_c).reshape(K * 6) + Ar @ c_p.reshape(P * 3)) * free6
        dx_c = torch.linalg.solve_ex(S, rhs)[0].reshape(K, 6)
        back = (dx_c.reshape(K * 6) @ Ar).reshape(P, 3)            # A^T dx_c
        dx_p = torch.einsum("pij,pj->pi", Hpp_inv, -b_p - back)
        ok = torch.all(torch.isfinite(dx_c)) & torch.all(torch.isfinite(dx_p))
        dx_c = torch.where(ok, dx_c, 0.0)
        dx_p = torch.where(ok, dx_p, 0.0)
        delta = torch.sum(dx_c * dx_c) + torch.sum(dx_p * dx_p)
        return se3.update_left(kf_Tcw, dx_c), pt_pos + dx_p, delta

    def stage(kf_Tcw, pt_pos, n_iters, use_huber, active):
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(n_iters):
            T_new, p_new, delta = iteration(kf_Tcw, pt_pos, active, use_huber)
            kf_Tcw = torch.where(done, kf_Tcw, T_new)
            pt_pos = torch.where(done, pt_pos, p_new)
            done = done | (delta <= 1e-8)
        return kf_Tcw, pt_pos

    active0 = obs_valid & (obs_pt >= 0)
    kf_Tcw, pt_pos = stage(kf_Tcw, pt_pos, n_iters_pre, True, active0.to(f32))

    # outlier removal between stages (reference Optimizer.cc:863-917)
    res, _, _, is_stereo = _residuals(cam, kf_Tcw, pt_pos, obs_pt, obs_uvr, active0.to(f32))
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    active1 = active0 & (_chi2(res, inv_sigma2, is_stereo) <= chi2_th)
    kf_Tcw, pt_pos = stage(kf_Tcw, pt_pos, n_iters_post, False, active1.to(f32))

    res, _, _, is_stereo = _residuals(cam, kf_Tcw, pt_pos, obs_pt, obs_uvr, active1.to(f32))
    chi2 = _chi2(res, inv_sigma2, is_stereo)
    inlier = active1 & (chi2 <= chi2_th)
    mean = torch.sum(torch.where(inlier, chi2, 0.0)) / torch.clamp_min(
        torch.sum(inlier), 1).to(f32)
    return BAResult(kf_Tcw=kf_Tcw, pt_pos=pt_pos, obs_inlier=inlier, mean_chi2=mean)
