"""Batched EPnP + RANSAC for relocalization.

Counterpart of the JAX package's ops/solvers/epnp.py (reference PnPsolver,
src/PnPsolver.cc): EPnP (4 control points, barycentric coordinates, 12x12
M'M eigendecomposition, compute_pose :684) wrapped in RANSAC (iterate :240).
All hypotheses are solved in one batch (control-point PCA, eigh and Horn
alignment are batched) and the best inlier count wins.  As in the JAX
package the betas case analysis is replaced by the dominant kernel vector
with a closed-form scale; the winner is refined by the robust pose optimizer
downstream (Tracking.cc:2127).

Differences in form, not in result:
  * the minimal sets are drawn with torch.multinomial from a caller-owned
    torch.Generator (the JAX package draws them from its PRNG key); a
    problem with no valid correspondence draws from a uniform distribution
    instead of an all-zero one, which torch refuses, and fails through its
    inlier count as it does there;
  * pnp_ransac_batch solves several problems (relocalization candidates) in
    one batch, so the three eigh calls see every hypothesis of every
    candidate at once;
  * a singular barycentric basis (a set that repeats a point, coplanar
    points) gives non-finite values through inv_ex without raising; such
    a hypothesis counts no inlier, because every comparison with NaN is
    false.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import se3
from ..camera import CameraParams
from .horn import horn_align


class PnPResult(NamedTuple):
    Tcw: torch.Tensor        # [4, 4] best hypothesis pose
    inliers: torch.Tensor    # [N] bool under best hypothesis
    n_inliers: torch.Tensor  # scalar int32
    success: torch.Tensor    # scalar bool


def _epnp_solve(pts_w: torch.Tensor, uv: torch.Tensor, cam: CameraParams):
    """EPnP for one batch of correspondence sets.

    pts_w [B, n, 3], uv [B, n, 2] -> (R [B, 3, 3], t [B, 3]).
    """
    B, n, _ = pts_w.shape
    # a set with a non-finite entry must lose, not raise: eigh refuses such input
    finite = (torch.all(torch.isfinite(pts_w.reshape(B, -1)), dim=1)
              & torch.all(torch.isfinite(uv.reshape(B, -1)), dim=1))
    pts_w = torch.where(finite[:, None, None], pts_w, 0.0)
    uv = torch.where(finite[:, None, None], uv, 0.0)
    # control points: centroid + principal axes (reference
    # choose_control_points :507)
    c0 = torch.mean(pts_w, dim=1, keepdim=True)
    centered = pts_w - c0
    cov = torch.einsum("bni,bnj->bij", centered, centered) / n
    vals, vecs = torch.linalg.eigh(cov)
    # scale axes by sqrt(eigenvalue) (descending)
    axes = vecs * torch.sqrt(torch.clamp_min(vals, 1e-12))[..., None, :]
    ctrl_w = torch.cat(
        [c0, c0 + axes[..., :, 2][:, None], c0 + axes[..., :, 1][:, None],
         c0 + axes[..., :, 0][:, None]], dim=1)  # [B, 4, 3]

    # barycentric coordinates (compute_barycentric_coordinates :572)
    basis = ctrl_w[:, 1:] - ctrl_w[:, :1]  # [B, 3, 3] rows = c_i - c_0
    eye3 = torch.eye(3, dtype=pts_w.dtype, device=pts_w.device)
    basis_inv = torch.linalg.inv_ex(basis.transpose(1, 2) + 1e-9 * eye3)[0]
    rel = pts_w - ctrl_w[:, :1]
    a123 = torch.einsum("bij,bnj->bni", basis_inv, rel)
    a0 = 1.0 - torch.sum(a123, dim=-1, keepdim=True)
    alphas = torch.cat([a0, a123], dim=-1)  # [B, n, 4]
    # nor may a singular basis raise
    finite = finite & torch.all(torch.isfinite(alphas.reshape(B, -1)), dim=1)
    alphas = torch.where(finite[:, None, None], alphas, 0.0)

    # M matrix (reference fill_M, columns ordered x0 y0 z0 x1 y1 z1 ...):
    # u-row of point i: sum_j alpha_ij * (fx*X_j + (cx-u_i)*Z_j)
    # v-row of point i: sum_j alpha_ij * (fy*Y_j + (cy-v_i)*Z_j)
    u = uv[..., 0]
    v = uv[..., 1]
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    zeros = torch.zeros_like(alphas)
    Mu = torch.stack([alphas * fx, zeros, alphas * (cx - u)[..., None]], dim=-1)
    Mv = torch.stack([zeros, alphas * fy, alphas * (cy - v)[..., None]], dim=-1)
    # [B, n, 4, 3] -> [B, n, 12] with (x, y, z) contiguous per control point
    M = torch.cat([Mu.reshape(B, n, 12), Mv.reshape(B, n, 12)], dim=1)

    MtM = torch.einsum("bki,bkj->bij", M, M)
    _, evecs = torch.linalg.eigh(MtM)
    kernel = evecs[..., :, 0]  # [B, 12]
    ctrl_c = kernel.reshape(B, 4, 3)

    # resolve scale + sign: match inter-control-point distances; positive depth
    def pdist(c):
        d = c[:, :, None, :] - c[:, None, :, :]
        return torch.sqrt(torch.clamp_min(torch.sum(d * d, -1), 1e-18))

    dw = pdist(ctrl_w)
    dc = pdist(ctrl_c)
    beta = torch.sum(dw * dc, dim=(1, 2)) / torch.clamp_min(
        torch.sum(dc * dc, dim=(1, 2)), 1e-12)
    ctrl_c = ctrl_c * beta[:, None, None]
    # sign: mean z of reconstructed points must be positive
    pts_c = torch.einsum("bnj,bjk->bnk", alphas, ctrl_c)
    sign = torch.where(torch.mean(pts_c[..., 2], dim=-1) < 0, -1.0, 1.0)
    ctrl_c = ctrl_c * sign[:, None, None]

    # R, t from world->camera control-point alignment (estimate_R_and_t)
    _, R, t = horn_align(ctrl_w, ctrl_c)
    nan = torch.full((), float("nan"), dtype=R.dtype, device=R.device)
    return (torch.where(finite[:, None, None], R, nan),
            torch.where(finite[:, None], t, nan))


def draw_minimal_sets(valid: torch.Tensor, n_hypotheses: int, min_set: int,
                      generator: torch.Generator | None) -> torch.Tensor:
    """[C, n] bool -> [C, n_hypotheses, min_set] indices drawn with
    replacement among each row's valid entries; a row with none draws
    uniformly (its hypotheses find no inlier)."""
    C, n = valid.shape
    probs = valid.to(torch.float32)
    probs = torch.where(torch.any(valid, dim=1, keepdim=True), probs, 1.0)
    rows = probs[:, None, :].expand(C, n_hypotheses, n).reshape(C * n_hypotheses, n)
    sets = torch.multinomial(rows, min_set, replacement=True, generator=generator)
    return sets.reshape(C, n_hypotheses, min_set)


def pnp_ransac_batch(cam: CameraParams, pts_w: torch.Tensor, uv: torch.Tensor,
                     valid: torch.Tensor, sigma2: torch.Tensor,
                     generator: torch.Generator | None = None,
                     n_hypotheses: int = 256, min_set: int = 6,
                     chi2_th: float = 5.991, min_inliers: int = 10) -> PnPResult:
    """RANSAC-EPnP for C problems over one set of pixels: pts_w [C, n, 3],
    valid [C, n]; uv [n, 2] and sigma2 [n] are shared.  Every field of the
    result carries a leading C."""
    C, n, _ = pts_w.shape
    sets = draw_minimal_sets(valid, n_hypotheses, min_set, generator)
    flat = sets.reshape(C, -1)
    set_pts = torch.gather(pts_w, 1, flat[..., None].expand(-1, -1, 3))
    R, t = _epnp_solve(set_pts.reshape(C * n_hypotheses, min_set, 3),
                       uv[flat].reshape(C * n_hypotheses, min_set, 2), cam)
    R = R.reshape(C, n_hypotheses, 3, 3)
    t = t.reshape(C, n_hypotheses, 3)

    # score all hypotheses against all correspondences
    pc = torch.einsum("cbij,cnj->cbni", R, pts_w) + t[:, :, None, :]
    z = pc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u_hat = cam.fx * pc[..., 0] / z_safe + cam.cx
    v_hat = cam.fy * pc[..., 1] / z_safe + cam.cy
    err2 = (u_hat - uv[:, 0]) ** 2 + (v_hat - uv[:, 1]) ** 2
    inl = ((err2 / torch.clamp_min(sigma2, 1e-9) < chi2_th) & (z > 0)
           & valid[:, None, :])
    counts = torch.sum(inl, dim=2)                   # [C, B]; 0 for a NaN pose
    best = torch.argmax(counts, dim=1)
    pick = best[:, None]
    n_best = counts.gather(1, pick)[:, 0]
    R_best = R.gather(1, pick[..., None, None].expand(C, 1, 3, 3))[:, 0]
    t_best = t.gather(1, pick[..., None].expand(C, 1, 3))[:, 0]
    # an all-NaN problem's winner is hypothesis 0 with 0 inliers: hand the
    # identity on, so the optimizer downstream starts from a finite pose
    bad = ~torch.all(torch.isfinite(R_best.reshape(C, -1)), dim=1) \
        | ~torch.all(torch.isfinite(t_best), dim=1)
    R_best = torch.where(bad[:, None, None], torch.eye(3, dtype=R.dtype, device=R.device),
                         R_best)
    t_best = torch.where(bad[:, None], 0.0, t_best)
    return PnPResult(
        Tcw=se3.rt_to_mat(R_best, t_best),
        inliers=inl.gather(1, pick[..., None].expand(C, 1, n))[:, 0],
        n_inliers=n_best.to(torch.int32),
        success=n_best >= min_inliers,
    )


def pnp_ransac(cam: CameraParams, pts_w: torch.Tensor, uv: torch.Tensor,
               valid: torch.Tensor, sigma2: torch.Tensor,
               generator: torch.Generator | None = None,
               n_hypotheses: int = 256, min_set: int = 6,
               chi2_th: float = 5.991, min_inliers: int = 10) -> PnPResult:
    """RANSAC-EPnP over matched (3D point, 2D pixel) pairs: pts_w [n, 3],
    uv [n, 2], valid [n], sigma2 [n].

    Reference: PnPsolver::iterate (:240) with chi2 5.991 scaled per octave
    (:181 SetRansacParameters).
    """
    res = pnp_ransac_batch(cam, pts_w[None], uv, valid[None], sigma2, generator,
                           n_hypotheses, min_set, chi2_th, min_inliers)
    return PnPResult(*(x[0] for x in res))
