"""Monocular two-view initialization: batched H/F RANSAC + motion recovery.

Counterpart of the JAX package's ops/solvers/two_view.py (reference
Initializer, src/Initializer.cc):

  * every RANSAC hypothesis for H (DLT) and F (8-point) is solved in one
    batched eigh / SVD call each (the reference iterates 200 times in two
    threads, :188-198);
  * model selection keeps the reference's symmetric-transfer scoring
    (CheckHomography :616 / CheckFundamental :813, thresholds 5.991 / 3.841)
    and the RH = SH / (SH + SF) > 0.40 rule (:203-210);
  * motion recovery: F -> E -> 4 decompositions (DecomposeE :1798) and
    H -> Faugeras' 8 hypotheses (ReconstructH :1135), each family checked in
    one batch by cheirality, parallax and reprojection (CheckRT :1578).

The minimal sets come from a torch.Generator the caller owns, or are handed
in, so that a test can give both packages the same hypotheses.  Eigenvector
and singular-vector signs differ between LAPACK, cuSOLVER and XLA: H and F
are defined up to scale, and the motion recovery fixes det(R) and tries both
signs of t, so outcomes agree.  initialize_two_view runs its solves in
float64 and its scoring in fp32, so that the card and the CPU pick the same
hypothesis from the same sets.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import se3
from ..camera import CameraParams
from ..indexing import row
from ..triangulate import camera_matrix, triangulate_linear
from .epnp import draw_minimal_sets


class TwoViewResult(NamedTuple):
    success: torch.Tensor          # scalar bool
    Tcw2: torch.Tensor             # [4, 4] pose of view 2 (view 1 = identity)
    points: torch.Tensor           # [N, 3] triangulated points
    is_triangulated: torch.Tensor  # [N] bool
    used_homography: torch.Tensor  # scalar bool
    n_good: torch.Tensor           # scalar int32


def _normalize(pts: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization (reference Initializer::Normalize :1501).  With
    no spread among the valid points (none valid, or all equal) the scale is
    1: the JAX package's 1e9 there overflows fp32 in A^T A, which XLA's eigh
    turns into NaN and LAPACK's into an exception."""
    w = valid.to(pts.dtype)
    n = torch.clamp_min(torch.sum(w), 1.0)
    mean = torch.sum(pts * w[:, None], dim=0) / n
    mean_dev = torch.sum(torch.abs(pts - mean) * w[:, None], dim=0) / n
    s = torch.where(mean_dev > 1e-9, 1.0 / mean_dev, 1.0)
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return (pts - mean) * s, T


def _sample_minimal_sets(valid: torch.Tensor, n_hyp: int,
                         generator: torch.Generator | None, set_size: int = 8):
    """[n_hyp, 8] indices drawn among the valid correspondences, with
    replacement (a collision merely wastes a hypothesis); with no valid
    correspondence the draw is uniform and every hypothesis loses."""
    return draw_minimal_sets(valid[None], n_hyp, set_size, generator)[0]


def _smallest_eigvec(A: torch.Tensor) -> torch.Tensor:
    """[..., k, 9] constraint rows -> the null direction [..., 9] of A^T A."""
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    _, vecs = torch.linalg.eigh(AtA)
    return vecs[..., :, 0]


def _solve_h_batch(p1: torch.Tensor, p2: torch.Tensor, weights=None) -> torch.Tensor:
    """DLT homographies for [B, 4+, 2] point sets -> [B, 3, 3] (reference
    ComputeH21 :1318).  Optional weights [B, n] zero out constraint rows
    (the all-inlier refit)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    zero, one = torch.zeros_like(x1), torch.ones_like(x1)
    rows_a = torch.stack([zero, zero, zero, -x1, -y1, -one, y2 * x1, y2 * y1, y2], -1)
    rows_b = torch.stack([x1, y1, one, zero, zero, zero, -x2 * x1, -x2 * y1, -x2], -1)
    if weights is not None:
        rows_a = rows_a * weights[..., None]
        rows_b = rows_b * weights[..., None]
    h = _smallest_eigvec(torch.cat([rows_a, rows_b], dim=-2))  # [B, 2n, 9] rows
    return h.reshape(*h.shape[:-1], 3, 3)


def _solve_f_batch(p1: torch.Tensor, p2: torch.Tensor, weights=None) -> torch.Tensor:
    """8-point fundamental matrices [B, 8+, 2] -> [B, 3, 3] with the rank-2
    projection (reference ComputeF21 :1390)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], -1)
    if weights is not None:
        A = A * weights[..., None]
    f = _smallest_eigvec(A).reshape(-1, 3, 3)
    U, S, Vt = torch.linalg.svd(f)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ (S[..., :, None] * Vt)


def _apply(M: torch.Tensor, a: torch.Tensor):
    """Rows of M [B, 3, 3] applied to homogeneous a [N, 2] -> three [B, N]."""
    ax, ay = a[None, :, 0], a[None, :, 1]
    return tuple(M[:, i, 0, None] * ax + M[:, i, 1, None] * ay + M[:, i, 2, None]
                 for i in range(3))


def _score_h(H, Hinv, p1, p2, valid, sigma: float = 1.0):
    """Symmetric transfer score (reference CheckHomography :616, th 5.991).
    A non-finite H or inverse scores nothing."""
    th = 5.991
    inv_s2 = 1.0 / (sigma * sigma)

    def transfer(M, a, b):
        x, y, w = _apply(M, a)
        w = torch.where(torch.abs(w) < 1e-9, 1e-9, w)
        return ((x / w - b[None, :, 0]) ** 2 + (y / w - b[None, :, 1]) ** 2) * inv_s2

    c1 = transfer(H, p1, p2)
    c2 = transfer(Hinv, p2, p1)
    ok = (c1 < th) & (c2 < th) & valid
    score = torch.where(ok, (th - c1) + (th - c2), 0.0)
    return torch.sum(score, dim=-1), ok


def _score_f(F, p1, p2, valid, sigma: float = 1.0):
    """Symmetric epipolar score (reference CheckFundamental :813, th 3.841
    gating / 5.991 scoring)."""
    th = 3.841
    th_score = 5.991
    inv_s2 = 1.0 / (sigma * sigma)

    def epi(Fm, a, b):
        # distance of b to the epipolar lines Fm @ a -> [B, N]
        l0, l1, l2 = _apply(Fm, a)
        num = (b[None, :, 0] * l0 + b[None, :, 1] * l1 + l2) ** 2
        return num / torch.clamp_min(l0 * l0 + l1 * l1, 1e-12) * inv_s2

    c1 = epi(F, p1, p2)
    c2 = epi(F.transpose(-1, -2), p2, p1)
    ok = (c1 < th) & (c2 < th) & valid
    score = (torch.where(c1 < th, th_score - c1, 0.0)
             + torch.where(c2 < th, th_score - c2, 0.0))
    return torch.sum(torch.where(valid, score, 0.0), dim=-1), ok


def _check_rt(cam: CameraParams, R, t, p1, p2, valid, sigma: float = 1.0):
    """Cheirality + parallax + reprojection check of C motion hypotheses
    (R [C, 3, 3], t [C, 3]) over all correspondences (reference CheckRT
    :1578).  Returns (n_good [C], good [C, N], points [C, N, 3], parallax in
    degrees [C])."""
    K = camera_matrix(cam, R.device)
    P1 = K @ torch.eye(4, dtype=R.dtype, device=R.device)[:3, :4]
    P2 = K @ se3.rt_to_mat(R, t)[:, :3, :4]
    pts = triangulate_linear(p1, p2, P1.expand_as(P2)[:, None], P2[:, None])  # [C, N, 3]
    finite = torch.all(torch.isfinite(pts), dim=-1)

    c2 = -torch.einsum("cji,cj->ci", R, t)                     # -R^T t
    ray2 = pts - c2[:, None]
    n1 = torch.linalg.norm(pts, dim=-1)
    n2 = torch.linalg.norm(ray2, dim=-1)
    cos_par = torch.sum(pts * ray2, dim=-1) / torch.clamp_min(n1 * n2, 1e-9)

    z1 = pts[..., 2]
    pc2 = torch.einsum("cij,cnj->cni", R, pts) + t[:, None]
    z2 = pc2[..., 2]

    def reproj_err2(pc, z, uv):
        z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        u = cam.fx * pc[..., 0] / z + cam.cx
        v = cam.fy * pc[..., 1] / z + cam.cy
        return (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2

    th2 = 4.0 * sigma * sigma
    good = (valid & finite & (z1 > 0) & (z2 > 0) & (cos_par < 0.99998)
            & (reproj_err2(pts, z1, p1) < th2) & (reproj_err2(pc2, z2, p2) < th2))
    n_good = torch.sum(good, dim=-1)
    # parallax of the 50th-best (the reference takes the min(50, n)-th)
    par = torch.where(good, torch.arccos(torch.clamp(cos_par, -1.0, 1.0)), 0.0)
    par_sorted, _ = torch.sort(par, dim=-1, descending=True)
    idx50 = torch.clamp(n_good - 1, 0, 49)
    return n_good, good, pts, torch.rad2deg(par_sorted.gather(-1, idx50[:, None])[:, 0])


def _decompose_e(E: torch.Tensor):
    """E -> (R1, R2, t) candidates (reference DecomposeE :1798)."""
    U, _, Vt = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))      # proper rotations
    R2 = U @ W.T @ Vt
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    t = U[:, 2]
    return R1, R2, t / torch.clamp_min(torch.linalg.norm(t), 1e-9)


def _pick_motion(cam, Rs, ts, p1, p2, inliers, sigma, min_points, min_parallax,
                 margin: float):
    """The best of the motion hypotheses (Rs [C, 3, 3], unit ts [C, 3]) and
    whether it is accepted (reference :1090-1130): a clear winner over the
    second-best count, enough points, enough parallax.  argmax takes the
    first maximum."""
    n_goods, good, pts, par = _check_rt(cam, Rs, ts, p1, p2, inliers, sigma)
    best = torch.argmax(n_goods)
    n_best = row(n_goods, best)
    n_second = torch.sort(n_goods)[0][-2]
    n_inl = torch.sum(inliers)
    ok = ((n_best > margin * torch.clamp_min(n_second, 1))
          & (n_best >= torch.clamp_min(0.9 * n_inl, min_points))
          & (row(par, best) > min_parallax))
    return (ok, se3.rt_to_mat(row(Rs, best), row(ts, best)), row(pts, best),
            row(good, best), n_best)


def _reconstruct_f(cam, F, p1, p2, inliers, sigma=1.0, min_points=50, min_parallax=1.0):
    """Pick the best of the 4 E decompositions (reference ReconstructF :956).
    The decomposition runs in F's dtype, the checks in the points'."""
    K = camera_matrix(cam, F.device).to(F.dtype)
    R1, R2, t = _decompose_e(K.T @ F @ K)
    return _pick_motion(cam, torch.stack([R1, R1, R2, R2]).to(p1.dtype),
                        torch.stack([t, -t, t, -t]).to(p1.dtype),
                        p1, p2, inliers, sigma, min_points, min_parallax, 0.7)


def _reconstruct_h(cam, H, p1, p2, inliers, sigma=1.0, min_points=50, min_parallax=1.0):
    """Faugeras decomposition: 8 motion hypotheses from H (reference
    ReconstructH :1135), decomposed in H's dtype, checked in the points'."""
    K = camera_matrix(cam, H.device).to(H.dtype)
    A = torch.linalg.inv(K) @ H @ K
    U, w, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]

    def sqrt0(x):
        return torch.sqrt(torch.clamp_min(x, 0.0))

    aux1 = sqrt0((d1 * d1 - d2 * d2) / torch.clamp_min(d1 * d1 - d3 * d3, 1e-12))
    aux3 = sqrt0((d2 * d2 - d3 * d3) / torch.clamp_min(d1 * d1 - d3 * d3, 1e-12))
    sign = lambda *sg: torch.tensor(sg, dtype=H.dtype, device=H.device)  # noqa: E731
    x1s = aux1 * sign(1, 1, -1, -1)
    x3s = aux3 * sign(1, -1, 1, -1)
    root = sqrt0((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3))
    flip = sign(1, -1, -1, 1)
    zero, one = torch.zeros_like(x1s), torch.ones_like(x1s)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)  # [4, 3, 3]

    # case d' > 0
    den = torch.clamp_min((d1 + d3) * d2, 1e-12)
    sts = root / den * flip
    ct = (d2 * d2 + d1 * d3) / den * one
    Rp_pos = mat([[ct, zero, -sts], [zero, one, zero], [sts, zero, ct]])
    tp_pos = (d1 - d3) * torch.stack([x1s, zero, -x3s], dim=-1)
    # case d' < 0
    den = torch.clamp_min((d1 - d3) * d2, 1e-12)
    sps = root / den * flip
    cp = (d1 * d3 - d2 * d2) / den * one
    Rp_neg = mat([[cp, zero, sps], [zero, -one, zero], [sps, zero, -cp]])
    tp_neg = (d1 + d3) * torch.stack([x1s, zero, x3s], dim=-1)

    Rs = s * (U @ torch.cat([Rp_pos, Rp_neg]) @ Vt)                   # [8, 3, 3]
    ts = torch.cat([tp_pos, tp_neg]) @ U.T                            # U @ tp
    ts = ts / torch.clamp_min(torch.linalg.norm(ts, dim=-1, keepdim=True), 1e-9)
    return _pick_motion(cam, Rs.to(p1.dtype), ts.to(p1.dtype), p1, p2, inliers, sigma,
                        min_points, min_parallax, 0.75)


def _inv_or_nan(M: torch.Tensor) -> torch.Tensor:
    """Batched inverse; a singular matrix gives NaN (it then scores nothing)
    instead of raising."""
    inv, info = torch.linalg.inv_ex(M)
    return torch.where((info == 0)[..., None, None], inv, torch.nan)


def initialize_two_view(cam: CameraParams, uv1: torch.Tensor, uv2: torch.Tensor,
                        valid: torch.Tensor, generator: torch.Generator | None = None,
                        n_hypotheses: int = 256, sigma: float = 1.0,
                        min_points: int = 50, min_parallax: float = 1.0,
                        sets: torch.Tensor | None = None) -> TwoViewResult:
    """Full monocular bootstrap from matched pixel pairs: uv1 / uv2 [N, 2]
    matched undistorted pixels, valid [N] (reference Initializer::Initialize,
    src/Initializer.cc:68-231, 200 hypotheses; here n_hypotheses solved at
    once).  `sets` [n_hypotheses, 8]: the minimal sets to use instead of
    drawing them from `generator`."""
    n1, T1n = _normalize(uv1, valid)
    n2, T2n = _normalize(uv2, valid)
    if sets is None:
        sets = _sample_minimal_sets(valid, n_hypotheses, generator)
    # Every solve (the minimal sets, the refit below, the denormalization and
    # the decomposition into motions) runs in float64: they are 9x9
    # eigenproblems and 3x3 products, and in fp32 the null direction of an
    # 8-row A^T A moves between LAPACK and cuSOLVER by enough to change which
    # hypothesis wins and, through its inlier set, the translation direction
    # by several 1e-3.  Scoring and the motion checks over all points stay in
    # fp32.
    dt = uv1.dtype
    n1d, n2d, T1d, T2d = n1.double(), n2.double(), T1n.double(), T2n.double()
    T2d_inv = torch.linalg.inv(T2d)
    s1, s2 = n1d[sets], n2d[sets]                    # [B, 8, 2]
    H = (T2d_inv @ _solve_h_batch(s1, s2) @ T1d).to(dt)   # denormalize (reference :1336)
    F = (T2d.T @ _solve_f_batch(s1, s2) @ T1d).to(dt)

    h_scores, h_inl = _score_h(H, _inv_or_nan(H), uv1, uv2, valid, sigma)
    f_scores, f_inl = _score_f(F, uv1, uv2, valid, sigma)
    bh = torch.argmax(h_scores)                      # first maximum
    bf = torch.argmax(f_scores)
    SH, SF = row(h_scores, bh), row(f_scores, bf)
    use_h = SH / torch.clamp_min(SH + SF, 1e-9) > 0.40   # reference :203-210

    # Refit the winning models on all their inliers (masked full DLT): the
    # minimal-set estimate is too noisy to survive CheckRT's 4 sigma^2 gate.
    def refit(solver, inliers):
        return solver(n1d[None], n2d[None], inliers.double()[None])[0]

    H_best = T2d_inv @ refit(_solve_h_batch, row(h_inl, bh)) @ T1d
    F_best = T2d.T @ refit(_solve_f_batch, row(f_inl, bf)) @ T1d
    H32, F32 = H_best.to(dt)[None], F_best.to(dt)[None]
    _, h_inl_r = _score_h(H32, _inv_or_nan(H32), uv1, uv2, valid, sigma)
    _, f_inl_r = _score_f(F32, uv1, uv2, valid, sigma)

    res_h = _reconstruct_h(cam, H_best, uv1, uv2, h_inl_r[0], sigma, min_points,
                           min_parallax)
    res_f = _reconstruct_f(cam, F_best, uv1, uv2, f_inl_r[0], sigma, min_points,
                           min_parallax)
    success, Tcw2, pts, good, n_good = (torch.where(use_h, a, b)
                                        for a, b in zip(res_h, res_f))
    return TwoViewResult(success=success, Tcw2=Tcw2, points=pts, is_triangulated=good,
                         used_homography=use_h, n_good=n_good.to(torch.int32))
