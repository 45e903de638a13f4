"""Distributed bundle adjustment over a mesh of ranks.

Counterpart of the JAX package's parallel/distributed_ba.py: the
Schur-complement reduction of ops/optim/bundle_adjust.py, sharded:

  * the "map" axis is data parallelism over independent maps (each map's BA
    is independent: multi-sequence processing);
  * the "blk" axis shards the map points of ONE map: each rank owns a stripe
    of points, builds that stripe's H_pp / b_p / cross blocks, and the
    reduced camera system S = Hcc - A Hpp^-1 A^T is summed over the ranks
    with all_reduce.  Point positions are exchanged with one all_gather per
    iteration; camera updates are computed identically on every rank (a
    replicated solve of the small [6K, 6K] system).

The JAX shard_map body becomes one SPMD program per rank: the public
function takes the full [S, ...] tensors on every rank, each rank slices its
map rows and point stripe, runs the body and all-gathers the result, so
every rank returns what one device would.

Every iteration is Huber-weighted, with ur_weight as the square-root weight
on the third residual; there is no early exit (the JAX fori_loop).  The
cross block A of a stripe is dense, [6K, 3 Pl] (1.21 GB in fp32 at K = 256,
Pl = 65536), built by index_add_ into its flattened rows, and S_partial is
one [6K, 3 Pl] @ [3 Pl, 6K] product; no [Pl, 6K, 6K] tensor is formed.  A
non-finite step is dropped on every rank together (the JAX body decides per
device on its own stripe; one flag summed over "blk" keeps the replicated
poses equal).  index_add_ sums in a nondeterministic order on the card, and
all_reduce sums the ranks' partials in its own order, so results across
devices and world sizes agree to a tolerance, not to the bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import se3
from ..ops.camera import CameraParams
from ..ops.optim.bundle_adjust import _chi2, _residuals, inv3x3
from ..ops.optim.robust import CHI2_MONO, CHI2_STEREO, huber_weight
from .mesh import Mesh, map_sharding, point_block_sharding, shard, unshard


class DistBAResult(NamedTuple):
    kf_Tcw: torch.Tensor  # [S, K, 4, 4]
    pt_pos: torch.Tensor  # [S, P, 3]


def _ba_one_map(mesh: Mesh, cam: CameraParams, n_iters: int, damping: float,
                ur_weight: float, kf_Tcw, pt_stripe, obs_pt, obs_uvr, obs_sigma2,
                obs_valid, kf_free, pt_free):
    """One map on this rank: kf_Tcw [K, 4, 4] (replicated over "blk"),
    pt_stripe [Pl, 3] (this rank's points), obs_* [K, N], kf_free [K],
    pt_free [P] (every point's flag)."""
    K, N = obs_pt.shape
    Pl = pt_stripe.shape[0]
    P = pt_free.shape[0]
    lo = mesh.axis_index("blk") * Pl
    dev, f32 = pt_stripe.device, torch.float32
    inv_sigma2 = 1.0 / torch.clamp_min(obs_sigma2, 1e-9)
    sw = torch.tensor([1.0, 1.0, ur_weight**0.5], dtype=f32, device=dev)
    active = (obs_valid & (obs_pt >= 0)).to(f32)
    chi2_th = torch.where(obs_uvr[..., 2] >= 0.0, CHI2_STEREO, CHI2_MONO)
    pid = torch.clamp(obs_pt, 0, P - 1).long()
    # ownership: this rank accumulates the observations of its point stripe
    mine = (pid >= lo) & (pid < lo + Pl) & (active > 0)
    pid_local = torch.where(mine, pid - lo, 0)
    # flattened rows of A [K, 6, Pl, 3] (rows (k, a), columns (p, i)) and of
    # the per-point blocks [Pl, 12]
    k_idx = torch.arange(K, device=dev)[:, None, None]
    a_idx = torch.arange(6, device=dev)[None, :, None]
    rows_A = ((k_idx * 6 + a_idx) * Pl + pid_local[:, None, :]).reshape(-1)   # [K*6*N]
    rows_P = pid_local.reshape(-1)
    free6 = kf_free.repeat_interleave(6)
    pt_free_l = pt_free[lo: lo + Pl].to(f32)
    J_p_free = pt_free.to(f32)[pid][..., None, None]
    kf_free_f = kf_free.to(f32)[:, None, None, None]
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)
    blk = torch.arange(K * 6, device=dev).reshape(K, 6)
    diag_free = torch.diag(torch.where(free6, 1e-8, 1.0))

    for _ in range(n_iters):
        pt_full = mesh.all_gather(pt_stripe, "blk")                # one exchange per iteration
        res, J_c, J_p, is_stereo = _residuals(cam, kf_Tcw, pt_full, obs_pt, obs_uvr, active)
        res = res * sw
        J_c = J_c * sw[:, None] * kf_free_f
        J_p = J_p * sw[:, None] * J_p_free
        chi2 = _chi2(res, inv_sigma2, is_stereo)
        w = inv_sigma2 * huber_weight(chi2, chi2_th) * active
        wm = torch.where(mine, w, 0.0)
        Wres = res * wm[..., None]
        Jw_c = J_c * wm[..., None, None]

        H_cc = torch.einsum("knia,knib->kab", Jw_c, J_c)           # [K, 6, 6]
        b_c = torch.einsum("knia,kni->ka", J_c, Wres)              # [K, 6]
        U = torch.einsum("knia,knib->kanb", Jw_c, J_p)             # [K, 6, N, 3]
        Hpp_obs = torch.einsum("knia,knib->knab", J_p * wm[..., None, None], J_p)
        bp_obs = torch.einsum("knia,kni->kna", J_p, Wres)
        # exact zeros for the observations of other stripes (no NaN leaks in)
        U = torch.where(mine[:, None, :, None], U, 0.0)
        per_pt = torch.where(mine[..., None], torch.cat([Hpp_obs.reshape(K, N, 9), bp_obs], -1),
                             0.0)
        A = torch.zeros(K * 6 * Pl, 3, dtype=f32, device=dev).index_add_(
            0, rows_A, U.reshape(-1, 3)).view(K * 6, Pl * 3)       # [6K, 3Pl]
        blocks = torch.zeros(Pl, 12, dtype=f32, device=dev).index_add_(
            0, rows_P, per_pt.reshape(-1, 12))
        H_pp = blocks[:, :9].reshape(Pl, 3, 3)
        b_p = blocks[:, 9:]

        H_pp = H_pp + damping * (eye3 * H_pp) + 1e-6 * eye3
        Hpp_inv = inv3x3(H_pp) * pt_free_l[:, None, None]
        B = torch.einsum("rpi,pij->rpj", A.view(K * 6, Pl, 3), Hpp_inv).reshape(K * 6, Pl * 3)
        S = -(B @ A.T)                                             # -A Hpp^-1 A^T
        S[blk[:, :, None], blk[:, None, :]] += H_cc + damping * (eye6 * H_cc)
        rhs = (-b_c).reshape(K * 6) + B @ b_p.reshape(Pl * 3)
        # the reduced camera system, summed over the point stripes
        S = mesh.psum(S, "blk")
        rhs = mesh.psum(rhs, "blk")

        S = torch.where(free6[:, None] & free6[None, :], S, 0.0) + diag_free
        dx_c = torch.linalg.solve_ex(S, rhs * free6)[0].reshape(K, 6)
        back = (dx_c.reshape(K * 6) @ A).reshape(Pl, 3)            # A^T dx_c
        dx_p = torch.einsum("pij,pj->pi", Hpp_inv, -b_p - back)
        bad = (~torch.isfinite(dx_c)).any() | (~torch.isfinite(dx_p)).any()
        ok = mesh.psum(bad.to(f32)[None], "blk")[0] == 0
        kf_Tcw = se3.update_left(kf_Tcw, torch.where(ok, dx_c, 0.0))
        pt_stripe = pt_stripe + torch.where(ok, dx_p, 0.0)
    return kf_Tcw, pt_stripe


def distributed_bundle_adjust(
    mesh: Mesh,
    cam: CameraParams,
    kf_Tcw: torch.Tensor,     # [S, K, 4, 4]
    pt_pos: torch.Tensor,     # [S, P, 3]  (P divisible by mesh "blk")
    obs_pt: torch.Tensor,     # [S, K, N]
    obs_uvr: torch.Tensor,    # [S, K, N, 3]
    obs_sigma2: torch.Tensor, # [S, K, N]
    obs_valid: torch.Tensor,  # [S, K, N]
    kf_free: torch.Tensor,    # [S, K]
    pt_free: torch.Tensor,    # [S, P]
    n_iters: int = 10,
    damping: float = 1e-4,
    ur_weight: float = 1.0,
) -> DistBAResult:
    """Sharded BA over ("map", "blk"), called on every rank of the mesh with
    the same full tensors.  Returns DistBAResult of the full [S, ...]."""
    mesh = mesh.for_this_rank()
    rows, stripes = map_sharding(mesh), point_block_sharding(mesh)
    mine = [shard(x, rows) for x in (kf_Tcw, obs_pt, obs_uvr, obs_sigma2, obs_valid, kf_free,
                                     pt_free)]
    pt_l = shard(pt_pos, stripes)
    outs = [_ba_one_map(mesh, cam, n_iters, damping, ur_weight, T, p, *rest)
            for T, p, *rest in zip(mine[0], pt_l, *mine[1:])]
    new_kf = torch.stack([o[0] for o in outs])
    new_pt = torch.stack([o[1] for o in outs])
    return DistBAResult(kf_Tcw=unshard(new_kf, rows), pt_pos=unshard(new_pt, stripes))
