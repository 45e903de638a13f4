"""Local mapping: the pass that runs after each keyframe insertion.

Counterpart of the JAX package's models/local_mapping.py (reference
LocalMapping::Run, src/LocalMapping.cc:72-167).  _process runs the stages in
the JAX order: cull recent points (MapPointCulling), triangulate new points
against covisible keyframes (CreateNewMapPoints), fuse (SearchInNeighbors +
ORBmatcher::Fuse), refresh the new keyframe's points (ProcessNewKeyFrame),
local bundle adjustment, cull one redundant keyframe (KeyFrameCulling), and
rebuild the incidence cache.  Four stages, create_new_points,
fuse_into_keyframe, refresh_observed_points and local_bundle_adjustment,
stamp their start and end into rings of their own (utils/profiling.stamp),
where they run: op by op, in the per-frame tail graph and inside the chunk
graph.

Where PyTorch does not give what XLA gives, the rule is explicit:
  * scatter-sets with duplicate indices keep the update that comes last, as
    XLA's sequential CPU scatter does (indexing.set_drop picks it with a
    max-index reduce, so the card picks the same winner);
  * mode="drop" sink indices (max_pt + 1, max_kf + 1) become -1 and are
    dropped by the helpers, never indexed;
  * lax.top_k is a stable descending sort (indexing.top_k): empty window
    slots take the lowest-index zero-count keyframes and are masked by their
    zero counts, as in the JAX code;
  * the JAX vmaps over keyframes are a leading batch dim (torch.vmap for the
    frustum test).
Each stage returns a new MapState; add_points writes the keyframe's
observation row in place, so callers hand the map forward and keep no older
reference to it, as with insert_keyframe.
"""

from __future__ import annotations

import torch

from ..ops import constants, se3
from ..ops.camera import in_frustum, project
from ..ops.indexing import (add_drop, index_add_fixed, indicator, nonzero_padded, row,
                            set_drop, top_k)
from ..ops.matching import core as mcore
from ..ops.matching.hamming import hamming_distance
from ..ops.optim.bundle_adjust import bundle_adjust
from ..ops.triangulate import camera_matrix, projection_matrix, triangulate_linear_fast
from ..utils import profiling
from . import map_state as ms
from .config import SlamConfig
from .map_state import MapState

MAX_OBS_TABLE = 12  # observation descriptors per point entering the median


def _set_at(arr: torch.Tensor, i: torch.Tensor, val) -> torch.Tensor:
    """arr.at[i].set(val) for a 0-d index tensor (-1 drops the write)."""
    val = val.to(arr.dtype) if torch.is_tensor(val) else arr.new_full((), val)
    return set_drop(arr, i.reshape(1), val.expand(arr.shape[1:])[None])


def _scale_tables(config: SlamConfig, device):
    sf = constants.scale_factors(config.orb, device)
    return sf, sf * sf


def _predict_level(config: SlamConfig, ref_dist: torch.Tensor,
                   dist: torch.Tensor) -> torch.Tensor:
    """Predicted octave (MapPoint::PredictScale, src/MapPoint.cc:551):
    ceil(log(ref_dist / dist) / log(scale_factor)), clipped to the pyramid."""
    ratio = torch.clamp_min(ref_dist, 1e-6) / torch.clamp_min(dist, 1e-6)
    log_sf = constants.log_scale_factor(config.orb.scale_factor, dist.device)
    return torch.clamp(torch.ceil(torch.log(ratio) / log_sf).to(torch.int32), 0,
                       config.orb.n_levels - 1)


def refresh_observed_points(config: SlamConfig, m: MapState,
                            kf_id: torch.Tensor) -> MapState:
    """Representative descriptor, mean viewing normal and distance band of
    the points the new keyframe observes (reference ProcessNewKeyFrame,
    src/LocalMapping.cc:198-259; MapPoint::ComputeDistinctiveDescriptors and
    UpdateNormalAndDepth, src/MapPoint.cc:359-533)."""
    P, N = m.max_pt, m.feat_cap
    dev = m.pt_valid.device
    i32 = torch.int32
    ids = row(m.kf_obs_pt, kf_id)
    ok = (ids >= 0) & row(m.kf_feat_valid, kf_id)
    idx = torch.where(ok, ids, -1)

    # point id -> target row (its feature index in the new keyframe)
    lut = set_drop(torch.full((P,), -1, dtype=i32, device=dev), idx,
                   torch.arange(N, dtype=i32, device=dev))
    obs_ok = (m.kf_obs_pt >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    tgt = torch.where(obs_ok, lut[m.kf_obs_pt.clamp(0, P - 1).long()], -1)   # [K, N]
    hit = tgt >= 0

    # mean viewing normal over all observations
    centers = ms.keyframe_positions(m)
    pos_t = m.pt_pos[ids.clamp(0, P - 1).long()]                           # [N, 3]
    rays = pos_t[tgt.clamp(0, N - 1).long()] - centers[:, None, :]          # [K, N, 3]
    rays = rays / torch.clamp_min(torch.linalg.norm(rays, dim=-1, keepdim=True), 1e-9)
    normal_sum = index_add_fixed(torch.zeros(N, 3, dtype=torch.float32, device=dev), 0,
                                 tgt.reshape(-1), rays.reshape(-1, 3))   # misses dropped
    mean_normal = normal_sum / torch.clamp_min(
        torch.linalg.norm(normal_sum, dim=-1, keepdim=True), 1e-9)

    # distinctive descriptor: the observation of least median Hamming
    # distance to the others.  An observation's slot is the count of earlier
    # keyframes with a hit at the same feature index (the JAX package's
    # cumsum over the keyframe axis), capped at MAX_OBS_TABLE.
    O = MAX_OBS_TABLE
    ind = hit.to(i32)
    slots = torch.cumsum(ind, dim=0) - ind
    flat_pos = torch.where(hit & (slots < O), tgt * O + slots, -1)
    table = set_drop(torch.zeros(N * O, 8, dtype=i32, device=dev), flat_pos,
                     m.kf_desc).reshape(N, O, 8)
    filled = indicator(N * O, flat_pos.reshape(-1)).reshape(N, O)
    n_obs = filled.sum(dim=1)
    big = 1 << 20
    dmat = hamming_distance(table[:, :, None, :], table[:, None, :, :])     # [N, O, O]
    dmat = torch.where(filled[:, None, :], dmat, big)
    dsorted = torch.sort(dmat, dim=-1).values
    med_idx = torch.clamp(torch.div(n_obs - 1, 2, rounding_mode="floor"), 0, O - 1)
    medians = torch.gather(dsorted, 2, med_idx[:, None, None].expand(N, O, 1))[..., 0]
    medians = torch.where(filled, medians, big)
    best_obs = torch.argmin(medians, dim=-1)                                # first minimum
    best_desc = table[torch.arange(N, device=dev), best_obs]
    best_desc = torch.where((n_obs > 0)[:, None], best_desc, row(m.kf_desc, kf_id))

    # distance band anchored on the new observation
    sf, _ = _scale_tables(config, dev)
    dist = torch.linalg.norm(pos_t - row(centers, kf_id), dim=-1)
    max_dist = dist * sf[row(m.kf_level, kf_id).long()]
    min_dist = max_dist / sf[config.orb.n_levels - 1]
    return m._replace(
        pt_desc=set_drop(m.pt_desc, idx, best_desc),
        pt_normal=set_drop(m.pt_normal, idx, mean_normal),
        pt_max_dist=set_drop(m.pt_max_dist, idx, max_dist),
        pt_min_dist=set_drop(m.pt_min_dist, idx, min_dist),
        pt_found=add_drop(m.pt_found, idx, 1),
        pt_visible=add_drop(m.pt_visible, idx, 1),
    )


def cull_points(config: SlamConfig, m: MapState, kf_id: torch.Tensor) -> MapState:
    """Remove unreliable recent points (reference MapPointCulling,
    src/LocalMapping.cc:261-310): found ratio < 0.25, or two keyframes after
    birth still observed by <= 2 keyframes (points born with the first
    keyframe exempt); their observations are scrubbed, since the free-list
    allocator reuses the slots."""
    found_ratio = m.pt_found.to(torch.float32) / torch.clamp_min(
        m.pt_visible.to(torch.float32), 1.0)
    age = row(m.kf_seq, kf_id) - m.pt_first_kf
    bad = m.pt_valid & ((found_ratio < 0.25)
                        | ((age >= 2) & (m.pt_obs <= 2) & (m.pt_first_kf > 0)))
    stale = (m.kf_obs_pt >= 0) & bad[m.kf_obs_pt.clamp(0, m.max_pt - 1).long()]
    return m._replace(pt_valid=m.pt_valid & ~bad,
                      kf_obs_pt=torch.where(stale, ms.NO_POINT, m.kf_obs_pt))


def fuse_into_keyframe(config: SlamConfig, m: MapState, kf_id: torch.Tensor,
                       counts: torch.Tensor | None = None,
                       obs_count: torch.Tensor | None = None) -> MapState:
    """Project the covisible neighbourhood's points into the new keyframe and
    its points into the neighbours; a match on a free feature adds an
    observation, one on an occupied feature merges the pair into the point
    with more observations (reference SearchInNeighbors + ORBmatcher::Fuse,
    src/LocalMapping.cc:628-779, src/ORBmatcher.cc:1020-1177)."""
    cam = config.camera
    K, P, N = m.max_kf, m.max_pt, m.feat_cap
    dev = m.pt_valid.device
    i32 = torch.int32
    sf, _ = _scale_tables(config, dev)
    bounds = (0.0, float(cam.width), 0.0, float(cam.height))
    kf_range = torch.arange(K, device=dev)

    if counts is None:
        counts = ms.covisibility_row(m, row(m.kf_obs_pt, kf_id))
    counts = _set_at(counts, kf_id, 0)
    # 10 (stereo / RGB-D) or 20 (mono) first-order + 5 second-order neighbours
    topv1, topi1 = top_k(counts, min(20 if config.sensor == "mono" else 10, K))
    first_mask = set_drop(torch.zeros(K, dtype=torch.bool, device=dev), topi1, topv1 > 0)
    nb_pts = ms.points_of_keyframes_cached(m, first_mask)
    counts2 = ms.covisibility_of_points_cached(m, nb_pts)
    counts2 = torch.where(first_mask | (kf_range == kf_id), 0, counts2)
    topv2, topi2 = top_k(counts2, min(5, K))
    topv = torch.cat([topv1, topv2])
    topi = torch.cat([topi1, topi2])
    neigh_mask = set_drop(torch.zeros(K, dtype=torch.bool, device=dev), topi, topv > 0)

    cand_mask = ms.points_of_keyframes_cached(m, neigh_mask)
    cand_mask &= ~indicator(P, row(m.kf_obs_pt, kf_id))
    cand = nonzero_padded(cand_mask, config.caps.local_points, P)
    cand_ok = cand < P
    cand_c = cand.clamp(0, P - 1)

    vis, uv, dist, _ = in_frustum(cam, row(m.kf_Tcw, kf_id), m.pt_pos[cand_c],
                                  m.pt_normal[cand_c], m.pt_min_dist[cand_c] * 0.8,
                                  m.pt_max_dist[cand_c] * 1.2, bounds, view_cos_limit=0.5)
    vis &= cand_ok
    pred_level = _predict_level(config, m.pt_max_dist[cand_c] / 1.2, dist)
    radius = 3.0 * sf[pred_level.long()]           # reference Fuse th = 3 (:1044)
    kf_desc = row(m.kf_desc, kf_id)
    mask = (mcore.window_mask(uv, row(m.kf_xy, kf_id), radius)
            & mcore.level_mask(pred_level, row(m.kf_level, kf_id), -1, 1))
    match = mcore.mutual_best_match(m.pt_desc[cand_c], kf_desc, mask, vis,
                                    row(m.kf_feat_valid, kf_id), max_dist=mcore.TH_LOW,
                                    ratio=None)
    own_row = row(m.kf_obs_pt, kf_id)
    occupied = own_row[match.idx.clamp(0, N - 1).long()]
    hit_free = match.valid & (occupied < 0)
    hit_occ = match.valid & (occupied >= 0)

    # free features: bind the candidate point
    new_row = set_drop(own_row, torch.where(hit_free, match.idx, -1),
                       torch.where(hit_free, cand, -1).to(i32))
    m = m._replace(kf_obs_pt=_set_at(m.kf_obs_pt, kf_id, new_row))

    # occupied features: merge; the point with fewer observations is
    # forwarded to the other (MapPoint::Replace, src/MapPoint.cc:244)
    if obs_count is None:
        obs_count = ms.observation_count(m)
    occ_c = occupied.clamp(0, P - 1).long()
    cand_wins = obs_count[cand_c] >= obs_count[occ_c]
    winner = torch.where(cand_wins, cand_c, occ_c)
    loser = torch.where(hit_occ, torch.where(cand_wins, occ_c, cand_c), -1)
    lut = set_drop(torch.arange(P, dtype=i32, device=dev), loser, winner.to(i32))
    remapped = torch.where(m.kf_obs_pt >= 0, lut[m.kf_obs_pt.clamp(0, P - 1).long()],
                           m.kf_obs_pt)
    m = m._replace(kf_obs_pt=remapped, pt_valid=set_drop(m.pt_valid, loser, False))

    # reverse direction: the new keyframe's points into each neighbour
    # (src/LocalMapping.cc:690-720), all neighbours at once
    own_ids = row(m.kf_obs_pt, kf_id)
    own_ok = (own_ids >= 0) & row(m.kf_feat_valid, kf_id)
    own_c = own_ids.clamp(0, P - 1).long()
    maxd = m.pt_max_dist[own_c] * 1.2
    nb = topi
    obs_nb = m.kf_obs_pt[nb]                                                # [B, N]
    vis_n, uv_n, dist_n, _ = torch.vmap(
        lambda T: in_frustum(cam, T, m.pt_pos[own_c], m.pt_normal[own_c],
                             m.pt_min_dist[own_c] * 0.8, maxd, bounds,
                             view_cos_limit=0.5))(m.kf_Tcw[nb])
    B = nb.shape[0]
    have = torch.zeros(B, P + 1, dtype=torch.bool, device=dev).scatter_(
        1, torch.where(obs_nb >= 0, obs_nb, P).long(), True)               # points each holds
    vis_n = vis_n & own_ok & (topv > 0)[:, None] & ~have.gather(1, own_c.expand(B, N))
    lvl_n = _predict_level(config, maxd / 1.2, dist_n)
    mask_n = (mcore.window_mask(uv_n, m.kf_xy[nb], 3.0 * sf[lvl_n.long()])
              & mcore.level_mask(lvl_n, m.kf_level[nb], -1, 1))
    mm = mcore.mutual_best_match(m.pt_desc[own_c].expand(B, N, 8), m.kf_desc[nb], mask_n,
                                 vis_n, m.kf_feat_valid[nb] & (obs_nb < 0),
                                 max_dist=mcore.TH_LOW, ratio=None)
    new_rows = torch.cat([obs_nb, obs_nb[:, :1]], dim=1).scatter_(
        1, torch.where(mm.valid, mm.idx, N).long(),
        torch.where(mm.valid, own_c, -1).to(i32))[:, :N]
    kf_obs_pt = set_drop(m.kf_obs_pt, torch.where(topv > 0, topi, -1), new_rows)
    return m._replace(kf_obs_pt=kf_obs_pt)


def create_new_points(config: SlamConfig, m: MapState, kf_id: torch.Tensor,
                      max_new: int = 128, counts: torch.Tensor | None = None) -> MapState:
    """Triangulate new points between the new keyframe and its covisible
    neighbours (reference CreateNewMapPoints, src/LocalMapping.cc:312-626):
    epipolar-gated mutual matching of free features against every neighbour
    at once, the best neighbour per feature, DLT triangulation, the parallax
    / depth / reprojection / scale gates, at most max_new points (best
    matches first), each bound in both keyframes."""
    cam = config.camera
    K, P, N = m.max_kf, m.max_pt, m.feat_cap
    dev = m.pt_valid.device
    sf, sigma2 = _scale_tables(config, dev)

    if counts is None:
        counts = ms.covisibility_row(m, row(m.kf_obs_pt, kf_id))
    counts = _set_at(counts, kf_id, 0)
    # 10 neighbours stereo / RGB-D, 20 mono (reference :316-318)
    topv, topi = top_k(counts, min(20 if config.sensor == "mono" else 10, K))
    nb = topi
    B = nb.shape[0]

    Tcw1 = row(m.kf_Tcw, kf_id)
    c1 = se3.inverse(Tcw1)[:3, 3]
    xy1 = row(m.kf_xy, kf_id)
    lvl1 = row(m.kf_level, kf_id).long()
    free1 = row(m.kf_feat_valid, kf_id) & (row(m.kf_obs_pt, kf_id) < 0)
    K33 = camera_matrix(cam, dev)

    Tcw2 = m.kf_Tcw[nb]                                                     # [B, 4, 4]
    baseline = torch.linalg.norm(c1 - se3.inverse(Tcw2)[:, :3, 3], dim=-1)
    # baseline gate (reference :366-384), chosen by the sensor as the
    # reference's mbMonocular chooses it: stereo and RGB-D need more than the
    # rig's baseline, mono a baseline / scene-depth ratio above 0.01 (the JAX
    # package chooses by bf > 0, so a mono camera with bf set took the stereo
    # rule and its map starved; ROADMAP.md §C)
    enough_baseline = (baseline > cam.baseline if config.sensor != "mono"
                       else baseline / 2.0 > 0.01)
    free2 = m.kf_feat_valid[nb] & (m.kf_obs_pt[nb] < 0)
    # fundamental matrices F12 = K^-T [t12]x R12 K^-1 (reference ComputeF12)
    T12 = Tcw1 @ se3.inverse(Tcw2)
    Kinv = constants.inverse_camera_matrix(cam, K33.device)
    F12 = Kinv.T @ se3.hat(T12[:, :3, 3]) @ T12[:, :3, :3] @ Kinv
    x1h = torch.cat([xy1, torch.ones_like(xy1[:, :1])], dim=-1)
    lines = x1h @ F12                                                       # [B, N, 3]
    xy2 = m.kf_xy[nb]
    num = (lines[:, :, None, 0] * xy2[:, None, :, 0]
           + lines[:, :, None, 1] * xy2[:, None, :, 1]
           + lines[:, :, None, 2]) ** 2
    den = torch.clamp_min(lines[:, :, None, 0] ** 2 + lines[:, :, None, 1] ** 2, 1e-12)
    epi_ok = num / den < 3.84 * sigma2[m.kf_level[nb].long()][:, None, :]
    match = mcore.mutual_best_match(
        row(m.kf_desc, kf_id).expand(B, N, 8), m.kf_desc[nb], epi_ok,
        free1 & (topv > 0)[:, None] & enough_baseline[:, None], free2,
        max_dist=mcore.TH_LOW, ratio=0.9)
    nb_dist = torch.where(match.valid, match.dist, 10_000)
    best_dist, best_nb = torch.min(nb_dist, dim=0)                          # first minimum
    has_match = best_dist < mcore.TH_LOW
    nb_kf = nb[best_nb]                                                     # [N]
    nb_feat = match.idx.gather(0, best_nb[None])[0].clamp(0, N - 1).long()

    # triangulate each (feature, neighbour feature) pair
    Tcw2g = m.kf_Tcw[nb_kf]
    uv2 = m.kf_xy[nb_kf, nb_feat]
    lvl2 = m.kf_level[nb_kf, nb_feat].long()
    pts = triangulate_linear_fast(xy1, uv2, projection_matrix(K33, Tcw1),
                                  projection_matrix(K33, Tcw2g))

    # gates (reference :430-560)
    pc1 = pts @ Tcw1[:3, :3].T + Tcw1[:3, 3]
    pc2 = torch.einsum("nij,nj->ni", Tcw2g[:, :3, :3], pts) + Tcw2g[:, :3, 3]
    uv1_hat, z1 = project(cam, pc1)
    uv2_hat, z2 = project(cam, pc2)
    e1 = torch.sum((uv1_hat - xy1) ** 2, dim=-1) / sigma2[lvl1]
    e2 = torch.sum((uv2_hat - uv2) ** 2, dim=-1) / sigma2[lvl2]
    ray1 = pts - c1
    ray2 = pts + torch.einsum("nij,ni->nj", Tcw2g[:, :3, :3], Tcw2g[:, :3, 3])
    dist1 = torch.linalg.norm(ray1, dim=-1)
    dist2 = torch.linalg.norm(ray2, dim=-1)
    cos_par = torch.sum(ray1 * ray2, dim=-1) / torch.clamp_min(dist1 * dist2, 1e-9)
    ratio_dist = dist2 / torch.clamp_min(dist1, 1e-9)
    ratio_octave = sf[lvl2] / sf[lvl1]
    scale_ok = (ratio_dist < ratio_octave * 1.5) & (ratio_dist * 1.5 > ratio_octave)
    good = (has_match & torch.all(torch.isfinite(pts), dim=-1)
            & (z1 > 0) & (z2 > 0) & (cos_par < 0.9998) & (cos_par > 0)
            & (e1 < 5.991) & (e2 < 5.991) & scale_ok)

    # at most max_new per keyframe, best matches first
    order = torch.argsort(torch.where(good, best_dist, 10_000), stable=True)
    rank = torch.empty(N, dtype=torch.int64, device=dev).scatter_(
        0, order, torch.arange(N, device=dev))
    create = good & (rank < max_new)
    m, new_ids = ms.add_points(m, config, kf_id, torch.arange(N, dtype=torch.int32, device=dev),
                               pts, create)
    # the neighbour-side observation too: two observations from birth
    tgt = torch.where(create & (new_ids >= 0), nb_kf * N + nb_feat, -1)
    return m._replace(kf_obs_pt=set_drop(m.kf_obs_pt.reshape(-1), tgt, new_ids).reshape(K, N))


def local_bundle_adjustment(config: SlamConfig, m: MapState, kf_id: torch.Tensor,
                            counts: torch.Tensor | None = None) -> MapState:
    """Local BA over a covisibility-ranked window around the new keyframe
    (reference Optimizer::LocalBundleAdjustment, src/Optimizer.cc:629-1014):
    the top ba_free_kfs covisible keyframes free (keyframe 0 fixed: the
    gauge), the top ba_fixed_kfs other observers of their points fixed, at
    most ba_points points; outlier observations are erased."""
    caps = config.caps
    K, P = m.max_kf, m.max_pt
    dev = m.pt_valid.device
    _, sigma2 = _scale_tables(config, dev)
    n_free = min(caps.ba_free_kfs, K)
    n_fixed = min(caps.ba_fixed_kfs, K)
    Pl = caps.ba_points

    if counts is None:
        counts = ms.covisibility_row(m, row(m.kf_obs_pt, kf_id))
    # the new keyframe always belongs to the window
    counts = counts + 10_000 * (torch.arange(K, device=dev) == kf_id).to(counts.dtype)
    free_counts, free_idx = top_k(counts, n_free)
    free_ok = free_counts > 0
    free_mask = set_drop(torch.zeros(K, dtype=torch.bool, device=dev), free_idx, free_ok)

    cand = nonzero_padded(ms.points_of_keyframes(m, free_mask), Pl, P)
    cand_ok = cand < P
    cand_c = cand.clamp(0, P - 1)
    counts2 = ms.covisibility_row(m, torch.where(cand_ok, cand, -1).to(torch.int32))
    counts2 = torch.where(free_mask, 0, counts2)
    fixed_counts, fixed_idx = top_k(counts2, n_fixed)
    fixed_ok = fixed_counts > 0

    sel_idx = torch.cat([free_idx, fixed_idx])                              # [Kl]
    sel_ok = torch.cat([free_ok, fixed_ok])
    sel_free = torch.cat([free_ok, torch.zeros_like(fixed_ok)]) & (sel_idx != 0)

    # padded candidates all land on point P-1 and come last: as in the JAX
    # package, point P-1 then has no local index
    lut = set_drop(torch.full((P,), -1, dtype=torch.int32, device=dev), cand_c,
                   torch.where(cand_ok, torch.arange(Pl, device=dev), -1))
    obs_pt_g = m.kf_obs_pt[sel_idx]                                         # [Kl, N]
    obs_pt_l = torch.where(obs_pt_g >= 0, lut[obs_pt_g.clamp(0, P - 1).long()], -1)
    obs_uvr = torch.cat([m.kf_xy[sel_idx], m.kf_uright[sel_idx][..., None]], dim=-1)
    obs_valid = m.kf_feat_valid[sel_idx] & sel_ok[:, None]
    res = bundle_adjust(config.camera, m.kf_Tcw[sel_idx], m.pt_pos[cand_c], obs_pt_l,
                        obs_uvr, sigma2[m.kf_level[sel_idx].long()], obs_valid,
                        sel_free, cand_ok, n_iters_pre=caps.ba_iters_pre,
                        n_iters_post=caps.ba_iters_post, ur_weight=config.ur_weight)

    # scatter back free poses and points; window slots top_k filled with
    # zero-count keyframes (which may repeat valid ones) are dropped
    outlier = (obs_pt_l >= 0) & obs_valid & ~res.obs_inlier     # reference Optimizer.cc:919-960
    return m._replace(
        kf_Tcw=set_drop(m.kf_Tcw, torch.where(sel_free, sel_idx, -1), res.kf_Tcw),
        pt_pos=set_drop(m.pt_pos, torch.where(cand_ok, cand_c, -1), res.pt_pos),
        kf_obs_pt=set_drop(m.kf_obs_pt, torch.where(sel_ok, sel_idx, -1),
                           torch.where(outlier, -1, obs_pt_g)),
    )


def cull_keyframes(config: SlamConfig, m: MapState, kf_id: torch.Tensor,
                   counts: torch.Tensor | None = None,
                   obs_count: torch.Tensor | None = None) -> MapState:
    """Retire the most redundant covisible keyframe, if its points are at
    least kf_cull_redundancy observed by >= 3 other keyframes (reference
    KeyFrameCulling, src/LocalMapping.cc:873-1030); never keyframe 0 or the
    new one.  Its pose relative to its most covisible survivor goes to the
    cull archive, its points re-anchor there, and its spanning-tree children
    take their most covisible older keyframe (KeyFrame::SetBadFlag,
    src/KeyFrame.cc:571-724)."""
    K, P = m.max_kf, m.max_pt
    dev = m.pt_valid.device
    if obs_count is None:
        obs_count = ms.observation_count(m)
    if counts is None:
        counts = ms.covisibility_row(m, row(m.kf_obs_pt, kf_id))
    counts = _set_at(counts, kf_id, 0)
    topv, topi = top_k(counts, min(10, K))

    ids = m.kf_obs_pt[topi]
    ok = (ids >= 0) & m.kf_feat_valid[topi]
    redundant = torch.sum(ok & (obs_count[ids.clamp(0, P - 1).long()] >= 4), dim=-1)
    total = torch.clamp_min(torch.sum(ok, dim=-1), 1)
    red = redundant.to(torch.float32) / total.to(torch.float32)
    red = torch.where((topv > 0) & (topi != 0) & (topi != kf_id), red, 0.0)
    worst = torch.argmax(red)                                               # first maximum
    victim = row(topi, worst)
    do_cull = row(red, worst) >= config.tracking.kf_cull_redundancy

    # parent: the victim's most covisible surviving keyframe
    vcounts = _set_at(ms.covisibility_row_cached(m, row(m.kf_obs_pt, victim)), victim, 0)
    parent = torch.argmax(vcounts).to(torch.int32)
    Tcp = row(m.kf_Tcw, victim) @ se3.inverse(row(m.kf_Tcw, parent))
    victim_s = torch.where(do_cull, victim, -1)
    a_slot = torch.where(do_cull, m.n_culled % m.cull_seq.shape[0], -1)
    pt_ref = torch.where(m.pt_valid & (m.pt_ref_kf == victim) & do_cull, parent, m.pt_ref_kf)

    # re-parent the victim's spanning-tree children: each takes its most
    # covisible older surviving keyframe, else the victim's own tree parent
    is_child = (m.kf_tree_parent_seq == row(m.kf_seq, victim)) & m.kf_valid & do_cull
    kr = torch.arange(K, device=dev)
    C = ms.covisibility_matrix_cached(m)
    C = torch.where((kr[None, :] == victim) | (kr[None, :] == kr[:, None]), 0, C)
    C = torch.where(m.kf_valid[None, :] & (m.kf_seq[None, :] < m.kf_seq[:, None]), C, 0)
    best = torch.argmax(C, dim=1)                                           # first maximum
    new_parents = torch.where(C.gather(1, best[:, None])[:, 0] > 0, m.kf_seq[best],
                              row(m.kf_tree_parent_seq, victim))
    return m._replace(
        kf_valid=_set_at(m.kf_valid, victim_s, False),
        kf_parent=_set_at(m.kf_parent, victim_s, parent),
        kf_Tcp=_set_at(m.kf_Tcp, victim_s, Tcp),
        kf_tree_parent_seq=torch.where(is_child, new_parents, m.kf_tree_parent_seq),
        cull_seq=_set_at(m.cull_seq, a_slot, row(m.kf_seq, victim)),
        cull_parent_seq=_set_at(m.cull_parent_seq, a_slot, row(m.kf_seq, parent)),
        cull_Tcp=_set_at(m.cull_Tcp, a_slot, Tcp),
        n_culled=m.n_culled + do_cull.to(torch.int32),
        pt_ref_kf=pt_ref,
    )


class LocalMapper:
    """The mapping pass bound to one configuration (the JAX package's
    LocalMapper jit-compiles _process; eager torch runs it as it is)."""

    def __init__(self, config: SlamConfig):
        self.config = config

    def process(self, m: MapState, kf_id) -> MapState:
        kf_id = torch.as_tensor(kf_id, dtype=torch.int32, device=m.kf_valid.device)
        return _process(self.config, m, kf_id)


def _process(config: SlamConfig, m: MapState, kf_id: torch.Tensor) -> MapState:
    """One mapping pass (reference LocalMapping::Run body).  The covisibility
    row (from the incidence cache) and the observation counts are computed
    once and shared across the stages, as in the JAX package; the pass ends
    by rebuilding the cache the per-frame tracking reads."""
    dev = m.kf_valid.device
    m = cull_points(config, m, kf_id)
    counts = ms.covisibility_row_cached(m, row(m.kf_obs_pt, kf_id))
    obs_count = ms.observation_count(m)
    profiling.stamp(dev, "create_new_points")
    m = create_new_points(config, m, kf_id, counts=counts)
    profiling.stamp(dev, "create_new_points")
    profiling.stamp(dev, "fuse_into_keyframe")
    m = fuse_into_keyframe(config, m, kf_id, counts=counts, obs_count=obs_count)
    profiling.stamp(dev, "fuse_into_keyframe")
    profiling.stamp(dev, "refresh_observed_points")
    m = refresh_observed_points(config, m, kf_id)
    profiling.stamp(dev, "refresh_observed_points")
    profiling.stamp(dev, "local_bundle_adjustment")
    m = local_bundle_adjustment(config, m, kf_id, counts=counts)
    profiling.stamp(dev, "local_bundle_adjustment")
    m = cull_keyframes(config, m, kf_id, counts=counts)
    return ms.rebuild_incidence(m)
