"""Tracking: per-frame pose estimation against the map.

Counterpart of the JAX package's models/tracking.py (reference Tracking,
src/Tracking.cc:419-779):

  * track_motion      - TrackWithMotionModel (:1353): project the last
                        frame's points with a constant-velocity prior,
                        window-match, motion-only BA.
  * track_local_map   - TrackLocalMap (:1443): covisibility-derived local
                        points, frustum filter, scale-aware projection match,
                        second motion-only BA.
  * initialize_depth  - StereoInitialization (:788): first keyframe + points
                        from RGB-D depth.
  * create_keyframe   - CreateNewKeyFrame (:1649): keyframe + up to 100 new
                        close points, nearest first.
  * track_motion_loc  - localization-mode motion tracking with temporal
                        visual-odometry points (UpdateLastFrame :1247).

With a vocabulary every keyframe also gets its BoW row, word ids and node
ids at insertion (_frame_bow).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import bow as bow_ops
from ..ops import constants
from ..ops.camera import in_frustum, project
from ..ops.indexing import indicator, nonzero_padded, row, set_drop
from ..ops.matching import core as mcore
from ..ops.optim.pose_opt import pose_optimize
from . import map_state as ms
from .config import SlamConfig
from .frame import FrameData, backproject_frame
from .map_state import NO_POINT, MapState


class TrackResult(NamedTuple):
    Tcw: torch.Tensor        # [4, 4]
    obs_pt: torch.Tensor     # [N] matched map-point id per feature (-1)
    n_matches: torch.Tensor  # scalar int32 (pre-optimization)
    n_inliers: torch.Tensor  # scalar int32 (post-optimization)


class LocalMapResult(NamedTuple):
    Tcw: torch.Tensor
    obs_pt: torch.Tensor
    n_inliers: torch.Tensor
    local_kf_mask: torch.Tensor   # [K] keyframes in the local window
    visible_pt: torch.Tensor      # [C] point ids tested visible (-1 pad)
    found_pt_mask: torch.Tensor   # [N] features whose point was found
    ref_kf: torch.Tensor          # scalar int32: most-covisible keyframe
    ref_shared: torch.Tensor      # scalar int32: points shared with it now
    ref_total: torch.Tensor       # scalar int32: its well-observed points


def _scale_factors(config: SlamConfig, device) -> torch.Tensor:
    return constants.scale_factors(config.orb, device)


def _observations(frame: FrameData) -> torch.Tensor:
    """[N, 3] (u, v, u_right) observation rows for the pose optimizer."""
    return torch.cat([frame.xy, frame.u_right[:, None]], dim=-1)


def _scatter_matches(n_feat: int, match: mcore.MatchResult,
                     pt_ids: torch.Tensor) -> torch.Tensor:
    """Invert a query->feature match into per-feature point ids [N].  Where
    two queries match one feature the later query wins, as in XLA's
    sequential scatter (set_drop's rule)."""
    none = torch.full((n_feat,), NO_POINT, dtype=torch.int32, device=pt_ids.device)
    return set_drop(none, torch.where(match.valid, match.idx, -1), pt_ids)


def _optimize_with_matches(config: SlamConfig, m: MapState, Tcw0, frame: FrameData,
                           obs_pt: torch.Tensor):
    """Pose-optimize the frame against its matched points; returns the
    result and the inlier-filtered obs_pt."""
    sigma2 = constants.sigma2(config.orb, Tcw0.device)
    cl = torch.clamp(obs_pt, 0, m.max_pt - 1).long()
    valid = (obs_pt >= 0) & frame.valid & m.pt_valid[cl]
    res = pose_optimize(config.camera, Tcw0, m.pt_pos[cl], _observations(frame),
                        sigma2[frame.level.long()], valid,
                        ur_weight=config.ur_weight)
    return res, torch.where(res.inliers, obs_pt, NO_POINT)


def track_motion(config: SlamConfig, m: MapState, frame: FrameData,
                 Tcw_last: torch.Tensor, velocity: torch.Tensor,
                 last_frame: FrameData, last_obs_pt: torch.Tensor,
                 search_radius: float, *,
                 last_obs_birth: torch.Tensor | None = None) -> TrackResult:
    """Constant-velocity tracking (reference TrackWithMotionModel,
    src/Tracking.cc:1353-1440).  last_obs_birth drops carried ids whose slot
    was reused for another point since (CheckReplacedInLastFrame analogue)."""
    cam = config.camera
    Tcw_pred = velocity @ Tcw_last

    pt_ids = last_obs_pt
    cl = torch.clamp(pt_ids, 0, m.max_pt - 1).long()
    pt_ok = (pt_ids >= 0) & m.pt_valid[cl]
    if last_obs_birth is not None:
        pt_ok &= m.pt_birth[cl] == last_obs_birth
    pc = m.pt_pos[cl] @ Tcw_pred[:3, :3].T + Tcw_pred[:3, 3]
    uv, z = project(cam, pc)
    inb = ((z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
           & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))
    pt_ok &= inb & last_frame.valid

    # window radius scaled by the feature's last octave (reference :1395)
    radius = search_radius * _scale_factors(config, uv.device)[last_frame.level.long()]
    wmask = mcore.window_mask(uv, frame.xy, radius)
    lmask = mcore.level_mask(last_frame.level, frame.level, -1, 1)
    # match by the map point's representative descriptor (reference
    # SearchByProjection uses pMP->GetDescriptor(), ORBmatcher.cc:1569+)
    match = mcore.mutual_best_match(m.pt_desc[cl], frame.desc, wmask & lmask,
                                    pt_ok, frame.valid, max_dist=mcore.TH_HIGH,
                                    ratio=None)
    keep = mcore.rotation_consistency_mask(last_frame.angle, frame.angle, match)
    match = match._replace(valid=keep, idx=torch.where(keep, match.idx, -1))

    obs_pt = _scatter_matches(frame.capacity, match, pt_ids)
    n_matches = torch.sum(obs_pt >= 0).to(torch.int32)
    res, obs_out = _optimize_with_matches(config, m, Tcw_pred, frame, obs_pt)
    return TrackResult(res.Tcw, obs_out, n_matches, res.n_inliers)


class TrackResultVO(NamedTuple):
    """track_motion_loc result: TrackResult + the count of inliers bound to
    real map points (the reference's nmatchesMap, src/Tracking.cc:1401-1426,
    which drives the mbVO 'map support lost' flag)."""

    Tcw: torch.Tensor
    obs_pt: torch.Tensor
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    n_map_inliers: torch.Tensor


def _depth_rank(depth: torch.Tensor, candidate: torch.Tensor) -> torch.Tensor:
    """[N] rank of each feature by depth among the candidates, nearest
    first; equal depths keep feature order (a stable sort, as jnp.argsort)."""
    n = depth.shape[0]
    order = torch.argsort(torch.where(candidate, depth, math.inf), stable=True)
    return torch.empty(n, dtype=torch.int64, device=depth.device).scatter_(
        0, order, torch.arange(n, device=depth.device))


def track_motion_loc(config: SlamConfig, m: MapState, frame: FrameData,
                     Tcw_last: torch.Tensor, velocity: torch.Tensor,
                     last_frame: FrameData, last_obs_pt: torch.Tensor,
                     search_radius: float, *,
                     last_obs_birth: torch.Tensor | None = None) -> TrackResultVO:
    """Localization-mode motion tracking with temporal "visual odometry"
    points (reference Tracking::UpdateLastFrame src/Tracking.cc:1247-1350 +
    TrackWithMotionModel :1353-1430).

    The reference allocates temporary MapPoints from the last frame's close
    RGB-D depth every frame (all with depth < mThDepth, plus the 100
    closest) and deletes them after tracking (:670-716).  Here the same
    candidates are frame-local tensors (backprojected positions and
    descriptors of the last frame that never touch the map) and the pose
    optimization runs over the union of map matches and VO matches."""
    cam = config.camera
    Tcw_pred = velocity @ Tcw_last

    pt_ids = last_obs_pt
    cl = torch.clamp(pt_ids, 0, m.max_pt - 1).long()
    map_ok = (pt_ids >= 0) & m.pt_valid[cl]
    if last_obs_birth is not None:  # slot-reuse guard (see track_motion)
        map_ok &= m.pt_birth[cl] == last_obs_birth

    # temporal VO candidates: depth-sorted close features of the last frame
    # without a live map point (reference Tracking.cc:1301-1345)
    depth_ok = last_frame.has_depth() & ~map_ok
    rank = _depth_rank(last_frame.depth, depth_ok)
    vo_ok = depth_ok & ((last_frame.depth < config.th_depth) | (rank < 100))
    vo_pos = backproject_frame(cam, last_frame, Tcw_last)

    pts_w = torch.where(map_ok[:, None], m.pt_pos[cl], vo_pos)
    desc_q = torch.where(map_ok[:, None], m.pt_desc[cl], last_frame.desc)
    q_ok = map_ok | vo_ok

    pc = pts_w @ Tcw_pred[:3, :3].T + Tcw_pred[:3, 3]
    uv, z = project(cam, pc)
    inb = ((z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
           & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))
    q_ok &= inb & last_frame.valid

    radius = search_radius * _scale_factors(config, uv.device)[last_frame.level.long()]
    wmask = mcore.window_mask(uv, frame.xy, radius)
    lmask = mcore.level_mask(last_frame.level, frame.level, -1, 1)
    match = mcore.mutual_best_match(desc_q, frame.desc, wmask & lmask, q_ok,
                                    frame.valid, max_dist=mcore.TH_HIGH, ratio=None)
    keep = mcore.rotation_consistency_mask(last_frame.angle, frame.angle, match)
    match = match._replace(valid=keep, idx=torch.where(keep, match.idx, -1))

    # scatter the source feature index so VO positions survive the
    # query->feature inversion (a VO match has no map-point id to scatter)
    n_last = last_frame.capacity
    src = _scatter_matches(frame.capacity, match,
                           torch.arange(n_last, dtype=torch.int32, device=uv.device))
    has = src >= 0
    src_c = torch.clamp(src, 0, n_last - 1).long()
    is_map = has & map_ok[src_c]
    obs_pt_map = torch.where(is_map, pt_ids[src_c], NO_POINT)
    n_matches = torch.sum(has).to(torch.int32)

    sigma2 = constants.sigma2(config.orb, uv.device)
    res = pose_optimize(cam, Tcw_pred, pts_w[src_c], _observations(frame),
                        sigma2[frame.level.long()], has & frame.valid,
                        ur_weight=config.ur_weight)
    obs_out = torch.where(res.inliers & is_map, obs_pt_map, NO_POINT)
    n_map_inl = torch.sum(res.inliers & is_map).to(torch.int32)
    return TrackResultVO(res.Tcw, obs_out, n_matches, res.n_inliers, n_map_inl)


def track_local_map(config: SlamConfig, m: MapState, frame: FrameData,
                    Tcw: torch.Tensor, obs_pt: torch.Tensor) -> LocalMapResult:
    """Local-map tracking (reference TrackLocalMap + helpers,
    src/Tracking.cc:1443-2028)."""
    cam = config.camera
    caps = config.caps
    dev = Tcw.device
    scale_factors = _scale_factors(config, dev)
    n_levels = config.orb.n_levels

    # local keyframes: sharers of the current points, capped (:1895-1964);
    # top-k ties keep the lowest slot first, as jax.lax.top_k does
    counts = ms.covisibility_row_cached(m, obs_pt)
    k = min(caps.local_keyframes, m.max_kf)
    topk, topk_idx = torch.sort(counts, descending=True, stable=True)
    local_kf_mask = torch.zeros(m.max_kf, dtype=torch.bool, device=dev).scatter(
        0, topk_idx[:k], topk[:k] > 0)

    # local points = points of local keyframes, minus those already matched
    local_pt = ms.points_of_keyframes_cached(m, local_kf_mask)
    local_pt &= ~indicator(m.max_pt, obs_pt)

    cand = nonzero_padded(local_pt, caps.local_points, m.max_pt)
    cand_ok = cand < m.max_pt
    cand_c = torch.clamp(cand, 0, m.max_pt - 1)
    min_d = m.pt_min_dist[cand_c] * 0.8   # reference band (MapPoint.cc:523-533)
    max_d = m.pt_max_dist[cand_c] * 1.2
    bounds = (0.0, float(cam.width), 0.0, float(cam.height))
    vis, uv, dist, view_cos = in_frustum(cam, Tcw, m.pt_pos[cand_c],
                                         m.pt_normal[cand_c], min_d, max_d,
                                         bounds, view_cos_limit=0.5)
    vis &= cand_ok

    # scale prediction (reference MapPoint::PredictScale src/MapPoint.cc:551)
    ratio = torch.clamp_min(max_d / 1.2, 1e-6) / torch.clamp_min(dist, 1e-6)
    log_sf = constants.log_scale_factor(config.orb.scale_factor, dev)
    pred_level = torch.clamp(torch.ceil(torch.log(ratio) / log_sf).to(torch.int32),
                             0, n_levels - 1)
    # radius by viewing angle (reference ORBmatcher.cc:178 RadiusByViewingCos)
    base_r = torch.where(view_cos > 0.998, 2.5, 4.0)
    radius = (base_r * scale_factors[pred_level.long()]
              * config.tracking.local_search_radius)

    unmatched = frame.valid & (obs_pt < 0)
    wmask = mcore.window_mask(uv, frame.xy, radius)
    lmask = mcore.level_mask(pred_level, frame.level, -1, 1)
    match = mcore.masked_best_match(m.pt_desc[cand_c], frame.desc, wmask & lmask,
                                    vis, unmatched, max_dist=mcore.TH_HIGH,
                                    ratio=0.8)
    new_obs = _scatter_matches(frame.capacity, match, cand.to(torch.int32))
    obs_pt = torch.where(obs_pt >= 0, obs_pt, new_obs)

    res, obs_out = _optimize_with_matches(config, m, Tcw, frame, obs_pt)

    # reference-keyframe statistics for the keyframe decision (reference
    # NeedNewKeyFrame, src/Tracking.cc:1509-1648), from the pre-search votes
    ref_kf = torch.argmax(counts).to(torch.int32)
    out_ind = indicator(m.max_pt + 2, torch.where(obs_out >= 0, obs_out, m.max_pt + 1))
    ref_row = row(m.kf_obs_pt, ref_kf)
    ref_feat_valid = row(m.kf_feat_valid, ref_kf)
    ref_shared = torch.sum(out_ind[torch.clamp(ref_row, 0, m.max_pt + 1).long()]
                           & (ref_row >= 0) & ref_feat_valid).to(torch.int32)
    # nRefMatches: the ref KF's points seen by >= minObs keyframes (minObs 2
    # while the map is young, else 3 - Tracking.cc:1545-1552)
    min_obs = torch.where(m.n_kf <= 2, 2, 3)
    ref_ok = (ref_row >= 0) & ref_feat_valid
    ref_total = torch.sum(
        ref_ok & (m.pt_obs[torch.clamp(ref_row, 0, m.max_pt - 1).long()] >= min_obs)
    ).to(torch.int32)
    return LocalMapResult(
        Tcw=res.Tcw,
        obs_pt=obs_out,
        n_inliers=res.n_inliers,
        local_kf_mask=local_kf_mask,
        visible_pt=torch.where(vis, cand, NO_POINT).to(torch.int32),
        found_pt_mask=obs_out >= 0,
        ref_kf=ref_kf,
        ref_shared=ref_shared,
        ref_total=ref_total,
    )


def _frame_bow(config: SlamConfig, frame: FrameData):
    """(sparse bow (ids, vals), words, nodes) for keyframe insertion; a None
    triple without a vocabulary.  Reference: KeyFrame::ComputeBoW
    (src/KeyFrame.cc:79-95); the sparse pair is the inverted-file entry
    (KeyFrameDatabase::add, src/KeyFrameDatabase.cc:53)."""
    if config.vocab is None:
        return None, None, None
    words, nodes = bow_ops.transform(config.vocab, frame.desc, frame.valid)
    return bow_ops.sparse_bow(config.vocab, words, config.bow_top), words, nodes


def initialize_depth(config: SlamConfig, m: MapState, frame: FrameData,
                     frame_id, timestamp):
    """First RGB-D keyframe: a map point for every feature with depth
    (reference StereoInitialization, src/Tracking.cc:788-884)."""
    dev = frame.xy.device
    Tcw = torch.eye(4, dtype=torch.float32, device=dev)
    n = frame.capacity
    bow, words, nodes = _frame_bow(config, frame)
    m, kf_id = ms.insert_keyframe(
        m, frame, Tcw, frame_id, timestamp,
        torch.full((n,), NO_POINT, dtype=torch.int32, device=dev),
        bow=bow, words=words, nodes=nodes)
    pts_w = backproject_frame(config.camera, frame, Tcw)
    feat_idx = torch.arange(n, dtype=torch.int32, device=dev)
    m, _ = ms.add_points(m, config, kf_id, feat_idx, pts_w, frame.has_depth())
    return m, kf_id


def create_keyframe(config: SlamConfig, m: MapState, frame: FrameData,
                    Tcw: torch.Tensor, obs_pt: torch.Tensor, frame_id, timestamp):
    """Insert a keyframe + new close points for unmatched depth features
    (reference CreateNewKeyFrame, src/Tracking.cc:1649-1758: by depth, until
    100 or depth > mThDepth)."""
    dev = frame.xy.device
    bow, words, nodes = _frame_bow(config, frame)
    m, kf_id = ms.insert_keyframe(m, frame, Tcw, frame_id, timestamp, obs_pt,
                                  bow=bow, words=words, nodes=nodes)
    candidate = frame.has_depth() & (obs_pt < 0) & (frame.depth < config.th_depth)
    n = frame.capacity
    create = candidate & (_depth_rank(frame.depth, candidate)
                          < config.tracking.max_new_points_per_kf)
    pts_w = backproject_frame(config.camera, frame, Tcw)
    feat_idx = torch.arange(n, dtype=torch.int32, device=dev)
    m, _ = ms.add_points(m, config, kf_id, feat_idx, pts_w, create)
    return m, kf_id
