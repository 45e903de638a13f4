"""Relocalization: BoW candidate retrieval + EPnP-RANSAC + robust refine.

Counterpart of the JAX package's models/relocalization.py (reference
Tracking::Relocalization, src/Tracking.cc:2030-2240, and
KeyFrameDatabase::DetectRelocalizationCandidates,
src/KeyFrameDatabase.cc:252-374):

  * candidate retrieval with the reference's semantics: share-word filter at
    0.8 * maxCommonWords, then covisibility-group accumulated scores with the
    0.75 * best cutoff, best member per surviving group, all from the sparse
    (word id, weight) database rows;
  * per candidate: node-constrained SearchByBoW matching (ORBmatcher.cc:230)
    between the keyframe's map points and the frame, EPnP-RANSAC, then the
    robust pose optimizer;
  * the widening projection rounds (Tracking.cc:2169-2214): below 50 inliers
    the candidate keyframe's map points are projected through the current
    estimate and window-matched (radius 10, TH_HIGH) and the pose is
    re-optimized; a narrow round (radius 3, distance 64) follows when the
    count lands in [30, 50);
  * accept at >= 50 inliers (reference :2218).

The JAX package vmaps one function over the five candidates.  Here the
matching and refinement loop over the candidates and the RANSAC of all of
them runs as one batch.  Candidates that retrieval left inactive are skipped
(they score 0 in the JAX package); reading which are active costs the one
host sync of a relocalization.  The minimal sets come from a
torch.Generator the caller owns.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from ..ops import bow as bow_ops
from ..ops import se3
from ..ops.camera import project
from ..ops.indexing import indicator, row, select, set_drop, top_k
from ..ops.matching import core as mcore
from ..ops.optim.pose_opt import pose_optimize
from ..ops.solvers.epnp import pnp_ransac_batch
from . import map_state as ms
from .config import SlamConfig
from .frame import FrameData
from .map_state import NO_POINT, MapState
from .tracking import _observations, _scatter_matches

N_CANDIDATES = 5
N_GROUP = 8   # candidates entering covisibility-group accumulation

# relocalize() calls since reset_counts(), and the success flag of each of
# the latest ones (0-d tensors, kept unread so that counting costs no sync)
attempts = 0
_success_log: collections.deque = collections.deque(maxlen=4096)


def reset_counts() -> None:
    global attempts
    attempts = 0
    _success_log.clear()


def counts() -> tuple[int, int]:
    """(attempts, successes) since reset_counts(); reads the device."""
    return attempts, sum(int(s) for s in _success_log)


class RelocResult(NamedTuple):
    success: torch.Tensor    # scalar bool
    Tcw: torch.Tensor        # [4, 4]
    obs_pt: torch.Tensor     # [N] matched point ids (post-refine inliers)
    n_inliers: torch.Tensor  # scalar int32


def detect_reloc_candidates(config: SlamConfig, m: MapState,
                            q_ids: torch.Tensor, q_vals: torch.Tensor):
    """[N_CANDIDATES] keyframe slots by the reference's retrieval semantics
    (KeyFrameDatabase::DetectRelocalizationCandidates): share-word filter at
    0.8 * maxCommonWords, covisibility-group accumulated scores with the
    0.75 * best cutoff, best-scoring member per group.  Unlike loop detection
    there is no covisible exclusion and no minScore gate.  Returns
    (slots [C] int32, active [C] bool)."""
    neg_inf = float("-inf")
    common = bow_ops.sparse_common_words(q_ids, m.kf_bow_ids)
    eligible = m.kf_valid & (common > 0)
    max_common = torch.max(torch.where(eligible, common, 0))
    word_ok = common.to(torch.float32) >= 0.8 * max_common.to(torch.float32)
    scores = bow_ops.sparse_l1_score(q_ids, q_vals, m.kf_bow_ids, m.kf_bow_vals)
    cand0 = eligible & word_ok

    base_scores = torch.where(cand0, scores, neg_inf)
    top_s, top_i = top_k(base_scores, min(N_GROUP, m.max_kf))

    # group scores of the G leaders at once (the JAX package vmaps over them)
    C = ms.covisibility_matrix_cached(m)
    rows = C[top_i].scatter(1, top_i[:, None], 0)            # [G, K], self dropped
    nbv, nbi = top_k(rows, min(10, m.max_kf))                # [G, 10]
    nb_scores = scores[nbi]
    nb_is_cand = cand0[nbi] & (nbv > 0)
    own = scores[top_i]
    accs = own + torch.sum(torch.where(nb_is_cand, nb_scores, 0.0), dim=1)
    nb_best = torch.argmax(torch.where(nb_is_cand, nb_scores, neg_inf), dim=1)[:, None]
    use_nb = nb_is_cand.gather(1, nb_best)[:, 0] & (nb_scores.gather(1, nb_best)[:, 0] > own)
    best_kfs = torch.where(use_nb, nbi.gather(1, nb_best)[:, 0], top_i).to(torch.int32)

    cand_live = torch.isfinite(top_s)
    accs = torch.where(cand_live, accs, neg_inf)
    group_keep = cand_live & (accs >= 0.75 * torch.max(accs))
    order = torch.argsort(-torch.where(group_keep, accs, neg_inf), stable=True)
    sel = order[:N_CANDIDATES]
    return best_kfs[sel], group_keep[sel]


def relocalize(config: SlamConfig, m: MapState, frame: FrameData,
               generator: torch.Generator | None = None,
               min_accept: int = 50) -> RelocResult:
    """Recover the pose of `frame` against the map.  `generator` drives the
    RANSAC draws and must live on the frame's device (None: the global one)."""
    global attempts
    if config.vocab is None:
        raise ValueError("relocalization requires a vocabulary")
    attempts += 1
    vocab = config.vocab
    cam = config.camera
    dev = frame.xy.device
    N = frame.capacity
    sigma2 = torch.from_numpy(config.orb.sigma2()).to(dev)[frame.level.long()]
    scale_factors = torch.from_numpy(config.orb.scale_factors()).to(dev)
    obs = _observations(frame)

    words, nodes = bow_ops.transform(vocab, frame.desc, frame.valid)
    q_ids, q_vals = bow_ops.sparse_bow(vocab, words, config.bow_top)
    cand_kf, cand_active = detect_reloc_candidates(config, m, q_ids, q_vals)
    live = [c for c, a in enumerate(cand_active.tolist()) if a]   # the host sync

    def optimize(Tcw0, obs_pt):
        pts_w = m.pt_pos[torch.clamp(obs_pt, 0, m.max_pt - 1).long()]
        sel = (obs_pt >= 0) & frame.valid
        opt = pose_optimize(cam, Tcw0, pts_w, obs, sigma2, sel,
                            ur_weight=config.ur_weight)
        return opt, torch.where(opt.inliers, obs_pt, NO_POINT)

    def proj_round(kf_id, Tcw, obs_pt, radius_px, max_dist):
        """Widening SearchByProjection round (reference Tracking.cc:2169-2214
        via ORBmatcher::SearchByProjection(Frame, KeyFrame, ...),
        ORBmatcher.cc:1731): project the candidate keyframe's map points
        through the current estimate, window-match still-unmatched frame
        features, merge, and re-optimize."""
        pt_row = row(m.kf_obs_pt, kf_id)
        ids = torch.clamp(pt_row, 0, m.max_pt - 1).long()
        row_ok = (pt_row >= 0) & row(m.kf_feat_valid, kf_id) & m.pt_valid[ids]
        uv, z = project(cam, se3.transform_points(Tcw, m.pt_pos[ids]))
        vis = (row_ok & (z > 0)
               & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
               & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))
        # exclude points already matched (reference's sFound set)
        found = indicator(m.max_pt, obs_pt)
        vis &= ~found[ids]
        unmatched = frame.valid & (obs_pt < 0)
        radius = radius_px * scale_factors[row(m.kf_level, kf_id).long()]
        wmask = mcore.window_mask(uv, frame.xy, radius)
        match = mcore.masked_best_match(m.pt_desc[ids], frame.desc, wmask, vis,
                                        unmatched, max_dist=max_dist, ratio=None)
        new_obs = _scatter_matches(N, match, ids.to(torch.int32))
        return optimize(Tcw, torch.where(obs_pt >= 0, obs_pt, new_obs))

    def bow_matches(kf_id):
        """SearchByBoW: descriptor match constrained to identical mid-level
        vocabulary nodes, only keyframe features that carry a map point ->
        per-frame-feature matched point id [N]."""
        kf_obs = row(m.kf_obs_pt, kf_id)
        kf_node = row(m.kf_node, kf_id)
        kf_has_pt = (kf_obs >= 0) & row(m.kf_feat_valid, kf_id)
        node_mask = (kf_node[:, None] == nodes[None, :]) & (kf_node >= 0)[:, None]
        match = mcore.mutual_best_match(row(m.kf_desc, kf_id), frame.desc, node_mask,
                                        kf_has_pt, frame.valid,
                                        max_dist=mcore.TH_LOW, ratio=0.75)
        keep = mcore.rotation_consistency_mask(row(m.kf_angle, kf_id), frame.angle, match)
        none = torch.full((N,), NO_POINT, dtype=torch.int32, device=dev)
        return set_drop(none, torch.where(keep, match.idx, -1),
                        torch.where(keep, kf_obs, NO_POINT))

    def pick(take_a, a, b):
        """Of two (PoseOptResult, obs_pt) pairs."""
        return select(take_a, a[0], b[0]), torch.where(take_a, a[1], b[1])

    def refine(kf_id, Tcw0, obs_pt):
        opt, obs1 = optimize(Tcw0, obs_pt)
        # widening round: < min_accept inliers -> radius 10, TH_HIGH
        # (reference Tracking.cc:2169-2186)
        widen = opt.n_inliers < min_accept
        opt_n, obs2 = pick(widen, proj_round(kf_id, opt.Tcw, obs1, 10.0, mcore.TH_HIGH),
                               (opt, obs1))
        # narrow round: landed in [min_accept * 0.6, min_accept) -> radius 3,
        # distance 64 (reference Tracking.cc:2190-2210)
        narrow = (widen & (opt_n.n_inliers >= (min_accept * 3) // 5)
                  & (opt_n.n_inliers < min_accept))
        return pick(narrow, proj_round(kf_id, opt_n.Tcw, obs2, 3.0, 64),
                        (opt_n, obs2))

    n_inl = torch.zeros(N_CANDIDATES, dtype=torch.int32, device=dev)
    Tcws = torch.eye(4, dtype=torch.float32, device=dev).repeat(N_CANDIDATES, 1, 1)
    obs_out = torch.full((N_CANDIDATES, N), NO_POINT, dtype=torch.int32, device=dev)
    if live:
        kfs = [cand_kf[c] for c in live]
        obs0 = torch.stack([bow_matches(kf) for kf in kfs])          # [C, N]
        pts_w = m.pt_pos[torch.clamp(obs0, 0, m.max_pt - 1).long()]  # [C, N, 3]
        pnp = pnp_ransac_batch(cam, pts_w, frame.xy, obs0 >= 0, sigma2, generator,
                               min_inliers=10)
        for j, (c, kf) in enumerate(zip(live, kfs)):
            opt_f, obs_f = refine(kf, pnp.Tcw[j], obs0[j])
            n_inl[c] = opt_f.n_inliers * pnp.success[j].to(torch.int32)
            Tcws[c] = opt_f.Tcw
            obs_out[c] = obs_f
    best = torch.argmax(n_inl)
    res = RelocResult(
        success=row(n_inl, best) >= min_accept,
        Tcw=row(Tcws, best),
        obs_pt=row(obs_out, best),
        n_inliers=row(n_inl, best),
    )
    _success_log.append(res.success)
    return res
