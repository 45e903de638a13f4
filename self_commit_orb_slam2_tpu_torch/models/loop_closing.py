"""Loop closing: BoW detection, Sim3 verification, essential-graph correction,
global bundle adjustment.

Counterpart of the JAX package's models/loop_closing.py (reference
LoopClosing, src/LoopClosing.cc, run as a phase after keyframe insertion):

  * DetectLoop (:133) with KeyFrameDatabase::DetectLoopCandidates semantics:
    shared-word filter at 0.8 * maxCommonWords, score >= minScore, then
    covisibility-group accumulated scores with the 0.75 * best cutoff;
  * ComputeSim3 (:337) over the 3 surviving candidates as one batch:
    node-constrained SearchByBoW, Horn RANSAC over 128 3-point sets (scale
    locked for stereo / RGB-D), SearchBySim3-style match extension, Sim3
    Gauss-Newton polish, accept at >= 20 inliers;
  * the Scw projection gate: >= 40 matches of the loop group's points
    projected through the corrected pose (LoopClosing.cc:522-545);
  * CorrectLoop (:571): a Sim3 pose graph over the spanning tree, strong
    covisibility edges and every persisted loop edge with the loop keyframe
    fixed, pose recovery [R, t/s], points remapped through their reference
    keyframes, then the loop group's points fused into the current group;
  * global BA after every loop (:880), sliced into one Gauss-Newton
    iteration per stream drain on a snapshot of the corrected map and
    merged back through the spanning tree (merge_gba); with graphs, each
    slice and the merge replay captured programs
    (models/program_graphs.py CloserGraphs).

Where the JAX package vmaps (3 candidates, 8 group scores, 11 fuse rows)
the port carries a leading batch dimension; only the keyframes of one
detection group are a Python loop (each is a whole detection).

When things happen does not depend on timing.  The JAX closer asks its
device whether a fetch is ready (is_ready) to decide whether a detection is
consumed now or later and whether a finished global BA is merged, so on a
TPU the map a correction lands on depends on timing.  Here every decision
point is fixed by the stream: a detection group is consumed by the resolve()
of the drain that dispatched it (MAX_PENDING_DETS = 0), a pending global BA
advances by one slice per resolve() and is merged by the resolve() after
the one that ran its last slice, and a blocking resolve() does everything
at once.  Each fetch is a plain device-to-host copy where the rule needs it.

Two faults of the JAX closer are not carried over (the intended behaviour
is):
  * a re-base payload is (keyframe slot, its pose before the event, its pose
    after the event), taken when the event happens, so a correction and a
    global-BA merge in one resolve() re-base the tracking carry once each
    (the JAX payload holds only the earlier pose, and the stream applies
    each against the final map, twice over);
  * merge_gba leaves a point where it is when its reference slot no longer
    holds a live keyframe (the JAX merge remaps it through whatever the
    slot holds).

The Sim3 RANSAC draws from a torch.Generator the caller owns (the JAX closer
splits PRNGKey(7)); hypotheses differ between the packages, so tests compare
on fixed hypothesis sets or on outcomes.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops import bow as bow_ops
from ..ops import se3, sim3
from ..ops.camera import in_frustum
from ..ops.constants import log_scale_factor, scale_factors, sigma2
from ..ops.indexing import nonzero_padded, row, set_drop, top_k
from ..ops.matching import core as mcore
from ..ops.optim.bundle_adjust import bundle_adjust
from ..ops.optim.pose_graph import optimize_pose_graph
from ..ops.optim.sim3_opt import optimize_sim3
from ..ops.solvers.horn import horn_align
from ..utils import profiling
from . import map_state as ms
from .config import SlamConfig
from .map_state import NO_POINT, MapState

COOLDOWN = 10          # reference :147
MIN_SIM3_INLIERS = 20  # reference :463
MIN_PROJ_TOTAL = 40    # reference :545
N_HYPOTHESES = 128
N_CANDIDATES = 3       # Sim3-verified candidates per pass
N_GROUP = 8            # candidates entering group accumulation
REPROJ_TH2 = 9.21      # reference Sim3Solver th2

# GBA iteration schedule of the sliced path: Huber-weighted steps first
# (the reference's stage 1, Optimizer.cc:863), then plain steps on the
# chi2-gated observations (stage 2, :916); each slice is one call.
GBA_SLICES = [True] * 4 + [False] * 6

# the closer's phases: span name -> timed_phases() key
_PHASES = {"loop.detect": "detect", "loop.correct": "correct", "loop.gba_slice": "gba_slice",
           "loop.merge": "merge"}


@contextlib.contextmanager
def timed_phases():
    """Time the closer's phases inside the block (host clock, with
    cuda.synchronize on both sides on a card); yields a dict of lists of
    ms keyed by phase: "detect" (one keyframe), "correct", "gba_slice",
    "merge".  A view over the tracer's loop.* spans
    (utils/profiling.timed): it opens a trace if none is open."""
    with profiling.timed(_PHASES, scale=1e3) as out:
        yield out


class LoopDetection(NamedTuple):
    found: torch.Tensor       # scalar bool: best candidate fully verified
    cand_kf: torch.Tensor     # scalar int32 (slot of the verified candidate)
    S_cur_cand: torch.Tensor  # [8] Sim3 mapping cand-camera coords -> cur-camera
    n_inliers: torch.Tensor
    n_proj: torch.Tensor      # scalar int32: Scw-projection total (>= 40 gate)
    groups: torch.Tensor      # [C, K] bool BoW-candidate covisibility groups
    group_ok: torch.Tensor    # [C] bool: group is a live BoW-stage candidate
    best_c: torch.Tensor      # scalar int32: which group the winner belongs to


def _pixels(cam, p: torch.Tensor) -> torch.Tensor:
    """Camera points [..., 3] -> pixels [..., 2] with the depth floored at 1e-6."""
    z = torch.clamp_min(p[..., 2], 1e-6)
    return torch.stack([cam.fx * p[..., 0] / z + cam.cx, cam.fy * p[..., 1] / z + cam.cy], -1)


def _reproj_err(cam, R, t, s, src, dst):
    """Squared pixel distance between s R src + t and dst, each projected;
    R [..., 3, 3], t [..., 3], s [...] broadcast over src / dst [..., N, 3]."""
    pred = torch.einsum("...ij,...nj->...ni", R, s[..., None, None] * src) + t[..., None, :]

    def px(p):
        z = torch.where(torch.abs(p[..., 2]) < 1e-6, 1e-6, p[..., 2])
        return cam.fx * p[..., 0] / z + cam.cx, cam.fy * p[..., 1] / z + cam.cy

    (u, v), (ud, vd) = px(pred), px(dst)
    return (u - ud) ** 2 + (v - vd) ** 2


def _hyp_inliers(cam, s, R, t, src, dst, pair_ok):
    """Pairs consistent with (s, R, t) in both directions (reference
    Sim3Solver::CheckInliers)."""
    e1 = _reproj_err(cam, R, t, s, src, dst)
    Rt = R.transpose(-1, -2)
    s_safe = torch.clamp_min(s, 1e-9)
    e2 = _reproj_err(cam, Rt, -torch.einsum("...ij,...j->...i", Rt, t) / s_safe[..., None],
                     1.0 / s_safe, dst, src)
    return (e1 < REPROJ_TH2) & (e2 < REPROJ_TH2) & pair_ok


def bow_matches(m: MapState, kf_id: torch.Tensor, cand: torch.Tensor,
                active: torch.Tensor) -> mcore.MatchResult:
    """Node-constrained SearchByBoW of keyframe kf_id's point-carrying
    features against each candidate's ([C] slots): [C, N] matches."""
    cl = cand.long()
    C, N = cl.shape[0], m.feat_cap
    cur_node = row(m.kf_node, kf_id)
    cur_has = (row(m.kf_obs_pt, kf_id) >= 0) & row(m.kf_feat_valid, kf_id)
    cand_has = (m.kf_obs_pt[cl] >= 0) & m.kf_feat_valid[cl]
    node_mask = (cur_node[None, :, None] == m.kf_node[cl][:, None, :]) \
        & (cur_node >= 0)[None, :, None]
    return mcore.mutual_best_match(row(m.kf_desc, kf_id).expand(C, N, 8), m.kf_desc[cl],
                                   node_mask, cur_has[None, :] & active[:, None], cand_has,
                                   max_dist=mcore.TH_LOW, ratio=0.75)


def draw_hypotheses(match_valid: torch.Tensor, generator: torch.Generator | None):
    """[C, N_HYPOTHESES, 3] minimal sets per candidate, drawn with
    replacement among its matched features (a row with no match draws
    uniformly, where torch refuses an all-zero distribution; it loses
    through its inlier count)."""
    C, n = match_valid.shape
    w = match_valid.to(torch.float32)
    w = torch.where(torch.any(match_valid, dim=1, keepdim=True), w, 1.0)
    return torch.multinomial(w, N_HYPOTHESES * 3, replacement=True,
                             generator=generator).reshape(C, N_HYPOTHESES, 3)


def _sim3_verify(config: SlamConfig, m: MapState, kf_id: torch.Tensor, cand: torch.Tensor,
                 active: torch.Tensor, generator: torch.Generator | None,
                 sets: torch.Tensor | None = None):
    """ComputeSim3 of keyframe kf_id against [C] candidates at once:
    SearchByBoW -> Horn RANSAC -> projection match extension -> GN polish.
    `sets` ([C, N_HYPOTHESES, 3]) replaces the random minimal sets.
    Returns (n_inliers [C] int32, 0 where rejected; S [C, 8])."""
    cam = config.camera
    fix_scale = config.sensor != "mono"
    cl = cand.long()
    C, N, P = cl.shape[0], m.feat_cap, m.max_pt
    dev = m.kf_valid.device
    cur_obs = row(m.kf_obs_pt, kf_id)
    cur_has = (cur_obs >= 0) & row(m.kf_feat_valid, kf_id)
    cand_obs = m.kf_obs_pt[cl]                                      # [C, N]
    cand_has = (cand_obs >= 0) & m.kf_feat_valid[cl]
    Tcw_cand = m.kf_Tcw[cl]

    match = bow_matches(m, kf_id, cand, active)
    n_matches = torch.sum(match.valid, dim=1)
    j = torch.where(match.valid, match.idx, 0).long()
    pid_cand = cand_obs.gather(1, j).clamp(0, P - 1).long()
    p_cur = se3.transform_points(row(m.kf_Tcw, kf_id), m.pt_pos[cur_obs.clamp(0, P - 1).long()])
    p_cand = se3.transform_points(Tcw_cand, m.pt_pos[pid_cand])     # [C, N, 3]
    p_cur_c = p_cur.expand(C, N, 3)

    if sets is None:
        sets = draw_hypotheses(match.valid, generator)
    sets = sets.long()
    ci = torch.arange(C, device=dev)[:, None, None]
    s_h, R_h, t_h = horn_align(p_cand[ci, sets], p_cur[sets], with_scale=not fix_scale)
    if fix_scale:
        s_h = torch.ones_like(s_h)
    inl = _hyp_inliers(cam, s_h, R_h, t_h, p_cand[:, None], p_cur, match.valid[:, None])
    best = torch.argmax(torch.sum(inl, dim=-1), dim=1)              # [C], first maximum
    w_best = inl[torch.arange(C, device=dev), best].to(torch.float32)
    s_f, R_f, t_f = horn_align(p_cand, p_cur_c, w_best, with_scale=not fix_scale)
    if fix_scale:
        s_f = torch.ones_like(s_f)

    # SearchBySim3-style match extension (reference ORBmatcher.cc:1314):
    # the candidate's points projected into the current keyframe through the
    # RANSAC Sim3 claim window matches the BoW stage missed
    S_r = sim3.make(R_f, t_f, s_f)                                   # [C, 8]
    p_in_cur = sim3.apply(S_r, p_cand)
    vis = cand_has & (p_in_cur[..., 2] > 0)
    ext = mcore.mutual_best_match(
        m.kf_desc[cl], row(m.kf_desc, kf_id).expand(C, N, 8),
        mcore.window_mask(_pixels(cam, p_in_cur), row(m.kf_xy, kf_id),
                          torch.full((C, N), 7.5, device=dev)),
        vis, cur_has, max_dist=mcore.TH_HIGH, ratio=None)
    # merged correspondences by CURRENT-keyframe feature; the BoW match
    # wins where both exist
    off = torch.arange(C, device=dev)[:, None] * N
    ext_scatter = set_drop(torch.full((C * N,), -1, dtype=torch.int64, device=dev),
                           torch.where(ext.valid, ext.idx.long() + off, C * N),
                           torch.arange(N, device=dev).expand(C, N)).reshape(C, N)
    j_ext = torch.where(match.valid, j, torch.where(ext_scatter >= 0, ext_scatter, 0))
    pair_ok = match.valid | (ext_scatter >= 0)
    pid_cand2 = cand_obs.gather(1, j_ext).clamp(0, P - 1).long()
    p_cand2 = se3.transform_points(Tcw_cand, m.pt_pos[pid_cand2])
    uv_cand = m.kf_xy[cl].gather(1, j_ext.clamp(0, N - 1)[..., None].expand(C, N, 2))
    # inliers of the extended set under the refit transform, so the
    # recovered pairs enter the polish
    inl_ext = _hyp_inliers(cam, sim3.scale(S_r), sim3.rotation(S_r), sim3.translation(S_r),
                           p_cand2, p_cur_c, pair_ok)
    opt = optimize_sim3(cam, S_r, p_cur_c, p_cand2, row(m.kf_xy, kf_id).expand(C, N, 2),
                        uv_cand, inl_ext, fix_scale=fix_scale)
    S = opt.S12
    final_inl = torch.sum(_hyp_inliers(cam, sim3.scale(S), sim3.rotation(S),
                                       sim3.translation(S), p_cand2, p_cur_c, pair_ok), dim=1)
    ok = active & (n_matches >= 20) & (final_inl >= MIN_SIM3_INLIERS)
    return torch.where(ok, final_inl, 0).to(torch.int32), S


def loop_candidates(config: SlamConfig, m: MapState, kf_id: torch.Tensor):
    """Candidate retrieval (DetectLoop + DetectLoopCandidates): returns
    (slots [C] int32, active [C] bool, groups [C, K] bool) for the
    N_CANDIDATES best covisibility groups."""
    neg_inf = float("-inf")
    K = m.max_kf
    C_all = ms.covisibility_matrix_cached(m)
    covis = row(C_all, kf_id) > 0
    q_ids, q_vals = row(m.kf_bow_ids, kf_id), row(m.kf_bow_vals, kf_id)
    scores = bow_ops.sparse_l1_score(q_ids, q_vals, m.kf_bow_ids, m.kf_bow_vals)
    covis_min = torch.min(torch.where(covis & m.kf_valid, scores, float("inf")))
    # with no valid covisible score, the absolute floor (LoopClosing.cc:159-179)
    min_score = torch.where(torch.isfinite(covis_min), torch.clamp_max(covis_min, 1.0), 0.0)
    eligible = (m.kf_valid & ~covis & (m.kf_seq >= 0)
                & (m.kf_seq <= row(m.kf_seq, kf_id) - COOLDOWN))
    common = bow_ops.sparse_common_words(q_ids, m.kf_bow_ids)
    max_common = torch.max(torch.where(eligible, common, 0))
    word_ok = common.to(torch.float32) >= 0.8 * max_common.to(torch.float32)
    cand0 = eligible & word_ok & (scores >= min_score)

    # group scores of the G leaders at once (KeyFrameDatabase.cc:180-239)
    top_s, top_i = top_k(torch.where(cand0, scores, neg_inf), min(N_GROUP, K))
    rows = C_all[top_i].scatter(1, top_i[:, None], 0)              # [G, K], self dropped
    nbv, nbi = top_k(rows, min(10, K))
    nb_scores = scores[nbi]
    nb_is_cand = cand0[nbi] & (nbv > 0)
    own = scores[top_i]
    accs = own + torch.sum(torch.where(nb_is_cand, nb_scores, 0.0), dim=1)
    nb_best = torch.argmax(torch.where(nb_is_cand, nb_scores, neg_inf), dim=1)[:, None]
    use_nb = nb_is_cand.gather(1, nb_best)[:, 0] & (nb_scores.gather(1, nb_best)[:, 0] > own)
    best_kfs = torch.where(use_nb, nbi.gather(1, nb_best)[:, 0], top_i).to(torch.int32)
    # the CONSISTENCY group is the candidate's whole covisibility
    # neighbourhood and itself (reference spCandidateGroup, LoopClosing.cc:253)
    groups_all = torch.zeros_like(rows, dtype=torch.bool).scatter(1, nbi, nbv > 0)
    groups_all = groups_all.scatter(1, top_i[:, None], True)

    cand_live = torch.isfinite(top_s)
    accs = torch.where(cand_live, accs, neg_inf)
    group_keep = cand_live & (accs >= 0.75 * torch.max(accs))
    sel = torch.argsort(-torch.where(group_keep, accs, neg_inf), stable=True)[:N_CANDIDATES]
    return best_kfs[sel], group_keep[sel], groups_all[sel] & m.kf_valid[None, :]


def detect_and_verify(config: SlamConfig, m: MapState, kf_id: torch.Tensor,
                      generator: torch.Generator | None = None,
                      sets: torch.Tensor | None = None) -> LoopDetection:
    """Loop detection for keyframe kf_id (0-d tensor): retrieval, Sim3
    verification of the 3 best groups, the Scw projection gate.  `sets`
    fixes the RANSAC's minimal sets ([3, N_HYPOTHESES, 3])."""
    cam = config.camera
    cand_slots, cand_active, groups = loop_candidates(config, m, kf_id)
    n_inls, Ss = _sim3_verify(config, m, kf_id, cand_slots, cand_active, generator, sets)
    best_c = torch.argmax(n_inls)
    cand = row(cand_slots, best_c)
    S = row(Ss, best_c)
    final_inl = row(n_inls, best_c)

    # the loop group's points projected into the current keyframe through
    # the corrected pose Scw = S_cur_cand . S_cand_w; 40 matches needed
    gpt = ms.points_of_keyframes_cached(m, row(groups, best_c))
    CAP = config.caps.local_points
    gids = nonzero_padded(gpt, CAP, m.max_pt)
    g_ok = gids < m.max_pt
    g_c = gids.clamp(0, m.max_pt - 1)
    S_cw = sim3.compose(S, sim3.from_se3(row(m.kf_Tcw, cand)))
    p_c = sim3.apply(S_cw, m.pt_pos[g_c])
    uvc = _pixels(cam, p_c)
    visc = (g_ok & (p_c[:, 2] > 0) & (uvc[:, 0] >= 0) & (uvc[:, 0] < cam.width)
            & (uvc[:, 1] >= 0) & (uvc[:, 1] < cam.height))
    pm = mcore.mutual_best_match(
        m.pt_desc[g_c], row(m.kf_desc, kf_id),
        mcore.window_mask(uvc, row(m.kf_xy, kf_id), torch.full((CAP,), 10.0,
                                                                device=uvc.device)),
        visc, row(m.kf_feat_valid, kf_id), max_dist=mcore.TH_LOW, ratio=None)
    n_proj = torch.sum(pm.valid).to(torch.int32)
    found = (final_inl >= MIN_SIM3_INLIERS) & (n_proj >= MIN_PROJ_TOTAL)
    return LoopDetection(found=found, cand_kf=cand, S_cur_cand=S, n_inliers=final_inl,
                         n_proj=n_proj, groups=groups, group_ok=cand_active,
                         best_c=best_c.to(torch.int32))


def _search_and_fuse_loop(config: SlamConfig, m: MapState, kf_id: torch.Tensor,
                          det: LoopDetection) -> MapState:
    """Project the loop group's map points into the current keyframe and its
    top-10 covisibles and bind matches (reference LoopClosing::SearchAndFuse,
    src/LoopClosing.cc:809 -> ORBmatcher::Fuse(Scw, radius 4)): a free
    feature is bound to the loop point, a feature holding a point is rebound
    to it (LoopClosing.cc:835-845); the displaced points keep their other
    observations.  The 11 rows are one batch."""
    cam = config.camera
    K, P, N = m.max_kf, m.max_pt, m.feat_cap
    dev = m.kf_valid.device
    sf = scale_factors(config.orb, dev)
    bounds = (0.0, float(cam.width), 0.0, float(cam.height))

    counts = ms.covisibility_row_cached(m, row(m.kf_obs_pt, kf_id))
    counts = torch.where(torch.arange(K, device=dev) == kf_id, 0, counts)
    topv, topi = top_k(counts, min(10, K))
    grp_idx = torch.cat([kf_id.reshape(1).to(topi.dtype), topi])
    grp_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), topv > 0])

    lpt = ms.points_of_keyframes_cached(m, row(det.groups, det.best_c))
    CAP = config.caps.local_points
    cand = nonzero_padded(lpt, CAP, P)
    cand_ok = cand < P
    cand_c = cand.clamp(0, P - 1)
    pos, normal = m.pt_pos[cand_c], m.pt_normal[cand_c]
    mind = m.pt_min_dist[cand_c] * 0.8
    maxd = m.pt_max_dist[cand_c] * 1.2

    G = grp_idx.shape[0]
    obs_rows = m.kf_obs_pt[grp_idx]                                    # [G, N]
    vis, uv, dist, _ = torch.vmap(
        lambda T: in_frustum(cam, T, pos, normal, mind, maxd, bounds, view_cos_limit=0.5))(
            m.kf_Tcw[grp_idx])
    have = torch.zeros(G, P + 1, dtype=torch.bool, device=dev).scatter_(
        1, torch.where(obs_rows >= 0, obs_rows, P).long(), True)
    vis = vis & cand_ok & grp_ok[:, None] & ~have.gather(1, cand_c.expand(G, CAP))
    ratio = torch.clamp_min(maxd / 1.2, 1e-6) / torch.clamp_min(dist, 1e-6)
    log_sf = log_scale_factor(config.orb.scale_factor, dev)
    lvl = torch.clamp(torch.ceil(torch.log(ratio) / log_sf).to(torch.int32), 0,
                      config.orb.n_levels - 1)
    mm = mcore.mutual_best_match(
        m.pt_desc[cand_c].expand(G, CAP, 8), m.kf_desc[grp_idx],
        mcore.window_mask(uv, m.kf_xy[grp_idx], 4.0 * sf[lvl.long()])   # Fuse(Scw) radius 4
        & mcore.level_mask(lvl, m.kf_level[grp_idx], -1, 1),
        vis, m.kf_feat_valid[grp_idx], max_dist=mcore.TH_LOW, ratio=None)
    new_rows = torch.cat([obs_rows, obs_rows[:, :1]], dim=1).scatter_(
        1, torch.where(mm.valid, mm.idx, N).long(),
        torch.where(mm.valid, cand_c, NO_POINT).to(torch.int32))[:, :N]
    return m._replace(kf_obs_pt=set_drop(m.kf_obs_pt, torch.where(grp_ok, grp_idx, -1),
                                         new_rows))


def _resolve_seqs(m: MapState, seqs: torch.Tensor):
    """Live slot of each seq ([L] ints): (slot [L], ok [L])."""
    eq = m.kf_seq[None, :] == seqs[:, None]
    slot = torch.argmax(eq.to(torch.int32), dim=1)                  # first match
    ok = eq.gather(1, slot[:, None])[:, 0] & m.kf_valid[slot] & (seqs >= 0)
    return slot, ok


def essential_tree_edges(m: MapState):
    """Essential-graph backbone edges: the covisibility spanning tree
    (reference OptimizeEssentialGraph, src/Optimizer.cc:1100-1265; tree kept
    at KeyFrame.cc:498-556): each live keyframe connects to its tree parent,
    or to its temporal predecessor when the parent's seq no longer resolves
    to a live slot.  Returns (edge_i [K-1], edge_j [K-1], valid [K-1])."""
    order = torch.argsort(torch.where(m.kf_valid, m.kf_seq, 1 << 30), stable=True)
    seq_i, prev_j = order[1:], order[:-1]
    tp_slot, tp_ok = _resolve_seqs(m, m.kf_tree_parent_seq[seq_i])
    tp_ok &= tp_slot != seq_i
    seq_j = torch.where(tp_ok, tp_slot, prev_j)
    return seq_i, seq_j, m.kf_valid[seq_i] & m.kf_valid[seq_j]


def _apply_rows(S: torch.Tensor, idx: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """sim3.apply_point(S[idx], p) with each row's rotation built once."""
    R, t, s = sim3.rotation(S), sim3.translation(S), sim3.scale(S)
    return s[idx, None] * torch.einsum("pij,pj->pi", R[idx], p) + t[idx]


def correct_loop(config: SlamConfig, m: MapState, kf_id: torch.Tensor,
                 det: LoopDetection) -> MapState:
    """Essential-graph correction and map-point remapping (CorrectLoop),
    then the loop group's points fused into the current group."""
    K = m.max_kf
    dev = m.kf_valid.device
    idx = torch.arange(K, device=dev)
    S_old = sim3.from_se3(m.kf_Tcw)

    # persist the verified loop edge first (KeyFrame::AddLoopEdge), so this
    # and every later essential graph includes it
    L = m.loop_seq_i.shape[0]
    at = torch.arange(L, device=dev) == torch.remainder(m.n_loop, L)
    m = m._replace(
        loop_seq_i=torch.where(at, row(m.kf_seq, kf_id), m.loop_seq_i),
        loop_seq_j=torch.where(at, row(m.kf_seq, det.cand_kf), m.loop_seq_j),
        loop_meas=torch.where(at[:, None], det.S_cur_cand, m.loop_meas),
        n_loop=m.n_loop + 1)

    # the current keyframe's corrected pose: S_cur_cand . S_cand_w
    S_init = torch.where((idx == kf_id)[:, None],
                         sim3.compose(det.S_cur_cand, row(S_old, det.cand_kf)), S_old)

    seq_i, seq_j, seq_valid = essential_tree_edges(m)
    # strong covisibility edges: top-3 partners per keyframe with >= 30
    # shared observations (Optimizer.cc:1183-1230)
    C_all = torch.where(idx[:, None] == idx[None, :], 0, ms.covisibility_matrix_cached(m))
    topv, topi = top_k(C_all, 3)
    cov_ok = (topv >= 30) & m.kf_valid[:, None] & (topi != idx[:, None])
    cov_i, cov_j = idx.repeat_interleave(3), topi.reshape(-1)
    # every persisted loop edge, endpoints resolved from seqs
    loop_i, li_ok = _resolve_seqs(m, m.loop_seq_i)
    loop_j, lj_ok = _resolve_seqs(m, m.loop_seq_j)

    rel_i = torch.cat([seq_i, cov_i])
    rel_j = torch.cat([seq_j, cov_j])
    edge_meas = torch.cat([sim3.compose(S_old[rel_i], sim3.inverse(S_old[rel_j])), m.loop_meas])
    res = optimize_pose_graph(
        S_init, torch.cat([rel_i, loop_i]), torch.cat([rel_j, loop_j]), edge_meas,
        torch.cat([seq_valid, cov_ok.reshape(-1), li_ok & lj_ok]),
        ~m.kf_valid | (idx == det.cand_kf), n_iters=20)
    S_new = res.kf_sim3

    # SE3 poses back, points remapped through their reference keyframes:
    # p' = S_new_ref^-1 (S_old_ref p)   (Optimizer.cc:1297-1362)
    kf_Tcw = torch.where(m.kf_valid[:, None, None], sim3.to_se3(S_new), m.kf_Tcw)
    ref = m.pt_ref_kf.clamp(0, K - 1).long()
    p_new = _apply_rows(sim3.inverse(S_new), ref, _apply_rows(S_old, ref, m.pt_pos))
    m = m._replace(kf_Tcw=kf_Tcw, pt_pos=torch.where(m.pt_valid[:, None], p_new, m.pt_pos))

    # now that the poses agree, fuse the loop group's points into the
    # current keyframe's group; without these cross-sector observations the
    # global BA would pull the map back to the drifted configuration
    m = _search_and_fuse_loop(config, m, kf_id, det)
    return ms.rebuild_incidence(m)


def _needs_sharded_gba(config: SlamConfig, m: MapState) -> bool:
    return config.tracking.enable_loop_gba and m.max_kf * m.max_pt > 4 * 1024 * 1024


def _gba(config: SlamConfig, m: MapState, kf_Tcw, pt_pos, anchor_kf, n_pre: int, n_post: int):
    K = m.max_kf
    dev = m.kf_valid.device
    obs_uvr = torch.cat([m.kf_xy, m.kf_uright[..., None]], dim=-1)
    sigma2_kf = sigma2(config.orb, dev)[m.kf_level.long()]
    idx = torch.arange(K, device=dev)
    kf_free = m.kf_valid & (idx != anchor_kf) & (idx != 0)
    ba = bundle_adjust(config.camera, kf_Tcw, pt_pos, m.kf_obs_pt, obs_uvr, sigma2_kf,
                       m.kf_feat_valid & m.kf_valid[:, None], kf_free, m.pt_valid,
                       n_iters_pre=n_pre, n_iters_post=n_post, ur_weight=config.ur_weight)
    return ba.kf_Tcw, ba.pt_pos


def global_bundle_adjust(config: SlamConfig, m: MapState, anchor_kf):
    """Post-loop global BA in one call (reference RunGlobalBundleAdjustment,
    LoopClosing.cc:880): 4 Huber + 6 plain iterations over every keyframe
    but the anchor and slot 0.  Returns (kf_Tcw, pt_pos) for merge_gba."""
    return _gba(config, m, m.kf_Tcw, m.pt_pos, anchor_kf, 4, 6)


def global_bundle_adjust_slice(config: SlamConfig, m: MapState, kf_Tcw, pt_pos, anchor_kf,
                               huber: bool):
    """One Gauss-Newton iteration of the post-loop GBA on the (poses,
    points) state threaded through repeated calls, against the observation
    snapshot `m`: huber=True weights robustly (stage 1); huber=False
    re-gates outliers by chi2 at the current state and steps plainly
    (stage 2).  anchor_kf: a slot, as a Python int or a 0-d device tensor
    (a captured slice reads it from a static buffer)."""
    return _gba(config, m, kf_Tcw, pt_pos, anchor_kf, 1 if huber else 0, 0 if huber else 1)


def run_sharded_gba(config: SlamConfig, m: MapState, anchor_kf):
    """Sharded-Schur variant of global_bundle_adjust for maps too big for
    the dense assembly (max_kf * max_pt > 4 Mi): the reference never skips
    GBA (LoopClosing.cc:880).  10 Huber-weighted iterations over every
    keyframe but the anchor and slot 0, on a 1 x n mesh with n the most
    ranks of the world (one without a process group) that divide the point
    capacity; in a multi-process world every rank calls it with the same
    map.  Returns (kf_Tcw, pt_pos)."""
    from ..parallel.distributed_ba import distributed_bundle_adjust
    from ..parallel.mesh import MeshSpec, make_mesh, world

    n = world()[1]
    while n > 1 and m.max_pt % n:
        n -= 1
    mesh = make_mesh(MeshSpec(n_map=1, n_blk=n))
    dev = m.kf_valid.device
    obs_uvr = torch.cat([m.kf_xy, m.kf_uright[..., None]], dim=-1)
    sigma2_kf = sigma2(config.orb, dev)[m.kf_level.long()]
    idx = torch.arange(m.max_kf, device=dev)
    kf_free = m.kf_valid & (idx != int(anchor_kf)) & (idx != 0)
    res = distributed_bundle_adjust(
        mesh, config.camera, *(x[None] for x in (
            m.kf_Tcw, m.pt_pos, m.kf_obs_pt, obs_uvr, sigma2_kf,
            m.kf_feat_valid & m.kf_valid[:, None] & (m.kf_obs_pt >= 0), kf_free, m.pt_valid)),
        n_iters=10, ur_weight=config.ur_weight)
    return res.kf_Tcw[0], res.pt_pos[0]


def merge_gba(m: MapState, snap_kf_seq: torch.Tensor, snap_pt_birth: torch.Tensor,
              gba_kf_Tcw: torch.Tensor, gba_pt_pos: torch.Tensor) -> MapState:
    """Fold a global BA computed on a snapshot into the live map (reference
    write-back under the map mutex, LoopClosing.cc:897-1010): keyframes in
    the snapshot (matched by seq) take their optimized poses; keyframes
    created since are corrected through the spanning tree, T_child_new =
    T_child T_parent^-1 T_parent_new, in seq order; points in the snapshot
    (matched by birth stamp) take their optimized positions, newer points
    are remapped through their reference keyframe's correction, and a point
    whose reference slot holds no live keyframe stays where it is."""
    K = m.max_kf
    dev = m.kf_valid.device
    idx = torch.arange(K, device=dev)
    eq = snap_kf_seq[None, :] == m.kf_seq[:, None]
    j_of = torch.argmax(eq.to(torch.int32), dim=1)
    in_snap = eq.gather(1, j_of[:, None])[:, 0] & (m.kf_seq >= 0) & m.kf_valid
    T_live = m.kf_Tcw
    T_new = torch.where(in_snap[:, None, None], gba_kf_Tcw[j_of], T_live)

    # keyframes created during the GBA: one ordered pass (a parent is older
    # than its child, so it is final when the child is reached)
    pslot, p_ok = _resolve_seqs(m, m.kf_tree_parent_seq)
    need = m.kf_valid & ~in_snap & p_ok
    hop = T_live @ se3.inverse(T_live[pslot])                        # T_child T_parent^-1
    order = torch.argsort(torch.where(m.kf_valid, m.kf_seq, 1 << 30), stable=True)
    for i in range(K):
        slot = order[i]
        T_corr = row(hop, slot) @ row(T_new, row(pslot, slot))
        T_new = torch.where((idx == slot)[:, None, None] & row(need, slot), T_corr, T_new)

    pt_in_snap = (snap_pt_birth == m.pt_birth) & m.pt_valid
    ref = m.pt_ref_kf.clamp(0, K - 1).long()
    M = se3.inverse(T_new) @ T_live                                  # T_new_ref^-1 T_old_ref
    p_corr = torch.einsum("pij,pj->pi", M[ref, :3, :3], m.pt_pos) + M[ref, :3, 3]
    remap = m.pt_valid & m.kf_valid[ref]
    pt_pos = torch.where(pt_in_snap[:, None], gba_pt_pos,
                         torch.where(remap[:, None], p_corr, m.pt_pos))
    return m._replace(kf_Tcw=T_new, pt_pos=pt_pos)


def _clone_map(m: MapState) -> MapState:
    """A copy no later in-place keyframe insertion can reach."""
    return MapState(*(x.clone() for x in m))


class LoopCloser:
    """Loop detection, consistency chaining, correction and the sliced
    global BA of one System (reference LoopClosing thread).  `generator`
    drives the Sim3 RANSAC and must live on the map's device.  With
    `graphs` set (a program_graphs.CloserGraphs, which the System sets from
    its step graphs) detection, correction and the dense global BA's slices
    and merge run through it: replayed CUDA graphs on the card, the same
    calls on static buffers on the CPU; None runs them op by op (and so
    does the sharded global BA, with its merge, always)."""

    MAX_DETECT = 4              # keyframes per detection part
    MAX_PENDING_DETS = 0        # groups left queued by a non-blocking resolve
    STALE_DETECTION_KFS = 16    # corrections older than this many keyframes are dropped

    def __init__(self, config: SlamConfig, generator: torch.Generator | None = None):
        self.config = config
        self.enabled = config.vocab is not None
        self.generator = generator
        self.last_loop_kf = -999
        self._kf_counter = 0
        self.n_big_changes = 0   # reference Map::InformNewBigChange (Map.cc:111)
        # covisibility-consistency chaining: (group mask, chain length) of
        # the previous keyframe's BoW-stage candidates (LoopClosing.cc:229-305)
        self._consistent_groups: list = []
        self._pending_dets: list = []   # (part, LoopDetection batch) awaiting resolve
        self._pending_gba: dict | None = None
        self.last_gba_info: dict = {}
        # the gate values of every consumed detection (found, chain, inliers,
        # projections), read in the same transfer as the decision values
        self.debug_log: list = []
        # the LoopDetection of every correction applied, in order, on the
        # device (each closure's Sim3 S_cur_cand, its scale at [7])
        self.corrections: list = []
        self.graphs = None
        # groups within one part are detected against one pre-correction
        # map; the COOLDOWN check discards the rest after a mid-part
        # correction only while MAX_DETECT < COOLDOWN
        assert self.MAX_DETECT < COOLDOWN

    def warmup(self, m: MapState) -> None:
        """One detection, correction, both GBA slice kinds and a merge on a
        throwaway copy of `m`, results discarded (the JAX closer compiles its
        programs here; the port warms its device libraries and, with graphs,
        captures detection, correction, both slice kinds and the merge),
        with a generator of its own so that the closer's draws are not
        moved."""
        if not self.enabled:
            return
        dev = m.kf_valid.device
        gen = torch.Generator(device=dev).manual_seed(0)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        det = detect_and_verify(self.config, m, zero, gen)
        out = correct_loop(self.config, _clone_map(m), zero, det)
        if self.graphs is not None:
            self.graphs.capture(m, 0, self.generator, gen)
        if self.config.tracking.enable_loop_gba and not _needs_sharded_gba(self.config, out):
            if self.graphs is not None:   # each program runs once, then is captured
                self.graphs.capture_gba(out, 0)
                return
            T, p = out.kf_Tcw.clone(), out.pt_pos.clone()
            for huber in (True, False):
                T, p = global_bundle_adjust_slice(self.config, out, T, p, 0, huber)
            merge_gba(out, out.kf_seq.clone(), out.pt_birth.clone(), T, p)

    def process(self, m: MapState, kf_id) -> MapState:
        return self.process_group(m, [int(kf_id)])

    def process_group(self, m: MapState, slots: list) -> MapState:
        """Dispatch and a blocking resolve (the per-frame API)."""
        self.dispatch_group(m, slots)
        m, _ = self.resolve(m, block=True)
        return m

    def dispatch_group(self, m: MapState, slots: list) -> None:
        """Loop detection for a group of just-created keyframes (slots), in
        parts of MAX_DETECT; consumed by the next resolve()."""
        if not self.enabled or not slots:
            return
        with profiling.span("loop.dispatch"):
            self._dispatch_group(m, slots)

    def _dispatch_group(self, m: MapState, slots: list) -> None:
        live = []
        for s in slots:
            self._kf_counter += 1
            if self._kf_counter - self.last_loop_kf >= COOLDOWN:
                live.append((self._kf_counter, int(s)))
        profiling.count("detections", len(live))
        dev = m.kf_valid.device
        for start in range(0, len(live), self.MAX_DETECT):
            part = live[start: start + self.MAX_DETECT]
            dets = []
            for _, s in part:
                with profiling.span("loop.detect", dev):
                    if self.graphs is not None:
                        dets.append(self.graphs.detect(m, s, self.generator))
                    else:
                        dets.append(detect_and_verify(
                            self.config, m, torch.full((), s, dtype=torch.int32, device=dev),
                            self.generator))
            self._pending_dets.append((part, LoopDetection(*map(torch.stack, zip(*dets)))))

    def pending(self) -> int:
        return len(self._pending_dets) + (self._pending_gba is not None)

    def _dispatch_gba(self, m: MapState, anchor_kf: int) -> None:
        """Start the global BA on a snapshot of the corrected map; the stream
        keeps tracking on `m` while resolve() runs it slice by slice (the
        reference's detached GBA thread, LoopClosing.cc:797)."""
        if not self.config.tracking.enable_loop_gba:
            return
        g = dict(snap_seq=m.kf_seq.clone(), snap_birth=m.pt_birth.clone(),
                 t0=time.perf_counter(), anchor=int(anchor_kf), phase=0)
        if _needs_sharded_gba(self.config, m):
            g["path"] = "sharded"
            g["gba_T"], g["gba_p"] = run_sharded_gba(self.config, m, anchor_kf)
            g["phase"] = len(GBA_SLICES)
        else:
            g["path"] = "dense"
            g["graphs"] = self.graphs
            if self.graphs is not None:
                self.graphs.load_gba(m, anchor_kf)   # the programs' static snapshot
            else:
                g["snap"] = _clone_map(m)
            g["gba_T"], g["gba_p"] = m.kf_Tcw.clone(), m.pt_pos.clone()
        self._pending_gba = g

    def _advance_gba(self, block: bool = False) -> None:
        """One sliced-GBA iteration (all that remain when block=True):
        through the GBA programs when the GBA was dispatched with graphs,
        else op by op on its own snapshot."""
        g = self._pending_gba
        while g is not None and g["phase"] < len(GBA_SLICES):
            huber = GBA_SLICES[g["phase"]]
            with profiling.span("loop.gba_slice", g["gba_T"].device):
                if g["graphs"] is not None:
                    g["gba_T"], g["gba_p"] = g["graphs"].gba_slice(g["gba_T"], g["gba_p"], huber)
                else:
                    g["gba_T"], g["gba_p"] = global_bundle_adjust_slice(
                        self.config, g["snap"], g["gba_T"], g["gba_p"], g["anchor"], huber)
            g["phase"] += 1
            if g["phase"] == len(GBA_SLICES):
                g.pop("snap", None)   # release the observation snapshot
            if not block:
                break

    def _merge_pending_gba(self, m: MapState, fired: list) -> MapState:
        """Fold the finished global BA into the live map; the re-base payload
        is the newest keyframe's pose before and after the merge."""
        g, self._pending_gba = self._pending_gba, None
        with profiling.span("loop.merge", m.kf_valid.device):
            slot = ms.latest_kf(m)
            before = row(m.kf_Tcw, slot)
            if g.get("graphs") is not None:
                m = g["graphs"].merge(m, g["snap_seq"], g["snap_birth"], g["gba_T"], g["gba_p"])
            else:
                m = merge_gba(m, g["snap_seq"], g["snap_birth"], g["gba_T"], g["gba_p"])
            fired.append((slot, before, row(m.kf_Tcw, slot)))
        self.last_gba_info = {"gba_path": g["path"],
                              "gba_inflight_ms": (time.perf_counter() - g["t0"]) * 1e3}
        return m

    def resolve(self, m: MapState, block: bool = False):
        """Consume the dispatched detections (consistency chaining on the
        host, corrections, a new global BA each) and move the pending global
        BA on: merge it if its last slice ran in an earlier call, else run
        one slice.  block=True also runs every remaining slice and merges.
        Returns (map, fired): a re-base payload (keyframe slot, its pose
        before, its pose after; 0-d and [4, 4] tensors) per correction and
        per merge, in event order."""
        fired = []
        if not self.enabled:
            return m, fired
        with profiling.span("loop.resolve"):
            m = self._resolve(m, block, fired)
        return m, fired

    def _resolve(self, m: MapState, block: bool, fired: list) -> MapState:
        if self._pending_gba is not None:
            if self._pending_gba["phase"] >= len(GBA_SLICES):
                m = self._merge_pending_gba(m, fired)
            else:
                self._advance_gba()
        th = self.config.tracking.loop_consistency_th
        keep = 0 if block else self.MAX_PENDING_DETS
        while len(self._pending_dets) > keep:
            part, dets = self._pending_dets.pop(0)
            D, C = len(part), dets.group_ok.shape[1]
            host = torch.cat([x.reshape(D, -1).to(torch.int32) for x in (
                dets.found, dets.best_c, dets.cand_kf, dets.n_inliers, dets.n_proj,
                dets.group_ok, dets.groups)], dim=1).cpu().numpy()          # one transfer
            profiling.count("host_waits")
            for i, (counter, s) in enumerate(part):
                if counter - self.last_loop_kf < COOLDOWN:
                    continue  # an earlier keyframe of this part just fired
                found, best_c, cand, n_inl, n_proj = (int(x) for x in host[i, :5])
                g_ok = host[i, 5:5 + C].astype(bool)
                groups = host[i, 5 + C:].reshape(C, -1).astype(bool)
                new_groups = []
                chains = np.zeros(C, np.int32)
                for c in np.nonzero(g_ok)[0]:
                    chains[c] = 1 + max((n for g, n in self._consistent_groups
                                         if (g & groups[c]).any()), default=0)
                    new_groups.append((groups[c], int(chains[c])))
                self._consistent_groups = new_groups
                self.debug_log.append(dict(kf_counter=counter, lag=self._kf_counter - counter,
                                           found=bool(found), chain=int(chains[best_c]),
                                           cand=cand, n_groups=int(g_ok.sum()),
                                           n_inliers=n_inl, n_proj=n_proj))
                if not (found and chains[best_c] >= th):
                    continue
                # a detection measured against a map many keyframes ago
                # would bend a map that has moved on since
                if self._kf_counter - counter > self.STALE_DETECTION_KFS:
                    continue
                # a newer correction aborts the in-flight GBA (reference
                # mbStopGBA, LoopClosing.cc:586-593)
                self._pending_gba = None
                with profiling.span("loop.correct", m.kf_valid.device):
                    slot = ms.latest_kf(m)
                    before = row(m.kf_Tcw, slot)
                    det = LoopDetection(*(x[i] for x in dets))
                    if self.graphs is not None:
                        m = self.graphs.correct(m, s, det)
                    else:
                        m = correct_loop(self.config, m, torch.full(
                            (), s, dtype=torch.int32, device=m.kf_valid.device), det)
                    fired.append((slot, before, row(m.kf_Tcw, slot)))
                self.corrections.append(det)
                self._dispatch_gba(m, cand)
                self.last_loop_kf = counter
                self.n_big_changes += 1
                self._consistent_groups = []
        if block and self._pending_gba is not None:
            self._advance_gba(block=True)
            m = self._merge_pending_gba(m, fired)
        return m
