"""Monocular map initialization.

Counterpart of the JAX package's models/mono_init.py (reference
Tracking::MonocularInitialization + CreateInitialMapMonocular,
src/Tracking.cc:886-1180, and ORBmatcher::SearchForInitialization,
src/ORBmatcher.cc:515):

  * wide windowed mutual matching between the two bootstrap frames,
  * batched H/F RANSAC + motion recovery (ops/solvers/two_view.py),
  * initial map: two keyframes + triangulated points, refined by a short
    full BA and normalized to median scene depth 1 (reference :1081-1116).

The JAX package builds the map in the graph and selects it against the
untouched one at the end; here the success flag and the match count are read
on the host in one transfer, and a failed attempt returns before any map row
is written.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.indexing import indicator, row, set_drop, top_k
from ..ops.matching import core as mcore
from ..ops.optim.bundle_adjust import bundle_adjust
from ..ops.solvers.two_view import initialize_two_view
from . import map_state as ms
from . import pipeline
from .config import SlamConfig
from .frame import FrameData
from .map_state import NO_POINT, MapState
from .tracking import _frame_bow


class MonoInitResult(NamedTuple):
    success: bool                        # read on the host
    n_matches: int
    m: MapState                          # the map handed in, if not success
    carry: Optional[pipeline.TrackCarry]  # None if not success


def try_initialize(config: SlamConfig, m: MapState, f1: FrameData, f2: FrameData,
                   timestamp1, timestamp2, frame_id2: int,
                   generator: torch.Generator | None = None,
                   sets: torch.Tensor | None = None) -> MonoInitResult:
    """One bootstrap attempt from frames f1 (the reference view) and f2.
    The frames may carry more features than the map's rows hold (the doubled
    bootstrap budget); the best N are kept.  RANSAC sets come from
    `generator`, or are `sets` [256, 8]."""
    dev = f1.xy.device
    tcfg = config.tracking
    # --- SearchForInitialization: 100px windows, mutual best, ratio 0.9 ---
    radius = torch.full((f1.capacity,), 100.0, device=dev)
    wmask = mcore.window_mask(f1.xy, f2.xy, radius)
    # the reference restricts init matching to octave 0 (ORBmatcher.cc:540)
    l0 = (f1.level == 0)[:, None] & (f2.level == 0)[None, :]
    match = mcore.mutual_best_match(f1.desc, f2.desc, wmask & l0, f1.valid, f2.valid,
                                    max_dist=mcore.TH_LOW, ratio=0.9)
    match = match._replace(valid=mcore.rotation_consistency_mask(f1.angle, f2.angle, match))
    n_matches = torch.sum(match.valid)

    j = torch.where(match.valid, match.idx, 0).long()
    res = initialize_two_view(
        config.camera, f1.xy, f2.xy[j], match.valid, generator, n_hypotheses=256,
        min_points=tcfg.mono_init_min_points, min_parallax=tcfg.mono_init_min_parallax,
        sets=sets)
    success = (res.success & (n_matches >= tcfg.mono_init_min_matches)
               & (res.n_good >= tcfg.mono_init_min_points))
    ok, n_matches = torch.stack([success.to(n_matches.dtype), n_matches]).tolist()
    if not ok:
        return MonoInitResult(False, n_matches, m, None)
    good = res.is_triangulated & match.valid

    # --- median-depth normalization (reference :1087-1116) ---
    z = res.points[:, 2]
    z_sorted, _ = torch.sort(torch.where(good, z, torch.inf))
    n_good = torch.sum(good)
    med = row(z_sorted, torch.clamp(n_good // 2, 0, z.shape[0] - 1))
    inv_med = 1.0 / torch.clamp_min(med, 1e-6)
    pts = res.points * inv_med
    Tcw2 = res.Tcw2.clone()
    Tcw2[:3, 3] *= inv_med

    # --- doubled-budget bootstrap downselect ---
    # The reference extracts 2x nFeatures before the map exists
    # (mpIniORBextractor, src/Tracking.cc:121-124), so the two-view bootstrap
    # sees a dense candidate set.  Matching, RANSAC and triangulation above
    # ran at the doubled capacity; the N best features per frame
    # (triangulated ones first, then by response; equal keys by lowest
    # index) are kept for the fixed-capacity map rows.
    N = config.orb.feat_capacity()
    if f1.capacity > N:
        key1 = good.to(torch.float32) * 1e9 + f1.response
        _, idx1 = top_k(torch.where(f1.valid, key1, -torch.inf), N)
        prio2 = indicator(f2.capacity, torch.where(good, j, -1))
        key2 = prio2.to(torch.float32) * 1e9 + f2.response
        _, idx2 = top_k(torch.where(f2.valid, key2, -torch.inf), N)
        inv2 = torch.full((f2.capacity,), -1, dtype=torch.int64, device=dev)
        inv2[idx2] = torch.arange(N, device=dev)
        f1 = FrameData(*(a[idx1] for a in f1))
        f2 = FrameData(*(a[idx2] for a in f2))
        pts = pts[idx1]
        j = inv2[j[idx1]]
        good = good[idx1] & (j >= 0)
        j = torch.clamp(j, 0, N - 1)

    # --- build the two-keyframe map ---
    n = f1.capacity
    obs_none = torch.full((n,), NO_POINT, dtype=torch.int32, device=dev)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    frame_id2 = int(frame_id2)

    def insert(m, frame, Tcw, frame_id, timestamp):
        bow, words, nodes = _frame_bow(config, frame)
        return ms.insert_keyframe(m, frame, Tcw, frame_id, timestamp, obs_none,
                                  bow=bow, words=words, nodes=nodes)

    m, kf1 = insert(m, f1, eye, 0, timestamp1)
    m, kf2 = insert(m, f2, Tcw2, frame_id2, timestamp2)
    feat_idx = torch.arange(n, dtype=torch.int32, device=dev)
    m, new_ids = ms.add_points(m, config, kf1, feat_idx, pts, good)
    # bind the second view's observations
    tgt = torch.where(good & (new_ids >= 0), j, -1)
    obs2 = set_drop(row(m.kf_obs_pt, kf2), tgt, new_ids)
    m.kf_obs_pt.index_put_((kf2.reshape(1).long(),), obs2[None])
    m = ms.rebuild_incidence(m)  # direct rebind above: refresh the cache

    # --- short full BA over the 2-KF map (the reference runs GBA, 20 iterations) ---
    sel = torch.stack([kf1, kf2]).long()
    created = new_ids >= 0
    lut = set_drop(torch.full((m.max_pt,), -1, dtype=torch.int32, device=dev),
                   torch.where(created, new_ids, -1), feat_idx)
    obs = m.kf_obs_pt[sel]
    obs_pt_l = torch.where(obs >= 0, lut[torch.clamp(obs, 0, m.max_pt - 1).long()], -1)
    obs_uvr = torch.cat([m.kf_xy[sel], m.kf_uright[sel][..., None]], dim=-1)
    sigma2 = torch.from_numpy(config.orb.sigma2()).to(dev)[m.kf_level[sel].long()]
    ba = bundle_adjust(
        config.camera, m.kf_Tcw[sel],
        m.pt_pos[torch.clamp(new_ids, 0, m.max_pt - 1).long()],
        obs_pt_l, obs_uvr, sigma2, m.kf_feat_valid[sel],
        torch.tensor([False, True], device=dev), created,
        n_iters_pre=5, n_iters_post=10)
    m.kf_Tcw.index_put_((kf2.reshape(1).long(),), ba.kf_Tcw[1][None])
    m = m._replace(pt_pos=set_drop(m.pt_pos, torch.where(created, new_ids, -1), ba.pt_pos))

    carry = pipeline.init_carry(config, f2)._replace(
        Tcw=ba.kf_Tcw[1],
        last_obs_pt=obs2,
        last_obs_birth=torch.where(
            obs2 >= 0, m.pt_birth[torch.clamp(obs2, 0, m.max_pt - 1).long()], 0),
        frame_id=torch.tensor(frame_id2 + 1, dtype=torch.int32, device=dev),
        last_kf_frame_id=torch.tensor(frame_id2, dtype=torch.int32, device=dev),
        prev_inliers=res.n_good.to(torch.int32),
    )
    return MonoInitResult(True, n_matches, m, carry)
