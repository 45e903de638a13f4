"""The global map as fixed-capacity struct-of-arrays.

Counterpart of the JAX package's models/map_state.py (reference Map /
KeyFrame / MapPoint, src/Map.cc, src/KeyFrame.cc, src/MapPoint.cc), with the
same fields, shapes and meanings so `convert.py` moves a map between the two
packages field by field.  Descriptors are int32 words holding the JAX
package's uint32 bits.

Unlike the JAX pytree, the tensors here are updated in place by
insert_keyframe (the keyframe's slot rows) to avoid copying the [K, N, ...]
blocks on every keyframe; callers hand the map forward and keep no older
reference to it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import constants, se3
from ..ops.indexing import add_drop, indicator, nonzero_padded, row, set_drop
from .config import SlamConfig
from .frame import FrameData

NO_POINT = -1


class MapState(NamedTuple):
    # --- keyframes ---
    kf_Tcw: torch.Tensor        # [K, 4, 4]
    kf_valid: torch.Tensor      # [K] bool
    kf_frame_id: torch.Tensor   # [K] int32
    kf_timestamp: torch.Tensor  # [K] float32
    kf_xy: torch.Tensor         # [K, N, 2] undistorted coords
    kf_uright: torch.Tensor     # [K, N]
    kf_depth: torch.Tensor      # [K, N]
    kf_level: torch.Tensor      # [K, N] int32
    kf_angle: torch.Tensor      # [K, N]
    kf_desc: torch.Tensor       # [K, N, 8] int32 (uint32 bits)
    kf_feat_valid: torch.Tensor # [K, N] bool
    kf_obs_pt: torch.Tensor     # [K, N] int32 point id (-1 = none)
    kf_bow_ids: torch.Tensor    # [K, T] int32 (T = 1 without vocabulary)
    kf_bow_vals: torch.Tensor   # [K, T] float32
    kf_parent: torch.Tensor     # [K] int32 parent after culling (-1 = live)
    kf_Tcp: torch.Tensor        # [K, 4, 4]
    kf_tree_parent_seq: torch.Tensor  # [K] int32 spanning-tree parent seq
    kf_word: torch.Tensor       # [K, N] int32
    kf_node: torch.Tensor       # [K, N] int32
    kf_seq: torch.Tensor        # [K] int32 insertion sequence number (-1 unused)
    # --- map points ---
    pt_pos: torch.Tensor        # [P, 3]
    pt_normal: torch.Tensor     # [P, 3]
    pt_desc: torch.Tensor       # [P, 8] int32 (uint32 bits)
    pt_min_dist: torch.Tensor   # [P]
    pt_max_dist: torch.Tensor   # [P]
    pt_valid: torch.Tensor      # [P] bool
    pt_ref_kf: torch.Tensor     # [P] int32
    pt_first_kf: torch.Tensor   # [P] int32
    pt_visible: torch.Tensor    # [P] int32
    pt_found: torch.Tensor      # [P] int32
    pt_birth: torch.Tensor      # [P] int32 unique creation stamp (slot-reuse guard)
    pt_obs: torch.Tensor        # [P] int32 cached observation counts
    kf_pt_inc: torch.Tensor     # [K, P] int8 observation incidence cache
    # --- cull archive ---
    cull_seq: torch.Tensor         # [A] int32
    cull_parent_seq: torch.Tensor  # [A] int32
    cull_Tcp: torch.Tensor         # [A, 4, 4]
    n_culled: torch.Tensor         # scalar int32
    # --- persisted loop edges ---
    loop_seq_i: torch.Tensor       # [Lp] int32
    loop_seq_j: torch.Tensor       # [Lp] int32
    loop_meas: torch.Tensor        # [Lp, 8] Sim3
    n_loop: torch.Tensor           # scalar int32
    # --- counters (monotone totals) ---
    n_kf: torch.Tensor          # scalar int32: keyframes ever inserted (= next seq)
    n_pt: torch.Tensor          # scalar int32: points ever created

    @property
    def max_kf(self) -> int:
        return self.kf_Tcw.shape[0]

    @property
    def max_pt(self) -> int:
        return self.pt_pos.shape[0]

    @property
    def feat_cap(self) -> int:
        return self.kf_xy.shape[1]


def empty_map(config: SlamConfig, device) -> MapState:
    K = config.caps.max_keyframes
    P = config.caps.max_points
    N = config.orb.feat_capacity()
    A = config.caps.cull_log
    Lp = config.caps.loop_log
    T = config.bow_top if config.vocab is not None else 1
    f32, i32 = torch.float32, torch.int32
    eye = torch.eye(4, dtype=f32, device=device)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return MapState(
        kf_Tcw=eye.repeat(K, 1, 1),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), 0, i32),
        kf_timestamp=full((K,), 0.0, f32),
        kf_xy=full((K, N, 2), 0.0, f32),
        kf_uright=full((K, N), -1.0, f32),
        kf_depth=full((K, N), -1.0, f32),
        kf_level=full((K, N), 0, i32),
        kf_angle=full((K, N), 0.0, f32),
        kf_desc=full((K, N, 8), 0, i32),
        kf_feat_valid=full((K, N), False, torch.bool),
        kf_obs_pt=full((K, N), NO_POINT, i32),
        kf_bow_ids=full((K, T), -1, i32),
        kf_bow_vals=full((K, T), 0.0, f32),
        kf_parent=full((K,), -1, i32),
        kf_Tcp=eye.repeat(K, 1, 1),
        kf_tree_parent_seq=full((K,), -1, i32),
        kf_word=full((K, N), -1, i32),
        kf_node=full((K, N), -1, i32),
        kf_seq=full((K,), -1, i32),
        pt_pos=full((P, 3), 0.0, f32),
        pt_normal=full((P, 3), 0.0, f32),
        pt_desc=full((P, 8), 0, i32),
        pt_min_dist=full((P,), 0.0, f32),
        pt_max_dist=full((P,), 0.0, f32),
        pt_valid=full((P,), False, torch.bool),
        pt_ref_kf=full((P,), 0, i32),
        pt_first_kf=full((P,), 0, i32),
        pt_visible=full((P,), 0, i32),
        pt_found=full((P,), 0, i32),
        pt_birth=full((P,), 0, i32),
        pt_obs=full((P,), 0, i32),
        kf_pt_inc=full((K, P), 0, torch.int8),
        cull_seq=full((A,), -1, i32),
        cull_parent_seq=full((A,), -1, i32),
        cull_Tcp=eye.repeat(A, 1, 1),
        n_culled=full((), 0, i32),
        loop_seq_i=full((Lp,), -1, i32),
        loop_seq_j=full((Lp,), -1, i32),
        loop_meas=torch.tensor([0, 0, 0, 1, 0, 0, 0, 1], dtype=f32,
                               device=device).repeat(Lp, 1),
        n_loop=full((), 0, i32),
        n_kf=full((), 0, i32),
        n_pt=full((), 0, i32),
    )


def latest_kf(m: MapState) -> torch.Tensor:
    """Slot of the most recently inserted live keyframe."""
    return torch.argmax(torch.where(m.kf_valid, m.kf_seq, -1)).to(torch.int32)


def covisibility_row(m: MapState, pt_ids: torch.Tensor) -> torch.Tensor:
    """[K] shared observations between a point-id set and every keyframe,
    exact (from the observation table, not the incidence cache)."""
    ind = indicator(m.max_pt + 2, torch.where(pt_ids >= 0, pt_ids, m.max_pt + 1))
    hits = ind[torch.clamp(m.kf_obs_pt, 0, m.max_pt + 1).long()] & (m.kf_obs_pt >= 0)
    return torch.sum(hits & m.kf_feat_valid, dim=1).to(torch.int32) * m.kf_valid


def covisibility_row_cached(m: MapState, pt_ids: torch.Tensor) -> torch.Tensor:
    """[K] shared-observation counts from the cached incidence matrix (one
    matvec; counts of 0/1 terms are exact in fp32)."""
    z = indicator(m.max_pt, pt_ids, torch.float32)
    counts = m.kf_pt_inc.to(torch.float32) @ z
    return counts.to(torch.int32) * m.kf_valid


def points_of_keyframes_cached(m: MapState, kf_mask: torch.Tensor) -> torch.Tensor:
    """[P] bool: points observed by any keyframe of kf_mask (cached incidence)."""
    s = kf_mask.to(torch.float32) @ m.kf_pt_inc.to(torch.float32)
    return (s > 0) & m.pt_valid


def covisibility_of_points_cached(m: MapState, pt_mask: torch.Tensor) -> torch.Tensor:
    """[K] count of the points of a [P] bool mask each keyframe observes
    (cached incidence)."""
    counts = m.kf_pt_inc.to(torch.float32) @ pt_mask.to(torch.float32)
    return counts.to(torch.int32) * m.kf_valid


def covisibility_matrix_cached(m: MapState) -> torch.Tensor:
    """[K, K] keyframe-keyframe shared-observation counts, inc @ inc.T."""
    inc = m.kf_pt_inc.to(torch.float32)
    C = (inc @ inc.T).to(torch.int32)
    return C * (m.kf_valid[:, None] & m.kf_valid[None, :])


def points_of_keyframes(m: MapState, kf_mask: torch.Tensor) -> torch.Tensor:
    """[P] bool: points observed by any keyframe of kf_mask (exact, from the
    observation table)."""
    obs = torch.where(kf_mask[:, None] & (m.kf_obs_pt >= 0), m.kf_obs_pt, -1)
    return indicator(m.max_pt, obs.reshape(-1)) & m.pt_valid


def observation_count(m: MapState) -> torch.Tensor:
    """[P] int32 number of keyframes observing each point."""
    ok = m.kf_feat_valid & (m.kf_obs_pt >= 0) & m.kf_valid[:, None]
    zero = torch.zeros(m.max_pt, dtype=torch.int32, device=m.pt_valid.device)
    return add_drop(zero, torch.where(ok, m.kf_obs_pt, -1).reshape(-1), 1)


def keyframe_positions(m: MapState) -> torch.Tensor:
    """[K, 3] camera centres c = -R^T t."""
    return -torch.einsum("kij,ki->kj", m.kf_Tcw[:, :3, :3], m.kf_Tcw[:, :3, 3])


def rebuild_incidence(m: MapState) -> MapState:
    """Recompute the incidence cache kf_pt_inc and pt_obs from the
    observation table; the last step of every mapping pass, so the cache
    the per-frame tracking reads reflects its culls and rebinds."""
    K, P = m.max_kf, m.max_pt
    ok = m.kf_valid[:, None] & m.kf_feat_valid & (m.kf_obs_pt >= 0)
    flat = torch.arange(K, device=ok.device)[:, None] * (P + 1) + torch.where(
        ok, m.kf_obs_pt, P).long()
    inc = indicator(K * (P + 1), flat.reshape(-1), torch.int8).reshape(K, P + 1)[:, :P]
    return m._replace(kf_pt_inc=inc, pt_obs=inc.sum(0, dtype=torch.int32))


def _inc_row(m: MapState, obs_pt: torch.Tensor, feat_valid: torch.Tensor) -> torch.Tensor:
    """[P] int8 incidence row for one keyframe's observation row."""
    return indicator(m.max_pt, torch.where(feat_valid & (obs_pt >= 0), obs_pt, -1),
                     torch.int8)


def insert_keyframe(m: MapState, frame: FrameData, Tcw: torch.Tensor,
                    frame_id, timestamp, obs_pt: torch.Tensor,
                    bow: tuple | None = None, words: torch.Tensor | None = None,
                    nodes: torch.Tensor | None = None):
    """Insert a keyframe into the first free slot (reference
    Tracking::CreateNewKeyFrame + Map::AddKeyFrame); the write is dropped if
    every slot is live.  bow: sparse (ids [T], vals [T]) from
    ops/bow.sparse_bow; words, nodes: [N] from ops/bow.transform.  Returns
    (map, slot)."""
    dev = m.kf_valid.device
    slot = torch.argmin(m.kf_valid.to(torch.int8)).reshape(1)   # first free slot
    ok = ~m.kf_valid[slot][0]
    obs_row = torch.where(frame.valid, obs_pt, NO_POINT)
    # spanning-tree parent: the most covisible existing keyframe (exact row)
    tree_counts = covisibility_row(m, obs_row)
    tp = torch.argmax(tree_counts)
    parent_seq = torch.where(row(tree_counts, tp) > 0, row(m.kf_seq, tp), -1)

    def w(arr, val):
        val = val.to(arr.dtype) if torch.is_tensor(val) else arr.new_full((), val)
        arr.index_put_((slot,), torch.where(ok, val, arr[slot][0])[None])

    w(m.kf_Tcw, Tcw)
    w(m.kf_seq, m.n_kf)
    w(m.kf_parent, -1)
    w(m.kf_Tcp, torch.eye(4, dtype=torch.float32, device=dev))
    w(m.kf_tree_parent_seq, parent_seq)
    w(m.kf_frame_id, frame_id)
    w(m.kf_timestamp, timestamp)
    w(m.kf_xy, frame.xy)
    w(m.kf_uright, frame.u_right)
    w(m.kf_depth, frame.depth)
    w(m.kf_level, frame.level)
    w(m.kf_angle, frame.angle)
    w(m.kf_desc, frame.desc)
    w(m.kf_feat_valid, frame.valid)
    w(m.kf_obs_pt, obs_row)
    w(m.kf_pt_inc, _inc_row(m, obs_pt, frame.valid))
    if bow is not None:
        w(m.kf_bow_ids, bow[0])
        w(m.kf_bow_vals, bow[1])
    if words is not None:
        w(m.kf_word, words)
    if nodes is not None:
        w(m.kf_node, nodes)
    m.kf_valid.index_put_((slot,), (ok | m.kf_valid[slot][0])[None])
    # keep the cached observation counts consistent with the new row
    pt_obs = add_drop(m.pt_obs, torch.where(ok & frame.valid, obs_pt, -1), 1)
    m = m._replace(pt_obs=pt_obs, n_kf=m.n_kf + ok.to(torch.int32))
    return m, slot[0].to(torch.int32)


def add_points(m: MapState, config: SlamConfig, kf_id: torch.Tensor,
               feat_idx: torch.Tensor, positions: torch.Tensor,
               create_mask: torch.Tensor):
    """Create map points observed by keyframe kf_id in the first free point
    slots, with normal and scale band (reference MapPoint creation +
    UpdateNormalAndDepth, src/MapPoint.cc:477-533).  Returns (map, ids [M],
    -1 where not created)."""
    dev = positions.device
    scale_factors = constants.scale_factors(config.orb, dev)
    n_levels = config.orb.n_levels
    P = m.max_pt
    M = create_mask.shape[0]
    free = nonzero_padded(~m.pt_valid, M, P + 1)
    rank = torch.cumsum(create_mask.to(torch.int64), 0) - 1
    ids = free[torch.clamp(rank, 0, M - 1)]
    create_mask = create_mask & (ids <= P)
    ids = torch.where(create_mask, ids, P + 1)       # out of range -> dropped

    kf_Tcw = row(m.kf_Tcw, kf_id)
    cam_center = se3.inverse(kf_Tcw)[:3, 3]
    rays = positions - cam_center
    dist = torch.linalg.norm(rays, dim=-1)
    normal = rays / torch.clamp_min(dist[:, None], 1e-9)
    level = row(m.kf_level, kf_id)[feat_idx.long()]
    max_dist = dist * scale_factors[level.long()]
    min_dist = max_dist / scale_factors[n_levels - 1]
    desc = row(m.kf_desc, kf_id)[feat_idx.long()]
    kf_seq = row(m.kf_seq, kf_id)

    inc = m.kf_pt_inc.reshape(-1)
    inc_idx = torch.where(ids < P, kf_id.long() * P + ids, inc.shape[0])
    obs_row = row(m.kf_obs_pt, kf_id)
    obs_new = set_drop(obs_row, feat_idx,
                       torch.where(create_mask, ids, obs_row[feat_idx.long()].long()))
    m.kf_obs_pt.index_put_((kf_id.reshape(1).long(),), obs_new[None])
    m2 = m._replace(
        pt_pos=set_drop(m.pt_pos, ids, positions),
        pt_normal=set_drop(m.pt_normal, ids, normal),
        pt_desc=set_drop(m.pt_desc, ids, desc),
        pt_min_dist=set_drop(m.pt_min_dist, ids, min_dist),
        pt_max_dist=set_drop(m.pt_max_dist, ids, max_dist),
        pt_valid=set_drop(m.pt_valid, ids, True),
        pt_ref_kf=set_drop(m.pt_ref_kf, ids, kf_id),
        pt_first_kf=set_drop(m.pt_first_kf, ids, kf_seq),
        pt_visible=set_drop(m.pt_visible, ids, 1),
        pt_found=set_drop(m.pt_found, ids, 1),
        pt_birth=set_drop(m.pt_birth, ids, m.n_pt + rank),
        pt_obs=set_drop(m.pt_obs, ids, 1),
        kf_pt_inc=set_drop(inc, inc_idx, 1).reshape(m.kf_pt_inc.shape),
        n_pt=m.n_pt + torch.sum(create_mask).to(torch.int32),
    )
    return m2, torch.where(create_mask, ids, NO_POINT).to(torch.int32)
