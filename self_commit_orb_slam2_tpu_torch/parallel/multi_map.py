"""Multi-sequence sharded-map refinement (the "KITTI 00+02+05" configuration).

Counterpart of the JAX package's parallel/multi_map.py.  Several independent
maps (one per sequence) are refined jointly on a mesh of ranks: maps ride
the "map" axis (pure data parallelism), and inside each map the point
blocks / pose-graph edges are striped over "blk".  The distributed analogue
of running the reference's LoopClosing::RunGlobalBundleAdjustment
(src/LoopClosing.cc:880) once per sequence, back to back, on one CPU.

Pipeline per map:
  1. optional distributed Sim3 pose graph over sequential + strong
     covisibility (+ caller-provided loop) edges (Optimizer::
     OptimizeEssentialGraph, src/Optimizer.cc:1017);
  2. map points moved by their reference keyframe's correction (the
     reference's spanning-tree propagation, src/Optimizer.cc:1297-1345);
  3. distributed Schur-complement global BA (src/Optimizer.cc:55).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..models.config import SlamConfig
from ..models.map_state import MapState
from ..ops import se3, sim3
from .distributed_ba import distributed_bundle_adjust
from .distributed_pose_graph import distributed_pose_graph
from .mesh import Mesh

# reference Optimizer.cc:1053: covisibility edges enter the essential graph
# only above this shared-observation count
MIN_COVIS_WEIGHT = 100


def stack_maps(maps: Sequence[MapState]) -> MapState:
    """Stack S same-capacity maps into one [S, ...] batched MapState."""
    return MapState(*(torch.stack(xs) for xs in zip(*maps)))


def unstack_maps(batched: MapState, n: int) -> list[MapState]:
    return [MapState(*(x[s] for x in batched)) for s in range(n)]


def _covis_weights(m: MapState) -> torch.Tensor:
    """[S, K, K] shared-map-point counts (KeyFrame::UpdateConnections weight,
    reference KeyFrame.cc:386): one incidence matmul per map."""
    obs = (m.kf_obs_pt >= 0) & m.kf_feat_valid & m.kf_valid[:, :, None]
    S, K, _ = obs.shape
    P = m.pt_pos.shape[-2]
    pid = torch.clamp(m.kf_obs_pt, 0, P - 1).long()
    W = []
    for s in range(S):
        inc = torch.zeros(K, P, dtype=torch.float32, device=obs.device).scatter_add_(
            1, pid[s], obs[s].to(torch.float32)).clamp_max_(1.0)
        W.append(inc @ inc.T)
    eye = torch.eye(K, dtype=torch.float32, device=obs.device)
    return torch.stack(W) * (1.0 - eye)


def build_essential_edges(
    m: MapState,
    edge_cap: int,
    extra_i: np.ndarray | None = None,   # [S, L] caller loop edges
    extra_j: np.ndarray | None = None,
    min_weight: int = MIN_COVIS_WEIGHT,
    extra_meas: np.ndarray | None = None,  # [S, L, 8] Sim3 measurements
):
    """Sequential + strong-covisibility (+ loop) edges per map, padded to
    edge_cap (divisible by the blk width); built on the host in numpy.

    Non-loop edges are measured from the CURRENT poses: their residuals are
    zero at initialization, so they act purely as stiffness holding the
    chain together.  Loop edges MUST carry their own measurement
    (`extra_meas`, e.g. the Sim3 from loop detection): the reference's
    OptimizeEssentialGraph corrects drift precisely because loop-edge
    measurements come from the Sim3 solver, not the drifted poses
    (src/Optimizer.cc:1100-1265).  Loop edges without a measurement are a
    ValueError: they would be exact no-ops."""
    S = m.kf_valid.shape[0]
    dev = m.kf_valid.device
    W = _covis_weights(m).cpu().numpy()
    Tcw = m.kf_Tcw.cpu().numpy()
    valid = m.kf_valid.cpu().numpy()

    ei = np.zeros((S, edge_cap), np.int32)
    ej = np.zeros((S, edge_cap), np.int32)
    meas = np.tile(np.array([0, 0, 0, 1, 0, 0, 0, 1], np.float32), (S, edge_cap, 1))
    ok = np.zeros((S, edge_cap), bool)
    for s in range(S):
        pairs = []  # (a, b, measurement or None)
        live = np.nonzero(valid[s])[0]
        for a, b in zip(live[1:], live[:-1]):       # spanning / sequential chain
            pairs.append((int(a), int(b), None))
        for a, b in np.argwhere(np.triu(W[s]) >= min_weight):
            if valid[s, a] and valid[s, b] and abs(int(a) - int(b)) > 1:
                pairs.append((int(a), int(b), None))
        if extra_i is not None:
            if extra_meas is None:
                raise ValueError(
                    "loop edges need explicit Sim3 measurements (extra_meas); "
                    "measuring them from the drifted poses makes the pose "
                    "graph a no-op")
            for le, (a, b) in enumerate(zip(extra_i[s], extra_j[s])):
                if a >= 0 and b >= 0:
                    pairs.append((int(a), int(b), np.asarray(extra_meas[s, le])))
        pairs = pairs[:edge_cap]
        for e, (a, b, mm) in enumerate(pairs):
            ei[s, e], ej[s, e] = a, b
            if mm is None:
                rel = Tcw[s, a] @ np.linalg.inv(Tcw[s, b])
                mm = sim3.from_se3(torch.from_numpy(rel)).numpy()
            meas[s, e] = mm
            ok[s, e] = True
    return tuple(torch.from_numpy(x).to(dev) for x in (ei, ej, meas, ok))


def _apply_pose_graph_result(m: MapState, S_new: torch.Tensor) -> MapState:
    """Write optimized Sim3 poses back as SE3 (s = 1 after normalization)
    and move every map point by its reference keyframe's correction,
    x' = Tnew^-1 . Told . x (reference Optimizer.cc:1297-1345)."""
    K = m.kf_valid.shape[1]
    T_old = m.kf_Tcw
    T_new = torch.where(m.kf_valid[..., None, None], sim3.to_se3(S_new), T_old)
    ref = torch.clamp(m.pt_ref_kf, 0, K - 1).long()
    pick = lambda T: torch.gather(T, 1, ref[..., None, None].expand(*ref.shape, 4, 4))  # noqa: E731
    corr = se3.compose(se3.inverse(pick(T_new)), pick(T_old))             # [S, P, 4, 4]
    x = torch.einsum("spij,spj->spi", corr[..., :3, :3], m.pt_pos) + corr[..., :3, 3]
    x = torch.where(m.pt_valid[..., None], x, m.pt_pos)
    return m._replace(kf_Tcw=T_new, pt_pos=x)


def joint_refine(
    mesh: Mesh,
    config: SlamConfig,
    maps: Sequence[MapState],
    loop_edges: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
    edge_cap: int = 256,
    pg_iters: int = 20,
    ba_iters: int = 10,
    run_pose_graph: bool = True,
) -> list[MapState]:
    """Jointly refine S maps on the mesh (called on every rank with the
    same maps); returns the refined maps."""
    n = len(maps)
    m = stack_maps(maps)
    K = m.kf_valid.shape[1]
    dev = m.kf_valid.device
    first = torch.argmax(m.kf_valid.to(torch.int32), dim=1)
    is_first = torch.arange(K, device=dev)[None, :] == first[:, None]

    if run_pose_graph:
        li, lj, lm = loop_edges if loop_edges is not None else (None, None, None)
        ei, ej, meas, ok = build_essential_edges(m, edge_cap, li, lj, extra_meas=lm)
        S0 = sim3.from_se3(m.kf_Tcw)
        S_new, _ = distributed_pose_graph(mesh, S0, ei, ej, meas, ok, ~m.kf_valid | is_first,
                                          n_iters=pg_iters)
        m = _apply_pose_graph_result(m, S_new)

    obs_uvr = torch.cat([m.kf_xy, m.kf_uright[..., None]], dim=-1)
    sigma2 = torch.from_numpy(config.orb.sigma2()).to(dev)[m.kf_level.long()]
    res = distributed_bundle_adjust(
        mesh, config.camera, m.kf_Tcw, m.pt_pos, m.kf_obs_pt, obs_uvr, sigma2,
        m.kf_feat_valid & m.kf_valid[:, :, None] & (m.kf_obs_pt >= 0),
        m.kf_valid & ~is_first, m.pt_valid, n_iters=ba_iters,
    )
    m = m._replace(kf_Tcw=res.kf_Tcw, pt_pos=res.pt_pos)
    return unstack_maps(m, n)
