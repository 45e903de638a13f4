"""Distributed Sim(3) pose-graph optimization over a mesh of ranks.

Counterpart of the JAX package's parallel/distributed_pose_graph.py: the
essential-graph solve of ops/optim/pose_graph.py, sharded:

  * the "map" axis is data parallelism over independent maps (each
    sequence's pose graph is independent);
  * the "blk" axis shards the EDGE list of one map: each rank owns a stripe
    of edges, computes that stripe's residuals and 7x7 Jacobian blocks in
    closed form (pose_graph.edge_jacobians, where the JAX package takes
    jax.jacfwd) and assembles a partial normal system; the full system is
    its all_reduce over "blk".  The (small) damped solve and the pose update
    are replicated, so every rank holds the same poses for the next
    iteration: no gather.

As in distributed_ba.py, the public function takes the full [S, ...]
tensors on every rank and returns the full result on every rank.
"""

from __future__ import annotations

import torch

from ..ops.optim.pose_graph import damped_update, edge_residual, normal_equations
from .mesh import Mesh, Placement, map_sharding, shard, unshard


def _pg_one_map(mesh: Mesh, n_iters: int, damping: float, S, ei, ej, meas, valid, fixed):
    """One map on this rank: S [K, 8] (replicated over "blk"), the edge
    stripe ei, ej [El], meas [El, 8], valid [El], fixed [K]."""
    free = ~fixed
    ei, ej = ei.long(), ej.long()
    for _ in range(n_iters):
        H, b = normal_equations(S, ei, ej, meas, valid, free)
        # full normal system = sum of every rank's edge-stripe partials
        S = damped_update(S, mesh.psum(H, "blk"), mesh.psum(b, "blk"), free, damping)
    w = valid.to(torch.float32)
    r = edge_residual(S[ei], S[ej], meas)
    sums = mesh.psum(torch.stack([torch.sum(torch.sum(r * r, -1) * w), torch.sum(w)]), "blk")
    return S, sums[0] / torch.clamp_min(sums[1], 1.0)


def distributed_pose_graph(
    mesh: Mesh,
    kf_sim3: torch.Tensor,     # [S, K, 8]
    edge_i: torch.Tensor,      # [S, E] int32 (E divisible by mesh "blk")
    edge_j: torch.Tensor,      # [S, E] int32
    edge_meas: torch.Tensor,   # [S, E, 8] measured S_i . S_j^-1
    edge_valid: torch.Tensor,  # [S, E] bool
    kf_fixed: torch.Tensor,    # [S, K] bool
    n_iters: int = 20,
    damping: float = 1e-6,
):
    """Sharded pose-graph Gauss-Newton over ("map", "blk"), called on every
    rank of the mesh with the same full tensors.

    Returns (kf_sim3 [S, K, 8], mean_residual [S])."""
    mesh = mesh.for_this_rank()
    rows, edges = map_sharding(mesh), Placement(mesh, ("map", "blk"))
    S_l, fixed_l = shard(kf_sim3, rows), shard(kf_fixed, rows)
    ei, ej, meas, valid = (shard(x, edges) for x in (edge_i, edge_j, edge_meas, edge_valid))
    outs = [_pg_one_map(mesh, n_iters, damping, *a)
            for a in zip(S_l, ei, ej, meas, valid, fixed_l)]
    return (unshard(torch.stack([o[0] for o in outs]), rows),
            unshard(torch.stack([o[1] for o in outs]), rows))
