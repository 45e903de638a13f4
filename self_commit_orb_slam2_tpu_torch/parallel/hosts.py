"""Multi-process bring-up: torch.distributed + global mesh construction.

Counterpart of the JAX package's parallel/hosts.py.  Every process runs
this same program with one device, `initialize` wires the processes into
one process group, and the meshes built here span every rank: the
collectives of parallel/distributed_ba.py and distributed_pose_graph.py then
run over NCCL between cards (gloo for CPU tensors) with no change of code.

Single-process use needs none of this; multi-process use:

    from self_commit_orb_slam2_tpu_torch.parallel import hosts
    hosts.initialize()                  # env-driven (torchrun: automatic)
    mesh = hosts.global_mesh(n_map=2)   # ("map", "blk") over every rank

Under torchrun the address, world size and rank come from the environment
(MASTER_ADDR / WORLD_SIZE / RANK / TORCHELASTIC_RUN_ID) and `initialize()`
needs no arguments; elsewhere pass coordinator_address (a "tcp://host:port"
or "file://path" URL, or "host:port"), num_processes and process_id.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, MeshSpec, make_mesh, world

_initialized = False
_ENV_MARKERS = ("TORCHELASTIC_RUN_ID", "MASTER_ADDR", "WORLD_SIZE")


def _backend() -> str:
    """NCCL for CUDA tensors beside gloo for CPU tensors where both exist."""
    if torch.cuda.is_available() and dist.is_nccl_available():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: Optional[float] = None) -> None:
    """Idempotent torch.distributed bring-up (no-op if already done or
    single-process).  With a card, each process takes the card of its rank
    modulo the cards on its host."""
    global _initialized
    if _initialized:
        return
    kwargs = dict(backend=_backend())
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is not None:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        kwargs.update(init_method=url, world_size=num_processes, rank=process_id)
    elif num_processes in (None, 1) and not any(os.environ.get(k) for k in _ENV_MARKERS):
        return  # single process: nothing to wire (a later explicit call still may)
    else:
        kwargs.update(init_method="env://")
    if dist.is_initialized():
        # Only a double init is benign, and only while the running world is
        # the one asked for.  Every failure of init_process_group raises:
        # degrading a multi-process job to uncoordinated single processes
        # would corrupt it.
        if num_processes not in (None, dist.get_world_size()):
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is already "
                               f"initialized; {num_processes} were asked for")
    else:
        dist.init_process_group(**kwargs)
    if torch.cuda.is_available():
        torch.cuda.set_device(world()[0] % torch.cuda.device_count())
    _initialized = True


def shutdown() -> None:
    """Tear the process group down (after initialize); initialize may run again."""
    global _initialized
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def global_mesh(n_map: int = 1, n_blk: Optional[int] = None) -> Mesh:
    """("map", "blk") mesh over every rank of every host.

    Ranks are numbered host by host, so reshaping them to [n_map, n_blk]
    keeps each map's blk stripe on neighbouring ranks (one host where it
    fits) and lays the map axis, which needs no per-step traffic, across
    hosts."""
    total = world()[1]
    if total % n_map:
        raise ValueError(f"{total} devices not divisible by n_map={n_map}")
    n_blk = n_blk or total // n_map
    if n_map * n_blk > total:
        raise ValueError(f"mesh {n_map}x{n_blk} exceeds {total} devices")
    return make_mesh(MeshSpec(n_map=n_map, n_blk=n_blk))


def local_device_count() -> int:
    return torch.cuda.device_count()


def is_coordinator() -> bool:
    return world()[0] == 0


def fold_in_process(seed: int) -> np.random.Generator:
    """Per-process RNG (e.g. for host-side RANSAC set sampling)."""
    return np.random.default_rng(seed + 1315423911 * world()[0])
