"""Device meshes over torch.distributed ranks, and their collectives.

Counterpart of the JAX package's parallel/mesh.py.  The port runs one
process per device (one rank), so a mesh is the world's ranks reshaped
[n_map, n_blk] with the JAX axis names:
  * "map": data parallelism over independent maps or streams (no per-step
    collectives between maps);
  * "blk": block parallelism inside one map: point blocks (and their
    observation stripes) or pose-graph edges striped over ranks, reduced
    with all_reduce / all_gather along this axis.

Each axis has its process subgroups, made with dist.new_group once per rank
grid (every rank of the world makes every group, in one order, as
new_group requires).  The JAX collectives are Mesh methods:
all_gather(x, "blk") is dist.all_gather on the rank's blk group, psum(x,
"blk") is dist.all_reduce.  On an axis of size 1 a collective is the
identity, and with no process group initialized the world is one rank, so
single-device use needs no init_process_group.  A CUDA tensor is reduced
only over NCCL: on a group without it the collective raises instead of
going through the host.

A mesh larger than the world raises.  A rank outside a smaller mesh holds
no coordinate (`coords` is None); the sharded functions then run the whole
problem on that rank alone (`Mesh.for_this_rank`).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

_GROUPS: dict = {}


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) when no process group is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _group(ranks: Sequence[int]):
    """The process group of `ranks` in the current world, made on first use."""
    key = (id(dist.group.WORLD), tuple(int(r) for r in ranks))
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(key[1]))
    return _GROUPS[key]


class MeshSpec(NamedTuple):
    n_map: int = 1
    n_blk: int = 1

    @property
    def total(self) -> int:
        return self.n_map * self.n_blk


class Mesh:
    """A grid of ranks with named axes (jax.sharding.Mesh's `devices`,
    `axis_names` and `shape`), this rank's coordinates and one process
    group per axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        rank, _ = world()
        where = np.argwhere(self.devices == rank)
        self.coords = tuple(int(c) for c in where[0]) if len(where) else None
        self._groups = {}
        for ax, name in enumerate(self.axis_names):
            n = self.devices.shape[ax]
            if n == 1:
                continue
            for line in np.moveaxis(self.devices, ax, -1).reshape(-1, n):
                g = _group(line)
                if rank in line:
                    self._groups[name] = g

    @property
    def shape(self) -> dict:
        return {n: int(s) for n, s in zip(self.axis_names, self.devices.shape)}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def for_this_rank(self) -> "Mesh":
        """This mesh on a member rank; on a rank outside it, a mesh of that
        rank alone with the same axis names (every axis of size 1)."""
        if self.coords is not None:
            return self
        return Mesh(np.full((1,) * len(self.axis_names), world()[0]), self.axis_names)

    def axis_index(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]

    def _checked_group(self, x: torch.Tensor, name: str):
        g = self._groups[name]
        if x.is_cuda and "nccl" not in str(dist.get_backend(g)).lower():
            raise RuntimeError(f"a CUDA tensor on the {name!r} axis needs an NCCL process "
                               f"group; this one is {dist.get_backend(g)!r}")
        return g

    def all_gather(self, x: torch.Tensor, name: str, dim: int = 0) -> torch.Tensor:
        """jax.lax.all_gather(x, name, tiled=True) along `dim`."""
        if self.shape[name] == 1:
            return x
        g = self._checked_group(x, name)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shape[name])]
        dist.all_gather(parts, x, group=g)
        return torch.cat(parts, dim)

    def broadcast(self, x: torch.Tensor, name: str, index: int) -> torch.Tensor:
        """x of the rank at coordinate `index` along `name` on every rank of
        that axis (written into x, which is returned)."""
        if self.shape[name] == 1:
            return x
        g = self._checked_group(x, name)
        at = list(self.coords)
        at[self.axis_names.index(name)] = index
        dist.broadcast(x.view(torch.uint8) if x.dtype == torch.bool else x,
                       src=int(self.devices[tuple(at)]), group=g)
        return x

    def psum(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """jax.lax.psum(x, name), returned as a new tensor."""
        if self.shape[name] == 1:
            return x
        g = self._checked_group(x, name)
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=g)
        return y


def make_mesh(spec: MeshSpec, devices=None) -> Mesh:
    """The ("map", "blk") mesh over the first spec.total ranks of `devices`
    (default: every rank of the world)."""
    devices = list(devices) if devices is not None else list(range(world()[1]))
    if spec.total > len(devices):
        raise ValueError(f"mesh {spec} needs {spec.total} devices, have {len(devices)}")
    grid = np.asarray(devices[: spec.total]).reshape(spec.n_map, spec.n_blk)
    return Mesh(grid, ("map", "blk"))


class Placement(NamedTuple):
    """The port's NamedSharding: which mesh axis splits each leading dim."""

    mesh: Mesh
    spec: tuple


def map_sharding(mesh: Mesh) -> Placement:
    """Arrays with a leading per-map axis: [S, ...] split over "map"."""
    return Placement(mesh, ("map",))


def point_block_sharding(mesh: Mesh) -> Placement:
    """Per-map point blocks: [S, P, ...] split over ("map", "blk")."""
    return Placement(mesh, ("map", "blk"))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def shard(x: torch.Tensor, placement: Placement) -> torch.Tensor:
    """This rank's block of the global `x` under `placement`."""
    mesh = placement.mesh
    for dim, name in enumerate(placement.spec):
        n = mesh.shape[name]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over "
                             f"{name!r} of size {n}")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.axis_index(name) * size, size)
    return x


def unshard(x: torch.Tensor, placement: Placement) -> torch.Tensor:
    """The global array from every rank's block (the inverse of shard, by
    all_gather along each split dim, innermost first)."""
    for dim in reversed(range(len(placement.spec))):
        x = placement.mesh.all_gather(x, placement.spec[dim], dim)
    return x
