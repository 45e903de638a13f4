"""Multi-device scaling: meshes of ranks, sharded map state, distributed BA.

Counterpart of the JAX package's parallel/: keyframe and point blocks
sharded over a mesh of torch.distributed ranks (one process per device),
bundle adjustment reducing its Schur system with all_reduce / all_gather
over the "blk" axis, map-parallel processing of independent sequences on
the "map" axis (parallel/multi_map.py, refine_maps.py), and many camera
streams tracked in lockstep (parallel/fleet.py).  With no process group
initialized the world is one rank and every function runs on its own.
"""

from .mesh import make_mesh, MeshSpec  # noqa: F401
from .distributed_ba import distributed_bundle_adjust  # noqa: F401
from .distributed_pose_graph import distributed_pose_graph  # noqa: F401
from .multi_map import joint_refine, stack_maps  # noqa: F401
from .fleet import FleetTracker, make_fleet_mesh  # noqa: F401
