"""Map checkpoint / resume.

Counterpart of the JAX package's models/checkpoint.py (the reference left
SaveMap/LoadMap as a TODO, include/System.h:146-149): the whole MapState
round-trips through one compressed npz, which enables persistent maps and
localization-only deployments against prebuilt maps.

Entries are keyed by field name, plus a schema-version entry, in the JAX
package's layout and dtypes (descriptor words as uint32), so a checkpoint
written by either package loads in the other.  Unknown entries are refused;
fields a checkpoint predates are synthesized from documented defaults where
that is safe.  Unlike the JAX package's loader this one reads the schema
version and refuses a newer one.
"""

from __future__ import annotations

import numpy as np

from ..convert import state_from_numpy, state_to_numpy
from .map_state import MapState

SCHEMA_VERSION = 2
_VERSION_KEY = "__schema_version__"

# Fields added after a checkpoint format existed, with shape-aware default
# factories (arg = the partially loaded field dict).  Only fields whose
# default is semantically safe belong here.
_FIELD_DEFAULTS = {
    # older checkpoints had no live spanning tree: -1 (root) falls back to
    # the temporal chain
    "kf_tree_parent_seq": lambda d: np.full(d["kf_valid"].shape[0], -1, np.int32),
    # older checkpoints had no per-point birth stamp (slot-reuse guard); 0
    # matches what carries re-derive on their first frame after the load
    "pt_birth": lambda d: np.zeros(d["pt_valid"].shape[0], np.int32),
}


def save_map(path: str, m: MapState) -> None:
    arrays, _ = state_to_numpy(m)
    arrays[_VERSION_KEY] = np.int32(SCHEMA_VERSION)
    np.savez_compressed(path, **arrays)


def load_map(path: str, device=None) -> MapState:
    """The map on `device`: the card unless the caller asks for the CPU
    (models/system.resolve_device)."""
    from .system import resolve_device  # system imports this module

    device = resolve_device(device)
    with np.load(path) as z:
        if _VERSION_KEY not in z.files:
            raise ValueError(f"{path}: not a name-keyed map checkpoint (no schema "
                             "version; positional checkpoints must be re-saved)")
        version = int(z[_VERSION_KEY])
        if version > SCHEMA_VERSION:
            raise ValueError(f"{path}: checkpoint schema version {version} is newer "
                             f"than this package's {SCHEMA_VERSION}")
        d = {name: z[name] for name in z.files if name != _VERSION_KEY}
    unknown = set(d) - set(MapState._fields)
    if unknown:
        raise ValueError(f"{path}: unknown MapState fields {sorted(unknown)} "
                         "(checkpoint from a newer schema?)")
    for name in MapState._fields:
        if name not in d:
            factory = _FIELD_DEFAULTS.get(name)
            if factory is None:
                raise ValueError(f"{path}: missing MapState field '{name}' "
                                 "with no known default")
            d[name] = factory(d)
    return state_from_numpy(d, None, device)[0]
