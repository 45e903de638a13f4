"""Move SLAM state between the JAX package and the port, as numpy arrays.

SLAM has no weights; its state (the map and the tracking carry) plays that
role.  Both packages use the same field names and shapes, so conversion is
field by field.  The only change of representation: descriptor words (and
the relocalization key) are uint32 in the JAX package and keep the same bits
as int32 (int64 for the key) here, because torch.uint32 has almost no
operators.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.frame import FrameData
from .models.map_state import MapState
from .models.pipeline import TrackCarry
from .ops import bow as bow_ops

_DESC_FIELDS = {"kf_desc", "pt_desc", "desc"}


def _as_dict(x) -> dict:
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


def _to_tensor(name: str, arr, device) -> torch.Tensor:
    a = np.asarray(arr)
    if name in _DESC_FIELDS and a.dtype == np.uint32:
        a = a.view(np.int32)
    elif name == "key":
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, order="C")).to(device)  # a copy: writable, 0-d kept


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if name in _DESC_FIELDS:
        a = a.view(np.uint32)
    elif name == "key":
        a = a.astype(np.uint32)
    return a


def state_from_numpy(map_np: dict, carry_np: dict | None, device):
    """JAX MapState / TrackCarry fields as numpy arrays (dicts or the
    namedtuples themselves; carry's last_frame may be either) -> the port's
    (MapState, TrackCarry or None) on `device`."""
    map_np = _as_dict(map_np)
    m = MapState(**{k: _to_tensor(k, map_np[k], device) for k in MapState._fields})
    if carry_np is None:
        return m, None
    carry_np = _as_dict(carry_np)
    fields = {}
    for k in TrackCarry._fields:
        if k == "last_frame":
            fd = _as_dict(carry_np[k])
            fields[k] = FrameData(**{f: _to_tensor(f, fd[f], device)
                                     for f in FrameData._fields})
        else:
            fields[k] = _to_tensor(k, carry_np[k], device)
    return m, TrackCarry(**fields)


def vocabulary_from_numpy(vocab_np, device) -> bow_ops.Vocabulary:
    """A JAX Vocabulary (its arrays as numpy; node descriptors uint32) -> the
    port's Vocabulary on `device`, with its child-descriptor table rebuilt."""
    v = _as_dict(vocab_np)
    return bow_ops.from_arrays(
        np.asarray(v["node_desc"]), np.asarray(v["node_children"]),
        np.asarray(v["word_id"]), np.asarray(v["word_weight"]),
        v["k"], v["L"], v["n_words"], v["levelsup"]).to(device)


def frame_from_numpy(frame_np, device) -> FrameData:
    """A JAX FrameData (numpy fields) -> the port's FrameData."""
    fd = _as_dict(frame_np)
    return FrameData(**{f: _to_tensor(f, fd[f], device) for f in FrameData._fields})


def state_to_numpy(m: MapState, carry: TrackCarry | None = None):
    """Inverse of state_from_numpy: (map dict, carry dict or None) of numpy
    arrays with the JAX package's dtypes (descriptors as uint32)."""
    map_np = {k: _to_numpy(k, getattr(m, k)) for k in MapState._fields}
    if carry is None:
        return map_np, None
    carry_np = {}
    for k in TrackCarry._fields:
        v = getattr(carry, k)
        carry_np[k] = ({f: _to_numpy(f, getattr(v, f)) for f in FrameData._fields}
                       if k == "last_frame" else _to_numpy(k, v))
    return map_np, carry_np
