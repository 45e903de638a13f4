"""Helpers of the frozen ORB extractor: constants built once per device, a
stable top-k, and the rounding that the lower-precision control applies.

Frozen from the port's ops/constants.py and ops/indexing.py (their values
and tie order), so that the reference runs no code of the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
           np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
           np.dtype(np.bool_): torch.bool}

# None: every stage in float32.  A torch dtype (the control): the pyramid
# levels and the blurred patches are stored in it between stages.
STORAGE = None


def stored(x: torch.Tensor) -> torch.Tensor:
    """x as a stage stores it: unchanged, or rounded through STORAGE."""
    return x if STORAGE is None else x.to(STORAGE).to(x.dtype)


@functools.lru_cache(maxsize=None)
def constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def scale_factors(orb, device) -> torch.Tensor:
    """[L] float32 pyramid scale factors."""
    return constant(tuple(orb.scale_factors().tolist()), torch.float32, torch.device(device))


def _from_array(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    return torch.tensor(a.reshape(-1).tolist(), dtype=_DTYPES[a.dtype],
                        device=device).reshape(a.shape)


@functools.lru_cache(maxsize=None)
def _arrays(fn, args: tuple, device: torch.device):
    out = fn(*args)
    if isinstance(out, tuple):
        return tuple(_from_array(a, device) for a in out)
    return _from_array(out, device)


def from_numpy(fn, *args, device):
    """fn(*args), numpy arrays, as tensors on `device`, built once."""
    return _arrays(fn, args, torch.device(device))


def top_k(x: torch.Tensor, k: int):
    """The k largest first, equal values by lowest index (stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
