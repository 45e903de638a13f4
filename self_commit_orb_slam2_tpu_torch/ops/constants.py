"""Small constant tensors of the per-frame path, built once per device.

A tensor made from host data inside a step (`torch.tensor(...)`,
`torch.from_numpy(...).to(device)`, a Python scalar written into a slice)
is a copy from pageable host memory on the card: the stream waits for it,
and a CUDA graph cannot capture it.  The step's constants are built here
once per value, dtype and device and shared; callers read them and never
write into them.  Each is built from Python values (`torch.tensor` of a
nested list), so on the meta device no operand lies on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
           np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
           np.dtype(np.bool_): torch.bool}


@functools.lru_cache(maxsize=None)
def constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """torch.tensor(values, dtype=dtype, device=device), built once.  values
    is a Python number or a (nested) tuple of them."""
    return torch.tensor(values, dtype=dtype, device=device)


def scale_factors(orb, device) -> torch.Tensor:
    """[L] float32 pyramid scale factors of an OrbConfig."""
    return constant(tuple(orb.scale_factors().tolist()), torch.float32, torch.device(device))


def sigma2(orb, device) -> torch.Tensor:
    """[L] float32 squared scale factors (the per-level variance)."""
    return constant(tuple(orb.sigma2().tolist()), torch.float32, torch.device(device))


@functools.lru_cache(maxsize=None)
def log_scale_factor(scale_factor: float, device: torch.device) -> torch.Tensor:
    """0-d float32 log(scale_factor), computed on the device."""
    return torch.log(constant(scale_factor, torch.float32, device))


def camera_matrix(cam, device) -> torch.Tensor:
    """[3, 3] float32 intrinsics K of a CameraParams."""
    return constant(((cam.fx, 0.0, cam.cx), (0.0, cam.fy, cam.cy), (0.0, 0.0, 1.0)),
                    torch.float32, torch.device(device))


@functools.lru_cache(maxsize=None)
def inverse_camera_matrix(cam, device: torch.device) -> torch.Tensor:
    """[3, 3] float32 K^-1, computed on the device (inv_ex: no error check,
    so no sync)."""
    return torch.linalg.inv_ex(camera_matrix(cam, device))[0]


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
    """fn(*args) -- a numpy array, or a tuple of them, from a module-level
    function of hashable arguments -- as tensors of the same dtypes and
    shapes on `device`, built once per (fn, args, device)."""
    return _arrays(fn, args, torch.device(device))
