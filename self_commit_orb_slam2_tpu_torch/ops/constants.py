"""Small constant tensors of the per-frame path, built once per device.

A tensor made from host data inside a step (`torch.tensor(...)`,
`torch.from_numpy(...).to(device)`, a Python scalar written into a slice)
is a copy from pageable host memory on the card: the stream waits for it,
and a CUDA graph cannot capture it.  The step's constants are built here
once per value, dtype and device and shared; callers read them and never
write into them.
"""

from __future__ import annotations

import functools

import torch


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
