"""FAST + NMS + per-level border mask + 16-row band max/argmax (kernel B1).

`fast_nms_bands_hi_lo` is the port of the JAX package's
ops/orb/fast_pallas.py::fast_nms_bands_hi_lo.  On a CUDA tensor it launches
the hand-written kernel `csrc/fast_band.cu` (or raises); on a CPU tensor it
runs `fast_bands_plain`, the same function in plain torch with the same
expression order, which the CPU tests hold against the Pallas kernel.

Output width: the band arrays are W0 rounded up to 16 columns (the TPU kernel
padded to 128 lanes).  The extra columns lie past the border mask and are
zero in both, and select_keypoints_bands sees the same real cells in the same
relative order.
"""

from __future__ import annotations

import ctypes

import torch

from ...kernels import CudaKernel, check_launch
from .fast_nms import fast_nms_plain

BAND = 16  # rows per band

kernel = CudaKernel(
    "fast_band", "fast_band.cu", "fast_band_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
       ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
)


def _check(image: torch.Tensor, H0p: int, dims, n_levels: int) -> None:
    if image.dtype != torch.float32 or image.ndim != 2:
        raise ValueError(f"fast band: need a 2-D float32 slab, got "
                         f"{tuple(image.shape)} {image.dtype}")
    h = image.shape[0]
    if H0p % BAND or h % H0p:
        raise ValueError(f"fast band: slab height {h} must be a multiple of "
                         f"H0p={H0p}, itself a multiple of {BAND}")
    if len(dims) < n_levels or not 1 <= n_levels <= 32:
        raise ValueError(f"fast band: need dims for {n_levels} levels (<= 32)")


def out_width(w: int) -> int:
    return w + (-w) % BAND


def fast_nms_bands_hi_lo(image: torch.Tensor, thr_hi: float, thr_lo: float,
                         H0p: int, dims, border: int, n_levels: int):
    """[G*H0p, W0] stacked slab -> (hi_max, hi_arg, lo_max, lo_arg), each
    [G*H0p//16, W0 rounded up to 16], border mask applied (zeros outside)."""
    _check(image, H0p, dims, n_levels)
    if image.device.type == "cpu":
        return fast_bands_plain(image, thr_hi, thr_lo, H0p, dims, border,
                                n_levels)
    if image.device.type != "cuda":
        raise ValueError(f"fast band: no kernel for device {image.device}")
    if not image.is_contiguous():
        raise ValueError("fast band: slab must be contiguous")
    h, w = image.shape
    wp = out_width(w)
    shape = (h // BAND, wp)
    hi_max = torch.empty(shape, dtype=torch.float32, device=image.device)
    lo_max = torch.empty_like(hi_max)
    hi_arg = torch.empty(shape, dtype=torch.int32, device=image.device)
    lo_arg = torch.empty_like(hi_arg)
    flat = [int(v) for hw in dims[:n_levels] for v in hw]
    dims_hw = (ctypes.c_int * len(flat))(*flat)
    fn = kernel.function()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        rc = fn(image.data_ptr(), hi_max.data_ptr(), hi_arg.data_ptr(),
                lo_max.data_ptr(), lo_arg.data_ptr(), h, w, wp, H0p, dims_hw,
                n_levels, border, thr_hi, thr_lo, stream)
    check_launch(kernel, rc)
    return hi_max, hi_arg, lo_max, lo_arg


def level_valid_mask(h: int, w: int, H0p: int, dims, border: int, n_levels: int,
                     device) -> torch.Tensor:
    """[h, w] bool: the pixels of the stacked slab inside their level's image
    and its `border`, the pixels whose scores the bands keep."""
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    slc = rows // H0p
    row_in = rows - slc * H0p
    lvl = slc % n_levels
    dims_t = torch.tensor([list(d) for d in dims[:n_levels]], dtype=torch.int64,
                          device=device)
    hr = dims_t[lvl, 0]
    wr = dims_t[lvl, 1]
    return ((row_in >= border) & (row_in < hr - border)
            & (cols >= border) & (cols < wr - border))


def fast_bands_plain(image: torch.Tensor, thr_hi: float, thr_lo: float,
                     H0p: int, dims, border: int, n_levels: int):
    """Plain torch version of the kernel: fast_nms_plain (FAST with the
    slab's 4-px border zeroed, NMS), the per-level border mask, the band
    reduction."""
    h, w = image.shape
    wp = out_width(w)
    dev = image.device
    valid = level_valid_mask(h, w, H0p, dims, border, n_levels, dev)

    def bands(score):
        score = torch.where(valid, score, 0.0)
        score = torch.nn.functional.pad(score, (0, wp - w))
        sb = score.reshape(h // BAND, BAND, wp)
        mx = sb.amax(dim=1)
        ri = torch.arange(BAND, dtype=torch.int32, device=dev)[None, :, None]
        arg = torch.where(sb == mx[:, None], ri, BAND).amin(dim=1)  # first row of the max
        return mx, arg

    hi, lo = fast_nms_plain(image, thr_hi, thr_lo)
    hi_max, hi_arg = bands(hi)
    lo_max, lo_arg = bands(lo)
    return hi_max, hi_arg, lo_max, lo_arg
