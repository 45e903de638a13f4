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

import numpy as np
import torch

from ...kernels import CudaKernel, check_launch
from .fast_nms import check_thresholds, fast_nms_plain

BAND = 16    # rows per band
STRIP = 128  # columns of one kernel tile

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


def launch(image: torch.Tensor, outs, thr_hi: float, thr_lo: float, H0p: int,
           dims, border: int, n_levels: int) -> None:
    """Launch the kernel on a CUDA slab and preallocated outputs `outs` =
    (hi_max, hi_arg, lo_max, lo_arg) as `empty_outputs` makes them, on the
    current stream; raises on what the kernel does not take."""
    _check(image, H0p, dims, n_levels)
    check_thresholds("fast band", thr_hi, thr_lo)
    if image.device.type != "cuda" or not image.is_contiguous():
        raise ValueError(f"fast band: need a contiguous CUDA slab, got one on "
                         f"{image.device}")
    h, w = image.shape
    shape = (h // BAND, out_width(w))
    for t, dtype in zip(outs, (torch.float32, torch.int32, torch.float32, torch.int32)):
        if (t.device != image.device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"fast band: outputs must be contiguous {shape} float32 / "
                             f"int32 tensors on {image.device}")
    flat = [int(v) for hw in dims[:n_levels] for v in hw]
    dims_hw = (ctypes.c_int * len(flat))(*flat)
    fn = kernel.function()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        rc = fn(image.data_ptr(), *(o.data_ptr() for o in outs), h, w, shape[1], H0p,
                dims_hw, n_levels, border, thr_hi, thr_lo, stream)
    check_launch(kernel, rc)


def empty_outputs(image: torch.Tensor):
    """Uninitialised (hi_max, hi_arg, lo_max, lo_arg) for a [h, w] slab."""
    h, w = image.shape
    shape = (h // BAND, out_width(w))
    hi_max = torch.empty(shape, dtype=torch.float32, device=image.device)
    hi_arg = torch.empty(shape, dtype=torch.int32, device=image.device)
    return hi_max, hi_arg, torch.empty_like(hi_max), torch.empty_like(hi_arg)


def fast_nms_bands_hi_lo(image: torch.Tensor, thr_hi: float, thr_lo: float,
                         H0p: int, dims, border: int, n_levels: int):
    """[G*H0p, W0] stacked slab -> (hi_max, hi_arg, lo_max, lo_arg), each
    [G*H0p//16, W0 rounded up to 16], border mask applied (zeros outside).
    Needs thr_hi >= thr_lo: the kernel rejects a pixel at the low threshold
    for both."""
    _check(image, H0p, dims, n_levels)
    check_thresholds("fast band", thr_hi, thr_lo)
    if image.device.type == "cpu":
        return fast_bands_plain(image, thr_hi, thr_lo, H0p, dims, border,
                                n_levels)
    outs = empty_outputs(image)
    launch(image, outs, thr_hi, thr_lo, H0p, dims, border, n_levels)
    return outs


def band_boxes(h: int, w: int, H0p: int, dims, border: int, n_levels: int):
    """Mirror of the kernel's band_box(): for each 16-row band of the slab
    the valid rows [r_lo, r_hi), counted from the band's first row, and the
    valid slab columns [c_lo, c_hi) its level's mask leaves; either range
    may be empty.  Four int64 arrays [h // 16]."""
    row0 = np.arange(h // BAND, dtype=np.int64) * BAND
    slc = row0 // H0p
    lvl = slc % n_levels
    row_in0 = row0 - slc * H0p
    dims_a = np.asarray([list(d) for d in dims[:n_levels]], dtype=np.int64)
    r_lo = np.maximum(border - row_in0, 0)
    r_hi = np.minimum(dims_a[lvl, 0] - border - row_in0, BAND)
    c_lo = np.full_like(row0, max(border, 0))
    c_hi = np.minimum(dims_a[lvl, 1] - border, w)
    return r_lo, r_hi, c_lo, c_hi


def live_tiles(h: int, w: int, H0p: int, dims, border: int, n_levels: int) -> np.ndarray:
    """[h // 16, ceil(out_width(w) / 128)] bool: the (band, 128-column
    strip) pairs that hold a pixel of `level_valid_mask`.  The kernel stages
    and scores a tile only if one of its bands is live in its strip, and
    writes zeros for the others."""
    r_lo, r_hi, c_lo, c_hi = band_boxes(h, w, H0p, dims, border, n_levels)
    col0 = np.arange(-(-out_width(w) // STRIP), dtype=np.int64) * STRIP
    cols = np.maximum(c_lo[:, None], col0[None]) < np.minimum(c_hi[:, None],
                                                               col0[None] + STRIP)
    return (r_lo < r_hi)[:, None] & cols


def scored_mask(h: int, w: int, H0p: int, dims, border: int, n_levels: int) -> np.ndarray:
    """[h, w] bool: the positions the kernel scores for a band live in
    their strip: within 1 row of the band's valid rows and 1 column of its
    valid columns, off the slab's 4-px border.  Everything the NMS of a
    valid pixel reads lies inside."""
    r_lo, r_hi, c_lo, c_hi = band_boxes(h, w, H0p, dims, border, n_levels)
    rows = np.arange(h, dtype=np.int64)[:, None]
    cols = np.arange(w, dtype=np.int64)[None, :]
    mask = np.zeros((h, w), bool)
    for band in np.nonzero(r_lo < r_hi)[0]:
        top = band * BAND
        mask |= ((rows >= top + r_lo[band] - 1) & (rows < top + r_hi[band] + 1)
                 & (cols >= c_lo[band] - 1) & (cols < c_hi[band] + 1))
    return mask & (rows >= 4) & (rows < h - 4) & (cols >= 4) & (cols < w - 4)


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
