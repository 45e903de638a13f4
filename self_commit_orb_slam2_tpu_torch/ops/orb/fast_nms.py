"""FAST + 3x3 NMS at two thresholds, full score maps (kernel B2).

`fast_nms_hi_lo` is the port of the JAX package's
ops/orb/fast_pallas.py::fast_nms_hi_lo, the FAST kernel of the keypoint
selection with cells other than 16x16.  On a CUDA tensor it launches the
hand-written kernel `csrc/fast_nms.cu` (or raises); on a CPU tensor it runs
`fast_nms_plain`, the same function in plain torch with the same expression
order, which the CPU tests hold against the Pallas kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ...kernels import CudaKernel, check_launch
from .fast import fast_response, nms3x3

HALO = 4  # 3 (FAST ring) + 1 (NMS): the image border the kernel zeroes

kernel = CudaKernel(
    "fast_nms", "fast_nms.cu", "fast_nms_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
)


def check_thresholds(who: str, thr_hi: float, thr_lo: float) -> None:
    """Both FAST kernels reject a pixel for both thresholds where the low
    one finds no 9-arc, which is exact only for thr_hi >= thr_lo."""
    if not thr_hi >= thr_lo:
        raise ValueError(f"{who}: need thr_hi >= thr_lo, got {thr_hi} < {thr_lo}")


def launch(image: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
           thr_hi: float, thr_lo: float) -> None:
    """Launch the kernel on a CUDA image and preallocated outputs of its
    shape, on the current stream; raises on what the kernel does not take."""
    check_thresholds("fast nms", thr_hi, thr_lo)
    for name, t in (("image", image), ("hi", hi), ("lo", lo)):
        if (t.device != image.device or t.device.type != "cuda" or t.dtype != torch.float32
                or t.shape != image.shape or t.ndim != 2 or not t.is_contiguous()):
            raise ValueError(f"fast nms: {name} must be a contiguous 2-D float32 CUDA "
                             f"tensor of the image's shape, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    h, w = image.shape
    fn = kernel.function()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        rc = fn(image.data_ptr(), hi.data_ptr(), lo.data_ptr(), h, w,
                thr_hi, thr_lo, stream)
    check_launch(kernel, rc)


def fast_nms_hi_lo(image: torch.Tensor, thr_hi: float, thr_lo: float):
    """[H, W] float32 -> (hi, lo) NMS'd FAST score maps, each [H, W].
    Needs thr_hi >= thr_lo."""
    if image.dtype != torch.float32 or image.ndim != 2:
        raise ValueError(f"fast nms: need a 2-D float32 image, got "
                         f"{tuple(image.shape)} {image.dtype}")
    check_thresholds("fast nms", thr_hi, thr_lo)
    if image.device.type == "cpu":
        return fast_nms_plain(image, thr_hi, thr_lo)
    hi = torch.empty_like(image, memory_format=torch.contiguous_format)
    lo = torch.empty_like(hi)
    launch(image, hi, lo, thr_hi, thr_lo)
    return hi, lo


def inner_mask(h: int, w: int, device) -> torch.Tensor:
    """[h, w] bool: the pixels the kernel scores, off the image's 4-px border."""
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    return (rows >= HALO) & (rows < h - HALO) & (cols >= HALO) & (cols < w - HALO)


def fast_nms_plain(image: torch.Tensor, thr_hi: float, thr_lo: float):
    """Plain torch version of the kernel: fast_response with the 4-px
    border zeroed, then nms3x3, per threshold."""
    inb = inner_mask(*image.shape, image.device)
    return tuple(nms3x3(torch.where(inb, fast_response(image, thr), 0.0))
                 for thr in (thr_hi, thr_lo))
