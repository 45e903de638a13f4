"""FAST at two thresholds, 3x3 NMS, the per-level border mask and the
16-row band maxima over a stacked pyramid slab: the plain torch function
that the program's band kernel computes (frozen from the port's
ops/orb/fast_band.py and ops/orb/fast_nms.py, same expression order)."""

from __future__ import annotations

import torch

from .common import constant
from .fast import fast_response, nms3x3

BAND = 16   # rows per band
HALO = 4    # 3 (FAST ring) + 1 (NMS): the image border that scores 0


def out_width(w: int) -> int:
    return w + (-w) % BAND


def inner_mask(h: int, w: int, device) -> torch.Tensor:
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    return (rows >= HALO) & (rows < h - HALO) & (cols >= HALO) & (cols < w - HALO)


def level_valid_mask(h: int, w: int, H0p: int, dims, border: int, n_levels: int,
                     device) -> torch.Tensor:
    """[h, w] bool: the slab's pixels inside their level's image and border."""
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    slc = rows // H0p
    row_in = rows - slc * H0p
    lvl = slc % n_levels
    dims_t = constant(tuple(tuple(int(v) for v in d) for d in dims[:n_levels]),
                      torch.int64, torch.device(device))
    return ((row_in >= border) & (row_in < dims_t[lvl, 0] - border)
            & (cols >= border) & (cols < dims_t[lvl, 1] - border))


def fast_bands(image: torch.Tensor, thr_hi: float, thr_lo: float, H0p: int, dims,
               border: int, n_levels: int):
    """[G*H0p, W0] slab -> (hi_max, hi_arg, lo_max, lo_arg), each
    [G*H0p // 16, W0 rounded up to 16]."""
    h, w = image.shape
    wp = out_width(w)
    dev = image.device
    valid = level_valid_mask(h, w, H0p, dims, border, n_levels, dev)
    inb = inner_mask(h, w, dev)

    def bands(score):
        score = torch.where(valid, score, 0.0)
        score = torch.nn.functional.pad(score, (0, wp - w))
        sb = score.reshape(h // BAND, BAND, wp)
        mx = sb.amax(dim=1)
        ri = torch.arange(BAND, dtype=torch.int32, device=dev)[None, :, None]
        arg = torch.where(sb == mx[:, None], ri, BAND).amin(dim=1)
        return mx, arg

    hi, lo = (nms3x3(torch.where(inb, fast_response(image, thr), 0.0))
              for thr in (thr_hi, thr_lo))
    return (*bands(hi), *bands(lo))
