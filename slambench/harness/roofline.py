"""Peaks of the card and the least time of kernel B1 (FAST + NMS + band
maxima over a stacked pyramid slab), as plain arithmetic over shapes.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, 3.35 TB/s
of HBM and 67 TFLOP/s of float32 outside the tensor cores.  B1's bytes are
those of chip_smoke.py's count: every slab pixel within 4 of a level's
valid region (a valid pixel's NMS reads scores within 1, a score reads the
ring within 3) read once, and the four [h/16, w rounded to 16] band arrays
written once.  The valid region of a slice is its level's image less a
16-px border, so the count is a sum of rectangles.  Only the bytes bound
is taken: at every slab shape the cells give, it is the larger one
(chip_smoke.py counts the operations too), so the share is not
overstated."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
BAND = 16
HALO = 4


def level_shapes(height: int, width: int, n_levels: int, scale: float):
    return [(int(round(height / scale ** lv)), int(round(width / scale ** lv)))
            for lv in range(n_levels)]


def b1_shape(width: int, height: int, n_levels: int, scale: float, images_per_launch: int):
    """(slab rows, slab columns, level shapes, slices) of one B1 launch."""
    dims = level_shapes(height, width, n_levels, scale)
    h0p = height + (-height) % BAND
    slices = images_per_launch * n_levels
    return slices * h0p, width, dims, slices


def b1_bytes(width: int, height: int, n_levels: int, scale: float,
             images_per_launch: int, border: int = 16) -> int:
    rows, cols, dims, slices = b1_shape(width, height, n_levels, scale, images_per_launch)
    read = 0
    for lv in range(n_levels):
        h, w = dims[lv]
        if h > 2 * border and w > 2 * border:
            read += (h - 2 * border + 2 * HALO) * (w - 2 * border + 2 * HALO)
    read *= slices // n_levels
    out_w = cols + (-cols) % BAND
    return read * 4 + 4 * (rows // BAND) * out_w * 4


def b1_bound_s(*args, **kwargs) -> float:
    return b1_bytes(*args, **kwargs) / PEAK_BYTES_PER_S
