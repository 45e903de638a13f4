"""Kernel B1's share of its roofline: the least time of one launch at the
cell's slab shape (harness/roofline.py, bytes at the published 3.35 TB/s)
over the mean device time of its launches in the profiled sub-window, %."""


def read(record):
    t = record.get("trace")
    bound = record.get("b1_bound_s")
    if t is None or not bound:
        return None
    times = [s for name, v in t.kernel_s.items() if "fast_band_kernel" in name
             for s in v]
    if not times:
        return None
    return bound / (sum(times) / len(times)) * 100.0
