"""Device kernels executed in the profiled sub-window, per frame."""


def read(record):
    t = record.get("trace")
    if t is None or t.frames == 0 or t.kernels == 0:
        return None
    return t.kernels / t.frames
