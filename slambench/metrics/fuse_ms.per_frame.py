"""Mean device ms of the mapping pass's fusion (fuse_into_keyframe: the
neighbours' points projected into the new keyframe and its points into
them, 10 first-order neighbours with depth, 20 mono) over the window's
passes: the stage's own stamps, written where it runs (the port's
utils/profiling.py stage rings), on the host clock.  None where the trace
holds no stage intervals, as in a program that does not stamp them."""

from slambench.harness import spans


def read(record):
    s = spans.summary(record)
    stage_ns = getattr(s, "stage_ns", None)   # None in a program without stage stamps
    ns = stage_ns("fuse_into_keyframe") if stage_ns is not None else []
    return sum(ns) / len(ns) / 1e6 if ns else None
