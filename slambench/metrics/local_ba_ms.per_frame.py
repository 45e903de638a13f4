"""Mean device ms of the mapping pass's local bundle adjustment
(local_bundle_adjustment: the covisible window's selection, the Gauss-Newton
iterations of both stages and the scatter of poses, points and outliers
back into the map) over the window's passes: the stage's own stamps,
written where it runs (the port's utils/profiling.py stage rings), on the
host clock.  None where the trace holds no interval of that stage, as in a
program that does not stamp it."""

from slambench.harness import spans


def read(record):
    s = spans.summary(record)
    stage_ns = getattr(s, "stage_ns", None)   # None in a program without stage stamps
    ns = stage_ns("local_bundle_adjustment") if stage_ns is not None else []
    return sum(ns) / len(ns) / 1e6 if ns else None
