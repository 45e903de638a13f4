"""Mean device ms of the mapping pass's refresh of the new keyframe's
points (refresh_observed_points: each point's mean viewing normal over
every keyframe that observes it, its distinctive descriptor and distance
band) over the window's passes: the stage's own stamps, written where it
runs (the port's utils/profiling.py stage rings), on the host clock.  None
where the trace holds no interval of that stage, as in a program that does
not stamp it."""

from slambench.harness import spans


def read(record):
    s = spans.summary(record)
    stage_ns = getattr(s, "stage_ns", None)   # None in a program without stage stamps
    ns = stage_ns("refresh_observed_points") if stage_ns is not None else []
    return sum(ns) / len(ns) / 1e6 if ns else None
