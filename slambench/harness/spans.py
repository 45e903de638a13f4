"""The program's span tracer (the port's utils/profiling.py) as the
benchmark reads it: the summary of the trace over a run's window, the
five span readers' shared arithmetic, and the lines a run prints from it.

A run with the tracer open over its window puts the summary in
`record["timers"]["spans"]`.  Where none is there, the readers take the
last trace the program closed in the process, and only if it is this
run's: in a per-frame --trace 1 run the window's trace is the one
pipeline.timed_mapping_passes() opens (a view over the tracer), and its
timed passes are then the run's `pass_s`, to the nanosecond.  Any other
trace, and a program without the tracer (an older commit's), give None,
and the readers then report nothing."""

from __future__ import annotations

# the spans whose device intervals make each layer's time
FRAME_PHASE = ("frame.h2d", "frame.phase", "frame.build")
STEP = ("step.chunk", "step.frame", "step.core", "step.lost", "step.tail")


def summary(record):
    """The run's TraceSummary, or None."""
    timers = record.get("timers", {})
    s = timers.get("spans")
    if s is not None:
        return s
    from self_commit_orb_slam2_tpu_torch.utils import profiling

    last = getattr(profiling, "last_summary", None)   # None in a program without the tracer
    s = last() if last is not None else None
    passes = timers.get("pass_s")
    if s is None or not s.frames or not passes:
        return None
    return s if s.timed.get("mapping.pass") == list(passes) else None


def per_frame_ms(s, ns: float):
    """ns over the window's frames, in ms (None without frames)."""
    return ns / 1e6 / s.frames if s is not None and s.frames else None


def accounting(s) -> dict:
    """A frame's wall time (the window over its frames) against its parts,
    ms a frame: the frame phase, the step less its passes, the passes,
    other device work (loop closing, copies) and the device's idle time."""
    frame = s.device_ns(*FRAME_PHASE)
    step = s.device_ns(*STEP, without_passes=True)
    passes = sum(s.pass_ns())
    busy = s.busy_ns()
    parts = dict(wall=s.window_ns, frame_phase=frame, step=step, passes=passes,
                 other_busy=busy - frame - step - passes, idle=s.window_ns - busy)
    return {k: v / 1e6 / s.frames for k, v in parts.items()}


def idle_line(s) -> str:
    """The device's idle ms a frame by the innermost host span open where
    each idle gap starts, largest first."""
    idle = sorted(s.idle_by_span().items(), key=lambda x: -x[1])
    return "[slambench] idle by span (ms a frame): " + ", ".join(
        f"{name} {ns / 1e6 / s.frames:.3f}" for name, ns in idle)
