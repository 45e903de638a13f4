"""Run one cell as run.py runs it untraced, with the program's span tracer
(the port's utils/profiling.tracing) open over the window.

    python slambench/trace_spans.py --workload <cell> --seed <n> --seconds <s>

The tracer opens at the window's first call and closes after the run, so
the spans cover the window's calls and nothing else.  The last line of
standard output is one JSON object: the run's end-to-end metrics and
`correct` with the tracer open (against a run.py --trace 0 run on the same
seed, the difference is the tracer's cost), the five span metrics (the
readers of metrics/), the share of the calls' host time their direct
children cover, a frame's wall time against its parts, the counters a
frame, and the device's idle ms a frame by the host span open at each
gap.  Standard error ends with the run's lines and the idle-by-span line.
"""

from __future__ import annotations

import time

T_SCRIPT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from contextlib import ExitStack  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from slambench import run  # noqa: E402

METRICS = ("device_idle_pct", "frame_phase_ms", "step_ms", "mapping_pass_ms.stream",
           "graph_launch_ms")


def window_hooks(stack: ExitStack, warm_frames: int):
    """hooks(slam, calls) for run.execute: the tracer opened (on `stack`)
    at the first call past the warm-up's `warm_frames` frames."""
    from self_commit_orb_slam2_tpu_torch.utils import profiling

    def hooks(slam, calls):
        invoke = calls.invoke

        def traced(s, args):
            if profiling.current() is None and calls.next_frame - calls.per_call >= warm_frames:
                stack.enter_context(profiling.tracing())
            return invoke(s, args)

        calls.invoke = traced

    return hooks


def warm_frames(cell: str, overrides: dict | None) -> int:
    """Frames the run's set-up takes: the initializing frame and the
    warm-up's whole calls (as harness/drive.py counts them)."""
    from slambench.harness import spec

    overrides = overrides or {}
    mix = {**spec.traffic(spec.workload(cell)["traffic"]), **overrides.get("mix", {})}
    n_cycle = int(overrides.get("cycle_frames", mix["cycle_frames"]))
    n_warm = int(overrides.get("warmup_frames", int(mix.get("warmup_cycles", 1)) * n_cycle))
    per_call = int(mix["frames_per_call"])
    return 1 + n_warm // per_call * per_call


def execute(cell: str, seed: int, seconds: float, device, t_process: float,
            overrides: dict | None = None) -> tuple[dict, list[str]]:
    """One run of the cell with the tracer over its window -> (the JSON
    object, the lines for standard error)."""
    from self_commit_orb_slam2_tpu_torch.utils import profiling
    from slambench.harness import spans, spec

    with ExitStack() as stack:
        out, lines = run.execute(cell, seed, seconds, False, device, t_process, overrides,
                                 window_hooks(stack, warm_frames(cell, overrides)))
    s = profiling.last_summary()
    record = {"timers": {"spans": s}}
    metrics = {}
    for name in METRICS:
        v = spec.metric_reader(name)(record)
        if v is not None:
            metrics[name] = float(v)
    result = {"cell": cell, "seed": seed, "correct": out["correct"],
              "end_to_end": {k: v["value"] for k, v in out["metrics"].items()},
              "spans": metrics, "coverage": s.coverage(), "frames": s.frames,
              "window_s": s.window_ns / 1e9, "accounting": spans.accounting(s),
              "counts": {k: v / s.frames for k, v in s.counts.items()},
              "idle_by_span": {k: v / 1e6 / s.frames for k, v in s.idle_by_span().items()},
              "device": out["device"]}
    return result, lines + [spans.idle_line(s)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    t_process = run.process_start()
    import torch

    if not torch.cuda.is_available():
        print("slambench: no CUDA device", file=sys.stderr)
        return 2
    result, lines = execute(args.workload, args.seed, args.seconds, torch.device("cuda", 0),
                            t_process)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
