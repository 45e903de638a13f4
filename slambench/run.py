"""Run one cell of the port's benchmark once, on the card it is started on.

    python slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (building the System, `warm_start`, the initializing frame and one
cycle of the arc with the cell's calls) is timed from the process start;
then the cell's calls run back to back for --seconds; with --trace 1 the
program's pass timer stays open over the window (per frame) and a few
more calls run under torch.profiler.  What the calls produced is then held
to the plain reference.  The last line of standard output is the result
as one JSON object; standard error ends with each compared number beside
its limit.  Without a card, or with fewer than the cell asks for, it exits
with 2 and prints no result; with JAX or the JAX package loaded, with 3.
"""

from __future__ import annotations

import time

T_SCRIPT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
CACHE = REPO / "slambench" / "_out" / "cache"
# build and kernel caches of any JIT the program reaches, at fixed paths
# inside the checkout (the port's own nvcc builds go to its _build/)
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "self_commit_orb_slam2_tpu")


def process_start() -> float:
    """The process's start on the perf_counter clock (from /proc, to a
    clock tick), else the start of this script."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        now = time.perf_counter()
        return min(now - age, T_SCRIPT) if 0 <= age < 3600 else T_SCRIPT
    except (OSError, ValueError, IndexError):
        return T_SCRIPT


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def end_to_end(name: str, run, setup_s: float):
    """An end-to-end metric by its name: setup_s; fps (every frame of the
    window over the window's time); <calls>_p<NN>_ms (the NN-th percentile
    of every call of the window, host clock, from the call to its return)."""
    import numpy as np

    calls = run.calls[:run.n_window_calls]
    if name == "setup_s":
        return setup_s
    if name == "fps":
        return sum(len(c[2]) for c in calls) / (run.window_end - run.window_start)
    head, _, tail = name.rpartition("_p")
    if head and tail.endswith("_ms") and tail[:-3].isdigit():
        ms = np.array([(c[1] - c[0]) * 1e3 for c in calls])
        return float(np.percentile(ms, int(tail[:-3])))
    raise KeyError(f"no end-to-end metric {name!r}")


def execute(cell: str, seed: int, seconds: float, trace: bool, device, t_process: float,
            overrides: dict | None = None, hooks=None) -> tuple[dict, list[str]]:
    """One run of the cell on `device` -> (the result's JSON object, the
    lines for standard error).  The tests call it on the CPU at a smaller
    size (`overrides`) and with the timed path broken (`hooks`)."""
    import numpy as np
    import torch

    from slambench.harness import check, drive, roofline, spec
    from slambench.harness import trace as tr

    bench = spec.benchmark()
    run = drive.run(cell, seed, seconds, trace, device, t_process, overrides, hooks)
    setup_s = run.window_start - t_process
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)

    values = check.numbers(run, device)
    values["lost_frames"] = float(sum(len(c[2]) for c in run.calls if c[4]))
    bad = [(~np.isfinite(c[3]).all(axis=(1, 2))).sum() for c in run.calls]
    nonfinite = int(sum(bad))
    if overrides and "limits" in overrides:
        limits = overrides["limits"]
    else:
        try:
            limits = spec.limits(cell)
        except FileNotFoundError:
            limits = {}
    ok, checks = check.judge(values, limits)
    # a pose that is not finite, a call that did not return one pose a frame
    # (its poses are NaN) or a monocular trajectory that cannot be aligned
    # is not correct, whatever the limits name
    ok = ok and bool(limits) and nonfinite == 0 and run.miscounted == 0 and check.aligned(values)

    ctx = run.context
    s = ctx["settings"]
    on_card = torch.device(device).type == "cuda"
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": run.memory_peak}
    # a frame fails when its call left the System not OK or its pose is not finite
    out = {"correct": ok, "attempted": int(sum(len(c[2]) for c in run.calls)),
           "failed": int(sum(len(c[2]) if c[4] else b for c, b in zip(run.calls, bad)))}
    lines = []
    if trace:
        images = ctx["per_call"] * (2 if ctx["sensor"] == "stereo" else 1)
        W, H = int(s.get("Camera.width", 640)), int(s.get("Camera.height", 480))
        record = {"trace": run.trace, "timers": run.timers, "cell": cell,
                  "b1_bound_s": roofline.b1_bound_s(
                      W, H, int(s.get("ORBextractor.nLevels", 8)),
                      float(s.get("ORBextractor.scaleFactor", 1.2)), images)}
        metrics = {}
        for m in spec.per_layer(cell, bench):
            v = spec.metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        out["metrics"] = metrics
        out["device"] = device_info
        out["breakdown"] = tr.breakdown(run.trace)
        lines.append(f"[slambench] trace: {run.trace.frames} frames in "
                     f"{run.trace.window_s:.4f} s, {run.trace.kernels} kernels, "
                     f"reduced in {run.trace.process_s:.1f} s")
    else:
        out["metrics"] = {m["name"]: {"value": float(end_to_end(m["name"], run, setup_s)),
                                      "unit": m["unit"]}
                          for m in spec.end_to_end(cell, bench)}
        out["device"] = device_info
    out["checks"] = checks
    ms = np.array([(c[1] - c[0]) * 1e3 for c in run.calls[:run.n_window_calls]])
    lines.append(f"[slambench] window: {len(ms)} calls, "
                 f"{sum(len(c[2]) for c in run.calls[:run.n_window_calls])} frames in "
                 f"{run.window_end - run.window_start:.3f} s; ms a call: median "
                 f"{np.median(ms):.2f}, p90 {np.percentile(ms, 90):.2f}, "
                 f"p95 {np.percentile(ms, 95):.2f}, max {ms.max():.2f}")
    parts = ", ".join(f"{k} {v:.3f}" for k, v in run.setup.items())
    lines.append(f"[slambench] set-up parts (s): {parts}; setup_s {setup_s:.3f}")
    lines.append("[slambench] numbers: " + ", ".join(f"{k} {v:.6g}" for k, v in values.items()))
    if run.miscounted:
        lines.append(f"[slambench] {run.miscounted} frames in calls that returned another "
                     "number of poses than they took frames")
    lines.append(f"[slambench] device: {device_info['kind']}; correct {ok}")
    lines += [f"{name} {c['value']:.6g} limit {c['limit']:.6g}" for name, c in checks.items()]
    return out, lines


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__(f"loaded in the measuring process: {', '.join(names)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_process = process_start()

    from slambench.harness import spec

    w = spec.workload(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slambench: {args.workload} needs {w['chips']} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    try:
        out, lines = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), t_process)
    except ForbiddenModules as e:
        print(f"slambench: {e}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
