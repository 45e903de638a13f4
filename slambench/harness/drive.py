"""One run of a cell: set-up, the closed-loop window, and with --trace 1
the timers and the profiled sub-window; returns what the run measured and
what the program produced, for the check."""

from __future__ import annotations

import gc
import sys
import time
from contextlib import ExitStack

import numpy as np
import torch

from . import build, frames, spec
from . import settings as st
from . import trace as tr
from .traffic import Calls

STATE_OK = 1   # the System's OK state: tracking, the map initialized


def log(msg: str) -> None:
    print(f"[slambench] {msg}", file=sys.stderr, flush=True)


class Run:
    """What a run measured (`setup`, `calls`: (start, end, frame numbers,
    poses, lost) a call, `trace`, `timers`, `memory_peak`) and produced
    (`outputs`), with what the check needs to read them (`context`).  A
    call is lost when the System is not OK after it (LOST, or a monocular
    map not yet bootstrapped).  `miscounted`: frames of calls after the
    warm-up that returned another number of poses than they took frames;
    their poses are NaN, so that every frame keeps its place."""

    def __init__(self):
        self.setup: dict[str, float] = {}
        self.calls: list[tuple[float, float, np.ndarray, np.ndarray, bool]] = []
        self.window_start = 0.0
        self.window_end = 0.0
        self.n_window_calls = 0   # r.calls[:n] are the window's, the rest traced
        self.miscounted = 0
        self.trace = None
        self.timers: dict = {}
        self.memory_peak = 0
        self.outputs: dict = {}
        self.context: dict = {}


def _timed(run: Run, name: str, fn):
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    run.setup[name] = time.perf_counter() - t0
    log(f"set-up {name}: {run.setup[name]:.3f} s")
    return out


def run(cell: str, seed: int, seconds: float, trace: bool, device, t_process: float,
        overrides: dict | None = None, hooks=None) -> Run:
    """`overrides` (tests): a smaller cell ({"config": {...}, "mix": {...},
    "cycle_frames": n, "start": n, "warmup_frames": n, "max_calls": n}, the
    configuration's keys replaced); `hooks(slam, calls)` may replace the
    System's methods (the fault tests)."""
    overrides = overrides or {}
    r = Run()
    w = spec.workload(cell)
    cfg = {**spec.config(w["config"]), **overrides.get("config", {})}
    mix = {**spec.traffic(w["traffic"]), **overrides.get("mix", {})}
    s = st.read(cfg)
    sensor = cfg["sensor"]
    n_cycle = int(overrides.get("cycle_frames", mix["cycle_frames"]))

    from self_commit_orb_slam2_tpu_torch.models.system import System
    r.setup["imports"] = time.perf_counter() - t_process
    vocab = _timed(r, "vocabulary", lambda: build.load_vocabulary(cfg))
    sc = _timed(r, "config", lambda: build.slam_config(cfg, vocab))
    start = int(overrides.get("start", frames.start_frame(seed, n_cycle)))
    cycle = _timed(r, "render", lambda: frames.cell_cycle(s, cfg, mix, device, start, n_cycle))
    slam = _timed(r, "system", lambda: System(sc, enable_mapping=cfg.get("mapping", True),
                                              enable_loop_closing=cfg.get("loop_closing", True),
                                              device=device))
    _timed(r, "warm_start", slam.warm_start)
    calls = Calls(mix, sensor, cycle, s.get("Camera.fps", 30.0))
    if hooks is not None:
        hooks(slam, calls)

    def one_call(n: int, warm: bool = False) -> None:
        k = calls.frame_numbers(n)
        args = calls.arguments(k)
        t0 = time.perf_counter()
        poses = calls.invoke(slam, args)
        t1 = time.perf_counter()
        if len(poses) != n and not warm:
            # no pose can be paired with its frame: the call answered none
            r.miscounted += n
            poses = np.full((n, 4, 4), np.nan)
        r.calls.append((t0, t1, k, poses, slam.state != STATE_OK))

    def warmup():
        # the initializing frame, then a cycle; a monocular bootstrap takes
        # frames of both, and its calls return fewer poses than frames
        one_call(1, warm=True)
        n_warm = int(overrides.get("warmup_frames", int(mix.get("warmup_cycles", 1)) * n_cycle))
        for _ in range(n_warm // calls.per_call):
            one_call(calls.per_call, warm=True)

    _timed(r, "warmup_cycle", warmup)
    n_warm = len(r.calls)
    max_calls = overrides.get("max_calls")
    with ExitStack() as timers:
        if trace:
            from self_commit_orb_slam2_tpu_torch.models import pipeline

            if calls.api == "frame" and cfg.get("mapping", True):
                # a chunk graph cannot time its passes; the per-frame steps can
                r.timers["pass_s"] = timers.enter_context(pipeline.timed_mapping_passes())
        r.window_start = time.perf_counter()
        log(f"set-up {r.window_start - t_process:.3f} s; window of {seconds} s")
        while True:
            one_call(calls.per_call)
            if r.calls[-1][1] - r.window_start >= seconds:
                break
            if max_calls is not None and len(r.calls) - n_warm >= max_calls:
                break
        r.window_end = r.calls[-1][1]
        if trace:
            r.timers = {"pass_s": list(r.timers.get("pass_s", []))}
    r.n_window_calls = len(r.calls) - n_warm
    if trace:
        r.trace = tr.profile(lambda: [one_call(calls.per_call)
                                      for _ in range(int(mix["trace_calls"]))],
                             frames_per_call=calls.per_call)
    r.calls = r.calls[n_warm:]
    if torch.cuda.is_available() and torch.device(device).type == "cuda":
        r.memory_peak = int(torch.cuda.max_memory_allocated(device))
    r.outputs = _outputs(slam, calls, r)
    r.context = dict(cfg=cfg, settings=s, sensor=sensor, cycle=cycle, mix=mix,
                     api=calls.api, per_call=calls.per_call)
    del slam
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return r


def _outputs(slam, calls: Calls, r: Run) -> dict:
    """What the check compares, copied to the host: every pose the calls
    returned, the live keyframes and map points, and the last frame's
    features with the images of the call that built it (None where the
    System has tracked no frame: a monocular map never bootstrapped)."""
    m = slam.map
    last = slam.last_frame
    k_last = r.calls[-1][2]
    args = calls.arguments(k_last)
    if calls.api == "batch":
        batch = args[0]
        if calls.method == "track_batch_stereo":
            batch = np.concatenate([args[0], args[1]])
    else:
        batch = args[0][None]
        if calls.method == "track_stereo":
            batch = np.stack([args[0], args[1]])
    return dict(
        frame_numbers=np.concatenate([c[2] for c in r.calls]),
        poses=np.concatenate([c[3] for c in r.calls]),
        kf_Tcw=m.kf_Tcw[m.kf_valid].cpu().numpy().astype(np.float64),
        kf_timestamp=m.kf_timestamp[m.kf_valid].cpu().numpy().astype(np.float64),
        points=m.pt_pos[m.pt_valid].cpu().numpy().astype(np.float64),
        last_features=None if last is None else dict(
            xy=last.xy_raw.cpu().numpy(), level=last.level.cpu().numpy(),
            desc=last.desc.cpu().numpy(), valid=last.valid.cpu().numpy()),
        last_batch=batch, last_index=len(k_last) - 1,
        keyframes_inserted=int(m.n_kf),
        closures=int(slam._loop_closer.n_big_changes) if slam._loop_closer is not None else 0,
    )
