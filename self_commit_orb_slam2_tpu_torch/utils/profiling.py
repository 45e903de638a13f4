"""Tracing / profiling instrumentation.

Counterpart of the JAX package's utils/profiling.py: wall-clock stage timers
with summaries (the reference drivers time by hand, Examples/Monocular/
mono_tum.cc:80-122), plus a device trace over torch.profiler.  On the card
work is queued, so a stage timed with cuda=True synchronizes on both sides:
its time is the device's, not the time to enqueue it.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch


class StageTimer:
    """Accumulating per-stage wall-clock timer.

    Usage:
        timer = StageTimer()
        with timer("extract"):
            ...
        print(timer.summary())

    StageTimer(cuda=True) calls torch.cuda.synchronize() before and after
    each stage, so queued device work lands inside the stage that queued it.
    """

    def __init__(self, cuda: bool = False):
        self.samples: dict[str, list[float]] = defaultdict(list)
        self.cuda = cuda

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.cuda:
                torch.cuda.synchronize()
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> str:
        lines = []
        for name, xs in sorted(self.samples.items()):
            a = np.array(xs) * 1e3
            lines.append(
                f"{name:24s} n={len(a):4d} median={np.median(a):8.2f}ms "
                f"mean={a.mean():8.2f}ms p90={np.percentile(a, 90):8.2f}ms"
            )
        return "\n".join(lines)

    def medians(self) -> dict[str, float]:
        return {k: float(np.median(v)) for k, v in self.samples.items()}


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the CPU and, with a card, the CUDA
    activity inside the block; writes log_dir/trace.json (Chrome trace
    format: open with Perfetto or chrome://tracing) and yields the profiler,
    whose key_averages() sum the events by name.

    with device_trace("slam_trace"):
        slam.track_rgbd(...)
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# runtime calls after which the host has waited for the card
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def trace_counts(prof, wall_s: float) -> dict:
    """Counts of a torch.profiler run (CPU and CUDA activities) over a window
    of wall_s seconds: device kernels and memory operations executed
    (`kernels`) and their busy ms, the idle share (1 - busy / wall), the
    runtime calls after which the host waited for the card (`syncs`:
    cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize, a
    synchronous cudaMemcpy; a device-to-host copy or a copy from pageable
    host memory ends in one), every cudaMemcpy* call (`memcpy`; a
    device-to-device copy is one too) and cudaGraphLaunch calls."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)

    def calls(pred) -> int:
        return sum(e.count for e in events if e.device_type == DeviceType.CPU and pred(e.key))

    return dict(kernels=sum(e.count for e in device), busy_ms=busy_us / 1e3,
                idle=1.0 - busy_us / 1e6 / wall_s,
                syncs=calls(lambda k: k in HOST_WAITS),
                memcpy=calls(lambda k: k.startswith("cudaMemcpy")),
                graph_launches=calls(lambda k: k == "cudaGraphLaunch"))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them (what every
    number taken on the card is written beside)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
