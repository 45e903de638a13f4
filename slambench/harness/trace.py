"""The profiled sub-window of a --trace 1 run: a few calls at the end of
the window under torch.profiler (CPU and CUDA activity), reduced to what
the per-layer readers need.

Device time is the union of the device operations' intervals (graph bodies
on several streams overlap, so a sum would count time twice), clipped to
the sub-window, which is the `slambench.subwindow` span the harness
records around the calls.  Idle gaps are the holes in that union, each
named by the innermost host event open where it starts."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

# runtime calls after which the host has waited for the card (the port's
# utils/profiling.HOST_WAITS, copied)
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
SPAN = "slambench.subwindow"


class TraceRecord:
    def __init__(self):
        self.frames = 0
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernels = 0
        self.host_waits = 0
        self.kernel_s: dict[str, list[float]] = defaultdict(list)
        self.idle_by_host: dict[str, float] = defaultdict(float)
        self.process_s = 0.0   # host seconds spent reducing the trace


def _is_cuda(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def _kind(e) -> str:
    try:
        return str(e.activity_type()).lower()
    except Exception:  # noqa: BLE001 - older event types lack the field
        return ""


def _union(intervals):
    """Sorted disjoint union of (start, end) pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def profile(fn, frames_per_call: int) -> TraceRecord:
    """Run fn (the sub-window's calls) under the profiler and reduce it."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN):
            n_calls = len(fn())
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = reduce(prof.profiler.kineto_results.events())
    rec.frames = n_calls * frames_per_call
    rec.process_s = time.perf_counter() - t0
    return rec


def reduce(events) -> TraceRecord:
    rec = TraceRecord()
    device, host = [], []
    w0 = w1 = None
    for e in events:
        a, b = e.start_ns(), e.end_ns()
        if _is_cuda(e):
            name = e.name()
            kind = _kind(e)
            if "annotation" in kind or name == SPAN:
                continue   # the span mirrored on the device's timeline, not work
            is_kernel = "kernel" in kind if kind else not name.startswith(("Memcpy", "Memset"))
            device.append((a, b))
            if is_kernel:
                rec.kernels += 1
                rec.kernel_s[name].append((b - a) * 1e-9)
            continue
        name = e.name()
        if name == SPAN:
            w0, w1 = a, b
            continue
        if name in HOST_WAITS:
            rec.host_waits += 1
        host.append((a, b, name))
    if w0 is None:
        raise RuntimeError("the profiled sub-window's span is missing from the trace")
    clipped = [(max(a, w0), min(b, w1)) for a, b in device if b > w0 and a < w1]
    busy = _union(clipped)
    rec.window_s = (w1 - w0) * 1e-9
    rec.busy_s = sum(b - a for a, b in busy) * 1e-9
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    host.sort()
    starts = [h[0] for h in host]
    ends = sorted((h[1], h[2]) for h in host)
    end_times = [e[0] for e in ends]
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0)
        label = None
        for j in range(i - 1, max(i - 4000, -1), -1):
            if host[j][1] >= g0:     # the latest-starting host event still open
                label = host[j][2]
                break
        if label is None:            # host code between recorded events
            j = bisect.bisect_right(end_times, g0) - 1
            label = f"after {ends[j][1]}" if j >= 0 else "(before any host event)"
        rec.idle_by_host[label] += (g1 - g0) * 1e-9
    return rec


def breakdown(rec: TraceRecord) -> dict:
    """The ten device operations that took most time and the ten host
    activities under which the device sat idle longest, in seconds."""
    ops = sorted(((n, sum(v)) for n, v in rec.kernel_s.items()), key=lambda x: -x[1])[:10]
    gaps = sorted(rec.idle_by_host.items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n[:200], s] for n, s in gaps]}
