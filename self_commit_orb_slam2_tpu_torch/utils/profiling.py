"""Tracing / profiling instrumentation.

Counterpart of the JAX package's utils/profiling.py: wall-clock stage timers
with summaries (the reference drivers time by hand, Examples/Monocular/
mono_tum.cc:80-122), plus a device trace over torch.profiler.  On the card
work is queued, so a stage timed with cuda=True synchronizes on both sides:
its time is the device's, not the time to enqueue it.

The span tracer.  `span(name, stream)` marks one stage of a call at a layer
boundary of the program (models/system.py, streaming.py, step_graph.py,
program_graphs.py, pipeline.py, loop_closing.py).  With no trace open and
the profiler off it returns one shared no-op object: a global read and a
branch.  Inside `tracing()` each span records its name, its host start and
end (time.perf_counter_ns), its parent span and the id of the public call
(a `call` span, models/system.py) it belongs to; with `stream` (a CUDA
stream, or a device: its current stream) it also records a pair of timing
events there, from a pool made when the trace opens, and never waits for
the card.  Closing the trace synchronizes once and puts every event on the
host clock (elapsed_time from a reference event recorded when the trace
opened, scaled by a second one at its close), and resolves the trace into a
TraceSummary.  Inside a CUDA graph capture a span records nothing; while
torch.profiler runs, a span also opens a host range of that name, so that
the program's stages sit in the profiler's timeline (as host operations,
with no mirror on the device's).  `count(name, n)` adds to
the open trace's counters.

The stamp ring.  `stamp(device)` writes the device's clock into the next
slot of a ring of RING_SLOTS int64 and moves the ring's head: on the card a
one-thread kernel (csrc/stamp.cu) reads %globaltimer, so a stamp captured
into a CUDA graph times the graph's work where it runs, with no host read;
on the CPU the plain version writes perf_counter_ns.  Every local-mapping
pass stamps its start and end (models/pipeline.py); the head counts the
stamps since reset_stamps() (pipeline.mapping_passes() halves it).
`stamp(device, stage)` writes into a ring of the stage's own, one for each
name in STAGES, so the pass ring and its count stay the passes': four of
the pass's stages (triangulation, fusion, the refresh of the new
keyframe's points, the local BA) stamp their start and end there
(models/local_mapping.py).  A trace reads the rings once, at its
close, and aligns the card's stamps to the host clock with one stamp
launched between two synchronizes at its open and one at its close.

`timed(names)` synchronizes the card on both sides of the named spans and
keeps their host times as they close: pipeline.timed_mapping_passes() and
loop_closing.timed_phases() are such views.  The trace keeps what each such
synchronize costs the device (from the end of the work queued on the
current stream, an event recorded first, to the host's return) and the
summary leaves those stretches out of its window and of every device
interval: a timed run reads the program's idle, not the timer's.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import ctypes
import os
import subprocess
import time
from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import CudaKernel, check_launch


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


def _union(intervals) -> list:
    """Sorted disjoint union of (start, end) pairs, as [start, end] lists."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _length(intervals) -> int:
    return sum(b - a for a, b in intervals)


def _device_intervals(prof) -> list:
    """(start_ns, end_ns) of every device operation of a torch.profiler run;
    the device-side mirrors of record_function ranges are not work."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        try:
            kind = str(e.activity_type()).lower()
        except (AttributeError, RuntimeError):
            kind = ""
        if "annotation" not in kind:
            out.append((e.start_ns(), e.end_ns()))
    return out


def trace_counts(prof, wall_s: float) -> dict:
    """Counts of a torch.profiler run (CPU and CUDA activities) over a window
    of wall_s seconds: device kernels and memory operations executed
    (`kernels`) and their busy ms (the length of the union of their
    intervals: graph bodies on several streams overlap, and a sum would
    count that time twice), the idle share (1 - busy / wall), the runtime
    calls after which the host waited for the card (`syncs`:
    cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize, a
    synchronous cudaMemcpy; a device-to-host copy or a copy from pageable
    host memory ends in one), every cudaMemcpy* call (`memcpy`; a
    device-to-device copy is one too) and cudaGraphLaunch calls."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    device = _device_intervals(prof)
    busy_ns = _length(_union(device))

    def calls(pred) -> int:
        return sum(e.count for e in events if e.device_type == DeviceType.CPU and pred(e.key))

    return dict(kernels=len(device), busy_ms=busy_ns / 1e6,
                idle=1.0 - busy_ns / 1e9 / wall_s,
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


# ------------------------------------------------------------------ stamps

RING_SLOTS = 8192   # 4,096 start and end pairs
# the mapping pass's stages that stamp rings of their own (models/local_mapping.py)
STAGES = ("create_new_points", "fuse_into_keyframe", "refresh_observed_points",
          "local_bundle_adjustment")
_STAMP = CudaKernel("stamp", "stamp.cu", "stamp",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])


class _Ring(NamedTuple):
    slots: torch.Tensor   # [1 + len(STAGES), RING_SLOTS] int64: the passes' stamps,
                          # then each stage's
    head: torch.Tensor    # [2 + len(STAGES)] int64: the stamps written into each row
                          # of the slots since the ring was made, then the passes'
                          # count at the last reset_stamps()
    align: torch.Tensor   # [2] int64: a one-slot ring of its own for aligning


_rings: dict = {}   # device -> _Ring


def _key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _capturing() -> bool:
    """True while the current CUDA stream captures a graph."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def _launch(slots: torch.Tensor, head: torch.Tensor, n: int) -> None:
    stream = torch.cuda.current_stream(slots.device).cuda_stream
    check_launch(_STAMP, _STAMP.function()(slots.data_ptr(), head.data_ptr(), n, stream))


def _ring(device) -> _Ring:
    """The device's stamp rings, made (and on the card its kernel built and
    launched once) at first use, which must come before any capture that
    stamps into them."""
    dev = _key(device)
    r = _rings.get(dev)
    if r is None:
        if dev.type == "cuda" and _capturing():
            raise RuntimeError("the stamp ring must exist before a graph that stamps "
                               "is captured")
        r = _rings[dev] = _Ring(
            torch.zeros(1 + len(STAGES), RING_SLOTS, dtype=torch.int64, device=dev),
            torch.zeros(2 + len(STAGES), dtype=torch.int64, device=dev),
            torch.zeros(2, dtype=torch.int64, device=dev))
        if dev.type == "cuda":
            _launch(r.align[:1], r.align[1:], 1)
    return r


def stamp(device, stage: str | None = None) -> None:
    """The device's clock now into the next slot of its stamp ring, or of
    the ring of `stage`, one of STAGES (nothing on the meta device)."""
    dev = torch.device(device)
    if dev.type == "meta":
        return
    r = _ring(dev)
    row = 0 if stage is None else 1 + STAGES.index(stage)
    slots, head = r.slots[row], r.head[row:row + 1]
    if dev.type == "cuda":
        _launch(slots, head, RING_SLOTS)
        return
    # the plain version: no host read, the time a fill
    slots.index_fill_(0, torch.remainder(head, RING_SLOTS), time.perf_counter_ns())
    head.add_(1)


def stamp_head(device) -> torch.Tensor:
    """The device's ring heads ([2 + len(STAGES)] int64; the rings made if
    missing): what a warm-up that stamps saves and restores."""
    return _ring(device).head


def reset_stamps() -> None:
    """Count pass stamps from now (on the device: no host read)."""
    for r in _rings.values():
        r.head[-1:].copy_(r.head[:1])


def stamps() -> int:
    """Pass stamps written since reset_stamps(), on every device; reads them."""
    return sum(int(r.head[0] - r.head[-1]) for r in _rings.values())


def _align(r: _Ring) -> tuple[int, int]:
    """(host ns, the card's stamp) of one stamp launched between two
    synchronizes: the card's clock against the host's."""
    torch.cuda.synchronize(r.align.device)
    t0 = time.perf_counter_ns()
    _launch(r.align[:1], r.align[1:], 1)
    torch.cuda.synchronize(r.align.device)
    t1 = time.perf_counter_ns()
    return (t0 + t1) // 2, int(r.align[0])


# ------------------------------------------------------------------ spans


class SpanRecord(NamedTuple):
    name: str
    call: int        # the public call the span belongs to (0: none)
    parent: int      # index of the enclosing span in TraceSummary.spans (-1: none)
    host: tuple      # (start, end) ns, perf_counter_ns
    device: tuple | None   # (start, end) ns of its device interval on the host clock


class TraceSummary:
    """A closed trace: the spans, the stamped passes ((start, end) ns on the
    host clock, in order), the stamped stages of the passes (`stages`: each
    stage's name -> its (start, end) pairs on the host clock, in order; no
    name without one), the counters, the window: from the first `call`
    span's start to the last one's end (the trace's own open and close
    without calls), the stretches the timed spans' synchronizes cost the
    device (`syncs`, host clock), which window_ns and every device interval
    leave out, and the seconds each timed span name was timed (`timed`, as
    timed() gave them).  Built by tracing(); by hand in tests."""

    def __init__(self, spans, passes=(), counts=None, window=None, syncs=(), timed=None,
                 stages=None):
        self.spans = list(spans)
        self.passes = [tuple(p) for p in passes]
        self.stages = {k: [tuple(p) for p in v] for k, v in (stages or {}).items() if v}
        self.counts = dict(counts or {})
        self.timed = {k: list(v) for k, v in (timed or {}).items()}
        calls = [s.host for s in self.spans if s.name == "call"]
        if window is None:
            window = (min(a for a, _ in calls), max(b for _, b in calls)) if calls else (0, 0)
        self.window = tuple(window)
        self.syncs = _union(self._clip(syncs))

    @property
    def frames(self) -> int:
        return int(self.counts.get("frames", 0))

    @property
    def window_ns(self) -> int:
        """The window's length less the synchronizes' stretches."""
        return self.window[1] - self.window[0] - _length(self.syncs)

    def _clip(self, intervals) -> list:
        w0, w1 = self.window
        return [(max(a, w0), min(b, w1)) for a, b in intervals if b > w0 and a < w1]

    def _device(self, intervals) -> list:
        """The union of device intervals inside the window, less the syncs."""
        return _subtract(_union(self._clip(intervals)), self.syncs)

    def host_ns(self, *names) -> int:
        """Host ns of the union of the named spans inside the window."""
        return _length(_union(self._clip(s.host for s in self.spans if s.name in names)))

    def device_ns(self, *names, without_passes: bool = False) -> int:
        """Device ns of the union of the named spans' device intervals inside
        the window; without_passes: less the stamped passes inside them."""
        busy = self._device(s.device for s in self.spans
                            if s.name in names and s.device is not None)
        if not without_passes:
            return _length(busy)
        return _length(busy) - _overlap(busy, _union(self._clip(self.passes)))

    def busy_ns(self) -> int:
        """Device ns of the union of every device interval and stamped pass
        inside the window (work outside every interval is not seen, and a
        gap inside an interval counts as busy)."""
        return _length(_subtract(self._busy(), self.syncs))

    def _busy(self) -> list:
        return _union(self._clip([s.device for s in self.spans if s.device is not None]
                                + self.passes))

    def _inside(self, pairs) -> list:
        w0, w1 = self.window
        return [b - a for a, b in pairs if w1 == w0 or (a >= w0 and b <= w1)]

    def pass_ns(self) -> list:
        """The duration of each stamped pass inside the window, ns."""
        return self._inside(self.passes)

    def stage_ns(self, name: str) -> list:
        """The duration of each stamped interval of the pass's stage `name`
        inside the window, ns (none where the stage stamped nothing)."""
        return self._inside(self.stages.get(name, ()))

    def idle_by_span(self) -> dict:
        """Device idle ns inside the window by the name of the innermost host
        span open where each idle gap starts ("(no span)" outside spans)."""
        order = sorted(range(len(self.spans)), key=lambda i: self.spans[i].host[0])
        rank = {i: r for r, i in enumerate(order)}
        starts = [self.spans[i].host[0] for i in order]

        def innermost(t: int) -> str:
            # the latest span to start by t, or the ancestor of it still open
            # at t (spans nest, so no other span can be)
            j = bisect.bisect_right(starts, t) - 1
            while j >= 0 and self.spans[order[j]].host[1] <= t:
                parent = self.spans[order[j]].parent
                j = rank[parent] if parent >= 0 else -1
            return self.spans[order[j]].name if j >= 0 else "(no span)"

        out: dict = collections.Counter()
        w0, w1 = self.window
        prev = w0
        for a, b in _union(self._busy() + self.syncs) + [[w1, w1]]:
            if a > prev:
                out[innermost(prev)] += a - prev
            prev = max(prev, b)
        return dict(out)

    def self_ns(self, *names) -> int:
        """Host ns of the named spans less what their direct children cover."""
        children = defaultdict(list)
        for s in self.spans:
            if s.parent >= 0:
                children[s.parent].append(s.host)
        return sum(s.host[1] - s.host[0] - _length(_union(children[i]))
                   for i, s in enumerate(self.spans) if s.name in names)

    def coverage(self) -> float:
        """The share of the `call` spans' host time that their direct
        children cover."""
        total = self.host_ns("call")
        return 1.0 - self.self_ns("call") / total if total else 0.0


def _subtract(a: list, b: list) -> list:
    """A sorted disjoint union less another."""
    out = []
    j = 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > lo:
                out.append([lo, b[k][0]])
            lo = max(lo, b[k][1])
            k += 1
        if lo < hi:
            out.append([lo, hi])
    return out


def _overlap(a: list, b: list) -> int:
    """Length of the intersection of two sorted disjoint unions."""
    i = j = out = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


_POOL = 8192   # timing events made when a trace opens (more are made when they run out)
_HOST = -1     # a CPU span's device interval is its host interval


class Trace:
    """An open trace (see the module docstring); tracing() makes it."""

    def __init__(self):
        self.records: list = []   # [name, call, parent, host0, host1, ev0, ev1]
        self.stack: list = []
        self.calls = 0
        self.counts: collections.Counter = collections.Counter()
        self.timers: list = []    # (span name -> key, scale, out dict) of each timed()
        self.timed_s: defaultdict = defaultdict(list)   # span name -> seconds timed
        self.syncs: list = []     # (event before, host ns after) of each timed synchronize
        self.summary: TraceSummary | None = None
        self.cuda = torch.cuda.is_initialized()
        self.heads0 = {d: r.head.tolist() for d, r in _rings.items() if d.type != "meta"}
        self.events: list = []
        self.aligned0: dict = {}
        if self.cuda:
            self.events = [torch.cuda.Event(enable_timing=True) for _ in range(_POOL)]
            for e in self.events:   # made on the card now, not on the hot path
                e.record()
            self.aligned0 = {d: _align(r) for d, r in _rings.items() if d.type == "cuda"}
            self.ref = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            self.ref_ns = time.perf_counter_ns()
            self.ref.record()
        self.used = 0

    def _event(self, stream) -> int:
        if self.used == len(self.events):
            self.events += [torch.cuda.Event(enable_timing=True) for _ in range(1024)]
        self.events[self.used].record(stream)
        self.used += 1
        return self.used - 1

    def timing(self, name: str) -> bool:
        return any(name in names for names, _, _ in self.timers)

    def _sync(self) -> None:
        """A timed span's synchronize, with the stretch it costs the device:
        from the end of the current stream's queued work to the return."""
        if self.cuda:
            before = self._event(torch.cuda.current_stream())
            torch.cuda.synchronize()
            self.syncs.append((before, time.perf_counter_ns()))

    def enter(self, name: str, stream) -> int:
        parent = self.stack[-1] if self.stack else -1
        if name == "call":
            self.calls += 1
            call = self.calls
        else:
            call = self.records[parent][1] if parent >= 0 else 0
        timed = self.timing(name)
        if timed:
            self._sync()
        ev = None
        if stream is not None:
            ev = _HOST if stream == "cpu" else self._event(stream)
        self.records.append([name, call, parent, time.perf_counter_ns(), 0, ev, None])
        self.stack.append(len(self.records) - 1)
        return len(self.records) - 1

    def exit(self, index: int, stream) -> None:
        rec = self.records[index]
        if rec[5] is not None and rec[5] != _HOST:
            rec[6] = self._event(stream)
        name = rec[0]
        timed = self.timing(name)
        if timed:
            self._sync()
        rec[4] = time.perf_counter_ns()
        while self.stack and self.stack.pop() != index:
            pass
        if timed:
            seconds = (rec[4] - rec[3]) * 1e-9
            self.timed_s[name].append(seconds)
            for names, scale, out in self.timers:
                if name in names:
                    out.setdefault(names[name], []).append(seconds * scale)

    def close(self) -> TraceSummary:
        """Synchronize once, put the device intervals and the stamped passes
        on the host clock, and keep the summary."""
        to_host = None
        syncs = []
        if self.cuda:
            torch.cuda.synchronize()
            end_ns = time.perf_counter_ns()
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
            dev_ms = self.ref.elapsed_time(end)
            scale = (end_ns - self.ref_ns) / (dev_ms * 1e6) if dev_ms > 0 else 1.0

            def to_host(i):
                return self.ref_ns + round(self.ref.elapsed_time(self.events[i]) * 1e6 * scale)

            syncs = [(a, t) for a, t in ((to_host(e), t) for e, t in self.syncs) if a < t]

        spans = []
        now = time.perf_counter_ns()
        for name, call, parent, h0, h1, e0, e1 in self.records:
            h1 = h1 or now   # a span left open ends at the close
            if e0 is None or (e0 != _HOST and e1 is None):
                dev = None
            elif e0 == _HOST:
                dev = (h0, h1)
            else:
                dev = (to_host(e0), to_host(e1))
            spans.append(SpanRecord(name, call, parent, (h0, h1), dev))
        passes, stages = [], {name: [] for name in STAGES}
        for d, r in _rings.items():
            if d.type == "meta":
                continue
            pairs = self._stamped(d, r)
            passes += pairs[0]
            for name, p in zip(STAGES, pairs[1:]):
                stages[name] += p
        self.counts["passes"] += len(passes)
        self.summary = TraceSummary(spans, sorted(passes), self.counts, syncs=syncs,
                                    timed=self.timed_s,
                                    stages={k: sorted(v) for k, v in stages.items()})
        return self.summary

    def _stamped(self, d: torch.device, r: _Ring) -> list:
        """The (start, end) pairs stamped since the trace opened, host clock:
        the passes', then each stage's (STAGES' order)."""
        heads = r.head.tolist()
        firsts = self.heads0.get(d, [0] * len(heads))
        slots = r.slots.cpu().numpy()
        to_host = int
        if d.type == "cuda":
            h1, g1 = _align(r)
            h0, g0 = self.aligned0.get(d, (h1, g1))
            rate = (h1 - h0) / (g1 - g0) if g1 != g0 else 1.0

            def to_host(g):
                return h1 + round((int(g) - g1) * rate)

        out = []
        for row in range(len(slots)):
            head, first = heads[row], firsts[row]
            if head - first > RING_SLOTS:
                self.counts["stamps_lost"] += head - first - RING_SLOTS
                first = head - RING_SLOTS
            first += (head - first) % 2   # whole pairs
            stamped = [to_host(slots[row, i % RING_SLOTS]) for i in range(first, head)]
            out.append([(stamped[i], stamped[i + 1]) for i in range(0, len(stamped) - 1, 2)])
        return out


_trace: Trace | None = None          # the open trace
_last: TraceSummary | None = None    # the summary of the last trace closed
_profiler = torch.autograd.profiler  # its _is_profiler_enabled flag


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "stream", "trace", "index", "rf")

    def __init__(self, name: str, stream):
        self.name = name
        self.stream = stream
        self.trace = None
        self.rf = None

    def __enter__(self):
        if _capturing():
            return self
        if _profiler._is_profiler_enabled:
            # a host range of the profiler's own (record_function's user
            # annotations are mirrored onto the device's timeline, where a
            # trace reader takes them for device work)
            self.rf = torch._C._profiler._RecordFunctionFast(self.name)
            self.rf.__enter__()
        if _trace is not None:
            if self.stream is not None:
                self.stream = _stream(self.stream)
            self.trace = _trace
            self.index = _trace.enter(self.name, self.stream)
        return self

    def __exit__(self, *exc):
        if self.trace is not None:
            self.trace.exit(self.index, self.stream)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _stream(stream):
    """A stream argument as a span records it: a CUDA stream, or "cpu"."""
    if isinstance(stream, (str, torch.device)):
        dev = torch.device(stream)
        return torch.cuda.current_stream(dev) if dev.type == "cuda" else "cpu"
    return stream


def span(name: str, stream=None):
    """One stage of a call (see the module docstring): a context manager.
    stream: a CUDA stream, or a device (a CUDA device's current stream; a
    CPU device's interval is the span's host interval), to record the
    stage's device interval too."""
    if _trace is None and not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, stream)


def count(name: str, n: int = 1) -> None:
    """Add n to the open trace's counter `name`."""
    if _trace is not None:
        _trace.counts[name] += n


def current() -> Trace | None:
    """The open trace, if any."""
    return _trace


def last_summary() -> TraceSummary | None:
    """The summary of the last trace closed in this process, if any."""
    return _last


def timing(name: str) -> bool:
    """True while the open trace synchronizes around the spans `name`."""
    return _trace is not None and _trace.timing(name)


@contextlib.contextmanager
def tracing():
    """Open a trace over the block and yield it; at the block's end it is
    closed and resolved (Trace.summary, last_summary()).  Inside an open
    trace, yields that one and closes nothing."""
    global _trace, _last
    if _trace is not None:
        yield _trace
        return
    t = Trace()
    _trace = t
    try:
        yield t
    finally:
        _trace = None
        _last = t.close()


@contextlib.contextmanager
def timed(names: dict, scale: float = 1.0):
    """Inside the block (and a trace: tracing()), the card is synchronized
    on both sides of every span whose name is a key of `names`, and each
    such span's host seconds times `scale` are appended, as it closes, to
    the yielded dict's list under names[span name]."""
    out: dict = {}
    with tracing() as t:
        entry = (names, scale, out)
        t.timers.append(entry)
        try:
            yield out
        finally:
            t.timers.remove(entry)


@contextlib.contextmanager
def suspended():
    """No span records into the open trace inside the block (a graph's
    warm-up runs stages that are not the stream's)."""
    global _trace
    saved, _trace = _trace, None
    try:
        yield
    finally:
        _trace = saved
