"""The port's span tracer and stamp ring (utils/profiling.py) on the CPU.

With no trace open and the profiler off a span is one shared no-op; inside
tracing() spans nest, carry their call's id and parent, and a CPU span's
device interval is its host interval; nothing is recorded while a stream
captures a graph; under torch.profiler the span names sit among kineto's
host operations.  The stamp ring times every local-mapping pass on the plain
path and counts them for pipeline.mapping_passes(); the two module timers
(pipeline.timed_mapping_passes, loop_closing.timed_phases) are views over
the tracer; trace_counts takes busy time as a union of intervals.
"""

from __future__ import annotations

import time

import pytest
import torch

from self_commit_orb_slam2_tpu_torch.models import config, loop_closing, pipeline
from self_commit_orb_slam2_tpu_torch.models.step_graph import StepGraph
from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.utils import profiling
from self_commit_orb_slam2_tpu_torch.utils.profiling import SpanRecord, TraceSummary
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

W, H, FX = 160, 120, 120.0
N_FRAMES = 14


def _config():
    cam = CameraParams.create(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H, bf=12.0)
    return config.SlamConfig(camera=cam, orb=OrbConfig(n_features=300, cell_size=8),
                             caps=config.Capacities(max_keyframes=16, max_points=2048,
                                                    local_points=256),
                             tracking=config.TrackingConfig(max_frames_between_kf=4))


def _run(graphs: bool):
    """A streamed batch of 9 frames, then 5 per-frame calls, under one trace;
    graphs: through a CPU StepGraph (the runners' plain versions)."""
    torch.set_num_threads(2)
    seq = generate_sequence(n_frames=N_FRAMES, width=W, height=H, fx=FX, seed=5)
    slam = System(_config(), enable_mapping=True, enable_loop_closing=False, device="cpu")
    if graphs:
        slam.step_graph = StepGraph(slam.config, "cpu")
    pipeline.reset_mapping_passes()
    with profiling.tracing() as trace:
        slam.track_batch_rgbd(seq.images[:9], seq.depths[:9], seq.timestamps[:9], chunk=4)
        for i in range(9, N_FRAMES):
            slam.track_rgbd(seq.images[i], seq.depths[i], seq.timestamps[i])
    return slam, trace.summary, pipeline.mapping_passes()


@pytest.fixture(scope="module")
def op_by_op():
    return _run(graphs=False)


@pytest.fixture(scope="module")
def graphed():
    return _run(graphs=True)


def test_off_a_span_is_the_shared_no_op():
    assert profiling.current() is None
    last = profiling.last_summary()
    spans = {id(profiling.span(n, "cpu")) for n in ("call", "step.core", "x")}
    assert spans == {id(profiling._NO_SPAN)}
    with profiling.span("call"), profiling.span("step.core", "cpu"):
        profiling.count("frames", 3)
    assert profiling.current() is None and profiling.last_summary() is last
    n, best = 200_000, float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.span("step.core", "cpu"):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 1e-6, f"{best * 1e9:.0f} ns a span with the tracer off"


def test_open_spans_nest_with_parents_call_ids_and_self_time():
    with profiling.tracing() as t:
        with profiling.span("call"):
            profiling.count("frames", 4)
            with profiling.span("frame.phase", "cpu"):
                time.sleep(0.01)
                with profiling.span("graph.launch"):
                    time.sleep(0.005)
            with profiling.span("step.chunk", "cpu"):
                time.sleep(0.002)
        with profiling.span("orphan"):
            pass
        with profiling.span("call"):
            with profiling.span("session.drain"):
                time.sleep(0.001)
    s = t.summary
    assert profiling.current() is None and profiling.last_summary() is s
    names = [r.name for r in s.spans]
    assert names == ["call", "frame.phase", "graph.launch", "step.chunk", "orphan", "call",
                     "session.drain"]
    assert [r.parent for r in s.spans] == [-1, 0, 1, 0, -1, -1, 5]
    assert [r.call for r in s.spans] == [1, 1, 1, 1, 0, 2, 2]
    assert s.frames == 4 and s.counts["passes"] == 0
    for r in s.spans:
        assert r.host[0] <= r.host[1]
        parent = s.spans[r.parent] if r.parent >= 0 else None
        if parent is not None:
            assert parent.host[0] <= r.host[0] and r.host[1] <= parent.host[1]
    # a CPU span's device interval is its host interval; others have none
    assert all((r.device == r.host) == (r.name in ("frame.phase", "step.chunk"))
               for r in s.spans)
    assert s.window == (s.spans[0].host[0], s.spans[5].host[1])
    phase = s.spans[1]
    launch = s.spans[2]
    assert s.self_ns("frame.phase") == (phase.host[1] - phase.host[0]
                                        - (launch.host[1] - launch.host[0]))
    assert 0.004e9 < s.self_ns("frame.phase") < 0.5e9
    assert s.host_ns("graph.launch") == launch.host[1] - launch.host[0]
    assert 0.95 < s.coverage() <= 1.0


def test_spans_opened_in_a_capture_record_nothing(monkeypatch):
    with profiling.tracing() as t:
        with profiling.span("call"):
            monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
            monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
            with profiling.span("step.chunk", "cpu"), profiling.span("graph.launch"):
                pass
            monkeypatch.undo()
            with profiling.span("step.read"):
                pass
    assert [r.name for r in t.summary.spans] == ["call", "step.read"]
    assert t.summary.spans[1].parent == 0


def test_suspended_spans_record_nothing():
    with profiling.tracing() as t:
        with profiling.span("call"):
            with profiling.suspended():
                with profiling.span("mapping.pass", "cpu"):
                    profiling.count("frames")
            with profiling.span("step.core", "cpu"):
                pass
    assert [r.name for r in t.summary.spans] == ["call", "step.core"]
    assert t.summary.frames == 0


@pytest.mark.parametrize("open_trace", [False, True], ids=["profiler", "profiler-and-trace"])
def test_span_names_sit_among_the_profilers_host_events(open_trace):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.tracing() if open_trace else profiling.suspended():
            with profiling.span("call"), profiling.span("frame.phase", "cpu"):
                torch.ones(8).add_(1)
    spans = [e for e in prof.profiler.kineto_results.events()
             if e.name() in ("call", "frame.phase")]
    assert sorted(e.name() for e in spans) == ["call", "frame.phase"]
    # host operations, not user annotations: nothing of them is mirrored
    # onto the device's timeline, where a trace reader would count it
    assert not any(e.is_user_annotation() for e in spans)
    assert profiling.current() is None


def test_a_nested_tracing_joins_the_open_trace():
    with profiling.tracing() as outer:
        with pipeline.timed_mapping_passes() as passes:
            assert profiling.current() is outer and profiling.timing("mapping.pass")
            with profiling.span("mapping.pass", "cpu"):
                time.sleep(0.002)
        assert profiling.current() is outer and not profiling.timing("mapping.pass")
        with profiling.span("mapping.pass", "cpu"):
            pass
    assert len(passes) == 1 and passes[0] >= 0.002
    assert [r.name for r in outer.summary.spans] == ["mapping.pass", "mapping.pass"]


def test_timed_phases_keys_and_ms():
    assert set(loop_closing._PHASES.values()) == {"detect", "correct", "gba_slice", "merge"}
    with loop_closing.timed_phases() as ph:
        for name in ("loop.detect", "loop.detect", "loop.merge", "loop.dispatch"):
            with profiling.span(name, "cpu"):
                time.sleep(0.001)
        assert set(ph) == {"detect", "merge"}   # filled as the spans close
    assert profiling.current() is None
    assert len(ph["detect"]) == 2 and len(ph["merge"]) == 1
    assert all(1.0 <= v < 1e3 for v in ph["detect"] + ph["merge"])   # ms


def test_the_stamp_ring_times_passes_on_the_plain_path(op_by_op):
    slam, s, n_passes = op_by_op
    assert slam.state == STATE_OK
    assert n_passes == len(s.passes) == s.counts["passes"] == slam.n_keyframes() - 1 > 0
    assert s.counts["keyframes"] == n_passes and s.frames == N_FRAMES
    spans = [r for r in s.spans if r.name == "mapping.pass"]
    assert len(spans) == n_passes
    for (a, b), r in zip(s.passes, spans):   # each stamped pair inside its span
        assert r.host[0] <= a < b <= r.host[1]
    assert all(ns > 0 for ns in s.pass_ns())
    pipeline.reset_mapping_passes()
    assert pipeline.mapping_passes() == 0


def test_the_streamed_and_per_frame_calls_are_spanned(op_by_op):
    _, s, _ = op_by_op
    calls = [r for r in s.spans if r.name == "call"]
    assert [r.call for r in calls] == list(range(1, 7))   # one batch, five frames
    assert all(r.call > 0 for r in s.spans)
    names = {r.name for r in s.spans}
    assert {"session.pack", "frame.upload", "frame.h2d", "frame.phase", "step.chunk",
            "session.finish", "frame.build", "step.frame", "step.read", "step.init",
            "mapping.pass"} <= names
    assert s.coverage() > 0.95
    # the CPU's device intervals are host intervals: nothing idles inside a
    # step, and the step less its passes is what remains of it
    steps = ("step.chunk", "step.frame")
    assert 0 < s.device_ns(*steps, without_passes=True) < s.device_ns(*steps)
    assert s.device_ns(*steps) - s.device_ns(*steps, without_passes=True) == sum(s.pass_ns())
    assert s.busy_ns() <= s.window_ns


def test_the_runners_spans(graphed, op_by_op):
    slam, s, n_passes = graphed
    names = [r.name for r in s.spans]
    assert {"step.core", "step.read", "step.tail", "frame.build", "frame.phase",
            "step.chunk"} <= set(names)
    assert "step.frame" not in names and "graph.launch" not in names   # nothing replays
    # the same stream, so the same passes and keyframes as op by op
    assert n_passes == op_by_op[2] and s.counts["keyframes"] == op_by_op[1].counts["keyframes"]
    for i, r in enumerate(s.spans):
        if r.name == "step.tail":
            inner = [c.name for c in s.spans if c.parent == i]
            assert inner == ["mapping.pass"]
    assert s.coverage() > 0.95


def test_trace_counts_takes_busy_time_as_a_union():
    from torch.autograd import DeviceType

    class Event:
        def __init__(self, a, b, kind="kernel", device=DeviceType.CUDA):
            self.a, self.b, self.kind, self.device = a, b, kind, device

        def device_type(self):
            return self.device

        def activity_type(self):
            return self.kind

        def start_ns(self):
            return self.a

        def end_ns(self):
            return self.b

    class Avg:
        def __init__(self, key, device, count):
            self.key, self.device_type, self.count = key, device, count

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [Event(0, 4_000_000), Event(1_000_000, 6_000_000),
                            Event(0, 9_000_000, "gpu_user_annotation"),
                            Event(0, 9_000_000, device=DeviceType.CPU)]

        @staticmethod
        def key_averages():
            return [Avg("k", DeviceType.CUDA, 2), Avg("call", DeviceType.CUDA, 1),
                    Avg("cudaStreamSynchronize", DeviceType.CPU, 3),
                    Avg("cudaGraphLaunch", DeviceType.CPU, 1)]

    c = profiling.trace_counts(Prof, 0.010)
    assert c["busy_ms"] == pytest.approx(6.0)     # not 4 + 5
    assert c["idle"] == pytest.approx(0.4)
    # a span's mirror on the device's timeline is not a kernel
    assert (c["kernels"], c["syncs"], c["graph_launches"]) == (2, 3, 1)


def _hand_built() -> TraceSummary:
    ms = 1_000_000
    spans = [SpanRecord("call", 1, -1, (0, 100 * ms), None),
             SpanRecord("step.chunk", 1, 0, (10 * ms, 60 * ms), (20 * ms, 70 * ms)),
             SpanRecord("graph.launch", 1, 1, (50 * ms, 55 * ms), None),
             SpanRecord("session.drain", 1, 0, (60 * ms, 100 * ms), None),
             SpanRecord("loop.detect", 1, 3, (80 * ms, 90 * ms), (85 * ms, 95 * ms))]
    return TraceSummary(spans, passes=[(30 * ms, 40 * ms)], counts={"frames": 4})


def test_summary_arithmetic_on_a_hand_built_trace():
    s = _hand_built()
    ms = 1e6
    assert s.window == (0, 100 * ms) and s.frames == 4
    assert s.busy_ns() == 60 * ms                       # 20..70 and 85..95
    assert s.device_ns("step.chunk") == 50 * ms
    assert s.device_ns("step.chunk", without_passes=True) == 40 * ms
    assert s.pass_ns() == [10 * ms]
    assert s.host_ns("graph.launch") == 5 * ms
    # gaps named where they start: 0..20 (the call alone), 70..85 and
    # 95..100 (session.drain, loop.detect closed at 90)
    assert s.idle_by_span() == {"call": 20 * ms, "session.drain": 20 * ms}
    assert s.coverage() == pytest.approx(0.9)
    assert s.self_ns("session.drain") == 30 * ms


def test_the_timed_spans_synchronizes_leave_the_window_and_the_intervals():
    """A timed span's synchronize costs the device the stretch from the end
    of its queued work to the host's return: the summary takes it out of
    the window, of every device interval and of the idle."""
    s = _hand_built()
    ms = 1e6
    # 65..75: the chunk's interval ends at 70 (its last 5 ms a synchronize),
    # then 5 ms of the idle gap 70..85
    s = TraceSummary(s.spans, passes=s.passes, counts=s.counts, syncs=[(65 * ms, 75 * ms)],
                     timed={"mapping.pass": [0.01]})
    assert s.window == (0, 100 * ms) and s.window_ns == 90 * ms
    assert s.busy_ns() == 55 * ms
    assert s.device_ns("step.chunk") == 45 * ms
    assert s.device_ns("step.chunk", without_passes=True) == 35 * ms
    assert s.idle_by_span() == {"call": 20 * ms, "session.drain": 15 * ms}
    assert s.window_ns - s.busy_ns() == sum(s.idle_by_span().values())
    assert s.timed == {"mapping.pass": [0.01]}
    # a stretch outside the window is dropped
    assert TraceSummary(s.spans, syncs=[(200 * ms, 210 * ms)]).window_ns == 100 * ms


def test_a_trace_keeps_the_seconds_of_its_timed_spans():
    with pipeline.timed_mapping_passes() as passes:
        with profiling.span("call"):
            for _ in range(2):
                with profiling.span("mapping.pass", "cpu"):
                    time.sleep(0.001)
    s = profiling.last_summary()
    assert len(passes) == 2 and s.timed["mapping.pass"] == passes
    assert s.syncs == [] and s.window_ns == s.window[1] - s.window[0]
