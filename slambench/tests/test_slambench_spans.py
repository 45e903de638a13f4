"""The five span readers (metrics/device_idle_pct.py, frame_phase_ms.py,
step_ms.py, mapping_pass_ms.stream.py, graph_launch_ms.py) on a
hand-built span summary and without one, and toy CPU passes: a per-frame
--trace 1 run reports the span metrics BENCHMARK.json lists for it (the
window's trace is the one pipeline.timed_mapping_passes() opens), and
trace_spans.py, the tracer open over a stream's window, reports all five."""

from __future__ import annotations

import pytest

from slambench import trace_spans
from slambench.harness import spans, spec
from slambench.tests import toy
from self_commit_orb_slam2_tpu_torch.utils import profiling
from self_commit_orb_slam2_tpu_torch.utils.profiling import SpanRecord, TraceSummary

MS = 1_000_000
SPAN_METRICS = trace_spans.METRICS


def _summary() -> TraceSummary:
    """Two calls of 4 frames over 200 ms: a frame phase of 10 ms on the
    device, a chunk of 50 ms holding a 20 ms pass, 2 + 3 ms of launches."""
    s = [SpanRecord("call", 1, -1, (0, 100 * MS), None),
         SpanRecord("frame.upload", 1, 0, (0, 5 * MS), None),
         SpanRecord("frame.h2d", 1, 1, (4 * MS, 5 * MS), (4 * MS, 6 * MS)),
         SpanRecord("frame.phase", 1, 0, (5 * MS, 8 * MS), (6 * MS, 14 * MS)),
         SpanRecord("graph.launch", 1, 3, (6 * MS, 8 * MS), None),
         SpanRecord("step.chunk", 1, 0, (8 * MS, 12 * MS), (14 * MS, 64 * MS)),
         SpanRecord("graph.launch", 1, 5, (9 * MS, 12 * MS), None),
         SpanRecord("session.drain", 1, 0, (12 * MS, 100 * MS), None),
         SpanRecord("call", 2, -1, (100 * MS, 200 * MS), None)]
    return TraceSummary(s, passes=[(30 * MS, 50 * MS)], counts={"frames": 8})


def _read(name, record):
    return spec.metric_reader(name)(record)


def test_each_reader_on_a_hand_built_summary():
    record = {"timers": {"spans": _summary()}}
    assert _read("device_idle_pct", record) == pytest.approx(100 * (1 - 60 / 200))
    assert _read("frame_phase_ms", record) == pytest.approx(10 / 8)
    assert _read("step_ms", record) == pytest.approx(30 / 8)
    assert _read("mapping_pass_ms.stream", record) == pytest.approx(20.0)
    assert _read("graph_launch_ms", record) == pytest.approx(5 / 8)
    a = spans.accounting(record["timers"]["spans"])
    assert a == pytest.approx(dict(wall=25.0, frame_phase=10 / 8, step=30 / 8, passes=20 / 8,
                                   other_busy=0.0, idle=140 / 8))
    assert "session.drain 17.000" in spans.idle_line(record["timers"]["spans"])


def test_each_reader_reports_nothing_without_a_summary(monkeypatch):
    monkeypatch.setattr(profiling, "_last", None)
    for name in SPAN_METRICS:
        assert _read(name, {"timers": {}}) is None, name
        assert _read(name, {}) is None, name
    # a program without the tracer
    monkeypatch.delattr(profiling, "last_summary")
    assert all(_read(name, {}) is None for name in SPAN_METRICS)


def test_a_stale_summary_is_refused(monkeypatch):
    """The last trace closed is read only where its timed passes are the
    run's: a later trace, or one without timed passes, gives None."""
    s = _summary()
    s.timed = {"mapping.pass": [0.0672, 0.0681]}
    monkeypatch.setattr(profiling, "_last", s)
    this_run = {"timers": {"pass_s": [0.0672, 0.0681]}}
    assert spans.summary(this_run) is s
    assert _read("step_ms", this_run) == pytest.approx(30 / 8)
    for record in ({"timers": {"pass_s": [0.0672]}},                # another window's
                   {"timers": {"pass_s": [0.0672, 0.0682]}},
                   {"timers": {"pass_s": []}}, {"timers": {}}, {}):
        assert spans.summary(record) is None, record
        assert all(_read(name, record) is None for name in SPAN_METRICS), record
    s.counts = {}                                                    # no frames
    assert spans.summary(this_run) is None


def test_a_per_frame_trace_reports_its_span_metrics():
    cell = "tum1_rgbd.per_frame"
    out, lines = toy.execute(cell, seed=5, max_calls=4, trace=True)
    assert out["correct"], lines
    listed = {m["name"] for m in spec.per_layer(cell) if m["source"] == "program_span"}
    assert {"device_idle_pct", "frame_phase_ms", "step_ms", "graph_launch_ms"} <= listed
    assert listed <= set(out["metrics"])
    s = profiling.last_summary()
    assert s.frames == 4 and s.coverage() > 0.95


def test_trace_spans_reports_the_five_over_a_stream_window():
    import time

    cell = "tum1_rgbd.stream4"
    overrides = toy.overrides(spec.workload(cell)["config"], max_calls=3)
    result, lines = trace_spans.execute(cell, 5, 1e9, "cpu", time.perf_counter(), overrides)
    assert result["correct"], lines
    assert set(result["spans"]) == set(SPAN_METRICS)
    assert result["frames"] == 12 and result["coverage"] > 0.95
    assert result["spans"]["step_ms"] > 0 and result["spans"]["frame_phase_ms"] > 0
    assert set(result["end_to_end"]) == {m["name"] for m in spec.end_to_end(cell)}
    assert lines[-1].startswith("[slambench] idle by span")
