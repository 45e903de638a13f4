"""The readers of the mapping pass's refresh and local BA stamps
(metrics/refresh_ms.per_frame.py, local_ba_ms.per_frame.py): nothing
without those stamps, as in a program that does not write them, the mean
stamped interval where it does; a toy per-frame run of each per-frame
cell on the CPU reports both, inside the pass."""

from __future__ import annotations

import pytest

from slambench.harness import spec
from slambench.tests import toy
from self_commit_orb_slam2_tpu_torch.utils import profiling
from self_commit_orb_slam2_tpu_torch.utils.profiling import SpanRecord, TraceSummary

STAGE_METRICS = {"refresh_ms.per_frame": "refresh_observed_points",
                 "local_ba_ms.per_frame": "local_bundle_adjustment"}
ALL_STAGES = ("triangulate_ms.per_frame", "fuse_ms.per_frame", *STAGE_METRICS)


def test_the_metrics_are_listed_in_both_per_frame_cells():
    for cell in ("tum1_rgbd.per_frame", "tum1_mono.per_frame"):
        listed = {m["name"] for m in spec.per_layer(cell)}
        assert set(STAGE_METRICS) <= listed, cell
    assert set(STAGE_METRICS.values()) <= set(profiling.STAGES)


@pytest.mark.parametrize("name", sorted(STAGE_METRICS))
def test_a_stage_reader_reports_nothing_without_its_stamps(name, monkeypatch):
    read = spec.metric_reader(name)
    ms = 1_000_000
    spans = [SpanRecord("call", 1, -1, (0, 100 * ms), None)]
    bare = TraceSummary(spans, passes=[(30 * ms, 50 * ms)], counts={"frames": 4})
    assert read({"timers": {"spans": bare}}) is None
    # a program that stamps only the two neighbour-wide stages
    older = TraceSummary(spans, passes=[(30 * ms, 50 * ms)], counts={"frames": 4},
                         stages={"create_new_points": [(31 * ms, 32 * ms)],
                                 "fuse_into_keyframe": [(32 * ms, 33 * ms)]})
    assert read({"timers": {"spans": older}}) is None
    stamped = TraceSummary(spans, passes=[(30 * ms, 50 * ms), (60 * ms, 90 * ms)],
                           counts={"frames": 4},
                           stages={STAGE_METRICS[name]: [(34 * ms, 37 * ms),
                                                         (70 * ms, 75 * ms)]})
    assert read({"timers": {"spans": stamped}}) == pytest.approx(4.0)
    monkeypatch.setattr(profiling, "_last", None)
    assert read({}) is None and read({"timers": {}}) is None
    monkeypatch.delattr(TraceSummary, "stage_ns")
    assert read({"timers": {"spans": bare}}) is None


def test_the_rgbd_per_frame_cell_reads_the_four_stages_inside_the_pass():
    out, lines = toy.execute("tum1_rgbd.per_frame", seed=5, max_calls=4, trace=True)
    assert out["correct"], lines
    stages = {name: out["metrics"][name]["value"] for name in ALL_STAGES}
    assert all(v > 0 for v in stages.values()), out["metrics"]
    assert sum(stages.values()) < out["metrics"]["mapping_pass_ms.per_frame"]["value"]
