"""The committed tum1_mono configuration and its cell tum1_mono.per_frame,
at a toy's size on the CPU, through run.execute: half the resolution (the
settings state no Camera.bf, so neither does the toy), 500 features, small
capacities, a 40-frame stretch of the arc with the bootstrap in the
warm-up, then toy.MONO_CALLS' per-frame calls.  The cell is correct, and
not where the System never bootstraps; its traced run reports the two
stage metrics (triangulate_ms.per_frame, fuse_ms.per_frame), as does the
RGB-D per-frame cell's, and they report nothing without stage stamps; the
control is refused; a Camera.bf in the settings changes nothing the mono
path returns."""

from __future__ import annotations

import time

import numpy as np
import pytest

from slambench.harness import spec
from slambench.tests import toy
from slambench.tests.test_slambench_mono import _never_bootstraps
from self_commit_orb_slam2_tpu_torch.utils import profiling
from self_commit_orb_slam2_tpu_torch.utils.profiling import SpanRecord, TraceSummary

CELL = "tum1_mono.per_frame"
STAGE_METRICS = {"triangulate_ms.per_frame": "create_new_points",
                 "fuse_ms.per_frame": "fuse_into_keyframe"}
# tum1_mono's camera at half its size (toy.HALF's tum1_rgbd entry less bf)
HALF = {"Camera.width": 320, "Camera.height": 240, "Camera.fx": 517.306408 / 2,
        "Camera.fy": 516.469215 / 2, "Camera.cx": 318.643040 / 2,
        "Camera.cy": 255.313989 / 2}


def overrides(changed: dict | None = None) -> dict:
    return {"config": {"changed": {**spec.config("tum1_mono")["changed"], **HALF,
                                   "ORBextractor.nFeatures": 500, **(changed or {})},
                       "capacities": {"max_keyframes": 32, "max_points": 8192,
                                      "local_points": 512}},
            "cycle_frames": 40, "start": 0, "warmup_frames": toy.MONO_WARMUP_FRAMES,
            "max_calls": toy.MONO_CALLS["frame"], "limits": toy.TOY_LIMITS}


def execute(hooks=None, trace: bool = False):
    import torch

    from slambench import run

    torch.set_num_threads(2)
    return run.execute(CELL, 3, 1e9, trace, "cpu", time.perf_counter(), overrides(), hooks)


def test_the_cell_is_the_committed_configuration():
    w = spec.workload(CELL)
    cfg = spec.config(w["config"])
    assert (w["traffic"], w["chips"], cfg["sensor"]) == ("per_frame", 1, "mono")
    assert spec.traffic(w["traffic"])["api"] == "frame"
    from slambench.harness import settings as st

    s = st.read(cfg)
    assert "Camera.bf" not in s and "ThDepth" not in s and "DepthMapFactor" not in s
    assert st.size(s) == (640, 480) and s["ORBextractor.nFeatures"] == 1000
    assert set(spec.limits(CELL)) == set(toy.TOY_LIMITS)


def test_the_traced_mono_cell_is_correct_and_reads_its_stages():
    out, lines = execute(trace=True)
    assert out["correct"], lines
    traced = spec.traffic(spec.workload(CELL)["traffic"])["trace_calls"]
    assert out["failed"] == 0 and out["attempted"] == toy.MONO_CALLS["frame"] + traced
    listed = {m["name"] for m in spec.per_layer(CELL) if m["source"] == "program_span"}
    assert set(STAGE_METRICS) <= listed <= set(out["metrics"])
    stages = {name: out["metrics"][name]["value"] for name in STAGE_METRICS}
    assert all(v > 0 for v in stages.values()), stages
    # both stages lie inside the pass
    assert sum(stages.values()) < out["metrics"]["mapping_pass_ms.per_frame"]["value"]


def test_a_mono_cell_that_never_bootstraps_is_not_correct():
    out, lines = execute(hooks=_never_bootstraps)
    assert out["correct"] is False, lines


def test_the_rgbd_per_frame_cell_reads_its_stages():
    cell = "tum1_rgbd.per_frame"
    out, lines = toy.execute(cell, seed=5, max_calls=4, trace=True)
    assert out["correct"], lines
    assert all(out["metrics"][name]["value"] > 0 for name in STAGE_METRICS), out["metrics"]


@pytest.mark.parametrize("name", sorted(STAGE_METRICS))
def test_a_stage_reader_reports_nothing_without_stage_stamps(name, monkeypatch):
    read = spec.metric_reader(name)
    ms = 1_000_000
    spans = [SpanRecord("call", 1, -1, (0, 100 * ms), None)]
    bare = TraceSummary(spans, passes=[(30 * ms, 50 * ms)], counts={"frames": 4})
    assert read({"timers": {"spans": bare}}) is None
    stamped = TraceSummary(spans, passes=[(30 * ms, 50 * ms)], counts={"frames": 4},
                           stages={STAGE_METRICS[name]: [(32 * ms, 36 * ms)]})
    assert read({"timers": {"spans": stamped}}) == pytest.approx(4.0)
    monkeypatch.setattr(profiling, "_last", None)
    assert read({}) is None and read({"timers": {}}) is None
    # a program whose summaries have no stage intervals at all
    monkeypatch.delattr(TraceSummary, "stage_ns")
    assert read({"timers": {"spans": bare}}) is None


@pytest.mark.parametrize("kind", ["late", "bf16"])
def test_the_mono_control_is_refused_by_the_cells_limits(kind):
    """The control at the toy's size under the cell's own limits (the
    control test of every cell builds its toy from toy.HALF, which has no
    tum1_mono entry): refused; a frame late fails the rotations and the
    features (the similarity takes up most of the lag in position on the
    toy's short stretch of arc)."""
    from slambench import control

    small = {"config": {"changed": overrides()["config"]["changed"]},
             "cycle_frames": 40, "start": 0}
    out = control.control(CELL, 5, "cpu", small, kind=kind)
    assert out["correct"] is False, out
    failed = {n for n, c in out["checks"].items() if c["value"] > c["limit"]}
    assert failed >= ({"ate_r_deg", "kf_r_deg", "feat_diff"} if kind == "late"
                      else {"feat_diff"}), failed


def test_a_camera_bf_changes_nothing_on_the_mono_path():
    """The same toy run with the RGB-D file's Camera.bf (half of 40) set:
    every returned pose, live keyframe and map point bit for bit."""
    import torch

    from slambench.harness import drive

    torch.set_num_threads(2)
    outputs = [drive.run(CELL, 3, 1e9, False, "cpu", time.perf_counter(),
                         overrides(changed)).outputs
               for changed in (None, {"Camera.bf": 20.0})]
    for key in ("poses", "kf_Tcw", "points"):
        assert np.array_equal(outputs[0][key], outputs[1][key], equal_nan=True), key
    assert outputs[0]["poses"].shape[0] == toy.MONO_CALLS["frame"]
