"""A cell at a size a CPU test run can hold: half the configuration's
resolution, 500 features, small capacities, a 40-frame stretch of the arc,
8 warm-up frames and a few calls.  TOY_LIMITS hold the toy's outputs to
the same numbers as the cell's limits, at the toy's own accuracy (a
quarter of the pixels: sound toy runs read up to ~15 mm and ~0.6 degrees
from the true poses)."""

from __future__ import annotations

import time

HALF = {
    "tum1_rgbd": {"Camera.width": 320, "Camera.height": 240, "Camera.fx": 517.306408 / 2,
                  "Camera.fy": 516.469215 / 2, "Camera.cx": 318.643040 / 2,
                  "Camera.cy": 255.313989 / 2, "Camera.bf": 40.0 / 2},
    "kitti00_stereo": {"Camera.width": 620, "Camera.height": 188, "Camera.fx": 718.856 / 2,
                       "Camera.fy": 718.856 / 2, "Camera.cx": 607.1928 / 2,
                       "Camera.cy": 185.2157 / 2, "Camera.bf": 386.1448 / 2},
}

# the monocular toy: the first frame and 8 warm-up frames, of which the
# two-view bootstrap takes the first two (frames 0 and 1 of the arc from
# start 0), then a window of 24 frames, from the arc's right end to its
# left: one similarity fitted to a few frames on a short stretch of the arc
# is not fixed well about the stretch's axis, so the window spans the arc.
# Aligned, the sound toy reads 22.4 mm, 1.19 degrees, 11.7 mm and 0.93
# degrees against TOY_LIMITS' 40, 1.5, 30 and 1.5 (both APIs alike)
MONO_WARMUP_FRAMES = 8
MONO_CALLS = {"batch": 6, "frame": 24}

TOY_LIMITS = {"ate_mm": 40.0, "ate_r_deg": 1.5, "kf_t_mm": 30.0, "kf_r_deg": 1.5,
              "feat_diff": 0.0, "lost_frames": 0.0}


def changed(config: str) -> dict:
    """The configuration's changed keys with the toy's size on top."""
    from slambench.harness import spec

    return {**spec.config(config).get("changed", {}), **HALF[config],
            "ORBextractor.nFeatures": 500}


def overrides(config: str, max_calls: int = 3, limits: dict | None = None) -> dict:
    return {"config": {"changed": changed(config),
                       "capacities": {"max_keyframes": 32, "max_points": 8192,
                                      "local_points": 512}},
            "cycle_frames": 40, "start": 0, "warmup_frames": 8, "max_calls": max_calls,
            "limits": TOY_LIMITS if limits is None else limits}


def mono_overrides(max_calls: int) -> dict:
    """The tum1_rgbd toy run as a monocular camera: its configuration with
    "sensor": "mono" and a warm-up long enough for the two-view bootstrap."""
    ov = overrides("tum1_rgbd", max_calls)
    ov["config"]["sensor"] = "mono"
    ov["warmup_frames"] = MONO_WARMUP_FRAMES
    return ov


def execute(cell: str, seed: int, hooks=None, max_calls: int = 3, trace: bool = False,
            mono: bool = False):
    """One toy run of the cell on the CPU through the harness's entry (mono:
    a tum1_rgbd cell's toy run as a monocular camera, its calls
    MONO_CALLS)."""
    import torch

    from slambench import run
    from slambench.harness import spec

    torch.set_num_threads(2)
    w = spec.workload(cell)
    ov = (mono_overrides(MONO_CALLS[spec.traffic(w["traffic"])["api"]]) if mono
          else overrides(w["config"], max_calls))
    return run.execute(cell, seed, 1e9, trace, "cpu", time.perf_counter(), ov, hooks)
