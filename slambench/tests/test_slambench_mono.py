"""The harness with a monocular camera: toy CPU runs of the tum1_rgbd cells
with the configuration's sensor set to "mono" (no configuration file is
added), through run.execute and both APIs (track_batch_mono,
track_monocular).  The two-view bootstrap happens in the warm-up; the
check aligns the map onto the truth by one similarity before it compares.
The program's own outputs pass, the control (aligned the same way) is
refused, and with the timed path broken underneath `correct` comes out
false: every pose one frame late, one pose moved 5 cm in true metres, a
System that never bootstraps, a call that returns one pose too few."""

from __future__ import annotations

import numpy as np
import pytest

from slambench.harness.drive import STATE_OK
from slambench.reference import truth
from slambench.tests import toy

STREAM, PER_FRAME = "tum1_rgbd.stream4", "tum1_rgbd.per_frame"


def _poses(out) -> np.ndarray:
    return np.array(out, np.float64).reshape(-1, 4, 4)


def _returned(calls, poses):
    return poses if calls.api == "batch" else poses[0]


def bootstrap_recorder(record: dict):
    """A hook that leaves the calls as they are and records, at the call
    that bootstraps the map, the run frames its two views came from (the
    timestamps of keyframes 0 and 1) in record["views"]."""
    def hook(slam, calls):
        real = getattr(slam, calls.method)

        def step(*args):
            was_ok = slam.state == STATE_OK
            out = real(*args)
            if not was_ok and slam.state == STATE_OK and "views" not in record:
                ts = slam.map.kf_timestamp[:2].cpu().numpy().astype(np.float64)
                record["views"] = [int(k) for k in np.rint(ts * calls.fps)]
            return out

        setattr(slam, calls.method, step)
    return hook


def _late(slam, calls):
    """Every pose one frame late: each frame gets the pose of the frame
    before it."""
    real = getattr(slam, calls.method)
    held = {"T": np.eye(4)}

    def step(*args):
        poses = _poses(real(*args))
        late = np.concatenate([held["T"][None], poses[:-1]])
        held["T"] = poses[-1]
        return _returned(calls, late)

    setattr(slam, calls.method, step)


def _moved_5cm(slam, calls):
    """The first pose returned after the warm-up has its camera centre moved
    by 5 cm of the room: 0.05 over the map's scale, which the two bootstrap
    keyframes give (their distance in the map against the true one)."""
    real = getattr(slam, calls.method)
    n_warm_calls = 1 + toy.MONO_WARMUP_FRAMES // calls.per_call
    seen = {"calls": 0}

    def step(*args):
        poses = _poses(real(*args))
        seen["calls"] += 1
        if seen["calls"] == n_warm_calls + 1:
            ts = slam.map.kf_timestamp[:2].cpu().numpy().astype(np.float64)
            k = calls.cycle.index(np.rint(ts * calls.fps).astype(np.int64))
            true_c = truth.inv_se3(calls.cycle.poses[k])[:, :3, 3]
            map_c = truth.inv_se3(slam.map.kf_Tcw[:2].cpu().numpy())[:, :3, 3]
            metres_per_unit = (np.linalg.norm(true_c[1] - true_c[0])
                               / np.linalg.norm(map_c[1] - map_c[0]))
            poses[0, 0, 3] += 0.05 / metres_per_unit
        return _returned(calls, poses)

    setattr(slam, calls.method, step)


def _never_bootstraps(slam, calls):
    """The System is never given a frame: every call returns the identity,
    as the API does before the bootstrap (one pose a call)."""
    def step(*args):
        return np.eye(4, dtype=np.float32)[None] if calls.api == "batch" else np.eye(4)

    setattr(slam, calls.method, step)


def _one_pose_short(slam, calls):
    """Every call returns one pose fewer than it took frames."""
    real = getattr(slam, calls.method)

    def step(*args):
        return real(*args)[:-1]

    setattr(slam, calls.method, step)


@pytest.mark.parametrize("cell", [STREAM, PER_FRAME])
def test_the_check_accepts_the_programs_mono_outputs(cell):
    record = {}
    out, lines = toy.execute(cell, seed=3, hooks=bootstrap_recorder(record), mono=True)
    assert out["correct"], lines
    assert out["failed"] == 0 and out["attempted"] == 24
    # the bootstrap ends inside the warm-up: frame 0 and the 8 after it
    assert record["views"][1] <= toy.MONO_WARMUP_FRAMES, record
    numbers = next(x for x in lines if x.startswith("[slambench] numbers: "))
    scale = float(numbers.split("mono_scale ")[1].split(",")[0])
    assert 0.1 < scale < 10.0, numbers


# the per-frame calls run the stream's frames to the same poses: of its
# faults, those of its own path
FAULTS = [(STREAM, _late), (STREAM, _moved_5cm), (STREAM, _never_bootstraps),
          (STREAM, _one_pose_short), (PER_FRAME, _late), (PER_FRAME, _never_bootstraps)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_mono_path_is_not_correct(cell, fault):
    out, lines = toy.execute(cell, seed=3, hooks=fault, mono=True)
    assert out["correct"] is False, lines


@pytest.mark.parametrize("kind", ["late", "bf16"])
def test_the_mono_control_is_aligned_and_refused(kind):
    from slambench import control

    out = control.control(STREAM, 5, "cpu", {
        "config": {"sensor": "mono", "changed": toy.changed("tum1_rgbd")},
        "cycle_frames": 40, "start": 0, "limits": toy.TOY_LIMITS}, kind=kind)
    assert out["correct"] is False, out
    # the control's poses are the truth's in metres, a frame late or rounded:
    # the similarity is near 1 (0.967 late on the toy's fast arc)
    assert abs(out["numbers"]["mono_scale"] - 1.0) < 0.05, out["numbers"]
