"""Toy CPU passes of each traffic mix through the harness's entry
(run.execute, the look for a card skipped): the check accepts the
program's own outputs, no JAX module is loaded, and with the timed path
broken underneath `correct` comes out false, once for each fault a cell
can have (a step that returns its state unchanged, half of the batch left
out, an answer altered where it is produced; no cell spans chips)."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest

from slambench.harness import spec
from slambench.tests import toy

STREAM, PER_FRAME = "tum1_rgbd.stream4", "tum1_rgbd.per_frame"


def test_the_check_accepts_the_programs_outputs():
    for cell in (STREAM, PER_FRAME):
        out, lines = toy.execute(cell, seed=3)
        assert out["correct"], lines
        assert out["failed"] == 0 and out["attempted"] == 3 * spec.traffic(
            spec.workload(cell)["traffic"])["frames_per_call"]
        assert list(out)[-1] == "checks" and set(out["checks"]) == set(toy.TOY_LIMITS)
        assert set(out["metrics"]) == {m["name"] for m in spec.end_to_end(cell)}


def test_toy_limits_name_the_cells_numbers():
    for cell in (w["name"] for w in spec.benchmark()["workloads"]):
        assert set(spec.limits(cell)) == set(toy.TOY_LIMITS), cell


def test_no_jax_module_after_a_pass_of_each_mix():
    probe = (
        "import json, sys\n"
        "from slambench.tests import toy\n"
        "from slambench import run\n"
        f"toy.execute({STREAM!r}, seed=4, max_calls=1)\n"
        f"toy.execute({PER_FRAME!r}, seed=4, max_calls=1)\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=1500, cwd=str(spec.REPO_DIR))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole():
    from slambench import run

    saved = dict(sys.modules)
    try:
        sys.modules["self_commit_orb_slam2_tpu_torch_x"] = sys.modules[__name__]
        sys.modules["jaxtyping_like"] = sys.modules[__name__]
        assert run.forbidden_modules() == []
        sys.modules["jax.numpy"] = sys.modules[__name__]
        assert run.forbidden_modules() == ["jax.numpy"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def _unchanged_state(slam, calls):
    """Every call returns the pose the tracker held before it: the step
    leaves its state as it was."""
    held = {"T": None}
    real = getattr(slam, calls.method)

    def step(*args):
        if held["T"] is None:
            held["T"] = np.asarray(real(*args), np.float64).reshape(-1, 4, 4)[-1]
        n = len(args[2]) if calls.api == "batch" else 1
        out = np.repeat(held["T"][None], n, 0)
        return out if calls.api == "batch" else out[0]

    setattr(slam, calls.method, step)


def _half_batch(slam, calls):
    """Only the first half of each batch is tracked; the rest take the last
    tracked pose."""
    real = getattr(slam, calls.method)

    def step(a, b, ts):
        if len(ts) < 2:
            return real(a, b, ts)
        h = len(ts) // 2
        poses = np.asarray(real(a[:h], b[:h], ts[:h]), np.float64).reshape(-1, 4, 4)
        return np.concatenate([poses, np.repeat(poses[-1:], len(ts) - h, 0)])

    setattr(slam, calls.method, step)


def _altered_pose(slam, calls):
    """Each call's last pose is moved by 5 cm where the API returns it."""
    real = getattr(slam, calls.method)

    def step(*args):
        out = np.array(real(*args), np.float64)
        out.reshape(-1, 4, 4)[-1, 0, 3] += 0.05
        return out

    setattr(slam, calls.method, step)


def _altered_feature(slam, calls):
    """One descriptor bit of the last frame is flipped where the frame is
    built."""
    real = getattr(slam, calls.method)

    def step(*args):
        out = real(*args)
        desc = slam.carry.last_frame.desc
        desc[0, 0] ^= 1
        return out

    setattr(slam, calls.method, step)


FAULTS = [(STREAM, _unchanged_state), (STREAM, _half_batch), (STREAM, _altered_pose),
          (STREAM, _altered_feature), (PER_FRAME, _unchanged_state),
          (PER_FRAME, _altered_pose), (PER_FRAME, _altered_feature)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    out, lines = toy.execute(cell, seed=3, hooks=fault, max_calls=4)
    assert out["correct"] is False, lines
