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
import time

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


# The checked numbers of the RGB-D and stereo toy runs (seed 3, toy.overrides,
# 3 calls) as the check gave them before it learned the monocular sensor, on
# an x86-64 CPU at 2 torch threads: the sensor's rule leaves these cells' check
# as it was, bit for bit.
PINNED_KEYS = ("rpe_t_mm", "rpe_r_deg", "ate_mm", "ate_r_deg", "kf_t_mm", "kf_r_deg",
               "pt_p50_mm", "pt_p90_mm", "feat_diff", "n_poses", "n_keyframes", "n_points",
               "keyframes_inserted", "closures", "lost_frames")
PINNED = {
    "tum1_rgbd.stream4": (
        "0x1.09d1df67dd84fp+4", "0x1.3329420bc1e5fp-1", "0x1.2d37aee2459c4p+4",
        "0x1.5b737fe20c825p-1", "0x1.15600f09159bap+4", "0x1.3d5ad0a14d3aap-1",
        "0x1.6a1ac25c0d851p+1", "0x1.71e6b51f3c7aap+3", "0x0.0p+0", "0x1.8000000000000p+3",
        "0x1.8000000000000p+1", "0x1.4300000000000p+9", "0x1.8000000000000p+1", "0x0.0p+0",
        "0x0.0p+0"),
    "tum1_rgbd.per_frame": (
        "0x1.2cca342c373f5p+3", "0x1.fd35867006aa5p-4", "0x1.32f87c0ed742ap+3",
        "0x1.3a754f39b29e9p-2", "0x1.11b639128b5a8p+2", "0x1.64887446b6a9bp-3",
        "0x1.724000a8faed6p+0", "0x1.8d448153a07bbp+2", "0x0.0p+0", "0x1.8000000000000p+1",
        "0x1.0000000000000p+1", "0x1.0d00000000000p+9", "0x1.0000000000000p+1", "0x0.0p+0",
        "0x0.0p+0"),
    "kitti00_stereo.stream4": (
        "0x1.10a0042f821d0p+5", "0x1.8c0daffb14137p-3", "0x1.9de491b1d7eb5p+5",
        "0x1.d56f2efcf7953p-2", "0x1.aa5a916251103p+4", "0x1.a217cdf0ff34cp-3",
        "0x1.18064f97bb7bcp+6", "0x1.1a92845f9f9f6p+9", "0x0.0p+0", "0x1.8000000000000p+3",
        "0x1.0000000000000p+2", "0x1.0c00000000000p+9", "0x1.0000000000000p+2", "0x0.0p+0",
        "0x0.0p+0"),
}


@pytest.mark.parametrize("cell", list(PINNED))
def test_the_check_of_the_rgbd_and_stereo_cells_did_not_move(cell):
    import torch

    from slambench.harness import check, drive

    torch.set_num_threads(2)
    config = spec.workload(cell)["config"]
    r = drive.run(cell, 3, 1e9, False, "cpu", time.perf_counter(), toy.overrides(config, 3))
    values = check.numbers(r, "cpu")
    values["lost_frames"] = float(sum(len(c[2]) for c in r.calls if c[4]))
    assert tuple(values) == PINNED_KEYS
    assert {k: float(v).hex() for k, v in values.items()} == dict(zip(PINNED_KEYS, PINNED[cell]))
