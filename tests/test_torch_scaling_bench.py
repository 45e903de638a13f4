"""tools/scaling_bench.py, the port's counterpart of scripts/scaling_bench.py:
its problem against the JAX script's construction run through the JAX
package (points and poses within 1e-6, observed pixels within 1e-6
relative), distributed_bundle_adjust on that problem at a world
of one rank against the JAX package's on a one-device mesh (poses 1e-4,
points 1e-3, ROADMAP.md C4's BA bounds), and the harness itself under
torchrun with two gloo ranks at a tiny size."""

import hashlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.ops import se3 as jse3
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.camera import project as jproject
from self_commit_orb_slam2_tpu.parallel import distributed_ba as jdba
from self_commit_orb_slam2_tpu.parallel.mesh import MeshSpec as JMeshSpec
from self_commit_orb_slam2_tpu.parallel.mesh import make_mesh as jmake_mesh
from self_commit_orb_slam2_tpu_torch.parallel.distributed_ba import distributed_bundle_adjust
from self_commit_orb_slam2_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from self_commit_orb_slam2_tpu_torch.tools import scaling_bench

torch.set_num_threads(2)   # six test workers share the CPU

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCAM = JCam.create(fx=300.0, fy=300.0, cx=160.0, cy=120.0, bf=30.0, width=320, height=240)
K, N, ITERS = 8, 256, 5


def jax_problem(rng, K, N, P):
    """scripts/scaling_bench.py:67-82, one width, through the JAX package."""
    pt = rng.uniform(-1, 1, (1, P, 3)).astype(np.float32)
    pt[..., 2] += 5.0
    poses = np.zeros((1, K, 4, 4), np.float32)
    obs_pt = np.zeros((1, K, N), np.int32)
    obs_uvr = np.zeros((1, K, N, 3), np.float32)
    for k in range(K):
        xi = jnp.asarray((rng.normal(0, 0.05, 6)).astype(np.float32))
        poses[0, k] = np.asarray(jse3.se3_exp(xi))
        sel = rng.choice(P, N, replace=False).astype(np.int32)
        obs_pt[0, k] = sel
        pc = pt[0, sel] @ poses[0, k][:3, :3].T + poses[0, k][:3, 3]
        uv, _ = jproject(JCAM, jnp.asarray(pc))
        ur = np.asarray(uv)[:, 0] - float(JCAM.bf) / pc[:, 2]
        obs_uvr[0, k] = np.concatenate([np.asarray(uv), ur[:, None]], -1)
    return pt, poses, obs_pt, obs_uvr


@pytest.fixture(scope="module")
def problems():
    """Two widths drawn in turn from one generator on each side (512 and
    1024 points), as the harnesses draw them."""
    jr, pr = np.random.default_rng(0), np.random.default_rng(0)
    return [(jax_problem(jr, K, N, 512 * w), scaling_bench.build_problem(
        pr, scaling_bench.CAMERA, K, N, 512 * w)) for w in (1, 2)]


def test_problem_matches_the_jax_scripts(problems):
    for ref, got in problems:
        for a, b in zip(ref, got):
            assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(got[0], ref[0], atol=1e-6)     # points
        np.testing.assert_allclose(got[1], ref[1], atol=1e-6)     # poses
        np.testing.assert_array_equal(got[2], ref[2])             # observed points
        # pixels: one float32 ulp apart at most (JAX's compiled projection)
        np.testing.assert_allclose(got[3], ref[3], rtol=1e-6, atol=1e-6)


def test_world_of_one_matches_jax_one_device_mesh(problems):
    ref, got = problems[0]
    pt, poses, obs_pt, obs_uvr = ref
    P = pt.shape[1]
    T_ref, p_ref = jdba.distributed_bundle_adjust(
        jmake_mesh(JMeshSpec(n_map=1, n_blk=1)), JCAM, jnp.asarray(poses), jnp.asarray(pt),
        jnp.asarray(obs_pt), jnp.asarray(obs_uvr), jnp.ones((1, K, N), jnp.float32),
        jnp.ones((1, K, N), bool), jnp.asarray((np.arange(K) > 0)[None]),
        jnp.ones((1, P), bool), n_iters=ITERS)
    T, p = distributed_bundle_adjust(make_mesh(MeshSpec(1, 1)), scaling_bench.CAMERA,
                                     *scaling_bench.ba_inputs(got, "cpu"), n_iters=ITERS)
    np.testing.assert_allclose(T.numpy(), np.asarray(T_ref), atol=1e-4)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=1e-3)
    # the problem starts at the truth: the solve stays there, keyframe 0 fixed
    assert torch.equal(T[0, 0], torch.from_numpy(poses[0, 0]))
    np.testing.assert_allclose(p.numpy(), pt, atol=1e-3)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_harness_under_torchrun_two_gloo_ranks(tmp_path):
    scaling = os.path.join(ROOT, "SCALING.json")
    before = _sha(scaling)
    out = tmp_path / "scaling.json"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "self_commit_orb_slam2_tpu_torch.tools.scaling_bench",
           "--device", "cpu", "--per-dev-points", "32", "--kfs", "4", "--obs-per-kf", "32",
           "--iters", "2", "--reps", "1", "--out", str(out)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = [line for line in proc.stdout.splitlines() if line.startswith("blk=")]
    assert [r.split()[0:2] for r in rows] == [["blk=", "1"], ["blk=", "2"]], proc.stdout
    got = json.loads(out.read_text())
    assert got["kind"] == "weak_scaling_distributed_ba" and got["world_size"] == 2
    assert got["device"] == "cpu" and got["card"] is None
    assert [r["devices"] for r in got["table"]] == [1, 2]
    assert [r["points"] for r in got["table"]] == [32, 64]
    assert all(r["ms"] > 0 and np.isfinite(r["ms"]) for r in got["table"])
    assert got["table"][0]["efficiency_pct"] == pytest.approx(100.0)
    assert _sha(scaling) == before


def test_harness_refuses_the_jax_record_and_a_missing_card():
    with pytest.raises(ValueError, match="SCALING.json"):
        scaling_bench.main(["--device", "cpu", "--out", os.path.join(ROOT, "SCALING.json")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scaling_bench.main([])
