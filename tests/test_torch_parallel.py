"""The port's multi-device layer at a world of one rank, against the JAX
package's parallel/ on its 8-virtual-device CPU mesh (tests/test_parallel.py's
inputs): distributed bundle adjustment (poses 1e-4, points 1e-3, the BA
bounds of ROADMAP.md C(2)), the distributed pose graph (Sim3 2e-3, the JAX
test's own bar, mean residual < 1e-2), and the mesh and hosts helpers.
The multi-process worlds are tests/test_torch_gloo.py's; the refine_maps
CLI is tests/test_torch_refine_maps.py's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.parallel.distributed_ba import (
    distributed_bundle_adjust as jax_dist_ba)
from self_commit_orb_slam2_tpu.parallel.distributed_pose_graph import (
    distributed_pose_graph as jax_dist_pg)
from self_commit_orb_slam2_tpu.parallel.mesh import MeshSpec as JMeshSpec
from self_commit_orb_slam2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from self_commit_orb_slam2_tpu_torch.ops import se3
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.parallel import hosts
from self_commit_orb_slam2_tpu_torch.parallel.distributed_ba import distributed_bundle_adjust
from self_commit_orb_slam2_tpu_torch.parallel.distributed_pose_graph import (
    distributed_pose_graph)
from self_commit_orb_slam2_tpu_torch.parallel.mesh import (
    MeshSpec, make_mesh, map_sharding, point_block_sharding, replicated, shard, unshard)
from tests.test_parallel import CAM as JCAM
from tests.test_parallel import _padded_ring_graphs, make_problem

torch.set_num_threads(2)   # six test workers share the CPU

CAM = CameraParams.create(fx=300.0, fy=300.0, cx=160.0, cy=120.0, bf=30.0,
                          width=320, height=240)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ba_problem(rng):
    """test_parallel.py:44-56: two maps of 4 keyframes, 96 observations
    each, 256 points; poses and points perturbed."""
    S, K, N, P = 2, 4, 96, 256
    poses, pt, obs_pt, obs_uvr = make_problem(rng, S, K, N, P)
    poses_n = poses.copy()
    for s in range(S):
        for k in range(1, K):
            xi = rng.normal(0, 0.005, 6).astype(np.float32)
            poses_n[s, k] = np.asarray(se3.se3_exp(torch.from_numpy(xi))) @ poses_n[s, k]
    pt_n = pt + rng.normal(0, 0.01, pt.shape).astype(np.float32)
    kf_free = np.tile(np.arange(K) > 0, (S, 1))
    args = (poses_n, pt_n, obs_pt, obs_uvr, np.ones((S, K, N), np.float32),
            np.ones((S, K, N), bool), kf_free, np.ones((S, P), bool))
    return poses, args


def test_distributed_ba_matches_jax(rng):
    poses, args = _ba_problem(rng)
    ref = jax_dist_ba(jax_make_mesh(JMeshSpec(n_map=2, n_blk=4)), JCAM,
                      *(jnp.asarray(a) for a in args), n_iters=8)
    got = distributed_bundle_adjust(make_mesh(MeshSpec(1, 1)), CAM, *(_t(a) for a in args),
                                    n_iters=8)
    np.testing.assert_allclose(got.kf_Tcw.numpy(), np.asarray(ref.kf_Tcw), atol=1e-4)
    np.testing.assert_allclose(got.pt_pos.numpy(), np.asarray(ref.pt_pos), atol=1e-3)
    # and it recovers the true poses, as the JAX test requires of its own
    for s in range(2):
        for k in range(1, 4):
            T = got.kf_Tcw[s, k].double() @ torch.linalg.inv(torch.from_numpy(poses[s, k]).double())
            assert float(torch.linalg.norm(se3.se3_log(T.float()))) < 2e-3


def test_distributed_ba_ur_weight_matches_jax(rng):
    """The RGB-D weight on the third residual (ur_weight 25, loop_closing's
    sharded GBA), with a mono half and invalid observations."""
    _, args = _ba_problem(rng)
    poses_n, pt_n, obs_pt, obs_uvr, sigma2, valid, kf_free, pt_free = args
    obs_uvr = obs_uvr.copy()
    obs_uvr[:, :, ::2, 2] = -1.0
    valid = rng.uniform(size=valid.shape) > 0.1
    obs_pt = np.where(rng.uniform(size=obs_pt.shape) > 0.05, obs_pt, -1).astype(np.int32)
    sigma2 = rng.choice([1.0, 1.44, 2.0736], size=sigma2.shape).astype(np.float32)
    pt_free = rng.uniform(size=pt_free.shape) > 0.1
    args = (poses_n, pt_n, obs_pt, obs_uvr, sigma2, valid, kf_free, pt_free)
    ref = jax_dist_ba(jax_make_mesh(JMeshSpec(n_map=2, n_blk=2)), JCAM,
                      *(jnp.asarray(a) for a in args), n_iters=5, ur_weight=25.0)
    got = distributed_bundle_adjust(make_mesh(MeshSpec(1, 1)), CAM, *(_t(a) for a in args),
                                    n_iters=5, ur_weight=25.0)
    np.testing.assert_allclose(got.kf_Tcw.numpy(), np.asarray(ref.kf_Tcw), atol=1e-4)
    np.testing.assert_allclose(got.pt_pos.numpy(), np.asarray(ref.pt_pos), atol=1e-3)


def test_distributed_pose_graph_matches_jax(rng):
    """test_parallel.py:139-160: two rings of 12 keyframes, 16 edge slots."""
    est, ei, ej, meas, valid, fixed, _ = _padded_ring_graphs(rng, 2, 12, 16)
    args = (est, ei, ej, meas, valid, fixed)
    S_ref, res_ref = jax_dist_pg(jax_make_mesh(JMeshSpec(n_map=2, n_blk=4)),
                                 *(jnp.asarray(a) for a in args), n_iters=20)
    S_got, res_got = distributed_pose_graph(make_mesh(MeshSpec(1, 1)),
                                            *(_t(a) for a in args), n_iters=20)
    assert S_got.shape == (2, 12, 8) and res_got.shape == (2,)
    assert bool((res_got < 1e-2).all()), res_got
    np.testing.assert_allclose(S_got.numpy(), np.asarray(S_ref), atol=2e-3)
    np.testing.assert_allclose(res_got.numpy(), np.asarray(res_ref), atol=1e-4)


def test_mesh_construction():
    """test_parallel.py:37-41 at the port's world of one rank: the shape
    reads like JAX's, and a mesh larger than the world raises."""
    mesh = make_mesh(MeshSpec(n_map=1, n_blk=1))
    assert mesh.shape == {"map": 1, "blk": 1} and mesh.coords == (0, 0)
    assert MeshSpec(2, 4).total == 8
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        make_mesh(MeshSpec(n_map=2, n_blk=4))
    x = torch.arange(24.0).reshape(2, 4, 3)
    for place in (map_sharding(mesh), point_block_sharding(mesh), replicated(mesh)):
        assert torch.equal(shard(x, place), x) and torch.equal(unshard(x, place), x)
    # a grid of ranks this rank is not in: the whole problem runs here alone
    other = make_mesh(MeshSpec(1, 1), devices=[5])
    assert other.coords is None and other.for_this_rank().coords == (0, 0)


def test_global_mesh_and_hosts_helpers():
    """test_parallel.py:322-333: initialize() without a process group or its
    environment is a no-op; the helpers read the world of one rank."""
    hosts.initialize()  # single-process no-op
    assert not torch.distributed.is_initialized()
    mesh = hosts.global_mesh(n_map=1)
    assert mesh.shape == {"map": 1, "blk": 1}
    assert hosts.is_coordinator()
    assert hosts.local_device_count() == torch.cuda.device_count()
    with pytest.raises(ValueError):
        hosts.global_mesh(n_map=3)
    with pytest.raises(ValueError):
        hosts.global_mesh(n_map=1, n_blk=2)
    r1, r2 = hosts.fold_in_process(5), hosts.fold_in_process(5)
    assert r1.integers(0, 1000) == r2.integers(0, 1000)
    assert np.random.default_rng(5).integers(0, 1000) == hosts.fold_in_process(5).integers(0, 1000)
