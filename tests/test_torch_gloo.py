"""The port's multi-device layer in multi-process worlds of 2 and 4 gloo
ranks on the CPU, against the same calls at a world of one rank (this
process, no process group): distributed bundle adjustment and the
distributed pose graph at blk widths 1, 2 and 4 and on a 2x2 mesh, the
fleet's two streams split over two ranks, refine_maps' refusals and the
mesh / hosts helpers.  Results agree within 1e-4 (the ranks sum their
partials in another order than one rank does).

Each world is spawned once (a file:// rendezvous in a temporary directory,
init_process_group with a 60 s timeout) and runs every case; a join with
its own deadline kills the children and fails, so no case can hang the
suite.  Spawned children import this module, so its top-level imports are
torch, numpy and the port only: no JAX.
"""

import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu_torch.models.config import Capacities, SlamConfig
from self_commit_orb_slam2_tpu_torch.models.map_state import empty_map
from self_commit_orb_slam2_tpu_torch.ops import se3, sim3
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams, project
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.parallel import hosts
from self_commit_orb_slam2_tpu_torch.parallel.distributed_ba import distributed_bundle_adjust
from self_commit_orb_slam2_tpu_torch.parallel.distributed_pose_graph import (
    distributed_pose_graph)
from self_commit_orb_slam2_tpu_torch.parallel.fleet import FleetTracker, make_fleet_mesh
from self_commit_orb_slam2_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

torch.set_num_threads(2)   # six test workers share the CPU

WORLD_DEADLINE_S = 240
CAM = CameraParams.create(fx=300.0, fy=300.0, cx=160.0, cy=120.0, bf=30.0,
                          width=320, height=240)
FLEET_CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)
N_FLEET = 6


def ba_problem(seed=0, S=2, K=4, N=64, P=256):
    """tests/test_parallel.py's make_problem in torch, poses and points
    perturbed: the arguments of distributed_bundle_adjust after the mesh."""
    rng = np.random.default_rng(seed)
    pt = rng.uniform(-1, 1, (S, P, 3)).astype(np.float32)
    pt[..., 2] += 5.0
    poses = np.zeros((S, K, 4, 4), np.float32)
    obs_pt = np.zeros((S, K, N), np.int32)
    obs_uvr = np.zeros((S, K, N, 3), np.float32)
    for s in range(S):
        for k in range(K):
            xi = (rng.normal(0, 0.1, 6) * [1, 1, 1, 0.3, 0.3, 0.3]).astype(np.float32)
            poses[s, k] = se3.se3_exp(torch.from_numpy(xi)).numpy()
            sel = rng.choice(P, N, replace=False).astype(np.int32)
            obs_pt[s, k] = sel
            pc = pt[s, sel] @ poses[s, k][:3, :3].T + poses[s, k][:3, 3]
            uv = project(CAM, torch.from_numpy(pc))[0].numpy()
            ur = uv[:, 0] - float(CAM.bf) / pc[:, 2]
            obs_uvr[s, k] = np.concatenate([uv, ur[:, None]], -1)
    for s in range(S):
        for k in range(1, K):
            xi = rng.normal(0, 0.005, 6).astype(np.float32)
            poses[s, k] = se3.se3_exp(torch.from_numpy(xi)).numpy() @ poses[s, k]
    pt = pt + rng.normal(0, 0.01, pt.shape).astype(np.float32)
    kf_free = np.tile(np.arange(K) > 0, (S, 1))
    return tuple(torch.from_numpy(a) for a in (
        poses, pt, obs_pt, obs_uvr, np.ones((S, K, N), np.float32), np.ones((S, K, N), bool),
        kf_free, np.ones((S, P), bool)))


def pose_graph_problem(seed=0, S=2, K=10, E=16, drift=0.02):
    """Rings of K keyframes with drifting odometry and one loop edge
    (tests/test_pose_graph.py's ring_problem in torch), padded to E edges:
    the arguments of distributed_pose_graph after the mesh."""
    rng = np.random.default_rng(seed)
    est = np.zeros((S, K, 8), np.float32)
    ei = np.zeros((S, E), np.int32)
    ej = np.zeros((S, E), np.int32)
    meas = np.tile(np.array([0, 0, 0, 1, 0, 0, 0, 1], np.float32), (S, E, 1))
    valid = np.zeros((S, E), bool)
    def exp(xi):
        return se3.se3_exp(torch.tensor(xi, dtype=torch.float32)).double().numpy()

    def S3(T):
        return sim3.from_se3(torch.from_numpy(T.astype(np.float32))).numpy()

    for s in range(S):
        gt = [exp([np.sin(a), 0, 1 - np.cos(a), 0, a, 0])
              for a in 2 * np.pi * np.arange(K) / K]
        T = [gt[0]]
        for k in range(1, K):
            T.append(exp(rng.normal(0, drift, 6)) @ gt[k] @ np.linalg.inv(gt[k - 1]) @ T[-1])
            ei[s, k - 1], ej[s, k - 1] = k, k - 1
            meas[s, k - 1] = S3(T[k] @ np.linalg.inv(T[k - 1]))
        ei[s, K - 1], ej[s, K - 1] = K - 1, 0
        meas[s, K - 1] = S3(gt[K - 1] @ np.linalg.inv(gt[0]))
        valid[s, :K] = True
        est[s] = np.stack([S3(t) for t in T])
    fixed = np.tile(np.arange(K) == 0, (S, 1))
    return tuple(torch.from_numpy(a) for a in (est, ei, ej, meas, valid, fixed))


def fleet_frames():
    seqs = [generate_sequence(n_frames=N_FLEET, width=320, height=240, seed=10 + s)
            for s in range(2)]
    return (np.stack([q.images[0] for q in seqs]), np.stack([q.depths[0] for q in seqs]),
            np.array([q.timestamps[0] for q in seqs]), np.stack([q.images[1:] for q in seqs]),
            np.stack([q.depths[1:] for q in seqs]), np.stack([q.timestamps[1:] for q in seqs]))


def run_fleet(frames, mesh):
    cfg = SlamConfig(camera=CameraParams.create(**FLEET_CAM), orb=OrbConfig(n_features=300),
                     caps=Capacities(max_keyframes=16, max_points=4096), sensor="rgbd")
    a0, b0, t0, a, b, ts = frames
    fleet = FleetTracker(cfg, n_streams=2, mesh=mesh, device="cpu")
    fleet.initialize(a0, b0, t0)
    poses = fleet.track_chunk(a, b, ts)
    m1 = fleet.stream_map(1)
    return dict(poses=poses, state_ok=fleet.state_ok.copy(), n_kf=fleet.n_keyframes(),
                n_pt=fleet.n_points(), local=fleet.local, first=fleet.first,
                map1=(m1.kf_Tcw.numpy(), m1.pt_pos.numpy(), int(m1.n_kf)),
                traj=np.stack([T for _, T in fleet.trajectories[1]]))


MESHES = {2: [(1, 1), (1, 2), (2, 1)], 4: [(1, 1), (1, 2), (1, 4), (2, 2)]}


def _world_cases(world, workdir):
    """Every case of one world, on this rank; numpy results."""
    out = {"ba": {}, "pg": {}}
    ba, pg = ba_problem(), pose_graph_problem()
    for spec in MESHES[world]:
        mesh = make_mesh(MeshSpec(*spec))
        res = distributed_bundle_adjust(mesh, CAM, *ba, n_iters=4, ur_weight=25.0)
        out["ba"][spec] = (res.kf_Tcw.numpy(), res.pt_pos.numpy())
        S_out, mean = distributed_pose_graph(mesh, *pg, n_iters=10)
        out["pg"][spec] = (S_out.numpy(), mean.numpy())
    rank = torch.distributed.get_rank()
    out["helpers"] = dict(
        rank=rank, coordinator=hosts.is_coordinator(),
        global_shape=hosts.global_mesh(n_map=1).shape,
        draw=int(hosts.fold_in_process(5).integers(0, 1 << 30)))
    try:
        make_mesh(MeshSpec(world, 2))
    except ValueError as e:
        out["helpers"]["too_big"] = str(e)
    if world == 2:
        out["fleet"] = run_fleet(fleet_frames(), make_fleet_mesh(2))
        try:
            FleetTracker(SlamConfig(camera=CameraParams.create(**FLEET_CAM)), n_streams=3,
                         mesh=make_fleet_mesh(2), device="cpu")
        except ValueError as e:
            out["fleet"]["odd"] = str(e)
        from self_commit_orb_slam2_tpu_torch.refine_maps import main

        out["refine_rc"] = main([os.path.join(workdir, "odd.npz"), "--settings",
                                 os.path.join(workdir, "cam.yaml"), "--mesh", "1x2",
                                 "--device", "cpu"])
    return out


def _child(rank, world, workdir, results):
    torch.set_num_threads(1)
    try:
        hosts.initialize(f"file://{os.path.join(workdir, 'rendezvous')}", world, rank,
                         timeout_s=60)
        results.put((rank, "ok", _world_cases(world, workdir)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        hosts.shutdown()


def _run_world(world):
    """Spawn `world` gloo ranks, each running _world_cases; their results in
    rank order.  Past the deadline every child is killed and the test fails."""
    from self_commit_orb_slam2_tpu_torch.models.checkpoint import save_map

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as workdir:
        save_map(os.path.join(workdir, "odd.npz"), empty_map(
            SlamConfig(camera=CAM, caps=Capacities(max_keyframes=4, max_points=99)), "cpu"))
        with open(os.path.join(workdir, "cam.yaml"), "w") as f:
            f.write("%YAML:1.0\nCamera.fx: 300.0\nCamera.fy: 300.0\nCamera.cx: 160.0\n"
                    "Camera.cy: 120.0\nCamera.bf: 30.0\n")
        procs = [ctx.Process(target=_child, args=(r, world, workdir, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + WORLD_DEADLINE_S
        try:
            while len(got) < world:
                try:
                    rank, status, payload = results.get(
                        timeout=max(deadline - time.monotonic(), 0.1))
                except queue.Empty:
                    pytest.fail(f"world of {world} ranks: no result within "
                                f"{WORLD_DEADLINE_S} s from ranks "
                                f"{sorted(set(range(world)) - set(got))}")
                if status != "ok":
                    pytest.fail(f"rank {rank} of {world} failed:\n{payload}")
                got[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=20)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world)]


@pytest.fixture(scope="module")
def world2():
    return _run_world(2)


@pytest.fixture(scope="module")
def world4():
    return _run_world(4)


@pytest.fixture(scope="module")
def world1():
    """The same calls in this process, with no process group."""
    assert not torch.distributed.is_initialized()
    mesh = make_mesh(MeshSpec(1, 1))
    res = distributed_bundle_adjust(mesh, CAM, *ba_problem(), n_iters=4, ur_weight=25.0)
    S_out, mean = distributed_pose_graph(mesh, *pose_graph_problem(), n_iters=10)
    return dict(ba=(res.kf_Tcw.numpy(), res.pt_pos.numpy()), pg=(S_out.numpy(), mean.numpy()))


def _close(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_bundle_adjust_blk_widths_equal_world_1(world, world1, request):
    ranks = request.getfixturevalue(f"world{world}")
    for spec in MESHES[world]:
        for out in ranks:   # every rank returns the whole result
            _close(out["ba"][spec], world1["ba"])


@pytest.mark.parametrize("world", [2, 4])
def test_pose_graph_blk_widths_equal_world_1(world, world1, request):
    ranks = request.getfixturevalue(f"world{world}")
    assert np.all(world1["pg"][1] < 1e-2)
    for spec in MESHES[world]:
        for out in ranks:
            _close(out["pg"][spec], world1["pg"])


def test_members_agree_to_the_bit(world4):
    """all_gather hands every member of a mesh the same bytes."""
    for key in ("ba", "pg"):
        for spec in ((1, 4), (2, 2)):
            for out in world4[1:]:
                for a, b in zip(out[key][spec], world4[0][key][spec]):
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_hosts_helpers(world, request):
    ranks = request.getfixturevalue(f"world{world}")
    assert [o["helpers"]["rank"] for o in ranks] == list(range(world))
    assert [o["helpers"]["coordinator"] for o in ranks] == [True] + [False] * (world - 1)
    assert all(o["helpers"]["global_shape"] == {"map": 1, "blk": world} for o in ranks)
    assert len({o["helpers"]["draw"] for o in ranks}) == world
    assert ranks[0]["helpers"]["draw"] == np.random.default_rng(5).integers(0, 1 << 30)
    assert all(f"needs {2 * world} devices, have {world}" in o["helpers"]["too_big"]
               for o in ranks)


def test_fleet_split_over_two_ranks_equals_world_1(world2):
    ref = run_fleet(fleet_frames(), make_fleet_mesh())
    assert ref["local"] == 2
    for rank, out in enumerate(o["fleet"] for o in world2):
        assert (out["local"], out["first"]) == (1, rank)
        np.testing.assert_allclose(out["poses"], ref["poses"], atol=1e-4)
        np.testing.assert_allclose(out["traj"], ref["traj"], atol=1e-4)
        for f in ("state_ok", "n_kf", "n_pt"):
            np.testing.assert_array_equal(out[f], ref[f])
        for a, b in zip(out["map1"], ref["map1"]):
            np.testing.assert_allclose(a, b, atol=1e-4)
        assert "not divisible by mesh size 2" in out["odd"]
    assert ref["state_ok"].all()


def test_refine_maps_refuses_an_indivisible_point_capacity(world2):
    assert [o["refine_rc"] for o in world2] == [2, 2]
