"""The port's FleetTracker against the JAX package's on two RGB-D streams
(tests/test_parallel.py:252-289's scenario at 2 streams: 320x240, 300
features, 16 keyframes x 4096 points, 1 + 9 frames of generate_sequence
seeds 10 and 11).  The JAX fleet runs on make_fleet_mesh(2) of its
8-virtual-device CPU mesh, the port's on its world of one rank.  Whole
paths on the CPU are compared by outcome (ROADMAP.md C(2)): each stream's
ATE within 0.01 m of the JAX stream's and the same keyframe count +-1; and,
as the JAX test requires, stream 0 within 5e-2 of a solo System."""

import jax
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models.config import Capacities as JCaps
from self_commit_orb_slam2_tpu.models.config import SlamConfig as JConfig
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb
from self_commit_orb_slam2_tpu.parallel.fleet import FleetTracker as JFleet
from self_commit_orb_slam2_tpu.parallel.fleet import make_fleet_mesh as jax_fleet_mesh
from self_commit_orb_slam2_tpu_torch.models.config import Capacities, SlamConfig
from self_commit_orb_slam2_tpu_torch.models.system import System
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.parallel.fleet import FleetTracker, make_fleet_mesh
from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

torch.set_num_threads(2)   # six test workers share the CPU

CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)
N_FRAMES, S = 10, 2


def _ates(poses, seqs):
    return [float(ate_rmse(np.concatenate([np.eye(4, dtype=np.float32)[None], poses[s]]),
                           seqs[s].poses_gt)) for s in range(len(seqs))]


def test_fleet_tracker_matches_jax():
    seqs = [generate_sequence(n_frames=N_FRAMES, width=320, height=240, seed=10 + s)
            for s in range(S)]
    a0 = np.stack([q.images[0] for q in seqs])
    b0 = np.stack([q.depths[0] for q in seqs])
    t0 = np.array([q.timestamps[0] for q in seqs])
    a = np.stack([q.images[1:] for q in seqs])
    b = np.stack([q.depths[1:] for q in seqs])
    ts = np.stack([q.timestamps[1:] for q in seqs])

    jcfg = JConfig(camera=JCam.create(**CAM), orb=JOrb(n_features=300),
                   caps=JCaps(max_keyframes=16, max_points=4096), sensor="rgbd")
    jfleet = JFleet(jcfg, n_streams=S, mesh=jax_fleet_mesh(2))
    jfleet.initialize(a0, b0, t0)
    jposes = jfleet.track_chunk(a, b, ts)
    jax.block_until_ready(jfleet.map)

    cfg = SlamConfig(camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=300),
                     caps=Capacities(max_keyframes=16, max_points=4096), sensor="rgbd")
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_fleet_mesh(2)
    fleet = FleetTracker(cfg, n_streams=S, mesh=make_fleet_mesh(1), device="cpu")
    assert fleet.local == S and fleet.first == 0
    fleet.initialize(a0, b0, t0)
    poses = fleet.track_chunk(a, b, ts)
    assert poses.shape == (S, N_FRAMES - 1, 4, 4) and np.all(np.isfinite(poses))
    assert fleet.state_ok.all() and not fleet.vo.any()
    assert all(len(t) == N_FRAMES for t in fleet.trajectories)

    ates, jates = _ates(poses, seqs), _ates(jposes, seqs)
    assert max(ates) < 0.02, ates
    assert np.all(np.abs(np.subtract(ates, jates)) < 0.01), (ates, jates)
    kf, jkf = fleet.n_keyframes(), np.asarray(jfleet.n_keyframes())
    assert np.all(np.abs(kf - jkf) <= 1), (kf, jkf)
    assert np.all(kf >= 1) and np.all(fleet.n_points() > 0)

    # stream 0 agrees with a solo System on the same frames (the JAX test's bar)
    solo = System(cfg, enable_loop_closing=False, device="cpu")
    solo.track_batch_rgbd(seqs[0].images, seqs[0].depths, seqs[0].timestamps)
    _, est_solo = solo.get_trajectory()
    est0 = np.concatenate([np.eye(4, dtype=np.float32)[None], poses[0]])
    n = min(len(est_solo), len(est0))
    assert np.abs(est_solo[:n] - est0[:n]).max() < 5e-2
    # stream_map is a copy of the stream's map
    m1 = fleet.stream_map(1)
    assert int(m1.n_kf) == int(kf[1])
    m1.kf_Tcw.zero_()
    assert fleet.maps[1].kf_Tcw.abs().sum() > 0
