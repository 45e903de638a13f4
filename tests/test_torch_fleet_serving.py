"""The port's FleetTracker serving a prebuilt map: localization bring-up by
relocalization and frozen-map tracking (tests/test_parallel.py:336-400's
scenario and bars, through the port on the CPU at a world of one rank).
The vocabulary is trained as the JAX test trains its own (k=8, L=3, seed 2,
every fourth frame's descriptors), from the port's extract."""

import numpy as np
import torch

from self_commit_orb_slam2_tpu_torch.models.config import Capacities, SlamConfig, TrackingConfig
from self_commit_orb_slam2_tpu_torch.models.system import System
from self_commit_orb_slam2_tpu_torch.ops import bow
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig, extract
from self_commit_orb_slam2_tpu_torch.parallel.fleet import FleetTracker, make_fleet_mesh
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

torch.set_num_threads(2)   # six test workers share the CPU

CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)


def train_vocab(images, seed):
    descs = []
    for img in images:
        f = extract(torch.from_numpy(img.astype(np.float32)), OrbConfig(n_features=300))
        descs.append(f.desc[f.valid].numpy().view(np.uint32))
    return bow.train_vocabulary(np.concatenate(descs), k=8, L=3, seed=seed)


def test_fleet_localization_serving():
    """Streams relocalize their first frame against a PREBUILT map and track
    it frozen (no keyframes or points added)."""
    seq = generate_sequence(n_frames=20, width=320, height=240, seed=5)
    vocab = train_vocab(seq.images[0:20:4], seed=2)
    cfg = SlamConfig(camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=500),
                     caps=Capacities(max_keyframes=32, max_points=8192, local_points=1024),
                     tracking=TrackingConfig(max_frames_between_kf=8),
                     sensor="rgbd", vocab=vocab)
    builder = System(cfg, device="cpu")
    for i in range(16):
        builder.track_rgbd(seq.images[i], seq.depths[i], float(i) / 30.0)
    m = builder.map
    n_kf = builder.n_keyframes()
    n_live_pt = int(m.pt_valid.sum())

    starts = [4, 8]
    fleet = FleetTracker(cfg, n_streams=2, mesh=make_fleet_mesh(), localization_only=True,
                         device="cpu")
    ok = fleet.initialize_localization(m, np.stack([seq.images[s] for s in starts]),
                                       np.stack([seq.depths[s] for s in starts]),
                                       np.array([0.0, 0.0]))
    assert ok.all(), "relocalization bring-up failed"
    # initial poses match the ground truth in the map's world frame (the
    # builder's first camera)
    T0_inv = np.linalg.inv(seq.poses_gt[0])
    for i, s in enumerate(starts):
        T0 = fleet.trajectories[i][0][1]
        expect = seq.poses_gt[s] @ T0_inv
        assert np.linalg.norm(T0[:3, 3] - expect[:3, 3]) < 0.05

    B = 6
    a = np.stack([seq.images[s + 1: s + 1 + B] for s in starts])
    b = np.stack([seq.depths[s + 1: s + 1 + B] for s in starts])
    ts = np.stack([np.arange(1, B + 1) / 30.0 for _ in starts])
    poses = fleet.track_chunk(a, b, ts)
    for i, s in enumerate(starts):
        for j in range(B):
            expect = seq.poses_gt[s + 1 + j] @ T0_inv
            err = np.linalg.norm(poses[i, j][:3, 3] - expect[:3, 3])
            assert err < 0.05, (i, j, err)
    # frozen map: no keyframes or points added on any stream, and the
    # builder's map untouched by the streams
    assert np.all(fleet.n_keyframes() == n_kf)
    assert all(int(fleet.stream_map(s).pt_valid.sum()) == n_live_pt for s in range(2))
    assert fleet.state_ok.all()
    assert builder.map.kf_Tcw.data_ptr() != fleet.maps[0].kf_Tcw.data_ptr()
