"""A fleet stream that loses tracking mid-run (blank frames) relocalizes
through the shared in-stream pipeline while the other stream is unaffected
(tests/test_parallel.py:403-471's scenario and bars, which the JAX package
marks slow, through the port on the CPU at a world of one rank; reference:
Tracking falls back to Relocalization whenever LOST, src/Tracking.cc:523-629,
:2030)."""

import numpy as np
import torch

from self_commit_orb_slam2_tpu_torch.models.config import Capacities, SlamConfig, TrackingConfig
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.parallel.fleet import FleetTracker
from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence
from tests.test_torch_fleet_serving import CAM, train_vocab

torch.set_num_threads(2)   # six test workers share the CPU


def test_fleet_stream_loss_recovery():
    n, S, B = 33, 2, 8
    seqs = [generate_sequence(n_frames=n, width=320, height=240, seed=20 + s)
            for s in range(S)]
    vocab = train_vocab([q.images[i] for q in seqs for i in range(0, n, 8)], seed=4)
    cfg = SlamConfig(camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=400),
                     caps=Capacities(max_keyframes=24, max_points=8192, local_points=1024),
                     tracking=TrackingConfig(max_frames_between_kf=6),
                     sensor="rgbd", vocab=vocab)
    fleet = FleetTracker(cfg, n_streams=S, device="cpu")
    fleet.initialize(np.stack([q.images[0] for q in seqs]),
                     np.stack([q.depths[0] for q in seqs]),
                     np.array([q.timestamps[0] for q in seqs]))

    def chunk(lo, hi, blank_stream=None):
        a = np.stack([q.images[lo:hi] for q in seqs]).copy()
        b = np.stack([q.depths[lo:hi] for q in seqs]).copy()
        ts = np.stack([q.timestamps[lo:hi] for q in seqs])
        if blank_stream is not None:
            a[blank_stream] = 0.0
            b[blank_stream] = 0.0
        return a, b, ts

    poses = [fleet.track_chunk(*chunk(1, 1 + B))]
    poses.append(fleet.track_chunk(*chunk(1 + B, 1 + 2 * B, blank_stream=1)))
    assert fleet.state_ok[0], "healthy stream lost tracking"
    assert not fleet.state_ok[1], "blanked stream still claims OK"
    poses.append(fleet.track_chunk(*chunk(1 + 2 * B, 1 + 3 * B)))
    poses.append(fleet.track_chunk(*chunk(1 + 3 * B, 1 + 4 * B)))
    assert fleet.state_ok.all(), "stream did not recover after frames returned"

    all_poses = np.concatenate(poses, axis=1)  # [S, 4B, 4, 4]
    est0 = np.concatenate([np.eye(4, dtype=np.float32)[None], all_poses[0]])
    assert ate_rmse(est0, seqs[0].poses_gt[: len(est0)]) < 0.02
    # the recovered stream, over the non-blank frames: the relocalization
    # must return it to its own map's frame
    keep = np.concatenate([np.arange(0, 1 + B), np.arange(1 + 2 * B, 1 + 4 * B)])
    est1 = np.concatenate([np.eye(4, dtype=np.float32)[None], all_poses[1]])
    assert ate_rmse(est1[keep], seqs[1].poses_gt[keep]) < 0.05
