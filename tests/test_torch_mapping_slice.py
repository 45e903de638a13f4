"""The port's second path as a whole against the JAX package: RGB-D
streaming with 8-px cells (the FAST NMS kernel and slab selection) and local
mapping on; loop closing and the vocabulary off.

Both Systems stream the same 21 frames (320x240, 500 features, the bench's
capacities, chunk 4).  Both select keypoints through the slab path here, so
the trajectories are held close: both STATE_OK, the port's ATE < 0.02 m and
within 0.005 m of the JAX package's, per-frame camera centres within 0.01 m,
keyframe counts within one, and one mapping pass per keyframe inserted after
initialization.
"""

import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models import config as jconfig
from self_commit_orb_slam2_tpu.models import system as jsystem
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb
from self_commit_orb_slam2_tpu_torch.models import config, pipeline
from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

# Eager torch on the CPU is thousands of tiny ops: with several test workers
# on one machine, full-width intra-op thread pools only spin against each
# other (these files took 5 to 10 times longer in a 6-worker run).
torch.set_num_threads(2)

W, H, FX, N_FEAT, N_FRAMES = 320, 240, 260.0, 500, 21
CAPS = dict(max_keyframes=64, max_points=16384, local_points=1024)  # bench.py:116
CAM = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=FX * 0.1, width=W, height=H)


def _centres(poses):
    return -np.einsum("nij,ni->nj", poses[:, :3, :3], poses[:, :3, 3])


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(n_frames=N_FRAMES, width=W, height=H, fx=FX, seed=5)


def test_mapping_stream_matches_jax(seq):
    jcfg = jconfig.SlamConfig(camera=JCam.create(**CAM),
                              orb=JOrb(n_features=N_FEAT, cell_size=8),
                              caps=jconfig.Capacities(**CAPS),
                              tracking=jconfig.TrackingConfig(max_frames_between_kf=10))
    jsys = jsystem.System(jcfg, enable_mapping=True, enable_loop_closing=False)
    jsys.track_batch_rgbd(seq.images, seq.depths, seq.timestamps, chunk=4)
    _, jest = jsys.get_trajectory()

    cfg = config.SlamConfig(camera=CameraParams.create(**CAM),
                            orb=OrbConfig(n_features=N_FEAT, cell_size=8),
                            caps=config.Capacities(**CAPS),
                            tracking=config.TrackingConfig(max_frames_between_kf=10))
    slam = System(cfg, enable_mapping=True, enable_loop_closing=False, device="cpu")
    with pipeline.timed_mapping_passes() as pass_s:
        poses = slam.track_batch_rgbd(seq.images, seq.depths, seq.timestamps, chunk=4)
    _, est = slam.get_trajectory()

    assert poses.shape == (N_FRAMES - 1, 4, 4) and est.shape == (N_FRAMES, 4, 4)
    assert jsys.state == 1 and slam.state == STATE_OK
    ate_port = ate_rmse(est, seq.poses_gt)
    ate_jax = ate_rmse(jest, seq.poses_gt)
    assert ate_port < 0.02
    assert abs(ate_port - ate_jax) <= 0.005
    assert np.abs(_centres(est) - _centres(jest)).max() <= 0.01
    assert abs(slam.n_keyframes() - jsys.n_keyframes()) <= 1
    assert slam.n_keyframes() >= 2 and slam.n_points() > 100
    assert len(pass_s) == slam.n_keyframes() - 1 and min(pass_s) > 0
    assert pipeline._pass_s is None  # the timer is off again
