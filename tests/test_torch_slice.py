"""The port's slice as a whole against the JAX package: RGB-D streaming with
local mapping, loop closing and the vocabulary off.

Both Systems stream the same 21 frames (320x240, 500 features, the bench's
capacities, chunk 4).  Tolerances: the JAX package on the CPU selects
keypoints through its slab path, whose tie-break differs from the band path
the port (and the JAX package on a TPU) runs (detect.py:113-115), so the
trajectories are compared loosely: both STATE_OK, the port's ATE < 0.02 m,
ATE within 0.01 m of the JAX package's, per-frame camera centres within
0.02 m.
"""

import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models import config as jconfig
from self_commit_orb_slam2_tpu.models import system as jsystem
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb
from self_commit_orb_slam2_tpu_torch.models import config
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


def test_rgbd_stream_matches_jax(seq, tmp_path):
    jcfg = jconfig.SlamConfig(camera=JCam.create(**CAM), orb=JOrb(n_features=N_FEAT),
                              caps=jconfig.Capacities(**CAPS),
                              tracking=jconfig.TrackingConfig(max_frames_between_kf=10))
    jsys = jsystem.System(jcfg, enable_mapping=False, enable_loop_closing=False)
    jsys.track_batch_rgbd(seq.images, seq.depths, seq.timestamps, chunk=4)
    _, jest = jsys.get_trajectory()

    cfg = config.SlamConfig(camera=CameraParams.create(**CAM),
                            orb=OrbConfig(n_features=N_FEAT),
                            caps=config.Capacities(**CAPS),
                            tracking=config.TrackingConfig(max_frames_between_kf=10))
    slam = System(cfg, enable_mapping=False, enable_loop_closing=False, device="cpu")
    poses = slam.track_batch_rgbd(seq.images, seq.depths, seq.timestamps, chunk=4)
    ts, est = slam.get_trajectory()

    assert poses.shape == (N_FRAMES - 1, 4, 4) and est.shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(ts, seq.timestamps)
    assert jsys.state == 1 and slam.state == STATE_OK
    ate_port = ate_rmse(est, seq.poses_gt)
    ate_jax = ate_rmse(jest, seq.poses_gt)
    assert ate_port < 0.02
    assert abs(ate_port - ate_jax) <= 0.01
    assert np.abs(_centres(est) - _centres(jest)).max() <= 0.02
    assert slam.n_keyframes() >= 2 and slam.n_points() > 100

    # the TUM export reads back as the same trajectory
    from self_commit_orb_slam2_tpu_torch.utils.trajectory import load_tum

    path = tmp_path / "traj.txt"
    slam.save_trajectory_tum(str(path))
    ts_back, Twc = load_tum(str(path))
    np.testing.assert_allclose(ts_back, ts, atol=1e-6)
    np.testing.assert_allclose(Twc[:, :3, 3], _centres(est), atol=1e-5)

    # reset clears the session state; the per-frame API tracks again
    slam.reset()
    assert slam.n_keyframes() == 0 and slam.state == 0
    for i in range(3):
        T = slam.track_rgbd(seq.images[i], seq.depths[i], float(seq.timestamps[i]))
    assert slam.state == STATE_OK
    # the map's world frame is the first camera's
    rel_gt = seq.poses_gt[2] @ np.linalg.inv(seq.poses_gt[0])
    np.testing.assert_allclose(_centres(T[None]), _centres(rel_gt[None]), atol=0.02)
