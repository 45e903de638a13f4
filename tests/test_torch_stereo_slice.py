"""The port's stereo path as a whole against the JAX package: raw stereo
pairs with a small mounting rotation in each eye, rectified on the device
(SlamConfig.rect_maps), matched along rows and streamed through
track_batch_stereo; loop closing and the vocabulary off in both.

The scenario of tests/test_rectify.py::test_on_device_rectified_stereo_tracking:
14 pairs at 320x240, 500 features.  On the CPU the JAX package selects
keypoints through its slab path and the port through the band path, so the
trajectories are compared loosely: both STATE_OK, ATE < 0.05 m in both and
within 0.01 m of each other, camera centres within 0.02 m, keyframes within
one.  Inside the port the per-frame API (track_stereo: make_frame_stereo) and
the streamed one (make_frames_stereo_batch, chunk 4) build the same frames
and must give the same poses within 1e-4.
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
from self_commit_orb_slam2_tpu_torch.utils.synthetic import euroc_like_sequence

# Eager torch on the CPU is thousands of tiny ops: with several test workers
# on one machine, full-width intra-op thread pools only spin against each
# other (these files took 5 to 10 times longer in a 6-worker run).
torch.set_num_threads(2)

W, H, FX, BASELINE, N = 320, 240, 260.0, 0.1, 14
CAM = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=FX * BASELINE, width=W, height=H)
CAPS = dict(max_keyframes=32, max_points=8192, local_points=512)


def _centres(poses):
    return -np.einsum("nij,ni->nj", poses[:, :3, :3], poses[:, :3, 3])


@pytest.fixture(scope="module")
def raw():
    """(sequence of raw eyes, numpy rect_maps): the rotations of the JAX
    package's test."""
    return euroc_like_sequence(N, W, H, FX, BASELINE, seed=7,
                               rot_l=(0.006, -0.012, 0.004), rot_r=(-0.008, 0.009, -0.003))


def _port_config(rect_maps):
    return config.SlamConfig(
        camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=500),
        caps=config.Capacities(**CAPS),
        tracking=config.TrackingConfig(max_frames_between_kf=6),
        sensor="stereo", rect_maps=rect_maps)


@pytest.fixture(scope="module")
def streamed(raw):
    seq, rect_maps = raw
    slam = System(_port_config(rect_maps), enable_loop_closing=False, device="cpu")
    poses = slam.track_batch_stereo(seq.images, seq.right_images, seq.timestamps)
    return slam, poses


def test_rectified_stereo_stream_matches_jax(raw, streamed):
    seq, rect_maps = raw
    jcfg = jconfig.SlamConfig(
        camera=JCam.create(**CAM), orb=JOrb(n_features=500),
        caps=jconfig.Capacities(**CAPS),
        tracking=jconfig.TrackingConfig(max_frames_between_kf=6),
        sensor="stereo", rect_maps=rect_maps)
    jsys = jsystem.System(jcfg, enable_loop_closing=False)
    jsys.track_batch_stereo(seq.images, seq.right_images, seq.timestamps)
    _, jest = jsys.get_trajectory()

    slam, poses = streamed
    _, est = slam.get_trajectory()
    assert poses.shape == (N - 1, 4, 4) and est.shape == (N, 4, 4)
    # the numpy maps of the configuration went to the engine's device once
    assert all(isinstance(m, torch.Tensor) and m.dtype == torch.float32
               for m in slam.config.rect_maps)
    assert jsys.state == 1 and slam.state == STATE_OK
    ate_port, ate_jax = ate_rmse(est, seq.poses_gt), ate_rmse(jest, seq.poses_gt)
    assert ate_port < 0.05 and ate_jax < 0.05
    assert abs(ate_port - ate_jax) <= 0.01
    assert np.abs(_centres(est) - _centres(jest)).max() <= 0.02
    assert abs(slam.n_keyframes() - jsys.n_keyframes()) <= 1
    assert slam.n_keyframes() >= 2 and slam.n_points() > 100
    # stereo depth on a fair share of the last frame's keypoints, as in the JAX package
    share = float(slam.carry.last_frame.has_depth().sum() / slam.carry.last_frame.valid.sum())
    jshare = float(jsys.carry.last_frame.has_depth().sum() / jsys.carry.last_frame.valid.sum())
    assert share > 0.25 and abs(share - jshare) < 0.1


def test_per_frame_stereo_equals_streamed(raw, streamed):
    seq, rect_maps = raw
    slam = System(_port_config(rect_maps), enable_loop_closing=False, device="cpu")
    q = lambda a: np.clip(a, 0, 255).astype(np.uint8)  # noqa: E731  (as the stream packs them)
    for i in range(N):
        slam.track_stereo(q(seq.images[i]), q(seq.right_images[i]), float(seq.timestamps[i]))
    assert slam.state == STATE_OK
    _, est = slam.get_trajectory()
    _, est_s = streamed[0].get_trajectory()
    np.testing.assert_allclose(est, est_s, atol=1e-4)
    assert slam.n_keyframes() == streamed[0].n_keyframes()


def test_unrectified_raw_eyes_lose_depth(raw):
    """Without rect_maps the rotated eyes are not row-aligned: the matcher
    finds far fewer depths, which is what makes the maps load-bearing."""
    seq, rect_maps = raw
    from self_commit_orb_slam2_tpu_torch.models.frame import make_frame_stereo

    il = torch.from_numpy(np.clip(seq.images[0], 0, 255).astype(np.float32))
    ir = torch.from_numpy(np.clip(seq.right_images[0], 0, 255).astype(np.float32))
    with_maps = make_frame_stereo(_port_config(rect_maps), il, ir)
    without = make_frame_stereo(_port_config(None), il, ir)
    assert int(with_maps.has_depth().sum()) > 1.5 * int(without.has_depth().sum())
