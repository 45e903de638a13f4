"""The port's byte-stream driver against the JAX package's: the wire
records byte for byte, serve against a track_* loop (as
tests/test_stream.py:35-61 checks it, its stereo case with a rectifier), the
CLI over stdin and stdout; and the trajectory writers against the JAX
writers.  Within the port the CPU is deterministic, so serve equals the
loop to the bit."""

import io
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu import stream_slam as jstream_slam
from self_commit_orb_slam2_tpu.utils import trajectory as jtrajectory
from self_commit_orb_slam2_tpu_torch import stream_slam
from self_commit_orb_slam2_tpu_torch.models.config import Capacities, SlamConfig, TrackingConfig
from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.utils import trajectory
from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse
from self_commit_orb_slam2_tpu_torch.utils.rectify import StereoRectifier
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

torch.set_num_threads(2)   # six test workers share the CPU


def _read_tum_cw(path):
    _, Twc = trajectory.load_tum(path)
    return np.linalg.inv(Twc)


@pytest.mark.parametrize("sensor", ["mono", "stereo", "rgbd"])
def test_stream_records_byte_equal(rng, sensor):
    img = rng.uniform(-5, 260, (48, 64)).astype(np.float32)
    second = (rng.uniform(0.5, 70.0, (48, 64)) if sensor == "rgbd"
              else rng.uniform(0, 255, (48, 64))).astype(np.float32)
    arrays = (img,) if sensor == "mono" else (img, second)
    ours, theirs = io.BytesIO(), io.BytesIO()
    stream_slam.write_frame(ours, sensor, 1.25, *arrays)
    jstream_slam.write_frame(theirs, sensor, 1.25, *arrays)
    assert ours.getvalue() == theirs.getvalue() and ours.getvalue()[:4] == b"SLFR"
    ours.seek(0)
    theirs.seek(0)
    a, b = stream_slam.read_frame(ours), jstream_slam.read_frame(theirs)
    assert a[:2] == b[:2] == (sensor, 1.25)
    for x, y in zip(a[2], b[2]):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)
    assert stream_slam.read_frame(ours) is None
    T = rng.normal(size=(4, 4))
    ours, theirs = io.BytesIO(), io.BytesIO()
    stream_slam.write_pose(ours, 2.5, STATE_OK, T)
    jstream_slam.write_pose(theirs, 2.5, STATE_OK, T)
    assert ours.getvalue() == theirs.getvalue() and ours.getvalue()[:4] == b"SLPO"
    ours.seek(0)
    ts, state, Tcw = stream_slam.read_pose(ours)
    assert (ts, state) == (2.5, STATE_OK)
    np.testing.assert_array_equal(Tcw, T.astype(np.float32))
    with pytest.raises(ValueError, match="magic"):
        stream_slam.read_frame(io.BytesIO(b"XXXX" + ours.getvalue()))


def _small_config(sensor):
    return SlamConfig(camera=CameraParams.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                                                 bf=26.0, width=320, height=240),
                      orb=OrbConfig(n_features=300),
                      caps=Capacities(max_keyframes=16, max_points=4096, local_points=512),
                      tracking=TrackingConfig(max_frames_between_kf=3), sensor=sensor)


@pytest.mark.parametrize("sensor", ["rgbd", "stereo"])
def test_serve_equals_a_track_loop(sensor):
    """serve() tracks what it reads exactly as the per-frame API does; the
    stereo case with a rectifier (identity maps, the reference ros_stereo.cc
    do_rectify mode)."""
    n = 4
    seq = generate_sequence(n_frames=n, width=320, height=240, seed=5, stereo_baseline=0.1)
    frames = io.BytesIO()
    for i in range(n):
        second = seq.depths[i] if sensor == "rgbd" else seq.right_images[i]
        stream_slam.write_frame(frames, sensor, float(seq.timestamps[i]), seq.images[i], second)
    rect = None
    if sensor == "stereo":
        K = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]])
        ident = {"K": K, "D": np.zeros(4), "R": np.eye(3),
                 "P": np.concatenate([K, np.zeros((3, 1))], 1)}
        rect = StereoRectifier(ident, ident, 320, 240)
    frames.seek(0)
    poses = io.BytesIO()
    slam = System(_small_config(sensor), enable_loop_closing=False, device="cpu")
    assert stream_slam.serve(slam, frames, poses, rectifier=rect) == n
    assert slam.state == STATE_OK
    poses.seek(0)
    recs = []
    while (r := stream_slam.read_pose(poses)) is not None:
        recs.append(r)
    frames.seek(0)
    ref = System(_small_config(sensor), enable_loop_closing=False, device="cpu")
    track = ref.track_rgbd if sensor == "rgbd" else ref.track_stereo
    for (ts, state, Tcw), (_, t, arrays) in zip(recs, iter(lambda: stream_slam.read_frame(
            frames), None)):
        if rect is not None:
            arrays = rect.rectify(*arrays)
        want = track(*arrays, t)
        assert ts == t and state == ref.state == STATE_OK
        np.testing.assert_array_equal(Tcw, want.astype(np.float32))
    assert len(recs) == n
    frames.seek(0)
    assert stream_slam.serve(slam, frames, max_frames=2) == 2


def test_stream_slam_main_over_stdin(tmp_path, monkeypatch):
    """The CLI: SLFR records on stdin, SLPO records on stdout, a TUM file at
    exit; the wire's millimetres are tracked as metres whatever the
    settings' DepthMapFactor says."""
    seq = generate_sequence(n_frames=4, width=320, height=240, seed=5)
    (tmp_path / "TUM1.yaml").write_text(
        "%YAML:1.0\nCamera.fx: 260.0\nCamera.fy: 260.0\nCamera.cx: 160.0\nCamera.cy: 120.0\n"
        "Camera.width: 320\nCamera.height: 240\nCamera.bf: 26.0\nDepthMapFactor: 5000.0\n"
        "ORBextractor.nFeatures: 300\n")
    frames = io.BytesIO()
    for i in range(4):
        stream_slam.write_frame(frames, "rgbd", float(seq.timestamps[i]), seq.images[i],
                                seq.depths[i])
    frames.seek(0)
    out = io.BytesIO()
    monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=frames))
    monkeypatch.setattr(sys, "stdout", SimpleNamespace(buffer=out, write=lambda s: None,
                                                       flush=lambda: None))
    assert stream_slam.main(["--settings", str(tmp_path / "TUM1.yaml"), "--device", "cpu",
                             "--poses", "--output", str(tmp_path / "s.txt")]) == 0
    out.seek(0)
    recs = []
    while (r := stream_slam.read_pose(out)) is not None:
        recs.append(r)
    assert [r[1] for r in recs] == [STATE_OK] * 4
    est = _read_tum_cw(tmp_path / "s.txt")
    assert ate_rmse(est, seq.poses_gt[:4]) < 0.01


def test_trajectory_writers_match_jax(tmp_path, rng):
    """save_kitti is the JAX writer's text; the keyframe trajectory holds the
    live keyframes' timestamps and poses, as the JAX System writes them."""
    from self_commit_orb_slam2_tpu_torch.ops import se3

    poses = se3.se3_exp(torch.from_numpy(rng.normal(0, 0.3, (6, 6)).astype(np.float32))).numpy()
    trajectory.save_kitti(str(tmp_path / "a.kitti"), poses)
    jtrajectory.save_kitti(str(tmp_path / "b.kitti"), poses)
    assert (tmp_path / "a.kitti").read_text() == (tmp_path / "b.kitti").read_text()

    seq = generate_sequence(n_frames=7, width=320, height=240, seed=5)
    slam = System(_small_config("rgbd"), enable_loop_closing=False, device="cpu")
    slam.track_batch_rgbd(seq.images, seq.depths, seq.timestamps)
    assert slam.n_keyframes() >= 2
    slam.save_keyframe_trajectory_tum(str(tmp_path / "kf.txt"))
    valid = slam.map.kf_valid.numpy()
    jtrajectory.save_tum(str(tmp_path / "kf_jax.txt"), slam.map.kf_timestamp.numpy()[valid],
                         slam.map.kf_Tcw.numpy()[valid])
    a, b = np.loadtxt(tmp_path / "kf.txt"), np.loadtxt(tmp_path / "kf_jax.txt")
    assert a.shape == (slam.n_keyframes(), 8)
    np.testing.assert_allclose(a, b, atol=2e-7)
    slam.save_trajectory_kitti(str(tmp_path / "t.kitti"))
    jtrajectory.save_kitti(str(tmp_path / "t_jax.kitti"), slam.get_trajectory()[1])
    assert (tmp_path / "t.kitti").read_text() == (tmp_path / "t_jax.kitti").read_text()
