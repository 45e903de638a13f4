"""The rest of the port's public API: System.warm_start, the unpacked
pipeline steps, LocalMapper, timings, last_obs_pt / last_frame, and the
viewer against the JAX package's on the same state.

warm_start must change nothing a stream computes: after it the map, the
carry, the trajectory and the four random streams are bit-equal to an
unprimed System's (the CPU is deterministic).  The unpacked steps are the
packed path without the packing, so they too are bit-equal.  The viewer is
numpy on both sides: the same map and trajectory give the same pixels."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models import map_state as jms
from self_commit_orb_slam2_tpu.utils import viewer as jviewer
from self_commit_orb_slam2_tpu_torch.convert import state_to_numpy
from self_commit_orb_slam2_tpu_torch.models import local_mapping, pipeline
from self_commit_orb_slam2_tpu_torch.models.config import Capacities, SlamConfig, TrackingConfig
from self_commit_orb_slam2_tpu_torch.models.frame import make_frame_rgbd
from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
from self_commit_orb_slam2_tpu_torch.ops import bow
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.utils import viewer
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

torch.set_num_threads(2)   # six test workers share the CPU

N = 9


def _config(sensor="rgbd", vocab=None):
    return SlamConfig(camera=CameraParams.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                                                 bf=26.0, width=320, height=240),
                      orb=OrbConfig(n_features=300),
                      caps=Capacities(max_keyframes=16, max_points=4096, local_points=512),
                      tracking=TrackingConfig(max_frames_between_kf=3), sensor=sensor,
                      vocab=vocab)


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(n_frames=N, width=320, height=240, fx=260.0, seed=5,
                             stereo_baseline=0.1)


@pytest.fixture(scope="module")
def vocab():
    return bow.load_vocabulary(bow.default_vocab_path())


def _assert_tuples_equal(a, b, what):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if hasattr(x, "_fields"):
            _assert_tuples_equal(x, y, f"{what}.{name}")
        else:
            assert torch.equal(x, y), f"{what}.{name}"


def _stream(slam, seq, sensor):
    if sensor == "rgbd":
        return slam.track_batch_rgbd(seq.images, seq.depths, seq.timestamps)
    return slam.track_batch_stereo(seq.images, seq.right_images, seq.timestamps)


@pytest.mark.parametrize("sensor", ["rgbd", "stereo"])
def test_warm_start_leaves_the_stream_bit_equal(seq, vocab, sensor):
    runs = []
    for primed in (False, True):
        slam = System(_config(sensor, vocab), device="cpu")
        assert slam._loop_closer.enabled
        if primed:
            slam.warm_start()
            assert slam.carry is None and slam.trajectory == [] and slam.n_keyframes() == 0
        poses = _stream(slam, seq, sensor)
        runs.append((slam, poses))
    (a, pa), (b, pb) = runs
    assert a.state == b.state == STATE_OK and a.n_keyframes() >= 2
    np.testing.assert_array_equal(pa, pb)
    _assert_tuples_equal(a.map, b.map, "map")
    _assert_tuples_equal(a.carry, b.carry, "carry")
    ta, tb = a.get_trajectory(), b.get_trajectory()
    np.testing.assert_array_equal(ta[0], tb[0])
    np.testing.assert_array_equal(ta[1], tb[1])
    for gen in ("_stream_gen", "_reloc_gen", "_mono_gen", "_loop_gen"):
        assert torch.equal(getattr(a, gen).get_state(), getattr(b, gen).get_state()), gen
    assert a._loop_closer.n_big_changes == b._loop_closer.n_big_changes


def _initialized(seq, sensor="rgbd"):
    """A map and carry after the first frame, and the config."""
    cfg = _config(sensor)
    slam = System(cfg, enable_loop_closing=False, device="cpu")
    if sensor == "rgbd":
        slam.track_rgbd(seq.images[0], seq.depths[0], 0.0)
    else:
        slam.track_stereo(seq.images[0], seq.right_images[0], 0.0)
    return cfg, slam.map, slam.carry


def _clone(state):
    return type(state)(*(_clone(x) if hasattr(x, "_fields") else x.clone() for x in state))


@pytest.mark.parametrize("sensor", ["rgbd", "stereo"])
def test_unpacked_batch_steps_equal_the_packed_path(seq, sensor):
    cfg, m, carry = _initialized(seq, sensor)
    u8 = np.clip(seq.images[1:5], 0, 255).astype(np.uint8)
    ts = seq.timestamps[1:5].astype(np.float32)
    valid = np.array([True, True, True, False])
    if sensor == "rgbd":
        second = np.clip(seq.depths[1:5] * 1e3, 0, 65535).astype(np.uint16)
        buf = pipeline.pack_rgbd_chunk(u8, second, ts, valid)
        want = pipeline.batch_steps_rgbd_packed(cfg, _clone(m), _clone(carry),
                                                torch.from_numpy(buf))
        got = pipeline.batch_steps_rgbd(cfg, _clone(m), _clone(carry), torch.from_numpy(u8),
                                        torch.from_numpy(second.astype(np.int32)),
                                        torch.from_numpy(ts), torch.from_numpy(valid))
    else:
        second = np.clip(seq.right_images[1:5], 0, 255).astype(np.uint8)
        buf = pipeline.pack_stereo_chunk(u8, second, ts, valid)
        want = pipeline.batch_steps_stereo_packed(cfg, _clone(m), _clone(carry),
                                                  torch.from_numpy(buf))
        got = pipeline.batch_steps_stereo(cfg, _clone(m), _clone(carry), torch.from_numpy(u8),
                                          torch.from_numpy(second), torch.from_numpy(ts),
                                          torch.from_numpy(valid))
    _assert_tuples_equal(got[0], want[0], "map")
    _assert_tuples_equal(got[1], want[1], "carry")
    assert torch.equal(got[2], want[2])
    infos = pipeline.unpack_infos(got[2].numpy())
    assert infos.state_ok[:3].all() and not infos.created_kf[3]


@pytest.mark.parametrize("depth_kind", ["metres", "millimetres"])
def test_step_rgbd_equals_track_step(seq, depth_kind):
    cfg, m, carry = _initialized(seq)
    img = torch.from_numpy(seq.images[1].astype(np.float32))
    depth_m = torch.from_numpy(seq.depths[1].astype(np.float32))
    mm = np.clip(seq.depths[1] * 1e3, 0, 65535).astype(np.uint16)
    if depth_kind == "millimetres":
        depth = torch.from_numpy(mm.astype(np.int32))
        depth_m = torch.from_numpy(mm.astype(np.float32)) * torch.tensor(1e-3)
    else:
        depth = depth_m
    frame = make_frame_rgbd(cfg, img, depth_m)
    want = pipeline.track_step(cfg, _clone(m), _clone(carry), frame, torch.tensor(0.1))
    got = pipeline.step_rgbd(cfg, _clone(m), _clone(carry), img, depth,
                             torch.tensor(0.1))
    _assert_tuples_equal(got[0], want[0], "map")
    _assert_tuples_equal(got[1], want[1], "carry")
    _assert_tuples_equal(got[2], want[2], "info")


def test_local_mapper_process_equals_process(seq):
    cfg, m, _ = _initialized(seq)
    want = local_mapping._process(cfg, _clone(m), torch.tensor(0, dtype=torch.int32))
    mapper = local_mapping.LocalMapper(cfg)
    assert mapper.config is cfg
    _assert_tuples_equal(mapper.process(_clone(m), 0), want, "map")


def test_timings_last_obs_and_last_frame(seq):
    """timings: one entry per track_* call; a batch's time spread over the
    frames it returns (the first frame of a new map initializes through the
    per-frame path and is not among them), as in the JAX System."""
    slam = System(_config(), enable_loop_closing=False, device="cpu")
    assert slam.last_obs_pt is None and slam.last_frame is None and slam.timings == []
    for i in range(3):
        slam.track_rgbd(seq.images[i], seq.depths[i], float(seq.timestamps[i]))
    assert len(slam.timings) == 3 and all(t > 0 for t in slam.timings)
    assert slam.last_frame is slam.carry.last_frame
    assert torch.equal(slam.last_obs_pt, slam.carry.last_obs_pt)
    assert int((slam.last_obs_pt >= 0).sum()) > 50
    assert slam.last_frame.xy.shape[0] == slam.last_obs_pt.shape[0] == 384
    poses = slam.track_batch_rgbd(seq.images[3:], seq.depths[3:], seq.timestamps[3:])
    assert len(poses) == N - 3 and len(slam.timings) == N
    fresh = System(_config(), enable_loop_closing=False, device="cpu")
    fresh.track_batch_rgbd(seq.images, seq.depths, seq.timestamps)
    assert len(fresh.timings) == N - 1
    slam.reset()
    assert slam.last_frame is None and len(slam.timings) == N


def _jax_side(slam):
    """The port System's map as the JAX viewer reads it."""
    arrays, _ = state_to_numpy(slam.map)
    return SimpleNamespace(map=jms.MapState(**arrays), get_trajectory=slam.get_trajectory)


def test_viewer_matches_jax(seq):
    slam = System(_config(), enable_loop_closing=False, device="cpu")
    slam.track_batch_rgbd(seq.images, seq.depths, seq.timestamps)
    got = viewer.render_system(slam)
    want = jviewer.render_system(_jax_side(slam))
    assert got.shape == (512, 512, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got == viewer.RED).all(-1).sum() >= 9 * slam.n_keyframes() // 2
    frame = slam.last_frame
    xy, valid = frame.xy.numpy(), frame.valid.numpy()
    tracked = slam.last_obs_pt.numpy() >= 0
    np.testing.assert_array_equal(viewer.draw_frame(seq.images[-1], xy, valid, tracked),
                                  jviewer.draw_frame(seq.images[-1], xy, valid, tracked))
    empty = System(_config(), enable_loop_closing=False, device="cpu")
    np.testing.assert_array_equal(viewer.render_system(empty),
                                  jviewer.render_system(_jax_side(empty)))
