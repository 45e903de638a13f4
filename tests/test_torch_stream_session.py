"""StreamSession with the loop closer on (mirrors tests/test_stream_session.py).

What a drain consumes is fixed by the chunk count, never by timing or by how
the frames are split between feed() calls, and poll() lands nothing: frames
fed 1, 3, 5 and 7 at a time, with a poll after each feed, give the same
poses, keyframes, loop closures and map as one feed, to the last bit (the
port on the CPU is deterministic).  A second session on the same System
carries on from the first.

The scene: the port streams 36 frames of a spin (the bundled vocabulary,
mapping on), the map then drifts along the chain (15 increments, 15 cm and
8 degrees at the start); a fresh System (loop closing on, consistency 1)
takes that map, re-initializes at frame 0 on it and streams 16 frames, a
second branch that revisits the first keyframes, so a loop closes inside the
stream and its global BA runs and merges; a second session streams 5 more.
"""

import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu_torch.models.config import Capacities, SlamConfig, TrackingConfig
from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
from self_commit_orb_slam2_tpu_torch.ops import bow
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.utils.drift import displace_old_content, se3_increment
from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence, spin_trajectory

torch.set_num_threads(2)   # six test workers share the CPU

N_FIRST, N_SECOND, N_THIRD = 36, 16, 5


def _config():
    return SlamConfig(camera=CameraParams.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                                                 bf=26.0, width=320, height=240),
                      orb=OrbConfig(n_features=500),
                      caps=Capacities(max_keyframes=24, max_points=4096, local_points=512),
                      tracking=TrackingConfig(max_frames_between_kf=3, loop_consistency_th=1),
                      vocab=bow.load_vocabulary(bow.default_vocab_path()))


@pytest.fixture(scope="module")
def world():
    seq = generate_sequence(n_frames=N_FIRST, width=320, height=240, seed=9,
                            trajectory=spin_trajectory(N_FIRST, frames_per_rev=72))
    u8 = (np.clip(seq.images, 0, 255).astype(np.uint8),
          np.clip(seq.depths * 1e3, 0, 65535).astype(np.uint16))
    slam = System(_config(), enable_loop_closing=False, device="cpu")
    slam.track_batch_rgbd(seq.images, seq.depths, seq.timestamps, chunk=4)
    m = slam.map
    newest = int(m.n_kf) - 1
    D = se3_increment([0.01, 0.002, -0.0033, 0.0, 0.0093, 0.0])
    for j in range(15):
        m = displace_old_content(m, D, 1.0, keep_recent=newest - j)
    return seq, u8, m


def _run(world, cuts):
    """The second branch fed in the pieces `cuts` gives, a poll after each;
    then a second session of N_THIRD frames."""
    seq, (imgs, deps), first = world
    slam = System(_config(), device="cpu")
    slam.map = type(first)(*(t.clone() for t in first))
    ts = seq.timestamps + 10.0
    sess = slam.open_stream("rgbd", 4)
    for a, b in zip(cuts[:-1], cuts[1:]):
        sess.feed((imgs[a:b], deps[a:b]), ts[a:b])
        sess.poll()
    poses = sess.finish()
    closures = slam._loop_closer.n_big_changes
    end = N_SECOND + N_THIRD
    sess2 = slam.open_stream("rgbd", 4)
    sess2.feed((imgs[N_SECOND:end], deps[N_SECOND:end]), ts[N_SECOND:end])
    poses2 = sess2.finish()
    return slam, poses, poses2, closures


@pytest.fixture(scope="module")
def runs(world):
    return {"one": _run(world, [0, N_SECOND]), "ragged": _run(world, [0, 1, 4, 9, N_SECOND])}


def test_irregular_feeds_match_one_feed_with_the_closer_on(runs):
    one, ragged = runs["one"], runs["ragged"]
    assert one[3] >= 1, "a loop must close inside the stream"
    assert ragged[3] == one[3]
    np.testing.assert_array_equal(ragged[1], one[1])
    np.testing.assert_array_equal(ragged[2], one[2])
    a, b = one[0], ragged[0]
    assert a.n_keyframes() == b.n_keyframes()
    assert a._loop_closer.debug_log == b._loop_closer.debug_log
    assert a._loop_closer.n_big_changes == b._loop_closer.n_big_changes
    for f, x, y in zip(a.map._fields, a.map, b.map):
        assert torch.equal(x, y), f
    np.testing.assert_array_equal(a.get_trajectory()[1], b.get_trajectory()[1])


def test_sessions_in_sequence_with_the_closer_on(runs, world):
    seq = world[0]
    slam, poses, poses2, _ = runs["one"]
    assert len(poses) == N_SECOND - 1 and len(poses2) == N_THIRD   # frame 0 initializes
    assert slam.state == STATE_OK and slam._loop_closer.pending() == 0
    assert slam._loop_closer.last_gba_info["gba_path"] == "dense"
    ts, est = slam.get_trajectory()
    assert len(ts) == N_SECOND + N_THIRD and np.all(np.isfinite(est))
    # the correction re-bases the carry onto the drifted first branch (its
    # candidate keyframe is the fixed vertex), so the frames after it move
    # with the map: bounded by the drift put in (15 cm at the start)
    assert ate_rmse(np.stack([T for _, T in slam.trajectory]),
                    seq.poses_gt[:N_SECOND + N_THIRD]) < 0.15
