"""The port's monocular path against the JAX package: the two-view bootstrap
(models/mono_init.try_initialize) on the same two frames with the same RANSAC
sets, then whole runs per frame and through track_batch_mono.

try_initialize: both packages get the JAX package's doubled-budget bootstrap
frames as numpy and the minimal sets the JAX package draws from its key
(`_sample_minimal_sets(split(key)[0], ...)` over the match mask, which is
integer work and identical).  Every integer field of the resulting map is
exact; poses within 1e-4 and points within 1e-3 (the fp32 sums of the
two-view solvers and of the 15 BA iterations run in another order).  A failed
attempt returns the map it was given, untouched (the JAX package selects it
in the graph; the port reads the flag on the host and returns early).

Whole runs (tests/test_slam_mono.py's 320x240 / 700-feature configuration, 24
frames): the port draws its sets from a torch.Generator, the JAX package from
jax.random, so outcomes are compared: both initialize, the initialization
lag within 2 frames of each other, STATE_OK, Sim3-aligned ATE < 0.06 m in
both and within 0.02 m of each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models import config as jconfig
from self_commit_orb_slam2_tpu.models import frame as jframe
from self_commit_orb_slam2_tpu.models import map_state as jms
from self_commit_orb_slam2_tpu.models import mono_init as jmono
from self_commit_orb_slam2_tpu.models import system as jsystem
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.matching import core as jcore
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb
from self_commit_orb_slam2_tpu.ops.solvers import two_view as jtv
from self_commit_orb_slam2_tpu_torch import convert
from self_commit_orb_slam2_tpu_torch.models import config, map_state, mono_init
from self_commit_orb_slam2_tpu_torch.models.system import (STATE_NOT_INITIALIZED, STATE_OK,
                                                           System)
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

# Eager torch on the CPU is thousands of tiny ops: with several test workers
# on one machine, full-width intra-op thread pools only spin against each
# other (these files took 5 to 10 times longer in a 6-worker run).
torch.set_num_threads(2)

N_FRAMES, N_FEAT = 24, 700
CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=0.0, width=320, height=240)
CAPS = dict(max_keyframes=32, max_points=8192, local_points=1024)
TRACK = dict(max_frames_between_kf=8, kf_ref_ratio_stereo=0.8)


def _configs(n_features=N_FEAT):
    jcfg = jconfig.SlamConfig(camera=JCam.create(**CAM), orb=JOrb(n_features=n_features),
                              caps=jconfig.Capacities(**CAPS),
                              tracking=jconfig.TrackingConfig(**TRACK), sensor="mono")
    cfg = config.SlamConfig(camera=CameraParams.create(**CAM),
                            orb=OrbConfig(n_features=n_features),
                            caps=config.Capacities(**CAPS),
                            tracking=config.TrackingConfig(**TRACK), sensor="mono")
    return jcfg, cfg


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(n_frames=N_FRAMES, width=320, height=240, seed=5)


@pytest.fixture(scope="module")
def bootstrap_frames(seq):
    """Frames 0 to 3 with the doubled feature budget, from the JAX package."""
    jcfg, _ = _configs(2 * N_FEAT)
    make = jax.jit(lambda img: jframe.make_frame_mono(jcfg, img))
    q = lambda a: jnp.asarray(np.clip(a, 0, 255).astype(np.uint8), jnp.float32)  # noqa: E731
    return [make(q(seq.images[i])) for i in range(4)]


def _jax_sets(f1, f2, key):
    """The minimal sets the JAX package's try_initialize draws for (f1, f2)."""
    wmask = jcore.window_mask(f1.xy, f2.xy, jnp.full(f1.capacity, 100.0))
    l0 = (f1.level == 0)[:, None] & (f2.level == 0)[None, :]
    match = jcore.mutual_best_match(f1.desc, f2.desc, wmask & l0, f1.valid, f2.valid,
                                    max_dist=jcore.TH_LOW, ratio=0.9)
    valid = jcore.rotation_consistency_mask(f1.angle, f2.angle, match)
    sets = jtv._sample_minimal_sets(jax.random.split(key)[0], f1.capacity, valid, 256)
    return torch.from_numpy(np.array(sets)), int(valid.sum())


def _try_both(f1, f2, frame_id2=4):
    jcfg, cfg = _configs()
    key = jax.random.PRNGKey(11)
    ref = jax.jit(lambda m, a, b, k: jmono.try_initialize(
        jcfg, m, a, b, jnp.float32(0.0), jnp.float32(0.1), jnp.int32(frame_id2), k))(
            jms.empty_map(jcfg), f1, f2, key)
    sets, n_matches = _jax_sets(f1, f2, key)
    m0 = map_state.empty_map(cfg, "cpu")
    got = mono_init.try_initialize(
        cfg, m0, convert.frame_from_numpy(jax.tree.map(np.asarray, f1), "cpu"),
        convert.frame_from_numpy(jax.tree.map(np.asarray, f2), "cpu"),
        0.0, 0.1, frame_id2, sets=sets)
    assert got.n_matches == int(ref.n_matches) == n_matches
    return ref, got, m0


@pytest.mark.parametrize("i,k", [(0, 1), (1, 2)])
def test_try_initialize_matches_jax(bootstrap_frames, i, k):
    f1, f2 = bootstrap_frames[i], bootstrap_frames[k]
    assert f1.capacity > OrbConfig(n_features=N_FEAT).feat_capacity()   # the doubled budget
    ref, got, _ = _try_both(f1, f2, frame_id2=k)
    assert bool(ref.success) and got.success is True
    ref_map, ref_carry = convert.state_from_numpy(
        jax.tree.map(np.asarray, ref.m)._asdict(),
        jax.tree.map(np.asarray, ref.carry)._asdict(), "cpu")
    assert int(got.m.n_kf) == 2 and int(got.m.n_pt) > 40
    assert got.m.kf_xy.shape[1] == OrbConfig(n_features=N_FEAT).feat_capacity()
    close = {"kf_Tcw": 1e-4, "kf_Tcp": 1e-4, "pt_pos": 1e-3, "pt_normal": 1e-3,
             "pt_min_dist": 1e-3, "pt_max_dist": 1e-3}
    for name in got.m._fields:
        a, b = getattr(got.m, name), getattr(ref_map, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.is_floating_point and name in close:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=close[name], err_msg=name)
        elif a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, err_msg=name)
        else:
            assert torch.equal(a, b), name
    c, r = got.carry, ref_carry
    np.testing.assert_allclose(c.Tcw.numpy(), r.Tcw.numpy(), atol=1e-4)
    for name in ("last_obs_pt", "last_obs_birth", "frame_id", "last_kf_frame_id", "state_ok"):
        assert torch.equal(getattr(c, name), getattr(r, name)), name
    assert abs(int(c.prev_inliers) - int(r.prev_inliers)) <= 0.02 * int(r.prev_inliers)
    assert torch.equal(c.last_frame.xy, r.last_frame.xy)
    # median scene depth about 1: normalized before the downselect and the BA's polish
    z = got.m.pt_pos[got.m.pt_valid][:, 2]
    assert abs(float(z.median()) - 1.0) < 0.2


def test_failed_attempt_returns_the_map_untouched(bootstrap_frames):
    """Frames 2 and 3: enough matches, but the two-view gates refuse the
    pair, in both packages."""
    f1, f2 = bootstrap_frames[2], bootstrap_frames[3]
    ref, got, m0 = _try_both(f1, f2, frame_id2=3)
    assert got.n_matches >= 60
    assert not bool(ref.success) and got.success is False
    assert got.m is m0 and got.carry is None
    assert int(m0.n_kf) == 0 and not bool(m0.kf_valid.any()) and not bool(m0.pt_valid.any())
    assert int(np.asarray(ref.m.n_kf)) == 0


def _lag_and_ate(slam, seq):
    _, est = slam.get_trajectory()
    lag = N_FRAMES - len(est)
    return lag, ate_rmse(est, seq.poses_gt[lag:], with_scale=True)


@pytest.fixture(scope="module")
def jax_run(seq):
    jcfg, _ = _configs()
    jsys = jsystem.System(jcfg, enable_loop_closing=False)
    jsys.track_batch_mono(seq.images, seq.timestamps)
    return jsys.state, *_lag_and_ate(jsys, seq), jsys.n_keyframes()


@pytest.mark.parametrize("api", ["per_frame", "batch"])
def test_mono_run_matches_jax_outcome(seq, jax_run, api):
    _, cfg = _configs()
    slam = System(cfg, enable_loop_closing=False, device="cpu")
    if api == "per_frame":
        for i in range(N_FRAMES):
            T = slam.track_monocular(seq.images[i], float(seq.timestamps[i]))
            if slam.state == STATE_NOT_INITIALIZED:
                np.testing.assert_array_equal(T, np.eye(4))
    else:
        poses = slam.track_batch_mono(seq.images, seq.timestamps)
    jstate, jlag, jate, jkf = jax_run
    lag, ate = _lag_and_ate(slam, seq)
    assert jstate == 1 and slam.state == STATE_OK
    assert lag <= 6 and abs(lag - jlag) <= 2
    assert ate < 0.06 and jate < 0.06 and abs(ate - jate) <= 0.02
    assert slam.n_keyframes() >= 3 and slam.n_points() > 100
    assert len(slam.trajectory) == N_FRAMES          # bootstrap frames are recorded too
    # the trajectory's first entry hangs off keyframe seq 1 (the second view)
    assert slam._rel_trajectory[0][1] == 1
    # every map row keeps the configured capacity, not the doubled bootstrap one
    assert slam.map.kf_xy.shape[1] == cfg.orb.feat_capacity() == slam.carry.last_frame.capacity
    # mono frames carry no depth: the 2-row residual everywhere
    assert not bool(slam.carry.last_frame.has_depth().any())
    assert bool((slam.map.kf_uright[slam.map.kf_valid] < 0).all())
    if api == "batch":                               # streamed frames only
        assert poses.shape == (N_FRAMES - lag - 1, 4, 4)
