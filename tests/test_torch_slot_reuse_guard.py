"""The carried-observation slot-reuse guard, through the port, against the JAX package.

carry.last_obs_pt holds point ids across frames; a cull and a reuse of the
slot between two frames can rebind an id to another point.  Every point
carries a birth stamp (map_state.add_points) and the carry holds the stamps
beside the ids; tracking.track_motion drops a carried id whose stamp no
longer matches (the reference's CheckReplacedInLastFrame, src/Tracking.cc:1152).
The JAX package's tests/test_slot_reuse_guard.py, on its 6 frames (320x240,
500 features, per frame):

- the port's own run holds the JAX test's assertions, and creates the same
  number of points with the same stamps as the JAX run on those frames;
- the JAX run's map and carry move into the port (convert.py), a carried
  point's stamp is changed, and the port's track_motion, with and without
  the guard, keeps the victim exactly where the JAX package's does and
  matches the same features (the matching is integer work on equal inputs);
- the port's own state with a stamp changed: the guard drops the alias,
  and a full step on that map re-captures fresh stamps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models import config as jconfig
from self_commit_orb_slam2_tpu.models import system as jsystem
from self_commit_orb_slam2_tpu.models import tracking as jtracking
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb
from self_commit_orb_slam2_tpu_torch import convert
from self_commit_orb_slam2_tpu_torch.models import config, tracking
from self_commit_orb_slam2_tpu_torch.models.system import System
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

torch.set_num_threads(2)   # six test workers share the CPU

CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)


def _guard_configs():
    """tests/test_slam_rgbd.py::make_config, in both packages."""
    caps, track = dict(max_keyframes=32, max_points=8192, local_points=1024), dict(
        max_frames_between_kf=10)
    return (jconfig.SlamConfig(camera=JCam.create(**CAM), orb=JOrb(n_features=500),
                               caps=jconfig.Capacities(**caps),
                               tracking=jconfig.TrackingConfig(**track), sensor="rgbd"),
            config.SlamConfig(camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=500),
                              caps=config.Capacities(**caps),
                              tracking=config.TrackingConfig(**track), sensor="rgbd"))


@pytest.fixture(scope="module")
def guard_runs():
    """The JAX test's 6 frames through both packages (per frame)."""
    jcfg, cfg = _guard_configs()
    seq = generate_sequence(n_frames=7, width=320, height=240, seed=5)
    jslam, slam = jsystem.System(jcfg), System(cfg, device="cpu")
    for i in range(6):
        jslam.track_rgbd(seq.images[i], seq.depths[i], float(i) / 30.0)
        slam.track_rgbd(seq.images[i], seq.depths[i], float(i) / 30.0)
    return jslam, slam, seq


def test_birth_stamps_unique_and_carried(guard_runs):
    jslam, slam, _ = guard_runs
    m = slam.map
    birth = m.pt_birth[m.pt_valid].numpy()
    assert len(np.unique(birth)) == len(birth), "birth stamps must be unique"
    ids, stamps = slam.carry.last_obs_pt.numpy(), slam.carry.last_obs_birth.numpy()
    sel = ids >= 0
    assert sel.sum() > 50
    np.testing.assert_array_equal(stamps[sel], m.pt_birth.numpy()[ids[sel]])
    # the JAX run stamps its points the same way: one stamp per point ever
    # created, in creation order
    jm = jslam.map
    assert int(m.n_pt) == int(jm.n_pt)
    np.testing.assert_array_equal(np.sort(birth),
                                  np.sort(np.asarray(jm.pt_birth)[np.asarray(jm.pt_valid)]))
    jids = np.asarray(jslam.carry.last_obs_pt)
    assert abs(int(sel.sum()) - int((jids >= 0).sum())) <= 0.02 * sel.sum()


def test_reused_slot_is_dropped_by_guard(guard_runs):
    """A carried point's slot rebound to another point between two frames
    (its stamp changed): the guard drops that association, and without it
    the alias would be accepted; the port agrees with the JAX package on
    the JAX run's state, then runs its own step clean on such a map."""
    jslam, slam, seq = guard_runs
    jcfg, cfg = _guard_configs()

    # on the JAX run's state, moved into the port
    jm, jc = jslam.map, jslam.carry
    jids = np.asarray(jc.last_obs_pt)
    carried = np.unique(jids[jids >= 0])
    victim = int(carried[len(carried) // 2])
    jm = jm._replace(pt_birth=jm.pt_birth.at[victim].add(10_000))
    m, carry = convert.state_from_numpy(jax.device_get(jm), jax.device_get(jc), "cpu")
    out = {}
    for guarded in (True, False):
        kw = dict(last_obs_birth=jc.last_obs_birth) if guarded else {}
        want = jtracking.track_motion(jcfg, jm, jc.last_frame, jc.Tcw, jnp.eye(4), jc.last_frame,
                                      jc.last_obs_pt, jnp.float32(15.0), **kw)
        kw = dict(last_obs_birth=carry.last_obs_birth) if guarded else {}
        got = tracking.track_motion(cfg, m, carry.last_frame, carry.Tcw, torch.eye(4),
                                    carry.last_frame, carry.last_obs_pt, 15.0, **kw)
        w, g = np.asarray(want.obs_pt), got.obs_pt.numpy()
        assert (victim in w) == (victim in g) == (not guarded), guarded
        np.testing.assert_array_equal(g >= 0, w >= 0)
        out[guarded] = g
    # the guard drops the victim's association and nothing else that the
    # unguarded match kept for a live stamp
    dropped = (out[False] >= 0) & (out[True] < 0)
    assert victim in out[False][dropped]

    # the port's own run: the same rebinding, then a full step on that map
    m, c = slam.map, slam.carry
    ids = c.last_obs_pt.numpy()
    carried = np.unique(ids[ids >= 0])
    victim = int(carried[len(carried) // 2])
    slam.map = m = m._replace(pt_birth=m.pt_birth.clone().index_add_(
        0, torch.tensor([victim]), torch.tensor([10_000], dtype=m.pt_birth.dtype)))
    guarded = tracking.track_motion(cfg, m, c.last_frame, c.Tcw, torch.eye(4), c.last_frame,
                                    c.last_obs_pt, 15.0, last_obs_birth=c.last_obs_birth)
    unguarded = tracking.track_motion(cfg, m, c.last_frame, c.Tcw, torch.eye(4), c.last_frame,
                                      c.last_obs_pt, 15.0)
    assert victim in unguarded.obs_pt.numpy(), "test premise: the alias is matchable"
    assert victim not in guarded.obs_pt.numpy()
    slam.track_rgbd(seq.images[6], seq.depths[6], 6 / 30.0)
    ids2, stamps2 = slam.carry.last_obs_pt.numpy(), slam.carry.last_obs_birth.numpy()
    sel = ids2 >= 0
    np.testing.assert_array_equal(stamps2[sel], slam.map.pt_birth.numpy()[ids2[sel]])
