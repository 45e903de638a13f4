"""A map run past its keyframe capacity, through the port, against the JAX package.

Slot recycling (map_state.insert_keyframe into the first free slot), point
birth stamps (add_points) and the carried-observation guard they feed
(tracking.track_motion's last_obs_birth), and the cull archive that
keyframe culling writes and get_trajectory reads back.  The JAX package's
own tests of the first and the last (tests/test_long_sequence.py) run here
through the port (the guard's are in test_torch_slot_reuse_guard.py):

- insert_keyframe on one zero frame, in both packages: slots, n_kf and
  kf_seq exact (integer work);
- test_long_sequence_bounded_map's scenario (320x240, 400 features, 12
  keyframe slots, 60 frames of a lingering look-at oscillation, per frame)
  under the JAX test's assertions, with the JAX outcome pinned below:
  keyframe counts within 1, ATE within 25% of the JAX run's (the port's
  run on the CPU gives 0.006915 m against its 0.006914 m; a keyframe more
  or fewer moves it by more than the float noise, by less than a quarter),
  and the spanning tree (each parent after the culls' re-parenting) equal
  on the keyframes live in both.

    python -m tests.test_torch_bounded_map [jax|port]

prints the run's outcome through either package (the pinned values come
from the JAX run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from self_commit_orb_slam2_tpu.models import config as jconfig
from self_commit_orb_slam2_tpu.models import frame as jframe
from self_commit_orb_slam2_tpu.models import map_state as jms
from self_commit_orb_slam2_tpu.models import system as jsystem
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb
from self_commit_orb_slam2_tpu_torch import convert
from self_commit_orb_slam2_tpu_torch.models import config, map_state
from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence, lookat_trajectory

torch.set_num_threads(2)   # six test workers share the CPU

CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)
N_LONG = 60
# python -m tests.test_torch_bounded_map jax (the JAX package on the CPU); tree:
# {seq: tree-parent seq} of the live keyframes after the run's re-parentings
JAX_LONG = dict(total=35, live=7, culled=28, ate=0.006914,
                tree={0: -1, 1: 0, 7: 0, 28: 7, 32: 28, 33: 32, 34: 0})


def _long_configs(max_kf=12):
    """tests/test_long_sequence.py::_config, in both packages."""
    kw = dict(caps=dict(max_keyframes=max_kf, max_points=8192, local_points=768, cull_log=256),
              tracking=dict(max_frames_between_kf=2, min_frames_between_kf=0,
                            kf_cull_redundancy=0.7))
    return (jconfig.SlamConfig(camera=JCam.create(**CAM), orb=JOrb(n_features=400),
                               caps=jconfig.Capacities(**kw["caps"]),
                               tracking=jconfig.TrackingConfig(**kw["tracking"]), sensor="rgbd"),
            config.SlamConfig(camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=400),
                              caps=config.Capacities(**kw["caps"]),
                              tracking=config.TrackingConfig(**kw["tracking"]), sensor="rgbd"))


def test_insert_reuses_freed_slot():
    """The JAX test's four inserts, a dropped fifth into a full map, then a
    slot freed and reused, in both packages on the same zero frame."""
    jcfg, cfg = _long_configs(max_kf=4)
    N = cfg.orb.feat_capacity()
    jf = jframe.FrameData(xy=jnp.zeros((N, 2)), xy_raw=jnp.zeros((N, 2)),
                          response=jnp.zeros(N), angle=jnp.zeros(N),
                          level=jnp.zeros(N, jnp.int32), desc=jnp.zeros((N, 8), jnp.uint32),
                          valid=jnp.ones(N, bool), u_right=jnp.full(N, -1.0),
                          depth=jnp.full(N, -1.0))
    tf = convert.frame_from_numpy(jax.device_get(jf), "cpu")
    jm, m = jms.empty_map(jcfg), map_state.empty_map(cfg, "cpu")

    def both(i, jm, m):
        jm, js = jms.insert_keyframe(jm, jf, jnp.eye(4), jnp.int32(i), jnp.float32(i),
                                     jnp.full(N, -1, jnp.int32))
        m, s = map_state.insert_keyframe(m, tf, torch.eye(4), torch.tensor(i, dtype=torch.int32),
                                         torch.tensor(float(i)),
                                         torch.full((N,), -1, dtype=torch.int32))
        assert int(s) == int(js)
        for f in ("n_kf", "kf_seq", "kf_valid", "kf_frame_id", "kf_tree_parent_seq"):
            np.testing.assert_array_equal(getattr(m, f).numpy(), np.asarray(getattr(jm, f)), f)
        return jm, m, int(s)

    slots = []
    for i in range(4):
        jm, m, s = both(i, jm, m)
        slots.append(s)
    assert slots == [0, 1, 2, 3] and int(m.n_kf) == 4
    # full: the fifth insert is dropped in both
    seq_before = m.kf_seq.clone()
    _, m_full, _ = both(4, jm, m)
    assert int(m_full.n_kf) == 4
    np.testing.assert_array_equal(m_full.kf_seq.numpy(), seq_before.numpy())
    # slot 2 freed: the next insert takes it with the next seq
    jm = jm._replace(kf_valid=jm.kf_valid.at[2].set(False))
    m = m._replace(kf_valid=m.kf_valid.clone().index_fill_(0, torch.tensor([2]), False))
    jm, m, s = both(5, jm, m)
    assert s == 2 and int(m.kf_seq[2]) == 4
    assert int(map_state.latest_kf(m)) == int(jms.latest_kf(jm)) == 2


def long_run(package: str) -> dict:
    """test_long_sequence_bounded_map's drive through either package, with
    the JAX test's per-frame assertions."""
    jcfg, cfg = _long_configs()
    traj = lookat_trajectory(N_LONG, sweep=0.22, frames_per_cycle=24)
    seq = generate_sequence(n_frames=N_LONG, width=320, height=240, fx=260.0, seed=7,
                            trajectory=traj)
    slam = jsystem.System(jcfg, enable_loop_closing=False) if package == "jax" else System(
        cfg, enable_loop_closing=False, device="cpu")
    for i in range(N_LONG):
        slam.track_rgbd(seq.images[i], seq.depths[i], float(seq.timestamps[i]))
        assert slam.state == STATE_OK, f"tracking lost at frame {i}"
        assert int(np.asarray(slam.map.kf_valid).sum()) <= cfg.caps.max_keyframes
    m = slam.map
    ts, poses = slam.get_trajectory()
    valid, seq_, parent = (np.asarray(x) for x in (m.kf_valid, m.kf_seq, m.kf_tree_parent_seq))
    return dict(tree={int(seq_[k]): int(parent[k]) for k in np.nonzero(valid)[0]},
                total=int(np.asarray(m.n_kf)), live=int(np.asarray(m.kf_valid).sum()),
                culled=int(np.asarray(m.n_culled)), pts=int(np.asarray(m.pt_valid).sum()),
                n_poses=len(ts), finite=bool(np.all(np.isfinite(poses))),
                ate=float(ate_rmse(poses, seq.poses_gt)))


def test_long_sequence_bounded_map():
    got = long_run("port")
    _, cfg = _long_configs()
    assert got["total"] > cfg.caps.max_keyframes, "slot reuse untested"
    assert got["culled"] == got["total"] - got["live"]
    assert 0 < got["pts"] <= cfg.caps.max_points
    assert got["n_poses"] == N_LONG and got["finite"]
    assert got["ate"] < 0.08
    for k in ("total", "live", "culled"):
        assert abs(got[k] - JAX_LONG[k]) <= 1, (k, got[k], JAX_LONG[k])
    assert abs(got["ate"] - JAX_LONG["ate"]) <= 0.25 * JAX_LONG["ate"]
    # the spanning tree after culls re-parented the victims' children: the
    # same parent for every keyframe live in both runs
    both = set(got["tree"]) & set(JAX_LONG["tree"])
    assert len(both) >= JAX_LONG["live"] - 1
    assert {k: got["tree"][k] for k in both} == {k: JAX_LONG["tree"][k] for k in both}


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    print(long_run(sys.argv[1] if len(sys.argv) > 1 else "jax"))
