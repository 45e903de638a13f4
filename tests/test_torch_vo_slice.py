"""Localization-mode visual odometry through the port: survive an off-map
excursion (tests/test_localization_vo.py's scenario and assertions, run on
the port alone: the JAX package marks that file's tests slow, so its side is
not re-run here), stay on real map support over mapped views, and track
after load_map into a fresh System as the JAX package does.

Scenario (the JAX test's constants): map the cluster sector over N_MAP frames
of a look-at arc (seed 11), switch to localization mode, yaw ~126 degrees
away from everything mapped and back.  The tracker must (a) enter VO mode
off-map instead of going LOST, (b) keep producing poses there, (c)
relocalize on return and drop the VO flag, within the JAX test's bounds.
The vocabulary is trained as the JAX test trains its own (k=8, L=3, seed 3,
every fourth mapping frame's descriptors), from the port's extract.
"""

import copy

import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models import config as jconfig
from self_commit_orb_slam2_tpu.models import system as jsystem
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb
from self_commit_orb_slam2_tpu_torch.convert import state_to_numpy
from self_commit_orb_slam2_tpu_torch.models.config import Capacities, SlamConfig, TrackingConfig
from self_commit_orb_slam2_tpu_torch.models.system import STATE_LOST, STATE_OK, System
from self_commit_orb_slam2_tpu_torch.ops import bow
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig, extract
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence, lookat_trajectory

torch.set_num_threads(2)   # six test workers share the CPU

N_MAP = 24          # mapping phase frames (look-at arc over the cluster)
YAW_MAX = 2.2       # rad (~126 deg): far outside the mapped sector
YAW_STEP = 0.05     # rad/frame (~13 px/frame at fx=260)
HOLD = 4
CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)
CAPS = dict(max_keyframes=32, max_points=8192, local_points=1024)


def _yaw_pose(yaw: float, center: np.ndarray) -> np.ndarray:
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rwc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    T = np.eye(4)
    T[:3, :3] = Rwc.T
    T[:3, 3] = -Rwc.T @ center
    return T


def _excursion_trajectory():
    """Mapping arc, then yaw away to YAW_MAX and back (Tcw [n, 4, 4])."""
    poses = list(lookat_trajectory(N_MAP))
    center = np.array([0.0, 0.0, 1.0])  # first look-at camera centre
    ramp = np.arange(YAW_STEP, YAW_MAX + 1e-9, YAW_STEP)
    yaws = np.concatenate([ramp, np.full(HOLD, YAW_MAX), ramp[::-1], np.zeros(HOLD)])
    poses += [_yaw_pose(y, center) for y in yaws]
    return np.stack(poses).astype(np.float32), len(ramp)


@pytest.fixture(scope="module")
def mapped():
    """The sequence, ramp length, and a System (mapping on, closer off, on
    the CPU) that tracked the N_MAP mapping frames; tests take deep copies."""
    traj, n_ramp = _excursion_trajectory()
    seq = generate_sequence(width=320, height=240, seed=11, trajectory=traj)
    descs = []
    for i in range(0, N_MAP, 4):
        f = extract(torch.from_numpy(seq.images[i].astype(np.float32)), OrbConfig(n_features=300))
        descs.append(f.desc[f.valid].numpy().view(np.uint32))
    vocab = bow.train_vocabulary(np.concatenate(descs), k=8, L=3, seed=3)
    cfg = SlamConfig(camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=500),
                     caps=Capacities(**CAPS), tracking=TrackingConfig(max_frames_between_kf=8),
                     sensor="rgbd", vocab=vocab)
    slam = System(cfg, enable_loop_closing=False, device="cpu")
    for i in range(N_MAP):
        slam.track_rgbd(seq.images[i], seq.depths[i], float(seq.timestamps[i]))
    return seq, n_ramp, slam


def test_vo_survives_offmap_excursion(mapped):
    seq, n_ramp, base = mapped
    slam = copy.deepcopy(base)
    assert slam.state == STATE_OK
    assert slam.n_keyframes() >= 2
    assert not slam.vo_mode

    slam.activate_localization_mode()
    n_loc = len(seq.images) - N_MAP
    vo_flags, ok_flags, centers = [], [], []
    for j in range(n_loc):
        i = N_MAP + j
        T = slam.track_rgbd(seq.images[i], seq.depths[i], float(seq.timestamps[i]))
        vo_flags.append(slam.vo_mode)
        ok_flags.append(slam.state == STATE_OK)
        centers.append(-T[:3, :3].T @ T[:3, 3])
    vo_flags = np.asarray(vo_flags)
    ok_flags = np.asarray(ok_flags)

    # (a) far off-map (yaw near YAW_MAX) the tracker flags VO mode: matches
    # to real map points have collapsed, yet tracking continues
    far = slice(n_ramp - 6, n_ramp + HOLD)
    assert vo_flags[far].any(), "never entered VO mode off-map"
    # (b) VO keeps the tracker alive through the excursion
    assert ok_flags.mean() >= 0.7, f"tracking alive only {ok_flags.mean():.0%}"
    assert ok_flags[far].any(), "LOST throughout the off-map segment"
    # (c) back home: relocalized onto the map, VO flag dropped, pose correct
    # (the world frame is the first camera's, so the expected pose is the
    # ground truth composed against the first frame's)
    assert ok_flags[-1], "did not recover on return"
    assert not vo_flags[-1], "VO flag stuck after relocalization"
    T0_inv = np.linalg.inv(seq.poses_gt[0])

    def exp_center(i):
        T = seq.poses_gt[i] @ T0_inv
        return -T[:3, :3].T @ T[:3, 3]

    err = np.linalg.norm(centers[-1] - exp_center(len(seq.images) - 1))
    assert err < 0.15, f"return pose off by {err:.3f} m"
    # VO poses stay sane: every tracked camera centre within 1 m of ground truth
    gt_centers = np.stack([exp_center(N_MAP + j) for j in range(n_loc)])
    errs = np.linalg.norm(np.stack(centers) - gt_centers, axis=1)[ok_flags]
    assert np.max(errs) < 1.0, f"VO pose diverged: max err {np.max(errs):.2f} m"


def test_localization_mode_stays_on_map(mapped):
    """Control: while the view stays mapped, localization mode tracks on real
    map support (vo_mode False throughout) and creates no keyframe."""
    seq, _, base = mapped
    slam = copy.deepcopy(base)
    n_kf = slam.n_keyframes()
    slam.activate_localization_mode()
    for i in range(N_MAP - 8, N_MAP):  # replay mapped views
        slam.track_rgbd(seq.images[i], seq.depths[i], float(seq.timestamps[i]) + 10.0)
        assert slam.state == STATE_OK
        assert not slam.vo_mode
    assert slam.n_keyframes() == n_kf, "localization mode created keyframes"


def _jax_system():
    cfg = jconfig.SlamConfig(camera=JCam.create(**CAM), orb=JOrb(n_features=500),
                             caps=jconfig.Capacities(**CAPS),
                             tracking=jconfig.TrackingConfig(max_frames_between_kf=8),
                             sensor="rgbd")
    return jsystem.System(cfg, enable_loop_closing=False)


def test_tracking_after_load_map_matches_jax(mapped, tmp_path):
    """load_map into a fresh System: LOST with no tracking carry, in both
    packages (the checkpoint holds no carry).  The next track_rgbd raises in
    both, the same error, and leaves the port's map and state untouched: no
    recovery is invented that the JAX package does not make."""
    seq, _, base = mapped
    path = str(tmp_path / "map.npz")
    base.save_map(path)
    fresh = System(base.config, enable_loop_closing=False, device="cpu")
    fresh.load_map(path)
    assert fresh.state == STATE_LOST and fresh.carry is None
    assert fresh.n_keyframes() == base.n_keyframes()
    jfresh = _jax_system()
    jfresh.load_map(path)
    assert jfresh.state == jsystem.STATE_LOST and jfresh.carry is None
    assert int(jfresh.map.n_kf) == fresh.n_keyframes()
    np.testing.assert_array_equal(np.asarray(jfresh.map.kf_Tcw),
                                  state_to_numpy(fresh.map)[0]["kf_Tcw"])
    i = N_MAP - 1
    with pytest.raises(AttributeError) as theirs:
        jfresh.track_rgbd(seq.images[i], seq.depths[i], 9.0)
    before = fresh.map.kf_Tcw.clone()
    with pytest.raises(AttributeError) as ours:
        fresh.track_rgbd(seq.images[i], seq.depths[i], 9.0)
    assert "'NoneType' object has no attribute" in str(theirs.value)
    assert "'NoneType' object has no attribute" in str(ours.value)
    assert fresh.state == STATE_LOST and torch.equal(fresh.map.kf_Tcw, before)
