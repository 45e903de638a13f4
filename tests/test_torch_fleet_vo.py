"""Fleet localization serving inherits visual odometry through the shared
pipeline (tests/test_localization_vo.py:140-180's fleet case, which the JAX
package marks slow, through the port on the CPU at a world of one rank): one
stream replays mapped views (control) while the other leaves the mapped
sector; the excursion stream must flag vo, keep tracking and recover on
return, and the control stream must never flag vo.

Cut to keep the file near a minute: the excursion turns to YAW_MAX = 1.2
rad (~69 degrees, still outside the mapped sector: the camera's half field
of view is 32 degrees) where the JAX test turns to 2.2, so 56 localization
frames per stream instead of 96.  Everything else is the JAX test's: the
seed-11 look-at arc mapped over N_MAP = 24 frames, 320x240, 500 features,
the same steps and hold, chunks of 8, the same assertions."""

import numpy as np
import torch

from self_commit_orb_slam2_tpu_torch.models.config import Capacities, SlamConfig, TrackingConfig
from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.parallel.fleet import FleetTracker
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence, lookat_trajectory
from tests.test_torch_fleet_serving import CAM, train_vocab

torch.set_num_threads(2)   # six test workers share the CPU

N_MAP = 24          # mapping phase frames (look-at arc over the cluster)
YAW_MAX = 1.2       # rad (~69 deg): outside the mapped sector (the JAX test: 2.2)
YAW_STEP = 0.1      # rad/frame (~26 px/frame at fx=260; the JAX test: 0.05)
HOLD = 4
B = 8


def _yaw_pose(yaw: float, center: np.ndarray) -> np.ndarray:
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rwc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    T = np.eye(4)
    T[:3, :3] = Rwc.T
    T[:3, 3] = -Rwc.T @ center
    return T


def test_fleet_serving_survives_offmap_excursion():
    center = np.array([0.0, 0.0, 1.0])  # first look-at camera centre
    ramp = np.arange(YAW_STEP, YAW_MAX + 1e-9, YAW_STEP)
    yaws = np.concatenate([ramp, np.full(HOLD, YAW_MAX), ramp[::-1], np.zeros(HOLD)])
    traj = np.stack(list(lookat_trajectory(N_MAP)) + [_yaw_pose(y, center) for y in yaws])
    seq = generate_sequence(width=320, height=240, seed=11, trajectory=traj.astype(np.float32))
    n_ramp = len(ramp)
    vocab = train_vocab(seq.images[0:N_MAP:4], seed=3)
    cfg = SlamConfig(camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=500),
                     caps=Capacities(max_keyframes=32, max_points=8192, local_points=1024),
                     tracking=TrackingConfig(max_frames_between_kf=8),
                     sensor="rgbd", vocab=vocab)
    slam = System(cfg, enable_loop_closing=False, device="cpu")
    for i in range(N_MAP):
        slam.track_rgbd(seq.images[i], seq.depths[i], float(seq.timestamps[i]))
    assert slam.state == STATE_OK and slam.n_keyframes() >= 2

    fleet = FleetTracker(slam.config, n_streams=2, localization_only=True, device="cpu")
    ok = fleet.initialize_localization(slam.map,
                                       np.stack([seq.images[0], seq.images[N_MAP]]),
                                       np.stack([seq.depths[0], seq.depths[N_MAP]]),
                                       np.zeros(2, np.float32))
    assert ok.all(), "fleet relocalization bring-up failed"

    n_loc = len(seq.images) - N_MAP
    saw_vo_away = False
    for c in range(n_loc // B):
        lo = N_MAP + c * B
        # stream 0 (control): cycle mapped views; stream 1: the excursion
        ctrl = [(c * B + k) % N_MAP for k in range(B)]
        a = np.stack([seq.images[ctrl], seq.images[lo:lo + B]])
        d = np.stack([seq.depths[ctrl], seq.depths[lo:lo + B]])
        ts = np.tile((np.arange(B) + c * B) / 30.0, (2, 1))
        fleet.track_chunk(a, d, ts)
        assert not fleet.vo[0], "control stream flagged VO on mapped views"
        if lo + B > N_MAP + n_ramp - 6 and lo < N_MAP + n_ramp + HOLD:
            saw_vo_away = saw_vo_away or bool(fleet.vo[1])
    assert saw_vo_away, "excursion stream never entered VO off-map"
    assert fleet.state_ok[1], "excursion stream did not recover on return"
    assert not fleet.vo[1], "VO flag stuck after return"
