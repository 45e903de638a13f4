"""Mono triangulation takes the monocular baseline gate whatever the camera's bf.

The reference gates a keyframe pair for triangulation by the sensor
(LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:366-384): stereo and
RGB-D need a baseline above the rig's, mono a baseline / scene-depth ratio
above 0.01.  The JAX package decides by `cam.bf > 0` instead
(models/local_mapping.py:353-355), so a mono configuration that sets bf, as
bench.py's mono runs do (bf = 0.1 fx), takes the stereo rule: in map units
normalized to a median depth of 1, keyframe baselines near 0.1 then starve
the map of new points, and on the card (other bootstrap draws) path 9 (a)
lost tracking after its first mapping pass.  The port gates by the sensor
(ROADMAP.md §C (2), a divergence by design).

- Against the JAX package: the port's create_new_points with sensor="mono"
  and bf set (bench.py's 0.1 fx) gives the JAX package's with
  sensor="mono" and bf = 0 (its own mono rule) on one converted JAX state,
  exactly as tests/test_torch_local_mapping.py holds the stage.  The state
  is that file's, shrunk by 0.25 so that the new keyframe's neighbours lie
  0.04 to 0.13 map units away: between the two rules, so the JAX package
  with bf set creates fewer points on it.
- Within the port: bf is used nowhere else on the mono path, so a mono run
  with bf set equals the same run with bf = 0: the same keyframes, points
  and poses.
"""

import functools

import jax
import numpy as np
import torch

from self_commit_orb_slam2_tpu.models import local_mapping as jlm
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu_torch.models import config, local_mapping
from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.utils.synthetic import circle_trajectory, generate_sequence
from tests.test_torch_local_mapping import (FX, H, W, _port_state, assert_maps_match,  # noqa: F401
                                            chain)

torch.set_num_threads(2)   # six test workers share the CPU

SHRINK = 0.25   # the chain state's neighbour baselines 0.16 to 0.51 -> 0.04 to 0.13

N = 10


def _run(bf: float, seq):
    cfg = config.SlamConfig(
        camera=CameraParams.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=bf, width=320,
                                   height=240),
        orb=OrbConfig(n_features=700),
        caps=config.Capacities(max_keyframes=32, max_points=8192, local_points=1024),
        tracking=config.TrackingConfig(max_frames_between_kf=8, kf_ref_ratio_stereo=0.8),
        sensor="mono")
    slam = System(cfg, enable_loop_closing=False, device="cpu")
    slam._mono_gen.manual_seed(12)   # a bootstrap whose keyframes lie < 0.1 apart
    poses = slam.track_batch_mono(seq.images, seq.timestamps)
    return slam, poses


def test_mono_gate_follows_the_sensor_not_bf():
    seq = generate_sequence(n_frames=N, width=320, height=240, fx=260.0, seed=5,
                            trajectory=circle_trajectory(N, frames_per_rev=120))
    ref, ref_poses = _run(0.0, seq)
    got, got_poses = _run(26.0, seq)
    assert ref.state == got.state == STATE_OK
    assert ref.n_keyframes() >= 3 and ref.n_points() > 150
    assert (got.n_keyframes(), got.n_points()) == (ref.n_keyframes(), ref.n_points())
    np.testing.assert_array_equal(got.map.pt_valid.numpy(), ref.map.pt_valid.numpy())
    np.testing.assert_array_equal(got_poses, ref_poses)


def _shrunk(m):
    """The map scaled by SHRINK about the world origin (a similarity: every
    reprojection, parallax and scale ratio triangulation tests is kept)."""
    d = m._asdict()
    T = np.array(d["kf_Tcw"])
    T[:, :3, 3] *= SHRINK
    d.update(kf_Tcw=T, pt_pos=np.asarray(d["pt_pos"]) * np.float32(SHRINK),
             pt_min_dist=np.asarray(d["pt_min_dist"]) * np.float32(SHRINK),
             pt_max_dist=np.asarray(d["pt_max_dist"]) * np.float32(SHRINK))
    return type(m)(**d)


def test_mono_gate_equals_jax_without_bf(chain):
    before = _shrunk(chain["states"]["cull_points"])
    kf, counts = chain["kf"], chain["counts"]

    def jax_new_points(bf):
        cam = JCam.create(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=bf, width=W, height=H)
        jcfg = chain["jcfg"]._replace(sensor="mono", camera=cam)
        return jax.device_get(jax.jit(functools.partial(jlm.create_new_points, jcfg))(
            jax.device_put(before), kf, counts=counts))

    want, stereo_rule = jax_new_points(0.0), jax_new_points(FX * 0.1)
    tcfg = chain["tcfg"]._replace(sensor="mono")
    assert tcfg.camera.bf == FX * 0.1
    got = local_mapping.create_new_points(tcfg, _port_state(before),
                                          torch.tensor(kf, dtype=torch.int32),
                                          counts=torch.tensor(counts))
    assert_maps_match(got, want)
    n0 = int(before.pt_valid.sum())
    assert int(want.pt_valid.sum()) > int(stereo_rule.pt_valid.sum()) >= n0
