"""One tracking step of the PyTorch port against the JAX package.

Both packages start from the same state: the JAX System (mapping and loop
closing off) tracks the first frames of a synthetic sequence, its map and
carry move into the port through convert.py, and both then run track_step on
the same frames (the JAX FrameData, converted), so tracking is compared
without extraction differences.

Tolerances: Tcw within 1e-4 (fp32 Gauss-Newton with sums in another order);
n_inliers within +-2 (the pose optimizer's chi2 reclassification can move an
observation at the threshold); the keyframe decision equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models import config as jconfig
from self_commit_orb_slam2_tpu.models import frame as jframe
from self_commit_orb_slam2_tpu.models import map_state as jmap_state
from self_commit_orb_slam2_tpu.models import pipeline as jpipeline
from self_commit_orb_slam2_tpu.models import system as jsystem
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb
from self_commit_orb_slam2_tpu.utils.synthetic import generate_sequence
from self_commit_orb_slam2_tpu_torch import convert
from self_commit_orb_slam2_tpu_torch.models import config, pipeline
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig

W, H, FX, N_FEAT = 320, 240, 260.0, 500
CAPS = dict(max_keyframes=16, max_points=4096, local_points=512)
N_WARM, N_STEPS = 9, 4


def _configs():
    cam = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=FX * 0.1, width=W, height=H)
    track = dict(max_frames_between_kf=3)   # keyframes come often: both branches run
    jcfg = jconfig.SlamConfig(camera=JCam.create(**cam), orb=JOrb(n_features=N_FEAT),
                              caps=jconfig.Capacities(**CAPS),
                              tracking=jconfig.TrackingConfig(**track))
    tcfg = config.SlamConfig(camera=CameraParams.create(**cam),
                             orb=OrbConfig(n_features=N_FEAT),
                             caps=config.Capacities(**CAPS),
                             tracking=config.TrackingConfig(**track))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_run():
    """JAX state after N_WARM frames, then N_STEPS more steps: the state
    before each step, its frame, and its StepInfo."""
    jcfg, tcfg = _configs()
    seq = generate_sequence(n_frames=N_WARM + N_STEPS, width=W, height=H, fx=FX, seed=5)
    sys_ = jsystem.System(jcfg, enable_mapping=False, enable_loop_closing=False)
    sys_.track_batch_rgbd(seq.images[:N_WARM], seq.depths[:N_WARM],
                          seq.timestamps[:N_WARM], chunk=4)
    m, carry = sys_.map, sys_.carry
    make = jax.jit(functools.partial(jframe.make_frame_rgbd, jcfg))
    step = jax.jit(functools.partial(jpipeline.track_step, jcfg, run_mapping=False))
    steps = []
    for i in range(N_WARM, N_WARM + N_STEPS):
        frame = make(jnp.asarray(seq.images[i]), jnp.asarray(seq.depths[i]))
        ts = jnp.float32(seq.timestamps[i])
        before = jax.device_get((m, carry, frame))
        m, carry, info = step(m, carry, frame, ts)
        steps.append((before, float(seq.timestamps[i]), jax.device_get(info)))
    return tcfg, steps


def test_track_step_matches(jax_run):
    tcfg, steps = jax_run
    created = []
    for (m_np, carry_np, frame_np), ts, info in steps:
        m, carry = convert.state_from_numpy(m_np, carry_np, "cpu")
        frame = convert.frame_from_numpy(frame_np, "cpu")
        m2, carry2, got = pipeline.track_step(
            tcfg, m, carry, frame, torch.tensor(ts, dtype=torch.float32),
            run_mapping=False)
        np.testing.assert_allclose(got.Tcw.numpy(), info.Tcw, atol=1e-4)
        assert abs(int(got.n_inliers) - int(info.n_inliers)) <= 2
        assert bool(got.created_kf) == bool(info.created_kf)
        assert bool(got.state_ok) == bool(info.state_ok)
        assert int(got.n_keyframes) == int(info.n_keyframes)
        assert abs(int(got.n_points) - int(info.n_points)) <= 2
        assert int(got.ref_kf_seq) == int(info.ref_kf_seq)
        created.append(bool(info.created_kf))
    assert any(created) and not all(created)  # both branches compared


def test_state_roundtrip_bitwise(jax_run):
    _, steps = jax_run
    (m_np, carry_np, _), _, _ = steps[-1]
    m, carry = convert.state_from_numpy(m_np, carry_np, "cpu")
    assert m.kf_desc.dtype == torch.int32 and m.feat_cap == m_np.kf_xy.shape[1]
    m_back, carry_back = convert.state_to_numpy(m, carry)
    for k in jmap_state.MapState._fields:
        a, b = np.asarray(getattr(m_np, k)), m_back[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    for k in jpipeline.TrackCarry._fields:
        a, b = getattr(carry_np, k), carry_back[k]
        if k == "last_frame":
            for f in jframe.FrameData._fields:
                np.testing.assert_array_equal(b[f], np.asarray(getattr(a, f)), err_msg=f)
        else:
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=k)
