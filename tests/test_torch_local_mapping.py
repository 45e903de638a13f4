"""The port's local mapping against the JAX package, stage by stage.

The JAX System (8-px cells, local mapping on) streams the first frames of a
synthetic sequence; then JAX track_step runs with mapping off until it
inserts a keyframe.  From that state the JAX stages run in _process order,
and each stage's input moves into the port through convert.py: the port's
stage must give the JAX stage's output.  The shared covisibility row and
observation counts are the JAX ones, converted.

Tolerances: integer and boolean state (culls, observations, incidence,
descriptors, archive) exact; float state within 1e-5 (normals, distance
bands); poses within 1e-4 after bundle adjustment (fp32 sums in another
order); points and what is derived from their positions (normals,
distance bands) within 1e-3 + 2e-3 relative (normals 1e-4): a low-parallax
pair's triangulation solves ill-conditioned 3x3 normal equations, which
magnify last-ulp differences of their fp32 sums (measured: 3 of 4096 points
off by up to 6e-4 relative, their normals by 2e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models import config as jconfig
from self_commit_orb_slam2_tpu.models import frame as jframe
from self_commit_orb_slam2_tpu.models import local_mapping as jlm
from self_commit_orb_slam2_tpu.models import map_state as jms
from self_commit_orb_slam2_tpu.models import pipeline as jpipeline
from self_commit_orb_slam2_tpu.models import system as jsystem
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb
from self_commit_orb_slam2_tpu.utils.synthetic import generate_sequence
from self_commit_orb_slam2_tpu_torch import convert
from self_commit_orb_slam2_tpu_torch.models import config, local_mapping
from self_commit_orb_slam2_tpu_torch.models import map_state as ms
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig

W, H, FX, N_FEAT = 320, 240, 260.0, 500
CAPS = dict(max_keyframes=16, max_points=4096, local_points=512, ba_points=1024)
N_WARM, N_MAX = 9, 16


def _configs(**track):
    cam = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=FX * 0.1, width=W, height=H)
    track = dict(max_frames_between_kf=3, **track)
    jcfg = jconfig.SlamConfig(camera=JCam.create(**cam),
                              orb=JOrb(n_features=N_FEAT, cell_size=8),
                              caps=jconfig.Capacities(**CAPS),
                              tracking=jconfig.TrackingConfig(**track))
    tcfg = config.SlamConfig(camera=CameraParams.create(**cam),
                             orb=OrbConfig(n_features=N_FEAT, cell_size=8),
                             caps=config.Capacities(**CAPS),
                             tracking=config.TrackingConfig(**track))
    return jcfg, tcfg


def _jit(fn, cfg):
    return jax.jit(functools.partial(fn, cfg))


@pytest.fixture(scope="module")
def chain():
    """JAX states around one mapping pass: the state right after a keyframe
    insertion, then after each stage of _process."""
    jcfg, tcfg = _configs()
    seq = generate_sequence(n_frames=N_MAX, width=W, height=H, fx=FX, seed=5)
    sys_ = jsystem.System(jcfg, enable_mapping=True, enable_loop_closing=False)
    sys_.track_batch_rgbd(seq.images[:N_WARM], seq.depths[:N_WARM],
                          seq.timestamps[:N_WARM], chunk=4)
    m, carry = sys_.map, sys_.carry
    make = _jit(jframe.make_frame_rgbd, jcfg)
    step = jax.jit(functools.partial(jpipeline.track_step, jcfg, run_mapping=False))
    for i in range(N_WARM, N_MAX):
        m, carry, info = step(m, carry, make(jnp.asarray(seq.images[i]),
                                             jnp.asarray(seq.depths[i])),
                              jnp.float32(seq.timestamps[i]))
        if bool(info.created_kf):
            break
    assert bool(info.created_kf)
    kf = jnp.int32(int(info.ref_kf))
    states = {"inserted": m}
    m = states["cull_points"] = _jit(jlm.cull_points, jcfg)(m, kf)
    counts = jms.covisibility_row_cached(m, m.kf_obs_pt[kf])
    obs_count = jms.observation_count(m)
    m = states["create_new_points"] = jax.jit(functools.partial(
        jlm.create_new_points, jcfg))(m, kf, counts=counts)
    m = states["fuse_into_keyframe"] = jax.jit(functools.partial(
        jlm.fuse_into_keyframe, jcfg))(m, kf, counts=counts, obs_count=obs_count)
    m = states["refresh_observed_points"] = _jit(jlm.refresh_observed_points, jcfg)(m, kf)
    m = states["local_bundle_adjustment"] = jax.jit(functools.partial(
        jlm.local_bundle_adjustment, jcfg))(m, kf, counts=counts)
    m = states["cull_keyframes"] = jax.jit(functools.partial(
        jlm.cull_keyframes, jcfg))(m, kf, counts=counts)
    states["rebuild_incidence"] = jax.jit(jms.rebuild_incidence)(m)
    states = {k: jax.device_get(v) for k, v in states.items()}
    return dict(jcfg=jcfg, tcfg=tcfg, kf=int(kf), states=states,
                counts=np.asarray(counts), obs_count=np.asarray(obs_count))


def _port_state(m_np):
    return convert.state_from_numpy(m_np, None, "cpu")[0]


# (atol, rtol) by field; others (1e-5, 1e-5)
FLOAT_TOL = {"kf_Tcw": (1e-4, 1e-5), "kf_Tcp": (1e-4, 1e-5), "cull_Tcp": (1e-4, 1e-5),
             "pt_pos": (1e-3, 2e-3), "pt_min_dist": (1e-3, 2e-3), "pt_max_dist": (1e-3, 2e-3),
             "pt_normal": (1e-4, 1e-4)}


def assert_maps_match(got: ms.MapState, ref):
    got_np, _ = convert.state_to_numpy(got)
    for f in ms.MapState._fields:
        a, b = np.asarray(getattr(ref, f)), got_np[f]
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if a.dtype.kind == "f":
            atol, rtol = FLOAT_TOL.get(f, (1e-5, 1e-5))
            np.testing.assert_allclose(b, a, atol=atol, rtol=rtol, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


STAGES = ["cull_points", "create_new_points", "fuse_into_keyframe",
          "refresh_observed_points", "local_bundle_adjustment", "cull_keyframes"]


@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches(chain, stage):
    names = ["inserted"] + STAGES
    before = chain["states"][names[names.index(stage) - 1]]
    after = chain["states"][stage]
    kf = torch.tensor(chain["kf"], dtype=torch.int32)
    kwargs = {}
    if stage in ("create_new_points", "fuse_into_keyframe", "local_bundle_adjustment",
                 "cull_keyframes"):
        kwargs["counts"] = torch.tensor(chain["counts"])
    if stage == "fuse_into_keyframe":
        kwargs["obs_count"] = torch.tensor(chain["obs_count"])
    got = getattr(local_mapping, stage)(chain["tcfg"], _port_state(before), kf, **kwargs)
    assert_maps_match(got, after)


def test_stages_change_the_map(chain):
    """The compared stages do work on this state (the comparison is not
    vacuous): points are culled, created and bound, and BA moves poses."""
    s = chain["states"]
    n_valid = {k: int(v.pt_valid.sum()) for k, v in s.items()}
    assert n_valid["create_new_points"] > n_valid["cull_points"]
    assert (s["fuse_into_keyframe"].kf_obs_pt != s["create_new_points"].kf_obs_pt).any()
    assert np.abs(s["local_bundle_adjustment"].kf_Tcw
                  - s["refresh_observed_points"].kf_Tcw).max() > 1e-6


def test_process_matches(chain):
    kf = torch.tensor(chain["kf"], dtype=torch.int32)
    got = local_mapping._process(chain["tcfg"], _port_state(chain["states"]["inserted"]), kf)
    assert_maps_match(got, chain["states"]["rebuild_incidence"])


def test_process_with_duplicate_observations_matches(chain):
    """Point ids held twice in a keyframe row (as tracking and merges can
    leave them) make the refresh lookup, the descriptor table and the
    merge lookup scatter with duplicate indices: the port keeps the last
    update, as XLA does, and the whole pass still matches."""
    m_np = chain["states"]["inserted"]._asdict()
    kf = chain["kf"]
    obs = np.array(m_np["kf_obs_pt"])
    held = np.nonzero((obs[kf] >= 0) & np.asarray(m_np["kf_feat_valid"])[kf])[0]
    obs[kf, held[1::2][:40]] = obs[kf, held[0::2][:40]]
    for k in np.nonzero(np.asarray(m_np["kf_valid"]))[0][:3]:  # older keyframes too
        row_held = np.nonzero(obs[k] >= 0)[0]
        obs[k, row_held[-10:]] = obs[k, row_held[:10]]
    m_np["kf_obs_pt"] = obs
    m_np = jms.MapState(**m_np)
    ref = jax.device_get(jax.jit(functools.partial(jlm._process, chain["jcfg"]))(
        jax.device_put(m_np), jnp.int32(kf)))
    got = local_mapping._process(chain["tcfg"], _port_state(m_np),
                                 torch.tensor(kf, dtype=torch.int32))
    assert_maps_match(got, ref)


def test_forced_keyframe_cull_matches(chain):
    """A low redundancy threshold makes cull_keyframes retire a keyframe:
    the archive, re-anchoring and spanning-tree re-parenting match."""
    jcfg, tcfg = _configs(kf_cull_redundancy=0.05)
    before = chain["states"]["local_bundle_adjustment"]
    counts = chain["counts"]
    ref = jax.device_get(jax.jit(functools.partial(jlm.cull_keyframes, jcfg))(
        jax.device_put(before), jnp.int32(chain["kf"]), counts=jnp.asarray(counts)))
    assert int(ref.n_culled) == int(before.n_culled) + 1
    got = local_mapping.cull_keyframes(tcfg, _port_state(before),
                                       torch.tensor(chain["kf"], dtype=torch.int32),
                                       counts=torch.tensor(counts))
    assert_maps_match(got, ref)
    # the JAX package's culled map (cull archive, incidence cache) round-trips
    # through the port bitwise
    back, _ = convert.state_to_numpy(_port_state(ref))
    for f in ms.MapState._fields:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(ref, f)), err_msg=f)


MAP_FNS = ["rebuild_incidence", "observation_count", "keyframe_positions",
           "covisibility_matrix_cached", "points_of_keyframes",
           "covisibility_of_points_cached"]


@pytest.mark.parametrize("fn", MAP_FNS)
def test_map_state_helpers_exact(chain, fn):
    m_np = chain["states"]["fuse_into_keyframe"]
    jm, tm = jax.device_put(m_np), _port_state(m_np)
    rng = np.random.default_rng(1)
    args = ()
    if fn == "points_of_keyframes":
        args = (rng.random(tm.max_kf) < 0.5,)
    elif fn == "covisibility_of_points_cached":
        args = (rng.random(tm.max_pt) < 0.3,)
    ref = getattr(jms, fn)(jm, *map(jnp.asarray, args))
    got = getattr(ms, fn)(tm, *map(torch.tensor, args))
    if fn == "rebuild_incidence":
        np.testing.assert_array_equal(got.kf_pt_inc.numpy(), np.asarray(ref.kf_pt_inc))
        np.testing.assert_array_equal(got.pt_obs.numpy(), np.asarray(ref.pt_obs))
    elif fn == "keyframe_positions":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
