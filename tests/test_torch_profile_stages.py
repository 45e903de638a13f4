"""tools/profile_stages.py, the port's counterpart of scripts/profile_stages.py,
at 160x120 / 300 features on the CPU: its stage lists against the JAX
script's, its state recipe against a port System fed the same frames, each
stage on the JAX script's state (the recipe run through the JAX package,
with fx passed, and carried into the port) against the JAX function
(ROADMAP.md C4's bounds: Tcw 1e-4 and inliers +-2 for the tracking stages,
poses 1e-4 and points 1e-3 for the mapping stages), and the tool's CPU run
(one row a stage, each Program's plain version bitwise against op by op,
no device metric)."""

import contextlib
import functools
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models import frame as jframe
from self_commit_orb_slam2_tpu.models import local_mapping as jlm
from self_commit_orb_slam2_tpu.models import pipeline as jpipeline
from self_commit_orb_slam2_tpu.models import tracking as jtracking
from self_commit_orb_slam2_tpu.models.config import Capacities as JCaps
from self_commit_orb_slam2_tpu.models.config import SlamConfig as JConfig
from self_commit_orb_slam2_tpu.models.config import TrackingConfig as JTracking
from self_commit_orb_slam2_tpu.models.system import System as JSystem
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.optim.pose_opt import pose_optimize as jpose_optimize
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb
from self_commit_orb_slam2_tpu_torch.convert import frame_from_numpy, state_from_numpy
from self_commit_orb_slam2_tpu_torch.models import local_mapping, pipeline, tracking
from self_commit_orb_slam2_tpu_torch.models.system import System
from self_commit_orb_slam2_tpu_torch.tools import profile_stages as tool
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

torch.set_num_threads(2)   # six test workers share the CPU

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, NF = 160, 120, 300


def _jax_script_stages():
    """The JAX script's stage labels: main's timeit calls, then
    profile_mapping's list, each in its order."""
    src = open(os.path.join(ROOT, "scripts", "profile_stages.py")).read()
    main_src, mapping_src = src.split("def profile_mapping")
    main = re.findall(r'timeit\("([^"]+)"', main_src)
    mapping = re.findall(r'"([a-z_]+)"', mapping_src.split("for name in [")[1].split("]")[0])
    return main, mapping


def test_stage_lists_follow_the_jax_script():
    main, mapping = _jax_script_stages()
    assert list(tool.JAX_MAIN) == main and len(main) == 6
    assert list(tool.JAX_MAPPING) == mapping and len(mapping) == 6
    assert [s for s in tool.MAIN if s not in tool.ADDED] == main
    assert set(tool.ADDED) <= set(tool.MAIN) and len(tool.MAIN) == len(main) + 4
    assert tool.MAPPING[:6] == tool.JAX_MAPPING and len(tool.MAPPING) == 12


@pytest.fixture(scope="module")
def port_state():
    return tool.build_state(W, H, NF, "cpu")


def test_state_recipe_equals_a_system_fed_the_same_frames(port_state):
    cfg = tool.config(W, H, NF)
    assert cfg.camera.fx == 130.0 and cfg.camera.bf == pytest.approx(13.0)
    seq = generate_sequence(n_frames=8, width=W, height=H, fx=130.0, seed=5)
    np.testing.assert_array_equal(port_state.seq.images, seq.images)
    slam = System(cfg, device="cpu")
    slam.track_batch_rgbd(seq.images, seq.depths, seq.timestamps)
    assert tool.bitwise_equal(port_state.map, slam.map)
    assert tool.bitwise_equal(port_state.carry, slam.carry)
    assert int(slam.map.n_kf) >= 2


@pytest.fixture(scope="module")
def jax_state():
    """The JAX script's recipe through the JAX package at 160x120 / 300
    features, fx passed to generate_sequence; its frame 0; and the port's
    copy of the state and the frame."""
    fx = 260.0 * W / 320
    seq = generate_sequence(n_frames=8, width=W, height=H, fx=fx, seed=5)
    cam = JCam.create(fx=fx, fy=fx, cx=W / 2, cy=H / 2, bf=fx * 0.1, width=W, height=H)
    cfg = JConfig(camera=cam, orb=JOrb(n_features=NF),
                  caps=JCaps(max_keyframes=64, max_points=16384, local_points=1024),
                  tracking=JTracking(max_frames_between_kf=10), sensor="rgbd")
    slam = JSystem(cfg)
    slam.track_batch_rgbd(seq.images[:8], seq.depths[:8], seq.timestamps[:8])
    img = jnp.asarray(seq.images[0].astype(np.float32))
    dep = jnp.asarray(seq.depths[0].astype(np.float32))
    frame = jax.jit(functools.partial(jframe.make_frame_rgbd, cfg))(img, dep)
    m, carry = state_from_numpy(jax.device_get(slam.map), jax.device_get(slam.carry), "cpu")
    port = tool.State(tool.config(W, H, NF), seq, m, carry, torch.device("cpu"))
    return cfg, slam.map, slam.carry, frame, port, frame_from_numpy(jax.device_get(frame), "cpu")


def _assert_pose(T, T_ref, n, n_ref):
    np.testing.assert_allclose(np.asarray(T), np.asarray(T_ref), atol=1e-4)
    assert abs(int(n) - int(n_ref)) <= 2


def test_tracking_stages_match_jax(jax_state):
    jcfg, jm, jc, jf, st, f = jax_state
    cfg, m, c = st.config, st.map, st.carry
    tm = jax.jit(functools.partial(jtracking.track_motion, jcfg))
    jres = tm(jm, jf, jc.Tcw, jc.velocity, jc.last_frame, jc.last_obs_pt, jnp.float32(7.0))
    res = tool._track_motion(cfg, m, f, c.Tcw, c.velocity, c.last_frame, c.last_obs_pt)
    _assert_pose(res.Tcw, jres.Tcw, res.n_inliers, jres.n_inliers)
    assert int(jres.n_inliers) > 0   # frame 0 seen from frame 7: few, but some

    cam, kw, args = tool.pose_optimize_args(st, f)
    jpo = jax.jit(functools.partial(jpose_optimize, jcfg.camera, **kw))(
        *(jnp.asarray(a.numpy()) for a in args))
    po = tool._pose_optimize(cam, kw, *args)
    _assert_pose(po.Tcw, jpo.Tcw, po.n_inliers, jpo.n_inliers)

    # local-map tracking from the JAX motion result, on both sides
    tl = jax.jit(functools.partial(jtracking.track_local_map, jcfg))
    jl = tl(jm, jf, jres.Tcw, jres.obs_pt)
    lres = tracking.track_local_map(cfg, m, f, torch.from_numpy(np.asarray(jres.Tcw)),
                                    torch.from_numpy(np.asarray(jres.obs_pt)))
    _assert_pose(lres.Tcw, jl.Tcw, lres.n_inliers, jl.n_inliers)

    # step_core (both hypotheses, local-map tracking) against the JAX step's
    # pose and inliers; the whole step's too, and its keyframe decision
    jstep = jax.jit(functools.partial(jpipeline.step_rgbd, jcfg))
    img = jnp.asarray(st.seq.images[0].astype(np.float32))
    dep = jnp.asarray(st.seq.depths[0].astype(np.float32))
    jm2, _, jinfo = jstep(jm, jc, img, dep, jnp.float32(0.0))
    core = pipeline.step_core(cfg, m, c, f)
    _assert_pose(core.lres.Tcw, jinfo.Tcw, core.lres.n_inliers, jinfo.n_inliers)
    m2, _, info = tool.step_rgbd_on_device(
        cfg, tool._clone(m), c, torch.from_numpy(st.seq.images[0].astype(np.float32)),
        torch.from_numpy(st.seq.depths[0].astype(np.float32)), torch.zeros(()))
    _assert_pose(info.Tcw, jinfo.Tcw, info.n_inliers, jinfo.n_inliers)
    assert bool(info.created_kf) == bool(jinfo.created_kf)
    assert int(m2.n_kf) == int(jm2.n_kf)
    np.testing.assert_allclose(m2.kf_Tcw.numpy(), np.asarray(jm2.kf_Tcw), atol=1e-4)


def _assert_map(m, jm):
    """Poses within 1e-4, the points live on both sides within 1e-3, the
    live sets within 2 points and equal keyframe sets."""
    assert torch.equal(m.kf_valid, torch.from_numpy(np.asarray(jm.kf_valid)))
    np.testing.assert_allclose(m.kf_Tcw.numpy(), np.asarray(jm.kf_Tcw), atol=1e-4)
    live, jlive = m.pt_valid.numpy(), np.asarray(jm.pt_valid)
    assert abs(int(live.sum()) - int(jlive.sum())) <= 2
    both = live & jlive
    np.testing.assert_allclose(m.pt_pos.numpy()[both], np.asarray(jm.pt_pos)[both], atol=1e-3)


@pytest.mark.parametrize("name", tool.JAX_MAPPING + ("create_keyframe_then_process",))
def test_mapping_stages_match_jax(jax_state, name):
    jcfg, jm, jc, jf, st, f = jax_state
    cfg, m, c = st.config, st.map, st.carry
    if name == "create_keyframe_then_process":
        # the main mode's create_keyframe, then local_mapping._process on its map
        ck = jax.jit(functools.partial(jtracking.create_keyframe, jcfg))
        tl = jax.jit(functools.partial(jtracking.track_local_map, jcfg))
        res = tool._track_motion(cfg, m, f, c.Tcw, c.velocity, c.last_frame, c.last_obs_pt)
        jl = tl(jm, jf, jnp.asarray(res.Tcw.numpy()), jnp.asarray(res.obs_pt.numpy()))
        Tcw, obs = torch.from_numpy(np.asarray(jl.Tcw)), torch.from_numpy(np.asarray(jl.obs_pt))
        jm2, jkf = ck(jm, jf, jl.Tcw, jl.obs_pt, jc.frame_id, jnp.float32(0.0))
        m2, kf = tracking.create_keyframe(cfg, tool._clone(m), f, Tcw, obs, c.frame_id,
                                          torch.zeros(()))
        assert int(kf) == int(jkf) and int(m2.n_pt) == int(jm2.n_pt)
        _assert_map(m2, jm2)
        out = local_mapping._process(cfg, m2, kf)
        jout = jax.jit(functools.partial(jlm._process, jcfg))(jm2, jkf)
    else:
        kf = (m.n_kf - 1).to(torch.int32)
        out = getattr(local_mapping, name)(cfg, tool._clone(m), kf)
        jout = jax.jit(functools.partial(getattr(jlm, name), jcfg))(jm, jnp.int32(int(kf)))
    _assert_map(out, jout)


def _lines(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def _assert_cpu_table(out, names):
    rows = [line for line in out.splitlines() if line[:42].strip() in names]
    assert [line[:42].strip() for line in rows] == list(names)
    # step_rgbd's Program (its tail a cond) bitwise against pipeline.step_rgbd;
    # every other stage's Program runs the same call
    assert all(line.rstrip().endswith("yes" if line.startswith(tool.JAX_MAIN[-1]) else "-")
               for line in rows), out
    assert "device ms" not in out and "kernels" not in out and "syncs" not in out
    assert "device metrics need the card" in out


@pytest.mark.parametrize("mapping", [False, True])
def test_cpu_run_prints_a_row_a_stage_and_no_device_metric(port_state, mapping):
    """Each mode on the recipe's state, as main runs it after the recipe:
    one row a stage with its host ms."""
    rows, out = _lines(lambda: tool.report(port_state, mapping, 1))
    _assert_cpu_table(out, tool.MAPPING if mapping else tool.MAIN)
    assert tool.failures(rows) == [] and all("graph" not in r for r in rows)
    if mapping:   # the pass's sums against the sink form they replaced
        assert tool.sink_form_equal(port_state) == {
            "refresh_observed_points": True, "bundle_adjust": True}
        assert "sink form's kept rows, bitwise: {'refresh_observed_points': True" in out


def test_tool_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
