"""The monocular bootstrap and the per-frame frame build as captured
programs (models/program_graphs.py MonoInitGraphs and FrameBuild), on the
CPU, and the host-free solvers they run.

(a) Under a TorchDispatchMode, mono_init.initialize_map (the attempt's
    captured body: matching, two-view, the map built on a copy and selected
    by success) and frame.make_frame_{rgbd,stereo,mono} (stereo with
    rectification maps) build no tensor from host data (aten.lift_fresh)
    and read nothing back (aten._local_scalar_dense), and run on the meta
    device with no operand on the CPU (the FAST kernels' plain versions
    stand in for their wrappers there): on the card none syncs, so a CUDA
    graph captures each.
(b) The float64 Jacobi SVD of 3x3 matrices (ops/solvers/jacobi.svd3, the
    two-view solver's F rank-2 projection, DecomposeE and ReconstructH)
    against torch.linalg.svd on random, rank-2, E-like (singular values 1,
    1, 0) and nearly degenerate (a gap of 1e-3) matrices: singular values,
    U diag(S) Vh and orthonormality within 1e-6, and every singular vector
    that the matrix determines within 1e-6 up to its sign (u_k and v_k
    flip together where sigma_k > 0; of E's equal pair neither vector is
    determined, and a zero sigma_3 leaves u_3's sign free).  The 9x9 Jacobi
    eigh (the H and F minimal solves and their refits) against
    torch.linalg.eigh on random, rank-8 (8-point) and nearly degenerate
    spectra, within 1e-6 up to sign.
(c) initialize_map against the JAX package's try_initialize on
    test_torch_mono_slice.py's doubled-budget bootstrap frames with the JAX
    draws fed in as `sets`: the same success and n_matches; on success
    Tcw2 (the second keyframe's pose) within 1e-4 and points within 1e-3,
    that file's bounds; on a refused pair the selected map equals the one
    handed in, field by field, and try_initialize returns that map object.
(d) MonoInitGraphs and FrameGraphs.single on the CPU (the plain versions:
    the same functions on their static buffers) against the direct calls,
    twice in a row: bit for bit, the generators left in one state; then a
    mono System with a CPU StepGraph bootstraps and tracks per frame
    exactly as one without.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from self_commit_orb_slam2_tpu.models import frame as jframe
from self_commit_orb_slam2_tpu.models import map_state as jms
from self_commit_orb_slam2_tpu.models import mono_init as jmono
from self_commit_orb_slam2_tpu_torch import convert
from self_commit_orb_slam2_tpu_torch.models import config, frame, map_state, mono_init
from self_commit_orb_slam2_tpu_torch.models.program_graphs import FrameGraphs, MonoInitGraphs
from self_commit_orb_slam2_tpu_torch.models.step_graph import StepGraph
from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb import fast_band, fast_nms
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.ops.solvers import jacobi, two_view
from self_commit_orb_slam2_tpu_torch.utils.rectify import init_undistort_rectify_map
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence
from tests.test_torch_mono_slice import N_FEAT, _configs, _jax_sets


torch.set_num_threads(2)   # six test workers share the CPU

W, H, FX = 320, 240, 260.0


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(n_frames=8, width=W, height=H, fx=FX, seed=5, stereo_baseline=0.1)


@pytest.fixture(scope="module")
def bootstrap_frames(seq):
    """Frames 0 to 3 with the doubled feature budget, from the JAX package
    (test_torch_mono_slice.py's)."""
    jcfg, _ = _configs(2 * N_FEAT)
    make = jax.jit(lambda img: jframe.make_frame_mono(jcfg, img))
    q = lambda a: jnp.asarray(np.clip(a, 0, 255).astype(np.uint8), jnp.float32)  # noqa: E731
    return [make(q(seq.images[i])) for i in range(4)]


def _port_frame(f):
    return convert.frame_from_numpy(jax.tree.map(np.asarray, f), "cpu")


class _Ops(TorchDispatchMode):
    """Counts aten ops by name, and the ops that take a CPU tensor of one
    element or more (a Python number inside torch.vmap reaches the
    dispatcher as a 0-d CPU tensor, taken by value: no copy)."""

    def __init__(self):
        super().__init__()
        self.count = collections.Counter()
        self.cpu_operands = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count[func.overloadpacket.__name__] += 1
        if any(torch.is_tensor(x) and x.device.type == "cpu" and x.ndim > 0
               for x in tree_leaves((args, kwargs or {}))):
            self.cpu_operands.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _meta(x):
    return tree_map(lambda t: t.to("meta") if torch.is_tensor(t) else t, x)


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _scalars(*values):
    return tuple(torch.tensor(v, dtype=d) for v, d in zip(
        values, (torch.float32, torch.float32, torch.int32)))


# --------------------------------------------------------------- (a) host-free

def test_bootstrap_body_is_host_free(bootstrap_frames, monkeypatch):
    _, cfg = _configs()
    f1, f2 = _port_frame(bootstrap_frames[0]), _port_frame(bootstrap_frames[1])
    m = map_state.empty_map(cfg, "cpu")
    gen = torch.Generator().manual_seed(11)
    args = (cfg, m, f1, f2, *_scalars(0.0, 0.1, 1))
    mono_init.initialize_map(*args, gen)          # the per-device constants are built once
    with _Ops() as ops:
        out = mono_init.initialize_map(*args, gen)
    assert ops.count["lift_fresh"] == 0 and ops.count["_local_scalar_dense"] == 0
    assert ops.count["multinomial"] == 1 and sum(ops.count.values()) > 5000
    assert bool(out.success) and int(out.m.n_kf) == 2 and int(m.n_kf) == 0

    # on the meta device a host read raises, and so does an operand on the CPU
    margs = _meta(args[1:])
    with _Ops() as ops:
        got = mono_init.initialize_map(cfg, *margs, torch.Generator())
    assert ops.cpu_operands == []
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert [t.shape for t in tree_leaves(got)] == [t.shape for t in tree_leaves(out)]


def _frame_inputs(seq, sensor):
    img = torch.from_numpy(seq.images[0].astype(np.float32))
    if sensor == "rgbd":
        return (img, torch.from_numpy(seq.depths[0].astype(np.float32)))
    if sensor == "stereo":
        return (img, torch.from_numpy(seq.right_images[0].astype(np.float32)))
    return (img,)


def _frame_config(sensor):
    cfg = config.SlamConfig(camera=CameraParams.create(fx=FX, fy=FX, cx=W / 2, cy=H / 2,
                                                       bf=FX * 0.1, width=W, height=H),
                            orb=OrbConfig(n_features=500), sensor=sensor)
    if sensor == "stereo":   # rectification on the device: identity rotations, no distortion
        K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]])
        P = np.hstack([K, np.zeros((3, 1))])
        maps = [init_undistort_rectify_map(K, np.zeros(5), np.eye(3), P, W, H)
                for _ in range(2)]
        cfg = cfg._replace(rect_maps=tuple(torch.from_numpy(np.asarray(a, np.float32))
                                           for mp in maps for a in mp))
    return cfg


@pytest.mark.parametrize("sensor", ["rgbd", "stereo", "mono"])
def test_frame_builders_are_host_free(seq, sensor, monkeypatch):
    cfg = _frame_config(sensor)
    build = getattr(frame, f"make_frame_{sensor}")
    images = _frame_inputs(seq, sensor)
    build(cfg, *images)
    with _Ops() as ops:
        want = build(cfg, *images)
    assert ops.count["lift_fresh"] == 0 and ops.count["_local_scalar_dense"] == 0
    assert bool(want.valid.any())

    monkeypatch.setattr(fast_band, "fast_nms_bands_hi_lo", fast_band.fast_bands_plain)
    monkeypatch.setattr(fast_nms, "fast_nms_hi_lo", fast_nms.fast_nms_plain)
    mcfg = cfg._replace(rect_maps=_meta(cfg.rect_maps)) if cfg.rect_maps else cfg
    mimages = _meta(images)
    with _Ops() as ops:
        got = build(mcfg, *mimages)
    assert ops.cpu_operands == []
    assert all(t.device.type == "meta" for t in got)
    assert [t.shape for t in got] == [t.shape for t in want]


# ------------------------------------------------------------------ (b) solvers

def _three_by_three(kind: str, g: torch.Generator, n: int = 256) -> torch.Tensor:
    if kind == "random":
        return torch.randn(n, 3, 3, generator=g, dtype=torch.float64) * 5.0
    Q1, _ = torch.linalg.qr(torch.randn(n, 3, 3, generator=g, dtype=torch.float64))
    Q2, _ = torch.linalg.qr(torch.randn(n, 3, 3, generator=g, dtype=torch.float64))
    s = {"rank2": (3.0, 1.0, 0.0), "E": (1.0, 1.0, 0.0), "close": (2.0, 2.0 - 1e-3, 0.5)}[kind]
    return Q1 @ torch.diag(torch.tensor(s, dtype=torch.float64)) @ Q2.transpose(-1, -2)


@pytest.mark.parametrize("kind", ["random", "rank2", "E", "close"])
def test_jacobi_svd_matches_svd(kind):
    A = _three_by_three(kind, torch.Generator().manual_seed(3))
    U, S, Vh = jacobi.svd3(A, two_view.SVD_SWEEPS)
    Ur, Sr, Vhr = torch.linalg.svd(A)
    eye = torch.eye(3, dtype=torch.float64)
    assert U.dtype == S.dtype == Vh.dtype == torch.float64
    assert float((S - Sr).abs().max()) < 1e-6
    assert float((U @ torch.diag_embed(S) @ Vh - A).abs().max()) < 1e-6
    assert float((U.transpose(-1, -2) @ U - eye).abs().max()) < 1e-6
    assert float((Vh @ Vh.transpose(-1, -2) - eye).abs().max()) < 1e-6
    null = kind in ("rank2", "E")
    for k in ([2] if kind == "E" else [0, 1, 2]):
        v, vr = Vh[:, k], Vhr[:, k]
        sign = torch.where((v * vr).sum(-1, keepdim=True) < 0, -1.0, 1.0)
        assert float((v * sign - vr).abs().max()) < 1e-6, k
        u, ur = U[..., k], Ur[..., k]
        if k == 2 and null:   # sigma_3 = 0: u_3's sign is its own
            sign = torch.where((u * ur).sum(-1, keepdim=True) < 0, -1.0, 1.0)
        assert float((u * sign - ur).abs().max()) < 1e-6, k


def _nine_by_nine(kind: str, g: torch.Generator, n: int = 256) -> torch.Tensor:
    if kind == "rank8":                       # an 8-point set's A^T A
        A = torch.randn(n, 8, 9, generator=g, dtype=torch.float64)
        return A.transpose(-1, -2) @ A
    Q, _ = torch.linalg.qr(torch.randn(n, 9, 9, generator=g, dtype=torch.float64))
    if kind == "random":
        lam = torch.randn(n, 9, generator=g, dtype=torch.float64) * 10.0
    else:
        lam = torch.linspace(1.0, 9.0, 9, dtype=torch.float64).expand(n, 9).clone()
        lam[:, 1] = lam[:, 0] + 1e-3
    return Q @ torch.diag_embed(lam) @ Q.transpose(-1, -2)


@pytest.mark.parametrize("kind", ["random", "rank8", "close"])
def test_jacobi_eigh_9x9_matches_eigh(kind):
    A = _nine_by_nine(kind, torch.Generator().manual_seed(9))
    vals, vecs = jacobi.eigh(A, two_view.DLT_SWEEPS)
    want_vals, want_vecs = torch.linalg.eigh(A)
    assert float((vals - want_vals).abs().max()) < 1e-6
    err = torch.minimum((vecs - want_vecs).norm(dim=-2), (vecs + want_vecs).norm(dim=-2))
    assert float(err.max()) < 1e-6


# ------------------------------------------------------- (c) against the JAX package

def _jax_try(f1, f2, frame_id2):
    jcfg, _ = _configs()
    key = jax.random.PRNGKey(11)
    ref = jax.jit(lambda m, a, b, k: jmono.try_initialize(
        jcfg, m, a, b, jnp.float32(0.0), jnp.float32(0.1), jnp.int32(frame_id2), k))(
            jms.empty_map(jcfg), f1, f2, key)
    return ref, _jax_sets(f1, f2, key)[0]


@pytest.mark.parametrize("i,k", [(0, 1), (1, 2), (2, 3)])
def test_bootstrap_body_matches_jax(bootstrap_frames, i, k):
    ref, sets = _jax_try(bootstrap_frames[i], bootstrap_frames[k], k)
    _, cfg = _configs()
    m0 = map_state.empty_map(cfg, "cpu")
    before = tree_map(torch.clone, m0)
    out = mono_init.initialize_map(cfg, m0, _port_frame(bootstrap_frames[i]),
                                   _port_frame(bootstrap_frames[k]), *_scalars(0.0, 0.1, k),
                                   sets=sets)
    assert bool(out.success) == bool(ref.success) == (k != 3)
    assert int(out.n_matches) == int(ref.n_matches) >= 60
    assert _equal(m0, before)                  # the map handed in is only read
    if k == 3:   # refused: the selected map is the one handed in
        assert _equal(out.m, m0)
        res = mono_init.read_result(out, m0)
        assert res.success is False and res.m is m0 and res.carry is None
        return
    jm = convert.state_from_numpy(jax.tree.map(np.asarray, ref.m)._asdict(), None, "cpu")[0]
    np.testing.assert_allclose(out.m.kf_Tcw[1].numpy(), jm.kf_Tcw[1].numpy(), atol=1e-4)
    np.testing.assert_allclose(out.carry.Tcw.numpy(), np.asarray(ref.carry.Tcw), atol=1e-4)
    assert torch.equal(out.m.pt_valid, jm.pt_valid) and int(out.m.n_pt) > 40
    np.testing.assert_allclose(out.m.pt_pos.numpy(), jm.pt_pos.numpy(), atol=1e-3)


# ------------------------------------------------------------------ (d) runners

def test_mono_runner_equals_the_direct_call(bootstrap_frames):
    _, cfg = _configs()
    fr = [_port_frame(f) for f in bootstrap_frames]
    runner = MonoInitGraphs(cfg, "cpu", pool=None)
    g_run, g_direct = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    m0 = map_state.empty_map(cfg, "cpu")
    for a, b in ((2, 3), (0, 1), (0, 1)):     # refused, then twice from advanced generators
        got = runner.try_initialize(m0, fr[a], fr[b], 0.5, 0.6, b, g_run)
        want = mono_init.try_initialize(cfg, m0, fr[a], fr[b], 0.5, 0.6, b, g_direct)
        assert got.success == want.success == (b == 1) and got.n_matches == want.n_matches
        if want.success:
            assert _equal((got.m, got.carry), (want.m, want.carry))
        else:
            assert got.m is m0 and got.carry is None
    assert torch.equal(g_run.get_state(), g_direct.get_state())
    assert len(runner.programs) == 1           # the attempt; no frame built yet


@pytest.mark.parametrize("sensor", ["rgbd", "stereo", "mono"])
def test_frame_build_runner_equals_the_direct_call(seq, sensor):
    cfg = _frame_config(sensor)
    runner = FrameGraphs(cfg, "cpu", pool=None)
    build = getattr(frame, f"make_frame_{sensor}")
    outs = []
    for i in (0, 1, 2):
        images = _frame_inputs(seq, sensor) if i == 0 else tuple(
            torch.roll(a, 7 * i, dims=1) for a in _frame_inputs(seq, sensor))
        got = runner.single(sensor, images)
        assert _equal(got, build(cfg, *images)), i
        outs.append((got, tree_map(torch.clone, got)))
    assert len(runner.single_programs) == 1 and runner.programs == []
    for got, copy in outs:             # each frame's outputs outlive the next run
        assert _equal(got, copy)


def test_mono_system_through_the_runners_equals_op_by_op(seq):
    """Per frame: the doubled-budget frame build and the attempt through a
    CPU StepGraph's MonoInitGraphs, the later frames through its frame
    build and step, against a System with step_graph None."""
    _, cfg = _configs()
    out = {}
    for graphed in (False, True):
        slam = System(cfg, enable_loop_closing=False, device="cpu")
        if graphed:
            slam.step_graph = StepGraph(slam.config, "cpu")
        poses = [slam.track_monocular(seq.images[i], float(seq.timestamps[i]))
                 for i in range(6)]
        out[graphed] = (poses, slam.map, slam.carry, slam.state, slam._mono_gen.get_state())
        if graphed:
            sg = slam.step_graph
            assert sg.mono.program is not None and len(sg.mono.frame.programs) == 1
            assert len(sg.frames.single_programs) == 1
    (p_e, m_e, c_e, s_e, g_e), (p_g, m_g, c_g, s_g, g_g) = out[False], out[True]
    assert s_e == s_g == STATE_OK and int(m_e.n_kf) >= 2
    assert all(np.array_equal(a, b) for a, b in zip(p_e, p_g))
    assert _equal(m_e, m_g) and _equal(c_e, c_g) and torch.equal(g_e, g_g)
