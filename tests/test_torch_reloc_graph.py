"""Relocalization, the localization-mode step and the fleet's step as
captured programs (models/program_graphs.py RelocGraphs, the lost / loc_core
/ loc_lost graphs of models/step_graph.py, the fleet's runners), on the CPU.

The world: 320x240, 500 features, a k=8 L=3 vocabulary trained on the
sequence's descriptors, a System (local mapping off: the keyframes' own
points) that tracks 14 frames; then frames of the same sequence and a
blank one.

(a) Under a TorchDispatchMode, pipeline._localization_core and
    pipeline.relocalize_branch (which runs relocalization.relocalize_uncounted,
    the captured body of a relocalization) build no tensor from host data
    (aten.lift_fresh) and read nothing back (aten._local_scalar_dense), and
    both run on the meta device with no operand on the CPU (the meta
    device's multinomial draws no values, only the minimal sets' shape): on
    the card none syncs, so a CUDA graph captures each.
(b) The Jacobi eigensolver (ops/solvers/jacobi.py) at EPnP's sweep counts
    against float64 torch.linalg.eigh on random, nearly degenerate (an
    eigengap of 1e-3) and rank-deficient (one zero eigenvalue) symmetric
    3x3 and 12x12 matrices: every eigenvalue and eigenvector within 1e-6,
    up to the eigenvector's sign.  EPnP against the JAX package's stays in
    tests/test_torch_solvers.py, at its bounds.
(c) relocalize against the JAX package's on the same map and frames (the
    port's map moved over with convert.state_to_numpy), on the frames where
    retrieval leaves 1 candidate of 5 active, so the masked rows run: the
    same candidates exactly, both succeed, centres within 0.02 m, inliers
    within 10% (tests/test_torch_relocalization.py's bounds).
(d) A CPU StepGraph (the plain versions on its static buffers) against
    pipeline.track_step / batch_steps_frames from clones of one state and
    generators of one seed: a kidnap in SLAM mode, then localization mode
    per frame with a kidnap, then a localization-mode chunk with a padded
    frame: every StepInfo, carry and map bit for bit, and the
    relocalization counts alike.  RelocGraphs against relocalize, twice in
    a row: bit for bit, the generators left in one state.
(e) A 2-stream FleetTracker (mapping off) with CPU runners against one
    without, two chunks: poses, maps and carries bit for bit.
"""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from self_commit_orb_slam2_tpu.models import config as jconfig
from self_commit_orb_slam2_tpu.models import frame as jframe
from self_commit_orb_slam2_tpu.models import map_state as jms
from self_commit_orb_slam2_tpu.models import relocalization as jreloc
from self_commit_orb_slam2_tpu.ops import bow as jbow
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb
from self_commit_orb_slam2_tpu_torch import convert
from self_commit_orb_slam2_tpu_torch.models import config, pipeline, relocalization
from self_commit_orb_slam2_tpu_torch.models import frame as frame_mod
from self_commit_orb_slam2_tpu_torch.models.program_graphs import RelocGraphs
from self_commit_orb_slam2_tpu_torch.models.step_graph import StepGraph
from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
from self_commit_orb_slam2_tpu_torch.ops import bow
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.ops.solvers import epnp, jacobi
from self_commit_orb_slam2_tpu_torch.parallel.fleet import FleetTracker
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

torch.set_num_threads(2)   # six test workers share the CPU

CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)
CAPS = dict(max_keyframes=32, max_points=8192, local_points=1024)
N_MAPPED = 14
ONE_ACTIVE = (8, 13)   # frames on which retrieval leaves 1 candidate active


def _config(vocab) -> config.SlamConfig:
    return config.SlamConfig(camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=500),
                             caps=config.Capacities(**CAPS),
                             tracking=config.TrackingConfig(max_frames_between_kf=8),
                             vocab=vocab)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    seq = generate_sequence(n_frames=N_MAPPED, width=320, height=240, seed=5)
    cfg0 = _config(None)

    def make(cfg, i):
        img = seq.images[i] if i is not None else np.zeros_like(seq.images[0])
        dep = seq.depths[i] if i is not None else np.zeros_like(seq.depths[0])
        return frame_mod.make_frame_rgbd(cfg, torch.from_numpy(img.astype(np.float32)),
                                         torch.from_numpy(dep.astype(np.float32)))

    descs = []
    for i in range(0, N_MAPPED, 4):
        f = make(cfg0, i)
        descs.append(f.desc[f.valid].numpy().view(np.uint32))
    vocab = bow.train_vocabulary(np.concatenate(descs), k=8, L=3, seed=2)
    path = str(tmp_path_factory.mktemp("vocab") / "voc.npz")
    bow.save_vocabulary(path, vocab)
    cfg = _config(vocab)
    slam = System(cfg, enable_mapping=False, enable_loop_closing=False, device="cpu")
    slam.track_batch_rgbd(seq.images[:N_MAPPED], seq.depths[:N_MAPPED],
                          seq.timestamps[:N_MAPPED], chunk=4)
    assert slam.state == STATE_OK and slam.n_keyframes() >= 2
    frames = {i: make(cfg, i) for i in (*ONE_ACTIVE, 9, 10, 11, 12)}
    frames["blank"] = make(cfg, None)
    return dict(seq=seq, cfg=cfg, vocab_path=path, m=slam.map, carry=slam.carry,
                frames=frames, own=[np.asarray(T) for _, T in slam.trajectory])


class _Ops(TorchDispatchMode):
    """Counts aten ops by name, and the ops that take a CPU tensor of one
    element or more.  (torch.vmap hands a Python number on as a 0-d CPU
    tensor, which a CUDA kernel takes by value, as it takes the number: no
    copy.  A 0-d tensor built from host data shows as aten.lift_fresh.)"""

    def __init__(self):
        super().__init__()
        self.count = collections.Counter()
        self.cpu_operands = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count[func.overloadpacket.__name__] += 1
        if _cpu_operand(args) or _cpu_operand((kwargs or {}).values()):
            self.cpu_operands.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _cpu_operand(xs) -> bool:
    for x in xs:
        if isinstance(x, torch.Tensor):
            if x.device.type == "cpu" and x.ndim > 0:
                return True
        elif isinstance(x, (list, tuple)) and _cpu_operand(x):
            return True
    return False


def _meta(x):
    return tree_map(lambda t: t.to("meta") if torch.is_tensor(t) else t, x)


def _clone(x):
    return tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, x)


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _centre(T):
    T = np.asarray(T)
    return -T[:3, :3].T @ T[:3, 3]


# --------------------------------------------------------------- (a) host-free

def test_relocalization_and_localization_are_host_free(world):
    cfg, m, carry, f = world["cfg"], world["m"], world["carry"], world["frames"][9]
    gen = torch.Generator().manual_seed(0)
    # a first call builds the constants (ops/constants.py, once per process)
    core = pipeline._localization_core(cfg, m, carry, f)
    pipeline.relocalize_branch(cfg, m, carry, f, core, gen)
    with _Ops() as ops:
        core = pipeline._localization_core(cfg, m, carry, f)
        branch = pipeline.relocalize_branch(cfg, m, carry, f, core, gen)   # relocalize inside
    assert ops.count["lift_fresh"] == 0 and ops.count["_local_scalar_dense"] == 0
    assert ops.count["multinomial"] == 1 and sum(ops.count.values()) > 5000
    assert bool(branch.relocated) and bool(branch.ok)

    # on the meta device a host read raises, and so does an operand on the CPU
    mcfg = cfg._replace(vocab=cfg.vocab.to("meta"))
    mm, mc, mf = _meta((m, carry, f))
    with _Ops() as ops:
        core_meta = pipeline._localization_core(mcfg, mm, mc, mf)
        branch_meta = pipeline.relocalize_branch(mcfg, mm, mc, mf, core_meta, torch.Generator(),
                                                 localization_only=True)
    assert ops.cpu_operands == []
    for got, like in ((core_meta, core), (branch_meta, branch)):
        assert all(t.device.type == "meta" for t in tree_leaves(got))
        assert [t.shape for t in tree_leaves(got)] == [t.shape for t in tree_leaves(like)]


# ------------------------------------------------------------ (b) eigensolver

def _symmetric(kind: str, n: int, g: torch.Generator) -> torch.Tensor:
    Q, _ = torch.linalg.qr(torch.randn(256, n, n, generator=g, dtype=torch.float64))
    if kind == "random":
        lam = torch.randn(256, n, generator=g, dtype=torch.float64) * 10.0
    else:
        lam = torch.linspace(1.0, float(n), n, dtype=torch.float64).expand(256, n).clone()
        if kind == "close":
            lam[:, 1] = lam[:, 0] + 1e-3
        else:                                   # rank-deficient
            lam[:, 0] = 0.0
    return Q @ torch.diag_embed(lam) @ Q.transpose(-1, -2)


@pytest.mark.parametrize("kind", ["random", "close", "rank_deficient"])
@pytest.mark.parametrize("n,sweeps", [(3, epnp.COV_SWEEPS), (12, epnp.KERNEL_SWEEPS)])
def test_jacobi_matches_eigh(n, sweeps, kind):
    A = _symmetric(kind, n, torch.Generator().manual_seed(n))
    vals, vecs = jacobi.eigh(A, sweeps)
    want_vals, want_vecs = torch.linalg.eigh(A)
    assert vals.dtype == vecs.dtype == torch.float64
    assert float((vals - want_vals).abs().max()) < 1e-6
    err = torch.minimum((vecs - want_vecs).norm(dim=-2), (vecs + want_vecs).norm(dim=-2))
    assert float(err.max()) < 1e-6
    low = jacobi.extreme_eigenvector(A, sweeps, largest=False)
    assert torch.equal(low, vecs[..., :, 0])


# ------------------------------------------------------- (c) against the JAX package

@pytest.fixture(scope="module")
def jax_side(world):
    jvocab = jbow.load_vocabulary(world["vocab_path"])
    jcfg = jconfig.SlamConfig(camera=JCam.create(**CAM), orb=JOrb(n_features=500),
                              caps=jconfig.Capacities(**CAPS),
                              tracking=jconfig.TrackingConfig(max_frames_between_kf=8),
                              vocab=jvocab)
    map_np, _ = convert.state_to_numpy(world["m"])

    @jax.jit
    def jdetect(m, desc, valid):
        words, _ = jbow.transform(jcfg.vocab, desc, valid)
        q_ids, q_vals = jbow.sparse_bow(jcfg.vocab, words, jcfg.bow_top)
        return jreloc.detect_reloc_candidates(jcfg, m, q_ids, q_vals)

    return dict(jm=jms.MapState(**map_np), detect=jdetect,
                relocalize=jax.jit(functools.partial(jreloc.relocalize, jcfg)))


@pytest.mark.parametrize("which", ONE_ACTIVE)
def test_relocalize_with_masked_candidates_matches_jax(which, world, jax_side):
    cfg, m, f = world["cfg"], world["m"], world["frames"][which]
    jf = jframe.FrameData(**{k: convert._to_numpy(k, getattr(f, k)) for k in f._fields})
    jslots, jactive = jax_side["detect"](jax_side["jm"], jf.desc, jf.valid)
    words, _ = bow.transform(cfg.vocab, f.desc, f.valid)
    slots, active = relocalization.detect_reloc_candidates(
        cfg, m, *bow.sparse_bow(cfg.vocab, words, cfg.bow_top))
    np.testing.assert_array_equal(active.numpy(), np.asarray(jactive))
    np.testing.assert_array_equal(slots.numpy(), np.asarray(jslots))
    assert 1 <= int(active.sum()) <= 2 < relocalization.N_CANDIDATES

    jres = jax_side["relocalize"](jax_side["jm"], jf, jax.random.PRNGKey(0))
    res = relocalization.relocalize(cfg, m, f, torch.Generator().manual_seed(0))
    assert bool(jres.success) and bool(res.success)
    assert np.linalg.norm(_centre(res.Tcw) - _centre(jres.Tcw)) < 0.02
    assert np.linalg.norm(_centre(res.Tcw) - _centre(world["own"][which])) < 0.05
    assert abs(int(res.n_inliers) - int(jres.n_inliers)) <= 0.1 * int(jres.n_inliers)


# --------------------------------------------------------- (d) the runners

def _packed(info) -> np.ndarray:
    return pipeline.pack_infos([info])[0].numpy()


def test_step_runner_equals_track_step_through_kidnaps(world):
    """SLAM mode: a blank frame (LOST, relocalization fails), then a mapped
    view (recovered); localization mode: the same, then two tracked frames
    per frame, then a chunk of three and a padded frame.  Mapping off (the tail
    inserts keyframes without the mapping pass: the LOST graph's outputs
    are what it reads either way)."""
    cfg, fr = world["cfg"], world["frames"]
    m0, c0 = world["m"], world["carry"]
    plan = [("blank", False), (12, False), ("blank", True), (10, True), (11, True)]
    ts = torch.tensor(5.0)
    runs = {}
    for graphed in (False, True):
        m, carry = _clone(m0), _clone(c0)
        gen = torch.Generator().manual_seed(23)
        sg = StepGraph(cfg, "cpu") if graphed else None
        relocalization.reset_counts()
        out = []
        for which, loc in plan:
            if graphed:
                m, carry, row = sg.step(m, carry, fr[which], ts, False, gen,
                                        localization_only=loc)
            else:
                m, carry, info = pipeline.track_step(cfg, m, carry, fr[which], ts, False,
                                                     localization_only=loc, generator=gen)
                row = _packed(info)
            out.append((row, _clone(carry)))
        chunk = [fr[9], fr[12], fr[11], fr[11]]
        frames = type(fr[9])(*(torch.stack(x) for x in zip(*chunk)))
        valid = torch.tensor([True, True, True, False])
        tsc = torch.arange(4, dtype=torch.float32) + 6.0
        if graphed:
            m, carry, packed = sg.batch_steps(m, carry, frames, tsc, valid, False, gen,
                                              localization_only=True)
        else:
            m, carry, packed = pipeline.batch_steps_frames(cfg, m, carry, frames, tsc, valid,
                                                           False, localization_only=True,
                                                           generator=gen)
        runs[graphed] = (out, packed, m, carry, relocalization.counts(), gen.get_state())
        assert sg is None or sg.replays == 0

    (out_e, p_e, m_e, c_e, n_e, g_e), (out_g, p_g, m_g, c_g, n_g, g_g) = runs[False], runs[True]
    for k, ((row_e, carry_e), (row_g, carry_g)) in enumerate(zip(out_e, out_g)):
        assert np.array_equal(row_e, row_g), plan[k]
        assert _equal(carry_e, carry_g), plan[k]
    assert torch.equal(p_e, p_g) and _equal(m_e, m_g) and _equal(c_e, c_g)
    assert n_e == n_g and torch.equal(g_e, g_g)
    # what the scenario is for: each kidnap lost, then recovered near the
    # earlier estimate; localization mode added nothing to the map
    states = [bool(r[34] > 0.5) for r, _ in out_e]
    assert states == [False, True, False, True, True]
    infos = pipeline.unpack_infos(np.stack([r for r, _ in out_e]))
    for k, frame_id in ((1, 12), (3, 10)):
        assert np.linalg.norm(_centre(infos.Tcw[k]) - _centre(world["own"][frame_id])) < 0.05
    chunk_infos = pipeline.unpack_infos(p_e.numpy())
    assert list(chunk_infos.state_ok[:3]) == [True, True, True]
    assert n_e == (4, 2)   # each kidnap's blank frame fails, the next view recovers
    assert int(m_e.n_kf) == int(infos.n_keyframes[1]) and int(m_e.n_kf) >= int(m0.n_kf)


def test_reloc_runner_equals_the_direct_call(world):
    cfg, m, f = world["cfg"], world["m"], world["frames"][9]
    runner = RelocGraphs(cfg, "cpu", pool=None)
    g_run, g_direct = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    relocalization.reset_counts()
    for _ in range(2):   # the second call draws from the advanced generators
        got = runner.relocalize(m, f, g_run)
        want = relocalization.relocalize(cfg, m, f, g_direct)
        assert _equal(got, want) and bool(got.success)
    assert torch.equal(g_run.get_state(), g_direct.get_state())
    assert relocalization.counts() == (4, 4)


# -------------------------------------------------------------- (e) the fleet

def test_fleet_runners_equal_op_by_op(world):
    cfg, seq = _config(None), world["seq"]
    starts = np.array([0, 4])
    out = {}
    for graphed in (False, True):
        fleet = FleetTracker(cfg, n_streams=2, enable_mapping=False, device="cpu")
        assert fleet.step_graphs is None
        if graphed:
            fleet.step_graphs = [StepGraph(fleet.config, "cpu") for _ in range(2)]
        fleet.initialize(seq.images[starts], seq.depths[starts], seq.timestamps[starts])
        poses = []
        for lo in (1, 3):
            idx = starts[:, None] + np.arange(lo, lo + 2)
            poses.append(fleet.track_chunk(seq.images[idx], seq.depths[idx], seq.timestamps[idx]))
        out[graphed] = (poses, [fleet.stream_map(s) for s in range(2)], fleet.carries,
                        fleet.state_ok.tolist(), fleet.n_keyframes().tolist())
    (p_e, m_e, c_e, s_e, k_e), (p_g, m_g, c_g, s_g, k_g) = out[False], out[True]
    assert all(np.array_equal(a, b) for a, b in zip(p_e, p_g))
    assert _equal(m_e, m_g) and _equal(c_e, c_g)
    assert s_e == s_g == [True, True] and k_e == k_g
