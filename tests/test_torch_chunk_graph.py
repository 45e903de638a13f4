"""The chunk program (models/step_graph.py, the JAX package's
batch_steps_frames as one graph a chunk, its branches program_graphs.cond)
on the CPU.

The world: 320x240, 500 features, a k=8 L=3 vocabulary trained on the
sequence's descriptors, a System (local mapping on) that tracks 14 frames
per frame; then chunks of 4 of the sequence's frames and blank ones.

(a) The chunk function with cond recording its predicates and running its
    branch whatever they hold: no tensor built from host data
    (aten.lift_fresh) and nothing read back (aten._local_scalar_dense)
    outside the predicates, and the same on the meta device with no operand
    on the CPU; the predicates are 0-d bools, one valid flag a slot, then
    want_reloc and need_kf.
(b) A CPU StepGraph's chunk runner (the plain version: cond reads its
    predicate) against pipeline.batch_steps_frames from clones of one state
    and generators of one seed, in SLAM and localization mode, for a chunk
    in which a blank frame goes LOST and the next frames relocalize and
    make keyframes, and for a chunk with two padded slots: the packed
    StepInfos, the map, the carry, the generator and the relocalization
    counts bit for bit.
(c) The relocalization counters (device tensors): a LOST sequence through
    the per-frame API counts one attempt per LOST branch that ran (one
    RANSAC draw each) and one success per recovery; (b) holds the chunk
    runner's counts to op by op's.
(d) A short RGB-D stream through a System with a CPU StepGraph against the
    JAX System (its jitted batch_steps_frames) on the same numpy frames, at
    ROADMAP.md C4's whole-path bounds.
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from self_commit_orb_slam2_tpu_torch.models import config, pipeline, program_graphs, relocalization
from self_commit_orb_slam2_tpu_torch.models import frame as frame_mod
from self_commit_orb_slam2_tpu_torch.models.step_graph import StepGraph
from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
from self_commit_orb_slam2_tpu_torch.ops import bow
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig, extract_batch
from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

torch.set_num_threads(2)   # six test workers share the CPU

CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)
CAPS = dict(max_keyframes=32, max_points=8192, local_points=1024)
N_MAPPED, N_SEQ = 14, 17
# a blank frame goes LOST, the next relocalizes and makes a keyframe, so does
# the one after it; a chunk whose last two slots are padded
PLANS = {"lost_then_keyframe": ([None, 12, 13, 14], [True] * 4),
         "padded": ([14, 15, 16, 16], [True, True, False, False])}


def _config(vocab, max_frames_between_kf=8) -> config.SlamConfig:
    return config.SlamConfig(camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=500),
                             caps=config.Capacities(**CAPS),
                             tracking=config.TrackingConfig(
                                 max_frames_between_kf=max_frames_between_kf),
                             vocab=vocab)


@pytest.fixture(scope="module")
def world():
    seq = generate_sequence(n_frames=N_SEQ, width=320, height=240, fx=260.0, seed=5)
    feats, _ = extract_batch(torch.from_numpy(seq.images[0:16:4].astype(np.float32)),
                             OrbConfig(n_features=300))
    vocab = bow.train_vocabulary(feats.desc[feats.valid].numpy().view(np.uint32), k=8, L=3,
                                 seed=2)
    cfg = _config(vocab)
    slam = System(cfg, enable_mapping=True, enable_loop_closing=False, device="cpu")
    for i in range(N_MAPPED):
        slam.track_rgbd(seq.images[i], seq.depths[i], i / 30.0)
    assert slam.state == STATE_OK and slam.n_keyframes() >= 2

    def make(i):
        img = seq.images[i] if i is not None else np.zeros_like(seq.images[0])
        dep = seq.depths[i] if i is not None else np.zeros_like(seq.depths[0])
        return frame_mod.make_frame_rgbd(cfg, torch.from_numpy(img.astype(np.float32)),
                                         torch.from_numpy(dep.astype(np.float32)))

    def chunk(plan):
        fs = [make(i) for i in plan]
        return type(fs[0])(*(torch.stack(x) for x in zip(*fs)))

    chunks = {k: (chunk(p), torch.tensor(v)) for k, (p, v) in PLANS.items()}
    return dict(seq=seq, cfg=cfg, m=slam.map, carry=slam.carry, chunks=chunks)


def _clone(x):
    return tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, x)


def _meta(x):
    return tree_map(lambda t: t.to("meta") if torch.is_tensor(t) else t, x)


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


class _Ops(TorchDispatchMode):
    """Counts aten ops by name, and the ops that take a CPU tensor of one
    element or more (torch.vmap hands a Python number on as a 0-d CPU
    tensor, which a CUDA kernel takes by value)."""

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


def _record_conds(monkeypatch) -> list:
    """program_graphs.cond replaced by one that records its predicate and
    runs the branch whatever it holds (as a capture records it)."""
    preds = []

    def cond(pred, fn):
        preds.append(pred)
        fn()

    monkeypatch.setattr(program_graphs, "cond", cond)
    return preds


# --------------------------------------------------------------- (a) host-free

def test_chunk_program_is_host_free(world, monkeypatch):
    """SLAM mode (every branch: core, LOST, tail with the mapping pass) on
    the first two slots of the LOST-then-keyframe chunk."""
    cfg, (frames, valid) = world["cfg"], world["chunks"]["lost_then_keyframe"]
    frames = type(frames)(*(x[:2] for x in frames))
    sg = StepGraph(cfg, "cpu")
    sg.capture(_clone(world["m"]), _clone(world["carry"]), frames.select(0), True,
               torch.Generator().manual_seed(0), chunk=frames)
    sg._C.valid.copy_(valid[:2])
    sg._C.ts.copy_(torch.arange(2, dtype=torch.float32))
    # the relocalization's constants, built once per device
    relocalization.relocalize_uncounted(cfg, world["m"], frames.select(1),
                                        torch.Generator().manual_seed(0))
    preds = _record_conds(monkeypatch)
    with _Ops() as ops:
        rows = sg._run_chunk(False, torch.Generator().manual_seed(0))
    assert ops.count["lift_fresh"] == 0 and ops.count["_local_scalar_dense"] == 0
    assert ops.count["multinomial"] == 2   # every slot's LOST branch recorded
    assert rows.shape == (2, 40) and torch.isfinite(rows).all()
    assert len(preds) == 2 * 3   # valid, want_reloc, need_kf a slot
    assert all(p.dtype == torch.bool and p.shape == () for p in preds)

    # on the meta device a host read raises, and so does an operand on the CPU
    # (one slot: the slots run the same code)
    mcfg = cfg._replace(vocab=cfg.vocab.to("meta"))
    meta = StepGraph(mcfg, "meta")
    one = _meta(type(frames)(*(x[:1] for x in frames)))
    meta.capture(_meta(world["m"]), _meta(world["carry"]), one.select(0), True, None,
                 chunk=one)
    preds.clear()
    with _Ops() as ops:
        rows_meta = meta._run_chunk(False, None)
    assert ops.cpu_operands == []
    assert rows_meta.device.type == "meta" and rows_meta.shape == (1, 40)
    assert len(preds) == 3 and all(p.device.type == "meta" for p in preds)


# ---------------------------------------------- (b) the runner against the chunk op by op

@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("loc", [False, True], ids=["slam", "localization"])
def test_chunk_runner_equals_batch_steps_frames(world, plan, loc):
    cfg, (frames, valid) = world["cfg"], world["chunks"][plan]
    ts = torch.arange(4, dtype=torch.float32) + 1.0
    runs = {}
    for graphed in (False, True):
        m, carry = _clone(world["m"]), _clone(world["carry"])
        gen = torch.Generator().manual_seed(23)
        relocalization.reset_counts()
        if graphed:
            sg = StepGraph(cfg, "cpu")
            m, carry, packed = sg.batch_steps(m, carry, frames, ts, valid, True, gen,
                                              localization_only=loc)
            assert sg.replays == 0 and not sg.graphed
        else:
            m, carry, packed = pipeline.batch_steps_frames(cfg, m, carry, frames, ts, valid,
                                                           True, localization_only=loc,
                                                           generator=gen)
        runs[graphed] = (packed, m, carry, gen.get_state(), relocalization.counts())
    (p_e, m_e, c_e, g_e, n_e), (p_g, m_g, c_g, g_g, n_g) = runs[False], runs[True]
    assert torch.equal(p_e, p_g)
    assert _equal(m_e, m_g) and _equal(c_e, c_g)
    assert torch.equal(g_e, g_g) and n_e == n_g

    # what the plans are for
    infos = pipeline.unpack_infos(p_e.numpy())
    if plan == "lost_then_keyframe":
        assert list(infos.state_ok) == [False, True, True, True]
        assert n_e == (2, 1)   # the blank frame's attempt fails, the next recovers
        if not loc:
            assert infos.created_kf[1] and infos.created_kf[2]
            assert int(m_e.n_kf) == int(world["m"].n_kf) + int(infos.created_kf.sum())
    else:
        assert n_e == (0, 0) and list(infos.state_ok) == [True] * 4
        assert not infos.created_kf[2:].any()   # a padded slot makes no keyframe
        skip = pipeline.pack_infos([pipeline._skip_info(m_e, c_e)])[0]
        assert torch.equal(p_e[3], skip) and torch.equal(p_e[2], skip)
    if loc:
        assert not infos.created_kf.any() and int(m_e.n_kf) == int(world["m"].n_kf)


# ------------------------------------------------------------- (c) the counters

def test_relocalization_counters_count_lost_branches(world):
    """The LOST-then-keyframe chunk's frames through the per-frame API
    (StepGraph.step): each LOST branch that runs is one attempt (one RANSAC
    draw), each recovery one success, counted in place on the device; the
    chunk runner and the chunk op by op count the same in (b)."""
    cfg, (frames, _) = world["cfg"], world["chunks"]["lost_then_keyframe"]
    relocalization.reset_counts()
    counters = relocalization.counters("cpu")
    assert counters.dtype == torch.int64 and counters.shape == (2,)
    sg = StepGraph(cfg, "cpu")
    m, carry = _clone(world["m"]), _clone(world["carry"])
    gen = torch.Generator().manual_seed(23)
    states = []
    with _Ops() as ops:
        for b in range(4):
            m, carry, row = sg.step(m, carry, frames.select(b), torch.tensor(1.0), True, gen)
            states.append(bool(row[34] > 0.5))
    assert states == [False, True, True, True]
    assert relocalization.counts() == (ops.count["multinomial"], 1) == (2, 1)
    assert relocalization.counters("cpu") is counters and counters.tolist() == [2, 1]


# ----------------------------------------------------------- (d) against JAX

def test_chunk_runner_slice_matches_jax(world):
    """13 frames of the sequence (no vocabulary, local mapping off, a
    keyframe every 4 frames at most) through the port's System with a CPU
    StepGraph and through the JAX System, both in chunks of 4."""
    from self_commit_orb_slam2_tpu.models import config as jconfig
    from self_commit_orb_slam2_tpu.models import system as jsystem
    from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
    from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb

    seq, n = world["seq"], 13
    jcfg = jconfig.SlamConfig(camera=JCam.create(**CAM), orb=JOrb(n_features=500),
                              caps=jconfig.Capacities(**CAPS),
                              tracking=jconfig.TrackingConfig(max_frames_between_kf=4))
    jsys = jsystem.System(jcfg, enable_mapping=False, enable_loop_closing=False)
    jsys.track_batch_rgbd(seq.images[:n], seq.depths[:n], seq.timestamps[:n], chunk=4)
    _, jest = jsys.get_trajectory()

    cfg = _config(None, max_frames_between_kf=4)
    slam = System(cfg, enable_mapping=False, enable_loop_closing=False, device="cpu")
    slam.step_graph = StepGraph(cfg, "cpu")
    slam.track_batch_rgbd(seq.images[:n], seq.depths[:n], seq.timestamps[:n], chunk=4)
    _, est = slam.get_trajectory()

    def centres(P):
        return -np.einsum("nij,ni->nj", P[:, :3, :3], P[:, :3, 3])

    assert est.shape == jest.shape == (n, 4, 4)
    assert jsys.state == 1 and slam.state == STATE_OK
    ate_port, ate_jax = ate_rmse(est, seq.poses_gt[:n]), ate_rmse(jest, seq.poses_gt[:n])
    assert abs(ate_port - ate_jax) <= 0.01
    assert np.abs(centres(est) - centres(jest)).max() <= 0.02
    assert abs(slam.n_keyframes() - int(jsys.map.n_kf)) <= 1
    assert slam.step_graph._C is not None   # the chunks went through the chunk runner
