"""The sliced global BA and its merge as captured programs
(models/program_graphs.py CloserGraphs: load_gba, gba_slice, merge), on
the CPU.

The world: 320x240, 500 features, a System (local mapping on) that tracks
13 frames; its map (keyframes, points, the cull archive) is the GBA's
snapshot and the live map.

(a) Under a TorchDispatchMode, global_bundle_adjust_slice of both kinds
    (the anchor slot a 0-d tensor) and merge_gba build no tensor from host
    data (aten.lift_fresh) and read nothing back (aten._local_scalar_dense),
    and run on the meta device with no operand on the CPU: on the card
    none syncs, so a CUDA graph captures each.
(b) The runner's programs on the CPU (the plain versions: the functions on
    the static snapshot, pair and anchor) against the direct calls: the ten
    slices of GBA_SLICES and the merge, bit for bit, the anchor's pose
    untouched; then a GBA dropped after three slices and a new one loaded
    at phase 0 on another map and anchor (what a newer correction does):
    its ten slices and merge equal the direct calls on that map, bit for
    bit, and the first GBA's outputs, already handed out, are untouched.
(c) A LoopCloser whose GBA runs through the runner against one that runs it
    op by op, through _dispatch_gba / resolve: the same phases, the same
    merged map, bit for bit.
The GBA's numbers against the JAX package are held by
tests/test_torch_loop_closing.py (the whole and sliced GBA, the merge, and
a GBA aborted mid-slice by a newer correction).
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from self_commit_orb_slam2_tpu_torch.models import config, loop_closing
from self_commit_orb_slam2_tpu_torch.models.program_graphs import CloserGraphs
from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
from self_commit_orb_slam2_tpu_torch.ops import bow, se3
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

torch.set_num_threads(2)   # six test workers share the CPU

CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)
N_FRAMES = 13


def _config(vocab=None) -> config.SlamConfig:
    return config.SlamConfig(camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=500),
                             caps=config.Capacities(max_keyframes=16, max_points=4096,
                                                    local_points=512),
                             tracking=config.TrackingConfig(max_frames_between_kf=3),
                             vocab=vocab)


@pytest.fixture(scope="module")
def world():
    seq = generate_sequence(n_frames=N_FRAMES, width=320, height=240, seed=5)
    cfg = _config()
    slam = System(cfg, enable_mapping=True, enable_loop_closing=False, device="cpu")
    slam.track_batch_rgbd(seq.images, seq.depths, seq.timestamps, chunk=4)
    assert slam.state == STATE_OK and slam.n_keyframes() >= 4
    m = slam.map
    # a second live map: every pose and point moved a little (a newer correction's map)
    rng = np.random.default_rng(0)
    K, P = m.max_kf, m.max_pt
    noise = se3.se3_exp(torch.from_numpy(rng.normal(0, 0.005, (K, 6)).astype(np.float32)))
    m2 = m._replace(kf_Tcw=torch.where(m.kf_valid[:, None, None], noise @ m.kf_Tcw, m.kf_Tcw),
                    pt_pos=m.pt_pos + torch.from_numpy(
                        rng.normal(0, 0.005, (P, 3)).astype(np.float32)) * m.pt_valid[:, None])
    return dict(cfg=cfg, m=m, m2=m2)


class _Ops(TorchDispatchMode):
    """Counts aten ops by name, and the ops that take a CPU tensor of one
    element or more."""

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


def _merge_inputs(m):
    """A GBA result to merge into m: poses and points moved, the newest
    keyframe and a tenth of the points not in the snapshot."""
    rng = np.random.default_rng(1)
    snap_seq = m.kf_seq.clone()
    newest = int(torch.argmax(torch.where(m.kf_valid, m.kf_seq, -1)))
    snap_seq[newest] = 10_000
    snap_birth = m.pt_birth.clone()
    snap_birth[torch.from_numpy(rng.random(m.max_pt) < 0.1)] -= 1
    T = m.kf_Tcw.clone()
    T[:, :3, 3] += 0.01
    return snap_seq, snap_birth, T, m.pt_pos + 0.01


# --------------------------------------------------------------- (a) host-free

@pytest.mark.parametrize("huber", [True, False])
def test_gba_slice_is_host_free(world, huber):
    cfg, m = world["cfg"], world["m"]
    anchor = torch.tensor(1, dtype=torch.int32)
    args = (cfg, m, m.kf_Tcw, m.pt_pos, anchor, huber)
    loop_closing.global_bundle_adjust_slice(*args)   # the per-device constants are built once
    with _Ops() as ops:
        T, p = loop_closing.global_bundle_adjust_slice(*args)
    assert ops.count["lift_fresh"] == 0 and ops.count["_local_scalar_dense"] == 0
    assert sum(ops.count.values()) > 200
    assert not torch.equal(T, m.kf_Tcw) and torch.equal(T[1], m.kf_Tcw[1])   # the anchor holds

    margs = _meta((m, m.kf_Tcw, m.pt_pos, anchor))
    with _Ops() as ops:
        got = loop_closing.global_bundle_adjust_slice(cfg, *margs, huber)
    assert ops.cpu_operands == []
    assert [t.device.type for t in got] == ["meta", "meta"]
    assert [t.shape for t in got] == [T.shape, p.shape]


def test_merge_is_host_free(world):
    m = world["m"]
    args = (m, *_merge_inputs(m))
    with _Ops() as ops:
        want = loop_closing.merge_gba(*args)
    assert ops.count["lift_fresh"] == 0 and ops.count["_local_scalar_dense"] == 0
    margs = _meta(args)
    with _Ops() as ops:
        got = loop_closing.merge_gba(*margs)
    assert ops.cpu_operands == []
    assert all(t.device.type == "meta" for t in got)
    assert [t.shape for t in got] == [t.shape for t in want]


# ------------------------------------------------------------------ (b) runner

def _direct_gba(cfg, m, anchor):
    T, p = m.kf_Tcw.clone(), m.pt_pos.clone()
    for huber in loop_closing.GBA_SLICES:
        T, p = loop_closing.global_bundle_adjust_slice(cfg, m, T, p, anchor, huber)
    return T, p


def test_runner_equals_the_direct_calls_across_a_reload(world):
    cfg, m, m2 = world["cfg"], world["m"], world["m2"]
    runner = CloserGraphs(cfg, "cpu", pool=None)
    # a first GBA on m anchored at 1 ...
    runner.load_gba(m, 1)
    T, p = m.kf_Tcw.clone(), m.pt_pos.clone()
    outs = []
    for huber in loop_closing.GBA_SLICES:
        T, p = runner.gba_slice(T, p, huber)
        outs.append((T, p, T.clone(), p.clone()))
    assert _equal((T, p), _direct_gba(cfg, m, 1))
    assert torch.equal(T[1], m.kf_Tcw[1]) and not torch.equal(T, m.kf_Tcw)
    merged = runner.merge(m, *_merge_inputs(m)[:2], T, p)
    want = loop_closing.merge_gba(m, *_merge_inputs(m)[:2], T, p)
    assert _equal(merged, want) and merged.kf_valid is m.kf_valid
    # ... then one on m2 anchored at 2, dropped after three slices, reloaded
    runner.load_gba(m2, 2)
    T, p = m2.kf_Tcw.clone(), m2.pt_pos.clone()
    for huber in loop_closing.GBA_SLICES[:3]:
        T, p = runner.gba_slice(T, p, huber)
    runner.load_gba(m2, 3)
    T, p = m2.kf_Tcw.clone(), m2.pt_pos.clone()
    for huber in loop_closing.GBA_SLICES:
        T, p = runner.gba_slice(T, p, huber)
    want_T, want_p = _direct_gba(cfg, m2, 3)
    assert _equal((T, p), (want_T, want_p)) and torch.equal(T[3], m2.kf_Tcw[3])
    assert _equal(runner.merge(m2, m2.kf_seq, m2.pt_birth, T, p),
                  loop_closing.merge_gba(m2, m2.kf_seq, m2.pt_birth, want_T, want_p))
    for T1, p1, T0, p0 in outs:    # outputs handed out earlier are untouched
        assert torch.equal(T1, T0) and torch.equal(p1, p0)
    assert len(runner.gba_programs) == 2 and runner.merge_program is not None


# ------------------------------------------------------------- (c) the closer

def test_closer_gba_through_the_runner_equals_op_by_op(world):
    cfg, m = world["cfg"]._replace(vocab=bow.load_vocabulary(bow.default_vocab_path())), world["m"]
    out = {}
    for graphed in (False, True):
        lc = loop_closing.LoopCloser(cfg, torch.Generator().manual_seed(7))
        if graphed:
            lc.graphs = CloserGraphs(cfg, "cpu", pool=None)
        lc._dispatch_gba(m, 2)
        assert lc._pending_gba["phase"] == 0 and ("snap" in lc._pending_gba) != graphed
        live, phases = world["m2"], []
        for _ in range(len(loop_closing.GBA_SLICES)):
            live, fired = lc.resolve(live)
            phases.append(lc._pending_gba["phase"])
            assert fired == []
        live, fired = lc.resolve(live)     # the call after the last slice merges
        assert lc._pending_gba is None and len(fired) == 1
        out[graphed] = (phases, live, fired)
    (ph_e, m_e, f_e), (ph_g, m_g, f_g) = out[False], out[True]
    assert ph_e == ph_g == list(range(1, len(loop_closing.GBA_SLICES) + 1))
    assert _equal(m_e, m_g) and _equal(f_e, f_g)
    assert not torch.equal(m_g.kf_Tcw, world["m2"].kf_Tcw)
