"""The loop closer's detection and correction as captured programs
(models/program_graphs.py), and the host-free Horn eigensolver, on the CPU.

The loop state is the port's own, built once for the module as
tests/test_torch_loop_closing.py builds the JAX one (320x240, 500 features,
the bundled vocabulary): 20 frames of a spin with a keyframe every 2 frames,
drift injected along the keyframe chain, a re-initialization at frame 0 on
that map and 4 more frames, so the newest keyframe revisits the first ones.

(a) Under a TorchDispatchMode, detect_and_verify and correct_loop build no
    tensor from host data (aten.lift_fresh) and read nothing back
    (aten._local_scalar_dense), and both run on the meta device with no
    operand on the CPU (detection with fixed minimal sets there: the meta
    device draws nothing).  On the card neither syncs, so a CUDA graph
    captures each.
(b) CloserGraphs on the CPU (the plain version: the same calls on its
    static map, slot and detection) against the direct calls, twice in a
    row from generators of one seed: detections and corrected maps equal bit
    for bit, so the runner draws as the direct call does.  A LoopCloser with
    the runner against one without, through dispatch_group and resolve: the
    same closures, re-base payloads and map, bit for bit.
(c) horn.top_eigenvector (cyclic Jacobi in float64, no host read) against
    torch.linalg.eigh in float64 on random, nearly degenerate (an eigengap
    of 1e-3) and scaled symmetric fp32 4x4 matrices: within 1e-6, up to the
    eigenvector's sign (fp32 eigh itself is 1e-5 to 1e-3 off on these);
    and horn_align against the JAX
    package's on the same numpy inputs, within 1e-5 (the bound of
    tests/test_torch_solvers.py), batched with a row whose weights are all
    zero: that row gives a finite identity rotation, which loses its vote.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from self_commit_orb_slam2_tpu.ops.solvers.horn import horn_align as jhorn
from self_commit_orb_slam2_tpu_torch.models import config, loop_closing
from self_commit_orb_slam2_tpu_torch.models import map_state as ms
from self_commit_orb_slam2_tpu_torch.models.program_graphs import CloserGraphs
from self_commit_orb_slam2_tpu_torch.models.system import STATE_NOT_INITIALIZED, System
from self_commit_orb_slam2_tpu_torch.ops import bow, se3
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.ops.solvers.horn import horn_align, top_eigenvector
from self_commit_orb_slam2_tpu_torch.utils.drift import displace_old_content
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence, spin_trajectory

torch.set_num_threads(2)   # six test workers share the CPU

CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)
CAPS = dict(max_keyframes=24, max_points=4096, local_points=512)
N_FIRST, N_SECOND, N_DRIFT = 20, 4, 15
DRIFT = [0.01, 0.002, -0.0033, 0.0, 0.0093, 0.0]  # per increment, as the loop-closing tests


def _config(**track) -> config.SlamConfig:
    return config.SlamConfig(
        camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=500),
        caps=config.Capacities(**CAPS),
        tracking=config.TrackingConfig(max_frames_between_kf=2, **track),
        vocab=bow.load_vocabulary(bow.default_vocab_path()))


@pytest.fixture(scope="module")
def state():
    cfg = _config()
    seq = generate_sequence(n_frames=N_FIRST, width=320, height=240, seed=9,
                            trajectory=spin_trajectory(N_FIRST, frames_per_rev=72))
    slam = System(cfg, enable_mapping=True, enable_loop_closing=False, device="cpu")
    slam.track_batch_rgbd(seq.images, seq.depths, seq.timestamps, chunk=4)
    m = slam.map
    newest = int(m.n_kf) - 1
    D = se3.se3_exp(torch.tensor(DRIFT))
    for j in range(N_DRIFT):
        m = displace_old_content(m, D, 1.0, keep_recent=newest - j)
    slam.map, slam.carry, slam.state = m, None, STATE_NOT_INITIALIZED
    slam.track_batch_rgbd(seq.images[:N_SECOND], seq.depths[:N_SECOND],
                          seq.timestamps[:N_SECOND] + 10.0, chunk=4)
    m = slam.map
    kf = int(ms.latest_kf(m))
    det = loop_closing.detect_and_verify(cfg, m, torch.tensor(kf, dtype=torch.int32),
                                         torch.Generator().manual_seed(7))
    assert bool(det.found), "the scenario must hold a verified loop"
    return dict(cfg=cfg, m=m, kf=kf, det=det)


class _Ops(TorchDispatchMode):
    """Counts aten ops by name, and the ops that take a CPU tensor."""

    def __init__(self):
        super().__init__()
        self.count = collections.Counter()
        self.cpu_operands = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count[func.overloadpacket.__name__] += 1
        if any(torch.is_tensor(x) and x.device.type == "cpu"
               for x in tree_leaves((args, kwargs or {}))):
            self.cpu_operands.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _meta(x):
    return tree_map(lambda t: t.to("meta") if torch.is_tensor(t) else t, x)


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_detect_and_correct_are_host_free(state):
    cfg, m, kf, det = state["cfg"], state["m"], state["kf"], state["det"]
    kf_t = torch.tensor(kf, dtype=torch.int32)
    with _Ops() as ops:
        loop_closing.detect_and_verify(cfg, m, kf_t, torch.Generator().manual_seed(7))
    assert ops.count["lift_fresh"] == 0 and ops.count["_local_scalar_dense"] == 0
    assert ops.count["multinomial"] == 1 and sum(ops.count.values()) > 5000
    with _Ops() as ops:
        corrected = loop_closing.correct_loop(cfg, m, kf_t, det)
    assert ops.count["lift_fresh"] == 0 and ops.count["_local_scalar_dense"] == 0
    assert int(corrected.n_loop) == int(m.n_loop) + 1

    # on the meta device a host read raises, and so does an operand on the CPU
    sets = torch.zeros(loop_closing.N_CANDIDATES, loop_closing.N_HYPOTHESES, 3,
                       dtype=torch.int64)
    args = _meta((m, kf_t, sets, det))
    with _Ops() as ops:
        d_meta = loop_closing.detect_and_verify(cfg, args[0], args[1], sets=args[2])
        m_meta = loop_closing.correct_loop(cfg, args[0], args[1], args[3])
    assert ops.cpu_operands == []
    for got, like in ((d_meta, det), (m_meta, corrected)):
        assert all(t.device.type == "meta" for t in tree_leaves(got))
        assert [t.shape for t in tree_leaves(got)] == [t.shape for t in tree_leaves(like)]


def test_runner_equals_the_direct_calls(state):
    cfg, m, kf, det = state["cfg"], state["m"], state["kf"], state["det"]
    kf_t = torch.tensor(kf, dtype=torch.int32)
    runner = CloserGraphs(cfg, "cpu", pool=None)
    g_run, g_direct = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    for _ in range(2):   # the second call draws from the advanced generators
        got = runner.detect(m, kf, g_run)
        want = loop_closing.detect_and_verify(cfg, m, kf_t, g_direct)
        assert _equal(got, want)
    assert torch.equal(g_run.get_state(), g_direct.get_state())
    assert _equal(runner.correct(m, kf, det), loop_closing.correct_loop(cfg, m, kf_t, det))


def test_closer_through_the_runner_equals_op_by_op(state):
    cfg, m, kf = _config(loop_consistency_th=1, enable_loop_gba=False), state["m"], state["kf"]
    out = {}
    for graphs in (None, CloserGraphs(cfg, "cpu", pool=None)):
        lc = loop_closing.LoopCloser(cfg, torch.Generator().manual_seed(7))
        lc.graphs = graphs
        if graphs is not None:
            m_before = tree_map(torch.clone, m)
            lc.warmup(m)   # touches neither the closer's draws nor the map
            assert _equal(m, m_before) and lc.pending() == 0
        lc.dispatch_group(m, [kf])
        m2, fired = lc.resolve(m, block=True)
        out[graphs is None] = (m2, fired, lc.debug_log, lc.generator.get_state())
    (m_e, fired_e, log_e, gen_e), (m_g, fired_g, log_g, gen_g) = out[True], out[False]
    assert len(fired_e) == 1 and log_e == log_g
    assert _equal(fired_e, fired_g) and _equal(m_e, m_g) and torch.equal(gen_e, gen_g)


def _symmetric(kind: str, n: int, g: torch.Generator) -> torch.Tensor:
    if kind == "close":
        Q, _ = torch.linalg.qr(torch.randn(n, 4, 4, generator=g, dtype=torch.float64))
        lam = torch.tensor([1.0, 2.0, 3.0, 3.001], dtype=torch.float64)
        return (Q @ torch.diag_embed(lam.expand(n, 4)) @ Q.transpose(-1, -2)).float()
    X = torch.randn(n, 4, 4, generator=g)
    A = X + X.transpose(-1, -2)
    return A * 1e4 if kind == "scaled" else A


@pytest.mark.parametrize("kind", ["random", "close", "scaled"])
def test_top_eigenvector_matches_eigh(kind):
    A = _symmetric(kind, 4096, torch.Generator().manual_seed(1))
    got = top_eigenvector(A).double()
    want = torch.linalg.eigh(A.double())[1][..., :, -1]
    err = torch.minimum((got - want).norm(dim=-1), (got + want).norm(dim=-1))
    assert float(err.max()) < 1e-6
    assert float((got.norm(dim=-1) - 1).abs().max()) < 1e-6


@pytest.mark.parametrize("with_scale", [False, True])
def test_horn_align_matches_jax_with_a_weightless_row(with_scale):
    rng = np.random.default_rng(11)
    src = rng.normal(size=(3, 40, 3)).astype(np.float32)
    R = Rotation.random(3, random_state=5).as_matrix().astype(np.float32)
    dst = (1.7 if with_scale else 1.0) * np.einsum("bij,bnj->bni", R, src) + 0.3
    dst = dst.astype(np.float32)
    w = rng.uniform(0.5, 2.0, (3, 40)).astype(np.float32)
    w[2] = 0.0                                  # no correspondence in the last row
    got = horn_align(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w),
                     with_scale=with_scale)
    want = jhorn(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), with_scale=with_scale)
    for g, j, name in zip(got, want, "sRt"):
        np.testing.assert_allclose(g.numpy()[:2], np.asarray(j)[:2], rtol=0, atol=1e-5,
                                   err_msg=name)
        assert np.isfinite(g.numpy()).all()
    np.testing.assert_array_equal(got[1][2].numpy(), np.eye(3, dtype=np.float32))
