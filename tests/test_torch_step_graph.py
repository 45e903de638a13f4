"""The step graphs' runner (models/step_graph.py) and the split step it
captures, on the CPU.

(a) Under a TorchDispatchMode, pipeline.step_core and pipeline.keyframe_tail
    build no tensor from host data (aten.lift_fresh) and read nothing back
    (aten._local_scalar_dense), and both run on the meta device with no
    operand on the CPU: on the card neither holds a copy from the host or a
    sync, so a CUDA graph captures both.  pipeline.track_step as a whole
    reads once, as its docstring states.
(b) A CPU System with a StepGraph (the runner's plain version: the captured
    functions called on its static buffers) against one without, over a
    21-frame RGB-D stream with mapping on: keyframes inside a chunk, the
    per-frame API, a map replaced between chunks (save_map / load_map) and
    a reset(): poses, trajectories, maps and carries equal bit for bit.  A
    runner that tracked against a stale static map fails here.
(c) The slice through the runner against the JAX package on the same numpy
    frames, at the bounds of tests/test_torch_slice.py.

320x240, 500 features, the bench's capacities.
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from self_commit_orb_slam2_tpu_torch.models import config, pipeline
from self_commit_orb_slam2_tpu_torch.models import frame as frame_mod
from self_commit_orb_slam2_tpu_torch.models.map_state import MapState
from self_commit_orb_slam2_tpu_torch.models.step_graph import StepGraph
from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

# as in the other slice files: 2 intra-op threads per test worker
torch.set_num_threads(2)

W, H, FX, N_FEAT, N_FRAMES = 320, 240, 260.0, 500, 21
CAPS = dict(max_keyframes=64, max_points=16384, local_points=1024)  # bench.py:116
CAM = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=FX * 0.1, width=W, height=H)


def _config(max_frames_between_kf: int) -> config.SlamConfig:
    return config.SlamConfig(
        camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=N_FEAT),
        caps=config.Capacities(**CAPS),
        tracking=config.TrackingConfig(max_frames_between_kf=max_frames_between_kf))


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(n_frames=N_FRAMES, width=W, height=H, fx=FX, seed=5)


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


def _clone(x):
    return type(x)(*(v.clone() if torch.is_tensor(v) else _clone(v) for v in x))


def _to(x, device):
    return type(x)(*(v.to(device) if torch.is_tensor(v) else _to(v, device) for v in x))


@pytest.fixture(scope="module")
def mid_stream(seq):
    """A System after 9 frames (mapping on, a keyframe every 4 frames at
    most, so every part and constant has run once) and the tenth frame."""
    cfg = _config(4)
    slam = System(cfg, enable_mapping=True, enable_loop_closing=False, device="cpu")
    slam.track_batch_rgbd(seq.images[:9], seq.depths[:9], seq.timestamps[:9], chunk=4)
    frame = frame_mod.make_frame_rgbd(cfg, torch.from_numpy(seq.images[9].astype(np.float32)),
                                      torch.from_numpy(seq.depths[9].astype(np.float32)))
    return cfg, slam, frame, torch.tensor(float(seq.timestamps[9]))


def _core_and_tail(cfg, m, carry, frame, ts):
    core = pipeline.step_core(cfg, m, carry, frame)
    return pipeline.keyframe_tail(cfg, m, core.carry, frame, core.lres.obs_pt, carry.frame_id,
                                  ts, True, core.info)


def test_core_and_tail_are_host_free(mid_stream):
    cfg, slam, frame, ts = mid_stream
    with _Ops() as ops:
        core = pipeline.step_core(cfg, slam.map, slam.carry, frame)
    assert ops.count["lift_fresh"] == 0 and ops.count["_local_scalar_dense"] == 0
    assert sum(ops.count.values()) > 1000  # the core did run
    m = _clone(slam.map)
    with _Ops() as ops:
        m2, _, _ = pipeline.keyframe_tail(cfg, m, core.carry, frame, core.lres.obs_pt,
                                          slam.carry.frame_id, ts, True, core.info)
    assert ops.count["lift_fresh"] == 0 and ops.count["_local_scalar_dense"] == 0
    assert int(m2.n_kf) == int(slam.map.n_kf) + 1

    # on the meta device a host read raises, and so does an operand on the CPU
    args = [_to(x, "meta") for x in (slam.map, slam.carry, frame)] + [ts.to("meta")]
    with _Ops() as ops:
        m3, carry3, info3 = _core_and_tail(cfg, *args)
    assert ops.cpu_operands == []
    assert all(t.device.type == "meta" for t in (*m3, *carry3[:2], *info3))


def test_track_step_reads_once(mid_stream):
    """The one host read of pipeline.track_step's docstring (SLAM mode, no
    vocabulary), on a frame that inserts a keyframe and runs the mapping
    pass, and no tensor built from host data."""
    cfg, slam, frame, ts = mid_stream
    m, carry = _clone(slam.map), _clone(slam.carry)
    carry = carry._replace(last_kf_frame_id=carry.frame_id - 4)  # due for a keyframe
    with _Ops() as ops:
        m2, _, info = pipeline.track_step(cfg, m, carry, frame, ts, True)
    assert bool(info.created_kf)
    assert ops.count["_local_scalar_dense"] == 1
    assert ops.count["lift_fresh"] == 0


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(tuple(a)), tree_leaves(tuple(b))))


def _scenario(seq, slam, tmp_path):
    """Chunks, the per-frame API, a map replaced between chunks, a reset;
    returns the poses each call gave and the final trajectory."""
    imgs, deps, ts = seq.images, seq.depths, seq.timestamps
    out = [slam.track_batch_rgbd(imgs[:13], deps[:13], ts[:13], chunk=4)]
    kf_frames = slam.map.kf_frame_id[slam.map.kf_valid].tolist()
    path = str(tmp_path / f"map_{id(slam)}.npz")
    slam.save_map(path)
    out += [slam.track_rgbd(imgs[i], deps[i], float(ts[i]))[None] for i in (13, 14, 15)]
    out.append(slam.track_batch_rgbd(imgs[16:20], deps[16:20], ts[16:20], chunk=4))
    n_kf_before_load = slam.n_keyframes()
    slam.load_map(path)        # the map of frame 12 replaces that of frame 19
    out.append(slam.track_batch_rgbd(imgs[[20, 16, 15, 14]], deps[[20, 16, 15, 14]],
                                     ts[16:20] + 1.0, chunk=4))
    out.append(slam.track_rgbd(imgs[13], deps[13], float(ts[19]) + 2.0)[None])
    slam.reset()
    out.append(slam.track_batch_rgbd(imgs[:5], deps[:5], ts[:5], chunk=4))
    return np.concatenate(out), slam.get_trajectory(), kf_frames, n_kf_before_load


def test_runner_equals_eager_stream_bitwise(seq, tmp_path):
    cfg = _config(5)
    runs = []
    for graphed in (False, True):
        slam = System(cfg, enable_mapping=True, enable_loop_closing=False, device="cpu")
        if graphed:
            slam.step_graph = StepGraph(cfg, "cpu")
        runs.append((slam, *_scenario(seq, slam, tmp_path)))
    (eager, p_e, (t_e, T_e), kf_e, n_e), (graph, p_g, (t_g, T_g), kf_g, n_g) = runs

    # the scenario holds what it is for: keyframes inside a chunk (chunks of
    # frames 1-4, 5-8, 9-12), a loaded map smaller than the live one
    assert any((f - 1) % 4 != 3 for f in kf_e[1:]), kf_e
    assert n_e > len(kf_e)
    assert graph.step_graph.replays == 0 and not graph.step_graph.graphed

    assert p_e.shape == p_g.shape and np.array_equal(p_e, p_g)
    assert kf_e == kf_g and n_e == n_g
    assert np.array_equal(t_e, t_g) and np.array_equal(T_e, T_g)
    assert _equal(eager.map, graph.map)
    assert _equal(eager.carry, graph.carry)
    assert eager.state == graph.state == STATE_OK
    assert isinstance(graph.map, MapState)


def test_runner_slice_matches_jax(seq):
    """tests/test_torch_slice.py's stream through the runner."""
    from self_commit_orb_slam2_tpu.models import config as jconfig
    from self_commit_orb_slam2_tpu.models import system as jsystem
    from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
    from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb

    jcfg = jconfig.SlamConfig(camera=JCam.create(**CAM), orb=JOrb(n_features=N_FEAT),
                              caps=jconfig.Capacities(**CAPS),
                              tracking=jconfig.TrackingConfig(max_frames_between_kf=10))
    jsys = jsystem.System(jcfg, enable_mapping=False, enable_loop_closing=False)
    jsys.track_batch_rgbd(seq.images, seq.depths, seq.timestamps, chunk=4)
    _, jest = jsys.get_trajectory()

    cfg = _config(10)
    slam = System(cfg, enable_mapping=False, enable_loop_closing=False, device="cpu")
    slam.step_graph = StepGraph(cfg, "cpu")
    slam.track_batch_rgbd(seq.images, seq.depths, seq.timestamps, chunk=4)
    _, est = slam.get_trajectory()

    def centres(P):
        return -np.einsum("nij,ni->nj", P[:, :3, :3], P[:, :3, 3])

    assert est.shape == (N_FRAMES, 4, 4)
    assert jsys.state == 1 and slam.state == STATE_OK
    ate_port, ate_jax = ate_rmse(est, seq.poses_gt), ate_rmse(jest, seq.poses_gt)
    assert ate_port < 0.02
    assert abs(ate_port - ate_jax) <= 0.01
    assert np.abs(centres(est) - centres(jest)).max() <= 0.02
    assert slam.n_keyframes() >= 2 and slam.n_points() > 100
