"""The streamed frame phase as a captured program (models/program_graphs.py),
on the CPU.

(a) Under a TorchDispatchMode, pipeline.frames_{rgbd,stereo,mono}_packed
    build no tensor from host data (aten.lift_fresh) and read nothing back
    (aten._local_scalar_dense), at 16-px cells (the band kernel's plain
    version) and at 8-px cells (the NMS kernel's), and run on the meta
    device with no operand on the CPU (there the kernels' plain versions
    stand in for their wrappers, which refuse a device without a kernel):
    on the card the phase holds no copy from the host and no sync, so a
    CUDA graph captures it.
(b) FrameGraphs on the CPU (the plain version: the same function on its
    static buffers, after the packed chunk is copied in) against the direct
    call on three chunks in turn, per sensor: every output equal bit for bit,
    and a chunk's outputs untouched by the next chunk's run.
(c) A System's runners (its StepGraph, their shared pool, the closer's
    programs) hold no reference cycle: dropped, they are freed at once, with
    the cycle collector off.  On the card a cycle is freed by the collector
    at any moment, and freeing a CUDA graph during another capture
    invalidates that capture.
The extraction the phase runs is held to the JAX package by
tests/test_torch_orb.py, and the stream through the runner (a CPU
StepGraph's FrameGraphs) by tests/test_torch_step_graph.py (c).

320x240, 500 features.
"""

import collections
import gc
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from self_commit_orb_slam2_tpu_torch.models import config, pipeline
from self_commit_orb_slam2_tpu_torch.models.program_graphs import FrameGraphs
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb import fast_band, fast_nms
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

torch.set_num_threads(2)   # six test workers share the CPU

W, H, FX, N_FEAT, B = 320, 240, 260.0, 500, 2
FRAME_PHASES = {"rgbd": pipeline.frames_rgbd_packed, "stereo": pipeline.frames_stereo_packed,
                "mono": pipeline.frames_mono_packed}
CAM = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=FX * 0.1, width=W, height=H)


def _config(sensor: str, cell: int = 16) -> config.SlamConfig:
    return config.SlamConfig(camera=CameraParams.create(**CAM),
                             orb=OrbConfig(n_features=N_FEAT, cell_size=cell), sensor=sensor)


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(n_frames=3 * B, width=W, height=H, fx=FX, seed=5,
                             stereo_baseline=0.1)


def _chunk(seq, sensor: str, k: int = 0) -> np.ndarray:
    sl = slice(k * B, (k + 1) * B)
    images = np.clip(seq.images[sl], 0, 255).astype(np.uint8)
    ts, valid = seq.timestamps[sl].astype(np.float32), np.array([True, k != 2])
    if sensor == "rgbd":
        depth = np.clip(seq.depths[sl] * 1e3, 0, 65535).astype(np.uint16)
        return pipeline.pack_rgbd_chunk(images, depth, ts, valid)
    if sensor == "stereo":
        right = np.clip(seq.right_images[sl], 0, 255).astype(np.uint8)
        return pipeline.pack_stereo_chunk(images, right, ts, valid)
    return pipeline.pack_mono_chunk(images, ts, valid)


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


@pytest.mark.parametrize("sensor,cell", [("rgbd", 16), ("rgbd", 8), ("stereo", 16),
                                         ("mono", 16)])
def test_frame_phase_is_host_free(seq, sensor, cell, monkeypatch):
    cfg = _config(sensor, cell)
    buf = torch.from_numpy(_chunk(seq, sensor))
    fn = FRAME_PHASES[sensor]
    fn(cfg, buf)                       # the per-device constants are built once
    with _Ops() as ops:
        frames, ts, valid = fn(cfg, buf)
    assert ops.count["lift_fresh"] == 0 and ops.count["_local_scalar_dense"] == 0
    assert sum(ops.count.values()) > 200 and bool(frames.valid.any())   # the phase did run

    # on the meta device a host read raises, and so does an operand on the CPU
    monkeypatch.setattr(fast_band, "fast_nms_bands_hi_lo", fast_band.fast_bands_plain)
    monkeypatch.setattr(fast_nms, "fast_nms_hi_lo", fast_nms.fast_nms_plain)
    meta = buf.to("meta")
    with _Ops() as ops:
        out = fn(cfg, meta)
    assert ops.cpu_operands == []
    leaves = tree_leaves(out)
    assert all(t.device.type == "meta" for t in leaves)
    assert [t.shape for t in leaves] == [t.shape for t in tree_leaves((frames, ts, valid))]


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("sensor", ["rgbd", "stereo", "mono"])
def test_runner_equals_the_direct_call(seq, sensor):
    cfg = _config(sensor)
    runner = FrameGraphs(cfg, "cpu", pool=None)
    outs = []
    for k in range(3):
        host = _chunk(seq, sensor, k)
        want = FRAME_PHASES[sensor](cfg, torch.from_numpy(host))
        got = runner(sensor, host)
        assert _equal(got, want), f"chunk {k}"
        outs.append((got, tree_map(torch.clone, got)))
    assert len(runner.programs) == 1   # one program per (sensor, chunk shape)
    for got, copy in outs:             # each chunk's outputs outlive the next run
        assert _equal(got, copy)



def test_runners_hold_no_reference_cycle():
    from self_commit_orb_slam2_tpu_torch.models.step_graph import StepGraph
    from self_commit_orb_slam2_tpu_torch.models.system import System
    from self_commit_orb_slam2_tpu_torch.ops import bow

    cfg = _config("rgbd")._replace(vocab=bow.load_vocabulary(bow.default_vocab_path()))
    slam = System(cfg, device="cpu")
    slam.step_graph = StepGraph(slam.config, "cpu")
    refs = [weakref.ref(x) for x in (slam, slam.step_graph, slam.step_graph.pool,
                                    slam.step_graph.frames, slam.step_graph.closer,
                                    slam._loop_closer)]
    assert slam._loop_closer.graphs is slam.step_graph.closer
    enabled = gc.isenabled()
    gc.disable()
    try:
        del slam
        assert [r() is None for r in refs] == [True] * len(refs)
    finally:
        if enabled:
            gc.enable()
