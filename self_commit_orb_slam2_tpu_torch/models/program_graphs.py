"""The frame phase, loop detection, loop correction and relocalization as
captured CUDA graphs.

Counterparts of four more of the JAX package's compiled programs (beside
the step, models/step_graph.py): the batched frame phase, one per sensor
(its System's _frame_fns), loop detection for one keyframe and loop
correction (its loop closer's _jit_detect and _jit_correct), and
relocalization of one frame (its System's _jit_reloc).  Each is a Program:
a function of static input buffers that

  * at its first run executes eagerly on a side stream (the call's result,
    and the warm-up of the libraries it uses), then is captured into a
    torch.cuda.CUDAGraph in the memory pool of the System's step graphs;
  * at every later run is replayed, and its outputs are cloned out of the
    pool at once, so the caller gets fresh tensors, as from a plain call.

A capture that fails raises: nothing falls back to eager execution.  On the
CPU a Program calls its function on the same static buffers instead (the
plain version, which the tests hold bitwise against the direct calls).

Pool sharing.  The graphs of one System replay one after another on one
stream, so each may use the pool's free memory as scratch.  A graph's
outputs stay live in the pool only until they are cloned, right after its
replay; the step graphs' own outputs are read within the step that replays
them.  No replay therefore overwrites a tensor that is still to be read.

Random draws.  Detection draws its RANSAC sets from the closer's
torch.Generator, relocalization from the System's.  Each generator is
registered with its graph, so
each replay draws from the generator's state at that moment and advances it
as the eager call would: replay k draws what eager call k draws.  The
capture itself leaves the generator's state as it found it.

Python state inside a captured function runs once, at capture (a counter, a
timer, a log line): the callers time and count around the replays.  The
hand-written kernels count their launches in their wrappers, which run only
at capture here; a replay makes the launches its capture recorded, and
LAUNCHES_REPLAYED counts those (LAUNCHES_AT_CAPTURE counts the recordings,
which ran nothing on the device).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..ops.orb import fast_band, fast_nms
from . import loop_closing, relocalization
from .config import SlamConfig
from .frame import FrameData
from .map_state import MapState
from .streaming import _SENSORS

# kernel name -> launches made by replays / recorded at captures (module-wide,
# reset by whoever reads them)
LAUNCHES_REPLAYED: collections.Counter = collections.Counter()
LAUNCHES_AT_CAPTURE: collections.Counter = collections.Counter()
_KERNELS = (fast_band.kernel, fast_nms.kernel)


class GraphPool:
    """One CUDA graph memory pool, made at first use; every graph of a
    System captures into it.  (A holder of its own, so that the runners
    sharing it form no reference cycle with their owner: a cycle is freed
    only by the cycle collector, at any moment.)"""

    def __init__(self):
        self._handle = None

    def __call__(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


@contextlib.contextmanager
def no_collection():
    """Python's cycle collector off around a capture, after one collection:
    a collection inside the capture could free an unreachable object's CUDA
    graphs, which CUDA refuses while a stream captures, and so invalidate
    the capture."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _clone(x):
    return tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, x)


def _same_layout(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and x.device == y.device
        for x, y in zip(la, lb))


def _copy_into(dst, src) -> None:
    """dst's tensors <- src's, wherever src holds another tensor."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if s is not d:
            d.copy_(s)


class Program:
    """fn(*statics, generator) on static input buffers: replayed from a CUDA
    graph on the card after its first run, called on the CPU.  The caller
    writes the statics in place before each run."""

    def __init__(self, fn, statics: tuple, device: torch.device, pool):
        self.fn = fn
        self.statics = statics
        self.device = torch.device(device)
        self._pool = pool            # a GraphPool
        self.graph: torch.cuda.CUDAGraph | None = None
        self.generator: torch.Generator | None = None   # registered with the graph
        self._out = None             # the captured outputs, live in the pool
        self.per_replay: collections.Counter = collections.Counter()
        self.replays = 0
        self.capture_s = 0.0

    @property
    def graphed(self) -> bool:
        return self.device.type == "cuda"

    def run(self, generator: torch.Generator | None = None):
        """The outputs of fn on the statics, as fresh tensors."""
        if not self.graphed:
            return self.fn(*self.statics, generator)
        if self.graph is None:
            return self.capture(generator, generator)
        if generator is not self.generator:
            raise ValueError("a captured program replays with the generator registered at "
                             "its capture")
        self.graph.replay()
        self.replays += 1
        LAUNCHES_REPLAYED.update(self.per_replay)
        return _clone(self._out)

    def capture(self, generator: torch.Generator | None = None,
                warm_generator: torch.Generator | None = None):
        """Run fn eagerly on a side stream, drawing from warm_generator, and
        return that run's outputs; then capture fn with `generator`
        registered, leaving its state as it was after the eager run."""
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            first = self.fn(*self.statics, warm_generator)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
            state = generator.get_state()
        before = {k.name: k.launches for k in _KERNELS}
        with no_collection(), torch.cuda.graph(graph, pool=self._pool()):
            self._out = self.fn(*self.statics, generator)
        self.per_replay = collections.Counter(
            {k.name: k.launches - before[k.name] for k in _KERNELS if k.launches > before[k.name]})
        LAUNCHES_AT_CAPTURE.update(self.per_replay)
        if generator is not None:
            generator.set_state(state)
        torch.cuda.synchronize(self.device)
        self.graph, self.generator = graph, generator
        self.capture_s += time.perf_counter() - t0
        return first


def _frame_phase(frame_fn, config: SlamConfig, buf: torch.Tensor, generator):
    return frame_fn(config, buf)


class _FrameEntry(NamedTuple):
    program: Program
    stage: torch.Tensor          # pinned host staging buffer (the card)
    uploaded: list               # [the event after the last upload, or None]


class FrameGraphs:
    """pipeline.frames_{rgbd,stereo,mono}_packed, one Program per (sensor,
    packed chunk shape).  A chunk goes from the host into a pinned staging
    buffer and from there into the static device buffer, both outside the
    graph; the staging buffer is refilled only once its last copy is done."""

    def __init__(self, config: SlamConfig, device: torch.device, pool):
        self.config = config
        self.device = torch.device(device)
        self._pool = pool
        self._entries: dict = {}

    @property
    def programs(self) -> list:
        return [e.program for e in self._entries.values()]

    def __call__(self, sensor: str, host_buf: np.ndarray):
        """(FrameData [B, ...], ts [B], valid [B]) of a packed host chunk."""
        key = (sensor, host_buf.shape)
        entry = self._entries.get(key)
        graphed = self.device.type == "cuda"
        if entry is None:
            static = torch.empty(host_buf.shape, dtype=torch.uint8, device=self.device)
            stage = torch.empty(host_buf.shape, dtype=torch.uint8, pin_memory=graphed)
            prog = Program(functools.partial(_frame_phase, _SENSORS[sensor][1], self.config),
                           (static,), self.device, self._pool)
            entry = self._entries[key] = _FrameEntry(prog, stage, [None])
        static = entry.program.statics[0]
        if graphed:
            if entry.uploaded[0] is not None:
                entry.uploaded[0].synchronize()
            entry.stage.numpy()[...] = host_buf
            static.copy_(entry.stage, non_blocking=True)
            entry.uploaded[0] = torch.cuda.Event()
            entry.uploaded[0].record(torch.cuda.current_stream(self.device))
        else:
            static.copy_(torch.from_numpy(host_buf))
        return entry.program.run()


def _detect(config: SlamConfig, m: MapState, slot: torch.Tensor, generator):
    return loop_closing.detect_and_verify(config, m, slot, generator)


def _correct(config: SlamConfig, m: MapState, slot: torch.Tensor,
             det: loop_closing.LoopDetection, generator):
    return loop_closing.correct_loop(config, m, slot, det)


class CloserGraphs:
    """loop_closing.detect_and_verify and loop_closing.correct_loop as two
    Programs on one static map, a static 0-d slot and (for the correction) a
    static LoopDetection.  The map given is copied into the static map
    before each run (device to device; the steady stream hands over the
    step graphs' static map, updated in place since the last run)."""

    def __init__(self, config: SlamConfig, device: torch.device, pool):
        self.config = config
        self.device = torch.device(device)
        self._pool = pool
        self._map: MapState | None = None
        self._slot = torch.zeros((), dtype=torch.int32, device=self.device)
        self._det: loop_closing.LoopDetection | None = None
        self.detect_program: Program | None = None
        self.correct_program: Program | None = None

    @property
    def programs(self) -> list:
        return [p for p in (self.detect_program, self.correct_program) if p is not None]

    def _load(self, m: MapState, slot: int) -> None:
        if self._map is None or not _same_layout(self._map, m):
            self._map = _clone(m)
            self._det = None
            self.detect_program = Program(functools.partial(_detect, self.config),
                                          (self._map, self._slot), self.device, self._pool)
            self.correct_program = None
        else:
            _copy_into(self._map, m)
        self._slot.fill_(slot)

    def _load_det(self, det: loop_closing.LoopDetection) -> None:
        if self._det is None:
            self._det = _clone(det)
            self.correct_program = Program(functools.partial(_correct, self.config),
                                           (self._map, self._slot, self._det), self.device,
                                           self._pool)
        else:
            _copy_into(self._det, det)

    def detect(self, m: MapState, slot: int,
               generator: torch.Generator | None) -> loop_closing.LoopDetection:
        """detect_and_verify(config, m, slot, generator)."""
        self._load(m, slot)
        return self.detect_program.run(generator)

    def correct(self, m: MapState, slot: int, det: loop_closing.LoopDetection) -> MapState:
        """correct_loop(config, m, slot, det), as a fresh map."""
        self._load(m, slot)
        self._load_det(det)
        return self.correct_program.run()

    def capture(self, m: MapState, slot: int, generator: torch.Generator | None,
                warm_generator: torch.Generator | None) -> None:
        """Capture both programs on m (on the card; nothing on the CPU): the
        eager first runs draw from warm_generator, the detection graph is
        bound to `generator`, whose state is left as it was."""
        if self.device.type != "cuda":
            return
        self._load(m, slot)
        det = self.detect_program.capture(generator, warm_generator)
        self._load_det(det)
        self.correct_program.capture()


def _relocalize(config: SlamConfig, m: MapState, frame: FrameData, generator):
    return relocalization.relocalize_uncounted(config, m, frame, generator)


class RelocGraphs:
    """relocalization.relocalize as a Program on a static map and a static
    frame, both copied in before each run (device to device).  Its RANSAC
    draws come from the generator of its first run, registered with the
    graph."""

    def __init__(self, config: SlamConfig, device: torch.device, pool):
        self.config = config
        self.device = torch.device(device)
        self._pool = pool
        self._statics: tuple | None = None   # (map, frame)
        self.program: Program | None = None

    @property
    def programs(self) -> list:
        return [self.program] if self.program is not None else []

    def _load(self, m: MapState, frame: FrameData) -> None:
        if self._statics is None or not _same_layout(self._statics, (m, frame)):
            self._statics = (_clone(m), _clone(frame))
            self.program = Program(functools.partial(_relocalize, self.config), self._statics,
                                   self.device, self._pool)
        else:
            _copy_into(self._statics, (m, frame))

    def relocalize(self, m: MapState, frame: FrameData,
                   generator: torch.Generator | None) -> relocalization.RelocResult:
        """relocalization.relocalize(config, m, frame, generator), counted."""
        self._load(m, frame)
        res = self.program.run(generator)
        relocalization.record(res.success)
        return res

    def capture(self, m: MapState, frame: FrameData, generator: torch.Generator | None,
                warm_generator: torch.Generator | None) -> None:
        """Capture the program on (m, frame) (on the card; nothing on the
        CPU): the eager first run draws from warm_generator and counts
        nothing; the graph is bound to `generator`, whose state is left as
        it was."""
        if self.device.type != "cuda":
            return
        self._load(m, frame)
        self.program.capture(generator, warm_generator)
