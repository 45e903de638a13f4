"""The frame phase, the frame build, loop detection, loop correction, the
sliced global BA and its merge, relocalization and the monocular bootstrap
as captured CUDA graphs.

Counterparts of more of the JAX package's compiled programs (beside the
step, models/step_graph.py): the batched frame phase, one per sensor (its
System's _frame_fns), and the frame build of one frame (inside its
per-frame _steps); loop detection for one keyframe, loop correction, one
slice of the global BA of each kind and the merge (its loop closer's
_jit_detect, _jit_correct, _jit_gba_slice and _jit_merge); relocalization
of one frame (its System's _jit_reloc); and the monocular bootstrap's frame
build and attempt (its System's _jit_mono_frame and _jit_mono_try).  Each
is a Program:
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
torch.Generator, relocalization and the bootstrap from the System's.  Each
generator is registered with its graph, so
each replay draws from the generator's state at that moment and advances it
as the eager call would: replay k draws what eager call k draws.  The
capture itself leaves the generator's state as it found it.

Python state inside a captured function runs once, at capture (a counter, a
timer, a log line): the callers time and count around the replays.  The
hand-written kernels count their launches in their wrappers, which run only
at capture here; a replay makes the launches its capture recorded, and
LAUNCHES_REPLAYED counts those (LAUNCHES_AT_CAPTURE counts the recordings,
which ran nothing on the device).

Branches on the device.  cond(pred, fn) is lax.cond with no else branch:
inside conditional_capture it records fn into a conditional IF node of the
graph, whose condition a one-thread kernel (csrc/graph_cond.cu) sets from
the 0-d device bool pred at every replay, so a replay decides the branch
without the host; elsewhere (the CPU, a warm-up on the card) it runs fn
when bool(pred) holds.  The body is captured on a stream of its own into
the node's body graph, under a capture id that the graph's own routing of
allocations does not know, so conditional_capture routes every allocation
on the device to the graph's pool while it lasts.  There is no fallback:
where conditional nodes cannot be captured, the capture raises.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import gc
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..kernels import CudaKernel
from ..ops.orb import fast_band, fast_nms
from ..utils import profiling
from . import frame as frame_mod
from . import loop_closing, mono_init, relocalization
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


@contextlib.contextmanager
def syncs_allowed():
    """The card's sync debug mode off inside the block (a capture and its
    warm-up synchronize; a dispatch checked for host reads may capture at
    its first run)."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


# csrc/graph_cond.cu: an IF node under stream capture, and node counts
_SIZE_P = ctypes.POINTER(ctypes.c_size_t)
_COND_BEGIN = CudaKernel("cond_begin", "graph_cond.cu", "cond_begin", [ctypes.c_void_p] * 3)
_COND_END = CudaKernel("cond_end", "graph_cond.cu", "cond_end", [ctypes.c_void_p, _SIZE_P])
_CAPTURE_NODES = CudaKernel("capture_nodes", "graph_cond.cu", "capture_nodes",
                            [ctypes.c_void_p, _SIZE_P])
_BODY_STREAM = CudaKernel("body_stream", "graph_cond.cu", "body_stream",
                          [ctypes.POINTER(ctypes.c_void_p)])
_body_streams: dict = {}   # device index -> streams of the IF bodies, one a nesting depth


def _body_stream(index: int, depth: int) -> torch.cuda.ExternalStream:
    """The stream that captures the bodies at one nesting depth: made once,
    outside PyTorch's stream pool (whose streams the capture itself uses),
    and reused, so that the bodies of one depth share their pool blocks."""
    streams = _body_streams.setdefault(index, [])
    while len(streams) <= depth:
        ptr = ctypes.c_void_p()
        with torch.cuda.device(index):
            _cuda_call(_BODY_STREAM, ctypes.byref(ptr))
        streams.append(torch.cuda.ExternalStream(ptr.value, device=torch.device("cuda", index)))
    return streams[depth]


def _cuda_call(entry: CudaKernel, *args) -> None:
    rc = entry.function()(*args)
    if rc != 0:
        raise RuntimeError(f"{entry.name}: CUDA error {rc} while capturing a conditional node")


class _Conditional:
    """The state of one conditional_capture: the device, the nesting depth
    and the counts."""

    def __init__(self, device: torch.device, index: int):
        self.device = device
        self.index = index
        self.depth = 0
        self.conds = 0        # IF nodes recorded
        self.body_nodes = 0   # nodes inside their bodies

    def record(self, pred: torch.Tensor, fn) -> None:
        if pred.dtype != torch.bool or pred.numel() != 1 or pred.device.type != "cuda":
            raise ValueError(f"cond: the predicate must be one bool on the card, got "
                             f"{tuple(pred.shape)} {pred.dtype} on {pred.device}")
        parent = torch.cuda.current_stream(self.device)
        child = _body_stream(self.index, self.depth)
        _cuda_call(_COND_BEGIN, parent.cuda_stream, child.cuda_stream, pred.data_ptr())
        self.depth += 1
        try:
            with torch.cuda.stream(child):
                fn()
        finally:
            self.depth -= 1
        n = ctypes.c_size_t(0)
        _cuda_call(_COND_END, child.cuda_stream, ctypes.byref(n))
        self.conds += 1
        self.body_nodes += n.value


_conditional: _Conditional | None = None   # the conditional_capture under way


def cond(pred: torch.Tensor, fn) -> None:
    """lax.cond(pred, fn, no-op) for a fn that returns nothing and writes
    what it computes into tensors made before the call: inside
    conditional_capture, recorded into an IF node set from the 0-d device
    bool pred at each replay; elsewhere fn() when bool(pred) holds (the
    plain version: one host read)."""
    if _conditional is not None:
        _conditional.record(pred, fn)
    elif bool(pred):
        fn()


class CaptureStats(NamedTuple):
    nodes: int           # graph nodes, those inside IF bodies included
    conds: int           # IF nodes
    capture_s: float     # host seconds recording the graph
    instantiate_s: float  # host seconds ending the capture and instantiating it


@contextlib.contextmanager
def conditional_capture(graph: torch.cuda.CUDAGraph, pool, device):
    """torch.cuda.graph(graph, pool=pool) in which cond() records IF nodes.
    Yields a list that holds the capture's CaptureStats once the block has
    ended."""
    global _conditional
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    out: list = []
    t0 = time.perf_counter()
    with no_collection(), torch.cuda.graph(graph, pool=pool):
        # the bodies allocate on streams capturing under ids of their own:
        # route every allocation on the device to the pool for the capture
        # (the graph ends this routing at its end; begin took a reference
        # of the pool that the graph already holds)
        torch._C._cuda_endAllocateToPool(index, pool)
        torch._C._cuda_beginAllocateToPool(index, pool)
        torch._C._cuda_releasePool(index, pool)
        _conditional = state = _Conditional(device, index)
        try:
            yield out
        finally:
            _conditional = None
        n = ctypes.c_size_t(0)
        _cuda_call(_CAPTURE_NODES, torch.cuda.current_stream(device).cuda_stream,
                   ctypes.byref(n))
        t1 = time.perf_counter()
    out.append(CaptureStats(n.value + state.body_nodes, state.conds, t1 - t0,
                            time.perf_counter() - t1))


@contextlib.contextmanager
def _plain_capture(graph: torch.cuda.CUDAGraph, pool):
    with no_collection(), torch.cuda.graph(graph, pool=pool):
        yield


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
    writes the statics in place before each run.  conditional: captured
    through conditional_capture, so that fn may branch on the device with
    cond."""

    def __init__(self, fn, statics: tuple, device: torch.device, pool,
                 conditional: bool = False):
        self.fn = fn
        self.statics = statics
        self.device = torch.device(device)
        self._pool = pool            # a GraphPool
        self.conditional = conditional
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
        return _clone(self.replay())

    def replay(self):
        """One replay of the captured graph; its outputs, live in the pool
        until the next replay of a graph of the pool."""
        with profiling.span("graph.launch"):
            self.graph.replay()
        self.replays += 1
        LAUNCHES_REPLAYED.update(self.per_replay)
        return self._out

    def capture(self, generator: torch.Generator | None = None,
                warm_generator: torch.Generator | None = None):
        """Run fn eagerly on a side stream, drawing from warm_generator, and
        return that run's outputs; then capture fn with `generator`
        registered, leaving its state as it was after the eager run."""
        with syncs_allowed():
            return self._capture(generator, warm_generator)

    def _capture(self, generator, warm_generator):
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
        with (conditional_capture(graph, self._pool(), self.device) if self.conditional
              else _plain_capture(graph, self._pool())):
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
    program: Program             # its statics: one device buffer per staging buffer
    stage: tuple                 # pinned host staging buffers (the card)
    uploaded: list               # [the event after the last upload, or None]

    def load(self, sources: tuple) -> None:
        """The host tensors `sources` into the static buffers: on the card
        through the staging buffers (refilled once their last copy is done)
        and a copy that does not block the host, on the CPU directly."""
        statics, dev = self.program.statics, self.program.device
        with profiling.span("frame.upload"):
            if not self.program.graphed:
                with profiling.span("frame.h2d", dev):
                    for static, src in zip(statics, sources):
                        static.copy_(src)
                return
            if self.uploaded[0] is not None:
                profiling.count("host_waits")
                self.uploaded[0].synchronize()
            for st, src in zip(self.stage, sources):
                st.copy_(src)
            with profiling.span("frame.h2d", dev):
                for static, st in zip(statics, self.stage):
                    static.copy_(st, non_blocking=True)
            self.uploaded[0] = torch.cuda.Event()
            self.uploaded[0].record(torch.cuda.current_stream(dev))


def _frame_entry(fn, shapes_dtypes: list, device: torch.device, pool) -> _FrameEntry:
    """A Program of fn on new static device buffers, with pinned staging
    buffers of the same shapes and dtypes."""
    graphed = device.type == "cuda"
    statics = tuple(torch.empty(shape, dtype=dt, device=device) for shape, dt in shapes_dtypes)
    stage = tuple(torch.empty(shape, dtype=dt, pin_memory=graphed) for shape, dt in shapes_dtypes)
    return _FrameEntry(Program(fn, statics, device, pool), stage, [None])


def _frame_build(build, config: SlamConfig, *images_and_generator):
    return build(config, *images_and_generator[:-1])


class FrameBuild:
    """frame.make_frame_{rgbd,stereo,mono}(config, *images) of one frame as
    a Program per image shape.  The images ([H, W] float32 on the host) go
    into pinned staging buffers and from there into the static device
    buffers, both outside the graph; the staging buffers are refilled only
    once their last copy is done."""

    def __init__(self, sensor: str, config: SlamConfig, device: torch.device, pool):
        self.build = getattr(frame_mod, f"make_frame_{sensor}")
        self.config = config
        self.device = torch.device(device)
        self._pool = pool
        self._entries: dict = {}

    @property
    def programs(self) -> list:
        return [e.program for e in self._entries.values()]

    def __call__(self, images: tuple) -> FrameData:
        """The FrameData of host images ([H, W] float32 tensors)."""
        key = tuple(tuple(a.shape) for a in images)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _frame_entry(
                functools.partial(_frame_build, self.build, self.config),
                [(a.shape, torch.float32) for a in images], self.device, self._pool)
        entry.load(images)
        with profiling.span("frame.build", self.device):
            return entry.program.run()


class FrameGraphs:
    """pipeline.frames_{rgbd,stereo,mono}_packed, one Program per (sensor,
    packed chunk shape).  A chunk goes from the host into a pinned staging
    buffer and from there into the static device buffer, both outside the
    graph; the staging buffer is refilled only once its last copy is done.
    `single(sensor, images)` builds one frame of the per-frame API the same
    way (a FrameBuild per sensor)."""

    def __init__(self, config: SlamConfig, device: torch.device, pool):
        self.config = config
        self.device = torch.device(device)
        self._pool = pool
        self._entries: dict = {}
        self._single: dict = {}   # sensor -> FrameBuild

    @property
    def programs(self) -> list:
        """The chunk programs."""
        return [e.program for e in self._entries.values()]

    @property
    def single_programs(self) -> list:
        """The per-frame programs."""
        return [p for b in self._single.values() for p in b.programs]

    def single(self, sensor: str, images: tuple) -> FrameData:
        """frame.make_frame_{sensor}(config, *images) of host images ([H, W]
        float32 tensors: the image and the depth in metres, the two eyes, or
        the image)."""
        build = self._single.get(sensor)
        if build is None:
            build = self._single[sensor] = FrameBuild(sensor, self.config, self.device,
                                                      self._pool)
        return build(images)

    def __call__(self, sensor: str, host_buf: np.ndarray):
        """(FrameData [B, ...], ts [B], valid [B]) of a packed host chunk."""
        key = (sensor, host_buf.shape)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _frame_entry(
                functools.partial(_frame_phase, _SENSORS[sensor][1], self.config),
                [(host_buf.shape, torch.uint8)], self.device, self._pool)
        entry.load((torch.from_numpy(host_buf),))
        with profiling.span("frame.phase", self.device):
            return entry.program.run()


def _detect(config: SlamConfig, m: MapState, slot: torch.Tensor, generator):
    return loop_closing.detect_and_verify(config, m, slot, generator)


def _correct(config: SlamConfig, m: MapState, slot: torch.Tensor,
             det: loop_closing.LoopDetection, generator):
    return loop_closing.correct_loop(config, m, slot, det)


def _gba_slice(config: SlamConfig, huber: bool, snap: MapState, kf_Tcw: torch.Tensor,
               pt_pos: torch.Tensor, anchor: torch.Tensor, generator):
    return loop_closing.global_bundle_adjust_slice(config, snap, kf_Tcw, pt_pos, anchor, huber)


def _merge(m: MapState, snap_seq: torch.Tensor, snap_birth: torch.Tensor,
           kf_Tcw: torch.Tensor, pt_pos: torch.Tensor, generator):
    merged = loop_closing.merge_gba(m, snap_seq, snap_birth, kf_Tcw, pt_pos)
    return merged.kf_Tcw, merged.pt_pos


class CloserGraphs:
    """loop_closing.detect_and_verify and loop_closing.correct_loop as two
    Programs on one static map, a static 0-d slot and (for the correction) a
    static LoopDetection.  The map given is copied into the static map
    before each run (device to device; the steady stream hands over the
    step graphs' static map, updated in place since the last run).

    The dense global BA: global_bundle_adjust_slice of each kind as a
    Program on a static snapshot (load_gba copies the corrected map in when
    the closer dispatches a GBA, in place of a fresh copy), a static (poses,
    points) pair, copied in before each slice, and a static 0-d anchor
    slot; merge_gba as a Program on a static map and static (snapshot seqs,
    snapshot births, poses, points), all copied in before each merge."""

    def __init__(self, config: SlamConfig, device: torch.device, pool):
        self.config = config
        self.device = torch.device(device)
        self._pool = pool
        self._map: MapState | None = None
        self._slot = torch.zeros((), dtype=torch.int32, device=self.device)
        self._det: loop_closing.LoopDetection | None = None
        self.detect_program: Program | None = None
        self.correct_program: Program | None = None
        self._gba: tuple | None = None     # (snapshot, kf_Tcw, pt_pos, anchor)
        self.gba_programs: dict = {}       # huber -> Program
        self._merge_in: tuple | None = None   # (map, snap_seq, snap_birth, kf_Tcw, pt_pos)
        self.merge_program: Program | None = None

    @property
    def programs(self) -> list:
        return [p for p in (self.detect_program, self.correct_program,
                            *self.gba_programs.values(), self.merge_program) if p is not None]

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

    def load_gba(self, m: MapState, anchor_kf: int) -> None:
        """Start a global BA on m: its snapshot, its starting (poses,
        points) and its anchor slot into the static buffers.  A GBA in
        flight on the old snapshot is dropped: its slices' outputs were
        cloned out, so nothing reads the buffers it used."""
        if self._gba is None or not _same_layout(self._gba[0], m):
            self._gba = (_clone(m), m.kf_Tcw.clone(), m.pt_pos.clone(),
                         torch.zeros((), dtype=torch.int32, device=self.device))
            self.gba_programs = {h: Program(functools.partial(_gba_slice, self.config, h),
                                            self._gba, self.device, self._pool)
                                 for h in (True, False)}
        else:
            _copy_into(self._gba[:3], (m, m.kf_Tcw, m.pt_pos))
        self._gba[3].fill_(int(anchor_kf))

    def gba_slice(self, kf_Tcw: torch.Tensor, pt_pos: torch.Tensor, huber: bool):
        """global_bundle_adjust_slice(config, snapshot, kf_Tcw, pt_pos,
        anchor, huber) on the snapshot load_gba gave -> (kf_Tcw, pt_pos)."""
        _copy_into(self._gba[1:3], (kf_Tcw, pt_pos))
        return self.gba_programs[huber].run()

    def merge(self, m: MapState, snap_seq: torch.Tensor, snap_birth: torch.Tensor,
              kf_Tcw: torch.Tensor, pt_pos: torch.Tensor) -> MapState:
        """merge_gba(m, snap_seq, snap_birth, kf_Tcw, pt_pos): m with the
        merged poses and points (fresh tensors; its other fields are m's)."""
        args = (m, snap_seq, snap_birth, kf_Tcw, pt_pos)
        if self._merge_in is None or not _same_layout(self._merge_in, args):
            self._merge_in = _clone(args)
            self.merge_program = Program(_merge, self._merge_in, self.device, self._pool)
        else:
            _copy_into(self._merge_in, args)
        T, p = self.merge_program.run()
        return m._replace(kf_Tcw=T, pt_pos=p)

    def capture_gba(self, m: MapState, anchor_kf: int) -> None:
        """Capture both slice kinds and the merge on m (on the card; nothing
        on the CPU); their eager first runs' outputs are discarded."""
        if self.device.type != "cuda":
            return
        self.load_gba(m, anchor_kf)
        T, p = m.kf_Tcw, m.pt_pos
        for huber in (True, False):
            _copy_into(self._gba[1:3], (T, p))
            T, p = self.gba_programs[huber].capture()
        self.merge(m, m.kf_seq, m.pt_birth, T, p)   # the first run, then the capture


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


def _mono_try(config: SlamConfig, m: MapState, f1: FrameData, f2: FrameData,
              timestamp1: torch.Tensor, timestamp2: torch.Tensor, frame_id2: torch.Tensor,
              generator):
    return mono_init.initialize_map(config, m, f1, f2, timestamp1, timestamp2, frame_id2,
                                    generator)


class MonoInitGraphs:
    """The monocular bootstrap as two Programs: `frame`, the doubled-budget
    frame build (a FrameBuild of make_frame_mono at 2x the feature budget,
    reference mpIniORBextractor), and the attempt, mono_init.initialize_map
    on a static map, two static frames and static 0-d timestamps and frame
    id, all written before each run.  The attempt's RANSAC draws come from
    the generator of its first run, registered with the graph."""

    def __init__(self, config: SlamConfig, device: torch.device, pool):
        self.config = config
        self.device = torch.device(device)
        self._pool = pool
        self.ini_config = config._replace(orb=config.orb._replace(
            n_features=2 * config.orb.n_features))
        self.frame = FrameBuild("mono", self.ini_config, self.device, pool)
        self._statics: tuple | None = None   # (map, f1, f2, ts1, ts2, frame_id2)
        self.program: Program | None = None

    @property
    def programs(self) -> list:
        return self.frame.programs + ([self.program] if self.program is not None else [])

    def _load(self, m: MapState, f1: FrameData, f2: FrameData, timestamp1: float,
              timestamp2: float, frame_id2: int) -> None:
        if self._statics is None or not _same_layout(self._statics[:3], (m, f1, f2)):
            self._statics = (*_clone((m, f1, f2)),
                             torch.zeros((), dtype=torch.float32, device=self.device),
                             torch.zeros((), dtype=torch.float32, device=self.device),
                             torch.zeros((), dtype=torch.int32, device=self.device))
            self.program = Program(functools.partial(_mono_try, self.config), self._statics,
                                   self.device, self._pool)
        else:
            _copy_into(self._statics[:3], (m, f1, f2))
        for static, value in zip(self._statics[3:], (timestamp1, timestamp2, frame_id2)):
            static.fill_(value)

    def try_initialize(self, m: MapState, f1: FrameData, f2: FrameData, timestamp1: float,
                       timestamp2: float, frame_id2: int,
                       generator: torch.Generator | None) -> mono_init.MonoInitResult:
        """mono_init.try_initialize(config, m, f1, f2, timestamp1,
        timestamp2, frame_id2, generator): one replay, then (success,
        n_matches) read in one transfer; m itself back on failure."""
        self._load(m, f1, f2, timestamp1, timestamp2, frame_id2)
        return mono_init.read_result(self.program.run(generator), m)

    def capture(self, m: MapState, f1: FrameData, f2: FrameData,
                generator: torch.Generator | None,
                warm_generator: torch.Generator | None) -> None:
        """Capture the attempt on (m, f1, f2) (on the card; nothing on the
        CPU): the eager first run draws from warm_generator, the graph is
        bound to `generator`, whose state is left as it was."""
        if self.device.type != "cuda":
            return
        self._load(m, f1, f2, 0.0, 0.0, 0)
        self.program.capture(generator, warm_generator)
