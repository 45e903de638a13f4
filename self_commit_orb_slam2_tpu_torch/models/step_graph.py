"""The tracking step and the chunk program as captured CUDA graphs.

Counterpart of the JAX package's jitted step: its System jits
batch_steps_frames and the per-frame step per sensor and mode, donating the
map and the carry, and the branches of the step are lax.cond (the JAX
package's models/system.py and models/pipeline.py).  Here
pipeline.track_step is split at its branches, and each part is captured
once per System into a torch.cuda.CUDAGraph; all share one memory pool.
SLAM mode:

  core   pipeline.step_core: both motion hypotheses, local-map tracking,
         the keyframe decision and the LOST flag; it writes the carry of a
         frame that takes neither branch into the static carry;
  lost   pipeline.relocalize_branch (with a vocabulary): relocalization and
         the keyframe decision and carry after it; it writes its StepCore
         over the core's outputs and its carry into the static carry, so
         the tail that follows a recovery reads them as after the core, and
         counts the attempt (relocalization.record, on the device);
  tail   pipeline.keyframe_tail: keyframe insertion and the mapping pass; it
         writes the static map and carry;
  chunk  pipeline.batch_steps_frames over a chunk of B frames, unrolled:
         for each slot its frame and timestamp into the static ones, then
         cond(valid, live), where live runs the core, cond(want_reloc,
         lost) with a vocabulary and cond(need_kf, tail); the slot's packed
         StepInfo (the skip info of a padded slot, else the core's or the
         LOST branch's, else the tail's, chosen by device selects) into row
         b of a static [B, 40] output.  cond is program_graphs.cond: a
         conditional IF node set on the device at every replay.

Localization mode (pipeline.track_step with localization_only), which never
makes a keyframe and so has no tail: loc_core (pipeline._localization_core),
loc_lost (relocalize_branch(..., localization_only=True)) and loc_chunk.

A streamed chunk (batch_steps) is one copy of the chunk into the static
chunk buffers and one replay of its mode's chunk graph: the host reads
nothing, and the packed StepInfos stay on the device.  A frame of the
per-frame API (step) is one replay of its core and one host read of its
two flags and its StepInfo (pipeline.track_step's read); a frame that
wants relocalization replays its LOST graph and reads that graph's flags;
a keyframe frame replays the tail after that.  per_frame = True makes
batch_steps run a chunk that way, slot by slot (the runner before the
chunk graph; asked for by whoever times mapping passes, which a chunk
graph cannot time).

Random draws.  The LOST graphs and the chunk graphs draw their RANSAC sets
from the stream's torch.Generator, registered with them at capture.  A
replay advances a registered generator by its graph's capture-time
increment, so a chunk replay takes one LOST branch's draws for every slot,
live or padded, lost or not, as the JAX package splits its key at every
step: slot b draws at the chunk's starting Philox offset + b * draw_span,
and the chunk ends at + B * draw_span (draw_span: the offset the LOST
part's warm-up advanced its generator by).  pipeline.batch_steps_frames
and the per_frame runner reserve the same spans on the card.

The static buffers are the map, the carry (its last frame included), the
frame and the timestamp, and the chunk's frames, timestamps, valid flags
and output rows.  The invariant: the graphs read the state the host thinks
it has.  Before every step the caller's map and carry are compared field by
field with the static ones, and a field that holds another tensor (the
loop closer, a re-based or relocalized carry, load_map, reset: anything
but a graph wrote it) is copied in.  After a step the caller's map is the
static map (updated in place, as insert_keyframe already updates the map
in pipeline.track_step), its carry is a copy out of the static carry, and
the step infos are copies out of the pool.

A mode is warmed once: WARMUP_ITERS eager runs of its per-frame parts on
a side stream (cuBLAS and cuSOLVER handles, the caching allocator; the
LOST part drawing from a scratch generator), the static buffers and the
counters restored from a copy taken before them.  Its graphs are then
captured when first needed: the per-frame parts at the first per-frame
step, the chunk graph at the first chunk (which shapes the chunk
buffers), both in System.warm_start (SLAM mode, on a scratch state) and
System.activate_localization_mode (localization mode).  Again only if a
buffer's shape or dtype changes (new buffers drop every graph) or SLAM
mode's run_mapping does.

On the CPU the same runner calls the captured functions on the same static
buffers instead of replaying them, cond reading its predicate: the plain
version, which the tests hold bitwise against pipeline.track_step and
pipeline.batch_steps_frames.  On a CUDA device it replays, or raises:
nothing falls back to eager execution or to per-frame replays when a
capture fails.

The runner also holds the System's other captured programs, in the same
graph pool (models/program_graphs.py): `frames`, the streamed frame phase
and the per-frame API's frame build, `closer`, the loop closer's
detection, correction, global-BA slices and merge, `reloc`, the per-frame
relocalization after a LOST step, and `mono`, the monocular bootstrap's
frame build and attempt.  A System with step_graph = None runs all of them
op by op.
"""

from __future__ import annotations

import collections
import functools
import itertools
import time
from typing import NamedTuple

import numpy as np
import torch

from ..utils import profiling
from . import pipeline, program_graphs, relocalization
from .config import SlamConfig
from .frame import FrameData
from .map_state import MapState
from .pipeline import StepCore, TrackCarry
from .program_graphs import (CloserGraphs, FrameGraphs, GraphPool, MonoInitGraphs, RelocGraphs,
                             no_collection, syncs_allowed)

WARMUP_ITERS = 1  # eager runs of the per-frame parts on a side stream before a capture
INFO_WIDTH = 40   # columns of a packed StepInfo (pipeline.pack_infos)

class _Static(NamedTuple):
    map: MapState
    carry: TrackCarry
    frame: FrameData
    ts: torch.Tensor


class _Chunk(NamedTuple):
    frames: FrameData     # [B, ...]
    ts: torch.Tensor      # [B] float32
    valid: torch.Tensor   # [B] bool
    out: torch.Tensor     # [B, INFO_WIDTH] float32: the packed StepInfos


class _CoreOut(NamedTuple):
    core: StepCore
    before: TrackCarry   # the carry the step started from (last_frame: the static one)
    head: torch.Tensor | None  # [2 + INFO_WIDTH] float32: want_reloc, need_kf, packed
                               # StepInfo (None inside the chunk program)


def _head(a: torch.Tensor, b: torch.Tensor, info) -> torch.Tensor:
    """[2 + INFO_WIDTH] float32: two flags, then the packed StepInfo."""
    return torch.cat([torch.stack([a, b]).to(torch.float32), pipeline.pack_infos([info])[0]])


# a mode's graphs, by the names of the module docstring
_MODES = {False: ("core", "lost", "chunk"), True: ("loc_core", "loc_lost", "loc_chunk")}


def _leaves(x):
    """The tensors of a NamedTuple of tensors and NamedTuples, in field order."""
    for v in x:
        if torch.is_tensor(v):
            yield v
        else:
            yield from _leaves(v)


def _same_layout(a, b) -> bool:
    la, lb = list(_leaves(a)), list(_leaves(b))
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and x.device == y.device
        for x, y in zip(la, lb))


def _copy_into(dst, src, skip=None) -> None:
    """dst's tensors <- src's, wherever src holds another tensor (and not
    the one `skip` holds in that field: a copy of dst made since)."""
    skips = _leaves(skip) if skip is not None else itertools.repeat(None)
    for d, s, k in zip(_leaves(dst), _leaves(src), skips):
        if s is not d and s is not k:
            d.copy_(s)


def _clone(x):
    return type(x)(*(v.clone() if torch.is_tensor(v) else _clone(v) for v in x))


def _read(t: torch.Tensor) -> np.ndarray:
    """A host read of the step's flags or StepInfo."""
    with profiling.span("step.read"):
        profiling.count("host_waits")
        return t.cpu().numpy()


class StepGraph:
    """The tracking step of one System (one sensor, one configuration) on
    static buffers: replayed from CUDA graphs on the card, called as plain
    functions on the CPU."""

    def __init__(self, config: SlamConfig, device):
        self.config = config
        self.device = torch.device(device)
        self.run_mapping: bool | None = None   # the tail's, fixed at capture
        self.generator: torch.Generator | None = None   # registered with the LOST graphs
        self.per_frame = False   # batch_steps slot by slot through the per-frame parts
        self.draw_span: int | None = None   # Philox offset of one LOST part (the card)
        self.replays = 0      # graph replays (every part)
        self.part_replays: collections.Counter = collections.Counter()   # by part name
        # part name -> the hand-written kernels' launches its capture recorded
        # (what each replay runs; the chunk graph's IF nodes decide that at
        # each replay, so its launches are counted at capture only)
        self.per_replay: dict = {}
        self.captures = 0     # times a mode's graphs were captured
        self.capture_s = 0.0  # host seconds of warm-up and capture, in all
        self.chunk_stats: dict = {}   # chunk graph name -> program_graphs.CaptureStats
        self._S: _Static | None = None
        self._C: _Chunk | None = None
        self._graphs: dict = {}   # part name -> CUDAGraph, once captured
        self._out: dict = {}      # part name -> its outputs (a _CoreOut, or a head / rows)
        self._modes: set = set()  # localization_only values warmed (graphs captured on demand)
        self._published: TrackCarry | None = None   # the carry last handed out
        self.pool = GraphPool()   # every graph of this System captures into it
        self.frames = FrameGraphs(config, self.device, self.pool)
        self.closer = CloserGraphs(config, self.device, self.pool)
        self.reloc = RelocGraphs(config, self.device, self.pool)
        self.mono = MonoInitGraphs(config, self.device, self.pool)

    @property
    def graphed(self) -> bool:
        """True on the card (replays), False on the CPU (plain calls)."""
        return self.device.type == "cuda"

    @property
    def with_reloc(self) -> bool:
        return self.config.vocab is not None

    # ------------------------------------------------------------ the parts

    def _run_core(self, loc: bool, head: bool = True) -> _CoreOut:
        S = self._S
        # the LOST branch reads the carry the step started from, which the
        # core overwrites: copy it out first (its last frame stays static)
        before = S.carry._replace(**{f: getattr(S.carry, f).clone()
                                     for f in TrackCarry._fields if f != "last_frame"})
        fn = pipeline._localization_core if loc else pipeline.step_core
        core = fn(self.config, S.map, S.carry, S.frame)
        _copy_into(S.carry, core.carry)
        return _CoreOut(core, before,
                        _head(core.want_reloc, core.need_kf, core.info) if head else None)

    def _run_lost(self, loc: bool, generator, c: _CoreOut, head: bool = True):
        S = self._S
        core = pipeline.relocalize_branch(self.config, S.map, c.before, S.frame, c.core,
                                          generator, localization_only=loc)
        relocalization.record(core.relocated)
        _copy_into(c.core, core)     # what the tail reads after a recovery
        _copy_into(S.carry, core.carry)
        return _head(core.relocated, core.need_kf, core.info) if head else None

    def _run_tail(self, c: _CoreOut) -> torch.Tensor:
        S = self._S
        m, carry, info = pipeline.keyframe_tail(
            self.config, S.map, S.carry, S.frame, c.core.lres.obs_pt, c.before.frame_id,
            S.ts, self.run_mapping, c.core.info)
        _copy_into(S.map, m)
        _copy_into(S.carry, carry)
        return pipeline.pack_infos([info])[0]

    def _run_chunk(self, loc: bool, generator) -> torch.Tensor:
        """The chunk program on the static buffers -> the [B, 40] rows."""
        S, C = self._S, self._C
        for b in range(C.valid.shape[0]):
            _copy_into(S.frame, C.frames.select(b))
            S.ts.copy_(C.ts[b])
            skip = pipeline.pack_infos([pipeline._skip_info(S.map, S.carry)])[0]
            live = torch.empty_like(skip)   # written by the live branch where it runs
            program_graphs.cond(C.valid[b], functools.partial(self._live, loc, generator, live))
            C.out[b].copy_(torch.where(C.valid[b], live, skip))
        return C.out

    def _live(self, loc: bool, generator, row: torch.Tensor) -> None:
        """One live slot of the chunk program: its packed StepInfo into row."""
        c = self._run_core(loc, head=False)
        if self.with_reloc:
            program_graphs.cond(c.core.want_reloc,
                                lambda: self._run_lost(loc, generator, c, head=False))
        info = pipeline.pack_infos([c.core.info])[0]   # the core's, or the LOST branch's
        if loc:
            row.copy_(info)
            return
        tail = torch.empty_like(info)
        program_graphs.cond(c.core.need_kf, lambda: tail.copy_(self._run_tail(c)))
        row.copy_(torch.where(c.core.need_kf, tail, info))

    def _replay(self, name: str):
        with profiling.span("graph.launch"):
            self._graphs[name].replay()
        self.replays += 1
        self.part_replays[name] += 1
        program_graphs.LAUNCHES_REPLAYED.update(self.per_replay.get(name, {}))
        profiling.count("replays." + name)
        return self._out[name]

    def _core(self, loc: bool = False) -> _CoreOut:
        name = _MODES[loc][0]
        if self.graphed:
            return self._replay(name)
        self._out[name] = self._run_core(loc)
        return self._out[name]

    def _check_generator(self, generator) -> None:
        if self.with_reloc and generator is not self.generator:
            raise ValueError("the LOST and chunk graphs replay with the generator registered "
                             "at their capture")

    def _lost(self, loc: bool, generator) -> torch.Tensor:
        if not self.graphed:
            return self._run_lost(loc, generator, self._out[_MODES[loc][0]])
        self._check_generator(generator)
        return self._replay(_MODES[loc][1])

    def _tail(self) -> torch.Tensor:
        if not self.graphed:
            return self._run_tail(self._out["core"])
        if self.run_mapping and profiling.timing("mapping.pass"):
            # the pass inside the graph cannot be spanned: time the replay,
            # synchronized on both sides
            with profiling.span("mapping.pass"):
                return self._replay("tail")
        return self._replay("tail")

    def _chunk(self, loc: bool, generator) -> torch.Tensor:
        if not self.graphed:
            return self._run_chunk(loc, generator)
        if self.run_mapping and not loc and profiling.timing("mapping.pass"):
            raise RuntimeError("a chunk graph cannot time its mapping passes: set "
                               "StepGraph.per_frame to time them slot by slot")
        self._check_generator(generator)
        return self._replay(_MODES[loc][2])

    # ------------------------------------------------------- buffers, capture

    def capture(self, m: MapState, carry: TrackCarry, frame: FrameData, run_mapping: bool,
                generator: torch.Generator | None = None,
                localization_only: bool = False, chunk: FrameData | None = None) -> None:
        """Static buffers shaped and filled like (m, carry, frame), and one
        mode warmed and, on the card, its graphs captured: SLAM mode's
        core, tail (with the mapping pass if run_mapping) and, with a
        vocabulary, LOST graph, or localization mode's core and LOST graph,
        and with `chunk` (frames [B, ...] that shape the chunk buffers) the
        mode's chunk graph.  The LOST and chunk graphs draw from `generator`
        (its state is left as it was).  m, carry and frame are copied, never
        written; new buffers drop the other mode's graphs."""
        self._new_buffers(m, carry, frame, chunk)
        self._ready(localization_only, run_mapping, generator, True, chunk is not None)

    def prepare(self, m: MapState, carry: TrackCarry, frame: FrameData, run_mapping: bool,
                generator: torch.Generator | None = None, localization_only: bool = False,
                chunk: FrameData | None = None, parts: bool = True) -> None:
        """Make the static buffers hold (m, carry): new buffers on first use
        or when a shape changes, else a copy of every field the caller's
        state holds apart from the static one.  Then the mode warmed (again
        for another run_mapping in SLAM mode) and, on the card, what is
        asked for captured if it is missing: its per-frame parts (parts),
        its chunk graph (chunk: frames [B, ...] of a chunk to come, which
        shape the chunk buffers)."""
        S = self._S
        if (S is None or not _same_layout(S.map, m) or not _same_layout(S.carry, carry)
                or not _same_layout(S.frame, frame)):
            self._new_buffers(m, carry, frame, chunk)
        else:
            if m is not S.map:
                _copy_into(S.map, m)
            if carry is not self._published:
                _copy_into(S.carry, carry, skip=self._published)
            self._set_chunk(chunk)
        self._ready(localization_only, run_mapping, generator, parts, chunk is not None)

    def _new_buffers(self, m, carry, frame, chunk) -> None:
        if chunk is None and self._C is not None and not _same_layout(
                self._C.frames.select(0), frame):
            self._C = None
        self._set_chunk(chunk)
        self._S = _Static(_clone(m), _clone(carry), _clone(frame),
                          torch.zeros((), dtype=torch.float32, device=self.device))
        self._published = None
        self._graphs, self._out, self._modes = {}, {}, set()

    def _ready(self, loc: bool, run_mapping: bool, generator, parts: bool, chunk: bool) -> None:
        if loc not in self._modes or (not loc and run_mapping != self.run_mapping):
            self._warm(loc, run_mapping, generator)
        if not self.graphed:
            return
        core_name, _, chunk_name = _MODES[loc]
        with syncs_allowed():
            if parts and core_name not in self._graphs:
                self._capture_parts(loc, generator)
            if chunk and chunk_name not in self._graphs:
                self._capture_chunk(loc, generator)

    def _part_names(self, loc: bool) -> list:
        core_name, lost_name, _ = _MODES[loc]
        return [core_name] + ([lost_name] if self.with_reloc else []) + ([] if loc else ["tail"])

    def _warm(self, loc: bool, run_mapping: bool, generator) -> None:
        """A mode's graphs dropped, its run_mapping and generator fixed and,
        on the card, its per-frame parts run WARMUP_ITERS times eagerly on
        a side stream (cuBLAS and cuSOLVER handles, the caching allocator;
        the LOST part drawing from a scratch generator, whose offsets give
        draw_span), the static buffers and the counters restored after."""
        for name in self._part_names(loc) + [_MODES[loc][2]]:
            self._graphs.pop(name, None)
        self._modes.discard(loc)
        if not loc:
            self.run_mapping = run_mapping
        if self.with_reloc:
            self.generator = generator
        if self.graphed:
            with syncs_allowed():
                self._warm_up(loc)
        self._modes.add(loc)

    def _runs(self, loc: bool) -> dict:
        core_name, lost_name, _ = _MODES[loc]
        return {core_name: lambda g: self._run_core(loc),
                lost_name: lambda g: self._run_lost(loc, g, self._out[core_name]),
                "tail": lambda g: self._run_tail(self._out[core_name])}

    def _warm_up(self, loc: bool) -> None:
        t0 = time.perf_counter()
        S = self._S
        saved = _clone(S)
        # counters made before any capture, and left as the warm-up found them
        counters = (relocalization.counters(self.device), profiling.stamp_head(self.device))
        saved_counts = [c.clone() for c in counters]
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        scratch = torch.Generator(device=self.device).manual_seed(0)
        run, lost_name = self._runs(loc), _MODES[loc][1]
        with profiling.suspended(), torch.cuda.stream(side):
            for _ in range(WARMUP_ITERS):
                for name in self._part_names(loc):
                    offset = scratch.get_offset()
                    self._out[name] = run[name](scratch)
                    if name == lost_name:
                        self.draw_span = scratch.get_offset() - offset
        main.wait_stream(side)
        _copy_into(S, saved)
        for c, saved_c in zip(counters, saved_counts):
            c.copy_(saved_c)
        torch.cuda.synchronize(self.device)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def _capture_parts(self, loc: bool, generator) -> None:
        t0 = time.perf_counter()
        run, lost_name = self._runs(loc), _MODES[loc][1]
        pool = self.pool()
        with profiling.suspended():
            for name in self._part_names(loc):
                graph = torch.cuda.CUDAGraph()
                drawn = name == lost_name and generator is not None
                if drawn:
                    graph.register_generator_state(generator)
                    state = generator.get_state()
                before = program_graphs.launch_counts()
                with no_collection(), torch.cuda.graph(graph, pool=pool):
                    self._out[name] = run[name](generator)
                self.per_replay[name] = program_graphs.launches_since(before)
                if drawn:
                    generator.set_state(state)
                self._graphs[name] = graph
        torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - t0

    def _capture_chunk(self, loc: bool, generator) -> None:
        """The mode's chunk graph on the chunk buffers (after the mode's
        warm-up, which ran everything it runs)."""
        name = _MODES[loc][2]
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        drawn = self.with_reloc and generator is not None
        if drawn:
            graph.register_generator_state(generator)
            state = generator.get_state()
        before = program_graphs.launch_counts()
        with profiling.suspended(), program_graphs.conditional_capture(
                graph, self.pool(), self.device) as stats:
            self._out[name] = self._run_chunk(loc, generator)
        program_graphs.launches_since(before)
        if drawn:
            generator.set_state(state)
        torch.cuda.synchronize(self.device)
        self._graphs[name] = graph
        self.chunk_stats[name] = stats[0]
        self.capture_s += time.perf_counter() - t0

    @property
    def chunk_frames(self) -> FrameData | None:
        """The chunk buffers' frames [B, ...] (None before the first chunk)."""
        return self._C.frames if self._C is not None else None

    def _set_chunk(self, frames: FrameData | None) -> bool:
        """New chunk buffers for frames [B, ...] unless the current ones fit
        (True: made anew, and every chunk graph dropped)."""
        if frames is None or (self._C is not None and _same_layout(self._C.frames, frames)):
            return False
        B = frames.xy.shape[0]
        dev = self.device
        self._C = _Chunk(_clone(frames), torch.zeros(B, dtype=torch.float32, device=dev),
                         torch.zeros(B, dtype=torch.bool, device=dev),
                         torch.zeros(B, INFO_WIDTH, dtype=torch.float32, device=dev))
        for loc in (False, True):
            self._graphs.pop(_MODES[loc][2], None)
        return True

    def _publish(self) -> TrackCarry:
        self._published = _clone(self._S.carry)
        return self._published

    # ------------------------------------------------------------------ steps

    def _step(self, frame: FrameData, timestamp, generator, out_row: torch.Tensor,
              host_info: bool, loc: bool):
        """One step on the static buffers through the per-frame parts; its
        packed StepInfo goes to out_row.  host_info: also return it on the
        host (numpy [40]), read in the same transfer as the last flags the
        step reads."""
        S = self._S
        with profiling.span("step.core", self.device):
            _copy_into(S.frame, frame)
            S.ts.copy_(timestamp)
            c = self._core(loc)
        head = _read(c.head if host_info else c.head[:2])   # the host read
        if bool(head[0] > 0.5) and self.with_reloc:
            with profiling.span("step.lost", self.device):
                lost = self._lost(loc, generator)
            head = _read(lost if host_info else lost[:2])   # the second
            src = lost
        else:
            src = c.head
        if bool(head[1] > 0.5):   # a keyframe (never in localization mode)
            with profiling.span("step.tail", self.device):
                out_row.copy_(self._tail())
            return _read(out_row) if host_info else None
        out_row.copy_(src[2:])
        return head[2:] if host_info else None

    def step(self, m: MapState, carry: TrackCarry, frame: FrameData, timestamp,
             run_mapping: bool = True, generator: torch.Generator | None = None,
             localization_only: bool = False):
        """pipeline.track_step -> (map, carry, the packed StepInfo [40] on
        the host as numpy)."""
        self.prepare(m, carry, frame, run_mapping, generator, localization_only)
        row = torch.empty(INFO_WIDTH, dtype=torch.float32, device=self.device)
        info = self._step(frame, timestamp, generator, row, True, localization_only)
        return self._S.map, self._publish(), np.asarray(info, np.float32)

    def batch_steps(self, m: MapState, carry: TrackCarry, frames: FrameData,
                    timestamps: torch.Tensor, valid: torch.Tensor,
                    run_mapping: bool = True, generator: torch.Generator | None = None,
                    localization_only: bool = False):
        """pipeline.batch_steps_frames -> (map, carry, packed StepInfo
        [B, 40] on the device): the chunk into the chunk buffers and one
        replay of the mode's chunk graph, with no host read (per_frame: the
        per-frame parts slot by slot, reading the flags)."""
        if self.per_frame:
            return self._batch_steps_per_frame(m, carry, frames, timestamps, valid, run_mapping,
                                               generator, localization_only)
        with profiling.span("step.chunk", self.device):
            self.prepare(m, carry, frames.select(0), run_mapping, generator, localization_only,
                         chunk=frames, parts=False)
            C = self._C
            _copy_into(C.frames, frames)
            C.ts.copy_(timestamps)
            C.valid.copy_(valid)
            out = self._chunk(localization_only, generator).clone()
            return self._S.map, self._publish(), out

    def _batch_steps_per_frame(self, m, carry, frames, timestamps, valid, run_mapping,
                               generator, localization_only):
        """The chunk slot by slot through the per-frame parts, reading each
        slot's flags and the valid flags on the host; on the card each slot
        draws from its own span of the generator, as in the chunk graph."""
        self.prepare(m, carry, frames.select(0), run_mapping, generator, localization_only)
        S = self._S
        live = valid.tolist()
        spans = self.graphed and self.with_reloc and generator is not None
        base = generator.get_offset() if spans else 0
        out = torch.empty(len(live), INFO_WIDTH, dtype=torch.float32, device=self.device)
        for b, is_live in enumerate(live):
            if spans:
                generator.set_offset(base + b * self.draw_span)
            if is_live:
                self._step(frames.select(b), timestamps[b], generator, out[b], False,
                           localization_only)
            else:
                out[b].copy_(pipeline.pack_infos([pipeline._skip_info(S.map, S.carry)])[0])
        if spans:
            generator.set_offset(base + len(live) * self.draw_span)
        return S.map, self._publish(), out
