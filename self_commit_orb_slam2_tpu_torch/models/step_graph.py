"""The tracking step as captured CUDA graphs.

Counterpart of the JAX package's jitted step: its System jits
batch_steps_frames and the per-frame step per sensor and mode, donating the
map and the carry, and the branches of the step are lax.cond (the JAX
package's models/system.py and models/pipeline.py).  Here
pipeline.track_step is split at its host branches, and each part is
captured once per System into a torch.cuda.CUDAGraph; all share one memory
pool.  SLAM mode:

  core  pipeline.step_core: both motion hypotheses, local-map tracking, the
        keyframe decision and the LOST flag; it writes the carry of a frame
        that takes neither branch into the static carry;
  lost  pipeline.relocalize_branch (with a vocabulary): relocalization and
        the keyframe decision and carry after it; it writes its StepCore
        over the core's outputs and its carry into the static carry, so the
        tail that follows a recovery reads them as after the core;
  tail  pipeline.keyframe_tail: keyframe insertion and the mapping pass; it
        writes the static map and carry.

Localization mode (pipeline.track_step with localization_only), which never
makes a keyframe and so has no tail:

  loc_core  pipeline._localization_core;
  loc_lost  pipeline.relocalize_branch(..., localization_only=True).

A steady frame is one copy of the frame into the static frame, one replay
of its core and one host read of its two flags (pipeline.track_step's read).
A frame that wants relocalization replays its LOST graph and reads that
graph's two flags (relocated, keyframe); a keyframe frame replays the tail
after that.  The LOST graphs draw their RANSAC sets from the stream's
torch.Generator, registered with them at capture: replay k draws what eager
call k would.

The static buffers are the map, the carry (its last frame included), the
frame and the timestamp.  The invariant: the graphs read the state the host
thinks it has.  Before every step the caller's map and carry are compared
field by field with the static ones, and a field that holds another tensor
(the loop closer, a re-based or relocalized carry, load_map, reset:
anything but a graph wrote it) is copied in.  After a step the caller's map
is the static map (updated in place, as insert_keyframe already updates the
map in pipeline.track_step), its carry is a copy out of the static carry,
and the step infos are copies out of the pool.

The capture of a mode's graphs: WARMUP_ITERS eager runs of its parts on a
side stream (cuBLAS and cuSOLVER handles, the caching allocator; the LOST
part drawing from a scratch generator), the static buffers restored from a
copy taken before them, then the captures.  SLAM mode's happens in
System.warm_start (on a scratch state), else at the first tracked frame;
localization mode's in System.activate_localization_mode, else at the first
localization-mode frame.  Both again only if a buffer's shape or dtype
changes (new buffers drop every graph).

On the CPU the same runner calls the captured functions on the same static
buffers instead of replaying them: the plain version, which the tests hold
bitwise against pipeline.track_step.  On a CUDA device it replays, or
raises: nothing falls back to eager execution when a capture fails.

The runner also holds the System's other captured programs, in the same
graph pool (models/program_graphs.py): `frames`, the streamed frame phase,
`closer`, the loop closer's detection and correction, and `reloc`, the
per-frame relocalization after a LOST step.  A System with step_graph =
None runs all of them op by op.
"""

from __future__ import annotations

import collections
import itertools
import time
from typing import NamedTuple

import numpy as np
import torch

from . import pipeline, relocalization
from .config import SlamConfig
from .frame import FrameData
from .map_state import MapState
from .pipeline import StepCore, TrackCarry
from .program_graphs import CloserGraphs, FrameGraphs, GraphPool, RelocGraphs, no_collection

WARMUP_ITERS = 2  # eager runs of both parts on a side stream before a capture
INFO_WIDTH = 40   # columns of a packed StepInfo (pipeline.pack_infos)

class _Static(NamedTuple):
    map: MapState
    carry: TrackCarry
    frame: FrameData
    ts: torch.Tensor


class _CoreOut(NamedTuple):
    core: StepCore
    before: TrackCarry   # the carry the step started from (last_frame: the static one)
    head: torch.Tensor   # [2 + INFO_WIDTH] float32: want_reloc, need_kf, packed StepInfo


def _head(a: torch.Tensor, b: torch.Tensor, info) -> torch.Tensor:
    """[2 + INFO_WIDTH] float32: two flags, then the packed StepInfo."""
    return torch.cat([torch.stack([a, b]).to(torch.float32), pipeline.pack_infos([info])[0]])


# a mode's graphs, by the names of the module docstring
_MODES = {False: ("core", "lost"), True: ("loc_core", "loc_lost")}


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


class StepGraph:
    """The tracking step of one System (one sensor, one configuration) on
    static buffers: replayed from CUDA graphs on the card, called as plain
    functions on the CPU."""

    def __init__(self, config: SlamConfig, device):
        self.config = config
        self.device = torch.device(device)
        self.run_mapping: bool | None = None   # the tail's, fixed at capture
        self.generator: torch.Generator | None = None   # registered with the LOST graphs
        self.replays = 0      # graph replays (every part)
        self.part_replays: collections.Counter = collections.Counter()   # by part name
        self.captures = 0     # times a mode's graphs were captured
        self.capture_s = 0.0  # host seconds of warm-up and capture, in all
        self._S: _Static | None = None
        self._graphs: dict = {}   # part name -> CUDAGraph, once captured
        self._out: dict = {}      # part name -> its outputs (a _CoreOut, or a head / row)
        self._modes: set = set()  # localization_only values whose parts are ready
        self._published: TrackCarry | None = None   # the carry last handed out
        self.pool = GraphPool()   # every graph of this System captures into it
        self.frames = FrameGraphs(config, self.device, self.pool)
        self.closer = CloserGraphs(config, self.device, self.pool)
        self.reloc = RelocGraphs(config, self.device, self.pool)

    @property
    def graphed(self) -> bool:
        """True on the card (replays), False on the CPU (plain calls)."""
        return self.device.type == "cuda"

    @property
    def with_reloc(self) -> bool:
        return self.config.vocab is not None

    # ------------------------------------------------------------ the parts

    def _run_core(self, loc: bool) -> _CoreOut:
        S = self._S
        # the LOST branch reads the carry the step started from, which the
        # core overwrites: copy it out first (its last frame stays static)
        before = S.carry._replace(**{f: getattr(S.carry, f).clone()
                                     for f in TrackCarry._fields if f != "last_frame"})
        fn = pipeline._localization_core if loc else pipeline.step_core
        core = fn(self.config, S.map, S.carry, S.frame)
        head = _head(core.want_reloc, core.need_kf, core.info)
        _copy_into(S.carry, core.carry)
        return _CoreOut(core, before, head)

    def _run_lost(self, loc: bool, generator) -> torch.Tensor:
        S, c = self._S, self._out[_MODES[loc][0]]
        core = pipeline.relocalize_branch(self.config, S.map, c.before, S.frame, c.core,
                                          generator, localization_only=loc)
        head = _head(core.relocated, core.need_kf, core.info)
        _copy_into(c.core, core)     # what the tail reads after a recovery
        _copy_into(S.carry, core.carry)
        return head

    def _run_tail(self) -> torch.Tensor:
        S, c = self._S, self._out["core"]
        m, carry, info = pipeline.keyframe_tail(
            self.config, S.map, S.carry, S.frame, c.core.lres.obs_pt, c.before.frame_id,
            S.ts, self.run_mapping, c.core.info)
        _copy_into(S.map, m)
        _copy_into(S.carry, carry)
        return pipeline.pack_infos([info])[0]

    def _replay(self, name: str):
        self._graphs[name].replay()
        self.replays += 1
        self.part_replays[name] += 1
        return self._out[name]

    def _core(self, loc: bool = False) -> _CoreOut:
        name = _MODES[loc][0]
        if self.graphed:
            return self._replay(name)
        self._out[name] = self._run_core(loc)
        return self._out[name]

    def _lost(self, loc: bool, generator) -> torch.Tensor:
        if not self.graphed:
            return self._run_lost(loc, generator)
        if generator is not self.generator:
            raise ValueError("the LOST graph replays with the generator registered at its "
                             "capture")
        return self._replay(_MODES[loc][1])

    def _tail(self) -> torch.Tensor:
        if not self.graphed:
            return self._run_tail()
        timed = self.run_mapping and pipeline.mapping_passes_timed()
        if timed:
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
        row = self._replay("tail")
        if timed:
            torch.cuda.synchronize(self.device)
            pipeline.record_pass_seconds(time.perf_counter() - t0)
        return row

    # ------------------------------------------------------- buffers, capture

    def capture(self, m: MapState, carry: TrackCarry, frame: FrameData, run_mapping: bool,
                generator: torch.Generator | None = None,
                localization_only: bool = False) -> None:
        """Static buffers shaped and filled like (m, carry, frame), and one
        mode's parts warmed and, on the card, captured: SLAM mode's core,
        tail (with the mapping pass if run_mapping) and, with a vocabulary,
        LOST graph, or localization mode's core and LOST graph.  The LOST
        graph draws from `generator` (its state is left as it was).  m,
        carry and frame are copied, never written; new buffers drop the
        other mode's graphs."""
        self._S = _Static(_clone(m), _clone(carry), _clone(frame),
                          torch.zeros((), dtype=torch.float32, device=self.device))
        self._published = None
        self._graphs, self._out, self._modes = {}, {}, set()
        self._capture_mode(localization_only, run_mapping, generator)

    def _capture_mode(self, loc: bool, run_mapping: bool, generator) -> None:
        core_name, lost_name = _MODES[loc]
        names = [core_name] + ([lost_name] if self.with_reloc else []) + ([] if loc else ["tail"])
        for name in names:
            self._graphs.pop(name, None)
        self._modes.discard(loc)
        if not loc:
            self.run_mapping = run_mapping
        if self.with_reloc:
            self.generator = generator
        if not self.graphed:
            self._modes.add(loc)
            return
        t0 = time.perf_counter()
        S = self._S
        saved = _clone(S)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        scratch = torch.Generator(device=self.device).manual_seed(0)
        run = {core_name: lambda g: self._run_core(loc),
               lost_name: lambda g: self._run_lost(loc, g),
               "tail": lambda g: self._run_tail()}
        with pipeline.untimed_mapping_passes():
            with torch.cuda.stream(side):
                for _ in range(WARMUP_ITERS):
                    for name in names:
                        self._out[name] = run[name](scratch)
            main.wait_stream(side)
            _copy_into(S, saved)
            del saved
            pool = self.pool()
            for name in names:
                graph = torch.cuda.CUDAGraph()
                drawn = name == lost_name and generator is not None
                if drawn:
                    graph.register_generator_state(generator)
                    state = generator.get_state()
                with no_collection(), torch.cuda.graph(graph, pool=pool):
                    self._out[name] = run[name](generator)
                if drawn:
                    generator.set_state(state)
                self._graphs[name] = graph
        torch.cuda.synchronize(self.device)
        self._modes.add(loc)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def prepare(self, m: MapState, carry: TrackCarry, frame: FrameData, run_mapping: bool,
                generator: torch.Generator | None = None,
                localization_only: bool = False) -> None:
        """Make the static buffers hold (m, carry) and the mode's graphs
        exist: new buffers on first use or when a shape changes, the mode's
        capture when it has none (SLAM mode: or another run_mapping), else
        a copy of every field the caller's state holds apart from the
        static one."""
        S = self._S
        if (S is None or not _same_layout(S.map, m) or not _same_layout(S.carry, carry)
                or not _same_layout(S.frame, frame)):
            self.capture(m, carry, frame, run_mapping, generator, localization_only)
            return
        if m is not S.map:
            _copy_into(S.map, m)
        if carry is not self._published:
            _copy_into(S.carry, carry, skip=self._published)
        if localization_only not in self._modes or (not localization_only
                                                    and run_mapping != self.run_mapping):
            self._capture_mode(localization_only, run_mapping, generator)

    def _publish(self) -> TrackCarry:
        self._published = _clone(self._S.carry)
        return self._published

    # ------------------------------------------------------------------ steps

    def _step(self, frame: FrameData, timestamp, generator, out_row: torch.Tensor,
              host_info: bool, loc: bool):
        """One step on the static buffers; its packed StepInfo goes to
        out_row.  host_info: also return it on the host (numpy [40]), read
        in the same transfer as the last flags the step reads."""
        S = self._S
        _copy_into(S.frame, frame)
        S.ts.copy_(timestamp)
        c = self._core(loc)
        head = c.head.cpu().numpy() if host_info else c.head[:2].cpu().numpy()  # the host read
        if bool(head[0] > 0.5) and self.with_reloc:
            lost = self._lost(loc, generator)
            head = lost.cpu().numpy() if host_info else lost[:2].cpu().numpy()  # the second
            relocalization.record(bool(head[0] > 0.5))
            src = lost
        else:
            src = c.head
        if bool(head[1] > 0.5):   # a keyframe (never in localization mode)
            out_row.copy_(self._tail())
            return out_row.cpu().numpy() if host_info else None
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
        [B, 40] on the device)."""
        live = valid.tolist()
        if not any(live):
            return pipeline.batch_steps_frames(self.config, m, carry, frames, timestamps,
                                               valid, run_mapping,
                                               localization_only=localization_only,
                                               generator=generator)
        self.prepare(m, carry, frames.select(0), run_mapping, generator, localization_only)
        S = self._S
        out = torch.empty(len(live), INFO_WIDTH, dtype=torch.float32, device=self.device)
        for b, is_live in enumerate(live):
            if is_live:
                self._step(frames.select(b), timestamps[b], generator, out[b], False,
                           localization_only)
            else:
                out[b].copy_(pipeline.pack_infos([pipeline._skip_info(S.map, S.carry)])[0])
        return S.map, self._publish(), out
