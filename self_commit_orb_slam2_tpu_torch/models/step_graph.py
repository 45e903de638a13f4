"""The SLAM-mode step as two captured CUDA graphs.

Counterpart of the JAX package's jitted step: its System jits
batch_steps_frames and the per-frame step per sensor, donating the map and
the carry, and the branches of the step are lax.cond (the JAX package's
models/system.py and models/pipeline.py).  Here pipeline.track_step is split
at its host branches, and the two parts without one are captured once per
System into torch.cuda.CUDAGraphs that share one memory pool:

  core  pipeline.step_core: both motion hypotheses, local-map tracking, the
        keyframe decision and the LOST flag; it writes the carry of a frame
        that takes neither branch into the static carry;
  tail  pipeline.keyframe_tail: keyframe insertion and the mapping pass; it
        writes the static map and carry.

A steady frame is one copy of the frame into the static frame, one replay
of the core and one host read of its two flags (pipeline.track_step's read).
A keyframe frame replays the tail after that.  The LOST branch
(pipeline.relocalize_branch, which draws random numbers) runs eagerly on the
same buffers, and so does the keyframe tail after it; localization mode
does not come here (System keeps pipeline.track_step for it).

The static buffers are the map, the carry (its last frame included), the
frame and the timestamp.  The invariant: the graphs read the state the host
thinks it has.  Before every step the caller's map and carry are compared
field by field with the static ones, and a field that holds another tensor
(the eager branches, the loop closer, a re-based or relocalized carry,
load_map, reset: anything but a graph wrote it) is copied in.  After a step
the caller's map is the static map (updated in place, as insert_keyframe
already updates the map in pipeline.track_step), its carry is a copy out of
the static carry, and the step infos are copies out of the pool.

The capture: WARMUP_ITERS eager runs of both parts on a side stream (cuBLAS
and cuSOLVER handles, the caching allocator), the static buffers restored
from a copy taken before them, then the two captures.  It happens in
System.warm_start (on a scratch state), else at the first tracked frame,
and again only if a buffer's shape or dtype changes.

On the CPU the same runner calls the captured functions on the same static
buffers instead of replaying them: the plain version, which the tests hold
bitwise against pipeline.track_step.  On a CUDA device it replays, or
raises: nothing falls back to eager execution when a capture fails.
"""

from __future__ import annotations

import itertools
import time
from typing import NamedTuple

import numpy as np
import torch

from . import pipeline
from .config import SlamConfig
from .frame import FrameData
from .map_state import MapState
from .pipeline import StepCore, TrackCarry

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
    """The SLAM-mode tracking step of one System (one sensor, one
    configuration) on static buffers: replayed from two CUDA graphs on the
    card, called as plain functions on the CPU."""

    def __init__(self, config: SlamConfig, device):
        self.config = config
        self.device = torch.device(device)
        self.run_mapping: bool | None = None   # the tail's, fixed at capture
        self.replays = 0      # graph replays (core and tail)
        self.captures = 0     # times both graphs were captured
        self.capture_s = 0.0  # host seconds of warm-up and capture, in all
        self._S: _Static | None = None
        self._graphs: tuple | None = None   # (core, tail) once captured
        self._core_out: _CoreOut | None = None
        self._tail_row: torch.Tensor | None = None
        self._published: TrackCarry | None = None   # the carry last handed out

    @property
    def graphed(self) -> bool:
        """True on the card (replays), False on the CPU (plain calls)."""
        return self.device.type == "cuda"

    # ------------------------------------------------------------ the parts

    def _run_core(self) -> _CoreOut:
        S = self._S
        # the LOST branch reads the carry the step started from, which the
        # core overwrites: copy it out first (its last frame stays static)
        before = S.carry._replace(**{f: getattr(S.carry, f).clone()
                                     for f in TrackCarry._fields if f != "last_frame"})
        core = pipeline.step_core(self.config, S.map, S.carry, S.frame)
        head = torch.cat([torch.stack([core.want_reloc, core.need_kf]).to(torch.float32),
                          pipeline.pack_infos([core.info])[0]])
        _copy_into(S.carry, core.carry)
        return _CoreOut(core, before, head)

    def _run_tail(self) -> torch.Tensor:
        S, c = self._S, self._core_out
        m, carry, info = pipeline.keyframe_tail(
            self.config, S.map, S.carry, S.frame, c.core.lres.obs_pt, c.before.frame_id,
            S.ts, self.run_mapping, c.core.info)
        _copy_into(S.map, m)
        _copy_into(S.carry, carry)
        return pipeline.pack_infos([info])[0]

    def _core(self) -> _CoreOut:
        if self.graphed:
            self._graphs[0].replay()
            self.replays += 1
        else:
            self._core_out = self._run_core()
        return self._core_out

    def _tail(self) -> torch.Tensor:
        if not self.graphed:
            return self._run_tail()
        timed = self.run_mapping and pipeline.mapping_passes_timed()
        if timed:
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
        self._graphs[1].replay()
        self.replays += 1
        if timed:
            torch.cuda.synchronize(self.device)
            pipeline.record_pass_seconds(time.perf_counter() - t0)
        return self._tail_row

    # ------------------------------------------------------- buffers, capture

    def capture(self, m: MapState, carry: TrackCarry, frame: FrameData,
                run_mapping: bool) -> None:
        """Static buffers shaped and filled like (m, carry, frame), both
        parts warmed and, on the card, captured (the tail with the mapping
        pass if run_mapping).  m, carry and frame are copied, never
        written."""
        self.run_mapping = run_mapping
        self._S = _Static(_clone(m), _clone(carry), _clone(frame),
                          torch.zeros((), dtype=torch.float32, device=self.device))
        self._published = None
        self._graphs = None
        if not self.graphed:
            return
        t0 = time.perf_counter()
        S = self._S
        saved = _clone(S)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with pipeline.untimed_mapping_passes():
            with torch.cuda.stream(side):
                for _ in range(WARMUP_ITERS):
                    self._core_out = self._run_core()
                    self._run_tail()
            main.wait_stream(side)
            _copy_into(S, saved)
            del saved
            pool = torch.cuda.graph_pool_handle()
            core, tail = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            with torch.cuda.graph(core, pool=pool):
                self._core_out = self._run_core()
            with torch.cuda.graph(tail, pool=pool):
                self._tail_row = self._run_tail()
        torch.cuda.synchronize(self.device)
        self._graphs = (core, tail)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def _load(self, m: MapState, carry: TrackCarry, frame: FrameData, run_mapping: bool) -> None:
        """Make the static buffers hold (m, carry): capture anew on first use
        or when a shape changes, else copy in every field the caller's state
        holds apart from the static one."""
        S = self._S
        if (S is None or run_mapping != self.run_mapping or not _same_layout(S.map, m)
                or not _same_layout(S.carry, carry) or not _same_layout(S.frame, frame)):
            self.capture(m, carry, frame, run_mapping)
            return
        if m is not S.map:
            _copy_into(S.map, m)
        if carry is not self._published:
            _copy_into(S.carry, carry, skip=self._published)

    def _publish(self) -> TrackCarry:
        self._published = _clone(self._S.carry)
        return self._published

    # ------------------------------------------------------------------ steps

    def _step(self, frame: FrameData, timestamp, generator, out_row: torch.Tensor,
              host_info: bool):
        """One step on the static buffers; its packed StepInfo goes to
        out_row.  host_info: also return it on the host (numpy [40]), read
        in the same transfer as the flags on a frame that takes no branch."""
        S = self._S
        _copy_into(S.frame, frame)
        S.ts.copy_(timestamp)
        c = self._core()
        head = c.head.cpu().numpy() if host_info else c.head[:2].cpu().numpy()  # the host read
        want = bool(head[0] > 0.5) and self.config.vocab is not None
        make_kf = bool(head[1] > 0.5)
        if want:
            core = pipeline.relocalize_branch(self.config, S.map, c.before, S.frame, c.core,
                                              generator)
            if bool(core.need_kf):
                m, carry, info = pipeline.keyframe_tail(
                    self.config, S.map, core.carry, S.frame, core.lres.obs_pt,
                    c.before.frame_id, S.ts, self.run_mapping, core.info)
            else:
                m, carry, info = S.map, core.carry, core.info
            _copy_into(S.map, m)
            _copy_into(S.carry, carry)
            out_row.copy_(pipeline.pack_infos([info])[0])
        elif make_kf:
            out_row.copy_(self._tail())
        else:
            out_row.copy_(c.head[2:])
            return head[2:] if host_info else None
        return out_row.cpu().numpy() if host_info else None

    def step(self, m: MapState, carry: TrackCarry, frame: FrameData, timestamp,
             run_mapping: bool = True, generator: torch.Generator | None = None):
        """pipeline.track_step in SLAM mode -> (map, carry, the packed
        StepInfo [40] on the host as numpy)."""
        self._load(m, carry, frame, run_mapping)
        row = torch.empty(INFO_WIDTH, dtype=torch.float32, device=self.device)
        info = self._step(frame, timestamp, generator, row, host_info=True)
        return self._S.map, self._publish(), np.asarray(info, np.float32)

    def batch_steps(self, m: MapState, carry: TrackCarry, frames: FrameData,
                    timestamps: torch.Tensor, valid: torch.Tensor,
                    run_mapping: bool = True, generator: torch.Generator | None = None):
        """pipeline.batch_steps_frames in SLAM mode -> (map, carry, packed
        StepInfo [B, 40] on the device)."""
        live = valid.tolist()
        if not any(live):
            return pipeline.batch_steps_frames(self.config, m, carry, frames, timestamps,
                                               valid, run_mapping, generator=generator)
        self._load(m, carry, frames.select(0), run_mapping)
        S = self._S
        out = torch.empty(len(live), INFO_WIDTH, dtype=torch.float32, device=self.device)
        for b, is_live in enumerate(live):
            if is_live:
                self._step(frames.select(b), timestamps[b], generator, out[b], host_info=False)
            else:
                out[b].copy_(pipeline.pack_infos([pipeline._skip_info(S.map, S.carry)])[0])
        return S.map, self._publish(), out
