"""Persistent chunked streaming session over a live System.

Counterpart of the JAX package's models/streaming.py::StreamSession for the
three sensors: feed() frames for the lifetime of a run; every full chunk
goes to the device as one packed buffer, is built through one extraction
chain and tracked frame by frame; finish() flushes the padded tail and
records the trajectory.  Before the map exists the leading frames go through
the per-frame path: one for RGB-D and stereo, as many as the two-view
bootstrap takes for mono.  (The reference analogue is the standing Tracking
thread and its queues, src/System.cc:116-145.)

With the loop closer on, every LOOP_CHUNK_STRIDE chunks the group's step
infos are read back (with the map's keyframe seqs, one transfer), loop
detection is dispatched for the keyframes created in it, and the closer
resolves: see models/loop_closing.py.  On the card with the graphs a chunk
is one frame-phase replay and one chunk-graph replay (models/step_graph.py)
and the host reads nothing until the drain: inside no_host_reads() every
dispatch runs them under torch.cuda.set_sync_debug_mode("error"), so that a
host read there raises (the tests and chip_smoke.py check so).  Each chunk
is followed by exactly one drain; what a drain consumes is fixed by the
chunk count, never by whether a device-to-host copy has finished (the JAX
session polls is_ready), so the poses, keyframes and closures do not depend
on timing, on how the frames are split between feed() calls, or on poll().  finish() drains with block:
the last group is consumed, a pending global BA runs its remaining slices
and is merged.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from . import pipeline

STATE_NOT_INITIALIZED = 0
STATE_OK = 1
STATE_LOST = 2

# chunks per loop-detection group (the JAX session's SLAM_LOOP_CHUNK_STRIDE default)
LOOP_CHUNK_STRIDE = 4

# sensor -> (host-side chunk packer, device-side frame phase)
_SENSORS = {
    "rgbd": (pipeline.pack_rgbd_chunk, pipeline.frames_rgbd_packed),
    "stereo": (pipeline.pack_stereo_chunk, pipeline.frames_stereo_packed),
    "mono": (pipeline.pack_mono_chunk, pipeline.frames_mono_packed),
}


_no_host_reads = False   # set by no_host_reads()


@contextlib.contextmanager
def no_host_reads():
    """Inside the block, a dispatch of a System with CUDA graphs runs its
    frame phase and its tracking under torch.cuda.set_sync_debug_mode
    ("error"): any op that waits for the card there raises.  A first run
    that captures a graph is set-up, and synchronizes as it must."""
    global _no_host_reads
    saved, _no_host_reads = _no_host_reads, True
    try:
        yield
    finally:
        _no_host_reads = saved


@contextlib.contextmanager
def checked_dispatch(sg):
    """The block under torch.cuda.set_sync_debug_mode("error") inside
    no_host_reads(), when `sg` (a StepGraph or None) replays graphs."""
    if not (_no_host_reads and sg is not None and sg.graphed):
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


class StreamSession:
    """One live stream of frames into a System.  Not thread-safe; at most
    one session may be active per System (chunks update its map)."""

    def __init__(self, system, sensor: str, chunk: Optional[int] = None):
        if sensor not in _SENSORS:
            raise ValueError(f"unknown sensor {sensor!r}")
        self.sys = system
        self.sensor = sensor
        self.pack, self.frame_fn = _SENSORS[sensor]
        self.C = int(chunk or system._batch_chunk)
        self.loc = system.localization_only  # frozen at open
        lc = system._loop_closer
        self.per_chunk_loops = lc is not None and lc.enabled
        self.stride = LOOP_CHUNK_STRIDE
        self._tail: list | None = None    # frames that do not yet fill a chunk
        self._tail_ts: list = []
        self._pending: list = []          # packed StepInfo of the group being filled
        self._packed_parts: list = []     # per-chunk packed StepInfo (device or host)
        self._all_ts: list = []           # timestamps of every dispatched frame
        self.n_fed = 0

    def feed(self, arrays: tuple, timestamps) -> None:
        """Queue frames and [B] timestamps.  `arrays` holds [B, H, W] host
        arrays: (images uint8, depths uint16 mm) for rgbd, (left, right)
        uint8 for stereo, (images,) uint8 for mono.  Dispatches every full
        chunk; the leading frames of a new map initialize it."""
        ts = np.asarray(timestamps, np.float64).reshape(-1)
        arrays = tuple(np.asarray(a) for a in arrays)
        i0 = 0
        if (self.sys.state == STATE_NOT_INITIALIZED and self.n_fed == 0
                and self._tail is None):
            # bootstrap through the per-frame path: one frame for stereo and
            # RGB-D, possibly several for the monocular two-view
            # initialization (which restarts until the parallax suffices)
            while self.sys.state == STATE_NOT_INITIALIZED and i0 < len(ts):
                first = tuple(
                    torch.from_numpy(a[i0].astype(np.float32) * np.float32(
                        1e-3 if a.dtype == np.uint16 else 1.0)) for a in arrays)
                self.sys._track(self.sensor, first, float(ts[i0]))
                i0 += 1
                if self.sensor != "mono" and self.sys.state == STATE_NOT_INITIALIZED:
                    raise RuntimeError("initialization failed on first frame")
            if self.sys.state == STATE_NOT_INITIALIZED:
                return  # mono: keep bootstrapping on the next feed
        if i0 >= len(ts):
            return
        if self._tail is None:
            self._tail = [a[i0:] for a in arrays]
            self._tail_ts = list(ts[i0:])
        else:
            self._tail = [np.concatenate([t, a[i0:]]) for t, a in zip(self._tail, arrays)]
            self._tail_ts.extend(ts[i0:])
        C = self.C
        n_full = len(self._tail_ts) // C
        for j in range(n_full):
            ts_j = self._tail_ts[j * C:(j + 1) * C]
            self._dispatch(self._upload([a[j * C:(j + 1) * C] for a in self._tail],
                                        ts_j), ts_j)
        self._tail = [a[n_full * C:] for a in self._tail]
        self._tail_ts = self._tail_ts[n_full * C:]

    def _upload(self, arrs: list, ts: list) -> np.ndarray:
        """The packed host chunk of these frames, padded to C with the last."""
        n_live = len(ts)
        pad = self.C - n_live
        if pad:
            arrs = [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]) for a in arrs]
            ts = list(ts) + [ts[-1]] * pad
        valid = np.zeros(self.C, bool)
        valid[:n_live] = True
        return self.pack(*arrs, np.asarray(ts, np.float32), valid)

    def _dispatch(self, host_buf: np.ndarray, ts_live: list) -> None:
        with checked_dispatch(self.sys.step_graph):   # no host read until the drain
            frames, ts, valid = self.sys._frame_phase(self.sensor, host_buf)
            packed = self.sys._batch_steps(frames, ts, valid, self.loc)
        n_live = len(ts_live)
        self._all_ts.extend(ts_live)
        self.n_fed += n_live
        if self.per_chunk_loops:
            self._pending.append(packed[:n_live])
            self._drain(force=False)
        else:
            self._packed_parts.append(packed[:n_live])

    def _drain(self, force: bool) -> None:
        """The drain after a chunk (force: the last one): a full group of
        step infos (any group, with force) is read back with the map's
        keyframe seqs in one transfer and its keyframes dispatched for
        detection; then the closer resolves and every re-base payload it
        fired moves the tracking carry once."""
        if len(self._pending) >= self.stride or (force and self._pending):
            cat = torch.cat(self._pending)
            self._pending = []
            m = self.sys.map
            host = torch.cat([cat.reshape(-1), m.kf_seq.to(torch.float32),
                              m.kf_valid.to(torch.float32)]).cpu().numpy()
            K = m.max_kf
            arr = host[:cat.numel()].reshape(cat.shape)
            self._packed_parts.append(self.sys._consume_chunk_infos(
                arr, host[cat.numel():cat.numel() + K].astype(np.int32),
                host[cat.numel() + K:] > 0.5))
        lc = self.sys._loop_closer
        if lc.pending():
            self.sys.map, fired = lc.resolve(self.sys.map, block=force)
            for payload in fired:
                self.sys._apply_correction_to_carry(*payload)

    def poll(self) -> None:
        """The JAX session's opportunistic drain.  Here every chunk's drain
        runs when the chunk is dispatched, so nothing is left for a poll to
        land: a stream gives the same result whether and when it polls."""

    def finish(self) -> np.ndarray:
        """Flush the tail (padded final chunk), drain the loop closer with
        block, record the trajectory, and return [B, 4, 4] poses of every
        frame dispatched since the session opened (the initializing frame
        excluded)."""
        if self._tail is not None and self._tail_ts:
            ts_live = self._tail_ts
            self._dispatch(self._upload(self._tail, ts_live), ts_live)
        self._tail, self._tail_ts = None, []
        if self.per_chunk_loops:
            self._drain(force=True)
        if not self._packed_parts:
            return np.zeros((0, 4, 4), np.float32)
        parts = self._packed_parts   # device tensors, or host arrays when read per group
        packed_all = (torch.cat(parts).cpu().numpy() if torch.is_tensor(parts[0])
                      else np.concatenate(parts))
        self._packed_parts = []
        assert packed_all.shape[0] == len(self._all_ts)
        infos = pipeline.unpack_infos(packed_all)
        sysm = self.sys
        for b in range(packed_all.shape[0]):
            tsb = float(self._all_ts[b])
            sysm.trajectory.append((tsb, infos.Tcw[b]))
            sysm._rel_trajectory.append(
                (tsb, int(infos.ref_kf_seq[b]),
                 infos.Tcw[b] @ np.linalg.inv(infos.ref_kf_Tcw[b])))
        self._all_ts = []
        sysm.Tcw = infos.Tcw[-1]
        sysm.state = STATE_OK if bool(infos.state_ok[-1]) else STATE_LOST
        sysm.vo_mode = bool(infos.vo[-1])
        return infos.Tcw
