"""Persistent chunked streaming session over a live System.

Counterpart of the JAX package's models/streaming.py::StreamSession for the
three sensors with the loop closer off (local mapping, the vocabulary and
localization mode as the System says): feed() frames for the lifetime of a
run; every full chunk goes to the device as one packed buffer, is built
through one extraction chain and tracked frame by frame; finish() flushes the
padded tail and records the trajectory.  Before the map exists the leading
frames go through the per-frame path: one for RGB-D and stereo, as many as
the two-view bootstrap takes for mono.  (The reference analogue is the
standing Tracking thread and its queues, src/System.cc:116-145.)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import pipeline

STATE_NOT_INITIALIZED = 0
STATE_OK = 1
STATE_LOST = 2

# sensor -> (host-side chunk packer, device-side frame phase)
_SENSORS = {
    "rgbd": (pipeline.pack_rgbd_chunk, pipeline.frames_rgbd_packed),
    "stereo": (pipeline.pack_stereo_chunk, pipeline.frames_stereo_packed),
    "mono": (pipeline.pack_mono_chunk, pipeline.frames_mono_packed),
}


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
        self._tail: list | None = None    # frames that do not yet fill a chunk
        self._tail_ts: list = []
        self._packed_parts: list = []     # per-chunk packed StepInfo (device)
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

    def _upload(self, arrs: list, ts: list) -> torch.Tensor:
        n_live = len(ts)
        pad = self.C - n_live
        if pad:
            arrs = [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]) for a in arrs]
            ts = list(ts) + [ts[-1]] * pad
        valid = np.zeros(self.C, bool)
        valid[:n_live] = True
        buf = self.pack(*arrs, np.asarray(ts, np.float32), valid)
        return torch.from_numpy(buf).to(self.sys.device)

    def _dispatch(self, buf: torch.Tensor, ts_live: list) -> None:
        cfg = self.sys.config
        frames, ts, valid = self.frame_fn(cfg, buf)
        self.sys.map, self.sys.carry, packed = pipeline.batch_steps_frames(
            cfg, self.sys.map, self.sys.carry, frames, ts, valid,
            self.sys.enable_mapping, localization_only=self.loc,
            generator=self.sys._stream_gen)
        n_live = len(ts_live)
        self._packed_parts.append(packed[:n_live])
        self._all_ts.extend(ts_live)
        self.n_fed += n_live

    def finish(self) -> np.ndarray:
        """Flush the tail (padded final chunk), record the trajectory, and
        return [B, 4, 4] poses of every frame dispatched since the session
        opened (the initializing frame excluded)."""
        if self._tail is not None and self._tail_ts:
            ts_live = self._tail_ts
            self._dispatch(self._upload(self._tail, ts_live), ts_live)
        self._tail, self._tail_ts = None, []
        if not self._packed_parts:
            return np.zeros((0, 4, 4), np.float32)
        packed_all = torch.cat(self._packed_parts).cpu().numpy()
        self._packed_parts = []
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
