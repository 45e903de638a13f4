"""The one generator of every traffic mix: a mix's data file
(traffic/<name>.json) gives the call pattern and the trajectory; the frames
come from the cycle (frames.py).  Frame k of a run is the cycle's frame
(k + start) mod F, stamped k / fps: the cycle replayed with time running
on.  A mix with a key nothing here reads is refused, so that a knob a data
file states is never silently ignored."""

from __future__ import annotations

import numpy as np

# (sensor, api) -> the System method the call goes through
_METHODS = {("rgbd", "batch"): "track_batch_rgbd", ("rgbd", "frame"): "track_rgbd",
            ("stereo", "batch"): "track_batch_stereo", ("stereo", "frame"): "track_stereo",
            ("mono", "batch"): "track_batch_mono", ("mono", "frame"): "track_monocular"}
# every key a mix may state: the call pattern (api, frames_per_call, loop,
# clients), the frames (trajectory, cycle_frames: frames.py) and the run's
# phases (warmup_cycles, trace_calls: drive.py)
MIX_KEYS = {"api", "frames_per_call", "loop", "clients", "trajectory", "cycle_frames",
            "warmup_cycles", "trace_calls"}


def check_mix(mix: dict) -> dict:
    unknown = set(mix) - MIX_KEYS
    if unknown:
        raise ValueError(f"the mix states keys nothing reads: {sorted(unknown)}")
    return mix


class Calls:
    """Makes each call of a mix: its frame numbers and its arguments."""

    def __init__(self, mix: dict, sensor: str, cycle, fps: float):
        check_mix(mix)
        if mix.get("loop", "closed") != "closed" or int(mix.get("clients", 1)) != 1:
            raise ValueError("only a closed loop with one client is generated")
        self.api = mix["api"]
        self.method = _METHODS[(sensor, self.api)]
        self.per_call = int(mix["frames_per_call"])
        if self.api == "frame" and self.per_call != 1:
            raise ValueError("a per-frame call takes one frame")
        self.cycle = cycle
        # the planes a call hands over: the image, then depth or the right eye
        self.planes = (cycle.left,) + {"rgbd": (cycle.depth,), "stereo": (cycle.right,),
                                       "mono": ()}[sensor]
        self.fps = float(fps)
        self.next_frame = 0

    def frame_numbers(self, n: int) -> np.ndarray:
        k = np.arange(self.next_frame, self.next_frame + n)
        self.next_frame += n
        return k

    def arguments(self, k: np.ndarray) -> tuple:
        """The API's arguments for frames k, made before the call is timed."""
        c = self.cycle.index(k)
        ts = k.astype(np.float64) / self.fps
        if self.api == "batch":
            return (*(p[c] for p in self.planes), ts)
        return (*(p[c[0]] for p in self.planes), float(ts[0]))

    def invoke(self, slam, args) -> np.ndarray:
        """Poses [n, 4, 4] of the call."""
        out = getattr(slam, self.method)(*args)
        return np.asarray(out, np.float64).reshape(-1, 4, 4)
