"""Where the port's RGB-D stream spends its time on the card.

    python -m self_commit_orb_slam2_tpu_torch.tools.profile_stream [n_chunks] [--path2]

Runs a port path (640x480, 1000 features, the bench's capacities, chunk 4,
loop closing off) on generate_sequence frames: path 1 (16-px cells, mapping
off) by default, path 2 (8-px cells, mapping on) with --path2.  Then over
`n_chunks` steady chunks (default 2):
  * host-clock time of the frame phase (frames_rgbd_packed) and the tracking
    phase (batch_steps_frames), each ending in cuda.synchronize, and of the
    mapping passes inside the tracking phase (synced around each pass);
  * a torch.profiler trace: device busy time against wall time (the idle
    share), launches per frame, and the top operators by host and by device
    time.
Needs a CUDA device.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from ..models import pipeline
from ..models.config import Capacities, SlamConfig, TrackingConfig
from ..models.system import System
from ..ops.camera import CameraParams
from ..ops.orb.extractor import OrbConfig
from ..utils.synthetic import generate_sequence

WIDTH, HEIGHT, FX, N_FEATURES, CHUNK = 640, 480, 520.0, 1000, 4


def main(n_chunks: int = 2, path2: bool = False) -> None:
    n_frames = 1 + CHUNK * (1 + 2 * n_chunks)
    seq = generate_sequence(n_frames=n_frames, width=WIDTH, height=HEIGHT, fx=FX, seed=5)
    cam = CameraParams.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2,
                              bf=FX * 0.1, width=WIDTH, height=HEIGHT)
    cfg = SlamConfig(camera=cam,
                     orb=OrbConfig(n_features=N_FEATURES, cell_size=8 if path2 else 16),
                     caps=Capacities(max_keyframes=64, max_points=16384,
                                     local_points=1024),
                     tracking=TrackingConfig(max_frames_between_kf=10))
    slam = System(cfg, enable_mapping=path2, enable_loop_closing=False)
    images = np.clip(seq.images, 0, 255).astype(np.uint8)
    depths = np.clip(seq.depths * 1e3, 0, 65535).astype(np.uint16)
    sess = slam.open_stream("rgbd", CHUNK)
    sess.feed((images[:1 + CHUNK], depths[:1 + CHUNK]), seq.timestamps[:1 + CHUNK])
    torch.cuda.synchronize()

    def chunk_buf(k):
        s = 1 + CHUNK * (1 + k)
        return sess._upload([images[s:s + CHUNK], depths[s:s + CHUNK]],
                            list(seq.timestamps[s:s + CHUNK]))

    # host-clock phase split
    frame_s, track_s = [], []
    with pipeline.timed_mapping_passes() as map_s:
        for k in range(n_chunks):
            buf = chunk_buf(k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames, ts, valid = pipeline.frames_rgbd_packed(cfg, buf)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            slam.map, slam.carry, _ = pipeline.batch_steps_frames(
                cfg, slam.map, slam.carry, frames, ts, valid, slam.enable_mapping)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            frame_s.append(t1 - t0)
            track_s.append(t2 - t1)
    print(f"path {2 if path2 else 1}: frame phase: {np.mean(frame_s) / CHUNK * 1e3:.3f} "
          f"ms/frame, tracking phase: {np.mean(track_s) / CHUNK * 1e3:.3f} ms/frame, of "
          f"which mapping {sum(map_s) / (n_chunks * CHUNK) * 1e3:.3f} ms/frame "
          f"({len(map_s)} passes; host clock, {n_chunks} chunks of {CHUNK})")

    # profiler over the next chunks
    from torch.profiler import ProfilerActivity, profile

    bufs = [chunk_buf(n_chunks + k) for k in range(n_chunks)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for buf in bufs:
            frames, ts, valid = pipeline.frames_rgbd_packed(cfg, buf)
            slam.map, slam.carry, _ = pipeline.batch_steps_frames(
                cfg, slam.map, slam.carry, frames, ts, valid, slam.enable_mapping)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device time and launches from the kernel events themselves (operator
    # rows repeat their kernels' device time)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_launch = sum(e.count for e in kernels)
    n_fr = n_chunks * CHUNK
    print(f"profiled {n_fr} frames: wall {wall * 1e3:.1f} ms, device busy "
          f"{dev_us / 1e3:.1f} ms, idle share {1 - dev_us / 1e6 / wall:.3f}, "
          f"{n_launch / n_fr:.0f} device kernels per frame")
    print(events.table(sort_by="self_cpu_time_total", row_limit=25))
    print(events.table(sort_by="self_device_time_total", row_limit=15))


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--path2"]
    main(int(args[0]) if args else 2, path2="--path2" in sys.argv[1:])
