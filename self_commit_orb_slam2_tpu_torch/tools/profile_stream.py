"""Where the port's stream spends its time on the card.

    python -m self_commit_orb_slam2_tpu_torch.tools.profile_stream [n_chunks] [--path2|--stereo]

Runs a port path (the bench's capacities, chunk 4, loop closing off) on
generate_sequence frames: path 1 (RGB-D 640x480, 1000 features, 16-px cells,
mapping off) by default, path 2 (8-px cells, mapping on) with --path2, path
4 (a) (stereo at KITTI geometry, 1241x376, 2000 features, mapping on, no
vocabulary) with --stereo.  Then over `n_chunks` steady chunks (default 2):
  * host-clock time of the frame phase (frames_rgbd_packed or
    frames_stereo_packed; with --stereo also of the stereo matcher alone, on
    the chunk's own features) and the tracking phase (batch_steps_frames),
    each ending in cuda.synchronize, and of the mapping passes inside the
    tracking phase (synced around each pass);
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
from ..ops.matching import stereo as stereo_ops
from ..ops.orb import extractor, pyramid
from ..models.config import Capacities, SlamConfig, TrackingConfig
from ..models.system import System
from ..ops.camera import CameraParams
from ..ops.orb.extractor import OrbConfig
from ..utils.synthetic import generate_sequence

CHUNK = 4


def _stereo_match_ms(cfg: SlamConfig, buf: torch.Tensor) -> float:
    """Host-clock ms of match_stereo alone on the chunk's own features."""
    cam, orb = cfg.camera, cfg.orb
    H, W = cam.height, cam.width
    B = buf.shape[0]
    eyes = buf[:, :2 * H * W].reshape(B, 2, H, W).to(torch.float32)
    feats, slabs = extractor.extract_batch(torch.cat([eyes[:, 0], eyes[:, 1]]), orb)
    args = ([getattr(feats, f)[:B] for f in ("xy", "level", "desc", "valid")]
            + [getattr(feats, f)[B:] for f in ("xy", "level", "desc", "valid")]
            + [slabs[:B], slabs[B:], cam.bf, cam.baseline,
               torch.from_numpy(orb.scale_factors()).to(buf.device),
               pyramid.level_shapes(H, W, orb.n_levels, orb.scale_factor)])
    stereo_ops.match_stereo(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stereo_ops.match_stereo(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main(n_chunks: int = 2, path2: bool = False, stereo: bool = False) -> None:
    n_frames = 1 + CHUNK * (1 + 2 * n_chunks)
    width, height, fx, n_features = (1241, 376, 718.9, 2000) if stereo else (640, 480,
                                                                             520.0, 1000)
    seq = generate_sequence(n_frames=n_frames, width=width, height=height, fx=fx, seed=5,
                            stereo_baseline=0.1 if stereo else 0.0)
    cam = CameraParams.create(fx=fx, fy=fx, cx=width / 2, cy=height / 2,
                              bf=fx * 0.1, width=width, height=height)
    cfg = SlamConfig(camera=cam,
                     orb=OrbConfig(n_features=n_features, cell_size=8 if path2 else 16),
                     caps=Capacities(max_keyframes=64, max_points=16384,
                                     local_points=1024),
                     tracking=TrackingConfig(max_frames_between_kf=10),
                     sensor="stereo" if stereo else "rgbd")
    slam = System(cfg, enable_mapping=path2 or stereo, enable_loop_closing=False)
    images = np.clip(seq.images, 0, 255).astype(np.uint8)
    second = (np.clip(seq.right_images, 0, 255).astype(np.uint8) if stereo
              else np.clip(seq.depths * 1e3, 0, 65535).astype(np.uint16))
    sess = slam.open_stream(cfg.sensor, CHUNK)
    sess.feed((images[:1 + CHUNK], second[:1 + CHUNK]), seq.timestamps[:1 + CHUNK])
    torch.cuda.synchronize()
    frame_phase = sess.frame_fn
    name = "4a" if stereo else 2 if path2 else 1

    def chunk_buf(k):
        s = 1 + CHUNK * (1 + k)
        return sess._upload([images[s:s + CHUNK], second[s:s + CHUNK]],
                            list(seq.timestamps[s:s + CHUNK]))

    # host-clock phase split
    frame_s, track_s, match_ms = [], [], []
    with pipeline.timed_mapping_passes() as map_s:
        for k in range(n_chunks):
            buf = chunk_buf(k)
            if stereo:
                match_ms.append(_stereo_match_ms(cfg, buf))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames, ts, valid = frame_phase(cfg, buf)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            slam.map, slam.carry, _ = pipeline.batch_steps_frames(
                cfg, slam.map, slam.carry, frames, ts, valid, slam.enable_mapping)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            frame_s.append(t1 - t0)
            track_s.append(t2 - t1)
    if stereo:
        print(f"path 4a: match_stereo alone {np.mean(match_ms) / CHUNK:.3f} ms/frame (host "
              f"clock, synced, inside the frame phase below)")
    print(f"path {name}: frame phase: {np.mean(frame_s) / CHUNK * 1e3:.3f} "
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
            frames, ts, valid = frame_phase(cfg, buf)
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
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(int(args[0]) if args else 2, path2="--path2" in sys.argv[1:],
         stereo="--stereo" in sys.argv[1:])
