"""Frames/s of the op-by-op fleet (chip_smoke.py path 8 (c)), for any tree.

    python self_commit_orb_slam2_tpu_torch/tools/fleet_rate.py --root DIR \\
        [--frames FILE.npz] [--repeat N]

Imports the port from DIR (a checkout or an unpacked archive of any commit
since the fleet exists), so the fleets of two commits can be timed in one
call on one card: run it once per tree, in turns.  A FleetTracker of 4
RGB-D streams (generate_sequence seeds 5 to 8, 1 + 24 frames each, 640x480,
1000 features, capacities 64 / 16384 / 1024, mapping on, chunk 4) tracks
every stream; prints its state, ATE per stream, and frames/s per stream and
for the fleet, over the whole run and steady (after the first chunk),
host clock (track_chunk returns the poses on the host), `repeat` times.
The rendered frames are cached in FILE (rendered by DIR's own synthetic
module when FILE is missing).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

N_STREAMS, N_FRAMES, SEED, CHUNK = 4, 25, 5, 4
WIDTH, HEIGHT, FX, N_FEATURES = 640, 480, 520.0, 1000


def _render(root: str, seed: int):
    sys.path.insert(0, root)
    from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

    return generate_sequence(n_frames=N_FRAMES, width=WIDTH, height=HEIGHT, fx=FX, seed=seed)


def _frames(path: str, root: str) -> dict:
    if not os.path.exists(path):
        with ProcessPoolExecutor(N_STREAMS,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            seqs = list(pool.map(_render, [root] * N_STREAMS,
                                 [SEED + s for s in range(N_STREAMS)]))
        np.savez(path, **{f: np.stack([getattr(q, f) for q in seqs])
                          for f in ("images", "depths", "timestamps", "poses_gt")})
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--frames", default="_scratch/fleet_frames.npz")
    ap.add_argument("--repeat", type=int, default=1)
    a = ap.parse_args()
    frames_path = os.path.abspath(a.frames)
    os.makedirs(os.path.dirname(frames_path), exist_ok=True)
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch

    from self_commit_orb_slam2_tpu_torch.models.config import (
        Capacities, SlamConfig, TrackingConfig)
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
    from self_commit_orb_slam2_tpu_torch.parallel.fleet import FleetTracker
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse

    import self_commit_orb_slam2_tpu_torch as pkg
    print(f"[fleet_rate] package {os.path.dirname(pkg.__file__)}; "
          f"{torch.cuda.get_device_name(0)}")
    q = _frames(frames_path, root)
    cfg = SlamConfig(
        camera=CameraParams.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, bf=FX * 0.1,
                                   width=WIDTH, height=HEIGHT),
        orb=OrbConfig(n_features=N_FEATURES),
        caps=Capacities(max_keyframes=64, max_points=16384, local_points=1024),
        tracking=TrackingConfig(max_frames_between_kf=10), sensor="rgbd")
    for r in range(a.repeat):
        fleet = FleetTracker(cfg, n_streams=N_STREAMS)
        t0 = time.perf_counter()
        fleet.initialize(q["images"][:, 0], q["depths"][:, 0], q["timestamps"][:, 0])
        torch.cuda.synchronize()
        chunk_s, poses = [], []
        for lo in range(1, N_FRAMES, CHUNK):
            t1 = time.perf_counter()
            sl = slice(lo, min(lo + CHUNK, N_FRAMES))
            poses.append(fleet.track_chunk(q["images"][:, sl], q["depths"][:, sl],
                                           q["timestamps"][:, sl]))
            chunk_s.append(time.perf_counter() - t1)
        total = time.perf_counter() - t0
        est = np.concatenate([np.broadcast_to(np.eye(4, dtype=np.float32),
                                              (N_STREAMS, 1, 4, 4)),
                              np.concatenate(poses, axis=1)], axis=1)
        ates = [round(float(ate_rmse(est[s], q["poses_gt"][s])), 6) for s in range(N_STREAMS)]
        n_steady = N_FRAMES - 1 - CHUNK
        steady = sum(chunk_s[1:])
        print(f"[fleet_rate] run {r}: state_ok {fleet.state_ok.tolist()}, ATE {ates} m; "
              f"{total:.3f} s: {N_FRAMES / total:.3f} frames/s per stream, "
              f"{N_STREAMS * N_FRAMES / total:.3f} for the fleet; steady "
              f"{n_steady / steady:.3f} per stream, {N_STREAMS * n_steady / steady:.3f} for "
              f"the fleet (host clock)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
