#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. device: the card's name, count, and nvidia-smi's name and power limit;
  2. build: compile every kernel of the main path from the checkout's
     sources (nvcc, sm_90a) and print ptxas' registers / shared memory;
  3. kernels: run each kernel and its plain PyTorch version on the card at
     the main path's shapes; require bitwise equality; time both with CUDA
     events beside the kernel's bound;
  4. main path: the port's System (RGB-D, 640x480, 1000 features, the
     bench's capacities, chunk 4, mapping and loop closing off) streams
     1 + 60 frames of generate_sequence(seed=5, fx=520); require STATE_OK,
     >= 2 keyframes, ATE < 0.01 m and every kernel launched by that run.

The second-to-last line is the kernels JSON; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# main-path operating point (bench.py's default RGB-D configuration)
WIDTH, HEIGHT, FX, N_FEATURES, N_FRAMES, CHUNK = 640, 480, 520.0, 1000, 61, 4
ATE_LIMIT_M = 0.01


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def phase_device():
    import torch

    require(torch.cuda.is_available(), "no CUDA device is available")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name} x{count}")
    print(f"[device] nvidia-smi: {card}")
    return name, count, card


def phase_build():
    from self_commit_orb_slam2_tpu_torch.ops.orb import fast_band

    t0 = time.perf_counter()
    lib = fast_band.kernel.build()
    print(f"[build] {fast_band.kernel.name}: {lib.name} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in fast_band.kernel.build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"[build]   {line.strip()}")
    fast_band.kernel.function()  # load it
    return [fast_band.kernel]


def _cuda_time_ms(fn, reps: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _slab(images_u8, cfg):
    """The [G*H0p, W0] slab and the band arguments extract_batch gives the
    kernel for these frames."""
    import torch

    from self_commit_orb_slam2_tpu_torch.ops.orb import pyramid

    imgs = torch.from_numpy(images_u8.astype(np.float32)).cuda()
    levels = pyramid.build_pyramid(imgs, cfg.n_levels, cfg.scale_factor)
    dims = tuple(tuple(l.shape[-2:]) for l in levels)
    slab = pyramid.stack_slab_batch(levels)
    B, L, H0, W0 = slab.shape
    H0p = H0 + (-H0) % 16
    slab = slab[:, :, torch.clamp(torch.arange(H0p, device=slab.device), max=H0 - 1)]
    return slab.reshape(B * L * H0p, W0).contiguous(), H0p, dims


def fast_band_bound_ms(h: int, w: int) -> tuple[float, str]:
    """Least time for the band function on these inputs: the slab read once
    and four [h/16, w16] outputs written once, or its fp32 operations
    (integer bit operations not counted) at the published peak rates."""
    wp = w + (-w) % 16
    n_bytes = h * w * 4 + 4 * (h // 16) * wp * 4
    # per pixel and threshold: p+t, p-t; 16 taps x (2 compares, 2 excess
    # subtractions each for bright and dark, 2 accumulations); max; 8 NMS
    # compares; 1 band compare
    ops = h * w * 2 * (2 + 16 * (2 + 4 + 2) + 1 + 8 + 1)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernels(seq):
    import torch

    from self_commit_orb_slam2_tpu_torch.ops.orb import fast_band
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig

    cfg = OrbConfig(n_features=N_FEATURES)
    images = np.clip(seq.images, 0, 255).astype(np.uint8)
    results = {}
    # first-frame shape (8 slices), then a chunk of 4 frames (32 slices)
    for label, frames in (("first frame", images[0:1]), ("chunk", images[1:1 + CHUNK])):
        slab, H0p, dims = _slab(frames, cfg)
        args = (cfg.fast_threshold_hi, cfg.fast_threshold_lo, H0p, dims,
                cfg.border, cfg.n_levels)
        out_k = fast_band.fast_nms_bands_hi_lo(slab, *args)
        out_p = fast_band.fast_bands_plain(slab, *args)
        torch.cuda.synchronize()
        n_diff = sum(int((a != b).sum()) for a, b in zip(out_k, out_p))
        max_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(out_k, out_p))
        n_corners = int((out_k[2] > 0).sum())
        print(f"[kernels] fast_band {label}: slab {tuple(slab.shape)}, "
              f"{n_corners} band maxima > 0, differing entries {n_diff}, "
              f"max |kernel - plain| {max_err}")
        require(n_corners > 0, f"fast_band {label}: no corners found")
        require(n_diff == 0, f"fast_band {label}: {n_diff} entries differ from "
                             f"the plain version")
        if label == "chunk":
            ms = _cuda_time_ms(lambda: fast_band.fast_nms_bands_hi_lo(slab, *args), 100)
            plain_ms = _cuda_time_ms(lambda: fast_band.fast_bands_plain(slab, *args), 5, 1)
            bound_ms, bound_by = fast_band_bound_ms(*slab.shape)
            print(f"[kernels] fast_band chunk: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            results["fast_band"] = dict(
                name="fast_band", route="cuda",
                source="self_commit_orb_slam2_tpu_torch/csrc/fast_band.cu",
                replaces="self_commit_orb_slam2_tpu/ops/orb/fast_pallas.py:107",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return results


def phase_main_path(seq, kernels):
    import torch

    from self_commit_orb_slam2_tpu_torch.models.config import (
        Capacities, SlamConfig, TrackingConfig)
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse

    cam = CameraParams.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2,
                              bf=FX * 0.1, width=WIDTH, height=HEIGHT)
    cfg = SlamConfig(
        camera=cam, orb=OrbConfig(n_features=N_FEATURES),
        caps=Capacities(max_keyframes=64, max_points=16384, local_points=1024),
        tracking=TrackingConfig(max_frames_between_kf=10), sensor="rgbd")
    slam = System(cfg, enable_mapping=False, enable_loop_closing=False)
    images = np.clip(seq.images, 0, 255).astype(np.uint8)
    depths = np.clip(seq.depths * 1e3, 0, 65535).astype(np.uint16)
    ts = seq.timestamps

    for k in kernels:
        k.launches = 0
    sess = slam.open_stream("rgbd", CHUNK)
    warm = 1 + CHUNK  # the initializing frame + the first chunk
    sess.feed((images[:warm], depths[:warm]), ts[:warm])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.feed((images[warm:], depths[warm:]), ts[warm:])
    sess.finish()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}

    n_timed = N_FRAMES - warm
    fps = n_timed / dt
    _, est = slam.get_trajectory()
    require(len(est) == N_FRAMES, f"trajectory has {len(est)} poses, want {N_FRAMES}")
    require(np.all(np.isfinite(est)), "non-finite poses")
    ate = float(ate_rmse(est, seq.poses_gt[:len(est)]))
    n_kf, n_pt = slam.n_keyframes(), slam.n_points()
    print(f"[main] {N_FRAMES} frames {WIDTH}x{HEIGHT}, {N_FEATURES} features, "
          f"chunk {CHUNK}: state {slam.state}, keyframes {n_kf}, points {n_pt}, "
          f"ATE {ate:.6f} m")
    print(f"[main] steady stream: {n_timed} frames in {dt:.3f} s = {fps:.2f} "
          f"frames/s (host clock, ends in cuda.synchronize)")
    print(f"[main] launches during the run: {launches}")
    require(slam.state == STATE_OK, f"tracking lost (state {slam.state})")
    require(n_kf >= 2, f"only {n_kf} keyframes")
    require(ate < ATE_LIMIT_M, f"ATE {ate:.6f} m >= {ATE_LIMIT_M} m")
    n_extract = 1 + (N_FRAMES - 1) // CHUNK
    require(launches["fast_band"] == n_extract,
            f"fast_band launched {launches['fast_band']} times, want one per "
            f"extraction call ({n_extract})")
    return launches, fps, ate


def main() -> int:
    sys.path.insert(0, HERE)
    try:
        import torch  # noqa: F401
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    try:
        name, count, card = phase_device()
        try:
            import self_commit_orb_slam2_tpu_torch  # noqa: F401
        except ImportError as exc:
            raise PhaseError(f"the port's package is missing beside this script ({exc})")
        from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

        kernels = phase_build()
        t0 = time.perf_counter()
        seq = generate_sequence(n_frames=N_FRAMES, width=WIDTH, height=HEIGHT,
                                fx=FX, seed=5)
        print(f"[data] generate_sequence: {N_FRAMES} frames in "
              f"{time.perf_counter() - t0:.1f} s (host)")
        results = phase_kernels(seq)
        launches, fps, ate = phase_main_path(seq, kernels)
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    for k, n in launches.items():
        results[k]["launches"] = n
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"[summary] {card}: main path {fps:.2f} frames/s, ATE {ate:.6f} m")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
