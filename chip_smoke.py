#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. device: the card's name, count, and nvidia-smi's name and power limit;
  2. build: compile every kernel of the port's paths from the checkout's
     sources (one nvcc per source, all at once, sm_90a) and print ptxas'
     registers / shared memory;
  3. kernels: run each kernel and its plain PyTorch version on the card at
     its path's shapes (the first frame and a chunk of 4) and on a chunk-sized
     slab of uniform noise (the kernels' worst case); require bitwise
     equality; time the kernel on the device alone (launches on preallocated
     outputs replayed from a CUDA graph, L2 hot; then with the L2 flushed
     before each launch), the wrapper's host time per call and the plain
     version, beside the kernel's bound;
  4. the port's System (RGB-D, 640x480, 1000 features, the bench's
     capacities, chunk 4, loop closing off) streams 1 + 60 frames of
     generate_sequence(seed=5, fx=520) along each path, with every launch
     count set to 0 just before it and read just after:
       path 1: 16-px cells (FAST band kernel), local mapping off;
       path 2: 8-px cells (FAST NMS kernel + slab selection), local mapping
               on, one mapping pass per keyframe inserted after the first;
     each must end STATE_OK with >= 2 keyframes and ATE < 0.01 m, launch its
     own kernel once per extraction call and the other kernel never;
  5. vocabulary: the bundled vocabulary (k=10, L=6) is loaded and moved to
     the card; transform + sparse_bow of one extracted frame on the card must
     equal the same calls on the CPU (words, nodes, ids exactly; weights
     within 1e-6); ms per call; the three batched eigh calls of a
     relocalization, timed;
  6. path 3: one System with the vocabulary, 16-px cells, local mapping on,
     with the launch, mapping-pass and relocalization counts set to 0 before:
       a. 1 + 40 frames streamed: STATE_OK, >= 2 keyframes, ATE < 0.01 m, a
          BoW row and node ids in every keyframe, no relocalization attempt;
       b. one batch of 3 blank frames, frame 20 three times, frame 21 twice:
          recovers inside the batch, within 0.05 m of its own estimate;
       c. per frame: 3 blank frames (LOST), then frame 24 until it recovers;
       d. localization mode over frames 25 to 40: STATE_OK throughout, no
          keyframe and no point added, within 0.05 m of the estimates of (a);
       e. save_map, load_map into a second System: every field equal.
  7. the band kernel at the stereo paths' slab shapes (first pair 16 slices,
     chunk 64 slices, of 384x1241 and of 480x752): bitwise against the plain
     version, timed from a CUDA graph, bound recounted at each shape;
  8. stereo matcher: match_stereo on the card against the same call on the
     CPU on the first KITTI-geometry pair (valid equal on >= 99.5%, u_right
     within 0.02 px), the share of left keypoints that get a depth, their
     depth against the rendered ground-truth depth map (median relative
     error < 2%), ms per chunk of 4 pairs;
  9. path 4, stereo, vocabulary loaded, mapping on, chunk 4:
       a. KITTI geometry, 1241x376, fx 718.9, baseline 0.1, 2000 features:
          1 + 24 pairs streamed; ATE < 0.01 m;
       b. EuRoC geometry, 752x480, fx 458.7, baseline 0.11, 1200 features,
          raw eyes with mounting rotations rectified on the card: 1 + 8 pairs
          streamed, 4 more through track_stereo; ATE < 0.02 m;
     each STATE_OK, >= 2 keyframes, 0 relocalization attempts, the band
     kernel once per extraction call;
 10. two-view: initialize_two_view on the card against the CPU on one
     synthetic correspondence set with the same minimal sets (same model,
     n_good within 2%, pose within 1e-3); its eigh / svd shapes timed;
 11. path 5, mono, 640x480, 1000 features, vocabulary loaded, mapping on:
     the first 41 frames of the RGB-D sequence's images through
     track_batch_mono; the map initializes within 6 frames, STATE_OK, >= 3
     keyframes, Sim3-aligned ATE < 0.06 m;
 12. path 6, bench.py's default RGB-D operating point with loop closing on
     (System(cfg): the bundled vocabulary, 16-px cells, mapping on, global BA
     on, consistency 3): 184 frames of a 120-frame circle revolution
     (generate_sequence(seed=5, circle_trajectory)) streamed in chunks of 4
     through open_stream / feed / poll, with drift injected between feeds
     (utils/drift, one increment of bench.py's per-frame twist per frame,
     frames 9 to 120); requires STATE_OK, >= 1 closure, map_changed() once,
     a global BA merged, the corrected ATE (get_trajectory) below the raw
     per-frame poses' ATE, 0 relocalization attempts, the band kernel once
     per chunk and the first frame; prints each closure's detection,
     correction, GBA-slice and merge ms and the stall it cost the stream.
     Then the whole map torn rigidly, the tracker re-initialized on it at the
     revolution's first frame and its next frames per frame through
     track_rgbd until a per-frame closure joins the branches; then
     detect_and_verify (the same minimal sets), correct_loop and
     optimize_pose_graph on the card against the CPU from the first
     closure's state: the same candidate and found, poses within 1e-3.

 13. path 7, the drivers, on frames of the paths above written to disk in
     each dataset's layout (stdlib PNG writer), decoded by the native decoder
     (required; which decoder ran, and whether PIL, PyYAML and g++ are
     present, is printed first):
       a. TUM RGB-D layout (1 + 40 frames of path 1, 16-bit depth at
          DepthMapFactor 5000, a TUM1-style settings file):
          run_slam.main --dataset tum --batch 4 (the bundled vocabulary,
          System(cfg) with the closer), then --batch 0 on 13 frames; ATE of
          the written TUM file < 0.01 m, STATE_OK, >= 2 keyframes (batch run),
          B1 bitwise on the decoded frames;
       b. KITTI layout (1 + 16 pairs of path 4 (a)): --dataset kitti --batch
          4, run_slam's own configuration (2000 features, 256 / 131072 /
          4096); ATE < 0.01 m;
       c. EuRoC layout (1 + 8 raw pairs of path 4 (b), a settings file with
          the LEFT.* / RIGHT.* blocks): --dataset euroc --batch 4, rectified
          on the host; ATE < 0.02 m;
       d. stream_slam.serve: 20 frames as SLFR records through an os.pipe
          into a System primed by warm_start; 20 SLPO records, STATE_OK,
          poses within 1e-3 of a track_rgbd loop on the card;
       e. warm_start at bench.py's configuration with the vocabulary, in a
          fresh process, against an unprimed one: its seconds, the first
          chunk's ms against the median chunk's;
     each driver run's frames/s, ms per frame and decode share (host clock,
     synchronized with the card), and B1's launches (once per extraction
     call; B2 never).

Frame rendering (numpy, host) runs in a pool of worker processes started
first, beside the card work.  The second-to-last line is the kernels JSON
(each kernel with its launches on its own path; the band kernel also with
those on paths 3 to 7 and its times at the stereo shapes); the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

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


def _render(kind: str, kw: dict):
    """One rendering job in a worker process (host numpy)."""
    from self_commit_orb_slam2_tpu_torch.utils import synthetic

    if kind == "euroc":
        return synthetic.euroc_like_sequence(**kw)
    return synthetic.generate_sequence(**kw)


def _submit_frames(pool, traj, n_parts: int, **kw) -> list:
    """generate_sequence of `traj` rendered in n_parts slices (the scene
    comes from the seed, so the frames equal one sequential rendering)."""
    bounds = np.linspace(0, len(traj), n_parts + 1).astype(int)
    return [pool.submit(_render, "frames", dict(kw, n_frames=b - a, trajectory=traj[a:b]))
            for a, b in zip(bounds[:-1], bounds[1:]) if b > a]


def _join_frames(futures):
    from self_commit_orb_slam2_tpu_torch.utils.synthetic import SyntheticSequence

    parts = [f.result() for f in futures]
    cat = {f: np.concatenate([getattr(p, f) for p in parts])
           for f in ("images", "depths", "poses_gt")}
    n = len(cat["images"])
    right = (np.concatenate([p.right_images for p in parts])
             if parts[0].right_images is not None else None)
    return SyntheticSequence(K=parts[0].K, timestamps=np.arange(n, dtype=np.float64) / 30.0,
                             right_images=right, **cat)


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
    from concurrent.futures import ThreadPoolExecutor

    from self_commit_orb_slam2_tpu_torch.ops.orb import fast_band, fast_nms

    kernels = [fast_band.kernel, fast_nms.kernel]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:   # one nvcc per source, together
        libs = list(pool.map(lambda k: k.build(), kernels))
    print(f"[build] {len(kernels)} kernels in {time.perf_counter() - t0:.1f} s")
    for k, lib in zip(kernels, libs):
        print(f"[build] {k.name}: {lib.name}")
        for line in k.build_log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
        k.function()  # load it
    return {k.name: k for k in kernels}


def _event_time_ms(fn, reps: int = 5) -> float:
    """CUDA-event time per call, after a warm-up call (for calls with enough
    device work that the host does not set the time)."""
    import torch

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


def _fast_ops(image, thr: float, scored) -> int:
    """fp32 operations FAST at one threshold needs on this image over the
    pixels `scored` marks (integer bit work not counted): p + t, p - t and
    the 32 ring compares at each; then, at the pixels with a 9-arc only, 3
    for each brighter tap ((q - p) - t and its sum), 2 for each darker one
    ((p - t) - q and its sum) and the max of the two sums."""
    import torch

    from self_commit_orb_slam2_tpu_torch.ops.orb import fast

    h, w = image.shape
    pad = torch.nn.functional.pad(image[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    hi, lo = image + thr, image - thr
    bits_b, bits_d, n_b, n_d = (torch.zeros(image.shape, dtype=torch.int32,
                                            device=image.device) for _ in range(4))
    for k, (dy, dx) in enumerate(fast.RING_OFFSETS.tolist()):
        ring = pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
        bright, dark = (ring > hi).int(), (ring < lo).int()
        bits_b |= bright << k
        bits_d |= dark << k
        n_b += bright
        n_d += dark
    arc = scored & (fast._has_arc(bits_b) | fast._has_arc(bits_d))
    return 34 * int(scored.sum()) + int(((3 * n_b + 2 * n_d + 1) * arc).sum())


def _nms_ops(score, out, at) -> int:
    """fp32 compares the 3x3 NMS needs at the pixels `at` marks: 8 where a
    nonzero score is kept, at least 1 where one is dropped, none at a zero."""
    return int(8 * (at & (out > 0)).sum() + (at & (score > 0) & (out == 0)).sum())


def _scores(image, thr: float, inb):
    from self_commit_orb_slam2_tpu_torch.ops.orb import fast

    score = fast.fast_response(image, thr) * inb
    return score, fast.nms3x3(score)


def fast_band_bound_ms(image, thr_hi, thr_lo, H0p, dims, border, n_levels):
    """Least time for the band function on these inputs: the pixels it needs
    read once (those within 4 of a level mask: a masked pixel's NMS reads
    scores within 1, and a score reads pixels within 3) and four [h/16, w16]
    outputs written once, or the fp32 operations these inputs need at the
    published peak rates.  Operations: FAST (_fast_ops) at the pixels within
    1 of the level masks, where the NMS reads scores; the NMS (_nms_ops)
    inside the masks; one band-max compare for each nonzero masked maximum
    past the first of its band column.  Also returns the bound that charges
    the whole slab, as the earlier count did."""
    import torch

    from self_commit_orb_slam2_tpu_torch.ops.orb import fast_band, fast_nms

    h, w = image.shape
    valid = fast_band.level_valid_mask(h, w, H0p, dims, border, n_levels, image.device)
    inb = fast_nms.inner_mask(h, w, image.device)
    near = inb & (torch.nn.functional.max_pool2d(
        valid[None, None].float(), 3, 1, 1)[0, 0] > 0)
    ops = 0
    for thr in (thr_hi, thr_lo):
        score, out = _scores(image, thr, inb)
        per_col = (valid & (out > 0)).reshape(h // fast_band.BAND, fast_band.BAND, w).sum(1)
        ops += (_fast_ops(image, thr, near) + _nms_ops(score, out, valid)
                + int(torch.clamp_min(per_col - 1, 0).sum()))
    out_bytes = 4 * (h // fast_band.BAND) * fast_band.out_width(w) * 4
    needed = int((torch.nn.functional.max_pool2d(valid[None, None].float(), 9, 1, 4) > 0).sum())
    return _bound(needed * 4 + out_bytes, ops), _bound(h * w * 4 + out_bytes, ops)


def fast_nms_bound_ms(image, thr_hi, thr_lo):
    """Least time for the NMS function on these inputs: the image read once
    and two [h, w] float32 maps written once, or the fp32 operations these
    inputs need (_fast_ops off the 4-px border, _nms_ops everywhere) at the
    published peak rates."""
    from self_commit_orb_slam2_tpu_torch.ops.orb import fast_nms

    h, w = image.shape
    inb = fast_nms.inner_mask(h, w, image.device)
    ops = 0
    for thr in (thr_hi, thr_lo):
        score, out = _scores(image, thr, inb)
        ops += _fast_ops(image, thr, inb) + _nms_ops(score, out, inb)
    return _bound(h * w * 4 + 2 * h * w * 4, ops)


def _bound(n_bytes: float, ops: float) -> tuple[float, str, float, float]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            n_bytes, ops)


def _check_kernel(name, label, out_k, out_p, n_corners):
    import torch

    torch.cuda.synchronize()
    n_diff = sum(int((a != b).sum()) for a, b in zip(out_k, out_p))
    max_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(out_k, out_p))
    print(f"[kernels] {name} {label}: {n_corners} maxima > 0, differing entries "
          f"{n_diff}, max |kernel - plain| {max_err}")
    require(n_corners > 0, f"{name} {label}: no corners found")
    require(n_diff == 0, f"{name} {label}: {n_diff} entries differ from the plain version")
    return max_err


def _timed(name, source, replaces, slab, launch_fn, wrapper_fn, plain_fn, bound, max_err,
           noise_launch_fn, old=None):
    """Times of one kernel at the chunk shape.  `launch_fn` launches it on
    preallocated outputs (device time), `wrapper_fn` is the public wrapper
    (host time per call), `noise_launch_fn` the launch on the noise slab;
    `old` is the row's earlier bound, printed beside the new one."""
    from self_commit_orb_slam2_tpu_torch.tools import time_fast

    ms = time_fast.graph_time_ms(launch_fn)
    cold_ms = time_fast.cold_time_ms(launch_fn)
    host_ms = time_fast.host_time_ms(wrapper_fn)
    noise_ms = time_fast.graph_time_ms(noise_launch_fn)
    plain_ms = _event_time_ms(plain_fn)
    bound_ms, bound_by, n_bytes, ops = bound
    print(f"[kernels] {name} chunk {tuple(slab.shape)}: kernel {ms:.4f} ms on the device "
          f"(CUDA graph replay, L2 hot), {cold_ms:.4f} ms with the L2 flushed before each "
          f"launch, {noise_ms:.4f} ms on uniform noise (worst case, L2 hot); wrapper "
          f"{host_ms:.4f} ms of host time per call; plain {plain_ms:.4f} ms")
    print(f"[kernels] {name} bound {bound_ms:.4f} ms ({bound_by}: {n_bytes:.0f} bytes, "
          f"{ops} fp32 operations): the kernel takes {ms / bound_ms:.2f} x its bound")
    if old is not None:
        print(f"[kernels] {name} bound charging the whole slab, as counted before: "
              f"{old[0]:.4f} ms ({old[1]}: {old[2]:.0f} bytes)")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def phase_kernels(seq):
    import torch

    from self_commit_orb_slam2_tpu_torch.ops.orb import fast_band, fast_nms
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
    from self_commit_orb_slam2_tpu_torch.tools.time_fast import frames_slab, noise_slab

    cfg = OrbConfig(n_features=N_FEATURES)
    thr = (cfg.fast_threshold_hi, cfg.fast_threshold_lo)
    images = np.clip(seq.images, 0, 255).astype(np.uint8)
    results = {}
    # first-frame shape (8 slices), then a chunk of 4 frames (32 slices), then
    # uniform noise at the chunk shape: most pixels pass the kernels' pre-test
    for label, frames in (("first frame", images[0:1]), ("chunk", images[1:1 + CHUNK])):
        slab, H0p, dims = frames_slab(frames, cfg, band=True)
        args = (*thr, H0p, dims, cfg.border, cfg.n_levels)
        out_k = fast_band.fast_nms_bands_hi_lo(slab, *args)
        out_p = fast_band.fast_bands_plain(slab, *args)
        err = _check_kernel("fast_band", label, out_k, out_p, int((out_k[2] > 0).sum()))
        if label == "chunk":
            noise = noise_slab(slab.shape)
            out_k = fast_band.fast_nms_bands_hi_lo(noise, *args)
            err = max(err, _check_kernel("fast_band", "noise", out_k,
                                         fast_band.fast_bands_plain(noise, *args),
                                         int((out_k[2] > 0).sum())))
            outs = fast_band.empty_outputs(slab)
            bound, old_bound = fast_band_bound_ms(slab, *args)
            results["fast_band"] = _timed(
                "fast_band", "self_commit_orb_slam2_tpu_torch/csrc/fast_band.cu",
                "self_commit_orb_slam2_tpu/ops/orb/fast_pallas.py:107", slab,
                lambda: fast_band.launch(slab, outs, *args),
                lambda: fast_band.fast_nms_bands_hi_lo(slab, *args),
                lambda: fast_band.fast_bands_plain(slab, *args), bound, err,
                lambda: fast_band.launch(noise, outs, *args), old_bound)

        slab, _, _ = frames_slab(frames, cfg, band=False)
        out_k = fast_nms.fast_nms_hi_lo(slab, *thr)
        out_p = fast_nms.fast_nms_plain(slab, *thr)
        err = _check_kernel("fast_nms", label, out_k, out_p, int((out_k[1] > 0).sum()))
        if label == "chunk":
            noise = noise_slab(slab.shape)
            out_k = fast_nms.fast_nms_hi_lo(noise, *thr)
            err = max(err, _check_kernel("fast_nms", "noise", out_k,
                                         fast_nms.fast_nms_plain(noise, *thr),
                                         int((out_k[1] > 0).sum())))
            hi, lo = torch.empty_like(slab), torch.empty_like(slab)
            results["fast_nms"] = _timed(
                "fast_nms", "self_commit_orb_slam2_tpu_torch/csrc/fast_nms.cu",
                "self_commit_orb_slam2_tpu/ops/orb/fast_pallas.py:33", slab,
                lambda: fast_nms.launch(slab, hi, lo, *thr),
                lambda: fast_nms.fast_nms_hi_lo(slab, *thr),
                lambda: fast_nms.fast_nms_plain(slab, *thr),
                fast_nms_bound_ms(slab, *thr), err,
                lambda: fast_nms.launch(noise, hi, lo, *thr))
    return results


def phase_path(seq, kernels, label: str, cell_size: int, mapping: bool, own: str):
    """Stream the 61 frames through the System along one path; `own` is the
    FAST kernel the path must run (once per extraction call)."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import pipeline
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse

    cfg = _bench_config()
    cfg = cfg._replace(orb=cfg.orb._replace(cell_size=cell_size))
    slam = System(cfg, enable_mapping=mapping, enable_loop_closing=False)
    images = np.clip(seq.images, 0, 255).astype(np.uint8)
    depths = np.clip(seq.depths * 1e3, 0, 65535).astype(np.uint16)
    ts = seq.timestamps

    with pipeline.timed_mapping_passes() as pass_s:  # count and time them
        for k in kernels.values():
            k.launches = 0
        sess = slam.open_stream("rgbd", CHUNK)
        warm = 1 + CHUNK  # the initializing frame + the first chunk
        sess.feed((images[:warm], depths[:warm]), ts[:warm])
        torch.cuda.synchronize()
        n_warm_passes = len(pass_s)
        t0 = time.perf_counter()
        sess.feed((images[warm:], depths[warm:]), ts[warm:])
        sess.finish()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.values()}

    n_timed = N_FRAMES - warm
    fps = n_timed / dt
    _, est = slam.get_trajectory()
    require(len(est) == N_FRAMES, f"{label}: trajectory has {len(est)} poses, want {N_FRAMES}")
    require(np.all(np.isfinite(est)), f"{label}: non-finite poses")
    ate = float(ate_rmse(est, seq.poses_gt[:len(est)]))
    n_kf, n_pt = slam.n_keyframes(), slam.n_points()
    steady_map_s = sum(pass_s[n_warm_passes:])
    print(f"[{label}] {N_FRAMES} frames {WIDTH}x{HEIGHT}, {N_FEATURES} features, "
          f"cell {cell_size}, mapping {'on' if mapping else 'off'}, chunk {CHUNK}: "
          f"state {slam.state}, keyframes {n_kf}, points {n_pt}, culled keyframes "
          f"{int(slam.map.n_culled)}, ATE {ate:.6f} m")
    print(f"[{label}] steady stream: {n_timed} frames in {dt:.3f} s = {fps:.2f} "
          f"frames/s (host clock, ends in cuda.synchronize)")
    if mapping:
        print(f"[{label}] mapping passes: {len(pass_s)}, mean {np.mean(pass_s) * 1e3:.1f} ms "
              f"per pass (host clock, synced); steady stream: {steady_map_s:.3f} s of "
              f"mapping, {dt - steady_map_s:.3f} s of frame building and tracking")
    print(f"[{label}] launches during the run: {launches}")
    require(slam.state == STATE_OK, f"{label}: tracking lost (state {slam.state})")
    require(n_kf >= 2, f"{label}: only {n_kf} keyframes")
    require(ate < ATE_LIMIT_M, f"{label}: ATE {ate:.6f} m >= {ATE_LIMIT_M} m")
    n_extract = 1 + (N_FRAMES - 1) // CHUNK
    for name, n in launches.items():
        want = n_extract if name == own else 0
        require(n == want, f"{label}: {name} launched {n} times, want {want}")
    want_passes = n_kf - 1 if mapping else 0
    require(len(pass_s) == want_passes,
            f"{label}: {len(pass_s)} mapping passes, want {want_passes} (one per "
            f"keyframe inserted after initialization)")
    return launches[own], fps, ate


def _bench_config(vocab=None):
    from self_commit_orb_slam2_tpu_torch.models.config import (
        Capacities, SlamConfig, TrackingConfig)
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig

    cam = CameraParams.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2,
                              bf=FX * 0.1, width=WIDTH, height=HEIGHT)
    return SlamConfig(
        camera=cam, orb=OrbConfig(n_features=N_FEATURES),
        caps=Capacities(max_keyframes=64, max_points=16384, local_points=1024),
        tracking=TrackingConfig(max_frames_between_kf=10), sensor="rgbd", vocab=vocab)


def phase_vocabulary(seq):
    """Load the bundled vocabulary, move it to the card, and hold transform
    + sparse_bow on the card against the CPU on one extracted frame."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models.frame import make_frame_rgbd
    from self_commit_orb_slam2_tpu_torch.ops import bow

    path = bow.default_vocab_path()
    require(path is not None, "the bundled vocabulary file is missing from the checkout")
    t0 = time.perf_counter()
    vocab = bow.load_vocabulary(path)
    t_load = time.perf_counter() - t0
    on_card = vocab.to("cuda")
    torch.cuda.synchronize()
    print(f"[vocabulary] k={vocab.k} L={vocab.L} words={vocab.n_words} nodes="
          f"{vocab.node_desc.shape[0]}: {on_card.device_bytes()} bytes on the card "
          f"(child_desc {tuple(on_card.child_desc.shape)}); loaded in {t_load:.2f} s (host)")
    cfg = _bench_config()
    frame = make_frame_rgbd(cfg, torch.from_numpy(seq.images[0].astype(np.float32)).cuda(),
                            torch.from_numpy(seq.depths[0].astype(np.float32)).cuda())
    T = cfg.bow_top
    words_c, nodes_c = bow.transform(on_card, frame.desc, frame.valid)
    ids_c, vals_c = bow.sparse_bow(on_card, words_c, T)
    words, nodes = bow.transform(vocab, frame.desc.cpu(), frame.valid.cpu())
    ids, vals = bow.sparse_bow(vocab, words, T)
    torch.cuda.synchronize()
    n_valid, n_ids = int(frame.valid.sum()), int((ids >= 0).sum())
    err = float((vals_c.cpu() - vals).abs().max())
    print(f"[vocabulary] frame 0: {n_valid} descriptors, {n_ids} distinct words kept of "
          f"T={T}; card vs CPU: words equal {torch.equal(words_c.cpu(), words)}, nodes equal "
          f"{torch.equal(nodes_c.cpu(), nodes)}, ids equal {torch.equal(ids_c.cpu(), ids)}, "
          f"max weight difference {err:.2e}")
    require(n_valid > 500 and n_ids > 100, "vocabulary: too few descriptors or words")
    require(torch.equal(words_c.cpu(), words), "vocabulary: words differ between card and CPU")
    require(torch.equal(nodes_c.cpu(), nodes), "vocabulary: nodes differ between card and CPU")
    require(torch.equal(ids_c.cpu(), ids), "vocabulary: sparse ids differ between card and CPU")
    require(err <= 1e-6, f"vocabulary: weights differ by {err}")
    ms_t = _event_time_ms(lambda: bow.transform(on_card, frame.desc, frame.valid))
    ms_s = _event_time_ms(lambda: bow.sparse_bow(on_card, words_c, T))
    print(f"[vocabulary] transform {ms_t:.3f} ms + sparse_bow {ms_s:.3f} ms per call at "
          f"{frame.capacity} descriptors (CUDA events, after a warm-up)")
    # the three batched eigh calls of one relocalization (5 candidates x 256 sets)
    g = torch.Generator(device="cuda").manual_seed(0)
    eigh_ms = []
    for n in (3, 12, 4):
        a = torch.randn(1280, n, n, device="cuda", generator=g)
        sym = a @ a.transpose(1, 2)
        eigh_ms.append(_event_time_ms(lambda sym=sym: torch.linalg.eigh(sym), reps=5))
    print(f"[vocabulary] torch.linalg.eigh on the card, library "
          f"{torch.backends.cuda.preferred_linalg_library()}: [1280, 3, 3] {eigh_ms[0]:.3f} ms, "
          f"[1280, 12, 12] {eigh_ms[1]:.3f} ms, [1280, 4, 4] {eigh_ms[2]:.3f} ms")
    return vocab, ms_t + ms_s


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def phase_path3(seq, kernels, vocab):
    """The JAX package's default RGB-D configuration less loop closing: the
    vocabulary loaded, 16-px cells, local mapping on; steps (a) to (e)."""
    import tempfile

    import torch

    from self_commit_orb_slam2_tpu_torch.models import pipeline, relocalization
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_LOST, STATE_OK, System
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse

    label, n_a = "path 3", 41
    cfg = _bench_config(vocab)
    slam = System(cfg, enable_mapping=True, enable_loop_closing=False)
    require(slam.config.vocab.child_desc.is_cuda, f"{label}: the vocabulary is not on the card")
    images = np.clip(seq.images, 0, 255).astype(np.uint8)
    depths = np.clip(seq.depths * 1e3, 0, 65535).astype(np.uint16)
    ts = seq.timestamps
    blank, no_depth = np.zeros_like(seq.images[0]), np.zeros_like(seq.depths[0])

    def counts_ok(n_extract: int, where: str):
        got = {k.name: k.launches for k in kernels.values()}
        require(got == {"fast_band": n_extract, "fast_nms": 0},
                f"{label} {where}: launches {got}, want fast_band {n_extract}, fast_nms 0")

    with pipeline.timed_mapping_passes() as pass_s:
        for k in kernels.values():
            k.launches = 0
        relocalization.reset_counts()

        # (a) the steady stream
        sess = slam.open_stream("rgbd", CHUNK)
        warm = 1 + CHUNK
        sess.feed((images[:warm], depths[:warm]), ts[:warm])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.feed((images[warm:n_a], depths[warm:n_a]), ts[warm:n_a])
        sess.finish()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        fps = (n_a - warm) / dt
        _, est = slam.get_trajectory()
        require(len(est) == n_a and np.all(np.isfinite(est)), f"{label} (a): bad trajectory")
        ate = float(ate_rmse(est, seq.poses_gt[:n_a]))
        own = [T for _, T in slam.trajectory]      # the engine's estimate of each frame
        n_kf, n_pt = slam.n_keyframes(), slam.n_points()
        m = slam.map
        rows = (m.kf_bow_ids >= 0).sum(1)
        nodes_ok = bool(((m.kf_node >= 0) == m.kf_feat_valid)[m.kf_valid].all())
        words_ok = bool(((m.kf_word >= 0) == m.kf_feat_valid)[m.kf_valid].all())
        attempts, _ = relocalization.counts()
        print(f"[{label}] (a) {n_a} frames, vocabulary loaded, cell 16, mapping on, chunk "
              f"{CHUNK}: state {slam.state}, keyframes {n_kf}, points {n_pt}, ATE {ate:.6f} m; "
              f"{n_a - warm} frames in {dt:.3f} s = {fps:.2f} frames/s (host clock, synced); "
              f"BoW words per keyframe {int(rows[m.kf_valid].min())} to "
              f"{int(rows[m.kf_valid].max())}; mapping passes {len(pass_s)}, mean "
              f"{np.mean(pass_s) * 1e3:.1f} ms; relocalization attempts {attempts}")
        require(slam.state == STATE_OK, f"{label} (a): tracking lost")
        require(n_kf >= 2, f"{label} (a): only {n_kf} keyframes")
        require(ate < ATE_LIMIT_M, f"{label} (a): ATE {ate:.6f} m >= {ATE_LIMIT_M} m")
        require(int(rows[m.kf_valid].min()) > 0 and nodes_ok and words_ok,
                f"{label} (a): a keyframe lacks its BoW row, words or nodes")
        require(int(rows[~m.kf_valid].max()) == 0, f"{label} (a): BoW row in a free slot")
        require(len(pass_s) == n_kf - 1, f"{label} (a): {len(pass_s)} mapping passes, "
                f"want {n_kf - 1}")
        require(attempts == 0, f"{label} (a): {attempts} relocalization attempts in a "
                "steady stream")
        n_extract = 1 + (n_a - 1) // CHUNK
        counts_ok(n_extract, "(a)")
        launches_a = n_extract

        # (b) kidnapped and returned inside one batch
        imgs = np.stack([blank] * 3 + [seq.images[20]] * 3 + [seq.images[21]] * 2)
        deps = np.stack([no_depth] * 3 + [seq.depths[20]] * 3 + [seq.depths[21]] * 2)
        poses = slam.track_batch_rgbd(imgs, deps, np.arange(8) / 30.0 + 10.0, chunk=CHUNK)
        attempts_b, ok_b = relocalization.counts()
        d_b = float(np.linalg.norm(_centre(poses[-3]) - _centre(own[20])))
        print(f"[{label}] (b) batch of 3 blank + 5 mapped frames: state {slam.state}, "
              f"relocalization attempts {attempts_b}, successes {ok_b}, recovered centre "
              f"{d_b:.4f} m from the earlier estimate of frame 20")
        require(slam.state == STATE_OK, f"{label} (b): not recovered inside the batch")
        require(attempts_b >= 1 and ok_b >= 1, f"{label} (b): no relocalization success")
        require(d_b < 0.05, f"{label} (b): recovered {d_b:.4f} m away")
        n_extract += 2
        counts_ok(n_extract, "(b)")

        # (c) kidnapped and returned with per-frame calls
        for j in range(3):
            slam.track_rgbd(blank, no_depth, 20.0 + j)
            n_extract += 1
        require(slam.state == STATE_LOST, f"{label} (c): blank frames did not lose tracking")
        for j in range(3):
            T = slam.track_rgbd(seq.images[24], seq.depths[24], 21.0 + j)
            n_extract += 1
            if slam.state == STATE_OK:
                break
        attempts_c, ok_c = relocalization.counts()
        d_c = float(np.linalg.norm(_centre(T) - _centre(own[24])))
        print(f"[{label}] (c) per frame, 3 blank then frame 24: state {slam.state} after "
              f"{j + 1} tries, attempts {attempts_c - attempts_b}, successes {ok_c - ok_b}, "
              f"recovered centre {d_c:.4f} m from the earlier estimate")
        require(slam.state == STATE_OK, f"{label} (c): not recovered")
        require(ok_c - ok_b >= 1, f"{label} (c): no relocalization success")
        require(d_c < 0.05, f"{label} (c): recovered {d_c:.4f} m away")
        counts_ok(n_extract, "(c)")

        # one relocalization, timed (host clock, synced both sides)
        gen = torch.Generator(device="cuda").manual_seed(1)
        reloc_s = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = relocalization.relocalize(slam.config, slam.map, slam.carry.last_frame, gen)
            torch.cuda.synchronize()
            reloc_s.append(time.perf_counter() - t0)
            require(bool(r.success), f"{label}: the timed relocalization failed")
        reloc_ms = float(np.median(reloc_s)) * 1e3
        attempts_t, _ = relocalization.counts()
        print(f"[{label}] one relocalization of a mapped frame: {reloc_ms:.1f} ms (median of "
              f"3, host clock, synced both sides; {int(r.n_inliers)} inliers)")

        # (d) localization mode
        slam.activate_localization_mode()
        n_kf_d, n_pt_d, n_pass_d = slam.n_keyframes(), slam.n_points(), len(pass_s)
        worst = 0.0
        for i in range(25, n_a):
            T = slam.track_rgbd(seq.images[i], seq.depths[i], 30.0 + i / 30.0)
            n_extract += 1
            require(slam.state == STATE_OK, f"{label} (d): lost at frame {i}")
            worst = max(worst, float(np.linalg.norm(_centre(T) - _centre(own[i]))))
        attempts_d, ok_d = relocalization.counts()
        print(f"[{label}] (d) localization mode, frames 25 to {n_a - 1}: state {slam.state}, "
              f"keyframes added {slam.n_keyframes() - n_kf_d}, points added "
              f"{slam.n_points() - n_pt_d}, worst centre {worst:.4f} m from the estimates of "
              f"(a), relocalization attempts {attempts_d - attempts_t}")
        require(slam.n_keyframes() == n_kf_d and slam.n_points() == n_pt_d
                and len(pass_s) == n_pass_d, f"{label} (d): the map changed")
        require(worst < 0.05, f"{label} (d): {worst:.4f} m from the estimates of (a)")
        counts_ok(n_extract, "(d)")
        slam.deactivate_localization_mode()

    # (e) checkpoint round trip into a second System
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        slam.save_map(path)
        size = os.path.getsize(path)
        other = System(cfg, enable_mapping=True, enable_loop_closing=False)
        other.load_map(path)
    differing = [f for f, a, b in zip(slam.map._fields, slam.map, other.map)
                 if a.dtype != b.dtype or not torch.equal(a, b)]
    print(f"[{label}] (e) save_map ({size} bytes) and load_map into a second System: "
          f"{len(slam.map._fields) - len(differing)} of {len(slam.map._fields)} fields equal, "
          f"state {other.state}")
    require(not differing, f"{label} (e): fields differ after the round trip: {differing}")
    require(other.state == STATE_LOST and other.map.kf_Tcw.is_cuda,
            f"{label} (e): the loaded System is not LOST on the card")
    print(f"[{label}] counts: fast_band launches {n_extract} ({launches_a} in (a)), fast_nms 0; "
          f"mapping passes {len(pass_s)}; relocalization attempts {attempts_d}, "
          f"successes {ok_d} (the 3 timed calls included)")
    return n_extract, fps, ate, reloc_ms


def _u8(images) -> np.ndarray:
    return np.clip(images, 0, 255).astype(np.uint8)


def _sensor_config(sensor, width, height, fx, baseline, n_features, vocab, rect_maps=None,
                   **tracking):
    from self_commit_orb_slam2_tpu_torch.models.config import (
        Capacities, SlamConfig, TrackingConfig)
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig

    cam = CameraParams.create(fx=fx, fy=fx, cx=width / 2, cy=height / 2,
                              bf=fx * baseline, width=width, height=height)
    return SlamConfig(
        camera=cam, orb=OrbConfig(n_features=n_features),
        caps=Capacities(max_keyframes=64, max_points=16384, local_points=1024),
        tracking=TrackingConfig(**tracking), sensor=sensor, vocab=vocab, rect_maps=rect_maps)


# the stereo operating points (bench.py's --size=kitti and --size=euroc)
KITTI = dict(width=1241, height=376, fx=718.9, baseline=0.1, n_features=2000)
EUROC = dict(width=752, height=480, fx=458.7, baseline=0.11, n_features=1200)
N_KITTI, N_EUROC, N_EUROC_PER_FRAME, N_MONO = 25, 13, 4, 41


def phase_band_shapes(kitti, euroc, euroc_maps, band_row):
    """Kernel B1 at the stereo paths' slab shapes: the [left block; right
    block] of the first pair (16 slices) and of a chunk of 4 pairs (64), at
    both geometries; EuRoC's raw eyes rectified on the card first, as the
    path does.  Bitwise against the plain version, device time from a CUDA
    graph, the bound recounted from each slab."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import frame as frame_mod
    from self_commit_orb_slam2_tpu_torch.ops.orb import fast_band
    from self_commit_orb_slam2_tpu_torch.tools import time_fast

    band_row["shapes"] = []
    for name, seq, geo, maps in (("KITTI", kitti, KITTI, None), ("EuRoC", euroc, EUROC,
                                                                  euroc_maps)):
        cfg = _sensor_config("stereo", vocab=None, rect_maps=maps, **geo)
        for label, sl in (("first pair", slice(0, 1)), ("chunk", slice(1, 1 + CHUNK))):
            il = torch.from_numpy(_u8(seq.images[sl]).astype(np.float32)).cuda()
            ir = torch.from_numpy(_u8(seq.right_images[sl]).astype(np.float32)).cuda()
            both = torch.cat(frame_mod._rectify_pair(cfg, il, ir))
            slab, H0p, dims = time_fast.frames_slab(both, cfg.orb, band=True)
            args = (cfg.orb.fast_threshold_hi, cfg.orb.fast_threshold_lo, H0p, dims,
                    cfg.orb.border, cfg.orb.n_levels)
            G = slab.shape[0] // H0p
            shape = [G, H0p, slab.shape[1]]
            out_k = fast_band.fast_nms_bands_hi_lo(slab, *args)
            out_p = fast_band.fast_bands_plain(slab, *args)
            err = _check_kernel("fast_band", f"{name} {label} {shape}", out_k, out_p,
                                int((out_k[2] > 0).sum()))
            outs = fast_band.empty_outputs(slab)
            (bound_ms, bound_by, n_bytes, ops), _ = fast_band_bound_ms(slab, *args)
            ms = time_fast.graph_time_ms(lambda: fast_band.launch(slab, outs, *args))
            cold_ms = time_fast.cold_time_ms(lambda: fast_band.launch(slab, outs, *args))
            plain_ms = _event_time_ms(lambda: fast_band.fast_bands_plain(slab, *args), reps=2)
            print(f"[kernels] fast_band {name} {label} {shape}: kernel {ms:.4f} ms hot, "
                  f"{cold_ms:.4f} ms with the L2 flushed; plain {plain_ms:.3f} ms; bound "
                  f"{bound_ms:.4f} ms ({bound_by}: {n_bytes:.0f} bytes, {ops} fp32 operations): "
                  f"{ms / bound_ms:.2f} x its bound; 16-byte loads "
                  f"{'on' if slab.shape[1] % 4 == 0 else 'off (odd width)'}")
            band_row["shapes"].append(dict(
                path=f"4 {name} {label}", shape=shape, max_abs_err=err, ms=ms, cold_ms=cold_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by))
            del out_k, out_p, outs, slab, both
    torch.cuda.empty_cache()


def phase_stereo_matcher(kitti):
    """match_stereo on the card against the CPU on the first KITTI-geometry
    pair; depth share and depth error against the rendered depth map; ms per
    chunk of 4 pairs."""
    import torch

    from self_commit_orb_slam2_tpu_torch.ops.matching import stereo
    from self_commit_orb_slam2_tpu_torch.ops.orb import extractor, pyramid

    cfg = _sensor_config("stereo", vocab=None, **KITTI)
    cam, orb = cfg.camera, cfg.orb
    dims = pyramid.level_shapes(cam.height, cam.width, orb.n_levels, orb.scale_factor)
    scales = torch.from_numpy(orb.scale_factors()).cuda()

    def inputs(sl):
        il = torch.from_numpy(_u8(kitti.images[sl]).astype(np.float32)).cuda()
        ir = torch.from_numpy(_u8(kitti.right_images[sl]).astype(np.float32)).cuda()
        B = il.shape[0]
        feats, slabs = extractor.extract_batch(torch.cat([il, ir]), orb)
        return ([getattr(feats, f)[:B] for f in ("xy", "level", "desc", "valid")]
                + [getattr(feats, f)[B:] for f in ("xy", "level", "desc", "valid")]
                + [slabs[:B], slabs[B:]])

    args = inputs(slice(0, 1))
    on_card = stereo.match_stereo(*args, cam.bf, cam.baseline, scales, dims)
    on_cpu = stereo.match_stereo(*(a.cpu() for a in args), cam.bf, cam.baseline,
                                 scales.cpu(), dims)
    torch.cuda.synchronize()
    v_c, v_h = on_card.valid[0].cpu(), on_cpu.valid[0]
    agree = float((v_c == v_h).float().mean())
    both = v_c & v_h
    du = float((on_card.u_right[0].cpu() - on_cpu.u_right[0])[both].abs().max())
    xy, n_kp = args[0][0].cpu(), int(args[3][0].sum())
    share = int(v_c.sum()) / n_kp
    gt = torch.from_numpy(kitti.depths[0])[xy[:, 1].long().clamp(0, cam.height - 1),
                                           xy[:, 0].long().clamp(0, cam.width - 1)]
    seen = v_c & (gt > 0)
    rel = float(((on_card.depth[0].cpu() - gt).abs() / gt)[seen].median())
    print(f"[stereo] first pair {cam.width}x{cam.height}: {n_kp} left keypoints, "
          f"{int(v_c.sum())} with a depth (share {share:.3f}); card vs CPU: valid equal on "
          f"{agree:.4f} of rows, max |u_right difference| {du:.5f} px where both are valid; "
          f"median relative depth error against the rendered depth map {rel:.5f}")
    require(agree >= 0.995, f"stereo: valid equal on only {agree:.4f} of rows")
    require(du <= 0.02, f"stereo: u_right differs by {du} px between card and CPU")
    require(share > 0.25, f"stereo: only {share:.3f} of the keypoints got a depth")
    require(rel < 0.02, f"stereo: median relative depth error {rel:.4f} >= 0.02")
    chunk_args = inputs(slice(1, 1 + CHUNK))
    torch.cuda.reset_peak_memory_stats()
    ms = _event_time_ms(lambda: stereo.match_stereo(*chunk_args, cam.bf, cam.baseline,
                                                    scales, dims))
    print(f"[stereo] match_stereo on a chunk of {CHUNK} pairs, {chunk_args[0].shape[1]} "
          f"keypoint rows each: {ms:.3f} ms per call = {ms / CHUNK:.3f} ms per frame (CUDA "
          f"events, after a warm-up); peak device memory during it "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return ms, share


def phase_path_stereo(label, seq, cfg, n_stream, ate_limit, kernels):
    """One stereo System: the first n_stream pairs streamed in chunks, the
    rest one by one through track_stereo."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import pipeline, relocalization
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse

    n = len(seq.images)
    slam = System(cfg, enable_mapping=True, enable_loop_closing=False)
    require(slam.config.vocab.child_desc.is_cuda, f"{label}: the vocabulary is not on the card")
    if cfg.rect_maps is not None:
        require(all(m.is_cuda for m in slam.config.rect_maps),
                f"{label}: the rectification maps are not on the card")
    il, ir, ts = _u8(seq.images), _u8(seq.right_images), seq.timestamps
    with pipeline.timed_mapping_passes() as pass_s:
        for k in kernels.values():
            k.launches = 0
        relocalization.reset_counts()
        sess = slam.open_stream("stereo", CHUNK)
        warm = 1 + CHUNK
        sess.feed((il[:warm], ir[:warm]), ts[:warm])
        torch.cuda.synchronize()
        n_warm_passes = len(pass_s)
        t0 = time.perf_counter()
        sess.feed((il[warm:n_stream], ir[warm:n_stream]), ts[warm:n_stream])
        sess.finish()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        map_s = sum(pass_s[n_warm_passes:])
        per_frame_s = []
        for i in range(n_stream, n):
            t0 = time.perf_counter()
            slam.track_stereo(il[i], ir[i], float(ts[i]))
            torch.cuda.synchronize()
            per_frame_s.append(time.perf_counter() - t0)
            require(slam.state == STATE_OK, f"{label}: lost at per-frame pair {i}")
        launches = {k.name: k.launches for k in kernels.values()}
        attempts, _ = relocalization.counts()
    fps = (n_stream - warm) / dt
    _, est = slam.get_trajectory()
    require(len(est) == n and np.all(np.isfinite(est)), f"{label}: bad trajectory")
    ate = float(ate_rmse(est, seq.poses_gt[:n]))
    n_kf, n_pt = slam.n_keyframes(), slam.n_points()
    last = slam.carry.last_frame
    share = float(last.has_depth().sum() / last.valid.sum())
    cam = cfg.camera
    print(f"[{label}] {n} pairs {cam.width}x{cam.height}, {cfg.orb.n_features} features "
          f"(capacity {cfg.orb.feat_capacity()}), rectified on the card: "
          f"{cfg.rect_maps is not None}; vocabulary loaded, mapping on, chunk {CHUNK}: state "
          f"{slam.state}, keyframes {n_kf}, points {n_pt}, ATE {ate:.6f} m, depth on "
          f"{share:.3f} of the last frame's keypoints, relocalization attempts {attempts}")
    print(f"[{label}] steady stream: {n_stream - warm} pairs in {dt:.3f} s = {fps:.2f} "
          f"frames/s (host clock, synced), of which mapping {map_s:.3f} s; mapping passes "
          f"{len(pass_s)}, mean {np.mean(pass_s) * 1e3:.1f} ms per pass"
          + (f"; track_stereo per pair: {np.mean(per_frame_s) * 1e3:.1f} ms mean over "
             f"{len(per_frame_s)} (host clock, synced)" if per_frame_s else ""))
    print(f"[{label}] launches during the run: {launches}")
    require(slam.state == STATE_OK, f"{label}: tracking lost (state {slam.state})")
    require(n_kf >= 2, f"{label}: only {n_kf} keyframes")
    require(ate < ate_limit, f"{label}: ATE {ate:.6f} m >= {ate_limit} m")
    require(attempts == 0, f"{label}: {attempts} relocalization attempts in a steady run")
    require(len(pass_s) == n_kf - 1, f"{label}: {len(pass_s)} mapping passes, want {n_kf - 1}")
    want = 1 + -(-(n_stream - 1) // CHUNK) + (n - n_stream)
    require(launches == {"fast_band": want, "fast_nms": 0},
            f"{label}: launches {launches}, want fast_band {want}, fast_nms 0")
    return want, fps, ate, float(np.mean(pass_s) * 1e3)


def phase_two_view():
    """initialize_two_view on the card against the CPU on one synthetic
    correspondence set (a general scene, 0.3 px of noise, 10% outliers) with
    the same minimal sets; its batched eigh / svd shapes timed."""
    import torch

    from self_commit_orb_slam2_tpu_torch.ops import se3
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
    from self_commit_orb_slam2_tpu_torch.ops.solvers import two_view

    n = 2048
    rng = np.random.default_rng(0)
    cam = CameraParams.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, width=WIDTH,
                              height=HEIGHT)
    pts = rng.uniform(-2, 2, (n, 3))
    pts[:, 2] += 5.0 + rng.uniform(0, 3, n)
    T2 = se3.se3_exp(torch.tensor([0.5, 0.05, 0.1, 0.02, -0.04, 0.01])).double().numpy()

    def project(T):
        pc = pts @ T[:3, :3].T + T[:3, 3]
        return np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                         cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)

    uv1 = torch.from_numpy((project(np.eye(4)) + rng.normal(0, 0.3, (n, 2))).astype(np.float32))
    uv2 = project(T2) + rng.normal(0, 0.3, (n, 2))
    bad = rng.choice(n, n // 10, replace=False)
    uv2[bad] = rng.uniform(0, WIDTH, (len(bad), 2))
    uv2 = torch.from_numpy(uv2.astype(np.float32))
    valid = torch.ones(n, dtype=torch.bool)
    sets = two_view._sample_minimal_sets(valid, 256, torch.Generator().manual_seed(0))
    on_cpu = two_view.initialize_two_view(cam, uv1, uv2, valid, sets=sets)
    card = lambda: two_view.initialize_two_view(  # noqa: E731
        cam, uv1.cuda(), uv2.cuda(), valid.cuda(), sets=sets.cuda())
    on_card = card()
    torch.cuda.synchronize()
    n_c, n_h = int(on_card.n_good), int(on_cpu.n_good)
    dT = float((on_card.Tcw2.cpu() - on_cpu.Tcw2).abs().max())
    print(f"[two-view] {n} correspondences, 256 hypotheses: card success "
          f"{bool(on_card.success)}, homography {bool(on_card.used_homography)}, n_good {n_c}; "
          f"CPU success {bool(on_cpu.success)}, homography {bool(on_cpu.used_homography)}, "
          f"n_good {n_h}; max |Tcw2 difference| {dT:.2e}")
    require(bool(on_card.success) and bool(on_cpu.success), "two-view: did not initialize")
    require(bool(on_card.used_homography) == bool(on_cpu.used_homography),
            "two-view: the card and the CPU chose different models")
    require(abs(n_c - n_h) <= 0.02 * n_h, f"two-view: n_good {n_c} on the card, {n_h} on the CPU")
    require(dT <= 1e-3, f"two-view: poses differ by {dT}")
    ms = _event_time_ms(card, reps=3)
    g = torch.Generator(device="cuda").manual_seed(0)

    def sym(*shape):
        a = torch.randn(*shape, device="cuda", generator=g)
        return a @ a.transpose(-1, -2)

    a9, a4, a3 = sym(256, 9, 9), sym(8 * n, 4, 4), torch.randn(256, 3, 3, device="cuda",
                                                                generator=g)
    t9 = _event_time_ms(lambda: torch.linalg.eigh(a9))
    t4 = _event_time_ms(lambda: torch.linalg.eigh(a4))
    t3 = _event_time_ms(lambda: torch.linalg.svd(a3))
    print(f"[two-view] initialize_two_view on the card {ms:.1f} ms per call (CUDA events; host-"
          f"bound); library {torch.backends.cuda.preferred_linalg_library()}: eigh [256, 9, 9] "
          f"{t9:.3f} ms (H and F hypotheses), eigh [{8 * n}, 4, 4] {t4:.3f} ms (triangulation "
          f"under the 8 motions of H), svd [256, 3, 3] {t3:.3f} ms (rank-2 projection)")
    return ms


def phase_path5(seq, kernels, vocab):
    """Mono: the RGB-D sequence's images through track_batch_mono, in two
    calls: the first bootstraps on the per-frame path (doubled feature
    budget) and streams the rest of its 9 frames, the second streams 32."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import mono_init, pipeline, relocalization
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse

    label, first = "path 5", 1 + 2 * CHUNK
    cfg = _sensor_config("mono", WIDTH, HEIGHT, FX, 0.0, N_FEATURES, vocab,
                         max_frames_between_kf=8, kf_ref_ratio_stereo=0.8)
    slam = System(cfg, enable_mapping=True, enable_loop_closing=False)
    images, ts = _u8(seq.images[:N_MONO]), seq.timestamps[:N_MONO]
    attempt_s = []
    inner = mono_init.try_initialize

    def timed_try(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inner(*args, **kw)
        torch.cuda.synchronize()
        attempt_s.append(time.perf_counter() - t0)
        return res

    mono_init.try_initialize = timed_try
    try:
        with pipeline.timed_mapping_passes() as pass_s:
            for k in kernels.values():
                k.launches = 0
            relocalization.reset_counts()
            slam.track_batch_mono(images[:first], ts[:first], chunk=CHUNK)
            torch.cuda.synchronize()
            require(slam.state == STATE_OK, f"{label}: no map after {first} frames")
            t0 = time.perf_counter()
            slam.track_batch_mono(images[first:], ts[first:], chunk=CHUNK)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k.name: k.launches for k in kernels.values()}
            attempts, _ = relocalization.counts()
    finally:
        mono_init.try_initialize = inner
    fps = (N_MONO - first) / dt
    _, est = slam.get_trajectory()
    lag = N_MONO - len(est)
    require(np.all(np.isfinite(est)), f"{label}: non-finite poses")
    ate = float(ate_rmse(est, seq.poses_gt[lag:N_MONO], with_scale=True))
    n_kf, n_pt = slam.n_keyframes(), slam.n_points()
    print(f"[{label}] {N_MONO} frames {WIDTH}x{HEIGHT} mono, {N_FEATURES} features ("
          f"{slam._ini_config.orb.n_features} while bootstrapping), vocabulary loaded, mapping "
          f"on, chunk {CHUNK}: initialized after {lag + 1} frames ({len(attempt_s)} attempts, "
          f"{np.mean(attempt_s) * 1e3:.1f} ms per attempt, host clock, synced), state "
          f"{slam.state}, keyframes {n_kf}, points {n_pt}, Sim3-aligned ATE {ate:.6f} m, "
          f"relocalization attempts {attempts}")
    print(f"[{label}] steady stream: {N_MONO - first} frames in {dt:.3f} s = {fps:.2f} frames/s "
          f"(host clock, synced); mapping passes {len(pass_s)}, mean "
          f"{np.mean(pass_s) * 1e3:.1f} ms; launches {launches}")
    require(lag <= 6, f"{label}: the map took {lag + 1} frames to initialize")
    require(slam.state == STATE_OK, f"{label}: tracking lost")
    require(n_kf >= 3, f"{label}: only {n_kf} keyframes")
    require(ate < 0.06, f"{label}: Sim3-aligned ATE {ate:.6f} m >= 0.06 m")
    require(slam.map.kf_xy.shape[1] == cfg.orb.feat_capacity(),
            f"{label}: map rows carry the bootstrap capacity")
    n_boot = lag + 1    # frames the bootstrap consumed, one extraction each
    want = n_boot + -(-(first - n_boot) // CHUNK) + (N_MONO - first) // CHUNK
    require(launches == {"fast_band": want, "fast_nms": 0},
            f"{label}: launches {launches}, want fast_band {want}, fast_nms 0")
    return want, fps, ate, float(np.mean(attempt_s) * 1e3), lag + 1


# path 6: a circle revolution of 120 frames, 184 streamed (the JAX package
# closes its first loop at frame 153 to 157 of this scenario on the CPU,
# scripts/jax_loop_scenario.py), drift from
# frame 9 to 120 (bench.py's twist per frame, composed over each chunk)
LOOP_REV, N_LOOP, DRIFT_FROM, DRIFT_TO = 120, 184, 9, 120
DRIFT_TWIST = [0.0011, 0.00028, -0.00055, 0.0, 0.0009, 0.0]   # bench.py:451-452
TEAR_TWIST = [0.15, 0.03, -0.05, 0.0, 0.14, 0.0]              # per-frame closure
N_PER_FRAME_MAX = 40


def _to(m, device):
    return type(m)(*(x.to(device) for x in m))


def phase_path6(seq6, kernels, vocab):
    """The default operating point with loop closing on, streamed; then one
    per-frame closure; then the loop stages on the card against the CPU."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import loop_closing, pipeline, relocalization
    from self_commit_orb_slam2_tpu_torch.models.system import (
        STATE_NOT_INITIALIZED, STATE_OK, System)
    from self_commit_orb_slam2_tpu_torch.ops.orb import fast_band
    from self_commit_orb_slam2_tpu_torch.tools.time_fast import frames_slab
    from self_commit_orb_slam2_tpu_torch.utils.drift import (
        displace_old_content, make_injector, se3_increment)
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse

    label = "path 6"
    cfg = _bench_config(vocab)
    slam = System(cfg)
    lc = slam._loop_closer
    require(lc is not None and lc.enabled and cfg.tracking.enable_loop_gba
            and cfg.tracking.loop_consistency_th == 3, f"{label}: System(cfg) built no closer")
    images, depths = _u8(seq6.images), np.clip(seq6.depths * 1e3, 0, 65535).astype(np.uint16)
    ts = seq6.timestamps
    inject = make_injector(keep_recent=6)
    dD = torch.linalg.matrix_power(se3_increment(DRIFT_TWIST).double(), CHUNK).float().cuda()
    # B1 on this path's own first frame and its chunk at the closure, bitwise
    orb = cfg.orb
    for what, frames in (("first frame", images[:1]), ("chunk at frame 113", images[113:117])):
        slab, H0p, dims = frames_slab(frames, orb, band=True)
        args = (orb.fast_threshold_hi, orb.fast_threshold_lo, H0p, dims, orb.border, orb.n_levels)
        out_k = fast_band.fast_nms_bands_hi_lo(slab, *args)
        _check_kernel("fast_band", f"{label} {what}", out_k,
                      fast_band.fast_bands_plain(slab, *args), int((out_k[2] > 0).sum()))

    # the first correction's inputs and its pose graph's, for the card / CPU check
    captured = {}
    orig_correct, orig_graph = loop_closing.correct_loop, loop_closing.optimize_pose_graph

    def spy_correct(config, m, kf_id, det):
        captured.setdefault("correct", (_to(m, "cpu"), kf_id.cpu(), _to(det, "cpu")))
        return orig_correct(config, m, kf_id, det)

    def spy_graph(*args, **kw):
        captured.setdefault("graph", ([a.cpu() for a in args], kw))
        return orig_graph(*args, **kw)

    loop_closing.correct_loop, loop_closing.optimize_pose_graph = spy_correct, spy_graph
    try:
        with loop_closing.timed_phases() as ph, pipeline.timed_mapping_passes() as pass_s:
            for k in kernels.values():
                k.launches = 0
            relocalization.reset_counts()
            sess = slam.open_stream("rgbd", CHUNK)
            t_start = time.perf_counter()
            sess.feed((images[:1 + CHUNK], depths[:1 + CHUNK]), ts[:1 + CHUNK])
            torch.cuda.synchronize()
            done, chunk_ms, events = 1 + CHUNK, [], []
            while done < N_LOOP:
                t0 = time.perf_counter()
                sl = slice(done, min(done + CHUNK, N_LOOP))
                sess.feed((images[sl], depths[sl]), ts[sl])
                done = sl.stop
                if DRIFT_FROM <= done <= DRIFT_TO:
                    slam.map = inject(slam.map, dD, 1.0)
                sess.poll()
                torch.cuda.synchronize()
                chunk_ms.append((time.perf_counter() - t0) * 1e3)
                if lc.n_big_changes > len(events):
                    events.append((len(chunk_ms) - 1, done, {k: len(v) for k, v in ph.items()}))
            t0 = time.perf_counter()
            sess.finish()
            torch.cuda.synchronize()
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
            stream_s = time.perf_counter() - t_start
            launches = {k.name: k.launches for k in kernels.values()}
            attempts, _ = relocalization.counts()
            n_stream_closures = lc.n_big_changes
            gba_info = dict(lc.last_gba_info)
            stream_ph = {k: list(v) for k, v in ph.items()}
            changed = [slam.map_changed(), slam.map_changed()]
            _, est = slam.get_trajectory()
            raw = np.stack([T for _, T in slam.trajectory])
            gt = seq6.poses_gt[:N_LOOP]
            require(len(est) == N_LOOP and np.all(np.isfinite(est)), f"{label}: bad trajectory")
            ate, ate_raw = float(ate_rmse(est, gt)), float(ate_rmse(raw, gt))
            n_kf, n_pt, n_live = slam.n_keyframes(), slam.n_points(), int(slam.map.kf_valid.sum())

            # one per-frame closure: the whole map torn rigidly, the tracker
            # re-initialized on it at the revolution's first frame (a second
            # branch with no shared observation, the construction of the loop
            # tests), then its next frames per frame until the closer joins the
            # branches
            slam.map = displace_old_content(slam.map, se3_increment(TEAR_TWIST).cuda(), 1.0,
                                            keep_recent=-1)
            slam.carry, slam.state = None, STATE_NOT_INITIALIZED
            per_frame_s = []
            for j in range(N_PER_FRAME_MAX):
                t0 = time.perf_counter()
                slam.track_rgbd(seq6.images[j], seq6.depths[j], float(N_LOOP + j) / 30.0)
                torch.cuda.synchronize()
                per_frame_s.append(time.perf_counter() - t0)
                require(slam.state == STATE_OK, f"{label}: lost at per-frame frame {j}")
                if lc.n_big_changes > n_stream_closures:
                    break
            launches_all = {k.name: k.launches for k in kernels.values()}
            attempts_all, _ = relocalization.counts()
    finally:
        loop_closing.correct_loop, loop_closing.optimize_pose_graph = orig_correct, orig_graph

    n_timed = N_LOOP - 1 - CHUNK
    fps = N_LOOP / stream_s
    med = float(np.median(chunk_ms[4:]))
    print(f"[{label}] {N_LOOP} frames {WIDTH}x{HEIGHT} of a {LOOP_REV}-frame circle revolution, "
          f"System(cfg) defaults (loop closing, global BA, consistency 3), chunk {CHUNK}, drift "
          f"frames {DRIFT_FROM} to {DRIFT_TO}: state {slam.state}, keyframes {n_kf} ({n_live} live "
          f"of {cfg.caps.max_keyframes}), points {n_pt}, closures {n_stream_closures}, map_changed "
          f"{changed}, last GBA {gba_info}; ATE corrected {ate:.6f} m, raw per-frame "
          f"{ate_raw:.6f} m; relocalization attempts {attempts}; launches {launches}")
    print(f"[{label}] stream {stream_s:.3f} s = {fps:.2f} frames/s (host clock, synced per chunk); "
          f"median chunk {med:.1f} ms; mapping passes {len(pass_s)}, mean "
          f"{np.mean(pass_s) * 1e3:.1f} ms; {n_timed} frames after the first chunk")
    for name, v in stream_ph.items():
        print(f"[{label}] {name}: {len(v)} calls, mean {np.mean(v):.1f} ms, max "
              f"{np.max(v):.1f} ms, all {[round(x, 1) for x in v]} (host clock, synced)")
    for c, frame, before in events:
        w = np.asarray(chunk_ms[max(c - 1, 0): c + 3])
        print(f"[{label}] closure landed in chunk {c} (frame {frame}): stall "
              f"{w.max() - med:.1f} ms over the median chunk (worst chunk of the 4 around it, "
              f"bench.py's measure); phase calls before it {before}")
    n_pf = len(per_frame_s)
    pf_ph = {k: [round(x, 1) for x in v[len(stream_ph.get(k, [])):]] for k, v in ph.items()}
    print(f"[{label}] per frame after a tear and a re-initialization: closure "
          f"{lc.n_big_changes > n_stream_closures} after {n_pf} track_rgbd calls, "
          f"{np.mean(per_frame_s) * 1e3:.1f} ms per call, the closing call "
          f"{per_frame_s[-1] * 1e3:.1f} ms (detection, correction and the whole GBA synchronous; "
          f"phases {pf_ph} ms, host clock, synced); state {slam.state}")
    require(slam.state == STATE_OK, f"{label}: tracking lost")
    require(n_stream_closures >= 1, f"{label}: no loop closed in the stream")
    require(changed == [True, False], f"{label}: map_changed() gave {changed}")
    require(gba_info.get("gba_path") == "dense", f"{label}: no global BA merged")
    require(ate < ate_raw, f"{label}: corrected ATE {ate:.6f} m not below raw {ate_raw:.6f} m")
    require(attempts_all == 0, f"{label}: {attempts_all} relocalization attempts")
    want = 1 + -(-(N_LOOP - 1) // CHUNK)
    require(launches == {"fast_band": want, "fast_nms": 0},
            f"{label}: launches {launches}, want fast_band {want}, fast_nms 0")
    require(launches_all == {"fast_band": want + n_pf, "fast_nms": 0},
            f"{label}: launches with the per-frame part {launches_all}, want {want + n_pf}")
    require(lc.n_big_changes > n_stream_closures, f"{label}: no per-frame closure in "
            f"{N_PER_FRAME_MAX} frames")
    require("correct" in captured and "graph" in captured, f"{label}: no correction captured")
    stages = phase_loop_stages(cfg, captured)
    return want, fps, ate, ate_raw, n_stream_closures, stream_ph, stages


def _count_syncs(fn):
    """fn() with the card's sync debug mode on: (result, Counter of the
    Python lines whose op made the host wait for the device)."""
    import collections
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))


def phase_loop_stages(cfg, captured):
    """The first closure's detection, correction and pose graph, from its
    captured inputs, on the card and on the CPU: the same minimal sets (drawn
    once on the CPU), the same candidate and found; poses within 1e-3 (the
    parity tests' bound), points within 2e-3 m + 1e-3 relative, observations
    equal on >= 99.9%."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import loop_closing
    from self_commit_orb_slam2_tpu_torch.ops.optim.pose_graph import optimize_pose_graph

    label = "path 6 stages"
    m, kf, det0 = captured["correct"]
    slots, active, _ = loop_closing.loop_candidates(cfg, m, kf)
    sets = loop_closing.draw_hypotheses(loop_closing.bow_matches(m, kf, slots, active).valid,
                                        torch.Generator().manual_seed(0))
    m_c, kf_c = _to(m, "cuda"), kf.cuda()
    t0 = time.perf_counter()
    d_cpu = loop_closing.detect_and_verify(cfg, m, kf, sets=sets)
    cpu_detect_ms = (time.perf_counter() - t0) * 1e3
    d_card, det_syncs = _count_syncs(
        lambda: loop_closing.detect_and_verify(cfg, m_c, kf_c, sets=sets.cuda()))
    torch.cuda.synchronize()
    dS = float((d_card.S_cur_cand.cpu() - d_cpu.S_cur_cand).abs().max())
    print(f"[{label}] detect_and_verify from the first closure's state (keyframe {int(kf)}): card "
          f"found {bool(d_card.found)} cand {int(d_card.cand_kf)} inliers {int(d_card.n_inliers)} "
          f"proj {int(d_card.n_proj)}; CPU found {bool(d_cpu.found)} cand {int(d_cpu.cand_kf)} "
          f"inliers {int(d_cpu.n_inliers)} proj {int(d_cpu.n_proj)} ({cpu_detect_ms:.0f} ms); "
          f"stream's own draws: found {bool(det0.found)} cand {int(det0.cand_kf)}; "
          f"max |S difference| {dS:.2e}")
    require(bool(d_card.found) == bool(d_cpu.found) and int(d_card.cand_kf) == int(d_cpu.cand_kf),
            f"{label}: detection differs between card and CPU")
    require(abs(int(d_card.n_inliers) - int(d_cpu.n_inliers)) <= 2
            and abs(int(d_card.n_proj) - int(d_cpu.n_proj)) <= 3 and dS <= 2e-3,
            f"{label}: detection counts or Sim3 differ between card and CPU")

    ref = loop_closing.correct_loop(cfg, m, kf, det0)
    det_c = _to(det0, "cuda")
    got, corr_syncs = _count_syncs(lambda: loop_closing.correct_loop(cfg, m_c, kf_c, det_c))
    torch.cuda.synchronize()
    dT = float((got.kf_Tcw.cpu() - ref.kf_Tcw).abs().max())
    dp = (got.pt_pos.cpu() - ref.pt_pos).abs()
    p_ok = bool((dp <= 2e-3 + 1e-3 * ref.pt_pos.abs()).all())
    obs = float((got.kf_obs_pt.cpu() == ref.kf_obs_pt).float().mean())
    print(f"[{label}] correct_loop card vs CPU: max |pose difference| {dT:.2e}, max |point "
          f"difference| {float(dp.max()):.2e} m, observations equal on {obs:.5f}")
    print(f"[{label}] host syncs (cuda sync debug mode): detect_and_verify "
          f"{sum(det_syncs.values())} {dict(det_syncs)}; correct_loop "
          f"{sum(corr_syncs.values())} {dict(corr_syncs)}")
    require(dT <= 1e-3 and p_ok and obs >= 0.999, f"{label}: correct_loop differs")

    args, kw = captured["graph"]
    ref_g = optimize_pose_graph(*args, **kw)
    t_ms = _event_time_ms(lambda: optimize_pose_graph(*(a.cuda() for a in args), **kw), reps=2)
    t0 = time.perf_counter()
    got_g = optimize_pose_graph(*(a.cuda() for a in args), **kw)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    dG = float((got_g.kf_sim3.cpu() - ref_g.kf_sim3).abs().max())
    K = args[0].shape[0]
    print(f"[{label}] optimize_pose_graph [{7 * K} x {7 * K}], {args[1].shape[0]} edges "
          f"({int(args[4].sum())} live), 20 iterations: card vs CPU max |Sim3 difference| "
          f"{dG:.2e}, mean residual {float(got_g.mean_residual):.3e} / "
          f"{float(ref_g.mean_residual):.3e}; {t_ms:.1f} ms per call on the card (CUDA events), "
          f"{host_ms:.1f} ms (host clock, synced)")
    require(dG <= 1e-3, f"{label}: optimize_pose_graph differs by {dG}")
    return dict(pose_graph_ms=t_ms, d_pose_graph=dG, d_correct=dT,
                syncs=(sum(det_syncs.values()), sum(corr_syncs.values())))


# ---------------------------------------------------------------- path 7
# The drivers on the card: run_slam on each dataset layout written to disk,
# stream_slam.serve over a pipe, and warm_start.  Frames come from the paths
# above (no real frames are in the repository); PNGs are written with the
# standard library (utils/viewer.save_png) and read back by the native decoder.
N_TUM, N_TUM_PER_FRAME, N_KITTI7, N_EUROC7, N_SERVE, N_WARM = 41, 13, 17, 9, 20, 25
TUM_DEPTH_FACTOR = 5000.0


def _installations():
    """Step 0: what the host offers the drivers; the native decoder is required."""
    import importlib.util
    import shutil

    from self_commit_orb_slam2_tpu_torch.utils import native_io

    have = {m: importlib.util.find_spec(m) is not None for m in ("PIL", "yaml")}
    have["g++"] = shutil.which("g++") is not None
    ok = native_io.available()
    print(f"[path 7] installations: PIL {have['PIL']}, PyYAML {have['yaml']}, g++ {have['g++']}, "
          f"zlib.h and libz {'found (the native decoder built)' if ok else 'not usable'}; "
          f"native decoder {native_io.library_path or native_io.build_error}")
    require(have["yaml"], "path 7: PyYAML is missing, so load_settings cannot read a settings file")
    require(ok, f"path 7: the native decoder did not build: {native_io.build_error}")


def _yaml_matrix(name, M):
    M = np.atleast_2d(np.asarray(M, np.float64))
    data = ", ".join(f"{v:.17e}" for v in M.reshape(-1))   # YAML 1.1 floats
    return (f"{name}: !!opencv-matrix\n   rows: {M.shape[0]}\n   cols: {M.shape[1]}\n"
            f"   dt: d\n   data: [{data}]\n")


def _settings(path, width, height, fx, baseline, n_features, fps, depth_factor=None,
              rect=None):
    """A reference-style OpenCV-YAML settings file (TUM1.yaml, EuRoC.yaml)."""
    lines = ["%YAML:1.0", f"Camera.fx: {fx}", f"Camera.fy: {fx}", f"Camera.cx: {width / 2}",
             f"Camera.cy: {height / 2}", "Camera.k1: 0.0", "Camera.k2: 0.0", "Camera.p1: 0.0",
             "Camera.p2: 0.0", f"Camera.width: {width}", f"Camera.height: {height}",
             f"Camera.fps: {fps}", f"Camera.bf: {fx * baseline}", "ThDepth: 35.0",
             f"ORBextractor.nFeatures: {n_features}", "ORBextractor.scaleFactor: 1.2",
             "ORBextractor.nLevels: 8", "ORBextractor.iniThFAST: 20",
             "ORBextractor.minThFAST: 7"]
    if depth_factor:
        lines.append(f"DepthMapFactor: {depth_factor}")
    text = "\n".join(lines) + "\n"
    if rect is not None:
        for eye, (K, D, R, P) in rect.items():
            text += f"{eye}.height: {height}\n{eye}.width: {width}\n"
            for key, M in (("D", D), ("K", K), ("R", R), ("P", P)):
                text += _yaml_matrix(f"{eye}.{key}", M)
    with open(path, "w") as f:
        f.write(text)
    return path


def _write_tum(root, seq, n):
    """TUM RGB-D layout: rgb/ (8-bit gray), depth/ (16-bit, DepthMapFactor
    5000), rgb.txt and depth.txt."""
    from self_commit_orb_slam2_tpu_torch.utils.viewer import save_png

    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rows = []
    for i in range(n):
        name = f"{seq.timestamps[i]:.6f}.png"
        save_png(os.path.join(root, "rgb", name), _u8(seq.images[i]))
        save_png(os.path.join(root, "depth", name), np.clip(
            np.round(seq.depths[i] * TUM_DEPTH_FACTOR), 0, 65535).astype(np.uint16))
        rows.append((seq.timestamps[i], name))
    for sub in ("rgb", "depth"):
        with open(os.path.join(root, f"{sub}.txt"), "w") as f:
            f.write(f"# {sub} maps\n# timestamp filename\n")
            f.writelines(f"{t:.6f} {sub}/{name}\n" for t, name in rows)
    return root


def _write_kitti(root, seq, n, fx, baseline):
    """KITTI odometry layout: image_0/, image_1/, times.txt, calib.txt."""
    from self_commit_orb_slam2_tpu_torch.utils.viewer import save_png

    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    h, w = seq.images.shape[1:]
    for i in range(n):
        save_png(os.path.join(root, "image_0", f"{i:06d}.png"), _u8(seq.images[i]))
        save_png(os.path.join(root, "image_1", f"{i:06d}.png"), _u8(seq.right_images[i]))
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.writelines(f"{t:.6e}\n" for t in seq.timestamps[:n])
    P0 = np.array([[fx, 0, w / 2, 0], [0, fx, h / 2, 0], [0, 0, 1, 0]])
    P1 = P0.copy()
    P1[0, 3] = -fx * baseline
    with open(os.path.join(root, "calib.txt"), "w") as f:
        for k, P in (("P0", P0), ("P1", P1), ("P2", P0), ("P3", P1)):
            f.write(f"{k}: " + " ".join(f"{v:.12e}" for v in P.reshape(-1)) + "\n")
    return root


def _write_euroc(root, seq, n):
    """EuRoC MAV layout: mav0/cam{0,1}/data/<ns>.png and data.csv."""
    from self_commit_orb_slam2_tpu_torch.utils.viewer import save_png

    for cam, imgs in (("cam0", seq.images), ("cam1", seq.right_images)):
        d = os.path.join(root, "mav0", cam, "data")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for i in range(n):
                ns = int(round(seq.timestamps[i] * 1e9))
                save_png(os.path.join(d, f"{ns}.png"), _u8(imgs[i]))
                f.write(f"{ns},{ns}.png\n")
    return root


def _euroc_rect_blocks(geo):
    """The LEFT.* / RIGHT.* blocks that describe euroc_like_sequence's raw
    eyes (its default mounting rotations, zero distortion)."""
    import inspect

    from self_commit_orb_slam2_tpu_torch.utils import synthetic

    defaults = inspect.signature(synthetic.euroc_like_sequence).parameters
    K = np.array([[geo["fx"], 0, geo["width"] / 2], [0, geo["fx"], geo["height"] / 2], [0, 0, 1]])
    P = np.concatenate([K, np.zeros((3, 1))], axis=1)
    return {eye: (K, np.zeros((1, 5)), synthetic._rotvec(defaults[arg].default).T, P)
            for eye, arg in (("LEFT", "rot_l"), ("RIGHT", "rot_r"))}


def _run_driver(label, argv, kernels):
    """run_slam.main(argv) in this process with the launch counts set to 0
    before it; returns (its printed report as a dict, launches)."""
    import contextlib
    import io
    import re

    from self_commit_orb_slam2_tpu_torch import run_slam
    from self_commit_orb_slam2_tpu_torch.utils import datasets

    for k in kernels.values():
        k.launches = 0
    decodes = dict(datasets.DECODES)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run_slam.main(argv)
    text = out.getvalue()
    launches = {k.name: k.launches for k in kernels.values()}
    require(rc == 0, f"{label}: run_slam returned {rc}:\n{text}")
    nums = dict(
        frames=int(re.search(r"frames: (\d+)", text).group(1)),
        keyframes=int(re.search(r"keyframes: (\d+)", text).group(1)),
        points=int(re.search(r"map points: (\d+)", text).group(1)),
        decode_s=float(re.search(r"decode: ([\d.]+)s", text).group(1)),
        track_s=float(re.search(r"tracking: ([\d.]+)s", text).group(1)),
        state=int(re.search(r"state: (\d+)", text).group(1)),
        median_ms=float(re.search(r"median tracking time: ([\d.]+) ms", text).group(1)))
    nums["native"] = datasets.DECODES["native"] - decodes["native"]
    nums["pil"] = datasets.DECODES["pil"] - decodes["pil"]
    for line in text.strip().splitlines():
        print(f"[{label}]   {line}")
    return nums, launches


def _driver_ate(path, gt, label, limit):
    """ATE of the TUM file a driver wrote against the known ground truth."""
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse
    from self_commit_orb_slam2_tpu_torch.utils.trajectory import load_tum

    _, Twc = load_tum(path)
    require(len(Twc) == len(gt) and np.all(np.isfinite(Twc)),
            f"{label}: the trajectory file holds {len(Twc)} poses, want {len(gt)}")
    ate = float(ate_rmse(np.linalg.inv(Twc), gt))
    require(ate < limit, f"{label}: ATE {ate:.6f} m >= {limit} m")
    return ate


def _batch_launches(n, batch):
    """FAST launches of run_slam --batch: one track_batch call per `batch`
    frames, each one (padded) chunk, plus the initializing frame."""
    return 1 + sum(1 for s in range(0, n, batch) if min(s + batch, n) - max(s, 1) > 0)


def _report(label, nums, launches, ate, want_b1, min_kf=1, sync_note="synced"):
    fps = nums["frames"] / nums["track_s"]
    share = nums["decode_s"] / (nums["decode_s"] + nums["track_s"])
    print(f"[{label}] {nums['frames']} frames: {fps:.2f} frames/s, "
          f"{nums['track_s'] / nums['frames'] * 1e3:.1f} ms per frame tracking, decode "
          f"{nums['decode_s'] / nums['frames'] * 1e3:.1f} ms per frame ({share:.3f} of the "
          f"run; host clock, {sync_note}); state {nums['state']}, keyframes "
          f"{nums['keyframes']}, points {nums['points']}, ATE {ate:.6f} m; decoded natively "
          f"{nums['native']}, by PIL {nums['pil']}; launches {launches}")
    require(nums["state"] == 1, f"{label}: tracking lost (state {nums['state']})")
    require(nums["keyframes"] >= min_kf, f"{label}: only {nums['keyframes']} keyframes")
    require(nums["native"] > 0 and nums["pil"] == 0,
            f"{label}: {nums['pil']} images decoded by PIL, {nums['native']} natively")
    require(launches == {"fast_band": want_b1, "fast_nms": 0},
            f"{label}: launches {launches}, want fast_band {want_b1}, fast_nms 0")
    return fps, share


def _b1_on_decoded(label, images_u8, orb):
    """B1 bitwise against its plain version on frames the driver decoded."""
    from self_commit_orb_slam2_tpu_torch.ops.orb import fast_band
    from self_commit_orb_slam2_tpu_torch.tools.time_fast import frames_slab

    slab, H0p, dims = frames_slab(images_u8, orb, band=True)
    args = (orb.fast_threshold_hi, orb.fast_threshold_lo, H0p, dims, orb.border, orb.n_levels)
    out_k = fast_band.fast_nms_bands_hi_lo(slab, *args)
    return _check_kernel("fast_band", label, out_k, fast_band.fast_bands_plain(slab, *args),
                         int((out_k[2] > 0).sum()))


def _warm_probe(primed: bool, images, depths, ts):
    """In a fresh process: System(cfg) at bench.py's configuration with the
    bundled vocabulary, warm_start or not, then 1 + 24 frames streamed in
    chunks of 4; seconds of warm_start and ms of each chunk (host clock,
    synced)."""
    sys.path.insert(0, HERE)
    import torch

    from self_commit_orb_slam2_tpu_torch.models.system import System
    from self_commit_orb_slam2_tpu_torch.ops import bow

    slam = System(_bench_config(bow.load_vocabulary(bow.default_vocab_path())))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if primed:
        slam.warm_start()
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    sess = slam.open_stream("rgbd", CHUNK)
    edges = [0, 1, *range(1 + CHUNK, len(ts) + 1, CHUNK)]   # the initializing frame, chunks
    chunk_ms = []
    for a, b in zip(edges[:-1], edges[1:]):
        t0 = time.perf_counter()
        sess.feed((images[a:b], depths[a:b]), ts[a:b])
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    sess.finish()
    return warm_s, chunk_ms, slam.state


def phase_path7(seq, kitti, euroc, kernels, vocab, workdir):
    """The drivers on the card: (a) to (c) run_slam on TUM, KITTI and EuRoC
    directories, (d) stream_slam.serve over a pipe, (e) warm_start."""
    import threading

    import torch

    from self_commit_orb_slam2_tpu_torch import stream_slam
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
    from self_commit_orb_slam2_tpu_torch.utils import datasets
    from self_commit_orb_slam2_tpu_torch.utils.config_io import load_settings

    _installations()
    t0 = time.perf_counter()
    tum = _write_tum(os.path.join(workdir, "tum"), seq, N_TUM)
    tum13 = _write_tum(os.path.join(workdir, "tum13"), seq, N_TUM_PER_FRAME)
    # Camera.fps 10: max_frames_between_kf 10, as bench.py's configuration
    tum_yaml = _settings(os.path.join(workdir, "TUM1.yaml"), WIDTH, HEIGHT, FX, 0.1, N_FEATURES,
                         10.0, depth_factor=TUM_DEPTH_FACTOR)
    kdir = _write_kitti(os.path.join(workdir, "kitti"), kitti, N_KITTI7, KITTI["fx"],
                        KITTI["baseline"])
    edir = _write_euroc(os.path.join(workdir, "euroc"), euroc, N_EUROC7)
    euroc_yaml = _settings(os.path.join(workdir, "EuRoC.yaml"), EUROC["width"], EUROC["height"],
                           EUROC["fx"], EUROC["baseline"], EUROC["n_features"], 20.0,
                           rect=_euroc_rect_blocks(EUROC))
    print(f"[path 7] datasets written in {time.perf_counter() - t0:.1f} s (host, stdlib PNG "
          f"writer): TUM {N_TUM} and {N_TUM_PER_FRAME} frames, KITTI {N_KITTI7} pairs, EuRoC "
          f"{N_EUROC7} raw pairs")
    rows, b1 = {}, 0

    # (a) TUM: --batch 4 as bench.py builds System(cfg), then per frame
    label = "path 7a"
    out = os.path.join(workdir, "tum_traj.txt")
    nums, launches = _run_driver(label, ["--dataset", "tum", "--path", tum, "--settings",
                                         tum_yaml, "--batch", str(CHUNK), "--output", out],
                                 kernels)
    ate = _driver_ate(out, seq.poses_gt[:N_TUM], label, ATE_LIMIT_M)
    rows["tum"] = _report(label, nums, launches, ate, _batch_launches(N_TUM, CHUNK),
                          min_kf=2) + (ate,)
    b1 += launches["fast_band"]
    ds = datasets.TumRgbdDataset(tum)
    decoded = np.stack([_u8(ds[i].image) for i in range(1 + CHUNK)])
    require(np.array_equal(decoded, _u8(seq.images[:1 + CHUNK])),
            f"{label}: the decoded frames differ from the frames written")
    _b1_on_decoded(f"{label} decoded first frame", decoded[:1], OrbConfig(n_features=N_FEATURES))
    _b1_on_decoded(f"{label} decoded chunk", decoded[1:], OrbConfig(n_features=N_FEATURES))
    label = "path 7a per frame"
    out13 = os.path.join(workdir, "tum13_traj.txt")
    nums, launches = _run_driver(label, ["--dataset", "tum", "--path", tum13, "--settings",
                                         tum_yaml, "--batch", "0", "--output", out13], kernels)
    ate = _driver_ate(out13, seq.poses_gt[:N_TUM_PER_FRAME], label, ATE_LIMIT_M)
    rows["tum per frame"] = _report(label, nums, launches, ate, N_TUM_PER_FRAME) + (ate,)
    b1 += launches["fast_band"]

    # (b) KITTI: run_slam's own configuration (2000 features, 256 / 131072 / 4096)
    label = "path 7b"
    out = os.path.join(workdir, "kitti_traj.txt")
    nums, launches = _run_driver(label, ["--dataset", "kitti", "--path", kdir, "--batch",
                                         str(CHUNK), "--output", out,
                                         "--kitti-output", out + ".kitti"], kernels)
    ate = _driver_ate(out, kitti.poses_gt[:N_KITTI7], label, 0.01)
    rows["kitti"] = _report(label, nums, launches, ate, _batch_launches(N_KITTI7, CHUNK)) + (ate,)
    b1 += launches["fast_band"]

    # (c) EuRoC: raw eyes rectified on the host from the settings' blocks
    label = "path 7c"
    out = os.path.join(workdir, "euroc_traj.txt")
    nums, launches = _run_driver(label, ["--dataset", "euroc", "--path", edir, "--settings",
                                         euroc_yaml, "--batch", str(CHUNK), "--output", out],
                                 kernels)
    ate = _driver_ate(out, euroc.poses_gt[:N_EUROC7], label, 0.02)
    rows["euroc"] = _report(label, nums, launches, ate, _batch_launches(N_EUROC7, CHUNK)) + (ate,)
    b1 += launches["fast_band"]

    # (d) stream_slam.serve: SLFR records through a pipe into a primed System
    label = "path 7d"
    cfg = load_settings(tum_yaml, sensor="rgbd", vocab=vocab)._replace(depth_map_factor=1.0)
    slam = System(cfg)
    slam.warm_start()
    r_fd, w_fd = os.pipe()

    def send():
        with os.fdopen(w_fd, "wb") as w:
            for i in range(N_SERVE):
                stream_slam.write_frame(w, "rgbd", float(seq.timestamps[i]), seq.images[i],
                                        seq.depths[i])

    for k in kernels.values():
        k.launches = 0
    sender = threading.Thread(target=send)
    sender.start()
    import io

    poses_out = io.BytesIO()
    t0 = time.perf_counter()
    with os.fdopen(r_fd, "rb") as r:
        n_served = stream_slam.serve(slam, r, poses_out)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    sender.join(timeout=60)
    launches = {k.name: k.launches for k in kernels.values()}
    b1 += launches["fast_band"]
    poses_out.seek(0)
    recs = []
    while (rec := stream_slam.read_pose(poses_out)) is not None:
        recs.append(rec)
    # the same frames as the wire carries them, through track_rgbd on the card
    ref = System(cfg)
    buf = io.BytesIO()
    want = []
    for i in range(N_SERVE):
        stream_slam.write_frame(buf, "rgbd", float(seq.timestamps[i]), seq.images[i],
                                seq.depths[i])
    buf.seek(0)
    while (fr := stream_slam.read_frame(buf)) is not None:
        want.append(ref.track_rgbd(*fr[2], fr[1]))
    err = max(float(np.abs(p - w).max()) for (_, _, p), w in zip(recs, want)) if recs else np.inf
    print(f"[{label}] serve: {n_served} SLFR records in, {len(recs)} SLPO records out in "
          f"{serve_s:.3f} s = {n_served / serve_s:.2f} frames/s (host clock, synced; the "
          f"sender thread writes the pipe meanwhile); final state {slam.state}, "
          f"keyframes {slam.n_keyframes()}; poses against a track_rgbd loop on the card: "
          f"max |difference| {err:.3e}; launches {launches}")
    require(n_served == N_SERVE and len(recs) == N_SERVE,
            f"{label}: {n_served} frames served, {len(recs)} poses back, want {N_SERVE}")
    require(slam.state == STATE_OK and recs[-1][1] == STATE_OK, f"{label}: tracking lost")
    require(err <= 1e-3, f"{label}: served poses differ from track_rgbd's by {err:.3e}")
    require(launches == {"fast_band": N_SERVE, "fast_nms": 0},
            f"{label}: launches {launches}, want fast_band {N_SERVE}")
    rows["serve"] = (n_served / serve_s, err)

    # (e) warm_start: a fresh process each, unprimed first, at bench.py's configuration
    label = "path 7e"
    images = _u8(seq.images[:N_WARM])
    depths = np.clip(seq.depths[:N_WARM] * 1e3, 0, 65535).astype(np.uint16)
    probes = {}
    for primed in (False, True):
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
            probes[primed] = pool.submit(_warm_probe, primed, images, depths,
                                         seq.timestamps[:N_WARM]).result()
    for primed, (warm_s, chunk_ms, state) in probes.items():
        first, med = chunk_ms[1], float(np.median(chunk_ms[2:]))
        print(f"[{label}] {'primed' if primed else 'unprimed'} (fresh process): warm_start "
              f"{warm_s:.3f} s; initializing frame {chunk_ms[0]:.1f} ms, first chunk "
              f"{first:.1f} ms, median of the other {len(chunk_ms) - 2} chunks {med:.1f} ms "
              f"(host clock, synced); state {state}")
        require(state == STATE_OK, f"{label}: tracking lost ({'primed' if primed else 'unprimed'})")
    rows["warm"] = {p: (w, c[0], c[1], float(np.median(c[2:]))) for p, (w, c, _) in probes.items()}
    return b1, rows


def main() -> int:
    sys.path.insert(0, HERE)
    try:
        import torch  # noqa: F401
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    stack = contextlib.ExitStack()
    try:
        name, count, card = phase_device()
        try:
            import self_commit_orb_slam2_tpu_torch  # noqa: F401
        except ImportError as exc:
            raise PhaseError(f"the port's package is missing beside this script ({exc})")

        from self_commit_orb_slam2_tpu_torch.utils.synthetic import (
            circle_trajectory, lookat_trajectory)

        t_data = time.perf_counter()
        pool = ProcessPoolExecutor(6, mp_context=multiprocessing.get_context("spawn"))
        stack.callback(pool.shutdown, cancel_futures=True)
        geo = dict(width=WIDTH, height=HEIGHT, fx=FX, seed=5)
        seq_jobs = _submit_frames(pool, lookat_trajectory(N_FRAMES), 4, **geo)
        kitti_jobs = _submit_frames(
            pool, lookat_trajectory(N_KITTI), 2, width=KITTI["width"], height=KITTI["height"],
            fx=KITTI["fx"], seed=5, stereo_baseline=KITTI["baseline"])
        euroc_job = pool.submit(_render, "euroc", dict(
            n_frames=N_EUROC, width=EUROC["width"], height=EUROC["height"], fx=EUROC["fx"],
            baseline=EUROC["baseline"]))
        loop_jobs = _submit_frames(pool, circle_trajectory(N_LOOP, frames_per_rev=LOOP_REV), 6,
                                   **geo)
        kernels = phase_build()
        seq = _join_frames(seq_jobs)
        print(f"[data] generate_sequence: {N_FRAMES} frames ready "
              f"{time.perf_counter() - t_data:.1f} s after the render pool started (6 worker "
              f"processes, host)")
        results = phase_kernels(seq)
        summary = []
        for label, cell, mapping, own in (("path 1", 16, False, "fast_band"),
                                          ("path 2", 8, True, "fast_nms")):
            n, fps, ate = phase_path(seq, kernels, label, cell, mapping, own)
            results[own]["launches"] = n
            summary.append(f"{label} {fps:.2f} frames/s, ATE {ate:.6f} m")
        vocab, bow_ms = phase_vocabulary(seq)
        n3, fps3, ate3, reloc_ms = phase_path3(seq, kernels, vocab)
        results["fast_band"]["launches_path3"] = n3
        results["fast_nms"]["launches_path3"] = 0
        summary.append(f"path 3 {fps3:.2f} frames/s, ATE {ate3:.6f} m, BoW of a frame "
                       f"{bow_ms:.3f} ms, one relocalization {reloc_ms:.1f} ms")

        t0 = time.perf_counter()
        kitti = _join_frames(kitti_jobs)
        euroc, euroc_maps = euroc_job.result()
        print(f"[data] stereo pairs: {N_KITTI} at {KITTI['width']}x{KITTI['height']} and "
              f"{N_EUROC} raw at {EUROC['width']}x{EUROC['height']}: waited "
              f"{time.perf_counter() - t0:.1f} s for the render pool (host)")
        band = results["fast_band"]
        phase_band_shapes(kitti, euroc, euroc_maps, band)
        match_ms, share = phase_stereo_matcher(kitti)
        n4a, fps4a, ate4a, pass4a = phase_path_stereo(
            "path 4a", kitti, _sensor_config("stereo", vocab=vocab, max_frames_between_kf=10,
                                             **KITTI), N_KITTI, 0.01, kernels)
        n4b, fps4b, ate4b, _ = phase_path_stereo(
            "path 4b", euroc, _sensor_config("stereo", vocab=vocab, rect_maps=euroc_maps,
                                             max_frames_between_kf=10, **EUROC),
            N_EUROC - N_EUROC_PER_FRAME, 0.02, kernels)
        summary.append(f"path 4a {fps4a:.2f} frames/s, ATE {ate4a:.6f} m, {pass4a:.1f} ms per "
                       f"mapping pass, match_stereo {match_ms / CHUNK:.3f} ms per frame, depth "
                       f"on {share:.3f} of the keypoints; path 4b {fps4b:.2f} frames/s, ATE "
                       f"{ate4b:.6f} m")
        two_view_ms = phase_two_view()
        n5, fps5, ate5, attempt_ms, n_init = phase_path5(seq, kernels, vocab)
        summary.append(f"two-view {two_view_ms:.1f} ms; path 5 {fps5:.2f} frames/s, Sim3 ATE "
                       f"{ate5:.6f} m, initialized after {n_init} frames, {attempt_ms:.1f} ms "
                       f"per bootstrap attempt")
        t0 = time.perf_counter()
        seq6 = _join_frames(loop_jobs)
        print(f"[data] path 6: {N_LOOP} frames; waited {time.perf_counter() - t0:.1f} s for the "
              f"render pool (host)")
        n6, fps6, ate6, raw6, n_closures, ph6, stages = phase_path6(seq6, kernels, vocab)
        mean6 = {k: float(np.mean(ph6.get(k, [np.nan])))
                 for k in ("detect", "correct", "gba_slice", "merge")}
        summary.append(f"path 6 {fps6:.2f} frames/s, {n_closures} closures, ATE {ate6:.6f} m "
                       f"(raw {raw6:.6f} m), detection {mean6['detect']:.1f} ms per keyframe, "
                       f"correction {mean6['correct']:.1f} ms, GBA slice "
                       f"{mean6['gba_slice']:.1f} ms, merge {mean6['merge']:.1f} ms, pose graph "
                       f"on the card {stages['pose_graph_ms']:.1f} ms")
        with tempfile.TemporaryDirectory() as workdir:
            n7, rows7 = phase_path7(seq, kitti, euroc, kernels, vocab, workdir)
        summary.append("path 7 " + ", ".join(
            f"{k} {rows7[k][0]:.2f} frames/s (decode {rows7[k][1]:.3f} of the run), ATE "
            f"{rows7[k][2]:.6f} m" for k in ("tum", "tum per frame", "kitti", "euroc"))
            + f", serve {rows7['serve'][0]:.2f} frames/s within {rows7['serve'][1]:.1e} of "
            f"track_rgbd, warm_start {rows7['warm'][True][0]:.2f} s; primed against unprimed: "
            "initializing frame {:.0f} / {:.0f} ms, first chunk {:.0f} / {:.0f} ms, median "
            "chunk {:.0f} / {:.0f} ms".format(*(rows7["warm"][p][i] for i in (1, 2, 3)
                                               for p in (True, False))))
        for row in results.values():
            row.setdefault("shapes", [])
            own = row["name"] == "fast_band"
            row.update(launches_path4a=n4a if own else 0, launches_path4b=n4b if own else 0,
                       launches_path5=n5 if own else 0, launches_path6=n6 if own else 0,
                       launches_path7=n7 if own else 0)
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        stack.close()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_path3",
            "launches_path4a", "launches_path4b", "launches_path5", "launches_path6",
            "launches_path7", "shapes")
    print(f"[summary] {card}: {'; '.join(summary)}")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
