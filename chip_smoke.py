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
     keyframes, Sim3-aligned ATE < 0.06 m.

The second-to-last line is the kernels JSON (each kernel with its launches
on its own path; the band kernel also with those on paths 3, 4 and 5 and its
times at the stereo shapes); the last line is {"ok": true, "device": {...}}.
Imports nothing of JAX.
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
        from self_commit_orb_slam2_tpu_torch.utils.synthetic import (
            euroc_like_sequence, generate_sequence)

        kernels = phase_build()
        t0 = time.perf_counter()
        seq = generate_sequence(n_frames=N_FRAMES, width=WIDTH, height=HEIGHT,
                                fx=FX, seed=5)
        print(f"[data] generate_sequence: {N_FRAMES} frames in "
              f"{time.perf_counter() - t0:.1f} s (host)")
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
        kitti = generate_sequence(n_frames=N_KITTI, width=KITTI["width"],
                                  height=KITTI["height"], fx=KITTI["fx"], seed=5,
                                  stereo_baseline=KITTI["baseline"])
        t1 = time.perf_counter()
        euroc, euroc_maps = euroc_like_sequence(N_EUROC, EUROC["width"], EUROC["height"],
                                                EUROC["fx"], EUROC["baseline"])
        print(f"[data] stereo pairs: {N_KITTI} at {KITTI['width']}x{KITTI['height']} in "
              f"{t1 - t0:.1f} s, {N_EUROC} raw at {EUROC['width']}x{EUROC['height']} in "
              f"{time.perf_counter() - t1:.1f} s (host)")
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
        for row in results.values():
            row.setdefault("shapes", [])
            own = row["name"] == "fast_band"
            row.update(launches_path4a=n4a if own else 0, launches_path4b=n4b if own else 0,
                       launches_path5=n5 if own else 0)
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_path3",
            "launches_path4a", "launches_path4b", "launches_path5", "shapes")
    print(f"[summary] {card}: {'; '.join(summary)}")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
