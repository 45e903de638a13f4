#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. device: the card's name, count, and nvidia-smi's name and power limit;
  2. build: compile every kernel of the port's paths and the chunk graph's
     conditional-node helper (csrc/graph_cond.cu) from the checkout's
     sources (one nvcc per source, all at once, sm_90a) and print ptxas'
     registers / shared memory;
  3. kernels: run each kernel and its plain PyTorch version on the card at
     its path's shapes (the first frame and a chunk of 4) and on a chunk-sized
     slab of uniform noise (the kernels' worst case); require bitwise
     equality; time the kernel on the device alone (launches on preallocated
     outputs replayed from a CUDA graph, L2 hot; then with the L2 flushed
     before each launch), the wrapper's host time per call and the plain
     version, beside the kernel's bound; then the per-frame API's frame
     build and the mono bootstrap's doubled-budget frame build, each a
     fresh captured program on 1 + 4 frames: B1 from their replays bitwise
     against its plain version on the slab each replay gave it, the frames
     bitwise against make_frame_* op by op, ms a frame build each way and
     host syncs in a replay (0, hard);
  4. the port's System (RGB-D, 640x480, 1000 features, the bench's
     capacities, chunk 4, loop closing off) streams 1 + 60 frames of
     generate_sequence(seed=5, fx=520) along each path, with every launch
     count set to 0 just before it and read just after, each chunk one
     frame-phase replay and one chunk-graph replay dispatched under
     streaming.no_host_reads() (a host read in a dispatch raises):
       path 1: 16-px cells (FAST band kernel), local mapping off;
       path 2: 8-px cells (FAST NMS kernel + slab selection), local mapping
               on, one mapping pass per keyframe inserted after the first;
     each must end STATE_OK with >= 2 keyframes and ATE < 0.01 m, launch its
     own kernel once per extraction call and the other kernel never, run
     one mapping pass per keyframe after the first (counted on the card)
     and replay one chunk graph a chunk (models/step_graph.py); then the
     same frames through a System whose chunks replay the per-frame step
     graphs (StepGraph.per_frame, its mapping passes timed): frames/s both
     ways in one call; then the graph phase of the path (phase_graph; also
     after paths 4 (a) and 5; the vocabulary added, so that the chunk graph
     holds the LOST branches): 1 + 9 frames, each chunk run op by op
     (pipeline.batch_steps_frames) on a clone of the state and through one
     chunk-graph replay on the live state, bitwise (StepInfos, map, carry,
     generator, relocalization counts) with 0 host syncs; op by op against
     graphed, tracking ms, device kernels, graph replays, host syncs and
     cudaMemcpy calls in a profiled chunk (torch.profiler), idle share, the
     capture's seconds, the chunk graph's nodes, capture and instantiation
     seconds; then a chunk whose blank first frame goes LOST and whose
     later frame relocalizes and makes a keyframe, likewise bitwise;
  5. vocabulary: the bundled vocabulary (k=10, L=6) is loaded and moved to
     the card; transform + sparse_bow of one extracted frame on the card must
     equal the same calls on the CPU (words, nodes, ids exactly; weights
     within 1e-6); ms per call; the three batched symmetric eigenproblems of
     a relocalization by the port's float64 Jacobi sweeps, op by op and from
     a CUDA graph, beside torch.linalg.eigh (the library call) on the same
     inputs;
  6. path 3: one System with the vocabulary, 16-px cells, local mapping on,
     with the launch, mapping-pass and relocalization counts set to 0 before:
       a. 1 + 40 frames streamed: STATE_OK, >= 2 keyframes, ATE < 0.01 m, a
          BoW row and node ids in every keyframe, no relocalization attempt;
       b. one batch of 3 blank frames, frame 20 three times, frame 21 twice:
          recovers inside the batch, within 0.05 m of its own estimate,
          through the LOST branches of two chunk-graph replays (no replay
          of the lost graph); b'. a LOST-then-keyframe chunk, op by op
          against the chunk graph, bitwise, 0 host syncs;
       c. per frame: 3 blank frames (LOST), then frame 24 until it recovers,
          through the lost graph and the relocalization graph;
          then one relocalization from one state, op by op against the
          relocalization graph: the same success, Tcw bitwise (else within
          1e-5), inliers within 2, ms a call each, 0 host syncs in a replay;
       d. localization mode over frames 25 to 40 through the loc_core graph
          (captured by activate_localization_mode), then the same frames op
          by op from the same state: STATE_OK throughout, no keyframe and no
          point added, the map unchanged, poses bitwise (else within 1e-5),
          within 0.05 m of the estimates of (a), ms a frame each way;
       d'. a kidnap inside localization mode: 3 blank frames, then mapped
          frames until it recovers through loc_lost, within 0.05 m; d''. a
          kidnap inside a localization-mode chunk, op by op against the
          loc_chunk graph, bitwise, 0 host syncs;
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
     n_good within 2%, pose within 1e-3); its solves' float64 Jacobi
     sweeps timed op by op and from a CUDA graph beside the library's eigh
     and svd on the same inputs;
 11. path 5, mono, 640x480, 1000 features, vocabulary loaded, mapping on:
     the first 41 frames of the RGB-D sequence's images through
     track_batch_mono; the map initializes within 6 frames, STATE_OK, >= 3
     keyframes, Sim3-aligned ATE < 0.06 m; the bootstrap through its graphs
     (program_graphs.MonoInitGraphs) against op by op, per frame from one
     generator seed (the same frame, Tcw and points bitwise, else within
     the two-view bounds), then the last attempt 3 times each way from one
     generator state (bitwise), ms an attempt each way and host syncs in a
     replay (0, hard);
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
     closure's state: the same candidate and found, poses within 1e-3;
     detection, correction, the ten GBA slices and the merge through the
     stream's closer graphs against op by op from that state (bitwise, else
     the stated bounds; ms a call, a slice and a merge each way; host syncs
     in a replay, 0, hard); then a LOST-then-keyframe chunk on the
     closer's System, op by op against the chunk graph, bitwise.

 13. path 7, the drivers, on frames of the paths above written to disk in
     each dataset's layout (stdlib PNG writer), decoded by the native decoder
     (required; which decoder ran, and whether PIL, PyYAML and g++ are
     present, is printed first):
       a. TUM RGB-D layout (1 + 40 frames of path 1, 16-bit depth at
          DepthMapFactor 5000, a TUM1-style settings file):
          run_slam.main --dataset tum --batch 4 (the bundled vocabulary,
          System(cfg) with the closer), then --batch 0 on 13 frames; ATE of
          the written TUM file < 0.01 m, STATE_OK, >= 2 keyframes (batch run),
          B1 bitwise on the decoded frames; the 13 decoded frames through
          track_rgbd graphed (the frame build and the step replayed) and op
          by op: poses bitwise (else 1e-5), ms a frame each way;
       b. KITTI layout (1 + 16 pairs of path 4 (a)): --dataset kitti --batch
          4, run_slam's own configuration (2000 features, 256 / 131072 /
          4096); ATE < 0.01 m;
       c. EuRoC layout (1 + 8 raw pairs of path 4 (b), a settings file with
          the LEFT.* / RIGHT.* blocks): --dataset euroc --batch 4, rectified
          on the host; ATE < 0.02 m;
       d. stream_slam.serve: 20 frames as SLFR records through an os.pipe
          into a System primed by warm_start; 20 SLPO records, STATE_OK,
          poses within 1e-3 of a track_rgbd loop on the card, which runs
          graphed and op by op (poses bitwise, else 1e-5; ms a frame);
       e. warm_start at bench.py's configuration with the vocabulary, in a
          fresh process, against an unprimed one: its seconds, the first
          chunk's ms against the median chunk's;
     each driver run's frames/s, ms per frame and decode share (host clock,
     synchronized with the card), and B1's launches (once per extraction
     call; B2 never).
 14. path 8, the multi-device layer on the one card (a world of one rank):
       a. path 6's scenario, its 184 frames, at run_slam's TUM
          capacities (the default Capacities(), 256 / 65536 / 2048):
          STATE_OK, >= 1 closure, the
          dispatched global BA takes the sharded branch (the distributed
          Schur BA on a 1 x 1 mesh) and is merged, corrected ATE below raw,
          B1 once per chunk and the first frame (bitwise on the first frame
          and the chunk at frame 113); the sharded GBA's ms, its peak memory
          on the card and the stall it cost the stream; then that GBA twice
          more from its own inputs (bitwise, hard: its scatter-adds in a
          fixed order) and twice with them as plain index_add_ (patched in
          for the comparison), ms each way;
       b. refine_maps.main on (a)'s map and a copy perturbed by N(0, 5e-3)
          (keyframe poses and points), --mesh 1x1: rc 0, the perturbed map's
          mean squared reprojection error below 0.2x its value before, (a)'s
          map's not above; the pose graph's and the BA's ms, peak memory;
       c. FleetTracker serving 4 RGB-D streams (generate_sequence seeds 5 to
          8, 1 + 8 frames each, 640x480, 1000 features, the bench's
          capacities, chunks of 4), through its per-stream graph runners (one
          chunk-graph replay a stream a chunk, every dispatch under sync
          debug mode "error") and op by op in one call: poses, maps and
          carries bitwise equal both ways, each STATE_OK with ATE < 0.01 m,
          stream 0 within 5e-2 of a solo System on its frames, B1 once per
          stream per extraction call; frames/s per stream and for the fleet
          each way;
          then initialize_localization of 2 streams on path 3's saved map and
          2 chunks of localization mode (loc_core replays), graphed and op by
          op: every pose within 0.05 m;
       d. NCCL at a world of one rank (hosts.initialize over a file://
          rendezvous): the distributed BA and pose graph at
          __graft_entry__.py's shapes equal the same calls with no process
          group within 1e-6; the group torn down.
     No multi-GPU run: the card is one.
 15. path 9:
       a. bench.py's mono scale-drift configuration (bench_long_mono: mono,
          96 / 16384 / 1024, max_frames_between_kf 10, the vocabulary,
          System(cfg)) on the first 180 frames of path 6's circle through
          open_stream("mono"), bench.py's per-frame twist and scale 1.0006
          composed per chunk and injected while tracking is OK, from the
          first chunk after initialization to frame 120; once with loop
          closing and once without: >= 1 closure, its global BA merged,
          STATE_OK, Sim3-aligned ATE (trailing ground truth) with loop
          closing below the run without, B1 bitwise on the path's first
          frame and its chunk at frame 160 and once per extraction call;
          prints each closure's frame and Sim3 scale, both ATEs, the live
          keyframes, ms per loop phase, the stall, frames/s;
       b. tests/test_long_sequence.py's bounded map at 640x480 / 1000
          features: 12 keyframe slots, a keyframe every 2 frames, 1 + 60
          frames of its look-at oscillation in chunks of 4: STATE_OK after
          every chunk, more keyframes inserted than slots, at most 12 live,
          n_culled == inserted - live, one finite pose per frame from
          get_trajectory, ATE < 0.08 m, 0 < live points <= 16384; then a
          second pass, untimed, on the same frames counts the carried ids
          the birth-stamp guard dropped.
 16. the per-stage profiler (tools/profile_stages.py) in process at
     PW=640 PH=480 PF=1000, both modes on one state (a System over 8
     frames): every stage op by op and replayed from its own graph, host
     ms and device ms a call, kernels, busy ms and host syncs of a replay
     (op by op only step_rgbd's, whose flag read the sync count must see);
     every replay bitwise against op by op and 0 host syncs in a replay,
     hard; B1's launches in the phase;
 17. the weak-scaling harness (tools/scaling_bench.py) in process at a
     world of one: the JAX script's defaults and path 8 (a)'s per-rank
     shape (256 keyframes x 65536 points), ms beside the Schur products'
     bound, peak memory.

Frame rendering (numpy, host) runs in a pool of worker processes started
first, beside the card work.  The second-to-last line is the kernels JSON
(each kernel with its launches on its own path; the band kernel also with
those on paths 3 to 9 and the profiler's, and its times at the stereo
shapes); the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import faulthandler
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


def _reset_launches(kernels) -> None:
    """Set every launch count to 0: the wrappers' own, and the graph
    runners' counts of what their captures recorded and their replays ran."""
    from self_commit_orb_slam2_tpu_torch.models import program_graphs

    for k in kernels.values():
        k.launches = 0
    program_graphs.LAUNCHES_AT_CAPTURE.clear()
    program_graphs.LAUNCHES_REPLAYED.clear()


def _launches(kernels) -> dict:
    """Device launches of each kernel since _reset_launches.  A wrapper adds
    one where it launches its kernel, and inside a CUDA graph capture that
    launch is only recorded; a replay runs what its capture recorded.  So:
    the wrapper's count, less the recordings, plus replays x launches per
    capture (models/program_graphs.py counts both)."""
    from self_commit_orb_slam2_tpu_torch.models import program_graphs

    return {k.name: k.launches - program_graphs.LAUNCHES_AT_CAPTURE[k.name]
            + program_graphs.LAUNCHES_REPLAYED[k.name] for k in kernels.values()}


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

    from self_commit_orb_slam2_tpu_torch.models import program_graphs
    from self_commit_orb_slam2_tpu_torch.ops.orb import fast_band, fast_nms

    kernels = [fast_band.kernel, fast_nms.kernel]
    cond = program_graphs._COND_BEGIN   # csrc/graph_cond.cu: the chunk graph's IF nodes
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels) + 1) as pool:   # one nvcc per source, together
        libs = list(pool.map(lambda k: k.build(), kernels + [cond]))
    print(f"[build] {len(kernels)} kernels and the conditional-node helper in "
          f"{time.perf_counter() - t0:.1f} s")
    for k, lib in zip(kernels + [cond], libs):
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


def _check_replayed(name, wrapper, plain, slabs, labels, count):
    """The wrapper captured into a CUDA graph on a static slab, replayed on
    each slab copied in: bitwise against the plain version (the launches
    the frame-phase graph makes).  Returns the worst |kernel - plain|."""
    import torch

    static = slabs[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        wrapper(static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = wrapper(static)
    err = 0.0
    for slab, label in zip(slabs, labels):
        static.copy_(slab)
        graph.replay()
        err = max(err, _check_kernel(name, f"{label}, launched from a graph replay", out,
                                     plain(slab), count(out)))
    return err


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
            err = max(err, _check_replayed(
                "fast_band", lambda x: fast_band.fast_nms_bands_hi_lo(x, *args),
                lambda x: fast_band.fast_bands_plain(x, *args), (slab, noise),
                ("chunk", "noise"), lambda o: int((o[2] > 0).sum())))
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
            err = max(err, _check_replayed(
                "fast_nms", lambda x: fast_nms.fast_nms_hi_lo(x, *thr),
                lambda x: fast_nms.fast_nms_plain(x, *thr), (slab, noise), ("chunk", "noise"),
                lambda o: int((o[1] > 0).sum())))
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


def _b1_from_replays(label, run, n):
    """run(k) builds frame k through a fresh frame program: the first call
    runs it and captures it, with B1's wrapper spied at the capture for the
    graph's static slab and outputs; each later call replays it, after
    which those tensors hold that replay's slab and outputs: bitwise against
    the plain version on that slab.  Returns the worst |kernel - plain|."""
    import torch

    from self_commit_orb_slam2_tpu_torch.ops.orb import fast_band

    seen = {}
    inner = fast_band.fast_nms_bands_hi_lo

    def spy(slab, *args):
        out = inner(slab, *args)
        if torch.cuda.is_current_stream_capturing():
            seen["io"] = (slab, args, out)
        return out

    fast_band.fast_nms_bands_hi_lo = spy
    try:
        run(0)
    finally:
        fast_band.fast_nms_bands_hi_lo = inner
    require("io" in seen, f"{label}: the capture launched no B1")
    err = 0.0
    for k in range(1, n):
        run(k)
        slab, args, out = seen["io"]
        err = max(err, _check_kernel("fast_band", f"{label} frame {k}, launched from a replay",
                                     out, fast_band.fast_bands_plain(slab, *args),
                                     int((out[2] > 0).sum())))
    return err


def phase_frame_programs(seq):
    """The per-frame API's frame build (program_graphs.FrameBuild through
    FrameGraphs.single, RGB-D at the main path's configuration) and the mono
    bootstrap's doubled-budget frame build (MonoInitGraphs.frame), each a
    fresh program on 1 + 4 frames: B1 from their replays bitwise against its
    plain version (_b1_from_replays); the frames built graphed (upload from
    pinned staging included) bitwise against make_frame_* op by op on a
    device copy; ms a frame build each way (host clock, synced, median of
    the replays); host syncs in a replay (sync debug mode; hard: 0)."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import frame as frame_mod
    from self_commit_orb_slam2_tpu_torch.models.program_graphs import (
        FrameGraphs, GraphPool, MonoInitGraphs)

    label, n = "frame programs", 1 + CHUNK
    cfg = _bench_config()
    mono = MonoInitGraphs(_sensor_config("mono", WIDTH, HEIGHT, FX, 0.0, N_FEATURES, None),
                          "cuda", GraphPool())
    rgbd = FrameGraphs(cfg, "cuda", GraphPool())
    host = {k: tuple(torch.from_numpy(a[k].astype(np.float32)) for a in (
        np.clip(seq.images, 0, 255).astype(np.uint8), seq.depths)) for k in range(n)}
    cases = {
        "rgbd per frame": (lambda k: rgbd.single("rgbd", host[k]),
                           lambda k: frame_mod.make_frame_rgbd(cfg, *(a.cuda() for a in host[k]))),
        "mono bootstrap": (lambda k: mono.frame(host[k][:1]),
                           lambda k: frame_mod.make_frame_mono(mono.ini_config,
                                                               host[k][0].cuda()))}
    out, err = {}, 0.0
    for name, (graphed, eager) in cases.items():
        err = max(err, _b1_from_replays(f"{label} {name}", graphed, n))
        secs, bitwise = {True: [], False: []}, True
        for k in range(1, n):
            got = {}
            for g, fn in ((True, graphed), (False, eager)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got[g] = fn(k)
                torch.cuda.synchronize()
                secs[g].append(time.perf_counter() - t0)
            bitwise = bitwise and _same_tensors(got[True], got[False])
        _, syncs = _count_syncs(lambda: graphed(1))
        ms = {g: float(np.median(v)) * 1e3 for g, v in secs.items()}
        print(f"[{label}] {name} ({WIDTH}x{HEIGHT}): graphed {ms[True]:.3f} / op by op "
              f"{ms[False]:.3f} ms a frame build (host clock, synced, median of {n - 1}); "
              f"bitwise {bitwise}; host syncs in a replay {sum(syncs.values())} {dict(syncs)}")
        require(bitwise, f"{label} {name}: the graphed frame build differs from op by op")
        require(sum(syncs.values()) == 0, f"{label} {name}: a replay made host syncs {syncs}")
        out[name] = dict(ms=ms, syncs=sum(syncs.values()))
    return out, err


def phase_path(seq, kernels, label: str, cell_size: int, mapping: bool, own: str, vocab):
    """Stream the N_FRAMES frames through the System along one path; `own` is the
    FAST kernel the path must run (once per extraction call).  Each chunk is
    one frame-phase replay and one chunk-graph replay, dispatched under
    streaming.no_host_reads() (a host read there raises); the mapping passes
    are counted on the card.  Then the same frames through the same System,
    reset, its chunks replaying the per-frame step graphs slot by slot
    (StepGraph.per_frame), its mapping passes timed: frames/s both ways."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import pipeline, streaming
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse

    cfg = _bench_config()
    cfg = cfg._replace(orb=cfg.orb._replace(cell_size=cell_size))
    images = np.clip(seq.images, 0, 255).astype(np.uint8)
    depths = np.clip(seq.depths * 1e3, 0, 65535).astype(np.uint16)
    ts = seq.timestamps
    warm = 1 + CHUNK  # the initializing frame + the first chunk
    n_timed = N_FRAMES - warm

    def stream(slam, passes, checked):
        sess = slam.open_stream("rgbd", CHUNK)
        with streaming.no_host_reads() if checked else contextlib.nullcontext():
            sess.feed((images[:warm], depths[:warm]), ts[:warm])
            torch.cuda.synchronize()
            n_warm = len(passes)
            t0 = time.perf_counter()
            sess.feed((images[warm:], depths[warm:]), ts[warm:])
            sess.finish()
            torch.cuda.synchronize()
        return time.perf_counter() - t0, n_warm

    slam = System(cfg, enable_mapping=mapping, enable_loop_closing=False)
    with _counted_passes() as passes:
        _reset_launches(kernels)
        dt, _ = stream(slam, passes, True)
        launches = _launches(kernels)
        n_passes = len(passes)
    fps = n_timed / dt
    _, est = slam.get_trajectory()
    require(len(est) == N_FRAMES, f"{label}: trajectory has {len(est)} poses, want {N_FRAMES}")
    require(np.all(np.isfinite(est)), f"{label}: non-finite poses")
    ate = float(ate_rmse(est, seq.poses_gt[:len(est)]))
    n_kf, n_pt = slam.n_keyframes(), slam.n_points()
    sg = slam.step_graph
    print(f"[{label}] {N_FRAMES} frames {WIDTH}x{HEIGHT}, {N_FEATURES} features, "
          f"cell {cell_size}, mapping {'on' if mapping else 'off'}, chunk {CHUNK}: "
          f"state {slam.state}, keyframes {n_kf}, points {n_pt}, culled keyframes "
          f"{int(slam.map.n_culled)}, ATE {ate:.6f} m")
    print(f"[{label}] steady stream through the chunk graph: {n_timed} frames in {dt:.3f} s = "
          f"{fps:.2f} frames/s (host clock, ends in cuda.synchronize); "
          f"{sg.part_replays['chunk']} chunk-graph replays and "
          f"{sum(p.replays for p in sg.frames.programs)} frame-phase replays for "
          f"{(N_FRAMES - 1) // CHUNK} chunks, per-frame parts replayed "
          f"{sg.replays - sg.part_replays['chunk']} times; every dispatch under sync debug mode "
          f"'error'; mapping passes {n_passes} (counted on the card)")
    print(f"[{label}] launches during the run: {launches}")
    require(slam.state == STATE_OK, f"{label}: tracking lost (state {slam.state})")
    require(n_kf >= 2, f"{label}: only {n_kf} keyframes")
    require(ate < ATE_LIMIT_M, f"{label}: ATE {ate:.6f} m >= {ATE_LIMIT_M} m")
    n_extract = 1 + (N_FRAMES - 1) // CHUNK
    for name, n in launches.items():
        want = n_extract if name == own else 0
        require(n == want, f"{label}: {name} launched {n} times, want {want}")
    want_passes = n_kf - 1 if mapping else 0
    require(n_passes == want_passes,
            f"{label}: {n_passes} mapping passes, want {want_passes} (one per "
            f"keyframe inserted after initialization)")
    require(sg.part_replays["chunk"] == (N_FRAMES - 1) // CHUNK
            and sg.replays == sg.part_replays["chunk"],
            f"{label}: the stream did not run one chunk-graph replay a chunk "
            f"({dict(sg.part_replays)})")

    per_frame = slam   # reset, its per-frame parts captured at the first chunk
    per_frame.reset()
    per_frame.step_graph.per_frame = True
    with pipeline.timed_mapping_passes() as pass_s:
        dt_pf, n_warm = stream(per_frame, pass_s, False)
    per_frame.step_graph.per_frame = False
    fps_pf = n_timed / dt_pf
    _, est_pf = per_frame.get_trajectory()
    steady_map_s = sum(pass_s[n_warm:])
    print(f"[{label}] the same stream through per-frame replays (StepGraph.per_frame): "
          f"{fps_pf:.2f} frames/s against {fps:.2f} through the chunk graph (one call, one "
          f"card); poses bitwise equal to the chunk graph's {bool(np.array_equal(est, est_pf))}; "
          f"{per_frame.step_graph.replays - sg.part_replays['chunk']} step-graph replays"
          + (f"; mapping passes {len(pass_s)}, mean {np.mean(pass_s) * 1e3:.1f} ms per pass "
             f"(host clock, synced), {steady_map_s:.3f} s of the steady stream" if mapping
             else ""))
    require(per_frame.state == STATE_OK and len(pass_s) == want_passes,
            f"{label}: the per-frame stream: state {per_frame.state}, {len(pass_s)} passes")
    graphs = phase_graph(label, cfg, "rgbd", (images, depths), ts, mapping, vocab)
    return launches[own], fps, fps_pf, ate, graphs


# the graph phase of paths 1, 2, 4 (a) and 5: chunks of 4 after the first
# frame (or the mono bootstrap), eager against graphed from the same states
GRAPH_CHUNKS = 3   # 6 until PR 14, cut for the time the chunk graphs' captures take
GRAPH_POSE_TOL, GRAPH_INLIER_TOL = 1e-5, 2


def _clone_state(x):
    import torch

    return type(x)(*(v.clone() if torch.is_tensor(v) else _clone_state(v) for v in x))


def _graph_note(g) -> str:
    f = g["frame"]
    return (f"frame phase eager {f['eager_ms']:.2f} / graphed {f['graph_ms']:.2f} ms per frame "
            f"({f['syncs'][False]:.2f} / {f['syncs'][True]:.2f} host syncs), "
            f"tracking op by op {g['eager_ms']:.1f} / chunk graph {g['graph_ms']:.1f} ms per "
            f"frame, profiled chunk host syncs {g['per'][False]['syncs']:.0f} / "
            f"{g['per'][True]['syncs']:.0f}, kernels {g['per'][False]['kernels']:.0f} / "
            f"{g['per'][True]['kernels']:.0f}, chunk graph {g['nodes']} nodes ({g['conds']} IF), "
            f"capture {g['chunk_capture_s']:.2f} s + instantiation {g['instantiate_s']:.3f} s, "
            f"bitwise {g['bitwise']}, LOST chunk keyframes at slots {g['lost']['slot_kf']}")


class _Passes:
    """The local-mapping passes run since it was made, as the card counted
    them (pipeline.mapping_passes: the stamps each pass writes where it
    runs): a chunk graph runs them inside its replays, where no host timer
    sees them (StepGraph.per_frame times them)."""

    def __len__(self) -> int:
        from self_commit_orb_slam2_tpu_torch.models import pipeline

        return pipeline.mapping_passes()


@contextlib.contextmanager
def _counted_passes():
    from self_commit_orb_slam2_tpu_torch.models import pipeline

    pipeline.reset_mapping_passes()
    yield _Passes()


def _chunk_check(label, slam, frames, ts, valid, loc=False):
    """One chunk op by op (pipeline.batch_steps_frames on clones of the map,
    the carry and the stream generator: every slot on its own span of the
    generator) and then through the System's dispatch of its tracking (one
    replay of the chunk graph) on the live state, under the card's sync
    debug mode.  Hard: the packed StepInfos, the map, the carry, the
    generator and the relocalization counts bit for bit, one replay, 0 host
    syncs.  Returns (unpacked StepInfos, ms op by op, ms graphed)."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import pipeline, relocalization

    sg = slam.step_graph
    ge = torch.Generator(device="cuda")
    ge.set_state(slam._stream_gen.get_state())
    n0 = relocalization.counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_e, c_e, p_e = pipeline.batch_steps_frames(
        slam.config, _clone_state(slam.map), _clone_state(slam.carry), frames, ts, valid,
        slam.enable_mapping, localization_only=loc, generator=ge)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n1 = relocalization.counts()
    r0 = sg.replays
    p_g, syncs = _count_syncs(lambda: slam._batch_steps(frames, ts, valid, loc))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n2 = relocalization.counts()
    bitwise = dict(packed=bool(torch.equal(p_e, p_g)), map=_same_tensors(m_e, slam.map),
                   carry=_same_tensors(c_e, slam.carry),
                   generator=bool(torch.equal(ge.get_state(), slam._stream_gen.get_state())),
                   counts=(n1[0] - n0[0], n1[1] - n0[1]) == (n2[0] - n1[0], n2[1] - n1[1]))
    require(all(bitwise.values()), f"{label}: the chunk graph against op by op: {bitwise}")
    require(sg.replays - r0 == 1, f"{label}: {sg.replays - r0} replays for one chunk")
    require(sum(syncs.values()) == 0, f"{label}: the chunk graph's dispatch made host syncs "
            f"{dict(syncs)}")
    return pipeline.unpack_infos(p_g.cpu().numpy()), (t1 - t0) * 1e3, (t2 - t1) * 1e3


def _lost_chunk_check(label, slam, sess, arrays, ts, start, loc=False):
    """A chunk whose first frame is blank (it goes LOST) and whose next
    three are the path's frames start, start + 1, start + 2, through the
    graphed frame phase, then _chunk_check.  Hard: the blank frame is lost
    and a later frame of the chunk recovers through the LOST branch and, in
    SLAM mode, makes a keyframe; up to three such chunks are tried (the
    frames after each), since a recovery need not make its keyframe in the
    same chunk.  Prints what it found."""
    from self_commit_orb_slam2_tpu_torch.models import relocalization

    for k in range(3):
        i = start + 3 * k
        if i + 3 > len(ts):   # past the path's frames: earlier ones, revisited
            i -= 12
        host = sess._upload([np.concatenate([np.zeros_like(a[:1]), a[i:i + 3]]) for a in arrays],
                            [float(ts[i]) - 0.01] + [float(t) for t in ts[i:i + 3]])
        frames, tsc, valid = slam._frame_phase(sess.sensor, host)
        n0 = relocalization.counts()
        infos, ms_e, ms_g = _chunk_check(f"{label} LOST chunk", slam, frames, tsc, valid, loc)
        n1 = relocalization.counts()
        kf = [int(b) for b in np.nonzero(infos.created_kf)[0]]
        ok = list(map(bool, infos.state_ok))
        found = (not ok[0] and any(ok[1:]) and n1[1] > n0[1]
                 and (loc or any(b > 0 for b in kf)))
        print(f"[{label}] {'localization' if loc else 'SLAM'}-mode chunk [blank, {i}, {i + 1}, "
              f"{i + 2}]: states {ok}, keyframes at slots {kf}, relocalization attempts "
              f"{n1[0] - n0[0]}, successes {n1[1] - n0[1]}; one chunk-graph replay bitwise equal "
              f"to op by op (StepInfos, map, carry, generator, counts), 0 host syncs; op by op "
              f"{ms_e:.1f} ms, graphed {ms_g:.1f} ms (host clock, synced)")
        if found:
            return dict(slot_kf=kf, ms=(ms_e, ms_g), tries=k + 1)
    require(False, f"{label}: no chunk went LOST and then recovered"
            + ("" if loc else " and made a keyframe"))


def _chunk_stats_note(sg, name="chunk") -> str:
    st = sg.chunk_stats[name]
    return (f"{name} graph: {st.nodes} nodes ({st.conds} IF nodes), capture "
            f"{st.capture_s:.3f} s, instantiation {st.instantiate_s:.3f} s (host clock)")


def phase_graph(label, cfg, sensor, arrays, ts, mapping, vocab, slam=None):
    """Op by op against the chunk graph along one path (models/step_graph.py),
    the path's configuration with the vocabulary (so that its chunk graph
    holds the LOST branches).  A fresh System (or the path's own `slam`,
    reset, whose graphs its stream captured) takes the path's first frame
    (or the mono bootstrap's frames) on the per-frame path; a fresh
    System's StepGraph captures the per-frame parts and the chunk graph on
    that state; then
    GRAPH_CHUNKS chunks, built by the path's frame phase first, each through
    _chunk_check (op by op on clones, then one chunk-graph replay on the
    live state: bitwise, 0 host syncs).  The last chunk, its first frame
    live and the other 3 padded (an op-by-op trace of 4 frames takes the
    profiler minutes to read), runs both ways under torch.profiler.  Then a
    chunk in which a blank frame goes LOST and a later frame recovers and
    makes a keyframe (_lost_chunk_check).  Prints tracking ms per frame
    (host clock, synced, the chunks before the last), the profiled chunk's
    device kernels, graph replays, host syncs (op by op: the valid flags'
    and the flags' reads and the closing cuda.synchronize; graphed: the
    closing one) and cudaMemcpy calls, and the idle share, the capture's
    seconds and the chunk graph's nodes, capture and instantiation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from self_commit_orb_slam2_tpu_torch.models import pipeline
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
    from self_commit_orb_slam2_tpu_torch.utils.profiling import trace_counts

    t_phase = time.perf_counter()
    if cfg.vocab is None:
        cfg = cfg._replace(vocab=vocab)
    reused = slam is not None
    if reused:
        slam.reset()
    else:
        slam = System(cfg, enable_mapping=mapping, enable_loop_closing=False)
    sg = slam.step_graph
    require(sg is not None and sg.graphed, f"{label} graphs: the System has no CUDA StepGraph")
    i = 0
    while slam.state != STATE_OK:   # the first frame, or the mono bootstrap
        require(i < 8, f"{label} graphs: no map after {i} frames")
        slam._track(sensor, tuple(torch.from_numpy(a[i].astype(np.float32) * np.float32(
            1e-3 if a.dtype == np.uint16 else 1.0)) for a in arrays), float(ts[i]))
        i += 1
    sess = slam.open_stream(sensor, CHUNK)
    hosts = []
    for c in range(GRAPH_CHUNKS):
        s = i + CHUNK * c
        n_live = 1 if c == GRAPH_CHUNKS - 1 else CHUNK
        hosts.append(sess._upload([a[s:s + n_live] for a in arrays], list(ts[s:s + n_live])))
    chunks, frame = _frame_phase_graphed_vs_eager(label, slam, sess, hosts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not reused:
        sg.capture(slam.map, slam.carry, chunks[0][0].select(0), mapping, slam._stream_gen,
                   chunk=chunks[0][0])
    capture_s = time.perf_counter() - t0

    secs = {False: 0.0, True: 0.0}
    for c in range(GRAPH_CHUNKS - 1):
        _, ms_e, ms_g = _chunk_check(f"{label} graphs chunk {c}", slam, *chunks[c])
        secs[False] += ms_e / 1e3
        secs[True] += ms_g / 1e3
    traces, out = {}, {}
    frames, tsc, valid = chunks[-1]
    for graphed in (False, True):
        r0 = sg.replays
        if not graphed:
            gen = torch.Generator(device="cuda")
            gen.set_state(slam._stream_gen.get_state())
            m, carry = _clone_state(slam.map), _clone_state(slam.carry)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if graphed:
                packed = slam._batch_steps(frames, tsc, valid, False)
                out[graphed] = (slam.map, slam.carry, packed)
            else:
                out[graphed] = pipeline.batch_steps_frames(
                    slam.config, m, carry, frames, tsc, valid, mapping, generator=gen)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        traces[graphed] = dict(trace_counts(prof, dt), replays=sg.replays - r0)
    require(_same_tensors(out[False], out[True]),
            f"{label} graphs: the profiled chunk graphed differs from op by op")
    require(bool(slam.carry.state_ok), f"{label} graphs: tracking lost")
    n_timed = CHUNK * (GRAPH_CHUNKS - 1)
    ms = {g: secs[g] / n_timed * 1e3 for g in secs}
    per = {g: {k: traces[g][k] for k in ("kernels", "syncs", "memcpy", "replays")}
           for g in traces}   # one live frame and 3 padded
    for g in (False, True):
        t = traces[g]
        print(f"[{label} graphs] {'chunk graph' if g else 'op by op   '}: tracking "
              f"{ms[g]:.2f} ms/frame (host clock, synced, {n_timed} frames); profiled chunk (1 "
              f"live frame, 3 padded): {per[g]['kernels']:.0f} device kernels, "
              f"{per[g]['replays']:.0f} graph replays, {per[g]['syncs']:.0f} host syncs, "
              f"{per[g]['memcpy']:.0f} cudaMemcpy calls, idle share {t['idle']:.3f} (device busy "
              f"{t['busy_ms']:.2f} ms, under the profiler)")
    lost = _lost_chunk_check(f"{label} graphs", slam, sess, arrays, ts,
                             min(i + CHUNK * GRAPH_CHUNKS, len(ts) - 3))
    print(f"[{label} graphs] "
          + ("the path's System reused, its graphs captured in its stream: " if reused else
             f"capture {capture_s:.2f} s (warm-up + the SLAM-mode graphs: ")
          + f"{sorted(sg._graphs)}); {_chunk_stats_note(sg)}; a chunk is 1 frame-phase replay + "
          f"1 chunk-graph replay and 0 host syncs; op by op against the chunk graph over "
          f"{n_timed + 1} frames and the LOST chunk from the same states: bitwise; "
          f"{int(slam.map.kf_valid.sum())} keyframes; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    require(traces[True]["replays"] == 1 and traces[False]["replays"] == 0,
            f"{label} graphs: {traces[True]['replays']} replays graphed, "
            f"{traces[False]['replays']} op by op in the profiled chunk")
    st = sg.chunk_stats["chunk"]
    return dict(eager_ms=ms[False], graph_ms=ms[True], per=per, capture_s=capture_s,
                idle={g: traces[g]["idle"] for g in traces}, frame=frame, bitwise=True,
                nodes=st.nodes, conds=st.conds, chunk_capture_s=st.capture_s,
                instantiate_s=st.instantiate_s, lost=lost)


def _same_tensors(a, b) -> bool:
    import torch
    from torch.utils._pytree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _frame_phase_graphed_vs_eager(label, slam, sess, hosts):
    """The streamed frame phase of each packed host chunk op by op
    (frames_*_packed on a device copy of the chunk) and through the System's
    frame-phase graph (models/program_graphs.py; upload from a pinned
    buffer included), both from the same bytes: hard, bitwise equal.  Prints
    ms a frame each way (host clock, synced around each chunk, the first
    graphed call, which captures, apart) and host syncs a frame (cuda sync
    debug mode, one chunk each way).  Returns the op-by-op outputs."""
    import torch

    cfg, sensor = slam.config, sess.sensor
    eager = lambda h: sess.frame_fn(cfg, torch.from_numpy(h).cuda())   # noqa: E731
    graphed = lambda h: slam._frame_phase(sensor, h)                    # noqa: E731
    t0 = time.perf_counter()
    first = graphed(hosts[0])          # the first run, then the capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    outs, secs, bitwise = [], {False: 0.0, True: 0.0}, _same_tensors(first, eager(hosts[0]))
    for h in hosts[1:]:
        for g in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = (graphed if g else eager)(h)
            torch.cuda.synchronize()
            secs[g] += time.perf_counter() - t0
            if not g:
                ref = out
        bitwise = bitwise and _same_tensors(out, ref)
    for h in hosts:
        outs.append(eager(h))
    dev_buf = torch.from_numpy(hosts[1]).cuda()
    _, syncs_e = _count_syncs(lambda: sess.frame_fn(cfg, dev_buf))
    _, syncs_g = _count_syncs(lambda: graphed(hosts[1]))
    n = CHUNK * (len(hosts) - 1)
    ms = {g: secs[g] / n * 1e3 for g in secs}
    progs = slam.step_graph.frames.programs
    sy = {False: sum(syncs_e.values()) / CHUNK, True: sum(syncs_g.values()) / CHUNK}
    print(f"[{label} graphs] frame phase: op by op {ms[False]:.3f} / graphed {ms[True]:.3f} ms "
          f"per frame (host clock, synced per chunk, {n} frame slots, upload included "
          f"graphed), host syncs per frame {sy[False]:.2f} {dict(syncs_e)} / {sy[True]:.2f} "
          f"{dict(syncs_g)} (sync debug mode); first run and capture {capture_s:.2f} s; "
          f"{sum(p.replays for p in progs)} replays; bitwise over {len(hosts)} chunks "
          f"{bitwise}")
    require(bitwise, f"{label} graphs: the frame phase graphed differs from op by op")
    require(sy[True] == 0, f"{label} graphs: the graphed frame phase made host syncs {syncs_g}")
    return outs, dict(eager_ms=ms[False], graph_ms=ms[True], syncs=sy, bitwise=bitwise)


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
    eig = _eigensolvers()
    return vocab, ms_t + ms_s, eig


def _graph_time_ms(fn, reps: int = 5) -> float:
    """CUDA-event time per replay of fn captured into a CUDA graph (after a
    warm-up run on a side stream)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _event_time_ms(graph.replay, reps)


def _eigensolvers():
    """The three batched symmetric eigenproblems of one relocalization (5
    candidates x 256 sets): EPnP's [1280, 3, 3] covariances (every
    eigenpair) and [1280, 12, 12] M'M (the smallest eigenvector), Horn's
    [1280, 4, 4] (the largest), each by the port's float64 Jacobi sweeps
    (ops/solvers/jacobi.py) op by op and from a CUDA graph, beside
    torch.linalg.eigh (the library call, which reads its error code back to
    the host and so cannot be captured) on the same inputs; and the
    solver's worst eigenvector against float64 eigh, up to sign."""
    import torch

    from self_commit_orb_slam2_tpu_torch.ops.solvers import epnp, horn, jacobi

    solvers = {3: lambda a: jacobi.eigh(a, epnp.COV_SWEEPS)[1],
               12: lambda a: jacobi.extreme_eigenvector(a, epnp.KERNEL_SWEEPS, largest=False),
               4: horn.top_eigenvector}
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for n, solve in solvers.items():
        a = torch.randn(1280, n, n, device="cuda", generator=g)
        sym = a @ a.transpose(1, 2)
        lib_ms = _event_time_ms(lambda sym=sym: torch.linalg.eigh(sym), reps=5)
        op_ms = _event_time_ms(lambda sym=sym: solve(sym), reps=5)
        graph_ms = _graph_time_ms(lambda sym=sym: solve(sym), reps=5)
        got = solve(sym).double()
        want = torch.linalg.eigh(sym.double())[1]
        want = {3: want, 12: want[..., :, 0], 4: want[..., :, -1]}[n]
        dim = -2 if n == 3 else -1
        err = float(torch.minimum((got - want).norm(dim=dim), (got + want).norm(dim=dim)).max())
        out[n] = dict(lib_ms=lib_ms, op_ms=op_ms, graph_ms=graph_ms, err=err)
        print(f"[vocabulary] [1280, {n}, {n}]: Jacobi (float64) {op_ms:.3f} ms op by op, "
              f"{graph_ms:.3f} ms from a CUDA graph; torch.linalg.eigh (library "
              f"{torch.backends.cuda.preferred_linalg_library()}) {lib_ms:.3f} ms (CUDA events, "
              f"after a warm-up); worst eigenvector against float64 eigh {err:.2e} (fp32 "
              f"inputs, up to sign)")
    return out


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def phase_path3(seq, kernels, vocab):
    """The JAX package's default RGB-D configuration less loop closing: the
    vocabulary loaded, 16-px cells, local mapping on; steps (a) to (e)."""
    import tempfile

    import torch

    from self_commit_orb_slam2_tpu_torch.models import relocalization, streaming
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
        got = _launches(kernels)
        require(got == {"fast_band": n_extract, "fast_nms": 0},
                f"{label} {where}: launches {got}, want fast_band {n_extract}, fast_nms 0")

    with _counted_passes() as pass_s:
        _reset_launches(kernels)
        relocalization.reset_counts()

        # (a) the steady stream, no host read in a dispatch
        sess = slam.open_stream("rgbd", CHUNK)
        warm = 1 + CHUNK
        with streaming.no_host_reads():
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
              f"{int(rows[m.kf_valid].max())}; mapping passes {len(pass_s)} (counted on the "
              f"card); relocalization attempts {attempts}")
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

        # (b) kidnapped and returned inside one batch, through the LOST
        # branches of the chunk graph (IF nodes: no replay of the lost graph)
        sg = slam.step_graph
        require(sg is not None and sg.graphed, f"{label}: the System has no CUDA StepGraph")
        lost0, chunk0 = sg.part_replays["lost"], sg.part_replays["chunk"]
        imgs = np.stack([blank] * 3 + [seq.images[20]] * 3 + [seq.images[21]] * 2)
        deps = np.stack([no_depth] * 3 + [seq.depths[20]] * 3 + [seq.depths[21]] * 2)
        with streaming.no_host_reads():
            poses = slam.track_batch_rgbd(imgs, deps, np.arange(8) / 30.0 + 10.0, chunk=CHUNK)
        attempts_b, ok_b = relocalization.counts()
        d_b = float(np.linalg.norm(_centre(poses[-3]) - _centre(own[20])))
        lost_b, chunk_b = sg.part_replays["lost"] - lost0, sg.part_replays["chunk"] - chunk0
        print(f"[{label}] (b) batch of 3 blank + 5 mapped frames: state {slam.state}, "
              f"relocalization attempts {attempts_b}, successes {ok_b} (counted on the card), "
              f"chunk-graph replays {chunk_b}, lost-graph replays {lost_b}, recovered centre "
              f"{d_b:.4f} m from the earlier estimate of frame 20")
        require(slam.state == STATE_OK, f"{label} (b): not recovered inside the batch")
        require(attempts_b >= 4 and ok_b >= 1, f"{label} (b): {attempts_b} relocalization "
                f"attempts, {ok_b} successes, want one a blank frame and a recovery")
        require(chunk_b == 2 and lost_b == 0, f"{label} (b): {chunk_b} chunk-graph and {lost_b} "
                "lost-graph replays for 2 chunks")
        require(d_b < 0.05, f"{label} (b): recovered {d_b:.4f} m away")
        n_extract += 2
        counts_ok(n_extract, "(b)")

        # (c) kidnapped and returned with per-frame calls: the lost graph in
        # the step, then the relocalization graph on the host's retry
        lost0 = sg.part_replays["lost"]
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
        prog = sg.reloc.program
        print(f"[{label}] (c) per frame, 3 blank then frame 24: state {slam.state} after "
              f"{j + 1} tries, attempts {attempts_c - attempts_b}, successes {ok_c - ok_b}, "
              f"lost-graph replays {sg.part_replays['lost'] - lost0}, relocalization-graph "
              f"replays {prog.replays if prog else 0}, recovered centre {d_c:.4f} m from the "
              "earlier estimate")
        require(slam.state == STATE_OK, f"{label} (c): not recovered")
        require(ok_c - ok_b >= 1, f"{label} (c): no relocalization success")
        require(sg.part_replays["lost"] - lost0 >= 3 and prog is not None
                and prog.graph is not None and prog.replays >= 2,
                f"{label} (c): the kidnap did not go through the lost and relocalization graphs")
        require(d_c < 0.05, f"{label} (c): recovered {d_c:.4f} m away")
        counts_ok(n_extract, "(c)")

        # one relocalization from one state, op by op against the System's
        # relocalization graph (host clock, synced both sides)
        frame_r = slam.carry.last_frame
        gen = slam._reloc_gen
        ge = torch.Generator(device="cuda")
        ge.set_state(gen.get_state())
        reloc_s, outs = {False: [], True: []}, {False: [], True: []}
        for _ in range(3):
            for graphed in (False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[graphed].append(
                    sg.reloc.relocalize(slam.map, frame_r, gen) if graphed
                    else relocalization.relocalize(slam.config, slam.map, frame_r, ge))
                torch.cuda.synchronize()
                reloc_s[graphed].append(time.perf_counter() - t0)
        worst_T, worst_inl, reloc_bitwise = 0.0, 0, True
        for e, g in zip(outs[False], outs[True]):
            require(bool(e.success) and bool(g.success), f"{label}: a timed relocalization failed")
            reloc_bitwise = reloc_bitwise and _same_tensors(e, g)
            worst_T = max(worst_T, float((e.Tcw - g.Tcw).abs().max()))
            worst_inl = max(worst_inl, abs(int(e.n_inliers) - int(g.n_inliers)))
        _, syncs_r = _count_syncs(lambda: sg.reloc.relocalize(slam.map, frame_r, gen))
        reloc_ms = {g: float(np.median(v)) * 1e3 for g, v in reloc_s.items()}
        attempts_t, _ = relocalization.counts()
        print(f"[{label}] one relocalization of a mapped frame from one state: op by op "
              f"{reloc_ms[False]:.1f} ms, graphed {reloc_ms[True]:.1f} ms (median of 3, host "
              f"clock, synced both sides; {int(outs[True][0].n_inliers)} inliers); bitwise "
              f"{reloc_bitwise}, worst Tcw {worst_T:.2e}, inliers {worst_inl}; host syncs in a "
              f"replay {sum(syncs_r.values())} {dict(syncs_r)} (sync debug mode)")
        require(reloc_bitwise or (worst_T <= GRAPH_POSE_TOL and worst_inl <= GRAPH_INLIER_TOL),
                f"{label}: the relocalization graph differs from op by op: Tcw {worst_T:.2e}, "
                f"inliers {worst_inl}")
        require(sum(syncs_r.values()) == 0,
                f"{label}: the relocalization graph made host syncs {dict(syncs_r)}")

        # (d) localization mode through the graphs, then the same frames op by
        # op on the state before them
        # (b') a LOST-then-keyframe chunk, op by op against the chunk graph
        lost3 = _lost_chunk_check(label, slam, sess, (images, depths), ts, 26)
        n_extract += lost3["tries"]

        before = (_clone_state(slam.map), _clone_state(slam.carry), slam.state,
                  slam._stream_gen.get_state(), slam._reloc_gen.get_state())
        n_kf_d, n_pt_d, n_pass_d = slam.n_keyframes(), slam.n_points(), len(pass_s)
        t0 = time.perf_counter()
        slam.activate_localization_mode()     # captures loc_core, loc_lost and loc_chunk
        torch.cuda.synchronize()
        loc_capture_s = time.perf_counter() - t0
        loc = {}
        for graphed in (True, False):
            if not graphed:
                slam.step_graph = None
                slam.map, slam.carry, slam.state = before[:3]
                slam._stream_gen.set_state(before[3])
                slam._reloc_gen.set_state(before[4])
            poses_d, secs = [], []
            for i in range(25, n_a):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                poses_d.append(slam.track_rgbd(seq.images[i], seq.depths[i], 30.0 + i / 30.0))
                secs.append(time.perf_counter() - t0)
                n_extract += 1
                require(slam.state == STATE_OK, f"{label} (d): lost at frame {i}")
            loc[graphed] = (np.stack(poses_d), float(np.median(secs)) * 1e3)
            if graphed:
                require(_same_tensors(slam.map, before[0]), f"{label} (d): the map changed")
        slam.step_graph = sg
        attempts_d, ok_d = relocalization.counts()
        worst = max(float(np.linalg.norm(_centre(T) - _centre(own[i])))
                    for i, T in zip(range(25, n_a), loc[True][0]))
        d_pose = float(np.abs(loc[True][0] - loc[False][0]).max())
        loc_bitwise = bool(np.array_equal(loc[True][0], loc[False][0]))
        loc_ms = {g: loc[g][1] for g in loc}
        print(f"[{label}] (d) localization mode, frames 25 to {n_a - 1}: state {slam.state}, "
              f"keyframes added {slam.n_keyframes() - n_kf_d}, points added "
              f"{slam.n_points() - n_pt_d}, worst centre {worst:.4f} m from the estimates of "
              f"(a), relocalization attempts {attempts_d - attempts_t}; graphed (loc_core "
              f"replays {sg.part_replays['loc_core']}, capture {loc_capture_s:.2f} s) against op "
              f"by op: poses bitwise {loc_bitwise}, worst {d_pose:.2e}; ms a frame (track_rgbd, "
              f"host clock, synced, median) graphed {loc_ms[True]:.1f}, op by op "
              f"{loc_ms[False]:.1f}")
        require(slam.n_keyframes() == n_kf_d and slam.n_points() == n_pt_d
                and len(pass_s) == n_pass_d, f"{label} (d): the map changed")
        require(sg.part_replays["loc_core"] >= n_a - 25,
                f"{label} (d): localization mode did not go through the graphs")
        require(loc_bitwise or d_pose <= GRAPH_POSE_TOL,
                f"{label} (d): graphed poses {d_pose:.2e} from op by op")
        require(worst < 0.05, f"{label} (d): {worst:.4f} m from the estimates of (a)")
        counts_ok(n_extract, "(d)")

        # (d') a kidnap inside localization mode, through loc_lost
        loc_lost0 = sg.part_replays["loc_lost"]
        for j in range(3):
            slam.track_rgbd(blank, no_depth, 40.0 + j)
            n_extract += 1
        require(slam.state == STATE_LOST, f"{label} (d'): blank frames did not lose tracking")
        for j, i in enumerate((32, 33, 34)):
            T = slam.track_rgbd(seq.images[i], seq.depths[i], 41.0 + j)
            n_extract += 1
            if slam.state == STATE_OK:
                break
        d_k = float(np.linalg.norm(_centre(T) - _centre(own[i])))
        print(f"[{label}] (d') localization mode, 3 blank frames then frame {i}: state "
              f"{slam.state} after {j + 1} tries, loc_lost replays "
              f"{sg.part_replays['loc_lost'] - loc_lost0}, recovered centre {d_k:.4f} m from the "
              f"earlier estimate; keyframes added {slam.n_keyframes() - n_kf_d}")
        require(slam.state == STATE_OK and d_k < 0.05,
                f"{label} (d'): not recovered within 0.05 m ({d_k:.4f} m)")
        require(sg.part_replays["loc_lost"] - loc_lost0 >= 4,
                f"{label} (d'): the kidnap did not go through loc_lost")
        require(slam.n_keyframes() == n_kf_d and slam.n_points() == n_pt_d,
                f"{label} (d'): the map changed")
        # (d'') a kidnap inside a localization-mode chunk, op by op against
        # the loc_chunk graph
        lost3_loc = _lost_chunk_check(label, slam, sess, (images, depths), ts, 30, loc=True)
        n_extract += lost3_loc["tries"]
        require(slam.n_keyframes() == n_kf_d and slam.n_points() == n_pt_d,
                f"{label} (d''): the map changed")
        print(f"[{label}] {_chunk_stats_note(sg)}; {_chunk_stats_note(sg, 'loc_chunk')}")
        counts_ok(n_extract, "(d'')")
        attempts_d, ok_d = relocalization.counts()
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
          f"successes {ok_d} (the 7 timed and counted calls included)")
    return n_extract, fps, ate, dict(reloc_ms=reloc_ms, reloc_syncs=sum(syncs_r.values()),
                                     loc_ms=loc_ms), other.map


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

    from self_commit_orb_slam2_tpu_torch.models import relocalization, streaming
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse

    n = len(seq.images)
    slam = System(cfg, enable_mapping=True, enable_loop_closing=False)
    require(slam.config.vocab.child_desc.is_cuda, f"{label}: the vocabulary is not on the card")
    if cfg.rect_maps is not None:
        require(all(m.is_cuda for m in slam.config.rect_maps),
                f"{label}: the rectification maps are not on the card")
    il, ir, ts = _u8(seq.images), _u8(seq.right_images), seq.timestamps
    with _counted_passes() as pass_s:
        _reset_launches(kernels)
        relocalization.reset_counts()
        sess = slam.open_stream("stereo", CHUNK)
        warm = 1 + CHUNK
        with streaming.no_host_reads():
            sess.feed((il[:warm], ir[:warm]), ts[:warm])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.feed((il[warm:n_stream], ir[warm:n_stream]), ts[warm:n_stream])
            sess.finish()
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        per_frame_s = []
        for i in range(n_stream, n):
            t0 = time.perf_counter()
            slam.track_stereo(il[i], ir[i], float(ts[i]))
            torch.cuda.synchronize()
            per_frame_s.append(time.perf_counter() - t0)
            require(slam.state == STATE_OK, f"{label}: lost at per-frame pair {i}")
        launches = _launches(kernels)
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
          f"frames/s (host clock, synced; the chunk graph, every dispatch under sync debug "
          f"mode 'error'); mapping passes {len(pass_s)} (counted on the card)"
          + (f"; track_stereo per pair: {np.mean(per_frame_s) * 1e3:.1f} ms mean over "
             f"{len(per_frame_s)}, median {np.median(per_frame_s) * 1e3:.1f} (host clock, "
             f"synced; the first captures the per-frame step graphs)" if per_frame_s else ""))
    print(f"[{label}] launches during the run: {launches}")
    require(slam.state == STATE_OK, f"{label}: tracking lost (state {slam.state})")
    require(n_kf >= 2, f"{label}: only {n_kf} keyframes")
    require(ate < ate_limit, f"{label}: ATE {ate:.6f} m >= {ate_limit} m")
    require(attempts == 0, f"{label}: {attempts} relocalization attempts in a steady run")
    require(len(pass_s) == n_kf - 1, f"{label}: {len(pass_s)} mapping passes, want {n_kf - 1}")
    want = 1 + -(-(n_stream - 1) // CHUNK) + (n - n_stream)
    require(launches == {"fast_band": want, "fast_nms": 0},
            f"{label}: launches {launches}, want fast_band {want}, fast_nms 0")
    return want, fps, ate, len(pass_s), slam


def phase_two_view():
    """initialize_two_view on the card against the CPU on one synthetic
    correspondence set (a general scene, 0.3 px of noise, 10% outliers) with
    the same minimal sets; its batched solves (float64 Jacobi) timed op by
    op and from a CUDA graph beside the library's eigh / svd."""
    import torch

    from self_commit_orb_slam2_tpu_torch.ops import se3, triangulate
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
    from self_commit_orb_slam2_tpu_torch.ops.solvers import jacobi, two_view

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
    a9, a3 = a9.double(), a3.double()
    t9 = _event_time_ms(lambda: torch.linalg.eigh(a9))
    t4 = _event_time_ms(lambda: torch.linalg.eigh(a4))
    t3 = _event_time_ms(lambda: torch.linalg.svd(a3))
    # what the solver runs instead (no host read): float64 Jacobi sweeps
    solves = {"9x9 eigh": (lambda: jacobi.extreme_eigenvector(a9, two_view.DLT_SWEEPS,
                                                               largest=False), t9),
              "4x4 eigh": (lambda: jacobi.extreme_eigenvector(a4, triangulate.DLT4_SWEEPS,
                                                               largest=False), t4),
              "3x3 svd": (lambda: jacobi.svd3(a3, two_view.SVD_SWEEPS), t3)}
    jac = {k: (_event_time_ms(f), _graph_time_ms(f), lib) for k, (f, lib) in solves.items()}
    print(f"[two-view] initialize_two_view on the card {ms:.1f} ms per call (CUDA events; host-"
          f"bound, op by op); its solves, float64 Jacobi op by op / from a CUDA graph against "
          f"the library call ({torch.backends.cuda.preferred_linalg_library()}, which reads "
          f"back to the host and cannot be captured) on the same inputs: " + "; ".join(
              f"{k} [{'256' if k != '4x4 eigh' else 8 * n}] {a:.3f} / {b:.3f} / {c:.3f} ms"
              for k, (a, b, c) in jac.items()) + " (CUDA events)")
    return ms


def phase_path5(seq, kernels, vocab):
    """Mono: the RGB-D sequence's images through track_batch_mono, in two
    calls: the first bootstraps on the per-frame path (doubled feature
    budget) and streams the rest of its 9 frames, the second streams 32."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import program_graphs, relocalization, streaming
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse

    label, first = "path 5", 1 + 2 * CHUNK
    cfg = _sensor_config("mono", WIDTH, HEIGHT, FX, 0.0, N_FEATURES, vocab,
                         max_frames_between_kf=8, kf_ref_ratio_stereo=0.8)
    slam = System(cfg, enable_mapping=True, enable_loop_closing=False)
    images, ts = _u8(seq.images[:N_MONO]), seq.timestamps[:N_MONO]
    attempt_s = []
    # the attempt replays a graph (program_graphs.MonoInitGraphs): time the
    # runner's Python method, which runs at every attempt (the first one
    # also captures)
    runner = program_graphs.MonoInitGraphs
    inner = runner.try_initialize

    def timed_try(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inner(*args, **kw)
        torch.cuda.synchronize()
        attempt_s.append(time.perf_counter() - t0)
        return res

    runner.try_initialize = timed_try
    try:
        with _counted_passes() as pass_s:
            _reset_launches(kernels)
            relocalization.reset_counts()
            slam.track_batch_mono(images[:first], ts[:first], chunk=CHUNK)
            torch.cuda.synchronize()
            require(slam.state == STATE_OK, f"{label}: no map after {first} frames")
            t0 = time.perf_counter()
            with streaming.no_host_reads():
                slam.track_batch_mono(images[first:], ts[first:], chunk=CHUNK)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = _launches(kernels)
            attempts, _ = relocalization.counts()
    finally:
        runner.try_initialize = inner
    fps = (N_MONO - first) / dt
    _, est = slam.get_trajectory()
    lag = N_MONO - len(est)
    require(np.all(np.isfinite(est)), f"{label}: non-finite poses")
    ate = float(ate_rmse(est, seq.poses_gt[lag:N_MONO], with_scale=True))
    n_kf, n_pt = slam.n_keyframes(), slam.n_points()
    print(f"[{label}] {N_MONO} frames {WIDTH}x{HEIGHT} mono, {N_FEATURES} features ("
          f"{slam._ini_config.orb.n_features} while bootstrapping), vocabulary loaded, mapping "
          f"on, chunk {CHUNK}: initialized after {lag + 1} frames ({len(attempt_s)} attempts "
          f"through MonoInitGraphs, {[round(x * 1e3, 1) for x in attempt_s]} ms, the first "
          f"with its capture; host clock, synced), state "
          f"{slam.state}, keyframes {n_kf}, points {n_pt}, Sim3-aligned ATE {ate:.6f} m, "
          f"relocalization attempts {attempts}")
    print(f"[{label}] steady stream: {N_MONO - first} frames in {dt:.3f} s = {fps:.2f} frames/s "
          f"(host clock, synced; the chunk graph, every dispatch under sync debug mode "
          f"'error'); mapping passes {len(pass_s)} (counted on the card); launches {launches}")
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
    require(slam.step_graph.replays > 0, f"{label}: the stream replayed no step graph")
    require(slam.step_graph.mono.program is not None
            and slam.step_graph.mono.program.graph is not None,
            f"{label}: the bootstrap went through no graph")
    boot = phase_bootstrap_graphs(label, cfg, images, ts)
    graphs = phase_graph(label, cfg, "mono", (images,), ts, True, vocab, slam)
    return want, fps, ate, boot, lag + 1, graphs


def phase_bootstrap_graphs(label, cfg, images, ts):
    """Path 5's bootstrap through its graphs against op by op.  Two fresh
    Systems, one through program_graphs.MonoInitGraphs (the doubled-budget
    frame build and the attempt replayed, the first of each captured on its
    first call) and one with step_graph None, per frame through
    track_monocular from the same generator seed: hard, the same frame
    initializes (within 6), Tcw, the keyframe poses and the points bitwise
    (else Tcw within 1e-3 and points within 1e-3 relative, the two-view
    bounds of tests/test_torch_two_view.py).  Then the last attempt's inputs
    3 times through the runner (replays) and 3 times op by op from one
    generator state: hard, bitwise; ms an attempt each way (host clock,
    synced; the runner's includes its one host read of (success, matches),
    as the op-by-op call's does); host syncs in a replay of the attempt's
    graph and of the frame build's (sync debug mode; hard: 0)."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import mono_init, program_graphs
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System

    label = f"{label} bootstrap"
    runner = program_graphs.MonoInitGraphs
    inner = {True: runner.try_initialize, False: mono_init.try_initialize}
    calls = {True: [], False: []}

    def spy(graphed):
        def call(*args, **kw):
            calls[graphed].append(args)
            return inner[graphed](*args, **kw)
        return call

    runs = {}
    runner.try_initialize, mono_init.try_initialize = spy(True), spy(False)
    try:
        for graphed in (True, False):
            slam = System(cfg, enable_mapping=True, enable_loop_closing=False)
            if not graphed:
                slam.step_graph = None
            i = 0
            while slam.state != STATE_OK:
                require(i < 6, f"{label}: no map after {i} frames (graphed {graphed})")
                slam.track_monocular(images[i], float(ts[i]))
                i += 1
            runs[graphed] = (i, slam)
    finally:
        runner.try_initialize, mono_init.try_initialize = inner[True], inner[False]
    (n_g, sg_sys), (n_e, e_sys) = runs[True], runs[False]
    d_T = float(np.abs(sg_sys.Tcw - e_sys.Tcw).max())
    mg, me = sg_sys.map, e_sys.map
    bitwise = (np.array_equal(sg_sys.Tcw, e_sys.Tcw) and torch.equal(mg.kf_Tcw, me.kf_Tcw)
               and torch.equal(mg.pt_pos, me.pt_pos) and torch.equal(mg.pt_valid, me.pt_valid))
    dp = (mg.pt_pos - me.pt_pos).abs() / (1e-3 * me.pt_pos.abs().clamp_min(1.0))
    d_pts = float(dp[me.pt_valid].max()) if bool(me.pt_valid.any()) else 0.0
    require(n_g == n_e, f"{label}: initialized after {n_g} frames graphed, {n_e} op by op")
    require(len(calls[True]) == len(calls[False]),
            f"{label}: {len(calls[True])} attempts graphed, {len(calls[False])} op by op")
    require(bitwise or (d_T <= 1e-3 and d_pts <= 1.0
                        and torch.equal(mg.pt_valid, me.pt_valid)),
            f"{label}: graphed against op by op: Tcw {d_T:.2e}, points at {d_pts:.3f} of the bound")

    # the last attempt's inputs, 3 times each way from one generator state
    sg, gen = sg_sys.step_graph, sg_sys._mono_gen
    m0, f1, f2, t1, t2, fid = calls[True][-1][1:7]   # [0]: the runner
    state0 = gen.get_state()
    ge = torch.Generator(device="cuda")
    ge.set_state(state0)
    secs, same = {True: [], False: []}, True
    for _ in range(3):
        got = {}
        for g in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[g] = (sg.mono.try_initialize(m0, f1, f2, t1, t2, fid, gen) if g else
                      mono_init.try_initialize(sg_sys.config, m0, f1, f2, t1, t2, fid, ge))
            torch.cuda.synchronize()
            secs[g].append(time.perf_counter() - t0)
        a, b = got[True], got[False]
        same = same and a.success == b.success and a.n_matches == b.n_matches and (
            not a.success or (_same_tensors(a.m, b.m) and _same_tensors(a.carry, b.carry)))
    require(torch.equal(gen.get_state(), ge.get_state()), f"{label}: the generators diverged")
    _, syncs_try = _count_syncs(lambda: sg.mono.program.run(gen))
    _, syncs_frame = _count_syncs(lambda: sg.mono.frame((torch.from_numpy(
        images[0].astype(np.float32)),)))
    ms = {g: float(np.median(v)) * 1e3 for g, v in secs.items()}
    syncs = sum(syncs_try.values()) + sum(syncs_frame.values())
    print(f"[{label}] per frame through track_monocular: initialized after {n_g} frames both "
          f"ways, {len(calls[True])} attempts; graphed against op by op: Tcw, keyframe poses "
          f"and points bitwise {bitwise} (Tcw {d_T:.2e}, points at {d_pts:.3f} of the bound); "
          f"the last attempt from one state, 3 calls each way: the same result bitwise {same} "
          f"(success {got[True].success}, matches {got[True].n_matches}); ms an attempt graphed "
          f"{ms[True]:.1f} / op by op {ms[False]:.1f} (host clock, synced, median); host syncs "
          f"in a replay: attempt {sum(syncs_try.values())} {dict(syncs_try)}, frame build "
          f"{sum(syncs_frame.values())} {dict(syncs_frame)}; capture of the attempt "
          f"{sg.mono.program.capture_s:.2f} s")
    require(same, f"{label}: the attempt graphed differs from op by op")
    require(syncs == 0, f"{label}: a replay made host syncs {syncs_try} {syncs_frame}")
    return dict(frames=n_g, ms=ms, syncs=syncs, bitwise=bitwise and same)


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


def _stream_loop(label, slam, seq6, kernels, ph, n=N_LOOP):
    """Stream the drifting revolution's first n frames through slam's closer: the first
    chunk with the initializing frame, then a chunk per feed with drift
    injected between feeds (frames DRIFT_FROM to DRIFT_TO) and a poll after
    each, every launch and relocalization count set to 0 first.  Returns
    the chunk times (host clock, synced), the chunks in which a closure
    landed (with the counts of the phase calls in `ph`, the closer's timed
    phases, before it), the launches, both ATEs and the closer's counters."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import relocalization
    from self_commit_orb_slam2_tpu_torch.utils.drift import make_injector, se3_increment
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse

    lc = slam._loop_closer
    images, depths = _u8(seq6.images), np.clip(seq6.depths * 1e3, 0, 65535).astype(np.uint16)
    ts = seq6.timestamps
    inject = make_injector(keep_recent=6)
    dD = torch.linalg.matrix_power(se3_increment(DRIFT_TWIST).double(), CHUNK).float().cuda()
    _reset_launches(kernels)
    relocalization.reset_counts()
    sess = slam.open_stream("rgbd", CHUNK)
    t_start = time.perf_counter()
    sess.feed((images[:1 + CHUNK], depths[:1 + CHUNK]), ts[:1 + CHUNK])
    torch.cuda.synchronize()
    done, chunk_ms, events = 1 + CHUNK, [], []
    while done < n:
        t0 = time.perf_counter()
        sl = slice(done, min(done + CHUNK, n))
        sess.feed((images[sl], depths[sl]), ts[sl])
        done = sl.stop
        if DRIFT_FROM <= done <= DRIFT_TO:
            slam.map = inject(slam.map, dD, 1.0)
        sess.poll()
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        while lc.n_big_changes > len(events):   # one entry a closure
            events.append((len(chunk_ms) - 1, done, {k: len(v) for k, v in ph.items()}))
    t0 = time.perf_counter()
    sess.finish()
    torch.cuda.synchronize()
    chunk_ms.append((time.perf_counter() - t0) * 1e3)
    stream_s = time.perf_counter() - t_start
    launches = _launches(kernels)
    attempts, _ = relocalization.counts()
    _, est = slam.get_trajectory()
    raw = np.stack([T for _, T in slam.trajectory])
    gt = seq6.poses_gt[:n]
    require(len(est) == n and np.all(np.isfinite(est)), f"{label}: bad trajectory")
    return dict(chunk_ms=chunk_ms, events=events, stream_s=stream_s, launches=launches,
                attempts=attempts, closures=lc.n_big_changes, gba_info=dict(lc.last_gba_info),
                ate=float(ate_rmse(est, gt)), ate_raw=float(ate_rmse(raw, gt)))


def _b1_on_loop_frames(label, seq6, orb, at: int = 113):
    """B1 on a path's first frame and its chunk at frame `at` (113: where
    path 6 closes), bitwise against its plain version."""
    from self_commit_orb_slam2_tpu_torch.ops.orb import fast_band
    from self_commit_orb_slam2_tpu_torch.tools.time_fast import frames_slab

    images = _u8(seq6.images)
    for what, frames in (("first frame", images[:1]),
                         (f"chunk at frame {at}", images[at:at + CHUNK])):
        slab, H0p, dims = frames_slab(frames, orb, band=True)
        args = (orb.fast_threshold_hi, orb.fast_threshold_lo, H0p, dims, orb.border, orb.n_levels)
        out_k = fast_band.fast_nms_bands_hi_lo(slab, *args)
        _check_kernel("fast_band", f"{label} {what}", out_k,
                      fast_band.fast_bands_plain(slab, *args), int((out_k[2] > 0).sum()))


def phase_path6(seq6, kernels, vocab):
    """The default operating point with loop closing on, streamed; then one
    per-frame closure; then the loop stages on the card against the CPU."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import (loop_closing, pipeline, relocalization,
                                                         streaming)
    from self_commit_orb_slam2_tpu_torch.models.system import (
        STATE_NOT_INITIALIZED, STATE_OK, System)
    from self_commit_orb_slam2_tpu_torch.utils.drift import displace_old_content, se3_increment

    label = "path 6"
    cfg = _bench_config(vocab)
    slam = System(cfg)
    lc = slam._loop_closer
    require(lc is not None and lc.enabled and cfg.tracking.enable_loop_gba
            and cfg.tracking.loop_consistency_th == 3, f"{label}: System(cfg) built no closer")
    _b1_on_loop_frames(label, seq6, cfg.orb)
    # as bench.py does (bench.py:122-123): the closer's graphs are captured
    # here, on throwaway state, and the stream replays them
    t0 = time.perf_counter()
    slam.warm_start()
    warm_s = time.perf_counter() - t0

    # the first correction's inputs, for the card / CPU check: the closer
    # hands them to its correction graph (whose replays run no Python)
    captured = {}
    cg = slam.step_graph.closer
    graph_correct = cg.correct

    def spy_correct(m, slot, det):
        captured.setdefault("correct", (_to(m, "cpu"), torch.tensor(slot, dtype=torch.int32),
                                        _to(det, "cpu")))
        return graph_correct(m, slot, det)

    cg.correct = spy_correct
    try:
        with loop_closing.timed_phases() as ph, _counted_passes() as pass_s:
            with streaming.no_host_reads():
                run = _stream_loop(label, slam, seq6, kernels, ph)
            stream_log = list(lc.debug_log)
            chunk_ms, events, stream_s, launches = (run[k] for k in (
                "chunk_ms", "events", "stream_s", "launches"))
            attempts, n_stream_closures, gba_info = (run[k] for k in (
                "attempts", "closures", "gba_info"))
            stream_ph = {k: list(v) for k, v in ph.items()}
            changed = [slam.map_changed(), slam.map_changed()]
            ate, ate_raw = run["ate"], run["ate_raw"]
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
            launches_all = _launches(kernels)
            attempts_all, _ = relocalization.counts()
    finally:
        cg.correct = graph_correct
    if "correct" in captured:   # the pose graph's inputs, from that correction op by op
        orig_graph = loop_closing.optimize_pose_graph

        def spy_graph(*args, **kw):
            captured.setdefault("graph", ([a.cpu() for a in args], kw))
            return orig_graph(*args, **kw)

        loop_closing.optimize_pose_graph = spy_graph
        try:
            m0, kf0, det0 = captured["correct"]
            loop_closing.correct_loop(slam.config, _to(m0, "cuda"), kf0.cuda(), _to(det0, "cuda"))
        finally:
            loop_closing.optimize_pose_graph = orig_graph

    n_timed = N_LOOP - 1 - CHUNK
    fps = N_LOOP / stream_s
    med = float(np.median(chunk_ms[4:]))
    print(f"[{label}] {N_LOOP} frames {WIDTH}x{HEIGHT} of a {LOOP_REV}-frame circle revolution, "
          f"System(cfg) defaults (loop closing, global BA, consistency 3), chunk {CHUNK}, drift "
          f"frames {DRIFT_FROM} to {DRIFT_TO}: state {slam.state}, keyframes {n_kf} ({n_live} live "
          f"of {cfg.caps.max_keyframes}), points {n_pt}, closures {n_stream_closures}, map_changed "
          f"{changed}, last GBA {gba_info}; ATE corrected {ate:.6f} m, raw per-frame "
          f"{ate_raw:.6f} m; relocalization attempts {attempts}; launches {launches}")
    print(f"[{label}] warm_start {warm_s:.2f} s before the stream (the closer's, the frame "
          f"phase's and the step's captures)")
    print(f"[{label}] stream {stream_s:.3f} s = {fps:.2f} frames/s (host clock, synced per chunk); "
          f"median chunk {med:.1f} ms; mapping passes {len(pass_s)} (counted on the card; every "
          f"dispatch under sync debug mode 'error'); {n_timed} frames after the first chunk")
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
    stages.update(phase_loop_graphs(slam, captured))
    # a LOST-then-keyframe chunk on the closer's System, op by op against
    # the chunk graph, on the revolution's frames after the per-frame part
    images6 = _u8(seq6.images)
    depths6 = np.clip(seq6.depths * 1e3, 0, 65535).astype(np.uint16)
    stages["lost"] = _lost_chunk_check(label, slam, slam.open_stream("rgbd", CHUNK),
                                       (images6, depths6), seq6.timestamps, n_pf)
    print(f"[{label}] {_chunk_stats_note(slam.step_graph)}")

    # the same stream with the closer op by op (its graphs off, the step's on):
    # the same closures at the same frames
    slam_e = System(cfg)
    slam_e._loop_closer.graphs = None
    slam_e.warm_start()
    with loop_closing.timed_phases() as ph_e:
        run_e = _stream_loop(label, slam_e, seq6, kernels, ph_e)
    frames_g = [f for _, f, _ in events]
    frames_e = [f for _, f, _ in run_e["events"]]
    med_e = float(np.median(run_e["chunk_ms"][4:]))
    stalls_e = [float(np.max(run_e["chunk_ms"][max(c - 1, 0): c + 3]) - med_e)
                for c, _, _ in run_e["events"]]
    print(f"[{label}] the stream again with the closer op by op: {run_e['closures']} closures at "
          f"frames {frames_e} (graphed: {n_stream_closures} at {frames_g}); "
          f"{N_LOOP / run_e['stream_s']:.2f} frames/s; stalls {[round(x, 1) for x in stalls_e]} "
          f"ms; " + "; ".join(f"{k} {len(v)} calls, mean {np.mean(v):.1f} ms"
                              for k, v in ph_e.items())
          + f"; ATE {run_e['ate']:.6f} m (graphed {ate:.6f} m)")
    for what, log in (("graphed", stream_log), ("op by op", slam_e._loop_closer.debug_log)):
        print(f"[{label}] verified detections in the stream, {what} (keyframe counter, chain, "
              f"Sim3 inliers, projections): " + str([
                  (d["kf_counter"], d["chain"], d["n_inliers"], d["n_proj"]) for d in log
                  if d["found"]]))
    require(run_e["closures"] == n_stream_closures and frames_e == frames_g,
            f"{label}: the closer op by op closed at {frames_e}, graphed at {frames_g}")
    stages.update(eager_ph=ph_e, eager_fps=N_LOOP / run_e["stream_s"], eager_stalls=stalls_e)
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
    sets_c = sets.cuda()
    d_card, det_syncs = _count_syncs(
        lambda: loop_closing.detect_and_verify(cfg, m_c, kf_c, sets=sets_c))
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
    require(sum(det_syncs.values()) == 0 and sum(corr_syncs.values()) == 0,
            f"{label}: detect_and_verify or correct_loop made the host wait: {det_syncs} "
            f"{corr_syncs}")

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


def phase_loop_graphs(slam, captured):
    """Path 6's graph phase: detection and correction through the stream's
    own closer graphs (models/program_graphs.py) against the same calls op
    by op, from the first closure's captured state on the card.  Detection:
    3 calls each way from one generator state (the graph's registered
    generator, an eager copy of its state): hard, bitwise.  Correction: 3
    calls each way from the same inputs: hard, bitwise or within the card
    against CPU bounds of phase_loop_stages (bitwise expected: the
    scatter-adds run in a fixed order on the card); the op-by-op run against
    itself is printed as the noise floor.  ms per call each way (host clock, synced), host syncs per
    call (sync debug mode; hard: 0 graphed), and optimize_pose_graph alone
    and the correction's replay under torch.profiler: device kernels, busy
    time and the top device operators."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from self_commit_orb_slam2_tpu_torch.models import loop_closing
    from self_commit_orb_slam2_tpu_torch.ops.optim.pose_graph import optimize_pose_graph
    from self_commit_orb_slam2_tpu_torch.utils.profiling import trace_counts

    label = "path 6 graphs"
    cfg, cg, gen = slam.config, slam.step_graph.closer, slam._loop_gen
    m, kf, det0 = (_to(x, "cuda") if not torch.is_tensor(x) else x.cuda()
                   for x in captured["correct"])
    slot = int(kf)
    require(cg.detect_program is not None and cg.detect_program.graph is not None
            and cg.correct_program is not None and cg.correct_program.graph is not None,
            f"{label}: the stream captured no closer graph")
    r0 = (cg.detect_program.replays, cg.correct_program.replays)
    state0 = gen.get_state()
    ge = torch.Generator(device="cuda")
    ge.set_state(state0)
    ms, bitwise = {"detect": {}, "correct": {}}, True

    def timed(fn, reps=3):
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            outs.append(fn())
        torch.cuda.synchronize()
        return outs, (time.perf_counter() - t0) / reps * 1e3

    de, ms["detect"][False] = timed(lambda: loop_closing.detect_and_verify(cfg, m, kf, ge))
    dg, ms["detect"][True] = timed(lambda: cg.detect(m, slot, gen))
    bitwise = all(_same_tensors(a, b) for a, b in zip(de, dg))
    _, syncs_de = _count_syncs(lambda: loop_closing.detect_and_verify(cfg, m, kf, ge))
    _, syncs_dg = _count_syncs(lambda: cg.detect(m, slot, gen))
    require(torch.equal(ge.get_state(), gen.get_state()), f"{label}: the generators diverged")
    gen.set_state(state0)

    me, ms["correct"][False] = timed(lambda: loop_closing.correct_loop(cfg, m, kf, det0))
    mg, ms["correct"][True] = timed(lambda: cg.correct(m, slot, det0))
    _, syncs_ce = _count_syncs(lambda: loop_closing.correct_loop(cfg, m, kf, det0))
    _, syncs_cg = _count_syncs(lambda: cg.correct(m, slot, det0))

    def diff(a, b):
        dT = float((a.kf_Tcw - b.kf_Tcw).abs().max())
        dp = (a.pt_pos - b.pt_pos).abs()
        rel = float((dp / (2e-3 + 1e-3 * b.pt_pos.abs())).max())
        obs = float((a.kf_obs_pt == b.kf_obs_pt).float().mean())
        return dT, rel, obs

    noise = diff(me[1], me[0])
    worst = max((diff(g, me[0]) for g in mg), key=lambda d: (d[0], d[1], -d[2]))
    c_bitwise = all(_same_tensors(g, me[0]) for g in mg)

    args, kw = captured["graph"]
    args = [a.cuda() for a in args]
    optimize_pose_graph(*args, **kw)
    prof_rows = {}
    for what, fn in (("optimize_pose_graph op by op", lambda: optimize_pose_graph(*args, **kw)),
                     ("correction replay", lambda: cg.correct(m, slot, det0))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        c = trace_counts(prof, wall)
        top = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)[:6]
        prof_rows[what] = c
        print(f"[{label}] {what} under torch.profiler: wall {wall * 1e3:.1f} ms, device busy "
              f"{c['busy_ms']:.2f} ms, {c['kernels']:.0f} device kernels, idle share "
              f"{c['idle']:.3f}; top device operators: " + "; ".join(
                  f"{e.key} {e.self_device_time_total / 1e3:.2f} ms x{e.count}" for e in top))
    replays = (cg.detect_program.replays - r0[0], cg.correct_program.replays - r0[1])
    print(f"[{label}] detection from the first closure's state (keyframe {slot}): op by op "
          f"{ms['detect'][False]:.1f} / graphed {ms['detect'][True]:.1f} ms per call (host "
          f"clock, synced, 3 calls), bitwise {bitwise}, found {bool(dg[0].found)}; host syncs "
          f"per call {sum(syncs_de.values())} {dict(syncs_de)} / {sum(syncs_dg.values())} "
          f"{dict(syncs_dg)}; capture {cg.detect_program.capture_s:.2f} s")
    print(f"[{label}] correction: op by op {ms['correct'][False]:.1f} / graphed "
          f"{ms['correct'][True]:.1f} ms per call; bitwise {c_bitwise}; graphed against op by "
          f"op: max |pose difference| {worst[0]:.2e}, points at {worst[1]:.3f} of the bound, "
          f"observations equal on {worst[2]:.5f}; op by op against itself {noise[0]:.2e}, "
          f"{noise[1]:.3f}, {noise[2]:.5f}; host syncs per call {sum(syncs_ce.values())} "
          f"{dict(syncs_ce)} / {sum(syncs_cg.values())} {dict(syncs_cg)}; capture "
          f"{cg.correct_program.capture_s:.2f} s; replays here {replays}")
    require(bitwise, f"{label}: detection graphed differs from op by op")
    require(c_bitwise or (worst[0] <= 1e-3 and worst[1] <= 1.0 and worst[2] >= 0.999),
            f"{label}: correction graphed differs from op by op: {worst}")
    require(sum(syncs_dg.values()) == 0 and sum(syncs_cg.values()) == 0,
            f"{label}: a replay made host syncs: {syncs_dg} {syncs_cg}")
    gba = _gba_graphed_vs_eager(label, cfg, cg, me[0], int(det0.cand_kf))
    return dict(graph_detect_ms=ms["detect"], graph_correct_ms=ms["correct"],
                graph_syncs=(sum(syncs_de.values()), sum(syncs_ce.values()),
                             sum(syncs_dg.values()), sum(syncs_cg.values())),
                prof=prof_rows, gba=gba)


def _gba_graphed_vs_eager(label, cfg, cg, mc, anchor):
    """The ten GBA slices (GBA_SLICES) and the merge from the first
    closure's corrected map `mc` (anchored at the loop keyframe), op by op
    and through the stream's closer programs (load_gba, gba_slice, merge):
    hard, bitwise, else poses within 1e-3 and points within 2e-3 m + 1e-3
    relative on >= 99.9% of coordinates (the card against the CPU bounds of
    a mapping pass; the BA's scatter-add runs in a fixed order, so bitwise
    is what the card should give, and the reason is printed if not).  The merge folds the result into mc with
    one keyframe's seq marked as newer than the snapshot (its pose goes
    through the spanning tree).  ms a slice (each) and a merge each way
    (host clock, synced); host syncs in a slice's and the merge's replay
    (sync debug mode; hard: 0)."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import loop_closing

    label = f"{label} GBA"
    snap_seq = mc.kf_seq.clone()
    newest = int(torch.argmax(torch.where(mc.kf_valid, mc.kf_seq, -1)))
    snap_seq[newest] = 1 << 20
    out, secs = {}, {}
    for graphed in (False, True):
        T, p = mc.kf_Tcw.clone(), mc.pt_pos.clone()
        if graphed:
            cg.load_gba(mc, anchor)
        times = []
        for huber in loop_closing.GBA_SLICES:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if graphed:
                T, p = cg.gba_slice(T, p, huber)
            else:
                T, p = loop_closing.global_bundle_adjust_slice(cfg, mc, T, p, anchor, huber)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merged = (cg.merge(mc, snap_seq, mc.pt_birth, T, p) if graphed
                  else loop_closing.merge_gba(mc, snap_seq, mc.pt_birth, T, p))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        out[graphed], secs[graphed] = (T, p, merged), times
    (Te, pe, me), (Tg, pg, mg) = out[False], out[True]
    bitwise = _same_tensors((Te, pe, me), (Tg, pg, mg))
    dT = float((mg.kf_Tcw - me.kf_Tcw).abs().max())
    close = (mg.pt_pos - me.pt_pos).abs() <= 2e-3 + 1e-3 * me.pt_pos.abs()
    share = float(close.float().mean())
    T1, p1 = cg.gba_slice(Te, pe, True)
    _, syncs_s = _count_syncs(lambda: cg.gba_slice(T1, p1, False))
    _, syncs_m = _count_syncs(lambda: cg.merge(mc, snap_seq, mc.pt_birth, Te, pe))
    moved = float((me.kf_Tcw - mc.kf_Tcw).abs().max())
    ms = {g: dict(slices=v[:-1], merge=v[-1]) for g, v in secs.items()}
    print(f"[{label}] from the first closure's corrected map, anchored at keyframe {anchor}: "
          f"ms a slice op by op {[round(x, 1) for x in ms[False]['slices']]} / graphed "
          f"{[round(x, 1) for x in ms[True]['slices']]}; merge {ms[False]['merge']:.1f} / "
          f"{ms[True]['merge']:.1f} ms (host clock, synced; the graphed merge copies the map "
          f"into its static buffers first); graphed against op by op: bitwise {bitwise}, max "
          f"|pose difference| {dT:.2e}, points within bounds on {share:.5f}"
          + ("" if bitwise else " (not bitwise: the BA's sums ran in another order)")
          + f"; the GBA moved poses by up to {moved:.3e}; host syncs in a replay: slice "
          f"{sum(syncs_s.values())} {dict(syncs_s)}, merge {sum(syncs_m.values())} "
          f"{dict(syncs_m)}; captures {[round(pr.capture_s, 2) for pr in cg.programs]} s")
    require(bitwise or (dT <= 1e-3 and share >= 0.999),
            f"{label}: graphed against op by op: poses {dT:.2e}, points within bounds on {share}")
    require(moved > 1e-4, f"{label}: the GBA moved nothing")
    require(sum(syncs_s.values()) == 0 and sum(syncs_m.values()) == 0,
            f"{label}: a replay made host syncs: {syncs_s} {syncs_m}")
    return dict(ms=ms, bitwise=bitwise, syncs=sum(syncs_s.values()) + sum(syncs_m.values()))


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

    _reset_launches(kernels)
    decodes = dict(datasets.DECODES)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run_slam.main(argv)
    text = out.getvalue()
    launches = _launches(kernels)
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


def _per_frame_graphed_vs_eager(label, cfg, frames):
    """frames [(image, depth in metres, timestamp)] through track_rgbd in a
    fresh System(cfg) through its graphs (the frame build, then the step)
    and in one with step_graph None: hard, poses bitwise (else within
    GRAPH_POSE_TOL); ms a frame each way (host clock, synced, median over
    the frames after the second, the first being the map's initialization
    and the second the captures).  Returns the graphed System and the ms."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models.system import System

    out = {}
    for graphed in (True, False):
        slam = System(cfg)
        if not graphed:
            slam.step_graph = None
        poses, secs = [], []
        for image, depth, t in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            poses.append(slam.track_rgbd(image, depth, t))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        out[graphed] = (np.stack(poses), float(np.median(secs[2:])) * 1e3, slam)
    bitwise = bool(np.array_equal(out[True][0], out[False][0]))
    d = float(np.abs(out[True][0] - out[False][0]).max())
    ms = {g: out[g][1] for g in out}
    progs = out[True][2].step_graph.frames.single_programs
    print(f"[{label}] per frame, {len(frames)} frames through track_rgbd: graphed (the frame "
          f"build's {sum(p.replays for p in progs)} replays, then the step's) "
          f"{ms[True]:.1f} / op by op {ms[False]:.1f} ms a frame (host clock, synced, median); "
          f"poses bitwise {bitwise}, worst {d:.2e}")
    require(bitwise or d <= GRAPH_POSE_TOL, f"{label}: per-frame poses graphed {d:.2e} from op "
            f"by op")
    require(sum(p.replays for p in progs) >= len(frames) - 2,
            f"{label}: the per-frame frame build replayed no graph")
    return out[True][2], ms


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
    # the same 13 decoded frames through track_rgbd, graphed and op by op (as
    # run_slam reads them: depth in metres)
    tum_cfg = load_settings(tum_yaml, sensor="rgbd", vocab=vocab)
    ds13 = datasets.TumRgbdDataset(tum13, depth_factor=1.0 / tum_cfg.depth_map_factor)
    tum_cfg = tum_cfg._replace(depth_map_factor=1.0)
    _, rows["per frame ms"] = _per_frame_graphed_vs_eager(
        label, tum_cfg, [(ds13[i].image, ds13[i].depth, float(ds13[i].timestamp))
                         for i in range(N_TUM_PER_FRAME)])

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

    _reset_launches(kernels)
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
    launches = _launches(kernels)
    b1 += launches["fast_band"]
    poses_out.seek(0)
    recs = []
    while (rec := stream_slam.read_pose(poses_out)) is not None:
        recs.append(rec)
    # the same frames as the wire carries them, through track_rgbd on the card,
    # graphed and op by op
    buf = io.BytesIO()
    for i in range(N_SERVE):
        stream_slam.write_frame(buf, "rgbd", float(seq.timestamps[i]), seq.images[i],
                                seq.depths[i])
    buf.seek(0)
    wire = []
    while (fr := stream_slam.read_frame(buf)) is not None:
        wire.append((*fr[2], fr[1]))
    ref, rows["serve per frame ms"] = _per_frame_graphed_vs_eager(label, cfg, wire)
    want = [T for _, T in ref.trajectory]
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

# ---------------------------------------------------------------- path 8
# The multi-device layer on the one card (a world of one rank): a loop
# closure at run_slam's TUM capacities takes the sharded global BA;
# refine_maps on that map and a perturbed copy; a FleetTracker serving 4
# RGB-D streams, then 2 localization streams on path 3's saved map; NCCL
# at a world of one rank.
N_FLEET, N_FLEET_FRAMES, FLEET_SEED = 4, 9, 5   # 25 frames until PR 14
# (a) streams path 6's 184 frames (cut to 157 while the steps ran op by op, to
# keep the script inside the 1200 s the chip check allows)
N_LOOP_8A = 184
PERTURB_SIGMA = 5e-3


def _peak_timed(fn):
    """fn() with the card synced on both sides: (result, ms on the host
    clock, the most bytes allocated on the card during the call)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated()


def _gba_bound_ms(K: int, P: int, n_iters: int) -> float:
    """Least time of the sharded GBA's dense Schur products alone: per
    iteration [6K, 3P] @ [3P, 6K] (2 * 36 K^2 * 3P fp32 operations) at the
    card's fp32 peak."""
    return n_iters * 2.0 * (6 * K) ** 2 * 3 * P / PEAK_FP32_PER_S * 1e3


def phase_path8a(seq6, kernels, vocab):
    """Path 6's scenario at run_slam's TUM capacities (the port's default
    Capacities(), 256 / 65536 / 2048): every closure's global BA takes the
    sharded branch (max_kf * max_pt > 4 Mi) and is merged."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import loop_closing, pipeline
    from self_commit_orb_slam2_tpu_torch.models.config import Capacities
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System

    label = "path 8a"
    cfg = _bench_config(vocab)._replace(caps=Capacities())
    slam = System(cfg)
    lc = slam._loop_closer
    require(lc is not None and lc.enabled, f"{label}: System(cfg) built no closer")
    require(loop_closing._needs_sharded_gba(slam.config, slam.map),
            f"{label}: {cfg.caps.max_keyframes} x {cfg.caps.max_points} takes the dense GBA")
    _b1_on_loop_frames(label, seq6, cfg.orb)
    slam.warm_start()   # as bench.py does: the captures before the stream
    gba = []
    orig = loop_closing.run_sharded_gba

    inputs = []

    def timed_gba(config, m, anchor_kf):
        if not inputs:
            inputs.append((config, _clone_state(m), anchor_kf))
        out, ms, peak = _peak_timed(lambda: orig(config, m, anchor_kf))
        require(all(bool(torch.isfinite(x).all()) for x in out), f"{label}: non-finite GBA")
        gba.append((ms, peak))
        return out

    loop_closing.run_sharded_gba = timed_gba
    try:
        with loop_closing.timed_phases() as ph, _counted_passes() as pass_s:
            run = _stream_loop(label, slam, seq6, kernels, ph, N_LOOP_8A)
    finally:
        loop_closing.run_sharded_gba = orig
    chunk_ms, launches = run["chunk_ms"], run["launches"]
    fps = N_LOOP_8A / run["stream_s"]
    med = float(np.median(chunk_ms[4:]))
    stalls = [float(np.max(chunk_ms[max(c - 1, 0): c + 3]) - med) for c, _, _ in run["events"]]
    K, P = cfg.caps.max_keyframes, cfg.caps.max_points
    bound = _gba_bound_ms(K, P, 10)
    print(f"[{label}] {N_LOOP_8A} frames of path 6's drifting revolution at run_slam's TUM "
          f"capacities {K} / {P} / {cfg.caps.local_points}: state {slam.state}, keyframes "
          f"{slam.n_keyframes()} ({int(slam.map.kf_valid.sum())} live), points "
          f"{slam.n_points()}, closures {run['closures']} (frames "
          f"{[f for _, f, _ in run['events']]}), last GBA {run['gba_info']}; ATE corrected "
          f"{run['ate']:.6f} m, raw per-frame {run['ate_raw']:.6f} m; relocalization attempts "
          f"{run['attempts']}; launches {launches}")
    print(f"[{label}] stream {run['stream_s']:.3f} s = {fps:.2f} frames/s (host clock, synced "
          f"per chunk), median chunk {med:.1f} ms, mapping passes {len(pass_s)}")
    for name, v in ph.items():
        print(f"[{label}] {name}: {len(v)} calls, mean {np.mean(v):.1f} ms, max "
              f"{np.max(v):.1f} ms (host clock, synced)")
    for (ms, peak), stall in zip(gba, stalls):
        print(f"[{label}] sharded global BA (10 Huber iterations, 1 x 1 mesh, dense [{6 * K}, "
              f"{3 * P}] cross block): {ms:.1f} ms (host clock, synced), peak "
              f"{peak / 2**30:.3f} GiB allocated on the card during it; its Schur products' "
              f"least time {bound:.1f} ms at {PEAK_FP32_PER_S / 1e12:.0f} TFLOP/s; the closure "
              f"stalled the stream {stall:.1f} ms over the median chunk (worst chunk of the 4 "
              "around it, bench.py's measure)")
    require(slam.state == STATE_OK, f"{label}: tracking lost")
    require(run["closures"] >= 1, f"{label}: no loop closed in the stream")
    require(len(gba) >= 1 and run["gba_info"].get("gba_path") == "sharded",
            f"{label}: no sharded global BA merged ({len(gba)} run, {run['gba_info']})")
    require(run["ate"] < run["ate_raw"], f"{label}: corrected ATE {run['ate']:.6f} m not below "
            f"raw {run['ate_raw']:.6f} m")
    require(run["attempts"] == 0, f"{label}: {run['attempts']} relocalization attempts")
    want = 1 + -(-(N_LOOP_8A - 1) // CHUNK)
    require(launches == {"fast_band": want, "fast_nms": 0},
            f"{label}: launches {launches}, want fast_band {want}, fast_nms 0")
    repeat = _gba_repeats(label, orig, *inputs[0])
    return dict(launches=want, fps=fps, ate=run["ate"], ate_raw=run["ate_raw"],
                closures=run["closures"], gba_ms=gba[0][0], gba_peak=gba[0][1],
                stall=stalls[0], bound=bound, repeat=repeat), cfg, slam.map


def _gba_repeats(label, gba_fn, config, m, anchor_kf):
    """The sharded GBA from one state twice with its scatter-adds in a fixed
    order (indexing.index_add_fixed, as the program runs it): bitwise equal,
    hard; then twice with them as plain index_add_ (patched in here, for the
    comparison only): the ms of each run (host clock, synced)."""
    from self_commit_orb_slam2_tpu_torch.parallel import distributed_ba

    def twice():
        runs = [_peak_timed(lambda: gba_fn(config, m, anchor_kf)) for _ in range(2)]
        return [r[1] for r in runs], _same_tensors(runs[0][0], runs[1][0])

    fixed_ms, fixed_same = twice()
    orig = distributed_ba.index_add_fixed
    distributed_ba.index_add_fixed = lambda t, dim, i, src: t.index_add_(dim, i, src)
    try:
        plain_ms, plain_same = twice()
    finally:
        distributed_ba.index_add_fixed = orig
    print(f"[{label}] the sharded GBA twice more from its first call's inputs: scatter-adds in "
          f"a fixed order {fixed_ms[0]:.1f}, {fixed_ms[1]:.1f} ms, bitwise {fixed_same}; as "
          f"plain index_add_ (before this repair) {plain_ms[0]:.1f}, {plain_ms[1]:.1f} ms, "
          f"bitwise {plain_same} (host clock, synced)")
    require(fixed_same, f"{label}: two sharded GBAs from one state differ")
    return dict(fixed_ms=fixed_ms, plain_ms=plain_ms, plain_same=plain_same)


def _mean_reproj_err(cam, m) -> float:
    """Mean squared reprojection error (px^2) over a map's live
    observations in front of the camera (tests/test_parallel.py's measure)."""
    import torch

    from self_commit_orb_slam2_tpu_torch.ops.camera import project

    pid = torch.clamp(m.kf_obs_pt, 0, m.max_pt - 1).long()
    active = (m.kf_obs_pt >= 0) & m.kf_feat_valid & m.kf_valid[:, None] & m.pt_valid[pid]
    pc = torch.einsum("kij,knj->kni", m.kf_Tcw[:, :3, :3], m.pt_pos[pid]) \
        + m.kf_Tcw[:, None, :3, 3]
    uv, z = project(cam, pc)
    w = (active & (z > 0.05)).to(torch.float32)
    return float(torch.sum(torch.sum((uv - m.kf_xy) ** 2, -1) * w) / torch.clamp_min(w.sum(), 1))


def phase_path8b(cfg, m, workdir):
    """refine_maps on the card: (a)'s final map and a copy with keyframe
    poses and points perturbed by N(0, 5e-3) (tests/test_parallel.py:
    198-232), S = 2 maps at (a)'s capacities, through the CLI's main."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models.checkpoint import load_map, save_map
    from self_commit_orb_slam2_tpu_torch.ops import se3
    from self_commit_orb_slam2_tpu_torch.parallel import multi_map
    from self_commit_orb_slam2_tpu_torch.refine_maps import main as refine_main

    label = "path 8b"
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.normal(0, PERTURB_SIGMA, (m.max_kf, 6)).astype(np.float32))
    kf = se3.update_left(m.kf_Tcw, noise.cuda())
    kf[0] = m.kf_Tcw[0]
    pt = m.pt_pos + torch.from_numpy(
        rng.normal(0, PERTURB_SIGMA, tuple(m.pt_pos.shape)).astype(np.float32)).cuda()
    paths = [os.path.join(workdir, "loop.npz"), os.path.join(workdir, "loop_perturbed.npz")]
    save_map(paths[0], m)
    save_map(paths[1], m._replace(kf_Tcw=kf, pt_pos=pt))
    yml = _settings(os.path.join(workdir, "TUM1.yaml"), WIDTH, HEIGHT, FX, 0.1, N_FEATURES, 30)
    timed = {"pose graph": [], "bundle adjustment": []}
    orig = multi_map.distributed_pose_graph, multi_map.distributed_bundle_adjust

    def timing(name, fn):
        def run(*a, **kw):
            out, ms, peak = _peak_timed(lambda: fn(*a, **kw))
            timed[name].append((ms, peak))
            return out
        return run

    multi_map.distributed_pose_graph = timing("pose graph", orig[0])
    multi_map.distributed_bundle_adjust = timing("bundle adjustment", orig[1])
    try:
        t0 = time.perf_counter()
        rc = refine_main(paths + ["--settings", yml, "--mesh", "1x1"])
        wall = time.perf_counter() - t0
    finally:
        multi_map.distributed_pose_graph, multi_map.distributed_bundle_adjust = orig
    require(rc == 0, f"{label}: refine_maps returned {rc}")
    before = [_mean_reproj_err(cfg.camera, load_map(p)) for p in paths]
    after = [_mean_reproj_err(cfg.camera, load_map(p[:-4] + ".refined.npz")) for p in paths]
    print(f"[{label}] refine_maps.main, 2 maps of {m.max_kf} x {m.max_pt} on a 1x1 mesh, "
          f"{wall:.1f} s in all: mean squared reprojection error (px^2) {before[0]:.4f} -> "
          f"{after[0]:.4f} ((a)'s map), {before[1]:.4f} -> {after[1]:.4f} (perturbed by "
          f"N(0, {PERTURB_SIGMA}))")
    for name, v in timed.items():
        print(f"[{label}] {name}: {[round(ms, 1) for ms, _ in v]} ms per map (host clock, "
              f"synced), peak {max(p for _, p in v) / 2**30:.3f} GiB allocated on the card")
    require(after[1] < 0.2 * before[1], f"{label}: the perturbed map refined only from "
            f"{before[1]:.4f} to {after[1]:.4f}")
    require(after[0] <= before[0],
            f"{label}: (a)'s map rose from {before[0]:.4f} to {after[0]:.4f}")
    return dict(pg_ms=[ms for ms, _ in timed["pose graph"]],
                ba_ms=[ms for ms, _ in timed["bundle adjustment"]],
                peak=max(p for v in timed.values() for _, p in v), before=before, after=after)


def _fleet_stream(fleet, fleet_seqs, graphed: bool):
    """One FleetTracker run over the N_FLEET streams (graphed: its runners;
    else step_graphs = None, op by op): (poses [S, F, 4, 4] with frame 0's
    identity, seconds in all, seconds after the first chunk, chunks)."""
    import torch

    if not graphed:
        fleet.step_graphs = None
    arr = lambda f, sl: np.stack([getattr(q, f)[sl] for q in fleet_seqs])  # noqa: E731
    t0 = time.perf_counter()
    fleet.initialize(arr("images", 0), arr("depths", 0), arr("timestamps", 0))
    torch.cuda.synchronize()
    chunk_s, poses = [], []
    for lo in range(1, N_FLEET_FRAMES, CHUNK):
        t1 = time.perf_counter()
        sl = slice(lo, min(lo + CHUNK, N_FLEET_FRAMES))
        poses.append(fleet.track_chunk(arr("images", sl), arr("depths", sl),
                                       arr("timestamps", sl)))
        chunk_s.append(time.perf_counter() - t1)
    total_s = time.perf_counter() - t0
    est = np.concatenate([np.broadcast_to(np.eye(4, dtype=np.float32), (N_FLEET, 1, 4, 4)),
                          np.concatenate(poses, axis=1)], axis=1)
    return est, total_s, sum(chunk_s[1:]), len(chunk_s)


def phase_path8c(fleet_seqs, kernels, seq, cfg3, map3):
    """FleetTracker serving N_FLEET RGB-D streams on the card at the bench's
    operating point (world 1: every stream on this rank), through its
    per-stream runners (step graphs and frame-phase graphs) and op by op in
    one call, against a solo System on stream 0's frames; then 2
    localization streams on path 3's saved map, brought up by
    initialize_localization and tracked for 2 chunks in localization mode,
    graphed and op by op."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import streaming
    from self_commit_orb_slam2_tpu_torch.models.system import System
    from self_commit_orb_slam2_tpu_torch.parallel.fleet import FleetTracker
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse

    label = "path 8c"
    cfg = _bench_config()
    runs, n_launch, fleets = {}, 0, {}
    for graphed in (True, False):
        fleet = fleets[graphed] = FleetTracker(cfg, n_streams=N_FLEET)
        _reset_launches(kernels)
        with streaming.no_host_reads():   # graphed: each stream's dispatch reads nothing
            est, total_s, steady, n_chunks = _fleet_stream(fleet, fleet_seqs, graphed)
        launches = _launches(kernels)
        ates = [float(ate_rmse(est[s], q.poses_gt)) for s, q in enumerate(fleet_seqs)]
        n_steady = N_FLEET_FRAMES - 1 - CHUNK
        r = dict(est=est, ates=ates, fps_stream=N_FLEET_FRAMES / total_s,
                 fps_fleet=N_FLEET * N_FLEET_FRAMES / total_s, steady_stream=n_steady / steady,
                 steady_fleet=N_FLEET * n_steady / steady)
        replays = (sum(sg.part_replays["chunk"] for sg in fleet.step_graphs) if graphed else 0)
        way = "graphed" if graphed else "op by op"
        print(f"[{label}] FleetTracker {way}, {N_FLEET} RGB-D streams {WIDTH}x{HEIGHT}, "
              f"{N_FEATURES} features, capacities {cfg.caps.max_keyframes} / "
              f"{cfg.caps.max_points}, mapping on, world 1 (every stream on this rank), 1 + "
              f"{N_FLEET_FRAMES - 1} frames each in chunks of {CHUNK}: state_ok "
              f"{fleet.state_ok.tolist()}, keyframes {fleet.n_keyframes().tolist()}, ATE "
              f"{[round(a, 6) for a in ates]} m; launches {launches}; chunk-graph replays "
              f"{replays}")
        print(f"[{label}] {way}: {total_s:.3f} s in all: {r['fps_stream']:.2f} frames/s per "
              f"stream, {r['fps_fleet']:.2f} for the fleet; steady (after the first chunk) "
              f"{r['steady_stream']:.2f} per stream, {r['steady_fleet']:.2f} for the fleet (host "
              "clock, track_chunk returns the poses on the host)")
        want = N_FLEET * (1 + n_chunks)
        n_launch += want
        require(launches == {"fast_band": want, "fast_nms": 0},
                f"{label} {way}: launches {launches}, want fast_band {want} (once per stream "
                "per extraction call), fast_nms 0")
        require(fleet.state_ok.all(), f"{label} {way}: a stream lost tracking")
        require(max(ates) < ATE_LIMIT_M, f"{label} {way}: ATE {ates}")
        require(not graphed or (replays == N_FLEET * n_chunks and all(
                    sg.replays == sg.part_replays["chunk"] for sg in fleet.step_graphs)),
                f"{label}: the fleet's chunks did not replay one chunk graph each")
        runs[graphed] = r
    d_ways = float(np.abs(runs[True]["est"] - runs[False]["est"]).max())
    same = [_same_tensors(fleets[True].maps[i], fleets[False].maps[i])
            and _same_tensors(fleets[True].carries[i], fleets[False].carries[i])
            for i in range(N_FLEET)]
    print(f"[{label}] graphed against op by op: max |pose difference| {d_ways:.2e}; each "
          f"stream's map and carry bitwise equal {same}; every graphed dispatch under sync "
          f"debug mode 'error'; {_chunk_stats_note(fleets[True].step_graphs[0])}")
    require(d_ways == 0.0 and all(same), f"{label}: the chunk graphs differ from op by op")

    solo = System(cfg, enable_loop_closing=False)
    q = fleet_seqs[0]
    solo.track_batch_rgbd(q.images, q.depths, q.timestamps)
    _, est_solo = solo.get_trajectory()
    n = min(len(est_solo), N_FLEET_FRAMES)
    diff = float(np.abs(est_solo[:n] - runs[True]["est"][0, :n]).max())
    print(f"[{label}] stream 0 (graphed) against a solo System(cfg, enable_loop_closing=False) "
          f"on its frames: max |pose difference| {diff:.2e}")
    require(diff < 5e-2, f"{label}: stream 0 differs from the solo System by {diff}")

    starts = np.array([10, 30])
    T0_inv = np.linalg.inv(seq.poses_gt[0])
    gt_t = lambda i: (seq.poses_gt[i] @ T0_inv)[:3, 3]   # noqa: E731  path 3's map frame
    loc_runs = {}
    for graphed in (True, False):
        way = "graphed" if graphed else "op by op"
        loc = FleetTracker(cfg3, n_streams=2, localization_only=True)
        if not graphed:
            loc.step_graphs = None
        _reset_launches(kernels)
        t1 = time.perf_counter()
        ok = loc.initialize_localization(map3, seq.images[starts], seq.depths[starts],
                                         np.zeros(2, np.float32))
        torch.cuda.synchronize()
        loc_ms = (time.perf_counter() - t1) * 1e3
        errs = [float(np.linalg.norm(loc.trajectories[i][0][1][:3, 3] - gt_t(s)))
                for i, s in enumerate(starts)]
        chunk_s, worst = [], 0.0
        for lo in (1, 1 + CHUNK):
            idx = starts[:, None] + np.arange(lo, lo + CHUNK)
            t1 = time.perf_counter()
            poses = loc.track_chunk(seq.images[idx], seq.depths[idx], np.zeros(idx.shape))
            chunk_s.append(time.perf_counter() - t1)
            worst = max(worst, max(float(np.linalg.norm(poses[i, b][:3, 3] - gt_t(idx[i, b])))
                                   for i in range(2) for b in range(CHUNK)))
        launches = _launches(kernels)
        want = 2 * (1 + len(chunk_s))
        n_launch += want
        loc_runs[graphed] = np.stack([np.stack([T for _, T in tr]) for tr in loc.trajectories])
        replays = sum(sg.part_replays["loc_chunk"] for sg in loc.step_graphs) if graphed else 0
        capture_note = ", the graphs' capture included" if graphed else ""
        print(f"[{label}] localization serving {way}: initialize_localization of 2 streams "
              f"(frames {starts.tolist()}) on path 3's saved map: success {ok.tolist()}, "
              f"translation within {[round(e, 4) for e in errs]} m of the ground truth, "
              f"{loc_ms:.1f} ms for both (host clock, synced{capture_note}); then "
              f"2 chunks of {CHUNK} in localization mode: worst translation {worst:.4f} m, "
              f"{2 * CHUNK * 2 / sum(chunk_s):.2f} frames/s for both streams, state_ok "
              f"{loc.state_ok.tolist()}, loc_chunk replays {replays}; launches {launches}")
        require(ok.all(), f"{label} {way}: localization bring-up failed ({ok.tolist()})")
        require(max(errs) < 0.05 and worst < 0.05,
                f"{label} {way}: relocalized {errs} m, tracked {worst:.4f} m away")
        require(loc.state_ok.all(), f"{label} {way}: a localization stream lost tracking")
        require(launches == {"fast_band": want, "fast_nms": 0},
                f"{label} {way}: launches {launches}, want fast_band {want}")
        require(not graphed or replays == 2 * 2,
                f"{label}: localization serving did not replay loc_chunk once a chunk")
    d_loc = float(np.abs(loc_runs[True] - loc_runs[False]).max())
    print(f"[{label}] localization serving graphed against op by op: max |pose difference| "
          f"{d_loc:.2e}")
    g, e = runs[True], runs[False]
    return dict(launches=n_launch, fps_stream=g["fps_stream"], fps_fleet=g["fps_fleet"],
                ates=g["ates"] + e["ates"], steady_stream=g["steady_stream"],
                steady_fleet=g["steady_fleet"], eager=e)


def _graft_problem(device):
    """__graft_entry__.dryrun_multichip's shapes at one device (S = 1 map,
    K = 4 keyframes, N = 64 observations, P = 64 points, E = 4 edge slots),
    built with the port: the BA's and the pose graph's arguments after the
    mesh (and the camera)."""
    import torch

    from self_commit_orb_slam2_tpu_torch.ops import se3, sim3
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams, project

    cam = CameraParams.create(fx=200.0, fy=200.0, cx=64.0, cy=48.0, bf=20.0, width=128,
                              height=96)
    S, K, N, P, E = 1, 4, 64, 64, 4
    rng = np.random.default_rng(0)
    pt = rng.uniform(-1, 1, (S, P, 3)).astype(np.float32)
    pt[..., 2] += 4.0
    poses = np.zeros((S, K, 4, 4), np.float32)
    obs_pt = np.full((S, K, N), -1, np.int32)
    obs_uvr = np.zeros((S, K, N, 3), np.float32)
    for k in range(K):
        xi = torch.tensor([0.1 * k, 0.0, 0.02 * k, 0.0, -0.02 * k, 0.0])
        poses[0, k] = se3.se3_exp(xi).numpy()
        sel = rng.choice(P, N, replace=False).astype(np.int32)
        obs_pt[0, k] = sel
        pc = pt[0, sel] @ poses[0, k][:3, :3].T + poses[0, k][:3, 3]
        uv = project(cam, torch.from_numpy(pc))[0].numpy()
        obs_uvr[0, k] = np.concatenate([uv, (uv[:, 0] - float(cam.bf) / pc[:, 2])[:, None]],
                                       -1)
    ba = [torch.from_numpy(a).to(device) for a in (
        poses, pt, obs_pt, obs_uvr, np.ones((S, K, N), np.float32), np.ones((S, K, N), bool),
        np.tile(np.arange(K) > 0, (S, 1)), np.ones((S, P), bool))]
    kf_sim3 = sim3.from_se3(torch.from_numpy(poses))
    ei, ej = np.zeros((S, E), np.int32), np.zeros((S, E), np.int32)
    meas = sim3.identity().repeat(S, E, 1)
    ok = np.zeros((S, E), bool)
    for k in range(1, K):
        ei[0, k - 1], ej[0, k - 1], ok[0, k - 1] = k, k - 1, True
        rel = poses[0, k] @ np.linalg.inv(poses[0, k - 1])
        meas[0, k - 1] = sim3.from_se3(torch.from_numpy(rel))
    pg = [x.to(device) for x in (kf_sim3, torch.from_numpy(ei), torch.from_numpy(ej), meas,
                                 torch.from_numpy(ok), torch.from_numpy(np.arange(K)[None] == 0))]
    return cam, ba, pg


def phase_path8d(workdir):
    """NCCL at a world of one rank: hosts.initialize over a file://
    rendezvous on the card; the distributed BA and pose graph at
    __graft_entry__.py:50-80's shapes on a 1x1 mesh over that group equal
    the same calls with no process group; the group is torn down."""
    import torch
    import torch.distributed as dist

    from self_commit_orb_slam2_tpu_torch.parallel import hosts
    from self_commit_orb_slam2_tpu_torch.parallel.distributed_ba import (
        distributed_bundle_adjust)
    from self_commit_orb_slam2_tpu_torch.parallel.distributed_pose_graph import (
        distributed_pose_graph)
    from self_commit_orb_slam2_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    label = "path 8d"
    cam, ba, pg = _graft_problem("cuda")

    def both(mesh):
        return (*distributed_bundle_adjust(mesh, cam, *ba, n_iters=2),
                *distributed_pose_graph(mesh, *pg, n_iters=2))

    require(not dist.is_initialized(), f"{label}: a process group exists already")
    ref = both(make_mesh(MeshSpec(1, 1)))
    hosts.initialize(f"file://{os.path.join(workdir, 'rendezvous')}", 1, 0, timeout_s=120)
    try:
        backend = str(dist.get_backend())
        x = torch.arange(8.0, device="cuda")
        dist.all_reduce(x)
        got, ms, _ = _peak_timed(lambda: both(hosts.global_mesh(n_map=1)))
    finally:
        hosts.shutdown()
    diff = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    print(f"[{label}] NCCL world of 1 rank over a file:// rendezvous (backend {backend!r}): "
          f"all_reduce on the card ok; distributed BA + pose graph (2 iterations each, "
          f"__graft_entry__ shapes) {ms:.1f} ms, max |difference| to no process group {diff:.1e}, "
          f"mean residual {float(got[3][0]):.2e}; group torn down {not dist.is_initialized()}")
    require("nccl" in backend.lower(), f"{label}: backend {backend} has no NCCL")
    require(torch.equal(x, torch.arange(8.0, device="cuda")), f"{label}: all_reduce changed x")
    require(diff <= 1e-6, f"{label}: results differ by {diff} over NCCL")
    require(all(bool(torch.isfinite(t).all()) for t in got) and float(got[3].max()) < 1e-4,
            f"{label}: non-finite results or a pose-graph residual above 1e-4")
    require(not dist.is_initialized(), f"{label}: the process group was not torn down")


# ---------------------------------------------------------------- path 9
# (a) bench.py's mono scale-drift loop (bench_long_mono, bench.py:535-650) cut
# to path 6's revolution of 120 frames: 180 frames (1.5 revolutions) through
# open_stream("mono") in chunks of 4, bench.py's per-frame twist and scale
# composed over each chunk and injected while tracking is OK, from the first
# chunk after initialization to frame 120; once with loop closing and once
# without (scripts/jax_mono_loop_scenario.py drives the same through the JAX
# package).  (b) tests/test_long_sequence.py's bounded map at full width: 12
# keyframe slots, a keyframe every 2 frames, 1 + 60 frames of a lingering
# look-at oscillation, so slots are culled and reused.

N_MONO_LOOP, MONO_DRIFT_TO = 180, 120
MONO_TWIST = [0.0009, 0.0002, -0.0004, 0.0, 0.0007, 0.0]   # bench.py:575-576
MONO_SCALE = 1.0006                                        # bench.py:577, per frame
N_BOUNDED, BOUNDED_SEED = 61, 7                            # tests/test_long_sequence.py:55-57


def _mono_loop_config(vocab):
    """bench_long_mono's configuration (bench.py:561-574)."""
    from self_commit_orb_slam2_tpu_torch.models.config import Capacities

    cfg = _sensor_config("mono", WIDTH, HEIGHT, FX, 0.1, N_FEATURES, vocab,
                         max_frames_between_kf=10)
    return cfg._replace(caps=Capacities(max_keyframes=96, max_points=16384, local_points=1024))


def _mono_stream(label, slam, seq9, kernels, ph):
    """Stream path 9 (a)'s frames through slam with the drift injected; every
    launch and relocalization count set to 0 first.  Returns the chunk
    times (host clock, synced), the chunks in which a closure landed, the
    launches, the frames the bootstrap took, the Sim3-aligned ATE against
    the trailing ground truth (bench.py:615-618) and the closer's counters."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import relocalization
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK
    from self_commit_orb_slam2_tpu_torch.utils.drift import make_injector, se3_increment
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse

    lc = slam._loop_closer
    images, ts, n = _u8(seq9.images), seq9.timestamps, N_MONO_LOOP
    inject = make_injector(keep_recent=6)
    dD = torch.linalg.matrix_power(se3_increment(MONO_TWIST).double(), CHUNK).float().cuda()
    s_chunk = MONO_SCALE ** CHUNK
    _reset_launches(kernels)
    relocalization.reset_counts()
    sess = slam.open_stream("mono", CHUNK)
    t_start = time.perf_counter()
    done, chunk_ms, events, n_drift = 0, [], [], 0
    while done < n:
        t0 = time.perf_counter()
        sl = slice(done, min(done + CHUNK, n))
        was_ok = slam.state == STATE_OK
        sess.feed((images[sl],), ts[sl])
        done = sl.stop
        if was_ok and done <= MONO_DRIFT_TO and slam.state == STATE_OK:
            slam.map = inject(slam.map, dD, s_chunk)
            n_drift += 1
        sess.poll()
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        while lc is not None and lc.n_big_changes > len(events):   # one entry a closure
            events.append((len(chunk_ms) - 1, done, {k: len(v) for k, v in ph.items()}))
    t0 = time.perf_counter()
    sess.finish()
    torch.cuda.synchronize()
    chunk_ms.append((time.perf_counter() - t0) * 1e3)
    stream_s = time.perf_counter() - t_start
    launches = _launches(kernels)
    attempts, _ = relocalization.counts()
    _, est = slam.get_trajectory()
    require(0 < len(est) <= n and np.all(np.isfinite(est)), f"{label}: bad trajectory")
    gt = seq9.poses_gt[n - len(est):n]
    return dict(chunk_ms=chunk_ms, events=events, stream_s=stream_s, launches=launches,
                attempts=attempts, n_boot=n - sess.n_fed, n_drift=n_drift,
                closures=lc.n_big_changes if lc is not None else 0,
                gba_info=dict(lc.last_gba_info) if lc is not None else {},
                ate=float(ate_rmse(est, gt, with_scale=True)), n_poses=len(est),
                live=int(slam.map.kf_valid.sum()), n_kf=slam.n_keyframes())


def phase_path9a(seq9, kernels, vocab):
    """A mono loop under scale drift, with and without loop closing."""
    from self_commit_orb_slam2_tpu_torch.models import loop_closing, pipeline
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System

    label = "path 9a"
    cfg = _mono_loop_config(vocab)
    _b1_on_loop_frames(label, seq9, cfg.orb, at=160)
    runs = {}
    for loops in (True, False):
        slam = System(cfg, enable_loop_closing=loops)
        lc = slam._loop_closer
        require(not loops or (lc is not None and lc.enabled),
                f"{label}: System(cfg) built no closer")
        slam.warm_start()   # as bench.py does: the captures before the stream
        with loop_closing.timed_phases() as ph, _counted_passes() as pass_s:
            run = _mono_stream(label, slam, seq9, kernels, ph)
        run.update(state=slam.state, phases={k: list(v) for k, v in ph.items()},
                   passes=len(pass_s))
        if loops:   # each applied correction's Sim3 scale, from the closer's record
            scales = [float(det.S_cur_cand[7]) for det in lc.corrections]
        runs[loops] = run
    on, off = runs[True], runs[False]
    # with loop closing again, the closer op by op (its graphs off, the step's on)
    slam_e = System(cfg)
    slam_e._loop_closer.graphs = None
    slam_e.warm_start()
    with loop_closing.timed_phases() as ph_e:
        run_e = _mono_stream(label, slam_e, seq9, kernels, ph_e)
    frames_on, frames_e = ([f for _, f, _ in r["events"]] for r in (on, run_e))
    print(f"[{label}] loop closing on, the closer op by op: {run_e['closures']} closures at "
          f"frames {frames_e} (graphed: {on['closures']} at {frames_on}), Sim3-aligned ATE "
          f"{run_e['ate']:.6f} m, {N_MONO_LOOP / run_e['stream_s']:.2f} frames/s; " + "; ".join(
              f"{k} {len(v)} calls, mean {np.mean(v):.1f} ms" for k, v in ph_e.items()))
    require(run_e["closures"] == on["closures"] and frames_e == frames_on,
            f"{label}: the closer op by op closed at {frames_e}, graphed at {frames_on}")
    med = float(np.median(on["chunk_ms"][4:]))
    stalls = [float(np.max(on["chunk_ms"][max(c - 1, 0): c + 3]) - med)
              for c, _, _ in on["events"]]
    for loops, run in runs.items():
        fps = N_MONO_LOOP / run["stream_s"]
        print(f"[{label}] loop closing {'on' if loops else 'off'}: {N_MONO_LOOP} frames "
              f"{WIDTH}x{HEIGHT} of a {LOOP_REV}-frame circle, mono, bench_long_mono's "
              f"configuration (96 / 16384 / 1024, max_frames_between_kf 10, vocabulary), chunk "
              f"{CHUNK}, drift (twist {MONO_TWIST}, scale {MONO_SCALE} a frame, composed per "
              f"chunk) injected after {run['n_drift']} chunks up to frame {MONO_DRIFT_TO}: "
              f"initialized after {run['n_boot']} frames, state {run['state']}, keyframes "
              f"{run['n_kf']} ({run['live']} live), closures {run['closures']} (frames "
              f"{[f for _, f, _ in run['events']]}), last GBA {run['gba_info']}; Sim3-aligned "
              f"ATE {run['ate']:.6f} m over {run['n_poses']} poses; {fps:.2f} frames/s (host "
              f"clock, synced per chunk), mapping passes {run['passes']}; relocalization "
              f"attempts {run['attempts']}; launches {run['launches']}")
    print(f"[{label}] closures' Sim3 scale s: {[round(x, 6) for x in scales]}")
    for name, v in on["phases"].items():
        print(f"[{label}] {name}: {len(v)} calls, mean {np.mean(v):.1f} ms, max "
              f"{np.max(v):.1f} ms (host clock, synced)")
    for (c, frame, before), stall in zip(on["events"], stalls):
        print(f"[{label}] closure landed in chunk {c} (frame {frame}): stall {stall:.1f} ms over "
              f"the median chunk {med:.1f} ms (worst chunk of the 4 around it, bench.py's "
              f"measure); phase calls before it {before}")
    for loops, run in runs.items():
        want = run["n_boot"] + -(-(N_MONO_LOOP - run["n_boot"]) // CHUNK)
        require(run["launches"] == {"fast_band": want, "fast_nms": 0},
                f"{label}: launches {run['launches']}, want fast_band {want}, fast_nms 0")
        require(run["state"] == STATE_OK, f"{label}: tracking lost (loop closing {loops})")
    require(on["n_drift"] == off["n_drift"] > 0, f"{label}: the runs took different drift "
            f"({on['n_drift']} and {off['n_drift']} chunks)")
    require(on["closures"] >= 1, f"{label}: no loop closed in the mono stream")
    require(len(scales) == on["closures"], f"{label}: {len(scales)} corrections recorded for "
            f"{on['closures']} closures")
    require(on["gba_info"].get("gba_path") == "dense", f"{label}: no global BA merged")
    require(on["ate"] < off["ate"], f"{label}: Sim3-aligned ATE with loop closing "
            f"{on['ate']:.6f} m not below the run without {off['ate']:.6f} m")
    return dict(launches=on["launches"]["fast_band"] + off["launches"]["fast_band"],
                fps=N_MONO_LOOP / on["stream_s"], ate=on["ate"], ate_raw=off["ate"],
                closures=on["closures"], frames=[f for _, f, _ in on["events"]],
                scales=scales, stalls=stalls, live=on["live"],
                phases={k: float(np.mean(v)) for k, v in on["phases"].items()})


def _bounded_pass(slam, seq9b, count_drops: bool):
    """Track path 9 (b)'s frames into slam, a fresh System, in chunks of 4.  With
    count_drops, a spy on tracking.track_motion counts the carried ids the
    birth-stamp guard drops (live slot, another point's stamp) on the static
    motion hypothesis, once a frame: a pass kept apart from the timed one.
    The spy runs inside the step graph, so it adds into a tensor made before
    the capture (in place: each replay adds), and the System captures in
    warm_start, on a scratch state with no carried ids, before the count
    starts."""
    import torch

    from self_commit_orb_slam2_tpu_torch.models import tracking
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK

    dropped = torch.zeros((), dtype=torch.int64, device="cuda")
    orig = tracking.track_motion

    def spy_motion(config, m, frame, Tcw, vel, last_frame, ids, radius, *, last_obs_birth=None):
        if last_obs_birth is not None and radius == config.tracking.motion_search_radius_wide:
            cl = ids.clamp(0, m.max_pt - 1).long()
            dropped.add_(torch.sum((ids >= 0) & m.pt_valid[cl]
                                   & (m.pt_birth[cl] != last_obs_birth)))
        return orig(config, m, frame, Tcw, vel, last_frame, ids, radius,
                    last_obs_birth=last_obs_birth)

    images, depths, ts = seq9b.images, seq9b.depths, seq9b.timestamps
    live_max, n_lost = 0, 0
    if count_drops:
        tracking.track_motion = spy_motion
        slam.warm_start()
        dropped.zero_()
    try:
        bounds = [0] + list(range(1 + CHUNK, N_BOUNDED + 1, CHUNK))
        for a, b in zip(bounds[:-1], bounds[1:]):
            slam.track_batch_rgbd(images[a:b], depths[a:b], ts[a:b], chunk=CHUNK)
            n_lost += slam.state != STATE_OK
            live_max = max(live_max, int(slam.map.kf_valid.sum()))
        torch.cuda.synchronize()
    finally:
        tracking.track_motion = orig
    return live_max, n_lost, int(dropped)


def phase_path9b(seq9b, kernels):
    """The bounded map: more keyframes inserted than the map has slots."""
    from self_commit_orb_slam2_tpu_torch.models import pipeline, relocalization
    from self_commit_orb_slam2_tpu_torch.models.config import Capacities
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse

    label = "path 9b"
    cfg = _sensor_config("rgbd", WIDTH, HEIGHT, FX, 0.1, N_FEATURES, None,
                         max_frames_between_kf=2, min_frames_between_kf=0,
                         kf_cull_redundancy=0.7)
    cfg = cfg._replace(caps=Capacities(max_keyframes=12, max_points=16384, local_points=1024,
                                       cull_log=256))
    slam = System(cfg, enable_loop_closing=False)
    _b1_on_loop_frames(label, seq9b, cfg.orb, at=40)
    slam.warm_start()   # the step graphs' capture: start-up, outside the timed frames
    with _counted_passes() as pass_s:
        _reset_launches(kernels)
        relocalization.reset_counts()
        t0 = time.perf_counter()
        live_max, n_lost, _ = _bounded_pass(slam, seq9b, count_drops=False)
        dt = time.perf_counter() - t0
        launches = _launches(kernels)
        attempts, _ = relocalization.counts()
    m = slam.map
    total, live, culled = int(m.n_kf), int(m.kf_valid.sum()), int(m.n_culled)
    pts = int(m.pt_valid.sum())
    ts_est, est = slam.get_trajectory()
    ate = float(ate_rmse(est, seq9b.poses_gt[:N_BOUNDED])) if len(est) == N_BOUNDED else np.inf
    counted = System(cfg, enable_loop_closing=False)
    _, _, dropped = _bounded_pass(counted, seq9b, count_drops=True)
    print(f"[{label}] {N_BOUNDED} frames {WIDTH}x{HEIGHT} RGB-D, {N_FEATURES} features, of a "
          f"look-at oscillation (tests/test_long_sequence.py's, seed {BOUNDED_SEED}), "
          f"{cfg.caps.max_keyframes} keyframe slots, a keyframe every 2 frames, redundancy 0.7, "
          f"chunk {CHUNK}: keyframes inserted {total}, live {live} (at most {live_max}), culled "
          f"{culled}; points {pts} of {cfg.caps.max_points}; {len(est)} poses from "
          f"get_trajectory, ATE {ate:.6f} m; state {slam.state} ({n_lost} chunks ended lost); "
          f"{N_BOUNDED / dt:.2f} frames/s (host clock, synced), mapping passes {len(pass_s)} "
          f"(counted on the card); relocalization attempts {attempts}; launches "
          f"{launches}")
    print(f"[{label}] a second pass, untimed, on the same frames: carried ids the birth guard "
          f"dropped {dropped}; keyframes inserted {int(counted.map.n_kf)}, live "
          f"{int(counted.map.kf_valid.sum())}, culled {int(counted.map.n_culled)}")
    require(n_lost == 0 and slam.state == STATE_OK, f"{label}: tracking lost")
    require(total > cfg.caps.max_keyframes, f"{label}: only {total} keyframes inserted into "
            f"{cfg.caps.max_keyframes} slots: slot reuse untested")
    require(live_max <= cfg.caps.max_keyframes, f"{label}: {live_max} live keyframes")
    require(culled == total - live, f"{label}: n_culled {culled} != {total} - {live}")
    require(0 < pts <= cfg.caps.max_points, f"{label}: {pts} live points")
    require(len(ts_est) == N_BOUNDED and np.all(np.isfinite(est)),
            f"{label}: {len(ts_est)} poses from get_trajectory, want {N_BOUNDED} finite")
    require(ate < 0.08, f"{label}: ATE {ate:.6f} m >= 0.08 m")
    want = 1 + -(-(N_BOUNDED - 1) // CHUNK)
    require(launches == {"fast_band": want, "fast_nms": 0},
            f"{label}: launches {launches}, want fast_band {want}, fast_nms 0")
    return dict(launches=want, total=total, live=live, culled=culled, ate=ate,
                dropped=dropped, fps=N_BOUNDED / dt)


# ------------------------------------------------------- per-stage profiler
# tools/profile_stages.py at bench.py's RGB-D operating point (the JAX
# script's PW=640 PH=480 PF=1000), both modes on one state; 3 timed calls a
# stage and way, and the op-by-op way traced only for step_rgbd (the sync
# counter's positive control): the tool's own defaults (20 / 10, both ways
# traced) take ~2 min more, mostly the profiler's event processing.
PROFILE_N = 3


def phase_profile_stages(kernels):
    """Every stage of the step and the mapping pass, op by op and replayed
    from its own graph: every replay bitwise, 0 host syncs in a replay."""
    from self_commit_orb_slam2_tpu_torch.tools import profile_stages

    label = "profile stages"
    _reset_launches(kernels)
    t0 = time.perf_counter()
    st = profile_stages.build_state(WIDTH, HEIGHT, N_FEATURES, "cuda")
    print(f"[{label}] {WIDTH}x{HEIGHT}/{N_FEATURES}feat: {int(st.map.n_kf)} keyframes, "
          f"{int(st.map.pt_valid.sum())} points after 8 frames of generate_sequence(seed=5, "
          f"fx={st.config.camera.fx}) ({time.perf_counter() - t0:.1f} s)")
    rows = {}
    for mapping in (False, True):
        rows[mapping] = profile_stages.report(st, mapping, PROFILE_N, trace_op=False)
        bad = profile_stages.failures(rows[mapping])
        require(not bad, f"{label}: replays that differ from op by op or sync: {bad}")
    launches = _launches(kernels)
    print(f"[{label}] launches {launches} ({time.perf_counter() - t0:.1f} s, host clock)")
    require(launches["fast_band"] > 0 and launches["fast_nms"] == 0,
            f"{label}: launches {launches}, want fast_band > 0, fast_nms 0")
    by = {r["name"]: r for r in rows[False] + rows[True]}
    return launches["fast_band"], by


def phase_scaling(workdir):
    """tools/scaling_bench.py at a world of one: the JAX script's defaults,
    then path 8 (a)'s per-rank shape."""
    from self_commit_orb_slam2_tpu_torch.tools import scaling_bench

    out = {}
    for name, extra in (("defaults", []), ("256 x 65536", ["--kfs", "256", "--per-dev-points",
                                                             "65536"])):
        path = os.path.join(workdir, "scaling.json")
        require(scaling_bench.main(extra + ["--out", path]) == 0, f"scaling {name}: failed")
        with open(path) as f:
            row = json.load(f)["table"][0]
        require(np.isfinite(row["ms"]) and row["ms"] > 0, f"scaling {name}: {row}")
        out[name] = row
    return out


def main() -> int:
    faulthandler.enable()   # a crash prints every thread's stack
    sys.path.insert(0, HERE)
    try:
        import torch  # noqa: F401
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    stack = contextlib.ExitStack()
    t_main = time.perf_counter()

    def lap(what):
        print(f"[time] {what} done {time.perf_counter() - t_main:.1f} s after the start "
              "(host clock)", flush=True)

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
        fleet_jobs = [pool.submit(_render, "frames", dict(geo, seed=FLEET_SEED + s,
                                                          n_frames=N_FLEET_FRAMES))
                      for s in range(N_FLEET)]
        bounded_jobs = _submit_frames(
            pool, lookat_trajectory(N_BOUNDED, sweep=0.22, frames_per_cycle=24), 2,
            **dict(geo, seed=BOUNDED_SEED))
        kernels = phase_build()
        seq = _join_frames(seq_jobs)
        print(f"[data] generate_sequence: {N_FRAMES} frames ready "
              f"{time.perf_counter() - t_data:.1f} s after the render pool started (6 worker "
              f"processes, host)")
        results = phase_kernels(seq)
        fp, fp_err = phase_frame_programs(seq)
        results["fast_band"]["max_abs_err"] = max(results["fast_band"]["max_abs_err"], fp_err)
        lap("build and kernels")
        summary = [f"frame build ({WIDTH}x{HEIGHT}) graphed / op by op: " + ", ".join(
            f"{k} {v['ms'][True]:.3f} / {v['ms'][False]:.3f} ms" for k, v in fp.items())]
        vocab, bow_ms, eig = phase_vocabulary(seq)   # the graph phases' LOST branches use it
        for label, cell, mapping, own in (("path 1", 16, False, "fast_band"),
                                          ("path 2", 8, True, "fast_nms")):
            n, fps, fps_pf, ate, g = phase_path(seq, kernels, label, cell, mapping, own, vocab)
            results[own]["launches"] = n
            summary.append(f"{label} {fps:.2f} frames/s through the chunk graph, {fps_pf:.2f} "
                           f"through per-frame replays, ATE {ate:.6f} m, " + _graph_note(g))
            lap(label)
        n3, fps3, ate3, r3, map3 = phase_path3(seq, kernels, vocab)
        results["fast_band"]["launches_path3"] = n3
        results["fast_nms"]["launches_path3"] = 0
        summary.append(
            f"path 3 {fps3:.2f} frames/s, ATE {ate3:.6f} m, BoW of a frame {bow_ms:.3f} ms, one "
            f"relocalization op by op / graphed {r3['reloc_ms'][False]:.1f} / "
            f"{r3['reloc_ms'][True]:.1f} ms ({r3['reloc_syncs']} host syncs graphed), a "
            f"localization-mode frame {r3['loc_ms'][False]:.1f} / {r3['loc_ms'][True]:.1f} ms, "
            f"Jacobi op by op / graphed / eigh " + ", ".join(
                f"[1280, {n}, {n}] {e['op_ms']:.3f} / {e['graph_ms']:.3f} / {e['lib_ms']:.3f} ms"
                for n, e in eig.items()))
        lap("vocabulary and path 3")

        t0 = time.perf_counter()
        kitti = _join_frames(kitti_jobs)
        euroc, euroc_maps = euroc_job.result()
        print(f"[data] stereo pairs: {N_KITTI} at {KITTI['width']}x{KITTI['height']} and "
              f"{N_EUROC} raw at {EUROC['width']}x{EUROC['height']}: waited "
              f"{time.perf_counter() - t0:.1f} s for the render pool (host)")
        band = results["fast_band"]
        phase_band_shapes(kitti, euroc, euroc_maps, band)
        match_ms, share = phase_stereo_matcher(kitti)
        cfg4a = _sensor_config("stereo", vocab=vocab, max_frames_between_kf=10, **KITTI)
        n4a, fps4a, ate4a, pass4a, slam4a = phase_path_stereo("path 4a", kitti, cfg4a, N_KITTI,
                                                              0.01, kernels)
        g4a = phase_graph("path 4a", cfg4a, "stereo", (_u8(kitti.images),
                                                       _u8(kitti.right_images)),
                          kitti.timestamps, True, vocab, slam4a)
        del slam4a
        n4b, fps4b, ate4b, _, _ = phase_path_stereo(
            "path 4b", euroc, _sensor_config("stereo", vocab=vocab, rect_maps=euroc_maps,
                                             max_frames_between_kf=10, **EUROC),
            N_EUROC - N_EUROC_PER_FRAME, 0.02, kernels)
        summary.append(f"path 4a {fps4a:.2f} frames/s, ATE {ate4a:.6f} m, {pass4a} mapping "
                       f"passes, match_stereo {match_ms / CHUNK:.3f} ms per frame, depth "
                       f"on {share:.3f} of the keypoints, {_graph_note(g4a)}; path 4b "
                       f"{fps4b:.2f} frames/s, ATE {ate4b:.6f} m")
        two_view_ms = phase_two_view()
        n5, fps5, ate5, boot5, n_init, g5 = phase_path5(seq, kernels, vocab)
        summary.append(f"two-view {two_view_ms:.1f} ms; path 5 {fps5:.2f} frames/s, Sim3 ATE "
                       f"{ate5:.6f} m, initialized after {n_init} frames, a bootstrap attempt "
                       f"graphed / op by op {boot5['ms'][True]:.1f} / {boot5['ms'][False]:.1f} "
                       f"ms ({boot5['syncs']} host syncs in a replay, bitwise "
                       f"{boot5['bitwise']}), {_graph_note(g5)}")
        lap("paths 4 and 5")
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
                       f"on the card {stages['pose_graph_ms']:.1f} ms; with the closer op by op "
                       f"{stages['eager_fps']:.2f} frames/s, detection "
                       f"{np.mean(stages['eager_ph'].get('detect', [np.nan])):.1f} ms, correction "
                       f"{np.mean(stages['eager_ph'].get('correct', [np.nan])):.1f} ms; from one "
                       f"state op by op / graphed: detection "
                       f"{stages['graph_detect_ms'][False]:.1f} / "
                       f"{stages['graph_detect_ms'][True]:.1f} ms, correction "
                       f"{stages['graph_correct_ms'][False]:.1f} / "
                       f"{stages['graph_correct_ms'][True]:.1f} ms, host syncs "
                       f"{stages['graph_syncs']}, GBA slices "
                       f"{np.min(stages['gba']['ms'][False]['slices']):.1f} to "
                       f"{np.max(stages['gba']['ms'][False]['slices']):.1f} / "
                       f"{np.min(stages['gba']['ms'][True]['slices']):.1f} to "
                       f"{np.max(stages['gba']['ms'][True]['slices']):.1f} ms, merge "
                       f"{stages['gba']['ms'][False]['merge']:.1f} / "
                       f"{stages['gba']['ms'][True]['merge']:.1f} ms (bitwise "
                       f"{stages['gba']['bitwise']}, {stages['gba']['syncs']} host syncs "
                       f"graphed)")
        lap("path 6")
        with tempfile.TemporaryDirectory() as workdir:
            n7, rows7 = phase_path7(seq, kitti, euroc, kernels, vocab, workdir)
        summary.append("path 7 " + ", ".join(
            f"{k} {rows7[k][0]:.2f} frames/s (decode {rows7[k][1]:.3f} of the run), ATE "
            f"{rows7[k][2]:.6f} m" for k in ("tum", "tum per frame", "kitti", "euroc"))
            + f", serve {rows7['serve'][0]:.2f} frames/s within {rows7['serve'][1]:.1e} of "
            f"track_rgbd, track_rgbd per frame graphed / op by op "
            f"{rows7['per frame ms'][True]:.1f} / {rows7['per frame ms'][False]:.1f} ms (TUM), "
            f"{rows7['serve per frame ms'][True]:.1f} / {rows7['serve per frame ms'][False]:.1f} "
            f"ms (the wire's frames), warm_start {rows7['warm'][True][0]:.2f} s; primed against "
            "unprimed: "
            "initializing frame {:.0f} / {:.0f} ms, first chunk {:.0f} / {:.0f} ms, median "
            "chunk {:.0f} / {:.0f} ms".format(*(rows7["warm"][p][i] for i in (1, 2, 3)
                                               for p in (True, False))))
        lap("path 7")
        r8a, cfg8, map8 = phase_path8a(seq6, kernels, vocab)
        lap("path 8a")
        with tempfile.TemporaryDirectory() as workdir:
            r8b = phase_path8b(cfg8, map8, workdir)
            del map8
            t0 = time.perf_counter()
            fleet_seqs = [f.result() for f in fleet_jobs]
            print(f"[data] path 8c: {N_FLEET} x {N_FLEET_FRAMES} frames; waited "
                  f"{time.perf_counter() - t0:.1f} s for the render pool (host)")
            r8c = phase_path8c(fleet_seqs, kernels, seq, _bench_config(vocab), map3)
            phase_path8d(workdir)
        lap("path 8b to 8d")
        n8 = r8a["launches"] + r8c["launches"]
        summary.append(
            f"path 8a {r8a['fps']:.2f} frames/s, {r8a['closures']} closures at 256 x 65536, ATE "
            f"{r8a['ate']:.6f} m (raw {r8a['ate_raw']:.6f} m), sharded GBA {r8a['gba_ms']:.1f} ms "
            f"(Schur products' bound {r8a['bound']:.1f} ms), peak {r8a['gba_peak'] / 2**30:.3f} "
            f"GiB, stall {r8a['stall']:.1f} ms; path 8b refine_maps pose graph "
            f"{r8b['pg_ms'][0]:.1f} ms, BA {r8b['ba_ms'][0]:.1f} ms per map, peak "
            f"{r8b['peak'] / 2**30:.3f} GiB, perturbed map {r8b['before'][1]:.4f} -> "
            f"{r8b['after'][1]:.4f} px^2; path 8c {N_FLEET} streams graphed / op by op "
            f"{r8c['fps_stream']:.2f} / {r8c['eager']['fps_stream']:.2f} frames/s each, "
            f"{r8c['fps_fleet']:.2f} / {r8c['eager']['fps_fleet']:.2f} for the fleet (steady "
            f"{r8c['steady_stream']:.2f} / {r8c['eager']['steady_stream']:.2f} and "
            f"{r8c['steady_fleet']:.2f} / {r8c['eager']['steady_fleet']:.2f}), ATE max "
            f"{max(r8c['ates']):.6f} m; path 8d NCCL world of 1 ok")
        r9a = phase_path9a(seq6, kernels, vocab)
        lap("path 9a")
        t0 = time.perf_counter()
        seq9b = _join_frames(bounded_jobs)
        print(f"[data] path 9b: {N_BOUNDED} frames; waited {time.perf_counter() - t0:.1f} s for "
              f"the render pool (host)")
        r9b = phase_path9b(seq9b, kernels)
        lap("path 9b")
        n_prof, prof = phase_profile_stages(kernels)
        lap("profile stages")
        with tempfile.TemporaryDirectory() as workdir:
            scaling = phase_scaling(workdir)
        lap("scaling")
        n9 = r9a["launches"] + r9b["launches"]
        summary.append(
            f"path 9a mono {r9a['fps']:.2f} frames/s, {r9a['closures']} closures (frames "
            f"{r9a['frames']}, s {[round(x, 4) for x in r9a['scales']]}), Sim3-aligned ATE "
            f"{r9a['ate']:.6f} m (without loop closing {r9a['ate_raw']:.6f} m), stall "
            f"{r9a['stalls'][0]:.1f} ms; path 9b {r9b['total']} keyframes inserted into 12 slots, "
            f"{r9b['live']} live, {r9b['culled']} culled, ATE {r9b['ate']:.6f} m, "
            f"{r9b['fps']:.2f} frames/s")
        summary.append(
            "stages at 640x480 op by op / replayed, device ms: " + ", ".join(
                f"{k} {prof[k]['op']['device_ms']:.3f} / {prof[k]['graph']['device_ms']:.3f}"
                for k in ("make_frame_rgbd", "pose_optimize", "step_core", "keyframe_tail",
                          "full step_rgbd (no scan)", "local_bundle_adjustment"))
            + f"; sharded GBA again, fixed order / plain index_add_ "
            f"{min(r8a['repeat']['fixed_ms']):.1f} / {min(r8a['repeat']['plain_ms']):.1f} ms; "
            "weak scaling at a world of one " + ", ".join(
                f"{k} {v['ms']:.2f} ms" for k, v in scaling.items()))
        for row in results.values():
            row.setdefault("shapes", [])
            own = row["name"] == "fast_band"
            row.update(launches_path4a=n4a if own else 0, launches_path4b=n4b if own else 0,
                       launches_path5=n5 if own else 0, launches_path6=n6 if own else 0,
                       launches_path7=n7 if own else 0, launches_path8=n8 if own else 0,
                       launches_path9=n9 if own else 0,
                       launches_profile_stages=n_prof if own else 0)
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        stack.close()
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_path3",
            "launches_path4a", "launches_path4b", "launches_path5", "launches_path6",
            "launches_path7", "launches_path8", "launches_path9", "launches_profile_stages",
            "shapes")
    print(f"[summary] {card}: {'; '.join(summary)}")
    print("[kernels] launches: each wrapper counts where it launches its kernel; inside a CUDA "
          "graph capture that launch is only recorded, so the counts below are the wrappers' "
          "own, less the recordings, plus graph replays x launches per capture "
          "(models/program_graphs.py)")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
