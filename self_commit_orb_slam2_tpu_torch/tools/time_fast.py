"""Device time of the two FAST kernels on the card, source variants in turns.

    python -m self_commit_orb_slam2_tpu_torch.tools.time_fast [--csrc DIR ...]

Builds `fast_band.cu` and `fast_nms.cu` from the package's `csrc/` and from
every other directory given with `--csrc` (an earlier commit's sources, or an
experiment), holds each against its plain version bitwise, and times them in
turns on one card (A, B, B, A), at the main path's chunk shape (4 frames of
640x480, 32 slices) on three inputs, since the kernels' work depends on the
image: frames of generate_sequence (dense in corners: about a fifth of the
pixels inside the level masks hold a 9-arc at the low threshold), a slab of
uniform noise, where most pixels pass the kernels' pre-test (their worst
case), and the same noise smoothed to a low contrast, where few do:
  * hot: launches on preallocated outputs replayed from a CUDA graph, so the
    host cannot set the number; the slab stays in the L2;
  * cold: one launch between two events after a write larger than the L2;
  * host: the wrapper's time per call on the host (allocation, ctypes).
`chip_smoke.py` uses the same timers.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..kernels import CSRC_DIR, CudaKernel
from ..ops.orb import fast_band, fast_nms, pyramid
from ..ops.orb.extractor import OrbConfig

WIDTH, HEIGHT, FX, CHUNK = 640, 480, 520.0, 4
L2_FLUSH_BYTES = 256 << 20  # several times the H100's 50 MB L2


def frames_slab(images, cfg: OrbConfig, band: bool):
    """The [G*H0p, W0] slab (slices padded to 16 rows for the band kernel,
    [G*H0, W0] for the NMS kernel), H0p and the level dims extract_batch
    gives the kernel for these frames: [B, H, W] uint8 numpy images, or
    float32 images already on the card."""
    imgs = (images if isinstance(images, torch.Tensor)
            else torch.from_numpy(images.astype(np.float32)).cuda())
    levels = pyramid.build_pyramid(imgs, cfg.n_levels, cfg.scale_factor)
    dims = tuple(tuple(l.shape[-2:]) for l in levels)
    slab = pyramid.stack_slab_batch(levels)
    B, L, H0, W0 = slab.shape
    H0p = H0 + (-H0) % 16 if band else H0
    slab = slab[:, :, torch.clamp(torch.arange(H0p, device=slab.device), max=H0 - 1)]
    return slab.reshape(B * L * H0p, W0).contiguous(), H0p, dims


def noise_slab(shape, seed: int = 0) -> torch.Tensor:
    """Uniform noise in [0, 255), float32, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32)).cuda()


def smooth_slab(shape, seed: int = 0) -> torch.Tensor:
    """`noise_slab` under two 9x9 box means, its contrast stretched back to
    a standard deviation of about 14 grey levels: at threshold 7 about a
    fifth of its pixels pass the compass pre-test and one in 60 holds a
    9-arc, as in a camera frame with large plain areas."""
    x = noise_slab(shape, seed)[None, None]
    for _ in range(2):
        x = torch.nn.functional.avg_pool2d(x, 9, 1, 4, count_include_pad=False)
    return ((x[0, 0] - 127.5) * 2.5 + 127.5).clamp(0, 255).contiguous()


def graph_time_ms(launch, per_graph: int = 20, replays: int = 10) -> float:
    """Device time per launch: `per_graph` launches captured in a CUDA graph,
    replayed `replays` times between two events."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            launch()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (per_graph * replays)


def cold_time_ms(launch, reps: int = 20) -> float:
    """Median device time of one launch that finds the L2 flushed: a write
    larger than the L2 runs before each, and two events bracket the launch
    alone (it is enqueued while the write still runs)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    launch()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        start.record()
        launch()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_time_ms(call, reps: int = 100) -> float:
    """Host time per call of a wrapper (enqueue only; synchronised after)."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e3


@contextlib.contextmanager
def _using(module, kernel: CudaKernel):
    """Route a wrapper module's launches to another build of its kernel."""
    old, module.kernel = module.kernel, kernel
    try:
        yield
    finally:
        module.kernel = old


def _variant(module, csrc: Path) -> CudaKernel:
    k = module.kernel
    return CudaKernel(f"{k.name}@{csrc}", str(csrc / k.source.name), k.symbol, k.argtypes)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", default=[], type=Path,
                    help="another directory holding fast_band.cu, fast_nms.cu and "
                         "their header, timed beside the package's")
    dirs = [CSRC_DIR] + [p.resolve() for p in ap.parse_args().csrc]

    from ..utils.synthetic import generate_sequence

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    cfg = OrbConfig()
    thr = (cfg.fast_threshold_hi, cfg.fast_threshold_lo)
    seq = generate_sequence(n_frames=1 + CHUNK, width=WIDTH, height=HEIGHT, fx=FX, seed=5)
    images = np.clip(seq.images, 0, 255).astype(np.uint8)[1:]
    band_slab, H0p, dims = frames_slab(images, cfg, band=True)
    nms_slab, _, _ = frames_slab(images, cfg, band=False)
    band_args = (*thr, H0p, dims, cfg.border, cfg.n_levels)
    inputs = {"frames": (band_slab, nms_slab),
              "noise": (noise_slab(band_slab.shape), noise_slab(nms_slab.shape)),
              "smooth": (smooth_slab(band_slab.shape), smooth_slab(nms_slab.shape))}

    variants = []
    for d in dirs:
        pair = (_variant(fast_band, d), _variant(fast_nms, d))
        for k in pair:
            k.function()
            print(f"[build] {k.name}")
            for line in k.build_log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build]   {line.strip()}")
        variants.append(pair)

    for label, (b_in, n_in) in inputs.items():
        b_ref = fast_band.fast_bands_plain(b_in, *band_args)
        n_ref = fast_nms.fast_nms_plain(n_in, *thr)
        b_out, n_out = fast_band.empty_outputs(b_in), (torch.empty_like(n_in),
                                                        torch.empty_like(n_in))
        print(f"[{label}] corners: band lo {int((b_ref[2] > 0).sum())}, "
              f"nms lo {int((n_ref[1] > 0).sum())}")
        for turn in list(range(len(variants))) + list(reversed(range(len(variants)))):
            kb, kn = variants[turn]
            with _using(fast_band, kb), _using(fast_nms, kn):
                got_b = fast_band.fast_nms_bands_hi_lo(b_in, *band_args)
                got_n = fast_nms.fast_nms_hi_lo(n_in, *thr)
                torch.cuda.synchronize()
                diff_b = sum(int((a != b).sum()) for a, b in zip(got_b, b_ref))
                diff_n = sum(int((a != b).sum()) for a, b in zip(got_n, n_ref))

                def run_b():
                    fast_band.launch(b_in, b_out, *band_args)

                def run_n():
                    fast_nms.launch(n_in, *n_out, *thr)

                print(f"[{label}] {dirs[turn]}: "
                      f"fast_band diff {diff_b} hot {graph_time_ms(run_b):.4f} ms cold "
                      f"{cold_time_ms(run_b):.4f} ms host "
                      f"{host_time_ms(lambda: fast_band.fast_nms_bands_hi_lo(b_in, *band_args)):.4f}"
                      f" ms; fast_nms diff {diff_n} hot {graph_time_ms(run_n):.4f} ms cold "
                      f"{cold_time_ms(run_n):.4f} ms host "
                      f"{host_time_ms(lambda: fast_nms.fast_nms_hi_lo(n_in, *thr)):.4f} ms")


if __name__ == "__main__":
    main()
