"""Does path 9 (a)'s drift without loop closing follow the bootstrap's draws?

    python -m self_commit_orb_slam2_tpu_torch.tools.mono_draws

Run from the repository root: it reuses chip_smoke.py's path 9 (a) (the
frames, bench_long_mono's configuration, the drift injected per chunk).
The mono bootstrap draws its two-view RANSAC sets from its own generator
(seed 11), and the card's stream and the CPU's differ.  This runs:
  1. on the CPU, the bootstrap of path 9 (a) through the per-frame path
     until the map exists, recording each attempt's minimal sets
     (two_view._sample_minimal_sets) and the frames it took;
  2. on the card, path 9 (a) without loop closing, its own draws;
  3. on the card, the same with attempt k's draws replaced by the CPU's
     attempt k (moved to the card; later attempts, if any, draw as usual).
Prints, for each card run, the frames the bootstrap took and the
Sim3-aligned ATE against the trailing ground truth, with the card's name
and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor


def main() -> int:
    import chip_smoke as cs

    from ..models import loop_closing, pipeline
    from ..models.system import STATE_OK, System
    from ..ops import bow
    from ..ops.solvers import two_view
    from ..utils.synthetic import circle_trajectory

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[mono_draws] {card.strip()}", flush=True)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(6, mp_context=multiprocessing.get_context("spawn")) as pool:
        seq = cs._join_frames(cs._submit_frames(
            pool, circle_trajectory(cs.N_LOOP, frames_per_rev=cs.LOOP_REV), 6,
            width=cs.WIDTH, height=cs.HEIGHT, fx=cs.FX, seed=5))
    print(f"[mono_draws] {len(seq.images)} frames rendered in {time.perf_counter() - t0:.1f} s "
          "(host)", flush=True)
    vocab = bow.load_vocabulary(bow.default_vocab_path())
    cfg = cs._mono_loop_config(vocab)
    orig = two_view._sample_minimal_sets

    # 1. the CPU's bootstrap and its draws
    drawn = []

    def record(valid, n_hyp, generator, set_size=8):
        sets = orig(valid, n_hyp, generator, set_size)
        drawn.append(sets.clone())
        return sets

    two_view._sample_minimal_sets = record
    try:
        cpu = System(cfg, enable_loop_closing=False, device="cpu")
        images = cs._u8(seq.images)
        n = 0
        while cpu.state != STATE_OK and n < 8:
            cpu.track_monocular(images[n], float(seq.timestamps[n]))
            n += 1
    finally:
        two_view._sample_minimal_sets = orig
    print(f"[mono_draws] CPU: initialized after {n} frames, {len(drawn)} two-view attempts "
          f"(state {cpu.state})", flush=True)

    # 2 and 3. the card, its own draws, then the CPU's
    kernels = cs.phase_build()
    for use_cpu_draws in (False, True):
        k = [0]

        def replay(valid, n_hyp, generator, set_size=8):
            if k[0] < len(drawn):
                k[0] += 1
                return drawn[k[0] - 1].to(valid.device)
            return orig(valid, n_hyp, generator, set_size)

        two_view._sample_minimal_sets = replay if use_cpu_draws else orig
        try:
            slam = System(cfg, enable_loop_closing=False)
            with loop_closing.timed_phases() as ph, pipeline.timed_mapping_passes():
                run = cs._mono_stream("mono_draws", slam, seq, kernels, ph)
        finally:
            two_view._sample_minimal_sets = orig
        print(f"[mono_draws] card, {'the CPU' if use_cpu_draws else 'its own'} draws: "
              f"initialized after {run['n_boot']} frames ({k[0]} CPU attempts fed), state "
              f"{slam.state}, keyframes {run['n_kf']}, drift chunks {run['n_drift']}, "
              f"Sim3-aligned ATE {run['ate']:.6f} m over {run['n_poses']} poses", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
