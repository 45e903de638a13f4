"""chip_smoke.py path 6's stream through two port Systems in lockstep, on the card.

    python scripts/port_lockstep.py [--root DIR] [--until FRAME]

Two Systems at bench.py's default RGB-D configuration with the bundled
vocabulary, one with its loop closer's graphs and one with the closer op by
op (its step graphs on), are fed the same chunks of the drifting circle of
chip_smoke.py path 6 (generate_sequence(seed=5), 120 frames a revolution,
the drift injected after every chunk whose last frame lies in frames 9 to
120), one chunk each in turn, up to frame --until (default 121).  After
each chunk it prints whether the two maps are equal bit for bit, the
largest keyframe-pose and point differences, the keyframe counts, the
closures and each System's last verified detection; and the first chunk
where the maps differ, with the fields that differ.  --root runs another
checkout's port (and its chip_smoke.py), e.g. a parent commit unpacked
with git archive.
"""

import argparse
import os
import sys
import time

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
parser.add_argument("--until", type=int, default=121)
args = parser.parse_args()
sys.path.insert(0, os.path.abspath(args.root))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from self_commit_orb_slam2_tpu_torch.models.system import System  # noqa: E402
from self_commit_orb_slam2_tpu_torch.ops import bow  # noqa: E402
from self_commit_orb_slam2_tpu_torch.utils.drift import make_injector, se3_increment  # noqa: E402
from self_commit_orb_slam2_tpu_torch.utils.synthetic import (  # noqa: E402
    circle_trajectory, generate_sequence)


def last_detection(slam):
    return [(d["kf_counter"], d["found"], d["chain"], d["n_inliers"], d["n_proj"])
            for d in slam._loop_closer.debug_log[-1:]]


def main() -> int:
    print(f"root {os.path.abspath(args.root)}; {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    seq = generate_sequence(n_frames=cs.N_LOOP, width=cs.WIDTH, height=cs.HEIGHT, fx=cs.FX,
                            seed=5, trajectory=circle_trajectory(cs.N_LOOP,
                                                                 frames_per_rev=cs.LOOP_REV))
    print(f"rendered {cs.N_LOOP} frames in {time.perf_counter() - t0:.1f} s (host)", flush=True)
    cfg = cs._bench_config(bow.load_vocabulary(bow.default_vocab_path()))
    systems = {}
    for graphed in (True, False):
        slam = System(cfg)
        if not graphed:
            slam._loop_closer.graphs = None
        slam.warm_start()
        systems[graphed] = slam
    images = cs._u8(seq.images)
    depths = np.clip(seq.depths * 1e3, 0, 65535).astype(np.uint16)
    C = cs.CHUNK
    dD = torch.linalg.matrix_power(se3_increment(cs.DRIFT_TWIST).double(), C).float().cuda()
    inject = {g: make_injector(keep_recent=6) for g in systems}
    sess = {g: s.open_stream("rgbd", C) for g, s in systems.items()}
    for g in systems:
        sess[g].feed((images[:1 + C], depths[:1 + C]), seq.timestamps[:1 + C])
    done, first = 1 + C, None
    while done < min(args.until, cs.N_LOOP):
        sl = slice(done, min(done + C, cs.N_LOOP))
        for g, slam in systems.items():
            sess[g].feed((images[sl], depths[sl]), seq.timestamps[sl])
        done = sl.stop
        for g, slam in systems.items():
            if cs.DRIFT_FROM <= done <= cs.DRIFT_TO:
                slam.map = inject[g](slam.map, dD, 1.0)
        mg, me = systems[True].map, systems[False].map
        same = all(torch.equal(a, b) for a, b in zip(mg, me))
        print(f"frame {done}: maps bitwise {same}, max |pose difference| "
              f"{float((mg.kf_Tcw - me.kf_Tcw).abs().max()):.2e}, max |point difference| "
              f"{float((mg.pt_pos - me.pt_pos).abs().max()):.2e}, keyframes "
              f"{int(mg.n_kf)} / {int(me.n_kf)}, closures "
              f"{systems[True]._loop_closer.n_big_changes} / "
              f"{systems[False]._loop_closer.n_big_changes}, last detection (counter, found, "
              f"chain, inliers, projections) {last_detection(systems[True])} / "
              f"{last_detection(systems[False])}", flush=True)
        if not same and first is None:
            first = done
            print(f"first divergence at frame {done}: " + ", ".join(
                f for f, a, b in zip(type(mg)._fields, mg, me) if not torch.equal(a, b)),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
