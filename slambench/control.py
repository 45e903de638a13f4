"""The control of a cell's output check: the plain reference put in the
program's place with one guarantee the configuration states broken.  The
settings state no precision; they state a camera rate, each frame's
outputs being that frame's.  The control returns every pose, keyframe and
feature set one frame late, as a tracker pipelined one frame deep would.
It has to come out as not correct; its readings set the upper end of each
limit.  `--kind bf16` gives a second witness: the reference stored in
bfloat16, the precision below the float32 the program computes in.

    python slambench/control.py --workload <cell> --seeds 11 12 13 [--kind late|bf16]

Prints one JSON line per seed with every number and whether the cell's
limits refuse it, at the cell's own size on the card.  The benchmark's own
runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def control(cell: str, seed: int, device, overrides: dict | None = None,
            kind: str = "late") -> dict:
    """The control's numbers for one seed, and whether the limits refuse them."""
    from slambench.harness import check, frames, spec
    from slambench.harness import settings as st

    overrides = overrides or {}
    w = spec.workload(cell)
    cfg = {**spec.config(w["config"]), **overrides.get("config", {})}
    mix = spec.traffic(w["traffic"])
    s = st.read(cfg)
    n = int(overrides.get("cycle_frames", mix["cycle_frames"]))
    start = int(overrides.get("start", frames.start_frame(seed, n)))
    cycle = frames.cell_cycle(s, cfg, mix, device, start, n)
    values = check.control_numbers(cycle, s, device, int(mix["frames_per_call"]),
                                   cfg["sensor"], kind)
    limits = overrides.get("limits") or spec.limits(cell)
    ok, checks = check.judge(values, limits)
    ok = ok and check.aligned(values)
    return {"cell": cell, "seed": seed, "kind": kind, "numbers": values, "correct": ok,
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kind", choices=("late", "bf16"), default="late")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed, args.device, kind=args.kind)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
