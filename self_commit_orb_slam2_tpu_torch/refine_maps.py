"""Offline multi-map refinement CLI.

The port's version of the JAX package's refine_maps.py: jointly refines
saved map checkpoints (models/checkpoint.py npz files, either package's) on
a mesh of ranks: distributed Sim3 pose graph + distributed Schur global BA
per map, maps data-parallel over the "map" axis (parallel/multi_map.py).
The batch analogue of the reference's LoopClosing::RunGlobalBundleAdjustment
(src/LoopClosing.cc:880) run over N sequences at once, e.g. the KITTI
00+02+05 multi-sequence configuration.

Usage (one process; under torchrun every rank runs the same command and
`parallel.hosts.initialize` wires them):
  python -m self_commit_orb_slam2_tpu_torch.refine_maps m0.npz m1.npz \
      --settings TUM1.yaml [--mesh MAPxBLK] [--no-pose-graph] [--suffix .refined.npz]

The maps are refined on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("maps", nargs="+", help="map checkpoint npz files")
    ap.add_argument("--settings", required=True,
                    help="reference-style YAML with the camera parameters the "
                    "maps were built with (required: refining against default "
                    "intrinsics silently corrupts the maps)")
    ap.add_argument("--mesh", default=None,
                    help="MAPxBLK rank grid, e.g. 2x4 (default: every rank on "
                    "the blk axis of a 1xN mesh)")
    ap.add_argument("--ba-iters", type=int, default=10)
    ap.add_argument("--pg-iters", type=int, default=20)
    ap.add_argument("--no-pose-graph", action="store_true")
    ap.add_argument("--suffix", default=".refined.npz",
                    help="output path suffix replacing .npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the maps (default cuda; cpu on purpose)")
    args = ap.parse_args(argv)

    from .models.checkpoint import load_map, save_map
    from .models.system import resolve_device
    from .parallel import hosts
    from .parallel.mesh import MeshSpec, make_mesh, world
    from .parallel.multi_map import joint_refine
    from .utils.config_io import load_settings

    device = resolve_device(args.device)
    hosts.initialize()
    maps = [load_map(p, device=device) for p in args.maps]
    shapes = {tuple(m.kf_Tcw.shape) + tuple(m.pt_pos.shape) for m in maps}
    if len(shapes) != 1:
        print("error: maps have different capacities; refine same-config "
              "maps together", file=sys.stderr)
        return 2

    if args.mesh:
        n_map, n_blk = (int(x) for x in args.mesh.split("x"))
    else:
        n_map, n_blk = 1, world()[1]
    mesh = make_mesh(MeshSpec(n_map=n_map, n_blk=n_blk))

    cfg = load_settings(args.settings, sensor="rgbd", width=640, height=480)
    P = maps[0].max_pt
    if P % n_blk:
        print(f"error: point capacity {P} not divisible by blk={n_blk}",
              file=sys.stderr)
        return 2

    # process in groups of n_map (the data-parallel width)
    for lo in range(0, len(maps), n_map):
        group = maps[lo:lo + n_map]
        pad = n_map - len(group)
        group = group + [group[-1]] * pad
        refined = joint_refine(
            mesh, cfg, group,
            pg_iters=args.pg_iters, ba_iters=args.ba_iters,
            run_pose_graph=not args.no_pose_graph,
        )
        for i, m in enumerate(refined[: n_map - pad]):
            src = args.maps[lo + i]
            dst = src[:-4] + args.suffix if src.endswith(".npz") else src + args.suffix
            if hosts.is_coordinator():
                save_map(dst, m)
            print(f"{src} -> {dst}  (kf={int(m.n_kf)} pt={int(m.n_pt)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
