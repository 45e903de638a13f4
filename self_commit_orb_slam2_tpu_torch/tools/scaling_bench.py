"""Weak scaling of the sharded bundle adjustment over the ranks of a world.

    torchrun --standalone --nproc_per_node W -m \\
        self_commit_orb_slam2_tpu_torch.tools.scaling_bench [--per-dev-points 512]
        [--kfs 8] [--obs-per-kf 256] [--iters 5] [--reps 3] [--device cpu]
        [--out SCALING_torch.json]

Counterpart of the JAX repository's scripts/scaling_bench.py: the load per
rank is held constant (a stripe of --per-dev-points map points a rank)
while the "blk" axis of parallel/distributed_ba.distributed_bundle_adjust
widens over 1, 2, 4, ... ranks of the world (at most W); the problem of
each width is drawn from one numpy generator (seed 0) in the JAX script's
order, on every rank alike.  One process a rank: hosts.initialize() reads
the world from torchrun's environment (gloo on the CPU, NCCL for the
card's tensors; with no torchrun, a world of one), each width builds
hosts.global_mesh(n_map=1, n_blk=blk) on every rank, and the ranks outside
it wait at a barrier outside the timed window.  Each width: one untimed
run, then the best of --reps on rank 0's host clock (synced).  On the card
each row also gives the peak memory allocated during the runs and the least
time of the dense Schur products ([6K, 3Pl] @ [3Pl, 6K] per iteration, at
the card's fp32 peak).  Rank 0 prints the table and writes --out (default
SCALING_torch.json at the repository root; the JAX package's SCALING.json
is its own record and is never written here).  Runs on the card unless
--device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops import se3
from ..ops.camera import CameraParams, project
from ..parallel import hosts
from ..parallel.distributed_ba import distributed_bundle_adjust
from ..parallel.mesh import world
from ..utils.profiling import card_line

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PEAK_FP32_PER_S = 67e12   # H100 SXM, published (no tensor cores)
WIDTHS = (1, 2, 4, 8, 16, 32)
CAMERA = CameraParams.create(fx=300.0, fy=300.0, cx=160.0, cy=120.0, bf=30.0, width=320,
                             height=240)


def build_problem(rng: np.random.Generator, cam: CameraParams, K: int, N: int, P: int):
    """The JAX script's problem of one width, drawn from rng in its order:
    points [1, P, 3] uniform in a box 5 m ahead, poses [1, K, 4, 4] from
    se3_exp of N(0, 0.05) twists, N distinct points a keyframe and their
    (u, v, u_right) projections [1, K, N, 3] (float32 numpy)."""
    pt = rng.uniform(-1, 1, (1, P, 3)).astype(np.float32)
    pt[..., 2] += 5.0
    poses = np.zeros((1, K, 4, 4), np.float32)
    obs_pt = np.zeros((1, K, N), np.int32)
    obs_uvr = np.zeros((1, K, N, 3), np.float32)
    for k in range(K):
        xi = torch.from_numpy(rng.normal(0, 0.05, 6).astype(np.float32))
        poses[0, k] = se3.se3_exp(xi).numpy()
        sel = rng.choice(P, N, replace=False).astype(np.int32)
        obs_pt[0, k] = sel
        pc = pt[0, sel] @ poses[0, k][:3, :3].T + poses[0, k][:3, 3]
        uv, _ = project(cam, torch.from_numpy(pc))
        uv = uv.numpy()
        ur = uv[:, 0] - float(cam.bf) / pc[:, 2]
        obs_uvr[0, k] = np.concatenate([uv, ur[:, None]], -1)
    return pt, poses, obs_pt, obs_uvr


def ba_inputs(problem, device) -> tuple:
    """distributed_bundle_adjust's tensor arguments for a problem, on device:
    unit sigma^2, every observation valid, keyframe 0 fixed, every point
    free."""
    pt, poses, obs_pt, obs_uvr = problem
    K, N, P = obs_pt.shape[1], obs_pt.shape[2], pt.shape[1]
    t = lambda a: torch.from_numpy(a).to(device)   # noqa: E731
    return (t(poses), t(pt), t(obs_pt), t(obs_uvr),
            torch.ones((1, K, N), dtype=torch.float32, device=device),
            torch.ones((1, K, N), dtype=torch.bool, device=device),
            t((np.arange(K) > 0)[None]), torch.ones((1, P), dtype=torch.bool, device=device))


def schur_bound_ms(K: int, Pl: int, iters: int) -> float:
    """Least time of one rank's dense Schur products, 2 (6K)^2 3Pl fp32
    operations an iteration, at the card's fp32 peak."""
    return iters * 2.0 * (6 * K) ** 2 * 3 * Pl / PEAK_FP32_PER_S * 1e3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--per-dev-points", type=int, default=512)
    ap.add_argument("--kfs", type=int, default=8)
    ap.add_argument("--obs-per-kf", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(ROOT, "SCALING_torch.json"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    if os.path.abspath(args.out) == os.path.join(ROOT, "SCALING.json"):
        raise ValueError("SCALING.json is the JAX package's record; write another --out")

    owned = not dist.is_initialized()
    hosts.initialize()   # torchrun's environment; a world of one without it
    rank, n_ranks = world()
    device = (torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda"
              else torch.device("cpu"))
    on_card = device.type == "cuda"
    K, N = args.kfs, args.obs_per_kf
    rng = np.random.default_rng(0)
    widths = [w for w in WIDTHS if w <= n_ranks]
    table = []
    for blk in widths:
        P = args.per_dev_points * blk   # weak scaling: a fixed stripe a rank
        inputs = ba_inputs(build_problem(rng, CAMERA, K, N, P), device)
        mesh = hosts.global_mesh(n_map=1, n_blk=blk)   # every rank makes its groups
        best, peak = np.inf, None
        if mesh.coords is not None:
            def run():
                out = distributed_bundle_adjust(mesh, CAMERA, *inputs, n_iters=args.iters)
                _sync(device)
                return out

            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
            out = run()   # untimed
            if not all(bool(torch.isfinite(x).all()) for x in out):
                raise RuntimeError(f"blk={blk}: non-finite bundle adjustment")
            for _ in range(args.reps):
                t0 = time.perf_counter()
                run()
                best = min(best, time.perf_counter() - t0)
            if on_card:
                peak = torch.cuda.max_memory_allocated(device)
        if dist.is_initialized():
            dist.barrier()
        row = {"devices": blk, "points": P, "ms": best * 1e3}
        if on_card:
            row.update(bound_ms=schur_bound_ms(K, args.per_dev_points, args.iters),
                       peak_bytes=peak)
        table.append(row)
        if rank == 0:
            extra = (f"  (Schur products' bound {row['bound_ms']:.3f} ms at "
                     f"{PEAK_FP32_PER_S / 1e12:.0f} TFLOP/s fp32; peak "
                     f"{peak / 2**30:.3f} GiB allocated)" if on_card else "")
            print(f"blk={blk:3d}  points={P:7d}  {best * 1e3:8.2f} ms{extra}", flush=True)
    if rank == 0:
        t1 = table[0]["ms"]
        print(f"\nweak-scaling efficiency vs blk={widths[0]} (ideal: flat time):")
        for row in table:
            row["efficiency_pct"] = t1 / row["ms"] * 100
            print(f"  blk={row['devices']:3d}: {row['efficiency_pct']:6.1f}%  "
                  f"({row['ms']:.2f} ms for {row['points']} pts)")
        name = torch.cuda.get_device_name(device) if on_card else "cpu"
        with open(args.out, "w") as f:
            json.dump({"kind": "weak_scaling_distributed_ba",
                       "per_device_points": args.per_dev_points, "kfs": K, "obs_per_kf": N,
                       "iters": args.iters, "backend": str(device), "device": name,
                       "world_size": n_ranks, "card": card_line() if on_card else None,
                       "table": table}, f, indent=1)
        print(f"wrote {args.out} ({name}, world of {n_ranks})")
    if owned:
        hosts.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
