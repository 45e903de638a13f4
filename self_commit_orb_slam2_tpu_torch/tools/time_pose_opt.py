"""Time pose_optimize's kernel (csrc/pose_opt.cu) on the card beside the
plain version, and check it against the plain version there.

    python -m self_commit_orb_slam2_tpu_torch.tools.time_pose_opt [--out FILE]

At the tracking step's shapes: one pose of 1,024 RGB-D rows (TUM1's feature
capacity), one of 2,048 stereo rows (KITTI's), and relocalization's five
poses of 1,024 rows in one launch (under torch.vmap).  For each case: the
kernel against the plain version on the card (Tcw within 1e-4, the inliers
within 2 rows: sums in another order), the kernel's device time (launches
replayed from a CUDA graph), the plain version's (its own graph's replay,
as the step replays it), the wrapper's host time per call, and the kernel's
latency bound.

The bound.  The kernel runs one block a pose on one SM, and its iterations
are dependent steps.  An iteration issues ~ROW_INSTR instructions a row
(the residual and Jacobian, the weights, the 81 products of the normal
equations) on one SM's 128 lanes, then waits for ~SERIAL_CYCLES of one
dependent chain: the shuffle tree and the warps' sums, two barriers, the
6x6 LU with partial pivoting and its back substitution on one thread, and
the exponential map.  So an iteration takes at least N x ROW_INSTR / 128 +
SERIAL_CYCLES cycles at the card's largest SM clock, and a call at least
that times the iterations the freeze rule lets run on these inputs (40 at
most; counted by the plain version, `pose_optimize_plain(iterations=)`).
Poses of one launch run on separate SMs at once.  Prints one JSON line a
case and a last line with every case.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..ops import se3
from ..ops.camera import CameraParams
from ..ops.optim import pose_opt
from ..utils.profiling import card_line
from .time_fast import graph_time_ms, host_time_ms

CAM = CameraParams.create(fx=520.0, fy=520.0, cx=320.0, cy=240.0, bf=40.0)
ROW_INSTR = 150        # instructions a row an iteration (counted from the source)
SERIAL_CYCLES = 1000   # the dependent chain of an iteration, cycles
CASES = (("rgbd", 1024, 1), ("stereo", 2048, 1), ("mixed", 1024, 5))


def pose_problem(kind: str, n: int, seed: int = 0):
    """(T_true, (Tcw0, pts_w, obs, sigma2, valid), ur_weight) as the tracker
    hands them over, made with numpy from `seed`.  kind "rgbd": every row
    with a u_right from depth, ur_weight 25; "stereo": every row with a
    disparity, ur_weight 1; "mixed": a third mono (u_right -1), a fifth
    outliers, ur_weight 25.  About a tenth of the rows invalid, their points
    at the world's origin (an empty pool slot)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    T_true = se3.se3_exp(torch.tensor([0.1, -0.05, 0.2, 0.03, -0.02, 0.05])).numpy()
    pc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    u = CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx
    v = CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy
    sigma2 = (1.2 ** (2 * rng.integers(0, 8, n))).astype(np.float32)
    noise = rng.normal(0.0, 1.0, (n, 3)) * np.sqrt(sigma2)[:, None] * 0.5
    obs = np.stack([u, v, u - CAM.bf / pc[:, 2]], -1) + noise
    if kind == "mixed":
        obs[rng.random(n) < 1 / 3, 2] = -1.0
        out = rng.random(n) < 0.2
        k = int(out.sum())
        obs[out, :2] += rng.uniform(15, 60, (k, 2)) * rng.choice([-1, 1], (k, 2))
    valid = rng.random(n) < 0.9
    pts[~valid] = 0.0
    T0 = se3.se3_exp(torch.tensor([0.04, 0.03, -0.05, 0.012, -0.02, 0.015])).numpy() @ T_true
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        T0.astype(np.float32), pts, obs.astype(np.float32), sigma2, valid))
    return T_true, args, (1.0 if kind == "stereo" else 25.0)


def batch_problem(kind: str, n: int, b: int, device):
    """b poses of one problem: initial poses moved apart (a seeded draw), the
    rows' selections thinned differently, the observations shared."""
    _, (T0, pts, obs, sigma2, valid), urw = pose_problem(kind, n)
    if b == 1:
        return (T0, pts, obs, sigma2, valid), urw
    rng = np.random.default_rng(2)
    T0s = torch.stack([se3.se3_exp(torch.from_numpy(rng.normal(0, 0.01, 6).astype(np.float32)))
                       @ T0 for _ in range(b)])
    sel = valid[None] & torch.from_numpy(rng.random((b, n)) < 0.8)
    return (T0s, pts, obs, sigma2, sel), urw


def iterations_run(Tcw0, pts_w, obs, sigma2, valid, ur_weight: float) -> int:
    """The Gauss-Newton steps the freeze rule lets run on one pose (the
    kernel's), as the plain version counts them."""
    rounds: list = []
    pose_opt.pose_optimize_plain(CAM, Tcw0, pts_w, obs, sigma2, valid, ur_weight=ur_weight,
                                 iterations=rounds)
    return sum(rounds)


def sm_clock_mhz() -> float:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=False, timeout=60)
    return float(smi.stdout.split()[0]) if smi.returncode == 0 else 1980.0


def bound_ms(n: int, iterations: int, clock_mhz: float) -> float:
    return iterations * (n * ROW_INSTR / 128 + SERIAL_CYCLES) / (clock_mhz * 1e3)


def run_case(kind: str, n: int, b: int, clock_mhz: float) -> dict:
    dev = torch.device("cuda")
    (T0, pts, obs, sigma2, valid), urw = batch_problem(kind, n, b, dev)
    T0, pts, obs, sigma2, valid = (t.to(dev) for t in (T0, pts, obs, sigma2, valid))
    if b == 1:
        call = lambda: pose_opt.pose_optimize(CAM, T0, pts, obs, sigma2, valid,  # noqa: E731
                                              ur_weight=urw)
        plain = lambda: pose_opt.pose_optimize_plain(CAM, T0, pts, obs, sigma2,  # noqa: E731
                                                     valid, ur_weight=urw)
        poses = [(T0, valid)]
    else:
        call = lambda: torch.vmap(  # noqa: E731
            lambda T, s: pose_opt.pose_optimize(CAM, T, pts, obs, sigma2, s, ur_weight=urw))(
                T0, valid)
        plain = lambda: torch.vmap(  # noqa: E731
            lambda T, s: pose_opt.pose_optimize_plain(CAM, T, pts, obs, sigma2, s,
                                                      ur_weight=urw))(T0, valid)
        poses = list(zip(T0, valid))
    got, ref = call(), plain()
    launches = pose_opt.kernel.launches
    pose_opt.device_launches(reset=True)
    again = call()
    launches = pose_opt.kernel.launches - launches
    ran = pose_opt.device_launches()
    torch.cuda.synchronize()
    repeats = all(torch.equal(a, c) for a, c in zip(got, again))
    if b == 1:   # one pose: the outputs without a batch
        got, ref = [t[None] for t in got], [t[None] for t in ref]
    pose_err = float((got[0] - ref[0]).abs().max())
    rows = int((got[1] != ref[1]).sum(-1).max())
    iters = [iterations_run(T.cpu(), pts.cpu(), obs.cpu(), sigma2.cpu(), v.cpu(), urw)
             for T, v in poses]
    kernel_ms = graph_time_ms(call)
    plain_ms = graph_time_ms(plain, per_graph=1, replays=5)
    row = dict(case=kind, rows=n, poses=b, launches_a_call=launches, device_launches=ran,
               repeats_bitwise=repeats, max_pose_err=pose_err, max_inlier_rows=rows,
               n_inliers=[int(x) for x in got[2].flatten()],
               iterations=iters, kernel_ms=kernel_ms, plain_graphed_ms=plain_ms,
               host_ms=host_time_ms(call), bound_ms=bound_ms(n, max(iters), clock_mhz),
               bound_full_budget_ms=bound_ms(n, 40, clock_mhz),
               ok=bool(repeats and launches == 1 and ran == 1 and pose_err <= 1e-4
                       and rows <= 2))
    row["x_bound"] = row["kernel_ms"] / row["bound_ms"]
    row["speedup"] = row["plain_graphed_ms"] / row["kernel_ms"]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_pose_opt: needs a CUDA card")
    clock = sm_clock_mhz()
    print(f"[pose_opt] {card_line()}, SM clock {clock:.0f} MHz; build: "
          f"{pose_opt.kernel.build().name}")
    for line in pose_opt.kernel.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[pose_opt]   {line.strip()}")
    rows = [run_case(kind, n, b, clock) for kind, n, b in CASES]
    for row in rows:
        print(json.dumps(row))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    print(json.dumps({"ok": all(r["ok"] for r in rows), "cases": len(rows)}))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
