"""Motion-only bundle adjustment (pose optimization).

Counterpart of the JAX package's ops/optim/pose_opt.py (reference
Optimizer::PoseOptimization, src/Optimizer.cc:363-627): 4 rounds of up to 10
Gauss-Newton iterations, Huber in the first two rounds, chi2
reclassification (5.991 / 7.815) between rounds, information 1/sigma2.

The JAX version leaves each round's loop once a step moves the pose by less
than 1e-6 (squared).  Here every round runs its 10 iterations and freezes the
pose after the first such step: the same fixed point, and no host sync on the
card to decide whether to go on.

`pose_optimize` on a CUDA tensor launches the hand-written kernel
`csrc/pose_opt.cu` (one block a pose, every iteration inside it; it leaves a
round's loop at the freeze) through the custom op `slam_torch::pose_optimize`,
or raises.  The op takes a leading batch of poses: its vmap rule folds a
vmapped dimension into that batch, so relocalization's vmapped candidates are
one launch of one block each.

On any other device `pose_optimize` calls `pose_optimize_plain`, the function
in plain torch, directly, which the CPU tests hold against the JAX package.
The direct call is kept on purpose: the step's host-free checks
(tests/test_torch_step_graph.py) count the core's aten ops and run the core
on the meta device, where a host read raises, and behind the op the plain
version's body would be hidden from both (the op's fake gives only shapes).
The op's CPU implementation, the plain version pose by pose, is what lets the
CPU tests hold the op's vmap rule, which the card takes, to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import se3
from ...kernels import CudaKernel, check_launch
from ...utils import profiling
from ..constants import constant
from ..camera import CameraParams
from .robust import CHI2_MONO, CHI2_STEREO, huber_weight

MAX_ROWS = 4096   # rows the kernel takes a pose (csrc/pose_opt.cu kMaxRows)

kernel = CudaKernel(
    "pose_opt", "pose_opt.cu", "pose_opt_launch",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_float] * 7
    + [ctypes.c_int] * 2 + [ctypes.c_void_p],
)


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor        # [4, 4] optimized pose
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # scalar int32
    chi2: torch.Tensor       # [N] final per-observation chi2


def _residuals_jacobians(cam: CameraParams, Tcw, pts_w, obs, is_stereo):
    """Residuals [N, 3] and Jacobians [N, 3, 6] wrt a left se3 update (third
    row zero for mono).  obs: [N, 3] = (u, v, u_right), u_right < 0 = mono."""
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    pc = pts_w @ R.T + t
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z

    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    res = torch.stack([u - obs[:, 0], v - obs[:, 1],
                       torch.where(is_stereo, ur - obs[:, 2], 0.0)], dim=-1)

    zero = torch.zeros_like(z)
    du_dpc = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], dim=-1)
    dv_dpc = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
    dur_dpc = du_dpc + torch.stack([zero, zero, cam.bf * inv_z2], dim=-1)
    duvw_dpc = torch.stack([du_dpc, dv_dpc, dur_dpc], dim=-2)      # [N, 3, 3]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    dpc_dxi = torch.cat([eye, -se3.hat(pc)], dim=-1)                # [N, 3, 6]
    J = duvw_dpc @ dpc_dxi
    row_w = torch.stack([torch.ones_like(z), torch.ones_like(z),
                         is_stereo.to(J.dtype)], dim=-1)
    return res, J * row_w[:, :, None]


def _chi2(res, inv_sigma2, is_stereo):
    e2 = torch.sum(res[:, :2] ** 2, dim=-1) + torch.where(is_stereo, res[:, 2] ** 2, 0.0)
    return e2 * inv_sigma2


def pose_optimize(cam: CameraParams, Tcw0: torch.Tensor, pts_w: torch.Tensor,
                  obs: torch.Tensor, sigma2: torch.Tensor, valid: torch.Tensor,
                  n_rounds: int = 4, n_iters: int = 10, damping: float = 1e-5,
                  ur_weight: float = 1.0) -> PoseOptResult:
    """Optimize Tcw [4, 4] against map points pts_w [N, 3] observed at obs
    [N, 3] = (u, v, u_right) (u_right < 0: mono) with variances sigma2 [N];
    invalid rows are zero-weighted.

    ur_weight: extra information on the u_right (disparity) residual; RGB-D
    depth is far more precise than one pixel of disparity.

    On the card one kernel launch (or a raise); elsewhere the plain version."""
    profiling.count("pose_opt.calls")
    if Tcw0.device.type != "cuda":
        return pose_optimize_plain(cam, Tcw0, pts_w, obs, sigma2, valid, n_rounds,
                                   n_iters, damping, ur_weight)
    out = torch.ops.slam_torch.pose_optimize(
        Tcw0[None], pts_w[None], obs[None], sigma2[None], valid[None], _camera(cam),
        n_rounds, n_iters, damping, ur_weight)
    return PoseOptResult(*(o[0] for o in out))


def pose_optimize_plain(cam: CameraParams, Tcw0: torch.Tensor, pts_w: torch.Tensor,
                        obs: torch.Tensor, sigma2: torch.Tensor, valid: torch.Tensor,
                        n_rounds: int = 4, n_iters: int = 10, damping: float = 1e-5,
                        ur_weight: float = 1.0, iterations: list | None = None) -> PoseOptResult:
    """The plain torch version of the kernel (pose_optimize's arguments).

    iterations: if a list, gets one int a round, the Gauss-Newton steps the
    freeze rule lets that round run (the freezing step included): the steps
    the kernel runs.  Reading them syncs the host."""
    dev = Tcw0.device
    is_stereo = obs[:, 2] >= 0.0
    inv_sigma2 = 1.0 / torch.clamp_min(sigma2, 1e-9)
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    sw = constant((1.0, 1.0, ur_weight**0.5), torch.float32, dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def gn_iteration(T, active, use_huber):
        res, J = _residuals_jacobians(cam, T, pts_w, obs, is_stereo)
        res = res * sw
        J = J * sw[:, None]
        chi2 = _chi2(res, inv_sigma2, is_stereo)
        w_rob = huber_weight(chi2, chi2_th) if use_huber else torch.ones_like(chi2)
        w = inv_sigma2 * w_rob * active.to(res.dtype)
        Jw = J * w[:, None, None]
        H = torch.einsum("nij,nik->jk", Jw, J)
        b = torch.einsum("nij,ni->j", Jw, res)
        H = H + damping * torch.diag(torch.diag(H)) + 1e-9 * eye6
        dx = torch.linalg.solve_ex(H, -b)[0]
        ok = torch.all(torch.isfinite(dx)) & (torch.linalg.norm(dx) < 1e3)
        return se3.update_left(T, torch.where(ok, dx, 0.0))

    T = Tcw0
    active = valid
    for round_idx in range(n_rounds):
        done = torch.zeros((), dtype=torch.bool, device=dev)
        ran = 0
        for _ in range(n_iters):
            T_new = gn_iteration(T, active, round_idx < 2)
            delta = torch.sum((T_new[:3] - T[:3]) ** 2)
            T = torch.where(done, T, T_new)
            if iterations is not None:
                ran += int(not done)
            done = done | (delta <= 1e-6)
        if iterations is not None:
            iterations.append(ran)
        res, _ = _residuals_jacobians(cam, T, pts_w, obs, is_stereo)
        active = valid & (_chi2(res, inv_sigma2, is_stereo) <= chi2_th)
    res, _ = _residuals_jacobians(cam, T, pts_w, obs, is_stereo)
    chi2 = _chi2(res, inv_sigma2, is_stereo)
    return PoseOptResult(Tcw=T, inliers=active,
                         n_inliers=torch.sum(active).to(torch.int32), chi2=chi2)


# ------------------------------------------------------------------ the op


def device_launches(reset: bool = False) -> int:
    """The kernel's launches the current card has run, counted on the card
    (csrc/pose_opt.cu g_launches): graph replays and conditional nodes
    included, which the wrapper's `kernel.launches` cannot see.  Syncs the
    card; zeroes the count if `reset`."""
    fn = ctypes.CDLL(str(kernel.build())).pose_opt_device_launches
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    n = fn(int(reset))
    if n < 0:
        raise RuntimeError("pose_opt: reading the device's launch count failed")
    return n


def _camera(cam: CameraParams) -> list:
    """The intrinsics the optimization reads, as the op takes them."""
    return [cam.fx, cam.fy, cam.cx, cam.cy, cam.bf]


@torch.library.custom_op("slam_torch::pose_optimize", mutates_args=(), device_types="cpu")
def _pose_optimize_op(Tcw0: torch.Tensor, pts_w: torch.Tensor, obs: torch.Tensor,
                      sigma2: torch.Tensor, valid: torch.Tensor, cam: list[float],
                      n_rounds: int, n_iters: int, damping: float,
                      ur_weight: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """B poses at once: Tcw0 [B, 4, 4], pts_w and obs [B, N, 3], sigma2 and
    valid [B, N] -> (Tcw [B, 4, 4], inliers [B, N], n_inliers [B] int32,
    chi2 [B, N]).  The CPU implementation: the plain version, pose by pose."""
    fx, fy, cx, cy, bf = cam
    c = CameraParams.create(fx=fx, fy=fy, cx=cx, cy=cy, bf=bf)
    outs = [pose_optimize_plain(c, *args, n_rounds, n_iters, damping, ur_weight)
            for args in zip(Tcw0, pts_w, obs, sigma2, valid)]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _empty_outputs(Tcw0: torch.Tensor, pts_w: torch.Tensor):
    B, N = pts_w.shape[:2]
    return (Tcw0.new_empty((B, 4, 4)), torch.empty((B, N), dtype=torch.bool, device=Tcw0.device),
            torch.empty((B,), dtype=torch.int32, device=Tcw0.device), pts_w.new_empty((B, N)))


def _check(Tcw0, pts_w, obs, sigma2, valid) -> None:
    B, N = pts_w.shape[:2] if pts_w.ndim == 3 else (-1, -1)
    want = (("Tcw0", Tcw0, (B, 4, 4), torch.float32), ("pts_w", pts_w, (B, N, 3), torch.float32),
            ("obs", obs, (B, N, 3), torch.float32), ("sigma2", sigma2, (B, N), torch.float32),
            ("valid", valid, (B, N), torch.bool))
    for name, t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != pts_w.device:
            raise ValueError(f"pose_opt: {name} must be {dtype} of shape [B, ...] = {shape} "
                             f"on {pts_w.device} (pts_w [B, N, 3] gives B, N); got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if N > MAX_ROWS:
        raise ValueError(f"pose_opt: the kernel takes at most {MAX_ROWS} rows a pose, got {N}")


@_pose_optimize_op.register_kernel("cuda")
def _pose_optimize_cuda(Tcw0, pts_w, obs, sigma2, valid, cam, n_rounds, n_iters, damping,
                        ur_weight):
    """The CUDA implementation: one launch of csrc/pose_opt.cu, a block a pose."""
    _check(Tcw0, pts_w, obs, sigma2, valid)
    if n_rounds < 0 or n_iters < 0:
        raise ValueError(f"pose_opt: need n_rounds, n_iters >= 0, got {n_rounds}, {n_iters}")
    ins = [t.contiguous() for t in (Tcw0, pts_w, obs, sigma2, valid)]
    outs = _empty_outputs(Tcw0, pts_w)
    B, N = pts_w.shape[:2]
    fn = kernel.function()
    with torch.cuda.device(Tcw0.device):
        stream = torch.cuda.current_stream(Tcw0.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs), B, N, *cam,
                ur_weight**0.5, damping, n_rounds, n_iters, stream)
    check_launch(kernel, rc)
    return outs


@_pose_optimize_op.register_fake
def _pose_optimize_fake(Tcw0, pts_w, obs, sigma2, valid, cam, n_rounds, n_iters, damping,
                        ur_weight):
    _check(Tcw0, pts_w, obs, sigma2, valid)
    return _empty_outputs(Tcw0, pts_w)


@torch.library.register_vmap("slam_torch::pose_optimize")
def _pose_optimize_vmap(info, in_dims, Tcw0, pts_w, obs, sigma2, valid, *rest):
    """A vmapped dimension of V poses folds into the op's batch: the inputs
    it does not map over are repeated V times, the V x B poses are one call,
    and the outputs come back with the vmapped dimension in front."""
    V = info.batch_size

    def fold(t, d):
        t = t.movedim(d, 0) if d is not None else t.expand(V, *t.shape)
        return t.reshape(V * t.shape[1], *t.shape[2:])

    tensors = (Tcw0, pts_w, obs, sigma2, valid)
    outs = _pose_optimize_op(*(fold(t, d) for t, d in zip(tensors, in_dims)), *rest)
    return tuple(o.reshape(V, -1, *o.shape[1:]) for o in outs), (0, 0, 0, 0)
