"""Trajectory evaluation: ATE RMSE (Horn/Umeyama alignment) and RPE.

Standalone equivalent of the TUM benchmark's evaluate_ate.py / evaluate_rpe.py
that the reference points users to (reference README.md:120-190) — needed
in-repo because accuracy parity is part of the bench harness.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid alignment src -> dst ([n, 3] each).

    Returns (s, R, t) minimizing || dst - (s R src + t) ||^2.
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / var_s
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    poses_est_cw: np.ndarray, poses_gt_cw: np.ndarray, with_scale: bool = False
) -> float:
    """Absolute trajectory error RMSE after alignment.

    Inputs are [n, 4, 4] Tcw (world->cam); compares camera centers.
    """
    def centers(poses):
        R = poses[:, :3, :3]
        t = poses[:, :3, 3]
        # c = -R^T t; einsum contracts over the row index of R.
        return -np.einsum("nij,ni->nj", R, t)

    c_est = centers(np.asarray(poses_est_cw, np.float64))
    c_gt = centers(np.asarray(poses_gt_cw, np.float64))
    s, R, t = umeyama_alignment(c_est, c_gt, with_scale)
    aligned = (s * (R @ c_est.T)).T + t
    err = np.linalg.norm(aligned - c_gt, axis=1)
    return float(np.sqrt((err**2).mean()))


def rpe_rmse(
    poses_est_cw: np.ndarray, poses_gt_cw: np.ndarray, delta: int = 1
) -> tuple[float, float]:
    """Relative pose error (translational m, rotational rad) over `delta` frames."""
    est = np.asarray(poses_est_cw, np.float64)
    gt = np.asarray(poses_gt_cw, np.float64)
    t_errs, r_errs = [], []
    for i in range(len(est) - delta):
        d_est = est[i + delta] @ np.linalg.inv(est[i])
        d_gt = gt[i + delta] @ np.linalg.inv(gt[i])
        e = np.linalg.inv(d_gt) @ d_est
        t_errs.append(np.linalg.norm(e[:3, 3]))
        cos = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        r_errs.append(np.arccos(cos))
    return float(np.sqrt(np.mean(np.square(t_errs)))), float(
        np.sqrt(np.mean(np.square(r_errs)))
    )
