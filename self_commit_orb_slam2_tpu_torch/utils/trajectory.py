"""Trajectory export in TUM and KITTI formats (reference
System::SaveTrajectoryTUM / SaveKeyFrameTrajectoryTUM / SaveTrajectoryKITTI,
src/System.cc:414-607).  Poses are Tcw; the files store camera-in-world, TUM
as `t tx ty tz qx qy qz qw`, KITTI as row-major 3x4.  The port's own copy of
the JAX package's utils/trajectory.py."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import se3


def _inverse_np(Tcw: np.ndarray) -> np.ndarray:
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    out = np.eye(4, dtype=np.float64)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def save_tum(path: str, timestamps: np.ndarray, poses_cw: np.ndarray) -> None:
    """poses_cw: [n, 4, 4] Tcw."""
    with open(path, "w") as f:
        for ts, Tcw in zip(timestamps, poses_cw):
            Twc = _inverse_np(np.asarray(Tcw, np.float64))
            q = se3.rot_to_quat(torch.tensor(Twc[:3, :3], dtype=torch.float32)).numpy()
            t = Twc[:3, 3]
            f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def save_kitti(path: str, poses_cw: np.ndarray) -> None:
    with open(path, "w") as f:
        for Tcw in poses_cw:
            Twc = _inverse_np(np.asarray(Tcw, np.float64))
            row = Twc[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def load_tum(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (timestamps [n], poses_wc [n, 4, 4] camera-in-world)."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    poses = []
    for r in data:
        T = np.eye(4)
        T[:3, :3] = se3.quat_to_rot(torch.tensor(r[4:8], dtype=torch.float32)).numpy()
        T[:3, 3] = r[1:4]
        poses.append(T)
    return data[:, 0], np.stack(poses)
