"""What the tracker and the map should give, from the renderer's exact
poses and the room's planes (numpy, float64).

The program's world is the first tracked camera's frame, so a true pose
Tcw of the room is compared as Tcw @ inv(Tcw_first).  A monocular map has
neither that frame nor metres: it is brought onto the truth by one
similarity (align_sim3) before it is compared.
"""

from __future__ import annotations

import numpy as np


def inv_se3(T: np.ndarray) -> np.ndarray:
    """Inverse of [..., 4, 4] rigid transforms."""
    T = np.asarray(T, np.float64)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    out = np.zeros(T.shape, np.float64)
    Rt = np.swapaxes(R, -1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, t)
    out[..., 3, 3] = 1.0
    return out


def in_first_frame(poses_w: np.ndarray, first_w: np.ndarray) -> np.ndarray:
    """Room poses Tcw [..., 4, 4] in the first camera's frame."""
    return np.asarray(poses_w, np.float64) @ inv_se3(first_w)


def _angle_deg(R: np.ndarray) -> np.ndarray:
    """Rotation angle of [..., 3, 3] near-rotations, from the skew part and
    the trace (atan2: a matrix a rounding away from orthonormal reads its
    rotation, not the rounding)."""
    S = R - np.swapaxes(R, -1, -2)
    sin = np.linalg.norm(np.stack([S[..., 2, 1], S[..., 0, 2], S[..., 1, 0]], -1), axis=-1) / 2
    cos = (np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0
    return np.degrees(np.arctan2(sin, cos))


def pose_errors(est: np.ndarray, gt: np.ndarray):
    """Per pose: camera-centre distance (m) and rotation angle (degrees)
    between estimated and true Tcw [n, 4, 4]."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    c_est = inv_se3(est)[:, :3, 3]
    c_gt = inv_se3(gt)[:, :3, 3]
    R = np.swapaxes(gt[:, :3, :3], -1, -2) @ est[:, :3, :3]
    return np.linalg.norm(c_est - c_gt, axis=-1), _angle_deg(R)


def relative_errors(est: np.ndarray, gt: np.ndarray):
    """Frame-to-frame errors of consecutive poses [n, 4, 4]: the motion
    D_k = T_k inv(T_k-1) against the true one, E = inv(D_gt) D_est;
    returns its translation (m) and rotation angle (degrees), [n - 1]."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    d_est = est[1:] @ inv_se3(est[:-1])
    d_gt = gt[1:] @ inv_se3(gt[:-1])
    E = inv_se3(d_gt) @ d_est
    return np.linalg.norm(E[:, :3, 3], axis=-1), _angle_deg(E[:, :3, :3])


def surface_distance(points_w: np.ndarray, scene) -> np.ndarray:
    """Distance (m) of each room point [n, 3] to the nearest textured plane
    of the room: to its plane where the foot lies inside the plane's extent,
    plus how far the foot lies outside it."""
    p = np.asarray(points_w, np.float64)
    best = np.full(len(p), np.inf)
    for pl in scene.planes:
        n = pl.normal()
        rel = p - pl.origin
        h = rel @ n
        foot = rel - h[:, None] * n
        out2 = h * h
        for axis in (pl.u_axis, pl.v_axis):
            a = foot @ axis / (axis @ axis)
            out = np.maximum(np.maximum(-a, a - 1.0), 0.0) * np.linalg.norm(axis)
            out2 = out2 + out * out
        best = np.minimum(best, np.sqrt(out2))
    return best


def backproject(K: np.ndarray, xy: np.ndarray, depth: np.ndarray,
                Tcw: np.ndarray) -> np.ndarray:
    """Room points [n, 3] of pixels xy [n, 2] at depth [n] seen from Tcw."""
    x = (xy[:, 0] - K[0, 2]) / K[0, 0] * depth
    y = (xy[:, 1] - K[1, 2]) / K[1, 1] * depth
    pc = np.stack([x, y, depth], -1)
    Twc = inv_se3(Tcw)
    return pc @ Twc[:3, :3].T + Twc[:3, 3]


def align_sim3(src: np.ndarray, dst: np.ndarray):
    """The similarity (s, R, t) that takes points src [n, 3] closest to dst
    [n, 3] in the least squares, dst ~ s R src + t: Umeyama, "Least-squares
    estimation of transformation parameters between two point patterns",
    IEEE TPAMI 13(4), 1991, eqs. (34) to (42).  Refuses (ValueError) fewer
    than 3 pairs, or pairs whose covariance has rank below 2 (collinear or
    coincident points), where no one similarity is the answer."""
    x, y = np.asarray(src, np.float64), np.asarray(dst, np.float64)
    if x.shape != y.shape or x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"align_sim3 takes two [n, 3] arrays, not {x.shape} and {y.shape}")
    n = len(x)
    if n < 3:
        raise ValueError(f"align_sim3 needs 3 pairs or more, got {n}")
    mu_x, mu_y = x.mean(0), y.mean(0)
    xc, yc = x - mu_x, y - mu_y
    var_x = np.einsum("ij,ij->", xc, xc) / n                 # (36)
    cov = yc.T @ xc / n                                      # (38)
    U, D, Vt = np.linalg.svd(cov)
    if not D[0] > 0 or D[1] <= 1e-9 * D[0]:
        raise ValueError("align_sim3: the points are collinear or coincide")
    S = np.ones(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:            # (39), (43)
        S[2] = -1.0
    R = (U * S) @ Vt                                         # (40)
    s = float((D * S).sum() / var_x)                         # (42)
    t = mu_y - s * R @ mu_x                                  # (41)
    return s, R, t


def sim3_poses(Tcw: np.ndarray, s: float, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Poses Tcw [n, 4, 4] of a world that the similarity x -> s R x + t
    takes onto another, as rigid poses of that other world: the camera
    centres mapped by it, the rotations turned by R, lengths in its units."""
    T = np.asarray(Tcw, np.float64)
    out = np.zeros(T.shape, np.float64)
    Rcw = T[:, :3, :3] @ R.T
    out[:, :3, :3] = Rcw
    out[:, :3, 3] = s * T[:, :3, 3] - Rcw @ t
    out[:, 3, 3] = 1.0
    return out


def sim3_points(p: np.ndarray, s: float, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Points [n, 3] under the similarity x -> s R x + t."""
    return s * np.asarray(p, np.float64) @ R.T + t
