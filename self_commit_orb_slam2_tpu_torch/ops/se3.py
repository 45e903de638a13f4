"""SE(3) / SO(3) Lie-group operations, batched over leading dims.

Counterpart of the JAX package's ops/se3.py (reference pose algebra in
src/Converter.cc and g2o's SE3Quat).  Poses are [..., 4, 4] float32
camera-from-world matrices (`Tcw`); tangent vectors are [..., 6] laid out
(rho, phi) = (translation, rotation), g2o's se3quat convention.
"""

from __future__ import annotations

import math

import torch

from .constants import constant

_EPS = 1e-8


def hat(phi: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of [..., 3] vectors -> [..., 3, 3]."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def vee(M: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: [..., 3, 3] -> [..., 3]."""
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: [..., 3] axis-angle -> [..., 3, 3] rotation, with
    Taylor expansions near theta = 0."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < 1e-8
    safe_t2 = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(safe_t2)
    K = hat(phi)
    KK = K @ K
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    return _eye3(phi, K.shape) + a[..., None, None] * K + b[..., None, None] * KK


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 3] axis-angle (stable at 0 and pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - R.transpose(-1, -2)) * 0.5  # = sin(theta) * axis
    sin2 = torch.sum(w * w, dim=-1)
    small = sin2 < 1e-10
    safe_sin = torch.sqrt(torch.where(small, 1.0, sin2))
    theta = torch.atan2(safe_sin, cos_t)
    scale = torch.where(small, 1.0 + sin2 / 6.0, theta / safe_sin)
    generic = w * scale[..., None]

    # near theta = pi, w vanishes: recover the axis from the diagonal of R + I
    near_pi = cos_t < -0.98
    theta = torch.where(small & (cos_t < 0), math.pi, theta)
    B = (R + R.transpose(-1, -2)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp_min(
        (diag - cos_t[..., None]) / torch.clamp_min(1.0 - cos_t[..., None], _EPS), 0.0)
    axis = torch.sqrt(torch.where(near_pi[..., None], torch.clamp_min(axis_sq, _EPS), 1.0))
    axis = axis * torch.where(w >= 0.0, 1.0, -1.0)
    axis = axis / torch.clamp_min(torch.linalg.norm(axis, dim=-1, keepdim=True), _EPS)
    return torch.where(near_pi[..., None], axis * theta[..., None], generic)


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(phi) (the V matrix of se3 exp)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < 1e-8
    safe_t2 = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(safe_t2)
    K = hat(phi)
    KK = K @ K
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (safe_t2 * theta))
    return _eye3(phi, K.shape) + b[..., None, None] * K + c[..., None, None] * KK


def _left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < 1e-8
    safe_t2 = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(safe_t2)
    K = hat(phi)
    KK = K @ K
    half_theta = 0.5 * theta
    cot = torch.cos(half_theta) / torch.where(small, 1.0, torch.sin(half_theta))
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - half_theta * cot) / safe_t2)
    return _eye3(phi, K.shape) - 0.5 * K + coef[..., None, None] * KK


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[..., 6] (rho, phi) -> [..., 4, 4] homogeneous transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = torch.einsum("...ij,...j->...i", _left_jacobian(phi), rho)
    return rt_to_mat(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 6] (rho, phi)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    phi = so3_log(R)
    rho = torch.einsum("...ij,...j->...i", _left_jacobian_inv(phi), t)
    return torch.cat([rho, phi], dim=-1)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3], [..., 3] -> [..., 4, 4]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = constant((0.0, 0.0, 0.0, 1.0), R.dtype, R.device).expand(*batch, 1, 4)
    return torch.cat([top, bottom], dim=-2)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a [..., 4, 4] rigid transform."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for [..., 4, 4] transforms."""
    return A @ B


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] to [..., N, 3] points."""
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], pts) + T[..., None, :3, 3]


def transform_point(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] to a single [..., 3] point."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], p) + T[..., :3, 3]


def update_left(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update exp(xi) @ T (g2o vertex update convention)."""
    return se3_exp(xi) @ T


def normalize_rotation(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block via SVD (drift control)."""
    U, _, Vt = torch.linalg.svd(T[..., :3, :3])
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return rt_to_mat(U @ (D[..., :, None] * Vt), T[..., :3, 3])


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (x, y, z, w) -> rotation [..., 3, 3]."""
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), _EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> unit quaternion [..., 4] (x, y, z, w), w >= 0
    (Shepperd's method: the best-conditioned of four candidates)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1),
    ], dim=-2)                                   # [..., 4, 4] in (w, x, y, z)
    mags = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    best = torch.argmax(mags, dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), _EPS)
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    return torch.stack([q[..., 1], q[..., 2], q[..., 3], q[..., 0]], dim=-1)
