"""Batched two-view linear triangulation and its acceptance gates.

Counterpart of the JAX package's ops/triangulate.py (reference
Initializer::Triangulate, src/Initializer.cc:1461-1499, and the gates of
LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:312-626).  Local
mapping uses the inhomogeneous form (w = 1, closed-form 3x3 normal
equations); the monocular bootstrap uses the homogeneous form (null vector
of the 4x4 system through eigh).
"""

from __future__ import annotations

import torch

from . import se3
from .camera import CameraParams, project


def camera_matrix(cam: CameraParams, device) -> torch.Tensor:
    """[3, 3] intrinsics K (the JAX CameraParams.K)."""
    return torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                         [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def projection_matrix(K: torch.Tensor, Tcw: torch.Tensor) -> torch.Tensor:
    """K [3, 3] x Tcw [..., 4, 4] -> P [..., 3, 4]."""
    return torch.einsum("ij,...jk->...ik", K, Tcw[..., :3, :4])


def _dlt_rows(uv1, uv2, P1, P2) -> torch.Tensor:
    return torch.stack([
        uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)                                           # [..., 4, 4]


def triangulate_linear(uv1: torch.Tensor, uv2: torch.Tensor,
                       P1: torch.Tensor, P2: torch.Tensor) -> torch.Tensor:
    """Homogeneous DLT of pixel pairs [..., 2] under projections [..., 3, 4]
    (reference src/Initializer.cc:1461): the null vector of the 4x4 system is
    the eigenvector of A^T A with the smallest eigenvalue, dehomogenized.
    Returns world points [..., 3]."""
    rows = _dlt_rows(uv1, uv2, P1, P2)
    AtA = torch.einsum("...ki,...kj->...ij", rows, rows)
    _, vecs = torch.linalg.eigh(AtA)
    x = vecs[..., :, 0]  # eigh sorts ascending
    w = x[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return x[..., :3] / w[..., None]


def triangulate_linear_fast(uv1: torch.Tensor, uv2: torch.Tensor,
                            P1: torch.Tensor, P2: torch.Tensor) -> torch.Tensor:
    """Inhomogeneous DLT of pixel pairs [..., 2] under projections [..., 3, 4]:
    fix w = 1 and solve the 4x3 system through its 3x3 normal equations in
    closed form (adjugate / determinant).  Returns world points [..., 3];
    0 where the system is singular."""
    rows = _dlt_rows(uv1, uv2, P1, P2)
    A = rows[..., :3]                                    # [..., 4, 3]
    b = -rows[..., 3]                                    # [..., 4]
    N = torch.einsum("...ki,...kj->...ij", A, A)         # [..., 3, 3]
    rhs = torch.einsum("...ki,...k->...i", A, b)         # [..., 3]
    n = lambda i, j: N[..., i, j]  # noqa: E731
    c00 = n(1, 1) * n(2, 2) - n(1, 2) * n(2, 1)
    c01 = n(0, 2) * n(2, 1) - n(0, 1) * n(2, 2)
    c02 = n(0, 1) * n(1, 2) - n(0, 2) * n(1, 1)
    c10 = n(1, 2) * n(2, 0) - n(1, 0) * n(2, 2)
    c11 = n(0, 0) * n(2, 2) - n(0, 2) * n(2, 0)
    c12 = n(0, 2) * n(1, 0) - n(0, 0) * n(1, 2)
    c20 = n(1, 0) * n(2, 1) - n(1, 1) * n(2, 0)
    c21 = n(0, 1) * n(2, 0) - n(0, 0) * n(2, 1)
    c22 = n(0, 0) * n(1, 1) - n(0, 1) * n(1, 0)
    det = n(0, 0) * c00 + n(1, 0) * c01 + n(2, 0) * c02
    inv_det = torch.where(torch.abs(det) > 1e-20, 1.0 / det, 0.0)
    adj = torch.stack([torch.stack([c00, c01, c02], -1),
                       torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], -2)
    return torch.einsum("...ij,...j->...i", adj, rhs) * inv_det[..., None]


def parallax_cos(pts_w: torch.Tensor, Tcw1: torch.Tensor, Tcw2: torch.Tensor) -> torch.Tensor:
    """Cosine of the triangulation parallax angle per point."""
    ray1 = pts_w - se3.inverse(Tcw1)[..., :3, 3]
    ray2 = pts_w - se3.inverse(Tcw2)[..., :3, 3]
    n1 = torch.linalg.norm(ray1, dim=-1)
    n2 = torch.linalg.norm(ray2, dim=-1)
    return torch.sum(ray1 * ray2, dim=-1) / torch.clamp_min(n1 * n2, 1e-9)


def triangulation_gates(cam: CameraParams, pts_w: torch.Tensor, Tcw1: torch.Tensor,
                        Tcw2: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
                        sigma2_1: torch.Tensor, sigma2_2: torch.Tensor,
                        min_parallax_cos: float = 0.9998,
                        chi2_th: float = 5.991) -> torch.Tensor:
    """Acceptance mask (LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:
    430-560): finite, enough parallax, positive depth in both views,
    reprojection error below chi2_th * sigma^2 in both views."""
    cos_par = parallax_cos(pts_w, Tcw1, Tcw2)
    pc1 = torch.einsum("...ij,...j->...i", Tcw1[..., :3, :3], pts_w) + Tcw1[..., :3, 3]
    pc2 = torch.einsum("...ij,...j->...i", Tcw2[..., :3, :3], pts_w) + Tcw2[..., :3, 3]
    uv1_hat, z1 = project(cam, pc1)
    uv2_hat, z2 = project(cam, pc2)
    e1 = torch.sum((uv1_hat - uv1) ** 2, dim=-1)
    e2 = torch.sum((uv2_hat - uv2) ** 2, dim=-1)
    return (torch.all(torch.isfinite(pts_w), dim=-1)
            & (cos_par < min_parallax_cos) & (cos_par > 0.0)
            & (z1 > 0.0) & (z2 > 0.0)
            & (e1 < chi2_th * sigma2_1) & (e2 < chi2_th * sigma2_2))
