"""The room's ray cast on the device: `room.Scene.render` in torch, float64.

Every pixel's ray is intersected with every plane at once; the nearest hit
inside its rectangle (the first plane on a tie, as the numpy loop keeps it)
samples its texture bilinearly.  Images leave as uint8 (clipped, then
truncated, as the program's batch API converts them) and depth as float32
metres along the optical axis, 0 where no plane is hit.
"""

from __future__ import annotations

import numpy as np
import torch

from .room import Scene


class DeviceScene:
    """A room's planes and textures on `device`."""

    def __init__(self, scene: Scene, device):
        dev = torch.device(device)
        f64 = dict(dtype=torch.float64, device=dev)
        planes = scene.planes
        self.origin = torch.tensor(np.stack([p.origin for p in planes]), **f64)
        self.u_axis = torch.tensor(np.stack([p.u_axis for p in planes]), **f64)
        self.v_axis = torch.tensor(np.stack([p.v_axis for p in planes]), **f64)
        self.normal = torch.tensor(np.stack([p.normal() for p in planes]), **f64)
        self.textures = torch.tensor(np.stack([p.texture for p in planes]),
                                     dtype=torch.float32, device=dev)
        self.device = dev

    def render(self, K: np.ndarray, Tcw: np.ndarray, width: int, height: int):
        """(image float32 [H, W], depth float32 [H, W]) from Tcw (world to
        camera), as `Scene.render` computes them."""
        dev = self.device
        K = torch.as_tensor(np.asarray(K, np.float64), device=dev)
        T = torch.as_tensor(np.asarray(Tcw, np.float64), device=dev)
        R, t = T[:3, :3], T[:3, 3]
        # the camera centre in the pose's own precision, as numpy forms it
        # from a float32 pose; every later step in float64
        Tc = np.asarray(Tcw)
        centre = torch.as_tensor(-Tc[:3, :3].T @ Tc[:3, 3], device=dev).to(torch.float64)
        ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float64, device=dev),
                                torch.arange(width, dtype=torch.float64, device=dev),
                                indexing="ij")
        rays_cam = torch.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                                torch.ones_like(xs)], dim=-1)
        rays_w = rays_cam @ R                                      # [H, W, 3]
        denom = torch.einsum("hwc,pc->phw", rays_w, self.normal)   # [P, H, W]
        denom = torch.where(denom.abs() < 1e-9, 1e-9, denom)
        lam = ((self.origin - centre) * self.normal).sum(-1)[:, None, None] / denom
        pts = centre + lam[..., None] * rays_w                      # [P, H, W, 3]
        rel = pts - self.origin[:, None, None, :]
        u = ((rel * self.u_axis[:, None, None, :]).sum(-1)
             / (self.u_axis ** 2).sum(-1)[:, None, None])
        v = ((rel * self.v_axis[:, None, None, :]).sum(-1)
             / (self.v_axis ** 2).sum(-1)[:, None, None])
        z = pts @ R[2] + t[2]
        hit = (lam > 0.05) & (u >= 0) & (u < 1) & (v >= 0) & (v < 1) & (z > 0)
        zm = torch.where(hit, z, torch.inf)
        best = torch.argmin(zm, dim=0)                              # first plane on a tie
        any_hit = hit.any(dim=0)
        take = best[None]
        u = torch.gather(u, 0, take)[0]
        v = torch.gather(v, 0, take)[0]
        z = torch.gather(z, 0, take)[0]
        s = self.textures.shape[-1]
        tu = torch.clamp(u * (s - 1), 0, s - 1.0001)
        tv = torch.clamp(v * (s - 1), 0, s - 1.0001)
        iu, iv = tu.long(), tv.long()
        fu, fv = tu - iu, tv - iv
        tex = self.textures.reshape(-1)
        base = best * (s * s)

        def at(r, c):
            return tex[base + r * s + c].to(torch.float64)

        val = (at(iv, iu) * (1 - fu) * (1 - fv) + at(iv, iu + 1) * fu * (1 - fv)
               + at(iv + 1, iu) * (1 - fu) * fv + at(iv + 1, iu + 1) * fu * fv)
        img = torch.where(any_hit, val.to(torch.float32), 0.0)
        depth = torch.where(any_hit, z.to(torch.float32), 0.0)
        return img, depth


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """float32 0..255 -> uint8, clipped then truncated (numpy's astype)."""
    return torch.clamp(img, 0, 255).to(torch.uint8)


def right_eye(Tcw: np.ndarray, baseline: float) -> np.ndarray:
    """The right camera's Tcw: the left one shifted by +baseline along its x."""
    T_rl = np.eye(4)
    T_rl[0, 3] = -baseline
    return T_rl @ np.asarray(Tcw, np.float64)
