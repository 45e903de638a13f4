"""RGB-D pseudo-stereo (reference Frame::ComputeStereoFromRGBD,
src/Frame.cc:1423-1461).  Counterpart of the JAX package's
ops/matching/stereo.py::stereo_from_depth; the row-band stereo matcher waits
for the stereo slice."""

from __future__ import annotations

from typing import NamedTuple

import torch


class StereoMatches(NamedTuple):
    u_right: torch.Tensor  # [NL] float32, -1 where unmatched
    depth: torch.Tensor    # [NL] float32, -1 where unmatched
    valid: torch.Tensor    # [NL] bool


def stereo_from_depth(xy: torch.Tensor, valid: torch.Tensor,
                      depth_map: torch.Tensor, bf: float,
                      depth_factor: float = 1.0) -> StereoMatches:
    """Read the depth at each (distorted) keypoint and synthesize
    u_right = u - bf / d.  Batched over leading dims: xy [..., N, 2],
    valid [..., N], depth_map [..., H, W]."""
    h, w = depth_map.shape[-2:]
    xi = torch.clamp(xy[..., 0].to(torch.int64), 0, w - 1)
    yi = torch.clamp(xy[..., 1].to(torch.int64), 0, h - 1)
    flat = depth_map.reshape(*depth_map.shape[:-2], h * w)
    d = torch.gather(flat, -1, yi * w + xi) * depth_factor
    ok = valid & (d > 0.0)
    ur = xy[..., 0] - bf / torch.clamp_min(d, 1e-6)
    return StereoMatches(u_right=torch.where(ok, ur, -1.0),
                         depth=torch.where(ok, d, -1.0), valid=ok)
