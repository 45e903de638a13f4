"""Per-frame data: features + RGB-D depth.

Counterpart of the JAX package's models/frame.py (reference Frame RGB-D
constructor, src/Frame.cc:238-349): ORB extraction, keypoint undistortion
and depth association for a whole chunk of frames at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.camera import CameraParams, backproject, undistort_points
from ..ops.matching import stereo as stereo_ops
from ..ops.orb import extractor as orb_extractor
from .config import SlamConfig


class FrameData(NamedTuple):
    """Capacity = config.orb feature budget; a chunk carries a leading [B]."""

    xy: torch.Tensor        # [N, 2] undistorted level-0 pixel coords
    xy_raw: torch.Tensor    # [N, 2] distorted coords
    response: torch.Tensor  # [N]
    angle: torch.Tensor     # [N] radians
    level: torch.Tensor     # [N] int32
    desc: torch.Tensor      # [N, 8] int32 (uint32 bits)
    valid: torch.Tensor     # [N] bool
    u_right: torch.Tensor   # [N] float32 (-1 = no depth)
    depth: torch.Tensor     # [N] float32 (-1 = none)

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    def has_depth(self) -> torch.Tensor:
        return self.valid & (self.depth > 0.0)

    def select(self, b: int) -> "FrameData":
        """Frame b of a chunk."""
        return FrameData(*(x[b] for x in self))


def backproject_frame(cam: CameraParams, frame: FrameData, Tcw: torch.Tensor) -> torch.Tensor:
    """World positions [N, 3] of all features (garbage where there is no
    depth: mask with frame.has_depth())."""
    pc = backproject(cam, frame.xy, torch.clamp_min(frame.depth, 1e-3))
    return (pc - Tcw[:3, 3]) @ Tcw[:3, :3]  # R^T (pc - t)


def make_frames_rgbd_batch(config: SlamConfig, images: torch.Tensor,
                           depth_maps: torch.Tensor) -> FrameData:
    """[B, H, W] images (0..255) and depths (m) -> FrameData [B, N, ...]
    through one extraction chain."""
    feats, _ = orb_extractor.extract_batch(images, config.orb)
    cam = config.camera
    xy_und = undistort_points(cam, feats.xy) if cam.has_distortion else feats.xy
    sm = stereo_ops.stereo_from_depth(feats.xy, feats.valid, depth_maps, cam.bf,
                                      config.depth_map_factor)
    return FrameData(
        xy=xy_und, xy_raw=feats.xy, response=feats.response, angle=feats.angle,
        level=feats.level, desc=feats.desc, valid=feats.valid,
        u_right=sm.u_right, depth=sm.depth,
    )


def make_frame_rgbd(config: SlamConfig, image: torch.Tensor,
                    depth_map: torch.Tensor) -> FrameData:
    """One RGB-D frame ([H, W] image and depth): the batch path at B = 1."""
    return make_frames_rgbd_batch(config, image[None], depth_map[None]).select(0)
