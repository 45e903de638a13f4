"""Per-frame data: features + stereo / RGB-D depth.

Counterpart of the JAX package's models/frame.py (reference Frame
constructors, src/Frame.cc:108-349): ORB extraction, keypoint undistortion
and depth association (RGB-D depth map, stereo row-band matching, or none
for a monocular frame) for a whole chunk of frames at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.camera import CameraParams, backproject, undistort_points
from ..ops.constants import scale_factors
from ..ops.matching import stereo as stereo_ops
from ..ops.orb import extractor as orb_extractor
from ..ops.orb.pyramid import level_shapes
from ..utils.rectify import remap_bilinear_torch
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


def _frame(config: SlamConfig, feats, u_right: torch.Tensor, depth: torch.Tensor) -> FrameData:
    cam = config.camera
    xy_und = undistort_points(cam, feats.xy) if cam.has_distortion else feats.xy
    return FrameData(
        xy=xy_und, xy_raw=feats.xy, response=feats.response, angle=feats.angle,
        level=feats.level, desc=feats.desc, valid=feats.valid,
        u_right=u_right, depth=depth,
    )


def make_frames_rgbd_batch(config: SlamConfig, images: torch.Tensor,
                           depth_maps: torch.Tensor) -> FrameData:
    """[B, H, W] images (0..255) and depths (m) -> FrameData [B, N, ...]
    through one extraction chain."""
    feats, _ = orb_extractor.extract_batch(images, config.orb)
    sm = stereo_ops.stereo_from_depth(feats.xy, feats.valid, depth_maps, config.camera.bf,
                                      config.depth_map_factor)
    return _frame(config, feats, sm.u_right, sm.depth)


def make_frame_rgbd(config: SlamConfig, image: torch.Tensor,
                    depth_map: torch.Tensor) -> FrameData:
    """One RGB-D frame ([H, W] image and depth): the batch path at B = 1."""
    return make_frames_rgbd_batch(config, image[None], depth_map[None]).select(0)


def _rectify_pair(config: SlamConfig, image_l: torch.Tensor, image_r: torch.Tensor):
    """Apply the configured undistort-rectify maps to both eyes ([..., H, W])
    on the device (reference EuRoC path: cv::remap per eye before tracking,
    Examples/Stereo/stereo_euroc.cc:45-80).  No-op when unset."""
    if config.rect_maps is None:
        return image_l, image_r
    mxl, myl, mxr, myr = (torch.as_tensor(a, dtype=torch.float32, device=image_l.device)
                          for a in config.rect_maps)
    return (remap_bilinear_torch(image_l, mxl, myl),
            remap_bilinear_torch(image_r, mxr, myr))


def make_frames_stereo_batch(config: SlamConfig, images_l: torch.Tensor,
                             images_r: torch.Tensor) -> FrameData:
    """Stereo frames for a chunk ([B, H, W] per eye): both eyes of every
    frame through one extraction chain in the contiguous [left block; right
    block] layout (one FAST launch over 2B images), then the batched
    row-band SAD matcher on the pyramid slabs of that extraction (reference
    Frame stereo ctor, src/Frame.cc:108-237)."""
    cam = config.camera
    B, H, W = images_l.shape
    images_l, images_r = _rectify_pair(config, images_l, images_r)
    feats, slabs = orb_extractor.extract_batch(torch.cat([images_l, images_r]), config.orb)
    fl = orb_extractor.OrbFeatures(*(x[:B] for x in feats))
    fr = orb_extractor.OrbFeatures(*(x[B:] for x in feats))
    dims = level_shapes(H, W, config.orb.n_levels, config.orb.scale_factor)
    sm = stereo_ops.match_stereo(
        fl.xy, fl.level, fl.desc, fl.valid, fr.xy, fr.level, fr.desc, fr.valid,
        slabs[:B], slabs[B:], cam.bf, cam.baseline,  # minZ = b (reference Frame.cc:1033)
        scale_factors(config.orb, images_l.device), dims)
    return _frame(config, fl, sm.u_right, sm.depth)


def make_frame_stereo(config: SlamConfig, image_l: torch.Tensor,
                      image_r: torch.Tensor) -> FrameData:
    """One stereo frame ([H, W] per eye): the batch path at B = 1."""
    return make_frames_stereo_batch(config, image_l[None], image_r[None]).select(0)


def make_frames_mono_batch(config: SlamConfig, images: torch.Tensor) -> FrameData:
    """Monocular frames for a chunk ([B, H, W]): no depth, u_right = -1."""
    feats, _ = orb_extractor.extract_batch(images, config.orb)
    none = torch.full(feats.valid.shape, -1.0, dtype=torch.float32, device=images.device)
    return _frame(config, feats, none, none.clone())


def make_frame_mono(config: SlamConfig, image: torch.Tensor) -> FrameData:
    """One monocular frame ([H, W]): the batch path at B = 1."""
    return make_frames_mono_batch(config, image[None]).select(0)
