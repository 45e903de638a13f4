"""The features a frame batch should carry: the frozen extractor run on the
same images and batch shape as the program's frame phase."""

from __future__ import annotations

import numpy as np
import torch

from .orb import common
from .orb.extract import OrbSettings, extract_batch


def orb_settings(s: dict) -> OrbSettings:
    return OrbSettings(n_features=int(s.get("ORBextractor.nFeatures", 1000)),
                       n_levels=int(s.get("ORBextractor.nLevels", 8)),
                       scale_factor=float(s.get("ORBextractor.scaleFactor", 1.2)),
                       fast_threshold_hi=float(s.get("ORBextractor.iniThFAST", 20)),
                       fast_threshold_lo=float(s.get("ORBextractor.minThFAST", 7)))


@torch.no_grad()
def extract(images_u8: np.ndarray, s: dict, device, storage=None) -> dict:
    """Features of a [B, H, W] uint8 batch as numpy arrays [B, N, ...];
    `storage` (a lower precision) gives the control's features."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             common.STORAGE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    common.STORAGE = storage
    try:
        imgs = torch.as_tensor(np.asarray(images_u8, np.float32), device=device)
        out = extract_batch(imgs, orb_settings(s))
        return {k: v.cpu().numpy() for k, v in out.items()}
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         common.STORAGE) = saved


def differing_rows(prog: dict, ref: dict) -> int:
    """Feature rows of one frame ([N, ...] arrays) where the program and the
    reference disagree: on whether the row holds a feature, or on a held
    feature's keypoint, octave or descriptor."""
    pv, rv = np.asarray(prog["valid"], bool), np.asarray(ref["valid"], bool)
    both = pv & rv
    same = ((prog["xy"] == ref["xy"]).all(-1) & (prog["level"] == ref["level"])
            & (prog["desc"] == ref["desc"]).all(-1))
    return int(((pv != rv) | (both & ~same)).sum())
