"""Settings-file loader: reference-style YAML -> SlamConfig.

The port's copy of the JAX package's utils/config_io.py.  Parses the same
keys the reference reads from its OpenCV-YAML settings files (reference
src/Tracking.cc:93-218: Camera.fx/fy/cx/cy, Camera.k1..p2,
Camera.bf, Camera.fps, ThDepth, DepthMapFactor, ORBextractor.nFeatures/
scaleFactor/nLevels/iniThFAST/minThFAST), so the reference's per-dataset
YAML files (TUM1.yaml, KITTI00-02.yaml, EuRoC.yaml) work directly.
"""

from __future__ import annotations

import yaml

from ..models.config import Capacities, SlamConfig, TrackingConfig
from ..ops.camera import CameraParams
from ..ops.orb.extractor import OrbConfig


def load_settings(path: str | None, sensor: str = "rgbd", width: int = 640,
                  height: int = 480, vocab=None,
                  caps: Capacities | None = None) -> SlamConfig:
    if path is None:  # defaults-only config (e.g. streaming driver smoke runs)
        text = ""
    else:
        with open(path) as f:
            text = f.read()
    # the reference files start with "%YAML:1.0" (OpenCV dialect)
    text = text.replace("%YAML:1.0", "").replace("!!opencv-matrix", "")
    data = yaml.safe_load(text) or {}

    def g(key, default=0.0):
        return float(data.get(key, default))

    cam = CameraParams.create(
        fx=g("Camera.fx", 500.0), fy=g("Camera.fy", 500.0),
        cx=g("Camera.cx", width / 2), cy=g("Camera.cy", height / 2),
        k1=g("Camera.k1"), k2=g("Camera.k2"),
        p1=g("Camera.p1"), p2=g("Camera.p2"), k3=g("Camera.k3"),
        bf=g("Camera.bf"), width=int(g("Camera.width", width)),
        height=int(g("Camera.height", height)),
    )
    orb = OrbConfig(
        n_features=int(g("ORBextractor.nFeatures", 1000)),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        scale_factor=g("ORBextractor.scaleFactor", 1.2),
        fast_threshold_hi=g("ORBextractor.iniThFAST", 20),
        fast_threshold_lo=g("ORBextractor.minThFAST", 7),
    )
    fps = g("Camera.fps", 30.0)
    tracking = TrackingConfig(
        max_frames_between_kf=int(fps),
        depth_threshold_factor=g("ThDepth", 35.0),
    )
    return SlamConfig(
        camera=cam, orb=orb, tracking=tracking,
        caps=caps or Capacities(),
        sensor=sensor,
        depth_map_factor=1.0 / g("DepthMapFactor", 1.0) if g("DepthMapFactor", 1.0) > 1.0 else 1.0,
        vocab=vocab,
    )
