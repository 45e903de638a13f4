"""The program's configuration of a cell, built as the port's run_slam
builds it: the settings file through the port's own loader, the
capacities and the bundled vocabulary, then the configuration's `changed`
keys; depth handed over in metres sets the engine's depth factor to 1."""

from __future__ import annotations

from pathlib import Path

# settings key -> CameraParams field
_CAMERA_KEYS = {"Camera.fx": "fx", "Camera.fy": "fy", "Camera.cx": "cx", "Camera.cy": "cy",
                "Camera.k1": "k1", "Camera.k2": "k2", "Camera.p1": "p1", "Camera.p2": "p2",
                "Camera.k3": "k3", "Camera.bf": "bf", "Camera.width": "width",
                "Camera.height": "height"}
# settings key -> OrbConfig field
_ORB_KEYS = {"ORBextractor.nFeatures": "n_features", "ORBextractor.scaleFactor": "scale_factor",
             "ORBextractor.nLevels": "n_levels", "ORBextractor.iniThFAST": "fast_threshold_hi",
             "ORBextractor.minThFAST": "fast_threshold_lo"}


def load_vocabulary(cfg: dict):
    """The vocabulary the configuration names (None without one)."""
    if cfg.get("vocabulary") != "bundled":
        return None
    from self_commit_orb_slam2_tpu_torch.ops import bow

    return bow.load_vocabulary(bow.default_vocab_path())


def slam_config(cfg: dict, vocab):
    from self_commit_orb_slam2_tpu_torch.models.config import Capacities
    from self_commit_orb_slam2_tpu_torch.utils.config_io import load_settings

    caps = Capacities()._replace(**cfg.get("capacities", {}))
    sc = load_settings(str(Path(cfg["dir"]) / cfg["settings"]), sensor=cfg["sensor"],
                       caps=caps, vocab=vocab)
    changed = cfg.get("changed", {})
    unknown = set(changed) - set(_CAMERA_KEYS) - set(_ORB_KEYS)
    if unknown:
        raise ValueError(f"{cfg['name']}: cannot apply {sorted(unknown)}")

    def replaced(group, keys):
        return group._replace(**{keys[k]: type(getattr(group, keys[k]))(v)
                                 for k, v in changed.items() if k in keys})

    sc = sc._replace(camera=replaced(sc.camera, _CAMERA_KEYS), orb=replaced(sc.orb, _ORB_KEYS))
    if cfg.get("depth_input") == "metres":
        sc = sc._replace(depth_map_factor=1.0)
    return sc
