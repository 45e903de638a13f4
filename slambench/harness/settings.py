"""A settings file as the benchmark reads it, without the program: the
`key: value` lines of an ORB-SLAM2 OpenCV-YAML file as numbers, with the
configuration's `changed` keys applied.  The renderer and the reference
take the camera, the rate and the ORB settings from here."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read(cfg: dict) -> dict:
    """{key: float} of configs/<name>/<settings>, `changed` applied."""
    out = {}
    for line in (Path(cfg["dir"]) / cfg["settings"]).read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        if ":" not in line or line.startswith("%"):
            continue
        key, value = (s.strip() for s in line.split(":", 1))
        try:
            out[key] = float(value)
        except ValueError:
            continue
    out.update({k: float(v) for k, v in cfg.get("changed", {}).items()})
    return out


def camera_matrix(s: dict) -> np.ndarray:
    return np.array([[s["Camera.fx"], 0.0, s["Camera.cx"]],
                     [0.0, s["Camera.fy"], s["Camera.cy"]],
                     [0.0, 0.0, 1.0]], np.float64)


def size(s: dict) -> tuple[int, int]:
    """(width, height)."""
    return int(s.get("Camera.width", 640)), int(s.get("Camera.height", 480))


def baseline(s: dict) -> float:
    return s.get("Camera.bf", 0.0) / s["Camera.fx"]
