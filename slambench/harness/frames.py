"""One cycle of the cell's frames: the configuration's room rendered on the
device along the mix's trajectory, with the configuration's own camera;
held on the host as the API takes them (uint8 images, depth in metres for
RGB-D, uint8 pairs for stereo), with the exact poses.  The run's seed picks
the frame the cycle starts from: every seed replays the same frames, in
another order, so a seed does not change the work (a room of another
texture changes how often keyframes are taken, and with it the rate).

A configuration may scale its room and trajectory (`scene_scale`): every
length times the factor, so that a rig's published baseline sees the
disparities the unscaled room gives a baseline that much shorter.  A mix
names its trajectory (`trajectory`, one of TRAJECTORIES) and the frames of
one cycle (`cycle_frames`: fewer frames, a faster camera)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..scene import cast, room
from . import settings as st

# a mix's `trajectory` -> Tcw [n, 4, 4] of a cycle of n frames
TRAJECTORIES = {"lookat": room.lookat_trajectory}


class Cycle(NamedTuple):
    left: np.ndarray             # [F, H, W] uint8
    depth: Optional[np.ndarray]  # [F, H, W] float32 metres (rgbd)
    right: Optional[np.ndarray]  # [F, H, W] uint8 (stereo)
    poses: np.ndarray            # [F, 4, 4] float32 Tcw, world to camera
    scene: room.Scene
    K: np.ndarray                # [3, 3] float64
    start: int                   # the cycle frame a run's frame 0 shows

    def index(self, k):
        """Cycle frame of run frame(s) k."""
        return (np.asarray(k) + self.start) % len(self.left)


def start_frame(seed: int, n_frames: int) -> int:
    return abs(int(seed)) % n_frames


def trajectory(name: str, n_frames: int, scale: float = 1.0) -> np.ndarray:
    """The named trajectory's cycle of n_frames poses, its camera centres
    scaled by `scale` (float32 Tcw, as the unscaled one is)."""
    if name not in TRAJECTORIES:
        raise ValueError(f"no trajectory {name!r}; known: {sorted(TRAJECTORIES)}")
    poses = TRAJECTORIES[name](n_frames)
    if scale != 1.0:
        poses = poses.astype(np.float64)
        poses[:, :3, 3] *= scale
        poses = poses.astype(np.float32)
    return poses


def scaled_room(room_seed: int, scale: float = 1.0) -> room.Scene:
    """The room of `room_seed` with every length times `scale`."""
    scene = room.make_room(np.random.default_rng(room_seed))
    if scale == 1.0:
        return scene
    return room.Scene([room.Plane(p.origin * scale, p.u_axis * scale, p.v_axis * scale,
                                  p.texture) for p in scene.planes])


def make_cycle(s: dict, sensor: str, room_seed: int, n_frames: int, device,
               start: int = 0, trajectory_name: str = "lookat",
               scale: float = 1.0) -> Cycle:
    scene = scaled_room(room_seed, scale)
    poses = trajectory(trajectory_name, n_frames, scale)
    K = st.camera_matrix(s)
    W, H = st.size(s)
    dev_scene = cast.DeviceScene(scene, device)
    left, second = [], []
    for T in poses:
        img, depth = dev_scene.render(K, T, W, H)
        left.append(cast.to_u8(img))
        if sensor == "rgbd":
            second.append(depth)
        elif sensor == "stereo":
            second.append(cast.to_u8(dev_scene.render(K, cast.right_eye(T, st.baseline(s)),
                                                      W, H)[0]))
    left_np = torch.stack(left).cpu().numpy()
    second_np = torch.stack(second).cpu().numpy() if second else None
    return Cycle(left_np, second_np if sensor == "rgbd" else None,
                 second_np if sensor == "stereo" else None, poses, scene, K, start)


def cell_cycle(s: dict, cfg: dict, mix: dict, device, start: int,
               n_frames: int | None = None) -> Cycle:
    """The cycle of a configuration under a mix (n_frames: a shorter
    cycle, for tests)."""
    n = int(mix["cycle_frames"] if n_frames is None else n_frames)
    return make_cycle(s, cfg["sensor"], int(cfg["room_seed"]), n, device, start,
                      mix["trajectory"], float(cfg.get("scene_scale", 1.0)))
