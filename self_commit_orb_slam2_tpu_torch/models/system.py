"""Public API + host-side state machine for the three sensors.

Counterpart of the JAX package's models/system.py (reference System,
src/System.cc, and the NOT_INITIALIZED/OK/LOST machine of Tracking,
Tracking.cc:419-786).  The ported configurations run loop closing off,
local mapping on or off and the vocabulary loaded or not:
System(cfg, enable_mapping=..., enable_loop_closing=False), with
cfg.sensor "rgbd", "stereo" (cfg.rect_maps optional) or "mono".  With
cfg.vocab = bow.load_vocabulary(bow.default_vocab_path()) keyframes carry
BoW rows, a lost tracker relocalizes (inside a streamed chunk, and after a
per-frame step) and localization mode is available.

The engine runs on `cuda` unless the caller passes device="cpu"; with no
card and no explicit device it raises instead of falling back to the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import trajectory as traj_io
from . import checkpoint
from . import frame as frame_mod
from . import map_state as ms
from . import mono_init
from . import pipeline
from . import relocalization
from .config import SlamConfig
from .streaming import STATE_LOST, STATE_NOT_INITIALIZED, STATE_OK, StreamSession

__all__ = ["System", "resolve_device", "STATE_NOT_INITIALIZED", "STATE_OK",
           "STATE_LOST"]


def resolve_device(device=None) -> torch.device:
    """`cuda` by default; raises when no card is present rather than falling
    back to the CPU.  Pass device="cpu" to run on the CPU on purpose."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _f32(image) -> torch.Tensor:
    return torch.as_tensor(np.asarray(image, np.float32))


def _u8(images) -> np.ndarray:
    return np.clip(images, 0, 255).astype(np.uint8)


_FRAME_BUILDERS = {"rgbd": frame_mod.make_frame_rgbd,
                   "stereo": frame_mod.make_frame_stereo,
                   "mono": frame_mod.make_frame_mono}


class System:
    """SLAM engine (reference System.h: TrackMonocular / TrackStereo /
    TrackRGBD, localization-mode switch, Reset, trajectory savers) with the
    chunked streaming API."""

    def __init__(self, config: SlamConfig, enable_mapping: bool = True,
                 enable_loop_closing: bool = True, device=None):
        self.device = resolve_device(device)
        if enable_loop_closing:
            raise NotImplementedError(
                "loop closing is not ported yet: pass enable_loop_closing=False")
        if config.sensor not in ("rgbd", "stereo", "mono"):
            raise ValueError(f"unknown sensor {config.sensor!r}")
        if config.vocab is not None:  # the whole tree lives on the engine's device
            config = config._replace(vocab=config.vocab.to(self.device))
        if config.rect_maps is not None:  # so do the rectification maps
            config = config._replace(rect_maps=tuple(
                torch.as_tensor(a, dtype=torch.float32).to(self.device)
                for a in config.rect_maps))
        self.config = config
        # Doubled feature budget before the monocular map exists (reference
        # mpIniORBextractor = 2x nFeatures, src/Tracking.cc:121-124):
        # bootstrap frames carry 2N candidates, try_initialize keeps the N best.
        self._ini_config = config._replace(orb=config.orb._replace(
            n_features=2 * config.orb.n_features))
        self.enable_mapping = enable_mapping
        self.localization_only = False
        # localization-mode "tracking on VO points, map support lost" flag
        # (the reference's mbVO, src/Tracking.cc:538-541)
        self.vo_mode = False
        # RANSAC draws of relocalization: one stream for the branch inside
        # track_step, one for the host-side attempt after a LOST per-frame step
        self._stream_gen = torch.Generator(device=self.device).manual_seed(23)
        self._reloc_gen = torch.Generator(device=self.device).manual_seed(0)
        # and one for the two-view RANSAC of the monocular bootstrap
        self._mono_gen = torch.Generator(device=self.device).manual_seed(11)
        self._batch_chunk = 4  # frames per streamed chunk (the JAX package's default)
        self.reset()

    # ------------------------------------------------------------- public API

    def track_rgbd(self, image: np.ndarray, depth: np.ndarray, timestamp: float) -> np.ndarray:
        """One frame: [H, W] grayscale (0..255) and depth in metres."""
        return self._track("rgbd", (_f32(image), _f32(depth)), timestamp)

    def track_stereo(self, image_l: np.ndarray, image_r: np.ndarray,
                     timestamp: float) -> np.ndarray:
        """One stereo pair of [H, W] grayscale images (reference
        System::TrackStereo); raw eyes when config.rect_maps is set."""
        return self._track("stereo", (_f32(image_l), _f32(image_r)), timestamp)

    def track_monocular(self, image: np.ndarray, timestamp: float) -> np.ndarray:
        """One [H, W] grayscale image (reference System::TrackMonocular,
        src/System.cc:292).  Until the two-view bootstrap succeeds the pose
        returned is the identity and no trajectory entry is kept for
        get_trajectory()."""
        return self._track("mono", (_f32(image),), timestamp)

    def track_batch_rgbd(self, images: np.ndarray, depths: np.ndarray,
                         timestamps: np.ndarray,
                         chunk: Optional[int] = None) -> np.ndarray:
        """Throughput mode: stream a frame batch in fixed-size chunks (the
        first frame initializes the map if needed).  Returns [B, 4, 4] poses."""
        depths_mm = np.clip(np.asarray(depths) * 1e3, 0, 65535).astype(np.uint16)
        return self._track_batch("rgbd", (_u8(images), depths_mm), timestamps, chunk)

    def track_batch_stereo(self, images_l: np.ndarray, images_r: np.ndarray,
                           timestamps: np.ndarray,
                           chunk: Optional[int] = None) -> np.ndarray:
        """Stereo throughput mode (see track_batch_rgbd)."""
        return self._track_batch("stereo", (_u8(images_l), _u8(images_r)), timestamps, chunk)

    def track_batch_mono(self, images: np.ndarray, timestamps: np.ndarray,
                         chunk: Optional[int] = None) -> np.ndarray:
        """Monocular throughput mode (see track_batch_rgbd).  The two-view
        bootstrap runs through the per-frame path until the map initializes
        (possibly consuming several leading frames); the rest stream in
        chunks, and only their poses are returned."""
        return self._track_batch("mono", (_u8(images),), timestamps, chunk)

    def _track_batch(self, sensor: str, arrays: tuple, timestamps,
                     chunk: Optional[int]) -> np.ndarray:
        sess = self.open_stream(sensor, chunk)
        sess.feed(arrays, timestamps)
        poses = sess.finish()
        return poses if len(poses) else np.asarray(self.Tcw)[None]

    def open_stream(self, sensor: str, chunk: Optional[int] = None) -> StreamSession:
        """A persistent streaming session: feed() chunks for the lifetime of a
        run (models/streaming.py)."""
        return StreamSession(self, sensor, chunk)

    def activate_localization_mode(self) -> None:
        """Reference System::ActivateLocalizationMode (src/System.cc:346):
        track against the map as it is; no keyframes, no mapping."""
        self.localization_only = True

    def deactivate_localization_mode(self) -> None:
        self.localization_only = False

    def save_map(self, path: str) -> None:
        """Persist the map (models/checkpoint.py)."""
        checkpoint.save_map(path, self.map)

    def load_map(self, path: str) -> None:
        """Restore a map; typically followed by activate_localization_mode()
        and relocalization against it.  As in the JAX package the tracking
        carry is not part of a checkpoint."""
        self.map = checkpoint.load_map(path, self.device)
        self.state = STATE_NOT_INITIALIZED if int(self.map.n_kf) == 0 else STATE_LOST

    def reset(self) -> None:
        """Reference Tracking::Reset (src/Tracking.cc:2242): clear everything."""
        self.map = ms.empty_map(self.config, self.device)
        self.state = STATE_NOT_INITIALIZED
        self.carry: Optional[pipeline.TrackCarry] = None
        self.trajectory: list[tuple[float, np.ndarray]] = []
        # (timestamp, ref keyframe seq, T_cr): poses are recomposed against the
        # keyframes' current poses at save time (reference SaveTrajectoryTUM)
        self._rel_trajectory: list[tuple[float, int, np.ndarray]] = []
        self.Tcw = np.eye(4, dtype=np.float32)
        self._mono_first: Optional[frame_mod.FrameData] = None  # awaiting a second view
        self._mono_first_ts = 0.0

    def get_trajectory(self) -> tuple[np.ndarray, np.ndarray]:
        """(timestamps, poses_cw): each frame's T_cr composed with its
        reference keyframe's current pose; retired keyframes resolve through
        the cull archive (reference SaveTrajectoryTUM, src/System.cc:438-460)."""
        m = self.map
        kf_poses = m.kf_Tcw.cpu().numpy()
        kf_valid = m.kf_valid.cpu().numpy()
        kf_seq = m.kf_seq.cpu().numpy()
        cull_seq = m.cull_seq.cpu().numpy()
        cull_parent = m.cull_parent_seq.cpu().numpy()
        cull_Tcp = m.cull_Tcp.cpu().numpy()
        seq_to_slot = {int(s): i for i, s in enumerate(kf_seq) if kf_valid[i] and s >= 0}
        seq_to_arch = {int(s): i for i, s in enumerate(cull_seq) if s >= 0}

        def resolve(seq: int) -> np.ndarray:
            T = np.eye(4)
            guard = 0
            while seq not in seq_to_slot and guard < 64:
                a = seq_to_arch.get(seq)
                if a is None:
                    break
                T = T @ cull_Tcp[a]
                seq = int(cull_parent[a])
                guard += 1
            if seq not in seq_to_slot:
                older = [s for s in seq_to_slot if s <= seq]
                seq = max(older) if older else min(seq_to_slot)
            return T @ kf_poses[seq_to_slot[seq]]

        ts = np.array([t for t, _, _ in self._rel_trajectory])
        poses = np.stack([Tcr @ resolve(ref) for _, ref, Tcr in self._rel_trajectory]
                         ) if self._rel_trajectory else np.zeros((0, 4, 4))
        return ts, poses

    def save_trajectory_tum(self, path: str) -> None:
        ts, poses = self.get_trajectory()
        traj_io.save_tum(path, ts, poses)

    def n_keyframes(self) -> int:
        return int(self.map.n_kf)

    def n_points(self) -> int:
        return int(torch.sum(self.map.pt_valid))

    # ------------------------------------------------------------ state machine

    def _relocalize_last_frame(self) -> None:
        """Reference: Tracking falls back to Relocalization when LOST
        (src/Tracking.cc:523-629, :2030).  One more attempt on the frame the
        step just lost, from the host-side stream; on success the carry
        restarts from the recovered pose with the velocity cleared."""
        m = self.map
        reloc = relocalization.relocalize(self.config, m, self.carry.last_frame,
                                          self._reloc_gen)
        if not bool(reloc.success):
            return
        dev = self.device
        self.carry = self.carry._replace(
            Tcw=reloc.Tcw,
            velocity=torch.eye(4, dtype=torch.float32, device=dev),
            last_obs_pt=reloc.obs_pt,
            last_obs_birth=torch.where(
                reloc.obs_pt >= 0,
                m.pt_birth[torch.clamp(reloc.obs_pt, 0, m.max_pt - 1).long()], 0),
            state_ok=torch.ones((), dtype=torch.bool, device=dev),
            # mbVO clears on relocalization success (reference Tracking.cc:623)
            vo=torch.zeros((), dtype=torch.bool, device=dev),
        )
        self.Tcw = reloc.Tcw.cpu().numpy()
        self.state = STATE_OK

    def _track(self, sensor: str, images: tuple, timestamp: float) -> np.ndarray:
        """One frame of `sensor`: images is (image, depth in metres) for
        rgbd, (left, right) for stereo, (image,) for mono, float32 [H, W]."""
        images = tuple(a.to(self.device) for a in images)
        ts = torch.tensor(timestamp, dtype=torch.float32, device=self.device)
        if self.state == STATE_NOT_INITIALIZED and sensor == "mono":
            return self._mono_initialize(images[0], timestamp)
        if self.state == STATE_NOT_INITIALIZED:
            init = pipeline.init_rgbd if sensor == "rgbd" else pipeline.init_stereo
            m, carry, n_depth = init(self.config, self.map, *images, ts)
            if int(n_depth) >= self.config.tracking.min_init_depth_points:
                self.map, self.carry = m, carry
                self.state = STATE_OK
                self.Tcw = np.eye(4, dtype=np.float32)
                self._rel_trajectory.append((timestamp, 0, np.eye(4)))
            else:  # not enough depth features: drop the premature keyframe
                self.map = ms.empty_map(self.config, self.device)
                self.carry = None
        else:
            frame = _FRAME_BUILDERS[sensor](self.config, *images)
            self.map, self.carry, info = pipeline.track_step(
                self.config, self.map, self.carry, frame, ts, self.enable_mapping,
                localization_only=self.localization_only, generator=self._stream_gen)
            self.Tcw = info.Tcw.cpu().numpy()
            self.state = STATE_OK if bool(info.state_ok) else STATE_LOST
            self.vo_mode = bool(info.vo)
            if self.state == STATE_LOST and self.config.vocab is not None:
                self._relocalize_last_frame()
            Tcr = self.Tcw @ np.linalg.inv(info.ref_kf_Tcw.cpu().numpy())
            self._rel_trajectory.append((timestamp, int(info.ref_kf_seq), Tcr))
        self.trajectory.append((timestamp, self.Tcw))
        return self.Tcw

    def _mono_initialize(self, image: torch.Tensor, timestamp: float) -> np.ndarray:
        """Two-frame monocular bootstrap (reference
        Tracking::MonocularInitialization, src/Tracking.cc:886).  Host reads:
        the feature count, then (success, matches) in one transfer."""
        frame = frame_mod.make_frame_mono(self._ini_config, image)
        enough = int(torch.sum(frame.valid)) >= 100
        if self._mono_first is None or not enough:
            self._mono_first = frame if enough else None
            self._mono_first_ts = timestamp
        else:
            res = mono_init.try_initialize(
                self.config, self.map, self._mono_first, frame, self._mono_first_ts,
                timestamp, len(self.trajectory), self._mono_gen)
            if res.success:
                self.map, self.carry = res.m, res.carry
                self.state = STATE_OK
                self.Tcw = res.carry.Tcw.cpu().numpy()
                kf2_Tcw = self.map.kf_Tcw[1].cpu().numpy()
                self._rel_trajectory.append((timestamp, 1, self.Tcw @ np.linalg.inv(kf2_Tcw)))
                self._mono_first = None
            elif res.n_matches < self.config.tracking.mono_init_min_matches:
                # too few matches: restart from the current frame (reference
                # Tracking.cc:938-946)
                self._mono_first = frame
                self._mono_first_ts = timestamp
        self.trajectory.append((timestamp, self.Tcw))
        return self.Tcw
