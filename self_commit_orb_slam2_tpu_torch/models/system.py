"""Public API + host-side state machine for the three sensors.

Counterpart of the JAX package's models/system.py (reference System,
src/System.cc, and the NOT_INITIALIZED/OK/LOST machine of Tracking,
Tracking.cc:419-786).  System(cfg) builds what the JAX System builds:
local mapping and, with cfg.vocab set, the loop closer
(models/loop_closing.py) after every keyframe: in the per-frame API after
the step, in a stream per group of chunks (models/streaming.py).  With
cfg.vocab = bow.load_vocabulary(bow.default_vocab_path()) keyframes carry
BoW rows, a lost tracker relocalizes (inside a streamed chunk, and after a
per-frame step) and localization mode is available; without a vocabulary
the closer stays idle, as in the JAX package.  cfg.sensor is "rgbd",
"stereo" (cfg.rect_maps optional) or "mono".

The engine runs on `cuda` unless the caller passes device="cpu"; with no
card and no explicit device it raises instead of falling back to the CPU.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..ops.indexing import row
from ..utils import profiling
from ..utils import trajectory as traj_io
from . import checkpoint
from . import frame as frame_mod
from . import loop_closing
from . import map_state as ms
from . import mono_init
from . import pipeline
from . import relocalization
from .config import SlamConfig
from .step_graph import StepGraph
from .streaming import (_SENSORS, STATE_LOST, STATE_NOT_INITIALIZED, STATE_OK,
                        StreamSession)

__all__ = ["System", "resolve_device", "config_on_device", "STATE_NOT_INITIALIZED", "STATE_OK",
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


def config_on_device(config: SlamConfig, device: torch.device) -> SlamConfig:
    """The configuration with its tensors (the vocabulary tree, the
    rectification maps) on the engine's device."""
    if config.vocab is not None:
        config = config._replace(vocab=config.vocab.to(device))
    if config.rect_maps is not None:
        config = config._replace(rect_maps=tuple(
            torch.as_tensor(a, dtype=torch.float32).to(device) for a in config.rect_maps))
    return config


def _f32(image) -> torch.Tensor:
    return torch.as_tensor(np.asarray(image, np.float32))


def _u8(images) -> np.ndarray:
    return np.clip(images, 0, 255).astype(np.uint8)


def _host_planes(sensor: str, arrays: tuple) -> tuple:
    """A batch call's frames as a streaming session takes them: uint8
    images, and RGB-D depths as uint16 millimetres."""
    if sensor == "rgbd":
        images, depths = arrays
        return _u8(images), np.clip(np.asarray(depths) * 1e3, 0, 65535).astype(np.uint16)
    return tuple(_u8(a) for a in arrays)


# dummy chunks _prime_stream pushes through the frame phase and the steps
PRIME_CHUNKS = 2

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
        if config.sensor not in ("rgbd", "stereo", "mono"):
            raise ValueError(f"unknown sensor {config.sensor!r}")
        self.config = config = config_on_device(config, self.device)
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
        # one for the two-view RANSAC of the monocular bootstrap
        self._mono_gen = torch.Generator(device=self.device).manual_seed(11)
        # and one for the loop closer's Sim3 RANSAC
        self._loop_gen = torch.Generator(device=self.device).manual_seed(7)
        self._batch_chunk = 4  # frames per streamed chunk (the JAX package's default)
        self._loop_closer = (loop_closing.LoopCloser(config, self._loop_gen)
                             if enable_loop_closing else None)
        # the tracking steps (both modes, the LOST branch included), the
        # streamed frame phase, the per-frame relocalization and the closer's
        # detection and correction through captured CUDA graphs on the card
        # (models/step_graph.py, models/program_graphs.py); None: all op by
        # op (the CPU's default; tests set a CPU StepGraph here to run its
        # plain versions)
        self.step_graph = StepGraph(config, self.device) if self.device.type == "cuda" else None
        self._last_big_change = 0
        # seconds per tracked frame: one entry per track_* call, and a chunked
        # batch's time spread evenly over its frames (kept across reset())
        self.timings: list[float] = []
        self.reset()

    @property
    def step_graph(self) -> Optional[StepGraph]:
        return self._step_graph

    @step_graph.setter
    def step_graph(self, sg: Optional[StepGraph]) -> None:
        self._step_graph = sg
        if self._loop_closer is not None:
            self._loop_closer.graphs = sg.closer if sg is not None else None

    def warm_start(self) -> None:
        """Warm the loop closer's device libraries (LoopCloser.warmup, with
        the closer on; with the graphs, it captures detection and
        correction, the global BA's slices and merge), prime the streaming
        pipeline and capture the frame phase's, the per-frame frame build's
        and the step's CUDA graphs (with a vocabulary, the LOST branch's and
        the per-frame relocalization's too; for mono, the bootstrap's),
        before the first real frame: the runtime analogue of the reference's
        seconds-long ORBvoc load at startup (src/System.cc:77-89).  Optional; without it
        the first chunk and the first closure pay the kernel builds, the
        libraries' start-up and the capture.  Touches neither the map, the
        carry, the trajectory nor the engine's random streams."""
        if self._loop_closer is not None and self._loop_closer.enabled:
            self._loop_closer.warmup(self.map)
        self._prime_stream()

    def _prime_stream(self) -> None:
        """Build the kernels and push PRIME_CHUNKS dummy packed chunks (valid
        False: the steps take only their pass-through branch) through upload,
        the streamed frame phase and batch_steps_frames, on a scratch map and
        carry with a generator of their own; then capture the step graphs
        (of the current mode), with a vocabulary the relocalization graph,
        on that scratch state, then the chunk graph of the current mode at
        the stream's chunk shape, the per-frame frame build of the sensor on
        blank images and, for mono, the bootstrap's frame build and attempt
        on a blank pair (the attempt's eager first run draws from the
        scratch generator)."""
        cfg = self.config
        sensor = cfg.sensor
        H, W = int(cfg.camera.height), int(cfg.camera.width)
        C = self._batch_chunk
        pack, _ = _SENSORS[sensor]
        planes = [np.zeros((C, H, W), np.uint8)]
        if sensor != "mono":
            planes.append(np.zeros((C, H, W), np.uint16 if sensor == "rgbd" else np.uint8))
        host_buf = pack(*planes, np.zeros(C, np.float32), np.zeros(C, bool))
        m = ms.empty_map(cfg, self.device)
        gen = torch.Generator(device=self.device).manual_seed(0)
        carry = None
        for _ in range(PRIME_CHUNKS):
            frames, ts, valid = self._frame_phase(sensor, host_buf)
            if carry is None:
                carry = pipeline.init_carry(cfg, frames.select(0))
            m, carry, packed = pipeline.batch_steps_frames(
                cfg, m, carry, frames, ts, valid, self.enable_mapping,
                localization_only=self.localization_only, generator=gen)
        packed.cpu()  # waits for the device
        sg = self.step_graph
        if sg is not None:
            sg.capture(m, carry, frames.select(0), self.enable_mapping, self._stream_gen,
                       self.localization_only, chunk=frames)
            if cfg.vocab is not None:
                sg.reloc.capture(m, frames.select(0), self._reloc_gen, gen)
            blank = tuple(torch.from_numpy(a[0].astype(np.float32)) for a in planes)
            sg.frames.single(sensor, blank)
            if sensor == "mono":
                f = sg.mono.frame(blank)
                sg.mono.capture(ms.empty_map(cfg, self.device), f, f, self._mono_gen, gen)

    # ------------------------------------------------------------- public API

    def track_rgbd(self, image: np.ndarray, depth: np.ndarray, timestamp: float) -> np.ndarray:
        """One frame: [H, W] grayscale (0..255) and depth in metres."""
        return self._timed_track("rgbd", (image, depth), timestamp)

    def track_stereo(self, image_l: np.ndarray, image_r: np.ndarray,
                     timestamp: float) -> np.ndarray:
        """One stereo pair of [H, W] grayscale images (reference
        System::TrackStereo); raw eyes when config.rect_maps is set."""
        return self._timed_track("stereo", (image_l, image_r), timestamp)

    def track_monocular(self, image: np.ndarray, timestamp: float) -> np.ndarray:
        """One [H, W] grayscale image (reference System::TrackMonocular,
        src/System.cc:292).  Until the two-view bootstrap succeeds the pose
        returned is the identity and no trajectory entry is kept for
        get_trajectory()."""
        return self._timed_track("mono", (image,), timestamp)

    def _timed_track(self, sensor: str, images: tuple, timestamp: float) -> np.ndarray:
        """One call of the per-frame API: the `call` span of the tracer."""
        with profiling.span("call"):
            profiling.count("frames")
            with profiling.span("session.pack"):
                images = tuple(_f32(a) for a in images)
            t0 = time.perf_counter()
            out = self._track(sensor, images, timestamp)  # ends in a host read of the pose
            self.timings.append(time.perf_counter() - t0)
            return out

    def track_batch_rgbd(self, images: np.ndarray, depths: np.ndarray,
                         timestamps: np.ndarray,
                         chunk: Optional[int] = None) -> np.ndarray:
        """Throughput mode: stream a frame batch in fixed-size chunks (the
        first frame initializes the map if needed).  Returns [B, 4, 4] poses."""
        return self._track_batch("rgbd", (images, depths), timestamps, chunk)

    def track_batch_stereo(self, images_l: np.ndarray, images_r: np.ndarray,
                           timestamps: np.ndarray,
                           chunk: Optional[int] = None) -> np.ndarray:
        """Stereo throughput mode (see track_batch_rgbd)."""
        return self._track_batch("stereo", (images_l, images_r), timestamps, chunk)

    def track_batch_mono(self, images: np.ndarray, timestamps: np.ndarray,
                         chunk: Optional[int] = None) -> np.ndarray:
        """Monocular throughput mode (see track_batch_rgbd).  The two-view
        bootstrap runs through the per-frame path until the map initializes
        (possibly consuming several leading frames); the rest stream in
        chunks, and only their poses are returned."""
        return self._track_batch("mono", (images,), timestamps, chunk)

    def _track_batch(self, sensor: str, arrays: tuple, timestamps,
                     chunk: Optional[int]) -> np.ndarray:
        """One call of the batch API (the images, and RGB-D depths in
        metres, as given): the `call` span of the tracer."""
        with profiling.span("call"):
            profiling.count("frames", np.size(timestamps))
            with profiling.span("session.pack"):
                arrays = _host_planes(sensor, arrays)
            t0 = time.perf_counter()
            sess = self.open_stream(sensor, chunk)
            sess.feed(arrays, timestamps)
            poses = sess.finish()
            if len(poses) == 0:
                return np.asarray(self.Tcw)[None]
            self.timings.extend([(time.perf_counter() - t0) / len(poses)] * len(poses))
            return poses

    def open_stream(self, sensor: str, chunk: Optional[int] = None) -> StreamSession:
        """A persistent streaming session: feed() chunks for the lifetime of a
        run (models/streaming.py)."""
        return StreamSession(self, sensor, chunk)

    def activate_localization_mode(self) -> None:
        """Reference System::ActivateLocalizationMode (src/System.cc:346):
        track against the map as it is; no keyframes, no mapping.  With the
        graphs and a tracked frame, the localization-mode graphs (the
        chunk graph too, once a chunk or warm_start has shaped the chunk
        buffers) are captured here, outside any frame."""
        self.localization_only = True
        sg = self.step_graph
        if sg is not None and self.carry is not None:
            sg.prepare(self.map, self.carry, self.carry.last_frame, self.enable_mapping,
                       self._stream_gen, True, chunk=sg.chunk_frames)

    def deactivate_localization_mode(self) -> None:
        self.localization_only = False

    def map_changed(self) -> bool:
        """True once per big map change, a loop closure (reference
        System::MapChanged, src/System.cc:362-374, via
        Map::InformNewBigChange)."""
        idx = self._loop_closer.n_big_changes if self._loop_closer else 0
        changed = idx != self._last_big_change
        self._last_big_change = idx
        return changed

    def shutdown(self) -> None:
        """Parity with reference System::Shutdown: nothing runs in the
        background, so nothing is stopped."""

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

    def save_trajectory_kitti(self, path: str) -> None:
        _, poses = self.get_trajectory()
        traj_io.save_kitti(path, poses)

    def save_keyframe_trajectory_tum(self, path: str) -> None:
        """Keyframe-only trajectory (reference System::SaveKeyFrameTrajectoryTUM,
        src/System.cc:505-549): the live keyframes' optimized poses."""
        m = self.map
        valid = m.kf_valid.cpu().numpy()
        traj_io.save_tum(path, m.kf_timestamp.cpu().numpy()[valid],
                         m.kf_Tcw.cpu().numpy()[valid])

    def n_keyframes(self) -> int:
        return int(self.map.n_kf)

    def n_points(self) -> int:
        return int(torch.sum(self.map.pt_valid))

    @property
    def last_obs_pt(self) -> Optional[torch.Tensor]:
        """[N] map point matched to each feature of the last frame (-1: none)."""
        return self.carry.last_obs_pt if self.carry is not None else None

    @property
    def last_frame(self) -> Optional[frame_mod.FrameData]:
        return self.carry.last_frame if self.carry is not None else None

    # ------------------------------------------------------------ loop closing

    def _consume_chunk_infos(self, arr: np.ndarray, kf_seq: np.ndarray,
                             kf_valid: np.ndarray) -> np.ndarray:
        """One chunk group's packed StepInfo (host copy) -> loop detection
        dispatched for every keyframe created in it.  Keyframes are known by
        seq: a slot culled and reused since its step is re-resolved against
        the map's (kf_seq, kf_valid) read with the infos, and a seq no longer
        live is skipped."""
        infos = pipeline.unpack_infos(arr)
        slots = []
        for b in np.nonzero(infos.created_kf)[0]:
            seq, slot = int(infos.ref_kf_seq[b]), int(infos.ref_kf[b])
            if not (0 <= slot < len(kf_seq)) or kf_seq[slot] != seq or not kf_valid[slot]:
                live = np.nonzero((kf_seq == seq) & kf_valid)[0]
                if len(live) == 0:
                    continue  # culled before loop processing could run
                slot = int(live[0])
            slots.append(slot)
        if slots:
            self._loop_closer.dispatch_group(self.map, slots)
        return arr

    def _apply_correction_to_carry(self, kf_slot, kf_Tcw_before,
                                   kf_Tcw_after=None) -> None:
        """Re-base the live tracking state by one keyframe's pose change
        (reference CorrectLoop also moves the keyframe Tracking hangs off):
        new Tcw = Tcw . Tkw_before^-1 . Tkw_after, the camera-to-keyframe
        pose kept.  kf_Tcw_after None: the keyframe's current pose."""
        if self.carry is None:
            return
        dev = self.device
        before = torch.as_tensor(kf_Tcw_before, dtype=torch.float32, device=dev)
        after = (row(self.map.kf_Tcw, torch.as_tensor(kf_slot, device=dev))
                 if kf_Tcw_after is None else kf_Tcw_after)
        new_Tcw = self.carry.Tcw @ torch.linalg.inv_ex(before)[0] @ after
        self.carry = self.carry._replace(Tcw=new_Tcw)
        self.Tcw = new_Tcw.cpu().numpy()

    # ------------------------------------------------------------ state machine

    def _relocalize_last_frame(self) -> None:
        """Reference: Tracking falls back to Relocalization when LOST
        (src/Tracking.cc:523-629, :2030).  One more attempt on the frame the
        step just lost, from the host-side stream (through the relocalization
        graph with the graphs); on success the carry restarts from the
        recovered pose with the velocity cleared."""
        m = self.map
        if self.step_graph is not None:
            reloc = self.step_graph.reloc.relocalize(m, self.carry.last_frame, self._reloc_gen)
        else:
            reloc = relocalization.relocalize(self.config, m, self.carry.last_frame,
                                              self._reloc_gen)
        profiling.count("host_waits")
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
        rgbd, (left, right) for stereo, (image,) for mono, float32 [H, W] on
        the host."""
        ts = torch.tensor(timestamp, dtype=torch.float32, device=self.device)
        if self.state == STATE_NOT_INITIALIZED and sensor == "mono":
            with profiling.span("step.init"):
                return self._mono_initialize(images[0], timestamp)
        if self.state == STATE_NOT_INITIALIZED:
            init = pipeline.init_rgbd if sensor == "rgbd" else pipeline.init_stereo
            with profiling.span("step.init"):
                images = tuple(a.to(self.device) for a in images)
                m, carry, n_depth = init(self.config, self.map, *images, ts)
                profiling.count("host_waits")
                enough = int(n_depth) >= self.config.tracking.min_init_depth_points
            if enough:
                self.map, self.carry = m, carry
                self.state = STATE_OK
                self.Tcw = np.eye(4, dtype=np.float32)
                self._rel_trajectory.append((timestamp, 0, np.eye(4)))
            else:  # not enough depth features: drop the premature keyframe
                self.map = ms.empty_map(self.config, self.device)
                self.carry = None
        else:
            info = self._step(self._build_frame(sensor, images), ts)
            self.Tcw = info.Tcw[0].copy()
            self.state = STATE_OK if info.state_ok[0] else STATE_LOST
            self.vo_mode = bool(info.vo[0])
            profiling.count("keyframes", int(info.created_kf[0]))
            if self.state == STATE_LOST and self.config.vocab is not None:
                with profiling.span("step.reloc"):
                    self._relocalize_last_frame()
            ref_kf_Tcw = info.ref_kf_Tcw[0]
            Tcr = self.Tcw @ np.linalg.inv(ref_kf_Tcw)
            self._rel_trajectory.append((timestamp, int(info.ref_kf_seq[0]), Tcr))
            if self._loop_closer is not None and info.created_kf[0]:
                before = self._loop_closer.n_big_changes
                self.map = self._loop_closer.process(self.map, int(info.ref_kf[0]))
                if self._loop_closer.n_big_changes != before:
                    self._apply_correction_to_carry(int(info.ref_kf[0]), ref_kf_Tcw)
        self.trajectory.append((timestamp, self.Tcw))
        return self.Tcw

    def _build_frame(self, sensor: str, images: tuple) -> frame_mod.FrameData:
        """One frame of the per-frame API from host images: through the
        frame-build graph of the step graphs, else op by op."""
        if self.step_graph is not None:
            return self.step_graph.frames.single(sensor, images)
        with profiling.span("frame.upload"), profiling.span("frame.h2d", self.device):
            images = tuple(a.to(self.device) for a in images)
        with profiling.span("frame.build", self.device):
            return _FRAME_BUILDERS[sensor](self.config, *images)

    def _step(self, frame: frame_mod.FrameData, ts: torch.Tensor) -> pipeline.StepInfo:
        """One tracking step of the per-frame API -> its StepInfo on the host
        (numpy, a leading axis of 1), read in one transfer with the step's
        flags on a frame that takes neither branch.  With no carry (a map
        loaded into a fresh System) track_step raises, as in the JAX
        package."""
        if self.step_graph is not None and self.carry is not None:
            self.map, self.carry, row = self.step_graph.step(
                self.map, self.carry, frame, ts, self.enable_mapping, self._stream_gen,
                self.localization_only)
        else:
            with profiling.span("step.frame", self.device):
                self.map, self.carry, info = pipeline.track_step(
                    self.config, self.map, self.carry, frame, ts, self.enable_mapping,
                    localization_only=self.localization_only, generator=self._stream_gen)
            with profiling.span("step.read"):
                profiling.count("host_waits")
                row = pipeline.pack_infos([info])[0].cpu().numpy()
        return pipeline.unpack_infos(row[None])

    def _frame_phase(self, sensor: str, host_buf: np.ndarray):
        """A packed host chunk uploaded and built into (frames, ts, valid):
        through the frame-phase graph of the step graphs, else op by op."""
        if self.step_graph is not None:
            return self.step_graph.frames(sensor, host_buf)
        with profiling.span("frame.upload"), profiling.span("frame.h2d", self.device):
            buf = torch.from_numpy(host_buf).to(self.device)
        with profiling.span("frame.phase", self.device):
            return _SENSORS[sensor][1](self.config, buf)

    def _batch_steps(self, frames: frame_mod.FrameData, ts: torch.Tensor,
                     valid: torch.Tensor, localization_only: bool) -> torch.Tensor:
        """A chunk's tracking steps (StreamSession._dispatch) on the map and
        carry -> packed StepInfo [B, 40] on the device."""
        if self.step_graph is not None:
            self.map, self.carry, packed = self.step_graph.batch_steps(
                self.map, self.carry, frames, ts, valid, self.enable_mapping, self._stream_gen,
                localization_only)
        else:
            with profiling.span("step.chunk", self.device):
                self.map, self.carry, packed = pipeline.batch_steps_frames(
                    self.config, self.map, self.carry, frames, ts, valid, self.enable_mapping,
                    localization_only=localization_only, generator=self._stream_gen)
        return packed

    def _mono_initialize(self, image: torch.Tensor, timestamp: float) -> np.ndarray:
        """Two-frame monocular bootstrap (reference
        Tracking::MonocularInitialization, src/Tracking.cc:886) from a host
        image: with the graphs, a replay of the doubled-budget frame build
        and one of the attempt (program_graphs.MonoInitGraphs), else op by
        op.  Host reads: the feature count, then (success, matches) in one
        transfer."""
        sg = self.step_graph
        if sg is not None:
            frame = sg.mono.frame((image,))
        else:
            frame = frame_mod.make_frame_mono(self._ini_config, image.to(self.device))
        enough = int(torch.sum(frame.valid)) >= 100
        if self._mono_first is None or not enough:
            self._mono_first = frame if enough else None
            self._mono_first_ts = timestamp
        else:
            args = (self.map, self._mono_first, frame, self._mono_first_ts, timestamp,
                    len(self.trajectory), self._mono_gen)
            res = (sg.mono.try_initialize(*args) if sg is not None
                   else mono_init.try_initialize(self.config, *args))
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
