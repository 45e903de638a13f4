"""Fleet tracking: S independent camera streams in one SPMD program.

Counterpart of the JAX package's parallel/fleet.py.  The serving mode for
tracking itself: each stream's map and carry live on the device of the rank
that owns it (a 1-axis ("map") mesh of ranks, n_streams / world streams per
rank), and every rank advances its streams by a chunk of frames through the
packed-chunk pipeline (models/pipeline.py).  Streams are independent, so the
only collective is one all_gather of the packed per-frame infos per chunk,
which gives every rank every stream's poses.

Each rank runs its local streams one after another, each through its own
frame phase and tracking steps, so every stream keeps its own keyframe
branch (no vmap over streams, which in the JAX package would turn the
keyframe cond into a select and run mapping on every stream every frame).
On the card each local stream has a runner of its own
(models/step_graph.py StepGraph, with its FrameGraphs): its chunks replay
captured CUDA graphs on the stream's static map, as a System's do, in SLAM
and in localization mode: one frame-phase replay and one chunk-graph
replay a chunk, and no host read before the gather (checked under
streaming.no_host_reads()).  step_graphs = None runs them op by op
(pipeline.batch_steps_*_packed), the CPU's default; a list of CPU runners
runs their plain versions.  Each stream draws its in-stream relocalization
hypotheses from its own torch.Generator, seeded as System seeds its
stream's (23) and registered with its runner's LOST graph, so stream s
tracks as a System would on its frames.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models import frame as frame_mod
from ..models import map_state as ms
from ..models import pipeline, streaming
from ..models.config import SlamConfig
from ..models.step_graph import StepGraph
from ..models.system import config_on_device, resolve_device
from .mesh import Mesh, world

_EYE = np.eye(4, dtype=np.float32)


def make_fleet_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-axis ("map") mesh over the first n_devices ranks (default all)."""
    devices = list(devices) if devices is not None else list(range(world()[1]))
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"fleet mesh needs {n} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n]), ("map",))


class FleetTracker:
    """Lockstep tracker for `n_streams` RGB-D or stereo streams.

    Usage (on every rank of the mesh, with the same arrays):
        fleet = FleetTracker(cfg, n_streams=8, sensor="rgbd")
        fleet.initialize(images0, depths0, ts0)        # frame 0 per stream
        poses = fleet.track_chunk(images, depths, ts)  # [S, B, 4, 4]

    The engine runs on `cuda` unless the caller passes device="cpu"."""

    def __init__(self, config: SlamConfig, n_streams: int,
                 sensor: str = "rgbd", mesh: Optional[Mesh] = None,
                 enable_mapping: bool = True, localization_only: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.config = config_on_device(config, self.device)
        self.sensor = sensor
        self.mesh = (mesh if mesh is not None else make_fleet_mesh()).for_this_rank()
        D = self.mesh.size
        if n_streams % D != 0:
            raise ValueError(f"n_streams={n_streams} not divisible by mesh size {D}")
        self.n_streams = n_streams
        self.local = n_streams // D
        self.first = self.mesh.axis_index("map") * self.local   # this rank's first stream
        self.maps: list = []      # this rank's streams' MapStates
        self.carries: list = []   # and TrackCarrys
        self.trajectories = [[] for _ in range(n_streams)]
        # per-stream serving state, refreshed each track_chunk: tracking
        # alive, and the localization-mode VO flag (the reference's mbVO,
        # "map support lost, tracking on temporal VO points",
        # src/Tracking.cc:538-541); a serving deployment watches these
        self.state_ok = np.ones(n_streams, bool)
        self.vo = np.zeros(n_streams, bool)
        self.localization_only = localization_only
        self.run_mapping = enable_mapping and not localization_only
        rgbd = sensor == "rgbd"
        self._batch = (pipeline.batch_steps_rgbd_packed if rgbd
                       else pipeline.batch_steps_stereo_packed)
        self._init = pipeline.init_rgbd if rgbd else pipeline.init_stereo
        self._make_frame = frame_mod.make_frame_rgbd if rgbd else frame_mod.make_frame_stereo
        self._pack = pipeline.pack_rgbd_chunk if rgbd else pipeline.pack_stereo_chunk
        self._gens = [torch.Generator(device=self.device).manual_seed(23)
                      for _ in range(self.local)]
        # one runner per local stream on the card (its static map is the
        # stream's); None: op by op
        self.step_graphs: Optional[list] = (
            [StepGraph(self.config, self.device) for _ in range(self.local)]
            if self.device.type == "cuda" else None)

    def _mine(self):
        return range(self.first, self.first + self.local)

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    def _gather(self, rows: list) -> np.ndarray:
        """[S, ...] on the host from this rank's per-stream tensors."""
        return self.mesh.all_gather(torch.stack(rows), "map").cpu().numpy()

    # ------------------------------------------------------------------ API

    def initialize(self, a0: np.ndarray, b0: np.ndarray, ts0: np.ndarray) -> None:
        """Initialize every stream from its first frame.  a0: [S, H, W]
        images; b0: [S, H, W] depths in metres (rgbd) or right images
        (stereo)."""
        self.maps, self.carries = [], []
        for s in self._mine():
            m, carry, _ = self._init(
                self.config, ms.empty_map(self.config, self.device), self._f32(a0[s]),
                self._f32(b0[s]), torch.tensor(float(ts0[s]), device=self.device))
            self.maps.append(m)
            self.carries.append(carry)
        self._prepare()
        for s in range(self.n_streams):
            self.trajectories[s].append((float(ts0[s]), _EYE.copy()))

    def initialize_localization(self, prebuilt_map, a0: np.ndarray,
                                b0: np.ndarray, ts0: np.ndarray) -> np.ndarray:
        """Localization-serving bring-up: every stream relocalizes its first
        frame against a PREBUILT map (models/checkpoint.py; the reference's
        Localization Mode on a frozen map, Tracking.cc:523-629) instead of
        building its own.  `prebuilt_map`: one MapState (shared by all
        streams; each takes its own copy on the device) or a list of
        per-stream MapStates.  Returns [S] success flags; failed streams
        start at identity and dead-reckon until their content overlaps the
        map.  Stream s draws its RANSAC sets from a generator of its own
        seeded 3 + s (the JAX package splits PRNGKey(3) over the streams),
        so the draws do not depend on how the streams fall on ranks."""
        from ..models.relocalization import relocalize

        if self.config.vocab is None:
            raise ValueError("localization bring-up needs a vocabulary")
        if isinstance(prebuilt_map, ms.MapState):  # NamedTuple IS a tuple
            prebuilt_map = [prebuilt_map] * self.n_streams
        self.maps, self.carries, rows = [], [], []
        for s in self._mine():
            m = ms.MapState(*(x.to(self.device).clone() for x in prebuilt_map[s]))
            frame = self._make_frame(self.config, self._f32(a0[s]), self._f32(b0[s]))
            gen = torch.Generator(device=self.device).manual_seed(3 + s)
            reloc = relocalize(self.config, m, frame, gen)
            carry = pipeline.init_carry(self.config, frame)
            ok = reloc.success.to(torch.bool)
            obs_r = torch.where(ok, reloc.obs_pt, carry.last_obs_pt)
            carry = carry._replace(
                Tcw=torch.where(ok, reloc.Tcw, carry.Tcw),
                last_obs_pt=obs_r,
                last_obs_birth=torch.where(
                    obs_r >= 0, m.pt_birth[torch.clamp(obs_r, 0, m.max_pt - 1).long()], 0),
                frame_id=torch.ones((), dtype=torch.int32, device=self.device),
                state_ok=ok.clone(),
            )
            self.maps.append(m)
            self.carries.append(carry)
            rows.append(torch.cat([carry.Tcw.reshape(16), ok.to(torch.float32)[None]]))
        self._prepare()
        got = self._gather(rows)
        for s in range(self.n_streams):
            self.trajectories[s].append((float(ts0[s]), got[s, :16].reshape(4, 4)))
        return got[:, 16] > 0.5

    def _prepare(self) -> None:
        """Warm each local stream's step graphs of the fleet's mode on its
        state (bring-up); the chunk graph is captured at the first chunk,
        which gives its shape."""
        for i, sg in enumerate(self.step_graphs or ()):
            sg.prepare(self.maps[i], self.carries[i], self.carries[i].last_frame,
                       self.run_mapping, self._gens[i], self.localization_only, parts=False)

    def track_chunk(self, a: np.ndarray, b: np.ndarray, ts: np.ndarray) -> np.ndarray:
        """Advance all streams by one chunk.  a / b: [S, B, H, W]; ts: [S, B].
        Returns per-frame poses [S, B, 4, 4]."""
        S, B = a.shape[:2]
        assert S == self.n_streams
        valid = np.ones(B, bool)
        packed = []
        for i, s in enumerate(self._mine()):
            au = np.clip(a[s], 0, 255).astype(np.uint8)
            bu = (np.clip(np.asarray(b[s]) * 1e3, 0, 65535).astype(np.uint16)
                  if self.sensor == "rgbd" else np.clip(b[s], 0, 255).astype(np.uint8))
            host = self._pack(au, bu, np.asarray(ts[s], np.float32), valid)
            if self.step_graphs is None:
                self.maps[i], self.carries[i], pk = self._batch(
                    self.config, self.maps[i], self.carries[i],
                    torch.from_numpy(host).to(self.device), self.run_mapping,
                    localization_only=self.localization_only, generator=self._gens[i])
            else:
                sg = self.step_graphs[i]
                with streaming.checked_dispatch(sg):   # no host read until the gather
                    frames, tsd, vd = sg.frames(self.sensor, host)
                    self.maps[i], self.carries[i], pk = sg.batch_steps(
                        self.maps[i], self.carries[i], frames, tsd, vd, self.run_mapping,
                        self._gens[i], self.localization_only)
            packed.append(pk)
        packed = self._gather(packed)  # [S, B, 40] one fetch
        poses = np.zeros((S, B, 4, 4), np.float32)
        for s in range(S):
            infos = pipeline.unpack_infos(packed[s])
            poses[s] = infos.Tcw
            self.state_ok[s] = bool(infos.state_ok[-1])
            self.vo[s] = bool(infos.vo[-1])
            for b_i in range(B):
                self.trajectories[s].append((float(ts[s][b_i]), np.asarray(infos.Tcw[b_i])))
        return poses

    def stream_map(self, s: int) -> ms.MapState:
        """One stream's MapState (a copy, on this rank's device; e.g. for
        joint_refine).  Called on every rank of the mesh: the owner
        broadcasts it over the "map" axis."""
        own, i = divmod(s, self.local)
        if self.mesh.size == 1:
            return ms.MapState(*(x.clone() for x in self.maps[i]))
        mine = own == self.mesh.axis_index("map")
        template = self.maps[i if mine else 0]   # every stream has the same capacities
        return ms.MapState(*(self.mesh.broadcast(x.clone(), "map", own) for x in template))

    def n_keyframes(self) -> np.ndarray:
        return self._gather([m.n_kf for m in self.maps])

    def n_points(self) -> np.ndarray:
        return self._gather([m.n_pt for m in self.maps])
