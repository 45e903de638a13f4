"""Per-frame SLAM step and the chunked stream, for the three sensors.

Counterpart of the JAX package's models/pipeline.py: a chunk of frames is
built through one batched extraction chain (frames_rgbd_packed,
frames_stereo_packed or frames_mono_packed), then the
tracking steps run in order over it (batch_steps_frames -> track_step):
dual-hypothesis motion tracking, local-map tracking, the keyframe decision,
keyframe insertion and, with run_mapping, the local-mapping pass.  The JAX
package compiles each step into one XLA program with lax.cond branches; here
track_step is split at its host branches: step_core (everything up to the
flags), relocalize_branch and keyframe_tail, with one host `if` on the flags
between them.  step_core and keyframe_tail build no tensor from host data
(ops/constants.py holds the step's constants) and read nothing back, so a
CUDA System replays each as a captured graph (models/step_graph.py).

Host reads per frame: one, the flags (the keyframe flag and, with a
vocabulary, the "wants relocalization" flag, in one transfer).  A frame
that relocalizes reads once more (the keyframe decision after the recovered
pose).  Localization mode (_localization_core) and the LOST branch
(relocalize_branch) read nothing themselves, so the graphs capture them
too, and a CUDA System replays a whole chunk of batch_steps_frames as one
graph whose branches are conditional nodes (models/step_graph.py).

With a vocabulary the LOST branch relocalizes inside the stream (reference
Tracking.cc:523-629, :2030), drawing its RANSAC sets from a torch.Generator
the caller owns.  Without one nothing random runs, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops import se3
from ..ops.constants import constant
from ..ops.indexing import row, select
from . import frame as frame_mod
from . import local_mapping
from . import map_state as ms
from . import relocalization
from . import tracking
from .config import SlamConfig
from .frame import FrameData
from .map_state import NO_POINT, MapState


class TrackCarry(NamedTuple):
    """Tracking state threaded between frames (JAX field names)."""

    Tcw: torch.Tensor            # [4, 4]
    velocity: torch.Tensor       # [4, 4]
    last_frame: FrameData
    last_obs_pt: torch.Tensor    # [N]
    last_obs_birth: torch.Tensor # [N] pt_birth stamps captured with last_obs_pt
    frame_id: torch.Tensor       # scalar int32
    last_kf_frame_id: torch.Tensor
    prev_inliers: torch.Tensor   # scalar int32
    state_ok: torch.Tensor       # scalar bool (False = lost)
    key: torch.Tensor            # [2] int64: the JAX package's relocalization
                                 # PRNG key words.  Carried unchanged so that
                                 # state still swaps with that package; the
                                 # port's random draws come from the
                                 # torch.Generator handed to track_step
    vo: torch.Tensor             # scalar bool: localization-mode VO flag


class StepInfo(NamedTuple):
    """Small per-step summary fetched by the host."""

    Tcw: torch.Tensor
    n_inliers: torch.Tensor
    created_kf: torch.Tensor   # bool
    state_ok: torch.Tensor     # bool
    n_keyframes: torch.Tensor
    n_points: torch.Tensor
    ref_kf: torch.Tensor       # latest keyframe slot
    ref_kf_Tcw: torch.Tensor   # its pose at track time
    ref_kf_seq: torch.Tensor   # its sequence number
    vo: torch.Tensor           # bool


def _scalar(value, dtype, device) -> torch.Tensor:
    """A 0-d tensor of a Python value: a device fill, not a copy of host data."""
    return torch.full((), value, dtype=dtype, device=device)


def init_carry(config: SlamConfig, frame: FrameData) -> TrackCarry:
    n = frame.capacity
    dev = frame.xy.device
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    return TrackCarry(
        Tcw=eye,
        velocity=eye.clone(),
        last_frame=frame,
        last_obs_pt=torch.full((n,), NO_POINT, dtype=torch.int32, device=dev),
        last_obs_birth=torch.zeros(n, dtype=torch.int32, device=dev),
        frame_id=_scalar(0, torch.int32, dev),
        last_kf_frame_id=_scalar(0, torch.int32, dev),
        prev_inliers=_scalar(0, torch.int32, dev),
        state_ok=_scalar(True, torch.bool, dev),
        key=constant((0, 23), torch.int64, dev).clone(),  # PRNGKey(23)
        vo=_scalar(False, torch.bool, dev),
    )


def _need_keyframe(config: SlamConfig, m: MapState, carry: TrackCarry,
                   frame: FrameData, lres: tracking.LocalMapResult,
                   localization_only: bool = False) -> torch.Tensor:
    """Keyframe policy (reference Tracking::NeedNewKeyFrame,
    src/Tracking.cc:1509-1648, as the JAX package adapts it); never in
    localization mode."""
    if localization_only:
        return torch.zeros((), dtype=torch.bool, device=frame.xy.device)
    cfg = config.tracking
    frames_since = carry.frame_id - carry.last_kf_frame_id
    n_inl = lres.n_inliers
    overlap = lres.ref_shared.to(torch.float32) / torch.clamp_min(n_inl, 1).to(torch.float32)
    close = frame.has_depth() & (frame.depth < config.th_depth)
    n_close_tracked = torch.sum(close & (lres.obs_pt >= 0))
    n_close_new = torch.sum(close & (lres.obs_pt < 0))
    c1 = frames_since >= cfg.max_frames_between_kf
    c2 = overlap < cfg.kf_ref_ratio_stereo
    c3 = (n_close_tracked < cfg.kf_min_close_points) & (n_close_new > cfg.kf_min_new_close)
    attrition = (cfg.kf_attrition_ratio_mono if config.sensor == "mono"
                 else cfg.kf_attrition_ratio)
    c4 = n_inl < (attrition * carry.prev_inliers.to(torch.float32))
    capacity_ok = ~torch.all(m.kf_valid)  # a free slot exists
    need = (c1 | c2 | c3 | c4) & (n_inl >= 15) & capacity_ok
    return need & (frames_since >= cfg.min_frames_between_kf)


# Seconds of each local-mapping pass while timed_mapping_passes() is open,
# else None (nothing is timed).
_pass_s: list | None = None


@contextlib.contextmanager
def timed_mapping_passes():
    """Time every local-mapping pass track_step runs inside the block (host
    clock, with cuda.synchronize on both sides on a CUDA map); yields the
    list the seconds are appended to."""
    global _pass_s
    _pass_s = []
    try:
        yield _pass_s
    finally:
        _pass_s = None


@contextlib.contextmanager
def untimed_mapping_passes():
    """Suspend timed_mapping_passes() inside the block (a graph's warm-up and
    capture run passes that are not the stream's, and a capture cannot
    synchronize)."""
    global _pass_s
    saved, _pass_s = _pass_s, None
    try:
        yield
    finally:
        _pass_s = saved


def record_pass_seconds(seconds: float) -> None:
    """Append a pass timed elsewhere (a replayed keyframe graph) to the open
    timed_mapping_passes() list, if any."""
    if _pass_s is not None:
        _pass_s.append(seconds)


def mapping_passes_timed() -> bool:
    return _pass_s is not None


# device -> 0-d int64: local-mapping passes run since reset_mapping_passes()
_pass_counters: dict = {}


def pass_counter(device) -> torch.Tensor:
    """The device's count of local-mapping passes (made at first use: a
    graph that counts into it must be captured after that).  A pass inside a
    captured graph counts when the graph replays its branch, where no host
    timer can see it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    c = _pass_counters.get(dev)
    if c is None:
        c = _pass_counters[dev] = torch.zeros((), dtype=torch.int64, device=dev)
    return c


def reset_mapping_passes() -> None:
    for c in _pass_counters.values():
        c.zero_()


def mapping_passes() -> int:
    """Local-mapping passes since reset_mapping_passes(); reads the devices."""
    return sum(int(c) for c in _pass_counters.values() if c.device.type != "meta")


def _mapping_pass(config: SlamConfig, m: MapState, kf_id: torch.Tensor) -> MapState:
    pass_counter(m.kf_valid.device).add_(1)
    if _pass_s is None:
        return local_mapping._process(config, m, kf_id)
    sync = torch.cuda.synchronize if m.kf_valid.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    m = local_mapping._process(config, m, kf_id)
    sync()
    _pass_s.append(time.perf_counter() - t0)
    return m


def _motion_hypotheses(track, config, m, carry, frame):
    """Dual-hypothesis motion tracking: the static prior with the wide window
    and the constant-velocity prior; static wins unless clearly worse."""
    cfg = config.tracking
    eye = torch.eye(4, dtype=torch.float32, device=frame.xy.device)
    res_static, res_vel = (
        track(config, m, frame, carry.Tcw, vel, carry.last_frame,
              carry.last_obs_pt, rad, last_obs_birth=carry.last_obs_birth)
        for vel, rad in ((eye, cfg.motion_search_radius_wide),
                         (carry.velocity, cfg.motion_search_radius)))
    take_static = (res_static.n_inliers.to(torch.float32)
                   >= 0.9 * res_vel.n_inliers.to(torch.float32))
    return select(take_static, res_static, res_vel)


def _echo_local_map(config: SlamConfig, m: MapState, res) -> tracking.LocalMapResult:
    """The motion result in LocalMapResult shape, for a localization-mode
    frame with no local map to retrieve (the reference skips TrackLocalMap
    entirely when mbVO, Tracking.cc:648-655)."""
    dev = res.Tcw.device
    return tracking.LocalMapResult(
        Tcw=res.Tcw, obs_pt=res.obs_pt, n_inliers=res.n_inliers,
        local_kf_mask=torch.zeros(m.max_kf, dtype=torch.bool, device=dev),
        visible_pt=torch.full((config.caps.local_points,), NO_POINT,
                              dtype=torch.int32, device=dev),
        found_pt_mask=res.obs_pt >= 0,
        ref_kf=ms.latest_kf(m),
        ref_shared=torch.zeros((), dtype=torch.int32, device=dev),
        ref_total=torch.ones((), dtype=torch.int32, device=dev),
    )


class StepCore(NamedTuple):
    """What a step knows before its host branches: the carry and StepInfo
    of a frame that neither relocalizes nor inserts a keyframe, and what the
    branches read."""

    carry: TrackCarry
    info: StepInfo
    lres: tracking.LocalMapResult
    ok: torch.Tensor           # bool: tracking held
    need_kf: torch.Tensor      # bool: the keyframe decision
    want_reloc: torch.Tensor   # bool: the LOST branch would run
    vo_now: torch.Tensor       # bool: localization-mode map support lost
    relocated: torch.Tensor    # bool: the LOST branch recovered the pose
                               # (False before it runs)


def _birth(m: MapState, obs_pt: torch.Tensor) -> torch.Tensor:
    """pt_birth stamps of the points in obs_pt (0 where none)."""
    return torch.where(obs_pt >= 0, m.pt_birth[torch.clamp(obs_pt, 0, m.max_pt - 1).long()], 0)


def _advance(m: MapState, carry: TrackCarry, frame: FrameData,
             lres: tracking.LocalMapResult, ok, need_kf, vo_now,
             relocated: torch.Tensor | None = None):
    """The carry and StepInfo after a frame that inserts no keyframe
    (relocated None: the LOST branch did not run)."""
    new_Tcw = torch.where(ok, lres.Tcw, carry.velocity @ carry.Tcw)  # dead-reckon if lost
    new_velocity = torch.where(ok, new_Tcw @ se3.inverse(carry.Tcw), carry.velocity)
    vo = vo_now
    if relocated is not None:
        new_velocity = torch.where(
            relocated, torch.eye(4, dtype=torch.float32, device=new_Tcw.device), new_velocity)
        vo = vo_now & ~relocated   # mbVO clears on relocalization success (Tracking.cc:623)
    obs_pt = torch.where(ok, lres.obs_pt, NO_POINT)
    carry_out = TrackCarry(
        Tcw=new_Tcw,
        velocity=new_velocity,
        last_frame=frame,
        last_obs_pt=obs_pt,
        last_obs_birth=_birth(m, obs_pt),
        frame_id=carry.frame_id + 1,
        last_kf_frame_id=torch.where(need_kf, carry.frame_id, carry.last_kf_frame_id),
        prev_inliers=torch.where(ok, lres.n_inliers, carry.prev_inliers),
        state_ok=ok,
        key=carry.key,
        vo=vo,
    )
    return carry_out, _info(m, new_Tcw, lres.n_inliers, need_kf, ok, vo)


def step_core(config: SlamConfig, m: MapState, carry: TrackCarry,
              frame: FrameData) -> StepCore:
    """The SLAM-mode step up to its host branches: the two motion
    hypotheses, local-map tracking, the keyframe decision and the LOST
    flag.  It reads nothing back to the host and builds no tensor from host
    data, so a CUDA graph captures it (models/step_graph.py)."""
    res = _motion_hypotheses(tracking.track_motion, config, m, carry, frame)
    lres = tracking.track_local_map(config, m, frame, res.Tcw, res.obs_pt)
    ok = lres.n_inliers >= config.tracking.min_inliers_local
    need_kf = _need_keyframe(config, m, carry, frame, lres) & ok
    vo_now = torch.zeros((), dtype=torch.bool, device=frame.xy.device)
    carry_out, info = _advance(m, carry, frame, lres, ok, need_kf, vo_now)
    return StepCore(carry_out, info, lres, ok, need_kf, ~ok, vo_now,
                    torch.zeros((), dtype=torch.bool, device=frame.xy.device))


def _localization_core(config: SlamConfig, m: MapState, carry: TrackCarry,
                       frame: FrameData) -> StepCore:
    """Localization mode (reference Tracking.cc:523-656): motion tracking is
    augmented with temporal visual-odometry points from the last frame's
    depth (UpdateLastFrame, :1247-1350); carry.vo is the reference's mbVO
    "map support lost" flag; local-map tracking is skipped while map
    support is lost (:648-655), and relocalization runs alongside the VO
    motion model, its solution preferred (:568-624).  Never a keyframe.
    The JAX package's lax.cond over local-map tracking is a select over
    both results here, so nothing is read back to the host and a CUDA graph
    captures it (models/step_graph.py)."""
    res = _motion_hypotheses(tracking.track_motion_loc, config, m, carry, frame)
    ok_mm = res.n_inliers > 20           # loc-mode motion-model return (:1427)
    vo_now = res.n_map_inliers < 10      # mbVO update (:1425-1426)
    local = ok_mm & ~vo_now              # local-map tracking runs (:648-655)
    lres_map = tracking.track_local_map(config, m, frame, res.Tcw, res.obs_pt)
    lres = select(local, lres_map, _echo_local_map(config, m, res))
    ok = torch.where(local, lres_map.n_inliers >= config.tracking.min_inliers_local, ok_mm)
    dev = frame.xy.device
    need_kf = torch.zeros((), dtype=torch.bool, device=dev)
    carry_out, info = _advance(m, carry, frame, lres, ok, need_kf, vo_now)
    return StepCore(carry_out, info, lres, ok, need_kf, ~ok | carry.vo | ~carry.state_ok,
                    vo_now, torch.zeros((), dtype=torch.bool, device=dev))


def relocalize_branch(config: SlamConfig, m: MapState, carry: TrackCarry,
                      frame: FrameData, core: StepCore,
                      generator: torch.Generator | None,
                      localization_only: bool = False) -> StepCore:
    """The LOST branch (reference Tracking falls back to Relocalization()
    whenever LOST, src/Tracking.cc:523-629, :2030): relocalize the frame
    against the map, drawing from `generator`, and redo the keyframe
    decision and the carry from the recovered pose.  `carry` is the carry
    the step started from.  Like step_core it reads nothing back to the
    host; it counts no relocalization (relocalization.record: the callers)."""
    r = relocalization.relocalize_uncounted(config, m, frame, generator)
    relocated = r.success
    ok = core.ok | relocated
    lres = core.lres._replace(
        Tcw=torch.where(relocated, r.Tcw, core.lres.Tcw),
        obs_pt=torch.where(relocated, r.obs_pt, core.lres.obs_pt),
        n_inliers=torch.where(relocated, r.n_inliers, core.lres.n_inliers))
    need_kf = _need_keyframe(config, m, carry, frame, lres, localization_only) & ok
    carry_out, info = _advance(m, carry, frame, lres, ok, need_kf, core.vo_now, relocated)
    return StepCore(carry_out, info, lres, ok, need_kf, core.want_reloc, core.vo_now, relocated)


def keyframe_tail(config: SlamConfig, m: MapState, carry: TrackCarry, frame: FrameData,
                  obs_pt: torch.Tensor, frame_id: torch.Tensor, timestamp,
                  run_mapping: bool, info: StepInfo):
    """Keyframe insertion at the step's pose (carry.Tcw, the carry a branch
    left) with the frame's matches obs_pt, then, with run_mapping, the
    local-mapping pass; the carry and StepInfo after them.  frame_id is the
    frame's own id (the carry's before the step).  Like step_core it reads
    nothing back to the host."""
    m, kf_id = tracking.create_keyframe(config, m, frame, carry.Tcw, obs_pt, frame_id,
                                        timestamp)
    if run_mapping:
        m = _mapping_pass(config, m, kf_id)
    obs_after = row(m.kf_obs_pt, kf_id)
    carry = carry._replace(last_obs_pt=obs_after, last_obs_birth=_birth(m, obs_after))
    return m, carry, _info(m, carry.Tcw, info.n_inliers, info.created_kf, info.state_ok,
                           info.vo)


def track_step(config: SlamConfig, m: MapState, carry: TrackCarry,
               frame: FrameData, timestamp, run_mapping: bool = True, *,
               localization_only: bool = False,
               generator: torch.Generator | None = None):
    """One tracking step (frame already built) -> (map, carry, StepInfo):
    step_core (or the localization-mode tracking), one host read of its
    flags, then the LOST branch (with a vocabulary) and keyframe_tail as
    they ask.  Updates the map in place when a keyframe is inserted; with
    run_mapping the local-mapping pass follows the insertion."""
    core = (_localization_core if localization_only else step_core)(config, m, carry, frame)
    # the host read: both flags in one transfer; the LOST branch runs only
    # with a vocabulary
    if config.vocab is None:
        want, make_kf = False, bool(core.need_kf)
    else:
        want, make_kf = torch.stack([core.want_reloc, core.need_kf]).tolist()
    if want:
        core = relocalize_branch(config, m, carry, frame, core, generator, localization_only)
        relocalization.record(core.relocated)
        make_kf = bool(core.need_kf)
    if not make_kf:
        return m, core.carry, core.info
    return keyframe_tail(config, m, core.carry, frame, core.lres.obs_pt, carry.frame_id,
                         timestamp, run_mapping, core.info)


def _info(m: MapState, Tcw, n_inliers, created_kf, state_ok, vo) -> StepInfo:
    ref_kf = ms.latest_kf(m)
    return StepInfo(
        Tcw=Tcw,
        n_inliers=n_inliers,
        created_kf=created_kf,
        state_ok=state_ok,
        n_keyframes=m.n_kf,
        n_points=torch.sum(m.pt_valid).to(torch.int32),
        ref_kf=ref_kf,
        ref_kf_Tcw=row(m.kf_Tcw, ref_kf),
        ref_kf_seq=row(m.kf_seq, ref_kf),
        vo=vo,
    )


def _skip_info(m: MapState, carry: TrackCarry) -> StepInfo:
    """StepInfo for a padded (invalid) frame: carry state echoed, no KF."""
    return _info(m, carry.Tcw, torch.zeros_like(carry.prev_inliers),
                 torch.zeros_like(carry.state_ok), carry.state_ok, carry.vo)


def pack_infos(infos: list[StepInfo]) -> torch.Tensor:
    """Stack per-frame StepInfos into ONE [B, 40] float32 tensor (one
    device->host copy per chunk); layout of the JAX package's pack_infos."""
    def col(x):
        return x.reshape(-1).to(torch.float32)

    rows = [torch.cat([col(i.Tcw), col(i.ref_kf_Tcw), col(i.n_inliers),
                       col(i.created_kf), col(i.state_ok), col(i.n_keyframes),
                       col(i.n_points), col(i.ref_kf), col(i.ref_kf_seq),
                       col(i.vo)]) for i in infos]
    return torch.stack(rows)


def unpack_infos(arr: np.ndarray) -> StepInfo:
    """Host-side inverse of pack_infos (numpy in, numpy out)."""
    B = arr.shape[0]
    return StepInfo(
        Tcw=arr[:, 0:16].reshape(B, 4, 4),
        n_inliers=arr[:, 32].astype(np.int32),
        created_kf=arr[:, 33] > 0.5,
        state_ok=arr[:, 34] > 0.5,
        n_keyframes=arr[:, 35].astype(np.int32),
        n_points=arr[:, 36].astype(np.int32),
        ref_kf=arr[:, 37].astype(np.int32),
        ref_kf_Tcw=arr[:, 16:32].reshape(B, 4, 4),
        ref_kf_seq=arr[:, 38].astype(np.int32),
        vo=arr[:, 39] > 0.5,
    )


def _pack(planes: list, ts_f32, valid_b) -> np.ndarray:
    """[B, bytes] uint8: the byte planes, then [4 ts f32][4 valid u8]."""
    B = planes[0].shape[0]
    return np.concatenate(
        [p.reshape(B, -1) for p in planes]
        + [np.asarray(ts_f32, "<f4").view(np.uint8).reshape(B, 4),
           np.repeat(valid_b.astype(np.uint8)[:, None], 4, axis=1)], axis=1)


def _unpack_tail(buf: torch.Tensor, offset: int):
    """(ts [B] float32, valid [B] bool) stored at `offset` of a packed chunk."""
    ts = buf[:, offset: offset + 4].contiguous().view(torch.float32)[:, 0]
    return ts, buf[:, offset + 4] > 0


def pack_rgbd_chunk(images_u8, depths_mm_u16, ts_f32, valid_b) -> np.ndarray:
    """Host-side packer: per frame [H*W image u8][H*W*2 depth u16 LE]
    [4 ts f32][4 valid u8] (the JAX package's layout)."""
    return _pack([images_u8, depths_mm_u16.astype("<u2").view(np.uint8)], ts_f32, valid_b)


def frames_rgbd_packed(config: SlamConfig, buf: torch.Tensor):
    """Packed uint8 chunk [B, bytes] on the device -> (FrameData [B, ...],
    ts [B] float32, valid [B] bool).  The little-endian uint16 depth is
    rebuilt from its two bytes in int32."""
    cam = config.camera
    H, W = int(cam.height), int(cam.width)
    B = buf.shape[0]
    images = buf[:, : H * W].reshape(B, H, W).to(torch.float32)
    d = buf[:, H * W: 3 * H * W].reshape(B, H, W, 2).to(torch.int32)
    depth_mm = d[..., 0] | (d[..., 1] << 8)
    ts, valid = _unpack_tail(buf, 3 * H * W)
    frames = frame_mod.make_frames_rgbd_batch(
        config, images, depth_mm.to(torch.float32) * constant(1e-3, torch.float32, buf.device))
    return frames, ts, valid


def pack_stereo_chunk(il_u8, ir_u8, ts_f32, valid_b) -> np.ndarray:
    """Host-side packer: per frame [H*W left u8][H*W right u8][4 ts f32]
    [4 valid u8] (the JAX package's layout)."""
    return _pack([il_u8, ir_u8], ts_f32, valid_b)


def frames_stereo_packed(config: SlamConfig, buf: torch.Tensor):
    """Stereo variant of frames_rgbd_packed (layout of pack_stereo_chunk)."""
    H, W = int(config.camera.height), int(config.camera.width)
    B = buf.shape[0]
    il = buf[:, : H * W].reshape(B, H, W).to(torch.float32)
    ir = buf[:, H * W: 2 * H * W].reshape(B, H, W).to(torch.float32)
    ts, valid = _unpack_tail(buf, 2 * H * W)
    return frame_mod.make_frames_stereo_batch(config, il, ir), ts, valid


def pack_mono_chunk(images_u8, ts_f32, valid_b) -> np.ndarray:
    """Host-side packer: per frame [H*W image u8][4 ts f32][4 valid u8]."""
    return _pack([images_u8], ts_f32, valid_b)


def frames_mono_packed(config: SlamConfig, buf: torch.Tensor):
    """Mono variant of frames_rgbd_packed (layout of pack_mono_chunk)."""
    H, W = int(config.camera.height), int(config.camera.width)
    B = buf.shape[0]
    images = buf[:, : H * W].reshape(B, H, W).to(torch.float32)
    ts, valid = _unpack_tail(buf, H * W)
    return frame_mod.make_frames_mono_batch(config, images), ts, valid


# (device, frame capacity) -> Philox offset one LOST branch advances a CUDA
# generator by
_draw_spans: dict = {}


def lost_draw_span(config: SlamConfig, m: MapState, frame: FrameData) -> int:
    """The Philox offset that the LOST branch's RANSAC draws advance a CUDA
    generator by, measured once per device and frame capacity: one
    relocalization of `frame` against m on a scratch generator."""
    key = (frame.xy.device, frame.capacity)
    if key not in _draw_spans:
        g = torch.Generator(device=frame.xy.device).manual_seed(0)
        offset = g.get_offset()
        relocalization.relocalize_uncounted(config, m, frame, g)
        _draw_spans[key] = g.get_offset() - offset
    return _draw_spans[key]


def batch_steps_frames(config: SlamConfig, m: MapState, carry: TrackCarry,
                       frames: FrameData, timestamps: torch.Tensor,
                       valid: torch.Tensor, run_mapping: bool = True, *,
                       localization_only: bool = False,
                       generator: torch.Generator | None = None):
    """Tracking steps over pre-built frames (leading dim B), in order.
    Padded (invalid) frames pass the state through.  Returns (map, carry,
    packed StepInfo [B, 40]).

    With a vocabulary and a CUDA generator, every slot, live or padded,
    lost or not, takes its own span of the generator's Philox offset (slot b
    draws at the chunk's starting offset + b * lost_draw_span, and the chunk
    ends at + B * lost_draw_span), as a replay of the chunk graph does
    (models/step_graph.py), and as the JAX package splits its key at every
    step.  A CPU generator (no offset) draws only where a branch runs."""
    live_slots = valid.tolist()
    span = None
    if (config.vocab is not None and generator is not None
            and generator.device.type == "cuda"):
        span = lost_draw_span(config, m, frames.select(0))
        base = generator.get_offset()
    infos = []
    for b, live in enumerate(live_slots):
        if span is not None:
            generator.set_offset(base + b * span)
        if live:
            m, carry, info = track_step(config, m, carry, frames.select(b),
                                        timestamps[b], run_mapping,
                                        localization_only=localization_only,
                                        generator=generator)
        else:
            info = _skip_info(m, carry)
        infos.append(info)
    if span is not None:
        generator.set_offset(base + len(live_slots) * span)
    return m, carry, pack_infos(infos)


def batch_steps_rgbd_packed(config: SlamConfig, m: MapState, carry: TrackCarry,
                            buf: torch.Tensor, run_mapping: bool = True, **kw):
    """A packed RGB-D chunk through the frame phase and the tracking steps
    (the JAX package keeps a single-graph variant under this name; eager
    torch has no second form to keep apart)."""
    frames, ts, valid = frames_rgbd_packed(config, buf)
    return batch_steps_frames(config, m, carry, frames, ts, valid, run_mapping, **kw)


def batch_steps_stereo_packed(config: SlamConfig, m: MapState, carry: TrackCarry,
                              buf: torch.Tensor, run_mapping: bool = True, **kw):
    """Stereo variant of batch_steps_rgbd_packed."""
    frames, ts, valid = frames_stereo_packed(config, buf)
    return batch_steps_frames(config, m, carry, frames, ts, valid, run_mapping, **kw)


def _depth_metres(depth: torch.Tensor) -> torch.Tensor:
    """Depth as float32 metres: uint16 input is millimetres (the JAX
    package's step_rgbd casts on the device alike)."""
    if depth.is_floating_point():
        return depth.to(torch.float32)
    return depth.to(torch.int32).to(torch.float32) * constant(1e-3, torch.float32,
                                                              depth.device)


def step_rgbd(config: SlamConfig, m: MapState, carry: TrackCarry,
              image: torch.Tensor, depth: torch.Tensor, timestamp,
              run_mapping: bool = True, **kw):
    """One RGB-D frame built and tracked: image [H, W] (uint8 or float,
    0..255), depth [H, W] in metres, or uint16 millimetres; keywords as
    track_step's."""
    frame = frame_mod.make_frame_rgbd(config, image.to(torch.float32), _depth_metres(depth))
    return track_step(config, m, carry, frame, timestamp, run_mapping, **kw)


def batch_steps_rgbd(config: SlamConfig, m: MapState, carry: TrackCarry,
                     images: torch.Tensor, depths: torch.Tensor,
                     timestamps: torch.Tensor, valid: torch.Tensor,
                     run_mapping: bool = True, **kw):
    """A chunk of unpacked RGB-D frames ([B, H, W] images and depths as in
    step_rgbd, [B] timestamps and valid flags) -> (map, carry, packed
    StepInfo [B, 40]).  The JAX package builds each frame inside its scan;
    here the chunk goes through one extraction chain, as the packed path
    does, and the same tracking steps follow."""
    frames = frame_mod.make_frames_rgbd_batch(config, images.to(torch.float32),
                                              _depth_metres(depths))
    return batch_steps_frames(config, m, carry, frames, timestamps, valid, run_mapping, **kw)


def batch_steps_stereo(config: SlamConfig, m: MapState, carry: TrackCarry,
                       images_l: torch.Tensor, images_r: torch.Tensor,
                       timestamps: torch.Tensor, valid: torch.Tensor,
                       run_mapping: bool = True, **kw):
    """Stereo variant of batch_steps_rgbd ([B, H, W] per eye)."""
    frames = frame_mod.make_frames_stereo_batch(config, images_l.to(torch.float32),
                                                images_r.to(torch.float32))
    return batch_steps_frames(config, m, carry, frames, timestamps, valid, run_mapping, **kw)


def step_stereo(config: SlamConfig, m: MapState, carry: TrackCarry,
                image_l: torch.Tensor, image_r: torch.Tensor, timestamp,
                run_mapping: bool = True, **kw):
    """One stereo frame built and tracked; keywords as track_step's."""
    frame = frame_mod.make_frame_stereo(config, image_l.to(torch.float32),
                                        image_r.to(torch.float32))
    return track_step(config, m, carry, frame, timestamp, run_mapping, **kw)


def step_mono(config: SlamConfig, m: MapState, carry: TrackCarry,
              image: torch.Tensor, timestamp, run_mapping: bool = True, **kw):
    """One monocular frame built and tracked; keywords as track_step's."""
    frame = frame_mod.make_frame_mono(config, image.to(torch.float32))
    return track_step(config, m, carry, frame, timestamp, run_mapping, **kw)


def init_rgbd(config: SlamConfig, m: MapState, image: torch.Tensor,
              depth: torch.Tensor, timestamp):
    """First-frame initialization -> (map, carry, number of depth features)."""
    return _init_depth(config, m, frame_mod.make_frame_rgbd(config, image, depth),
                       timestamp)


def init_stereo(config: SlamConfig, m: MapState, image_l: torch.Tensor,
                image_r: torch.Tensor, timestamp):
    """First stereo pair -> (map, carry, number of matched features)."""
    return _init_depth(config, m, frame_mod.make_frame_stereo(config, image_l, image_r),
                       timestamp)


def _init_depth(config: SlamConfig, m: MapState, frame: FrameData, timestamp):
    dev = frame.xy.device
    m, kf_id = tracking.initialize_depth(config, m, frame,
                                         _scalar(0, torch.int32, dev), timestamp)
    obs0 = row(m.kf_obs_pt, kf_id)
    n_depth = torch.sum(frame.has_depth()).to(torch.int32)
    carry = init_carry(config, frame)._replace(
        last_obs_pt=obs0,
        last_obs_birth=torch.where(
            obs0 >= 0, m.pt_birth[torch.clamp(obs0, 0, m.max_pt - 1).long()], 0),
        frame_id=_scalar(1, torch.int32, dev),
        prev_inliers=n_depth,
    )
    return m, carry, n_depth
