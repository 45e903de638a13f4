"""Per-frame SLAM step and the chunked stream, for the three sensors.

Counterpart of the JAX package's models/pipeline.py: a chunk of frames is
built through one batched extraction chain (frames_rgbd_packed,
frames_stereo_packed or frames_mono_packed), then the
tracking steps run in order over it (batch_steps_frames -> track_step):
dual-hypothesis motion tracking, local-map tracking, the keyframe decision,
keyframe insertion and, with run_mapping, the local-mapping pass.  The JAX
package compiles each step into one XLA program with lax.cond branches; here
the step runs eagerly and each branch is a host `if` on a 0-d tensor.

Host syncs per frame: one.  The keyframe flag and, with a vocabulary, the
"wants relocalization" flag are read in one transfer.  A frame that
relocalizes pays a second one (the keyframe decision after the recovered
pose) beside the one inside relocalize(); a localization-mode frame pays one
more to decide whether local-map tracking runs.

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
    return torch.tensor(value, dtype=dtype, device=device)


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
        key=torch.tensor([0, 23], dtype=torch.int64, device=dev),  # PRNGKey(23)
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


def _mapping_pass(config: SlamConfig, m: MapState, kf_id: torch.Tensor) -> MapState:
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
        ref_shared=_scalar(0, torch.int32, dev),
        ref_total=_scalar(1, torch.int32, dev),
    )


def track_step(config: SlamConfig, m: MapState, carry: TrackCarry,
               frame: FrameData, timestamp, run_mapping: bool = True, *,
               localization_only: bool = False,
               generator: torch.Generator | None = None):
    """One tracking step (frame already built) -> (map, carry, StepInfo).
    Updates the map in place when a keyframe is inserted; with run_mapping
    the local-mapping pass follows the insertion.  With a vocabulary a frame
    that lost tracking relocalizes, drawing from `generator`."""
    cfg = config.tracking
    dev = frame.xy.device
    false = torch.zeros((), dtype=torch.bool, device=dev)

    if localization_only:
        # Localization mode (reference Tracking.cc:523-656): motion tracking
        # is augmented with temporal visual-odometry points from the last
        # frame's depth (UpdateLastFrame, :1247-1350); carry.vo is the
        # reference's mbVO "map support lost" flag; local-map tracking is
        # skipped while map support is lost (:648-655), and relocalization
        # runs alongside the VO motion model, its solution preferred
        # (:568-624).
        res = _motion_hypotheses(tracking.track_motion_loc, config, m, carry, frame)
        ok_mm = res.n_inliers > 20           # loc-mode motion-model return (:1427)
        vo_now = res.n_map_inliers < 10      # mbVO update (:1425-1426)
        if bool(ok_mm & ~vo_now):            # host branch (lax.cond in JAX)
            lres = tracking.track_local_map(config, m, frame, res.Tcw, res.obs_pt)
            ok = lres.n_inliers >= cfg.min_inliers_local
        else:
            lres = _echo_local_map(config, m, res)
            ok = ok_mm
        want_reloc = ~ok | carry.vo | ~carry.state_ok
    else:
        res = _motion_hypotheses(tracking.track_motion, config, m, carry, frame)
        vo_now = false
        lres = tracking.track_local_map(config, m, frame, res.Tcw, res.obs_pt)
        ok = lres.n_inliers >= cfg.min_inliers_local
        want_reloc = ~ok

    # The keyframe decision, and relocalization on the LOST branch (reference
    # Tracking falls back to Relocalization() whenever LOST,
    # src/Tracking.cc:523-629, :2030), so a stream recovers mid-chunk instead
    # of dead-reckoning to its end.  Both host branches read their flags in
    # one transfer; relocalization runs only on frames that want it.
    need_kf = _need_keyframe(config, m, carry, frame, lres, localization_only) & ok
    relocated = false
    if config.vocab is None:
        make_kf = bool(need_kf)
    else:
        want, make_kf = torch.stack([want_reloc, need_kf]).tolist()
        if want:
            r = relocalization.relocalize(config, m, frame, generator)
            relocated = r.success
            ok = ok | relocated
            lres = lres._replace(
                Tcw=torch.where(relocated, r.Tcw, lres.Tcw),
                obs_pt=torch.where(relocated, r.obs_pt, lres.obs_pt),
                n_inliers=torch.where(relocated, r.n_inliers, lres.n_inliers))
            need_kf = _need_keyframe(config, m, carry, frame, lres, localization_only) & ok
            make_kf = bool(need_kf)

    new_Tcw = torch.where(ok, lres.Tcw, carry.velocity @ carry.Tcw)  # dead-reckon if lost
    new_velocity = torch.where(
        relocated, torch.eye(4, dtype=torch.float32, device=dev),
        torch.where(ok, new_Tcw @ se3.inverse(carry.Tcw), carry.velocity))
    obs_pt = torch.where(ok, lres.obs_pt, NO_POINT)

    if make_kf:
        m, kf_id = tracking.create_keyframe(config, m, frame, new_Tcw, lres.obs_pt,
                                            carry.frame_id, timestamp)
        if run_mapping:
            m = _mapping_pass(config, m, kf_id)
        obs_after = row(m.kf_obs_pt, kf_id)
    else:
        obs_after = obs_pt

    birth_after = torch.where(
        obs_after >= 0,
        m.pt_birth[torch.clamp(obs_after, 0, m.max_pt - 1).long()], 0)
    carry_out = TrackCarry(
        Tcw=new_Tcw,
        velocity=new_velocity,
        last_frame=frame,
        last_obs_pt=obs_after,
        last_obs_birth=birth_after,
        frame_id=carry.frame_id + 1,
        last_kf_frame_id=torch.where(need_kf, carry.frame_id, carry.last_kf_frame_id),
        prev_inliers=torch.where(ok, lres.n_inliers, carry.prev_inliers),
        state_ok=ok,
        key=carry.key,
        # mbVO clears on relocalization success (reference Tracking.cc:623)
        vo=vo_now & ~relocated,
    )
    return m, carry_out, _info(m, new_Tcw, lres.n_inliers, need_kf, ok, carry_out.vo)


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
        config, images, depth_mm.to(torch.float32) * torch.tensor(
            1e-3, dtype=torch.float32, device=buf.device))
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


def batch_steps_frames(config: SlamConfig, m: MapState, carry: TrackCarry,
                       frames: FrameData, timestamps: torch.Tensor,
                       valid: torch.Tensor, run_mapping: bool = True, *,
                       localization_only: bool = False,
                       generator: torch.Generator | None = None):
    """Tracking steps over pre-built frames (leading dim B), in order.
    Padded (invalid) frames pass the state through.  Returns (map, carry,
    packed StepInfo [B, 40])."""
    infos = []
    for b, live in enumerate(valid.tolist()):
        if live:
            m, carry, info = track_step(config, m, carry, frames.select(b),
                                        timestamps[b], run_mapping,
                                        localization_only=localization_only,
                                        generator=generator)
        else:
            info = _skip_info(m, carry)
        infos.append(info)
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
