"""Whether what the timed path produced is correct: the program's outputs
of the run held to the plain reference (slambench/reference), number by
number against the cell's limits (limits/<cell>.json).

Numbers (each the worst over what the run produced):
- rpe_t_mm, rpe_r_deg: frame-to-frame motion of every pose the calls
  returned against the true motion (translation mm, rotation degrees);
- ate_mm, ate_r_deg: every returned pose against the true pose in the
  first camera's frame;
- kf_t_mm, kf_r_deg: every live keyframe's pose against the true pose of
  its frame;
- pt_p50_mm, pt_p90_mm: the live map points' distances to the room's
  surfaces, median and 90th percentile;
- feat_diff: feature rows of the last frame that differ from the frozen
  extractor run on the same images in the same batch shape.

A monocular map has the bootstrap's scale and frame, not metres in the
first camera's: where the configuration's sensor is "mono", one similarity
(Umeyama, reference/truth.align_sim3) fitted from every returned camera
centre to the true one is applied to every returned pose, live keyframe
and map point before the pose and point numbers are taken, as ORB-SLAM's
monocular evaluation aligns a trajectory in 7 degrees of freedom; its scale
is reported, uncompared, as mono_scale.  Where no similarity can be fitted
(fewer than 3 finite poses, or their centres collinear) mono_scale and
every pose and point number are NaN, and the run is not correct.  Other
sensors are compared as they are.
"""

from __future__ import annotations

import numpy as np

from ..reference import features, truth

DEVICE_NUMBERS = ("feat_diff",)
# the numbers a monocular run without an alignment cannot give
ALIGNED_NUMBERS = ("rpe_t_mm", "rpe_r_deg", "ate_mm", "ate_r_deg", "kf_t_mm", "kf_r_deg",
                   "pt_p50_mm", "pt_p90_mm")


def _worst(x: np.ndarray) -> float:
    return float(np.max(x)) if len(x) else 0.0


def numbers(run, device) -> dict:
    ctx, out = run.context, run.outputs
    cycle, s = ctx["cycle"], ctx["settings"]
    fps = float(s.get("Camera.fps", 30.0))
    first = cycle.poses[cycle.start]
    gt = truth.in_first_frame(cycle.poses[cycle.index(out["frame_numbers"])], first)
    est, kf_Tcw, pts = out["poses"], out["kf_Tcw"], out["points"]
    finite = np.isfinite(est).all(axis=(1, 2))
    mono = ctx["sensor"] == "mono"
    if mono:
        sim = mono_alignment(est[finite], gt[finite])
        if sim is not None:
            est, kf_Tcw = truth.sim3_poses(est, *sim), truth.sim3_poses(kf_Tcw, *sim)
            pts = truth.sim3_points(pts, *sim)
    est = np.where(finite[:, None, None], est, 1e9)
    rt, rr = truth.relative_errors(est, gt)
    at, ar = truth.pose_errors(est, gt)
    kf_k = np.rint(out["kf_timestamp"] * fps).astype(np.int64)
    kt, kr = truth.pose_errors(kf_Tcw,
                               truth.in_first_frame(cycle.poses[cycle.index(kf_k)], first))
    Twc0 = truth.inv_se3(first)
    d = truth.surface_distance(pts @ Twc0[:3, :3].T + Twc0[:3, 3], cycle.scene)
    if out["last_features"] is None:   # no frame was tracked
        diff = np.nan
    else:
        ref = features.extract(out["last_batch"], s, device)
        i = out["last_index"]
        diff = features.differing_rows(out["last_features"],
                                       {f: v[i] for f, v in ref.items()})
    values = dict(rpe_t_mm=_worst(rt) * 1e3, rpe_r_deg=_worst(rr), ate_mm=_worst(at) * 1e3,
                  ate_r_deg=_worst(ar), kf_t_mm=_worst(kt) * 1e3, kf_r_deg=_worst(kr),
                  pt_p50_mm=float(np.median(d)) * 1e3 if len(d) else 0.0,
                  pt_p90_mm=float(np.percentile(d, 90)) * 1e3 if len(d) else 0.0,
                  feat_diff=float(diff), n_poses=float(len(est)), n_keyframes=float(len(kt)),
                  n_points=float(len(d)), keyframes_inserted=float(out["keyframes_inserted"]),
                  closures=float(out["closures"]))
    return _with_scale(values, sim) if mono else values


def _with_scale(values: dict, sim) -> dict:
    """A monocular run's numbers with its fitted scale, mono_scale; without
    a similarity, that and every aligned number NaN."""
    values["mono_scale"] = sim[0] if sim is not None else np.nan
    if sim is None:
        values.update(dict.fromkeys(ALIGNED_NUMBERS, np.nan))
    return values


def mono_alignment(est: np.ndarray, gt: np.ndarray):
    """(s, R, t) taking the camera centres of poses est [n, 4, 4] onto those
    of gt, or None where there is no one similarity (truth.align_sim3)."""
    try:
        return truth.align_sim3(truth.inv_se3(est)[:, :3, 3], truth.inv_se3(gt)[:, :3, 3])
    except ValueError:
        return None


def aligned(values: dict) -> bool:
    """False for a monocular run whose trajectory could not be aligned."""
    return bool(np.isfinite(values.get("mono_scale", 0.0)))


def control_numbers(cycle, s: dict, device, batch_frames: int, sensor: str,
                    kind: str = "late") -> dict:
    """The same numbers with the reference put in the program's place, with
    one guarantee broken.  The settings state no precision; they state a
    camera rate, every frame's outputs being that frame's.  kind "late"
    (the control): every pose, keyframe and feature set one frame late, as
    a tracker pipelined a frame deep would return them.  kind "bf16" (a
    second witness): poses, points and the extractor's stages stored in
    bfloat16.  Poses: every pair of consecutive frames of one cycle (all a
    window replays; the pair across the cycle's seam repeats the first).
    Points: under the features of the last frame of the batch that ends
    where the seed's start frame begins, at the rendered depth.  Features:
    of that batch.  A monocular cycle's poses and points are brought onto the
    truth by the similarity fitted from its poses, as numbers() does."""
    import torch

    F = len(cycle.left)
    stereo = sensor == "stereo"
    first = cycle.poses[cycle.start]
    k = np.arange(1, F)
    gt = truth.in_first_frame(cycle.poses[k], first)

    def batch_of(c):
        return np.concatenate([cycle.left[c], cycle.right[c]]) if stereo else cycle.left[c]

    c = cycle.index(np.arange(-batch_frames, 0))   # the batch before the start
    ref = features.extract(batch_of(c), s, device)
    i = batch_frames - 1
    if kind == "late":
        est = truth.in_first_frame(cycle.poses[k - 1], first)
        ctl, low = features.extract(batch_of((c - 1) % F), s, device), (lambda x: x)
    elif kind == "bf16":
        def low(x):
            return torch.as_tensor(x).to(torch.bfloat16).to(torch.float64).numpy()

        est = low(gt)
        ctl = features.extract(batch_of(c), s, device, storage=torch.bfloat16)
    else:
        raise ValueError(kind)
    sim = mono_alignment(est, gt) if sensor == "mono" else None
    if sim is not None:
        est = truth.sim3_poses(est, *sim)
    rt, rr = truth.relative_errors(est, gt)
    at, ar = truth.pose_errors(est, gt)
    diff = features.differing_rows({f: v[i] for f, v in ctl.items()},
                                   {f: v[i] for f, v in ref.items()})
    from ..scene import cast
    W, H = cycle.left.shape[2], cycle.left.shape[1]
    frame = c[-1] if kind != "late" else (c[-1] - 1) % F
    _, depth = cast.DeviceScene(cycle.scene, device).render(cycle.K, cycle.poses[frame], W, H)
    depth = depth.cpu().numpy().astype(np.float64)
    fx = ctl["xy"][i][ctl["valid"][i]]
    xy = np.stack([np.clip(np.rint(fx[:, 0]), 0, W - 1),
                   np.clip(np.rint(fx[:, 1]), 0, H - 1)], -1).astype(np.int64)
    z = depth[xy[:, 1], xy[:, 0]]
    keep = z > 0
    pts_w = truth.backproject(cycle.K, xy[keep].astype(np.float64), z[keep], cycle.poses[frame])
    T0 = np.asarray(first, np.float64)
    pts_first = low(pts_w @ T0[:3, :3].T + T0[:3, 3])
    if sim is not None:
        pts_first = truth.sim3_points(pts_first, *sim)
    Twc0 = truth.inv_se3(first)
    d = truth.surface_distance(pts_first @ Twc0[:3, :3].T + Twc0[:3, 3], cycle.scene)
    values = dict(rpe_t_mm=_worst(rt) * 1e3, rpe_r_deg=_worst(rr), ate_mm=_worst(at) * 1e3,
                  ate_r_deg=_worst(ar), kf_t_mm=_worst(at) * 1e3, kf_r_deg=_worst(ar),
                  pt_p50_mm=float(np.median(d)) * 1e3,
                  pt_p90_mm=float(np.percentile(d, 90)) * 1e3,
                  feat_diff=float(diff), lost_frames=0.0)
    return _with_scale(values, sim) if sensor == "mono" else values


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}) over the numbers with limits."""
    checks = {n: {"value": values[n], "limit": float(lim)} for n, lim in limits.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
