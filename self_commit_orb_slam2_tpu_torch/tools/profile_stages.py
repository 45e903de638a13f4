"""Each stage of the tracking step and of the mapping pass, timed alone.

    python -m self_commit_orb_slam2_tpu_torch.tools.profile_stages [--mapping]
        [--device cpu]
    PW=640 PH=480 PF=1000 python -m self_commit_orb_slam2_tpu_torch.tools.profile_stages

Counterpart of the JAX repository's scripts/profile_stages.py, on the same
state: a System (RGB-D, capacities 64 / 16384 / 1024,
max_frames_between_kf 10) over the first 8 frames of
generate_sequence(seed=5) at PW x PH (default 320 x 240) with PF features
(default 500), fx = 260 * PW / 320.  The frames are rendered at that fx
(the JAX script renders them at generate_sequence's default of 260, so its
frames and its camera part at any other width).  The stages, in the JAX
script's order, with four of the port's step beside them (ADDED):

  main       make_frame_rgbd of frame 0, track_motion (radius 7) from the
             System's carry, pose_optimize on the arguments track_motion
             hands it, pipeline._motion_hypotheses, track_local_map,
             pipeline.step_core, create_keyframe, pipeline.keyframe_tail
             with the mapping pass, local_mapping._process on
             create_keyframe's map, and the whole step_rgbd;
  --mapping  the six stages of the mapping pass on the newest keyframe of
             the System's map, then three forms of the sum at the pass's
             two scatter-add sites (refresh_observed_points' mean normals,
             the local BA's grouping), on the arguments the pass hands
             index_add_fixed: index_add_fixed itself (its inactive rows
             dropped), the sink form it replaced (the same fixed-order sum
             with every inactive row on one sink row, in the BA one sink
             column a keyframe, sliced off after) and plain index_add_ on
             the kept rows alone (no fixed order; it raises on a dropped
             index).

On the card each stage is timed two ways on one copy of its inputs each:
op by op (a warm call, then n calls ending in cuda.synchronize, as the
JAX script's timeit), and replayed from its own CUDA graph, captured once
through models/program_graphs.Program (the machinery the System runs on).
Each way prints host ms and device ms a call (CUDA events around the n
calls), device kernels, device busy ms and host syncs a call (torch.profiler
over one more call, utils/profiling.trace_counts).  A replay's outputs
must equal the op-by-op outputs bitwise (a sum with no fixed order,
index_add_, is reported, not held).  step_rgbd's host branch (the keyframe
flag read) becomes a conditional node (program_graphs.cond) in its graph,
as in the System's chunk graph.  A stage that writes into its inputs
(create_keyframe, keyframe_tail, _process, create_new_points, step_rgbd) has
the inputs it wrote copied back before every call, both ways; the copies
are timed alone and their numbers taken off the stage's.  No stage draws
random numbers on this state (no vocabulary), so none has a generator.

On the CPU (--device cpu) each stage runs once op by op, and step_rgbd
once more through its Program's plain version (bitwise against
pipeline.step_rgbd); only host ms is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from ..models import frame as frame_mod
from ..models import local_mapping, pipeline, program_graphs, tracking
from ..models.program_graphs import _clone, _copy_into
from ..models.config import Capacities, SlamConfig, TrackingConfig
from ..models.frame import FrameData
from ..models.map_state import MapState
from ..models.pipeline import TrackCarry
from ..models.system import System, resolve_device
from ..ops.camera import CameraParams
from ..ops.indexing import index_add_fixed, ordered_index_add_
from ..ops.optim import bundle_adjust
from ..ops.orb.extractor import OrbConfig
from ..utils.profiling import card_line, trace_counts
from ..utils.synthetic import generate_sequence

# the JAX script's stages, by its labels and in its order
JAX_MAIN = ("make_frame_rgbd", "track_motion", "track_local_map", "create_keyframe",
            "local_mapping._process", "full step_rgbd (no scan)")
JAX_MAPPING = ("cull_points", "create_new_points", "fuse_into_keyframe",
               "refresh_observed_points", "local_bundle_adjustment", "cull_keyframes")
# the port's step functions timed beside them
ADDED = ("pose_optimize", "_motion_hypotheses", "step_core", "keyframe_tail")
MAIN = ("make_frame_rgbd", "track_motion", "pose_optimize", "_motion_hypotheses",
        "track_local_map", "step_core", "create_keyframe", "keyframe_tail",
        "local_mapping._process", "full step_rgbd (no scan)")
# the mapping pass's two scatter-add sites: (label, module holding the call)
SCATTER_SITES = (("refresh_observed_points", local_mapping),
                 ("bundle_adjust", bundle_adjust))
# the sums timed at each site: the pass's, the sink form it replaced, plain
SCATTER_FORMS = ("index_add_fixed", "sink form", "index_add_")
MAPPING = JAX_MAPPING + tuple(f"{form} ({site})" for site, _ in SCATTER_SITES
                              for form in SCATTER_FORMS)
SEARCH_RADIUS = 7.0   # the JAX script's track_motion radius


class State(NamedTuple):
    """The JAX script's state: the configuration (on the device), the
    frames, and the map and carry a System leaves after 8 of them."""

    config: SlamConfig
    seq: object
    map: MapState
    carry: TrackCarry
    device: torch.device


class Stage(NamedTuple):
    name: str
    fn: Callable            # fn(*statics) -> outputs
    statics: tuple          # its inputs (tensors and NamedTuples of tensors)
    n: int                  # calls timed
    conditional: bool = False   # branches on the device (program_graphs.cond)
    exact: bool = True      # a replay must equal op by op bitwise
    op_fn: Callable | None = None   # op by op, where not fn


def config(width: int, height: int, n_features: int) -> SlamConfig:
    """The JAX script's configuration at width x height, n_features."""
    fx = 260.0 * width / 320
    cam = CameraParams.create(fx=fx, fy=fx, cx=width / 2, cy=height / 2, bf=fx * 0.1,
                              width=width, height=height)
    return SlamConfig(camera=cam, orb=OrbConfig(n_features=n_features),
                      caps=Capacities(max_keyframes=64, max_points=16384, local_points=1024),
                      tracking=TrackingConfig(max_frames_between_kf=10), sensor="rgbd")


def build_state(width: int, height: int, n_features: int, device) -> State:
    """A System over the first 8 frames of generate_sequence(seed=5), run op
    by op (its graphs give the same state bitwise)."""
    cfg = config(width, height, n_features)
    seq = generate_sequence(n_frames=8, width=width, height=height, fx=cfg.camera.fx, seed=5)
    slam = System(cfg, device=resolve_device(device))
    slam.step_graph = None
    slam.track_batch_rgbd(seq.images[:8], seq.depths[:8], seq.timestamps[:8])
    return State(slam.config, seq, slam.map, slam.carry, slam.device)


# ------------------------------------------------------------ stage bodies

def _track_motion(config, m, frame, Tcw, velocity, last_frame, last_obs_pt):
    return tracking.track_motion(config, m, frame, Tcw, velocity, last_frame, last_obs_pt,
                                 SEARCH_RADIUS)


def _keyframe_tail(config, m, carry, frame, obs_pt, frame_id, timestamp, info):
    return pipeline.keyframe_tail(config, m, carry, frame, obs_pt, frame_id, timestamp, True,
                                  info)


def step_rgbd_on_device(config, m, carry, image, depth, timestamp):
    """pipeline.step_rgbd (no vocabulary, mapping on) with its host branch
    on the device: the keyframe tail under program_graphs.cond, writing its
    map into m and its carry and StepInfo into the core's.  Returns (map,
    carry, StepInfo) as step_rgbd does."""
    frame = frame_mod.make_frame_rgbd(config, image.to(torch.float32),
                                      pipeline._depth_metres(depth))
    core = pipeline.step_core(config, m, carry, frame)

    def tail():
        out = pipeline.keyframe_tail(config, m, core.carry, frame, core.lres.obs_pt,
                                     carry.frame_id, timestamp, True, core.info)
        _copy_into((m, core.carry, core.info), out)

    program_graphs.cond(core.need_kf, tail)
    return m, core.carry, core.info


@contextlib.contextmanager
def _recording(module, name: str, calls: list):
    """module.<name> replaced by a wrapper that appends a clone of each
    call's arguments to `calls`."""
    orig = getattr(module, name)

    def spy(*args, **kw):
        calls.append(_clone((args, kw)))
        return orig(*args, **kw)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def _pose_optimize(cam, kw, Tcw0, pts_w, obs, sigma2, valid):
    from ..ops.optim.pose_opt import pose_optimize

    return pose_optimize(cam, Tcw0, pts_w, obs, sigma2, valid, **kw)


def pose_optimize_args(st: State, frame: FrameData) -> tuple:
    """(camera, keywords, tensors) of the pose_optimize call that
    track_motion makes on this state (models/tracking.py,
    _optimize_with_matches)."""
    m, c = st.map, st.carry
    with _recording(tracking, "pose_optimize", []) as calls:
        _track_motion(st.config, m, frame, c.Tcw, c.velocity, c.last_frame, c.last_obs_pt)
    args, kw = calls[0]
    return args[0], kw, tuple(args[1:])


def _scatter(form: str, shape, index, source, window: int = 1):
    """One of SCATTER_FORMS, summed into zeros: [*shape], or for the sink
    form `window` blocks of shape[0] // window targets, each followed by its
    sink row, returned without the sink rows ([window, shape[0] // window,
    ...], a view)."""
    zeros = functools.partial(torch.zeros, dtype=source.dtype, device=source.device)
    if form == "index_add_fixed":
        return index_add_fixed(zeros(shape), 0, index, source)
    if form == "index_add_":
        return zeros(shape).index_add_(0, index, source)
    z = zeros((shape[0] + window, *shape[1:]))
    return ordered_index_add_(z, 0, index, source).unflatten(0, (window, -1))[:, :-1]


def scatter_args(st: State, kf_id: torch.Tensor) -> dict:
    """site -> (target shape, index, source) of the first index_add_fixed
    call at each of the mapping pass's scatter-add sites, on this state."""
    out = {}
    for site, module in SCATTER_SITES:
        with _recording(module, "index_add_fixed", []) as calls:
            fn = (local_mapping.refresh_observed_points if site == "refresh_observed_points"
                  else local_mapping.local_bundle_adjustment)
            fn(st.config, _clone(st.map), kf_id)
        (target, dim, index, source), _ = calls[0]
        assert dim == 0
        out[site] = (tuple(target.shape), index.long(), source)
    return out


def scatter_forms(st: State, site: str, shape, index, source) -> dict:
    """form -> (window, index, source), _scatter's arguments for each of
    SCATTER_FORMS at one site.  The sink form: refresh_observed_points' N
    targets and one sink row N for every dropped row, zeroed; the BA's
    window x P (keyframe, point) targets laid out window x (P + 1), each
    keyframe's dropped rows on its sink column P.  Plain: the kept rows
    alone (picked here, on the host)."""
    n = shape[0]
    keep = (index >= 0) & (index < n)
    if site == "refresh_observed_points":
        sink = (1, torch.where(keep, index, n), torch.where(keep[:, None], source, 0.0))
    else:
        K = (min(st.config.caps.ba_free_kfs, st.map.max_kf)
             + min(st.config.caps.ba_fixed_kfs, st.map.max_kf))
        P, N = n // K, index.shape[0] // K
        k = torch.arange(K, device=index.device).repeat_interleave(N)
        sink = (K, k * (P + 1) + torch.where(keep, index - k * P, P), source)
    return {"index_add_fixed": (1, index, source), "sink form": sink,
            "index_add_": (1, index[keep], source[keep])}


def sink_form_equal(st: State) -> dict:
    """site -> whether index_add_fixed's sums equal the kept rows of the
    sink form's, bit for bit, on this state's newest keyframe."""
    out = {}
    for site, (shape, *args) in scatter_args(st, (st.map.n_kf - 1).to(torch.int32)).items():
        sums = {form: _scatter(form, shape, index, source, window).reshape(shape)
                for form, (window, index, source) in scatter_forms(st, site, shape,
                                                                   *args).items()}
        out[site] = bitwise_equal(sums["index_add_fixed"], sums["sink form"])
    return out


def main_stages(st: State, n: int) -> list:
    """The main mode's stages, their inputs computed op by op as the JAX
    script computes them."""
    cfg, m, c, dev = st.config, st.map, st.carry, st.device
    img = torch.from_numpy(st.seq.images[0].astype(np.float32)).to(dev)
    dep = torch.from_numpy(st.seq.depths[0].astype(np.float32)).to(dev)
    ts = torch.zeros((), dtype=torch.float32, device=dev)
    frame = frame_mod.make_frame_rgbd(cfg, img, dep)
    res = _track_motion(cfg, m, frame, c.Tcw, c.velocity, c.last_frame, c.last_obs_pt)
    lres = tracking.track_local_map(cfg, m, frame, res.Tcw, res.obs_pt)
    m2, kf_id = tracking.create_keyframe(cfg, _clone(m), frame, lres.Tcw, lres.obs_pt,
                                         c.frame_id, ts)
    core = pipeline.step_core(cfg, m, c, frame)
    cam, kw, po_args = pose_optimize_args(st, frame)
    part = functools.partial
    return [
        Stage("make_frame_rgbd", part(frame_mod.make_frame_rgbd, cfg), (img, dep), n),
        Stage("track_motion", part(_track_motion, cfg),
              (m, frame, c.Tcw, c.velocity, c.last_frame, c.last_obs_pt), n),
        Stage("pose_optimize", part(_pose_optimize, cam, kw), po_args, n),
        Stage("_motion_hypotheses", part(pipeline._motion_hypotheses, tracking.track_motion,
                                         cfg), (m, c, frame), n),
        Stage("track_local_map", part(tracking.track_local_map, cfg),
              (m, frame, res.Tcw, res.obs_pt), n),
        Stage("step_core", part(pipeline.step_core, cfg), (m, c, frame), n),
        Stage("create_keyframe", part(tracking.create_keyframe, cfg),
              (m, frame, lres.Tcw, lres.obs_pt, c.frame_id, ts), n),
        Stage("keyframe_tail", part(_keyframe_tail, cfg),
              (m, core.carry, frame, core.lres.obs_pt, c.frame_id, ts, core.info), n),
        Stage("local_mapping._process", part(local_mapping._process, cfg), (m2, kf_id),
              max(n // 4, 1)),
        Stage("full step_rgbd (no scan)", part(step_rgbd_on_device, cfg),
              (m, c, img, dep, ts), n, conditional=True, op_fn=part(pipeline.step_rgbd, cfg)),
    ]


def mapping_stages(st: State, n: int) -> list:
    """The mapping mode's stages on the newest keyframe (kf_id = n_kf - 1)."""
    cfg, m = st.config, st.map
    kf_id = (m.n_kf - 1).to(torch.int32)
    stages = [Stage(name, functools.partial(getattr(local_mapping, name), cfg), (m, kf_id), n)
              for name in JAX_MAPPING]
    for site, (shape, *args) in scatter_args(st, kf_id).items():
        for form, (window, index, source) in scatter_forms(st, site, shape, *args).items():
            stages.append(Stage(f"{form} ({site})",
                                functools.partial(_scatter, form, shape, window=window),
                                (index, source), n, exact=form != "index_add_"))
    return stages


# ------------------------------------------------------------------ timing

def bitwise_equal(a, b) -> bool:
    """Every tensor of a equals b's bit for bit (NaNs included)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if not torch.is_tensor(x):
            if x != y:
                return False
            continue
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if x.is_floating_point():
            bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
            x, y = x.view(bits), y.view(bits)
        if not torch.equal(x, y):
            return False
    return True


class _Inputs:
    """A stage's own copy of its inputs, and the copy back of the tensors
    a call wrote into them (found by comparing with the pristine inputs
    after the first call)."""

    def __init__(self, statics: tuple):
        self.pristine = statics
        self.statics = _clone(statics)
        self.written: list = []

    def find_written(self) -> None:
        self.written = [(d, s) for d, s in zip(tree_leaves(self.statics),
                                               tree_leaves(self.pristine))
                        if torch.is_tensor(d) and not bitwise_equal(d, s)]

    def restore(self) -> None:
        for d, s in self.written:
            d.copy_(s)


def _traced(calls: Callable, dev: torch.device) -> dict:
    """utils/profiling.trace_counts of calls() under torch.profiler (CUDA
    activity: kernels and runtime calls, which hold the host waits), the
    window closed by cuda.synchronize."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        calls()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    return trace_counts(prof, wall)


def measure(call: Callable, n: int, dev: torch.device, warm: bool = True,
            trace: bool = True) -> dict:
    """call() on the card timed n times (after a warm call, unless the
    caller just made one): host ms and device ms a call (CUDA events), then,
    with trace, kernels, busy ms and host syncs of
    one more call traced by torch.profiler (a call's kernels are the same
    every time; a step op by op leaves some 10^5 events a call, and their
    processing is most of the tool's time).  The host waits of an empty
    traced window just before (its closing synchronize, the profiler's own)
    are taken off."""
    if warm:
        call()
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        call()
    end.record()
    torch.cuda.synchronize(dev)
    host_ms = (time.perf_counter() - t0) / n * 1e3
    if not trace:
        return dict(host_ms=host_ms, device_ms=start.elapsed_time(end) / n, kernels=None,
                    busy_ms=None, syncs=None)
    window = _traced(lambda: None, dev)["syncs"]
    c = _traced(call, dev)
    return dict(host_ms=host_ms, device_ms=start.elapsed_time(end) / n,
                kernels=c["kernels"], busy_ms=c["busy_ms"], syncs=c["syncs"] - window)


def _net(m: dict, restore: dict | None) -> dict:
    """A stage's numbers less those of the copies back of its inputs."""
    if restore is None:
        return m
    return {k: (v - restore[k] if k != "syncs" and v is not None else v)
            for k, v in m.items()}


def run_stage(stage: Stage, dev: torch.device, trace_op: bool = True) -> dict:
    """One stage both ways -> its row: {"op": numbers, "graph": numbers (the
    card), "restore": numbers or None, "bitwise": bool, "written": count}.
    Each stage's graph has a pool of its own, freed with it.  trace_op
    False traces the op-by-op way of step_rgbd alone (the sync counter's
    positive control).  On the CPU
    the stage runs once op by op (its host ms), and once more through its
    Program's plain version only where that runs another function
    (step_rgbd; elsewhere "bitwise" is None: the same call)."""
    on_card = dev.type == "cuda"
    op_fn = stage.op_fn or stage.fn
    op_in = _Inputs(stage.statics)
    t0 = time.perf_counter()
    op_out = _clone(op_fn(*op_in.statics))
    host_ms = (time.perf_counter() - t0) * 1e3
    if not on_card:
        graph_out = (_clone(stage.fn(*_clone(stage.statics))) if stage.op_fn is not None
                     else None)
        return dict(name=stage.name, exact=stage.exact, written=0, restore=None,
                    op=dict(host_ms=host_ms),
                    bitwise=bitwise_equal(op_out, graph_out) if graph_out is not None else None)
    op_in.find_written()
    op_in.restore()
    prog_in = _Inputs(stage.statics)
    prog = program_graphs.Program(lambda *a: stage.fn(*a[:-1]), prog_in.statics, dev,
                                  program_graphs.GraphPool(), conditional=stage.conditional)
    prog.run()                    # eagerly, then the capture
    prog_in.find_written()
    prog_in.restore()
    graph_out = _clone(prog.run())    # a replay
    row = dict(name=stage.name, exact=stage.exact, bitwise=bitwise_equal(op_out, graph_out),
               written=len(op_in.written), restore=None)

    def op_call():
        op_in.restore()
        op_fn(*op_in.statics)

    trace = trace_op or stage.name == JAX_MAIN[-1]
    row["op"] = measure(op_call, stage.n, dev, warm=False, trace=trace)
    if op_in.written:
        row["restore"] = measure(op_in.restore, stage.n, dev, trace=trace)
        row["op"] = _net(row["op"], row["restore"])

    def graph_call():
        prog_in.restore()
        prog.replay()

    row["graph"] = _net(measure(graph_call, stage.n, dev, warm=False),
                        measure(prog_in.restore, stage.n, dev) if prog_in.written else None)
    return row


# ----------------------------------------------------------------- report

def format_rows(rows: list, on_card: bool) -> str:
    if not on_card:
        lines = [f"{'stage':42s} {'host ms':>9s}  bitwise"]
        lines += [f"{r['name']:42s} {r['op']['host_ms']:9.3f}  "
                  f"{'-' if r['bitwise'] is None else 'yes' if r['bitwise'] else 'NO'}"
                  for r in rows]
        return "\n".join(lines)
    lines = [f"{'stage':42s} {'way':5s} {'host ms':>9s} {'device ms':>10s} {'kernels':>8s} "
             f"{'busy ms':>9s} {'syncs':>6s}  bitwise"]
    for r in rows:
        for way in ("op", "graph"):
            v = r[way]
            tail = ""
            if way == "graph":
                tail = ("yes" if r["bitwise"] else "NO") if r["exact"] else (
                    f"{'yes' if r['bitwise'] else 'no'} (no fixed order: not held)")
            traced = (f"{v['kernels']:8.1f} {v['busy_ms']:9.3f} {v['syncs']:6.2f}"
                      if v["kernels"] is not None else f"{'-':>8s} {'-':>9s} {'-':>6s}")
            lines.append(f"{r['name'] if way == 'op' else '':42s} {way:5s} "
                         f"{v['host_ms']:9.3f} {v['device_ms']:10.3f} {traced}  {tail}")
    notes = [f"  {r['name']}: less {r['written']} input copies back a call "
             f"({r['restore']['device_ms']:.3f} device ms)" for r in rows
             if r["restore"] is not None]
    if notes:
        lines.append("stages that write into their inputs, shown net of the copies back:")
        lines += notes
    return "\n".join(lines)


def step_accounting(rows: list) -> str:
    """step_core's replayed device ms against its parts'."""
    by = {r["name"]: r["graph"]["device_ms"] for r in rows if "graph" in r}
    if not {"step_core", "_motion_hypotheses", "track_local_map"} <= by.keys():
        return ""
    parts = by["_motion_hypotheses"] + by["track_local_map"]
    core = by["step_core"]
    return (f"step_core replayed {core:.3f} device ms: _motion_hypotheses + track_local_map "
            f"cover {parts:.3f} ms ({parts / core:.1%}); unattributed (the keyframe decision "
            f"and _advance) {core - parts:.3f} ms")


def profile(st: State, mapping: bool, n: int | None = None, trace_op: bool = True) -> list:
    """Every stage of one mode on `st`, both ways -> rows (run_stage's
    trace_op)."""
    stages = (mapping_stages(st, n or 10) if mapping else main_stages(st, n or 20))
    rows = []
    for s in stages:
        t0 = time.perf_counter()
        rows.append(run_stage(s, st.device, trace_op))
        print(f"[profile_stages] {s.name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
    return rows


def report(st: State, mapping: bool, n: int | None = None, trace_op: bool = True) -> list:
    """Profile one mode on st and print its table (on the card also the
    step's accounting) -> the rows."""
    rows = profile(st, mapping, n, trace_op)
    on_card = st.device.type == "cuda"
    print(format_rows(rows, on_card))
    if on_card and not mapping:
        print(step_accounting(rows))
    if mapping:
        print(f"index_add_fixed against the sink form's kept rows, bitwise: "
              f"{sink_form_equal(st)}")
    if not on_card:
        print("device metrics need the card (--device cuda)")
    return rows


def failures(rows: list) -> list:
    """The stages whose replay differs from op by op where it must not, or
    synchronizes the host (the card); and, on the card, a sync count that
    misses step_rgbd's flag read op by op (the counter's positive control)."""
    bad = [r["name"] for r in rows
           if (r["exact"] and r["bitwise"] is False) or r.get("graph", {}).get("syncs", 0) > 0]
    bad += [f"{r['name']} op by op: {r['op']['syncs']} syncs seen, its flag read missed"
            for r in rows if r["name"] == JAX_MAIN[-1] and r["op"].get("syncs", 1) < 1]
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mapping", action="store_true", help="the mapping pass's stages")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    width, height = int(os.environ.get("PW", 320)), int(os.environ.get("PH", 240))
    n_features = int(os.environ.get("PF", 500))
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    print(f"device: {torch.cuda.get_device_name(dev) if on_card else 'cpu'}"
          + (f" ({card_line()})" if on_card else "")
          + f"; {width}x{height}/{n_features}feat; torch {torch.__version__}")
    t0 = time.perf_counter()
    st = build_state(width, height, n_features, dev)
    print(f"state: {int(st.map.n_kf)} keyframes, {int(st.map.pt_valid.sum())} points after 8 "
          f"frames ({time.perf_counter() - t0:.1f} s)")
    rows = report(st, args.mapping)
    bad = failures(rows)
    if args.mapping:
        bad += [f"{site}: index_add_fixed differs from the sink form"
                for site, same in sink_form_equal(st).items() if not same]
    if bad:
        print(f"FAILED: replays that differ from op by op or sync: {bad}", file=sys.stderr)
        return 1
    return 0

if __name__ == "__main__":
    sys.exit(main())
