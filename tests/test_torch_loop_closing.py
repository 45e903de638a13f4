"""The port's loop closer against the JAX package, stage by stage.

The JAX System (320x240, 500 features, local mapping on, the bundled
vocabulary, loop closing off) streams 36 frames of a spin.  Drift is then
injected: for the RGB-D state along the chain (keyframe j's content moved
by an increment 15 - j times, 15 cm and 8 degrees at the start); for the
mono state, verified scale-free, the whole map at once by a similarity
with scale 0.85.  The same System re-initializes at frame 0 on that map
and streams 7 more frames: a second branch that revisits the first
keyframes with no shared observation, i.e. a loop.  From that state
the JAX stages run, and each stage's input moves into the port through
convert.py.

Tolerances: candidate groups, the winning candidate, `found`, the persisted
loop edge and the spanning-tree edges exact; with the JAX package's own
minimal sets, Sim3 inliers within 2 and projection matches within 3, the
Sim3 within 2e-3 (a Horn eigenvector, 15 Gauss-Newton steps and a 3x3 solve
in fp32 with sums in another order); with the port's own draws, the same
candidate and `found`, projections within 5%.  After correct_loop: poses
within 1e-3, points within 2e-3 m + 1e-3 relative (a 20-step pose graph in
fp32), the rebound observations equal on >= 99.9% of entries (in
correct_loop, and in the fuse alone from an aligned current keyframe).  merge_gba is
arithmetic on given inputs: 1e-5.  The global BA from the corrected map:
poses 2e-3, points 2e-3 m + 1e-3 relative on >= 99.9% (its test says why).
A GBA aborted mid-slice by a newer correction, through both closers: the
corrected map at the correction bounds, the merged map with poses within
1e-3 and points at the same bound on >= 99.9% (its test says why).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models import config as jconfig
from self_commit_orb_slam2_tpu.models import loop_closing as jlc
from self_commit_orb_slam2_tpu.models import map_state as jms
from self_commit_orb_slam2_tpu.models import system as jsystem
from self_commit_orb_slam2_tpu.ops import bow as jbow
from self_commit_orb_slam2_tpu.ops import se3 as jse3
from self_commit_orb_slam2_tpu.ops import sim3 as jsim3
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb
from self_commit_orb_slam2_tpu.utils.drift import displace_old_content
from self_commit_orb_slam2_tpu.utils.synthetic import generate_sequence, spin_trajectory
from self_commit_orb_slam2_tpu_torch import convert
from self_commit_orb_slam2_tpu_torch.models import config, loop_closing, pipeline
from self_commit_orb_slam2_tpu_torch.models import map_state as ms
from self_commit_orb_slam2_tpu_torch.models.system import System
from self_commit_orb_slam2_tpu_torch.ops import bow
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig

torch.set_num_threads(2)   # six test workers share the CPU

CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)
CAPS = dict(max_keyframes=24, max_points=4096, local_points=512)
N_FIRST, N_SECOND = 36, 8
N_DRIFT = 15                                  # increments (keyframes 0 to 14)
DRIFT = [0.01, 0.002, -0.0033, 0.0, 0.0093, 0.0]  # per increment: 15 cm, 8 deg in all
MONO_TEAR = ([0.15, 0.03, -0.05, 0.0, 0.14, 0.0], 0.85)


def _configs(sensor="rgbd", **track):
    track = dict(max_frames_between_kf=3, **track)
    jcfg = jconfig.SlamConfig(camera=JCam.create(**CAM), orb=JOrb(n_features=500),
                              caps=jconfig.Capacities(**CAPS),
                              tracking=jconfig.TrackingConfig(**track), sensor=sensor,
                              vocab=jbow.load_vocabulary(bow.default_vocab_path()))
    tcfg = config.SlamConfig(camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=500),
                             caps=config.Capacities(**CAPS),
                             tracking=config.TrackingConfig(**track), sensor=sensor,
                             vocab=bow.load_vocabulary(bow.default_vocab_path()))
    return jcfg, tcfg


def _port(m_np):
    return convert.state_from_numpy(m_np, None, "cpu")[0]


def _det_to_port(det) -> loop_closing.LoopDetection:
    return loop_closing.LoopDetection(*(torch.from_numpy(np.array(x)) for x in det))


def _jax_sets(m, kf, cand_slots, active, key):
    """The minimal sets the JAX package draws for each candidate: its key
    split three ways, jax.random.choice over the (port's, equal) BoW matches."""
    match = loop_closing.bow_matches(m, kf, cand_slots, active)
    w = match.valid.numpy().astype(np.float32)
    keys = jax.random.split(key, loop_closing.N_CANDIDATES)
    sets = [jax.random.choice(k, w.shape[1], shape=(loop_closing.N_HYPOTHESES, 3), replace=True,
                              p=jnp.asarray(wc / max(wc.sum(), 1.0)))
            for k, wc in zip(keys, w)]
    return torch.from_numpy(np.stack([np.asarray(s) for s in sets]).astype(np.int64))


def loop_states(sensors=("rgbd", "mono"), mono_tear=MONO_TEAR) -> dict:
    """The JAX states of the module docstring, by sensor: the map, the
    current keyframe, the JAX detection from PRNGKey(3) and its correction.
    mono_tear: (twist, scale) of the similarity that displaces the whole
    first branch for the mono state."""
    jcfg, _ = _configs()
    seq = generate_sequence(n_frames=N_FIRST, width=320, height=240, seed=9,
                            trajectory=spin_trajectory(N_FIRST, frames_per_rev=72))
    slam = jsystem.System(jcfg, enable_mapping=True, enable_loop_closing=False)
    slam.track_batch_rgbd(seq.images, seq.depths, seq.timestamps, chunk=4)
    first = jax.device_get(slam.map)
    newest = int(first.n_kf) - 1
    out = {}
    for sensor in sensors:
        m = jax.device_put(first)
        if sensor == "rgbd":
            # increment j moves the content of keyframes 0..j (the JAX drift
            # helper's cutoff is newest - keep_recent)
            D = jse3.se3_exp(jnp.asarray(DRIFT, jnp.float32))
            for j in range(N_DRIFT):
                m = displace_old_content(m, D, jnp.float32(1.0), keep_recent=newest - j)
        else:
            m = displace_old_content(m, jse3.se3_exp(jnp.asarray(mono_tear[0], jnp.float32)),
                                     jnp.float32(mono_tear[1]), keep_recent=-1)
        slam.map = m
        slam.carry, slam.state = None, jsystem.STATE_NOT_INITIALIZED
        slam.track_batch_rgbd(seq.images[:N_SECOND], seq.depths[:N_SECOND],
                              seq.timestamps[:N_SECOND] + 10.0, chunk=4)
        m = slam.map
        kf = jms.latest_kf(m)
        jc, tc = _configs(sensor)
        key = jax.random.PRNGKey(3)
        det = jax.jit(functools.partial(jlc.detect_and_verify, jc))(m, kf, key)
        m_np = jax.device_get(m)
        corrected = jax.device_get(jax.jit(functools.partial(jlc.correct_loop, jc))(m, kf, det))
        out[sensor] = dict(jcfg=jc, tcfg=tc, m=m_np, kf=int(kf), key=key,
                           det=jax.device_get(det), corrected=corrected)
    return out


@pytest.fixture(scope="module")
def states():
    return loop_states()


@pytest.mark.parametrize("sensor", ["rgbd", "mono"])
def test_detect_and_verify_fixed_sets(states, sensor):
    s = states[sensor]
    m, kf = _port(s["m"]), torch.tensor(s["kf"], dtype=torch.int32)
    jdet = s["det"]
    assert bool(jdet.found), "the scenario must hold a verified loop"
    slots, active, groups = loop_closing.loop_candidates(s["tcfg"], m, kf)
    np.testing.assert_array_equal(active.numpy(), np.asarray(jdet.group_ok))
    np.testing.assert_array_equal(groups.numpy(), np.asarray(jdet.groups))
    sets = _jax_sets(m, kf, slots, active, s["key"])
    det = loop_closing.detect_and_verify(s["tcfg"], m, kf, sets=sets)
    assert bool(det.found) and int(det.cand_kf) == int(jdet.cand_kf)
    assert int(det.best_c) == int(jdet.best_c)
    assert abs(int(det.n_inliers) - int(jdet.n_inliers)) <= 2
    assert abs(int(det.n_proj) - int(jdet.n_proj)) <= 3
    np.testing.assert_allclose(det.S_cur_cand.numpy(), np.asarray(jdet.S_cur_cand), atol=2e-3)
    if sensor == "mono":   # the free scale recovers the similarity between branches
        assert abs(float(det.S_cur_cand[7]) - 1.0) > 0.05


def test_detect_and_verify_own_draws(states):
    s = states["rgbd"]
    m, kf = _port(s["m"]), torch.tensor(s["kf"], dtype=torch.int32)
    det = loop_closing.detect_and_verify(s["tcfg"], m, kf, torch.Generator().manual_seed(7))
    jdet = s["det"]
    assert bool(det.found) and int(det.cand_kf) == int(jdet.cand_kf)
    assert abs(int(det.n_proj) - int(jdet.n_proj)) <= 0.05 * int(jdet.n_proj)


@pytest.mark.parametrize("sensor", ["rgbd", "mono"])
def test_correct_loop_matches(states, sensor):
    s = states[sensor]
    before, want = s["m"], s["corrected"]
    got, _ = convert.state_to_numpy(loop_closing.correct_loop(
        s["tcfg"], _port(before), torch.tensor(s["kf"], dtype=torch.int32),
        _det_to_port(s["det"])))
    for f in ("loop_seq_i", "loop_seq_j", "n_loop"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got["loop_meas"], np.asarray(want.loop_meas), atol=1e-6)
    np.testing.assert_allclose(got["kf_Tcw"], np.asarray(want.kf_Tcw), atol=1e-3)
    np.testing.assert_allclose(got["pt_pos"], np.asarray(want.pt_pos), atol=2e-3, rtol=1e-3)
    moved = np.abs(np.asarray(want.kf_Tcw) - before.kf_Tcw).max()
    assert moved > 0.01, "the correction must move keyframes"
    assert (got["kf_obs_pt"] == np.asarray(want.kf_obs_pt)).mean() >= 0.999
    # the incidence cache follows the rebound observations
    np.testing.assert_array_equal(
        got["kf_pt_inc"], convert.state_to_numpy(ms.rebuild_incidence(_port(got)))[0]["kf_pt_inc"])


def test_search_and_fuse_rebinds(states):
    """The loop group's points fused into the current group once the
    current keyframe sits where the loop's Sim3 puts it (on the test state
    the 20-step pose graph leaves it 3 cm short, a compromise with the
    drifted chain's edges, in both packages, so correct_loop's own fuse
    binds little): the same observations rebound."""
    s = states["rgbd"]
    det, kf = s["det"], s["kf"]
    S_cw = jsim3.compose(jnp.asarray(det.S_cur_cand),
                         jsim3.from_se3(jnp.asarray(s["m"].kf_Tcw[int(det.cand_kf)])))
    m_np = s["m"]._replace(kf_Tcw=np.array(s["m"].kf_Tcw))
    m_np.kf_Tcw[kf] = np.asarray(jsim3.to_se3(S_cw))
    want = jax.device_get(jax.jit(functools.partial(jlc._search_and_fuse_loop, s["jcfg"]))(
        jax.device_put(m_np), jnp.int32(kf), jax.device_put(det)))
    got = loop_closing._search_and_fuse_loop(s["tcfg"], _port(m_np),
                                             torch.tensor(kf, dtype=torch.int32),
                                             _det_to_port(det))
    obs_w = np.asarray(want.kf_obs_pt)
    assert (obs_w != m_np.kf_obs_pt).sum() > 20, "the fuse must rebind observations"
    assert (got.kf_obs_pt.numpy() == obs_w).mean() >= 0.999


def test_essential_tree_edges_exact(states):
    for s in states.values():
        for m_np in (s["m"], s["corrected"]):
            want = jlc.essential_tree_edges(jax.device_put(m_np))
            got = loop_closing.essential_tree_edges(_port(m_np))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_merge_gba_matches(states):
    """A GBA result merged into a live map that moved on: the newest
    keyframe is not in the snapshot (spanning-tree correction), a tenth of
    the points are newer than it (remapped through their reference
    keyframe), and one keyframe was culled after the snapshot: its points
    stay where they are in the port (the JAX merge sends them through the
    culled slot's pose, T^-1 T, rounding only)."""
    s = states["rgbd"]
    live = s["corrected"]._asdict()
    rng = np.random.default_rng(0)
    K, P = live["kf_Tcw"].shape[0], live["pt_pos"].shape[0]
    kf_valid = np.array(live["kf_valid"])
    noise = np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(0, 0.01, (K, 6)).astype(np.float32))))
    gba_T = (noise @ np.asarray(live["kf_Tcw"])).astype(np.float32)
    gba_p = (np.asarray(live["pt_pos"]) + rng.normal(0, 0.01, (P, 3))).astype(np.float32)
    snap_seq = np.array(live["kf_seq"])
    newest = int(np.argmax(np.where(kf_valid, snap_seq, -1)))
    snap_seq[newest] = 10_000
    snap_birth = np.array(live["pt_birth"])
    newer = rng.random(P) < 0.1
    snap_birth[newer] -= 1
    ref = np.array(live["pt_ref_kf"])
    culled = int(np.bincount(ref[np.asarray(live["pt_valid"]) & newer], minlength=K)[1:].argmax()) + 1
    kf_valid[culled] = False
    live["kf_valid"] = kf_valid
    live = jms.MapState(**live)
    args = (snap_seq, snap_birth, gba_T, gba_p)
    want = jax.device_get(jax.jit(jlc.merge_gba)(jax.device_put(live), *map(jnp.asarray, args)))
    got = loop_closing.merge_gba(_port(live), *map(torch.from_numpy, args))
    np.testing.assert_allclose(got.kf_Tcw.numpy(), np.asarray(want.kf_Tcw), atol=1e-5)
    assert np.abs(np.asarray(want.kf_Tcw)[newest] - gba_T[newest]).max() > 1e-4
    dead = np.asarray(live.pt_valid) & newer & (ref == culled)
    assert dead.sum() > 0
    np.testing.assert_array_equal(got.pt_pos.numpy()[dead], np.asarray(live.pt_pos)[dead])
    np.testing.assert_allclose(got.pt_pos.numpy()[~dead], np.asarray(want.pt_pos)[~dead],
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(want.pt_pos)[dead], np.asarray(live.pt_pos)[dead],
                               atol=1e-5)


@pytest.mark.parametrize("how", ["whole", "slices"])
def test_global_bundle_adjust_matches(states, how):
    """The post-loop global BA on the corrected RGB-D map, anchored at the
    loop keyframe, against the JAX package's: in one call (4 Huber + 6 plain
    iterations), and as the stream runs it, GBA_SLICES threaded through ten
    calls.  The map right after a correction is far from the optimum and
    its Schur systems are ill-conditioned: one Gauss-Newton step from it
    differs by up to 1.8e-3 in a pose between the two packages' fp32
    solves (measured on the CPU), where the BA moves poses by 0.16.  Bounds:
    poses within 2e-3; points within 2e-3 m + 1e-3 relative on >= 99.9% of
    coordinates (a few weakly constrained points differ more); the anchor
    fixed to the last bit."""
    s = states["rgbd"]
    m_np, anchor = s["corrected"], int(s["det"].cand_kf)
    jm, tm = jax.device_put(m_np), _port(m_np)
    if how == "whole":
        want = jax.jit(functools.partial(jlc.global_bundle_adjust, s["jcfg"]))(jm, anchor)
        got = loop_closing.global_bundle_adjust(s["tcfg"], tm, anchor)
    else:
        want, got = (jm.kf_Tcw, jm.pt_pos), (tm.kf_Tcw, tm.pt_pos)
        jslice = {h: jax.jit(functools.partial(jlc.global_bundle_adjust_slice, s["jcfg"],
                                               huber=h)) for h in (True, False)}
        for huber in loop_closing.GBA_SLICES:
            want = jslice[huber](jm, *want, anchor)
            got = loop_closing.global_bundle_adjust_slice(s["tcfg"], tm, *got, anchor, huber)
    assert np.abs(np.asarray(want[0]) - m_np.kf_Tcw).max() > 0.05, "the BA must move poses"
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-3)
    p_want = np.asarray(want[1])
    close = np.abs(got[1].numpy() - p_want) <= 2e-3 + 1e-3 * np.abs(p_want)
    assert close.mean() >= 0.999
    np.testing.assert_array_equal(got[0].numpy()[anchor], m_np.kf_Tcw[anchor])


def _closer(s, **track):
    _, tcfg = _configs(**track)
    return loop_closing.LoopCloser(tcfg, torch.Generator().manual_seed(7)), _port(s["m"])


def test_resolve_consistency_chaining(states):
    """loop_consistency_th=2: the first verified detection does not fire,
    the second consecutive one of the same group does."""
    s = states["rgbd"]
    lc, m = _closer(s, loop_consistency_th=2)
    lc.dispatch_group(m, [s["kf"]])
    assert lc.pending() == 1
    m1, fired = lc.resolve(m)
    assert m1 is m and fired == [] and lc.n_big_changes == 0 and lc.pending() == 0
    assert lc.debug_log[-1]["found"] and lc.debug_log[-1]["chain"] == 1
    lc.dispatch_group(m, [s["kf"]])
    m2, fired = lc.resolve(m)
    assert lc.n_big_changes == 1 and lc.debug_log[-1]["chain"] == 2 and len(fired) == 1
    assert lc.last_loop_kf == 2 and int(m2.n_loop) == int(m.n_loop) + 1


def test_resolve_paths_and_single_rebase(states):
    """Each path of resolve(): a detection consumed and a correction fired
    (a GBA dispatched), the GBA advanced one slice per call, merged by the
    call after its last slice; then a merge and a correction landing in one
    call re-base the carry once each: their payloads chain, and applying
    both moves the carry by the newest keyframe's total change."""
    s = states["rgbd"]
    lc, m = _closer(s, loop_consistency_th=1)
    lc.dispatch_group(m, [s["kf"]])
    m, fired = lc.resolve(m)
    assert lc.n_big_changes == 1 and len(fired) == 1
    assert lc._pending_gba is not None and lc._pending_gba["phase"] == 0
    for k in range(1, len(loop_closing.GBA_SLICES) + 1):
        m, fired = lc.resolve(m)
        assert fired == [] and lc._pending_gba["phase"] == k
    # the last slice ran in the previous call: this one merges ...
    # ... and a new correction lands in the same call (COOLDOWN keyframes on)
    lc.dispatch_group(m, [s["kf"]] * loop_closing.COOLDOWN)
    assert len(lc._pending_dets) == 1 and len(lc._pending_dets[0][0]) == 1
    slot = ms.latest_kf(m)
    T_start = m.kf_Tcw[slot].clone()
    m, fired = lc.resolve(m)
    assert lc.last_gba_info["gba_path"] == "dense" and lc.n_big_changes == 2
    assert len(fired) == 2 and lc._pending_gba["phase"] == 0
    (s1, b1, a1), (s2, b2, a2) = fired
    assert int(s1) == int(s2) == int(slot)
    torch.testing.assert_close(b1, T_start, rtol=0, atol=0)
    torch.testing.assert_close(b2, a1, rtol=0, atol=0)
    T_end = m.kf_Tcw[slot]
    slam = System(_configs()[1], enable_loop_closing=False, device="cpu")
    T0 = torch.linalg.inv(T_start) @ torch.eye(4)
    slam.map = m
    slam.carry = pipeline.TrackCarry(*([T0] + [None] * (len(pipeline.TrackCarry._fields) - 1)))
    for payload in fired:
        slam._apply_correction_to_carry(*payload)
    want = T0 @ torch.linalg.inv(T_start) @ T_end
    torch.testing.assert_close(slam.carry.Tcw, want, atol=1e-4, rtol=0)
    # applying each payload against the final pose (the JAX stream) would
    # move the carry twice: the two differ here
    twice = T0 @ torch.linalg.inv(b1) @ T_end @ torch.linalg.inv(b2) @ T_end
    assert float((twice - want).abs().max()) > 1e-4
    # block=True runs every remaining slice and merges in the same call
    m, fired = lc.resolve(m, block=True)
    assert lc._pending_gba is None and len(fired) == 1


def test_warmup_leaves_the_closer_and_the_map_as_they_were(states):
    """warmup() runs a detection, a correction, both GBA slice kinds and a
    merge on a throwaway copy with a generator of its own: the closer's
    draws, state and the map are untouched."""
    s = states["rgbd"]
    lc, m = _closer(s)
    before = lc.generator.get_state()
    m_before = [t.clone() for t in m]
    lc.warmup(m)
    assert torch.equal(lc.generator.get_state(), before)
    assert lc.pending() == 0 and lc.n_big_changes == 0 and lc._kf_counter == 0
    for f, x, y in zip(m._fields, m, m_before):
        assert torch.equal(x, y), f


ABORT_AFTER = 3   # slices the first GBA runs before the call that aborts it


def _gba_abort_run(lc, m, inject, read_phase):
    """Two corrections, the second landing in the resolve() after
    ABORT_AFTER slices of the first one's GBA (that call runs slice
    ABORT_AFTER + 1, then aborts); then resolve() until the second GBA is
    merged.  inject(lc, i, counter) queues detection i.  Returns (final
    map, the phase after each call)."""
    inject(lc, 0, 1)
    m, _ = lc.resolve(m)
    phases = [read_phase(lc)]
    for _ in range(ABORT_AFTER):
        m, _ = lc.resolve(m)
        phases.append(read_phase(lc))
    inject(lc, 1, 1 + loop_closing.COOLDOWN)
    m, _ = lc.resolve(m)
    phases.append(read_phase(lc))
    for _ in range(len(loop_closing.GBA_SLICES) - 1):
        m, _ = lc.resolve(m)
        phases.append(read_phase(lc))
    m, _ = lc.resolve(m, block=True)
    assert lc._pending_gba is None and lc.n_big_changes == 2
    return m, phases


def test_gba_aborted_mid_slice_by_a_newer_correction(states):
    """ROADMAP C3: a newer correction fired while the global BA of the one
    before is at slice ABORT_AFTER + 1 of 10, in both packages on the same
    map and detections (loop_consistency_th 1): the JAX detection of the
    RGB-D state, then the JAX package's detection of the same keyframe on
    the map that correction left (PRNGKey(3)).  In each the old GBA is
    dropped, the new one starts at phase 0 on the twice-corrected map and
    is merged after its tenth slice.  The port runs it through the closer's
    programs on the CPU and op by op: bit for bit alike, and equal to
    correct, correct, ten slices and merge called directly (the dropped GBA
    leaves nothing behind).  Against the JAX package: the map the new GBA
    starts from at the correction bounds (poses 1e-3, points 2e-3 m + 1e-3
    relative); the merged map with poses within 1e-3 and points at the
    same bound on >= 99.9% of coordinates (the global BA's fp32 solves in
    another order; test_global_bundle_adjust_matches says why)."""
    from self_commit_orb_slam2_tpu_torch.models.program_graphs import CloserGraphs

    s = states["rgbd"]
    kf = s["kf"]
    jcfg, tcfg = _configs(loop_consistency_th=1)
    n = len(loop_closing.GBA_SLICES)
    jcorrect = jax.jit(functools.partial(jlc.correct_loop, jcfg))
    jm1 = jcorrect(jax.device_put(s["m"]), jnp.int32(kf), jax.device_put(s["det"]))
    det2 = jax.device_get(jax.jit(functools.partial(jlc.detect_and_verify, jcfg))(
        jm1, jnp.int32(kf), jax.random.PRNGKey(3)))
    assert bool(det2.found)
    jm2 = jax.device_get(jcorrect(jm1, jnp.int32(kf), jax.device_put(det2)))
    jdets = [jax.tree.map(lambda x: jnp.asarray(x)[None], d) for d in (s["det"], det2)]

    def inject_jax(lc, i, counter):
        lc._kf_counter = counter
        d = jdets[i]
        lc._pending_dets.append(([(counter, kf)], d,
                                 (d.found, d.best_c, d.groups, d.group_ok, d.cand_kf), None))

    def phase(lc):
        return None if lc._pending_gba is None else lc._pending_gba["phase"]

    jm, jphases = _gba_abort_run(jlc.LoopCloser(jcfg), jax.device_put(s["m"]), inject_jax, phase)
    # both closers advance before they consume: the abort call ran slice
    # ABORT_AFTER + 1 of the old GBA and left the new one at phase 0; it then
    # advances once a call, its tenth slice and the merge in the last
    assert jphases == list(range(ABORT_AFTER + 1)) + list(range(n))
    want = jax.device_get(jm)

    tdets = [loop_closing.LoopDetection(*(x[None] for x in _det_to_port(d)))
             for d in (s["det"], det2)]

    def inject_port(lc, i, counter):
        lc._kf_counter = counter
        lc._pending_dets.append(([(counter, kf)], tdets[i]))

    got = {}
    for graphed in (False, True):
        lc = loop_closing.LoopCloser(tcfg, torch.Generator().manual_seed(7))
        lc.graphs = CloserGraphs(tcfg, "cpu", pool=None) if graphed else None
        m, phases = _gba_abort_run(lc, _port(s["m"]), inject_port, phase)
        assert phases == jphases, graphed
        assert lc.last_gba_info["gba_path"] == "dense"
        got[graphed] = m
    for a, b in zip(got[False], got[True]):
        assert torch.equal(a, b)

    # the same events called directly: the first GBA leaves no trace
    kf_t = torch.tensor(kf, dtype=torch.int32)
    m1 = loop_closing.correct_loop(tcfg, _port(s["m"]), kf_t, _det_to_port(s["det"]))
    m2 = loop_closing.correct_loop(tcfg, m1, kf_t, _det_to_port(det2))
    T, p = m2.kf_Tcw.clone(), m2.pt_pos.clone()
    for huber in loop_closing.GBA_SLICES:
        T, p = loop_closing.global_bundle_adjust_slice(tcfg, m2, T, p, int(det2.cand_kf), huber)
    direct = loop_closing.merge_gba(m2, m2.kf_seq, m2.pt_birth, T, p)
    for f, a, b in zip(direct._fields, got[True], direct):
        assert torch.equal(a, b), f

    np.testing.assert_allclose(m2.kf_Tcw.numpy(), np.asarray(jm2.kf_Tcw), atol=1e-3)
    np.testing.assert_allclose(m2.pt_pos.numpy(), np.asarray(jm2.pt_pos), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got[True].kf_Tcw.numpy(), np.asarray(want.kf_Tcw), atol=1e-3)
    p_want = np.asarray(want.pt_pos)
    close = np.abs(got[True].pt_pos.numpy() - p_want) <= 2e-3 + 1e-3 * np.abs(p_want)
    assert close.mean() >= 0.999
    assert int(got[True].n_loop) == int(want.n_loop) == int(s["m"].n_loop) + 2
    # the GBA moved the map: what it merged is not the corrected map
    assert np.abs(np.asarray(want.kf_Tcw) - np.asarray(jm2.kf_Tcw)).max() > 1e-3
