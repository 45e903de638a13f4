"""The mono loop's 7-DoF path through the port, against the JAX package.

What a monocular loop under scale drift runs (chip_smoke.py path 9 (a),
bench.py's --mono): the drift injector with a scale, Sim3 detection with
the scale free (fix_scale is off for sensor="mono"), and a correction whose
essential-graph Sim3s carry the loop's scale into the keyframes and points.

- utils/drift.displace_old_content and make_injector with scale 1.05 and
  1/1.05 on one JAX map (random poses and points, a third of the keyframes
  recent): poses, points and normals within 1e-5.
- tests/test_torch_loop_closing.py's mono state (built by its loop_states),
  here with the first branch displaced by a similarity of scale 1.05 and a
  second branch re-initialized at frame 0 (a loop): detect_and_verify with
  the JAX package's own minimal sets gives the same candidate and found,
  inliers within 2, the Sim3 within 2e-3, and its scale s within 2e-3 of
  the JAX package's and on the same side of 1.
- correct_loop on that state: poses within 1e-3, points within 2e-3 m +
  1e-3 relative.  The Sim3 essential graph inside it carries the scale:
  the current keyframe's optimized scale lies on the loop's side of 1, and
  in both packages' corrected maps every keyframe's points sit at their old
  depths divided by the port's graph's scale for that keyframe (within
  1e-3), so the two graphs' scales agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models import map_state as jms
from self_commit_orb_slam2_tpu.ops import se3 as jse3
from self_commit_orb_slam2_tpu.utils import drift as jdrift
from self_commit_orb_slam2_tpu_torch import convert
from self_commit_orb_slam2_tpu_torch.models import loop_closing
from self_commit_orb_slam2_tpu_torch.utils import drift
from tests.test_torch_loop_closing import (_configs, _det_to_port, _jax_sets, _port,
                                           loop_states)

torch.set_num_threads(2)   # six test workers share the CPU

TEAR = ([0.15, 0.03, -0.05, 0.0, 0.14, 0.0], 1.05)   # the first branch's similarity
TWIST = [0.0009, 0.0002, -0.0004, 0.0, 0.0007, 0.0]   # bench.py:575-576, per frame


def _random_map(rng):
    """A JAX map with 20 live keyframes (random poses, seqs 0..19) and 3000
    live points first seen by random keyframes."""
    jcfg, _ = _configs()
    m = jax.device_get(jms.empty_map(jcfg))._asdict()
    K, P = m["kf_Tcw"].shape[0], m["pt_pos"].shape[0]
    n_kf, n_pt = 20, 3000
    T = np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(0, 0.5, (K, 6)).astype(np.float32))))
    kf_valid = np.arange(K) < n_kf
    kf_valid[7] = False                       # one culled slot
    pt_valid = np.arange(P) < n_pt
    normal = rng.normal(size=(P, 3)).astype(np.float32)
    m.update(kf_Tcw=T, kf_valid=kf_valid,
             kf_seq=np.where(np.arange(K) < n_kf, np.arange(K), -1).astype(np.int32),
             pt_valid=pt_valid, pt_pos=rng.normal(0, 2, (P, 3)).astype(np.float32),
             pt_normal=normal / np.linalg.norm(normal, axis=1, keepdims=True),
             pt_first_kf=rng.integers(0, n_kf, P).astype(np.int32))
    return jms.MapState(**m)


@pytest.mark.parametrize("scale", [1.05, 1 / 1.05])
def test_displace_old_content_with_scale(scale):
    jm = _random_map(np.random.default_rng(3))
    dD = jse3.se3_exp(jnp.asarray(TWIST, jnp.float32) * 40)
    m = _port(jax.device_get(jm))
    for keep in (6, -1):
        want = jdrift.displace_old_content(jax.device_put(jm), dD, jnp.float32(scale),
                                           keep_recent=keep)
        got = drift.displace_old_content(m, torch.from_numpy(np.array(dD)), scale,
                                         keep_recent=keep)
        via = drift.make_injector(keep_recent=keep)(m, np.array(dD), np.float32(scale))
        for f in ("kf_Tcw", "pt_pos", "pt_normal"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       atol=1e-5, err_msg=f)
            torch.testing.assert_close(getattr(via, f), getattr(got, f), rtol=0, atol=0)
        moved = np.abs(np.asarray(want.pt_pos) - np.asarray(jm.pt_pos)).max(axis=1) > 0
        assert moved.any() and (keep == -1) == moved[:3000].all()
    # a moved pose sees its moved content at the same pixels, depth scaled
    T = got.kf_Tcw[0].double()
    ref = m.kf_Tcw[0].double()
    p, q = m.pt_pos[:50].double(), got.pt_pos[:50].double()
    x_old = p @ ref[:3, :3].T + ref[:3, 3]
    x_new = q @ T[:3, :3].T + T[:3, 3]
    torch.testing.assert_close(x_new, scale * x_old, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def state():
    return loop_states(sensors=("mono",), mono_tear=TEAR)["mono"]


def test_mono_detect_and_verify_recovers_the_scale(state):
    s = state
    m, kf = _port(s["m"]), torch.tensor(s["kf"], dtype=torch.int32)
    jdet = s["det"]
    assert bool(jdet.found), "the scenario must hold a verified loop"
    assert s["tcfg"].sensor == "mono"
    slots, active, _ = loop_closing.loop_candidates(s["tcfg"], m, kf)
    det = loop_closing.detect_and_verify(s["tcfg"], m, kf,
                                         sets=_jax_sets(m, kf, slots, active, s["key"]))
    assert bool(det.found) and int(det.cand_kf) == int(jdet.cand_kf)
    assert int(det.best_c) == int(jdet.best_c)
    assert abs(int(det.n_inliers) - int(jdet.n_inliers)) <= 2
    np.testing.assert_allclose(det.S_cur_cand.numpy(), np.asarray(jdet.S_cur_cand), atol=2e-3)
    s_port, s_jax = float(det.S_cur_cand[7]), float(jdet.S_cur_cand[7])
    assert abs(s_port - s_jax) <= 2e-3
    assert (s_port > 1) == (s_jax > 1) and abs(s_jax - 1) > 0.02


def test_mono_correction_carries_the_scale(state, monkeypatch):
    s = state
    before, want = s["m"], s["corrected"]
    kf = s["kf"]
    graph = {}
    inner = loop_closing.optimize_pose_graph

    def spy(*args, **kw):
        graph["out"] = inner(*args, **kw)
        return graph["out"]

    monkeypatch.setattr(loop_closing, "optimize_pose_graph", spy)
    got_m = loop_closing.correct_loop(s["tcfg"], _port(before),
                                      torch.tensor(kf, dtype=torch.int32),
                                      _det_to_port(s["det"]))
    got, _ = convert.state_to_numpy(got_m)
    np.testing.assert_allclose(got["kf_Tcw"], np.asarray(want.kf_Tcw), atol=1e-3)
    np.testing.assert_allclose(got["pt_pos"], np.asarray(want.pt_pos), atol=2e-3, rtol=1e-3)

    # the Sim3 essential graph: each keyframe's optimized scale, here from the
    # port's graph and in both packages from the corrected map (a point
    # remapped through its reference keyframe sits at its old depth there,
    # divided by that keyframe's scale)
    S_port = graph["out"].kf_sim3.numpy()
    s_det, s_kf = float(s["det"].S_cur_cand[7]), float(S_port[kf, 7])
    assert (s_kf > 1) == (s_det > 1) and abs(np.log(s_kf)) >= 0.5 * abs(np.log(s_det))

    def depth(T, p):
        return (p @ T[:3, :3].T + T[:3, 3])[:, 2]

    checked = 0
    for k in np.nonzero(before.kf_valid)[0]:
        ref = (before.pt_ref_kf == k) & before.pt_valid
        if ref.sum() < 20:
            continue
        d0 = depth(before.kf_Tcw[k].astype(np.float64), before.pt_pos[ref].astype(np.float64))
        for m_after in (got, want._asdict()):
            d1 = depth(m_after["kf_Tcw"][k].astype(np.float64),
                       m_after["pt_pos"][ref].astype(np.float64))
            np.testing.assert_allclose(np.median(d0 / d1), S_port[k, 7], rtol=1e-3)
        checked += k == kf
    assert checked == 1, "the current keyframe anchors no point"
