"""The port's pose-graph and Sim3 optimizers against the JAX package.

Mirrors the 4 tests of tests/test_pose_graph.py on its ring problems (the
port's optimize_pose_graph against the JAX one, then the original test's
checks on the port's result), every ring at 12 keyframes (the original
uses 12, 8 and 10) so that the JAX side compiles once; and adds
optimize_sim3 with and without a fixed scale and both packages' Jacobians.

Tolerances: edge residuals and Jacobians within 1e-4 (the port's closed
forms against jax.jacfwd of the same fp32 residual); optimized Sim3 vectors within 1e-3 of the JAX ones (20
Gauss-Newton steps through a 3x3 log solve and a [7K, 7K] LU, each in fp32
with the sums in another order; measured below 2e-4); the fixed vertex to
the last bit; optimize_sim3's S12 within 1e-3 and its inlier sets equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.ops import se3 as jse3
from self_commit_orb_slam2_tpu.ops import sim3 as jsim3
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.optim import pose_graph as jpg
from self_commit_orb_slam2_tpu.ops.optim import sim3_opt as jsim3_opt
from self_commit_orb_slam2_tpu_torch.ops import sim3
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.optim import pose_graph, sim3_opt


def _t(x):
    return torch.from_numpy(np.array(x))


def ring_problem(rng, K=12, drift=0.03):
    """A loop of keyframes with accumulated drift; a loop-closure edge ties
    the last keyframe back to the first (tests/test_pose_graph.py's)."""
    gt = []
    for k in range(K):
        a = 2 * np.pi * k / K
        xi = np.array([np.sin(a), 0.0, 1 - np.cos(a), 0.0, a, 0.0], np.float32)
        gt.append(np.asarray(jse3.se3_exp(jnp.asarray(xi))))
    gt = np.stack(gt)
    gt_s = np.stack([np.asarray(jsim3.from_se3(jnp.asarray(g))) for g in gt])
    est = [gt[0]]
    for k in range(1, K):
        rel = gt[k] @ np.linalg.inv(gt[k - 1])
        noise = np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(0, drift, 6).astype(np.float32))))
        est.append(noise @ rel @ est[-1])
    est = np.stack(est)
    est_s = np.stack([np.asarray(jsim3.from_se3(jnp.asarray(e))) for e in est])
    ei, ej, meas = [], [], []
    for k in range(1, K):
        ei.append(k)
        ej.append(k - 1)
        meas.append(np.asarray(jsim3.from_se3(jnp.asarray(est[k] @ np.linalg.inv(est[k - 1])))))
    ei.append(K - 1)
    ej.append(0)
    meas.append(np.asarray(jsim3.from_se3(jnp.asarray(gt[K - 1] @ np.linalg.inv(gt[0])))))
    return gt_s, est_s, (np.array(ei, np.int32), np.array(ej, np.int32), np.stack(meas),
                         np.ones(len(ei), bool))


# one compile for every ring (the same K; the iteration count traced)
_jax_optimize = jax.jit(jpg.optimize_pose_graph)
K = 12


def _both(est_s, edges, fixed, n_iters=20):
    kw = dict(n_iters=n_iters)
    ei, ej, meas, valid = edges
    want = _jax_optimize(*map(jnp.asarray, (est_s, ei, ej, meas, valid, fixed)), **kw)
    got = pose_graph.optimize_pose_graph(*map(_t, (est_s, ei, ej, meas, valid, fixed)), **kw)
    np.testing.assert_allclose(got.kf_sim3.numpy(), np.asarray(want.kf_sim3), atol=1e-3)
    np.testing.assert_allclose(float(got.mean_residual), float(want.mean_residual),
                               atol=1e-5, rtol=1e-2)
    return got


def test_edge_residual_zero_at_consistency(rng):
    xs = rng.normal(0, 0.3, (2, 7)).astype(np.float32)
    S_i, S_j = sim3.exp(_t(xs[0])), sim3.exp(_t(xs[1]))
    r = pose_graph.edge_residual(S_i, S_j, sim3.compose(S_i, sim3.inverse(S_j)))
    np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-5)
    # and off consistency, against the JAX residual and both Jacobians
    xs = rng.normal(0, 0.3, (3, 6, 7)).astype(np.float32)
    S = [sim3.exp(_t(x)) for x in xs]
    jS = [jsim3.exp(jnp.asarray(x)) for x in xs]
    np.testing.assert_allclose(pose_graph.edge_residual(*S).numpy(),
                               np.asarray(jax.jit(jax.vmap(jpg.edge_residual))(*jS)), atol=1e-4)
    Ji, Jj = pose_graph.edge_jacobians(*S)
    z = jnp.zeros(7, jnp.float32)
    jJi, jJj = jax.jit(jax.vmap(lambda a, b, m: (jpg._jac_i(z, z, a, b, m),
                                                jpg._jac_j(z, z, a, b, m))))(*jS)
    np.testing.assert_allclose(Ji.numpy(), np.asarray(jJi), atol=1e-4)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(jJj), atol=1e-4)


def test_pose_graph_closes_loop(rng):
    gt_s, est_s, edges = ring_problem(rng, K=K, drift=0.02)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    res = _both(est_s, edges, fixed)
    assert float(res.mean_residual) < 1e-2
    S = res.kf_sim3
    loop_meas = _t(edges[2][K - 1])
    err = sim3.log(sim3.compose(sim3.inverse(loop_meas),
                                sim3.compose(S[K - 1], sim3.inverse(S[0]))))
    assert float(torch.linalg.norm(err)) < 1e-2

    def t_err(Ss):
        return np.linalg.norm(np.asarray(Ss)[:, 4:7] - gt_s[:, 4:7], axis=1)

    assert t_err(S.numpy())[6:].mean() < t_err(est_s)[6:].mean() * 0.7


def test_pose_graph_respects_fixed(rng):
    _, est_s, edges = ring_problem(rng, K=K)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    res = _both(est_s, edges, fixed, n_iters=5)
    np.testing.assert_array_equal(res.kf_sim3[0].numpy(), est_s[0])


def test_pose_graph_with_scale_drift(rng):
    """Mono-style: odometry underestimates scale; the loop edge fixes it."""
    _, est_s, (ei, ej, meas, valid) = ring_problem(rng, K=K, drift=0.0)
    meas = meas.copy()
    for k in range(K - 1):
        meas[k][7] *= 0.95
    est = [est_s[0]]
    for k in range(1, K):
        est.append(np.asarray(jsim3.compose(jnp.asarray(meas[k - 1]), jnp.asarray(est[-1]))))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    res = _both(np.stack(est), (ei, ej, meas, valid), fixed, n_iters=30)
    s = sim3.scale(res.kf_sim3).numpy()
    assert float(res.mean_residual) < 5e-3
    assert s.max() > 1.01 or s.min() < 0.99


# ---------------------------------------------------------------- optimize_sim3

_CAM = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)


def _sim3_problem(rng, n=120, scale=1.0, noise=0.5, outliers=15):
    """Points in camera 2, a true S12 (rotation, translation, scale), both
    images' pixels with noise and a few gross outliers; the initial S12 is
    off by a small perturbation."""
    p2 = np.column_stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                          rng.uniform(3, 6, n)]).astype(np.float32)
    xi_true = np.array([0.1, -0.05, 0.08, 0.02, -0.03, 0.015, np.log(scale)], np.float32)
    S_true = np.asarray(jsim3.exp(jnp.asarray(xi_true)))
    p1 = np.asarray(jsim3.apply(jnp.asarray(S_true), jnp.asarray(p2)))

    def proj(p):
        return np.stack([500 * p[:, 0] / p[:, 2] + 320, 500 * p[:, 1] / p[:, 2] + 240], -1)

    uv1 = proj(p1) + rng.normal(0, noise, (n, 2))
    uv2 = proj(p2) + rng.normal(0, noise, (n, 2))
    uv1[:outliers] += rng.uniform(20, 60, (outliers, 2))
    valid = np.ones(n, bool)
    valid[-5:] = False
    S0 = np.asarray(jsim3.compose(jsim3.exp(jnp.asarray(
        rng.normal(0, 0.01, 7).astype(np.float32) * np.array([1] * 6 + [0], np.float32))),
        jnp.asarray(S_true)))
    return [a.astype(np.float32) for a in (S0, p1, p2, uv1, uv2)] + [valid], S_true


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_sim3_matches(rng, fix_scale):
    (S0, p1, p2, uv1, uv2, valid), S_true = _sim3_problem(rng, scale=1.0 if fix_scale else 1.3)
    if not fix_scale:   # start from a wrong scale: the free scale must recover it
        S0[7] *= 0.9
    want = jsim3_opt.optimize_sim3(JCam.create(**_CAM), *map(jnp.asarray, (S0, p1, p2, uv1, uv2,
                                                                         valid)),
                                   fix_scale=fix_scale)
    cam = CameraParams.create(**_CAM)
    got = sim3_opt.optimize_sim3(cam, *map(_t, (S0, p1, p2, uv1, uv2, valid)),
                                 fix_scale=fix_scale)
    np.testing.assert_allclose(got.S12.numpy(), np.asarray(want.S12), atol=1e-3)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) >= 90
    err = sim3.log(sim3.compose(got.S12, sim3.inverse(_t(S_true))))
    assert float(torch.linalg.norm(err)) < 0.02
    if fix_scale:
        assert float(sim3.scale(got.S12)) == pytest.approx(float(S0[7]), abs=1e-6)
    # a batch of two problems gives each problem's own answer
    S0b, p1b, p2b, uv1b, uv2b, validb = (np.stack([a, a]) for a in (S0, p1, p2, uv1, uv2, valid))
    validb[1] = False
    b = sim3_opt.optimize_sim3(cam, *map(_t, (S0b, p1b, p2b, uv1b, uv2b, validb)),
                               fix_scale=fix_scale)
    np.testing.assert_allclose(b.S12[0].numpy(), got.S12.numpy(), atol=1e-6)
    assert b.n_inliers.tolist() == [int(got.n_inliers), 0]


def test_sim3_jacobian_matches_jacfwd(rng):
    (S0, p1, p2, uv1, uv2, _), _ = _sim3_problem(rng, n=40)
    S0[7] = 1.2
    jcam = JCam.create(**_CAM)
    z = jnp.zeros(7, jnp.float32)
    want = jax.jacfwd(lambda xi: jsim3_opt._residuals(
        jcam, jsim3.compose(jsim3.exp(xi), jnp.asarray(S0)), *map(jnp.asarray, (p1, p2, uv1,
                                                                               uv2))))(z)
    got = sim3_opt.residual_jacobian(CameraParams.create(**_CAM),
                                     *(_t(a)[None] for a in (S0, p1, p2, uv1, uv2)))[0]
    scale = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got.numpy() / scale, np.asarray(want) / scale, atol=1e-5)
    r = functools.partial(sim3_opt._residuals, CameraParams.create(**_CAM))
    np.testing.assert_allclose(r(*map(_t, (S0, p1, p2, uv1, uv2))).numpy(),
                               np.asarray(jsim3_opt._residuals(jcam, *map(jnp.asarray, (
                                   S0, p1, p2, uv1, uv2)))), atol=1e-3)
