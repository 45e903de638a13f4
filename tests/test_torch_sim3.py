"""The port's Sim(3) algebra and camera additions against the JAX package.

Mirrors the 8 tests of tests/test_sim3_camera.py: each runs the port's
function and the JAX one on the same numpy inputs, holds the port to the
JAX result, and keeps the original test's own check on the port's output.

Tolerances: Sim3 vectors, matrices and applied points within 1e-5 absolute
plus 1e-5 relative of the JAX values (fp32, the same formulas; only the
order of a few sums differs); log within 5e-5 (a 3x3 solve); projections
within 1e-4 px; triangulated points within 1e-3 m + 2e-3 relative, the
bound of the port's other triangulation tests (an SVD in fp32: measured
1.5e-4 m); the original tests' own
bounds as they are.
"""

import jax.numpy as jnp
import numpy as np
import torch
from scipy.spatial.transform import Rotation

from self_commit_orb_slam2_tpu.ops import camera as jcamera
from self_commit_orb_slam2_tpu.ops import sim3 as jsim3
from self_commit_orb_slam2_tpu.ops import triangulate as jtriangulate
from self_commit_orb_slam2_tpu_torch.ops import camera, se3, sim3, triangulate


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol)


def _rand_sim3_np(rng, n):
    R = Rotation.random(n, random_state=np.random.RandomState(1)).as_matrix().astype(np.float32)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    s = np.exp(rng.normal(size=(n,)).astype(np.float32) * 0.3)
    return R, t, s


def test_sim3_compose_inverse(rng):
    R, t, s = _rand_sim3_np(rng, 16)
    S, jS = sim3.make(_t(R), _t(t), _t(s)), jsim3.make(jnp.asarray(R), jnp.asarray(t),
                                                       jnp.asarray(s))
    _close(S, jS)
    _close(sim3.inverse(S), jsim3.inverse(jS))
    I = sim3.compose(S, sim3.inverse(S))
    _close(I, jsim3.compose(jS, jsim3.inverse(jS)))
    np.testing.assert_allclose(sim3.scale(I).numpy(), 1.0, atol=1e-4)
    np.testing.assert_allclose(sim3.translation(I).numpy(), 0.0, atol=1e-4)
    np.testing.assert_allclose(sim3.rotation(I).numpy(), np.broadcast_to(np.eye(3), (16, 3, 3)),
                               atol=1e-4)


def test_sim3_apply_matches_matrix(rng):
    R, t, s = _rand_sim3_np(rng, 8)
    S, jS = sim3.make(_t(R), _t(t), _t(s)), jsim3.make(jnp.asarray(R), jnp.asarray(t),
                                                       jnp.asarray(s))
    pts = rng.normal(size=(8, 5, 3)).astype(np.float32)
    out = sim3.apply(S, _t(pts))
    _close(out, jsim3.apply(jS, jnp.asarray(pts)))
    _close(sim3.apply_point(S, _t(pts[:, 0])), jsim3.apply_point(jS, jnp.asarray(pts[:, 0])))
    M = sim3.to_matrix(S)
    _close(M, jsim3.to_matrix(jS))
    _close(sim3.to_se3(S), jsim3.to_se3(jS))
    ref = np.einsum("bij,bnj->bni", M[:, :3, :3].numpy(), pts) + M[:, None, :3, 3].numpy()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)
    T = se3.se3_exp(_t(rng.normal(size=(4, 6)) * 0.5))
    _close(sim3.from_se3(T), jsim3.from_se3(jnp.asarray(T.numpy())))
    _close(sim3.from_se3(T, 2.0), jsim3.from_se3(jnp.asarray(T.numpy()), 2.0))


def test_sim3_exp_log_roundtrip(rng):
    xi = (rng.normal(size=(32, 7)) * 0.5).astype(np.float32)
    S = sim3.exp(_t(xi))
    _close(S, jsim3.exp(jnp.asarray(xi)))
    xi2 = sim3.log(S)
    _close(xi2, jsim3.log(jsim3.exp(jnp.asarray(xi))), atol=5e-5)
    np.testing.assert_allclose(xi2.numpy(), xi, atol=2e-4)
    # the small-angle and small-scale branches of the W coefficients
    xi[:8, 3:6] *= 1e-7
    xi[4:12, 6] = 0.0
    _close(sim3.exp(_t(xi)), jsim3.exp(jnp.asarray(xi)))


def test_sim3_exp_zero_is_identity():
    S = sim3.exp(torch.zeros(7))
    _close(S, jsim3.exp(jnp.zeros((7,))), atol=1e-6)
    np.testing.assert_allclose(S.numpy(), sim3.identity().numpy(), atol=1e-6)
    np.testing.assert_array_equal(sim3.identity().numpy(), np.asarray(jsim3.identity()))


def test_sim3_exp_reduces_to_se3():
    rng = np.random.default_rng(3)
    xi7 = (rng.normal(size=(16, 7)) * 0.5).astype(np.float32)
    xi7[:, 6] = 0.0  # zero log-scale
    S = sim3.exp(_t(xi7))
    _close(sim3.to_matrix(S), jsim3.to_matrix(jsim3.exp(jnp.asarray(xi7))))
    np.testing.assert_allclose(sim3.to_matrix(S).numpy(), se3.se3_exp(_t(xi7[:, :6])).numpy(),
                               atol=1e-4)


CAM = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3, k1=0.2624, k2=-0.9531, p1=-0.0054,
           p2=0.0026, k3=1.1633, bf=40.0, width=640, height=480)


def test_project_backproject_roundtrip(rng):
    cam, jcam = camera.CameraParams.create(**CAM), jcamera.CameraParams.create(**CAM)
    depth = rng.uniform(0.5, 5.0, size=(100,)).astype(np.float32)
    uv = np.stack([rng.uniform(0, 640, 100), rng.uniform(0, 480, 100)], -1).astype(np.float32)
    pts = camera.backproject(cam, _t(uv), _t(depth))
    uv2, z = camera.project(cam, pts)
    np.testing.assert_allclose(uv2.numpy(), uv, atol=1e-3)
    np.testing.assert_allclose(z.numpy(), depth, atol=1e-5)
    uvr, zs = camera.project_stereo(cam, pts)
    juvr, jzs = jcamera.project_stereo(jcam, jnp.asarray(pts.numpy()))
    _close(uvr, juvr, atol=1e-4)
    _close(zs, jzs)
    np.testing.assert_allclose(uvr[:, 2].numpy(), uv[:, 0] - 40.0 / depth, atol=1e-3)
    np.testing.assert_array_equal(cam.K.numpy(), np.asarray(jcam.K))


def test_undistort_inverts_distort(rng):
    cam, jcam = camera.CameraParams.create(**CAM), jcamera.CameraParams.create(**CAM)
    xn = rng.uniform(-0.3, 0.3, size=(50, 2)).astype(np.float32)
    xd = camera.distort_normalized(cam, _t(xn))
    _close(xd, jcamera.distort_normalized(jcam, jnp.asarray(xn)))
    uv_dist = torch.stack([cam.fx * xd[:, 0] + cam.cx, cam.fy * xd[:, 1] + cam.cy], -1)
    uv_und = camera.undistort_points(cam, uv_dist, iters=20)
    uv_true = np.stack([cam.fx * xn[:, 0] + cam.cx, cam.fy * xn[:, 1] + cam.cy], -1)
    np.testing.assert_allclose(uv_und.numpy(), uv_true, atol=0.05)
    np.testing.assert_allclose(camera.compute_image_bounds(cam),
                               jcamera.compute_image_bounds(jcam), atol=1e-4)


def test_triangulate_exact(rng):
    cam = camera.CameraParams.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
    jcam = jcamera.CameraParams.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
    pts_w = rng.uniform(-1, 1, size=(200, 3)).astype(np.float32)
    pts_w[:, 2] += 4.0
    T1 = torch.eye(4)
    T2 = se3.se3_exp(_t([0.3, 0.02, 0.01, 0.01, -0.05, 0.02]))
    P1 = triangulate.projection_matrix(cam.K, T1)
    P2 = triangulate.projection_matrix(cam.K, T2)
    _close(P2, jtriangulate.projection_matrix(jcam.K, jnp.asarray(T2.numpy())), atol=1e-4)
    uv1, _ = camera.project(cam, _t(pts_w))
    uv2, _ = camera.project(cam, _t(pts_w) @ T2[:3, :3].T + T2[:3, 3])
    est = triangulate.triangulate_linear(uv1, uv2, P1, P2)
    jest = jtriangulate.triangulate_linear(jnp.asarray(uv1.numpy()), jnp.asarray(uv2.numpy()),
                                           jnp.asarray(P1.numpy()), jnp.asarray(P2.numpy()))
    _close(est, jest, atol=1e-3, rtol=2e-3)
    np.testing.assert_allclose(est.numpy(), pts_w, atol=5e-2)
    gates = triangulate.triangulation_gates(cam, est, T1, T2, uv1, uv2, torch.ones(200),
                                            torch.ones(200), min_parallax_cos=0.99999)
    assert gates.float().mean() > 0.95
