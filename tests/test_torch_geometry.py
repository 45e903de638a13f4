"""Geometry of the PyTorch port (ops/se3.py, ops/camera.py, ops/optim/robust.py)
against the JAX package on the same numpy inputs.

Tolerance: atol 1e-5 (2e-5 on log maps, 1e-4 near theta = pi): both compute
in fp32 with the same formulas; only the order of a few sums differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from self_commit_orb_slam2_tpu.ops import camera as jcamera
from self_commit_orb_slam2_tpu.ops import se3 as jse3
from self_commit_orb_slam2_tpu.ops.optim import robust as jrobust
from self_commit_orb_slam2_tpu_torch.ops import camera, se3
from self_commit_orb_slam2_tpu_torch.ops.optim import robust


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _rotations(n):
    return Rotation.random(n, random_state=np.random.RandomState(0)).as_matrix().astype(np.float32)


def _poses(rng, n):
    return np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(size=(n, 6)).astype(np.float32) * 0.5)))


CASES = {
    "so3_exp": (lambda rng: rng.normal(size=(32, 3)), 1e-5),
    "so3_log": (lambda rng: _rotations(32), 2e-5),
    "se3_exp": (lambda rng: rng.normal(size=(32, 6)) * 0.8, 1e-5),
    "se3_log": (lambda rng: _poses(rng, 32), 2e-5),
    "inverse": (lambda rng: _poses(rng, 8), 1e-5),
    "hat": (lambda rng: rng.normal(size=(8, 3)), 0.0),
    "rot_to_quat": (lambda rng: _rotations(64), 1e-5),
    "quat_to_rot": (lambda rng: rng.normal(size=(32, 4)), 1e-5),
    "vee": (lambda rng: rng.normal(size=(8, 3, 3)), 0.0),
    "normalize_rotation": (lambda rng: _poses(rng, 4)
                           + rng.normal(size=(4, 4, 4)).astype(np.float32) * 1e-3, 1e-5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_se3_function_matches_jax(rng, name):
    make, atol = CASES[name]
    x = np.asarray(make(rng), np.float32)
    ref = np.asarray(getattr(jse3, name)(jnp.asarray(x)))
    got = getattr(se3, name)(_t(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=atol)


def test_so3_log_near_pi_and_small_angles():
    axis = np.array([1.0, 2.0, -0.5]) / np.linalg.norm([1.0, 2.0, -0.5])
    R = np.stack([Rotation.from_rotvec(axis * a).as_matrix()
                  for a in (np.pi - 1e-3, np.pi - 1e-5, 1e-6, 0.0)]).astype(np.float32)
    ref = np.asarray(jse3.so3_log(jnp.asarray(R)))
    got = se3.so3_log(_t(R)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert np.all(np.isfinite(se3.so3_exp(_t([[1e-9, 0, 0], [0, 0, 0]])).numpy()))


def test_transform_points_and_update(rng):
    T = _poses(rng, 1)[0]
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    np.testing.assert_allclose(se3.transform_points(_t(T), _t(pts)).numpy(),
                               np.asarray(jse3.transform_points(jnp.asarray(T), jnp.asarray(pts))),
                               atol=1e-5)
    np.testing.assert_allclose(se3.transform_point(_t(T), _t(pts[0])).numpy(),
                               np.asarray(jse3.transform_point(jnp.asarray(T), jnp.asarray(pts[0]))),
                               atol=1e-5)
    T2 = _poses(rng, 1)[0]
    np.testing.assert_allclose(se3.compose(_t(T), _t(T2)).numpy(),
                               np.asarray(jse3.compose(jnp.asarray(T), jnp.asarray(T2))),
                               atol=1e-5)
    xi = rng.normal(size=6).astype(np.float32) * 0.1
    np.testing.assert_allclose(se3.update_left(_t(T), _t(xi)).numpy(),
                               np.asarray(jse3.update_left(jnp.asarray(T), jnp.asarray(xi))),
                               atol=1e-5)


CAM_ARGS = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3, k1=0.2624, k2=-0.9531,
                p1=-0.0054, p2=0.0026, k3=1.1633, bf=40.0, width=640, height=480)


def test_project_backproject_undistort_match(rng):
    jc = jcamera.CameraParams.create(**CAM_ARGS)
    tc = camera.CameraParams.create(**CAM_ARGS)
    assert tuple(tc) == tuple(jc) and tc.has_distortion and tc.baseline == jc.baseline
    uv = np.stack([rng.uniform(0, 640, 100), rng.uniform(0, 480, 100)], -1).astype(np.float32)
    depth = rng.uniform(0.5, 5.0, 100).astype(np.float32)
    pts_ref = np.asarray(jcamera.backproject(jc, jnp.asarray(uv), jnp.asarray(depth)))
    pts = camera.backproject(tc, _t(uv), _t(depth))
    np.testing.assert_allclose(pts.numpy(), pts_ref, atol=1e-5)
    uv_ref, z_ref = jcamera.project(jc, jnp.asarray(pts_ref))
    uv2, z2 = camera.project(tc, pts)
    np.testing.assert_allclose(uv2.numpy(), np.asarray(uv_ref), atol=1e-4)
    np.testing.assert_allclose(z2.numpy(), np.asarray(z_ref), atol=1e-6)
    np.testing.assert_allclose(camera.undistort_points(tc, _t(uv)).numpy(),
                               np.asarray(jcamera.undistort_points(jc, jnp.asarray(uv))),
                               atol=1e-3)


def test_in_frustum_matches(rng):
    jc = jcamera.CameraParams.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
    tc = camera.CameraParams.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = rng.normal(size=3).astype(np.float32) * 0.2
    pts = rng.uniform(-3, 3, (200, 3)).astype(np.float32) + np.float32([0, 0, 4])
    rays = pts + T[:3, 3]   # camera centre is -t
    normals = rays / np.linalg.norm(rays, axis=1, keepdims=True)
    normals += rng.normal(size=(200, 3)).astype(np.float32) * 0.5
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    dist = np.linalg.norm(rays, axis=1)
    dmin = (dist * rng.uniform(0.5, 1.2, 200)).astype(np.float32)
    dmax = (dmin + rng.uniform(0.5, 4, 200)).astype(np.float32)
    bounds = (0.0, 640.0, 0.0, 480.0)
    ref = jcamera.in_frustum(jc, jnp.asarray(T), jnp.asarray(pts), jnp.asarray(normals),
                             jnp.asarray(dmin), jnp.asarray(dmax), bounds)
    got = camera.in_frustum(tc, _t(T), _t(pts), _t(normals), _t(dmin), _t(dmax), bounds)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert 10 < int(got[0].sum()) < 190
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_huber_weight_matches(rng):
    chi2 = rng.uniform(0, 20, 100).astype(np.float32)
    th = np.where(rng.random(100) < 0.5, jrobust.CHI2_MONO, jrobust.CHI2_STEREO).astype(np.float32)
    np.testing.assert_allclose(robust.huber_weight(_t(chi2), _t(th)).numpy(),
                               np.asarray(jrobust.huber_weight(jnp.asarray(chi2), jnp.asarray(th))),
                               atol=1e-6)
    assert (robust.CHI2_MONO, robust.CHI2_STEREO) == (jrobust.CHI2_MONO, jrobust.CHI2_STEREO)
