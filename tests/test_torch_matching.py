"""Matching, RGB-D depth association and pose optimization of the PyTorch
port against the JAX package on the same numpy inputs.

Tolerances: Hamming tables, masks, best/mutual matches, the rotation
histogram and stereo_from_depth's depth lookup are integer or select-only
computations and must match exactly (argmin ties resolve to the first index
in both); its u_right = u - bf/d may differ in the last ulp.
pose_optimize: Tcw within 1e-4 and the inlier count within +-2 (fp32 sums in
another order can move an observation across the chi2 threshold).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.ops import se3 as jse3
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.camera import project as jproject
from self_commit_orb_slam2_tpu.ops.matching import core as jcore
from self_commit_orb_slam2_tpu.ops.matching import hamming as jhamming
from self_commit_orb_slam2_tpu.ops.matching import stereo as jstereo
from self_commit_orb_slam2_tpu.ops.optim.pose_opt import pose_optimize as jpose_optimize
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.matching import core, hamming, stereo
from self_commit_orb_slam2_tpu_torch.ops.optim.pose_opt import pose_optimize


def _t(x):
    return torch.from_numpy(np.array(x))


def _desc(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)


def _noisy_copies(rng, base, n_flip):
    out = base.copy()
    for i in range(len(out)):
        for b in rng.choice(256, n_flip, replace=False):
            out[i, b // 32] ^= np.uint32(1 << (b % 32))
    return out


def test_hamming_table_exact(rng):
    d1, d2 = _desc(rng, 40), _desc(rng, 50)
    v1, v2 = rng.random(40) < 0.8, rng.random(50) < 0.8
    ref = np.asarray(jhamming.hamming_table(jnp.asarray(d1), jnp.asarray(d2),
                                            jnp.asarray(v1), jnp.asarray(v2)))
    got = hamming.hamming_table(_t(d1.view(np.int32)), _t(d2.view(np.int32)), _t(v1), _t(v2))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert hamming.INVALID_DIST == int(jhamming.INVALID_DIST)


def _match_problem(rng, n=60, m=80):
    """Queries are noisy copies of some targets, with duplicated targets so
    that argmin ties occur."""
    dt = _desc(rng, m)
    dt[m // 2:m // 2 + 10] = dt[:10]            # exact duplicate targets
    src = rng.integers(0, m, n)
    dq = _noisy_copies(rng, dt[src], 12)
    uv_q = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    uv_t = rng.uniform(0, 100, (m, 2)).astype(np.float32)
    radius = rng.uniform(20, 60, n).astype(np.float32)
    lq = rng.integers(0, 4, n).astype(np.int32)
    lt = rng.integers(0, 4, m).astype(np.int32)
    vq, vt = rng.random(n) < 0.9, rng.random(m) < 0.9
    return dq, dt, uv_q, uv_t, radius, lq, lt, vq, vt


@pytest.mark.parametrize("kind", ["masked_ratio", "masked_plain", "mutual"])
def test_best_matches_exact(rng, kind):
    dq, dt, uv_q, uv_t, radius, lq, lt, vq, vt = _match_problem(rng)
    jmask = (jcore.window_mask(jnp.asarray(uv_q), jnp.asarray(uv_t), jnp.asarray(radius))
             & jcore.level_mask(jnp.asarray(lq), jnp.asarray(lt), -1, 1))
    mask = (core.window_mask(_t(uv_q), _t(uv_t), _t(radius))
            & core.level_mask(_t(lq), _t(lt), -1, 1))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    jargs = (jnp.asarray(dq), jnp.asarray(dt), jmask, jnp.asarray(vq), jnp.asarray(vt))
    targs = (_t(dq.view(np.int32)), _t(dt.view(np.int32)), mask, _t(vq), _t(vt))
    if kind == "mutual":
        ref = jcore.mutual_best_match(*jargs, max_dist=100, ratio=None)
        got = core.mutual_best_match(*targs, max_dist=100, ratio=None)
    else:
        ratio = 0.8 if kind == "masked_ratio" else None
        ref = jcore.masked_best_match(*jargs, max_dist=100, ratio=ratio)
        got = core.masked_best_match(*targs, max_dist=100, ratio=ratio)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got.valid.sum()) > 10


def test_rotation_consistency_exact(rng):
    n = 120
    angle_q = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    angle_t = (angle_q - 0.3).astype(np.float32)
    out = rng.choice(n, 25, replace=False)
    angle_t[out] = rng.uniform(0, 2 * np.pi, 25)
    valid = rng.random(n) < 0.9
    idx = np.where(valid, np.arange(n), -1).astype(np.int32)
    jm = jcore.MatchResult(idx=jnp.asarray(idx), dist=jnp.zeros(n, jnp.int32),
                           valid=jnp.asarray(valid))
    tm = core.MatchResult(idx=_t(idx), dist=torch.zeros(n, dtype=torch.int32), valid=_t(valid))
    ref = np.asarray(jcore.rotation_consistency_mask(jnp.asarray(angle_q), jnp.asarray(angle_t), jm))
    got = core.rotation_consistency_mask(_t(angle_q), _t(angle_t), tm).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() >= 80


def test_stereo_from_depth_exact(rng):
    depth = rng.uniform(0.0, 4.0, (60, 80)).astype(np.float32)
    depth[depth < 0.5] = 0.0                    # holes
    xy = np.stack([rng.uniform(-2, 82, 200), rng.uniform(-2, 62, 200)], -1).astype(np.float32)
    valid = rng.random(200) < 0.9
    ref = jstereo.stereo_from_depth(jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(depth), 40.0)
    got = stereo.stereo_from_depth(_t(xy), _t(valid), _t(depth), 40.0)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(ref.depth))
    # u - bf/d: XLA's CPU division may differ from torch's in the last ulp
    np.testing.assert_allclose(got.u_right.numpy(), np.asarray(ref.u_right), rtol=3e-7, atol=1e-5)


CAM_ARGS = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=50.0)


def _pose_problem(rng, n=200, noise=0.3, outlier_frac=0.0, stereo_obs=True):
    jcam = JCam.create(**CAM_ARGS)
    pts_w = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    pts_w[:, 2] += 5.0
    T_true = np.asarray(jse3.se3_exp(jnp.asarray([0.1, -0.05, 0.2, 0.03, -0.02, 0.05],
                                                 jnp.float32)))
    pc = pts_w @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.asarray(jproject(jcam, jnp.asarray(pc))[0]) + rng.normal(0, noise, (n, 2))
    ur = (uv[:, 0] - 50.0 / pc[:, 2] + rng.normal(0, noise, n) if stereo_obs
          else np.full(n, -1.0))
    n_out = int(n * outlier_frac)
    idx = rng.choice(n, n_out, replace=False)
    uv[idx] += rng.uniform(20, 80, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    obs = np.concatenate([uv, ur[:, None]], -1).astype(np.float32)
    T0 = (np.asarray(jse3.se3_exp(jnp.asarray([0.05, 0.02, -0.05, 0.01, -0.02, 0.02],
                                              jnp.float32))) @ T_true).astype(np.float32)
    sigma2 = (1.2 ** (2 * rng.integers(0, 3, n))).astype(np.float32)
    valid = rng.random(n) < 0.95
    return T_true, T0, pts_w, obs, sigma2, valid


@pytest.mark.parametrize("stereo_obs,outlier_frac,ur_weight",
                         [(True, 0.0, 1.0), (False, 0.0, 1.0), (True, 0.25, 25.0)])
def test_pose_optimize_matches(rng, stereo_obs, outlier_frac, ur_weight):
    T_true, T0, pts, obs, sigma2, valid = _pose_problem(
        rng, outlier_frac=outlier_frac, stereo_obs=stereo_obs)
    ref = jpose_optimize(JCam.create(**CAM_ARGS), jnp.asarray(T0), jnp.asarray(pts),
                         jnp.asarray(obs), jnp.asarray(sigma2), jnp.asarray(valid),
                         ur_weight=ur_weight)
    got = pose_optimize(CameraParams.create(**CAM_ARGS), _t(T0), _t(pts), _t(obs),
                        _t(sigma2), _t(valid), ur_weight=ur_weight)
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(ref.Tcw), atol=1e-4)
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 2
    assert np.abs(got.Tcw.numpy() - T_true).max() < 0.02   # and it converged
    assert int(got.n_inliers) > 120


@pytest.mark.parametrize("stereo_obs,outlier_frac,ur_weight",
                         [(True, 0.0, 25.0), (False, 0.25, 1.0)])
def test_pose_optimize_op_under_vmap_matches(rng, stereo_obs, outlier_frac, ur_weight):
    """The custom op the card launches (its CPU implementation here), three
    initial poses folded into one call by its vmap rule, each against JAX
    pose_optimize from the same pose."""
    from self_commit_orb_slam2_tpu_torch.ops.optim import pose_opt

    T_true, T0, pts, obs, sigma2, valid = _pose_problem(
        rng, outlier_frac=outlier_frac, stereo_obs=stereo_obs)
    moves = [np.asarray(jse3.se3_exp(jnp.asarray(d, jnp.float32))) for d in
             ([0.0] * 6, [0.01, -0.02, 0.0, 0.005, 0.0, -0.01], [-0.02, 0.0, 0.03, 0.0, 0.01, 0.0])]
    T0s = np.stack([m @ T0 for m in moves]).astype(np.float32)
    cam = CameraParams.create(**CAM_ARGS)
    got = torch.vmap(lambda T: torch.ops.slam_torch.pose_optimize(
        T[None], _t(pts)[None], _t(obs)[None], _t(sigma2)[None], _t(valid)[None],
        pose_opt._camera(cam), 4, 10, 1e-5, ur_weight))(_t(T0s))
    for i in range(3):
        ref = jpose_optimize(JCam.create(**CAM_ARGS), jnp.asarray(T0s[i]), jnp.asarray(pts),
                             jnp.asarray(obs), jnp.asarray(sigma2), jnp.asarray(valid),
                             ur_weight=ur_weight)
        np.testing.assert_allclose(got[0][i, 0].numpy(), np.asarray(ref.Tcw), atol=1e-4)
        assert abs(int(got[2][i, 0]) - int(ref.n_inliers)) <= 2
        assert np.abs(got[0][i, 0].numpy() - T_true).max() < 0.02
