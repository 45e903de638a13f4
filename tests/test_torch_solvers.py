"""The port's closed-form solvers against the JAX package's.

horn_align (rigid, with scale, weighted): s, R, t within 1e-5 of the JAX
result on the same numpy inputs.  _epnp_solve on the same 12-point sets:
R and t within 1e-3 on exact pixels (three eigendecompositions by another
library; the function is built not to depend on eigenvector signs), looser on
noisy ones, as the test says.  pnp_ransac draws its
minimal sets from another random stream, so it is compared by outcome: pose
error against the ground truth, inlier counts, success flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.solvers import epnp as jepnp
from self_commit_orb_slam2_tpu.ops.solvers.horn import horn_align as jhorn
from self_commit_orb_slam2_tpu_torch.ops import se3
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.solvers import epnp
from self_commit_orb_slam2_tpu_torch.ops.solvers.horn import horn_align

CAM_KW = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0)
JCAM, CAM = JCam.create(**CAM_KW), CameraParams.create(**CAM_KW)
T_TRUE = se3.se3_exp(torch.tensor([0.4, -0.2, 0.6, 0.15, -0.1, 0.2])).numpy()


def _horn_case(kind, rng):
    if kind == "rigid":
        src = rng.normal(size=(4, 50, 3)).astype(np.float32)
        R = Rotation.random(4, random_state=3).as_matrix().astype(np.float32)
        dst = np.einsum("bij,bnj->bni", R, src) + rng.normal(size=(4, 1, 3)).astype(np.float32)
        return src, dst, None, False
    src = rng.normal(size=(60, 3)).astype(np.float32)
    R = Rotation.random(1, random_state=4).as_matrix()[0].astype(np.float32)
    if kind == "scaled":
        return src, (2.5 * src @ R.T + np.array([1.0, -0.5, 2.0], np.float32)), None, True
    dst = (src @ R.T + 0.5).astype(np.float32)
    dst[:10] += rng.normal(0, 5.0, (10, 3)).astype(np.float32)   # corrupted, weight 0
    w = rng.uniform(0.5, 2.0, 60).astype(np.float32)
    w[:10] = 0.0
    return src, dst, w, kind == "weighted_scaled"


@pytest.mark.parametrize("kind", ["rigid", "scaled", "weighted", "weighted_scaled"])
def test_horn_align_matches_jax(kind, rng):
    src, dst, w, with_scale = _horn_case(kind, rng)
    want = jhorn(jnp.asarray(src), jnp.asarray(dst),
                 None if w is None else jnp.asarray(w), with_scale=with_scale)
    got = horn_align(torch.from_numpy(src), torch.from_numpy(dst),
                     None if w is None else torch.from_numpy(w), with_scale=with_scale)
    for g, j, name in zip(got, want, "sRt"):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0, atol=1e-5, err_msg=name)
    if kind == "scaled":
        assert abs(float(got[0]) - 2.5) < 1e-4


def _pnp_problem(rng, n=150, noise=0.5, outlier_frac=0.0):
    pts_w = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    pts_w[:, 2] += 8.0
    pc = pts_w @ T_TRUE[:3, :3].T + T_TRUE[:3, 3]
    uv = np.stack([450.0 * pc[:, 0] / pc[:, 2] + 320.0,
                   450.0 * pc[:, 1] / pc[:, 2] + 240.0], -1)
    uv = uv + rng.normal(0, noise, (n, 2))
    bad = rng.choice(n, int(n * outlier_frac), replace=False)
    uv[bad] = rng.uniform(0, 640, (len(bad), 2))
    return pts_w, uv.astype(np.float32), bad


def _pose_err(Tcw: np.ndarray) -> float:
    return float(torch.linalg.norm(se3.se3_log(torch.from_numpy(
        (Tcw @ np.linalg.inv(T_TRUE)).astype(np.float32)))))


@pytest.mark.parametrize("noise,tol_R,tol_t", [(0.0, 1e-3, 1e-3), (0.3, 1e-2, 5e-2)])
def test_epnp_solve_matches_jax_on_fixed_sets(noise, tol_R, tol_t, rng):
    """64 sets of 12 correspondences, the same in both.  Exact pixels: R and
    t within 1e-3.  With 0.3 px of noise the 12x12 system's kernel vector is
    no longer well separated and fp32 rounding is magnified: either package
    then sits 7e-3 (R) from the float64 result of the same code, and they
    sit 4e-3 (R) and 3e-2 (t) from each other (measured), so 1e-2 and 5e-2."""
    pts_w, uv, _ = _pnp_problem(rng, n=400, noise=noise)
    sets = rng.integers(0, 400, (64, 12))
    jR, jt = jepnp._epnp_solve(jnp.asarray(pts_w[sets]), jnp.asarray(uv[sets]), JCAM)
    R, t = epnp._epnp_solve(torch.from_numpy(pts_w[sets]), torch.from_numpy(uv[sets]), CAM)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=0, atol=tol_R)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=tol_t)
    assert np.abs(R.numpy() - T_TRUE[:3, :3]).max() < 0.05


def test_epnp_solve_degenerate_sets_do_not_raise():
    """One point repeated 6 times, and 6 coplanar points: no exception (the
    JAX package returns whatever its inverse gives and the hypothesis loses)."""
    p = torch.tensor([[0.5, -0.2, 6.0]]).repeat(6, 1)
    plane = torch.tensor([[x, y, 5.0] for x, y in
                          [(0, 0), (1, 0), (0, 1), (1, 1), (2, 1), (1, 2)]], dtype=torch.float32)
    pts = torch.stack([p, plane])
    uv = torch.stack([450.0 * pts[..., 0] / pts[..., 2] + 320.0,
                      450.0 * pts[..., 1] / pts[..., 2] + 240.0], -1)
    R, t = epnp._epnp_solve(pts, uv, CAM)
    assert R.shape == (2, 3, 3) and t.shape == (2, 3)


def _both_ransac(pts_w, uv, valid, seed, **kw):
    n = len(pts_w)
    jres = jepnp.pnp_ransac(JCAM, jnp.asarray(pts_w), jnp.asarray(uv), jnp.asarray(valid),
                            jnp.ones(n), jax.random.PRNGKey(seed), **kw)
    res = epnp.pnp_ransac(CAM, torch.from_numpy(pts_w), torch.from_numpy(uv),
                          torch.from_numpy(valid), torch.ones(n),
                          torch.Generator().manual_seed(seed), **kw)
    return jres, res


def test_pnp_ransac_clean(rng):
    pts_w, uv, _ = _pnp_problem(rng, noise=0.3)
    jres, res = _both_ransac(pts_w, uv, np.ones(150, bool), 0)
    assert bool(jres.success) and bool(res.success)
    assert _pose_err(res.Tcw.numpy()) < 0.05 and _pose_err(np.asarray(jres.Tcw)) < 0.05
    assert int(res.n_inliers) > 130 and int(jres.n_inliers) > 130
    assert int(res.n_inliers) == int(res.inliers.sum())


def test_pnp_ransac_with_outliers(rng):
    pts_w, uv, bad = _pnp_problem(rng, noise=0.3, outlier_frac=0.3)
    jres, res = _both_ransac(pts_w, uv, np.ones(150, bool), 1)
    assert bool(jres.success) and bool(res.success)
    assert _pose_err(res.Tcw.numpy()) < 0.08 and _pose_err(np.asarray(jres.Tcw)) < 0.08
    assert res.inliers.numpy()[bad].mean() < 0.1
    assert abs(int(res.n_inliers) - int(jres.n_inliers)) <= 0.1 * int(jres.n_inliers)


def test_pnp_ransac_garbage_fails(rng):
    pts_w = (rng.uniform(-3, 3, (100, 3)) + [0, 0, 8]).astype(np.float32)
    uv = rng.uniform(0, 640, (100, 2)).astype(np.float32)
    jres, res = _both_ransac(pts_w, uv, np.ones(100, bool), 2, min_inliers=20)
    assert not bool(jres.success) and not bool(res.success)


@pytest.mark.parametrize("n_valid", [4, 0])
def test_pnp_ransac_too_few_valid(n_valid, rng):
    """Fewer than a minimal set, and none at all (all-zero probabilities):
    no exception, no success, a finite pose."""
    pts_w, uv, _ = _pnp_problem(rng, noise=0.3)
    valid = np.zeros(150, bool)
    valid[:n_valid] = True
    jres, res = _both_ransac(pts_w, uv, valid, 3)
    assert not bool(jres.success) and not bool(res.success)
    assert int(res.n_inliers) <= n_valid and not bool(res.inliers[n_valid:].any())
    assert bool(torch.isfinite(res.Tcw).all())


def test_pnp_ransac_batch_is_the_single_problem_per_row(rng):
    """Problems solved together: each row's outcome is that of a clean and
    of an empty problem, and a NaN point set cannot win."""
    pts_w, uv, _ = _pnp_problem(rng, noise=0.3)
    valid = np.stack([np.ones(150, bool), np.zeros(150, bool), np.ones(150, bool)])
    pts = np.stack([pts_w, pts_w, np.full_like(pts_w, np.nan)])
    res = epnp.pnp_ransac_batch(CAM, torch.from_numpy(pts), torch.from_numpy(uv),
                                torch.from_numpy(valid), torch.ones(150),
                                torch.Generator().manual_seed(4))
    assert res.success.tolist() == [True, False, False]
    assert res.n_inliers.tolist()[1:] == [0, 0] and int(res.n_inliers[0]) > 130
    assert _pose_err(res.Tcw[0].numpy()) < 0.08
    assert bool(torch.isfinite(res.Tcw).all())


def test_draw_minimal_sets_only_valid_and_reproducible():
    valid = torch.zeros(3, 40, dtype=torch.bool)
    valid[0, [3, 7, 11]] = True
    valid[1, 5] = True                           # row 2: nothing valid
    a = epnp.draw_minimal_sets(valid, 64, 6, torch.Generator().manual_seed(9))
    b = epnp.draw_minimal_sets(valid, 64, 6, torch.Generator().manual_seed(9))
    assert a.shape == (3, 64, 6) and torch.equal(a, b)
    assert set(a[0].unique().tolist()) <= {3, 7, 11} and a[1].unique().tolist() == [5]
    assert 0 <= int(a[2].min()) and int(a[2].max()) < 40
