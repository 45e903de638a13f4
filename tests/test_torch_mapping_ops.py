"""The geometry under the port's local mapping against the JAX package:
Hamming distances, two-view triangulation and bundle adjustment.

Tolerances and why:
  * hamming_distance: exact (integer popcounts, sign bit included).
  * triangulation: 1e-4 relative; the closed-form 3x3 solves run the same
    expressions, fp32 products summed in another order.
  * bundle_adjust: poses 1e-4, points 1e-3 (fp32 Gauss-Newton whose normal
    equations are summed in another order: the port groups observations by
    point with a scatter-add, the JAX package with a one-hot matmul);
    inlier masks equal except where an observation's chi2 lies within 1% of
    its threshold.  Each case mirrors one of tests/test_bundle_adjust.py and
    keeps its ground-truth asserts, held here on the port's result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.ops import se3 as jse3
from self_commit_orb_slam2_tpu.ops import triangulate as jtri
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.camera import project as jproject
from self_commit_orb_slam2_tpu.ops.matching import hamming as jhamming
from self_commit_orb_slam2_tpu.ops.optim import bundle_adjust as jba
from self_commit_orb_slam2_tpu_torch.ops import triangulate as tri
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.indexing import set_drop, top_k
from self_commit_orb_slam2_tpu_torch.ops.matching import hamming
from self_commit_orb_slam2_tpu_torch.ops.optim import bundle_adjust as ba
from self_commit_orb_slam2_tpu_torch.ops.optim.robust import CHI2_MONO, CHI2_STEREO

CAM_ARGS = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0, bf=40.0)
JCAM, TCAM = JCam.create(**CAM_ARGS), CameraParams.create(**CAM_ARGS)


def _t(x):
    return torch.from_numpy(np.array(x, order="C"))


def test_hamming_distance_exact(rng):
    d1 = rng.integers(0, 2**32, (40, 1, 8), dtype=np.uint64).astype(np.uint32)
    d2 = rng.integers(0, 2**32, (1, 30, 8), dtype=np.uint64).astype(np.uint32)
    d2[0, 0] = d1[0, 0]                        # distance 0
    d2[0, 1] = ~d1[1, 0]                       # distance 256 (every sign bit set)
    ref = np.asarray(jhamming.hamming_distance(jnp.asarray(d1), jnp.asarray(d2)))
    got = hamming.hamming_distance(_t(d1.view(np.int32)), _t(d2.view(np.int32))).numpy()
    assert got.shape == (40, 30) and got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0] == 0 and got[1, 1] == 256


@pytest.mark.parametrize("width", [0, 3])
def test_set_drop_matches_xla_scatter_with_duplicates(rng, width):
    """Duplicate indices keep the last update, as XLA's CPU scatter does;
    out-of-range ones (mode="drop" sinks) are dropped."""
    shape = (50,) + ((width,) if width else ())
    arr = rng.normal(0, 1, shape).astype(np.float32)
    idx = rng.integers(-3, 60, (8, 30)).astype(np.int32)     # many repeats, some sinks
    vals = rng.normal(0, 1, idx.shape + shape[1:]).astype(np.float32)
    # the port drops negative indices too; jnp would wrap them, so its
    # reference gets an out-of-range sink there instead
    idx_j = np.where(idx < 0, 99, idx)
    ref = np.asarray(jnp.asarray(arr).at[jnp.asarray(idx_j)].set(jnp.asarray(vals), mode="drop"))
    np.testing.assert_array_equal(set_drop(_t(arr), _t(idx), _t(vals)).numpy(), ref)


def test_top_k_tie_order_matches_lax(rng):
    x = rng.integers(0, 4, (5, 40)).astype(np.int32)          # many ties
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), 12)
    got_v, got_i = top_k(_t(x), 12)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))


def _two_views(rng, n=200):
    pts = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    T1 = np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(0, 0.05, 6).astype(np.float32))))
    T2 = np.asarray(jse3.se3_exp(jnp.asarray(
        np.array([0.3, 0.05, 0.02, 0.01, -0.03, 0.02], np.float32))))
    uv = []
    for T in (T1, T2):
        pc = pts @ T[:3, :3].T + T[:3, 3]
        uv.append(np.asarray(jproject(JCAM, jnp.asarray(pc))[0])
                  + rng.normal(0, 0.5, (n, 2)).astype(np.float32))
    # a few points behind the second camera fail the gates
    pts_bad = pts.copy()
    pts_bad[:10, 2] = -5.0
    return T1, T2, uv[0], uv[1], pts_bad


def test_triangulation_matches(rng):
    T1, T2, uv1, uv2, pts = _two_views(rng)
    P1 = np.asarray(jtri.projection_matrix(JCAM.K, jnp.asarray(T1)))
    P2 = np.asarray(jtri.projection_matrix(JCAM.K, jnp.asarray(T2)))
    K = tri.camera_matrix(TCAM, "cpu")
    np.testing.assert_array_equal(K.numpy(), np.asarray(JCAM.K))
    np.testing.assert_allclose(tri.projection_matrix(K, _t(T1)).numpy(), P1, rtol=1e-4,
                               atol=1e-4)
    ref = np.asarray(jtri.triangulate_linear_fast(jnp.asarray(uv1), jnp.asarray(uv2),
                                                  jnp.asarray(P1), jnp.asarray(P2)))
    got = tri.triangulate_linear_fast(_t(uv1), _t(uv2), _t(P1), _t(P2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    sig = np.full(len(uv1), 1.44, np.float32)
    args = (pts, T1, T2, uv1, uv2, sig, sig)
    ref_g = np.asarray(jtri.triangulation_gates(JCAM, *map(jnp.asarray, args)))
    got_g = tri.triangulation_gates(TCAM, *map(_t, args)).numpy()
    np.testing.assert_array_equal(got_g, ref_g)
    assert 0 < ref_g.sum() < len(ref_g)
    np.testing.assert_allclose(
        tri.parallax_cos(_t(pts), _t(T1), _t(T2)).numpy(),
        np.asarray(jtri.parallax_cos(*map(jnp.asarray, (pts, T1, T2)))), rtol=1e-4)


def make_ba_problem(rng, K=6, P=300, noise_px=0.3, stereo=True):
    """K cameras in an arc looking at a point cloud, every camera seeing
    every point (tests/test_bundle_adjust.py's problem)."""
    pts = rng.uniform(-2, 2, (P, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    poses = np.stack([np.asarray(jse3.se3_exp(jnp.asarray(np.array(
        [0.4 * k, 0.02 * k, 0.05 * k, 0.01 * k, -0.04 * k, 0.01 * k], np.float32) * 0.3)))
        for k in range(K)])
    obs_pt = np.tile(np.arange(P, dtype=np.int32), (K, 1))
    obs_uvr = np.zeros((K, P, 3), np.float32)
    for k in range(K):
        pc = pts @ poses[k][:3, :3].T + poses[k][:3, 3]
        uv = np.asarray(jproject(JCAM, jnp.asarray(pc))[0]) + rng.normal(
            0, noise_px, (P, 2)).astype(np.float32)
        ur = uv[:, 0] - CAM_ARGS["bf"] / pc[:, 2] if stereo else np.full(P, -1.0, np.float32)
        obs_uvr[k] = np.concatenate([uv, ur[:, None]], -1)
    return poses, pts, obs_pt, obs_uvr


def _perturb(rng, poses, sigma):
    out = poses.copy()
    for k in range(1, len(poses)):
        xi = rng.normal(0, sigma(k), 6).astype(np.float32)
        out[k] = np.asarray(jse3.se3_exp(jnp.asarray(xi))) @ out[k]
    return out


def _run_both(cam_j, cam_t, poses, pts, obs_pt, obs_uvr, obs_valid, kf_free, **kw):
    K, N = obs_pt.shape
    args = (poses, pts, obs_pt, obs_uvr, np.ones((K, N), np.float32), obs_valid, kf_free,
            np.ones(len(pts), bool))
    ref = jba.bundle_adjust(cam_j, *map(jnp.asarray, args), **kw)
    got = ba.bundle_adjust(cam_t, *map(_t, args), **kw)
    np.testing.assert_allclose(got.kf_Tcw.numpy(), np.asarray(ref.kf_Tcw), atol=1e-4)
    np.testing.assert_allclose(got.pt_pos.numpy(), np.asarray(ref.pt_pos), atol=1e-3)
    # inlier masks: equal away from the chi2 threshold
    res, _, _, is_st = ba._residuals(cam_t, got.kf_Tcw, got.pt_pos, _t(obs_pt), _t(obs_uvr),
                                     torch.ones(K, N))
    res = res * torch.tensor([1.0, 1.0, kw.get("ur_weight", 1.0) ** 0.5])
    chi2 = ba._chi2(res, torch.ones(K, N), is_st).numpy()
    th = np.where(is_st.numpy(), CHI2_STEREO, CHI2_MONO)
    edge = np.abs(chi2 - th) <= 0.01 * th
    diff = got.obs_inlier.numpy() != np.asarray(ref.obs_inlier)
    assert not (diff & ~edge).any()
    assert abs(float(got.mean_chi2) - float(ref.mean_chi2)) <= 1e-3 * max(
        1.0, float(ref.mean_chi2))
    return got


def _pose_err(T, T_gt):
    return float(np.linalg.norm(np.asarray(jse3.se3_log(jnp.asarray(T @ np.linalg.inv(T_gt))))))


def test_ba_recovers_perturbation(rng):
    K, P = 6, 300
    poses, pts, obs_pt, obs_uvr = make_ba_problem(rng, K, P, noise_px=0.0)
    poses_n = _perturb(rng, poses, lambda k: 0.01)
    pts_n = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
    res = _run_both(JCAM, TCAM, poses_n, pts_n, obs_pt, obs_uvr, np.ones((K, P), bool),
                    np.arange(K) > 0)
    for k in range(K):
        assert _pose_err(res.kf_Tcw.numpy()[k], poses[k]) < 1e-3
    assert np.abs(res.pt_pos.numpy() - pts).max() < 5e-3
    assert res.obs_inlier.numpy().mean() > 0.99


def test_ba_fixed_cameras_stay_fixed(rng):
    K, P = 4, 150
    poses, pts, obs_pt, obs_uvr = make_ba_problem(rng, K, P, noise_px=0.3)
    pts_n = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
    res = _run_both(JCAM, TCAM, poses, pts_n, obs_pt, obs_uvr, np.ones((K, P), bool),
                    np.array([False, False, True, True]))
    np.testing.assert_array_equal(res.kf_Tcw.numpy()[:2], poses[:2])


def test_ba_rejects_outlier_observations(rng):
    K, P = 4, 200
    poses, pts, obs_pt, obs_uvr = make_ba_problem(rng, K, P, noise_px=0.3)
    bad = rng.random((K, P)) < 0.05
    obs_uvr[bad] += 50.0
    res = _run_both(JCAM, TCAM, poses, pts, obs_pt, obs_uvr, np.ones((K, P), bool),
                    np.arange(K) > 0)
    inl = res.obs_inlier.numpy()
    assert inl[bad].mean() < 0.05 and inl[~bad].mean() > 0.95
    for k in range(K):
        assert _pose_err(res.kf_Tcw.numpy()[k], poses[k]) < 5e-3


def test_ba_mono_observations(rng):
    K, P = 5, 250
    poses, pts, obs_pt, obs_uvr = make_ba_problem(rng, K, P, noise_px=0.2, stereo=False)
    poses_n = _perturb(rng, poses, lambda k: 0.005)
    res = _run_both(JCAM, TCAM, poses_n, pts, obs_pt, obs_uvr, np.ones((K, P), bool),
                    np.arange(K) > 0)
    assert float(res.mean_chi2) < 0.5
    assert res.obs_inlier.numpy().mean() > 0.98


def test_ba_handles_missing_observations(rng):
    K, P = 4, 100
    poses, pts, obs_pt, obs_uvr = make_ba_problem(rng, K, P, noise_px=0.2)
    obs_pt[rng.random((K, P)) < 0.5] = -1
    res = _run_both(JCAM, TCAM, poses, pts, obs_pt, obs_uvr, np.ones((K, P), bool),
                    np.arange(K) > 0)
    assert np.all(np.isfinite(res.kf_Tcw.numpy())) and np.all(np.isfinite(res.pt_pos.numpy()))
    assert float(res.mean_chi2) < 1.0


@pytest.mark.parametrize("budget", [(3, 5), (5, 10)])
def test_ba_budget_converges_at_kitti_geometry(rng, budget):
    """KITTI geometry and feature density (12 keyframes, 2048 points): the
    shipped 3 + 5 budget and the reference's 5 + 10 both recover the
    ground truth to under 2 cm, in both packages."""
    kw = dict(fx=718.9, fy=718.9, cx=620.5, cy=188.0, bf=71.9, width=1241, height=376)
    cam_j, cam_t = JCam.create(**kw), CameraParams.create(**kw)
    K, P = 12, 2048
    pts = rng.uniform(-8, 8, (P, 3)).astype(np.float32)
    pts[:, 2] += 25.0
    poses = np.stack([np.asarray(jse3.se3_exp(jnp.asarray(np.array(
        [0.02 * k, 0.0, 1.0 * k, 0.0, 0.015 * k, 0.0], np.float32) * 0.3))) for k in range(K)])
    obs_pt = np.tile(np.arange(P, dtype=np.int32), (K, 1))
    obs_uvr = np.zeros((K, P, 3), np.float32)
    vis = np.zeros((K, P), bool)
    for k in range(K):
        pc = pts @ poses[k][:3, :3].T + poses[k][:3, 3]
        uv = np.asarray(jproject(cam_j, jnp.asarray(pc))[0]) + rng.normal(
            0, 0.5, (P, 2)).astype(np.float32)
        ur = uv[:, 0] - kw["bf"] / np.maximum(pc[:, 2], 1e-3)
        obs_uvr[k] = np.concatenate([uv, ur[:, None]], -1)
        vis[k] = ((pc[:, 2] > 1.0) & (uv[:, 0] >= 0) & (uv[:, 0] < 1241)
                  & (uv[:, 1] >= 0) & (uv[:, 1] < 376))
    poses_n = _perturb(rng, poses, lambda k: 0.003 * k)
    pts_n = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    res = _run_both(cam_j, cam_t, poses_n, pts_n, obs_pt, obs_uvr, vis, np.arange(K) > 0,
                    n_iters_pre=budget[0], n_iters_post=budget[1])
    err = max(_pose_err(res.kf_Tcw.numpy()[k], poses[k]) for k in range(1, K))
    assert err < 2e-2


def test_inv3x3_matches(rng):
    M = rng.normal(0, 1, (50, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(ba.inv3x3(_t(M)).numpy(), np.asarray(jba.inv3x3(jnp.asarray(M))),
                               rtol=1e-5, atol=1e-6)
