"""The two-view initializer of the PyTorch port against the JAX package,
with the same minimal sets in both.

The JAX package draws its sets from jax.random inside initialize_two_view;
the tests draw the same ones (`_sample_minimal_sets(split(key)[0], ...)`) and
hand them to the port through `sets`.  Tolerances and why:
  * eigenvectors and singular vectors carry an arbitrary sign (LAPACK here,
    XLA there): H and the all-inlier refits of H and F are compared up to
    sign at 1e-4 after scaling to unit norm.  An 8-point F is the null
    vector of a rank-8 9x9 A^T A taken in fp32: for many random sets its two
    smallest eigenvalues are close and the vector is ill-conditioned in
    either package, so minimal F's are held to a median of 5e-3 and the
    outcome they lead to is what counts.  The motion recovery fixes det(R)
    and tries both signs of t, so poses are compared directly;
  * the same model (H or F) and the same verdict in all four scenes of
    tests/test_two_view.py; n_good within 2% (fp32 sums in another order move
    a point across the 4 sigma^2 gate); Tcw2 within 1e-3 (unit translation);
    points within 1e-3 relative where both mark them triangulated;
  * triangulate_linear within 1e-4 relative;
  * a degenerate minimal set (one point repeated) gives a singular H: its
    inverse is NaN, it scores nothing, loses, and nothing raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.ops import se3 as jse3
from self_commit_orb_slam2_tpu.ops import triangulate as jtri
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.solvers import two_view as jtv
from self_commit_orb_slam2_tpu_torch.ops import triangulate as tri
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.solvers import two_view as tv

CAM_KW = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0)
JCAM, CAM = JCam.create(**CAM_KW), CameraParams.create(**CAM_KW)
N = 300


def _project(pts, T):
    pc = pts @ T[:3, :3].T + T[:3, 3]
    return np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                     CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], -1)


def _scene(kind: str):
    """The scenes of tests/test_two_view.py: (uv1, uv2, T2, key seed)."""
    rng = np.random.default_rng(0)
    xi = {"general": [0.5, 0.05, 0.1, 0.02, -0.04, 0.01],
          "planar": [0.4, 0.0, 0.05, 0.01, -0.05, 0.02],
          "rotation": [0.0, 0.0, 0.0, 0.02, -0.06, 0.01],
          "outliers": [0.5, 0.05, 0.1, 0.02, -0.04, 0.01]}[kind]
    if kind == "planar":
        xy = rng.uniform(-2, 2, (N, 2))
        pts = np.concatenate([xy, (4.0 + 0.1 * xy[:, 0] + 0.05 * xy[:, 1])[:, None]], -1)
    else:
        pts = rng.uniform(-2, 2, (N, 3))
        pts[:, 2] += 5.0 + (0 if kind == "rotation" else rng.uniform(0, 3, N))
    T2 = np.asarray(jse3.se3_exp(jnp.asarray(xi, jnp.float32)), np.float64)
    uv1 = _project(pts, np.eye(4)) + rng.normal(0, 0.3, (N, 2))
    uv2 = _project(pts, T2) + rng.normal(0, 0.3, (N, 2))
    if kind == "outliers":
        bad = rng.choice(N, 60, replace=False)
        uv2[bad] = rng.uniform(0, 640, (60, 2))
    seed = ["general", "planar", "rotation", "outliers"].index(kind)
    return uv1.astype(np.float32), uv2.astype(np.float32), T2, seed


def _both(uv1, uv2, valid, seed, **kw):
    key = jax.random.PRNGKey(seed)
    ref = jtv.initialize_two_view(JCAM, jnp.asarray(uv1), jnp.asarray(uv2),
                                  jnp.asarray(valid), key, **kw)
    sets = np.asarray(jtv._sample_minimal_sets(jax.random.split(key)[0], len(uv1),
                                               jnp.asarray(valid), 256))
    got = tv.initialize_two_view(CAM, torch.from_numpy(uv1), torch.from_numpy(uv2),
                                 torch.from_numpy(valid), sets=torch.from_numpy(np.array(sets)), **kw)
    return ref, got, sets


@pytest.mark.parametrize("kind,use_h,success", [("general", False, True),
                                                ("planar", True, True),
                                                ("rotation", None, False),
                                                ("outliers", False, True)])
def test_initialize_two_view_matches_jax(kind, use_h, success):
    uv1, uv2, T2, seed = _scene(kind)
    ref, got, _ = _both(uv1, uv2, np.ones(N, bool), seed)
    assert bool(got.success) == bool(ref.success) == success
    assert bool(got.used_homography) == bool(ref.used_homography)
    if use_h is not None:
        assert bool(got.used_homography) == use_h
    n_ref, n_got = int(ref.n_good), int(got.n_good)
    assert abs(n_got - n_ref) <= max(0.02 * n_ref, 1)
    assert got.n_good.dtype == torch.int32
    if not success:
        return
    np.testing.assert_allclose(got.Tcw2.numpy(), np.asarray(ref.Tcw2), atol=1e-3)
    g_ref, g_got = np.asarray(ref.is_triangulated), got.is_triangulated.numpy()
    assert (g_ref == g_got).mean() >= 0.98
    both = g_ref & g_got
    assert both.sum() > 150
    np.testing.assert_allclose(got.points.numpy()[both], np.asarray(ref.points)[both],
                               rtol=1e-3, atol=1e-3)
    # and the pose is the true one up to scale
    R_err = got.Tcw2.numpy()[:3, :3] @ T2[:3, :3].T
    assert np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)) < 0.02
    t_hat, t_true = got.Tcw2.numpy()[:3, 3], T2[:3, 3] / np.linalg.norm(T2[:3, 3])
    assert t_hat @ t_true > 0.95


def _unit(M):
    return M / np.linalg.norm(M.reshape(len(M), -1), axis=1)[:, None, None]


def _err_up_to_sign(got, ref):
    got, ref = _unit(np.asarray(got, np.float64)), _unit(np.asarray(ref, np.float64))
    return np.minimum(np.abs(got - ref).max((1, 2)), np.abs(got + ref).max((1, 2)))


def test_minimal_solvers_match_up_to_sign():
    uv1, uv2, _, seed = _scene("general")
    valid = np.ones(N, bool)
    n1, _ = jtv._normalize(jnp.asarray(uv1), jnp.asarray(valid))
    n2, _ = jtv._normalize(jnp.asarray(uv2), jnp.asarray(valid))
    t1, T1 = tv._normalize(torch.from_numpy(uv1), torch.from_numpy(valid))
    np.testing.assert_allclose(t1.numpy(), np.asarray(n1), atol=1e-5)
    sets = np.random.default_rng(1).integers(0, N, (64, 8))
    s1, s2 = np.asarray(n1)[sets], np.asarray(n2)[sets]
    for jsolve, solve in ((jtv._solve_h_batch, tv._solve_h_batch),
                          (jtv._solve_f_batch, tv._solve_f_batch)):
        err = _err_up_to_sign(solve(torch.from_numpy(s1), torch.from_numpy(s2)),
                              jsolve(jnp.asarray(s1), jnp.asarray(s2)))
        if solve is tv._solve_h_batch:   # 16 rows for 9 unknowns
            assert err.max() < 1e-4
        else:                            # 8 rows: see the module docstring
            assert np.median(err) < 5e-3
        w = (np.random.default_rng(2).random((1, N)) < 0.7).astype(np.float32)
        err = _err_up_to_sign(
            solve(torch.from_numpy(np.array(n1))[None], torch.from_numpy(np.array(n2))[None],
                  torch.from_numpy(w)),
            jsolve(n1[None], n2[None], jnp.asarray(w)))
        assert err.max() < 1e-4          # the all-inlier refit is well conditioned


def test_triangulate_linear_matches_jax(rng):
    uv1, uv2, T2, _ = _scene("general")
    Kj = JCAM.K
    P1 = np.asarray(jtri.projection_matrix(Kj, jnp.eye(4)))
    P2 = np.asarray(jtri.projection_matrix(Kj, jnp.asarray(T2, jnp.float32)))
    ref = np.asarray(jtri.triangulate_linear(jnp.asarray(uv1), jnp.asarray(uv2),
                                             jnp.asarray(P1), jnp.asarray(P2)))
    got = tri.triangulate_linear(torch.from_numpy(uv1), torch.from_numpy(uv2),
                                 torch.from_numpy(P1.copy()), torch.from_numpy(P2.copy())).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tri.projection_matrix(tri.camera_matrix(CAM, "cpu"),
                              torch.from_numpy(T2.astype(np.float32))).numpy(), P2, atol=1e-4)
    # batched projections broadcast against the points
    stacked = tri.triangulate_linear(torch.from_numpy(uv1), torch.from_numpy(uv2),
                                     torch.from_numpy(np.stack([P1, P1]))[:, None],
                                     torch.from_numpy(np.stack([P2, P2]))[:, None]).numpy()
    np.testing.assert_allclose(stacked[1], got, rtol=1e-5, atol=1e-5)


def test_degenerate_set_loses_and_does_not_raise():
    uv1, uv2, _, seed = _scene("general")
    valid = np.ones(N, bool)
    key = jax.random.PRNGKey(seed)
    sets = np.array(jtv._sample_minimal_sets(jax.random.split(key)[0], N,
                                             jnp.asarray(valid), 256))
    sets[0] = 17                     # hypothesis 0: one point, eight times
    sets[1, 4:] = sets[1, :4]        # hypothesis 1: four points, twice each
    a, b, v = torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(valid)
    got = tv.initialize_two_view(CAM, a, b, v, sets=torch.from_numpy(sets))
    assert bool(got.success) and not bool(got.used_homography)
    # the repeated-point set itself: singular H, NaN inverse, zero score
    n1, T1 = tv._normalize(a, v)
    n2, T2 = tv._normalize(b, v)
    s = torch.from_numpy(sets[:2])
    H = torch.linalg.inv(T2) @ tv._solve_h_batch(n1[s], n2[s]) @ T1
    scores, inl = tv._score_h(H, tv._inv_or_nan(H), a, b, v)
    assert torch.isfinite(scores).all() and float(scores[0]) < 0.05 * 2 * 5.991 * N
    # no valid correspondence at all: uniform draws, every hypothesis loses
    none = tv.initialize_two_view(CAM, a, b, torch.zeros(N, dtype=torch.bool),
                                  torch.Generator().manual_seed(0))
    assert not bool(none.success) and int(none.n_good) == 0


def test_drawn_sets_come_from_valid_rows():
    valid = torch.zeros(N, dtype=torch.bool)
    valid[::7] = True
    g = torch.Generator().manual_seed(3)
    sets = tv._sample_minimal_sets(valid, 256, g)
    assert tuple(sets.shape) == (256, 8) and bool(valid[sets].all())
    again = tv._sample_minimal_sets(valid, 256, torch.Generator().manual_seed(3))
    assert torch.equal(sets, again)
