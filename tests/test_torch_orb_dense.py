"""The dense ORB entry points of the port against the JAX package:
extract / build_extractor (at tests/test_orb.py's sizes, both cell sizes,
and below the patch size, where orientation and BRIEF take their dense
forms), orientation.py, brief.py, detect.select_keypoints and the pyramid's
gaussian_blur / gaussian_kernel_1d / stack_slab.

Tolerances: those ROADMAP.md section C (2) states for extract_batch.  On the
CPU the JAX extract selects keypoints through its slab path; the port's
16-px cells go through the band path (select_keypoints_bands), which breaks
ties differently only when two pixels of one cell share a score.  Valid
keypoints are equal at level 0 and >= 99% equal overall (levels >= 1 inherit
the pyramid's last-ulp differences, which can flip a FAST test at its
threshold); on equal keypoints angles agree within 5e-5 rad and descriptors
within 3 bits in all (the JAX package's own budget, sample.py:41-50).  The
dense forms sum in another order than the JAX package's: angles within
5e-5 rad, blur within 1e-3 grey levels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.ops.orb import brief as jbrief
from self_commit_orb_slam2_tpu.ops.orb import detect as jdetect
from self_commit_orb_slam2_tpu.ops.orb import extractor as jextractor
from self_commit_orb_slam2_tpu.ops.orb import fast as jfast
from self_commit_orb_slam2_tpu.ops.orb import orientation as jorientation
from self_commit_orb_slam2_tpu.ops.orb import pyramid as jpyramid
from self_commit_orb_slam2_tpu.utils.synthetic import generate_sequence, value_noise_texture
from self_commit_orb_slam2_tpu_torch.ops import orb as orb_pkg
from self_commit_orb_slam2_tpu_torch.ops.orb import brief, detect, extractor, orientation, pyramid


@pytest.fixture(scope="module")
def frame():
    """A rendered 320x320 frame: the value-noise texture's flat patches would
    tie blurred BRIEF samples, so its bits flip on last-ulp differences."""
    return generate_sequence(n_frames=1, width=320, height=320, fx=260.0, seed=5).images[0]


@pytest.fixture(scope="module")
def texture():
    return value_noise_texture(np.random.default_rng(1), size=320, sharp_features=120)


def _bits_differ(a_u32, b_i32) -> int:
    x = np.bitwise_xor(np.asarray(a_u32, np.uint32), np.asarray(b_i32).view(np.uint32))
    return int(np.unpackbits(x.view(np.uint8)).sum())


def _angles_close(a, b, tol=5e-5):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64) - b)))).max() < tol


@pytest.mark.parametrize("n_features,n_levels,cell,shape", [
    (500, 8, 16, (240, 320)), (300, 1, 16, (320, 320)), (100, 2, 16, (240, 320)),
    (500, 8, 8, (240, 320)), (40, 2, 16, (46, 72)), (40, 2, 8, (60, 40))])
def test_extract_matches_jax(frame, n_features, n_levels, cell, shape):
    image = frame[100:100 + shape[0], 0:shape[1]].copy() if shape[0] < 100 else \
        frame[:shape[0], :shape[1]].copy()
    jcfg = jextractor.OrbConfig(n_features=n_features, n_levels=n_levels, cell_size=cell)
    cfg = extractor.OrbConfig(n_features=n_features, n_levels=n_levels, cell_size=cell)
    want = jextractor.build_extractor(jcfg)(jnp.asarray(image))
    ext = orb_pkg.build_extractor(cfg)
    got, slab = ext(torch.from_numpy(image), return_slab=True)
    assert got.capacity == want.capacity == cfg.feat_capacity()
    assert tuple(slab.shape) == (n_levels, *shape)
    xy_j, v_j, l_j = (np.asarray(x) for x in (want.xy, want.valid, want.level))
    xy_t, v_t, l_t = got.xy.numpy(), got.valid.numpy(), got.level.numpy()
    assert not v_t[sum(cfg.level_budgets()):].any()
    same = (xy_j == xy_t).all(1) & (v_j == v_t) & (l_j == l_t)
    lvl0 = v_j & (l_j == 0)
    assert lvl0.sum() >= 1
    assert same[lvl0].all() and (v_t[l_t == 0] == v_j[l_j == 0]).all()
    assert same.mean() >= 0.99
    m = same & v_j
    np.testing.assert_array_equal(got.response.numpy()[m & (l_j == 0)],
                                  np.asarray(want.response)[m & (l_j == 0)])
    assert _angles_close(np.asarray(want.angle)[m], got.angle.numpy()[m])
    assert _bits_differ(np.asarray(want.desc)[m], got.desc.numpy()[m]) <= 3


def test_dense_orientation_matches_jax(texture):
    img = texture[:96, :112].copy()
    rng = np.random.default_rng(2)
    xy = np.stack([rng.integers(16, 96, 60), rng.integers(16, 80, 60)], -1).astype(np.float32)
    a_j = jorientation.keypoint_angles(jnp.asarray(img), jnp.asarray(xy))
    a_t = orientation.keypoint_angles(torch.from_numpy(img), torch.from_numpy(xy))
    assert _angles_close(a_j, a_t.numpy())
    m_j = np.asarray(jorientation.angle_map(jnp.asarray(img)))
    m_t = orientation.angle_map(torch.from_numpy(img)).numpy()
    assert m_t.shape == (96, 112)
    # a correlation sums in another order: all but near-zero moments agree
    d = np.abs(np.angle(np.exp(1j * (m_j.astype(np.float64) - m_t))))
    assert np.mean(d < 5e-5) >= 0.999
    # the dense map and the per-keypoint forms give the same angles
    lin = xy[:, 1].astype(int) * 112 + xy[:, 0].astype(int)
    assert _angles_close(m_t.reshape(-1)[lin], a_t.numpy(), tol=1e-3)
    slab = np.stack([img, img[::-1].copy()])
    level = rng.integers(0, 2, 60).astype(np.int32)
    s_j = jorientation.keypoint_angles_slab(jnp.asarray(slab), jnp.asarray(xy), jnp.asarray(level))
    s_t = orientation.keypoint_angles_slab(torch.from_numpy(slab), torch.from_numpy(xy),
                                           torch.from_numpy(level))
    assert _angles_close(s_j, s_t.numpy())


def test_dense_brief_matches_jax(texture):
    img = np.array(jpyramid.gaussian_blur(jnp.asarray(texture[:80, :96])))
    rng = np.random.default_rng(3)
    xy = np.stack([rng.integers(0, 96, 80), rng.integers(0, 80, 80)], -1).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 80).astype(np.float32)
    d_j = jbrief.describe(jnp.asarray(img), jnp.asarray(xy), jnp.asarray(ang))
    d_t = brief.describe(torch.from_numpy(img), torch.from_numpy(xy), torch.from_numpy(ang))
    assert d_t.dtype == torch.int32 and tuple(d_t.shape) == (80, 8)
    np.testing.assert_array_equal(d_t.numpy().view(np.uint32), np.asarray(d_j))
    slab = np.stack([img, img[::-1].copy()])
    level = rng.integers(0, 2, 80).astype(np.int32)
    dims = [(80, 96), (60, 70)]
    s_j = jbrief.describe_slab(jnp.asarray(slab), jnp.asarray(xy), jnp.asarray(level),
                               jnp.asarray(ang), dims)
    s_t = brief.describe_slab(torch.from_numpy(slab), torch.from_numpy(xy),
                              torch.from_numpy(level), torch.from_numpy(ang), dims)
    np.testing.assert_array_equal(s_t.numpy().view(np.uint32), np.asarray(s_j))


@pytest.mark.parametrize("n_keep,cell", [(200, 16), (50, 8), (2000, 16)])
def test_select_keypoints_matches_jax(texture, n_keep, cell):
    img = jnp.asarray(texture[:200, :232])
    hi = jfast.nms3x3(jfast.fast_response(img, 20.0))
    lo = jfast.nms3x3(jfast.fast_response(img, 7.0))
    want = jax.jit(jdetect.select_keypoints, static_argnums=(2, 3))(hi, lo, n_keep, cell)
    got = detect.select_keypoints(torch.from_numpy(np.asarray(hi)),
                                  torch.from_numpy(np.asarray(lo)), n_keep, cell=cell)
    assert isinstance(got, detect.LevelKeypoints)
    for name in ("xy", "response", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_blur_kernel_and_slab_match_jax(texture):
    np.testing.assert_array_equal(pyramid.gaussian_kernel_1d(7, 2.0),
                                  jpyramid.gaussian_kernel_1d(7, 2.0))
    img = texture[:90, :130].copy()
    for shape in ((90, 130), (2, 90, 130)):
        x = np.broadcast_to(img, shape).copy()
        b_j = np.asarray(jpyramid.gaussian_blur(jnp.asarray(x)))
        b_t = pyramid.gaussian_blur(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(b_t, b_j, atol=1e-3)
    assert abs(b_t.mean() - img.mean()) < 1.0 and b_t.std() < img.std()
    levels = [img, img[:75, :108].copy(), img[:62, :90].copy()]
    s_j = jpyramid.stack_slab([jnp.asarray(lv) for lv in levels])
    s_t = pyramid.stack_slab([torch.from_numpy(lv) for lv in levels])
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
