"""ORB extraction of the PyTorch port against the JAX package.

Tolerances and why:
  * pyramid levels: atol 1e-3 on 0..255 pixels.  Each resize is two fp32
    matmuls in both packages; levels >= 1 differ in the last ulp because the
    sums run in another order.
  * orient_and_describe: the JAX package's own budget (sample.py:41-50):
    <= 3 differing descriptor bits in total and angles within 5e-5 rad.  Its
    one-hot selectors run at bf16x3 precision, reproducing pixels within one
    ulp; the port gathers them exactly.
  * extract_batch: the JAX package on the CPU selects keypoints through the
    slab path, so the band path is composed here from its own functions
    (Pallas band kernel in interpret mode, select_keypoints_bands,
    orient_and_describe, the scale-back).  Valid keypoints are equal at level
    0, >= 99% equal overall (levels >= 1 inherit the pyramid's ulps, which
    can flip a FAST test at the threshold), descriptors within the budget on
    equal keypoints.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from self_commit_orb_slam2_tpu.ops.orb import detect as jdetect
from self_commit_orb_slam2_tpu.ops.orb import extractor as jextractor
from self_commit_orb_slam2_tpu.ops.orb import fast_pallas
from self_commit_orb_slam2_tpu.ops.orb import pyramid as jpyramid
from self_commit_orb_slam2_tpu.ops.orb import sample as jsample
from self_commit_orb_slam2_tpu.utils.synthetic import generate_sequence
from self_commit_orb_slam2_tpu_torch.ops.orb import extractor, pyramid, sample


def _desc_bits_differ(a_u32, b_i32) -> int:
    x = np.bitwise_xor(np.asarray(a_u32, np.uint32), np.asarray(b_i32).view(np.uint32))
    return int(np.unpackbits(x.view(np.uint8)).sum())


@pytest.fixture(scope="module")
def frames():
    return generate_sequence(n_frames=2, width=320, height=240, fx=260.0, seed=5).images


@pytest.mark.parametrize("shape", [(240, 320), (96, 160)])
def test_pyramid_matches(rng, shape):
    imgs = rng.uniform(0, 255, (2, *shape)).astype(np.float32)
    ref = jpyramid.stack_slab_batch(jpyramid.build_pyramid(jnp.asarray(imgs), 8, 1.2))
    got = pyramid.stack_slab_batch(pyramid.build_pyramid(torch.from_numpy(imgs), 8, 1.2))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3)
    assert pyramid.level_shapes(*shape, 8, 1.2) == jpyramid.level_shapes(*shape, 8, 1.2)


def test_orient_and_describe_matches(frames):
    slab = jpyramid.stack_slab_batch(jpyramid.build_pyramid(jnp.asarray(frames[:1]), 8, 1.2))[0]
    slab_np = np.asarray(slab)
    L, H0, W0 = slab_np.shape
    rng = np.random.default_rng(3)
    level = rng.integers(0, 4, 300).astype(np.int32)
    dims = jpyramid.level_shapes(H0, W0, 8, 1.2)
    hmax = np.asarray([dims[lv][0] for lv in level])
    wmax = np.asarray([dims[lv][1] for lv in level])
    xy = np.stack([rng.integers(16, wmax - 16), rng.integers(16, hmax - 16)], -1)
    xy = xy.astype(np.float32)
    a_ref, d_ref = jsample.orient_and_describe(slab, jnp.asarray(xy), jnp.asarray(level))
    a_got, d_got = sample.orient_and_describe(torch.from_numpy(slab_np),
                                              torch.from_numpy(xy),
                                              torch.from_numpy(level))
    dang = np.angle(np.exp(1j * (np.asarray(a_ref) - a_got.numpy())))
    assert np.abs(dang).max() < 5e-5
    assert _desc_bits_differ(d_ref, d_got.numpy()) <= 3


def _jax_band_extract(images, cfg):
    """extract_batch's band branch, composed from the JAX package's own
    functions (its CPU path would select through the slab instead)."""
    B, L = images.shape[0], cfg.n_levels
    levels = jpyramid.build_pyramid(jnp.asarray(images), L, cfg.scale_factor)
    dims = [tuple(l.shape[-2:]) for l in levels]
    H0, W0 = dims[0]
    slab = jpyramid.stack_slab_batch(levels).reshape(B * L, H0, W0)
    H0p = H0 + (-H0) % 16
    slab = jnp.pad(slab, ((0, 0), (0, H0p - H0), (0, 0)), mode="edge")
    with pltpu.force_tpu_interpret_mode():
        bands = fast_pallas.fast_nms_bands_hi_lo(
            slab.reshape(B * L * H0p, W0), cfg.fast_threshold_hi,
            cfg.fast_threshold_lo, H0p, tuple(dims[:L]), cfg.border, L)
    kps = jdetect.select_keypoints_bands(*bands, cfg.level_budgets() * B, B * L, H0p)
    ang, desc = jsample.orient_and_describe(slab, kps.xy, kps.level)
    lvl = kps.level % L
    xy = kps.xy * jnp.asarray(cfg.scale_factors())[lvl][:, None]
    return [np.asarray(x) for x in (xy, kps.response, ang, lvl, desc, kps.valid)]


def test_extract_batch_matches_band_path(frames):
    cfg = jextractor.OrbConfig(n_features=500)
    xy_j, r_j, a_j, l_j, d_j, v_j = _jax_band_extract(frames, cfg)
    feats, slab = extractor.extract_batch(torch.from_numpy(frames),
                                          extractor.OrbConfig(n_features=500))
    B, cap = frames.shape[0], sum(cfg.level_budgets())
    assert tuple(feats.xy.shape) == (B, cfg.feat_capacity(), 2)
    assert not feats.valid[:, cap:].any()

    def flat(x):
        x = x[:, :cap].numpy()
        return x.reshape(B * cap, *x.shape[2:])

    xy_t, r_t, a_t, l_t, d_t, v_t = map(flat, feats)
    same = (xy_j == xy_t).all(1) & (v_j == v_t) & (l_j == l_t)
    lvl0 = v_j & (l_j == 0)
    assert lvl0.sum() > 100
    assert same[lvl0].all() and (v_t[l_t == 0] == v_j[l_j == 0]).all()
    assert same.mean() >= 0.99
    m = same & v_j
    # responses: exact at level 0; ulp-level pixel differences above it
    np.testing.assert_array_equal(r_t[m & (l_j == 0)], r_j[m & (l_j == 0)])
    np.testing.assert_allclose(r_t[m], r_j[m], atol=1e-2)
    assert np.abs(np.angle(np.exp(1j * (a_j[m] - a_t[m])))).max() < 5e-5
    assert _desc_bits_differ(d_j[m], d_t[m]) <= 3
