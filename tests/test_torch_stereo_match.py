"""The stereo matcher and the two-eye extraction of the PyTorch port against
the JAX package on the same numpy inputs.

Inputs: two stereo pairs of generate_sequence(stereo_baseline=0.1, seed=7)
at 320x240, quantized to 8 bits as the streamed path does, 500 features.  The
JAX package's extract_pair supplies keypoints, descriptors and pyramid slabs
to both matchers.

Tolerances and why:
  * the candidate search (Hamming table, masks, first-index argmin) is
    integer work and the patch fetch is exact selection in both packages, so
    the coarse match is identical;
  * a level-0 SAD sums 121 integer-valued fp32 terms: exact in any order, so
    on level-0-only input `valid` is equal and u_right / depth agree to the
    last ulps (XLA contracts scale * (x + delta) and bf / d differently:
    held to 1e-4 px and 1e-5 relative);
  * above level 0 the pixels are not integers, the two packages sum them in
    another order, two windows whose SADs tie to the last ulp can pick
    another k and delta moves in its last ulps: `valid` equal on >= 99% of
    rows, u_right within 0.02 px and depth within 1e-3 relative where both
    are valid;
  * extract_pair: both packages select through the slab path with 8-px
    cells; level 0 exact, >= 99% of keypoints equal above it (pyramid ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.ops.matching import stereo as jstereo
from self_commit_orb_slam2_tpu.ops.orb import extractor as jextractor
from self_commit_orb_slam2_tpu.ops.orb import pyramid as jpyramid
from self_commit_orb_slam2_tpu_torch.ops.matching import stereo
from self_commit_orb_slam2_tpu_torch.ops.orb import extractor
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

W, H, FX, BASELINE, N_FEAT = 320, 240, 260.0, 0.1, 500
BF = FX * BASELINE
JCFG = jextractor.OrbConfig(n_features=N_FEAT)
DIMS = jpyramid.level_shapes(H, W, JCFG.n_levels, JCFG.scale_factor)
SCALES = JCFG.scale_factors()
FIELDS = ("xy", "level", "desc", "valid")


@pytest.fixture(scope="module")
def eyes():
    seq = generate_sequence(n_frames=2, width=W, height=H, fx=FX, seed=7,
                            stereo_baseline=BASELINE)
    q = lambda a: np.clip(a, 0, 255).astype(np.uint8).astype(np.float32)  # noqa: E731
    return q(seq.images), q(seq.right_images)


@pytest.fixture(scope="module")
def pairs(eyes):
    """Per pair: the JAX package's features of both eyes and both slabs."""
    out = []
    for il, ir in zip(*eyes):
        fl, fr, sl, sr = jextractor.extract_pair(jnp.asarray(il), jnp.asarray(ir), JCFG)
        out.append(dict(
            l={f: np.asarray(getattr(fl, f)) for f in FIELDS},
            r={f: np.asarray(getattr(fr, f)) for f in FIELDS},
            slab_l=np.asarray(sl), slab_r=np.asarray(sr)))
    return out


def _jax_match(p):
    sm = jstereo.match_stereo(
        *(jnp.asarray(p["l"][f]) for f in FIELDS), *(jnp.asarray(p["r"][f]) for f in FIELDS),
        jnp.asarray(p["slab_l"]), jnp.asarray(p["slab_r"]), BF, BASELINE,
        jnp.asarray(SCALES), level_dims=DIMS)
    return tuple(np.asarray(x) for x in sm)


def _t(name, a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if name == "desc" else a)


def _port_match(ps):
    """The port's matcher on a list of pairs, as one batch."""
    side = lambda s: [torch.stack([_t(f, p[s][f]) for p in ps]) for f in FIELDS]  # noqa: E731
    sm = stereo.match_stereo(
        *side("l"), *side("r"),
        torch.stack([_t("slab", p["slab_l"]) for p in ps]),
        torch.stack([_t("slab", p["slab_r"]) for p in ps]),
        BF, BASELINE, torch.from_numpy(SCALES), DIMS)
    return tuple(x.numpy() for x in sm)


def _assert_close(got, ref, exact_valid: bool):
    ur_g, d_g, v_g = got
    ur_r, d_r, v_r = ref
    if exact_valid:
        np.testing.assert_array_equal(v_g, v_r)
    else:
        assert (v_g == v_r).mean() >= 0.99
    both = v_g & v_r
    tol_px, tol_rel = (1e-4, 1e-5) if exact_valid else (0.02, 1e-3)
    np.testing.assert_allclose(ur_g[both], ur_r[both], atol=tol_px, rtol=0)
    np.testing.assert_allclose(d_g[both], d_r[both], rtol=tol_rel)
    # unmatched rows carry the -1 sentinels
    assert (ur_g[~v_g] == -1).all() and (d_g[~v_g] == -1).all()
    return both


def test_single_pair_matches_jax(pairs):
    ref = _jax_match(pairs[0])
    got = tuple(x[0] for x in _port_match(pairs[:1]))
    both = _assert_close(got, ref, exact_valid=False)
    assert both.sum() > 100
    assert (pairs[0]["l"]["level"][both] > 0).sum() > 20   # higher octaves are covered


def test_batch_of_two_matches_jax_and_single(pairs):
    got = _port_match(pairs)
    for b, p in enumerate(pairs):
        _assert_close(tuple(x[b] for x in got), _jax_match(p), exact_valid=False)
        alone = _port_match([p])
        for x, y in zip(got, alone):      # a pair's result does not depend on its batch
            np.testing.assert_array_equal(x[b], y[0])


def _restrict(p, keep_l=None, keep_r=None):
    q = dict(p, l=dict(p["l"]), r=dict(p["r"]))
    if keep_l is not None:
        q["l"]["valid"] = p["l"]["valid"] & keep_l
    if keep_r is not None:
        q["r"]["valid"] = p["r"]["valid"] & keep_r
    return q


def test_level0_only_is_exact(pairs):
    p = _restrict(pairs[0], pairs[0]["l"]["level"] == 0, pairs[0]["r"]["level"] == 0)
    ref = _jax_match(p)
    got = tuple(x[0] for x in _port_match([p]))
    both = _assert_close(got, ref, exact_valid=True)
    assert both.sum() > 30


def test_rows_without_candidate(pairs):
    """No valid right keypoint: every table row is INVALID_DIST, argmin
    yields index 0 and the distance gate rejects it."""
    p = _restrict(pairs[0], keep_r=np.zeros_like(pairs[0]["r"]["valid"]))
    ref = _jax_match(p)
    got = tuple(x[0] for x in _port_match([p]))
    assert not ref[2].any() and not got[2].any()
    assert (got[0] == -1).all() and (got[1] == -1).all()


def test_fewer_than_five_matches_disable_the_median_cut(pairs):
    ref_all = _jax_match(pairs[0])
    keep = np.zeros_like(ref_all[2])
    keep[np.nonzero(ref_all[2])[0][:4]] = True
    p = _restrict(pairs[0], keep_l=keep)
    ref = _jax_match(p)
    got = tuple(x[0] for x in _port_match([p]))
    _assert_close(got, ref, exact_valid=False)
    # with n_ok < 5 the SAD of a match is not held against the median
    assert 1 <= got[2].sum() <= 4 and got[2].sum() == ref[2].sum()


def test_strip_clipped_at_the_right_edge(pairs):
    """Keypoints placed by hand 3 px from the right edge of their level: the
    21-wide strip start is clipped to lw - 21, and u_right is built from the
    clipped start (xr0 + SAD_HALF + k), not from the keypoint's column."""
    p0 = pairs[0]
    n = p0["l"]["xy"].shape[0]
    levels = np.array([0, 1, 3], np.int32)
    xy_l = np.zeros((n, 2), np.float32)
    xy_r = np.zeros((n, 2), np.float32)
    for i, lv in enumerate(levels):
        lh, lw = DIMS[lv]
        xy_l[i] = (np.float32(lw - 3) * SCALES[lv], np.float32(lh // 2) * SCALES[lv])
        xy_r[i] = (np.float32(lw - 6) * SCALES[lv], np.float32(lh // 2) * SCALES[lv])
    valid = np.arange(n) < len(levels)
    level = np.zeros(n, np.int32)
    level[:len(levels)] = levels
    desc = np.zeros((n, 8), np.uint32)
    desc[:len(levels)] = np.arange(1, len(levels) + 1, dtype=np.uint32)[:, None] * 0x01010101
    side = lambda xy: dict(xy=xy, level=level, desc=desc, valid=valid)  # noqa: E731
    p = dict(p0, l=side(xy_l), r=side(xy_r))
    ref = _jax_match(p)
    got = tuple(x[0] for x in _port_match([p]))
    np.testing.assert_array_equal(got[2], ref[2])
    assert got[2][:len(levels)].all()
    np.testing.assert_allclose(got[0], ref[0], atol=0.02, rtol=0)
    # the refined column stays inside the level even though sur + SLIDE does not
    for i, lv in enumerate(levels):
        for ur in (got[0][i], ref[0][i]):
            assert ur == -1 or ur / SCALES[lv] <= DIMS[lv][1] - 1


def test_extract_pair_matches_jax(eyes):
    il, ir = eyes[0][0], eyes[1][0]
    jcfg = jextractor.OrbConfig(n_features=N_FEAT, cell_size=8)
    cfg = extractor.OrbConfig(n_features=N_FEAT, cell_size=8)
    ref = jextractor.extract_pair(jnp.asarray(il), jnp.asarray(ir), jcfg)
    got = extractor.extract_pair(torch.from_numpy(il), torch.from_numpy(ir), cfg)
    for f_ref, f_got, s_ref, s_got in ((ref[0], got[0], ref[2], got[2]),
                                       (ref[1], got[1], ref[3], got[3])):
        np.testing.assert_allclose(s_got.numpy(), np.asarray(s_ref), atol=1e-3)
        np.testing.assert_array_equal(s_got[0].numpy(), np.asarray(s_ref[0]))
        xy_r, l_r, v_r = (np.asarray(getattr(f_ref, f)) for f in ("xy", "level", "valid"))
        xy_g, l_g, v_g = (getattr(f_got, f).numpy() for f in ("xy", "level", "valid"))
        same = (xy_r == xy_g).all(1) & (v_r == v_g) & (l_r == l_g)
        lvl0 = v_r & (l_r == 0)
        assert lvl0.sum() > 50 and same[lvl0].all()
        assert same[v_r].mean() >= 0.99
        x = np.bitwise_xor(np.asarray(f_ref.desc)[same & v_r],
                           f_got.desc.numpy().view(np.uint32)[same & v_r])
        assert int(np.unpackbits(x.view(np.uint8)).sum()) <= 3
    # with the default 16-px cells the pair is extract_batch at B = 2
    cfg16 = extractor.OrbConfig(n_features=N_FEAT)
    pair = extractor.extract_pair(torch.from_numpy(il), torch.from_numpy(ir), cfg16)
    feats, slabs = extractor.extract_batch(torch.from_numpy(np.stack([il, ir])), cfg16)
    for b in (0, 1):
        for x, y in zip(pair[b], feats):
            assert torch.equal(x, y[b])
        assert torch.equal(pair[2 + b], slabs[b])
