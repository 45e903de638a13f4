"""The rules the port's two FAST kernels (csrc/fast_common.cuh, fast_band.cu,
fast_nms.cu) rely on to score only what the inputs need, each held here on
the CPU through its plain mirror in ops/orb/fast.py and ops/orb/fast_band.py:

(a) the arc test by doubling equals the 8-step one on every 16-bit mask;
(b) a pixel the compass pre-test or the low threshold's arc test rejects has
    a zero FAST response at BOTH thresholds;
(c) the high threshold's ring masks are subsets of the low threshold's;
(d) the live-tile rule marks exactly the (band, strip) tiles that hold a
    pixel of the level mask, the plain version is zero on every other tile,
    and the positions a live tile scores cover all that the NMS of a valid
    pixel reads;
(e) both wrappers refuse thr_hi < thr_lo, for which (b) and (c) do not hold.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from self_commit_orb_slam2_tpu_torch.ops.orb import fast, fast_band, fast_nms, pyramid

THR_HI, THR_LO, BORDER = 20.0, 7.0, 16

# level dims of the main path's slab (480x640, 8 levels, scale 1.2)
CHUNK_DIMS = tuple(pyramid.level_shapes(480, 640, 8, 1.2))
# (G slices, H0p, W0, dims): one frame at the main path's dims, the card
# test's small slab, and levels whose edges fall inside a tile
SLABS = {
    "chunk dims": (8, 480, 640, CHUNK_DIMS),
    "small": (6, 64, 200, tuple((round(64 / 1.2**l), round(200 / 1.2**l)) for l in range(3))),
    "edges inside tiles": (4, 96, 300, ((96, 300), (71, 170))),
}


def _images():
    rng = np.random.default_rng(7)
    blobs = np.kron(rng.uniform(0, 255, (12, 16)), np.ones((8, 8)))
    yield "integers", np.round(np.clip(blobs + rng.normal(0, 12, blobs.shape), 0, 255))
    yield "non-integers", np.clip(blobs + rng.normal(0, 12, blobs.shape), 0, 255) / 1.7
    yield "uniform noise", rng.uniform(0, 255, (96, 128))
    yield "small plateaus", np.kron(rng.integers(0, 4, (24, 32)) * 9.0, np.ones((4, 4)))
    yield "near the thresholds", 100.0 + rng.choice(
        [-20.0, -7.0, 0.0, 7.0, 20.0, 7.000001, 19.999998], (96, 128))


IMAGES = {name: img.astype(np.float32) for name, img in _images()}


def test_arc_by_doubling_equals_arc_test_on_every_mask():
    bits = torch.arange(1 << 16, dtype=torch.int64)
    want = fast._has_arc(bits)
    assert torch.equal(fast.has_arc_doubling(bits), want)
    assert 0 < int(want.sum()) < 1 << 16
    # a 9-run across the wrap, and an 8-run
    assert bool(fast.has_arc_doubling(torch.tensor(0b1111100000001111)))
    assert not bool(fast.has_arc_doubling(torch.tensor(0b0000000011111111)))


def _assert_rejected_pixels_score_zero(img, thr_hi, thr_lo):
    bright, dark = fast.ring_masks(img, thr_lo)
    arc = fast._has_arc(bright) | fast._has_arc(dark)
    passed = fast.compass_pass(bright, dark)
    assert not bool((arc & ~passed).any()), "the pre-test rejected a pixel with a 9-arc"
    for thr in (thr_hi, thr_lo):
        resp = fast.fast_response(img, thr)
        assert not bool(resp[~passed].any())
        assert not bool(resp[~arc].any())
    return arc, passed


@pytest.mark.parametrize("name", IMAGES)
def test_rejected_pixels_score_zero_at_both_thresholds(name):
    img = torch.from_numpy(IMAGES[name])
    arc, passed = _assert_rejected_pixels_score_zero(img, THR_HI, THR_LO)
    if name != "small plateaus":
        assert int(arc.sum()) > 0  # the accepting side is exercised too
    assert int((~passed).sum()) > 0


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       scale=st.sampled_from([1e-3, 1.0, 255.0, 1e6, 3e38]),
       thr_lo=st.sampled_from([0.0, 1e-6, 7.0, 19.999998, 20.0]),
       gap=st.sampled_from([0.0, 1e-6, 13.0, 1e30]))
def test_rejected_pixels_score_zero_at_the_extremes(seed, scale, thr_lo, gap):
    rng = np.random.default_rng(seed)
    img = (rng.uniform(-1, 1, (24, 24)) * scale).astype(np.float32)
    img[rng.uniform(size=img.shape) < 0.3] = 0.0
    thr_hi = float(np.float32(thr_lo) + np.float32(gap))
    _assert_rejected_pixels_score_zero(torch.from_numpy(img), thr_hi, thr_lo)


@pytest.mark.parametrize("name", IMAGES)
def test_high_threshold_masks_are_subsets_of_low(name):
    img = torch.from_numpy(IMAGES[name])
    for hi_bits, lo_bits in zip(fast.ring_masks(img, THR_HI), fast.ring_masks(img, THR_LO)):
        assert not bool((hi_bits & ~lo_bits).any())
    assert int(fast.ring_masks(img, THR_LO)[0].sum()) > 0


def _tile_any(mask, wp):
    """[h, w] bool -> [h // 16, ceil(wp / 128)] bool: any pixel in the tile."""
    h, w = mask.shape
    n_strips = -(-wp // fast_band.STRIP)
    padded = np.zeros((h, n_strips * fast_band.STRIP), bool)
    padded[:, :w] = mask
    return padded.reshape(h // 16, 16, n_strips, fast_band.STRIP).any(axis=(1, 3))


@pytest.mark.parametrize("name", SLABS)
@pytest.mark.parametrize("border", [16, 5, 0])
def test_live_tile_rule_equals_level_mask(name, border):
    G, H0p, W0, dims = SLABS[name]
    if name == "chunk dims":
        G = 32  # the whole chunk: the rule is cheap
    h, args = G * H0p, (H0p, dims, border, len(dims))
    valid = fast_band.level_valid_mask(h, W0, *args, "cpu").numpy()
    live = fast_band.live_tiles(h, W0, *args)
    np.testing.assert_array_equal(live, _tile_any(valid, fast_band.out_width(W0)))
    assert live.any() and not live.all()
    if name == "chunk dims" and border == 16:
        # 472 of a frame's 1200 tiles are live
        assert int(live.sum()) == 4 * 472 and live.size == 4 * 1200


@pytest.mark.parametrize("name", SLABS)
def test_plain_version_is_zero_on_skipped_tiles(name):
    G, H0p, W0, dims = SLABS[name]
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.uniform(0, 255, (G * H0p, W0)).astype(np.float32))
    args = (H0p, dims, BORDER, len(dims))
    outs = fast_band.fast_bands_plain(img, THR_HI, THR_LO, *args)
    live = fast_band.live_tiles(G * H0p, W0, *args)
    dead = np.repeat(~live, fast_band.STRIP, axis=1)[:, :outs[0].shape[1]]
    assert dead.any()
    for out in outs:
        assert not out.numpy()[dead].any()
    assert int((outs[2] > 0).sum()) > 50  # and it is not zero everywhere


@pytest.mark.parametrize("name", SLABS)
@pytest.mark.parametrize("border", [16, 1])
def test_scored_positions_cover_what_the_nms_reads(name, border):
    G, H0p, W0, dims = SLABS[name]
    h, args = G * H0p, (H0p, dims, border, len(dims))
    valid = fast_band.level_valid_mask(h, W0, *args, "cpu")
    near = torch.nn.functional.max_pool2d(valid[None, None].float(), 3, 1, 1)[0, 0] > 0
    inner = fast_nms.inner_mask(h, W0, "cpu")
    scored = torch.from_numpy(fast_band.scored_mask(h, W0, *args))
    assert not bool((near & inner & ~scored).any())
    assert not bool((scored & ~inner).any())
    assert int(scored.sum()) < 1.2 * int((near & inner).sum())  # and little more


def test_wrappers_refuse_thresholds_out_of_order():
    img = torch.zeros((64, 64))
    dims = ((32, 64), (27, 53))
    with pytest.raises(ValueError, match="thr_hi >= thr_lo"):
        fast_nms.fast_nms_hi_lo(img, 7.0, 20.0)
    with pytest.raises(ValueError, match="thr_hi >= thr_lo"):
        fast_band.fast_nms_bands_hi_lo(img, 7.0, 20.0, 32, dims, BORDER, 2)
    with pytest.raises(ValueError, match="thr_hi >= thr_lo"):
        fast_nms.fast_nms_hi_lo(img, float("nan"), 7.0)
    fast_nms.fast_nms_hi_lo(img, 7.0, 7.0)  # equal thresholds are in order
    fast_band.fast_nms_bands_hi_lo(img, 7.0, 7.0, 32, dims, BORDER, 2)
