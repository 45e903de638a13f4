"""Kernel B2 (FAST NMS) and the slab selection of the PyTorch port against
the JAX package.

The port's plain version (what its wrapper runs on a CPU tensor, and what the
CUDA kernel is held against on the card) must equal the Pallas kernel, run in
interpret mode, BITWISE: both accumulate the ring sums in the same order.
Against the JAX XLA chain (fast_response + nms3x3, per slice) it is equal
inside a 6-px margin of each slice: the kernel zeroes the image's 4-px
border, and on a stacked slab its ring reads cross slice edges there.
select_keypoints_slab is exact (same xy, response, level, validity) on the
same score maps.  extract_batch at cell_size 8 is held to the JAX package's
own CPU path (the XLA chain + select_keypoints_slab): level 0 exact, >= 99%
of keypoints equal overall (levels >= 1 inherit the pyramid's last-ulp
differences, test_torch_orb.py), descriptors within 3 bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from self_commit_orb_slam2_tpu.ops.orb import detect as jdetect
from self_commit_orb_slam2_tpu.ops.orb import extractor as jextractor
from self_commit_orb_slam2_tpu.ops.orb import fast as jfast
from self_commit_orb_slam2_tpu.ops.orb import fast_pallas
from self_commit_orb_slam2_tpu.ops.orb import pyramid as jpyramid
from self_commit_orb_slam2_tpu.utils.synthetic import generate_sequence
from self_commit_orb_slam2_tpu_torch.ops.orb import detect, extractor, fast_nms

THR_HI, THR_LO = 20.0, 7.0


def _image(rng, h, w):
    # smooth blobs + noise: corners of both polarities at both thresholds
    base = rng.uniform(0, 255, (h // 8 + 1, w // 8 + 1)).astype(np.float32)
    up = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
    return np.clip(up + rng.normal(0, 12, up.shape), 0, 255).astype(np.float32)


def _port(img):
    return [o.numpy() for o in fast_nms.fast_nms_hi_lo(torch.from_numpy(img), THR_HI, THR_LO)]


# (slices, slice height, width): two single images (W = 200 is not a multiple
# of 128) and a stacked slab of three 48x160 slices
SHAPES = [(1, 64, 128), (1, 96, 200), (3, 48, 160)]


@pytest.mark.parametrize("G,H,W", SHAPES)
def test_plain_bitwise_equals_pallas_interpret(rng, G, H, W):
    img = _image(rng, G * H, W)
    with pltpu.force_tpu_interpret_mode():
        ref = fast_pallas.fast_nms_hi_lo(jnp.asarray(img), THR_HI, THR_LO)
    got = _port(img)
    for name, a, b in zip(("hi", "lo"), ref, got):
        assert b.shape == (G * H, W)
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)
    assert (got[1] > 0).sum() > 50  # corners actually found


@pytest.mark.parametrize("G,H,W", SHAPES)
def test_plain_equals_jax_xla_chain_inside_margin(rng, G, H, W):
    img = _image(rng, G * H, W)
    got = [g.reshape(G, H, W) for g in _port(img)]
    x = jnp.asarray(img.reshape(G, H, W))
    for thr, b in zip((THR_HI, THR_LO), got):
        ref = np.asarray(jfast.nms3x3(jfast.fast_response(x, thr)))
        np.testing.assert_array_equal(b[:, 6:-6, 6:-6], ref[:, 6:-6, 6:-6])
        assert not b[0, :4].any() and not b[:, :, :4].any()  # the zeroed border


def test_wrapper_checks_inputs():
    img = torch.zeros((64, 64))
    with pytest.raises(ValueError):  # no kernel for this device, no fallback
        fast_nms.fast_nms_hi_lo(img.to("meta"), THR_HI, THR_LO)
    with pytest.raises(ValueError):
        fast_nms.fast_nms_hi_lo(img[None], THR_HI, THR_LO)
    with pytest.raises(ValueError):
        fast_nms.fast_nms_hi_lo(img.double(), THR_HI, THR_LO)
    fast_nms.fast_nms_hi_lo(img, THR_HI, THR_LO)
    assert fast_nms.kernel.launches == 0  # the CPU path never counts a launch


@pytest.mark.parametrize("cell", [8, 12])
@pytest.mark.parametrize("G", [1, 8, 16])
def test_select_keypoints_slab_exact(rng, cell, G):
    """Same score maps -> identical keypoints, the padded (invalid) rows too.
    H0 = 64, W0 = 100: 12-px cells pad both axes."""
    H0, W0, L = 64, 100, min(G, 4)
    img = _image(rng, G * H0, W0)
    hi, lo = (s.reshape(G, H0, W0) for s in _port(img))
    dims = list(jpyramid.level_shapes(H0, W0, L, 1.2)) * (G // L)
    budgets = [60, 40, 25, 12][:L] * (G // L)
    ref = jdetect.select_keypoints_slab(jnp.asarray(hi), jnp.asarray(lo), budgets, dims,
                                        cell=cell, border=16)
    got = detect.select_keypoints_slab(torch.from_numpy(hi), torch.from_numpy(lo), budgets,
                                       dims, cell=cell, border=16)
    for f in ("xy", "response", "level", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert np.asarray(ref.valid).sum() > 10 * G


def _desc_bits_differ(a_u32, b_i32) -> int:
    x = np.bitwise_xor(np.asarray(a_u32, np.uint32), np.asarray(b_i32).view(np.uint32))
    return int(np.unpackbits(x.view(np.uint8)).sum())


def test_extract_batch_cell8_matches_jax():
    frames = generate_sequence(n_frames=2, width=320, height=240, fx=260.0, seed=5).images
    jcfg = jextractor.OrbConfig(n_features=500, cell_size=8)
    ref, _ = jextractor.extract_batch(jnp.asarray(frames), jcfg)
    feats, _ = extractor.extract_batch(torch.from_numpy(frames),
                                       extractor.OrbConfig(n_features=500, cell_size=8))
    cap = sum(jcfg.level_budgets())

    def flat(x):
        x = np.asarray(x)[:, :cap]
        return x.reshape(-1, *x.shape[2:])

    xy_j, r_j, a_j, l_j, d_j, v_j = map(flat, ref)
    xy_t, r_t, a_t, l_t, d_t, v_t = (flat(x.numpy()) for x in feats)
    assert not feats.valid[:, cap:].any()
    same = (xy_j == xy_t).all(1) & (v_j == v_t) & (l_j == l_t)
    lvl0 = v_j & (l_j == 0)
    assert lvl0.sum() > 100
    assert same[lvl0].all() and (v_t[l_t == 0] == v_j[l_j == 0]).all()
    assert same.mean() >= 0.99
    m = same & v_j
    np.testing.assert_array_equal(r_t[m & (l_j == 0)], r_j[m & (l_j == 0)])
    np.testing.assert_allclose(r_t[m], r_j[m], atol=1e-2)
    assert np.abs(np.angle(np.exp(1j * (a_j[m] - a_t[m])))).max() < 5e-5
    assert _desc_bits_differ(d_j[m], d_t[m]) <= 3
