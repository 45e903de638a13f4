"""Kernel B1 (FAST band) of the PyTorch port against the JAX package.

The port's plain version (what its wrapper runs on a CPU tensor, and what the
CUDA kernel is held against on the card) must equal the Pallas kernel, run in
interpret mode, BITWISE: both accumulate the ring sums in the same order and
select the same first-row argmax.  Compared on the first W0 columns (the TPU
kernel pads its output to 128 lanes, the port to 16; the extra columns are
zero in both).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from self_commit_orb_slam2_tpu.ops.orb import detect as jdetect
from self_commit_orb_slam2_tpu.ops.orb import fast as jfast
from self_commit_orb_slam2_tpu.ops.orb import fast_pallas
from self_commit_orb_slam2_tpu.ops.orb import pyramid as jpyramid
from self_commit_orb_slam2_tpu_torch.ops.orb import detect, fast_band

THR_HI, THR_LO, BORDER = 20.0, 7.0, 16

# (G slices, H0p, W0, n_levels): W0 = 200 is not a multiple of 128, and
# G > n_levels stacks several frames' levels
SLABS = [(4, 64, 160, 2), (3, 48, 200, 2), (6, 64, 136, 3)]


def _level_dims(H0p, W0, L):
    return tuple(jpyramid.level_shapes(H0p, W0, L, 1.2))


def _slab(rng, G, H0p, W0):
    # smooth blobs + noise: corners of both polarities at both thresholds
    base = rng.uniform(0, 255, (G * H0p // 8 + 1, W0 // 8 + 1)).astype(np.float32)
    up = np.kron(base, np.ones((8, 8), np.float32))[:G * H0p, :W0]
    return np.clip(up + rng.normal(0, 12, up.shape), 0, 255).astype(np.float32)


def _pallas(img, H0p, dims, L):
    with pltpu.force_tpu_interpret_mode():
        out = fast_pallas.fast_nms_bands_hi_lo(jnp.asarray(img), THR_HI, THR_LO,
                                               H0p, dims, BORDER, L)
    return [np.asarray(o) for o in out]


def _port(img, H0p, dims, L):
    out = fast_band.fast_nms_bands_hi_lo(torch.from_numpy(img), THR_HI, THR_LO,
                                         H0p, dims, BORDER, L)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("G,H0p,W0,L", SLABS)
def test_plain_bitwise_equals_pallas_interpret(rng, G, H0p, W0, L):
    img = _slab(rng, G, H0p, W0)
    dims = _level_dims(H0p, W0, L)
    ref = _pallas(img, H0p, dims, L)
    got = _port(img, H0p, dims, L)
    assert got[0].shape == (G * H0p // 16, W0 + (-W0) % 16)
    for name, a, b in zip(("hi_max", "hi_arg", "lo_max", "lo_arg"), ref, got):
        np.testing.assert_array_equal(b[:, :W0], a[:, :W0], err_msg=name)
        assert not b[:, W0:].any(), name
    assert (got[2] > 0).sum() > 50  # corners actually found


def _jax_plain_bands(img, H0p, dims, L):
    """The JAX package's XLA chain (fast.py) + the kernel's masks + bands."""
    h, w = img.shape
    x = jnp.asarray(img)
    rows = np.arange(h)[:, None]
    cols = np.arange(w)[None, :]
    inb = (rows >= 4) & (rows < h - 4) & (cols >= 4) & (cols < w - 4)
    row_in = rows % H0p
    lvl = (rows // H0p) % L
    hr = np.asarray([d[0] for d in dims])[lvl]
    wr = np.asarray([d[1] for d in dims])[lvl]
    valid = ((row_in >= BORDER) & (row_in < hr - BORDER)
             & (cols >= BORDER) & (cols < wr - BORDER))
    out = []
    for thr in (THR_HI, THR_LO):
        s = jnp.where(inb, jfast.fast_response(x, thr), 0.0)
        s = np.asarray(jnp.where(valid, jfast.nms3x3(s), 0.0)).reshape(h // 16, 16, w)
        mx = s.max(1)
        out += [mx, np.argmax(s == mx[:, None], axis=1).astype(np.int32)]
    return out


@pytest.mark.parametrize("G,H0p,W0,L", SLABS[:2])
def test_plain_equals_jax_xla_chain(rng, G, H0p, W0, L):
    img = _slab(rng, G, H0p, W0)
    dims = _level_dims(H0p, W0, L)
    ref = _jax_plain_bands(img, H0p, dims, L)
    got = _port(img, H0p, dims, L)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b[:, :W0], a)


@pytest.mark.parametrize("G,H0p,W0,L", SLABS)
def test_select_keypoints_bands_exact(rng, G, H0p, W0, L):
    """Same band inputs -> identical xy, level, response and validity."""
    img = _slab(rng, G, H0p, W0)
    dims = _level_dims(H0p, W0, L)
    bands = _pallas(img, H0p, dims, L)
    budgets = [40, 25, 12][:L] * (G // L) + [40, 25, 12][:G % L]
    ref = jdetect.select_keypoints_bands(*[jnp.asarray(b) for b in bands],
                                         budgets, G, H0p)
    # the port's band arrays are 16-column aligned: crop the Pallas ones
    wp = W0 + (-W0) % 16
    got = detect.select_keypoints_bands(
        *[torch.from_numpy(np.ascontiguousarray(b[:, :wp])) for b in bands],
        budgets, G, H0p)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.level.numpy(), np.asarray(ref.level))
    np.testing.assert_array_equal(got.response.numpy(), np.asarray(ref.response))
    np.testing.assert_array_equal(got.xy.numpy()[valid], np.asarray(ref.xy)[valid])
    assert valid.sum() > G * 5


def test_wrapper_checks_inputs():
    img = torch.zeros((64, 64))
    dims = ((32, 64), (27, 53))
    with pytest.raises(ValueError):  # no kernel for this device, no fallback
        fast_band.fast_nms_bands_hi_lo(img.to("meta"), THR_HI, THR_LO, 32, dims, BORDER, 2)
    with pytest.raises(ValueError):  # slab height not a multiple of H0p
        fast_band.fast_nms_bands_hi_lo(img[:48], THR_HI, THR_LO, 32, dims, BORDER, 2)
    with pytest.raises(ValueError):
        fast_band.fast_nms_bands_hi_lo(img.double(), THR_HI, THR_LO, 32, dims, BORDER, 2)
    assert fast_band.kernel.launches == 0  # the CPU path never counts a launch
