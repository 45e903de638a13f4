"""The port's rectification module against the JAX package's.

The numpy half (radtan_distort, init_undistort_rectify_map, remap_bilinear,
StereoRectifier, load_rectification_from_settings) is a copy and must give
identical arrays.  remap_bilinear_torch is held against remap_bilinear_jnp:
the same floor, the same four clipped gathers zeroed outside the image, the
same order of weights, so the images agree bitwise or within one ulp (XLA may
contract a product and a sum), and the level-0 keypoints extracted from them
are exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.utils import rectify as jrectify
from self_commit_orb_slam2_tpu_torch.ops.orb import extractor
from self_commit_orb_slam2_tpu_torch.utils import rectify
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

W, H = 320, 240
K = np.array([[260.0, 0, W / 2], [0, 260.0, H / 2], [0, 0, 1.0]])


def _rotvec(v):
    th = np.linalg.norm(v)
    k = np.asarray(v) / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _grid(w, h):
    u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    return u, v


def _maps(kind):
    u, v = _grid(W, H)
    if kind == "translation":
        return u + 0.5, v + 0.25
    if kind == "outside":          # every source pixel lies outside the image
        return u + 1000.0, v
    if kind == "border":           # the left and top edges sample across the border
        return u - 0.5, v - 1.75
    if kind == "rotated":          # a mounting rotation with distortion
        D = np.array([-0.28, 0.07, 0.0002, 0.00002])
        return rectify.init_undistort_rectify_map(
            K, D, _rotvec([0.006, -0.012, 0.004]).T, K, W, H)
    raise ValueError(kind)


@pytest.fixture(scope="module")
def image():
    return generate_sequence(n_frames=1, width=W, height=H, fx=260.0, seed=7).images[0]


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("kind", ["translation", "outside", "border", "rotated"])
def test_remap_torch_matches_jnp_and_numpy(image, kind):
    mx, my = _maps(kind)
    ref = np.asarray(jrectify.remap_bilinear_jnp(jnp.asarray(image), jnp.asarray(mx),
                                                 jnp.asarray(my)))
    got = rectify.remap_bilinear_torch(torch.from_numpy(image), torch.from_numpy(mx),
                                       torch.from_numpy(my)).numpy()
    assert got.shape == ref.shape == (H, W) and got.dtype == np.float32
    assert _ulps(got, ref).max() <= 1
    np.testing.assert_allclose(got, rectify.remap_bilinear(image, mx, my), atol=1e-4)
    if kind == "outside":
        assert (got == 0).all()
    if kind == "translation":      # the mean of the four neighbours, weighted
        inner = (0.375 * image[:-1, :-1] + 0.375 * image[:-1, 1:]
                 + 0.125 * image[1:, :-1] + 0.125 * image[1:, 1:])
        np.testing.assert_allclose(got[:-1, :-1], inner, atol=1e-4)
    # a batch of images goes through the same maps
    both = rectify.remap_bilinear_torch(torch.from_numpy(np.stack([image, image[::-1].copy()])),
                                        torch.from_numpy(mx), torch.from_numpy(my))
    np.testing.assert_array_equal(both[0].numpy(), got)


def test_remapped_images_give_equal_level0_keypoints(image):
    mx, my = _maps("rotated")
    ref = np.asarray(jrectify.remap_bilinear_jnp(jnp.asarray(image), jnp.asarray(mx),
                                                 jnp.asarray(my)))
    got = rectify.remap_bilinear_torch(torch.from_numpy(image), torch.from_numpy(mx),
                                       torch.from_numpy(my))
    cfg = extractor.OrbConfig(n_features=500)
    feats, _ = extractor.extract_batch(torch.stack([got, torch.from_numpy(ref.copy())]), cfg)
    lvl0 = feats.valid & (feats.level == 0)
    assert int(lvl0[0].sum()) > 50
    assert torch.equal(lvl0[0], lvl0[1])
    assert torch.equal(feats.xy[0][lvl0[0]], feats.xy[1][lvl0[1]])


def test_numpy_copies_identical(rng, tmp_path):
    D = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.01])
    x, y = rng.normal(0, 0.3, 50), rng.normal(0, 0.3, 50)
    for a, b in zip(rectify.radtan_distort(x, y, D), jrectify.radtan_distort(x, y, D)):
        np.testing.assert_array_equal(a, b)
    R = _rotvec([0.01, -0.02, 0.005])
    P = np.array([[250.0, 0, 161.0, 0], [0, 250.0, 119.0, 0], [0, 0, 1, 0]])
    got = rectify.init_undistort_rectify_map(K, D, R, P, W, H)
    ref = jrectify.init_undistort_rectify_map(K, D, R, P, W, H)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    np.testing.assert_array_equal(rectify.remap_bilinear(img, *got),
                                  jrectify.remap_bilinear(img, *ref))
    cams = ({"K": K, "D": D, "R": R, "P": P}, {"K": K, "D": D[:4], "R": R.T, "P": P})
    a, b = rectify.StereoRectifier(*cams, W, H), jrectify.StereoRectifier(*cams, W, H)
    for x, y in zip(a.rectify(img, img[::-1]), b.rectify(img, img[::-1])):
        np.testing.assert_array_equal(x, y)

    def block(name, m):
        m = np.asarray(m, np.float64)
        data = ", ".join(repr(float(v)) for v in m.reshape(-1))
        return (f"{name}: !!opencv-matrix\n  rows: {m.shape[0]}\n  cols: {m.shape[1]}\n"
                f"  dt: d\n  data: [{data}]\n")

    text = "%YAML:1.0\nLEFT.width: 32\nLEFT.height: 24\n"
    for eye_name, cam in zip(("LEFT", "RIGHT"), cams):
        text += "".join(block(f"{eye_name}.{k}", np.atleast_2d(cam[k])) for k in "KDRP")
    path = tmp_path / "stereo.yaml"
    path.write_text(text)
    a = rectify.load_rectification_from_settings(str(path))
    b = jrectify.load_rectification_from_settings(str(path))
    for f in ("m1l", "m2l", "m1r", "m2r"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    (tmp_path / "plain.yaml").write_text("%YAML:1.0\nCamera.fx: 1.0\n")
    assert rectify.load_rectification_from_settings(str(tmp_path / "plain.yaml")) is None
