"""The device ray cast against the frozen numpy `Scene.render`, and the
frozen room against the port's (same seed, same textures)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from slambench.scene import cast, room

K = np.array([[517.306408 / 4, 0, 318.643040 / 4], [0, 516.469215 / 4, 255.313989 / 4],
              [0, 0, 1.0]])


@pytest.fixture(scope="module")
def scene():
    return room.make_room(np.random.default_rng(2024))


@pytest.mark.parametrize("frame", [0, 37, 101])
def test_cast_matches_the_numpy_render(scene, frame):
    """Tolerance: both cast rays in float64 and sum in another order, so a
    pixel whose texture coordinate lies within rounding of a texel edge may
    take the neighbouring texel pair; elsewhere the images agree to float32
    rounding of 0..255 values (1e-3), depth to float32 rounding."""
    T = room.lookat_trajectory(160)[frame]
    want_img, want_depth = scene.render(K, T, 160, 120)
    got_img, got_depth = cast.DeviceScene(scene, "cpu").render(K, T, 160, 120)
    got_img, got_depth = got_img.numpy(), got_depth.numpy()
    close = np.abs(got_img - want_img) <= 1e-3
    assert close.mean() >= 0.995
    assert np.abs(got_img - want_img).max() < 2.0
    np.testing.assert_allclose(got_depth, want_depth, rtol=1e-6, atol=1e-6)
    same_u8 = cast.to_u8(torch.from_numpy(got_img)).numpy() == want_img.astype(np.uint8)
    assert same_u8.mean() >= 0.999


def test_stereo_pair_right_eye(scene):
    """The right eye is the left one moved by the baseline along its x: the
    numpy render from that pose, and a scene point's disparity is fx b / z."""
    T = room.lookat_trajectory(160)[20]
    b = 0.1
    TR = cast.right_eye(T, b)
    want, _ = scene.render(K, TR, 160, 120)
    got, _ = cast.DeviceScene(scene, "cpu").render(K, TR, 160, 120)
    assert (np.abs(got.numpy() - want) <= 1e-3).mean() >= 0.995
    np.testing.assert_allclose(np.linalg.inv(TR)[:3, 3] - np.linalg.inv(T)[:3, 3],
                               np.linalg.inv(T)[:3, 0] * b, atol=1e-6)


def test_frozen_room_matches_the_port(scene):
    from self_commit_orb_slam2_tpu_torch.utils import synthetic

    theirs = synthetic.make_room(np.random.default_rng(2024))
    assert all(np.array_equal(a.texture, b.texture) and np.array_equal(a.origin, b.origin)
               for a, b in zip(scene.planes, theirs.planes))
    np.testing.assert_array_equal(room.lookat_trajectory(160), synthetic.lookat_trajectory(160))


def test_a_scaled_room_renders_the_pair_a_shorter_baseline_gives():
    """A room and trajectory scaled by k, seen with a baseline k times as
    long, give the images of the unscaled room with the shorter baseline
    (up to rounding at texel edges), and depth k times as deep."""
    from slambench.harness import frames

    k, b = 386.1448 / 71.8856, 0.1
    small, big = frames.scaled_room(2024), frames.scaled_room(2024, k)
    T, Tk = frames.trajectory("lookat", 160)[20], frames.trajectory("lookat", 160, k)[20]
    for eye, eye_k in ((T, Tk), (cast.right_eye(T, b), cast.right_eye(Tk, b * k))):
        img, depth = cast.DeviceScene(small, "cpu").render(K, eye, 160, 120)
        img_k, depth_k = cast.DeviceScene(big, "cpu").render(K, eye_k, 160, 120)
        same = cast.to_u8(img_k).numpy() == cast.to_u8(img).numpy()
        assert same.mean() >= 0.999
        np.testing.assert_allclose(depth_k.numpy(), depth.numpy() * k, rtol=1e-5, atol=1e-5)


def test_an_unknown_trajectory_is_refused():
    from slambench.harness import frames

    with pytest.raises(ValueError, match="no trajectory"):
        frames.trajectory("circle", 8)
