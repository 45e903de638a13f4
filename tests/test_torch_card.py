"""Tests of the port that need an NVIDIA card (marker `card`).

They skip without one.  This file imports neither JAX nor the JAX package, so
on a machine without JAX it runs with the repository's conftest switched off:

    python -m pytest --noconftest -m card tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu_torch.ops.orb import fast_band, fast_nms

pytestmark = pytest.mark.card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _image(kind: str, h: int, w: int) -> np.ndarray:
    """Test images, made with numpy from a seed."""
    rng = np.random.default_rng(0)
    if kind == "blobs":  # smooth blobs + noise: corners of both polarities
        base = rng.uniform(0, 255, (h // 8 + 1, w // 8 + 1)).astype(np.float32)
        img = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
        return img + rng.normal(0, 12, img.shape).astype(np.float32)
    if kind == "noise":  # most pixels pass the kernels' pre-test
        return rng.uniform(0, 255, (h, w)).astype(np.float32)
    if kind == "constant":  # no pixel does
        return np.full((h, w), 93.0, np.float32)
    if kind == "plateaus":  # small integers in 3x3 plateaus: equal scores meet the NMS tie-break
        base = rng.integers(0, 5, (h // 3 + 1, w // 3 + 1)).astype(np.float32) * 16.0
        return np.kron(base, np.ones((3, 3), np.float32))[:h, :w]
    if kind == "signed zeros":  # -0 beside pixels that equal a threshold exactly
        return rng.choice(np.array([-0.0, 0.0, 7.0, 20.0, 27.0], np.float32), (h, w))
    raise ValueError(kind)


def _assert_band_kernel_equals_plain(cuda, img, H0p, dims, border=16, min_corners=100):
    img = torch.from_numpy(img).to(cuda)
    args = (20.0, 7.0, H0p, dims, border, len(dims))
    before = fast_band.kernel.launches
    got = fast_band.fast_nms_bands_hi_lo(img, *args)
    ref = fast_band.fast_bands_plain(img, *args)
    torch.cuda.synchronize()
    assert fast_band.kernel.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int((got[2] > 0).sum()) >= min_corners


@pytest.mark.parametrize("G,H0p,W0,L", [(8, 480, 640, 8), (6, 64, 200, 3)])
def test_fast_band_kernel_bitwise_equals_plain(cuda, G, H0p, W0, L):
    dims = tuple((round(H0p / 1.2**l), round(W0 / 1.2**l)) for l in range(L))
    _assert_band_kernel_equals_plain(cuda, _image("blobs", G * H0p, W0), H0p, dims)


@pytest.mark.parametrize("kind,min_corners", [("noise", 100), ("constant", 0),
                                              ("plateaus", 100), ("signed zeros", 100)])
def test_fast_band_kernel_bitwise_on_hard_images(cuda, kind, min_corners):
    H0p, W0 = 480, 640
    dims = tuple((round(H0p / 1.2**l), round(W0 / 1.2**l)) for l in range(8))
    _assert_band_kernel_equals_plain(cuda, _image(kind, 8 * H0p, W0), H0p, dims,
                                     min_corners=min_corners)


@pytest.mark.parametrize("H0p,W0,dims,border", [
    (96, 300, ((96, 300), (71, 170)), 16),   # level edges inside a tile
    (96, 300, ((96, 300), (71, 170)), 5),    # the mask 1 px off the scored border
    (64, 203, ((64, 203), (53, 169)), 16),   # a width that is no multiple of 4
    (48, 131, ((48, 131), (40, 109), (33, 91)), 3),
])
def test_fast_band_kernel_bitwise_at_level_edges(cuda, H0p, W0, dims, border):
    G = 2 * len(dims)
    for kind in ("noise", "plateaus"):
        _assert_band_kernel_equals_plain(cuda, _image(kind, G * H0p, W0), H0p, dims,
                                         border=border, min_corners=20)


def _assert_nms_kernel_equals_plain(cuda, img, min_corners=100):
    img = torch.from_numpy(img).to(cuda)
    before = fast_nms.kernel.launches
    got = fast_nms.fast_nms_hi_lo(img, 20.0, 7.0)
    ref = fast_nms.fast_nms_plain(img, 20.0, 7.0)
    torch.cuda.synchronize()
    assert fast_nms.kernel.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int((got[1] > 0).sum()) >= min_corners


@pytest.mark.parametrize("h,w", [(3840, 640), (97, 200)])
def test_fast_nms_kernel_bitwise_equals_plain(cuda, h, w):
    _assert_nms_kernel_equals_plain(cuda, _image("blobs", h, w))


@pytest.mark.parametrize("kind,h,w,min_corners", [
    ("noise", 3840, 640, 100), ("constant", 3840, 640, 0), ("plateaus", 3840, 640, 100),
    ("signed zeros", 960, 640, 100),
    ("noise", 97, 203, 100),      # a width that is no multiple of 4
    ("plateaus", 50, 131, 20), ("noise", 9, 9, 0), ("noise", 16, 128, 20),
    ("noise", 33, 257, 100),      # one pixel past a tile in both directions
])
def test_fast_nms_kernel_bitwise_on_hard_images(cuda, kind, h, w, min_corners):
    _assert_nms_kernel_equals_plain(cuda, _image(kind, h, w), min_corners=min_corners)


def test_fast_kernels_take_an_unaligned_base(cuda):
    """A view that starts 4 bytes into its storage is contiguous but not
    16-byte aligned: the kernels take their scalar loads and stores."""
    flat = torch.from_numpy(_image("noise", 1, 96 * 200 + 1)[0]).to(cuda)
    img = flat[1:].view(96, 200)
    assert img.is_contiguous() and img.data_ptr() % 16 != 0
    for a, b in zip(fast_nms.fast_nms_hi_lo(img, 20.0, 7.0),
                    fast_nms.fast_nms_plain(img, 20.0, 7.0)):
        assert torch.equal(a, b)
    args = (20.0, 7.0, 48, ((48, 200), (40, 167)), 16, 2)
    for a, b in zip(fast_band.fast_nms_bands_hi_lo(img, *args),
                    fast_band.fast_bands_plain(img, *args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cell_size,mapping", [(16, False), (8, True)])
def test_system_streams_on_card(cuda, cell_size, mapping):
    from self_commit_orb_slam2_tpu_torch.models.config import (
        Capacities, SlamConfig, TrackingConfig)
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse
    from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

    seq = generate_sequence(n_frames=13, width=320, height=240, fx=260.0, seed=5)
    cfg = SlamConfig(camera=CameraParams.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                                                bf=26.0, width=320, height=240),
                     orb=OrbConfig(n_features=500, cell_size=cell_size),
                     caps=Capacities(max_keyframes=64, max_points=16384, local_points=1024),
                     tracking=TrackingConfig(max_frames_between_kf=10))
    slam = System(cfg, enable_mapping=mapping, enable_loop_closing=False)
    assert slam.map.kf_Tcw.is_cuda
    slam.track_batch_rgbd(seq.images, seq.depths, seq.timestamps, chunk=4)
    _, est = slam.get_trajectory()
    assert slam.state == STATE_OK
    assert ate_rmse(est, seq.poses_gt) < 0.02


def test_mapping_pass_on_card_matches_cpu(cuda):
    """One local-mapping pass from the same map on the card and on the CPU.
    The card sums BA's normal equations (scatter-adds) and the matrix
    products in other orders, so poses agree to 1e-3 and the integer state
    (observations, culls) to all but a few entries at a float threshold;
    duplicate-index scatters pick the same winner on both."""
    from self_commit_orb_slam2_tpu_torch.models import local_mapping
    from self_commit_orb_slam2_tpu_torch.models import map_state as ms
    from self_commit_orb_slam2_tpu_torch.models.config import (
        Capacities, SlamConfig, TrackingConfig)
    from self_commit_orb_slam2_tpu_torch.models.system import System
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
    from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

    seq = generate_sequence(n_frames=9, width=320, height=240, fx=260.0, seed=5)
    cfg = SlamConfig(camera=CameraParams.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                                                bf=26.0, width=320, height=240),
                     orb=OrbConfig(n_features=500, cell_size=8),
                     caps=Capacities(max_keyframes=16, max_points=4096, local_points=512),
                     tracking=TrackingConfig(max_frames_between_kf=3))
    slam = System(cfg, enable_mapping=True, enable_loop_closing=False, device="cpu")
    slam.track_batch_rgbd(seq.images, seq.depths, seq.timestamps, chunk=4)
    m_cpu = slam.map
    kf = ms.latest_kf(m_cpu)
    m_gpu = type(m_cpu)(*(t.to(cuda) for t in m_cpu))
    ref = local_mapping._process(cfg, type(m_cpu)(*(t.clone() for t in m_cpu)), kf)
    got = local_mapping._process(cfg, m_gpu, kf.to(cuda))
    torch.cuda.synchronize()
    assert torch.allclose(got.kf_Tcw.cpu(), ref.kf_Tcw, atol=1e-3)
    obs_same = (got.kf_obs_pt.cpu() == ref.kf_obs_pt).float().mean()
    assert obs_same >= 0.999
    assert abs(int(got.pt_valid.sum()) - int(ref.pt_valid.sum())) <= 5
    assert int(got.n_culled) == int(ref.n_culled)
