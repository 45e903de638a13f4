"""Tests of the port that need an NVIDIA card (marker `card`).

They skip without one.  This file imports neither JAX nor the JAX package, so
on a machine without JAX it runs with the repository's conftest switched off:

    python -m pytest --noconftest -m card tests/test_torch_card.py
"""

import time

import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu_torch.ops.indexing import index_add_fixed
from self_commit_orb_slam2_tpu_torch.ops.orb import fast_band, fast_nms

pytestmark = pytest.mark.card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _device_launches(kernel) -> int:
    """The kernel's launches on the card: its wrapper's count, less the
    launches a CUDA graph capture only recorded, plus those graph replays
    made (models/program_graphs.py)."""
    from self_commit_orb_slam2_tpu_torch.models import program_graphs

    return (kernel.launches - program_graphs.LAUNCHES_AT_CAPTURE[kernel.name]
            + program_graphs.LAUNCHES_REPLAYED[kernel.name])


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


@pytest.mark.parametrize("kind", ["blobs", "noise", "plateaus"])
@pytest.mark.parametrize("H0,W0", [(376, 1241), (480, 752)])
def test_fast_band_kernel_bitwise_at_stereo_shapes(cuda, kind, H0, W0):
    """The stereo paths' slabs: both eyes of a pair, 16 slices.  376 rows
    are padded to 384 (the pad repeats the last row, as the extractor's
    does), and no row of a 1241-wide slab after the first is 16-byte
    aligned, so the kernel takes its scalar loads."""
    L, H0p = 8, H0 + (-H0) % 16
    dims = tuple((round(H0 / 1.2**l), round(W0 / 1.2**l)) for l in range(L))
    img = _image(kind, 2 * L * H0, W0).reshape(2 * L, H0, W0)
    img = img[:, np.minimum(np.arange(H0p), H0 - 1)].reshape(2 * L * H0p, W0)
    _assert_band_kernel_equals_plain(cuda, np.ascontiguousarray(img), H0p, dims)


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


# ---------------------------------------------- vocabulary, EPnP, relocalization


def _small_world(device):
    """A 320x240 System with a k=8, L=3 vocabulary trained on the sequence,
    after 14 mapped frames."""
    from self_commit_orb_slam2_tpu_torch.models.config import (
        Capacities, SlamConfig, TrackingConfig)
    from self_commit_orb_slam2_tpu_torch.models.system import System
    from self_commit_orb_slam2_tpu_torch.ops import bow
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig, extract_batch
    from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

    seq = generate_sequence(n_frames=16, width=320, height=240, fx=260.0, seed=5)
    feats, _ = extract_batch(torch.from_numpy(seq.images[0:16:4].astype(np.float32)),
                             OrbConfig(n_features=300))
    vocab = bow.train_vocabulary(feats.desc[feats.valid].numpy().view(np.uint32),
                                 k=8, L=3, seed=2)
    cfg = SlamConfig(camera=CameraParams.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                                                bf=26.0, width=320, height=240),
                     orb=OrbConfig(n_features=500),
                     caps=Capacities(max_keyframes=32, max_points=8192, local_points=1024),
                     tracking=TrackingConfig(max_frames_between_kf=8), vocab=vocab)
    slam = System(cfg, enable_mapping=True, enable_loop_closing=False, device=device)
    for i in range(14):
        slam.track_rgbd(seq.images[i], seq.depths[i], i / 30.0)
    return slam, seq


def test_transform_and_sparse_bow_on_card_equal_cpu(cuda):
    """Words, nodes and sparse ids exact (the bundled tree, random
    descriptors, T = 512 and the live cut at T = 64); weights within 1e-6."""
    from self_commit_orb_slam2_tpu_torch.ops import bow

    vocab = bow.load_vocabulary(bow.default_vocab_path())
    on_card = vocab.to(cuda)
    assert on_card.child_desc.is_cuda and on_card.device_bytes() == vocab.device_bytes()
    rng = np.random.default_rng(0)
    desc = torch.from_numpy(rng.integers(-2**31, 2**31, (1000, 8)).astype(np.int32))
    valid = torch.from_numpy(rng.random(1000) < 0.9)
    words, nodes = bow.transform(vocab, desc, valid)
    words_c, nodes_c = bow.transform(on_card, desc.to(cuda), valid.to(cuda))
    assert torch.equal(words_c.cpu(), words) and torch.equal(nodes_c.cpu(), nodes)
    for T in (512, 64):
        ids, vals = bow.sparse_bow(vocab, words, T)
        ids_c, vals_c = bow.sparse_bow(on_card, words_c, T)
        assert torch.equal(ids_c.cpu(), ids)
        assert torch.allclose(vals_c.cpu(), vals, rtol=0, atol=1e-6)


def test_transform_first_minimum_on_card(cuda):
    """Equal Hamming distances are common in the descent: a node whose
    children are all one centre must send every query to the first, on the
    card as on the CPU."""
    from self_commit_orb_slam2_tpu_torch.ops import bow

    k = 10
    node_desc = np.zeros((1 + k, 8), np.uint32)
    node_desc[1:] = 0xFFFF0000
    children = np.full((1 + k, k), -1, np.int32)
    children[0] = np.arange(1, 1 + k)
    word_id = np.concatenate([[-1], np.arange(k)]).astype(np.int32)
    vocab = bow.from_arrays(node_desc, children, word_id, np.ones(k, np.float32), k, 1, k, 0)
    rng = np.random.default_rng(1)
    desc = torch.from_numpy(rng.integers(-2**31, 2**31, (4096, 8)).astype(np.int32))
    valid = torch.ones(4096, dtype=torch.bool)
    words, nodes = bow.transform(vocab.to(cuda), desc.to(cuda), valid.to(cuda))
    assert int(words.max()) == 0 and int(nodes.min()) == int(nodes.max()) == 1


def test_epnp_eigh_shapes_on_card_match_cpu(cuda):
    """1280 sets of 12 exact correspondences: the three batched symmetric
    eigenproblems ([1280, 3, 3], [1280, 12, 12], [1280, 4, 4]; float64
    Jacobi since the relocalization graphs) run on the card give R and t
    within 1e-3 of the CPU's on at least 99% of the sets (the rest are sets
    whose 12x12 kernel vector is badly separated)."""
    from self_commit_orb_slam2_tpu_torch.ops import se3
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
    from self_commit_orb_slam2_tpu_torch.ops.solvers import epnp

    cam = CameraParams.create(fx=450.0, fy=450.0, cx=320.0, cy=240.0)
    rng = np.random.default_rng(2)
    T = se3.se3_exp(torch.tensor([0.4, -0.2, 0.6, 0.15, -0.1, 0.2])).numpy()
    pts = rng.uniform(-3, 3, (1280, 12, 3)).astype(np.float32)
    pts[..., 2] += 8.0
    pc = pts @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([450.0 * pc[..., 0] / pc[..., 2] + 320.0,
                   450.0 * pc[..., 1] / pc[..., 2] + 240.0], -1).astype(np.float32)
    R, t = epnp._epnp_solve(torch.from_numpy(pts), torch.from_numpy(uv), cam)
    Rc, tc = epnp._epnp_solve(torch.from_numpy(pts).to(cuda), torch.from_numpy(uv).to(cuda), cam)
    err = torch.maximum((Rc.cpu() - R).abs().amax(dim=(1, 2)), (tc.cpu() - t).abs().amax(dim=1))
    assert float((err <= 1e-3).float().mean()) >= 0.99, float(err.max())
    assert float((R - torch.from_numpy(T[:3, :3])).abs().amax(dim=(1, 2)).median()) < 1e-3


def test_zero_probability_rows_draw_on_card(cuda):
    """A row with no valid correspondence must not reach multinomial as all
    zeros: on the card that is a device-side assert that ends the context."""
    from self_commit_orb_slam2_tpu_torch.ops.solvers import epnp

    valid = torch.zeros(5, 1000, dtype=torch.bool, device=cuda)
    valid[1, 10:20] = True
    gen = torch.Generator(device=cuda).manual_seed(0)
    sets = epnp.draw_minimal_sets(valid, 256, 6, gen)
    torch.cuda.synchronize()
    assert sets.shape == (5, 256, 6) and int(sets.min()) >= 0 and int(sets.max()) < 1000
    assert int(sets[1].min()) >= 10 and int(sets[1].max()) < 20
    assert float(torch.ones(3, device=cuda).sum()) == 3.0   # the context is alive


def test_relocalize_on_card(cuda):
    """A mapped view recovers within 0.05 m of the engine's own earlier
    estimate; a blank frame fails without raising and leaves the context
    alive."""
    from self_commit_orb_slam2_tpu_torch.models import relocalization
    from self_commit_orb_slam2_tpu_torch.models.frame import make_frame_rgbd

    slam, seq = _small_world(cuda)
    assert slam.state == 1 and slam.n_keyframes() >= 2 and slam.config.vocab.node_desc.is_cuda
    assert int((slam.map.kf_bow_ids[0] >= 0).sum()) > 50

    def frame(image, depth):
        return make_frame_rgbd(slam.config, torch.from_numpy(image.astype(np.float32)).to(cuda),
                               torch.from_numpy(depth.astype(np.float32)).to(cuda))

    gen = torch.Generator(device=cuda).manual_seed(0)
    res = relocalization.relocalize(slam.config, slam.map, frame(seq.images[4], seq.depths[4]), gen)
    assert bool(res.success) and int(res.n_inliers) >= 50
    T, T4 = res.Tcw.cpu().numpy(), slam.trajectory[4][1]
    centre = lambda P: -P[:3, :3].T @ P[:3, 3]  # noqa: E731
    assert np.linalg.norm(centre(T) - centre(T4)) < 0.05
    res = relocalization.relocalize(slam.config, slam.map,
                                    frame(np.zeros_like(seq.images[0]),
                                          np.zeros_like(seq.depths[0])), gen)
    torch.cuda.synchronize()
    assert not bool(res.success) and int(res.n_inliers) == 0


def _stereo_inputs(device):
    """Both eyes of one 640x360 pair through the extractor on `device`."""
    from self_commit_orb_slam2_tpu_torch.ops.orb import extractor, pyramid
    from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

    seq = generate_sequence(n_frames=1, width=641, height=360, fx=400.0, seed=7,
                            stereo_baseline=0.1)
    cfg = extractor.OrbConfig(n_features=1000)
    eyes = np.stack([seq.images[0], seq.right_images[0]])
    eyes = torch.from_numpy(np.clip(eyes, 0, 255).astype(np.uint8).astype(np.float32))
    feats, slabs = extractor.extract_batch(eyes.to(device), cfg)
    args = ([getattr(feats, f)[:1] for f in ("xy", "level", "desc", "valid")]
            + [getattr(feats, f)[1:] for f in ("xy", "level", "desc", "valid")]
            + [slabs[:1], slabs[1:]])
    dims = pyramid.level_shapes(360, 641, cfg.n_levels, cfg.scale_factor)
    return args, torch.from_numpy(cfg.scale_factors()), dims


def test_match_stereo_on_card_matches_cpu(cuda):
    """The same keypoints and slabs through match_stereo on both devices:
    the coarse search is integer work, level-0 SADs are exact, above it the
    sums run in another order (valid equal on >= 99.5%, u_right within
    0.02 px, depth within 1e-3 relative)."""
    from self_commit_orb_slam2_tpu_torch.ops.matching import stereo

    args, scales, dims = _stereo_inputs(cuda)
    bf, b = 40.0, 0.1
    got = stereo.match_stereo(*args, bf, b, scales.to(cuda), dims)
    ref = stereo.match_stereo(*(a.cpu() for a in args), bf, b, scales, dims)
    v_g, v_r = got.valid[0].cpu(), ref.valid[0]
    assert float((v_g == v_r).float().mean()) >= 0.995
    both = v_g & v_r
    assert int(both.sum()) > 200
    assert float((got.u_right[0].cpu() - ref.u_right[0])[both].abs().max()) <= 0.02
    torch.testing.assert_close(got.depth[0].cpu()[both], ref.depth[0][both], rtol=1e-3, atol=0)
    lvl0 = both & (args[1][0].cpu() == 0)
    assert torch.equal(got.u_right[0].cpu()[lvl0], ref.u_right[0][lvl0])


def test_initialize_two_view_on_card_matches_cpu(cuda):
    """The same correspondences and minimal sets on both devices: the same
    model and verdict, n_good within 2%, pose within 1e-3; a degenerate set
    and an empty problem lose on the card too, and do not raise."""
    from self_commit_orb_slam2_tpu_torch.ops import se3
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
    from self_commit_orb_slam2_tpu_torch.ops.solvers import two_view

    n = 600
    rng = np.random.default_rng(0)
    cam = CameraParams.create(fx=400.0, fy=400.0, cx=320.0, cy=240.0)
    T2 = se3.se3_exp(torch.tensor([0.5, 0.05, 0.1, 0.02, -0.04, 0.01])).double().numpy()
    for planar in (False, True):
        pts = rng.uniform(-2, 2, (n, 3))
        pts[:, 2] = (4.0 + 0.1 * pts[:, 0] + 0.05 * pts[:, 1] if planar
                     else pts[:, 2] + 5.0 + rng.uniform(0, 3, n))
        pc2 = pts @ T2[:3, :3].T + T2[:3, 3]
        uv1 = 400.0 * pts[:, :2] / pts[:, 2:] + [320.0, 240.0] + rng.normal(0, 0.3, (n, 2))
        uv2 = 400.0 * pc2[:, :2] / pc2[:, 2:] + [320.0, 240.0] + rng.normal(0, 0.3, (n, 2))
        uv1 = torch.from_numpy(uv1.astype(np.float32))
        uv2 = torch.from_numpy(uv2.astype(np.float32))
        valid = torch.ones(n, dtype=torch.bool)
        sets = two_view._sample_minimal_sets(valid, 256, torch.Generator().manual_seed(1))
        sets[0] = 17                                  # a repeated-point set
        ref = two_view.initialize_two_view(cam, uv1, uv2, valid, sets=sets)
        got = two_view.initialize_two_view(cam, uv1.to(cuda), uv2.to(cuda), valid.to(cuda),
                                           sets=sets.to(cuda))
        assert bool(got.success) and bool(ref.success)
        assert bool(got.used_homography) == bool(ref.used_homography) == planar
        assert abs(int(got.n_good) - int(ref.n_good)) <= 0.02 * int(ref.n_good)
        torch.testing.assert_close(got.Tcw2.cpu(), ref.Tcw2, atol=1e-3, rtol=0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    none = two_view.initialize_two_view(cam, uv1.to(cuda), uv2.to(cuda),
                                        torch.zeros(n, dtype=torch.bool, device=cuda), gen)
    assert not bool(none.success) and int(none.n_good) == 0


@pytest.mark.parametrize("sensor", ["stereo", "mono"])
def test_stereo_and_mono_systems_stream_on_card(cuda, sensor):
    """A short stereo and a short mono run at 320x240 on the card: the band
    kernel once per extraction call (launched eagerly or from a frame-phase
    replay), STATE_OK, a sane trajectory."""
    from self_commit_orb_slam2_tpu_torch.models import config
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse
    from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

    n = 13
    stereo = sensor == "stereo"
    seq = generate_sequence(n_frames=n, width=320, height=240, seed=5,
                            stereo_baseline=0.1 if stereo else 0.0)
    cam = CameraParams.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                              bf=26.0 if stereo else 0.0, width=320, height=240)
    cfg = config.SlamConfig(
        camera=cam, orb=OrbConfig(n_features=700),
        caps=config.Capacities(max_keyframes=32, max_points=8192, local_points=1024),
        tracking=config.TrackingConfig(max_frames_between_kf=8, kf_ref_ratio_stereo=0.8),
        sensor=sensor)
    slam = System(cfg, enable_loop_closing=False)
    before = _device_launches(fast_band.kernel)
    if stereo:
        poses = slam.track_batch_stereo(seq.images, seq.right_images, seq.timestamps)
    else:
        poses = slam.track_batch_mono(seq.images, seq.timestamps)
    _, est = slam.get_trajectory()
    lag = n - len(est)
    assert slam.map.kf_Tcw.device.type == cuda.type
    assert slam.state == STATE_OK and lag <= (0 if stereo else 6)
    assert len(poses) == len(est) - 1
    assert _device_launches(fast_band.kernel) - before == (lag + 1) + -(-len(poses) // 4)
    assert ate_rmse(est, seq.poses_gt[lag:], with_scale=not stereo) < 0.05


# ------------------------------------------------------------------ loop closing


def _loop_config(**track):
    from self_commit_orb_slam2_tpu_torch.models.config import (
        Capacities, SlamConfig, TrackingConfig)
    from self_commit_orb_slam2_tpu_torch.ops import bow
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig

    return SlamConfig(camera=CameraParams.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                                                 bf=26.0, width=320, height=240),
                      orb=OrbConfig(n_features=500),
                      caps=Capacities(max_keyframes=24, max_points=4096, local_points=512),
                      tracking=TrackingConfig(max_frames_between_kf=3, **track),
                      vocab=bow.load_vocabulary(bow.default_vocab_path()))


def _loop_world(device, **track):
    """A System on `device` (the bundled vocabulary, mapping on, loop
    closing on) that streamed 36 frames of a spin, whose map then drifted
    along the chain (15 increments, 15 cm and 8 degrees at the start), and
    that re-initialized at frame 0 on that map and streamed 8 frames: a
    second branch revisiting the first keyframes, i.e. a loop (the
    construction of tests/test_torch_loop_closing.py, in the port alone)."""
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_NOT_INITIALIZED, System
    from self_commit_orb_slam2_tpu_torch.utils.drift import displace_old_content, se3_increment
    from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence, spin_trajectory

    seq = generate_sequence(n_frames=36, width=320, height=240, seed=9,
                            trajectory=spin_trajectory(36, frames_per_rev=72))
    slam = System(_loop_config(**track), device=device)
    slam.track_batch_rgbd(seq.images, seq.depths, seq.timestamps, chunk=4)
    newest = int(slam.map.n_kf) - 1
    D = se3_increment([0.01, 0.002, -0.0033, 0.0, 0.0093, 0.0])
    for j in range(15):
        slam.map = displace_old_content(slam.map, D, 1.0, keep_recent=newest - j)
    slam.carry, slam.state = None, STATE_NOT_INITIALIZED
    slam.track_batch_rgbd(seq.images[:8], seq.depths[:8], seq.timestamps[:8] + 10.0, chunk=4)
    return slam


def test_loop_stages_on_card_match_cpu(cuda):
    """detect_and_verify (the same minimal sets), correct_loop and
    optimize_pose_graph from one loop state on the card and on the CPU: the
    same candidate and found, counts within 2 / 3, poses within 1e-3 (the
    parity tests' bounds)."""
    from self_commit_orb_slam2_tpu_torch.models import loop_closing
    from self_commit_orb_slam2_tpu_torch.models import map_state as ms
    from self_commit_orb_slam2_tpu_torch.ops.optim.pose_graph import optimize_pose_graph

    slam = _loop_world("cpu")
    cfg, m = slam.config, slam.map
    kf = ms.latest_kf(m)
    slots, active, _ = loop_closing.loop_candidates(cfg, m, kf)
    sets = loop_closing.draw_hypotheses(loop_closing.bow_matches(m, kf, slots, active).valid,
                                        torch.Generator().manual_seed(0))
    m_c = type(m)(*(t.to(cuda) for t in m))
    ref = loop_closing.detect_and_verify(cfg, m, kf, sets=sets)
    got = loop_closing.detect_and_verify(cfg, m_c, kf.to(cuda), sets=sets.to(cuda))
    assert bool(ref.found) and bool(got.found) and int(got.cand_kf) == int(ref.cand_kf)
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 2
    assert abs(int(got.n_proj) - int(ref.n_proj)) <= 3
    assert torch.allclose(got.S_cur_cand.cpu(), ref.S_cur_cand, atol=2e-3)

    det_c = loop_closing.LoopDetection(*(x.to(cuda) for x in ref))
    want = loop_closing.correct_loop(cfg, m, kf, ref)
    corr = loop_closing.correct_loop(cfg, m_c, kf.to(cuda), det_c)
    assert torch.allclose(corr.kf_Tcw.cpu(), want.kf_Tcw, atol=1e-3)
    assert torch.allclose(corr.pt_pos.cpu(), want.pt_pos, atol=2e-3, rtol=1e-3)
    assert (corr.kf_obs_pt.cpu() == want.kf_obs_pt).float().mean() >= 0.999

    from self_commit_orb_slam2_tpu_torch.ops import sim3
    K = m.max_kf
    S0 = sim3.from_se3(m.kf_Tcw)
    i = torch.arange(1, K)
    args = (S0, torch.cat([i, torch.tensor([K - 1])]), torch.cat([i - 1, torch.tensor([0])]),
            torch.cat([sim3.compose(S0[1:], sim3.inverse(S0[:-1])), ref.S_cur_cand[None]]),
            torch.cat([m.kf_valid[1:] & m.kf_valid[:-1], torch.tensor([True])]),
            ~m.kf_valid | (torch.arange(K) == 0))
    g_ref = optimize_pose_graph(*args)
    g_got = optimize_pose_graph(*(a.to(cuda) for a in args))
    assert torch.allclose(g_got.kf_sim3.cpu(), g_ref.kf_sim3, atol=1e-3)


def test_streamed_loop_closure_on_card(cuda):
    """A System on the card with loop closing on (consistency 1) closes the
    loop of the revisiting branch inside a stream, runs its global BA and
    merges it, and keeps tracking."""
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK

    slam = _loop_world(cuda, loop_consistency_th=1)
    assert slam.map.kf_Tcw.is_cuda
    lc = slam._loop_closer
    assert lc.n_big_changes >= 1 and slam.map_changed()
    assert lc.last_gba_info.get("gba_path") == "dense" and lc.pending() == 0
    assert slam.state == STATE_OK
    _, est = slam.get_trajectory()
    assert np.all(np.isfinite(est)) and len(est) == 36 + 8


@pytest.mark.parametrize("cell_size,kernel", [(16, "fast_band"), (8, "fast_nms")])
def test_extract_on_card_launches_its_kernel_and_equals_cpu(cuda, cell_size, kernel):
    """The unbatched extract: at 16-px cells a card tensor reaches B1, at
    8-px cells B2, once each; the features equal the CPU's (the kernels are
    bitwise equal to the plain versions the CPU runs; the pyramid's matmuls
    may differ in the last ulp, so >= 99% of keypoints and level 0 exactly)."""
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig, extract
    from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

    img = torch.from_numpy(generate_sequence(n_frames=1, width=320, height=240, fx=260.0,
                                             seed=5).images[0])
    cfg = OrbConfig(n_features=500, cell_size=cell_size)
    kernels = {"fast_band": fast_band.kernel, "fast_nms": fast_nms.kernel}
    before = {k: v.launches for k, v in kernels.items()}
    got = extract(img.to(cuda), cfg)
    torch.cuda.synchronize()
    after = {k: v.launches - before[k] for k, v in kernels.items()}
    assert after == {k: int(k == kernel) for k in kernels}
    want = extract(img, cfg)
    same = (got.xy.cpu() == want.xy).all(1) & (got.valid.cpu() == want.valid)
    lvl0 = want.valid & (want.level == 0)
    assert int(lvl0.sum()) > 100 and bool(same[lvl0].all())
    assert float(same.float().mean()) >= 0.99


def test_native_decoder_builds_on_the_card_machine(tmp_path):
    """The native decoder (csrc/slamio.cc, g++ and zlib) builds where the
    port runs, and reads what the viewer's stdlib PNG writer writes."""
    from self_commit_orb_slam2_tpu_torch.utils import datasets, native_io, viewer

    if not torch.cuda.is_available():
        pytest.skip("checks the machine that holds the card")
    assert native_io.available(), native_io.build_error
    rng = np.random.default_rng(0)
    for name, arr in (("g8.png", rng.integers(0, 255, (48, 64), dtype=np.uint8)),
                      ("g16.png", rng.integers(0, 65535, (48, 64), dtype=np.uint16))):
        path = str(tmp_path / name)
        viewer.save_png(path, arr)
        before = datasets.DECODES["native"]
        np.testing.assert_array_equal(datasets._load_gray(path), arr.astype(np.float32))
        assert datasets.DECODES["native"] == before + 1


def _sharded_gba_map():
    """A small map (16 keyframes x 4096 points) streamed on the CPU, its
    poses and points perturbed by N(0, 5e-3)."""
    from self_commit_orb_slam2_tpu_torch.models.config import Capacities, SlamConfig
    from self_commit_orb_slam2_tpu_torch.models.system import System
    from self_commit_orb_slam2_tpu_torch.ops import se3
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
    from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

    cfg = SlamConfig(camera=CameraParams.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                                                bf=26.0, width=320, height=240),
                     orb=OrbConfig(n_features=300),
                     caps=Capacities(max_keyframes=16, max_points=4096), sensor="rgbd")
    seq = generate_sequence(n_frames=20, width=320, height=240, seed=3)
    slam = System(cfg, enable_loop_closing=False, device="cpu")
    slam.track_batch_rgbd(seq.images, seq.depths, seq.timestamps, chunk=4)
    rng = np.random.default_rng(0)
    m = slam.map
    kf = se3.update_left(m.kf_Tcw, torch.from_numpy(
        rng.normal(0, 5e-3, (m.max_kf, 6)).astype(np.float32)))
    kf[0] = m.kf_Tcw[0]
    return cfg, m._replace(kf_Tcw=kf, pt_pos=m.pt_pos + torch.from_numpy(
        rng.normal(0, 5e-3, tuple(m.pt_pos.shape)).astype(np.float32)))


def test_run_sharded_gba_on_card_matches_cpu(cuda):
    """loop_closing.run_sharded_gba (the distributed BA at a world of one
    rank) on the card equals the CPU within 1e-3."""
    from self_commit_orb_slam2_tpu_torch.models import loop_closing

    cfg, m = _sharded_gba_map()
    assert int(m.kf_valid.sum()) >= 3
    T_ref, p_ref = loop_closing.run_sharded_gba(cfg, m, 1)
    T, p = loop_closing.run_sharded_gba(cfg, type(m)(*(t.to(cuda) for t in m)), 1)
    assert T.is_cuda and p.is_cuda
    assert torch.allclose(T.cpu(), T_ref, atol=1e-3)
    assert torch.allclose(p.cpu(), p_ref, atol=1e-3)
    assert not torch.equal(T_ref, m.kf_Tcw)


def test_nccl_world_of_one(cuda, tmp_path):
    """hosts.initialize wires an NCCL group of one rank over a file://
    rendezvous; distributed BA and pose graph on a 1x1 mesh over it equal
    the same calls with no process group within 1e-6; the group tears down."""
    import torch.distributed as dist

    from self_commit_orb_slam2_tpu_torch.ops import sim3
    from self_commit_orb_slam2_tpu_torch.parallel import hosts
    from self_commit_orb_slam2_tpu_torch.parallel.distributed_ba import (
        distributed_bundle_adjust)
    from self_commit_orb_slam2_tpu_torch.parallel.distributed_pose_graph import (
        distributed_pose_graph)
    from self_commit_orb_slam2_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    cfg, m = _sharded_gba_map()
    m = type(m)(*(t.to(cuda) for t in m))
    obs_uvr = torch.cat([m.kf_xy, m.kf_uright[..., None]], dim=-1)
    ba_args = [x[None] for x in (m.kf_Tcw, m.pt_pos, m.kf_obs_pt, obs_uvr,
                                 torch.ones_like(m.kf_uright),
                                 m.kf_feat_valid & m.kf_valid[:, None],
                                 m.kf_valid & (torch.arange(m.max_kf, device=cuda) > 0),
                                 m.pt_valid)]
    K = m.max_kf
    S0 = sim3.from_se3(m.kf_Tcw)
    i = torch.arange(1, K, device=cuda)
    pg_args = [x[None] for x in (S0, i, i - 1, sim3.compose(S0[1:], sim3.inverse(S0[:-1])),
                                 m.kf_valid[1:] & m.kf_valid[:-1],
                                 ~m.kf_valid | (torch.arange(K, device=cuda) == 0))]
    ba_ref = distributed_bundle_adjust(make_mesh(MeshSpec(1, 1)), cfg.camera, *ba_args, n_iters=3)
    pg_ref = distributed_pose_graph(make_mesh(MeshSpec(1, 1)), *pg_args, n_iters=3)
    assert not dist.is_initialized()
    hosts.initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, timeout_s=120)
    try:
        assert dist.is_initialized() and "nccl" in str(dist.get_backend()).lower()
        x = torch.arange(4.0, device=cuda)
        dist.all_reduce(x)
        assert torch.equal(x, torch.arange(4.0, device=cuda))
        mesh = hosts.global_mesh()
        ba = distributed_bundle_adjust(mesh, cfg.camera, *ba_args, n_iters=3)
        pg = distributed_pose_graph(mesh, *pg_args, n_iters=3)
    finally:
        hosts.shutdown()
    assert not dist.is_initialized()
    for got, ref in zip((*ba, *pg), (*ba_ref, *pg_ref)):
        assert torch.allclose(got, ref, atol=1e-6)


def test_distributed_ba_repeats_bit_for_bit_at_a_world_of_one(cuda):
    """distributed_bundle_adjust twice from one state on a 1 x 1 mesh: the
    cross block and the per-point blocks are summed in a fixed order
    (indexing.index_add_fixed), so the two results are equal to the bit.
    tools/scaling_bench.py's problem with each point seen by ~8 keyframes
    (duplicate indices in every per-point sum)."""
    from self_commit_orb_slam2_tpu_torch.parallel.distributed_ba import (
        distributed_bundle_adjust)
    from self_commit_orb_slam2_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from self_commit_orb_slam2_tpu_torch.tools import scaling_bench

    problem = scaling_bench.build_problem(np.random.default_rng(0), scaling_bench.CAMERA, 32,
                                          256, 1024)
    inputs = scaling_bench.ba_inputs(problem, cuda)
    inputs = (inputs[0], inputs[1] + 0.01) + inputs[2:]   # start off the optimum
    mesh = make_mesh(MeshSpec(1, 1))
    a = distributed_bundle_adjust(mesh, scaling_bench.CAMERA, *inputs, n_iters=5)
    b = distributed_bundle_adjust(mesh, scaling_bench.CAMERA, *inputs, n_iters=5)
    for x, y in zip(a, b):
        assert x.is_cuda and torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert not torch.equal(a.pt_pos, inputs[1])


def _parent_index_add_fixed(target, index, source):
    """The sum as the helper made it before it dropped rows: index_add_
    under deterministic algorithms, every index in range."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return target.index_add_(0, index, source)
    finally:
        torch.use_deterministic_algorithms(before)


def _pass_sites(cuda, N: int, seed: int, K: int = 256, live: int = 17, window: int = 24,
                P: int = 4096):
    """The mapping pass's two sums at a cell's shape, with the arguments of
    both forms: refresh_observed_points' [K x N, 3] rows into N targets
    (each of `live` keyframes sees ~60 % of the new keyframe's points, at
    most once each; every other row dropped, ~236,000 of 256,000 at N =
    1000), and the local BA's [window x N, 30] rows into window x P
    (keyframe, point) targets, a third inactive.  site -> (new form, sink
    form) as functions of nothing."""
    g = torch.Generator().manual_seed(seed)
    tgt = torch.full((K, N), -1, dtype=torch.int64)
    for k in torch.randperm(K, generator=g)[:live].tolist():
        tgt[k] = torch.where(torch.rand(N, generator=g) < 0.6, torch.randperm(N, generator=g), -1)
    idx = tgt.reshape(-1).to(cuda)
    rays = torch.randn(K * N, 3, generator=g).to(cuda)
    hit = idx >= 0
    sink_idx, sink_rays = torch.where(hit, idx, N), torch.where(hit[:, None], rays, 0.0)

    pid = torch.randint(0, P, (window, N), generator=g)
    active = torch.rand(window, N, generator=g) > 0.33
    k = torch.arange(window)[:, None]
    flat = torch.where(active, k * P + pid, -1).reshape(-1).to(cuda)
    flat_sink = (k * (P + 1) + torch.where(active, pid, P)).reshape(-1).to(cuda)
    packed = torch.randn(window * N, 30, generator=g).to(cuda)
    f32 = torch.float32
    return {
        "refresh": (lambda: index_add_fixed(torch.zeros(N, 3, dtype=f32, device=cuda), 0,
                                            idx, rays),
                    lambda: _parent_index_add_fixed(
                        torch.zeros(N + 1, 3, dtype=f32, device=cuda), sink_idx,
                        sink_rays)[:N]),
        "grouping": (lambda: index_add_fixed(
                         torch.zeros(window * P, 30, dtype=f32, device=cuda), 0, flat, packed),
                     lambda: _parent_index_add_fixed(
                         torch.zeros(window * (P + 1), 30, dtype=f32, device=cuda), flat_sink,
                         packed).reshape(window, P + 1, 30)[:, :P].reshape(window * P, 30)),
    }


def _event_ms(fn, n: int = 5) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


@pytest.mark.parametrize("N", [1000, 2000])
def test_dropped_rows_sum_as_the_sink_form_bitwise_and_faster(cuda, N):
    """The pass's two sums at the cells' shapes (256 x 1000 rows on TUM1,
    256 x 2000 on KITTI, 17 live keyframes): index_add_fixed with dropped
    rows equals the sink form it replaced to the bit, equals itself from run
    to run and from a CUDA-graph replay, and the refresh's sum is at least
    10x faster than the sink form's (one run of ~236,000 rows walked by one
    warp there)."""
    for site, (new, sink) in _pass_sites(cuda, N, seed=N).items():
        a, b, ref = new(), new(), sink()
        torch.cuda.synchronize()
        assert torch.equal(a.view(torch.int32), ref.view(torch.int32)), site
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), site
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            new()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = new()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), a.view(torch.int32)), site
        new_ms, sink_ms = _event_ms(new), _event_ms(sink)
        print(f"[card] {site} at 256 x {N}: index_add_fixed {new_ms:.4f} ms, "
              f"sink form {sink_ms:.4f} ms ({sink_ms / new_ms:.1f}x)")
        if site == "refresh":
            assert sink_ms >= 10 * new_ms, (new_ms, sink_ms)
        del graph


def test_profile_stages_replays_equal_op_by_op(cuda):
    """tools/profile_stages.py at 320x240 / 500 features, both modes on one
    state: every stage replayed from its own graph equals the same stage op
    by op bitwise (plain index_add_ excepted: no fixed order), with 0 host
    syncs in a replay."""
    from self_commit_orb_slam2_tpu_torch.tools import profile_stages as tool

    st = tool.build_state(320, 240, 500, cuda)
    for mapping in (False, True):
        rows = tool.profile(st, mapping, n=2)
        table = tool.format_rows(rows, True)
        assert [r["name"] for r in rows] == list(tool.MAPPING if mapping else tool.MAIN)
        assert tool.failures(rows) == [], table
        assert all(r["bitwise"] for r in rows if r["exact"]), table
        assert all(r["graph"]["syncs"] == 0 for r in rows), table
    assert tool.sink_form_equal(st) == {"refresh_observed_points": True,
                                        "bundle_adjust": True}


# ------------------------------------------------------------------ step graphs


def _graph_setup(cuda, n_frames=25):
    """The slice files' 320x240 RGB-D configuration, a keyframe every 4
    frames at most, mapping on; a CUDA System (its StepGraph on)."""
    from self_commit_orb_slam2_tpu_torch.models.config import (
        Capacities, SlamConfig, TrackingConfig)
    from self_commit_orb_slam2_tpu_torch.models.system import System
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
    from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

    seq = generate_sequence(n_frames=n_frames, width=320, height=240, fx=260.0, seed=5)
    cfg = SlamConfig(camera=CameraParams.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                                                bf=26.0, width=320, height=240),
                     orb=OrbConfig(n_features=500),
                     caps=Capacities(max_keyframes=64, max_points=16384, local_points=1024),
                     tracking=TrackingConfig(max_frames_between_kf=4))
    slam = System(cfg, enable_mapping=True, enable_loop_closing=False)
    assert slam.step_graph is not None and slam.step_graph.graphed
    return cfg, seq, slam


def _clone_tree(x):
    return type(x)(*(v.clone() if torch.is_tensor(v) else _clone_tree(v) for v in x))


def _card_frame(cfg, seq, i, cuda):
    from self_commit_orb_slam2_tpu_torch.models.frame import make_frame_rgbd

    frame = make_frame_rgbd(cfg, torch.from_numpy(seq.images[i].astype(np.float32)).to(cuda),
                            torch.from_numpy(seq.depths[i].astype(np.float32)).to(cuda))
    return frame, torch.tensor(float(seq.timestamps[i]), device=cuda)


def test_step_graph_replays_equal_eager_from_cloned_states(cuda):
    """24 frames after the first.  Before each, the map and the carry are
    cloned and the frame runs through pipeline.track_step (op by op) on the
    clone, then through the System's StepGraph (replays) on the live state.
    The mapping pass sums with index_add_, so the bound is poses within
    1e-5 and inliers within 2 where the two are not bitwise; the keyframe
    decisions and the keyframes' frame ids are the same."""
    from self_commit_orb_slam2_tpu_torch.models import pipeline

    cfg, seq, slam = _graph_setup(cuda)
    slam.track_rgbd(seq.images[0], seq.depths[0], float(seq.timestamps[0]))
    sg = slam.step_graph
    n_kf_frames = 0
    for i in range(1, 25):
        frame, ts = _card_frame(cfg, seq, i, cuda)
        m_e, _, info_e = pipeline.track_step(cfg, _clone_tree(slam.map), _clone_tree(slam.carry),
                                             frame, ts, True)
        row_e = pipeline.pack_infos([info_e])[0].cpu().numpy()
        slam.map, slam.carry, row_g = sg.step(slam.map, slam.carry, frame, ts, True,
                                              slam._stream_gen)
        if not np.array_equal(row_e, row_g):
            assert np.abs(row_e[:32] - row_g[:32]).max() <= 1e-5, i
            assert abs(row_e[32] - row_g[32]) <= 2, i
        assert row_e[33] == row_g[33], i   # created_kf
        n_kf_frames += int(row_g[33] > 0.5)
        assert torch.equal(m_e.kf_valid, slam.map.kf_valid), i
        assert torch.equal(m_e.kf_frame_id, slam.map.kf_frame_id), i
        assert torch.allclose(m_e.kf_Tcw, slam.map.kf_Tcw, atol=1e-5), i
    assert n_kf_frames >= 3
    assert sg.captures == 1 and sg.replays == 24 + n_kf_frames
    assert bool(slam.carry.state_ok)


def test_step_core_and_tail_run_without_a_sync(cuda):
    """pipeline.step_core and pipeline.keyframe_tail op by op on the card, and
    a replay of the core graph, under torch.cuda.set_sync_debug_mode("error"):
    no operation in them waits for the card."""
    from self_commit_orb_slam2_tpu_torch.models import pipeline

    cfg, seq, slam = _graph_setup(cuda, n_frames=10)
    slam.track_batch_rgbd(seq.images[:9], seq.depths[:9], seq.timestamps[:9], chunk=4)
    assert slam.step_graph.captures == 1
    frame, ts = _card_frame(cfg, seq, 9, cuda)
    # a stream captures only its chunk graph: the per-frame parts now
    slam.step_graph.prepare(slam.map, slam.carry, frame, True, slam._stream_gen)
    m = _clone_tree(slam.map)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        core = pipeline.step_core(cfg, slam.map, slam.carry, frame)
        m2, _, _ = pipeline.keyframe_tail(cfg, m, core.carry, frame, core.lres.obs_pt,
                                          slam.carry.frame_id, ts, True, core.info)
        slam.step_graph._core()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(m2.n_kf) == int(slam.map.n_kf) + 1


def test_step_graph_replays_the_pose_kernel_and_no_lu(cuda):
    """A per-frame track_rgbd step: its core graph records one pose_opt
    launch for each pose_optimize call (the two motion hypotheses and the
    local map), each replay runs them, and a profiled replay of the core
    holds the kernel and no LU factorization (getrf) of the plain version
    (the tail's mapping pass solves its own systems)."""
    from self_commit_orb_slam2_tpu_torch.models import program_graphs
    from self_commit_orb_slam2_tpu_torch.ops.optim import pose_opt

    cfg, seq, slam = _graph_setup(cuda, n_frames=6)
    program_graphs.LAUNCHES_AT_CAPTURE.clear()
    program_graphs.LAUNCHES_REPLAYED.clear()
    before = pose_opt.kernel.launches
    on_card = pose_opt.device_launches()
    for i in range(3):
        slam.track_rgbd(seq.images[i], seq.depths[i], float(seq.timestamps[i]))
    sg = slam.step_graph
    core = sg.per_replay["core"]["pose_opt"]
    assert core >= 3 and program_graphs.LAUNCHES_AT_CAPTURE["pose_opt"] >= core
    assert program_graphs.LAUNCHES_REPLAYED["pose_opt"] == core * sg.part_replays["core"]
    # the host's arithmetic is what the card counted
    assert pose_opt.device_launches() - on_card == _device_launches(pose_opt.kernel) - before
    frame, _ = _card_frame(cfg, seq, 3, cuda)
    sg.prepare(slam.map, slam.carry, frame, True, slam._stream_gen)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        sg._core()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert sum(n.count("pose_opt_kernel") for n in names) >= 1, names
    assert not [n for n in names if "getrf" in n.lower()], names
    assert _device_launches(pose_opt.kernel) - before >= core * sg.part_replays["core"]


def test_chunk_stream_runs_the_pose_kernel_three_times_a_frame(cuda):
    """Chunks of 4 RGB-D frames through the chunk graph: its IF nodes decide
    at each replay what runs, so the card counts P1's launches: three a
    tracked frame at least (the two motion hypotheses and the local map)."""
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK
    from self_commit_orb_slam2_tpu_torch.ops.optim import pose_opt

    _, seq, slam = _graph_setup(cuda, n_frames=13)
    on_card = pose_opt.device_launches()
    slam.track_batch_rgbd(seq.images, seq.depths, seq.timestamps, chunk=4)
    assert slam.state == STATE_OK and slam.step_graph.part_replays["chunk"] == 3
    assert pose_opt.device_launches() - on_card >= 3 * 12


def test_warm_start_captures_and_touches_no_state(cuda):
    """warm_start captures the step graphs on a scratch state: the map, the
    carry, the trajectory and the engine's generators are untouched, and the
    stream after it replays without capturing again."""
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK
    from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse

    cfg, seq, slam = _graph_setup(cuda, n_frames=13)
    gens = (slam._stream_gen, slam._reloc_gen, slam._mono_gen, slam._loop_gen)
    before = [g.get_state() for g in gens]
    map0 = _clone_tree(slam.map)
    slam.warm_start()
    sg = slam.step_graph
    assert sg.captures == 1 and sg.replays == 0 and "chunk" in sg._graphs
    assert [p.graph is not None for p in sg.frames.programs] == [True]   # the frame phase's
    assert slam.carry is None and slam.trajectory == []
    assert all(torch.equal(a, b) for a, b in zip(map0, slam.map))
    assert all(torch.equal(s, g.get_state()) for s, g in zip(before, gens))
    slam.track_batch_rgbd(seq.images, seq.depths, seq.timestamps, chunk=4)
    _, est = slam.get_trajectory()
    # the 12 frames after the first: one chunk-graph replay a chunk
    assert sg.captures == 1 and sg.replays == 3 and sg.part_replays["chunk"] == 3
    assert slam.state == STATE_OK and ate_rmse(est, seq.poses_gt) < 0.02


def test_frame_graph_replays_equal_eager(cuda):
    """The streamed frame phase through the System's frame-phase graph (the
    band kernel at 16-px cells, the NMS kernel at 8-px cells, both launched
    from replays) against frames_rgbd_packed op by op on the same packed
    chunks: bitwise; each replay makes its capture's one kernel launch."""
    from self_commit_orb_slam2_tpu_torch.models import pipeline, program_graphs
    from self_commit_orb_slam2_tpu_torch.models.system import System

    cfg, seq, _ = _graph_setup(cuda, n_frames=12)
    for cell, kernel in ((16, fast_band.kernel), (8, fast_nms.kernel)):
        c = cfg._replace(orb=cfg.orb._replace(cell_size=cell))
        slam = System(c, enable_loop_closing=False)
        program_graphs.LAUNCHES_REPLAYED.clear()
        for k in range(3):
            sl = slice(4 * k, 4 * k + 4)
            host = pipeline.pack_rgbd_chunk(
                np.clip(seq.images[sl], 0, 255).astype(np.uint8),
                np.clip(seq.depths[sl] * 1e3, 0, 65535).astype(np.uint16),
                seq.timestamps[sl].astype(np.float32), np.ones(4, bool))
            want = pipeline.frames_rgbd_packed(slam.config, torch.from_numpy(host).to(cuda))
            got = slam._frame_phase("rgbd", host)
            assert all(torch.equal(a, b) for a, b in zip(
                torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want))), k
        prog, = slam.step_graph.frames.programs
        assert prog.graph is not None and prog.replays == 2
        assert prog.per_replay == {kernel.name: 1}
        assert program_graphs.LAUNCHES_REPLAYED[kernel.name] == 2


def _loop_state(cuda):
    from self_commit_orb_slam2_tpu_torch.models import map_state as ms

    slam = _loop_world(cuda)
    return slam, slam.map, int(ms.latest_kf(slam.map))


def test_closer_graphs_replay_equal_eager_from_cloned_states(cuda):
    """Loop detection and correction through the System's closer graphs
    against the same calls op by op, from one loop state: three detections
    from one generator state (the graph's registered generator, an eager
    copy of its state) bitwise; corrections with poses within 1e-3 and
    points within 2e-3 m + 1e-3 relative (the card's bound against the CPU;
    the scatter-adds run in a fixed order, so bitwise is expected),
    observations equal on >= 99.9%."""
    from self_commit_orb_slam2_tpu_torch.models import loop_closing

    slam, m, kf = _loop_state(cuda)
    cfg, cg, gen = slam.config, slam.step_graph.closer, slam._loop_gen
    kf_t = torch.tensor(kf, dtype=torch.int32, device=cuda)
    ge = torch.Generator(device=cuda)
    ge.set_state(gen.get_state())
    for i in range(3):
        want = loop_closing.detect_and_verify(cfg, _clone_tree(m), kf_t, ge)
        got = cg.detect(m, kf, gen)
        assert all(torch.equal(a, b) for a, b in zip(want, got)), i
    assert cg.detect_program.graph is not None and cg.detect_program.replays >= 2
    assert torch.equal(ge.get_state(), gen.get_state())
    det = got
    for i in range(2):
        want = loop_closing.correct_loop(cfg, _clone_tree(m), kf_t, det)
        got = cg.correct(m, kf, det)
        assert torch.allclose(got.kf_Tcw, want.kf_Tcw, atol=1e-3), i
        assert torch.allclose(got.pt_pos, want.pt_pos, atol=2e-3, rtol=1e-3), i
        assert (got.kf_obs_pt == want.kf_obs_pt).float().mean() >= 0.999, i
    assert cg.correct_program.graph is not None


def test_detect_and_correct_run_without_a_sync(cuda):
    """detect_and_verify (drawing its minimal sets on the card),
    correct_loop and the frame phase op by op on the card under
    torch.cuda.set_sync_debug_mode("error"): no operation in them waits for
    the card."""
    from self_commit_orb_slam2_tpu_torch.models import loop_closing, pipeline

    slam, m, kf = _loop_state(cuda)
    cfg = slam.config
    kf_t = torch.tensor(kf, dtype=torch.int32, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    det = loop_closing.detect_and_verify(cfg, m, kf_t, gen)
    seq_images = np.zeros((4, 240, 320), np.uint8)
    host = pipeline.pack_rgbd_chunk(seq_images, np.zeros((4, 240, 320), np.uint16),
                                    np.zeros(4, np.float32), np.ones(4, bool))
    buf = torch.from_numpy(host).to(cuda)
    pipeline.frames_rgbd_packed(cfg, buf)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loop_closing.detect_and_verify(cfg, m, kf_t, gen)
        m2 = loop_closing.correct_loop(cfg, m, kf_t, det)
        pipeline.frames_rgbd_packed(cfg, buf)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(m2.n_loop) == int(m.n_loop) + 1


def test_warm_start_captures_the_closer_graphs_and_touches_no_state(cuda):
    """With the vocabulary (loop closing on), warm_start also captures the
    closer's detection and correction graphs on a throwaway copy: the map
    and every generator of the engine are untouched, and the first real
    detection replays."""
    from self_commit_orb_slam2_tpu_torch.models.system import System

    slam = System(_loop_config())
    gens = (slam._stream_gen, slam._reloc_gen, slam._mono_gen, slam._loop_gen)
    before = [g.get_state() for g in gens]
    map0 = _clone_tree(slam.map)
    slam.warm_start()
    cg = slam.step_graph.closer
    assert cg.detect_program.graph is not None and cg.correct_program.graph is not None
    assert cg.detect_program.replays == 0 and cg.correct_program.replays == 0
    assert cg.detect_program.generator is slam._loop_gen
    assert slam.carry is None and slam.trajectory == []
    assert all(torch.equal(a, b) for a, b in zip(map0, slam.map))
    assert all(torch.equal(s, g.get_state()) for s, g in zip(before, gens))


# ------------------------------------------- relocalization and localization graphs

def _reloc_plan(slam, seq, cuda):
    """(frame, ts, localization_only) of a kidnap in SLAM mode, then one in
    localization mode, then two tracked localization-mode frames."""
    from self_commit_orb_slam2_tpu_torch.models.frame import make_frame_rgbd

    zeros = torch.zeros(seq.images[0].shape, dtype=torch.float32, device=cuda)
    blank = make_frame_rgbd(slam.config, zeros, zeros)
    frames = {i: _card_frame(slam.config, seq, i, cuda)[0] for i in (10, 11, 12)}
    ts = torch.tensor(5.0, device=cuda)
    return [(blank, ts, False), (frames[12], ts, False), (blank, ts, True),
            (frames[10], ts, True), (frames[11], ts, True)]


def test_lost_and_localization_graphs_replay_equal_eager(cuda):
    """The small world's System on the card through a kidnap in SLAM mode
    and one in localization mode, per frame: before each frame the map, the
    carry and the stream generator are cloned and the frame runs through
    pipeline.track_step op by op on the clone, then through the StepGraph
    (core or loc_core, and the lost / loc_lost graph) on the live state:
    bitwise, else poses within 1e-5 and inliers within 2, the same
    keyframe decisions; both kidnaps recover through a LOST graph."""
    from self_commit_orb_slam2_tpu_torch.models import pipeline

    slam, seq = _small_world(cuda)
    sg, gen = slam.step_graph, slam._stream_gen
    plan = _reloc_plan(slam, seq, cuda)
    ge = torch.Generator(device=cuda)
    states = []
    for k, (frame, ts, loc) in enumerate(plan):
        ge.set_state(gen.get_state())
        _, _, info_e = pipeline.track_step(slam.config, _clone_tree(slam.map),
                                           _clone_tree(slam.carry), frame, ts, True,
                                           localization_only=loc, generator=ge)
        row_e = pipeline.pack_infos([info_e])[0].cpu().numpy()
        slam.map, slam.carry, row_g = sg.step(slam.map, slam.carry, frame, ts, True, gen,
                                              localization_only=loc)
        if not np.array_equal(row_e, row_g):
            assert np.abs(row_e[:32] - row_g[:32]).max() <= 1e-5, k
            assert abs(row_e[32] - row_g[32]) <= 2, k
        assert row_e[33] == row_g[33] and row_e[34] == row_g[34], k
        assert torch.equal(ge.get_state(), gen.get_state()), k
        states.append(bool(row_g[34] > 0.5))
    assert states == [False, True, False, True, True]
    assert sg.part_replays["lost"] == 2 and sg.part_replays["loc_lost"] >= 2
    assert sg.part_replays["loc_core"] == 3


def test_reloc_graph_replays_equal_eager(cuda):
    """The System's relocalization graph against relocalize op by op, three
    calls each from one generator state: the same success, Tcw bitwise
    (else within 1e-5), inliers within 2; the generators stay together."""
    from self_commit_orb_slam2_tpu_torch.models import relocalization

    slam, seq = _small_world(cuda)
    frame = _card_frame(slam.config, seq, 9, cuda)[0]
    runner, gen = slam.step_graph.reloc, slam._reloc_gen
    ge = torch.Generator(device=cuda)
    ge.set_state(gen.get_state())
    for i in range(3):
        want = relocalization.relocalize(slam.config, slam.map, frame, ge)
        got = runner.relocalize(slam.map, frame, gen)
        assert bool(want.success) and bool(got.success), i
        if not torch.equal(want.Tcw, got.Tcw):
            assert float((want.Tcw - got.Tcw).abs().max()) <= 1e-5, i
        assert abs(int(want.n_inliers) - int(got.n_inliers)) <= 2, i
    assert runner.program.graph is not None and runner.program.replays == 2
    assert torch.equal(ge.get_state(), gen.get_state())


def test_lost_localization_and_reloc_graphs_replay_without_a_sync(cuda):
    """Replays of lost, loc_core, loc_lost and the relocalization graph, and
    relocalize_uncounted, relocalize_branch and _localization_core op by
    op, under torch.cuda.set_sync_debug_mode("error")."""
    from self_commit_orb_slam2_tpu_torch.models import pipeline, relocalization

    slam, seq = _small_world(cuda)
    sg, gen = slam.step_graph, slam._stream_gen
    frame = _card_frame(slam.config, seq, 9, cuda)[0]
    for loc in (False, True):   # both modes captured, each core replayed once
        slam.map, slam.carry, _ = sg.step(slam.map, slam.carry, frame,
                                          torch.tensor(5.0, device=cuda), True, gen,
                                          localization_only=loc)
    slam.step_graph.reloc.relocalize(slam.map, frame, slam._reloc_gen)   # capture
    cfg, m, carry = slam.config, slam.map, slam.carry
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for loc in (False, True):
            sg._core(loc)
            sg._lost(loc, gen)
        res = slam.step_graph.reloc.relocalize(m, frame, slam._reloc_gen)
        core = pipeline._localization_core(cfg, m, carry, frame)
        pipeline.relocalize_branch(cfg, m, carry, frame, core, gen, localization_only=True)
        relocalization.relocalize_uncounted(cfg, m, frame, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(res.success)
    assert all(sg.part_replays[p] >= 1 for p in ("lost", "loc_core", "loc_lost"))


def test_warm_start_and_localization_mode_capture_outside_the_frames(cuda):
    """With a vocabulary, warm_start also captures the lost graph and the
    relocalization graph, bound to the System's generators, whose states it
    leaves as they were; activate_localization_mode captures loc_core and
    loc_lost before the first localization-mode frame, which replays."""
    slam, seq = _small_world(cuda)
    fresh = type(slam)(slam.config, enable_mapping=True, enable_loop_closing=False)
    gens = (fresh._stream_gen, fresh._reloc_gen)
    before = [g.get_state() for g in gens]
    fresh.warm_start()
    sg = fresh.step_graph
    assert {"core", "lost", "tail"} <= set(sg._graphs) and sg.generator is fresh._stream_gen
    assert sg.reloc.program.graph is not None and sg.reloc.program.generator is fresh._reloc_gen
    assert all(torch.equal(s, g.get_state()) for s, g in zip(before, gens))
    sg = slam.step_graph
    captures = sg.captures
    slam.activate_localization_mode()
    assert {"loc_core", "loc_lost"} <= set(sg._graphs) and sg.captures == captures + 1
    slam.track_rgbd(seq.images[12], seq.depths[12], 9.0)
    assert sg.captures == captures + 1 and sg.part_replays["loc_core"] == 1


def test_a_failed_capture_raises(cuda, monkeypatch):
    """A localization core that reads the card back cannot be captured: the
    capture raises, nothing runs op by op instead, and the card stays
    usable."""
    from self_commit_orb_slam2_tpu_torch.models import pipeline

    slam, seq = _small_world(cuda)
    core_fn = pipeline._localization_core

    def reading_core(*args):
        core = core_fn(*args)
        bool(core.ok)   # a host read
        return core

    monkeypatch.setattr(pipeline, "_localization_core", reading_core)
    with pytest.raises(RuntimeError):
        slam.activate_localization_mode()
    assert "loc_core" not in slam.step_graph._graphs
    torch.cuda.synchronize()
    assert float(torch.ones(3, device=cuda).sum()) == 3.0


# -------------------------- the global BA, the bootstrap and the per-frame frame build

def test_gba_and_merge_graphs_replay_equal_eager(cuda):
    """The ten GBA slices and the merge through the System's closer programs
    (load_gba, gba_slice, merge) against the same calls op by op, from the
    loop world's map corrected at its loop: bitwise, else poses within 1e-3
    and points within 2e-3 m + 1e-3 relative on >= 99.9% of coordinates
    (the card's bound against the CPU; bitwise is expected, the scatter-adds
    running in a fixed order); a reload
    at phase 0 after three slices gives the same result."""
    from self_commit_orb_slam2_tpu_torch.models import loop_closing
    from self_commit_orb_slam2_tpu_torch.models import map_state as ms

    slam = _loop_world(cuda)
    cfg, cg = slam.config, slam.step_graph.closer
    kf = ms.latest_kf(slam.map)
    det = loop_closing.detect_and_verify(cfg, slam.map, kf, torch.Generator(cuda).manual_seed(7))
    mc = loop_closing.correct_loop(cfg, _clone_tree(slam.map), kf, det)
    anchor = int(det.cand_kf)
    T, p = mc.kf_Tcw.clone(), mc.pt_pos.clone()
    for huber in loop_closing.GBA_SLICES:
        T, p = loop_closing.global_bundle_adjust_slice(cfg, mc, T, p, anchor, huber)
    want = loop_closing.merge_gba(mc, mc.kf_seq, mc.pt_birth, T, p)
    for partial in (0, 3):
        cg.load_gba(mc, anchor)
        Tg, pg = mc.kf_Tcw.clone(), mc.pt_pos.clone()
        for huber in loop_closing.GBA_SLICES[:partial]:
            Tg, pg = cg.gba_slice(Tg, pg, huber)
        if partial:   # dropped mid-way: reloaded at phase 0
            cg.load_gba(mc, anchor)
            Tg, pg = mc.kf_Tcw.clone(), mc.pt_pos.clone()
        for huber in loop_closing.GBA_SLICES:
            Tg, pg = cg.gba_slice(Tg, pg, huber)
        got = cg.merge(mc, mc.kf_seq, mc.pt_birth, Tg, pg)
        assert torch.allclose(got.kf_Tcw, want.kf_Tcw, atol=1e-3), partial
        close = (got.pt_pos - want.pt_pos).abs() <= 2e-3 + 1e-3 * want.pt_pos.abs()
        assert float(close.float().mean()) >= 0.999, partial
        assert torch.equal(got.kf_Tcw[anchor], mc.kf_Tcw[anchor])
    assert all(p.graph is not None for p in cg.gba_programs.values())
    assert cg.merge_program.graph is not None and cg.gba_programs[False].replays >= 12


def _mono_world(cuda):
    from self_commit_orb_slam2_tpu_torch.models.config import (
        Capacities, SlamConfig, TrackingConfig)
    from self_commit_orb_slam2_tpu_torch.models.system import System
    from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
    from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

    seq = generate_sequence(n_frames=8, width=320, height=240, fx=260.0, seed=5)
    cfg = SlamConfig(camera=CameraParams.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                                                bf=0.0, width=320, height=240),
                     orb=OrbConfig(n_features=700),
                     caps=Capacities(max_keyframes=32, max_points=8192, local_points=1024),
                     tracking=TrackingConfig(max_frames_between_kf=8, kf_ref_ratio_stereo=0.8),
                     sensor="mono")
    return cfg, seq, System(cfg, enable_loop_closing=False)


def test_mono_bootstrap_graphs_replay_equal_eager(cuda):
    """A mono System on the card bootstraps per frame through its
    MonoInitGraphs (the doubled-budget frame build, the attempt) and one
    with step_graph None from the same generator seed: the same frame
    initializes, the map and the carry bit for bit; then three attempts on
    one pair replayed against op by op from one generator state, bitwise."""
    from self_commit_orb_slam2_tpu_torch.models import map_state as ms
    from self_commit_orb_slam2_tpu_torch.models import mono_init
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System

    cfg, seq, slam = _mono_world(cuda)
    eager = System(cfg, enable_loop_closing=False)
    eager.step_graph = None
    for s in (slam, eager):
        for i in range(6):
            s.track_monocular(seq.images[i], float(seq.timestamps[i]))
            if s.state == STATE_OK:
                break
    assert slam.state == eager.state == STATE_OK and len(slam.trajectory) == len(eager.trajectory)
    assert all(torch.equal(a, b) for a, b in zip(slam.map, eager.map))
    mono = slam.step_graph.mono
    assert mono.program.graph is not None and mono.frame.programs[0].graph is not None
    f1, f2 = (mono.frame((torch.from_numpy(seq.images[i].astype(np.float32)),))
              for i in (0, 1))
    m0 = ms.empty_map(cfg, cuda)
    gen = slam._mono_gen
    ge = torch.Generator(cuda)
    ge.set_state(gen.get_state())
    for k in range(3):
        got = mono.try_initialize(m0, f1, f2, 0.0, 0.1, 1, gen)
        want = mono_init.try_initialize(cfg, m0, f1, f2, 0.0, 0.1, 1, ge)
        assert got.success == want.success and got.n_matches == want.n_matches, k
        if want.success:
            assert all(torch.equal(a, b) for a, b in zip(got.m, want.m)), k
    assert torch.equal(gen.get_state(), ge.get_state())


@pytest.mark.parametrize("sensor", ["rgbd", "mono"])
def test_frame_build_graph_replays_equal_eager(cuda, sensor):
    """The per-frame API's frame build through FrameGraphs.single against
    make_frame_* op by op on the same images, three frames: bitwise; the
    band kernel launched once by each replay."""
    from self_commit_orb_slam2_tpu_torch.models import frame as frame_mod
    from self_commit_orb_slam2_tpu_torch.models import program_graphs

    cfg, seq, slam = _graph_setup(cuda, n_frames=4)
    cfg = slam.config._replace(sensor=sensor)
    frames = program_graphs.FrameGraphs(cfg, cuda, program_graphs.GraphPool())
    program_graphs.LAUNCHES_REPLAYED.clear()
    for i in range(3):
        host = (torch.from_numpy(seq.images[i].astype(np.float32)),
                torch.from_numpy(seq.depths[i].astype(np.float32)))[:2 if sensor == "rgbd" else 1]
        got = frames.single(sensor, host)
        want = getattr(frame_mod, f"make_frame_{sensor}")(cfg, *(a.to(cuda) for a in host))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), i
    prog, = frames.single_programs
    assert prog.graph is not None and prog.replays == 2
    assert program_graphs.LAUNCHES_REPLAYED[fast_band.kernel.name] == 2


def test_gba_merge_bootstrap_and_frame_build_replay_without_a_sync(cuda):
    """Replays of both GBA slice kinds, the merge, the bootstrap's attempt
    and frame build and the per-frame frame build, and global_bundle_adjust_slice,
    merge_gba and mono_init.initialize_map op by op, under
    torch.cuda.set_sync_debug_mode("error")."""
    from self_commit_orb_slam2_tpu_torch.models import loop_closing, mono_init

    slam = _loop_world(cuda)
    cfg, cg, m = slam.config, slam.step_graph.closer, slam.map
    cg.load_gba(m, 1)
    T, p = cg.gba_slice(m.kf_Tcw, m.pt_pos, True)      # captures, then replays
    T, p = cg.gba_slice(T, p, False)
    cg.merge(m, m.kf_seq, m.pt_birth, T, p)
    mcfg, seq, mono_sys = _mono_world(cuda)
    mono = mono_sys.step_graph.mono
    img = (torch.from_numpy(seq.images[0].astype(np.float32)),)
    f1 = mono.frame(img)
    f2 = mono.frame((torch.from_numpy(seq.images[1].astype(np.float32)),))
    mono.try_initialize(mono_sys.map, f1, f2, 0.0, 0.1, 1, mono_sys._mono_gen)
    mono_sys.step_graph.frames.single("mono", img)
    ts = [torch.zeros((), device=cuda), torch.full((), 0.1, device=cuda),
          torch.ones((), dtype=torch.int32, device=cuda)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for huber in (True, False):
            T, p = cg.gba_slice(T, p, huber)
        cg.merge(m, m.kf_seq, m.pt_birth, T, p)
        loop_closing.global_bundle_adjust_slice(cfg, m, T, p, torch.ones((), dtype=torch.int32,
                                                                         device=cuda), True)
        loop_closing.merge_gba(m, m.kf_seq, m.pt_birth, T, p)
        mono.program.run(mono_sys._mono_gen)
        mono.frame(img)
        mono_sys.step_graph.frames.single("mono", img)
        mono_init.initialize_map(mcfg, mono_sys.map, f1, f2, *ts, mono_sys._mono_gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert mono.program.replays >= 1 and cg.merge_program.replays >= 1


def test_warm_start_captures_the_bootstrap_and_touches_no_state(cuda):
    """On a mono configuration warm_start also captures the bootstrap's
    frame build and attempt (the attempt bound to the System's mono
    generator, whose state it leaves as it was) and the per-frame frame
    build; the first real attempt replays."""
    cfg, seq, slam = _mono_world(cuda)
    gens = (slam._stream_gen, slam._reloc_gen, slam._mono_gen, slam._loop_gen)
    before = [g.get_state() for g in gens]
    slam.warm_start()
    mono = slam.step_graph.mono
    assert mono.program.graph is not None and mono.program.generator is slam._mono_gen
    assert mono.frame.programs[0].graph is not None
    assert [p.graph is not None for p in slam.step_graph.frames.single_programs] == [True]
    assert slam.carry is None and slam.trajectory == [] and int(slam.map.n_kf) == 0
    assert all(torch.equal(s, g.get_state()) for s, g in zip(before, gens))
    captures = mono.program.capture_s
    for i in range(3):
        slam.track_monocular(seq.images[i], float(seq.timestamps[i]))
    assert mono.program.replays >= 1 and mono.program.capture_s == captures


# ------------------------------------------------------------ the chunk graph

def _chunk(slam, seq, plan, cuda):
    """(frames [4, ...], ts [4], valid [4]) on the card: `plan` lists frame
    indices of seq, None for a blank frame, and the number of live slots."""
    from self_commit_orb_slam2_tpu_torch.models.frame import make_frame_rgbd

    idx, n_live = plan
    zeros = torch.zeros(seq.images[0].shape, dtype=torch.float32, device=cuda)
    fs = [make_frame_rgbd(slam.config, zeros, zeros) if i is None
          else _card_frame(slam.config, seq, i, cuda)[0] for i in idx]
    frames = type(fs[0])(*(torch.stack(x) for x in zip(*fs)))
    ts = torch.arange(4, dtype=torch.float32, device=cuda) + 20.0
    return frames, ts, torch.arange(4, device=cuda) < n_live


@pytest.mark.parametrize("loc", [False, True], ids=["slam", "localization"])
def test_chunk_graph_replays_equal_op_by_op(cuda, loc):
    """The small world's System on the card, three chunks: a blank frame
    goes LOST, the next frames relocalize and (SLAM mode) make keyframes;
    then a chunk with two padded slots; then the first chunk again.  Before
    each, the map, the carry and the stream generator are cloned and the
    chunk runs through pipeline.batch_steps_frames op by op on the clone
    (each slot on its own span of the generator), then through one replay
    of the chunk graph on the live state: the packed StepInfos, the map,
    the carry, the generator and the relocalization counts bit for bit."""
    from self_commit_orb_slam2_tpu_torch.models import pipeline, relocalization

    slam, seq = _small_world(cuda)
    sg, gen = slam.step_graph, slam._stream_gen
    plans = [([None, 12, 13, 14], 4), ([14, 15, 15, 15], 2), ([None, 12, 13, 14], 4)]
    ge = torch.Generator(device=cuda)
    for k, plan in enumerate(plans):
        frames, ts, valid = _chunk(slam, seq, plan, cuda)
        ge.set_state(gen.get_state())
        relocalization.reset_counts()
        m_e, c_e, p_e = pipeline.batch_steps_frames(
            slam.config, _clone_tree(slam.map), _clone_tree(slam.carry), frames, ts, valid,
            True, localization_only=loc, generator=ge)
        n_e = relocalization.counts()
        relocalization.reset_counts()
        replays = sg.part_replays[_chunk_name(loc)]
        slam.map, slam.carry, p_g = sg.batch_steps(slam.map, slam.carry, frames, ts, valid, True,
                                                   gen, localization_only=loc)
        assert sg.part_replays[_chunk_name(loc)] == replays + 1
        assert torch.equal(p_e, p_g), k
        assert all(torch.equal(a, b) for a, b in zip(m_e, slam.map)), k
        assert all(torch.equal(a, b) for a, b in zip(_leaves(c_e), _leaves(slam.carry))), k
        assert torch.equal(ge.get_state(), gen.get_state()), k
        assert n_e == relocalization.counts(), k
        infos = pipeline.unpack_infos(p_g.cpu().numpy())
        if plan[0][0] is None:
            assert list(infos.state_ok) == [False, True, True, True], k
            assert n_e[0] == 2 and n_e[1] == 1, k
            assert loc or infos.created_kf[1:].any(), k   # a keyframe after the LOST frame
    assert sg.chunk_stats[_chunk_name(loc)].conds == 4 * (2 if loc else 3)


def _chunk_name(loc):
    return "loc_chunk" if loc else "chunk"


def _leaves(x):
    from torch.utils._pytree import tree_leaves

    return tree_leaves(tuple(x))


def test_dispatch_reads_nothing_from_the_host(cuda):
    """A primed System (warm_start) streams under streaming.no_host_reads():
    every dispatch's frame phase and chunk-graph replay runs under
    torch.cuda.set_sync_debug_mode("error"), in SLAM mode, then in
    localization mode; each chunk is one replay of each graph."""
    from self_commit_orb_slam2_tpu_torch.models import streaming
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK

    slam, seq = _small_world(cuda)
    fresh = type(slam)(slam.config, enable_mapping=True, enable_loop_closing=False)
    fresh.warm_start()
    sg = fresh.step_graph
    frame_replays = sum(p.replays for p in sg.frames.programs)   # warm_start's own
    images = np.clip(seq.images, 0, 255).astype(np.uint8)
    depths = np.clip(seq.depths * 1e3, 0, 65535).astype(np.uint16)
    sess = fresh.open_stream("rgbd", 4)
    with streaming.no_host_reads():
        sess.feed((images[:9], depths[:9]), seq.timestamps[:9])
        sess.finish()
    assert fresh.state == STATE_OK
    assert sg.part_replays["chunk"] == 2 and sg.part_replays["core"] == 0
    assert sum(p.replays for p in sg.frames.programs) == frame_replays + 2
    fresh.activate_localization_mode()
    sess = fresh.open_stream("rgbd", 4)
    with streaming.no_host_reads():
        sess.feed((images[9:15], depths[9:15]), seq.timestamps[9:15])   # a padded chunk
        sess.finish()
    assert fresh.state == STATE_OK and sg.part_replays["loc_chunk"] == 2
    assert sg.replays == sg.part_replays["chunk"] + sg.part_replays["loc_chunk"]


def test_stamps_time_a_captured_graph_on_the_host_clock(cuda):
    """Two stamps captured around a matmul in a CUDA graph: each replay
    writes a start and an end where the graph runs; the tracer reads the
    ring at its close, and the stamped intervals fall inside the device
    interval of the span around the replays."""
    from self_commit_orb_slam2_tpu_torch.utils import profiling

    profiling.stamp_head(cuda)   # the ring and its kernel, before the capture
    x = torch.randn(2048, 2048, device=cuda)
    y = x @ x                    # the matmul's library handle, before the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        profiling.stamp(cuda)
        y = x @ x
        profiling.stamp(cuda)
    before = profiling.stamps()
    with profiling.tracing() as t:
        with profiling.span("call"):
            profiling.count("frames")
            with profiling.span("step.chunk", cuda):
                for _ in range(3):
                    g.replay()
    s = t.summary
    assert profiling.stamps() == before + 6 and len(s.passes) == 3
    chunk = next(r for r in s.spans if r.name == "step.chunk")
    slack = 50_000   # ns: the two clocks are aligned to tens of microseconds
    assert chunk.device is not None
    for a, b in s.passes:
        assert chunk.device[0] - slack <= a < b <= chunk.device[1] + slack
    assert torch.isfinite(y).all()


def test_timed_synchronizes_leave_the_window(cuda):
    """A timed span around queued matmuls: each of its two synchronizes
    keeps the stretch from the end of the stream's queued work to the
    host's return, inside the window; the summary's window and the span's
    device interval leave the stretches out."""
    from self_commit_orb_slam2_tpu_torch.utils import profiling

    x = torch.randn(2048, 2048, device=cuda)
    torch.cuda.synchronize()
    with profiling.timed({"mapping.pass": "s"}) as out:
        with profiling.span("call"):
            profiling.count("frames")
            with profiling.span("step.tail", cuda):
                for _ in range(3):
                    y = x @ x
                with profiling.span("mapping.pass"):
                    for _ in range(3):
                        y = y @ x
                time.sleep(0.002)
    s = profiling.last_summary()
    assert len(out["s"]) == 1 and s.timed["mapping.pass"] == out["s"]
    assert 1 <= len(s.syncs) <= 2
    w0, w1 = s.window
    assert all(w0 <= a < b <= w1 for a, b in s.syncs)
    cut = sum(b - a for a, b in s.syncs)
    assert s.window_ns == w1 - w0 - cut
    tail = next(r for r in s.spans if r.name == "step.tail")
    assert s.device_ns("step.tail") <= tail.device[1] - tail.device[0]
    assert 0 < s.busy_ns() <= s.window_ns
    assert torch.isfinite(y).all()


def test_dispatch_reads_nothing_with_the_tracer_open(cuda):
    """The primed System of test_dispatch_reads_nothing_from_the_host,
    streamed under streaming.no_host_reads() with the tracer open: nothing
    waits for the card inside a dispatch, the frame phase, the chunk-graph
    replay and each graph launch are spanned with device intervals, and the
    passes the chunk graph ran are the stamps the trace read."""
    from self_commit_orb_slam2_tpu_torch.models import pipeline, streaming
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK
    from self_commit_orb_slam2_tpu_torch.utils import profiling

    slam, seq = _small_world(cuda)
    fresh = type(slam)(slam.config, enable_mapping=True, enable_loop_closing=False)
    fresh.warm_start()
    pipeline.reset_mapping_passes()
    with profiling.tracing() as t:
        with streaming.no_host_reads():
            fresh.track_batch_rgbd(seq.images[:13], seq.depths[:13], seq.timestamps[:13],
                                   chunk=4)
    assert fresh.state == STATE_OK
    s = t.summary
    names = [r.name for r in s.spans]
    assert names.count("step.chunk") == 3 and names.count("frame.phase") == 3
    assert all(r.device is not None for r in s.spans
               if r.name in ("step.chunk", "frame.phase", "frame.h2d"))
    assert names.count("graph.launch") >= 6
    assert len(s.passes) == pipeline.mapping_passes() == s.counts["keyframes"]
    assert s.coverage() > 0.9 and 0 < s.busy_ns() < s.window_ns


def test_tail_replays_and_op_by_op_passes_stamp_the_same_stages(cuda):
    """The same 25 RGB-D frames one call a frame through the tail replay
    and op by op (step_graph None), then streamed through the chunk graph:
    each pass stamps one interval of each of its four stamped stages
    (create_new_points, fuse_into_keyframe, refresh_observed_points,
    local_bundle_adjustment), in that order, inside its pass."""
    from self_commit_orb_slam2_tpu_torch.models import pipeline
    from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK
    from self_commit_orb_slam2_tpu_torch.utils import profiling

    cfg, seq, graphed = _graph_setup(cuda)
    eager = type(graphed)(cfg, enable_mapping=True, enable_loop_closing=False)
    eager.step_graph = None
    streamed = type(graphed)(cfg, enable_mapping=True, enable_loop_closing=False)
    streamed.warm_start()
    slack = 50_000   # ns: the card's stamps on the host clock

    def traced(run):
        pipeline.reset_mapping_passes()
        with profiling.tracing() as t:
            run()
        s = t.summary
        assert len(s.passes) == pipeline.mapping_passes() > 0
        for name in profiling.STAGES:
            assert len(s.stages[name]) == len(s.passes), name
        for p, *stages in zip(s.passes, *(s.stages[name] for name in profiling.STAGES)):
            ends = [t for st in stages for t in st]
            assert p[0] - slack <= ends[0] and ends[-1] <= p[1] + slack
            assert all(a <= b for a, b in zip(ends, ends[1:]))
        return len(s.passes)

    def per_frame(slam):
        for i in range(len(seq.images)):
            slam.track_rgbd(seq.images[i], seq.depths[i], float(seq.timestamps[i]))

    n_graphed = traced(lambda: per_frame(graphed))
    n_eager = traced(lambda: per_frame(eager))
    assert n_graphed == n_eager
    n = traced(lambda: streamed.track_batch_rgbd(seq.images, seq.depths, seq.timestamps,
                                                 chunk=4))
    assert n > 0 and graphed.state == eager.state == streamed.state == STATE_OK
