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
    """1280 sets of 12 exact correspondences: the three batched eigh calls
    ([1280, 3, 3], [1280, 12, 12], [1280, 4, 4]) run by the card's solver
    give R and t within 1e-3 of the CPU's on at least 99% of the sets (the
    rest are sets whose 12x12 kernel vector is badly separated in fp32)."""
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
    kernel once per extraction call, STATE_OK, a sane trajectory."""
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
    before = fast_band.kernel.launches
    if stereo:
        poses = slam.track_batch_stereo(seq.images, seq.right_images, seq.timestamps)
    else:
        poses = slam.track_batch_mono(seq.images, seq.timestamps)
    _, est = slam.get_trajectory()
    lag = n - len(est)
    assert slam.map.kf_Tcw.device.type == cuda.type
    assert slam.state == STATE_OK and lag <= (0 if stereo else 6)
    assert len(poses) == len(est) - 1
    assert fast_band.kernel.launches - before == (lag + 1) + -(-len(poses) // 4)
    assert ate_rmse(est, seq.poses_gt[lag:], with_scale=not stereo) < 0.05
