"""The port's rules, as tests: it imports neither JAX nor the JAX package,
it never falls back to the CPU silently, and its copies of the JAX package's
numpy-only modules give the same results.

One exception to "nothing of the JAX package", and it is data, not code: the
bundled vocabulary file stays in that package's assets directory and the
port reads it by path (ops/bow.default_vocab_path).  The import scan stays as
strict as it was."""

import ast
import importlib.util
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models import config as jconfig
from self_commit_orb_slam2_tpu.ops import bow as jbow
from self_commit_orb_slam2_tpu.ops.orb import brief_pattern as jbrief
from self_commit_orb_slam2_tpu.ops.orb import fast as jfast
from self_commit_orb_slam2_tpu.utils import evaluation as jevaluation
from self_commit_orb_slam2_tpu.utils import synthetic as jsynthetic
from self_commit_orb_slam2_tpu_torch.models import config
from self_commit_orb_slam2_tpu_torch.models.system import System, resolve_device
from self_commit_orb_slam2_tpu_torch.ops import bow
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb import brief_pattern, detect, fast
from self_commit_orb_slam2_tpu_torch.utils import evaluation, synthetic

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "self_commit_orb_slam2_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "self_commit_orb_slam2_tpu"), (path, mod)


def _cfg():
    return config.SlamConfig(camera=CameraParams.create(fx=260.0, fy=260.0, cx=160.0,
                                                        cy=120.0, bf=26.0, width=320,
                                                        height=240))


def test_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        System(_cfg(), enable_mapping=False, enable_loop_closing=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("kwargs", [dict(enable_mapping=True, enable_loop_closing=True),
                                    dict(enable_mapping=False, enable_loop_closing=True)])
def test_unported_phases_refused(kwargs):
    """Nothing of the public API is refused any more: System(cfg) builds the
    loop closer for every sensor (idle without a vocabulary, as in the JAX
    package); the one refusal left is the sharded global BA, which names
    the slice that ports it.  An unknown sensor is an error."""
    from self_commit_orb_slam2_tpu_torch.models import loop_closing

    tiny = bow.from_arrays(np.zeros((3, 8), np.uint32), np.array([[1, 2], [-1, -1], [-1, -1]]),
                           np.array([-1, 0, 1]), np.ones(2, np.float32), 2, 1, 2, 0)
    for sensor in ("rgbd", "stereo", "mono"):
        plain = System(_cfg()._replace(sensor=sensor), device="cpu", **kwargs)
        assert plain._loop_closer is not None and not plain._loop_closer.enabled
        slam = System(_cfg()._replace(sensor=sensor, vocab=tiny), device="cpu", **kwargs)
        assert slam._loop_closer.enabled and slam.open_stream(sensor).per_chunk_loops
        assert not slam.map_changed()
        off = System(_cfg()._replace(sensor=sensor), enable_mapping=kwargs["enable_mapping"],
                     enable_loop_closing=False, device="cpu")
        assert off._loop_closer is None and off.open_stream(sensor).sensor == sensor
    with pytest.raises(NotImplementedError, match="slice 8"):
        loop_closing.run_sharded_gba(slam.config, slam.map, 0)
    # the dense path up to 4 Mi keyframe-point pairs: the bench's 64 and 96
    # keyframes x 16384 points; the default capacities (256 x 65536) need slice 8
    for (K, P), sharded in (((64, 16384), False), ((96, 16384), False), ((256, 65536), True)):
        assert loop_closing._needs_sharded_gba(slam.config, SimpleNamespace(
            max_kf=K, max_pt=P)) == sharded
    with pytest.raises(ValueError, match="lidar"):
        System(_cfg()._replace(sensor="lidar"), device="cpu")
    with pytest.raises(ValueError, match="lidar"):
        off.open_stream("lidar")
    assert slam.config.vocab.node_desc.device.type == "cpu"
    assert slam.map.kf_bow_ids.shape[1] == slam.config.bow_top == 512


@pytest.mark.parametrize("sensor", ["rgbd", "stereo", "mono"])
def test_no_silent_cpu_fallback_for_any_sensor(sensor):
    """Every sensor's engine asks for the card unless told otherwise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        System(_cfg()._replace(sensor=sensor), enable_loop_closing=False)


@pytest.mark.parametrize("name", ["Capacities", "TrackingConfig", "SlamConfig"])
def test_shared_config_defaults_equal(name):
    """Every field the port's configuration shares with the JAX package's
    has the same default; the port adds none of its own."""
    ours, theirs = getattr(config, name), getattr(jconfig, name)
    assert set(ours._fields) <= set(theirs._fields)
    for f in ours._fields:
        if f in ours._field_defaults:
            a, b = ours._field_defaults[f], theirs._field_defaults[f]
            if hasattr(a, "_asdict"):   # a nested config: its shared fields
                b = {k: v for k, v in b._asdict().items() if k in a._fields}
                a = a._asdict()
            assert a == b, f
    if name == "TrackingConfig":     # every field: a JAX configuration builds in the port
        assert set(ours._fields) == set(theirs._fields)
    if name == "SlamConfig":
        assert "rect_maps" in ours._fields and ours._field_defaults["rect_maps"] is None


def test_euroc_like_sequence_copy_identical():
    """The port's copy of bench.py's EuRoC-style generator: the same raw
    eyes, poses, timestamps and rectification maps."""
    spec = importlib.util.spec_from_file_location("_bench_for_rules", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    a, maps_a = bench._euroc_synthetic(2, 96, 72, 80.0, 0.11)
    b, maps_b = synthetic.euroc_like_sequence(2, 96, 72, 80.0, 0.11)
    for f in ("images", "right_images", "depths", "poses_gt", "K", "timestamps"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    for x, y in zip(maps_a, maps_b):
        np.testing.assert_array_equal(y, x)


def test_generate_sequence_copy_identical():
    kw = dict(n_frames=2, width=96, height=72, fx=80.0, seed=5)
    a, b = jsynthetic.generate_sequence(**kw), synthetic.generate_sequence(**kw)
    for f in ("images", "depths", "poses_gt", "K", "timestamps"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    for name in ("lookat_trajectory", "orbit_trajectory", "circle_trajectory",
                 "spin_trajectory"):
        np.testing.assert_array_equal(getattr(synthetic, name)(7),
                                      getattr(jsynthetic, name)(7), err_msg=name)


def test_numpy_constants_and_evaluation_copies(rng):
    np.testing.assert_array_equal(brief_pattern.BIT_PATTERN_31, jbrief.BIT_PATTERN_31)
    np.testing.assert_array_equal(fast.RING_OFFSETS, jfast.RING_OFFSETS)
    assert fast.ARC_LENGTH == jfast.ARC_LENGTH
    est = jsynthetic.lookat_trajectory(20)
    gt = est.copy()
    gt[:, :3, 3] += rng.normal(0, 0.01, (20, 3)).astype(np.float32)
    assert evaluation.ate_rmse(est, gt) == jevaluation.ate_rmse(est, gt)
    assert evaluation.rpe_rmse(est, gt) == jevaluation.rpe_rmse(est, gt)


def test_vocabulary_training_copies_identical(rng):
    """The numpy halves of train_vocabulary: the byte-LUT Hamming table and
    the k-majority clustering give the originals' results from one seed."""
    np.testing.assert_array_equal(bow._POP_LUT, jbow._POP_LUT)
    descs = rng.integers(0, 2**32, (600, 8), dtype=np.uint64).astype(np.uint32)
    centers = descs[:7]
    u8 = lambda a: np.ascontiguousarray(a).view(np.uint8).reshape(len(a), 32)  # noqa: E731
    np.testing.assert_array_equal(bow._hamming_table(u8(descs), u8(centers), chunk=128),
                                  jbow._hamming_table(u8(descs), u8(centers), chunk=128))
    got = bow._kmajority(descs, 6, np.random.default_rng(4))
    want = jbow._kmajority(descs, 6, np.random.default_rng(4))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_bundled_vocabulary_is_read_in_place_not_copied():
    """The data-file exception: one copy of the vocabulary in the checkout,
    in the JAX package's assets, found by path."""
    path = pathlib.Path(bow.default_vocab_path())
    assert path == ROOT / "self_commit_orb_slam2_tpu" / "assets" / "vocab_synthetic.npz"
    assert not list((ROOT / "self_commit_orb_slam2_tpu_torch").rglob("*.npz"))
    assert "self_commit_orb_slam2_tpu" not in {
        m.split(".")[0] for m in _imported_modules(
            ROOT / "self_commit_orb_slam2_tpu_torch" / "ops" / "bow.py")}


def test_slab_border_mask_built_once_per_shape():
    """select_keypoints_slab builds its [G, H0, W0] border mask on the
    device once per shape, not on the host per call."""
    score = torch.rand(3, 40, 56)
    dims = [(40, 56), (33, 47), (40, 56)]
    before = detect._border_mask.cache_info()
    for _ in range(3):
        detect.select_keypoints_slab(score, score, [20, 10, 20], dims, cell=8, border=8)
    after = detect._border_mask.cache_info()
    assert (after.misses, after.hits) == (before.misses + 1, before.hits + 2)
    detect.select_keypoints_slab(score[:2], score[:2], [20, 10], dims[:2], cell=8, border=8)
    assert detect._border_mask.cache_info().misses == before.misses + 2


# ------------------------------------------------------------- copies, by source

PORT = ROOT / "self_commit_orb_slam2_tpu_torch"
JAX = ROOT / "self_commit_orb_slam2_tpu"


def _defs(path):
    """Top-level function and class definitions of a module, docstrings
    dropped, as ast dumps keyed by name."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            for n in ast.walk(node):
                body = getattr(n, "body", None)
                if (isinstance(n, (ast.FunctionDef, ast.ClassDef)) and body
                        and isinstance(body[0], ast.Expr)
                        and isinstance(body[0].value, ast.Constant)
                        and isinstance(body[0].value.value, str)):
                    n.body = body[1:] or [ast.Pass()]
            out[node.name] = ast.dump(node)
    return out


# (module, definitions the port copies verbatim from the JAX package's module)
COPIES = [
    ("utils/datasets.py", ["_read_timestamp_file", "RgbdFrame", "TumRgbdDataset",
                           "StereoFrame", "KittiOdometryDataset", "EurocDataset"]),
    ("utils/config_io.py", ["load_settings"]),
    ("utils/viewer.py", ["draw_frame", "_to_px", "draw_map_topdown"]),
    ("utils/trajectory.py", ["_inverse_np", "save_kitti"]),
    ("utils/synthetic.py", ["value_noise_texture", "voronoi_texture", "stripe_blob_texture",
                            "warped_checker_texture", "halftone_texture", "corpus_texture"]),
    ("utils/native_io.py", ["available", "load_gray"]),
    ("stream_slam.py", ["write_frame", "_read_exact", "read_frame", "write_pose", "read_pose",
                        "serve"]),
    ("ops/orb/orientation.py", ["_circular_mask", "_separable_factors", "_band_matrix"]),
    ("ops/orb/pyramid.py", ["gaussian_kernel_1d", "_blur_matrix"]),
]


@pytest.mark.parametrize("module,names", COPIES, ids=[m for m, _ in COPIES])
def test_copies_equal_their_originals(module, names):
    ours, theirs = _defs(PORT / module), _defs(JAX / module)
    for name in names:
        assert ours[name] == theirs[name], f"{module}::{name} differs from the JAX package's"


def test_stage_timer_copy():
    """StageTimer: the JAX package's summary and medians; cuda=True only adds
    the synchronizations around a stage."""
    from self_commit_orb_slam2_tpu.utils import profiling as jprofiling
    from self_commit_orb_slam2_tpu_torch.utils import profiling

    ours, theirs = _defs(PORT / "utils/profiling.py"), _defs(JAX / "utils/profiling.py")
    ours_t, theirs_t = profiling.StageTimer(), jprofiling.StageTimer()
    for t in (ours_t, theirs_t):
        with t("decode"):
            pass
        t.samples["track"].extend([0.25, 0.5, 0.125])
    ours_t.samples["decode"] = list(theirs_t.samples["decode"])
    assert ours_t.summary() == theirs_t.summary()
    assert ours_t.medians() == theirs_t.medians()
    assert "device_trace" in ours and "device_trace" in theirs
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            with profiling.StageTimer(cuda=True)("x"):
                pass


def test_slamio_source_is_a_byte_equal_copy():
    assert (PORT / "csrc" / "slamio.cc").read_bytes() == (JAX / "native" / "slamio.cc").read_bytes()
    from self_commit_orb_slam2_tpu_torch.utils import native_io

    assert native_io.SOURCE == PORT / "csrc" / "slamio.cc"
    assert "self_commit_orb_slam2_tpu/" not in (PORT / "utils" / "native_io.py").read_text()


def test_load_map_defaults_to_the_card(tmp_path):
    """checkpoint.load_map puts the map on the card unless asked for the CPU."""
    from self_commit_orb_slam2_tpu_torch.models import checkpoint, map_state

    path = str(tmp_path / "m.npz")
    checkpoint.save_map(path, map_state.empty_map(_cfg(), "cpu"))
    assert checkpoint.load_map(path, device="cpu").kf_Tcw.device.type == "cpu"
    if torch.cuda.is_available():
        assert checkpoint.load_map(path).kf_Tcw.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            checkpoint.load_map(path)


# ------------------------------------------------------- the name-by-name guard

# JAX names whose port counterpart carries another name (module -> port module
# or "module::name"): the Pallas wrappers became the CUDA kernels' wrappers,
# and the jnp remap its torch form.
RENAMED = {
    ("ops/orb/fast_pallas.py", "fast_nms_bands_hi_lo"): ("ops/orb/fast_band.py",
                                                         "fast_nms_bands_hi_lo"),
    ("ops/orb/fast_pallas.py", "fast_nms_hi_lo"): ("ops/orb/fast_nms.py", "fast_nms_hi_lo"),
    ("utils/rectify.py", "remap_bilinear_jnp"): ("utils/rectify.py", "remap_bilinear_torch"),
}
# Slice 8 (multi-device): the only names the port may still lack.
SLICE_8_MODULES = ("parallel/", "refine_maps.py")


def _public_names(pkg):
    """{(module, qualified name)} of top-level functions, classes and their
    methods; names with a leading underscore are private, dunders count."""
    out = set()
    for path in pkg.rglob("*.py"):
        rel = str(path.relative_to(pkg))
        for node in ast.parse(path.read_text()).body:
            if not isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                continue
            names = [node.name]
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, ast.FunctionDef)]
            for name in names:
                if not any(p.startswith("_") and not p.endswith("__") for p in name.split(".")):
                    out.add((rel, name))
    return out


def test_every_jax_name_has_a_port_counterpart():
    """The port does all that the JAX package does, but multi-device: every
    public function, class and method of the JAX package has a counterpart
    of the same name in the same module of the port (or its renamed one),
    and the only names missing are slice 8's."""
    ours, theirs = _public_names(PORT), _public_names(JAX)
    missing = {key for key in theirs if RENAMED.get(key, key) not in ours}
    slice8 = {key for key in missing if key[0].startswith(SLICE_8_MODULES)}
    assert missing == slice8, sorted(missing - slice8)
    assert {m for m, _ in slice8} == {"refine_maps.py", "parallel/mesh.py", "parallel/hosts.py",
                                      "parallel/distributed_ba.py",
                                      "parallel/distributed_pose_graph.py",
                                      "parallel/multi_map.py", "parallel/fleet.py"}
    assert all(v in ours for v in RENAMED.values())
    assert ("models/loop_closing.py", "run_sharded_gba") in ours   # its body is slice 8's
