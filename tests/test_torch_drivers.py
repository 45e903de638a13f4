"""The port's dataset driver against the JAX package's: run_slam on the
synthetic sequence through both packages' CLIs, and a TUM directory through
the port's, per frame and in batches (tests/test_torch_stream_slam.py holds
the byte-stream driver and the trajectory writers).

Tolerances: the two packages' whole-path runs are compared at ROADMAP.md
section C (2)'s loose bound for RGB-D on the CPU (the JAX package selects
keypoints through its slab path there): ATE within 0.01 m of each other,
camera centres within 0.02 m, keyframes within one."""

import re

import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu import run_slam as jrun_slam
from self_commit_orb_slam2_tpu_torch import run_slam
from self_commit_orb_slam2_tpu_torch.utils import trajectory, viewer
from self_commit_orb_slam2_tpu_torch.utils.evaluation import ate_rmse
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

torch.set_num_threads(2)   # six test workers share the CPU


def _centres(poses_cw):
    return -np.einsum("nij,ni->nj", poses_cw[:, :3, :3], poses_cw[:, :3, 3])


def _read_tum_cw(path):
    _, Twc = trajectory.load_tum(path)
    return np.linalg.inv(Twc)


def _keyframes(text):
    return int(re.search(r"keyframes: (\d+)", text).group(1))


def test_run_slam_synthetic_matches_jax(tmp_path, capsys):
    args = ["--synthetic", "--frames", "12", "--no-vocab"]
    assert jrun_slam.main(args + ["--output", str(tmp_path / "jax.txt")]) == 0
    jax_text = capsys.readouterr().out
    assert run_slam.main(args + ["--device", "cpu", "--output", str(tmp_path / "port.txt"),
                                 "--kitti-output", str(tmp_path / "port.kitti")]) == 0
    port_text = capsys.readouterr().out
    # the JAX driver's lines, in its order, then the port's one more
    for key in ("frames: 12", "median tracking time", "mean tracking time", "keyframes:",
                "trajectory written", "ATE RMSE"):
        assert key in jax_text and key in port_text, key
    assert re.search(r"device: cpu  decode: [\d.]+s  tracking: [\d.]+s  state: 1", port_text)
    assert abs(_keyframes(port_text) - _keyframes(jax_text)) <= 1
    gt = generate_sequence(n_frames=12, width=320, height=240, seed=5).poses_gt
    ours, theirs = _read_tum_cw(tmp_path / "port.txt"), _read_tum_cw(tmp_path / "jax.txt")
    assert ours.shape == theirs.shape == (12, 4, 4)
    a_ours, a_theirs = ate_rmse(ours, gt), ate_rmse(theirs, gt)
    assert a_ours < 0.01 and abs(a_ours - a_theirs) < 0.01
    assert np.abs(_centres(ours) - _centres(theirs)).max() < 0.02
    kitti = np.loadtxt(tmp_path / "port.kitti").reshape(-1, 3, 4)
    np.testing.assert_allclose(kitti[:, :, 3], _centres(ours), atol=1e-6)


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """9 frames of the synthetic sequence in the TUM RGB-D layout (16-bit
    depth PNGs at DepthMapFactor 5000) with a TUM1-style settings file."""
    root = tmp_path_factory.mktemp("tum")
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    seq = generate_sequence(n_frames=9, width=320, height=240, seed=5)
    rows = []
    for i, t in enumerate(seq.timestamps):
        name = f"{t:.6f}.png"
        viewer.save_png(str(root / "rgb" / name), np.clip(seq.images[i], 0, 255).astype(np.uint8))
        viewer.save_png(str(root / "depth" / name),
                        np.round(seq.depths[i] * 5000).astype(np.uint16))
        rows.append(f"{t:.6f} {{}}/{name}")
    for sub in ("rgb", "depth"):
        (root / f"{sub}.txt").write_text("\n".join(r.format(sub) for r in rows) + "\n")
    (root / "TUM1.yaml").write_text(
        "%YAML:1.0\nCamera.fx: 260.0\nCamera.fy: 260.0\nCamera.cx: 160.0\nCamera.cy: 120.0\n"
        "Camera.width: 320\nCamera.height: 240\nCamera.fps: 3.0\nCamera.bf: 26.0\n"
        "DepthMapFactor: 5000.0\nORBextractor.nFeatures: 400\n")
    return root, seq


def test_run_slam_tum_batches_equal_per_frame(tum_dir, tmp_path, capsys):
    """A TUM directory through the port's driver: depth is scaled to metres
    by the loader, so batches of 4 give the keyframes of the per-frame run
    (the JAX driver's batch path clips raw depth counts; not reproduced)."""
    root, seq = tum_dir
    runs = {}
    for batch in ("0", "4"):
        out = tmp_path / f"b{batch}.txt"
        assert run_slam.main(["--dataset", "tum", "--path", str(root), "--settings",
                              str(root / "TUM1.yaml"), "--no-vocab", "--device", "cpu",
                              "--batch", batch, "--output", str(out)]) == 0
        text = capsys.readouterr().out
        assert "state: 1" in text
        runs[batch] = (_keyframes(text), _read_tum_cw(out))
    assert runs["0"][0] == runs["4"][0] >= 2
    for kf, est in runs.values():
        assert len(est) == 9 and ate_rmse(est, seq.poses_gt) < 0.01
    assert np.abs(_centres(runs["0"][1]) - _centres(runs["4"][1])).max() < 0.02
