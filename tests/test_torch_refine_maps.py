"""The port's refine_maps CLI (tests/test_parallel.py:280-319's scenario,
built and refined through the port on the CPU at a world of one rank)."""

import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams

torch.set_num_threads(2)   # six test workers share the CPU


def mean_reproj_err(cam, m) -> float:
    """Mean squared reprojection error (px^2) over a map's live observations
    in front of the camera (test_parallel.py:201-215 in torch)."""
    from self_commit_orb_slam2_tpu_torch.ops.camera import project

    P = m.pt_pos.shape[0]
    pid = torch.clamp(m.kf_obs_pt, 0, P - 1).long()
    active = (m.kf_obs_pt >= 0) & m.kf_feat_valid & m.kf_valid[:, None] & m.pt_valid[pid]
    pc = torch.einsum("kij,knj->kni", m.kf_Tcw[:, :3, :3], m.pt_pos[pid]) \
        + m.kf_Tcw[:, None, :3, 3]
    uv, z = project(cam, pc)
    err = torch.sum((uv - m.kf_xy) ** 2, -1)
    w = (active & (z > 0.05)).to(torch.float32)
    return float(torch.sum(err * w) / torch.clamp_min(torch.sum(w), 1.0))


def test_refine_maps_cli(rng, tmp_path):
    """test_parallel.py:280-319 through the port: the offline refine CLI
    round-trips checkpoints and reduces the reprojection error; maps of
    different capacities return 2 (a point capacity the blk width does not
    divide: tests/test_torch_gloo.py); groups are padded to n_map."""
    from self_commit_orb_slam2_tpu_torch.models.checkpoint import load_map, save_map
    from self_commit_orb_slam2_tpu_torch.models.config import Capacities, SlamConfig
    from self_commit_orb_slam2_tpu_torch.models.system import System
    from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
    from self_commit_orb_slam2_tpu_torch.refine_maps import main
    from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

    cam = CameraParams.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0,
                              width=320, height=240)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=300),
                     caps=Capacities(max_keyframes=16, max_points=4096), sensor="rgbd")
    paths = []
    for seed in (5, 6):
        seq = generate_sequence(n_frames=10, width=320, height=240, seed=seed)
        slam = System(cfg, device="cpu")
        for i in range(10):
            slam.track_rgbd(seq.images[i], seq.depths[i], float(seq.timestamps[i]))
        m = slam.map
        noise = torch.from_numpy(rng.normal(0, 4e-3, m.pt_pos.shape).astype(np.float32))
        m = m._replace(pt_pos=m.pt_pos + noise)
        p = str(tmp_path / f"m{seed}.npz")
        save_map(p, m)
        paths.append(p)

    yml = tmp_path / "cam.yaml"
    yml.write_text("%YAML:1.0\nCamera.fx: 260.0\nCamera.fy: 260.0\n"
                   "Camera.cx: 160.0\nCamera.cy: 120.0\nCamera.bf: 26.0\n"
                   "Camera.width: 320\nCamera.height: 240\n")
    before = [mean_reproj_err(cfg.camera, load_map(p, device="cpu")) for p in paths]
    # one map per group on the 1x1 mesh of this world, the second padded to n_map
    assert main(paths + ["--settings", str(yml), "--mesh", "1x1", "--device", "cpu"]) == 0
    after = [mean_reproj_err(cfg.camera, load_map(p[:-4] + ".refined.npz", device="cpu"))
             for p in paths]
    for b, a in zip(before, after):
        assert a < b * 0.5, (b, a)
    # the BA alone, under another suffix
    assert main(paths[:1] + ["--settings", str(yml), "--no-pose-graph", "--suffix", ".ba.npz",
                             "--ba-iters", "3", "--device", "cpu"]) == 0
    ba_only = load_map(paths[0][:-4] + ".ba.npz", device="cpu")
    assert mean_reproj_err(cfg.camera, ba_only) < before[0]

    small = str(tmp_path / "small.npz")
    save_map(small, System(cfg._replace(caps=Capacities(max_keyframes=8, max_points=4000)),
                           device="cpu").map)
    assert main([paths[0], small, "--settings", str(yml), "--device", "cpu"]) == 2
    with pytest.raises(ValueError, match="needs 2 devices"):
        main([small, "--settings", str(yml), "--mesh", "1x2", "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(paths)   # --settings is required
