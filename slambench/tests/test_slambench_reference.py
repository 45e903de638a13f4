"""The plain reference: the frozen extractor agrees bit for bit with the
program's extraction on the same batch, and the truth functions read
zero on exact inputs and the right amount on known errors."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from slambench.harness import frames, spec
from slambench.harness import settings as st
from slambench.reference import features, truth
from slambench.scene import room
from slambench.tests import toy


@pytest.fixture(scope="module")
def small():
    cfg = spec.config("tum1_rgbd")
    s = st.read({**cfg, "changed": toy.changed("tum1_rgbd")})
    return s, frames.make_cycle(s, "rgbd", 99, 6, "cpu")


def _program_features(images, s):
    from self_commit_orb_slam2_tpu_torch.ops.orb import extractor

    orb = extractor.OrbConfig(n_features=int(s["ORBextractor.nFeatures"]))
    f, _ = extractor.extract_batch(torch.as_tensor(images.astype(np.float32)), orb)
    return f


@pytest.mark.parametrize("batch", [1, 4])
def test_frozen_extractor_matches_the_program(small, batch):
    s, cycle = small
    imgs = cycle.left[:batch]
    ref = features.extract(imgs, s, "cpu")
    f = _program_features(imgs, s)
    for b in range(batch):
        prog = dict(xy=f.xy[b].numpy(), level=f.level[b].numpy(), desc=f.desc[b].numpy(),
                    valid=f.valid[b].numpy())
        assert prog["valid"].sum() > 300
        assert features.differing_rows(prog, {k: v[b] for k, v in ref.items()}) == 0
        prog["desc"] = prog["desc"].copy()
        prog["desc"][np.nonzero(prog["valid"])[0][0], 3] ^= 4
        assert features.differing_rows(prog, {k: v[b] for k, v in ref.items()}) == 1


def test_lower_precision_control_changes_the_features(small):
    s, cycle = small
    ref = features.extract(cycle.left[:1], s, "cpu")
    ctl = features.extract(cycle.left[:1], s, "cpu", storage=torch.bfloat16)
    assert features.differing_rows({k: v[0] for k, v in ctl.items()},
                                   {k: v[0] for k, v in ref.items()}) > 100


def test_pose_errors_read_what_was_put_in():
    poses = room.lookat_trajectory(20)
    gt = truth.in_first_frame(poses, poses[0])
    t, r = truth.relative_errors(gt, gt)
    assert t.max() < 1e-12 and r.max() < 1e-6
    moved = gt.copy()
    moved[7] = np.eye(4)   # frame 7 reports the first pose
    t, _ = truth.relative_errors(moved, gt)
    assert t[6] > 0.01 and t[7] > 0.01
    a = np.radians(0.5)
    R = np.eye(4)
    R[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
    _, r = truth.pose_errors(R[None] @ gt[:1], gt[:1])
    assert abs(r[0] - 0.5) < 1e-9


def test_surface_distance(small):
    _, cycle = small
    pl = cycle.scene.planes[0]
    on = pl.origin + 0.3 * pl.u_axis + 0.6 * pl.v_axis
    off = on + 0.01 * pl.normal()
    d = truth.surface_distance(np.stack([on, off]), cycle.scene)
    assert d[0] < 1e-12 and abs(d[1] - 0.01) < 1e-9


def _rotation(axis, deg):
    """Rodrigues: the rotation of `deg` degrees about `axis`."""
    k = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    a = np.radians(deg)
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def test_align_sim3_recovers_a_known_similarity():
    poses = room.lookat_trajectory(40)
    gt = truth.in_first_frame(poses, poses[0])
    U, _, Vt = np.linalg.svd(gt[:, :3, :3])   # rigid to float64's rounding, not float32's
    gt[:, :3, :3] = U @ Vt
    R = _rotation([0.3, -1.0, 0.5], 30.0)
    t = np.array([0.8, -2.5, 1.7])
    est = truth.sim3_poses(gt, 0.37, R, t)   # a world at 0.37 of the truth's scale
    centres = truth.inv_se3(est)[:, :3, 3]
    s_fit, R_fit, t_fit = truth.align_sim3(centres, truth.inv_se3(gt)[:, :3, 3])
    assert abs(s_fit * 0.37 - 1.0) < 1e-9
    assert np.abs(R_fit - R.T).max() < 1e-9
    assert np.abs(t_fit + R.T @ t / 0.37).max() < 1e-9
    at, ar = truth.pose_errors(truth.sim3_poses(est, s_fit, R_fit, t_fit), gt)
    rt, rr = truth.relative_errors(truth.sim3_poses(est, s_fit, R_fit, t_fit), gt)
    assert at.max() * 1e3 < 1e-6 and rt.max() * 1e3 < 1e-6
    assert ar.max() < 1e-6 and rr.max() < 1e-6
    p = np.random.default_rng(0).normal(size=(50, 3))
    back = truth.sim3_points(truth.sim3_points(p, 0.37, R, t), s_fit, R_fit, t_fit)
    assert np.abs(back - p).max() < 1e-9


def test_align_sim3_refuses_what_fixes_no_similarity():
    line = np.outer(np.linspace(0.0, 2.0, 10), [1.0, 2.0, -0.5]) + [0.3, 0.1, 4.0]
    plane = np.random.default_rng(1).normal(size=(10, 3))
    for src, dst in [(line, plane), (plane, line), (plane[:2], plane[:2]),
                     (np.zeros((5, 3)), plane[:5])]:
        with pytest.raises(ValueError):
            truth.align_sim3(src, dst)
    truth.align_sim3(plane[:3], plane[:3] * 2.0)   # three points in general position suffice
