"""pose_optimize's CUDA kernel (csrc/pose_opt.cu) and the custom op around it.

The CPU tests hold the op `slam_torch::pose_optimize` to the plain version:
its CPU implementation pose by pose, bitwise, and its vmap rule against a
Python loop, bitwise.  The tests marked `card` hold the kernel to the plain
version on the card: Tcw within 1e-4 and the inliers within 2 rows (the
kernel sums the normal equations in another order than torch.einsum, which
can move a row across the chi2 threshold), and to itself bitwise.  They skip
without a card.  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m card tests/test_torch_pose_kernel.py
"""

import re

import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu_torch.ops import se3
from self_commit_orb_slam2_tpu_torch.ops.optim import pose_opt
from self_commit_orb_slam2_tpu_torch.tools.time_pose_opt import CAM, pose_problem
from self_commit_orb_slam2_tpu_torch.utils import profiling

OP = torch.ops.slam_torch.pose_optimize


def _assert_close(got, ref, T_true=None, inlier_rows: int = 2):
    got = [t.cpu() for t in got]
    ref = [t.cpu() for t in ref]
    assert float((got[0] - ref[0]).abs().max()) <= 1e-4
    assert int((got[1] != ref[1]).sum()) <= inlier_rows
    assert abs(int(got[2]) - int(ref[2])) <= inlier_rows
    assert int(got[2]) == int(got[1].sum())
    if T_true is not None:   # and it converged
        assert float(np.abs(got[0].numpy() - T_true).max()) < 0.02


# ------------------------------------------------------------------ the CPU


@pytest.mark.parametrize("kind,n", [("rgbd", 300), ("stereo", 257), ("mixed", 300)])
def test_op_on_the_cpu_equals_the_plain_version_bitwise(kind, n):
    _, args, urw = pose_problem(kind, n)
    ref = pose_opt.pose_optimize_plain(CAM, *args, ur_weight=urw)
    got = OP(*(a[None] for a in args), pose_opt._camera(CAM), 4, 10, 1e-5, urw)
    for a, b in zip(ref, got):
        assert b.shape == (1, *a.shape) and torch.equal(a, b[0])


def test_op_vmap_over_five_poses_equals_a_loop_bitwise():
    """Relocalization's shape: five initial poses and selections, the
    observations and variances shared (not mapped over)."""
    T_true, (T0, pts, obs, sigma2, valid), urw = pose_problem("mixed", 300)
    rng = np.random.default_rng(1)
    T0s = torch.stack([se3.se3_exp(torch.from_numpy(rng.normal(0, 0.01, 6).astype(np.float32)))
                       @ T0 for _ in range(5)])
    pts5 = pts[None].repeat(5, 1, 1) + torch.from_numpy(rng.normal(0, 1e-3, (5, 300, 3))
                                                        .astype(np.float32))
    sel = valid[None] & torch.from_numpy(rng.random((5, 300)) < 0.8)

    def one(T, p, s):
        out = OP(T[None], p[None], obs[None], sigma2[None], s[None], pose_opt._camera(CAM),
                 4, 10, 1e-5, urw)
        return tuple(o[0] for o in out)

    got = torch.vmap(one)(T0s, pts5, sel)
    loop = [pose_opt.pose_optimize_plain(CAM, T0s[i], pts5[i], obs, sigma2, sel[i],
                                         ur_weight=urw) for i in range(5)]
    for k in range(4):
        assert torch.equal(got[k], torch.stack([r[k] for r in loop]))
    for r in loop:
        _assert_close(r, r, T_true)


def test_op_vmap_folds_into_a_batch_of_poses():
    """The op called on a batch of 2 inside a vmap of 3: 6 poses, each the
    plain version's."""
    _, (T0, pts, obs, sigma2, valid), urw = pose_problem("rgbd", 130)
    T0s = torch.stack([T0 * 1.0 for _ in range(6)])
    T0s[:, :3, 3] += torch.linspace(-0.02, 0.02, 6)[:, None]
    got = torch.vmap(lambda T: OP(T, pts[None].expand(2, -1, -1), obs[None].expand(2, -1, -1),
                                  sigma2[None].expand(2, -1), valid[None].expand(2, -1),
                                  pose_opt._camera(CAM), 4, 10, 1e-5, urw))(T0s.view(3, 2, 4, 4))
    assert got[0].shape == (3, 2, 4, 4) and got[2].shape == (3, 2)
    for i in range(6):
        ref = pose_opt.pose_optimize_plain(CAM, T0s[i], pts, obs, sigma2, valid, ur_weight=urw)
        for k in range(4):
            assert torch.equal(got[k].reshape(6, *got[k].shape[2:])[i], ref[k])


def test_pose_optimize_on_the_cpu_takes_the_plain_version_and_counts_calls():
    _, args, urw = pose_problem("rgbd", 200)
    launches = pose_opt.kernel.launches
    with profiling.tracing() as trace:
        got = pose_opt.pose_optimize(CAM, *args, ur_weight=urw)
        got5 = torch.vmap(lambda T: pose_opt.pose_optimize(CAM, T, *args[1:], ur_weight=urw))(
            args[0][None].repeat(5, 1, 1))
        assert trace.counts["pose_opt.calls"] == 2   # one a call, vmapped or not
    ref = pose_opt.pose_optimize_plain(CAM, *args, ur_weight=urw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert got5.Tcw.shape == (5, 4, 4)
    assert pose_opt.kernel.launches == launches   # the CPU never launches


def test_plain_version_counts_the_iterations_the_freeze_rule_runs():
    """`iterations=` takes one count a round and leaves the result bitwise
    as it is; from the pose the optimization converged to, each round
    freezes at its first step."""
    _, args, urw = pose_problem("rgbd", 200)
    rounds: list = []
    got = pose_opt.pose_optimize_plain(CAM, *args, ur_weight=urw, iterations=rounds)
    ref = pose_opt.pose_optimize_plain(CAM, *args, ur_weight=urw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert len(rounds) == 4 and all(1 <= n <= 10 for n in rounds) and sum(rounds) > 4
    again: list = []
    pose_opt.pose_optimize_plain(CAM, got.Tcw, *args[1:], ur_weight=urw, iterations=again)
    assert again == [1, 1, 1, 1]


def test_op_on_the_meta_device_gives_the_shapes():
    _, args, urw = pose_problem("stereo", 140)
    out = OP(*(a[None].expand(3, *a.shape).to("meta") for a in args), pose_opt._camera(CAM),
             4, 10, 1e-5, urw)
    assert [tuple(o.shape) for o in out] == [(3, 4, 4), (3, 140), (3,), (3, 140)]
    assert [o.dtype for o in out] == [torch.float32, torch.bool, torch.int32, torch.float32]


def test_op_refuses_what_the_kernel_does_not_take():
    _, (T0, pts, obs, sigma2, valid), _ = pose_problem("rgbd", 64)
    with pytest.raises(ValueError, match="valid must"):
        pose_opt._check(T0[None], pts[None], obs[None], sigma2[None], valid[None].float())
    with pytest.raises(ValueError, match="pts_w must"):
        pose_opt._check(T0[None], pts[None, :, :2], obs[None], sigma2[None], valid[None])
    big = pose_opt.MAX_ROWS + 1
    with pytest.raises(ValueError, match="at most"):
        pose_opt._check(T0[None], torch.zeros(1, big, 3), torch.zeros(1, big, 3),
                        torch.ones(1, big), torch.ones(1, big, dtype=torch.bool))
    src = pose_opt.kernel.source.read_text()
    assert int(re.search(r"kMaxRows = (\d+);", src).group(1)) == pose_opt.MAX_ROWS


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("kind,n", [("rgbd", 1024), ("stereo", 2048), ("mixed", 1024),
                                    ("mixed", 1500), ("mixed", 4096)])
def test_kernel_matches_the_plain_version(cuda, kind, n):
    T_true, args, urw = pose_problem(kind, n)
    args = tuple(a.to(cuda) for a in args)
    before = pose_opt.kernel.launches
    got = pose_opt.pose_optimize(CAM, *args, ur_weight=urw)
    torch.cuda.synchronize()
    assert pose_opt.kernel.launches == before + 1
    ref = pose_opt.pose_optimize_plain(CAM, *args, ur_weight=urw)
    _assert_close(got, ref, T_true)
    assert bool(((got.chi2 - ref.chi2).abs() <= 1e-2 * (1 + ref.chi2.abs())).all())


@pytest.mark.card
def test_kernel_under_vmap_is_one_launch_of_five_poses(cuda):
    T_true, (T0, pts, obs, sigma2, valid), urw = pose_problem("mixed", 1024)
    rng = np.random.default_rng(2)
    T0s = torch.stack([se3.se3_exp(torch.from_numpy(rng.normal(0, 0.01, 6).astype(np.float32)))
                       @ T0 for _ in range(5)]).to(cuda)
    sel = (valid[None] & torch.from_numpy(rng.random((5, 1024)) < 0.8)).to(cuda)
    pts, obs, sigma2 = pts.to(cuda), obs.to(cuda), sigma2.to(cuda)
    before = pose_opt.kernel.launches
    got = torch.vmap(lambda T, s: pose_opt.pose_optimize(CAM, T, pts, obs, sigma2, s,
                                                         ur_weight=urw))(T0s, sel)
    torch.cuda.synchronize()
    assert pose_opt.kernel.launches == before + 1
    assert got.Tcw.shape == (5, 4, 4) and got.n_inliers.shape == (5,)
    for i in range(5):
        ref = pose_opt.pose_optimize_plain(CAM, T0s[i], pts, obs, sigma2, sel[i], ur_weight=urw)
        _assert_close([t[i] for t in got], ref, T_true)


@pytest.mark.card
def test_the_card_counts_the_launches_it_runs(cuda):
    """pose_opt.device_launches: one a launch, whatever its batch, and one
    a graph replay, which the wrapper's count does not see."""
    _, args, urw = pose_problem("stereo", 2048)
    static = tuple(a.to(cuda) for a in args)
    pose_opt.pose_optimize(CAM, *static, ur_weight=urw)   # built and loaded
    pose_opt.device_launches(reset=True)
    pose_opt.pose_optimize(CAM, *static, ur_weight=urw)
    torch.vmap(lambda T: pose_opt.pose_optimize(CAM, T, *static[1:], ur_weight=urw))(
        static[0][None].repeat(3, 1, 1))
    assert pose_opt.device_launches() == 2
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        pose_opt.pose_optimize(CAM, *static, ur_weight=urw)
    assert pose_opt.device_launches() == 2   # a capture runs nothing
    wrapper = pose_opt.kernel.launches
    for _ in range(3):
        graph.replay()
    assert pose_opt.device_launches(reset=True) == 5
    assert pose_opt.kernel.launches == wrapper and pose_opt.device_launches() == 0


@pytest.mark.card
def test_kernel_repeats_bit_for_bit_and_from_a_graph(cuda):
    _, args, urw = pose_problem("mixed", 2048, seed=3)
    static = tuple(a.to(cuda) for a in args)
    first = pose_opt.pose_optimize(CAM, *static, ur_weight=urw)
    again = pose_opt.pose_optimize(CAM, *static, ur_weight=urw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pose_opt.pose_optimize(CAM, *static, ur_weight=urw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = pose_opt.kernel.launches
    with torch.cuda.graph(graph):
        out = pose_opt.pose_optimize(CAM, *static, ur_weight=urw)
    assert pose_opt.kernel.launches == before + 1   # recorded once
    graph.replay()
    torch.cuda.synchronize()
    for a, b, c in zip(first, again, out):
        assert torch.equal(a, b) and torch.equal(a, c)
    # new inputs copied into the static ones: the replay against op by op
    _, args2, _ = pose_problem("mixed", 2048, seed=4)
    for s, a in zip(static, args2):
        s.copy_(a)
    graph.replay()
    ref = pose_opt.pose_optimize(CAM, *static, ur_weight=urw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
