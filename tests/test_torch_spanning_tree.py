"""The covisibility spanning tree on a branching run, through the port,
against the JAX package (its tests/test_spanning_tree.py).

Map a sector, kidnap (3 blank frames), relocalize at the start view, then
branch the other way: keyframes after the branch are covisible with the
earliest keyframes, so their tree parents jump back across the sequence and
the essential graph's edges follow the tree, not the insertion order.  The
port runs the JAX test's scenario (320x240, 500 features, a k=8, L=3
vocabulary trained on the sector's frames, 22 + 3 + 22 frames per frame)
under the JAX test's three assertions.

Held exactly: essential_tree_edges of the JAX package and of the port on the
same map (the port's, moved through convert.py): integer work on equal
inputs.  Held as outcomes: the run itself, whose keypoints the JAX package
selects through its slab path on the CPU; its tree (each live keyframe's
seq and its parent's) is pinned below from the JAX run and the port's must
equal it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models import loop_closing as jlc
from self_commit_orb_slam2_tpu.models import map_state as jms
from self_commit_orb_slam2_tpu_torch import convert
from self_commit_orb_slam2_tpu_torch.models import config, loop_closing
from self_commit_orb_slam2_tpu_torch.models.system import STATE_OK, System
from self_commit_orb_slam2_tpu_torch.ops.bow import train_vocabulary
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig, extract
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

torch.set_num_threads(2)   # six test workers share the CPU

N_A, N_B = 22, 22
# python -m tests.test_torch_spanning_tree jax (the JAX package on the CPU):
# {seq: parent seq} of the live keyframes, and the last sector-A seq
JAX_TREE = {0: -1, 1: 0, 2: 1, 3: 2, 4: 0, 5: 0, 6: 5, 7: 6}
JAX_A_LAST = 3


def _lookat_pose(th: float, radius: float = 2.0) -> np.ndarray:
    target = np.array([0.0, 0.0, 3.0])
    c = target + np.array([radius * np.sin(th), 0.0, -radius * np.cos(th)])
    z = (target - c) / np.linalg.norm(target - c)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x = x / np.linalg.norm(x)
    Rwc = np.stack([x, np.cross(z, x), z], axis=1)
    T = np.eye(4)
    T[:3, :3] = Rwc.T
    T[:3, 3] = -Rwc.T @ c
    return T


def _branching_trajectory():
    ths_a = [0.55 * np.sin(2 * np.pi * i / 120) for i in range(N_A)]
    ths_b = [-0.030 * j for j in range(N_B)]   # branch from the start view
    return np.stack([_lookat_pose(t) for t in ths_a + ths_b]).astype(np.float32)


def branch_run(package: str):
    """The JAX test's fixture through either package: (map, last sector-A seq)."""
    seq = generate_sequence(width=320, height=240, seed=13, trajectory=_branching_trajectory())
    if package == "jax":
        from self_commit_orb_slam2_tpu.models import config as pkg_config
        from self_commit_orb_slam2_tpu.models.system import System as PkgSystem
        from self_commit_orb_slam2_tpu.ops.bow import train_vocabulary as train
        from self_commit_orb_slam2_tpu.ops.camera import CameraParams as Cam
        from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as Orb
        from self_commit_orb_slam2_tpu.ops.orb.extractor import extract as ex

        def feats(image, ocfg):
            return ex(jnp.asarray(image), ocfg)
        kw = {}
    else:
        pkg_config, PkgSystem, train, Cam, Orb = config, System, train_vocabulary, CameraParams, \
            OrbConfig

        def feats(image, ocfg):
            return extract(torch.as_tensor(np.asarray(image, np.float32)), ocfg)
        kw = dict(device="cpu")
    descs = []
    for i in range(0, N_A, 4):
        f = feats(seq.images[i], Orb(n_features=300))
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    vocab = train(np.concatenate(descs), k=8, L=3, seed=4)
    cam = Cam.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)
    slam = PkgSystem(pkg_config.SlamConfig(
        camera=cam, orb=Orb(n_features=500),
        caps=pkg_config.Capacities(max_keyframes=32, max_points=8192, local_points=1024),
        tracking=pkg_config.TrackingConfig(max_frames_between_kf=6), sensor="rgbd",
        vocab=vocab), **kw)
    for i in range(N_A):
        slam.track_rgbd(seq.images[i], seq.depths[i], i / 30.0)
    assert slam.state == STATE_OK
    a_last = int(np.asarray(slam.map.n_kf)) - 1
    blank = np.zeros_like(seq.images[0])
    for j in range(3):
        slam.track_rgbd(blank, seq.depths[0] * 0, 2.0 + j / 30.0)
    for j in range(N_B):
        slam.track_rgbd(seq.images[N_A + j], seq.depths[N_A + j], 3.0 + j / 30.0)
    assert slam.state == STATE_OK, "failed to relocalize and track the branch"
    return slam.map, a_last


def _tree(m) -> dict:
    valid, seq = np.asarray(m.kf_valid), np.asarray(m.kf_seq)
    parent = np.asarray(m.kf_tree_parent_seq)
    return {int(seq[s]): int(parent[s]) for s in np.nonzero(valid)[0]}


@pytest.fixture(scope="module")
def run():
    return branch_run("port")


def test_tree_parent_jumps_across_branch(run):
    m, seq_a_last = run
    kf_seq, parent = m.kf_seq.numpy(), m.kf_tree_parent_seq.numpy()
    branch_kfs = [s for s in np.nonzero(m.kf_valid.numpy())[0] if kf_seq[s] > seq_a_last]
    assert branch_kfs, "no keyframes created after the branch"
    first_b = min(branch_kfs, key=lambda s: kf_seq[s])
    assert parent[first_b] != kf_seq[first_b] - 1
    assert parent[first_b] <= seq_a_last // 2
    assert seq_a_last == JAX_A_LAST and _tree(m) == JAX_TREE


def test_tree_well_formed(run):
    m, _ = run
    kf_seq, parent = m.kf_seq.numpy(), m.kf_tree_parent_seq.numpy()
    live = np.nonzero(m.kf_valid.numpy())[0]
    assert all(parent[s] < kf_seq[s] for s in live if parent[s] >= 0)
    assert sum(parent[s] < 0 for s in live) >= 1, "no root keyframe"


def test_essential_edges_follow_tree(run):
    m, seq_a_last = run
    ei, ej, ev = (x.numpy() for x in loop_closing.essential_tree_edges(m))
    want = jlc.essential_tree_edges(jax.device_put(jms.MapState(**convert.state_to_numpy(m)[0])))
    for got_x, want_x in zip((ei, ej, ev), want):
        np.testing.assert_array_equal(got_x, np.asarray(want_x))
    kf_seq, kf_valid = m.kf_seq.numpy(), m.kf_valid.numpy()
    parent = m.kf_tree_parent_seq.numpy()
    seq_to_slot = {int(kf_seq[s]): s for s in np.nonzero(kf_valid)[0]}
    checked = 0
    for i, j, ok in zip(ei, ej, ev):
        if ok and int(parent[i]) in seq_to_slot:
            assert j == seq_to_slot[int(parent[i])]
            checked += 1
    assert checked >= 3, "too few tree edges verified"
    assert any(ok and kf_seq[i] > seq_a_last and kf_seq[j] <= seq_a_last // 2
               for i, j, ok in zip(ei, ej, ev)), "no essential edge crosses the branch"


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    m, a_last = branch_run(sys.argv[1] if len(sys.argv) > 1 else "jax")
    print(dict(tree=_tree(m), a_last=a_last))
