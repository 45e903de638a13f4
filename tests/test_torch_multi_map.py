"""The port's joint_refine and essential graph against the JAX package on
two maps the JAX System built
(tests/test_parallel.py:218-249's scenario: seeds 3 and 4, 12 frames at
320x240, 300 features, 16 keyframes x 4096 points), perturbed by N(0, 5e-3)
and carried over with convert.state_from_numpy.  The JAX side runs on its
8-virtual-device CPU mesh, the port at a world of one rank; poses within
1e-4 and points within 1e-3, the BA bounds of ROADMAP.md C(2).  The
sharded global BA of loop closing is tests/test_torch_sharded_gba.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models.config import Capacities as JCaps
from self_commit_orb_slam2_tpu.models.config import SlamConfig as JConfig
from self_commit_orb_slam2_tpu.models.system import System as JSystem
from self_commit_orb_slam2_tpu.ops import se3 as jse3
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb
from self_commit_orb_slam2_tpu.parallel.mesh import MeshSpec as JMeshSpec
from self_commit_orb_slam2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from self_commit_orb_slam2_tpu.parallel.multi_map import joint_refine as jax_joint_refine
from self_commit_orb_slam2_tpu.utils.synthetic import generate_sequence
from self_commit_orb_slam2_tpu_torch.convert import state_from_numpy
from self_commit_orb_slam2_tpu_torch.models.config import Capacities, SlamConfig
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from self_commit_orb_slam2_tpu_torch.parallel.multi_map import (
    MIN_COVIS_WEIGHT, build_essential_edges, joint_refine, stack_maps, unstack_maps)
from tests.test_torch_refine_maps import mean_reproj_err

torch.set_num_threads(2)   # six test workers share the CPU

CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)
JCFG = JConfig(camera=JCam.create(**CAM), orb=JOrb(n_features=300),
               caps=JCaps(max_keyframes=16, max_points=4096), sensor="rgbd")
CFG = SlamConfig(camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=300),
                 caps=Capacities(max_keyframes=16, max_points=4096), sensor="rgbd")


@pytest.fixture(scope="module")
def maps():
    """(JAX maps, the port's copies): each built by the JAX System, poses
    and points perturbed as test_parallel.py:232-241 perturbs them."""
    rng = np.random.default_rng(0)
    jmaps = []
    for seed in (3, 4):
        seq = generate_sequence(n_frames=12, width=320, height=240, seed=seed)
        slam = JSystem(JCFG)
        for i in range(12):
            slam.track_rgbd(seq.images[i], seq.depths[i], float(seq.timestamps[i]))
        m = slam.map
        noise = jnp.asarray(rng.normal(0, 5e-3, (m.kf_Tcw.shape[0], 6)).astype(np.float32))
        kf_new = jax.vmap(jse3.update_left)(m.kf_Tcw, noise).at[0].set(m.kf_Tcw[0])
        pt_new = m.pt_pos + jnp.asarray(rng.normal(0, 5e-3, m.pt_pos.shape).astype(np.float32))
        jmaps.append(m._replace(kf_Tcw=kf_new, pt_pos=pt_new))
    ours = [state_from_numpy(jax.tree.map(np.asarray, m), None, "cpu")[0] for m in jmaps]
    return jmaps, ours


def _close(got, ref):
    np.testing.assert_allclose(got.kf_Tcw.numpy(), np.asarray(ref.kf_Tcw), atol=1e-4)
    np.testing.assert_allclose(got.pt_pos.numpy(), np.asarray(ref.pt_pos), atol=1e-3)


def test_joint_refine_matches_jax(maps):
    """The whole refinement (essential graph, pose graph, point transfer,
    BA) against the JAX package's, and the JAX test's bar: the reprojection
    error falls below 0.2x its value before."""
    jmaps, ours = maps
    ref = jax_joint_refine(jax_make_mesh(JMeshSpec(n_map=2, n_blk=4)), JCFG, jmaps, ba_iters=10)
    got = joint_refine(make_mesh(MeshSpec(1, 1)), CFG, ours, ba_iters=10)
    for g, r, m in zip(got, ref, ours):
        _close(g, r)
        assert mean_reproj_err(CFG.camera, g) < 0.2 * mean_reproj_err(CFG.camera, m)
        for f in ("kf_obs_pt", "pt_valid", "kf_valid", "n_kf", "n_pt"):
            assert torch.equal(getattr(g, f), getattr(m, f)), f


def test_essential_edges_and_stacking(maps):
    """The essential graph's edges equal the JAX package's (pairs exactly,
    measurements within 1e-5); loop edges need a measurement; stacking
    round-trips."""
    from self_commit_orb_slam2_tpu.parallel.multi_map import (
        build_essential_edges as jax_edges, stack_maps as jax_stack)

    jmaps, ours = maps
    m = stack_maps(ours)
    assert [torch.equal(a, b) for a, b in zip(unstack_maps(m, 2)[1], ours[1])] == [True] * len(m)
    for weight in (MIN_COVIS_WEIGHT, 20):
        ref = jax_edges(jax_stack(jmaps), 64, min_weight=weight)
        got = build_essential_edges(m, 64, min_weight=weight)
        for g, r in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-5)
    loop = np.array([[2, -1], [1, -1]]), np.array([[0, -1], [0, -1]])
    with pytest.raises(ValueError, match="measurements"):
        build_essential_edges(m, 64, *loop)
    meas = np.tile(np.array([0, 0, 0, 1, 0.1, 0, 0, 1], np.float32), (2, 2, 1))
    ei, ej, me, ok = build_essential_edges(m, 64, *loop, extra_meas=meas)
    n = int(ok[0].sum())
    assert (int(ei[0, n - 1]), int(ej[0, n - 1])) == (2, 0)
    assert torch.equal(me[0, n - 1], torch.from_numpy(meas[0, 0]))
