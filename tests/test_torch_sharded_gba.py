"""loop_closing.run_sharded_gba and the closer's sharded global-BA branch
through the port, against the JAX package's run_sharded_gba on one small
map (test_parallel.py:218-249's seed 3, 20 frames at 320x240, 300 features, 16
keyframes x 4096 points) built by the port's System on the CPU and carried
to the JAX package with convert.state_to_numpy, its poses and points
perturbed by N(0, 5e-3).  The JAX side runs on its 8-virtual-device CPU mesh
(1 x 8), the port at a world of one rank; poses within 1e-4 and points
within 1e-3, the BA bounds of ROADMAP.md C(2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models import loop_closing as jloop
from self_commit_orb_slam2_tpu.models.config import Capacities as JCaps
from self_commit_orb_slam2_tpu.models.config import SlamConfig as JConfig
from self_commit_orb_slam2_tpu.models.map_state import MapState as JMapState
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb
from self_commit_orb_slam2_tpu_torch.convert import state_to_numpy
from self_commit_orb_slam2_tpu_torch.models import loop_closing
from self_commit_orb_slam2_tpu_torch.models.config import Capacities, SlamConfig
from self_commit_orb_slam2_tpu_torch.models.system import System
from self_commit_orb_slam2_tpu_torch.ops import bow, se3
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence
from tests.test_torch_refine_maps import mean_reproj_err

torch.set_num_threads(2)   # six test workers share the CPU

CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)
JCFG = JConfig(camera=JCam.create(**CAM), orb=JOrb(n_features=300),
               caps=JCaps(max_keyframes=16, max_points=4096), sensor="rgbd")
CFG = SlamConfig(camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=300),
                 caps=Capacities(max_keyframes=16, max_points=4096), sensor="rgbd")


@pytest.fixture(scope="module")
def small_map():
    """The port's map and the JAX package's copy of it."""
    rng = np.random.default_rng(0)
    seq = generate_sequence(n_frames=20, width=320, height=240, seed=3)
    slam = System(CFG, enable_loop_closing=False, device="cpu")
    for i in range(20):
        slam.track_rgbd(seq.images[i], seq.depths[i], float(seq.timestamps[i]))
    m = slam.map
    assert int(m.kf_valid.sum()) >= 3
    noise = torch.from_numpy(rng.normal(0, 5e-3, (m.max_kf, 6)).astype(np.float32))
    kf = se3.update_left(m.kf_Tcw, noise)
    kf[0] = m.kf_Tcw[0]
    m = m._replace(kf_Tcw=kf, pt_pos=m.pt_pos + torch.from_numpy(
        rng.normal(0, 5e-3, tuple(m.pt_pos.shape)).astype(np.float32)))
    arrays, _ = state_to_numpy(m)
    return m, JMapState(**{k: jnp.asarray(arrays[k]) for k in JMapState._fields})


def test_run_sharded_gba_matches_jax(small_map):
    """loop_closing.run_sharded_gba on one map: the JAX package's on its 1 x 8
    mesh, the port's on the world of one rank; anchor keyframe 1."""
    m, jm = small_map
    T_ref, p_ref = jloop.run_sharded_gba(JCFG, jm, 1)
    T, p = loop_closing.run_sharded_gba(CFG, m, 1)
    np.testing.assert_allclose(T.numpy(), np.asarray(T_ref), atol=1e-4)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=1e-3)
    # slot 0 and the anchor stay, the other live keyframes move
    assert torch.equal(T[:2], m.kf_Tcw[:2])
    refined = m._replace(kf_Tcw=T, pt_pos=p)
    assert mean_reproj_err(CFG.camera, refined) < mean_reproj_err(CFG.camera, m)


def test_loop_closer_takes_sharded_branch(small_map, monkeypatch):
    """A map forced onto the sharded branch: _dispatch_gba runs the sharded
    global BA at once (no slices), the next resolve merges it, and the live
    map takes its poses and points (the snapshot is the live map here)."""
    m, _ = small_map
    tiny = bow.from_arrays(np.zeros((3, 8), np.uint32), np.array([[1, 2], [-1, -1], [-1, -1]]),
                           np.array([-1, 0, 1]), np.ones(2, np.float32), 2, 1, 2, 0)
    lc = loop_closing.LoopCloser(CFG._replace(vocab=tiny))
    monkeypatch.setattr(loop_closing, "_needs_sharded_gba", lambda config, mm: True)
    lc._dispatch_gba(m, 2)
    g = lc._pending_gba
    assert g["path"] == "sharded" and g["phase"] == len(loop_closing.GBA_SLICES)
    assert "snap" not in g and lc.pending() == 1
    T, p = loop_closing.run_sharded_gba(CFG, m, 2)
    out, fired = lc.resolve(m)
    assert lc.pending() == 0 and lc.last_gba_info["gba_path"] == "sharded"
    assert len(fired) == 1
    np.testing.assert_allclose(out.kf_Tcw.numpy(), T.numpy(), atol=1e-6)
    live = m.pt_valid
    np.testing.assert_allclose(out.pt_pos[live].numpy(), p[live].numpy(), atol=1e-6)
