"""The port's relocalization against the JAX package's, on one map.

The JAX System (320x240, 500 features, a k=8 L=3 vocabulary trained on the
sequence, local mapping on) maps 14 frames; its map, carry and vocabulary
move into the port through convert.py, and both packages get the same frames
(built by the JAX extractor).

  * detect_reloc_candidates: slots and active flags exact.
  * relocalize draws its RANSAC sets from another random stream, so it is
    compared by outcome: on a mapped view both succeed, camera centres within
    0.02 m of each other, inlier counts within 10%; on a blank frame both
    fail (and the port raises nothing with every candidate inactive).
  * track_motion_loc: pose within 1e-4, inliers and map inliers within 2.
  * _frame_bow: the keyframes' BoW rows, words and nodes the JAX System
    stored are what the port computes from the stored descriptors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models import config as jconfig
from self_commit_orb_slam2_tpu.models import frame as jframe
from self_commit_orb_slam2_tpu.models import relocalization as jreloc
from self_commit_orb_slam2_tpu.models import system as jsystem
from self_commit_orb_slam2_tpu.models import tracking as jtracking
from self_commit_orb_slam2_tpu.ops import bow as jbow
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb
from self_commit_orb_slam2_tpu.ops.orb.extractor import extract as jextract
from self_commit_orb_slam2_tpu.utils.synthetic import generate_sequence
from self_commit_orb_slam2_tpu_torch import convert
from self_commit_orb_slam2_tpu_torch.models import config, relocalization, tracking
from self_commit_orb_slam2_tpu_torch.models.frame import FrameData
from self_commit_orb_slam2_tpu_torch.ops import bow
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig

CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)
CAPS = dict(max_keyframes=32, max_points=8192, local_points=1024)
N_MAPPED = 14


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _centre(T):
    T = np.asarray(T)
    return -T[:3, :3].T @ T[:3, 3]


@pytest.fixture(scope="module")
def world():
    seq = generate_sequence(n_frames=20, width=320, height=240, seed=5)
    descs = []
    for i in range(0, 20, 4):
        f = jextract(jnp.asarray(seq.images[i]), JOrb(n_features=300))
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    jvocab = jbow.train_vocabulary(np.concatenate(descs), k=8, L=3, seed=2)
    jcfg = jconfig.SlamConfig(
        camera=JCam.create(**CAM), orb=JOrb(n_features=500),
        caps=jconfig.Capacities(**CAPS),
        tracking=jconfig.TrackingConfig(max_frames_between_kf=8), vocab=jvocab)
    jsys = jsystem.System(jcfg, enable_mapping=True, enable_loop_closing=False)
    for i in range(N_MAPPED):
        jsys.track_rgbd(seq.images[i], seq.depths[i], float(i) / 30.0)
    assert jsys.state == 1 and jsys.n_keyframes() >= 2
    jmap, jcarry = _np(jsys.map), _np(jsys.carry)
    traj = [np.asarray(T) for _, T in jsys.trajectory]

    vocab = convert.vocabulary_from_numpy(
        {f: getattr(jvocab, f) for f in jvocab._fields if f != "child_desc"})
    cfg = config.SlamConfig(
        camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=500),
        caps=config.Capacities(**CAPS),
        tracking=config.TrackingConfig(max_frames_between_kf=8), vocab=vocab)
    m, carry = convert.state_from_numpy(jmap, jcarry, "cpu")

    make = jax.jit(functools.partial(jframe.make_frame_rgbd, jcfg))
    jframes = {i: _np(make(jnp.asarray(seq.images[i]), jnp.asarray(seq.depths[i])))
               for i in (4, 9, 13, N_MAPPED)}
    jframes["blank"] = _np(make(jnp.zeros_like(jnp.asarray(seq.images[0])),
                                jnp.zeros_like(jnp.asarray(seq.depths[0]))))
    frames = {k: convert.frame_from_numpy(f, "cpu") for k, f in jframes.items()}
    return dict(jcfg=jcfg, cfg=cfg, jmap=jmap, jcarry=jcarry, m=m, carry=carry,
                jframes=jframes, frames=frames, traj=traj)


def test_frame_bow_rows_of_the_jax_keyframes(world):
    """Every keyframe the JAX System inserted: the port's _frame_bow on its
    stored descriptors gives the stored row (ids, words, nodes exact;
    weights 1e-6)."""
    m, cfg = world["m"], world["cfg"]
    slots = torch.nonzero(m.kf_valid)[:, 0].tolist()
    assert len(slots) >= 2
    for k in slots:
        kf = FrameData(xy=m.kf_xy[k], xy_raw=m.kf_xy[k], response=m.kf_angle[k],
                       angle=m.kf_angle[k], level=m.kf_level[k], desc=m.kf_desc[k],
                       valid=m.kf_feat_valid[k], u_right=m.kf_uright[k], depth=m.kf_depth[k])
        (ids, vals), words, nodes = tracking._frame_bow(cfg, kf)
        assert torch.equal(ids, m.kf_bow_ids[k]) and int((ids >= 0).sum()) > 50
        assert torch.equal(words, m.kf_word[k]) and torch.equal(nodes, m.kf_node[k])
        np.testing.assert_allclose(vals.numpy(), m.kf_bow_vals[k].numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", [4, 9, 13, "blank"])
def test_detect_reloc_candidates_exact(which, world):
    jcfg, cfg = world["jcfg"], world["cfg"]
    jf, f = world["jframes"][which], world["frames"][which]

    @jax.jit
    def jdetect(m, desc, valid):
        words, _ = jbow.transform(jcfg.vocab, desc, valid)
        q_ids, q_vals = jbow.sparse_bow(jcfg.vocab, words, jcfg.bow_top)
        return jreloc.detect_reloc_candidates(jcfg, m, q_ids, q_vals)

    jslots, jactive = jdetect(world["jmap"], jf.desc, jf.valid)
    words, _ = bow.transform(cfg.vocab, f.desc, f.valid)
    slots, active = relocalization.detect_reloc_candidates(
        cfg, world["m"], *bow.sparse_bow(cfg.vocab, words, cfg.bow_top))
    np.testing.assert_array_equal(active.numpy(), np.asarray(jactive))
    np.testing.assert_array_equal(slots.numpy(), np.asarray(jslots))
    assert slots.dtype == torch.int32 and slots.shape == (relocalization.N_CANDIDATES,)
    assert bool(active.any()) == (which != "blank")


@pytest.fixture(scope="module")
def jrelocalize(world):
    return jax.jit(functools.partial(jreloc.relocalize, world["jcfg"]))


@pytest.mark.parametrize("which", [4, 9])
def test_relocalize_mapped_view_both_succeed(which, world, jrelocalize):
    jres = jrelocalize(world["jmap"], world["jframes"][which], jax.random.PRNGKey(0))
    relocalization.reset_counts()
    res = relocalization.relocalize(world["cfg"], world["m"], world["frames"][which],
                                    torch.Generator().manual_seed(0))
    assert bool(jres.success) and bool(res.success)
    assert relocalization.counts() == (1, 1)
    assert np.linalg.norm(_centre(res.Tcw) - _centre(jres.Tcw)) < 0.02
    assert np.linalg.norm(_centre(res.Tcw) - _centre(world["traj"][which])) < 0.05
    assert abs(int(res.n_inliers) - int(jres.n_inliers)) <= 0.1 * int(jres.n_inliers)
    assert int(res.n_inliers) == int((res.obs_pt >= 0).sum()) >= 50
    # the matched ids are points of the map
    ids = res.obs_pt[res.obs_pt >= 0].long()
    assert bool(world["m"].pt_valid[ids].all())


def test_relocalize_blank_frame_both_fail(world, jrelocalize):
    """No valid feature: every candidate inactive, every probability zero.
    Neither package succeeds and the port raises nothing."""
    jres = jrelocalize(world["jmap"], world["jframes"]["blank"], jax.random.PRNGKey(1))
    relocalization.reset_counts()
    res = relocalization.relocalize(world["cfg"], world["m"], world["frames"]["blank"],
                                    torch.Generator().manual_seed(1))
    assert not bool(jres.success) and not bool(res.success)
    assert int(res.n_inliers) == 0 and relocalization.counts() == (1, 0)
    assert bool(torch.isfinite(res.Tcw).all()) and not bool((res.obs_pt >= 0).any())


def test_relocalize_same_seed_same_result(world):
    f = world["frames"][13]
    a = relocalization.relocalize(world["cfg"], world["m"], f, torch.Generator().manual_seed(5))
    b = relocalization.relocalize(world["cfg"], world["m"], f, torch.Generator().manual_seed(5))
    assert bool(a.success) and torch.equal(a.Tcw, b.Tcw) and torch.equal(a.obs_pt, b.obs_pt)


@pytest.mark.parametrize("hyp", ["static", "velocity"])
def test_track_motion_loc_matches_jax(hyp, world):
    jcfg, cfg, jc, c = world["jcfg"], world["cfg"], world["jcarry"], world["carry"]
    radius = (cfg.tracking.motion_search_radius_wide if hyp == "static"
              else cfg.tracking.motion_search_radius)
    jvel = np.eye(4, dtype=np.float32) if hyp == "static" else jc.velocity
    jfn = jax.jit(functools.partial(jtracking.track_motion_loc, jcfg))
    jres = jfn(world["jmap"], world["jframes"][N_MAPPED], jc.Tcw, jvel, jc.last_frame,
               jc.last_obs_pt, jnp.float32(radius), last_obs_birth=jc.last_obs_birth)
    res = tracking.track_motion_loc(
        cfg, world["m"], world["frames"][N_MAPPED], c.Tcw, torch.from_numpy(np.array(jvel)),
        c.last_frame, c.last_obs_pt, radius, last_obs_birth=c.last_obs_birth)
    np.testing.assert_allclose(res.Tcw.numpy(), np.asarray(jres.Tcw), rtol=0, atol=1e-4)
    assert int(res.n_matches) == int(jres.n_matches) > 100
    assert abs(int(res.n_inliers) - int(jres.n_inliers)) <= 2
    assert abs(int(res.n_map_inliers) - int(jres.n_map_inliers)) <= 2
    assert int(res.n_inliers) > int(res.n_map_inliers) >= 10   # VO points took part
    assert int(np.sum(res.obs_pt.numpy() != np.asarray(jres.obs_pt))) <= 2
