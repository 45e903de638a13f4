"""The port's third path as a whole against the JAX package, on the CPU: the
vocabulary loaded, local mapping on, loop closing off, default 16-px cells.

Both Systems run one scenario on the same frames (320x240, 500 features, a
k=8 L=3 vocabulary trained on the sequence by the JAX package and carried
over with convert.py):

  1. map 14 frames with per-frame calls;
  2. one track_batch_rgbd call of 3 blank frames, then frame 4 three times
     and frame 5 twice: the stream must recover inside the batch;
  3. per-frame calls: 3 blank frames (LOST), then frame 6 up to 3 times:
     recovery through relocalization;
  4. localization mode over frames 7 to 13: no keyframe, no new point.

Compared: the OK / LOST state after every per-frame call and after the batch
(equal), the recovered camera centres (within 0.05 m of the JAX package's
and of each System's own earlier estimate of that frame), keyframes taken at
the same frames.  The two packages select keypoints by different routes on
the CPU (band path here, slab path there), so descriptors are not identical
and BoW rows of keyframes taken at the same frame are held to 80% shared
words; that a row is exactly what the JAX package computes from the same
descriptors is held in tests/test_torch_relocalization.py, and here that
every stored row is the port's own _frame_bow of the stored descriptors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.models import config as jconfig
from self_commit_orb_slam2_tpu.models import system as jsystem
from self_commit_orb_slam2_tpu.ops import bow as jbow
from self_commit_orb_slam2_tpu.ops.camera import CameraParams as JCam
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb
from self_commit_orb_slam2_tpu.ops.orb.extractor import extract as jextract
from self_commit_orb_slam2_tpu_torch import convert
from self_commit_orb_slam2_tpu_torch.models import config, pipeline, relocalization, tracking
from self_commit_orb_slam2_tpu_torch.models.frame import FrameData
from self_commit_orb_slam2_tpu_torch.models.system import STATE_LOST, STATE_OK, System
from self_commit_orb_slam2_tpu_torch.ops.camera import CameraParams
from self_commit_orb_slam2_tpu_torch.ops.orb.extractor import OrbConfig
from self_commit_orb_slam2_tpu_torch.utils.synthetic import generate_sequence

# Eager torch on the CPU is thousands of tiny ops: with several test workers
# on one machine, full-width intra-op thread pools only spin against each
# other (these files took 5 to 10 times longer in a 6-worker run).
torch.set_num_threads(2)

CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=26.0, width=320, height=240)
CAPS = dict(max_keyframes=32, max_points=8192, local_points=1024)
N_MAPPED = 14


def _centre(T):
    T = np.asarray(T)
    return -T[:3, :3].T @ T[:3, 3]


def _scenario(slam, seq, n_points):
    """Drive one System through the four steps; returns what is compared."""
    rec = dict(states=[], centres={})
    blank, no_depth = np.zeros_like(seq.images[0]), np.zeros_like(seq.depths[0])

    for i in range(N_MAPPED):
        slam.track_rgbd(seq.images[i], seq.depths[i], float(i) / 30.0)
        rec["states"].append(slam.state)
    own = [np.asarray(T) for _, T in slam.trajectory]
    rec["own"] = own
    rec["kf_after_mapping"] = slam.n_keyframes()

    imgs = np.stack([blank] * 3 + [seq.images[4]] * 3 + [seq.images[5]] * 2)
    deps = np.stack([no_depth] * 3 + [seq.depths[4]] * 3 + [seq.depths[5]] * 2)
    poses = slam.track_batch_rgbd(imgs, deps, np.arange(8) / 30.0 + 1.0)
    rec["states"].append(slam.state)
    rec["centres"]["batch frame 4"] = (_centre(poses[-3]), _centre(own[4]))
    rec["centres"]["batch frame 5"] = (_centre(poses[-1]), _centre(own[5]))

    for j in range(3):
        slam.track_rgbd(blank, no_depth, 2.0 + j)
        rec["states"].append(slam.state)
    for j in range(3):
        T = slam.track_rgbd(seq.images[6], seq.depths[6], 3.0 + j)
        rec["states"].append(slam.state)
        if slam.state == STATE_OK:
            break
    rec["centres"]["per-frame frame 6"] = (_centre(T), _centre(own[6]))

    slam.activate_localization_mode()
    n_kf, n_pt = slam.n_keyframes(), n_points(slam)
    for i in range(7, N_MAPPED):
        T = slam.track_rgbd(seq.images[i], seq.depths[i], 4.0 + i / 30.0)
        rec["states"].append(slam.state)
        rec["centres"][f"localization frame {i}"] = (_centre(T), _centre(own[i]))
    rec["loc_added"] = (slam.n_keyframes() - n_kf, n_points(slam) - n_pt)
    rec["vo_mode"] = slam.vo_mode
    return rec


@pytest.fixture(scope="module")
def runs():
    seq = generate_sequence(n_frames=20, width=320, height=240, seed=5)
    descs = []
    for i in range(0, 20, 4):
        f = jextract(jnp.asarray(seq.images[i]), JOrb(n_features=300))
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    jvocab = jbow.train_vocabulary(np.concatenate(descs), k=8, L=3, seed=2)
    track = dict(max_frames_between_kf=8)
    jcfg = jconfig.SlamConfig(camera=JCam.create(**CAM), orb=JOrb(n_features=500),
                              caps=jconfig.Capacities(**CAPS),
                              tracking=jconfig.TrackingConfig(**track), vocab=jvocab)
    jsys = jsystem.System(jcfg, enable_mapping=True, enable_loop_closing=False)
    jrec = _scenario(jsys, seq, lambda s: s.n_points())

    vocab = convert.vocabulary_from_numpy(
        {f: getattr(jvocab, f) for f in jvocab._fields if f != "child_desc"}, "cpu")
    cfg = config.SlamConfig(camera=CameraParams.create(**CAM), orb=OrbConfig(n_features=500),
                            caps=config.Capacities(**CAPS),
                            tracking=config.TrackingConfig(**track), vocab=vocab)
    slam = System(cfg, enable_mapping=True, enable_loop_closing=False, device="cpu")
    relocalization.reset_counts()
    with pipeline.timed_mapping_passes() as pass_s:
        rec = _scenario(slam, seq, lambda s: s.n_points())
    rec["reloc_counts"] = relocalization.counts()
    rec["n_passes"] = len(pass_s)
    return jsys, jrec, slam, rec


def test_states_equal_the_jax_packages(runs):
    _, jrec, _, rec = runs
    assert rec["states"] == jrec["states"]
    s = rec["states"]
    assert s[:N_MAPPED] == [STATE_OK] * N_MAPPED
    assert s[N_MAPPED] == STATE_OK                       # recovered inside the batch
    assert s[N_MAPPED + 1:N_MAPPED + 4] == [STATE_LOST] * 3
    assert s[N_MAPPED + 4] == STATE_OK                   # first return to a mapped view
    assert s[N_MAPPED + 5:] == [STATE_OK] * 7            # localization mode


def test_recovered_centres(runs):
    _, jrec, _, rec = runs
    for name, (got, own) in rec["centres"].items():
        jgot, jown = jrec["centres"][name]
        assert np.linalg.norm(got - own) < 0.05, name     # the port's own earlier estimate
        assert np.linalg.norm(got - jgot) < 0.05, name    # the JAX package's recovery
        assert np.linalg.norm(jgot - jown) < 0.05, name


def test_relocalization_runs_only_when_wanted(runs):
    """No attempt while tracking holds; the blank frames and the frames that
    recover account for every attempt; at least one success in the batch
    and one in the per-frame recovery."""
    _, _, slam, rec = runs
    attempts, successes = rec["reloc_counts"]
    # batch: 3 blank + 1 recovering frame in the stream; per frame: each of
    # the 3 blank frames tries in the step and once more on the host, and
    # the returning frame recovers in the step
    assert attempts == 4 + 6 + 1 and successes == 2
    assert not rec["vo_mode"]


def test_localization_mode_adds_nothing(runs):
    _, jrec, _, rec = runs
    assert rec["loc_added"] == (0, 0) and jrec["loc_added"] == (0, 0)


def test_keyframes_and_their_bow_rows(runs):
    jsys, jrec, slam, rec = runs
    m, cfg = slam.map, slam.config
    assert rec["kf_after_mapping"] == jrec["kf_after_mapping"] >= 2
    assert rec["n_passes"] == slam.n_keyframes() - 1
    valid = torch.nonzero(m.kf_valid)[:, 0].tolist()
    for k in valid:   # every row is the port's _frame_bow of the stored descriptors
        kf = FrameData(xy=m.kf_xy[k], xy_raw=m.kf_xy[k], response=m.kf_angle[k],
                       angle=m.kf_angle[k], level=m.kf_level[k], desc=m.kf_desc[k],
                       valid=m.kf_feat_valid[k], u_right=m.kf_uright[k], depth=m.kf_depth[k])
        (ids, vals), words, nodes = tracking._frame_bow(cfg, kf)
        assert torch.equal(ids, m.kf_bow_ids[k]) and torch.equal(vals, m.kf_bow_vals[k])
        assert torch.equal(words, m.kf_word[k]) and torch.equal(nodes, m.kf_node[k])
        assert int((ids >= 0).sum()) > 50
        assert bool(((nodes >= 0) == m.kf_feat_valid[k]).all())
        assert abs(float(vals.sum()) - 1.0) < 1e-5
    # keyframes taken at the same frames hold mostly the same words
    jm = jsys.map
    j_by_frame = {int(f): i for i, (f, v) in enumerate(zip(np.asarray(jm.kf_frame_id),
                                                           np.asarray(jm.kf_valid))) if v}
    shared_frames = 0
    for k in valid:
        j = j_by_frame.get(int(m.kf_frame_id[k]))
        if j is None:
            continue
        shared_frames += 1
        a = set(m.kf_bow_ids[k][m.kf_bow_ids[k] >= 0].tolist())
        b = set(np.asarray(jm.kf_bow_ids[j])[np.asarray(jm.kf_bow_ids[j]) >= 0].tolist())
        assert len(a & b) >= 0.8 * max(len(a), len(b)), (k, len(a), len(b), len(a & b))
    assert shared_frames >= 2
