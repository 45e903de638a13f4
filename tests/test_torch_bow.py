"""The port's bag-of-words module against the JAX package's.

The same numpy inputs (descriptors from a seed, one frame's extracted
descriptors, word lists) go through both.  Tolerances: word ids, node ids and
sparse word ids exact; weights and scores within 1e-6; a trained tree equal
in every array (its IDF weights within 1e-6: the port's transform feeds the
same counts into the same numpy log).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_commit_orb_slam2_tpu.ops import bow as jbow
from self_commit_orb_slam2_tpu.ops.orb.extractor import OrbConfig as JOrb
from self_commit_orb_slam2_tpu.ops.orb.extractor import extract as jextract
from self_commit_orb_slam2_tpu.utils.synthetic import generate_sequence
from self_commit_orb_slam2_tpu_torch import convert
from self_commit_orb_slam2_tpu_torch.ops import bow


def _i32(desc_u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(desc_u32, order="C").view(np.int32))


@pytest.fixture(scope="module")
def frame_desc():
    """One 320x240 frame's descriptors from the JAX extractor: (desc [N, 8]
    uint32, valid [N])."""
    seq = generate_sequence(n_frames=1, width=320, height=240, seed=5)
    f = jextract(jnp.asarray(seq.images[0]), JOrb(n_features=500))
    return np.asarray(f.desc), np.asarray(f.valid)


@pytest.fixture(scope="module")
def vocabs(frame_desc):
    """A k=8, L=3 tree trained by each package on the same descriptors."""
    rng = np.random.default_rng(3)
    desc, valid = frame_desc
    # the frame's descriptors plus noisy copies, so that leaves hold several
    train = np.concatenate([desc[valid]] + [
        desc[valid] ^ (np.uint32(1) << rng.integers(0, 32, (int(valid.sum()), 8)).astype(np.uint32))
        for _ in range(3)])
    return (jbow.train_vocabulary(train, k=8, L=3, seed=2),
            bow.train_vocabulary(train, k=8, L=3, seed=2))


@pytest.fixture(scope="module")
def bundled():
    path = bow.default_vocab_path()
    assert path is not None
    return jbow.load_vocabulary(path), bow.load_vocabulary(path)


def _same_tree(jv, tv, weight_tol=0.0):
    np.testing.assert_array_equal(tv.node_desc.numpy().view(np.uint32), np.asarray(jv.node_desc))
    np.testing.assert_array_equal(tv.node_children.numpy(), np.asarray(jv.node_children))
    np.testing.assert_array_equal(tv.word_id.numpy(), np.asarray(jv.word_id))
    np.testing.assert_array_equal(tv.child_desc.numpy().view(np.uint32),
                                  np.asarray(jv.child_desc))
    np.testing.assert_allclose(tv.word_weight.numpy(), np.asarray(jv.word_weight),
                               rtol=0, atol=weight_tol)
    assert (tv.k, tv.L, tv.n_words, tv.levelsup) == (jv.k, jv.L, jv.n_words, jv.levelsup)


def test_bundled_vocabulary_loads_to_the_same_bits(bundled):
    jv, tv = bundled
    assert (tv.k, tv.L, tv.n_words) == (10, 6, 199288)
    assert tv.node_desc.dtype == torch.int32 and tv.child_desc.shape == (221431, 10, 8)
    _same_tree(jv, tv)
    assert bow.vocabulary_provenance(bow.default_vocab_path()) == \
        jbow.vocabulary_provenance(bow.default_vocab_path())


def test_train_vocabulary_one_seed_one_tree(vocabs):
    jv, tv = vocabs
    assert tv.n_words > 50
    _same_tree(jv, tv, weight_tol=1e-6)


def test_vocabulary_from_numpy_and_file_round_trip(vocabs, tmp_path):
    jv, tv = vocabs
    _same_tree(jv, convert.vocabulary_from_numpy(
        {f: (np.asarray(getattr(jv, f)) if f not in ("k", "L", "n_words", "levelsup")
             else getattr(jv, f)) for f in jv._fields if f != "child_desc"}))
    # each package reads the file the other wrote
    bow.save_vocabulary(str(tmp_path / "t.npz"), tv, provenance="p")
    jbow.save_vocabulary(str(tmp_path / "j.npz"), jv, provenance="p")
    _same_tree(jbow.load_vocabulary(str(tmp_path / "t.npz")),
               bow.load_vocabulary(str(tmp_path / "j.npz")), weight_tol=1e-6)
    assert bow.vocabulary_provenance(str(tmp_path / "j.npz")) == "p"


def _both_transform(jv, tv, desc, valid):
    jw, jn = jbow.transform(jv, jnp.asarray(desc), jnp.asarray(valid))
    tw, tn = bow.transform(tv, _i32(desc), torch.from_numpy(valid))
    return (np.asarray(jw), np.asarray(jn)), (tw.numpy(), tn.numpy())


@pytest.mark.parametrize("which", ["trained", "bundled"])
def test_transform_random_descriptors_exact(which, vocabs, bundled, rng):
    jv, tv = vocabs if which == "trained" else bundled
    desc = rng.integers(0, 2**32, (2000, 8), dtype=np.uint64).astype(np.uint32)
    valid = rng.random(2000) < 0.9
    (jw, jn), (tw, tn) = _both_transform(jv, tv, desc, valid)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tn, jn)
    assert np.all(tw[~valid] == -1) and np.all(tn[~valid] == -1)
    assert np.all(tw[valid] >= 0) and np.all(tn[valid] >= 0)


@pytest.mark.parametrize("which", ["trained", "bundled"])
def test_transform_frame_descriptors_exact(which, vocabs, bundled, frame_desc):
    jv, tv = vocabs if which == "trained" else bundled
    (jw, jn), (tw, tn) = _both_transform(jv, tv, *frame_desc)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tn, jn)
    # without the child-descriptor table the descent gathers k rows: same result
    tw2, tn2 = bow.transform(tv._replace(child_desc=None), _i32(frame_desc[0]),
                             torch.from_numpy(frame_desc[1]))
    np.testing.assert_array_equal(tw2.numpy(), jw)
    np.testing.assert_array_equal(tn2.numpy(), jn)


def test_transform_takes_the_first_of_equal_children():
    """A node with two identical children: the descent takes the first."""
    node_desc = np.zeros((4, 8), np.uint32)
    node_desc[1:3] = 0xFFFF0000          # children 1 and 2 are the same centre
    node_desc[3] = 0x0000FFFF
    children = np.full((4, 3), -1, np.int32)
    children[0] = [1, 2, 3]
    word_id = np.array([-1, 0, 1, 2], np.int32)
    tv = bow.from_arrays(node_desc, children, word_id, np.ones(3, np.float32), 3, 1, 3, 0)
    desc = np.stack([np.full(8, 0xFFFF0000, np.uint32), np.full(8, 0xFFFF0001, np.uint32),
                     np.full(8, 0x0000FFFF, np.uint32)])
    words, nodes = bow.transform(tv, _i32(desc), torch.ones(3, dtype=torch.bool))
    assert words.tolist() == [0, 0, 2] and nodes.tolist() == [1, 1, 3]


def _words(rng, n, n_distinct, n_words, n_invalid):
    w = rng.choice(rng.choice(n_words, n_distinct, replace=False), n).astype(np.int32)
    w[rng.choice(n, n_invalid, replace=False)] = -1
    return w


@pytest.mark.parametrize("n,n_distinct,T", [
    (500, 40, 64),     # fewer distinct words than T
    (500, 300, 64),    # more: the cut by weight is live, with ties at the cut
    (500, 300, 512),   # T > N: padded
    (500, 1, 64), (500, 0, 64)])
def test_sparse_bow_matches_jax(n, n_distinct, T, vocabs, rng):
    jv, tv = vocabs
    words = (_words(rng, n, n_distinct, tv.n_words, 25) if n_distinct
             else np.full(n, -1, np.int32))
    jid, jval = jbow.sparse_bow(jv, jnp.asarray(words), T)
    tid, tval = bow.sparse_bow(tv, torch.from_numpy(words), T)
    assert tid.dtype == torch.int32 and tid.shape == (T,)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tval.numpy(), np.asarray(jval), rtol=0, atol=1e-6)
    if 0 < n_distinct <= T:
        assert int((tid >= 0).sum()) == len(np.unique(words[words >= 0]))
        assert abs(float(tval.sum()) - 1.0) < 1e-5


def test_sparse_bow_bundled_weights(bundled, frame_desc):
    """The real IDF table, on a real frame's words, at the default T."""
    jv, tv = bundled
    desc, valid = frame_desc
    words, _ = bow.transform(tv, _i32(desc), torch.from_numpy(valid))
    for T in (512, 64):
        jid, jval = jbow.sparse_bow(jv, jnp.asarray(words.numpy()), T)
        tid, tval = bow.sparse_bow(tv, words, T)
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        np.testing.assert_allclose(tval.numpy(), np.asarray(jval), rtol=0, atol=1e-6)


def test_sparse_scores_match_jax_and_dense(vocabs, rng):
    jv, tv = vocabs
    T, K = 128, 6
    lists = [_words(rng, 400, 90, tv.n_words, 10) for _ in range(K + 1)]
    lists[2] = lists[0].copy()                  # an identical frame scores 1
    lists[3] = np.full(400, -1, np.int32)       # an empty row scores 0
    sp = [bow.sparse_bow(tv, torch.from_numpy(w), T) for w in lists]
    q_ids, q_vals = sp[0]
    db_ids = torch.stack([s[0] for s in sp[1:]])
    db_vals = torch.stack([s[1] for s in sp[1:]])

    got = bow.sparse_l1_score(q_ids, q_vals, db_ids, db_vals)
    want = jbow.sparse_l1_score(jnp.asarray(q_ids.numpy()), jnp.asarray(q_vals.numpy()),
                                jnp.asarray(db_ids.numpy()), jnp.asarray(db_vals.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert abs(float(got[1]) - 1.0) < 1e-5 and float(got[2]) == 0.0

    common = bow.sparse_common_words(q_ids, db_ids)
    np.testing.assert_array_equal(
        common.numpy(), np.asarray(jbow.sparse_common_words(jnp.asarray(q_ids.numpy()),
                                                            jnp.asarray(db_ids.numpy()))))
    assert common.dtype == torch.int32
    for k in range(K):
        assert int(common[k]) == len(np.intersect1d(lists[0][lists[0] >= 0],
                                                    lists[k + 1][lists[k + 1] >= 0]))

    # <= T distinct words: the sparse score is the dense one
    dense = [bow.bow_vector(tv, torch.from_numpy(w)) for w in lists]
    np.testing.assert_allclose(dense[0].numpy(),
                               np.asarray(jbow.bow_vector(jv, jnp.asarray(lists[0]))),
                               rtol=0, atol=1e-6)
    d = bow.l1_score(dense[0], torch.stack(dense[1:]))
    np.testing.assert_allclose(
        d.numpy(), np.asarray(jbow.l1_score(jnp.asarray(dense[0].numpy()),
                                            jnp.asarray(torch.stack(dense[1:]).numpy()))),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy()[[0, 1, 3, 4, 5]], d.numpy()[[0, 1, 3, 4, 5]],
                               rtol=0, atol=1e-5)
