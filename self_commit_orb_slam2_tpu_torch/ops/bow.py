"""Bag-of-binary-words place recognition.

Counterpart of the JAX package's ops/bow.py (the reference's vendored DBoW2,
Thirdparty/DBoW2):

  * Vocabulary: hierarchical k-medoids tree over 256-bit ORB descriptors
    (k branches, L levels), stored as flat tensors (node descriptors +
    children) so a lookup is a batch of gathers.  Training is offline host
    code in numpy (binary k-majority k-means), copied from the JAX package
    and held equal to it by tests/test_torch_rules.py.
  * transform(): all N descriptors descend the tree together (L rounds of
    gather + Hamming argmin) -> word ids and mid-level node ids (the
    reference's FeatureVector, which constrains SearchByBoW).
  * Scoring: each frame keeps its top-T (word id, weight) pairs of the
    L1-normalized TF-IDF vector; for two such non-negative vectors
    1 - 0.5 * sum|v - w| == sum of min(v_i, w_i) over shared words, one
    [T, T] id match per database row (sparse_l1_score).  The dense forms
    (bow_vector, l1_score) are kept for small vocabularies and tests.

Node descriptors are uint32 words in the file and int32 words holding the
same bits here, like every descriptor of the port.

The bundled vocabulary (k=10, L=6) is a data file of the JAX package's
assets directory.  It is not duplicated: default_vocab_path() resolves it by
path.  That is a file read, not an import; no module of that package is
loaded.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .indexing import top_k
from .matching.hamming import hamming_distance

_NO_WORD = 1 << 30  # sorts after every word id


class Vocabulary(NamedTuple):
    """Flat hierarchical vocabulary.

    node_desc:     [n_nodes, 8] int32 cluster-centre descriptors (uint32 bits)
    node_children: [n_nodes, k] int32 (index into the node arrays; -1 = none)
    word_id:       [n_nodes] int32 (-1 for internal nodes)
    word_weight:   [n_words] float32 IDF weights
    k, L:          branching factor / leaf depth
    levelsup:      node level used for matching constraints, from the leaf
    child_desc:    [n_nodes, k, 8] int32: node i's children's descriptors,
                   contiguous, so the descent gathers one row per query and
                   level; built once by _with_child_desc
    """

    node_desc: torch.Tensor
    node_children: torch.Tensor
    word_id: torch.Tensor
    word_weight: torch.Tensor
    k: int
    L: int
    n_words: int
    levelsup: int = 2
    child_desc: torch.Tensor | None = None

    def to(self, device) -> "Vocabulary":
        """The same vocabulary with every tensor on `device`."""
        return self._replace(**{
            f: getattr(self, f).to(device) for f in
            ("node_desc", "node_children", "word_id", "word_weight", "child_desc")
            if getattr(self, f) is not None})

    def device_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self
                   if isinstance(t, torch.Tensor))


def default_vocab_path() -> str | None:
    """Path of the bundled vocabulary (the analogue of the reference's
    shipped Vocabulary/ORBvoc.txt), or None when the file is absent.  The
    file lives in the JAX package's assets directory and is read from there:
    data, not a module."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p = os.path.join(root, "self_commit_orb_slam2_tpu", "assets", "vocab_synthetic.npz")
    return p if os.path.exists(p) else None


# ------------------------------------------------------- training (host, numpy)

_POP_LUT = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _hamming_table(descs_u8: np.ndarray, centers_u8: np.ndarray,
                   chunk: int = 1 << 16) -> np.ndarray:
    """[M, k] Hamming distances, chunked byte-LUT popcount (no [M, k, 256]
    unpack: at training scale that would be gigabytes per iteration)."""
    M, k = len(descs_u8), len(centers_u8)
    out = np.empty((M, k), np.int32)
    for s in range(0, M, chunk):
        x = descs_u8[s: s + chunk, None, :] ^ centers_u8[None, :, :]
        out[s: s + chunk] = _POP_LUT[x].sum(-1, dtype=np.int32)
    return out


def _kmajority(descs: np.ndarray, k: int, rng, iters: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Binary k-means (k-majority vote) on [M, 8] uint32 descriptors."""
    M = len(descs)
    k = min(k, M)
    centers = descs[rng.choice(M, k, replace=False)]
    du8 = np.ascontiguousarray(descs).view(np.uint8).reshape(M, 32)
    assign = np.zeros(M, np.int64)
    for _ in range(iters):
        cu8 = np.ascontiguousarray(centers).view(np.uint8).reshape(k, 32)
        d = _hamming_table(du8, cu8)
        new_assign = np.argmin(d, axis=1)
        if np.array_equal(new_assign, assign):
            assign = new_assign
            break
        assign = new_assign
        new_centers = []
        for c in range(k):
            sel = du8[assign == c]
            if len(sel) == 0:
                new_centers.append(centers[c])
                continue
            maj = (np.unpackbits(sel, axis=-1).mean(0) >= 0.5).astype(np.uint8)
            new_centers.append(np.packbits(maj).view(np.uint32))
        centers = np.stack(new_centers)
    cu8 = np.ascontiguousarray(centers).view(np.uint8).reshape(k, 32)
    assign = np.argmin(_hamming_table(du8, cu8), axis=1)
    return centers, assign


def from_arrays(node_desc: np.ndarray, node_children: np.ndarray, word_id: np.ndarray,
                word_weight: np.ndarray, k: int, L: int, n_words: int,
                levelsup: int) -> Vocabulary:
    """Host arrays (descriptors uint32 or int32 bits) -> a CPU Vocabulary
    with its child-descriptor table."""
    nd = np.ascontiguousarray(node_desc)
    if nd.dtype == np.uint32:
        nd = nd.view(np.int32)
    t = lambda a, dt: torch.from_numpy(np.array(a, dtype=dt, order="C"))  # noqa: E731
    return _with_child_desc(Vocabulary(
        node_desc=t(nd, np.int32), node_children=t(node_children, np.int32),
        word_id=t(word_id, np.int32), word_weight=t(word_weight, np.float32),
        k=int(k), L=int(L), n_words=int(n_words), levelsup=int(levelsup)))


def train_vocabulary(descriptors: np.ndarray, k: int = 10, L: int = 4,
                     seed: int = 0, weight_descs: np.ndarray | None = None,
                     weight_doc_ids: np.ndarray | None = None,
                     levelsup: int = 2) -> Vocabulary:
    """Train the tree host-side (offline, like DBoW2's create()).

    descriptors: [M, 8] uint32 training set.  IDF weights come from
    `weight_descs` (defaults to the training set) as in
    TemplatedVocabulary::setNodeWeights; when `weight_doc_ids` [M] is given,
    document frequency counts distinct source images per word (the DBoW2
    definition) instead of descriptor occurrences.  Returns a CPU vocabulary.
    """
    rng = np.random.default_rng(seed)
    node_desc = [np.zeros(8, np.uint32)]  # root (never compared against)
    children: list[list[int]] = [[]]

    def build(node_id: int, descs: np.ndarray, level: int):
        if level == L or len(descs) < 2 * k:
            return
        centers, assign = _kmajority(descs, k, rng)
        for c in range(len(centers)):
            child_id = len(node_desc)
            node_desc.append(centers[c])
            children.append([])
            children[node_id].append(child_id)
            sub = descs[assign == c]
            if len(sub):
                build(child_id, sub, level + 1)

    build(0, descriptors.astype(np.uint32), 0)

    n_nodes = len(node_desc)
    is_leaf = np.array([len(children[i]) == 0 and i != 0 for i in range(n_nodes)])
    word_id = np.full(n_nodes, -1, np.int32)
    word_id[is_leaf] = np.arange(is_leaf.sum(), dtype=np.int32)
    n_words = int(is_leaf.sum())

    child_arr = np.full((n_nodes, k), -1, np.int32)
    for i, ch in enumerate(children):
        child_arr[i, : len(ch)] = ch

    vocab = from_arrays(np.stack(node_desc), child_arr, word_id,
                        np.ones(max(n_words, 1), np.float32), k, L, n_words, levelsup)
    # IDF weights (TemplatedVocabulary.h: weight = log(N / Ni))
    wd = weight_descs if weight_descs is not None else descriptors
    words_np = []
    CH = 1 << 17  # chunked: the descent gathers [M, k, 8] temporaries
    for s in range(0, len(wd), CH):
        d = np.ascontiguousarray(wd[s: s + CH].astype(np.uint32)).view(np.int32)
        w, _ = transform(vocab, torch.from_numpy(d),
                         torch.ones(len(d), dtype=torch.bool))
        words_np.append(w.numpy())
    words = np.concatenate(words_np) if words_np else np.zeros(0, np.int32)
    if weight_doc_ids is not None:
        # document frequency over distinct source images (DBoW2 semantics)
        docs = np.asarray(weight_doc_ids)[: len(words)]
        n_docs = max(int(docs.max()) + 1, 1)
        ok = words >= 0
        pairs = np.unique(words[ok].astype(np.int64) * n_docs + docs[ok])
        counts = np.bincount(pairs // n_docs, minlength=n_words).astype(np.float64)
    else:
        counts = np.bincount(words[words >= 0], minlength=n_words).astype(np.float64)
        n_docs = max(len(wd), 1)
    idf = np.log(n_docs / np.maximum(counts, 1.0)).astype(np.float32)
    return vocab._replace(word_weight=torch.from_numpy(np.maximum(idf, 1e-3)))


def _with_child_desc(vocab: Vocabulary) -> Vocabulary:
    """Precompute the contiguous [n_nodes, k, 8] child-descriptor table (once
    per load / train)."""
    ch = vocab.node_children.long()
    cd = vocab.node_desc[torch.clamp(ch, 0, vocab.node_desc.shape[0] - 1)]
    return vocab._replace(child_desc=cd.contiguous())


# ------------------------------------------------------------------- file I/O


def save_vocabulary(path: str, vocab: Vocabulary, provenance: str = "") -> None:
    """Write the JAX package's file layout (descriptors as uint32), so either
    package loads the other's file.  `provenance` records the training
    corpus so tests can assert it is disjoint from the test scenes."""
    np.savez_compressed(
        path,
        node_desc=vocab.node_desc.cpu().numpy().view(np.uint32),
        node_children=vocab.node_children.cpu().numpy(),
        word_id=vocab.word_id.cpu().numpy(),
        word_weight=vocab.word_weight.cpu().numpy(),
        meta=np.array([vocab.k, vocab.L, vocab.n_words, vocab.levelsup]),
        provenance=np.array(provenance),
    )


def vocabulary_provenance(path: str) -> str:
    """Training-corpus description stored by save_vocabulary ('' if absent)."""
    with np.load(path) as z:
        return str(z["provenance"]) if "provenance" in z else ""


def load_vocabulary(path: str) -> Vocabulary:
    """A vocabulary file -> a CPU Vocabulary; move it with .to(device)."""
    with np.load(path) as z:
        k, L, n_words, levelsup = (int(x) for x in z["meta"])
        return from_arrays(z["node_desc"], z["node_children"], z["word_id"],
                           z["word_weight"], k, L, n_words, levelsup)


# ------------------------------------------------------------------ transform


def transform(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor):
    """Batched tree descent: [N, 8] descriptors -> (word ids [N], node ids
    [N]), int32, -1 for invalid descriptors.

    Node ids are taken `levelsup` levels above the leaves (reference
    FeatureVector; measured from the leaf for robustness to variable-depth
    branches).  Among children at the same Hamming distance the first wins.
    """
    n = desc.shape[0]
    cur = torch.zeros(n, dtype=torch.int64, device=desc.device)  # root
    mid = cur
    n_nodes = vocab.node_desc.shape[0]
    for level in range(vocab.L):
        ch = vocab.node_children[cur].long()  # [N, k] (one row gather per query)
        has_child = ch >= 0
        if vocab.child_desc is not None:
            cdesc = vocab.child_desc[cur]      # [N, k, 8]: one contiguous row
        else:
            cdesc = vocab.node_desc[torch.clamp(ch, 0, n_nodes - 1)]
        dist = hamming_distance(desc[:, None, :], cdesc)
        dist = torch.where(has_child, dist, 100_000)
        best = torch.argmin(dist, dim=1)       # first index of the minimum
        nxt = ch.gather(1, best[:, None])[:, 0]
        # stop at nodes with no children (variable-depth branches)
        stopped = ~torch.any(has_child, dim=1)
        cur = torch.where(stopped, cur, nxt)
        if level == max(vocab.L - 1 - vocab.levelsup, 0):
            mid = cur
    words = torch.where(valid, vocab.word_id[cur], -1)
    return words.to(torch.int32), torch.where(valid, mid, -1).to(torch.int32)


def bow_vector(vocab: Vocabulary, words: torch.Tensor) -> torch.Tensor:
    """Dense L1-normalized TF-IDF vector [n_words] from word ids [N]."""
    w = torch.zeros(vocab.n_words + 1, dtype=torch.float32, device=words.device)
    idx = torch.where(words >= 0, words, vocab.n_words).long()
    w = w.index_add(0, idx, torch.ones_like(idx, dtype=torch.float32))
    v = w[: vocab.n_words] * vocab.word_weight
    return v / torch.clamp_min(torch.sum(torch.abs(v)), 1e-9)


def l1_score(v: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity of query v [W] vs database rows [K, W]:
    s = 1 - 0.5 * sum|v - w| in [0, 1] (ScoringObject.cpp L1Scoring)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(db - v[None, :]), dim=-1)


# ---------------------------------------------------------------- sparse path


def _unique_counts(keys: torch.Tensor):
    """jnp.unique(keys, size=N, fill_value=_NO_WORD, return_counts=True) at
    a fixed shape and with no host sync: the distinct keys ascending, padded
    with _NO_WORD, and their counts, padded with 0."""
    n = keys.shape[0]
    s, _ = torch.sort(keys)
    start = torch.ones(n, dtype=torch.bool, device=keys.device)
    start[1:] = s[1:] != s[:-1]
    seg = torch.cumsum(start.to(torch.int64), 0) - 1       # run number of each entry
    ids = torch.full((n,), _NO_WORD, dtype=keys.dtype, device=keys.device)
    ids = ids.scatter(0, seg, s)                           # a run writes one value
    counts = torch.zeros(n, dtype=torch.int32, device=keys.device)
    counts = counts.index_add(0, seg, torch.ones(n, dtype=torch.int32, device=keys.device))
    return ids, counts


def sparse_bow(vocab: Vocabulary, words: torch.Tensor, T: int):
    """[N] word ids -> (ids [T] int32, weights [T]) sparse L1-normalized
    TF-IDF; ids are -1 padded and ascending.

    Normalization runs over all distinct words first, then the top-T entries
    by weight are kept (equal weights: the lower word id first).  With <= T
    distinct words the result equals the dense vector exactly; beyond that
    the lowest-weight words are dropped, so sparse_l1_score is a tight lower
    bound of the dense score."""
    N = words.shape[0]
    ids, counts = _unique_counts(torch.where(words >= 0, words, _NO_WORD).to(torch.int32))
    ok = ids < _NO_WORD
    vals = torch.where(
        ok, counts.to(torch.float32)
        * vocab.word_weight[torch.clamp(ids, 0, vocab.n_words - 1).long()], 0.0)
    vals = vals / torch.clamp_min(torch.sum(vals), 1e-9)
    top_v, top_i = top_k(vals, min(T, N))
    top_ids = torch.where(top_v > 0, ids[top_i], _NO_WORD)
    if T > N:
        top_ids = torch.nn.functional.pad(top_ids, (0, T - N), value=_NO_WORD)
        top_v = torch.nn.functional.pad(top_v, (0, T - N))
    # sort by word id so downstream id-match joins see a canonical order
    order = torch.argsort(top_ids, stable=True)
    top_ids, top_v = top_ids[order], top_v[order]
    ok_t = top_ids < _NO_WORD
    return (torch.where(ok_t, top_ids, -1).to(torch.int32),
            torch.where(ok_t, top_v, 0.0))


def _id_match(q_ids: torch.Tensor, db_ids: torch.Tensor) -> torch.Tensor:
    """[K, T, T]: query word i is database row k's word j."""
    return (q_ids[None, :, None] == db_ids[:, None, :]) & (q_ids >= 0)[None, :, None]


def sparse_l1_score(q_ids: torch.Tensor, q_vals: torch.Tensor,
                    db_ids: torch.Tensor, db_vals: torch.Tensor) -> torch.Tensor:
    """Query (ids [T], vals [T]) vs database rows (ids [K, T], vals [K, T]):
    s[k] = sum over shared words of min(q, w), identical to l1_score on the
    densified vectors."""
    mins = torch.minimum(q_vals[None, :, None], db_vals[:, None, :])
    return torch.sum(torch.where(_id_match(q_ids, db_ids), mins, 0.0), dim=(1, 2))


def sparse_common_words(q_ids: torch.Tensor, db_ids: torch.Tensor) -> torch.Tensor:
    """[K] count of distinct shared words (KeyFrameDatabase share-word
    filter, reference KeyFrameDatabase.cc:104-160)."""
    return torch.sum(torch.any(_id_match(q_ids, db_ids), dim=2), dim=1).to(torch.int32)
