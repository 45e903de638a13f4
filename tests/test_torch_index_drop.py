"""ops/indexing.index_add_fixed's dropped rows (mode="drop"), torch only.

A row whose index lies outside [0, n) is left out of every sum.  The
mapping pass's two scatter-add sites used to send such rows to a sink row
that was sliced off (one shared row N in refresh_observed_points, one sink
column P a keyframe in the local BA's grouping); the first n rows of that
sink form must equal the dropped form to the bit, at both sites' shapes,
with runs of nearly every row on one sink.  An index with no dropped row
(the pose graph's, the sharded BA's) gives what index_add_ gives.
"""

import pytest
import torch

from self_commit_orb_slam2_tpu_torch.ops.indexing import index_add_fixed

torch.set_num_threads(2)   # six test workers share the CPU


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def refresh_site(K: int, N: int, live: int, seed: int):
    """refresh_observed_points' call at [K, N]: each of `live` keyframes
    sees ~60 % of the new keyframe's N points, each at most once; every
    other row (the empty keyframe slots, the misses) is dropped (-1)."""
    g = torch.Generator().manual_seed(seed)
    tgt = torch.full((K, N), -1, dtype=torch.int64)
    for k in torch.randperm(K, generator=g)[:live].tolist():
        seen = torch.rand(N, generator=g) < 0.6
        tgt[k] = torch.where(seen, torch.randperm(N, generator=g), -1)
    rays = torch.randn(K, N, 3, generator=g)
    return tgt.reshape(-1), rays.reshape(-1, 3)


def ba_site(K: int, N: int, P: int, seed: int):
    """The local BA's grouping at [K, N] observations into K x P (keyframe,
    point) rows: a third of the observations inactive; (flat index, packed
    rows, per-keyframe point index, active)."""
    g = torch.Generator().manual_seed(seed)
    pid = torch.randint(0, P, (K, N), generator=g)
    active = torch.rand(K, N, generator=g) > 0.33
    flat = torch.where(active, torch.arange(K)[:, None] * P + pid, -1).reshape(-1)
    packed = torch.randn(K * N, 30, generator=g)
    return flat, packed, pid, active


def refresh_sink_form(N, index, source):
    """The parent's refresh site: misses to the sink row N, zeroed."""
    hit = index >= 0
    return torch.zeros(N + 1, 3).index_add_(
        0, torch.where(hit, index, N), torch.where(hit[:, None], source, 0.0))[:N]


def ba_sink_form(K, N, P, pid, active, packed):
    """The parent's BA grouping: inactive observations to each keyframe's
    sink column P, then the columns sliced to P."""
    col = torch.where(active, pid, P)
    flat = (torch.arange(K)[:, None] * (P + 1) + col).reshape(-1)
    return torch.zeros(K * (P + 1), 30).index_add_(0, flat, packed).reshape(
        K, P + 1, 30)[:, :P].reshape(K * P, 30)


@pytest.mark.parametrize("K,N,live", [(256, 1000, 17), (256, 2000, 25)])
def test_refresh_site_equals_the_sink_form_bitwise(K, N, live):
    index, source = refresh_site(K, N, live, seed=K + N)
    assert int((index < 0).sum()) > 0.9 * index.numel()   # one run of nearly all rows
    got = index_add_fixed(torch.zeros(N, 3), 0, index, source)
    assert got.shape == (N, 3)
    assert torch.equal(_bits(got), _bits(refresh_sink_form(N, index, source)))


def test_ba_site_equals_the_sink_form_bitwise():
    K, N, P = 24, 1000, 4096
    flat, packed, pid, active = ba_site(K, N, P, seed=3)
    got = index_add_fixed(torch.zeros(K * P, 30), 0, flat, packed)
    assert got.shape == (K * P, 30)
    assert torch.equal(_bits(got), _bits(ba_sink_form(K, N, P, pid, active, packed)))


def test_an_index_with_only_dropped_rows_leaves_the_target():
    target = torch.randn(5, 3)
    index = torch.tensor([-1, 5, 7, -3, 1 << 40])   # below and past [0, 5)
    source = torch.full((5, 3), float("nan"))
    got = index_add_fixed(target.clone(), 0, index, source)
    assert torch.equal(_bits(got), _bits(target))


@pytest.mark.parametrize("shape,width", [((64 * 64, 7, 7), 2000), ((300, 12), 5000)])
def test_an_index_with_no_dropped_row_gives_index_add(shape, width):
    """The pose graph's [K*K, 7, 7] blocks and the sharded BA's per-point
    rows: indices in range only, the sums index_add_'s to the bit."""
    g = torch.Generator().manual_seed(width)
    index = torch.randint(0, shape[0], (width,), generator=g)
    source = torch.randn(width, *shape[1:], generator=g)
    got = index_add_fixed(torch.zeros(shape), 0, index, source)
    assert torch.equal(_bits(got), _bits(torch.zeros(shape).index_add_(0, index, source)))


def test_dropped_rows_add_nothing_to_a_kept_target_and_write_no_input():
    """Kept duplicates summed into a non-zero target in their order;
    dropped NaN rows left out; the target and the index not written; a
    dim other than 0."""
    target = torch.arange(12.0).reshape(3, 4)
    index = torch.tensor([2, -1, 0, 4, 2])
    source = torch.tensor([[1.0, 2.0, 3.0], [float("nan")] * 3, [4.0, 5.0, 6.0],
                           [float("inf")] * 3, [1e-8, 1e8, -1.0]]).T
    keep = torch.tensor([0, 2, 4])
    ref = target.clone().index_add_(1, index[keep], source[:, keep])
    before = (target.clone(), index.clone())
    got = index_add_fixed(target, 1, index, source)
    assert torch.equal(_bits(got), _bits(ref))
    assert torch.equal(target, before[0]) and torch.equal(index, before[1])
