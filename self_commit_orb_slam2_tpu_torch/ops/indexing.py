"""Scatter/gather helpers for JAX's fixed-shape indexing idioms.

JAX drops scatter writes whose index is out of range (`mode="drop"`) and
pads `nonzero(size=...)`; torch raises on the first and returns a
data-dependent shape from the second (a host sync on the card).  These
helpers give the JAX results with static shapes and no sync.
"""

from __future__ import annotations

import torch


def set_drop(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """arr.at[idx].set(vals, mode="drop") along dim 0 for any index shape,
    returned as a new tensor; negative indices are dropped too.  Among
    duplicate indices the update that comes last in idx's row-major order
    wins, as in XLA's sequential CPU scatter: a max-index reduce picks it,
    so the card gives the same answer (index_put_ promises no order among
    duplicates there)."""
    n, m = arr.shape[0], idx.numel()
    vals = torch.as_tensor(vals, dtype=arr.dtype, device=arr.device)
    vals = vals.expand(*idx.shape, *arr.shape[1:]).reshape(m, *arr.shape[1:])
    idx = idx.reshape(-1).long()
    tgt = torch.where((idx >= 0) & (idx < n), idx, n)
    winner = torch.full((n + 1,), -1, dtype=torch.int64, device=arr.device)
    winner = winner.scatter_reduce(0, tgt, torch.arange(m, device=arr.device),
                                   reduce="amax")[:n]
    hit = (winner >= 0).reshape(n, *([1] * (arr.ndim - 1)))
    return torch.where(hit, vals[winner.clamp(min=0)], arr)


def add_drop(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """arr.at[idx].add(vals, mode="drop") for a 1-D arr (duplicates add up)."""
    n = arr.shape[0]
    idx = idx.long()
    tgt = torch.where((idx >= 0) & (idx < n), idx, n)
    vals = torch.as_tensor(vals, dtype=arr.dtype, device=arr.device).expand(tgt.shape)
    return torch.cat([arr, arr[:1]]).index_add(0, tgt, vals)[:n]


def indicator(n: int, idx: torch.Tensor, dtype=torch.bool) -> torch.Tensor:
    """[n] with 1 at every in-range idx (out-of-range entries dropped)."""
    z = torch.zeros(n, dtype=dtype, device=idx.device)
    return set_drop(z, idx, 1)


def nonzero_padded(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """jnp.nonzero(mask, size=size, fill_value=fill)[0]: the first `size`
    True positions of a 1-D mask in order, padded with `fill`."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, tgt, torch.arange(n, device=mask.device))
    return out[:size]


def top_k(x: torch.Tensor, k: int):
    """jax.lax.top_k over the last dim: the k largest first, equal values by
    lowest index (a stable descending sort; torch.topk promises no order
    among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def row(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """arr[i] for a 0-d index tensor, as a device gather (no host sync)."""
    return arr.index_select(0, i.reshape(1).long())[0]


def select(take_a: torch.Tensor, a, b):
    """Field-wise torch.where over two NamedTuples of one type (the JAX
    package's jax.tree.map(lambda x, y: jnp.where(c, x, y), a, b))."""
    return type(a)(*(torch.where(take_a, x, y) for x, y in zip(a, b)))
