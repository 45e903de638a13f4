"""Scatter/gather helpers for JAX's fixed-shape indexing idioms.

JAX drops scatter writes whose index is out of range (`mode="drop"`) and
pads `nonzero(size=...)`; torch raises on the first and returns a
data-dependent shape from the second (a host sync on the card).  These
helpers give the JAX results with static shapes and no sync.
"""

from __future__ import annotations

import torch


def set_drop(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """arr.at[idx].set(vals, mode="drop") along dim 0, returned as a new
    tensor.  Dropped rows land in a discarded extra row.  Indices must be
    unique among the rows kept."""
    n = arr.shape[0]
    idx = idx.long()
    tgt = torch.where((idx >= 0) & (idx < n), idx, n)
    ext = torch.cat([arr, arr[:1]])
    vals = torch.as_tensor(vals, dtype=arr.dtype, device=arr.device)
    ext.index_put_((tgt,), vals.expand(tgt.shape + arr.shape[1:]))
    return ext[:n]


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


def row(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """arr[i] for a 0-d index tensor, as a device gather (no host sync)."""
    return arr.index_select(0, i.reshape(1).long())[0]
