"""Plain PyTorch versions of the combiner kernels: the whole-array segment
sum of sorted (key, count) rows, batched over leading dims, and the
combiner-on-compaction that compacts each row's unique keys and sums to
the front."""
from __future__ import annotations

from typing import Optional

import torch


def combine_blocks_ref(keys: torch.Tensor, counts: torch.Tensor):
    """keys int64 (..., n) sorted along the last dim; counts int32 or int64
    (..., n). Returns (heads bool (..., n), int64 (..., n) sum of each
    key's counts at its head, 0 elsewhere). A run of sentinel keys is one
    ordinary segment."""
    heads = torch.ones_like(keys, dtype=torch.bool)
    heads[..., 1:] = keys[..., 1:] != keys[..., :-1]
    seg = torch.cumsum(heads, dim=-1) - 1
    sums = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
    sums.scatter_add_(-1, seg, counts.to(torch.int64))
    return heads, torch.where(heads, sums.gather(-1, seg), 0)


def combine_compact_ref(keys: torch.Tensor, counts: Optional[torch.Tensor],
                        n_live: torch.Tensor, cap: int, sentinel: int):
    """keys int64 (T, N), each row sorted over its first n_live[t] entries
    (int (T,)), which lie below the sentinel; keys past them count as the
    sentinel whatever they hold. counts int32 or int64 (T, N), or None (the
    dedup form). Per row, sum the counts of equal adjacent keys and compact
    the unique keys to the front. Returns (ukeys (T, cap): the unique keys,
    then the sentinel; int64 sums (T, cap), each key's at its slot and the
    sentinel segment's, all of the tail's counts, at slot n_unique, 0
    after; or None without counts; int32 n_unique (T,)). The sentinel tail
    sums as one segment."""
    live = torch.arange(keys.shape[1], device=keys.device) < n_live[:, None]
    keys = torch.where(live, keys, sentinel)
    if counts is None:
        is_head = torch.ones_like(keys, dtype=torch.bool)
        is_head[:, 1:] = keys[:, 1:] != keys[:, :-1]
    else:
        is_head, head_sums = combine_blocks_ref(keys, counts)
    seg = torch.cumsum(is_head, dim=1) - 1
    n_unique = (is_head & (keys != sentinel)).sum(dim=1, dtype=torch.int32)
    # Every member of a segment carries the same key, so the duplicate
    # writes of this scatter all write one value.
    ukeys = torch.full_like(keys, sentinel).scatter_(1, seg, keys)
    sums = None
    if counts is not None:
        # Only heads hold a nonzero sum: one exact add per segment.
        sums = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
        sums.scatter_add_(1, seg, head_sums)
        sums = sums[:, :cap]
    return ukeys[:, :cap], sums, n_unique
