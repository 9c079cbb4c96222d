"""Plain PyTorch version of the combiner kernel: the whole-array segment
sum of sorted (key, count) rows, batched over leading dims."""
from __future__ import annotations

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
