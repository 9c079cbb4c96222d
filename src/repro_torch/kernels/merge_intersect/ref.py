"""Plain PyTorch version of the membership kernel: a batched searchsorted,
clamp, gather and exact compare — the reference's member_mask_keys with
the tablets as leading dims."""
from __future__ import annotations

import torch


def member_mask_keys(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., n), b (..., m) of one integer dtype, each row of b sorted
    ascending. Returns bool (..., n): whether a[..., j] occurs in the
    same row of b. Sentinels are ordinary values (the caller masks
    sentinel probes)."""
    m = b.shape[-1]
    if m == 0:
        return torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    pos = torch.searchsorted(b.contiguous(), a.contiguous())
    found = b.gather(-1, pos.clamp(0, m - 1))
    return (pos < m) & (found == a)
