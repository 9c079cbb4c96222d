"""Plain PyTorch version of the merge_runs rank kernel."""
from __future__ import annotations

from typing import Sequence

import torch


def merge_ranks_ref(keys: torch.Tensor, bounds: Sequence[int],
                    lengths: torch.Tensor) -> torch.Tensor:
    """keys (B, N) int32 or int64 holding K runs back to back, run o at
    [bounds[o], bounds[o+1]), each sorted ascending over its first
    lengths[:, o] entries; the entries past a run's length count as the
    dtype-max sentinel whatever they hold. Live keys lie below the
    sentinel. Returns int32 (B, N) output ranks, a permutation of [0, N)
    per batch, stable in (run, index) order: earlier runs win ties."""
    b, n = keys.shape
    k = len(bounds) - 1
    dev = keys.device
    caps = [bounds[o + 1] - bounds[o] for o in range(k)]
    run_of = torch.repeat_interleave(torch.arange(k, device=dev), torch.tensor(caps, device=dev))
    within = torch.arange(n, device=dev) - torch.tensor(bounds[:-1], device=dev)[run_of]
    live = within[None, :] < lengths.to(torch.int64)[:, run_of]
    masked = torch.where(live, keys, torch.iinfo(keys.dtype).max)
    runs = [masked[:, bounds[o]: bounds[o + 1]].contiguous() for o in range(k)]
    ranks = within.expand(b, n).clone()
    for i in range(k):
        for j in range(k):
            if i != j and caps[i] and caps[j]:
                ranks[:, bounds[j]: bounds[j + 1]] += torch.searchsorted(
                    runs[i], runs[j], right=i < j)
    return ranks.to(torch.int32)
