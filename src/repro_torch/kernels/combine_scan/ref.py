"""Plain PyTorch version of the fused filter and combine kernel: the
predicate program, then a whole-array segmented aggregate over rows
sorted by group key."""
from __future__ import annotations

import torch

from ..program_eval import program_eval_rows

I32_MIN = torch.iinfo(torch.int32).min
I32_MAX = torch.iinfo(torch.int32).max
# The aggregate of a segment with no matching row (jax.ops.segment_min/max
# of an empty segment, 0 for sums).
IDENTITY = {"count": 0, "sum": 0, "min": I32_MAX, "max": I32_MIN}


def combine_scan_ref(keys, vals, cols, opcodes, arg0, arg1, codesets, op: str):
    """keys int64 (n,) ascending; vals int32 (n,) (unread for op
    'count'); cols int32 (n, F); the program's original form as int32
    tensors; op 'count' | 'sum' | 'min' | 'max'. Returns (heads bool (n,), int64 (n,)
    aggregate of the matching rows of each segment at its head, int32 (n,)
    matching rows of each segment at its head); the identity and 0
    elsewhere. Sums accumulate in int64, min and max in int32."""
    n = keys.shape[0]
    mask = program_eval_rows(cols, opcodes, arg0, arg1, codesets)
    heads = torch.ones(n, dtype=torch.bool, device=keys.device)
    heads[1:] = keys[1:] != keys[:-1]
    seg = torch.cumsum(heads, dim=0) - 1
    ident = IDENTITY[op]
    if op in ("count", "sum"):
        contrib = (mask.to(torch.int64) if op == "count"
                   else torch.where(mask, vals.to(torch.int64), 0))
        agg = torch.zeros(n, dtype=torch.int64, device=keys.device).scatter_add_(0, seg, contrib)
    else:
        contrib = torch.where(mask, vals, ident)
        agg = torch.full((n,), ident, dtype=torch.int32, device=keys.device)
        agg.scatter_reduce_(0, seg, contrib, "amin" if op == "min" else "amax")
    cnt = torch.zeros(n, dtype=torch.int32, device=keys.device)
    cnt.scatter_add_(0, seg, mask.to(torch.int32))
    aggs = torch.where(heads, agg.gather(0, seg), ident).to(torch.int64)
    cnts = torch.where(heads, cnt.gather(0, seg), 0)
    return heads, aggs, cnts
