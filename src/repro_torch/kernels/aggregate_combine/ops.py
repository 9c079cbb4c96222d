"""The combiner kernel's wrapper — the aggregate family's
combiner-on-compaction and the host combiner op.

``combine_blocks(keys, counts)`` marks the head of every run of equal keys
along the last dim and puts the run's int64 count sum at its head: the
CUDA kernel (csrc/aggregate_combine.cu) for CUDA tensors, its plain version
(ref.py) for CPU tensors. The kernel sums tile by tile, and its second
pass folds the tile-start entries that continue a key into the key's
head.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..build import check, load_library
from .ref import combine_blocks_ref

# Kernel launches since the last reset (chip_smoke.py zeroes it before a
# path and reads it after).
launches = 0

_ENTRY = {torch.int32: "aggregate_combine_i32", torch.int64: "aggregate_combine_i64"}


def combine_blocks(keys: torch.Tensor, counts: torch.Tensor):
    """keys int64 (..., n) sorted along the last dim; counts int32 or int64
    of the same shape and device. Returns (heads bool (..., n), int64
    (..., n) each key's count sum at its head and 0 elsewhere). CPU
    tensors run the plain version; CUDA tensors launch the kernel, one
    launch for all leading dims."""
    if keys.dtype != torch.int64:
        raise TypeError(f"keys must be int64, got {keys.dtype}")
    if counts.dtype not in _ENTRY:
        raise TypeError(f"counts must be int32 or int64, got {counts.dtype}")
    if counts.shape != keys.shape or keys.dim() == 0:
        raise ValueError(f"keys {tuple(keys.shape)} and counts {tuple(counts.shape)} differ")
    if counts.device != keys.device:
        raise ValueError(f"counts are on {counts.device}, keys on {keys.device}")
    if keys.device.type == "cpu":
        return combine_blocks_ref(keys, counts)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    n = keys.shape[-1]
    rows = keys.numel() // n if n else 0
    heads = torch.empty(keys.shape, dtype=torch.bool, device=keys.device)
    sums = torch.empty(keys.shape, dtype=torch.int64, device=keys.device)
    if keys.numel() == 0:
        return heads, sums
    k2 = keys.reshape(rows, n).contiguous()
    c2 = counts.reshape(rows, n).contiguous()
    lib = load_library()
    # Scratch: each tile's last true head, for the kernel's stitch pass.
    last = torch.empty((rows, -(-n // lib.aggregate_combine_tile_rows())), dtype=torch.int64,
                       device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    check(getattr(lib, _ENTRY[counts.dtype])(
        k2.data_ptr(), c2.data_ptr(), rows, n, heads.data_ptr(), sums.data_ptr(),
        last.data_ptr(), stream), "aggregate_combine")
    global launches
    launches += 1
    return heads, sums


def combine_sorted_counts(keys: np.ndarray, counts: np.ndarray,
                          device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """(sorted int64 keys with duplicates, int32 counts) -> (unique sorted
    keys, their summed counts as int32), computed on ``device``. The sums
    are exact in int64 and then cast, which wraps exactly as the
    reference's int32 sums do."""
    keys = np.asarray(keys, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int32)
    if keys.size == 0:
        return keys, counts
    from ...core.device import resolve_device  # core imports this package

    dev = resolve_device(device)
    heads, sums = combine_blocks(torch.from_numpy(keys).to(dev), torch.from_numpy(counts).to(dev))
    return keys[heads.cpu().numpy()], sums[heads].to(torch.int32).cpu().numpy()
