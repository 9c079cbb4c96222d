"""The combiner kernels' wrappers — the plane's combiner-on-compaction
and the host combiner op. Each runs its CUDA kernel
(csrc/aggregate_combine.cu) for CUDA tensors and its plain version
(ref.py) for CPU tensors.

``combine_compact(keys, counts, n_live, cap, sentinel)`` is the plane's
compaction of a merged family: the unique keys of each row compacted to
the front, cut to the base's capacity, with their count sums (the
aggregate family) or without (the index family's dedup). The kernel reads
only each row's live prefix of keys and writes every output slot once.

``combine_blocks(keys, counts)`` marks the head of every run of equal keys
along the last dim and puts the run's int64 count sum at its head, for
``combine_sorted_counts`` (the reference's host combiner op, which no path
of either package calls: the host store's combiner is
core/tables.py::_combine_sorted in PyTorch, as the reference's is jnp).
The kernel sums tile by tile, and its second pass folds the tile-start
entries that continue a key into the key's head.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..build import check, load_library
from ..common import count_launch
from .ref import combine_blocks_ref, combine_compact_ref

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
    count_launch(globals())
    return heads, sums


def combine_compact(keys: torch.Tensor, counts: Optional[torch.Tensor], n_live: torch.Tensor,
                    cap: int, sentinel: int):
    """keys int64 (T, N), each row sorted over its first n_live[t] entries
    (integer (T,), on the keys' device), which lie below the sentinel;
    keys past them count as the sentinel and are not read. counts int32
    or int64 (T, N), or None for the dedup form; 0 <= cap <= N. Returns
    new tensors (ukeys int64 (T, cap), int64 sums (T, cap) or None, int32
    n_unique (T,)), as ref.combine_compact_ref defines them. CPU tensors
    run the plain version; CUDA tensors launch the kernel, one launch for
    all rows."""
    if keys.dtype != torch.int64 or keys.dim() != 2:
        raise TypeError(f"keys must be int64 (T, N), got {keys.dtype} {tuple(keys.shape)}")
    if counts is not None:
        if counts.dtype not in _ENTRY:
            raise TypeError(f"counts must be int32 or int64, got {counts.dtype}")
        if counts.shape != keys.shape or counts.device != keys.device:
            raise ValueError(f"counts {tuple(counts.shape)} on {counts.device} do not match "
                             f"keys {tuple(keys.shape)} on {keys.device}")
    t, n = keys.shape
    if n_live.shape != (t,) or n_live.device != keys.device or n_live.is_floating_point():
        raise ValueError(f"n_live must be integers ({t},) on {keys.device}, got "
                         f"{n_live.dtype} {tuple(n_live.shape)} on {n_live.device}")
    if not 0 <= cap <= n or n >= 2**31:
        raise ValueError(f"cap {cap} must lie in [0, {n}], and N below 2**31")
    if keys.device.type == "cpu":
        return combine_compact_ref(keys, counts, n_live, cap, sentinel)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    dev = keys.device
    ukeys = torch.empty((t, cap), dtype=torch.int64, device=dev)
    sums = None if counts is None else torch.empty((t, cap), dtype=torch.int64, device=dev)
    if t == 0 or n == 0:
        return ukeys, sums, torch.zeros(t, dtype=torch.int32, device=dev)
    n_unique = torch.empty(t, dtype=torch.int32, device=dev)
    k = keys.contiguous()
    c = None if counts is None else counts.contiguous()
    live = n_live.to(torch.int32).contiguous()
    lib = load_library()
    tiles = -(-n // lib.aggregate_combine_tile_rows())
    # Scratch: each tile's first output slot (then the row's segment
    # count), and each tile's carried partial sum (then the row's tail sum).
    first = torch.empty((t, tiles + 1), dtype=torch.int32, device=dev)
    carry = None if counts is None else torch.empty((t, tiles + 1), dtype=torch.int64, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.combine_compact(
        k.data_ptr(), ptr(c), 0 if c is None else c.element_size(), live.data_ptr(), t, n,
        cap, sentinel, first.data_ptr(), ptr(carry), ukeys.data_ptr(), ptr(sums),
        n_unique.data_ptr(), stream), "combine_compact")
    count_launch(globals())
    return ukeys, sums, n_unique


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
