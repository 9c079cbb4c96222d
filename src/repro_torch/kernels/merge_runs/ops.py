"""K-way sorted-run merge — major compaction's data plane.

``merge_ranks`` is the kernel wrapper: the output rank of every entry of
K sorted runs laid back to back, from the CUDA kernel
(csrc/merge_runs.cu) for CUDA tensors and from its plain version (ref.py)
for CPU tensors. Each run carries its live length, so runs of different
capacities merge without padding. The entry points around it scatter keys
and payload by rank:

  merge_sorted_device   K runs per tablet, batched over tablets
                        (the plane's K-way major stage)
  merge_pair_device     base + one run per tablet (the plane's 2-way major
                        stage and the incremental fold)
  merge_window_keys     one window of output ranks of K sentinel-padded
                        runs (a merge resumable by rank)
  merge_sorted_runs     host tablets' ragged numpy runs
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from ..build import check, load_library
from ..common import count_launch
from .ref import merge_ranks_ref

# Kernel launches since the last reset (chip_smoke.py zeroes it before the
# main path and reads it after).
launches = 0

# Runs one launch takes: the kernel's parameter block holds the bounds and
# every pair of runs (csrc/merge_runs.cu), and its grid has one row per
# batch.
MAX_RUNS = 32
MAX_BATCHES = 65535


def merge_ranks(keys: torch.Tensor, bounds: Sequence[int], lengths: torch.Tensor) -> torch.Tensor:
    """keys (B, N) int32/int64 holding K runs back to back, run o at
    [bounds[o], bounds[o+1]) with bounds[0] = 0 and bounds[K] = N; lengths
    (B, K) int32, the live entries of each run, which are sorted ascending
    and lie below the dtype-max sentinel. Entries past a run's length count
    as the sentinel whatever they hold. Returns int32 (B, N) ranks — a
    permutation of [0, N) per batch, earlier runs winning ties, dead
    entries last in (run, index) order. CPU tensors run the plain version;
    CUDA tensors launch the kernel."""
    bounds = tuple(int(x) for x in bounds)
    if keys.dim() != 2:
        raise ValueError(f"keys must be (B, N), got {tuple(keys.shape)}")
    if keys.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"keys must be int32 or int64, got {keys.dtype}")
    b, n = keys.shape
    k = len(bounds) - 1
    if k < 1 or bounds[0] != 0 or bounds[-1] != n or any(
            bounds[o] > bounds[o + 1] for o in range(k)):
        raise ValueError(f"bounds {bounds} do not split N = {n} into runs")
    if lengths.shape != (b, k) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 ({b}, {k}), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if lengths.device != keys.device:
        raise ValueError(f"lengths is on {lengths.device}, keys on {keys.device}")
    if keys.device.type == "cpu":
        return merge_ranks_ref(keys, bounds, lengths)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if k > MAX_RUNS or b > MAX_BATCHES:
        raise ValueError(f"{k} runs of {b} batches exceed the kernel's {MAX_RUNS} "
                         f"and {MAX_BATCHES}")
    if n >= 2**31:
        raise ValueError(f"N = {n} does not fit int32 ranks")
    keys = keys.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty((b, n), dtype=torch.int32, device=keys.device)
    if keys.numel() == 0:
        return out
    lib = load_library()
    fn = lib.merge_ranks_i32 if keys.dtype == torch.int32 else lib.merge_ranks_i64
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    check(fn(keys.data_ptr(), (ctypes.c_longlong * (k + 1))(*bounds), lengths.data_ptr(),
             out.data_ptr(), b, k, n, stream), "merge_ranks")
    count_launch(globals())
    return out


def _scatter_by_rank(keys, cols, ranks):
    """Place (B, N) keys and (B, N, W) cols at their (B, N) ranks."""
    b, n = keys.shape
    idx = ranks.to(torch.int64)
    out_keys = torch.empty_like(keys).scatter_(1, idx, keys)
    w = cols.shape[-1]
    if w == 0:
        return out_keys, cols.new_empty((b, n, 0))
    out_cols = torch.empty_like(cols).scatter_(1, idx[..., None].expand(b, n, w), cols)
    return out_keys, out_cols


def merge_sorted_device(run_keys: torch.Tensor, run_cols: torch.Tensor, run_n: torch.Tensor):
    """run_keys (B, K, R): run o sorted ascending over its first
    run_n[:, o] entries (int32 (B, K)) and sentinel-valued past them, with
    zero cols there (callers mask stale slots); run_cols (B, K, R, W)
    payload (W may be 0). Returns the merged (B, K*R) keys and (B, K*R, W)
    cols, sentinels as a contiguous tail."""
    b, k, r = run_keys.shape
    ranks = merge_ranks(run_keys.reshape(b, k * r), [o * r for o in range(k + 1)], run_n)
    return _scatter_by_rank(
        run_keys.reshape(b, k * r), run_cols.reshape(b, k * r, run_cols.shape[-1]), ranks
    )


def merge_pair_device(a_keys, a_cols, a_n, b_keys, b_cols, b_n):
    """2-way merge per tablet: a_keys (B, Ca) and b_keys (B, Cb), each
    sorted over its first a_n / b_n (int32 (B,)) entries and
    sentinel-valued with zero cols past them; cols (B, C, W) travel with
    their keys. Returns the merged (B, Ca+Cb) keys and cols — real keys
    first (stable: a-side wins ties), sentinels as a contiguous tail. The
    two sides are laid back to back with no padding (the reference pads
    both to a power of two); with zero cols on every sentinel the output
    is the same."""
    ca = a_keys.shape[1]
    keys = torch.cat([a_keys, b_keys], dim=1)
    cols = torch.cat([a_cols, b_cols], dim=1)
    ranks = merge_ranks(keys, (0, ca, keys.shape[1]), torch.stack([a_n, b_n], dim=1))
    return _scatter_by_rank(keys, cols, ranks)


def merge_window_keys(keys: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """The keys at output ranks [start, start + length) of the merge of
    keys (K, R) int32/int64, each row sorted ascending and padded with the
    dtype-max sentinel; ranks past the last entry hold the sentinel.
    Consecutive windows concatenate to the whole merge, so a merge can be
    resumed by rank. The ranks come from merge_ranks (one launch on the
    card), each row's live length its keys below the sentinel."""
    k, r = keys.shape
    sentinel = torch.iinfo(keys.dtype).max
    lengths = (keys < sentinel).sum(dim=1, dtype=torch.int32)[None]
    ranks = merge_ranks(keys.reshape(1, k * r), [o * r for o in range(k + 1)], lengths)
    ranks = ranks.reshape(-1).to(torch.int64)
    in_window = (ranks >= start) & (ranks < start + length)
    out = torch.full((length + 1,), sentinel, dtype=keys.dtype, device=keys.device)
    out.scatter_(0, torch.where(in_window, ranks - start, length), keys.reshape(-1))
    return out[:length]


def merge_sorted_runs(
    runs: Sequence[Tuple[np.ndarray, np.ndarray]],
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge K sorted (keys int64 [n_i], cols [n_i, w]) host runs into one,
    stable in run order, on ``device``: the concatenated runs go there, so
    on the card every merge of two or more non-empty runs launches the
    kernel once. Returns numpy (keys [n], cols [n, w]), n = sum n_i. When
    every run is empty the cols keep their width w (the reference returns
    (0, 0) there)."""
    runs = [(np.asarray(k, np.int64), np.asarray(c)) for k, c in runs]
    w = runs[0][1].shape[1] if runs else 0
    col_dtype = runs[0][1].dtype if runs else np.int32
    runs = [(k, c) for k, c in runs if k.size]
    if not runs:
        return np.empty(0, np.int64), np.empty((0, w), col_dtype)
    if len(runs) == 1:
        return runs[0]
    device = torch.device(device)
    sizes = [k.size for k, _ in runs]
    keys = torch.from_numpy(np.concatenate([k for k, _ in runs]))[None].to(device)
    cols = torch.from_numpy(
        np.concatenate([c for _, c in runs]).astype(col_dtype, copy=False))[None].to(device)
    ranks = merge_ranks(keys, np.concatenate([[0], np.cumsum(sizes)]),
                        torch.tensor([sizes], dtype=torch.int32, device=device))
    mk, mc = _scatter_by_rank(keys, cols, ranks)
    return mk[0].cpu().numpy(), mc[0].cpu().numpy()
