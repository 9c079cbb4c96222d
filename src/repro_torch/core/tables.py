"""Host tablets: sorted columnar storage for one shard of one table; a
copy of the reference's core/tables.py cut to what this package calls.

    memtable  (unsorted append buffer, host)
      --minor compaction-->  a new sorted run
    runs > max_runs
      --major compaction (blocks the writer: backpressure)-->  one run

Runs stay numpy arrays on the host, as in the reference; the data plane
of both compactions runs on the tablet's device (the reference jits them
onto its default device): the minor compaction's stable sort, the major
compaction's merge (kernels/merge_runs::merge_sorted_runs, which launches
the merge_runs kernel on the card) and AggregateTablet's combiner.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..kernels.merge_runs import merge_sorted_runs
from .device import resolve_device


def _sort_run(keys: np.ndarray, cols: np.ndarray, device: torch.device):
    """Sort a (keys, cols) batch by key (stable) on ``device`` — minor
    compaction. Returns numpy arrays."""
    k, order = torch.sort(torch.from_numpy(keys).to(device), stable=True)
    c = torch.from_numpy(cols).to(device)[order]
    return k.cpu().numpy(), c.cpu().numpy()


def _combine_sorted(keys: np.ndarray, vals: np.ndarray, device: torch.device):
    """Combiner on ``device``: sum vals (as int64) of equal adjacent keys
    of a sorted run. Returns numpy (unique keys, sums)."""
    if keys.size == 0:
        return keys, vals.astype(np.int64)
    k = torch.from_numpy(keys).to(device)
    v = torch.from_numpy(np.ascontiguousarray(vals)).to(device).to(torch.int64)
    is_head = torch.ones_like(k, dtype=torch.bool)
    is_head[1:] = k[1:] != k[:-1]
    heads = torch.nonzero(is_head).squeeze(1)
    # Segment sums as differences of the inclusive prefix sum at each
    # segment's last entry (exact in int64).
    ends = torch.cat([heads[1:], heads.new_tensor([k.numel()])]) - 1
    at_end = torch.cumsum(v, 0)[ends]
    sums = at_end - torch.cat([at_end.new_zeros(1), at_end[:-1]])
    return k[heads].cpu().numpy(), sums.cpu().numpy()


@dataclass
class SortedRun:
    """One immutable sorted file (ISAM analogue)."""

    keys: np.ndarray  # int64 [n], ascending
    cols: np.ndarray  # [n, width] payload columns

    @property
    def n(self) -> int:
        return int(self.keys.shape[0])

    def range_slice(self, lo: int, hi: int) -> Tuple[int, int]:
        """Row span [a, b) with lo <= key < hi."""
        a = int(np.searchsorted(self.keys, lo, side="left"))
        b = int(np.searchsorted(self.keys, hi, side="left"))
        return a, b


class Tablet:
    """One shard of one table. Thread-safe for concurrent inserts. Its
    compactions run on ``device`` (default "cuda"; raises without CUDA
    unless the caller passes "cpu")."""

    def __init__(self, shard: int, width: int, flush_rows: int = 32768,
                 max_runs: int = 8, col_dtype=np.int32, device="cuda"):
        self.shard = shard
        self.device = resolve_device(device)
        self.width = width
        self.flush_rows = flush_rows
        self.max_runs = max_runs
        self.col_dtype = np.dtype(col_dtype)
        self.runs: List[SortedRun] = []
        self._mem_keys: List[np.ndarray] = []
        self._mem_cols: List[np.ndarray] = []
        self._mem_rows = 0
        self.lock = threading.Lock()
        self.minor_compactions = 0
        self.major_compactions = 0
        self.blocked_seconds = 0.0

    def insert(self, keys: np.ndarray, cols: np.ndarray) -> float:
        """Append a batch of entries. Returns seconds blocked on a major
        compaction this insert tripped."""
        if cols.shape != (keys.shape[0], self.width):
            raise ValueError(f"cols shape {cols.shape} != ({keys.shape[0]}, {self.width})")
        blocked = 0.0
        with self.lock:
            self._mem_keys.append(np.asarray(keys, dtype=np.int64))
            self._mem_cols.append(np.asarray(cols, dtype=self.col_dtype))
            self._mem_rows += len(keys)
            if self._mem_rows >= self.flush_rows:
                t0 = time.perf_counter()
                self._minor_compact()
                if len(self.runs) > self.max_runs:
                    self._major_compact()
                    blocked = time.perf_counter() - t0
                    self.blocked_seconds += blocked
        return blocked

    def _minor_compact(self) -> None:
        keys = np.concatenate(self._mem_keys)
        cols = np.concatenate(self._mem_cols)
        self._mem_keys, self._mem_cols, self._mem_rows = [], [], 0
        self.runs.append(SortedRun(*_sort_run(keys, cols, self.device)))
        self.minor_compactions += 1

    def _major_compact(self) -> None:
        k, c = merge_sorted_runs([(r.keys, r.cols) for r in self.runs], device=self.device)
        self.runs = [SortedRun(k, c)]
        self.major_compactions += 1

    def flush(self) -> None:
        """Force the memtable to a run (used at the end of ingest)."""
        with self.lock:
            if self._mem_rows:
                self._minor_compact()

    def compact(self) -> None:
        """Flush, then merge every run into one."""
        with self.lock:
            if self._mem_rows:
                self._minor_compact()
            if len(self.runs) > 1:
                self._major_compact()

    @property
    def n_rows(self) -> int:
        with self.lock:
            return sum(r.n for r in self.runs) + self._mem_rows

    def snapshot_runs(self) -> List[SortedRun]:
        """Runs visible to a scan (flush-on-read)."""
        with self.lock:
            if self._mem_rows:
                self._minor_compact()
            return list(self.runs)

    def scan_range(self, lo: int, hi: int) -> Tuple[np.ndarray, np.ndarray]:
        """All entries with lo <= key < hi, sorted by key."""
        runs = self.snapshot_runs()
        parts_k, parts_c = [], []
        for r in runs:
            a, b = r.range_slice(lo, hi)
            if b > a:
                parts_k.append(r.keys[a:b])
                parts_c.append(r.cols[a:b])
        if not parts_k:
            return np.empty(0, np.int64), np.empty((0, self.width), self.col_dtype)
        keys = np.concatenate(parts_k)
        cols = np.concatenate(parts_c)
        if len(runs) > 1:
            order = np.argsort(keys, kind="stable")
            keys, cols = keys[order], cols[order]
        return keys, cols


class AggregateTablet(Tablet):
    """Aggregate table tablet: cols = [count] int64. Major compaction also
    sums duplicate keys (Accumulo's combiner-on-compaction)."""

    def __init__(self, shard: int, **kw):
        kw.setdefault("col_dtype", np.int64)
        super().__init__(shard, width=1, **kw)

    def _major_compact(self) -> None:
        k, c = merge_sorted_runs([(r.keys, r.cols) for r in self.runs], device=self.device)
        ukeys, sums = _combine_sorted(k, c[:, 0], self.device)
        self.runs = [SortedRun(ukeys, sums[:, None].astype(self.col_dtype))]
        self.major_compactions += 1

    def count_range(self, lo: int, hi: int) -> int:
        """Total count over an aggregate-key range, summed across runs (so
        duplicates not yet combined count too)."""
        _, cols = self.scan_range(lo, hi)
        return int(cols[:, 0].astype(np.int64).sum()) if cols.size else 0
