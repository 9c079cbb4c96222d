"""Scanners — range reads against the sharded host store; a copy of the
reference's core/scan.py.

  * Scanner: a packed-key range per shard resolved by searchsorted.
  * BatchScanner: every query uses it, with no ordering guarantee across
    shards — per-shard row blocks, cross-shard order unspecified.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np

from . import keypack
from .store import EventStore, join_key64


@dataclass
class RowBlock:
    """A block of event rows from one shard (columnar)."""

    shard: int
    keys: np.ndarray  # int64 [n] packed event keys
    cols: np.ndarray  # int32 [n, n_cols] dictionary codes
    field_ids: Optional[np.ndarray] = None  # set when projected: cols -> schema ids

    @property
    def n(self) -> int:
        return int(self.keys.shape[0])

    @property
    def nbytes(self) -> int:
        """Bytes this block costs to ship to the client (what the iterator
        stack exists to shrink)."""
        return self.keys.nbytes + self.cols.nbytes

    def ts(self) -> np.ndarray:
        _, rts, _ = keypack.unpack_event_key(self.keys)
        return keypack.unrev_ts(rts)


def scan_events(store: EventStore, t_start: int, t_stop: int,
                shards: Optional[Sequence[int]] = None, iterators=None) -> Iterator[RowBlock]:
    """BatchScanner over the event table for timestamps in [t_start,
    t_stop]. ``iterators``: an optional IteratorStack (core/iterators.py)
    applied to each block before it leaves the scanner; with a terminal
    CombinerIterator the scan yields AggregateBlocks."""
    for s in shards if shards is not None else range(store.n_shards):
        lo, hi = keypack.event_key_range(s, t_start, t_stop)
        keys, cols = store.event_tablets[s].scan_range(int(lo), int(hi))
        if keys.size:
            blk = RowBlock(s, keys, cols)
            if iterators is not None:
                blk = iterators.apply_block(blk)
                if blk is None:
                    continue
            yield blk


def index_scan(store: EventStore, field: str, value_codes: np.ndarray, t_start: int,
               t_stop: int, shards: Optional[Sequence[int]] = None) -> List[np.ndarray]:
    """Index-table lookup: per shard, the sorted event keys of rows whose
    ``field`` has any of ``value_codes`` within the time range."""
    fid = store.schema.field_id(field)
    out: List[np.ndarray] = []
    for s in shards if shards is not None else range(store.n_shards):
        tab = store.index_tablets[s]
        parts = []
        for code in np.atleast_1d(value_codes):
            lo = keypack.pack_index_key(fid, int(code), keypack.rev_ts(t_stop))
            hi = keypack.pack_index_key(fid, int(code), keypack.rev_ts(t_start)) + 1
            _, payload = tab.scan_range(int(lo), int(hi))
            if payload.size:
                parts.append(join_key64(payload[:, 0], payload[:, 1]))
        if parts:
            ek = np.concatenate(parts)
            ek.sort()
            out.append(ek)
        else:
            out.append(np.empty(0, np.int64))
    return out


def fetch_rows_by_keys(store: EventStore, shard: int, event_keys: np.ndarray) -> RowBlock:
    """Point lookups of event rows by sorted packed keys within one shard
    (the paper's Fig 2 step that passes row IDs to an event scanner)."""
    tab = store.event_tablets[shard]
    runs = tab.snapshot_runs()
    found_k: List[np.ndarray] = []
    found_c: List[np.ndarray] = []
    for r in runs:
        pos = np.searchsorted(r.keys, event_keys)
        pos_c = np.clip(pos, 0, max(r.n - 1, 0))
        if r.n:
            hit = (pos < r.n) & (r.keys[pos_c] == event_keys)
        else:
            hit = np.zeros(len(event_keys), bool)
        if hit.any():
            found_k.append(event_keys[hit])
            found_c.append(r.cols[pos_c[hit]])
    if not found_k:
        return RowBlock(shard, np.empty(0, np.int64), np.empty((0, tab.width), np.int32))
    keys = np.concatenate(found_k)
    cols = np.concatenate(found_c)
    order = np.argsort(keys, kind="stable")
    return RowBlock(shard, keys[order], cols[order])
