"""EventStore — one data source's three tables (paper §II, Fig 1), sharded
into host tablets; a copy of the reference's core/store.py cut to what
this package calls.

  event table   key = shard|rev_ts|hash      cols = field codes
  index table   key = field|value|rev_ts     cols = event key (2 lanes)
  aggregate     key = field|value|bucket     cols = count

Runs stay numpy arrays on the host; the tablets' compactions (sort,
merge, combine) run on the store's device, "cuda" unless the caller
passes device="cpu". The device plane takes its schema, dictionaries,
indexed fields and aggregate bucketing from a store
(DistIngestPlane.for_store, DistBatchWriter).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import keypack
from .device import resolve_device
from .schema import EventSchema, FieldDictionary
from .tables import AggregateTablet, Tablet

DEFAULT_AGG_BUCKET_SECONDS = 3600


def split_key64(key: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int64 -> (hi, lo) int32 lanes (the index table's payload)."""
    key = np.asarray(key, dtype=np.int64)
    hi = (key >> 32).astype(np.int32)
    lo = (key & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return hi, lo


def join_key64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) int32 lanes -> int64 (the inverse of split_key64)."""
    hi = np.asarray(hi).astype(np.int64)
    lo = np.asarray(lo).astype(np.int64) & 0xFFFFFFFF
    return (hi << 32) | lo


class EventStore:
    """One data source's three tables, sharded n_shards ways, compacting
    on ``device`` (default "cuda"; raises without CUDA unless the caller
    passes device="cpu")."""

    def __init__(self, schema: EventSchema, n_shards: int = 8, flush_rows: int = 32768,
                 max_runs: int = 8, agg_bucket_seconds: int = DEFAULT_AGG_BUCKET_SECONDS,
                 seed: int = 0, device="cuda"):
        if n_shards > keypack.MAX_SHARDS:
            raise ValueError(f"n_shards > {keypack.MAX_SHARDS}")
        self.device = resolve_device(device)
        self.schema = schema
        self.n_shards = n_shards
        self.agg_bucket_seconds = agg_bucket_seconds
        self.dictionaries: Dict[str, FieldDictionary] = {
            f.name: FieldDictionary(f.name) for f in schema.fields
        }
        self.event_tablets: List[Tablet] = [
            Tablet(s, width=schema.n_fields, flush_rows=flush_rows, max_runs=max_runs,
                   device=self.device)
            for s in range(n_shards)
        ]
        self.index_tablets: List[Tablet] = [
            Tablet(s, width=2, flush_rows=flush_rows, max_runs=max_runs, device=self.device)
            for s in range(n_shards)
        ]
        self.agg_tablet = AggregateTablet(0, flush_rows=flush_rows, max_runs=max_runs,
                                          device=self.device)
        self._indexed_field_ids = np.asarray(
            [schema.field_id(f.name) for f in schema.fields if f.indexed], dtype=np.int64
        )
        self._rng_lock = threading.Lock()
        self._rng = np.random.default_rng(seed)
        self.total_rows = 0
        self._rows_lock = threading.Lock()
        self._nonce = 0
        self.ts_min: Optional[int] = None
        self.ts_max: Optional[int] = None

    def encode_events(self, ts: np.ndarray, values: Dict[str, Sequence[str]]) -> np.ndarray:
        """values[field] -> list[str] per event; returns (n, n_fields) int32
        codes. Missing fields encode as the empty string."""
        n = len(ts)
        cols = np.zeros((n, self.schema.n_fields), dtype=np.int32)
        for name in self.schema.field_names():
            fid = self.schema.field_id(name)
            vals = values.get(name)
            if vals is None:
                cols[:, fid] = self.dictionaries[name].encode("")
            else:
                cols[:, fid] = self.dictionaries[name].encode_many(vals)
        return cols

    def ingest_encoded(self, ts: np.ndarray, cols: np.ndarray) -> float:
        """Insert pre-encoded events into all three tables. Returns seconds
        blocked on compaction (backpressure)."""
        n = len(ts)
        if n == 0:
            return 0.0
        ts = np.asarray(ts, dtype=np.int64)
        if np.any(ts < 0) or np.any(ts > keypack.TS_MAX):
            raise ValueError("timestamp out of 30-bit store range")
        with self._rng_lock:
            shards = keypack.assign_shards(n, self.n_shards, self._rng)
            nonce = np.arange(self._nonce, self._nonce + n, dtype=np.int64)
            self._nonce += n
        rts = keypack.rev_ts(ts)
        h = keypack.short_hash(*(cols[:, j] for j in range(cols.shape[1])), ts, nonce)
        ekeys = keypack.pack_event_key(shards, rts, h)
        fids = self._indexed_field_ids
        blocked = 0.0
        for s in np.unique(shards):
            m = shards == s
            blocked += self.event_tablets[int(s)].insert(ekeys[m], cols[m])
            n_m = int(m.sum())
            if n_m and len(fids):
                vcodes = cols[m][:, fids].T.reshape(-1).astype(np.int64)
                ikeys = keypack.pack_index_key(
                    np.repeat(fids, n_m), vcodes, np.tile(rts[m], len(fids))
                )
                hi, lo = split_key64(np.tile(ekeys[m], len(fids)))
                blocked += self.index_tablets[int(s)].insert(ikeys, np.stack([hi, lo], axis=1))
        buckets = ts // self.agg_bucket_seconds
        if len(fids):
            akeys = np.concatenate([
                keypack.pack_agg_key(fid, cols[:, fid].astype(np.int64), buckets) for fid in fids
            ])
            ukeys, counts = np.unique(akeys, return_counts=True)
            blocked += self.agg_tablet.insert(ukeys, counts.astype(np.int64)[:, None])
        with self._rows_lock:
            self.total_rows += n
            lo_t, hi_t = int(ts.min()), int(ts.max())
            self.ts_min = lo_t if self.ts_min is None else min(self.ts_min, lo_t)
            self.ts_max = hi_t if self.ts_max is None else max(self.ts_max, hi_t)
        return blocked

    def ingest(self, ts: np.ndarray, values: Dict[str, Sequence[str]]) -> float:
        return self.ingest_encoded(np.asarray(ts), self.encode_events(ts, values))

    def rows_per_second(self) -> float:
        """Mean event density — seeds the adaptive batcher's b0."""
        if not self.total_rows or self.ts_min is None:
            return 1.0
        return self.total_rows / max(self.ts_max - self.ts_min, 1)

    def agg_count(self, field: str, value: str, t_start: int, t_stop: int) -> int:
        """The planner's density input (paper §III-B): occurrences of
        field=value in the bucketed time range, from the aggregate table."""
        code = self.dictionaries[field].lookup(value)
        if code is None:
            return 0
        fid = self.schema.field_id(field)
        b0 = int(t_start) // self.agg_bucket_seconds
        b1 = int(t_stop) // self.agg_bucket_seconds
        lo = keypack.pack_agg_key(fid, code, b0)
        hi = keypack.pack_agg_key(fid, code, b1) + 1
        return self.agg_tablet.count_range(int(lo), int(hi))

    def _tablets(self) -> List[Tablet]:
        return self.event_tablets + self.index_tablets + [self.agg_tablet]

    def flush_all(self) -> None:
        """Flush every tablet's memtable to a sorted run."""
        for t in self._tablets():
            t.flush()

    def compact_all(self) -> None:
        """Flush, then major-compact every tablet to one run."""
        for t in self._tablets():
            t.compact()

    def backpressure_stats(self) -> Dict[str, float]:
        """The event tablets' compaction telemetry (the ingest experiments'
        backpressure signal)."""
        evs = self.event_tablets
        return {
            "rows": self.total_rows,
            "minor_compactions": sum(t.minor_compactions for t in evs),
            "major_compactions": sum(t.major_compactions for t in evs),
            "blocked_seconds": sum(t.blocked_seconds for t in evs),
        }
