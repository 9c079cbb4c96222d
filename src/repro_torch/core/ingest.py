"""BatchWriter — client-side ingest batching (paper §II); a copy of the
reference's core/ingest.py.

Each parallel ingest client owns one writer. It buffers parsed events and
flushes them in bulk; a flush that trips a major compaction blocks the
caller — the backpressure the paper measures (§IV-A). DistBatchWriter
(core/dist_ingest.py) retargets the flush at the device plane.

The paper's sizing guidance, N shards >= clients / 2, is
``check_shard_guidance``.
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..obs import get_registry, span
from .store import EventStore

_writer_seq = itertools.count()


class IngestMetrics:
    """Per-writer telemetry: a view over counters on the default metrics
    registry (``ingest_rows_total`` etc., labelled by a per-instance writer
    id), so ``obs.metrics_snapshot()`` sees every writer. Fields read and
    write through properties (``m.rows += n``)."""

    _FIELDS = {
        "rows": "ingest_rows_total",
        "bytes": "ingest_bytes_total",
        "flushes": "ingest_flushes_total",
        "blocked_seconds": "ingest_blocked_seconds_total",
        "flush_seconds": "ingest_flush_seconds_total",
    }

    def __init__(self) -> None:
        self._label = f"w{next(_writer_seq)}"
        reg = get_registry()
        self._counters = {f: reg.counter(n) for f, n in self._FIELDS.items()}
        # (wall_time, rows_flushed) samples — the instantaneous-rate series.
        self.samples: List = []

    def _get(self, f: str) -> float:
        return self._counters[f].value(writer=self._label)

    def _set(self, f: str, v: float) -> None:
        self._counters[f].set_value(v, writer=self._label)

    rows = property(lambda s: int(s._get("rows")), lambda s, v: s._set("rows", v))
    bytes = property(lambda s: int(s._get("bytes")), lambda s, v: s._set("bytes", v))
    flushes = property(lambda s: int(s._get("flushes")), lambda s, v: s._set("flushes", v))
    blocked_seconds = property(
        lambda s: s._get("blocked_seconds"), lambda s, v: s._set("blocked_seconds", v)
    )
    flush_seconds = property(
        lambda s: s._get("flush_seconds"), lambda s, v: s._set("flush_seconds", v)
    )

    def __repr__(self) -> str:
        return (
            f"IngestMetrics(rows={self.rows}, bytes={self.bytes}, "
            f"flushes={self.flushes}, blocked_seconds={self.blocked_seconds:.4f}, "
            f"flush_seconds={self.flush_seconds:.4f}, samples={len(self.samples)})"
        )


class BatchWriter:
    """Buffers parsed events; flushes them in bulk to the sharded store."""

    def __init__(self, store: EventStore, batch_rows: int = 4096,
                 metrics: Optional[IngestMetrics] = None):
        self.store = store
        self.batch_rows = batch_rows
        self.metrics = metrics if metrics is not None else IngestMetrics()
        self._ts: List[np.ndarray] = []
        self._vals: List[Dict[str, Sequence[str]]] = []
        self._rows = 0

    def add(self, ts: np.ndarray, values: Dict[str, Sequence[str]], nbytes: int = 0) -> None:
        """Queue a parsed batch of events (ts int seconds + field values)."""
        self._ts.append(np.asarray(ts, dtype=np.int64))
        self._vals.append(values)
        self._rows += len(ts)
        self.metrics.bytes += nbytes
        if self._rows >= self.batch_rows:
            self.flush()

    def _write(self, ts: np.ndarray, values: Dict[str, List[str]]) -> float:
        """Sink one flushed batch; returns seconds blocked on compaction."""
        return self.store.ingest(ts, values)

    def flush(self) -> None:
        if not self._rows:
            return
        ts = np.concatenate(self._ts)
        merged: Dict[str, List[str]] = {}
        for v in self._vals:
            for k, vv in v.items():
                merged.setdefault(k, []).extend(vv)
        n = len(ts)
        self._ts, self._vals, self._rows = [], [], 0
        t0 = time.perf_counter()
        with span("ingest.flush", cat="ingest", rows=n) as sp:
            blocked = self._write(ts, merged)
            sp.set(blocked_s=blocked)
        dt = time.perf_counter() - t0
        m = self.metrics
        m.rows += n
        m.flushes += 1
        m.blocked_seconds += blocked
        m.flush_seconds += dt
        m.samples.append((time.perf_counter(), n))

    def close(self) -> None:
        self.flush()


def check_shard_guidance(n_shards: int, n_clients: int) -> bool:
    """The paper's sizing rule: N >= clients / 2."""
    return n_shards >= n_clients / 2


def rate_series(metrics_list: Sequence[IngestMetrics], bucket_s: float = 0.25):
    """Aggregate flush samples across writers into an instantaneous
    rows/sec time series (the paper's Fig 4 signal). Returns (bucket start
    seconds, rows/s)."""
    samples = sorted(s for m in metrics_list for s in m.samples)
    if not samples:
        return np.zeros(0), np.zeros(0)
    t = np.asarray([s[0] for s in samples], dtype=np.float64)
    rows = np.asarray([s[1] for s in samples], dtype=np.float64)
    t0, t_end = t[0], t[-1]
    n_b = max(int((t_end - t0) / bucket_s) + 1, 1)
    # Half-open buckets [edge_i, edge_{i+1}) from explicit edges: an event
    # exactly on a boundary belongs to the bucket it opens.
    edges = t0 + bucket_s * np.arange(n_b + 1)
    idx = np.clip(np.searchsorted(edges, t, side="right") - 1, 0, n_b - 1)
    rate = np.bincount(idx, weights=rows, minlength=n_b)
    return np.arange(n_b) * bucket_s, rate / bucket_s
