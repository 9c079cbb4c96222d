"""BatchWriter — client-side ingest batching (paper §II); a copy of the
reference's core/ingest.py cut to what this package calls.

Each parallel ingest client owns one writer. It buffers parsed events and
flushes them in bulk; a flush that trips a major compaction blocks the
caller — the backpressure the paper measures (§IV-A). DistBatchWriter
(core/dist_ingest.py) retargets the flush at the device plane.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from ..obs import span
from .store import EventStore


@dataclass
class IngestMetrics:
    """Per-writer telemetry."""

    rows: int = 0
    bytes: int = 0
    flushes: int = 0
    blocked_seconds: float = 0.0
    flush_seconds: float = 0.0


class BatchWriter:
    """Buffers parsed events; flushes them in bulk to the sharded store."""

    def __init__(self, store: EventStore, batch_rows: int = 4096):
        self.store = store
        self.batch_rows = batch_rows
        self.metrics = IngestMetrics()
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
        m = self.metrics
        m.rows += n
        m.flushes += 1
        m.blocked_seconds += blocked
        m.flush_seconds += time.perf_counter() - t0

    def close(self) -> None:
        self.flush()


def check_shard_guidance(n_shards: int, n_clients: int) -> bool:
    """The paper's sizing rule: N >= clients / 2."""
    return n_shards >= n_clients / 2
