"""Client sessions of the query-serving plane; the port of the
reference's serve_db/session.py.

The paper measures query performance as "latency of the client receiving
initial result sets" — plural clients, concurrently, against a database
that is simultaneously ingesting (§IV-B, §V). A `QuerySession` is one
such client's handle on the shared `QueryService`: it submits paper-style
queries (any of the four §IV-B schemes, or a scan-time aggregation) and
receives STREAMING result batches — the first `ResultBatch` arrives as
soon as the query's first adaptive batch completes on the device, not
after the full time range.

Threading model: client threads only touch their session's queues; all
device work happens on the service dispatcher, which interleaves
per-session batches fairly (scheduler.py). `StreamingQuery.results()`
blocks on the queue, so a client iterating a stream consumes results at
exactly the rate its fair share of the device produces them.

This package serves *database queries* over the device store; its turn
quantum follows the paper's Alg-1 law (core/batching.py::alg1_next_k).
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .profile import QueryProfile

_DONE = object()  # stream sentinel


@dataclass
class ResultBatch:
    """One adaptive batch's results as delivered to a session.

    Distributed sessions carry the exact global `count` plus the
    per-tablet top-k newest rows (ts, cols) — BatchScanner semantics;
    host-path sessions carry the raw RowBlocks instead (`blocks`), with
    `count` the matched-row total. wait_s is the time this batch's query
    spent runnable-but-waiting for the device before the batch executed
    (queue wait — the concurrency cost of sharing the card); device_s is
    the batch's execution time."""

    seq: int
    lo: float
    hi: float
    count: int
    ts: Optional[np.ndarray] = None
    cols: Optional[np.ndarray] = None
    blocks: Optional[list] = None
    device_s: float = 0.0
    wait_s: float = 0.0


class StreamingQuery:
    """Handle on one submitted query: a thread-safe stream of ResultBatch
    plus per-query telemetry (time-to-first-result, queue wait) and a
    :class:`~repro_torch.serve_db.profile.QueryProfile` decomposing the TTFR
    into serve-path stages (filled in by the dispatcher as the query
    moves; complete once the first result is delivered)."""

    def __init__(self, qid: int, scheme: str, t_start: int, t_stop: int, tree):
        self.qid = qid
        self.scheme = scheme
        self.t_start = t_start
        self.t_stop = t_stop
        self.tree = tree
        self.profile = QueryProfile(qid, scheme)
        self.submitted_at = time.perf_counter()
        self.first_result_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.rows = 0
        self.batches = 0
        self.queue_wait_s = 0.0
        self._q: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None

    # ------------------------------------------------- dispatcher side
    def _deliver(self, rb: ResultBatch) -> None:
        now = time.perf_counter()
        if self.first_result_at is None:
            self.first_result_at = now
        self.rows += rb.count
        self.batches += 1
        self.queue_wait_s += rb.wait_s
        self._q.put(rb)

    def _finish(self, error: Optional[BaseException] = None) -> None:
        self._error = error
        self.finished_at = time.perf_counter()
        self._q.put(_DONE)

    # ------------------------------------------------------ client side
    def results(self, timeout: Optional[float] = 60.0):
        """Yield ResultBatch as the scheduler produces them; returns when
        the query completes. Raises the dispatcher-side error, if any."""
        while True:
            item = self._q.get(timeout=timeout)
            if item is _DONE:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def drain(self, timeout: Optional[float] = 60.0) -> List[ResultBatch]:
        """Block until completion; return every batch in delivery order."""
        return list(self.results(timeout=timeout))

    def count(self, timeout: Optional[float] = 60.0) -> int:
        """Block until completion; return the total matching-row count."""
        return sum(rb.count for rb in self.results(timeout=timeout))

    # -------------------------------------------------------- telemetry
    @property
    def first_result_s(self) -> Optional[float]:
        """Time-to-first-result: submit -> first batch delivered (the
        paper's Table I metric, per session)."""
        if self.first_result_at is None:
            return None
        return self.first_result_at - self.submitted_at

    @property
    def total_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at


class QuerySession:
    """One client of the QueryService. Sessions are cheap; open one per
    concurrent client thread (like one Accumulo BatchScanner per client).
    backend="dist" executes on the shared device plane; backend="host" runs
    the same queries through the host QueryProcessor under the same fair
    scheduler — the live oracle dist sessions are validated against."""

    _next_qid = itertools.count()

    def __init__(self, service, session_id: int, name: str = "", backend: str = "dist"):
        if backend not in ("dist", "host"):
            raise ValueError(f"unknown session backend: {backend!r}")
        self.service = service
        self.session_id = session_id
        self.name = name or f"session-{session_id}"
        self.backend = backend
        self.queries: List[StreamingQuery] = []  # guarded-by: _lock
        self.closed = False
        self._lock = threading.Lock()

    def submit(
        self,
        scheme: str,
        t_start: int,
        t_stop: int,
        tree=None,
        stats=None,
    ) -> StreamingQuery:
        """Submit one query (paper scheme by name: scan / batched_scan /
        index / batched_index) and return its result stream immediately.
        The scheduler delivers the first batch as soon as it completes."""
        if self.closed:
            raise RuntimeError(f"{self.name} is closed")
        sq = StreamingQuery(next(QuerySession._next_qid), scheme, t_start, t_stop, tree)
        with self._lock:
            self.queries.append(sq)
        self.service._enqueue(self, sq, stats=stats)
        return sq

    def submit_aggregate(
        self, spec, t_start: int, t_stop: int, tree=None, stats=None
    ) -> StreamingQuery:
        """Scan-time aggregation (the iterator stack's terminal combiner):
        one turn, one ResultBatch whose blocks hold the AggregateResult
        and whose count is the matched-row total."""
        if self.closed:
            raise RuntimeError(f"{self.name} is closed")
        sq = StreamingQuery(
            next(QuerySession._next_qid), "aggregate", t_start, t_stop, (spec, tree)
        )
        with self._lock:
            self.queries.append(sq)
        self.service._enqueue(self, sq, stats=stats)
        return sq

    def submit_density(
        self, field: str, value: str, t_start: int, t_stop: int
    ) -> StreamingQuery:
        """Planner-style density read (aggregate-table count for one
        field=value over the bucketed range): one turn, one ResultBatch
        whose count is the density."""
        if self.closed:
            raise RuntimeError(f"{self.name} is closed")
        sq = StreamingQuery(
            next(QuerySession._next_qid), "density", t_start, t_stop, (field, value)
        )
        with self._lock:
            self.queries.append(sq)
        self.service._enqueue(self, sq)
        return sq

    def close(self) -> None:
        """Report final telemetry into the plane and detach — the service
        drops its handle, so per-connection sessions don't accumulate.
        In-flight queries finish normally (the scheduler owns them)."""
        if self.closed:
            return
        self.closed = True
        self.service._report_session(self)
        self.service._forget_session(self)

    # -------------------------------------------------------- telemetry
    def telemetry(self) -> Dict[str, float]:
        """The per-session half of the one reporting structure: surfaced
        by DistIngestPlane.telemetry()["sessions"] next to the per-writer
        blocked-seconds (see QueryService._report_session)."""
        with self._lock:
            qs = list(self.queries)
        ttfr = [q.first_result_s for q in qs if q.first_result_s is not None]
        return {
            "queries": float(len(qs)),
            "batches": float(sum(q.batches for q in qs)),
            "rows": float(sum(q.rows for q in qs)),
            "queue_wait_s": float(sum(q.queue_wait_s for q in qs)),
            "first_result_s_max": float(max(ttfr)) if ttfr else 0.0,
            "first_result_s_mean": float(np.mean(ttfr)) if ttfr else 0.0,
        }
