"""Fair per-batch interleaving of many sessions' queries on one device;
the port of the reference's serve_db/scheduler.py.

The unit of scheduling is ONE adaptive batch (core/dist_query.QueryRun /
core/query.HostQueryRun step): the paper's Alg-2 already decomposes a
query into latency-bounded batches, so fairness costs nothing extra —
the scheduler just decides WHOSE batch runs next under the device lock.

Two policies compose:

  pick      time-to-first-result first: a query that has not delivered
            its first batch preempts every continuing stream (the paper's
            responsiveness metric is time to the INITIAL result set);
            within each class, FIFO round-robin across sessions.
  quantum   how many consecutive batches one turn may run before the
            device goes back to the queue — governed by the shared Alg-1
            law (core/batching.py::alg1_next_k): turns that run hot
            shrink toward one batch (interactive fairness), fast turns
            grow geometrically (amortize dispatch overhead when queues
            are short), the law core/batching.py applies to range
            batches.

The scheduler is pure bookkeeping — it owns no threads and runs no device
programs; the QueryService dispatcher drains it. Its waits measure QUERY
contention only: ingest appends never enter this queue (writers hold
per-tablet-group plane locks, not the device lock), so on a sharded
plane `max_first_turn_wait` keeps bounding first-result stalls by one
compaction increment regardless of how many writers are live.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from ..core.batching import alg1_next_k
from ..obs import get_registry
from .session import QuerySession, StreamingQuery


@dataclass
class TurnQuantum:
    """Alg-1 turn sizing: k = batches per turn, adapted so one turn's
    wall time stays inside [t_min, t_max] seconds."""

    k0: float = 1.0
    c: float = 1.5
    t_min: float = 0.02
    t_max: float = 0.25
    max_batches: int = 8

    def __post_init__(self):
        self._k = float(self.k0)

    @property
    def k(self) -> float:
        return self._k

    def budget(self) -> int:
        return max(1, min(int(round(self._k)), self.max_batches))

    def update(self, runtime: float, batches: int) -> None:
        k_next = alg1_next_k(self._k, runtime, batches, self.c, self.t_max, self.t_min)
        self._k = float(min(max(k_next, 1.0), self.max_batches))


@dataclass
class QueryEntry:
    """One submitted query's place in the scheduler. `run` (a QueryRun or
    HostQueryRun) is built lazily by the dispatcher under the device lock
    — planning reads densities off the card, which is device work, and it
    counts toward the session's time-to-first-result like any other
    serving cost. ready_at: when this entry last became runnable (queue
    wait accrues from here to batch execution)."""

    session: QuerySession
    stream: StreamingQuery
    stats: object = None
    run: object = None
    ready_at: float = 0.0
    popped_at: float = 0.0  # when pop_turn released it (profile: splits
    # admission into scheduler-queue wait vs device-lock acquire)
    seq: int = 0
    kw: dict = field(default_factory=dict)


class FairScheduler:
    """Thread-safe runnable queue with TTFR priority (see module
    docstring). has_pending()/ttfr_waiting() are the coordination points
    for the background compactor and the turn preemption check."""

    def __init__(self, quantum: Optional[TurnQuantum] = None):
        self.quantum = quantum or TurnQuantum()
        self._fresh: deque = deque()  # guarded-by: _cv — no first batch yet
        self._cont: deque = deque()  # guarded-by: _cv — continuing, round-robin
        self._closed = False  # guarded-by: _cv
        self._cv = threading.Condition()
        # Per-turn instrumentation ring (starvation guard): the service
        # logs every served turn here — `first` marks a session's
        # first-result turn, whose `wait_s` is the stall the incremental
        # compactor must bound (no first result may park behind more
        # than ~one compaction increment). Bounded so a long-lived
        # service never grows it without limit.
        self.turn_log: deque = deque(maxlen=4096)  # guarded-by: _cv
        # Registry mirror of the turn log: the ring keeps its exact
        # per-turn records (the starvation guard reads waits from it),
        # while the histograms feed
        # repro_torch.obs.metrics_snapshot() with the turn/wait
        # distributions across the whole process lifetime.
        reg = get_registry()
        self._m_turns = reg.counter("serve_turns_total", "served turns, by first/continuing")
        self._m_turn_s = reg.histogram("serve_turn_seconds", "wall time of one served turn")
        self._m_wait_s = reg.histogram(
            "serve_first_wait_seconds", "queue wait of first-result turns"
        )

    # ------------------------------------------------------- enqueue side
    def submit(self, entry: QueryEntry) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("QueryService closed")
            self._fresh.append(entry)
            self._cv.notify()

    def requeue(self, entry: QueryEntry) -> None:
        """Put a not-yet-done query back after its turn (it has delivered
        at least one batch by then, so it continues in the fair ring)."""
        with self._cv:
            if self._closed:
                raise RuntimeError("QueryService closed")
            self._cont.append(entry)
            self._cv.notify()

    def close(self) -> list:
        """Reject all future submits (a client racing service shutdown
        gets a RuntimeError instead of a stream that never terminates)
        and hand back everything still queued so the service can error
        the streams out."""
        with self._cv:
            self._closed = True
            out = list(self._fresh) + list(self._cont)
            self._fresh.clear()
            self._cont.clear()
            return out

    # ------------------------------------------------------ dispatcher side
    def pop_turn(
        self, timeout: Optional[float] = None, on_pop=None
    ) -> Optional[QueryEntry]:
        """Next query to serve, or None on timeout. Fresh queries (no
        first result yet) always preempt continuing streams. `on_pop`
        runs under the condition variable BEFORE the entry leaves the
        queue — the service marks itself in-flight there, so the
        compactor can never observe a popped-but-unstarted turn as
        idle."""
        with self._cv:
            if not self._fresh and not self._cont:
                self._cv.wait(timeout=timeout)
            entry = None
            if self._fresh:
                entry = self._fresh.popleft()
            elif self._cont:
                entry = self._cont.popleft()
            if entry is not None:
                entry.popped_at = time.perf_counter()
                if on_pop is not None:
                    on_pop()
            return entry

    def log_turn(
        self, session_id: int, seq: int, wait_s: float, batches: int, turn_s: float
    ) -> None:
        """Record one served turn (called by the service after every
        turn, including zero-batch empty-plan turns). seq is the entry's
        sequence number WHEN THE TURN STARTED: 0 marks a first-result
        turn, the one the starvation guard bounds."""
        with self._cv:
            self.turn_log.append(
                {
                    "session": int(session_id),
                    "first": seq == 0,
                    "wait_s": float(wait_s),
                    "batches": int(batches),
                    "turn_s": float(turn_s),
                    "t": time.perf_counter(),
                }
            )
        self._m_turns.inc(first=seq == 0)
        self._m_turn_s.observe(turn_s)
        if seq == 0:
            self._m_wait_s.observe(wait_s)

    def max_first_turn_wait(self) -> float:
        """Worst queue wait of any first-result turn in the log — the
        starvation-guard statistic (the tests assert
        it stays under the compaction increment bound)."""
        with self._cv:
            waits = [t["wait_s"] for t in self.turn_log if t["first"]]
            return max(waits) if waits else 0.0

    def has_pending(self) -> bool:
        with self._cv:
            return bool(self._fresh or self._cont)

    def ttfr_waiting(self) -> bool:
        """True when some query is still waiting for its FIRST batch —
        the dispatcher cuts the current turn short then (preemption at
        batch granularity keeps worst-case TTFR ~ one batch per waiting
        session, which is what bounds the no-starvation criterion)."""
        with self._cv:
            return bool(self._fresh)
