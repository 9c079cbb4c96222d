"""Background compaction, off the query path; the port of the
reference's serve_db/compactor.py.

Major compaction is the only point where LSM runs fold into the base
(publish() is a pure snapshot), and besides ingest-tripped thresholds
nothing else schedules it. The `BackgroundCompactor` drives
`DistIngestPlane.compact_step()` increments from a maintenance
thread, under two hard rules:

  1. NEVER while a session batch is in flight or runnable work is queued
     — it takes the service device lock non-blocking and re-checks the
     scheduler under it, so a query always wins the race;
  2. only when the plane actually has unfolded state
     (`plane.has_unfolded()` — exact from the host fill mirrors, free).

Folds are attributed in `plane.telemetry()["fold_events"]["background"]`;
the query path never appears in fold_events at all (reads cannot fold by
construction). Queries stay exact either way — the fold only moves rows
between levels, and an in-flight session's pinned snapshot is untouched
by a concurrent fold, because compaction never writes a published
buffer in place.

A major compaction costs SECONDS of device time at scale, so fold TIMING
is everything. Two-mode hysteresis decides WHEN folding starts:

  urgent   run-slot debt (`plane.fold_debt()`) reached `min_debt`: fold
           at the next momentary idle gap, before ingest exhausts the
           slots and trips a BLOCKING major in some writer's flush (and
           stalls publishes behind the plane lock);
  drain    any unfolded state at all, but only after the serve plane has
           been continuously idle for `idle_grace_s` — a live feed
           constantly re-dirties the memtable, and folding every tiny
           delta would park multi-second majors in front of the very
           next query.

Once folding starts, it proceeds incrementally: instead of one
non-preemptible `compact()` that holds the device for the whole k-way
fold, the compactor interleaves `plane.compact_step()` increments — one
bounded 2-way merge (top run slot -> base, all families in lockstep) per
device-lock hold — and re-checks the scheduler after EVERY increment. A
query submitted mid-major preempts at the next increment boundary and
reads the (fully consistent) partially-folded LSM, so the worst stall
any session's first result can park behind is ONE increment, not one
major. `increments` / `max_increment_s` instrument exactly that bound.

SHARDED PLANES (n_groups > 1). The compactor is oblivious to sharding by
design: `plane.fold_debt()` reports the WORST group's run-slot debt (the
one closest to tripping a blocking major in some writer), and every
`plane.compact_step()` ranks groups by (debt, has_unfolded) and folds one
increment in the most-indebted group under THAT group's lock only — so a
background fold in group 2 never stalls writers appending to groups 0, 1
or 3, and the one-increment stall bound the starvation guard asserts is
now also a one-GROUP stall.

MESH PLANES with a control log (core/spmd.py): the compactor runs on rank
0 only, and its idle and debt decisions (`has_unfolded`, `fold_debt`)
stay there; the group that takes each increment logs it under its lock,
and every follower applies the same increment on its own tablets.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

from ..obs import get_registry

_compactor_seq = itertools.count()


class BackgroundCompactor:
    """Maintenance thread: fold the plane's unfolded runs whenever the
    serve plane is idle (see module docstring for the urgent/drain
    hysteresis and the preemptible incremental fold). `folds` counts
    completed drains that actually folded something; `increments`
    counts the bounded compact_step calls they decomposed into and
    `max_increment_s` the longest single device-lock hold (the stall
    bound)."""

    def __init__(
        self,
        plane,
        service,
        interval: float = 0.02,
        min_debt: int = 2,
        idle_grace_s: float = 0.25,
    ):
        self.plane = plane
        self.service = service
        self.interval = float(interval)
        self.min_debt = int(min_debt)
        self.idle_grace_s = float(idle_grace_s)
        # Counters live on the default metrics registry (labelled per
        # compactor instance); the attributes below are property views
        # of them, readable and assignable.
        self._label = f"c{next(_compactor_seq)}"
        reg = get_registry()
        self._m_counts = reg.counter(
            "compactor_events_total",
            "background-compactor events by kind "
            "(folds/passes/increments/preempted/skipped_busy)",
        )
        self._m_max_inc = reg.gauge(
            "compactor_max_increment_seconds", "longest single compact_step device hold"
        )
        self._draining = False  # an incremental drain is mid-flight
        self._last_busy = time.perf_counter()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------- metric views
    def _count(self, kind: str) -> int:
        return int(self._m_counts.value(kind=kind, compactor=self._label))

    def _set_count(self, kind: str, v: int) -> None:
        self._m_counts.set_value(v, kind=kind, compactor=self._label)

    folds = property(lambda s: s._count("folds"), lambda s, v: s._set_count("folds", v))
    passes = property(lambda s: s._count("passes"), lambda s, v: s._set_count("passes", v))
    increments = property(
        lambda s: s._count("increments"), lambda s, v: s._set_count("increments", v)
    )
    preempted = property(
        lambda s: s._count("preempted"), lambda s, v: s._set_count("preempted", v)
    )
    skipped_busy = property(
        lambda s: s._count("skipped_busy"), lambda s, v: s._set_count("skipped_busy", v)
    )

    @property
    def max_increment_s(self) -> float:
        return self._m_max_inc.value(compactor=self._label)

    @max_increment_s.setter
    def max_increment_s(self, v: float) -> None:
        self._m_max_inc.set_value(v, compactor=self._label)

    def start(self) -> "BackgroundCompactor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="serve-db-compactor", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------ internals
    def _idle_fold(self) -> None:
        """One tick: fold iff the serve plane is quiescent RIGHT NOW and
        the urgent/drain hysteresis says the fold is worth its stall."""
        svc = self.service
        if svc.busy():
            self._last_busy = time.perf_counter()
        if not self.plane.has_unfolded():
            return
        urgent = self.plane.fold_debt() >= self.min_debt
        idle_for = time.perf_counter() - self._last_busy
        if not urgent and idle_for < self.idle_grace_s:
            return
        self._incremental_drain(svc)

    def _incremental_drain(self, svc) -> None:
        """Interleave bounded compact_step increments with session turns:
        the device lock is held for ONE increment at a time, and the
        scheduler is re-checked before every increment, so a query
        submitted mid-major preempts at the next increment boundary. The
        drain resumes on later ticks — any prefix of increments leaves a
        consistent LSM, an interrupted major is just lower fold debt.
        On a sharded plane each compact_step targets the currently
        most-indebted tablet group (re-ranked every increment), holding
        only that group's lock on the plane side."""
        progressed = False
        while not self._stop.is_set():
            if svc.busy():
                if progressed:
                    self.preempted += 1  # a query cut this drain short
                else:
                    self.skipped_busy += 1
                return
            # Non-blocking: if a session batch grabbed the device between
            # the busy() check and here, the query wins.
            if not svc._device_lock.acquire(blocking=False, owner="fold_increment"):
                self.skipped_busy += 1
                return
            try:
                if svc.busy():  # re-check under the lock (submit raced us)
                    self.skipped_busy += 1
                    return
                t0 = time.perf_counter()
                ran = self.plane.compact_step(source="background")
                dt = time.perf_counter() - t0
            finally:
                svc._device_lock.release()
            if not ran:
                break  # drained (or raced another folder): complete below
            progressed = True
            self._draining = True
            self.increments += 1
            self.passes += 1
            self.max_increment_s = max(self.max_increment_s, dt)
            if not self.plane.has_unfolded():
                break  # this increment finished the drain
        if self._draining and not self.plane.has_unfolded():
            self._draining = False
            self.folds += 1  # one completed (possibly multi-tick) drain

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self._idle_fold()
