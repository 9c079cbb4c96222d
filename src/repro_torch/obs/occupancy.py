"""Device-lock occupancy attribution; the port of the reference's
obs/occupancy.py.

The serialization points that govern TTFR in this system are two plain
``threading.Lock`` objects: the `DistIngestPlane` plane lock and the
`QueryService` device lock. :class:`OwnedLock` is a drop-in wrapper that
tags every hold with an *owner class* (``session_turn``,
``fold_increment``, ``publish_seal``, ``ingest_append``,
``density_read``, ...) and accounts the held wall time per owner, so an
occupancy report answers exactly the paper's attribution question: of
the time the device was serialized, which stage owned it?

Accounting invariant: a hold is partitioned into contiguous segments,
one per owner (``reowner`` splits a hold mid-way, e.g. a serve turn that
discovers it must first build the run does its planning/density reads
under ``density_read`` and only then re-owns as ``session_turn``).
Per-owner seconds therefore sum to ``total_held`` *exactly*; only an
independent wall-clock re-measurement needs a tolerance, never the
books.

Besides HELD time, every lock also books ACQUIRE-WAIT time: the wall
seconds a would-be holder spent inside ``acquire`` before getting the
lock, per owner class (``total_wait_s`` / ``wait_by_owner_s`` in the
snapshot). Held time answers "who serialized the device"; wait time
answers "who was serialized BEHIND whom" — the sharded ingest plane's
contention (each group lock's held and wait seconds) reads exactly this:
writers on different tablet groups show about zero wait on each other's
group locks.

API mirrors ``threading.Lock`` (acquire/release/context manager);
unattributed holds are charged to ``unknown``, which the tests check is
absent on the instrumented paths.
"""

from __future__ import annotations

import threading
import time
import weakref
from contextlib import contextmanager
from typing import Dict, List, Optional

from . import trace as _trace

__all__ = ["OwnedLock", "all_locks", "occupancy_snapshot"]

_LOCKS: "weakref.WeakSet[OwnedLock]" = weakref.WeakSet()
_LOCKS_LOCK = threading.Lock()


class OwnedLock:
    """A ``threading.Lock`` with per-owner held-time attribution."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        # _slock guards the books (owner tallies + current-hold state);
        # it is only ever held for a few arithmetic ops.
        self._slock = threading.Lock()
        self.total_held = 0.0
        self.total_wait = 0.0
        self.acquisitions = 0
        self.by_owner: Dict[str, float] = {}
        self.acq_by_owner: Dict[str, int] = {}
        self.wait_by_owner: Dict[str, float] = {}
        self._hold_t0: Optional[float] = None
        self._seg_t0: Optional[float] = None
        self._owner: Optional[str] = None
        self._owner_tid: int = 0
        with _LOCKS_LOCK:
            _LOCKS.add(self)

    # -- core protocol ---------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1, owner: str = "unknown") -> bool:
        t_wait = time.perf_counter()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            now = time.perf_counter()
            with self._slock:
                waited = now - t_wait
                self.total_wait += waited
                self.wait_by_owner[owner] = self.wait_by_owner.get(owner, 0.0) + waited
                self.acquisitions += 1
                self._hold_t0 = now
                self._seg_t0 = now
                self._owner = owner
                self._owner_tid = threading.get_ident()
        return ok

    def release(self) -> None:
        now = time.perf_counter()
        with self._slock:
            self._charge_segment(now)
            if self._hold_t0 is not None:
                self.total_held += now - self._hold_t0
            t0, tid, owner = self._hold_t0, self._owner_tid, self._owner
            self._hold_t0 = None
            self._seg_t0 = None
            self._owner = None
        self._lock.release()
        if t0 is not None and _trace._tracer.enabled:
            _trace._tracer.add_complete(
                f"lock/{self.name}", t0, now - t0, cat="lock", tid=tid, owner=owner or "unknown"
            )

    def _charge_segment(self, now: float) -> None:
        # caller holds _slock
        if self._seg_t0 is None or self._owner is None:
            return
        dt = now - self._seg_t0
        self.by_owner[self._owner] = self.by_owner.get(self._owner, 0.0) + dt
        self.acq_by_owner[self._owner] = self.acq_by_owner.get(self._owner, 0) + 1
        self._seg_t0 = now

    def __enter__(self) -> "OwnedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()

    # -- attribution verbs ----------------------------------------------
    @contextmanager
    def hold(self, owner: str):
        """``with lock.hold("ingest_append"):`` — acquire with an owner."""
        self.acquire(owner=owner)
        try:
            yield self
        finally:
            self.release()

    @contextmanager
    def reowner(self, owner: str):
        """Re-attribute the *current* hold to ``owner`` for the duration
        of the block, then restore the previous owner. Must be called by
        the holding thread."""
        now = time.perf_counter()
        with self._slock:
            prev = self._owner
            self._charge_segment(now)
            self._owner = owner
        try:
            yield self
        finally:
            now = time.perf_counter()
            with self._slock:
                self._charge_segment(now)
                self._owner = prev

    # -- reporting -------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        now = time.perf_counter()
        with self._slock:
            by_owner = dict(self.by_owner)
            total = self.total_held
            # A snapshot taken mid-hold still balances: fold the open
            # segment into both sides.
            if self._hold_t0 is not None:
                total += now - self._hold_t0
                if self._owner is not None and self._seg_t0 is not None:
                    by_owner[self._owner] = by_owner.get(self._owner, 0.0) + (now - self._seg_t0)
            return {
                "name": self.name,
                "total_held_s": total,
                "total_wait_s": self.total_wait,
                "acquisitions": self.acquisitions,
                "by_owner_s": by_owner,
                "acq_by_owner": dict(self.acq_by_owner),
                "wait_by_owner_s": dict(self.wait_by_owner),
            }

    def reset(self) -> None:
        with self._slock:
            self.total_held = 0.0
            self.total_wait = 0.0
            self.acquisitions = 0
            self.by_owner.clear()
            self.acq_by_owner.clear()
            self.wait_by_owner.clear()


def all_locks() -> List[OwnedLock]:
    with _LOCKS_LOCK:
        locks = list(_LOCKS)
    return sorted(locks, key=lambda l: l.name)


def occupancy_snapshot() -> Dict[str, Dict[str, object]]:
    """Per-lock occupancy, aggregated by lock name (two planes created
    with the same name merge their books in the report)."""
    out: Dict[str, Dict[str, object]] = {}
    for lk in all_locks():
        snap = lk.snapshot()
        cur = out.get(lk.name)
        if cur is None:
            out[lk.name] = snap
        else:
            cur["total_held_s"] = float(cur["total_held_s"]) + float(snap["total_held_s"])
            cur["total_wait_s"] = float(cur["total_wait_s"]) + float(snap["total_wait_s"])
            cur["acquisitions"] = int(cur["acquisitions"]) + int(snap["acquisitions"])
            for k, v in snap["by_owner_s"].items():  # type: ignore[union-attr]
                cur["by_owner_s"][k] = cur["by_owner_s"].get(k, 0.0) + v  # type: ignore[index]
            for k, v in snap["acq_by_owner"].items():  # type: ignore[union-attr]
                cur["acq_by_owner"][k] = cur["acq_by_owner"].get(k, 0) + v  # type: ignore[index]
            for k, v in snap["wait_by_owner_s"].items():  # type: ignore[union-attr]
                cur["wait_by_owner_s"][k] = cur["wait_by_owner_s"].get(k, 0.0) + v  # type: ignore[index]
    return out
