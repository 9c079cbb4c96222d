"""Lock occupancy attribution; the part of the reference's
obs/occupancy.py the ingest plane uses.

:class:`OwnedLock` tags every hold with an owner class (``ingest_append``,
``fold_increment``, ``publish_seal``, ...) and books held seconds and
acquire-wait seconds per owner. ``reowner`` splits a hold: a writer's
append that trips a blocking major books that stretch as fold work.
Per-owner held seconds sum to the total held time exactly.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

from . import trace as _trace


class OwnedLock:
    """A ``threading.Lock`` with per-owner held- and wait-time books."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._slock = threading.Lock()  # guards the books below
        self.total_held = 0.0
        self.total_wait = 0.0
        self.acquisitions = 0
        self.by_owner: Dict[str, float] = {}
        self.wait_by_owner: Dict[str, float] = {}
        self._hold_t0: Optional[float] = None
        self._seg_t0: Optional[float] = None
        self._owner: Optional[str] = None

    def _acquire(self, owner: str) -> None:
        t_wait = time.perf_counter()
        self._lock.acquire()
        now = time.perf_counter()
        with self._slock:
            waited = now - t_wait
            self.total_wait += waited
            self.wait_by_owner[owner] = self.wait_by_owner.get(owner, 0.0) + waited
            self.acquisitions += 1
            self._hold_t0 = now
            self._seg_t0 = now
            self._owner = owner

    def _release(self) -> None:
        now = time.perf_counter()
        with self._slock:
            self._charge_segment(now)
            t0, owner = self._hold_t0, self._owner
            self.total_held += now - t0
            self._hold_t0 = self._seg_t0 = self._owner = None
        self._lock.release()
        _trace.get_tracer().add_complete(f"lock/{self.name}", t0, now - t0, cat="lock",
                                         owner=owner)

    def _charge_segment(self, now: float) -> None:  # caller holds _slock
        if self._seg_t0 is None or self._owner is None:
            return
        self.by_owner[self._owner] = self.by_owner.get(self._owner, 0.0) + now - self._seg_t0
        self._seg_t0 = now

    @contextmanager
    def hold(self, owner: str):
        """``with lock.hold("ingest_append"):`` — acquire with an owner."""
        self._acquire(owner)
        try:
            yield self
        finally:
            self._release()

    @contextmanager
    def reowner(self, owner: str):
        """Re-attribute the current hold to ``owner`` for the block, then
        restore the previous owner. Called by the holding thread."""
        with self._slock:
            prev = self._owner
            self._charge_segment(time.perf_counter())
            self._owner = owner
        try:
            yield self
        finally:
            with self._slock:
                self._charge_segment(time.perf_counter())
                self._owner = prev

    def snapshot(self) -> Dict[str, object]:
        """The books, with an open hold folded in."""
        now = time.perf_counter()
        with self._slock:
            by_owner = dict(self.by_owner)
            total = self.total_held
            if self._hold_t0 is not None:
                total += now - self._hold_t0
                if self._owner is not None and self._seg_t0 is not None:
                    by_owner[self._owner] = by_owner.get(self._owner, 0.0) + now - self._seg_t0
            return {
                "name": self.name,
                "total_held_s": total,
                "total_wait_s": self.total_wait,
                "acquisitions": self.acquisitions,
                "by_owner_s": by_owner,
                "wait_by_owner_s": dict(self.wait_by_owner),
            }
