"""Flight recorder: a bounded, always-available ring of recent spans;
the port of the reference's obs/flight.py.

Tracing (`obs.enable()`) answers "show me everything that happened while
I was watching"; the flight recorder answers the question an incident
actually poses — "what happened in the last N seconds, given that nobody
was watching". It keeps a FIXED-SIZE per-thread ring buffer of completed
span records, independent of ``trace.enable()`` and of span sampling:

- **Bounded memory.** Each thread owns one preallocated ring of
  ``per_thread`` slots; the oldest record is overwritten in place. No
  allocation grows with uptime.
- **Lock-free append.** The hot path touches only its own thread's ring
  (a thread-local lookup, a slot store, an index increment) — no lock,
  no cross-thread cache traffic. The creation of a thread's ring is the
  only synchronized step, paid once per thread.
- **Independent of tracing.** With tracing disabled, ``obs.span(...)``
  returns a recording flight span instead of the null singleton; with
  tracing enabled, every record the tracer keeps is forwarded here, and
  spans the SAMPLER would drop are still captured (the flight window has
  no sampling — its bound is time, not rate).
- **dump(window_s)** composes a Perfetto-valid Chrome trace of the last
  N seconds (same event shape as ``export.chrome_trace``); parent links
  that point outside the window are cleared so the dump always validates
  (``export.validate_chrome_trace``).

A flight span costs a thread-local lookup and a slot store; a span
recorded here never takes a lock.

``fence()`` on a flight span passes values through WITHOUT blocking —
the same contract as disabled tracing, so enabling the recorder never
changes hot-path synchronization behavior.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "FlightRecorder",
    "flight_clear",
    "flight_disable",
    "flight_dump",
    "flight_enable",
    "flight_enabled",
    "get_flight",
]

# Flight sids live far above any plausible tracer sid so the two
# namespaces never collide inside one dump (tracer sids are a per-process
# counter from 1; flight sids are per-ring blocks starting here).
_SID_BASE = 1 << 40
_RING_STRIDE = 1 << 28  # max records one ring can ever number


class _Ring:
    """One thread's record ring. Only its owner thread writes; dump()
    readers take a point-in-time copy of the slot list (safe under the
    GIL — a torn read can at worst observe one record twice or miss the
    very newest, never corrupt one)."""

    __slots__ = ("slots", "i", "cap", "sid_base", "seq", "stack", "tid", "name")

    def __init__(self, cap: int, ring_index: int, tid: int, name: str) -> None:
        self.cap = cap
        self.slots: List[Optional[Tuple]] = [None] * cap
        self.i = 0
        self.sid_base = _SID_BASE + ring_index * _RING_STRIDE
        self.seq = 0
        self.stack: List[int] = []  # open flight-span sids, innermost last
        self.tid = tid
        self.name = name


class _FlightSpan:
    """Recording span used when the tracer is off (or sampled this span
    out). Parent linkage is per-ring: the innermost open flight span on
    this thread is the parent. When standing in for a sampled-out tracer
    span, it also maintains the tracer's thread-local drop depth so
    children keep following their root's fate (`drop_tls`)."""

    __slots__ = ("fr", "ring", "name", "cat", "args", "sid", "parent", "t0", "drop_tls")

    def __init__(self, fr: "FlightRecorder", name: str, cat: str,
                 args: Optional[Dict[str, Any]], drop_tls=None) -> None:
        self.fr = fr
        self.name = name
        self.cat = cat
        self.args = args
        self.drop_tls = drop_tls
        self.ring = None
        self.sid = 0
        self.parent = 0
        self.t0 = 0.0

    # reprolint: hot-path — flight append must stay sync-free
    def __enter__(self) -> "_FlightSpan":
        ring = self.fr._ring()
        self.ring = ring
        ring.seq += 1
        self.sid = ring.sid_base + ring.seq
        self.parent = ring.stack[-1] if ring.stack else 0
        ring.stack.append(self.sid)
        tls = self.drop_tls
        if tls is not None:
            tls.drop_depth = getattr(tls, "drop_depth", 0) + 1
        self.t0 = time.perf_counter()
        return self

    # reprolint: hot-path — flight append must stay sync-free
    def __exit__(self, *exc: object) -> None:
        t1 = time.perf_counter()
        ring = self.ring
        if ring.stack and ring.stack[-1] == self.sid:
            ring.stack.pop()
        ring.slots[ring.i % ring.cap] = (
            self.name, self.cat, self.sid, self.parent, ring.tid,
            self.t0, t1 - self.t0, 0.0, self.args,
        )
        ring.i += 1
        tls = self.drop_tls
        if tls is not None:
            tls.drop_depth -= 1

    def fence(self, x: object) -> object:
        """Pass-through WITHOUT blocking (disabled-tracing contract): the
        recorder never adds a device sync to a hot path."""
        return x

    def set(self, **kw: object) -> None:
        if self.args is None:
            self.args = dict(kw)
        else:
            self.args.update(kw)


class FlightRecorder:
    def __init__(self, per_thread: int = 8192) -> None:
        self.enabled = False
        self.per_thread = per_thread
        self._tls = threading.local()
        self._rings: Dict[int, _Ring] = {}  # guarded-by: _rings_lock
        self._next_ring = 0  # guarded-by: _rings_lock
        self._rings_lock = threading.Lock()

    # ------------------------------------------------------------ hot path
    def _ring(self) -> _Ring:
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            ring = self._make_ring()
        return ring

    def _make_ring(self) -> _Ring:
        tid = threading.get_ident()
        with self._rings_lock:
            self._next_ring += 1
            ring = _Ring(
                self.per_thread, self._next_ring, tid,
                threading.current_thread().name,
            )
            # A reused OS thread id keeps its newest ring in the registry
            # (the old thread is gone; its open-span stack died with it).
            self._rings[tid] = ring
        self._tls.ring = ring
        return ring

    def span(self, name: str, cat: str = "",
             args: Optional[Dict[str, Any]] = None, drop_tls=None) -> _FlightSpan:
        return _FlightSpan(self, name, cat, args, drop_tls=drop_tls)

    # reprolint: hot-path — forwarded tracer records append sync-free too
    def record(self, name: str, cat: str, sid: int, parent: int, tid: int,
               t0: float, dur: float, fence_s: float,
               args: Optional[Dict[str, Any]]) -> None:
        """Append one completed record with caller-supplied identity —
        the tracer forwards every record it keeps through here, so the
        flight window stays continuous whether or not tracing is on."""
        ring = self._ring()
        ring.slots[ring.i % ring.cap] = (
            name, cat, sid, parent, tid, t0, dur, fence_s, args,
        )
        ring.i += 1

    # reprolint: hot-path
    def record_complete(self, name: str, cat: str, tid: int, t0: float,
                        dur: float, args: Optional[Dict[str, Any]]) -> None:
        """Retroactive parentless record with a fresh flight sid (the
        lock-hold add_complete path)."""
        ring = self._ring()
        ring.seq += 1
        ring.slots[ring.i % ring.cap] = (
            name, cat, ring.sid_base + ring.seq, 0, tid, t0, dur, 0.0, args,
        )
        ring.i += 1

    # ------------------------------------------------------------- control
    def enable(self, per_thread: Optional[int] = None) -> None:
        if per_thread is not None and per_thread != self.per_thread:
            self.per_thread = int(per_thread)
            self.clear()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._rings_lock:
            self._rings.clear()
        # Live threads drop their ring lazily: _ring() re-registers a
        # fresh one on next append (self._tls is per-thread, so clear()
        # can only reset its OWN thread's cached ring eagerly).
        self._tls.ring = None

    # --------------------------------------------------------------- dump
    def records(self, window_s: Optional[float] = None) -> List[Dict[str, Any]]:
        """Snapshot of retained records (all threads), oldest first,
        optionally filtered to spans that END within the last window_s
        seconds."""
        cut = None if window_s is None else time.perf_counter() - window_s
        out: List[Dict[str, Any]] = []
        with self._rings_lock:
            rings = list(self._rings.values())
        for ring in rings:
            slots = list(ring.slots)  # point-in-time copy
            i, cap = ring.i, ring.cap
            order = range(i - cap, i) if i > cap else range(i)
            for j in order:
                rec = slots[j % cap]
                if rec is None:
                    continue
                name, cat, sid, parent, tid, t0, dur, fence_s, args = rec
                if cut is not None and (t0 + dur) < cut:
                    continue
                out.append(
                    {
                        "name": name, "cat": cat, "sid": sid,
                        "parent": parent, "tid": tid, "t0": t0,
                        "dur": dur, "fence_s": fence_s,
                        "args": {} if args is None else dict(args),
                    }
                )
        out.sort(key=lambda r: r["t0"])
        return out

    def dump(self, window_s: float = 30.0) -> Dict[str, Any]:
        """Chrome trace doc of the last ``window_s`` seconds across every
        thread — the incident artifact. Parent sids that fell out of the
        window are cleared (oldest-evicted rings and the window cut can
        both orphan a child), so the result always passes
        ``export.validate_chrome_trace``."""
        recs = self.records(window_s=window_s)
        with self._rings_lock:
            threads = {r.tid: r.name for r in self._rings.values()}
        events: List[Dict[str, Any]] = []
        for tid, name in sorted(threads.items()):
            events.append(
                {"ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                 "args": {"name": name}}
            )
        kept = {r["sid"] for r in recs}
        base = min((r["t0"] for r in recs), default=0.0)
        for r in recs:
            args = dict(r["args"])
            args["sid"] = r["sid"]
            if r["parent"] and r["parent"] in kept:
                args["parent"] = r["parent"]
            if r["fence_s"]:
                args["device_fence_us"] = round(r["fence_s"] * 1e6, 3)
            events.append(
                {
                    "ph": "X",
                    "name": r["name"],
                    "cat": r["cat"] or "span",
                    "pid": 1,
                    "tid": r["tid"],
                    "ts": round((r["t0"] - base) * 1e6, 3),
                    "dur": round(r["dur"] * 1e6, 3),
                    "args": args,
                }
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}


_flight = FlightRecorder()


def get_flight() -> FlightRecorder:
    return _flight


def flight_enable(per_thread: Optional[int] = None) -> None:
    """Turn the flight recorder on (independent of trace.enable())."""
    _flight.enable(per_thread=per_thread)


def flight_disable() -> None:
    _flight.disable()


def flight_enabled() -> bool:
    return _flight.enabled


def flight_clear() -> None:
    _flight.clear()


def flight_dump(window_s: float = 30.0) -> Dict[str, Any]:
    """Chrome trace of the last ``window_s`` seconds (see
    :meth:`FlightRecorder.dump`)."""
    return _flight.dump(window_s)
