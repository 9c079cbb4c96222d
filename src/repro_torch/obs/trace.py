"""Span tracing with parent linkage and device-time fencing; the port of
the reference's obs/trace.py.

Spans are cheap context managers::

    with span("query.step", cat="query", session=sid) as sp:
        out = step_fn(...)
        count = int(sp.fence(out))   # waits for the card; charged as fence_s
        sp.set(rows=count)           # attach results post-hoc

Tracing is OFF by default. When disabled, :func:`span` returns a shared
singleton whose ``__enter__``/``__exit__``/``fence``/``set`` are no-ops —
one global load, one attribute check and a function call.

Parent linkage is thread-local: the innermost open span on the current
thread is the parent of the next one opened. Records accumulate in a
bounded deque and export to Chrome trace-event JSON via
repro_torch.obs.export.chrome_trace (loadable in Perfetto).

FENCE: an enabled span's ``fence(x)`` waits for the CUDA tensors in ``x``
(a tuple, list or dict is fenced element by element; anything else
passes through) by recording a CUDA event on each one's device's current
stream and waiting on that event. The event follows the tensor's producer
on the stream, so the wait covers the span's own work and whatever was
queued before it, never work that other threads queue later. The wait is
charged to the span as ``fence_s``, and each call counts in ``fence_n``
(the span's read-backs: a fence belongs right before a host read of
``x``, which waits for the card with tracing off too). An error from the
card propagates.

RECORDS: each kept span becomes a dict whose ``t0`` is seconds after the
tracer's ``epoch`` (a ``time.perf_counter`` reading, reset by
``clear()``); :meth:`Tracer.records_between` hands them out on the
absolute ``perf_counter`` clock. A full deque pushes out its oldest
record for each new one, and ``Tracer.dropped`` counts those since the
last ``clear()``.

SAMPLING: ``enable(sample=1/N)`` keeps every Nth ROOT span (per-process
deterministic counter) and drops the rest; children always follow their
root's fate, so sampled traces contain only complete trees — never a
child whose parent is missing. Sampled-out spans cost one thread-local
read and return a no-op singleton whose ``fence`` passes values through
WITHOUT blocking (same contract as disabled tracing).

FLIGHT: while the flight recorder (obs/flight.py) is on, a disabled
tracer hands out recording flight spans instead of the null singleton,
sampled-out spans are recorded there too, and every record the tracer
keeps is forwarded to it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import torch

from .flight import get_flight

__all__ = [
    "Tracer",
    "clear",
    "disable",
    "enable",
    "enabled",
    "get_tracer",
    "span",
]


def _cuda_devices(x: object, out: Dict[torch.device, None]) -> None:
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            out[x.device] = None
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)


def _fence(x: object) -> None:
    """Wait until the card has run everything queued on the current
    stream up to now, for each device a CUDA tensor of ``x`` lives on."""
    devices: Dict[torch.device, None] = {}
    _cuda_devices(x, devices)
    for dev in devices:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        done.synchronize()


class _NullSpan:
    """Singleton returned while tracing is disabled; every verb no-ops."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        return None

    def fence(self, x: object) -> object:
        return x

    def set(self, **kw: object) -> None:
        return None


_NULL = _NullSpan()


class _DropSpan:
    """Returned for sampled-out spans. Tracks a thread-local drop depth so
    every span opened UNDER a dropped root is dropped too (a sampled
    trace never contains an orphaned child). fence() passes through
    without blocking, like the disabled-tracing singleton."""

    __slots__ = ("tracer",)

    def __init__(self, tracer: "Tracer") -> None:
        self.tracer = tracer

    def __enter__(self) -> "_DropSpan":
        tls = self.tracer._tls
        tls.drop_depth = getattr(tls, "drop_depth", 0) + 1
        return self

    def __exit__(self, *exc: object) -> None:
        self.tracer._tls.drop_depth -= 1

    def fence(self, x: object) -> object:
        return x

    def set(self, **kw: object) -> None:
        return None


class _Span:
    __slots__ = ("tracer", "name", "cat", "args", "sid", "parent", "tid", "t0", "fence_s",
                 "fence_n")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Dict[str, Any]) -> None:
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.sid = 0
        self.parent = 0
        self.tid = 0
        self.t0 = 0.0
        self.fence_s = 0.0
        self.fence_n = 0

    def __enter__(self) -> "_Span":
        tr = self.tracer
        self.sid = tr._next_sid()
        stack = tr._stack()
        self.parent = stack[-1].sid if stack else 0
        self.tid = threading.get_ident()
        tr._note_thread(self.tid)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> None:
        t1 = time.perf_counter()
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self.tracer._record(self, t1 - self.t0)

    def fence(self, x: object) -> object:
        """Wait until the card has produced ``x`` (see the module
        docstring); the wait is charged to this span as device time and
        the call counted as one read-back. Returns ``x`` unchanged."""
        t0 = time.perf_counter()
        _fence(x)
        self.fence_s += time.perf_counter() - t0
        self.fence_n += 1
        return x

    def set(self, **kw: object) -> None:
        self.args.update(kw)


class Tracer:
    def __init__(self, maxlen: int = 65536) -> None:
        self.enabled = False
        self.sample_n = 1  # keep every Nth root span (1 = keep all)
        self.records: Deque[Dict[str, Any]] = deque(maxlen=maxlen)
        self.dropped = 0  # records the full deque pushed out since clear()
        self.epoch = time.perf_counter()
        self._sid = 0
        self._root_count = 0
        self._sid_lock = threading.Lock()
        self._tls = threading.local()
        self._threads: Dict[int, str] = {}
        self._threads_lock = threading.Lock()
        self._drop = _DropSpan(self)
        self._flight = get_flight()

    # -- internals -------------------------------------------------------
    def _next_sid(self) -> int:
        with self._sid_lock:
            self._sid += 1
            return self._sid

    def set_sample(self, sample: Optional[float]) -> None:
        """sample = fraction of root spans to keep (1/N); None or >= 1
        keeps everything. Resets the root counter, so every enable()
        starts a fresh deterministic period (the first root is always
        kept)."""
        with self._sid_lock:
            self._root_count = 0
        if sample is None or sample >= 1:
            self.sample_n = 1
        elif sample <= 0:
            raise ValueError(f"sample must be in (0, 1]: {sample}")
        else:
            self.sample_n = max(1, int(round(1.0 / sample)))

    def _sample_root(self) -> bool:
        with self._sid_lock:
            self._root_count += 1
            return self._root_count % self.sample_n == 1

    def _stack(self) -> List[_Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def _append(self, rec: Dict[str, Any]) -> None:
        with self._sid_lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(rec)

    def _note_thread(self, tid: int) -> None:
        if tid not in self._threads:
            with self._threads_lock:
                self._threads[tid] = threading.current_thread().name

    def _record(self, sp: _Span, dur: float) -> None:
        rec = {
            "name": sp.name,
            "cat": sp.cat,
            "sid": sp.sid,
            "parent": sp.parent,
            "tid": sp.tid,
            "t0": sp.t0 - self.epoch,
            "dur": dur,
            "args": sp.args,
        }
        if sp.fence_n:
            rec["fence_s"] = sp.fence_s
            rec["fence_n"] = sp.fence_n
        self._append(rec)
        # Forward every kept record to the flight recorder (its window
        # stays continuous whether tracing is on or off); flight-native
        # sids start far above the tracer counter, so linkage inside a
        # dump never collides.
        fr = self._flight
        if fr.enabled:
            fr.record(
                sp.name, sp.cat, sp.sid, sp.parent, sp.tid,
                sp.t0, dur, sp.fence_s, sp.args,
            )

    # -- public ----------------------------------------------------------
    def span(self, name: str, cat: str = "", **args: object):
        if not self.enabled:
            return _NULL
        if self.sample_n > 1:
            if getattr(self._tls, "drop_depth", 0) > 0:
                return self._dropped(name, cat, args)  # child of dropped root
            if not self._stack() and not self._sample_root():
                return self._dropped(name, cat, args)  # root not sampled
        return _Span(self, name, cat, dict(args))

    def _dropped(self, name: str, cat: str, args: Dict[str, Any]):
        """A span the sampler rejects: the cheap drop singleton, or, when
        the flight recorder is on, a flight span (the flight window is
        bounded by time, not rate). The flight span keeps the tracer's
        drop depth like the singleton, so children still follow their
        root's fate in the sampled trace."""
        fr = self._flight
        if fr.enabled:
            return fr.span(name, cat, dict(args) if args else None, drop_tls=self._tls)
        return self._drop

    def add_complete(
        self,
        name: str,
        t0: float,
        dur: float,
        cat: str = "",
        tid: Optional[int] = None,
        **args: object,
    ) -> None:
        """Record a span retroactively from (start, duration) timestamps
        measured elsewhere — lock-hold segments, which OwnedLock times
        whether or not tracing was on when they began. The flight
        recorder receives these too (when enabled)."""
        fr = self._flight
        if fr.enabled:
            fr.record_complete(
                name, cat, tid if tid is not None else threading.get_ident(),
                t0, dur, dict(args),
            )
        if not self.enabled:
            return
        if tid is None:
            tid = threading.get_ident()
        self._note_thread(tid)
        self._append(
            {
                "name": name,
                "cat": cat,
                "sid": self._next_sid(),
                "parent": 0,
                "tid": tid,
                "t0": t0 - self.epoch,
                "dur": dur,
                "args": dict(args),
            }
        )

    def clear(self) -> None:
        with self._sid_lock:
            self.records.clear()
            self.dropped = 0
        self.epoch = time.perf_counter()

    def records_between(self, t0: float, t1: float) -> List[Dict[str, Any]]:
        """Copies of the records that overlap [t0, t1] (``perf_counter``
        readings), each with its ``start`` and ``end`` on that clock."""
        with self._sid_lock:
            recs = list(self.records)
        out = []
        for r in recs:
            start = self.epoch + r["t0"]
            end = start + r["dur"]
            if end >= t0 and start <= t1:
                out.append(dict(r, start=start, end=end))
        return out

    def thread_names(self) -> Dict[int, str]:
        with self._threads_lock:
            return dict(self._threads)


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def span(name: str, cat: str = "", **args: object):
    """Open a span on the global tracer (no-op singleton when disabled;
    drop singleton when sampled out). With the flight recorder on, a
    disabled tracer yields a recording flight span instead of the null
    singleton."""
    if not _tracer.enabled:
        fr = _tracer._flight
        if fr.enabled:
            return fr.span(name, cat, dict(args) if args else None)
        return _NULL
    return _tracer.span(name, cat, **args)


def enable(sample: Optional[float] = None) -> None:
    """Turn tracing on. ``sample=1/N`` keeps every Nth root span (children
    follow their root); omitted or >= 1 keeps everything."""
    _tracer.set_sample(sample)
    _tracer.enabled = True


def disable() -> None:
    _tracer.enabled = False
    _tracer.set_sample(None)


def enabled() -> bool:
    return _tracer.enabled


def clear() -> None:
    _tracer.clear()
