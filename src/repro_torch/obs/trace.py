"""Span tracing with device fencing; the part of the reference's
obs/trace.py the port reads.

    with span("query.scan_range", cat="query") as sp:
        count = int(sp.fence(total))   # waits for the card; charged as fence_s

Tracing is off by default; a disabled span is a shared no-op whose
``fence`` passes values through. An enabled span's ``fence`` calls
``torch.cuda.synchronize`` for CUDA tensors (a tuple or list is fenced
element by element) and passes anything else through; it never swallows
an error. Records (name, cat, t0, dur, fence_s, args) accumulate in a
bounded deque that chip_smoke.py summarises.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict

import torch


def _fence(x: object) -> None:
    if isinstance(x, (tuple, list)):
        for v in x:
            _fence(v)
    elif isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class _NullSpan:
    """Returned while tracing is disabled; every verb is a no-op."""

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


class _Span:
    __slots__ = ("tracer", "name", "cat", "args", "t0", "fence_s")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Dict[str, Any]) -> None:
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0
        self.fence_s = 0.0

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> None:
        self.tracer.add_complete(self.name, self.t0, time.perf_counter() - self.t0,
                                 cat=self.cat, fence_s=self.fence_s, **self.args)

    def fence(self, x: object) -> object:
        """Wait until the card has produced ``x``; the wait is charged to
        this span as fence_s."""
        t0 = time.perf_counter()
        _fence(x)
        self.fence_s += time.perf_counter() - t0
        return x

    def set(self, **kw: object) -> None:
        self.args.update(kw)


class Tracer:
    def __init__(self, maxlen: int = 65536) -> None:
        self.enabled = False
        self.records: Deque[Dict[str, Any]] = deque(maxlen=maxlen)
        self.epoch = time.perf_counter()
        self._lock = threading.Lock()

    def span(self, name: str, cat: str = "", **args: object):
        if not self.enabled:
            return _NULL
        return _Span(self, name, cat, dict(args))

    def add_complete(self, name: str, t0: float, dur: float, cat: str = "",
                     fence_s: float = 0.0, **args: object) -> None:
        """Record a span from its start and duration (spans on exit, and
        lock holds timed by OwnedLock)."""
        if not self.enabled:
            return
        rec = {"name": name, "cat": cat, "t0": t0 - self.epoch, "dur": dur,
               "fence_s": fence_s, "args": args}
        with self._lock:
            self.records.append(rec)

    def clear(self) -> None:
        with self._lock:
            self.records.clear()
            self.epoch = time.perf_counter()


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def span(name: str, cat: str = "", **args: object):
    """Open a span on the global tracer (a no-op while disabled)."""
    return _tracer.span(name, cat, **args)


def enable() -> None:
    _tracer.enabled = True


def disable() -> None:
    _tracer.enabled = False


def clear() -> None:
    _tracer.clear()
