"""Typed metrics: counters and gauges with label sets; the part of the
reference's obs/registry.py the ingest plane uses. Each metric keeps one
cell per distinct label tuple; a plane owns a private registry, so two
planes in one process never share cells."""
from __future__ import annotations

import threading
from typing import Dict, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Float accumulator per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._cells: Dict[LabelKey, float] = {}

    def inc(self, v: float = 1.0, **labels: object) -> None:
        key = _label_key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0.0) + v

    def value(self, **labels: object) -> float:
        with self._lock:
            return self._cells.get(_label_key(labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._cells.values())

    def cells(self) -> Dict[LabelKey, float]:
        with self._lock:
            return dict(self._cells)

    def reset(self, **labels: object) -> None:
        """Drop one cell, or every cell when no labels are given."""
        with self._lock:
            if labels:
                self._cells.pop(_label_key(labels), None)
            else:
                self._cells.clear()


class Gauge(Counter):
    """A value per label set that may move both ways; ``set`` is the
    primary verb."""

    kind = "gauge"

    def set(self, v: float, **labels: object) -> None:
        key = _label_key(labels)
        with self._lock:
            self._cells[key] = float(v)

    def max(self, v: float, **labels: object) -> None:
        """Keep the running maximum."""
        key = _label_key(labels)
        with self._lock:
            cur = self._cells.get(key)
            if cur is None or v > cur:
                self._cells[key] = float(v)


class MetricsRegistry:
    """A named bag of counters and gauges. Asking twice for one name
    returns the same metric; asking for it as the other kind raises."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._metrics: Dict[str, Counter] = {}
        self._lock = threading.Lock()

    def _get_or_make(self, cls, name: str, help: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help)
            elif type(m) is not cls:
                raise TypeError(f"metric {name!r} already registered as {m.kind}, "
                                f"wanted {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(Gauge, name, help)
