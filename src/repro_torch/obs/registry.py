"""Typed metrics: counters with label sets; the part of the
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


class MetricsRegistry:
    """A named bag of counters. Asking twice for one name returns the same
    counter."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._metrics: Dict[str, Counter] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help: str = "") -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Counter(name, help)
            return m
