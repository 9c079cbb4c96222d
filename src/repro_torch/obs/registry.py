"""Typed metrics registry: counters, gauges, fixed-bucket histograms;
the port of the reference's obs/registry.py.

Every metric carries an optional label set (keyword arguments at
observation time). Internally each metric keeps one cell per distinct
label tuple, so ``counter.inc(rows, writer="3")`` and
``counter.inc(rows, writer="7")`` accumulate independently while
``counter.total()`` sums across all cells.

Design constraints:

- Thread-safe: every mutation takes the metric's lock. Cells are plain
  floats/ints, so a hold is a few hundred nanoseconds.
- Near-zero cost when disabled: each metric checks its registry's
  ``enabled`` flag before doing anything else; a disabled ``inc`` is an
  attribute load and a branch.
- Registries are cheap and independent: a `DistIngestPlane` owns a
  private registry so two planes in one process never share cells, while
  process-wide metrics (writer flush counters, serve-turn histograms)
  live on the default registry from :func:`get_registry`.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "all_registries",
    "get_registry",
]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    """Shared plumbing for all metric kinds."""

    kind = "metric"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str = "") -> None:
        self.registry = registry
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.registry.enabled


class Counter(_Metric):
    """Monotonic (by convention) float accumulator per label set."""

    kind = "counter"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str = "") -> None:
        super().__init__(registry, name, help)
        self._cells: Dict[LabelKey, float] = {}

    def inc(self, v: float = 1.0, **labels: object) -> None:
        if not self.registry.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0.0) + v

    def set_value(self, v: float, **labels: object) -> None:
        """Overwrite a cell (the compactor's counter views assign through
        it); new code should prefer inc/reset."""
        key = _label_key(labels)
        with self._lock:
            self._cells[key] = float(v)

    def value(self, **labels: object) -> float:
        key = _label_key(labels)
        with self._lock:
            return self._cells.get(key, 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._cells.values())

    def cells(self) -> Dict[LabelKey, float]:
        with self._lock:
            return dict(self._cells)

    def reset(self, **labels: object) -> None:
        with self._lock:
            if labels:
                self._cells.pop(_label_key(labels), None)
            else:
                self._cells.clear()


class Gauge(Counter):
    """A counter whose value may move in both directions; ``set`` is the
    primary verb."""

    kind = "gauge"

    def set(self, v: float, **labels: object) -> None:
        if not self.registry.enabled:
            return
        self.set_value(v, **labels)

    def max(self, v: float, **labels: object) -> None:
        """Keep the running maximum (compactor's max_increment_s)."""
        if not self.registry.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            cur = self._cells.get(key)
            if cur is None or v > cur:
                self._cells[key] = float(v)


class Histogram(_Metric):
    """Fixed-bucket histogram; per label set it keeps bucket counts plus
    sum/count/min/max so means and extrema survive bucketing."""

    kind = "histogram"

    DEFAULT_EDGES = (
        0.0001,
        0.00025,
        0.0005,
        0.001,
        0.0025,
        0.005,
        0.01,
        0.025,
        0.05,
        0.1,
        0.25,
        0.5,
        1.0,
        2.5,
        5.0,
        10.0,
    )

    def __init__(
        self,
        registry: "MetricsRegistry",
        name: str,
        help: str = "",
        edges: Optional[Sequence[float]] = None,
    ) -> None:
        super().__init__(registry, name, help)
        e = tuple(float(x) for x in (edges if edges is not None else self.DEFAULT_EDGES))
        if list(e) != sorted(e):
            raise ValueError(f"histogram edges must be sorted: {e}")
        self.edges = e
        # cell: [bucket_counts(len(edges)+1), sum, count, min, max,
        #        exemplar (trace_id, value) | None]
        self._cells: Dict[LabelKey, List] = {}

    def _bucket_index(self, v: float) -> int:
        # First bucket whose upper edge is >= v; values above the last
        # edge land in the overflow bucket. Half-open on the left:
        # bucket i covers (edges[i-1], edges[i]].
        lo, hi = 0, len(self.edges)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.edges[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def observe(
        self, v: float, exemplar: Optional[str] = None, **labels: object
    ) -> None:
        """Record one value. ``exemplar`` attaches a trace id to the cell
        (kept policy: the exemplar of the WORST observation so far — the
        one an SLO investigation wants to pull from the flight recorder);
        it rides along in snapshot()/metrics_snapshot, not in the
        Prometheus 0.0.4 text (which has no exemplar syntax)."""
        if not self.registry.enabled:
            return
        v = float(v)
        key = _label_key(labels)
        idx = self._bucket_index(v)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                # cell: [buckets, sum, count, min, max, exemplar]
                cell = [[0] * (len(self.edges) + 1), 0.0, 0, v, v, None]
                self._cells[key] = cell
            cell[0][idx] += 1
            cell[1] += v
            cell[2] += 1
            if v < cell[3]:
                cell[3] = v
            if v > cell[4]:
                cell[4] = v
            if exemplar is not None and (cell[5] is None or v >= cell[5][1]):
                cell[5] = (str(exemplar), v)

    def snapshot(self, **labels: object) -> Optional[Dict[str, object]]:
        key = _label_key(labels)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                return None
            out = {
                "buckets": list(cell[0]),
                "sum": cell[1],
                "count": cell[2],
                "min": cell[3],
                "max": cell[4],
            }
            if cell[5] is not None:
                out["exemplar"] = {"trace_id": cell[5][0], "value": cell[5][1]}
            return out

    def count(self, **labels: object) -> int:
        snap = self.snapshot(**labels)
        return 0 if snap is None else int(snap["count"])

    def sum(self, **labels: object) -> float:
        snap = self.snapshot(**labels)
        return 0.0 if snap is None else float(snap["sum"])

    def max_value(self, **labels: object) -> float:
        snap = self.snapshot(**labels)
        return 0.0 if snap is None else float(snap["max"])

    def cells(self) -> Dict[LabelKey, Dict[str, object]]:
        with self._lock:
            keys = list(self._cells.keys())
        out = {}
        for key in keys:
            labels = dict(key)
            snap = self.snapshot(**labels)
            if snap is not None:
                out[key] = snap
        return out

    def reset(self, **labels: object) -> None:
        with self._lock:
            if labels:
                self._cells.pop(_label_key(labels), None)
            else:
                self._cells.clear()


_ALL: "weakref.WeakSet[MetricsRegistry]" = weakref.WeakSet()
_ALL_LOCK = threading.Lock()


class MetricsRegistry:
    """A named bag of metrics. Creating a metric twice with the same
    name returns the existing instance; asking for it as another kind
    raises TypeError."""

    def __init__(self, name: str = "default", enabled: bool = True) -> None:
        self.name = name
        self.enabled = enabled
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()
        with _ALL_LOCK:
            _ALL.add(self)

    def _get_or_make(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                # The exact kind: a Gauge is a Counter subclass, and asking
                # for a gauge's name as a counter must raise too.
                if type(m) is not cls:
                    raise TypeError(
                        f"metric {name!r} already registered as {m.kind}, wanted {cls.kind}"
                    )
                return m
            m = cls(self, name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(Counter, name, help)  # type: ignore[return-value]

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(Gauge, name, help)  # type: ignore[return-value]

    def histogram(
        self, name: str, help: str = "", edges: Optional[Sequence[float]] = None
    ) -> Histogram:
        return self._get_or_make(Histogram, name, help, edges=edges)  # type: ignore[return-value]

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def reset(self) -> None:
        for m in self.metrics():
            m.reset()  # type: ignore[attr-defined]

    def snapshot(self) -> Dict[str, object]:
        """Plain-data dump of every metric in this registry."""
        out: Dict[str, object] = {}
        for m in self.metrics():
            if isinstance(m, Histogram):
                cells = {
                    ",".join(f"{k}={v}" for k, v in key) or "__all__": snap
                    for key, snap in m.cells().items()
                }
                out[m.name] = {"kind": m.kind, "edges": list(m.edges), "cells": cells}
            else:
                cells = {
                    ",".join(f"{k}={v}" for k, v in key) or "__all__": val
                    for key, val in m.cells().items()  # type: ignore[attr-defined]
                }
                out[m.name] = {"kind": m.kind, "cells": cells}
        return out


_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry("default")
        return _default


def all_registries() -> List[MetricsRegistry]:
    with _ALL_LOCK:
        regs = list(_ALL)
    return sorted(regs, key=lambda r: r.name)
