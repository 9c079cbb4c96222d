"""Adaptive query batching — paper §III-A, Algorithms 1 and 2; a copy of
the reference's core/batching.py cut to what the query paths call.

After each batch the observed (runtime T_i, result count r_i) adapt the
next one:

    k_{i+1} <- c * k_i
    That_{i+1} <- k_{i+1} * (T_i / r_i)
    if That > T_max:  k_{i+1} <- T_max * (r_i / T_i)
    elif That < T_min: k_{i+1} <- T_min * (r_i / T_i)
    b_{i+1} <- min(k_{i+1} * (b_i / r_i), t_stop - p_i)
    p_{i+1} <- p_i + b_i + eps

On r_i == 0 k is kept and b grows geometrically by c.

A batch reads the whole seconds [int(p_i), int(p_i + b_i)]. A range that
ends less than eps short of t_stop is the last one (p_{i+1} passes
t_stop), so it ends at t_stop: the reference's ends at p_i + b_i there,
and its batches leave out the rows at t_stop.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Tuple

DEFAULT_K0 = 10.0
DEFAULT_C = 1.5
DEFAULT_T_MAX = 30.0
DEFAULT_T_MIN = 1.0
DEFAULT_EPS = 1


def alg1_next_k(
    k: float, runtime: float, rows: int, c: float, t_max: float, t_min: float
) -> float:
    """The Alg-1 UPDATE law for the desired result count. rows == 0 keeps
    k (the rate is unobservable)."""
    t_i = max(float(runtime), 1e-9)
    if rows <= 0:
        return float(k)
    k_next = c * k
    t_hat = k_next * (t_i / rows)
    if t_hat > t_max:
        k_next = t_max * (rows / t_i)
    elif t_hat < t_min:
        k_next = t_min * (rows / t_i)
    return float(k_next)


@dataclass
class BatchRecord:
    index: int
    p: float
    b: float
    k: float
    runtime: float = 0.0
    rows: int = 0


@dataclass
class AdaptiveBatcher:
    """Algorithm 1 state machine. One instance per executing query."""

    t_start: float
    t_stop: float
    b0: float
    k0: float = DEFAULT_K0
    c: float = DEFAULT_C
    t_max: float = DEFAULT_T_MAX
    t_min: float = DEFAULT_T_MIN
    eps: float = DEFAULT_EPS
    history: List[BatchRecord] = field(default_factory=list)

    def __post_init__(self):
        if self.t_stop < self.t_start:
            raise ValueError("t_stop < t_start")
        self._p = float(self.t_start)
        self._k = float(self.k0)
        self._b = max(min(float(self.b0), self.t_stop - self._p), self.eps)
        self._i = 0

    @property
    def done(self) -> bool:
        return self._p > self.t_stop if self._i > 0 else False

    def next_range(self) -> Tuple[float, float]:
        """Time range [p_i, p_i + b_i] for the next batch (inclusive),
        to t_stop for the last."""
        hi = self._p + self._b
        return self._p, self.t_stop if hi + self.eps > self.t_stop else hi

    def update(self, runtime: float, rows: int) -> None:
        """Alg 1 UPDATE(T_i, r_i)."""
        rec = BatchRecord(self._i, self._p, self._b, self._k, runtime, rows)
        self.history.append(rec)
        if rows > 0:
            k_next = alg1_next_k(self._k, runtime, rows, self.c, self.t_max, self.t_min)
            b_next = k_next * (self._b / rows)
        else:
            k_next = self._k
            b_next = self._b * self.c
        b_next = min(b_next, self.t_stop - self._p)
        self._p = self._p + self._b + self.eps
        self._b = max(b_next, self.eps)
        self._k = max(k_next, 1.0)
        self._i += 1


def run_batched_query(
    t_start: float,
    t_stop: float,
    b0: float,
    query: Callable[[float, float], Tuple[float, int]],
    **kw,
) -> AdaptiveBatcher:
    """Algorithm 2: run ``query(p, p + b)`` over adapting batches until the
    position passes t_stop. ``query`` returns (runtime_seconds, n_rows)."""
    batcher = AdaptiveBatcher(t_start=t_start, t_stop=t_stop, b0=b0, **kw)
    while not batcher.done:
        lo, hi = batcher.next_range()
        runtime, rows = query(lo, hi)
        batcher.update(runtime, rows)
    return batcher


def iter_batches(
    t_start: float, t_stop: float, b0: float, **kw
) -> Iterator[Tuple[Tuple[float, float], Callable[[float, int], None]]]:
    """Generator form of Algorithm 2: yields ((lo, hi), report) pairs; the
    caller calls report(runtime, rows) before advancing."""
    batcher = AdaptiveBatcher(t_start=t_start, t_stop=t_stop, b0=b0, **kw)
    while not batcher.done:
        rng = batcher.next_range()
        reported = {}

        def report(runtime: float, rows: int, _r=reported):
            _r["x"] = (runtime, rows)

        yield rng, report
        if "x" not in reported:
            raise RuntimeError("iter_batches: caller did not report batch stats")
        batcher.update(*reported["x"])


class HitRateTracker:
    """Per-table historical hit rate r/b that seeds b_0 (paper: 'b_0
    pre-computed for the particular Accumulo table being queried based on
    the typical hit-rates of previous queries on that table'). Thread-safe:
    concurrent observe() calls must not tear the EWMA update."""

    def __init__(self, default_rate: float = 1.0, alpha: float = 0.2):
        self._rate = default_rate  # rows per time unit
        self._alpha = alpha
        self._lock = threading.Lock()

    def observe(self, rows: int, b: float) -> None:
        if b > 0:
            with self._lock:
                self._rate = (1 - self._alpha) * self._rate + self._alpha * (rows / b)

    def initial_b(self, k0: float = DEFAULT_K0) -> float:
        return max(k0 / max(self._rate, 1e-9), 1.0)
