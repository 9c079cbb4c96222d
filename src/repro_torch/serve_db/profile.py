"""Query latency anatomy: where one query's time-to-first-result went;
the port of the reference's serve_db/profile.py.

The paper evaluates serving as "latency of the client receiving initial
result sets" — one number. A regression in that number is useless for
diagnosis until it is decomposed along the serve path, so every
:class:`~repro_torch.serve_db.session.StreamingQuery` carries a
:class:`QueryProfile` whose stages tile the TTFR interval end to end:

    submit ──admission──▶ turn start ──plan──▶ (density fence inside)
           ──device_step──▶ batch arrays on host ──epilogue──▶
           ──deliver──▶ first ResultBatch stamped

- **admission** — submit() to the first turn starting on the dispatcher
  (scheduler queue wait + device-lock acquire; ``admission_queue_s``
  sub-splits the scheduler-queue part using the pop timestamp).
- **plan** — lazy run construction under the device lock (snapshot sync,
  plan_query, the filter program's preparation), MINUS the density reads.
- **density_fence** — the planner's aggregate-tablet density reads (the
  fenced device wait the paper's follower queries pay).
- **device_step** — the device-program section of executed batches
  (dispatch + materialization inside scan_range/scan_index_range).
- **epilogue** — host remainder of a step: top-k merges, valid-row
  filtering, batcher/stats bookkeeping.
- **deliver** — handing the batch to the session stream up to the
  instant ``first_result_at`` is stamped.

First-result stages (``*_first``) sum to the measured TTFR up to float
rounding: each stage opens at the clock read that closed the one before
it, so the bookkeeping between them, and any GIL switch or collector
pause there, falls inside a stage rather than into a gap. chip_smoke.py's
path 5 asserts the sum lands within 5%; the totals keep accumulating
over the query's remaining batches.

Aggregation: committed profiles observe into two default-registry
histograms, ``query_profile_seconds{stage=,scheme=}`` and
``query_profile_ttfr_seconds{scheme=}``, each carrying a **trace-id
exemplar** (``q<qid>``, the id also stamped on the query's serve-plane
spans) for the worst observation — so a p99 blip in the histogram points
straight at a pullable trace in the flight recorder.

Threading: a profile is written only by the service dispatcher (one
thread steps any given query) and read by clients after delivery — the
result queue's put/get pair is the happens-before edge, same as every
other StreamingQuery field. The module-level TTFR event buffer feeding
the SLO watchdog is the one shared structure, locked inside
:class:`_TTFREvents`.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..obs import get_registry

__all__ = ["QueryProfile", "STAGES", "note_ttfr", "ttfr_event_probe"]

STAGES = ("admission", "plan", "density_fence", "device_step", "epilogue", "deliver")


class QueryProfile:
    """Per-query stage clock (see module docstring). ``*_acc_s`` fields
    are accumulators the execution layer (core/dist_query) adds into
    while a step or plan is running on the dispatcher thread; the
    service snapshots their deltas around each stage boundary."""

    __slots__ = (
        "qid", "scheme", "trace_id",
        "admission_s", "admission_queue_s", "plan_s", "density_fence_s",
        "device_step_s", "epilogue_s", "deliver_s",
        "ttfr_s",
        "density_acc_s", "device_acc_s",
        "steps_total", "device_total_s", "epilogue_total_s",
        "deliver_total_s", "committed",
    )

    def __init__(self, qid: int, scheme: str) -> None:
        self.qid = qid
        self.scheme = scheme
        self.trace_id = f"q{qid}"
        # First-result stages (tile the TTFR interval).
        self.admission_s = 0.0
        self.admission_queue_s = 0.0  # scheduler-queue part of admission
        self.plan_s = 0.0
        self.density_fence_s = 0.0
        self.device_step_s = 0.0
        self.epilogue_s = 0.0
        self.deliver_s = 0.0
        self.ttfr_s: Optional[float] = None
        # Execution-layer accumulators (device sections add in here).
        self.density_acc_s = 0.0
        self.device_acc_s = 0.0
        # Whole-query totals (keep growing after the first result).
        self.steps_total = 0
        self.device_total_s = 0.0
        self.epilogue_total_s = 0.0
        self.deliver_total_s = 0.0
        self.committed = False

    # ------------------------------------------------- dispatcher-side
    def note_step(self, device_s: float, epilogue_s: float, first: bool) -> None:
        self.steps_total += 1
        self.device_total_s += device_s
        self.epilogue_total_s += epilogue_s
        if first:
            self.device_step_s = device_s
            self.epilogue_s = epilogue_s

    def note_deliver(self, deliver_s: float, first: bool) -> None:
        self.deliver_total_s += deliver_s
        if first:
            self.deliver_s = deliver_s

    def commit(self, ttfr_s: float, registry=None) -> None:
        """Publish this profile once its first result is out: stage
        histograms + the TTFR histogram (worst-observation trace-id
        exemplars) on the default registry, and the TTFR event buffer the
        watchdog's sliding p99 reads."""
        if self.committed:
            return
        self.committed = True
        self.ttfr_s = ttfr_s
        reg = registry if registry is not None else get_registry()
        h = reg.histogram(
            "query_profile_seconds",
            "TTFR anatomy per stage (first-result stages tile the TTFR)",
        )
        for stage, v in self.stages().items():
            h.observe(v, exemplar=self.trace_id, stage=stage, scheme=self.scheme)
        reg.histogram(
            "query_profile_ttfr_seconds", "measured end-to-end TTFR"
        ).observe(ttfr_s, exemplar=self.trace_id, scheme=self.scheme)
        note_ttfr(ttfr_s)

    # ------------------------------------------------------ client-side
    def stages(self) -> Dict[str, float]:
        """The six first-result stages, in timeline order."""
        return {
            "admission": self.admission_s,
            "plan": self.plan_s,
            "density_fence": self.density_fence_s,
            "device_step": self.device_step_s,
            "epilogue": self.epilogue_s,
            "deliver": self.deliver_s,
        }

    def breakdown_sum_s(self) -> float:
        """Sum of the first-result stages — within 5% of the measured
        TTFR (chip_smoke.py's path 5 asserts this at 4 sessions)."""
        return float(sum(self.stages().values()))

    def as_dict(self) -> Dict[str, float]:
        out = {f"{k}_s": v for k, v in self.stages().items()}
        out.update(
            admission_queue_s=self.admission_queue_s,
            ttfr_s=self.ttfr_s if self.ttfr_s is not None else float("nan"),
            steps_total=float(self.steps_total),
            device_total_s=self.device_total_s,
            epilogue_total_s=self.epilogue_total_s,
            deliver_total_s=self.deliver_total_s,
        )
        return out


class _TTFREvents:
    """Bounded ring of committed (t, ttfr_s) observations — the event
    source behind the watchdog's sliding-window TTFR p99 rule."""

    def __init__(self, maxlen: int = 4096) -> None:
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=maxlen)  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock

    def note(self, ttfr_s: float) -> None:
        with self._lock:
            self._seq += 1
            self._events.append((self._seq, time.perf_counter(), float(ttfr_s)))

    def since(self, seq: int) -> Tuple[int, List[Tuple[float, float]]]:
        """Events newer than ``seq`` as (t, value) pairs, plus the new
        high-water mark."""
        with self._lock:
            fresh = [(t, v) for s, t, v in self._events if s > seq]
            return self._seq, fresh


_ttfr_events = _TTFREvents()


def note_ttfr(ttfr_s: float) -> None:
    _ttfr_events.note(ttfr_s)


def ttfr_event_probe() -> Callable[[], List[Tuple[float, float]]]:
    """An event probe for ``obs.WatchRule(agg="p99")``: each call drains
    the TTFR observations committed since the previous call."""
    state = {"seq": 0}

    def probe() -> List[Tuple[float, float]]:
        state["seq"], fresh = _ttfr_events.since(state["seq"])
        return fresh

    return probe
