"""The port's own spans in a traced window: the records of
``repro_torch.obs``'s tracer, what the idle gaps are labelled by when the
program's spans are at hand, and the window of records the program-span
metrics (``bench/metrics/append_plan_share.py`` and its kin) read.

``ProgramWindow`` is ``tracing.DeviceWindow`` with the program's tracer
cleared and on from the window's start to its stop. Its trace carries
``program``, the records that overlap the window (each with ``start``
and ``end`` on the ``perf_counter`` clock, ``Tracer.records_between``),
and ``program_dropped``, the records the tracer's full deque pushed out.
Its idle gaps go to the distinct names of the innermost program span open
on each thread at a gap's middle (``lock/*`` holds left out: they repeat
their holder's spans), and to the benchmark's own spans where no thread
has a program span open. ``bench/run.py`` uses the plain window, so the
tracer stays off in the benchmark's runs; ``scripts/trace_layers.py`` runs
a cell with this one.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from . import tracing

Span = Tuple[str, int, float, float]  # name, thread, start, end


def _innermost(program: List[dict]) -> List[Span]:
    """Each thread's time cut where its innermost open program span
    changes: pieces (name, thread, start, end) that never overlap on one
    thread."""
    by_tid: Dict[int, List[dict]] = {}
    for r in program:
        if not r["name"].startswith("lock/"):
            by_tid.setdefault(r["tid"], []).append(r)
    out: List[Span] = []
    for tid, recs in by_tid.items():
        edges = sorted([(r["start"], 1, i) for i, r in enumerate(recs)]
                       + [(r["end"], 0, i) for i, r in enumerate(recs)])
        open_: List[int] = []
        t = None
        for x, kind, i in edges:
            if open_ and t is not None and x > t:
                inner = max(open_, key=lambda j: recs[j]["start"])
                name = recs[inner]["name"]
                if out and out[-1][0] == name and out[-1][1] == tid and out[-1][3] == t:
                    out[-1] = (name, tid, out[-1][2], x)
                else:
                    out.append((name, tid, t, x))
            if kind:
                open_.append(i)
            else:
                open_.remove(i)
            t = x
    return out


def _outside(spans: List[Span], covered: List[Tuple[float, float]]) -> List[Span]:
    """The parts of ``spans`` outside the sorted, disjoint ``covered``."""
    starts = [a for a, _ in covered]
    out: List[Span] = []
    for name, tid, s, e in spans:
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while s < e:
            if i >= len(covered) or covered[i][0] >= e:
                out.append((name, tid, s, e))
                break
            a, b = covered[i]
            if a > s:
                out.append((name, tid, s, a))
            s = max(s, b)
            i += 1
    return out


def gap_spans(bench: List[Span], program: List[dict]) -> List[Span]:
    """Spans for ``tracing.label_gaps`` that label a gap by the innermost
    program span open on each thread at its middle and, where no thread
    has one open, by the benchmark's spans open there."""
    inner = _innermost(program)
    return inner + _outside(bench, tracing._union([(s, e) for _, _, s, e in inner]))


class ProgramWindow(tracing.DeviceWindow):
    """The profiler's window, with the program's tracer on over it."""

    def start(self) -> None:
        super().start()
        if self.on:
            from repro_torch import obs

            obs.clear()
            obs.enable()

    def stop(self, t0: float, t1: float, spans: tracing.Spans) -> Optional[tracing.DeviceTrace]:
        if not self.on:
            return super().stop(t0, t1, spans)
        from repro_torch import obs

        obs.disable()
        tracer = obs.get_tracer()
        program = tracer.records_between(t0, t1)
        labelled = tracing.Spans(True)  # what stop() labels the gaps by
        labelled.records = gap_spans(spans.records, program)
        trace = super().stop(t0, t1, labelled)
        if trace is not None:
            trace.program = program
            trace.program_dropped = tracer.dropped
        return trace


def records(run) -> Optional[List[dict]]:
    """The program's records that end in the run's window; None when the
    trace holds none (a window that left the program's tracer off) or the
    tracer dropped any."""
    trace = run.trace
    program = getattr(trace, "program", None)
    if not program or getattr(trace, "program_dropped", 0):
        return None
    t0, t1 = run.window.t0, run.window.t1
    return [r for r in program if t0 <= r["end"] <= t1]


def append_share(run, phase: str) -> Optional[float]:
    """Of the seconds of the ``ingest.append`` spans that end in the
    window, the share their ``phase`` (``plan_s`` or ``enqueue_s``)
    takes; None without such spans."""
    app = [r for r in records(run) or () if r["name"] == "ingest.append" and phase in r["args"]]
    if not app:
        return None
    return sum(r["args"][phase] for r in app) / sum(r["dur"] for r in app)
