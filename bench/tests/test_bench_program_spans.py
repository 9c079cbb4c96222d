"""The program's spans in a traced window (bench/program_spans.py): idle
gaps labelled by the innermost program span open on each thread, and the
program-span metrics read from synthetic records; on the card, both cells
traced with the program's tracer on."""
import json
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from bench import clients, harness, program_spans, tracing
from bench.tests.conftest import ROOT


def rec(name, tid, start, end, **extra):
    args = extra.pop("args", {})
    return dict(name=name, tid=tid, start=start, end=end, dur=end - start, args=args, **extra)


def labels(bench, program, gaps):
    return tracing.label_gaps(program_spans.gap_spans(bench, program), gaps)


def test_innermost_program_span_on_each_thread_labels_a_gap():
    program = [
        rec("serve.turn", 1, 0.0, 10.0),
        rec("query.step", 1, 1.0, 5.0),
        rec("query.scan_range", 1, 2.0, 3.0),
        rec("lock/plane_lock_g0", 1, 0.0, 10.0),  # a hold: its holder's spans say more
        rec("ingest.append", 2, 2.5, 2.9),
        rec("lock/device_lock", 3, 6.0, 7.0),  # only a hold open: no program span
    ]
    bench = [("session.drain", 7, 0.0, 12.0)]
    got = labels(bench, program, [(1.2, 1.4), (2.6, 2.8), (5.5, 5.9), (6.2, 6.4), (11.0, 11.5)])
    assert got == pytest.approx({
        "ingest.append+query.scan_range": 0.2,  # two threads: both innermost names
        "query.step": 0.2,
        "serve.turn": 0.4 + 0.2,  # the hold on thread 3 adds nothing
        "session.drain": 0.5,  # no program span open: the benchmark's span
    })


def test_gap_with_nothing_open_keeps_the_benchmarks_label():
    got = labels([("writer.ingest", 1, 0.0, 1.0)], [rec("ingest.route", 2, 0.2, 0.4)],
                 [(0.5, 0.7), (2.0, 2.5)])
    assert got == pytest.approx({"writer.ingest": 0.2, "no bench span open": 0.5})


def test_benchmark_span_is_cut_where_a_program_span_is_open():
    # One benchmark span across two program spans: only its parts outside
    # them label gaps.
    pieces = program_spans.gap_spans([("writer.ingest", 1, 0.0, 10.0)],
                                     [rec("ingest.append", 1, 2.0, 4.0),
                                      rec("ingest.minor", 1, 3.0, 3.5),
                                      rec("ingest.route", 2, 6.0, 7.0)])
    assert sorted(pieces) == sorted([
        ("ingest.append", 1, 2.0, 3.0), ("ingest.minor", 1, 3.0, 3.5),
        ("ingest.append", 1, 3.5, 4.0), ("ingest.route", 2, 6.0, 7.0),
        ("writer.ingest", 1, 0.0, 2.0), ("writer.ingest", 1, 4.0, 6.0),
        ("writer.ingest", 1, 7.0, 10.0)])


def run_of(program, dropped=0, drained=None):
    trace = tracing.DeviceTrace(window_s=10.0, busy_s=1.0)
    if program is not None:
        trace.program, trace.program_dropped = program, dropped
    run = types.SimpleNamespace(window=clients.Window(100.0, 110.0), trace=trace)
    if drained is not None:
        run.drained = lambda: drained
    return run


INGEST = [
    rec("ingest.route", 1, 100.0, 100.5),
    rec("ingest.append", 1, 101.0, 103.0, args={"plan_s": 0.5, "enqueue_s": 1.0, "chunks": 64}),
    rec("ingest.append", 2, 104.0, 106.0, args={"plan_s": 0.3, "enqueue_s": 0.2, "chunks": 64}),
    # ends after the window: left out
    rec("ingest.append", 1, 109.5, 110.5, args={"plan_s": 1.0, "enqueue_s": 0.0, "chunks": 1}),
]
SERVE = [
    rec("query.step", 1, 101.0, 102.0),
    rec("query.scan_range", 1, 101.0, 101.4, fence_s=0.2, fence_n=3),
    rec("query.scan_index_range", 1, 101.5, 101.9, fence_s=0.1, fence_n=3),
    rec("query.step", 1, 103.0, 104.0),
    rec("query.scan_range", 1, 103.0, 103.5, fence_s=0.3, fence_n=3),
    rec("query.density", 1, 100.5, 100.6, fence_s=0.05, fence_n=1),
    rec("serve.turn", 1, 100.2, 104.1),
]


@pytest.mark.parametrize("name, program, drained, want", [
    ("append_plan_share", INGEST, None, 0.8 / 4.0),
    ("append_enqueue_share", INGEST, None, 1.2 / 4.0),
    ("step_wait_share", SERVE, None, 0.6 / 2.0),
    ("readbacks_per_query", SERVE, 5, 10 / 5),
])
def test_program_metric_reads_the_window_and_nothing_else(name, program, drained, want):
    read = harness.metric_reader(name)
    assert read(run_of(program, drained=drained)) == pytest.approx(want)
    assert read(run_of(None, drained=drained)) is None  # the tracer was off
    assert read(run_of([], drained=drained)) is None
    assert read(run_of(program, dropped=1, drained=drained)) is None  # records went missing
    other = SERVE if program is INGEST else INGEST
    assert read(run_of(other, drained=drained or 5)) in (None, 0.0)


def test_readbacks_per_query_needs_a_drained_request():
    read = harness.metric_reader("readbacks_per_query")
    assert read(run_of(SERVE, drained=0)) is None
    assert read(run_of(SERVE)) is None  # a run that drains no requests


def test_program_window_is_the_plain_window_on_the_cpu():
    w = program_spans.ProgramWindow(torch.device("cpu"), True)
    w.start()
    from repro_torch import obs

    assert not obs.enabled()
    assert w.stop(0.0, 1.0, tracing.Spans(True)) is None


def _trace_layers():
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import trace_layers
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    return trace_layers


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["webproxy-1ts.ingest", "webproxy-8ts.analysts"])
def test_program_spans_label_the_idle_card(name, cuda_device, tiny, monkeypatch):
    """Both cells at the CPU tests' size on the card, traced with the
    program's tracer on: every program metric of the cell is read, no
    record is dropped, and program spans label most idle seconds."""
    metrics = [m for m in _trace_layers().PROGRAM_METRICS if name in m["workloads"]]
    cell = harness.resolve(name)
    cell.per_layer += metrics
    monkeypatch.setattr(tracing, "DeviceWindow", program_spans.ProgramWindow)
    out = harness.run_cell(cell, 2**31 + 11, 3.0, True, cuda_device, time.perf_counter(),
                           scale=tiny)
    assert out["correct"] is True, out["checks"]
    for m in metrics:
        assert out["metrics"][m["name"]]["value"] > 0, json.dumps(out["metrics"])
    from repro_torch import obs

    assert obs.get_tracer().dropped == 0 and not obs.enabled()
    gaps = dict(out["breakdown"]["idle_gaps"])
    prefixes = ("ingest.", "query.", "serve.", "spmd.")
    program_s = sum(v for k, v in gaps.items() if k.startswith(prefixes))
    assert program_s > 0.5 * sum(gaps.values()), gaps
