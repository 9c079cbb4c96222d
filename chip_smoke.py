#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path once on the card.

    python3 chip_smoke.py [--seed N]

What it runs, in order, and what makes it fail (exit code other than 0,
no result line):

  build      nvcc builds src/repro_torch/kernels/csrc/*.cu for sm_90a
             (one process per source, in parallel) into build/.
  reference  a small seeded workload through three paths that must agree
             bit for bit: the plane on the CPU (plain versions), the plane
             on the card (CUDA kernels), and a card plane started from the
             CPU plane's state (core/carry.py); their scan totals must equal
             the host EventStore's and the count in the generated events.
  main path  the paper's §IV-A ingest loop and §IV-B scan queries at full
             size: 4,194,304 synthetic web-proxy events through
             DistBatchWriter into 64 tablets of capacity 131,072 (mem_rows
             4096, max_runs 4); the runs left at the end are drained with
             compact_step; publish(); scan and batched_scan for the
             paper's query tiers A, B and C. The kernels' launch counters
             are zeroed just before and read just after; both must be
             nonzero. Every total must equal the count in the generated
             events and a plain-version scan of the same snapshot on the
             card.
  kernels    each kernel against its plain version on the card at the
             main path's shapes (merge_runs: the K-way and 2-way stages of
             a major and the incremental fold, for the ev, ix and ag
             families; filter_scan: the base, run and memtable levels),
             with the error computed from the compared tensors (it must be
             0), the kernel's time, its bound, the plain version's time
             and, for merge_runs, a stable torch.sort of the same keys.

The last lines are the kernels' JSON summary, the card's name and power
limit from nvidia-smi, and {"ok": true, "device": {...}}. The full report
goes to chiprun_out/chip_smoke.json. Needs one CUDA card; exits with 2
when CUDA is missing.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))
T_SPAN = 4 * 3600  # the paper's queries cover a 4-hour range
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
MERGE_SRC = "src/repro_torch/kernels/csrc/merge_runs.cu"
FILTER_SRC = "src/repro_torch/kernels/csrc/filter_scan.cu"
MERGE_REPLACES = "src/repro/kernels/merge_runs/merge_runs.py:93"
FILTER_REPLACES = "src/repro/kernels/filter_scan/filter_scan.py:113"
# The main path's size: 4,194,304 events into 64 tablets of capacity
# 131,072 (benchmarks/bench_ingest_scaling.py:214), mem_rows 4096,
# max_runs 4, written by DistBatchWriter in chunks of 65,536 events.
MAIN_PATH = dict(events=4_194_304, tablets=64, capacity=131_072, mem_rows=4096,
                 max_runs=4, chunk=65_536)


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def log(tag, msg):
    print(f"[{tag}] {msg}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not available"


def cuda_ms(fn):
    """Milliseconds of one fn() on the card: after a warm-up, CUDA events
    around a run of launches sized to about 0.25 s (at most 50), and the
    median of three such runs. The events also count any time the card
    sits idle while the host stalls, so the garbage collector is off while
    they run, and the median drops a run that met another stall."""
    import gc
    import statistics

    import torch

    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        one = max(time.perf_counter() - t0, 1e-6)
        reps = int(max(3, min(50, 0.25 / one)))
        runs = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / reps)
        return statistics.median(runs)
    finally:
        if gc_was_on:
            gc.enable()


def pick_tiers(source, domain_counts):
    """The paper's query tiers by benchmarks/common.py's rule, on counts of
    the generated events: A the most popular domain, B a moderately
    popular one, C the least popular one with at least 30 hits."""
    import numpy as np

    counts = {}
    for q in np.linspace(0, 0.5, 100):
        dom = source.domain_by_popularity(q)
        counts[dom] = domain_counts.get(dom, 0)
    ranked = sorted(counts.items(), key=lambda kv: -kv[1])
    top = ranked[0][1]
    a = ranked[0][0]
    b = next((d for d, c in ranked if c <= top * 0.15 and c > max(top * 0.02, 100)),
             ranked[len(ranked) // 4][0])
    c = next((d for d, c in reversed(ranked) if c >= 30), ranked[-1][0])
    return {"A": a, "B": b, "C": c}


def program_tensors(store, tree, device):
    import torch
    from repro_torch.core.filter import compile_tree
    from repro_torch.kernels.filter_scan import pad_program

    return tuple(torch.from_numpy(a).to(device) for a in pad_program(compile_tree(store, tree)))


def plain_scan_count(d, program, t0, t1):
    """The scan count of a snapshot from the plain versions only:
    searchsorted range restriction and program_eval_rows on every level."""
    import torch
    from repro_torch.core import keypack
    from repro_torch.kernels.program_eval import program_eval_rows

    lo, hi = int(keypack.rev_ts(t1)), int(keypack.rev_ts(t0)) + 1
    total = 0
    for rev, cols, live in ((d.rev_ts, d.cols, d.counts),
                            (d.run_rev_ts, d.run_cols, d.run_counts),
                            (d.mem_rev_ts, d.mem_cols, d.mem_counts)):
        r = rev.shape[-1]
        rev2 = rev.reshape(-1, r)
        probe = torch.tensor([lo, hi], dtype=rev.dtype, device=rev.device)
        a, b = torch.searchsorted(rev2, probe.expand(rev2.shape[0], 2).contiguous()).unbind(-1)
        idx = torch.arange(r, device=rev.device)
        in_range = (idx >= a[:, None]) & (idx < b[:, None]) & (idx < live.reshape(-1)[:, None])
        hit = program_eval_rows(cols.reshape(-1, cols.shape[-1]), *program).reshape(in_range.shape)
        total += int((hit & in_range).sum())
    return total


def host_scan_count(store, program, t0, t1):
    """The host EventStore's count: its BatchScanner plus the filter
    wrapper on CPU tensors (the plain version)."""
    import torch
    from repro_torch.core.scan import scan_events
    from repro_torch.kernels.filter_scan import filter_scan

    cpu_prog = tuple(p.cpu() for p in program)
    return sum(int(filter_scan(torch.from_numpy(cols), *cpu_prog).sum())
               for _, cols in scan_events(store, t0, t1))


def states_equal(a, b):
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch_equal(a[k], b[k]) for k in a)


def torch_equal(x, y):
    import torch

    return torch.equal(x.cpu(), y.cpu())


def run_reference(seed, dev):
    """Small workload: CPU plane == card plane == carried card plane, and
    their scan totals == the host store's == the generated events'."""
    import numpy as np
    from repro_torch.core.carry import plane_state_from_numpy
    from repro_torch.core.dist_ingest import DistBatchWriter, DistIngestPlane
    from repro_torch.core.dist_query import DistQueryProcessor
    from repro_torch.core.filter import Eq
    from repro_torch.core.schema import web_proxy_schema
    from repro_torch.core.store import EventStore
    from repro_torch.pipeline.sources import SyntheticWebProxySource, parse_web_proxy_lines

    t0 = time.perf_counter()
    source = SyntheticWebProxySource(seed=seed + 1)
    ts, vals = parse_web_proxy_lines(source.gen_lines(24000, 0, T_SPAN))
    host = EventStore(web_proxy_schema(), n_shards=4, flush_rows=4096, max_runs=3)
    host.ingest(ts, vals)
    sizes = dict(n_tablets=8, mem_rows=512, max_runs=2, append_rows=256)
    planes = {name: DistIngestPlane.for_store(host, capacity=4096, device=d, **sizes)
              for name, d in (("cpu", "cpu"), ("card", dev))}
    for name, plane in planes.items():
        w = DistBatchWriter(host, plane, batch_rows=2000, writer_id=5)
        for off in range(0, len(ts), 1500):
            w.add(ts[off: off + 1500], {k: v[off: off + 1500] for k, v in vals.items()})
        w.close()
    cpu, card = planes["cpu"], planes["card"]
    check(states_equal(cpu.state, card.state), "card plane state != CPU plane state after ingest")
    tel = cpu.telemetry()
    check(tel["major"].min() > 0 and tel["overflow"].sum() == 0,
          f"reference workload did not exercise majors cleanly: {tel['major']}")
    carried = DistIngestPlane.for_store(host, capacity=4096, device=dev, **sizes)
    carried.load_state(plane_state_from_numpy(
        {k: v.numpy() for k, v in cpu.state.items()}, dev))
    steps = 0
    while True:
        ran = [p.compact_step() for p in (cpu, card, carried)]
        check(len(set(ran)) == 1, f"compact_step disagrees: {ran}")
        check(states_equal(cpu.state, card.state) and states_equal(cpu.state, carried.state),
              f"states differ after compact_step {steps}")
        if not ran[0]:
            break
        steps += 1
    domain_counts = Counter(vals["domain"])
    tiers = pick_tiers(source, domain_counts)
    for tier, dom in tiers.items():
        tree = Eq("domain", dom)
        want = domain_counts[dom]
        got_host = host_scan_count(host, program_tensors(host, tree, "cpu"), 0, T_SPAN)
        for name, plane in planes.items():
            dq = DistQueryProcessor(host, plane, device=plane.device)
            for scheme in ("scan", "batched_scan"):
                got = sum(b.count for b in dq.run_scheme(scheme, 0, T_SPAN, tree))
                check(got == want == got_host,
                      f"reference {tier} {scheme} on {name}: {got} != {want} (host {got_host})")
    log("reference", f"24000 events: card plane == CPU plane == carried plane bit for bit "
        f"through ingest and {steps} compact_step increments; scan totals match the host "
        f"store and the events for {tiers} ({time.perf_counter() - t0:.3f} s)")


def merge_inputs(pre, fam, sentinel):
    """The rank kernel's three main-path inputs for one family, built from
    the plane state at the end of ingest as major and fold build them:
    (keys (T, N), run bounds, int32 (T, K) live lengths)."""
    import torch
    from repro_torch.kernels.merge_runs import merge_sorted_device

    rk, rc, rn = pre[f"{fam}_run_k"], pre[f"{fam}_run_c"], pre[f"{fam}_run_n"]
    bk, bn = pre[f"{fam}_base_k"], pre[f"{fam}_base_n"]
    t, k, m = rk.shape
    c = bk.shape[1]
    within = torch.arange(m, device=rk.device)[None, None, :] < rn[..., None]
    kway = torch.where(within, rk, sentinel)
    merged, _ = merge_sorted_device(kway, torch.where(within[..., None], rc, 0), rn)
    nr = pre["n_runs"]
    slot = (nr - 1).clamp(min=0).long()
    tix = torch.arange(t, device=rk.device)
    top_n = rn[tix, slot]
    top = torch.where(torch.arange(m, device=rk.device)[None, :] < top_n[:, None],
                      rk[tix, slot], sentinel)
    return {
        "kway": (kway.reshape(t, k * m), [o * m for o in range(k + 1)], rn),
        "two_way": (torch.cat([bk, merged], dim=1), [0, c, c + k * m],
                    torch.stack([bn, rn.sum(dim=1, dtype=torch.int32)], dim=1)),
        "fold": (torch.cat([bk, top], dim=1), [0, c, c + m], torch.stack([bn, top_n], dim=1)),
    }


def time_merge(name, keys, bounds, lengths):
    import torch
    from repro_torch.kernels.merge_runs import merge_ranks, merge_ranks_ref

    got = merge_ranks(keys, bounds, lengths)
    want = merge_ranks_ref(keys, bounds, lengths)
    err = int((got.long() - want.long()).abs().max())
    b, n = keys.shape
    live = int(lengths.sum())
    caps = [bounds[o + 1] - bounds[o] for o in range(len(bounds) - 1)]
    return {
        "shape": name, "dims": [b, n], "runs": caps, "live_keys": live,
        "dtype": str(keys.dtype).replace("torch.", ""), "max_abs_err": err,
        "ms": cuda_ms(lambda: merge_ranks(keys, bounds, lengths)),
        "plain_ms": cuda_ms(lambda: merge_ranks_ref(keys, bounds, lengths)),
        # The live keys read once, the lengths once, one int32 rank written
        # per entry; dead entries are not read.
        "bound_ms": (live * keys.element_size() + lengths.numel() * 4 + b * n * 4)
        / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        # The same bound if every entry's key were read, dead ones included.
        "bound_ms_all_keys": b * n * (keys.element_size() + 4) / HBM_BYTES_PER_S * 1e3,
        "library_ms": cuda_ms(lambda: torch.sort(keys, dim=1, stable=True)),
        "dependent_loads_per_live_key": max(
            sum(max(cap, 1).bit_length() for o, cap in enumerate(caps) if o != j)
            for j in range(len(caps))),
    }


def time_filter(name, cols, program, rich):
    from repro_torch.kernels.filter_scan import filter_scan
    from repro_torch.kernels.program_eval import program_eval_rows

    f = cols.shape[-1]
    rows = cols.reshape(-1, f)
    # The plain version walks the program on the host: give it the program
    # lists there, so that its time holds no device-to-host copies.
    host_prog = (*(p.cpu() for p in program[:3]), program[3])
    err = 0
    for prog in (program, rich):
        got = filter_scan(cols, *prog).reshape(-1)
        want = program_eval_rows(rows, *prog)
        err = max(err, int((got.int() - want.int()).abs().max()))
    n = rows.shape[0]
    return {
        "shape": name, "dims": list(cols.shape), "dtype": "int32", "max_abs_err": err,
        "ms": cuda_ms(lambda: filter_scan(cols, *program)),
        "plain_ms": cuda_ms(lambda: program_eval_rows(rows, *host_prog)),
        "bound_ms": (n * f * 4 + n) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
    }


def summarize_spans(records):
    out = {}
    for r in records:
        s = out.setdefault(r["name"], {"n": 0, "s": 0.0, "fence_s": 0.0})
        s["n"] += 1
        s["s"] += r["dur"]
        s["fence_s"] += r["fence_s"]
    return out


def run_main_path(seed, dev, size=MAIN_PATH):
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core.dist_ingest import REV_PAD, KEY_PAD64, DistBatchWriter, DistIngestPlane
    from repro_torch.core.dist_query import DistQueryProcessor
    from repro_torch.core.filter import Eq, In, Not, Or
    from repro_torch.core.schema import web_proxy_schema
    from repro_torch.core.store import EventStore
    from repro_torch.kernels.filter_scan import ops as filter_ops
    from repro_torch.kernels.merge_runs import ops as merge_ops
    from repro_torch.pipeline.sources import SyntheticWebProxySource, parse_web_proxy_lines

    report = {}
    events, chunk = size["events"], size["chunk"]
    source = SyntheticWebProxySource(seed=seed)
    store = EventStore(web_proxy_schema())  # schema and dictionaries for the writer
    plane = DistIngestPlane.for_store(
        store, capacity=size["capacity"], n_tablets=size["tablets"], mem_rows=size["mem_rows"],
        max_runs=size["max_runs"], append_rows=1024, device=dev)
    writer = DistBatchWriter(store, plane, batch_rows=chunk, writer_id=0)
    torch.cuda.reset_peak_memory_stats(dev)
    domain_counts = Counter()

    merge_ops.launches = 0
    filter_ops.launches = 0
    obs.enable()
    obs.clear()
    ingest_s = 0.0
    for off in range(0, events, chunk):
        n = min(chunk, events - off)
        ts, vals = parse_web_proxy_lines(source.gen_lines(n, 0, T_SPAN))
        domain_counts.update(vals["domain"])
        t0 = time.perf_counter()
        writer.add(ts, vals)
        ingest_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    writer.close()
    torch.cuda.synchronize(dev)
    ingest_s += time.perf_counter() - t0
    tel = plane.telemetry()
    pre = dict(plane.state)  # end-of-ingest levels, kept for the kernel checks
    runs_left = (int(tel["n_runs"].min()), int(tel["n_runs"].max()))
    t0 = time.perf_counter()
    steps = 0
    while plane.has_unfolded():
        steps += plane.compact_step()
    torch.cuda.synchronize(dev)
    drain_s = time.perf_counter() - t0
    ingest_spans = summarize_spans(obs.get_tracer().records)
    obs.clear()
    tel = plane.telemetry()
    check(int(tel["rows"].sum()) == events, f"plane rows {tel['rows'].sum()} != {events}")
    check(int(tel["overflow"].sum()) == 0 and int(tel["ix_overflow"].sum()) == 0
          and int(tel["ag_overflow"].sum()) == 0, "tablet overflow on the main path")
    check(int(tel["base_n"].sum()) == events, "drained bases do not hold every event")
    report["ingest"] = {
        "events": events, "seconds": ingest_s, "rows_per_s": events / ingest_s,
        "minor": int(tel["minor"].sum()), "major": int(tel["major"].sum()),
        "blocked_s": plane.blocked_seconds, "runs_left_per_tablet": runs_left,
        "drain_steps": steps, "drain_s": drain_s, "spans": ingest_spans,
        "lock": plane.group.lock.snapshot(),
    }
    log("ingest", f"{events} events in {ingest_s:.3f} s = {events / ingest_s:.1f} rows/s "
        f"(encode + shard + device append, blocking majors included); minor "
        f"{report['ingest']['minor']} major {report['ingest']['major']} blocked "
        f"{plane.blocked_seconds:.3f} s; runs per tablet left {runs_left[0]}..{runs_left[1]}")
    log("ingest", f"drained with {steps} compact_step increments in {drain_s:.3f} s; "
        f"has_unfolded={plane.has_unfolded()}")
    log("ingest", "spans " + json.dumps(ingest_spans))
    state_bytes = plane.state_bytes()
    base_bytes = sum(t.numel() * t.element_size() for k, t in plane.state.items() if "_base_" in k)
    report["plane"] = {"state_bytes": state_bytes, "base_bytes": base_bytes,
                       "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev)}
    log("plane", f"{state_bytes} bytes of state on the device ({base_bytes} in the bases); "
        f"peak allocated {report['plane']['peak_allocated_bytes']} bytes")

    tiers = pick_tiers(source, domain_counts)
    dq = DistQueryProcessor(store, plane, device=dev)
    queries = []
    for tier, dom in tiers.items():
        for scheme in ("scan", "batched_scan"):
            t0 = time.perf_counter()
            it = dq.run_scheme(scheme, 0, T_SPAN, Eq("domain", dom))
            first = next(it)
            ttfr = time.perf_counter() - t0
            rows, batches = first.count, 1
            for blk in it:
                rows += blk.count
                batches += 1
            total_s = time.perf_counter() - t0
            q = {"query": tier, "domain": dom, "scheme": scheme, "rows": rows,
                 "batches": batches, "ttfr_s": ttfr, "total_s": total_s}
            queries.append(q)
            log("query", json.dumps(q))
    launches = {"merge_runs": merge_ops.launches, "filter_scan": filter_ops.launches}
    query_spans = summarize_spans(obs.get_tracer().records)
    obs.disable()
    log("launches", "main path: " + json.dumps(launches))
    log("query", "spans " + json.dumps(query_spans))
    check(launches["merge_runs"] > 0 and launches["filter_scan"] > 0,
          f"a kernel of the main path never launched: {launches}")
    report["queries"] = queries
    report["query_spans"] = query_spans
    report["launches"] = launches

    d = dq.dist
    for q in queries:
        program = program_tensors(store, Eq("domain", q["domain"]), dev)
        want = domain_counts[q["domain"]]
        plain = plain_scan_count(d, program, 0, T_SPAN)
        check(q["rows"] == want == plain,
              f"{q['query']} {q['scheme']}: {q['rows']} rows, events hold {want}, "
              f"plain versions count {plain}")
    log("check", "every scheme's total equals the generated events' count and the plain "
        "versions' scan of the same snapshot on the card")

    # Each kernel against its plain version at the main path's shapes.
    merge_rows = []
    for fam, sentinel in (("ev", REV_PAD), ("ix", KEY_PAD64), ("ag", KEY_PAD64)):
        for stage, inputs in merge_inputs(pre, fam, sentinel).items():
            row = time_merge(f"{fam} {stage}", *inputs)
            merge_rows.append(row)
            log("kernel", json.dumps({"name": "merge_runs", **row}))
    dom_a = tiers["A"]
    program = program_tensors(store, Eq("domain", dom_a), dev)
    rich = program_tensors(store, Or(Eq("domain", dom_a), Not(In("status", ("200", "404"))),
                                     In("method", ("PUT", "HEAD", "never-seen"))), dev)
    filter_rows = []
    for name, cols in (("base (T,R,F)", d.cols), ("runs (T,K,M,F)", pre["ev_run_c"]),
                       ("memtable (T,M,F)", pre["ev_mem_c"])):
        row = time_filter(name, cols, program, rich)
        filter_rows.append(row)
        log("kernel", json.dumps({"name": "filter_scan", **row}))
    for rows in (merge_rows, filter_rows):
        for row in rows:
            check(row["max_abs_err"] == 0, f"kernel disagrees with its plain version: {row}")

    def summary(name, route, src, replaces, rows, main_shape):
        top = next(r for r in rows if r["shape"] == main_shape)
        return {
            "name": name, "route": route, "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "shape": main_shape, "shapes": rows,
        }

    kernels = [
        summary("merge_runs", "cuda", MERGE_SRC, MERGE_REPLACES, merge_rows, "ix two_way"),
        summary("filter_scan", "cuda", FILTER_SRC, FILTER_REPLACES, filter_rows, "base (T,R,F)"),
    ]
    report["kernels"] = kernels
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs one NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log("env", f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    build.load_library()
    log("build", f"kernels built and loaded in {time.perf_counter() - t0:.3f} s")
    for line in build.build_log:
        log("build", line)
    try:
        run_reference(args.seed, dev)
        report = run_main_path(args.seed, dev)
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    report.update(device=kind, nvidia_smi=smi, seed=args.seed, torch=torch.__version__)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": report["kernels"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
