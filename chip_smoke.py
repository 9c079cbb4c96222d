#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path once on the card.

    python3 chip_smoke.py [--seed N]

What it runs, in order, and what makes it fail (exit code other than 0,
no result line):

  build      nvcc builds src/repro_torch/kernels/csrc/*.cu for sm_90a
             (one process per source, in parallel) into build/; among
             them merge_ranks_search.cu, merge_runs' earlier design, which
             the kernel rows time beside the merge-path kernel.
  reference  a small seeded workload through three paths that must agree
             bit for bit: the plane on the CPU (plain versions), the plane
             on the card (CUDA kernels), and a card plane started from the
             CPU plane's state (core/carry.py); the totals of all four
             schemes on the tier queries, an AND and an OR must equal the
             host EventStore's and the count in the generated events; the
             three aggregation specs below, on tiers A and C and on A AND
             404, must give the same groups, values and counts from the
             host QueryProcessor on the CPU and on the card and from
             aggregate_range on the CPU plane and the card plane, on a scan
             plan and an index plan.
  main path  three paths at full size, each with every kernel launch count
             zeroed just before it and read just after:
             1. the paper's §IV-A ingest loop and §IV-B scans: 4,194,304
                synthetic web-proxy events through DistBatchWriter into 64
                tablets of capacity 131,072 (mem_rows 4096, max_runs 4);
                the runs left at the end are drained with compact_step;
                publish(); scan and batched_scan for the paper's query
                tiers A, B and C, and for domain = A AND bytes_in IN
                300,000 of the dictionary's codes (a program of 1.2 MB,
                past shared memory). merge_runs and filter_scan must
                launch.
             2. density planning and the index schemes on the same
                snapshot: index and batched_index for the tiers; all four
                schemes on domain AND status=404 for tiers A and B (both
                must plan two index conditions); both index schemes on
                domain B OR domain C. merge_intersect and filter_scan must
                launch. The device densities of the tiers must equal the
                generated counts.
             3. scan-time aggregation on the same snapshot: the host
                EventStore(n_shards=8) is filled with the same events, as
                the writer encoded them, then flushed and compacted
                (set-up, untimed); for (a) count per status per hour, (b)
                sum of bytes_in per method per hour and (c) max of
                bytes_out per status, on domain = tier A, B and C and on
                A AND status=404: the host QueryProcessor's combine_scan
                scheme on the card (time to the first and the last
                AggregateBlock) and DistQueryProcessor.aggregate_range on
                scan and index plans. Host and device must agree bit for
                bit, and every count total must equal the generated count.
                combine_scan, filter_scan and merge_intersect must launch.
             Every total must equal the count in the generated events and
             a plain-version scan of the same snapshot on the card.
             aggregate_combine must launch on path 1, once per major and
             per fold increment (the aggregate family's combiner), and
             filter_scan exactly once per scan, index or aggregate step
             on every path (one launch filters every LSM level).
  kernels    each kernel against its plain version on the card at the
             main path's shapes (merge_runs: the K-way and 2-way stages of
             a major and the incremental fold, for the ev, ix and ag
             families, with the earlier design's time beside; filter_scan:
             the fused scan step over base, runs and memtable, each level
             alone, the index step's candidate rows alone and fused, and
             on the base In(bytes_in) sets of 3,000, 12,000 and 30,000
             codes staged in shared memory and with their codes in global
             memory, and of 300,000 codes; merge_intersect: the posting
             slabs of one AND-B batch, and an int64 case; combine_scan:
             all four ops on the largest tier-A batch of path 3, its sum
             with the 300,000-code program, and on 1,048,576 synthetic
             rows with one group over many tiles and a filter that
             rejects half its rows; aggregate_combine: the
             aggregate family's 2-way major and fold inputs and an int32
             combine_sorted_counts case), with the error computed from the
             compared tensors (it must be 0), the kernel's time (cuda_ms:
             CUDA events around back-to-back calls, host dispatch
             included) and its device time alone (device_ms: a
             torch.profiler window), its bound, the plain version's time
             and, where one PyTorch call
             computes the same function, that call's time (a stable
             torch.sort for merge_runs, torch.isin for merge_intersect;
             none for combine_scan and aggregate_combine, which also
             record torch.unique_consecutive + torch.segment_reduce as a
             two-call yardstick).

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
INTERSECT_SRC = "src/repro_torch/kernels/csrc/merge_intersect.cu"
INTERSECT_REPLACES = "src/repro/kernels/merge_intersect/merge_intersect.py:73"
COMBINE_SRC = "src/repro_torch/kernels/csrc/combine_scan.cu"
COMBINE_REPLACES = "src/repro/kernels/combine_scan/combine_scan.py:99"
AGGREGATE_SRC = "src/repro_torch/kernels/csrc/aggregate_combine.cu"
AGGREGATE_REPLACES = "src/repro/kernels/aggregate_combine/aggregate_combine.py:54"
SCHEMES = ("scan", "batched_scan", "index", "batched_index")
OPS = ("count", "sum", "min", "max")
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


# How each device_ms was taken, in order ("profiler" or "queued events").
DEVICE_MS_BY = []


def device_ms(fn, names, calls=10):
    """The named kernels' own device time per fn() call, in ms.

    First a torch.profiler window over ``calls`` calls (CUDA activity
    only): the time of every device kernel or memset whose name holds one
    of ``names``, summed and divided by the calls. On the H100 runs so far
    the profiler now and then reported no device events for a window, and
    once for every window after the 18th; when two windows in a row hold
    fewer than ``calls`` of them it falls back to queued_device_ms (CUDA events around the calls queued behind a
    spin kernel, so no host gap
    enters). Each row names its method beside the number."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and any(n in e.name for n in names)]
        if len(us) >= calls:
            DEVICE_MS_BY.append("profiler")
            return sum(us) / calls / 1e3
    DEVICE_MS_BY.append("queued events")
    return queued_device_ms(fn, calls)


def queued_device_ms(fn, calls=10):
    """Device time per fn() call, in ms, with no host time in it: a spin
    kernel holds the stream while the host queues ``calls`` calls between
    two CUDA events, so the card runs them back to back. The spin is sized
    from the host's time per call and checked to outlast the queueing;
    fn must not synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_s = max(0.02, 4 * calls * host_s)
    for _ in range(3):
        spin0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spin0.record()
        torch.cuda._sleep(int(spin_s * 2e9))  # cycles; the clock is under 2 GHz
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        queued_s = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        if spin0.elapsed_time(start) / 1e3 > queued_s:
            return start.elapsed_time(end) / calls
        spin_s *= 4
    raise CheckFailed("queued_device_ms: the host could not queue the calls behind the spin")


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
    """The tree's program prepared on the device (a Program; it unpacks
    into the original form the plain versions take)."""
    from repro_torch.core.filter import compile_tree
    from repro_torch.kernels.filter_scan import program_tensors as prepare

    return prepare(compile_tree(store, tree), device)


def plain_scan_count(d, program, t0, t1):
    """The scan count of a snapshot from the plain versions only:
    searchsorted range restriction and program_eval_rows on every level."""
    import torch
    from repro_torch.core import keypack
    from repro_torch.kernels.program_eval import program_eval_rows

    lo, hi = int(keypack.rev_ts(t1)), int(keypack.rev_ts(t0)) + 1
    total = 0
    for rev, cols, live in d.ev_levels():
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
    return sum(int(filter_scan(torch.from_numpy(b.cols), *cpu_prog).sum())
               for b in scan_events(store, t0, t1))


def agg_specs():
    """The aggregation specs: (a) the repo's AGG_SPEC
    (benchmarks/bench_query_runtime.py:34), (b) a sum of bytes_in, whose
    tier-A totals overflow int32, (c) a max."""
    from repro_torch.core import AggregateSpec

    return {
        "a count/status/hour": AggregateSpec(group_by=("status",), op="count",
                                             time_bucket_s=3600),
        "b sum bytes_in/method/hour": AggregateSpec(group_by=("method",), op="sum",
                                                    value_field="bytes_in", time_bucket_s=3600),
        "c max bytes_out/status": AggregateSpec(group_by=("status",), op="max",
                                                value_field="bytes_out"),
    }


def same_aggregates(a, b):
    """Equal groups, values and counts (values compared across the host's
    int32 and the device's int64 counts)."""
    import numpy as np

    return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in ("gids", "values", "counts"))


def states_equal(a, b):
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch_equal(a[k], b[k]) for k in a)


def torch_equal(x, y):
    import torch

    return torch.equal(x.cpu(), y.cpu())


def run_reference(seed, dev):
    """Small workload: CPU plane == card plane == carried card plane, and
    their densities and four schemes' totals == the host store's == the
    generated events'."""
    import numpy as np
    from repro_torch.core.carry import plane_state_from_numpy
    from repro_torch.core.dist_ingest import DistBatchWriter, DistIngestPlane
    from repro_torch.core.dist_query import DistQueryProcessor
    from repro_torch.core.filter import And, Eq, Or
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
    pair_counts = Counter(zip(vals["domain"], vals["status"]))
    tiers = pick_tiers(source, domain_counts)
    queries = [(f"tier {tier}", Eq("domain", dom), domain_counts[dom])
               for tier, dom in tiers.items()]
    queries.append(("A and 404", And(Eq("domain", tiers["A"]), Eq("status", "404")),
                    pair_counts[(tiers["A"], "404")]))
    queries.append(("B or C", Or(Eq("domain", tiers["B"]), Eq("domain", tiers["C"])),
                    domain_counts[tiers["B"]] + domain_counts[tiers["C"]]))
    procs = {name: DistQueryProcessor(host, plane, device=plane.device)
             for name, plane in planes.items()}
    for tier, dom in tiers.items():
        dens = {name: dq.agg_count("domain", dom, 0, T_SPAN) for name, dq in procs.items()}
        dens["host"] = host.agg_count("domain", dom, 0, T_SPAN)
        check(all(v == domain_counts[dom] for v in dens.values()),
              f"reference density of tier {tier}: {dens}, events hold {domain_counts[dom]}")
    for label, tree, want in queries:
        got_host = host_scan_count(host, program_tensors(host, tree, "cpu"), 0, T_SPAN)
        for name, dq in procs.items():
            for scheme in SCHEMES:
                got = sum(b.count for b in dq.run_scheme(scheme, 0, T_SPAN, tree))
                check(got == want == got_host,
                      f"reference {label} {scheme} on {name}: {got} != {want} (host {got_host})")
    from repro_torch.core import QueryProcessor

    hosts = {"host cpu": QueryProcessor(host, device="cpu"),
             "host card": QueryProcessor(host, device=dev)}
    for sname, spec in agg_specs().items():
        for label, tree, want in (queries[0], queries[2], queries[3]):
            results = {name: qp.aggregate(spec, 0, T_SPAN, tree) for name, qp in hosts.items()}
            for name, dq in procs.items():
                for use_index in (False, True):
                    plan = "index" if use_index else "scan"
                    results[f"{name} plane {plan} plan"] = dq.aggregate_range(
                        spec, tree, 0, T_SPAN, use_index=use_index)
            base = results["host cpu"]
            for name, res in results.items():
                check(same_aggregates(res, base),
                      f"reference {label} {sname}: {name} differs from the CPU host processor")
            check(int(base.counts.sum()) == want,
                  f"reference {label} {sname}: counts sum to {base.counts.sum()}, "
                  f"events hold {want}")
    log("reference", f"24000 events: card plane == CPU plane == carried plane bit for bit "
        f"through ingest and {steps} compact_step increments; densities and the totals of "
        f"all four schemes match the host store and the events for {tiers}, an AND and an "
        f"OR; the three aggregation specs agree across the host processor (CPU, card) and "
        f"aggregate_range (CPU plane, card plane; scan and index plans) "
        f"({time.perf_counter() - t0:.3f} s)")


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


def search_ranks(keys, bounds, lengths):
    """The earlier design of merge_runs (csrc/merge_ranks_search.cu: one
    binary search per live entry into every other run), called straight
    from the library as the merge-path kernel's yardstick; its launches
    are not counted."""
    import torch
    from repro_torch.kernels.build import check as check_launch, load_library

    lib = load_library()
    fn = lib.merge_ranks_search_i32 if keys.dtype == torch.int32 else lib.merge_ranks_search_i64
    dev_bounds = torch.tensor(bounds, dtype=torch.int64, device=keys.device)
    out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream

    def run():
        check_launch(fn(keys.data_ptr(), dev_bounds.data_ptr(), lengths.data_ptr(),
                        out.data_ptr(), keys.shape[0], len(bounds) - 1, keys.shape[1], stream),
                     "merge_ranks_search")
        return out

    return run


def time_merge(name, keys, bounds, lengths, payload):
    """merge_runs against its plain version and its earlier design, and
    the scatter by rank that follows it in the plane's merges
    (merge_runs/ops.py::_scatter_by_rank) of the keys and a payload of the
    family's width and type (W = payload.shape[-1])."""
    import torch
    from repro_torch.kernels.merge_runs import merge_ranks, merge_ranks_ref
    from repro_torch.kernels.merge_runs.ops import _scatter_by_rank

    got = merge_ranks(keys, bounds, lengths)
    want = merge_ranks_ref(keys, bounds, lengths)
    err = int((got.long() - want.long()).abs().max())
    earlier = search_ranks(keys, bounds, lengths)
    check(torch.equal(earlier(), want), f"{name}: the earlier merge design disagrees")
    b, n = keys.shape
    live = int(lengths.sum())
    caps = [bounds[o + 1] - bounds[o] for o in range(len(bounds) - 1)]
    return {
        "shape": name, "dims": [b, n], "runs": caps, "live_keys": live,
        "dtype": str(keys.dtype).replace("torch.", ""), "max_abs_err": err,
        "ms": cuda_ms(lambda: merge_ranks(keys, bounds, lengths)),
        "device_ms": device_ms(lambda: merge_ranks(keys, bounds, lengths),
                               ("merge_path_kernel", "Memset")),
        "device_ms_by": DEVICE_MS_BY[-1],
        "earlier_design_ms": cuda_ms(earlier),
        "earlier_design_device_ms": device_ms(earlier, ("search_ranks_kernel",)),
        "earlier_design_device_ms_by": DEVICE_MS_BY[-1],
        "scatter_ms": cuda_ms(lambda: _scatter_by_rank(keys, payload, got)),
        "payload_width": payload.shape[-1],
        "plain_ms": cuda_ms(lambda: merge_ranks_ref(keys, bounds, lengths)),
        # The live keys read once, the lengths once, one int32 rank written
        # per entry; dead entries are not read.
        "bound_ms": (live * keys.element_size() + lengths.numel() * 4 + b * n * 4)
        / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        # The same bound if every entry's key were read, dead ones included.
        "bound_ms_all_keys": b * n * (keys.element_size() + 4) / HBM_BYTES_PER_S * 1e3,
        "library_ms": cuda_ms(lambda: torch.sort(keys, dim=1, stable=True)),
    }


def time_filter(name, levels, program, rich=None, both_placements=False):
    """filter_scan over one block or, fused, over a step's levels (one
    launch) against the plain version per level, with the rich program
    too where given. both_placements also times the program staged whole
    in shared memory (SHARED_PROGRAM_BYTES at the opt-in limit) and with
    its codes in global memory (SHARED_PROGRAM_BYTES = 0), beside its
    default placement."""
    from repro_torch.kernels import program_eval
    from repro_torch.kernels.build import shared_optin_bytes
    from repro_torch.kernels.filter_scan import filter_scan_levels
    from repro_torch.kernels.program_eval import program_eval_rows

    levels = levels if isinstance(levels, list) else [levels]
    f = levels[0].shape[-1]
    flat = [c.reshape(-1, f) for c in levels]
    # The plain version walks the program on the host: give it the program
    # lists there, so that its time holds no device-to-host copies.
    opcodes, arg0, arg1, codesets = program
    host_prog = (opcodes.cpu(), arg0.cpu(), arg1.cpu(), codesets)
    err = 0
    for prog in (program, rich) if rich is not None else (program,):
        for got, rows in zip(filter_scan_levels(levels, prog), flat):
            want = program_eval_rows(rows, *prog)
            err = max(err, int((got.reshape(-1).int() - want.int()).abs().max()))
    n = sum(r.shape[0] for r in flat)
    staged = program.staged_words(shared_optin_bytes())
    row = {
        "shape": name, "dims": [list(c.shape) for c in levels], "dtype": "int32",
        "codes": program.n_codes, "program_bytes": program.nbytes,
        "placement": ("shared" if staged == program.header_words + program.n_codes else
                      "header in shared, codes in global" if staged == program.header_words
                      else "global"), "max_abs_err": err,
        "ms": cuda_ms(lambda: filter_scan_levels(levels, program)),
        "device_ms": device_ms(lambda: filter_scan_levels(levels, program),
                               ("filter_levels_kernel",)),
        "device_ms_by": DEVICE_MS_BY[-1],
        "plain_ms": cuda_ms(lambda: [program_eval_rows(r, *host_prog) for r in flat]),
        # The rows and the program's words read once, the masks written once.
        "bound_ms": (n * f * 4 + n + program.nbytes) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
    }
    keep = program_eval.SHARED_PROGRAM_BYTES
    for placement, limit in (("shared", shared_optin_bytes()), ("global", 0)):
        if not both_placements:
            break
        program_eval.SHARED_PROGRAM_BYTES = limit
        try:
            got = filter_scan_levels(levels, program)
            for g, rows in zip(got, flat):
                check(torch_equal(g.reshape(-1), program_eval_rows(rows, *program)),
                      f"{name}: the {placement} placement disagrees")
            row[f"{placement}_ms"] = cuda_ms(lambda: filter_scan_levels(levels, program))
            row[f"{placement}_device_ms"] = device_ms(
                lambda: filter_scan_levels(levels, program), ("filter_levels_kernel",))
            row[f"{placement}_device_ms_by"] = DEVICE_MS_BY[-1]
        finally:
            program_eval.SHARED_PROGRAM_BYTES = keep
    return row


def time_intersect(name, a, b):
    """merge_intersect against its plain version and against torch.isin on
    keys offset by row ((row << shift) | key, so one flat call keeps the
    rows apart; int32 keys shift by 32, int64 keys below 2**53 by 53)."""
    import torch
    from repro_torch.kernels.merge_intersect import member_mask, member_mask_keys

    got = member_mask(a, b)
    want = member_mask_keys(a, b)
    rows, n = a.shape
    m = b.shape[-1]
    shift = 32 if a.dtype == torch.int32 else 53
    check(int(a.min()) >= 0 and int(b.min()) >= 0 and max(int(a.max()), int(b.max())) < 2**shift,
          f"{name}: keys do not fit the row offset")
    off = torch.arange(rows, dtype=torch.int64, device=a.device)[:, None] << shift
    a64, b64 = (off | a.long()).reshape(-1), (off | b.long()).reshape(-1)
    isin = torch.isin(a64, b64).reshape(a.shape)
    err = int((got.int() - want.int()).abs().max())
    check(torch.equal(isin, got), f"{name}: torch.isin disagrees with the kernel")
    return {
        "shape": name, "dims": [rows, n, m], "dtype": str(a.dtype).replace("torch.", ""),
        "max_abs_err": err, "live_probes": int((a < torch.iinfo(a.dtype).max).sum()),
        "live_hits": int((got & (a < torch.iinfo(a.dtype).max)).sum()),
        "ms": cuda_ms(lambda: member_mask(a, b)),
        "device_ms": device_ms(lambda: member_mask(a, b), ("member_mask_kernel",)),
        "device_ms_by": DEVICE_MS_BY[-1],
        "plain_ms": cuda_ms(lambda: member_mask_keys(a, b)),
        # Each probe and each set key read once, one bool written per probe.
        "bound_ms": (rows * (n + m) * a.element_size() + rows * n) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": cuda_ms(lambda: torch.isin(a64, b64)),
    }


def time_combine(name, keys, vals, cols, program, op):
    """combine_scan against its plain version on one sorted batch."""
    from repro_torch.kernels.combine_scan import combine_scan_ref, combine_segments

    v = None if op == "count" else vals
    got = combine_segments(keys, v, cols, program, op)
    want = combine_scan_ref(keys, vals, cols, *program, op)
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    n, f = cols.shape
    # Keys, values (not read for count), codes and the program's words read
    # once; a head flag, an int64 aggregate and an int32 count written once
    # per row.
    read = n * (8 + (0 if op == "count" else 4) + 4 * f) + program.nbytes
    return {
        "shape": f"{name} {op}", "dims": [n, f], "dtype": "int64 keys, int32 values and codes",
        "codes": program.n_codes, "groups": int(got[0].sum()), "max_abs_err": err,
        "ms": cuda_ms(lambda: combine_segments(keys, v, cols, program, op)),
        "device_ms": device_ms(lambda: combine_segments(keys, v, cols, program, op),
                               ("combine_scan_kernel", "combine_scan_stitch")),
        "device_ms_by": DEVICE_MS_BY[-1],
        "plain_ms": cuda_ms(lambda: combine_scan_ref(keys, vals, cols, *program, op)),
        "bound_ms": (read + n * 13) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
    }


def time_aggregate(name, keys, counts):
    """aggregate_combine against its plain version on sorted (B, n) keys,
    and torch.unique_consecutive + torch.segment_reduce over the flattened
    keys (two calls; float64 data, since segment_reduce takes no integers;
    rows are not kept apart) as a yardstick."""
    import torch
    from repro_torch.kernels.aggregate_combine import combine_blocks, combine_blocks_ref

    got = combine_blocks(keys, counts)
    want = combine_blocks_ref(keys, counts)
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    flat, flat_counts = keys.reshape(-1), counts.reshape(-1).double()

    def two_calls():
        _, lengths = torch.unique_consecutive(flat, return_counts=True)
        return torch.segment_reduce(flat_counts, "sum", lengths=lengths)

    live = int((keys != torch.iinfo(torch.int64).max).sum())
    per_entry = 8 + counts.element_size() + 1 + 8  # key and count read, head and sum written
    count_type = str(counts.dtype).replace("torch.", "")
    return {
        "shape": name, "dims": list(keys.shape), "dtype": f"int64 keys, {count_type} counts",
        "live_keys": live, "groups": int(got[0].sum()), "max_abs_err": err,
        "ms": cuda_ms(lambda: combine_blocks(keys, counts)),
        "device_ms": device_ms(lambda: combine_blocks(keys, counts),
                               ("aggregate_combine_kernel", "aggregate_combine_stitch")),
        "device_ms_by": DEVICE_MS_BY[-1],
        "plain_ms": cuda_ms(lambda: combine_blocks_ref(keys, counts)),
        "bound_ms": keys.numel() * per_entry / HBM_BYTES_PER_S * 1e3,
        "bound_ms_live_keys": live * per_entry / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
        "two_calls_ms": cuda_ms(two_calls),
    }


def combine_inputs(pre, sentinel):
    """The aggregate family's combiner inputs at the end of ingest, as a
    major (K-way then 2-way merge) and a fold increment build them:
    sorted (T, N) keys and their int64 counts."""
    import torch
    from repro_torch.kernels.merge_runs import merge_pair_device, merge_sorted_device

    rk, rc, rn = pre["ag_run_k"], pre["ag_run_c"], pre["ag_run_n"]
    bk, bc, bn = pre["ag_base_k"], pre["ag_base_c"], pre["ag_base_n"]
    t, k, m = rk.shape
    within = torch.arange(m, device=rk.device)[None, None, :] < rn[..., None]
    mk, mc = merge_sorted_device(torch.where(within, rk, sentinel),
                                 torch.where(within[..., None], rc, 0), rn)
    two_k, two_c = merge_pair_device(bk, bc, bn, mk, mc, rn.sum(dim=1, dtype=torch.int32))
    slot = (pre["n_runs"] - 1).clamp(min=0).long()
    tix = torch.arange(t, device=rk.device)
    top_n = rn[tix, slot]
    top = torch.arange(m, device=rk.device)[None, :] < top_n[:, None]
    fold_k, fold_c = merge_pair_device(bk, bc, bn, torch.where(top, rk[tix, slot], sentinel),
                                       torch.where(top[..., None], rc[tix, slot], 0), top_n)
    return {"ag two_way": (two_k, two_c[..., 0].contiguous()),
            "ag fold": (fold_k, fold_c[..., 0].contiguous())}


def aggregate_step_breakdown(store, d, program, dev):
    """Where the device aggregate step's time goes, for spec (a) on the tier
    A filter over the whole range: the step over every level, and on the
    base level alone its filter, its group ids and one of its scatters."""
    import torch
    from repro_torch.core import resolve_grouping
    from repro_torch.core.dist_query import (
        _group_ids, _in_range, _segment_aggregate, aggregate_step)
    from repro_torch.kernels.filter_scan import filter_scan

    g = resolve_grouping(store, agg_specs()["a count/status/hour"], 0, T_SPAN)
    vt = torch.ones(1, dtype=torch.int32, device=dev)
    probe = torch.tensor([0, 1 << 30], dtype=torch.int32, device=dev)
    hit = filter_scan(d.cols, program) & _in_range(d.rev_ts, probe, d.counts)
    gid = _group_ids(d.rev_ts, d.cols, g)
    ones = hit.reshape(-1).to(torch.int64)
    return {
        "groups": g.size, "base_rows": int(hit.numel()),
        "step_ms": cuda_ms(lambda: aggregate_step(d, program, vt, g, 0, 1 << 30)),
        "base_filter_ms": cuda_ms(lambda: filter_scan(d.cols, program)),
        "base_segment_aggregate_ms": cuda_ms(lambda: _segment_aggregate(d.rev_ts, d.cols, hit,
                                                                        g, vt)),
        "base_group_ids_ms": cuda_ms(lambda: _group_ids(d.rev_ts, d.cols, g)),
        "base_index_add_ms": cuda_ms(
            lambda: torch.zeros(g.size, dtype=torch.int64, device=dev).index_add_(0, gid, ones)),
    }


def run_aggregations(store, dq, dev, tiers, domain_counts, pair_counts):
    """Path 3: the host combine_scan scheme and the device aggregate_range
    for every spec on the tier queries and A AND 404. Returns the per-query
    rows and the (lo, hi) of the largest tier-A batch of spec (b)."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.core import Eq, And, QueryProcessor, QueryStats
    from repro_torch.core import merge_aggregate_blocks, resolve_grouping
    from repro_torch.kernels.filter_scan import ops as filter_ops

    qp = QueryProcessor(store, device=dev)
    queries = [(tier, Eq("domain", dom), domain_counts[dom]) for tier, dom in tiers.items()]
    queries.append(("A and 404", And(Eq("domain", tiers["A"]), Eq("status", "404")),
                    pair_counts[(tiers["A"], "404")]))
    rows, largest_a = [], None
    for sname, spec in agg_specs().items():
        grouping = resolve_grouping(store, spec, 0, T_SPAN)
        for label, tree, want in queries:
            stats = QueryStats()
            t0 = time.perf_counter()
            it = qp.run_scheme("combine_scan", 0, T_SPAN, tree, aggregate=spec, stats=stats,
                               _grouping=grouping)
            blocks = [next(it)]
            ttfr = time.perf_counter() - t0
            blocks.extend(it)
            total_s = time.perf_counter() - t0
            host = merge_aggregate_blocks(grouping, blocks)
            if label == "A" and sname.startswith("b"):
                largest_a = max(stats.batch_log, key=lambda b: b[3])[:2]
            row = {"query": label, "spec": sname, "want": want, "groups": host.n_groups,
                   "host": {"ttfr_s": ttfr, "total_s": total_s, "batches": stats.batches,
                            "rows": stats.rows}}
            check(int(host.counts.sum()) == want == stats.rows,
                  f"path 3 {label} {sname}: host counts sum to {host.counts.sum()}, "
                  f"events hold {want}")
            for use_index in (False, True):
                obs.clear()
                st = QueryStats()
                filter_before = filter_ops.launches
                t0 = time.perf_counter()
                res = dq.aggregate_range(spec, tree, 0, T_SPAN, use_index=use_index, stats=st)
                secs = time.perf_counter() - t0
                spans = summarize_spans(obs.get_tracer().records)
                key = "device_index_plan" if use_index else "device_scan_plan"
                steps = sum(spans.get(k, {}).get("n", 0)
                            for k in ("query.aggregate_scan", "query.aggregate_index"))
                check(filter_ops.launches - filter_before == steps,
                      f"path 3 {label} {sname} {key}: filter_scan launched "
                      f"{filter_ops.launches - filter_before} times for {steps} steps")
                row[key] = {
                    "s": secs, "plan": st.plan.describe(), "mode": st.plan.mode,
                    "index_keys_scanned": st.index_keys_scanned,
                    "fell_back": st.plan.mode == "index" and "query.aggregate_scan" in spans,
                    "step_s": sum(v["s"] for k, v in spans.items()
                                  if k.startswith("query.aggregate_")),
                }
                check(same_aggregates(res, host) and res.counts.dtype == np.int64,
                      f"path 3 {label} {sname}: device ({key}) differs from the host")
            log("aggregate", json.dumps(row))
            rows.append(row)
    return rows, largest_a


def summarize_spans(records):
    out = {}
    for r in records:
        s = out.setdefault(r["name"], {"n": 0, "s": 0.0, "fence_s": 0.0})
        s["n"] += 1
        s["s"] += r["dur"]
        s["fence_s"] += r["fence_s"]
    return out


def run_query(dq, scheme, tree, label, want):
    """One scheme run over the 4-hour range, with tracing on: time to the
    first batch and to the last, the plan, the run's QueryStats, and its
    spans. In an index-mode run every query.scan_range span is a batch that
    truncated and fell back to the exact scan. filter_scan must launch once
    per step (each query.scan_range and query.scan_index_range span)."""
    from repro_torch import obs
    from repro_torch.core.dist_query import QueryStats
    from repro_torch.kernels.filter_scan import ops as filter_ops

    obs.clear()
    stats = QueryStats()
    filter_before = filter_ops.launches
    t0 = time.perf_counter()
    it = dq.run_scheme(scheme, 0, T_SPAN, tree, stats=stats)
    first = next(it, None)
    ttfr = time.perf_counter() - t0
    rows = first.count if first is not None else 0
    for blk in it:
        rows += blk.count
    total_s = time.perf_counter() - t0
    spans = summarize_spans(obs.get_tracer().records)
    steps = sum(spans.get(k, {}).get("n", 0)
                for k in ("query.scan_range", "query.scan_index_range"))
    filter_launches = filter_ops.launches - filter_before
    check(filter_launches == steps, f"{label} {scheme}: filter_scan launched "
          f"{filter_launches} times for {steps} steps")
    plan = stats.plan
    q = {
        "query": label, "scheme": scheme, "rows": rows, "want": want, "tree": tree,
        "plan": plan.describe(), "mode": plan.mode, "n_conds": len(plan.index_conds),
        "batches": stats.batches, "steps": steps, "filter_launches": filter_launches,
        "ttfr_s": ttfr, "total_s": total_s,
        "fallbacks": spans.get("query.scan_range", {}).get("n", 0) if plan.mode == "index" else 0,
        "index_keys_scanned": stats.index_keys_scanned,
        "density_s": spans.get("query.density", {}).get("s", 0.0),
        "scan_index_range_s": spans.get("query.scan_index_range", {}).get("s", 0.0),
        "scan_range_s": spans.get("query.scan_range", {}).get("s", 0.0),
        "spans": spans, "batch_log": stats.batch_log,
    }
    log("query", json.dumps({k: v for k, v in q.items()
                             if k not in ("tree", "spans", "batch_log")}))
    return q


def run_main_path(seed, dev, size=MAIN_PATH):
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core.dist_ingest import REV_PAD, KEY_PAD64, DistBatchWriter, DistIngestPlane
    from repro_torch.core.dist_query import (
        DistQueryProcessor,
        _combine_postings,
        _expand_level,
        _posting_slabs,
    )
    from repro_torch.core.filter import And, Eq, In, Not, Or
    from repro_torch.core.planner import plan_query
    from repro_torch.core.schema import web_proxy_schema
    from repro_torch.core.store import EventStore
    from repro_torch.kernels.aggregate_combine import ops as aggregate_ops
    from repro_torch.kernels.combine_scan import ops as combine_ops
    from repro_torch.kernels.filter_scan import ops as filter_ops
    from repro_torch.kernels.merge_intersect import ops as intersect_ops
    from repro_torch.kernels.merge_runs import ops as merge_ops
    from repro_torch.pipeline.sources import SyntheticWebProxySource, parse_web_proxy_lines

    kernel_ops = {"merge_runs": merge_ops, "filter_scan": filter_ops,
                  "merge_intersect": intersect_ops, "combine_scan": combine_ops,
                  "aggregate_combine": aggregate_ops}

    def zero_launches():
        for ops in kernel_ops.values():
            ops.launches = 0

    def read_launches():
        return {name: ops.launches for name, ops in kernel_ops.items()}

    report = {}
    events, chunk = size["events"], size["chunk"]
    source = SyntheticWebProxySource(seed=seed)
    # Schema and dictionaries for the writer; path 3 fills its tablets with
    # the events as the writer encoded them (kept here, not encoded twice).
    store = EventStore(web_proxy_schema())
    encoded = []
    encode = store.encode_events

    def encode_and_keep(ts, values):
        cols = encode(ts, values)
        encoded.append((np.asarray(ts), cols))
        return cols

    store.encode_events = encode_and_keep
    plane = DistIngestPlane.for_store(
        store, capacity=size["capacity"], n_tablets=size["tablets"], mem_rows=size["mem_rows"],
        max_runs=size["max_runs"], append_rows=1024, device=dev)
    writer = DistBatchWriter(store, plane, batch_rows=chunk, writer_id=0)
    torch.cuda.reset_peak_memory_stats(dev)
    domain_counts = Counter()
    pair_counts = Counter()

    zero_launches()  # path 1: ingest and scans
    obs.enable()
    obs.clear()
    ingest_s = 0.0
    for off in range(0, events, chunk):
        n = min(chunk, events - off)
        ts, vals = parse_web_proxy_lines(source.gen_lines(n, 0, T_SPAN))
        domain_counts.update(vals["domain"])
        pair_counts.update(zip(vals["domain"], vals["status"]))
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
    # One aggregate-family combine per major and per fold increment.
    combines = ingest_spans.get("ingest.major", {}).get("n", 0) + sum(
        1 for r in obs.get_tracer().records
        if r["name"] == "ingest.fold_increment" and r["args"].get("kind") == "fold")
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
    eq = {tier: Eq("domain", dom) for tier, dom in tiers.items()}
    queries = []
    for tier in tiers:
        for scheme in ("scan", "batched_scan"):
            queries.append(run_query(dq, scheme, eq[tier], tier, domain_counts[tiers[tier]]))
    # A program far past shared memory: domain = A AND bytes_in IN 300,000
    # of the dictionary's codes (of its about a million; fewer on a small
    # rehearsal), counted in the events as the writer encoded them.
    bdict = store.dictionaries["bytes_in"]
    n_in = min(300_000, len(bdict) // 2)
    in_codes = np.sort(np.random.default_rng(seed + 2).choice(len(bdict), n_in, replace=False))
    in_values = tuple(bdict.decode(int(c)) for c in in_codes)
    dfid, bfid = store.schema.field_id("domain"), store.schema.field_id("bytes_in")
    a_code = store.dictionaries["domain"].lookup(tiers["A"])
    want_big = sum(int(((cols[:, dfid] == a_code) & np.isin(cols[:, bfid], in_codes)).sum())
                   for _, cols in encoded)
    big_in = And(eq["A"], In("bytes_in", in_values))
    for scheme in ("scan", "batched_scan"):
        queries.append(run_query(dq, scheme, big_in, f"A and bytes_in in {n_in:,}", want_big))
    launches_1 = read_launches()
    log("launches", "path 1 (ingest and scans): " + json.dumps(launches_1))
    check(launches_1["merge_runs"] > 0 and launches_1["filter_scan"] > 0
          and launches_1["aggregate_combine"] > 0,
          f"a kernel of path 1 never launched: {launches_1}")
    check(launches_1["aggregate_combine"] == combines,
          f"aggregate_combine launched {launches_1['aggregate_combine']} times on path 1, "
          f"for {combines} majors and fold increments")

    # Path 2: density planning and the index schemes on the same snapshot.
    zero_launches()
    ands = {tier: And(eq[tier], Eq("status", "404")) for tier in ("A", "B")}
    b_or_c = Or(eq["B"], eq["C"])
    for tier in tiers:
        for scheme in ("index", "batched_index"):
            queries.append(run_query(dq, scheme, eq[tier], tier, domain_counts[tiers[tier]]))
    for tier, tree in ands.items():
        for scheme in SCHEMES:
            queries.append(run_query(dq, scheme, tree, f"{tier} and 404",
                                     pair_counts[(tiers[tier], "404")]))
    for scheme in ("index", "batched_index"):
        queries.append(run_query(dq, scheme, b_or_c, "B or C",
                                 domain_counts[tiers["B"]] + domain_counts[tiers["C"]]))
    launches_2 = read_launches()
    log("launches", "path 2 (density and index): " + json.dumps(launches_2))
    check(launches_2["merge_intersect"] > 0 and launches_2["filter_scan"] > 0,
          f"a kernel of path 2 never launched: {launches_2}")

    # Path 3: scan-time aggregation, host and device, on the same snapshot.
    store.encode_events = encode
    t0 = time.perf_counter()
    for ts, cols in encoded:
        store.ingest_encoded(ts, cols)
    store.flush_all()
    store.compact_all()
    host_setup_s = time.perf_counter() - t0
    encoded.clear()
    log("aggregate", f"host EventStore(n_shards={store.n_shards}) filled with {store.total_rows} "
        f"events, flushed and compacted in {host_setup_s:.3f} s (set-up, untimed)")
    zero_launches()
    agg_rows, largest_a = run_aggregations(store, dq, dev, tiers, domain_counts, pair_counts)
    launches_3 = read_launches()
    obs.disable()
    log("launches", "path 3 (aggregation): " + json.dumps(launches_3))
    check(launches_3["combine_scan"] > 0 and launches_3["filter_scan"] > 0
          and launches_3["merge_intersect"] > 0, f"a kernel of path 3 never launched: {launches_3}")
    report["aggregation"] = {"host_setup_s": host_setup_s, "queries": agg_rows}
    launches = {k: launches_1[k] + launches_2[k] + launches_3[k] for k in launches_1}
    report["launches"] = {"total": launches, "path_1": launches_1, "path_2": launches_2,
                          "path_3": launches_3}

    d = dq.dist
    densities = {}
    for tier, dom in tiers.items():
        densities[tier] = dq.agg_count("domain", dom, 0, T_SPAN)
        check(densities[tier] == domain_counts[dom],
              f"device density of tier {tier} ({dom}): {densities[tier]}, events hold "
              f"{domain_counts[dom]}")
    n404 = sum(c for (_, st), c in pair_counts.items() if st == "404")
    densities["status=404"] = dq.agg_count("status", "404", 0, T_SPAN)
    check(densities["status=404"] == n404, f"device density of status=404: "
          f"{densities['status=404']}, events hold {n404}")
    report["densities"] = densities
    log("density", json.dumps(densities) + " equal the generated counts")
    for q in queries:
        if q["query"].endswith("and 404") and q["scheme"].endswith("index"):
            check(q["mode"] == "index" and q["n_conds"] == 2,
                  f"{q['query']} planned {q['plan']}, not two index conditions")
    plain = {}
    scan_rows = {q["tree"]: q["rows"] for q in queries if q["scheme"] == "scan"}
    for q in queries:
        if q["tree"] not in plain:
            plain[q["tree"]] = plain_scan_count(d, program_tensors(store, q["tree"], dev),
                                                0, T_SPAN)
        want_scan = scan_rows.get(q["tree"], plain[q["tree"]])  # B or C runs no scan
        check(q["rows"] == q["want"] == plain[q["tree"]] == want_scan,
              f"{q['query']} {q['scheme']}: {q['rows']} rows, events hold {q['want']}, "
              f"plain versions count {plain[q['tree']]}, the scan scheme {want_scan}")
    log("check", "every scheme's total equals the generated events' count, the scan "
        "scheme's total and the plain versions' scan of the same snapshot on the card")
    for q in queries:
        q.pop("tree")
    report["queries"] = queries

    # Each kernel against its plain version at the main path's shapes.
    merge_rows = []
    for fam, sentinel in (("ev", REV_PAD), ("ix", KEY_PAD64), ("ag", KEY_PAD64)):
        rc = pre[f"{fam}_run_c"]
        for stage, inputs in merge_inputs(pre, fam, sentinel).items():
            keys = inputs[0]
            payload = torch.zeros((*keys.shape, rc.shape[-1]), dtype=rc.dtype, device=dev)
            row = time_merge(f"{fam} {stage}", *inputs, payload)
            del payload
            merge_rows.append(row)
            log("kernel", json.dumps({"name": "merge_runs", **row}))
    dom_a = tiers["A"]
    program = program_tensors(store, Eq("domain", dom_a), dev)
    rich = program_tensors(store, Or(Eq("domain", dom_a), Not(In("status", ("200", "404"))),
                                     In("method", ("PUT", "HEAD", "never-seen"))), dev)
    filter_rows = [time_filter("fused step: base + runs + memtable",
                               [cols for _, cols, _ in d.ev_levels()], program, rich)]
    for name, cols in (("base (T,R,F)", d.cols), ("runs (T,K,M,F)", pre["ev_run_c"]),
                       ("memtable (T,M,F)", pre["ev_mem_c"])):
        filter_rows.append(time_filter(name, cols, program, rich))
    # Big sets on the base: 3,000, 12,000 and 30,000 codes (12, 48 and 120
    # KB), each timed staged whole in shared memory (the last two in the
    # opt-in shared memory) and with its codes in global memory, which
    # sets SHARED_PROGRAM_BYTES; and 300,000 (past shared memory, searched
    # in global memory).
    for step in (100, 25, 10):
        prog = program_tensors(store, In("bytes_in", in_values[::step]), dev)
        filter_rows.append(time_filter(f"base In(bytes_in, {prog.n_codes:,} codes)", d.cols,
                                       prog, both_placements=True))
    in_300k = program_tensors(store, In("bytes_in", in_values), dev)
    filter_rows.append(time_filter(f"base In(bytes_in, {n_in:,} codes)", d.cols, in_300k))
    for row in filter_rows:
        log("kernel", json.dumps({"name": "filter_scan", **row}))
    # The index step's inputs for the AND-B batch that expanded the most
    # rows: the posting slabs merge_intersect probes, and the base level's
    # candidate rows filter_scan re-checks.
    and_b = next(q for q in queries if q["query"] == "B and 404" and q["scheme"] == "batched_index")
    lo_t, hi_t, _, _ = max(and_b["batch_log"], key=lambda b: b[3])
    plan = plan_query(dq, ands["B"], 0, T_SPAN, w=dq.w)
    lo, hi = (torch.from_numpy(x).to(dev) for x in dq._cond_ranges(plan, int(lo_t), int(hi_t)))
    slabs, _ = _posting_slabs(d, lo, hi, dq.index_postings)
    cand, live = _combine_postings(slabs, plan.combine)
    _, r_cols, _, _, _ = _expand_level(cand, live, d.rev_ts, d.cols, d.counts, dq.index_rows)
    _, r_runs, _, _, _ = _expand_level(cand, live, d.run_rev_ts, d.run_cols, d.run_counts,
                                       dq.index_rows)
    _, r_mem, _, _, _ = _expand_level(cand, live, d.mem_rev_ts, d.mem_cols, d.mem_counts,
                                      dq.index_rows)
    for name, levels in (("index candidates (T,max_rows,F)", r_cols),
                         ("fused index step: candidates of base + runs + memtable",
                          [r_cols, r_runs, r_mem])):
        row = time_filter(name, levels, program_tensors(store, ands["B"], dev), rich)
        filter_rows.append(row)
        log("kernel", json.dumps({"name": "filter_scan", **row}))
    rng = np.random.default_rng(seed)
    syn_b = np.sort(rng.integers(0, 2**53, slabs[:, 0].shape), axis=1)
    syn_a = np.where(rng.random(syn_b.shape) < 0.5,
                     np.take_along_axis(syn_b, rng.integers(0, syn_b.shape[1], syn_b.shape), 1),
                     rng.integers(0, 2**53, syn_b.shape))
    intersect_rows = []
    for name, a, b in (("AND-B batch (T,S) int32", slabs[:, 0].contiguous(),
                        slabs[:, 1].contiguous()),
                       ("synthetic (T,S) int64", torch.from_numpy(syn_a).to(dev),
                        torch.from_numpy(syn_b).to(dev))):
        row = time_intersect(name, a, b)
        intersect_rows.append(row)
        log("kernel", json.dumps({"name": "merge_intersect", **row}))
    report["and_b_batch"] = {"lo": lo_t, "hi": hi_t, "plan": plan.describe()}

    # combine_scan on the largest tier-A batch of path 3 (spec b), sorted by
    # group as the CombinerIterator sorts it, and on a synthetic straddle.
    from repro_torch.core import keypack as kp, resolve_grouping
    from repro_torch.core.scan import scan_events

    spec_b = agg_specs()["b sum bytes_in/method/hour"]
    lo_t, hi_t = largest_a
    blocks = list(scan_events(store, int(lo_t), int(hi_t)))
    keys = np.concatenate([b.keys for b in blocks])
    cols = np.concatenate([b.cols for b in blocks])
    grouping = resolve_grouping(store, spec_b, 0, T_SPAN)
    gids = grouping.group_ids(kp.unrev_ts(kp.unpack_event_key(keys)[1]), cols)
    order = np.argsort(gids, kind="stable")
    batch = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             for x in (gids[order], grouping.values(cols)[order], cols[order])]
    combine_rows = [time_combine("tier-A batch", *batch, program, op) for op in OPS]
    combine_rows.append(time_combine(f"tier-A batch In(bytes_in, {n_in:,} codes)", *batch,
                                     in_300k, "sum"))
    n_syn = 1 << 20
    syn_gids = np.sort(rng.integers(0, 4000, n_syn))
    syn_gids[n_syn // 2:] = 4000  # one group over the last 1024 tiles of 512 rows
    syn_cols = np.zeros((n_syn, store.schema.n_fields), np.int32)
    sfid = store.schema.field_id("status")
    syn_cols[:, sfid] = store.dictionaries["status"].lookup("404")
    syn_cols[::2, sfid] = store.dictionaries["status"].lookup("200")
    syn = [torch.from_numpy(x).to(dev) for x in
           (syn_gids.astype(np.int64), rng.integers(0, 1 << 20, n_syn).astype(np.int32), syn_cols)]
    syn_prog = program_tensors(store, Eq("status", "200"), dev)
    combine_rows += [time_combine("synthetic straddle", *syn, syn_prog, op) for op in OPS]
    for row in combine_rows:
        log("kernel", json.dumps({"name": "combine_scan", **row}))
    report["tier_a_batch"] = {"lo": lo_t, "hi": hi_t, "rows": int(len(keys))}

    # aggregate_combine at the aggregate family's combiner inputs, and an
    # int32 combine_sorted_counts case.
    aggregate_rows = []
    for name, (k, c) in combine_inputs(pre, KEY_PAD64).items():
        aggregate_rows.append(time_aggregate(name, k, c))
    ck = torch.from_numpy(np.sort(rng.integers(0, 1 << 20, 1 << 22)))[None].to(dev)
    cc = torch.from_numpy(rng.integers(1, 100, (1, 1 << 22)).astype(np.int32)).to(dev)
    aggregate_rows.append(time_aggregate("combine_sorted_counts int32", ck, cc))
    for row in aggregate_rows:
        log("kernel", json.dumps({"name": "aggregate_combine", **row}))
    report["aggregate_step"] = aggregate_step_breakdown(store, d, program, dev)
    log("aggregate", "device aggregate step on the base (spec a, tier A): "
        + json.dumps(report["aggregate_step"]))
    for rows in (merge_rows, filter_rows, intersect_rows, combine_rows, aggregate_rows):
        for row in rows:
            check(row["max_abs_err"] == 0, f"kernel disagrees with its plain version: {row}")

    def summary(name, route, src, replaces, rows, main_shape):
        top = next(r for r in rows if r["shape"] == main_shape)
        return {
            "name": name, "route": route, "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": top["ms"], "device_ms": top["device_ms"], "device_ms_by": top["device_ms_by"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "shape": main_shape, "shapes": rows,
        }

    kernels = [
        summary("merge_runs", "cuda", MERGE_SRC, MERGE_REPLACES, merge_rows, "ix two_way"),
        summary("filter_scan", "cuda", FILTER_SRC, FILTER_REPLACES, filter_rows,
                "fused step: base + runs + memtable"),
        summary("merge_intersect", "cuda", INTERSECT_SRC, INTERSECT_REPLACES, intersect_rows,
                "AND-B batch (T,S) int32"),
        summary("combine_scan", "cuda", COMBINE_SRC, COMBINE_REPLACES, combine_rows,
                "tier-A batch sum"),
        summary("aggregate_combine", "cuda", AGGREGATE_SRC, AGGREGATE_REPLACES, aggregate_rows,
                "ag two_way"),
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
    report.update(device=kind, nvidia_smi=smi, seed=args.seed, torch=torch.__version__,
                  device_ms_by=dict(Counter(DEVICE_MS_BY)))
    log("kernel", "device_ms taken by " + json.dumps(report["device_ms_by"]))
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
