#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path once on the card.

    python3 chip_smoke.py [--seed N]

What it runs, in order, and what makes it fail (exit code other than 0,
no result line):

  build      nvcc builds src/repro_torch/kernels/csrc/*.cu for sm_90a
             (one process per source, in parallel) into build/; among
             them merge_ranks_search.cu, merge_runs' earlier design, which
             the kernel rows time beside the merge-path kernel.
  lint       repro_torch.analysis over src/repro_torch against the port's
             baseline (analysis/baseline.json): one [lint] line with the
             files scanned, the rules, fresh, baselined and stale findings
             and the seconds; fails on any fresh finding, stale baseline
             entry or parse error.
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
  main path  thirteen paths at full size, each with every kernel launch
             count zeroed just before it and read just after:
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
             aggregate_combine must launch on path 1 twice per major and
             per fold increment (combine_compact, the index family's dedup
             and the aggregate family's combiner), and
             filter_scan exactly once per scan, index or aggregate step
             on every path (one launch filters every LSM level).
             4. the sharded plane: the same events, encoded once before
                any timed region, through W = 4 writer threads (writer i
                takes every fourth 65,536-event chunk and routes each row
                by DistBatchWriter's row hash with writer_id=i) into a
                fresh plane of G = 1 and then of G = 4 tablet groups (16
                tablets each, a lock each), and as a control by one thread
                into G = 4, timed from the threads' start to the last join; rows/s, blocked seconds per writer, each
                group lock's held and wait seconds, majors, peak memory
                and launches per run. Each plane is drained with
                compact_step (on G = 4 a publish after the first increment
                must give the three untouched groups' snapshots as the same
                objects); the per-tablet rows of G = 1 and G = 4 must be
                equal; on the G = 4 composite snapshot every scheme's total
                for the tiers, A AND 404 and A AND bytes_out < 1000 must
                equal paths 1-2, and aggregate_range specs (a) and (c) path
                3's results bit for bit. aggregate_combine must launch
                exactly twice per major and fold increment under the
                threads. Last, from_event_store replays the host store into
                a base-only snapshot of 64 tablets whose scan and
                batched_scan totals, and execute_batched's over more than
                one batch, must equal paths 1-2.
             5. the serve plane (repro_torch.serve_db) on path 4's threaded
                G = 4 plane, drained: one QueryService (dispatcher and
                background compactor) and a /metrics endpoint on
                127.0.0.1. 5a: S = 4 dist sessions on threads each run the
                mix (the four schemes on tiers A, B, C and on A AND 404,
                both index schemes on B OR C, spec (a) on tier B, one
                density per tier) once with flight recording and tracing
                off and once with flight recording on, the second beside a
                host-backend session's spec (a) on tier C; every count
                equals paths 1-2's, every aggregate path 3's bit for bit,
                every density the generated count. 5b: W = 2
                DistBatchWriter threads append 524,288 fresh events
                (SyntheticWebProxySource(seed + 1), 128 chunks of 4,096,
                encoding included) while the sessions run the mix 3 times;
                the writers are paced by the sessions' submits (chunk j
                starts once j/127 of the 264 queries were submitted), so
                every query is submitted before the last writer closes,
                which is checked; each session's tier-A batched_scan
                counts never fall, and every count lies between 5a's and
                the final one. 5c: after
                the writers close, each tier's batched_scan and A AND 404's
                batched_index return 5a's count plus the appended events';
                the compactor drains the plane; fold sources are ingest,
                background and explicit only; every session is in the
                plane's telemetry; one /metrics scrape parses and counts
                every first result; every first result's profile stages
                sum to within 5% of its TTFR (of 1 ms for a TTFR under
                1 ms). aggregate_combine must
                launch exactly twice per major and fold increment of path
                5, and every kernel at least once. Then `python -m
                repro_torch.serve_db` runs in-process on the card with a
                tight TTFR SLO and must leave an incident bundle whose
                trace validates. It prints TTFR p50/p99 per scheme with
                the collector's seconds in the TTFR windows, queries/s,
                ingest rows/s while serving, queue wait, the device lock's
                held seconds by owner, the compactor's increments and the
                flight-on against both-off seconds.
             6. the ingest pipeline, at the reference's own deployment
                (configs/llcysa.py PIPELINE: 8 shards, flush_rows 32,768,
                max_runs 8, 3,600 s buckets, batch_rows 4,096): 64 files
                of 16,384 lines (1,048,576 events over 4 hours,
                SyntheticWebProxySource(seed + 3)) are staged under
                build/ (set-up, untimed), then ingested by an
                IngestWorkerPool of W = 4 workers and, as the control, of
                W = 1 into fresh host EventStores on the card (their minor
                sorts, majors and combiner run there), each under a
                torch.profiler window (CUDA activity only). Each reports
                rows/s and MB/s per worker, blocked seconds, the
                compactions (backpressure_stats), the rate_series p50 and
                p99, and merge_runs' launches and device ms; every file
                must complete once, the store hold 1,048,576 rows, and
                merge_runs launch exactly once per major of any tablet
                (every run is non-empty, so every major merges two or
                more). The host QueryProcessor on the card runs the four
                schemes on tiers A, B, C and A AND 404 of the W = 4 store:
                the scan schemes' totals must equal the staged lines'
                counts; the index schemes' must equal the same scheme run
                by a QueryProcessor on the CPU, and differ from the staged
                counts by no more than the rows whose event key (16-bit
                hash) another row of their shard shares (the index fetches
                one row per key and run, as the reference does); spec
                (a)'s total must equal the staged count, and its groups the
                W = 1 store's, decoded. EventTokenizer(vocab 32,768).sequences gives 32
                sequences of 8 events (112 tokens) in [0, 32,768), 14
                tokens an event. filter_scan, merge_intersect,
                combine_scan and merge_runs must launch.
             7. the analytics LM's serve path: llcysa-analytics-100m at
                full width (12 layers, d_model 768, 12 heads, d_ff 2,048,
                vocab 32,768) in bf16 from a seeded init, behind
                ServeEngine (max_batch 8, cache_len 256; after a 2-request
                warm-up) answering 32 requests of path 6's sequences with
                16 new tokens each: every request finishes with 16 tokens
                in range; TTFT p50/p95, end-to-end p50, decode tokens/s
                and peak memory are reported. In float32 on the same
                weights, each of 16 greedy decode steps' logits must agree
                with a prefill over the prompt plus the tokens generated
                so far within 2e-3 (tests/test_models.py's bound); the
                per-hour NLL of examples/cyber_pipeline.py step 5 must be
                finite. The LM has no kernel of its own: its launches are
                read and reported.
             8. the analytics LM's training path: llcysa-analytics-100m at
                full width in bf16 (seeded init, float32 Adam state)
                through build_train_step with remat at train_4k's sequence
                length, S = 4,096, for 20 steps of OptConfig(lr 1e-3,
                warmup 5, total 20); the global batch is 16 sequences of
                path 6's tokens (EventTokenizer.sequences(0, 4 h,
                seq_len 4,097, batch 16) on the W = 4 store) as 4
                microbatches of 4, cut from train_4k's 256 to fit the
                run's time. It reports the loss at every step, step ms
                with host dispatch (median of steps 2-20 without the
                profiled one), one step's device ms in a torch.profiler
                window, tokens/s, peak memory over steps 1-10 and model
                FLOPs per step (6 N per token plus the causal attention's,
                with and without the remat recompute) as a share of the
                dense bf16 peak. The steps run under
                torch.use_deterministic_algorithms. Checks: every loss
                finite and the last below 0.9 x the first; a
                CheckpointManager save after step 10 restores on the card
                (parameters and optimizer state) bit for bit with dtypes,
                and two steps resumed from it equal the uninterrupted
                steps 11-12 bit for bit; two compress_grads steps (4
                sequences as 2 microbatches) give finite losses and a
                non-zero error tree; the flash backward at one
                (1, 4,096, 12, 64) float32 sequence agrees with autograd
                of the naive attention within atol 1e-4 + rtol 1e-3. It
                has no kernel of its own either.
             9. the LM's attention-side families. 9a: gemma2-9b at full
                width and depth (42 layers as 21 local/global pairs,
                d_model 3,584, 16 heads over 8 KV heads of 256, d_ff
                14,336, vocab 256,000, bf16, seeded init on a CUDA
                generator) behind ServeEngine (max_batch 8, cache_len
                256; after a 2-request warm-up) answering path 7's 32
                requests with 16 new tokens each: every request finishes
                with 16 tokens in range, and the weights count within 2%
                of the config's; TTFT p50/p95, end-to-end p50, decode
                tokens/s, one decode step of the 8 slots and one prefill
                with dispatch and on the device, the decode step's device
                time by kernel, and peak memory are reported. The model
                is freed before 9b. 9b: for each of gemma2-9b, gemma3-12b,
                internlm2-20b, qwen1.5-4b, musicgen-medium and
                llama-3.2-vision-11b, one pattern period (at least two
                layers: 2, 6, 2, 2, 2 and 5) at full width in float32 from
                a seeded init (the cross gates set to 0.5, so the cross
                layer counts), a prompt prefilled once, then 16 decode
                steps (greedy tokens; musicgen seeded frame embeddings;
                llama-vision on seeded vision states of (1, 1,601, 4,096)),
                each step's logits within 2e-3 of a prefill over the
                inputs so far. gemma2's prompt of 4,160 tokens (cache_len
                4,224) and gemma3's of 1,100 (cache_len 1,152) must wrap
                their local rings (windows 4,096 and 1,024). 9c: gemma2's
                local attention's flash backward at (1, 4,096, 16, 256)
                float32, window 1,024, soft-cap 50, scale 1/16, against
                autograd of the naive attention within atol 1e-4 + rtol
                1e-3. No kernel of the port's own runs on path 9.
            10. the LM's MoE and SSM families. 10a: moonshot-v1-16b-a3b at
                full width and depth (48 layers, d_model 2,048, 16 heads,
                64 experts of d_ff 1,408, top-6, vocab 163,840, bf16;
                28,057,995,264 parameters from a seeded init on a CUDA
                generator, drawn a group's slice at a time) behind
                ServeEngine with path 9a's traffic, warm-up and timers
                (the free device memory is logged before it); the timed
                decode step is the engine's first round of 8 prompts,
                each prefilled into its slot, and its read bound counts
                attention, norms, the KV caches, the embedding rows,
                lm_head, the routers and the experts the router picks in
                each layer that step (distinct ids) over 3.35 TB/s.
                10b: zamba2-2.7b uncut (54 layers: 45 Mamba2 blocks and 9
                applications of the shared attention block, d_model 2,560,
                bf16) the same way, path 6's token ids taken modulo its
                vocabulary of 32,000 (the tokenizer's is 32,768); its pool
                holds the SSM state, the conv tail and each application's
                K/V. The device ms of 10a and 10b come from profiler
                windows of 3 calls. 10c: float32 decode
                against prefill for moonshot-v1-16b-a3b, phi3.5-moe-42b-
                a6.6b and mamba2-780m at 2 layers and zamba2-2.7b at one
                pattern period (6), full width, batch 1: MoE at capacity
                factor 16 (no token drops) on 112-token prompts
                (cache_len 128), SSM on 600-token prompts (cache_len 640:
                three chunks of 256, the last padded), 16 greedy decode
                steps, each within 2e-3 of a prefill over the tokens so
                far. No kernel of the port's own runs on path 10.
            11. the distribution layer. 11a: a one-rank NCCL process group
                (destroyed after) and a (data=1, model=1) DeviceMesh of the
                card; llcysa-analytics-100m at full width and depth through
                launch/steps.py's mesh builders in float32 from a seeded
                init: two train steps of 4 x 4,096 seeded tokens with ZeRO-1
                and sequence parallelism, one prefill of 8 of path 7's
                prompts into caches of 256, and 16 greedy decode steps,
                each against the meshless step on the same parameters and
                inputs (loss and grad norm within rtol 1e-5, logits within
                rtol 1e-5 / atol 1e-5, greedy tokens equal); then each step
                in bf16 with the mesh and without: ms with host dispatch
                (the median of 3 calls, 16 for decode) and device ms (one
                call in a profiler window), and their difference, DTensor's
                overhead on one rank. 11b, beside 11a in a subprocess with
                CUDA hidden: launch/dryrun.py's gemma2-9b train_4k and
                moonshot-v1-16b-a3b decode_32k on the single-pod mesh (256
                ranks) and mamba2-780m long_500k on the multi-pod mesh (512),
                traced on a fake process group under FakeTensorMode: the
                per-device peak, FLOPs, HBM bytes and collective bytes by
                op, the three roofline terms on the H100 data sheet's rates
                and the bottleneck; each cell's parameter bytes per device
                must equal its spec tree's shards', and the train cell must
                have collectives. No kernel of the port's own runs on path
                11.
            12. the store on a mesh: a one-rank NCCL process group
                (destroyed after) and a (data=1, model=1) DeviceMesh of the
                card; path 4's 4,194,304 pre-encoded, pre-hashed rows
                appended serially (every writer's chunks in the order they
                were cut) into a meshless plane of 64 tablets and into a
                mesh plane of tablets_per_device 64 (capacity 131,072,
                mem_rows 4096, max_runs 4), each timed. The two states must
                be equal tensor for tensor with dtypes, and so the
                published levels; scan_step on the tiers, A and B AND 404,
                B OR C, A AND bytes_out < 1000, Match(domain, "d0000"),
                bytes_in >= 1,000,000 and A AND bytes_in IN 300,000 codes,
                index_step on those the planner plans by index,
                density_step on the tiers and status=404, and
                aggregate_step and index_aggregate_step for specs (a), (b)
                and (c) on the tiers and A AND 404, over the 4-hour range,
                must return the same tensors with the mesh and without, bit
                for bit; run_scheme's first batch (range, count, rows) and
                total must be equal for the four schemes on the tiers and A
                AND 404. merge_runs, filter_scan, merge_intersect and
                aggregate_combine must launch. Beside these checks, in a
                subprocess with CUDA hidden, launch/dryrun.py's two store
                cells (run_store_cell: one rank's scan step of 4,000,000
                rows a tablet on the single-pod and multi-pod meshes, on a
                fake process group) must have argument bytes per device
                equal to the slabs' (4,000,000 x (4 + 4 x 12) + 4) and
                collectives. Then each step (the first case of each of the
                five) is timed with the mesh and without: ms with dispatch
                (cuda_ms) and device ms (device_ms over every CUDA
                activity, NCCL's included), in turns meshless, mesh, mesh,
                meshless. [store-mesh] lines, and the peak allocated
                memory with both planes.
            13. the serve plane and threaded writers on a mesh, in path
                12's process group and mesh: the plane is built with a
                control log (core/spmd.py; rank 0 the controller, here the
                only rank). 13a: path 4's 4,194,304 pre-encoded rows by W =
                4 writer threads into a mesh plane of G = 4 groups at path
                4's sizes (the full 3.3 GB plane); rows conserved, drained
                with compact_step, the four schemes' totals on the tiers
                and A AND 404 equal to paths 1-2 (path 4's G = 4 plane
                gives the same); rows/s beside path 4's G = 4 x 4-thread
                rate. 13b: path 5's traffic on that plane: S = 4 sessions
                run the mix once (counts equal paths 1-2, the aggregate
                path 3's bit for bit, densities the generated counts), then
                SERVE_MESH_ROUNDS rounds while W = 2 writers re-send path
                5b's own events paced as in 5b (counts bounded, tier-A
                batched_scan never falls per session), then the tiers' and
                A AND 404's counts equal 5a's plus the appended rows; the
                compactor drains the plane and close() sends the log's stop
                record. TTFR p50/p99 per scheme, queries/s and ingest
                rows/s while serving are printed beside path 5's, and the
                log's records by kind and bytes sent. 13c: `python -m
                repro_torch.serve_db --mesh dev` in-process in the same
                group, as path 5's daemon run. [serve-mesh] lines.
                merge_runs, filter_scan, merge_intersect and
                aggregate_combine must launch.
             Paths 1-3 also run the Cmp and Match filter nodes:
             domain = A AND bytes_out < 1000 on all four schemes and on
             path 3 with spec (a), Match(domain, "d0000") (the ten most
             popular domains) on the scan schemes, and bytes_in >=
             1,000,000 (nearly all 48,576 values of [10^6, 2^20)) on scan.
  kernels    each kernel against its plain version on the card at the
             main path's shapes (merge_runs: the K-way and 2-way stages of
             a major and the incremental fold, for the ev, ix and ag
             families, with the earlier design's time beside, and the ix
             and ag 2-way and fold at one group's shape of path 4, 16
             tablets, and at the host store's major shape of path 6: a
             first major's 9 runs of 32,768 index keys, and index tablet
             0's base and runs; filter_scan:
             the fused scan step over base, runs and memtable, each level
             alone, the index step's candidate rows alone and fused, and
             on the base In(bytes_in) sets of 3,000, 12,000 and 30,000
             codes staged in shared memory and with their codes in global
             memory (answered from its bitmap where it has one), and of
             300,000 codes (a bitmap); merge_intersect: the posting
             slabs of one AND-B batch (sorted probes), and an int64 case
             with unsorted probes; combine_scan, in its group form
             (combine_groups, the host op's) and its per-row form
             (combine_segments): all four ops on the largest tier-A
             batch of path 3, its sum with the 300,000-code program, and
             on 1,048,576 synthetic rows with one group over many strips
             and a filter that rejects half its rows; aggregate_combine: combine_compact on
             the index and aggregate families' 2-way major and fold
             inputs, each also against the earlier path (the
             combine_blocks kernel and PyTorch passes, composed here),
             which it must match bit for bit and which is timed beside it,
             and at one group's shape, and combine_blocks on an int32
             combine_sorted_counts case),
             with the error computed from the
             compared tensors (it must be 0), the kernel's time (cuda_ms:
             CUDA events around back-to-back calls, host dispatch
             included) and its device time alone (device_ms: a
             torch.profiler window), its bound, the plain version's time
             and, where one PyTorch call
             computes the same function, that call's time (a stable
             torch.sort for merge_runs, torch.isin for merge_intersect;
             none for combine_scan and aggregate_combine, whose
             combine_blocks row also records torch.unique_consecutive +
             torch.segment_reduce as a two-call yardstick).

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


def device_ms(fn, names, calls=10, per_call=1):
    """The named kernels' own device time per fn() call, in ms.

    First a torch.profiler window over ``calls`` calls (CUDA activity
    only): the time of every device kernel or memset whose name holds one
    of ``names``, summed and divided by the calls. On the H100 runs so far
    the profiler now and then reported no device events for a window, or
    dropped some of them; a window must hold ``per_call`` of them (the
    named launches of one call) for every call. When two windows in a row
    hold fewer it falls back to queued_device_ms (CUDA events around the
    calls queued behind a spin kernel, so no host gap enters). Each row
    names its method beside the number."""
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
        if len(us) >= calls * per_call:
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

    if x.device != y.device:
        x, y = x.cpu(), y.cpu()
    return torch.equal(x, y)


def run_lint():
    """The port's static analysis (repro_torch.analysis) over src/repro_torch
    with the port's baseline. Prints one [lint] line and fails on any fresh
    finding, stale baseline entry or parse error. Returns the line's
    numbers."""
    from repro_torch.analysis import (all_rules, collect_files, load_baseline, render_text,
                                      run_analysis)
    from repro_torch.analysis.engine import default_baseline_path

    root = os.path.join(ROOT, "src", "repro_torch")
    t0 = time.perf_counter()
    res = run_analysis([root], baseline=load_baseline(default_baseline_path()))
    secs = time.perf_counter() - t0
    stats = dict(files=len(collect_files([root])), rules=[r.name for r in all_rules()],
                 fresh=len(res.fresh), baselined=len(res.baselined),
                 stale=len(res.stale_baseline), parse_errors=len(res.parse_errors),
                 seconds=secs)
    log("lint", json.dumps(stats))
    check(not res.failed, "static analysis of src/repro_torch failed:\n" + render_text(res))
    return stats


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
    host = EventStore(web_proxy_schema(), n_shards=4, flush_rows=4096, max_runs=3, device="cpu")
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
    its codes in global memory (SHARED_PROGRAM_BYTES = 0; a set answered
    from its bitmap where the program has one), beside its default
    placement."""
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
                      "header in shared, bitmap in global" if staged == program.header_words
                      and program.n_bitmap_words else
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


COMBINE_NAMES = ("combine_chunks_kernel", "Memset")  # the memset clears the look-back words


def time_combine(name, keys, vals, cols, program, op):
    """combine_scan's per-row form (combine_segments) against its plain
    version on one sorted batch."""
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
        "shape": f"{name} {op}", "entry": "combine_segments", "dims": [n, f],
        "dtype": "int64 keys, int32 values and codes",
        "codes": program.n_codes, "bitmap_words": program.n_bitmap_words,
        "groups": int(got[0].sum()), "max_abs_err": err,
        "ms": cuda_ms(lambda: combine_segments(keys, v, cols, program, op)),
        "device_ms": device_ms(lambda: combine_segments(keys, v, cols, program, op),
                               COMBINE_NAMES, per_call=2),
        "device_ms_by": DEVICE_MS_BY[-1],
        "plain_ms": cuda_ms(lambda: combine_scan_ref(keys, vals, cols, *program, op)),
        "bound_ms": (read + n * 13) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
    }


def time_groups(name, keys, vals, cols, program, op):
    """combine_scan's group form (combine_groups, the host op's) against
    its plain version on one sorted batch."""
    from repro_torch.kernels.combine_scan import combine_groups, combine_groups_ref

    v = None if op == "count" else vals
    *got, n_got = combine_groups(keys, v, cols, program, op)
    *want, n_want = combine_groups_ref(keys, vals, cols, *program, op)
    m = int(n_got)
    check(m == int(n_want), f"{name} {op}: {m} groups, the plain version {int(n_want)}")
    err = max([0] + [int((g[:m].long() - w.long()).abs().max()) for g, w in zip(got, want)
                     if m])
    check(all(g.dtype == w.dtype for g, w in zip(got, want)), f"{name} {op}: dtypes differ")
    n, f = cols.shape
    # As time_combine's rows, but written: each group with a matching row
    # (int64 key and aggregate, int32 count) and the group count.
    read = n * (8 + (0 if op == "count" else 4) + 4 * f) + program.nbytes
    return {
        "shape": f"{name} {op} groups", "entry": "combine_groups", "dims": [n, f],
        "dtype": "int64 keys, int32 values and codes",
        "codes": program.n_codes, "bitmap_words": program.n_bitmap_words, "groups": m,
        "max_abs_err": err,
        "ms": cuda_ms(lambda: combine_groups(keys, v, cols, program, op)),
        "device_ms": device_ms(lambda: combine_groups(keys, v, cols, program, op),
                               COMBINE_NAMES, per_call=2),
        "device_ms_by": DEVICE_MS_BY[-1],
        "plain_ms": cuda_ms(lambda: combine_groups_ref(keys, vals, cols, *program, op)),
        "bound_ms": (read + m * 20 + 8) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None,
    }


def time_aggregate(name, keys, counts):
    """combine_blocks (the host combiner's kernel) against its plain
    version on sorted (B, n) keys, and torch.unique_consecutive +
    torch.segment_reduce over the flattened keys (two calls; float64 data,
    since segment_reduce takes no integers; rows are not kept apart) as a
    yardstick."""
    import torch
    from repro_torch.kernels.aggregate_combine import combine_blocks, combine_blocks_ref

    got = combine_blocks(keys, counts)
    want = combine_blocks_ref(keys, counts)
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    flat, flat_counts = keys.reshape(-1), counts.reshape(-1).double()

    def two_calls():
        _, lengths = torch.unique_consecutive(flat, return_counts=True)
        return torch.segment_reduce(flat_counts, "sum", lengths=lengths)

    per_entry = 8 + counts.element_size() + 1 + 8  # key and count read, head and sum written
    count_type = str(counts.dtype).replace("torch.", "")
    return {
        "shape": name, "entry": "combine_blocks", "dims": list(keys.shape),
        "dtype": f"int64 keys, {count_type} counts", "groups": int(got[0].sum()),
        "max_abs_err": err,
        "ms": cuda_ms(lambda: combine_blocks(keys, counts)),
        "device_ms": device_ms(lambda: combine_blocks(keys, counts),
                               ("aggregate_combine_kernel", "aggregate_combine_stitch"),
                               per_call=2 if keys.shape[-1] > 512 else 1),
        "device_ms_by": DEVICE_MS_BY[-1],
        "plain_ms": cuda_ms(lambda: combine_blocks_ref(keys, counts)),
        "bound_ms": keys.numel() * per_entry / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
        "two_calls_ms": cuda_ms(two_calls),
    }


def earlier_compact(keys, counts, cap, sentinel):
    """The plane's combine-and-compact as PR 16 ran it, composed here as
    the yardstick of combine_compact: the combine_blocks kernel's heads and
    sums (for the dedup form, head flags in PyTorch), then the PyTorch
    passes of the earlier _combine_dup_keys (segment ids by cumsum,
    n_unique, the scatters of keys and sums) and the cut to cap."""
    import torch
    from repro_torch.kernels.aggregate_combine import combine_blocks

    if counts is None:
        is_head = torch.ones_like(keys, dtype=torch.bool)
        is_head[:, 1:] = keys[:, 1:] != keys[:, :-1]
    else:
        is_head, head_sums = combine_blocks(keys, counts)
    seg = torch.cumsum(is_head, dim=1) - 1
    n_unique = (is_head & (keys != sentinel)).sum(dim=1, dtype=torch.int32)
    ukeys = torch.full_like(keys, sentinel).scatter_(1, seg, keys)
    sums = None
    if counts is not None:
        sums = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
        sums.scatter_add_(1, seg, head_sums)
        sums = sums[:, :cap]
    return ukeys[:, :cap], sums, n_unique


def time_compact(name, keys, counts, n_live, cap, sentinel):
    """combine_compact against its plain version and, as its yardstick,
    the earlier path (earlier_compact) on the same inputs, which it must
    match bit for bit."""
    from repro_torch.kernels.aggregate_combine import combine_compact, combine_compact_ref

    def same(x, y):
        return all((a is None and b is None) or torch_equal(a, b) for a, b in zip(x, y))

    got = combine_compact(keys, counts, n_live, cap, sentinel)
    want = combine_compact_ref(keys, counts, n_live, cap, sentinel)
    err = max(int((g - w).abs().max()) for g, w in zip(got, want) if g is not None)
    check(same(got, earlier_compact(keys, counts, cap, sentinel)),
          f"{name}: combine_compact disagrees with the earlier path")
    t, n = keys.shape
    live = int(n_live.sum())
    # The live keys and every count read once (tail keys count as the
    # sentinel unread; tail counts still sum into slot n_unique), n_live
    # read and n_unique written, a key and (with counts) an int64 sum
    # written per output slot.
    count_bytes = 0 if counts is None else t * n * counts.element_size()
    slot_bytes = t * cap * (8 if counts is None else 16)
    bound_bytes = live * 8 + count_bytes + t * 8 + slot_bytes
    live_count_bytes = 0 if counts is None else live * counts.element_size()
    names = ("compact_count", "compact_scan", "compact_write", "compact_carry")
    launched = 3 if counts is None else 4  # compact_carry: with counts, over 2+ tiles
    return {
        "shape": name, "entry": "combine_compact", "dims": [t, n], "cap": cap,
        "dtype": "int64 keys" + ("" if counts is None else
                                 f", {str(counts.dtype).replace('torch.', '')} counts"),
        "live_keys": live, "unique_keys": int(got[2].sum()), "max_abs_err": err,
        "ms": cuda_ms(lambda: combine_compact(keys, counts, n_live, cap, sentinel)),
        "device_ms": device_ms(lambda: combine_compact(keys, counts, n_live, cap, sentinel), names,
                               per_call=launched),
        "device_ms_by": DEVICE_MS_BY[-1],
        "plain_ms": cuda_ms(lambda: combine_compact_ref(keys, counts, n_live, cap, sentinel)),
        "bound_bytes": bound_bytes,
        "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        # The same bound if the tail's counts were known to be 0 and unread.
        "bound_ms_live_counts": (bound_bytes - count_bytes + live_count_bytes)
        / HBM_BYTES_PER_S * 1e3,
        "library_ms": None,
        "earlier_ms": cuda_ms(lambda: earlier_compact(keys, counts, cap, sentinel)),
        # The earlier path is a dozen PyTorch launches: timed queued, whole.
        "earlier_device_ms": queued_device_ms(lambda: earlier_compact(keys, counts, cap, sentinel)),
    }


def combine_inputs(pre, sentinel):
    """The plane's combine-and-compact inputs at the end of ingest, for the
    index and aggregate families, as a major (K-way then 2-way merge) and a
    fold increment build them: sorted (T, N) keys, the aggregate family's
    int64 counts (None for the index family's dedup), the live lengths
    (base_n plus the rows merged in) and the cap (the base's capacity)."""
    import torch
    from repro_torch.kernels.merge_runs import merge_pair_device, merge_sorted_device

    out = {}
    for fam in ("ag", "ix"):
        rk, rc, rn = pre[f"{fam}_run_k"], pre[f"{fam}_run_c"], pre[f"{fam}_run_n"]
        bk, bc, bn = pre[f"{fam}_base_k"], pre[f"{fam}_base_c"], pre[f"{fam}_base_n"]
        t, k, m = rk.shape
        within = torch.arange(m, device=rk.device)[None, None, :] < rn[..., None]
        mk, mc = merge_sorted_device(torch.where(within, rk, sentinel),
                                     torch.where(within[..., None], rc, 0), rn)
        rows_in = rn.sum(dim=1, dtype=torch.int32)
        two_k, two_c = merge_pair_device(bk, bc, bn, mk, mc, rows_in)
        slot = (pre["n_runs"] - 1).clamp(min=0).long()
        tix = torch.arange(t, device=rk.device)
        top_n = rn[tix, slot]
        top = torch.arange(m, device=rk.device)[None, :] < top_n[:, None]
        fold_k, fold_c = merge_pair_device(bk, bc, bn, torch.where(top, rk[tix, slot], sentinel),
                                           torch.where(top[..., None], rc[tix, slot], 0), top_n)
        cap = bk.shape[1]
        for stage, keys, cols, live in (("two_way", two_k, two_c, bn + rows_in),
                                        ("fold", fold_k, fold_c, bn + top_n)):
            counts = cols[..., 0].contiguous() if fam == "ag" else None
            out[f"{fam} {stage}"] = (keys, counts, live, cap)
    return out


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


def run_aggregations(store, dq, dev, tiers, domain_counts, pair_counts, cmp_query):
    """Path 3: the host combine_scan scheme and the device aggregate_range
    for every spec on the tier queries and A AND 404, and for spec (a) on
    cmp_query ((label, tree, count)). Returns the per-query rows, the (lo,
    hi) of the largest tier-A batch of spec (b) and the host results by
    (query, spec)."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.core import Eq, And, QueryProcessor, QueryStats
    from repro_torch.core import merge_aggregate_blocks, resolve_grouping
    from repro_torch.kernels.filter_scan import ops as filter_ops

    qp = QueryProcessor(store, device=dev)
    queries = [(tier, Eq("domain", dom), domain_counts[dom]) for tier, dom in tiers.items()]
    queries.append(("A and 404", And(Eq("domain", tiers["A"]), Eq("status", "404")),
                    pair_counts[(tiers["A"], "404")]))
    rows, largest_a, results = [], None, {}
    for sname, spec in agg_specs().items():
        grouping = resolve_grouping(store, spec, 0, T_SPAN)
        for label, tree, want in queries + ([cmp_query] if sname.startswith("a") else []):
            stats = QueryStats()
            t0 = time.perf_counter()
            it = qp.run_scheme("combine_scan", 0, T_SPAN, tree, aggregate=spec, stats=stats,
                               _grouping=grouping)
            blocks = [next(it)]
            ttfr = time.perf_counter() - t0
            blocks.extend(it)
            total_s = time.perf_counter() - t0
            host = merge_aggregate_blocks(grouping, blocks)
            results[(label, sname)] = host
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
    return rows, largest_a, results


def summarize_spans(records):
    out = {}
    for r in records:
        s = out.setdefault(r["name"], {"n": 0, "s": 0.0, "fence_s": 0.0})
        s["n"] += 1
        s["s"] += r["dur"]
        s["fence_s"] += r.get("fence_s", 0.0)
    return out


class GcPauses:
    """Seconds the garbage collector ran, its passes by generation and
    each pass's (start, end) on the perf_counter clock, while the block is
    open (gc.callbacks brackets each pass, on whichever thread runs it)."""

    def __init__(self):
        self.s = 0.0
        self.passes = [0, 0, 0]
        self.intervals = []
        self._t0 = None

    def _hook(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            now = time.perf_counter()
            self.s += now - self._t0
            self.passes[info["generation"]] += 1
            self.intervals.append((self._t0, now))
            self._t0 = None

    def seconds_in(self, t0, t1):
        """The collector's seconds inside [t0, t1]."""
        return sum(max(0.0, min(b, t1) - max(a, t0)) for a, b in self.intervals)

    def __enter__(self):
        import gc
        gc.callbacks.append(self._hook)
        return self

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._hook)


class MemoryPhases:
    """Device memory by phase of a serve path on ``plane``: at each mark
    the bytes allocated, the peak since the last mark (the peak then
    restarts), and how many DistStore snapshots are alive and the bytes
    of device storage they hold beyond the plane's own state (sealed
    memtable copies, and levels a compaction replaced that a snapshot
    still holds), found through the garbage collector."""

    def __init__(self, dev, plane):
        import torch

        self.dev, self.plane = dev, plane
        torch.cuda.reset_peak_memory_stats(dev)
        self.marks = [{"phase": "start", "allocated_bytes": torch.cuda.memory_allocated(dev)}]

    def mark(self, phase):
        import gc

        import torch
        from repro_torch.core.dist_query import DistStore

        peak = torch.cuda.max_memory_allocated(self.dev)
        state = {t.untyped_storage().data_ptr() for g in self.plane.groups
                 for t in g.state.values()}
        held, n = {}, 0
        for o in gc.get_objects():
            if type(o) is DistStore:  # not isinstance: no __class__ of a proxy is read
                n += 1
                for v in vars(o).values():
                    if isinstance(v, torch.Tensor) and v.is_cuda:
                        st = v.untyped_storage()
                        if st.data_ptr() not in state:
                            held[st.data_ptr()] = st.nbytes()
        self.marks.append({"phase": phase, "allocated_bytes": torch.cuda.memory_allocated(self.dev),
                           "peak_bytes": peak, "snapshots": n,
                           "snapshot_only_bytes": sum(held.values())})
        torch.cuda.reset_peak_memory_stats(self.dev)

    @property
    def peak(self):
        return max(m.get("peak_bytes", 0) for m in self.marks)

    def line(self):
        start = self.marks[0]["allocated_bytes"]
        return json.dumps([{"phase": m["phase"], "allocated_over_start": m["allocated_bytes"] - start,
                            "peak_over_start": m.get("peak_bytes", start) - start,
                            "snapshots": m.get("snapshots"),
                            "snapshot_only_bytes": m.get("snapshot_only_bytes")}
                           for m in self.marks[1:]])


def run_query(dq, scheme, tree, label, want):
    """One scheme run over the 4-hour range, with tracing on: time to the
    first batch and to the last, the garbage collector's seconds within
    each, the plan, the run's QueryStats, and its spans. In an index-mode
    run every query.scan_range span is a batch that truncated and fell
    back to the exact scan. filter_scan must launch once per step (each
    query.scan_range and query.scan_index_range span)."""
    from repro_torch import obs
    from repro_torch.core.dist_query import QueryStats
    from repro_torch.kernels.filter_scan import ops as filter_ops

    obs.clear()
    stats = QueryStats()
    filter_before = filter_ops.launches
    with GcPauses() as gc_first:
        t0 = time.perf_counter()
        it = dq.run_scheme(scheme, 0, T_SPAN, tree, stats=stats)
        first = next(it, None)
        ttfr = time.perf_counter() - t0
    with GcPauses() as gc_rest:
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
        "ttfr_gc_s": gc_first.s, "gc_s": gc_first.s + gc_rest.s,
        "gc_passes": [a + b for a, b in zip(gc_first.passes, gc_rest.passes)],
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


def writer_streams(encoded, n_tablets, chunk, n_writers):
    """Path 4's input, made once before any timed region: the events as
    path 1's writer encoded them, cut into chunks of ``chunk`` rows; writer
    i takes every n_writers-th chunk and routes each row by the row hash
    DistBatchWriter computes with writer_id=i (content, ts, the writer's
    running row count and its id). Returns, per writer, its list of (rev_ts
    int32, cols, global tablet ids)."""
    import numpy as np
    from repro_torch.core import keypack

    ts = np.concatenate([t for t, _ in encoded]).astype(np.int64)
    cols = np.concatenate([c for _, c in encoded])
    streams = [[] for _ in range(n_writers)]
    count = [0] * n_writers
    for i, off in enumerate(range(0, len(ts), chunk)):
        w = i % n_writers
        t, c = ts[off: off + chunk], cols[off: off + chunk]
        nonce = np.arange(count[w], count[w] + len(t), dtype=np.int64)
        count[w] += len(t)
        h = keypack.short_hash(*(c[:, j] for j in range(c.shape[1])), t, nonce, np.int64(w))
        streams[w].append((keypack.rev_ts(t).astype(np.int32), c,
                           (h % n_tablets).astype(np.int64)))
    return streams


def threaded_ingest(plane, streams):
    """One thread per writer stream, each appending its chunks in order
    with its writer id; a writer's exception is raised here."""
    import threading

    errors = []

    def work(w):
        try:
            for rts, cols, tab in streams[w]:
                plane.ingest(rts, cols, tab, writer_id=w)
        except BaseException as e:  # re-raised below, after the join
            errors.append(e)

    threads = [threading.Thread(target=work, args=(w,)) for w in range(len(streams))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def serial_ingest(plane, streams):
    """The writers' chunks appended by this thread alone, in the order
    they were cut (writer ids kept): the control for threaded_ingest."""
    for i in range(max(len(s) for s in streams)):
        for w, stream in enumerate(streams):
            if i < len(stream):
                plane.ingest(*stream[i], writer_id=w)


def run_sharded(store, streams, dev, size, queries, cmp_query, agg_results, read_launches):
    """Path 4: the main path's events through W = 4 writer threads into a
    fresh plane of G = 1 and then G = 4 tablet groups, and, as a control,
    appended by one thread into G = 4 groups (the previous plane freed
    first each time), each drained with compact_step; on the threaded
    G = 4 composite snapshot every scheme's total and aggregate_range
    specs (a) and (c) must equal paths 1 and 3; then the bulk replay of
    the host store (from_event_store) must give a base-only snapshot with
    the same totals. Returns the report and the threaded G = 4 plane,
    drained, which path 5 serves."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core.dist_ingest import DistIngestPlane
    from repro_torch.core.dist_query import DistQueryProcessor, from_event_store

    events, n_tab, n_writers = size["events"], size["tablets"], len(streams)
    specs = agg_specs()
    out = {"writers": n_writers, "runs": {}}
    rows_g1 = served = None
    for label, n_groups, threaded in (("G=1, 4 threads", 1, True),
                                      ("G=4, 1 thread", 4, False),
                                      ("G=4, 4 threads", 4, True)):
        gc.collect()
        torch.cuda.empty_cache()
        plane = DistIngestPlane.for_store(
            store, capacity=size["capacity"], n_tablets=n_tab, mem_rows=size["mem_rows"],
            max_runs=size["max_runs"], append_rows=1024, n_groups=n_groups, device=dev)
        before = read_launches()
        # Allocated with this plane's state, path 1's plane and its
        # end-of-ingest levels; the peak adds the run's temporaries.
        allocated = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        (threaded_ingest if threaded else serial_ingest)(plane, streams)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        ingest_launches = {k: v - before[k] for k, v in read_launches().items()}
        tel = plane.telemetry()
        check(int(tel["rows"].sum()) == events, f"path 4 {label}: {tel['rows'].sum()} rows")
        check(int(tel["overflow"].sum()) == 0 and int(tel["ix_overflow"].sum()) == 0
              and int(tel["ag_overflow"].sum()) == 0, f"path 4 {label}: tablet overflow")
        majors = plane.fold_events.get("ingest", 0)
        check(ingest_launches["aggregate_combine"] == 2 * majors,
              f"path 4 {label}: aggregate_combine launched "
              f"{ingest_launches['aggregate_combine']} times for {majors} majors of two families")
        run = {
            "run": label, "groups": n_groups, "threads": n_writers if threaded else 1,
            "seconds": secs, "rows_per_s": events / secs,
            "blocked_s": plane.blocked_seconds,
            "blocked_s_per_writer": plane.blocked_by_writer,
            "locks": [{k: g.lock.snapshot()[k] for k in ("name", "total_held_s", "total_wait_s",
                                                         "acquisitions")}
                      for g in plane.groups],
            "majors": majors, "major_per_tablet_sum": int(tel["major"].sum()),
            "minor": int(tel["minor"].sum()), "overflow": int(tel["overflow"].sum()),
            "ingest_launches": ingest_launches,
            "allocated_at_start_bytes": allocated,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
            "state_bytes": plane.state_bytes(),
        }
        # Drain. On the G = 4 plane, a publish after one increment must
        # give the three groups it did not touch as the same objects.
        folds = steps = 0
        d_before = plane.publish() if n_groups > 1 else None
        t0 = time.perf_counter()
        while plane.has_unfolded():
            folds += plane.fold_debt() > 0  # the picked group folds its top run
            steps += plane.compact_step()
            if d_before is not None:
                d_after = plane.publish()
                same = [a is b for a, b in zip(d_before.groups, d_after.groups)]
                check(sum(same) == n_groups - 1,
                      f"path 4: after one compact_step, groups aliased {same}")
                d_before = None
        torch.cuda.synchronize(dev)
        d_after = None  # the first drain step's snapshot holds the plane's buffers
        run["drain_steps"], run["drain_folds"] = steps, folds
        run["drain_s"] = time.perf_counter() - t0
        run["launches"] = {k: v - before[k] for k, v in read_launches().items()}
        check(run["launches"]["aggregate_combine"] == 2 * (majors + folds),
              f"path 4 {label}: aggregate_combine launched "
              f"{run['launches']['aggregate_combine']} times for {majors} majors and {folds} "
              f"fold increments")
        rows = plane.telemetry()["rows"]
        if rows_g1 is None:
            rows_g1 = rows
        else:
            check(np.array_equal(rows, rows_g1), f"path 4: per-tablet rows of {label} != G=1")
        log("sharded", json.dumps(run))
        out["runs"][label] = run
        if not (threaded and n_groups > 1):
            del plane
            continue
        dq = DistQueryProcessor(store, plane, device=dev)
        d = dq._sync()
        check(d.is_composite and len(d.groups) == n_groups,
              f"path 4: the G={n_groups} snapshot is not a composite of {n_groups} groups")
        totals = {}
        for qlabel, tree, want in queries + [cmp_query]:
            for scheme in SCHEMES:
                t0 = time.perf_counter()
                got = sum(b.count for b in dq.run_scheme(scheme, 0, T_SPAN, tree))
                totals[f"{qlabel} {scheme}"] = {"rows": got, "s": time.perf_counter() - t0}
                check(got == want, f"path 4 {qlabel} {scheme}: {got} rows, paths 1-2 count {want}")
        for qlabel, tree, _ in queries:
            for sname in ("a count/status/hour", "c max bytes_out/status"):
                res = dq.aggregate_range(specs[sname], tree, 0, T_SPAN)
                check(same_aggregates(res, agg_results[(qlabel, sname)]),
                      f"path 4 {qlabel} {sname}: the composite's aggregate differs from path 3")
        out["composite_queries"] = totals
        log("sharded", "G=4 composite: every total equals paths 1-2, specs (a) and (c) equal "
            "path 3 bit for bit: " + json.dumps(totals))
        served = plane
        del dq, d, plane
    gc.collect()
    torch.cuda.empty_cache()

    # Bulk replay of the host store into a base-only snapshot.
    t0 = time.perf_counter()
    replay = from_event_store(store, n_tablets=n_tab, device=dev)
    torch.cuda.synchronize(dev)
    replay_s = time.perf_counter() - t0
    check(not replay.has_runs and replay.run_rev_ts is None and replay.has_index,
          "from_event_store did not return a base-only snapshot with an index")
    dq = DistQueryProcessor(store, dist=replay, device=dev)
    totals = {}
    for label, tree, want in queries + [cmp_query]:
        for scheme in ("scan", "batched_scan"):
            got = sum(b.count for b in dq.run_scheme(scheme, 0, T_SPAN, tree))
            totals[f"{label} {scheme}"] = got
            check(got == want, f"replay {label} {scheme}: {got} rows, paths 1-2 count {want}")
    label, tree, want = queries[0]
    batches = dq.execute_batched(tree, 0, T_SPAN)
    got = sum(c for c, _, _ in batches)
    check(got == want and len(batches) > 1,
          f"replay execute_batched {label}: {got} rows in {len(batches)} batches, want {want}")
    out["replay"] = {"seconds": replay_s, "capacity": replay.capacity, "totals": totals,
                     "execute_batched": {"rows": got, "batches": len(batches)}}
    log("sharded", "bulk replay: " + json.dumps(out["replay"]))
    del dq, replay
    gc.collect()
    torch.cuda.empty_cache()
    return out, served


SERVE_SESSIONS = 4  # path 5: S dist sessions, each on its own thread
SERVE_WRITERS = 2  # path 5b: W DistBatchWriter threads
SERVE_ROUNDS = 3  # path 5b: rounds of the mix per session (a count, so runs repeat)
SERVE_CHUNKS = 128  # path 5b: the appended events go in this many chunks
SERVE_ALLOWED_FOLDS = {"ingest", "background", "explicit"}
TILE_FLOOR_S = 1e-3  # path 5: stages tile each TTFR within 5% of max(TTFR, this)


def serve_mix(tiers):
    """One dist session's round of path 5: the four schemes on the tiers
    and on A AND 404, both index schemes on B OR C, spec (a) on tier B and
    one density per tier, as (kind, scheme, label, tree or domain)."""
    from repro_torch.core import And, Eq, Or

    eq = {tier: Eq("domain", dom) for tier, dom in tiers.items()}
    mix = [("query", scheme, tier, eq[tier]) for tier in tiers for scheme in SCHEMES]
    a404 = And(eq["A"], Eq("status", "404"))
    mix += [("query", scheme, "A and 404", a404) for scheme in SCHEMES]
    b_or_c = Or(eq["B"], eq["C"])
    mix += [("query", scheme, "B or C", b_or_c) for scheme in ("index", "batched_index")]
    mix.append(("aggregate", "aggregate", "B", eq["B"]))
    mix += [("density", "density", tier, dom) for tier, dom in tiers.items()]
    return mix


def serve_counts(tiers, domain_counts, pair_counts):
    """Rows each label of serve_mix matches, from counts of the events."""
    want = {tier: domain_counts[dom] for tier, dom in tiers.items()}
    want["A and 404"] = pair_counts[(tiers["A"], "404")]
    want["B or C"] = domain_counts[tiers["B"]] + domain_counts[tiers["C"]]
    return want


def serve_one(session, item, spec, on_submit=None):
    """Submit one item of the mix through a session and drain it;
    on_submit() is called between the submit and the drain."""
    kind, scheme, label, arg = item
    res = None
    if kind == "query":
        q = session.submit(scheme, 0, T_SPAN, arg)
    elif kind == "aggregate":
        q = session.submit_aggregate(spec, 0, T_SPAN, arg)
    else:
        q = session.submit_density("domain", arg, 0, T_SPAN)
    if on_submit is not None:
        on_submit()
    if kind == "aggregate":
        rb = q.drain(timeout=300)
        check(len(rb) == 1, f"path 5 aggregate {label}: {len(rb)} result batches")
        count, res = rb[0].count, rb[0].blocks[0]
    else:
        count = q.count(timeout=300)
    return {"session": session.name, "scheme": scheme, "label": label, "count": count,
            "q": q, "res": res}


def run_sessions(svc, mixes, name, spec, backends=None, on_submit=None):
    """One client thread per session, session i running mixes[i] in order.
    Returns (records in each session's order, wall seconds, sessions)."""
    import threading

    backends = backends or ["dist"] * len(mixes)
    sessions = [svc.session(f"{name}-{i}", backend=b) for i, b in enumerate(backends)]
    records = [[] for _ in mixes]
    errors = []

    def work(i):
        try:
            for item in mixes[i]:
                records[i].append(serve_one(sessions[i], item, spec, on_submit))
        except BaseException as e:  # re-raised below, after the join
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,), name=f"{name}-client-{i}")
               for i in range(len(mixes))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    secs = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), f"path 5 {name}: a session thread hung")
    if errors:
        raise errors[0]
    for s in sessions:
        s.close()
    return [r for rs in records for r in rs], secs, sessions


class IngestPacer:
    """Path 5b's coupling of the writers to the sessions, so that ingest
    spans every round of the mix: the writers claim the chunks in order,
    and chunk j of J starts only once the sessions have submitted
    j * Q // (J - 1) of their Q queries. The last chunk therefore starts
    after the last query was submitted, so every query is submitted while
    a writer is live; the sessions never wait for the writers."""

    def __init__(self, n_queries, n_chunks):
        import threading

        check(n_chunks > 1, "path 5b needs more than one chunk")
        self.n_queries, self.n_chunks = n_queries, n_chunks
        self.cv = threading.Condition()
        self.submitted = self.claimed = 0
        self.aborted = False
        self.wait_s = 0.0  # writers' seconds spent waiting for a ticket

    def note_submit(self):
        with self.cv:
            self.submitted += 1
            self.cv.notify_all()

    def claim(self, timeout=600):
        """The index of the next chunk once its ticket is met; None when
        every chunk is claimed or the run was aborted."""
        with self.cv:
            j = self.claimed
            if j >= self.n_chunks or self.aborted:
                return None
            self.claimed += 1
            ticket = j * self.n_queries // (self.n_chunks - 1)
            t0 = time.perf_counter()
            met = self.cv.wait_for(lambda: self.submitted >= ticket or self.aborted, timeout)
            self.wait_s += time.perf_counter() - t0
            check(met, f"path 5b: chunk {j} waited {timeout} s for {ticket} submits")
            return None if self.aborted else j

    def abort(self):
        with self.cv:
            self.aborted = True
            self.cv.notify_all()


def rotated(mix, i, n):
    """Session i's copy of the mix, started at its own offset."""
    k = i * len(mix) // n
    return mix[k:] + mix[:k]


def phase_stats(records, secs, gcs):
    """TTFR p50/p99 per scheme with the collector's seconds in the TTFR
    windows, queries per second (where secs is given), queue wait and the first result's stages
    (the device section against the turn, which is the TTFR less
    admission)."""
    import numpy as np

    firsts = [r for r in records if r["q"].first_result_at is not None]
    by_scheme = {}
    for r in firsts:
        by_scheme.setdefault(r["scheme"], []).append(r)
    ttfr = {}
    for scheme, rs in sorted(by_scheme.items()):
        v = np.array([r["q"].first_result_s for r in rs])
        ttfr[scheme] = {
            "n": len(rs), "p50_ms": float(np.percentile(v, 50)) * 1e3,
            "p99_ms": float(np.percentile(v, 99)) * 1e3, "max_ms": float(v.max()) * 1e3,
            "ttfr_gc_s": sum(gcs.seconds_in(r["q"].submitted_at, r["q"].first_result_at)
                             for r in rs),
        }
    stages = {k: sum(r["q"].profile.stages()[k] for r in firsts)
              for k in ("admission", "plan", "density_fence", "device_step", "epilogue",
                        "deliver")}
    ttfr_sum = sum(r["q"].first_result_s for r in firsts)
    turn = ttfr_sum - stages["admission"]
    return {
        "queries": len(records), "seconds": secs,
        "queries_per_s": len(records) / secs if secs else None,
        "ttfr": ttfr,
        "queue_wait_s": sum(r["q"].queue_wait_s for r in records),
        "queue_wait_s_mean": sum(r["q"].queue_wait_s for r in records) / max(len(records), 1),
        "first_result_stages_s": stages, "ttfr_sum_s": ttfr_sum,
        "first_turn_s": turn, "device_share_of_first_turn": stages["device_step"] / turn
        if turn > 0 else 0.0,
        "device_total_s": sum(r["q"].profile.device_total_s for r in records),
        "query_total_s": sum(r["q"].total_s for r in records),
    }


def lock_books(snap, before=None):
    """The device lock's held seconds by owner (minus an earlier snapshot)."""
    by = dict(snap["by_owner_s"])
    if before is not None:
        for k, v in before["by_owner_s"].items():
            by[k] = by.get(k, 0.0) - v
    return by


def prom_samples(text):
    """Prometheus text format 0.0.4 as {(name, labels): value}; raises on a
    line it cannot parse."""
    import re

    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([a-zA-Z0-9_:]+)(\{(.*)\})? (\S+)$", line)
        check(m is not None, f"/metrics: unparseable line {line!r}")
        name, _, labels, val = m.groups()
        out[(name, labels or "")] = float("inf") if val == "+Inf" else float(val)
    return out


def serve_events(seed, size):
    """Path 5b's appended events, generated and parsed before any timed
    region (path 13b re-sends them): an eighth of the main path, as
    SERVE_CHUNKS chunks of (ts, values). More would overflow src_ip's
    dictionary (2**22 codes) with this source's address space. Returns
    (chunks, events, chunk rows)."""
    from repro_torch.pipeline.sources import SyntheticWebProxySource, parse_web_proxy_lines

    n_new = size["events"] // 8
    chunk = -(-n_new // SERVE_CHUNKS)
    source = SyntheticWebProxySource(seed=seed + 1)
    chunks = [parse_web_proxy_lines(source.gen_lines(min(chunk, n_new - off), 0, T_SPAN))
              for off in range(0, n_new, chunk)]
    return chunks, n_new, chunk


def serve_under_ingest(svc, store, plane, chunks, chunk, mixes, name, spec, writer_base):
    """SERVE_WRITERS DistBatchWriter threads (ids writer_base + w) append
    ``chunks``, paced by an IngestPacer on the sessions' submits, while
    the sessions run ``mixes`` (run_sessions). Checks that every chunk
    was appended; returns the records, the sessions' seconds and
    sessions, and the writers' numbers (ingest and append seconds, their
    (start, end) per chunk, the writers' close times, the pacer's wait)."""
    import threading

    from repro_torch.core.dist_ingest import DistBatchWriter

    pacer = IngestPacer(sum(map(len, mixes)), len(chunks))
    writer_errors = []
    writer_done = [0.0] * SERVE_WRITERS
    appends = []  # (start, end) of every chunk's add, flush included

    def write(w):
        try:
            wr = DistBatchWriter(store, plane, batch_rows=chunk, writer_id=writer_base + w)
            while (j := pacer.claim()) is not None:
                a0 = time.perf_counter()
                wr.add(*chunks[j])
                appends.append((a0, time.perf_counter()))
            wr.close()
            writer_done[w] = time.perf_counter()
        except BaseException as e:  # re-raised below, after the join
            writer_errors.append(e)
            pacer.abort()

    writers = [threading.Thread(target=write, args=(w,), name=f"{name}-writer-{w}")
               for w in range(SERVE_WRITERS)]
    t0 = time.perf_counter()
    for t in writers:
        t.start()
    try:
        recs, secs, sess = run_sessions(svc, mixes, name, spec, on_submit=pacer.note_submit)
    except BaseException:
        pacer.abort()  # release writers waiting for submits that never come
        raise
    finally:
        for t in writers:
            t.join(timeout=600)
    check(not any(t.is_alive() for t in writers), f"{name}: a writer thread hung")
    if writer_errors:
        raise writer_errors[0]
    check(pacer.claimed == len(chunks) and len(appends) == len(chunks),
          f"{name}: {len(appends)} of {len(chunks)} chunks appended")
    return recs, secs, sess, {"ingest_s": max(writer_done) - t0,
                              "append_s": sum(b - a for a, b in appends), "appends": appends,
                              "writer_done": writer_done, "wait_s": pacer.wait_s}


def run_serve(store, plane, dev, size, seed, tiers, domain_counts, pair_counts, agg_results,
              events):
    """Path 5: the serve plane on the drained G = 4 plane of path 4. One
    QueryService (background compactor on) and a /metrics endpoint on
    127.0.0.1. 5a: S sessions run the mix once with flight recording and
    tracing off, then once with flight recording on, beside a host-backend
    session's spec (a) on tier C; every count equals paths 1-2's, the
    aggregates path 3's bit for bit, the densities the generated counts.
    5b: W writer threads append fresh events, paced by IngestPacer so that
    every query is submitted before the last writer closes, while the
    sessions run the mix SERVE_ROUNDS times; each session's tier-A
    batched_scan counts never fall and every count lies between 5a's and
    the final one. 5c: after
    the writers close, each tier's count is 5a's plus the appended
    events'; the compactor drains the plane; fold sources, session
    telemetry, the /metrics scrape and the profiles' tiling are checked.
    Returns the report with the majors and fold increments path 5 ran.
    ``events`` are serve_events()."""
    from urllib.request import urlopen

    import torch
    from repro_torch import obs
    from repro_torch.core import Eq
    from repro_torch.serve_db import QueryService

    spec_a = agg_specs()["a count/status/hour"]
    base = serve_counts(tiers, domain_counts, pair_counts)
    mix = serve_mix(tiers)
    n = SERVE_SESSIONS
    ttfr_hist = obs.get_registry().histogram("query_profile_ttfr_seconds",
                                             "measured end-to-end TTFR")
    ttfr_before = sum(c["count"] for c in ttfr_hist.cells().values())
    folds_before = dict(plane.fold_events)
    check(not plane.has_unfolded(), "path 5: the plane of path 4 is not drained")
    chunks, n_new, chunk = events
    new_dom = Counter(d for _, v in chunks for d in v["domain"])
    new_pair = Counter(p for _, v in chunks for p in zip(v["domain"], v["status"]))
    final = {k: base[k] + v for k, v in serve_counts(tiers, new_dom, new_pair).items()}

    report = {"sessions": n, "writers": SERVE_WRITERS, "rounds": SERVE_ROUNDS,
              "appended_events": n_new, "chunk": chunk}
    memory = MemoryPhases(dev, plane)
    svc = QueryService(store, plane)
    endpoint = obs.serve_prometheus()
    all_records, all_sessions = [], []
    try:
        with GcPauses() as gcs:
            # 5a: the mix, beside a host session's spec (a) on tier C, with
            # flight recording and tracing off, then with flight recording
            # on (the overhead is printed, not gated). No fold can run in
            # between: nothing is unfolded and nothing is written.
            obs.flight_disable()
            obs.flight_clear()
            mixes = [rotated(mix, i, n) for i in range(n)]
            mixes.append([("aggregate", "aggregate", "C", Eq("domain", tiers["C"]))])
            backends = ["dist"] * n + ["host"]
            off, off_s, sess = run_sessions(svc, mixes, "5a-off", spec_a, backends)
            all_records += off
            all_sessions += sess
            check(not plane.has_unfolded(), "path 5a: the plane changed without a write")
            obs.flight_enable()
            lock0 = svc._device_lock.snapshot()
            recs_5a, secs_5a, sess = run_sessions(svc, mixes, "5a", spec_a, backends)
            all_records += recs_5a
            all_sessions += sess
            lock_5a = svc._device_lock.snapshot()
            for r in off + recs_5a:
                check(r["count"] == base[r["label"]],
                      f"path 5a {r['session']} {r['scheme']} {r['label']}: {r['count']} rows, "
                      f"paths 1-2 count {base[r['label']]}")
                if r["res"] is not None:
                    check(same_aggregates(r["res"], agg_results[(r["label"],
                                                                 "a count/status/hour")]),
                          f"path 5a {r['session']} aggregate {r['label']} differs from path 3")
            check(all(any(r["session"] == f"{ph}-{n}" for r in recs_5a + off)
                      for ph in ("5a", "5a-off")), "path 5a: the host-backend session ran nothing")
            report["5a_flight_off"] = phase_stats(off, off_s, gcs)
            report["5a"] = phase_stats(recs_5a, secs_5a, gcs)
            report["5a"]["device_lock_held_s"] = lock_books(lock_5a, lock0)
            report["flight_overhead"] = {"flight_on_s": secs_5a, "both_off_s": off_s}
            memory.mark("5a")
            log("serve", f"5a: {len(recs_5a)} queries ({n} sessions and a host session) in "
                f"{secs_5a:.3f} s with flight recording on, {off_s:.3f} s with both off; every "
                f"count equals paths 1-2, aggregates path 3")

            # 5b: queries under ingest, the writers paced by the sessions'
            # submits so that every query is submitted while they write.
            majors_before = plane.fold_events.get("ingest", 0)
            group_locks0 = [g.lock.snapshot() for g in plane.groups]
            mixes_5b = [rotated(mix, i, n) * SERVE_ROUNDS for i in range(n)]
            recs_5b, secs_5b, sess, wr = serve_under_ingest(svc, store, plane, chunks, chunk,
                                                            mixes_5b, "5b", spec_a, 10)
            all_records += recs_5b
            all_sessions += sess
            memory.mark("5b")
            ingest_s, append_s, appends = wr["ingest_s"], wr["append_s"], wr["appends"]
            writer_done = wr["writer_done"]
            lock_5b = svc._device_lock.snapshot()
            # Seconds publishes and appends waited for the group locks,
            # and held them, over 5b.
            group_wait, group_held = Counter(), Counter()
            for g, before in zip(plane.groups, group_locks0):
                after = g.lock.snapshot()
                for owner, v in after["wait_by_owner_s"].items():
                    group_wait[owner] += v - before["wait_by_owner_s"].get(owner, 0.0)
                for owner, v in after["by_owner_s"].items():
                    group_held[owner] += v - before["by_owner_s"].get(owner, 0.0)
            for r in recs_5b:
                check(base[r["label"]] <= r["count"] <= final[r["label"]],
                      f"path 5b {r['session']} {r['scheme']} {r['label']}: {r['count']} rows, "
                      f"outside [{base[r['label']]}, {final[r['label']]}]")
            for s in sess:
                a = [r["count"] for r in recs_5b if r["session"] == s.name
                     and r["label"] == "A" and r["scheme"] == "batched_scan"]
                check(len(a) == SERVE_ROUNDS and all(y >= x for x, y in zip(a, a[1:])),
                      f"path 5b {s.name}: tier A batched_scan counts {a} fall")
            late = [r for r in recs_5b if r["q"].submitted_at >= max(writer_done)]
            check(not late, f"path 5b: {len(late)} of {len(recs_5b)} queries were submitted "
                  f"after the last writer closed")
            # Queries whose submit-to-first-result window met a chunk's append.
            met = [r for r in recs_5b
                   if any(a < (r["q"].first_result_at or r["q"].finished_at)
                          and r["q"].submitted_at < b for a, b in appends)]
            in_append = len(met)
            # Distinct counts of one label show the writes landing mid-phase.
            seen_a = sorted({r["count"] for r in recs_5b if r["label"] == "A"})
            report["5b"] = phase_stats(recs_5b, secs_5b, gcs)
            report["5b_meeting_an_append"] = phase_stats(met, None, gcs) if met else None
            report["5b"].update(
                ingest_rows_per_s=n_new / ingest_s, ingest_s=ingest_s,
                append_s=append_s, append_rows_per_s=n_new / append_s,
                writer_ticket_wait_s=wr["wait_s"],
                queries_submitted_during_ingest=len(recs_5b) - len(late),
                queries_overlapping_an_append=in_append, tier_a_counts_seen=len(seen_a),
                device_lock_held_s=lock_books(lock_5b, lock_5a),
                group_locks_wait_s=dict(group_wait), group_locks_held_s=dict(group_held),
                writer_blocked_s={w: plane.blocked_by_writer.get(10 + w, 0.0)
                                  for w in range(SERVE_WRITERS)})
            log("serve", f"5b: {len(recs_5b)} queries in {secs_5b:.3f} s, every one submitted "
                f"before the last of {SERVE_WRITERS} writers closed and {in_append} waiting for "
                f"their first result while a chunk was appended; the writers appended {n_new} events in {len(chunks)} chunks "
                f"in {ingest_s:.3f} s ({append_s:.3f} s appending, {wr['wait_s']:.3f} s waiting "
                f"for the sessions); {len(seen_a)} distinct tier A counts; counts bounded and "
                f"monotone")

            # 5c: acknowledged writes, then the drain.
            s = svc.session("5c")
            all_sessions.append(s)
            recs_5c = []
            for item in mix[:len(SCHEMES) * len(tiers)]:
                if item[1] == "batched_scan":
                    recs_5c.append(serve_one(s, item, spec_a))
            recs_5c += [serve_one(s, m, spec_a) for m in mix
                        if m[2] == "A and 404" and m[1] == "batched_index"]
            s.close()
            all_records += recs_5c
            for r in recs_5c:
                check(r["count"] == final[r["label"]],
                      f"path 5c {r['scheme']} {r['label']}: {r['count']} rows after the writers "
                      f"closed, want {final[r['label']]} (5a {base[r['label']]})")
            check(svc.wait_idle(timeout=120), "path 5c: the service never went idle")
            t0 = time.perf_counter()
            deadline = t0 + 300
            while plane.has_unfolded() and time.perf_counter() < deadline:
                time.sleep(0.02)
            drain_s = time.perf_counter() - t0
            check(not plane.has_unfolded(), "path 5c: the compactor never drained the plane")
            torch.cuda.synchronize(dev)
            memory.mark("5c")
        lock_5c = svc._device_lock.snapshot()
        tel = plane.telemetry()
        check(set(tel["fold_events"]) <= SERVE_ALLOWED_FOLDS,
              f"path 5c: fold sources {tel['fold_events']}")
        comp = svc.compactor
        check(comp.increments > 0, "path 5c: the compactor ran no increment")
        background = tel["fold_events"].get("background", 0) - folds_before.get("background", 0)
        check(comp.increments == background,
              f"path 5c: {comp.increments} compactor increments, {background} background folds")
        missing = {x.session_id for x in all_sessions} - set(tel["sessions"])
        check(not missing, f"path 5c: sessions {missing} missing from telemetry")
        majors = plane.fold_events.get("ingest", 0) - majors_before
        fold_incs = sum(1 for r in obs.get_flight().records()
                        if r["name"] == "ingest.fold_increment"
                        and r["args"].get("kind") == "fold"
                        and r["args"].get("source") == "background")
        # One scrape of /metrics: it parses, and its TTFR histogram counted
        # every first result path 5 delivered.
        body = urlopen(endpoint.url, timeout=30).read().decode()
        samples = prom_samples(body)
        scraped = sum(v for (name, _), v in samples.items()
                      if name == "query_profile_ttfr_seconds_count") - ttfr_before
        firsts = [r for r in all_records if r["q"].first_result_at is not None]
        for r in firsts:
            p = r["q"].profile
            check(p.committed and p.ttfr_s == r["q"].first_result_s,
                  f"path 5: q{p.qid} has no committed profile")
        # The reference's law: the stages sum to each TTFR within 5%. The
        # stages are read off separate clock reads with a few lines of
        # bookkeeping between them, which can reach 5% of a TTFR under
        # 1 ms (a memoized density), so there the gap is held to 5% of
        # 1 ms; the raw gaps are reported either way.
        abs_gaps = [abs(r["q"].profile.breakdown_sum_s() - r["q"].profile.ttfr_s)
                    for r in firsts]
        gaps = [g / max(r["q"].profile.ttfr_s, TILE_FLOOR_S) for g, r in zip(abs_gaps, firsts)]
        worst = max(range(len(gaps)), key=gaps.__getitem__)
        raw = [g / r["q"].profile.ttfr_s for g, r in zip(abs_gaps, firsts)]
        sub_ms = [g for g, r in zip(abs_gaps, firsts) if r["q"].profile.ttfr_s < TILE_FLOOR_S]
    finally:
        endpoint.stop()
        svc.wait_idle(timeout=120)
        svc.close()
        obs.flight_disable()
    report["5c"] = {
        "counts": {r["label"]: r["count"] for r in recs_5c}, "drain_s": drain_s,
        "device_lock_held_s": lock_books(lock_5c, lock_5b),
    }
    report.update(
        majors=majors, fold_increments=fold_incs, fold_events=tel["fold_events"],
        compactor={"increments": comp.increments, "folds": comp.folds, "passes": comp.passes,
                   "preempted": comp.preempted, "skipped_busy": comp.skipped_busy,
                   "max_increment_s": comp.max_increment_s},
        device_lock=lock_5c, max_first_turn_wait_s=svc.scheduler.max_first_turn_wait(),
        first_results=len(firsts), metrics_bytes=len(body),
        profile_worst_gap=gaps[worst], profile_worst_raw_gap=max(raw),
        profile_sub_ms=len(sub_ms), profile_sub_ms_worst_gap_s=max(sub_ms, default=0.0),
        gc_s=gcs.s, gc_passes=gcs.passes, memory=memory.marks, memory_line=memory.line())
    log("serve", f"device memory by phase, bytes over the {memory.marks[0]['allocated_bytes']} "
        f"allocated at the start: {memory.line()}")
    for phase in ("5a_flight_off", "5a", "5b", "5b_meeting_an_append"):
        st = report[phase]
        if st is None:
            continue
        log("serve", f"{phase} TTFR ms p50/p99 per scheme: " + json.dumps(
            {k: [round(v["p50_ms"], 3), round(v["p99_ms"], 3), v["n"],
                 round(v["ttfr_gc_s"], 4)] for k, v in st["ttfr"].items()})
            + " ([p50, p99, n, ttfr_gc_s])")
        rate = (f"{st['queries_per_s']:.1f} queries/s" if st["queries_per_s"]
                else f"{st['queries']} queries")
        log("serve", f"{phase}: {rate}; queue wait "
            f"{st['queue_wait_s']:.3f} s in all ({st['queue_wait_s_mean'] * 1e3:.3f} ms a "
            f"query); first results' stages s {json.dumps(st['first_result_stages_s'])}; "
            f"device section {st['device_share_of_first_turn']:.3f} of the first turn")
    log("serve", f"5b: ingest {report['5b']['ingest_rows_per_s']:.1f} rows/s while serving, "
        f"paced ({report['5b']['append_rows_per_s']:.1f} rows/s of the writers' append time); "
        f"writers blocked {json.dumps(report['5b']['writer_blocked_s'])} s; the four group "
        f"locks' wait s by owner {json.dumps(report['5b']['group_locks_wait_s'])}, held s "
        f"{json.dumps(report['5b']['group_locks_held_s'])}")
    for phase in ("5a", "5b", "5c"):
        log("serve", f"{phase} device lock held s by owner: "
            + json.dumps(report[phase]["device_lock_held_s"]))
    log("serve", f"compactor: {json.dumps(report['compactor'])}; drain after the writers "
        f"{drain_s:.3f} s; fold events {json.dumps(tel['fold_events'])}; worst first-turn "
        f"wait {report['max_first_turn_wait_s'] * 1e3:.3f} ms")
    log("serve", f"flight recording on, tracing off: {secs_5a:.3f} s for the 5a mix against "
        f"{off_s:.3f} s with both off, which ran first (ratio {secs_5a / off_s:.4f}; not a "
        f"gate)")
    w = firsts[worst]
    report["profile_worst"] = {"session": w["session"], "scheme": w["scheme"],
                               "ttfr_s": w["q"].profile.ttfr_s, **w["q"].profile.stages()}
    log("serve", f"/metrics scrape parsed ({len(body)} bytes), {int(scraped)} first results "
        f"counted of {len(firsts)} delivered; profile stages against each TTFR (at least "
        f"1 ms): worst gap {gaps[worst]:.4%} ({json.dumps(report['profile_worst'])}), "
        f"{sum(g > 0.05 for g in raw)} over 5% of the TTFR itself; {len(sub_ms)} TTFRs under "
        f"1 ms, worst gap {max(sub_ms, default=0.0) * 1e6:.1f} us; {majors} majors and "
        f"{fold_incs} fold increments on path 5")
    check(scraped == len(firsts),
          f"/metrics counted {scraped} first results, path 5 delivered {len(firsts)}")
    check(gaps[worst] <= 0.05,
          f"path 5: the profile stages of q{w['q'].qid} ({w['session']} {w['scheme']}) miss "
          f"its TTFR by {gaps[worst]:.2%} of max(TTFR, 1 ms)")
    return report


def run_daemon(dev, mesh=False):
    """`python -m repro_torch.serve_db` in-process on the card at the
    reference test's small size with a tight TTFR SLO: exit code 0, both
    header lines, and an incident bundle whose trace validates. With
    ``mesh``, `--mesh dev` in this process's group (path 13c)."""
    import contextlib
    import io
    import shutil

    from repro_torch import obs
    from repro_torch.serve_db.__main__ import main as daemon_main

    inc = os.path.join(ROOT, "build", "serve_incidents")  # gitignored, like the kernels
    shutil.rmtree(inc, ignore_errors=True)
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = daemon_main(["--device", str(dev), "--rows", "1200", "--sessions", "2",
                              "--writers", "1", "--duration", "1.5", "--incident-dir", inc,
                              "--ttfr-slo", "0.000001", "--window", "5", "--tick", "0.1",
                              "--groups", "1", "--tablets-per-device", "2"]
                             + (["--mesh", "dev"] if mesh else []))
    finally:
        obs.flight_disable()
        obs.flight_clear()
    secs = time.perf_counter() - t0
    text = out.getvalue()
    check(rc == 0, f"daemon exited {rc}")
    check("METRICS_URL=http://127.0.0.1:" in text and f"INCIDENT_DIR={inc}" in text,
          f"daemon header lines missing: {text!r}")
    bundles = sorted(d for d in os.listdir(inc) if d.endswith("_ttfr_p99")) if os.path.isdir(
        inc) else []
    check(bool(bundles), f"daemon left no ttfr_p99 incident bundle: {text!r}")
    with open(os.path.join(inc, bundles[0], "trace.json")) as f:
        trace = json.load(f)
    problems = obs.validate_chrome_trace(trace)
    check(problems == [] and any(e.get("ph") == "X" for e in trace["traceEvents"]),
          f"daemon incident trace invalid: {problems[:5]}")
    summary = [ln for ln in text.splitlines() if ln.startswith("daemon:")]
    log("serve-mesh" if mesh else "daemon", f"{'13c: --mesh dev: ' if mesh else ''}exit 0 "
        f"in {secs:.3f} s; {len(bundles)} ttfr_p99 bundle(s), trace of "
        f"{len(trace['traceEvents'])} events validates; {summary[0] if summary else ''}")
    return {"seconds": secs, "bundles": len(bundles), "trace_events": len(trace["traceEvents"]),
            "stdout": text.splitlines()[:4]}


# Path 6: the reference's own deployment, PIPELINE of configs/llcysa.py
# (8 shards, 4 ingest workers, flush_rows 32,768, max_runs 8, 3,600 s
# aggregate buckets, batch_rows 4,096), over 64 staged files of 16,384
# lines: 1,048,576 events over the paper's 4-hour span.
PIPELINE_FILES = 64
PIPELINE_LINES = 16_384
# Path 7: llcysa-analytics-100m served to 32 requests whose prompts are
# path 6's token sequences of 8 events (112 tokens), 16 new tokens each.
LM_REQUESTS = 32
LM_PROMPT_EVENTS = 8
LM_NEW_TOKENS = 16
LM_MAX_BATCH = 8
LM_CACHE_LEN = 256
LM_DECODE_ATOL = 2e-3  # tests/test_models.py::test_decode_matches_prefill's bound


def profiled_kernels(fn, names):
    """fn() once under a torch.profiler window (CUDA activity only).
    Returns (fn's result, device ms summed over the kernels whose name
    holds one of ``names``, how many such kernels the window holds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and any(n in e.name for n in names)]
    return out, sum(us) / 1e3, len(us)


def pool_ingest(store, paths, n_workers, batch_rows):
    """IngestWorkerPool of n_workers over the staged files into ``store``;
    returns its report row (rates per worker, backpressure, the rate
    series' percentiles) and the worker reports."""
    import numpy as np
    from repro_torch.core.ingest import rate_series
    from repro_torch.pipeline import IngestWorkerPool

    t0 = time.perf_counter()
    pool = IngestWorkerPool(store, n_workers=n_workers, batch_rows=batch_rows,
                            lease_timeout_s=120.0)
    for p in paths:
        pool.submit_file(p)
    reports = pool.drain(timeout_s=600)
    wall = time.perf_counter() - t0
    _, rate = rate_series([r.metrics for r in reports])
    files = sum(r.files for r in reports)
    check(files == len(paths) == pool.queue.completed,
          f"W = {n_workers}: {files} files reported, {pool.queue.completed} completed, "
          f"{len(paths)} staged")
    bp = store.backpressure_stats()
    workers = [{"name": r.name, "files": r.files, "rows": r.metrics.rows,
                "rows_per_s": r.metrics.rows / wall, "mb_per_s": r.metrics.bytes / wall / 1e6,
                "blocked_s": r.metrics.blocked_seconds, "flush_s": r.metrics.flush_seconds}
               for r in reports]
    tablets = store.event_tablets + store.index_tablets + [store.agg_tablet]
    row = {
        "workers": n_workers, "wall_s": wall, "rows": store.total_rows,
        "rows_per_s": store.total_rows / wall,
        "rows_per_s_per_worker": store.total_rows / wall / n_workers,
        "mb_per_s_per_worker": sum(r.metrics.bytes for r in reports) / wall / n_workers / 1e6,
        "blocked_s": sum(r.metrics.blocked_seconds for r in reports),
        "backpressure": bp,
        "majors_all_tablets": sum(t.major_compactions for t in tablets),
        "minors_all_tablets": sum(t.minor_compactions for t in tablets),
        "rate_p50": float(np.percentile(rate, 50)) if rate.size else 0.0,
        "rate_p99": float(np.percentile(rate, 99)) if rate.size else 0.0,
        "rate_buckets": int(rate.size), "per_worker": workers,
    }
    return row


def run_pipeline(seed, dev, zero_launches, read_launches, files=PIPELINE_FILES,
                 lines=PIPELINE_LINES):
    """Path 6: stage the files, ingest them with W = 4 and W = 1 workers into
    fresh host stores on the card, query the W = 4 store with the host
    QueryProcessor, tokenize it. Returns (report, the W = 4 store, its
    tokenizer, the (32, 112) token prompts, the launches of the path)."""
    import shutil

    import numpy as np
    from repro_torch.configs.llcysa import PIPELINE as P
    from repro_torch.core import And, Eq, QueryProcessor, QueryStats
    from repro_torch.core.schema import web_proxy_schema
    from repro_torch.core.store import EventStore
    from repro_torch.pipeline import EventTokenizer, SyntheticWebProxySource
    from repro_torch.pipeline.sources import parse_web_proxy_lines

    stage = os.path.join(ROOT, "build", "pipeline_staged")  # gitignored
    shutil.rmtree(stage, ignore_errors=True)
    report = {}
    try:
        t0 = time.perf_counter()
        source = SyntheticWebProxySource(seed=seed + 3)
        paths = source.write_files(stage, files, lines, 0, T_SPAN)
        domain_counts, pair_counts, nbytes = Counter(), Counter(), 0
        for p in paths:
            with open(p) as f:
                text = f.readlines()
            nbytes += sum(len(x) for x in text)
            _, vals = parse_web_proxy_lines(text)
            domain_counts.update(vals["domain"])
            pair_counts.update(zip(vals["domain"], vals["status"]))
        events = files * lines
        report["staging"] = {"files": files, "lines_per_file": lines, "events": events,
                             "bytes": nbytes, "seconds": time.perf_counter() - t0}
        log("pipeline", f"staged {files} files of {lines} lines ({events} events, {nbytes} "
            f"bytes) in {report['staging']['seconds']:.3f} s (set-up, untimed)")

        def make_store():
            return EventStore(web_proxy_schema(), n_shards=P.n_shards, flush_rows=P.flush_rows,
                              max_runs=P.max_runs, agg_bucket_seconds=P.agg_bucket_seconds,
                              seed=seed, device=dev)

        zero_launches()
        stores, runs = {}, []
        for w in (P.n_ingest_workers, 1):
            store = make_store()
            before = read_launches()["merge_runs"]
            row, merge_ms, merge_events = profiled_kernels(
                lambda: pool_ingest(store, paths, w, P.batch_rows), ("merge_path_kernel",))
            row["merge_runs_launches"] = read_launches()["merge_runs"] - before
            row["merge_runs_device_ms"] = merge_ms
            row["merge_runs_profiled_kernels"] = merge_events
            check(store.total_rows == events and store.backpressure_stats()["rows"] == events,
                  f"W = {w}: the store holds {store.total_rows} rows, the files {events}")
            # Every run is non-empty, so every major merges two or more
            # non-empty runs and launches the kernel exactly once.
            check(row["merge_runs_launches"] == row["majors_all_tablets"] > 0,
                  f"W = {w}: merge_runs launched {row['merge_runs_launches']} times for "
                  f"{row['majors_all_tablets']} majors")
            log("pipeline", json.dumps({k: v for k, v in row.items() if k != "per_worker"}))
            for wr in row["per_worker"]:
                log("pipeline", f"W = {w} " + json.dumps(wr))
            stores[w] = store
            runs.append(row)
        report["ingest"] = runs

        store = stores[P.n_ingest_workers]
        tiers = pick_tiers(source, domain_counts)
        queries = [(tier, Eq("domain", dom), domain_counts[dom]) for tier, dom in tiers.items()]
        queries.append(("A and 404", And(Eq("domain", tiers["A"]), Eq("status", "404")),
                        pair_counts[(tiers["A"], "404")]))
        qp = QueryProcessor(store, w=P.planner_w, device=dev)
        qp1 = QueryProcessor(stores[1], w=P.planner_w, device=dev)
        qp_cpu = QueryProcessor(store, w=P.planner_w, device="cpu")
        # Event keys carry a 16-bit hash, so a few rows of one shard and
        # second share a key; the index schemes fetch one row per key and
        # run (the reference's semantics), so their totals may differ from
        # the files' by at most the rows whose key is shared.
        shared_key_rows = 0
        for t in store.event_tablets:
            _, n_key = np.unique(np.concatenate([r.keys for r in t.snapshot_runs()]),
                                 return_counts=True)
            shared_key_rows += int(n_key[n_key > 1].sum())
        report["shared_key_rows"] = shared_key_rows
        log("pipeline", f"{shared_key_rows} event rows share their shard and key with another")
        spec = agg_specs()["a count/status/hour"]
        rows = []
        for label, tree, want in queries:
            for scheme in SCHEMES:
                stats = QueryStats()
                t0 = time.perf_counter()
                it = qp.run_scheme(scheme, 0, T_SPAN, tree, stats=stats)
                got = 0
                ttfr = None
                for blk in it:
                    ttfr = ttfr if ttfr is not None else time.perf_counter() - t0
                    got += blk.n
                total = time.perf_counter() - t0
                if scheme.endswith("index"):
                    on_cpu = sum(b.n for b in qp_cpu.run_scheme(scheme, 0, T_SPAN, tree))
                    check(got == on_cpu and abs(got - want) <= shared_key_rows,
                          f"path 6 {label} {scheme}: {got} rows, the CPU processor's "
                          f"{on_cpu}, the files hold {want} ({shared_key_rows} rows share "
                          f"a key)")
                else:
                    check(got == want, f"path 6 {label} {scheme}: {got} rows, the files hold "
                          f"{want}")
                rows.append({"query": label, "scheme": scheme, "rows": got, "want": want,
                             "ttfr_s": ttfr, "total_s": total, "batches": stats.batches,
                             "plan": stats.plan.describe() if stats.plan else None})
            t0 = time.perf_counter()
            agg = qp.aggregate(spec, 0, T_SPAN, tree)
            agg_s = time.perf_counter() - t0
            agg1 = qp1.aggregate(spec, 0, T_SPAN, tree)
            # The two stores' dictionaries number values in the order the
            # workers met them, so the groups are compared decoded.
            decoded = [sorted(tuple(sorted(r.items())) for r in a.rows(st))
                       for a, st in ((agg, store), (agg1, stores[1]))]
            check(decoded[0] == decoded[1] and int(agg.counts.sum()) == want,
                  f"path 6 {label} spec (a): W = 4 and W = 1 stores differ, or the counts "
                  f"sum to {agg.counts.sum()} against {want}")
            rows.append({"query": label, "scheme": "aggregate a", "rows": int(agg.counts.sum()),
                         "groups": agg.n_groups, "total_s": agg_s})
        for r in rows:
            log("pipeline", "[query] " + json.dumps(r))
        report["queries"] = rows

        tok = EventTokenizer(store, vocab_size=32768)
        seq_len = LM_PROMPT_EVENTS * tok.tokens_per_event
        t0 = time.perf_counter()
        prompts = next(tok.sequences(0, T_SPAN, seq_len=seq_len, batch=LM_REQUESTS))
        check(tok.tokens_per_event == 14, f"tokens_per_event {tok.tokens_per_event} != 14")
        check(prompts.shape == (LM_REQUESTS, seq_len) and int(prompts.min()) >= 0
              and int(prompts.max()) < 32768, f"token batch {prompts.shape} out of range "
              f"[{prompts.min()}, {prompts.max()}]")
        report["tokenize"] = {"seconds": time.perf_counter() - t0, "shape": list(prompts.shape),
                              "tokens_per_event": tok.tokens_per_event}
        launches = read_launches()
        del stores[1]
    finally:
        shutil.rmtree(stage, ignore_errors=True)
    return report, store, tok, prompts, launches


def serve_prompts(cfg, params, dev, prompts, base_alloc, tag, prefilled=False,
                  profiled_calls=10):
    """Path 7's traffic on ``params``: after a 2-request warm-up,
    ServeEngine(max_batch LM_MAX_BATCH, cache_len LM_CACHE_LEN) answers
    ``prompts`` with LM_NEW_TOKENS new tokens each, and every request must
    finish with that many tokens in range. Then where a round's time goes:
    one decode step of every slot and one prompt's prefill, with host
    dispatch (cuda_ms) and on the device alone (every CUDA activity in a
    profiler window of ``profiled_calls`` calls). The step feeds zeros to
    zero caches or, ``prefilled``, is the engine's first decode round of
    the first LM_MAX_BATCH prompts: each prefilled alone into its slot,
    its last token fed again at its length.
    Returns (the serve report, the breakdown, the decode step as a
    function of no arguments, and the step's caches)."""
    import numpy as np
    import torch
    from repro_torch.models.model import decode_step, init_caches, prefill
    from repro_torch.serving import ServeEngine
    from repro_torch.tree import tree_leaves

    warm = ServeEngine(cfg, params, max_batch=2, cache_len=LM_CACHE_LEN, device=dev)
    for p in prompts[:2]:
        warm.submit(p, max_new_tokens=2)
    warm.run()
    del warm
    torch.cuda.synchronize(dev)
    eng = ServeEngine(cfg, params, max_batch=LM_MAX_BATCH, cache_len=LM_CACHE_LEN, device=dev)
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(p, max_new_tokens=LM_NEW_TOKENS)
    done = eng.run()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    check(len(done) == len(prompts), f"{cfg.name}: {len(done)} of {len(prompts)} requests "
          "finished")
    for r in done:
        check(len(r.output) == LM_NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in r.output),
              f"{cfg.name} request {r.rid}: {len(r.output)} tokens, range "
              f"{min(r.output)}..{max(r.output)}")
    ttft = np.asarray(sorted(r.ttft for r in done))
    e2e = np.asarray(sorted(r.finished_at - r.submitted_at for r in done))
    rounds = eng.batcher.history
    serve = {
        "requests": len(done), "prompt_tokens": int(prompts.shape[1]),
        "new_tokens": LM_NEW_TOKENS, "max_batch": LM_MAX_BATCH, "cache_len": LM_CACHE_LEN,
        "wall_s": wall, "rounds": len(rounds), "round_s_sum": sum(t for t, _ in rounds),
        "ttft_p50_s": float(np.percentile(ttft, 50)), "ttft_p95_s": float(np.percentile(ttft, 95)),
        "e2e_p50_s": float(np.percentile(e2e, 50)),
        "decode_tokens_per_s": sum(n for _, n in rounds) / wall,
        "final_k": eng.batcher.k,
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(dev),
        "allocated_before_bytes": base_alloc,
    }
    log(tag, f"{cfg.name} served: " + json.dumps(serve))
    del eng

    x = torch.from_numpy(prompts.astype(np.int64)).to(dev)
    slots = init_caches(params, cfg, LM_MAX_BATCH, LM_CACHE_LEN)
    tok1 = torch.zeros((LM_MAX_BATCH, 1), dtype=torch.int64, device=dev)
    if prefilled:
        for i in range(LM_MAX_BATCH):
            _, one, _ = prefill(params, cfg, {"inputs": x[i:i + 1]}, cache_len=LM_CACHE_LEN)
            for pool, leaf in zip(tree_leaves(slots), tree_leaves(one)):
                pool[:, i:i + 1] = leaf
        tok1 = x[:LM_MAX_BATCH, -1:]
    pos = torch.full((LM_MAX_BATCH,), x.shape[1], dtype=torch.int32, device=dev)

    def step():
        return decode_step(params, cfg, {"inputs": tok1}, slots, pos)

    def prefill_one():
        return prefill(params, cfg, {"inputs": x[:1]}, cache_len=LM_CACHE_LEN)

    breakdown = {
        "decode_step_ms": cuda_ms(step),
        "decode_step_device_ms": device_ms(step, ("",), calls=profiled_calls),
        "prefill_ms": cuda_ms(prefill_one),
        "prefill_device_ms": device_ms(prefill_one, ("",), calls=profiled_calls),
    }
    log(tag, f"{cfg.name}: one decode step of the {LM_MAX_BATCH} slots and one prompt's "
        "prefill: " + json.dumps(breakdown))
    return serve, breakdown, step, slots


def run_lm_serve(seed, dev, tok, prompts):
    """Path 7: llcysa-analytics-100m at full width in bf16 (seeded init)
    behind ServeEngine; decode against prefill in float32 on the same
    prompts; the per-window NLL scores of examples/cyber_pipeline.py step 5."""
    import numpy as np
    import torch
    from repro_torch.configs.llcysa import CONFIG as cfg
    from repro_torch.models.model import (
        cast_params, decode_step, forward_train, init_params, prefill,
    )

    report = {"config": {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                         "n_heads": cfg.n_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                         "dtype": cfg.dtype, "params": cfg.param_count()}}
    base_alloc = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    report["serve"], report["breakdown"], _, _ = serve_prompts(cfg, params, dev, prompts,
                                                               base_alloc, "lm")
    x = torch.from_numpy(prompts.astype(np.int64)).to(dev)
    s = x.shape[1]

    # Decode against prefill in float32: the prompts prefilled once, then
    # LM_NEW_TOKENS greedy decode steps, each step's logits held to a
    # prefill over the prompt plus the tokens generated so far.
    cfg32 = cfg.replace(dtype="float32")
    p32 = cast_params(params, torch.float32)
    logits, caches, _ = prefill(p32, cfg32, {"inputs": x}, cache_len=s + LM_NEW_TOKENS)
    gen = [torch.argmax(logits, dim=-1)]
    errs = []
    for j in range(LM_NEW_TOKENS):
        ld, caches = decode_step(p32, cfg32, {"inputs": gen[-1][:, None]}, caches,
                                 torch.full((x.shape[0],), s + j, device=dev))
        seq = torch.cat([x, torch.stack(gen, dim=1)], dim=1)
        lf, _, _ = prefill(p32, cfg32, {"inputs": seq})
        errs.append(float((ld - lf).abs().max()))
        gen.append(torch.argmax(ld, dim=-1))
    report["decode_vs_prefill"] = {"steps": LM_NEW_TOKENS, "max_abs_err": max(errs),
                                   "per_step": errs, "atol": LM_DECODE_ATOL}
    check(max(errs) < LM_DECODE_ATOL, f"float32 decode differs from prefill by {max(errs)}")
    log("lm", f"float32 decode vs prefill over {LM_NEW_TOKENS} steps of {x.shape[0]} "
        f"sequences: max |err| {max(errs):.3e} < {LM_DECODE_ATOL}")
    del p32, caches

    # examples/cyber_pipeline.py step 5: LM surprise per one-hour window.
    scores = []
    for w0 in range(0, T_SPAN, 3600):
        raw = next(tok.sequences(w0, w0 + 3600, seq_len=129, batch=2, seed=w0))
        raw = torch.from_numpy(raw.astype(np.int64)).to(dev)
        loss, _ = forward_train(params, cfg, {"inputs": raw[:, :-1], "targets": raw[:, 1:]})
        scores.append(float(loss))
    check(all(np.isfinite(scores)), f"window NLL scores not finite: {scores}")
    report["window_nll"] = scores
    log("lm", f"window NLL per hour {scores}")
    return report


# Path 8: llcysa-analytics-100m trained at full width on path 6's token
# sequences at train_4k's length, the global batch cut from 256 to 16 (4
# microbatches of 4) to fit the run's time.
TRAIN_SEQ = 4096
TRAIN_BATCH = 16
TRAIN_ACCUM = 4
TRAIN_STEPS = 20
TRAIN_CKPT_STEP = 10  # the CheckpointManager save the resume check restarts from
TRAIN_PROFILED_STEP = 15  # this step runs in a torch.profiler window
# The two compress_grads steps: 4 sequences as 2 microbatches, so that the
# gradients are float32 sums (a bf16 gradient is its own compression and
# leaves the error tree at zero).
TRAIN_COMPRESS_BATCH, TRAIN_COMPRESS_ACCUM = 4, 2
# The flash backward at one (1, 4,096, 12, 64) float32 sequence against
# autograd of the naive attention: elementwise atol + rtol * |naive| (sums
# of 4,096 terms in other orders; tests/test_torch_gpu.py's bound).
FLASH_CHECK_RTOL, FLASH_CHECK_ATOL = 1e-3, 1e-4
# NVIDIA's H100 SXM data sheet: dense bf16 tensor-core peak, at 700 W.
H100_BF16_PEAK_FLOPS = 989e12


def train_flops(cfg, batch, seq):
    """Model FLOPs of one train step, from the config: 6 N per token for
    the weights (forward 2, backward 4) and the causal attention's two
    products, S (S + 1) / 2 query-key pairs a sequence (forward once,
    backward twice); with remat also one more forward of every layer and
    of the loss's logits (8 N per token, the attention 4 times)."""
    n = cfg.param_count()
    tokens = batch * seq
    attn_fwd = cfg.n_layers * batch * 4 * cfg.n_heads * cfg.head_dim_ * seq * (seq + 1) // 2
    return {"params": n, "tokens": tokens, "attention_forward": attn_fwd,
            "model": 6 * n * tokens + 3 * attn_fwd,
            "with_remat": 8 * n * tokens + 4 * attn_fwd}


def trees_identical(a, b):
    import torch
    from repro_torch.tree import tree_flatten

    (la, da), (lb, db) = tree_flatten(a), tree_flatten(b)
    return da == db and all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
                            for x, y in zip(la, lb))


def flash_backward_check(dev, seed, shape=(1, TRAIN_SEQ, 12, 64), **kw):
    """The flash backward on the card against autograd of the naive
    attention at one float32 sequence of ``shape`` (B, S, H, D), causal,
    with the attention options ``kw`` (window, softcap_val, scale)."""
    import torch
    from repro_torch.models.attention import flash_attention, naive_attention

    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, w = (torch.randn(shape, generator=g, device=dev) for _ in range(4))

    def run(fn):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*xs, causal=True, **kw)
        (out * w).sum().backward()
        return [out.detach()] + [x.grad for x in xs]

    got, want = run(flash_attention), run(naive_attention)
    errs, ok = [], True
    for a, b in zip(got, want):
        d = (a - b).abs()
        errs.append(float(d.max()))
        ok &= bool((d <= FLASH_CHECK_ATOL + FLASH_CHECK_RTOL * b.abs()).all())
    row = {"shape": list(shape), "dtype": "float32", **kw, "max_abs_err": dict(zip(
        ("out", "dq", "dk", "dv"), errs)), "rtol": FLASH_CHECK_RTOL, "atol": FLASH_CHECK_ATOL,
        "flash_fwd_bwd_ms": cuda_ms(lambda: run(flash_attention)),
        "naive_fwd_bwd_ms": cuda_ms(lambda: run(naive_attention))}
    check(ok, f"flash backward on the card differs from naive autograd: {row}")
    return row


def profiled_breakdown(fn, top=12):
    """fn() once under a torch.profiler window (CUDA activity only).
    Returns (fn's result, device ms of every event, the number of events,
    the ``top`` kernel names by device ms as [name, ms, count])."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    by_name, total, n = {}, 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            ms_n = by_name.setdefault(e.name[:120], [0.0, 0])
            ms_n[0] += us / 1e3
            ms_n[1] += 1
            total += us / 1e3
            n += 1
    ranked = sorted(([k, v[0], v[1]] for k, v in by_name.items()), key=lambda r: -r[1])
    return out, total, n, ranked[:top]


def run_lm_train(seed, dev, tok):
    """Path 8: llcysa-analytics-100m at full width in bf16 (seeded init,
    float32 Adam state) trained for 20 steps through build_train_step with
    remat at S = 4,096 on path 6's token sequences; a CheckpointManager
    save after step 10, restored and resumed for two steps that must equal
    steps 11-12 bit for bit; two compress_grads steps; the flash backward
    against naive autograd."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.checkpointing import CheckpointManager
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs.llcysa import CONFIG as cfg
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import init_params
    from repro_torch.training.optimizer import OptConfig, adamw_init
    from repro_torch.tree import tree_leaves

    report = {"config": {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                         "n_heads": cfg.n_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                         "dtype": cfg.dtype, "params": cfg.param_count()},
              "shape": {"seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
                        "accum_steps": TRAIN_ACCUM, "steps": TRAIN_STEPS, "remat": True}}
    t0 = time.perf_counter()
    seqs = tok.sequences(0, T_SPAN, seq_len=TRAIN_SEQ + 1, batch=TRAIN_BATCH)
    batches = [torch.from_numpy(next(seqs)).to(dev) for _ in range(TRAIN_STEPS)]
    check(all(b.shape == (TRAIN_BATCH, TRAIN_SEQ + 1) and int(b.min()) >= 0
              and int(b.max()) < cfg.vocab_size for b in batches),
          "path 8's token batches are out of shape or range")
    report["data"] = {"seconds": time.perf_counter() - t0, "batches": len(batches),
                      "tokens": TRAIN_STEPS * TRAIN_BATCH * (TRAIN_SEQ + 1)}
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    report["flops_per_step"] = flops

    ckpt_dir = os.path.join(ROOT, "build", "train_ckpt")  # gitignored
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS)
    shape = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    step = build_train_step(cfg, shape, opt_cfg, remat=True, accum_steps=TRAIN_ACCUM,
                            device=dev)
    base_alloc = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    state = adamw_init(params, opt_cfg)
    mgr = CheckpointManager(ckpt_dir, keep=1)

    def batch_of(i):
        return {"inputs": batches[i][:, :-1], "targets": batches[i][:, 1:]}

    # Bitwise resume needs deterministic kernels (the embedding's backward
    # accumulates with atomics otherwise); chip_smoke sets
    # CUBLAS_WORKSPACE_CONFIG before CUDA starts.
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        losses, grad_norms, step_s, kept = [], [], [], {}
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            if i == TRAIN_PROFILED_STEP:
                (params, state, m), device_ms, profiled, top_kernels = profiled_breakdown(
                    lambda: step(params, state, batch_of(i)))
            else:
                params, state, m = step(params, state, batch_of(i))
                torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            grad_norms.append(float(m["grad_norm"]))
            if i + 1 == TRAIN_CKPT_STEP:
                report["peak_allocated_bytes_steps_1_10"] = torch.cuda.max_memory_allocated(dev)
                mgr.save(TRAIN_CKPT_STEP, {"params": params, "opt_state": state})
                kept[TRAIN_CKPT_STEP] = (params, state)
            if i + 1 == TRAIN_CKPT_STEP + 2:
                kept[TRAIN_CKPT_STEP + 2] = (params, state, losses[-2:])
        mgr.wait()
        timed = [s for i, s in enumerate(step_s) if i not in (0, TRAIN_PROFILED_STEP)]
        step_ms = 1e3 * float(np.median(timed))
        report["train"] = {
            "losses": losses, "grad_norms": grad_norms, "step_s": step_s,
            "step_ms_median": step_ms, "step_ms_first": 1e3 * step_s[0],
            "tokens_per_s": flops["tokens"] / (step_ms / 1e3),
            "device_ms_one_step": device_ms, "profiled_device_events": profiled,
            "top_kernels_one_step": top_kernels,
            "device_busy_share": device_ms / step_ms,
            "model_tflops_per_s": flops["model"] / (step_ms / 1e3) / 1e12,
            "model_share_of_bf16_peak": flops["model"] / (step_ms / 1e3) / H100_BF16_PEAK_FLOPS,
            "with_remat_share_of_bf16_peak":
                flops["with_remat"] / (step_ms / 1e3) / H100_BF16_PEAK_FLOPS,
            "peak_source": "NVIDIA H100 SXM data sheet, 989 TFLOP/s dense bf16 at 700 W",
            "allocated_before_bytes": base_alloc,
            "peak_allocated_bytes_steps_1_10": report.pop("peak_allocated_bytes_steps_1_10"),
        }
        log("train", json.dumps({k: v for k, v in report["train"].items()
                                 if k not in ("losses", "grad_norms", "step_s",
                                              "top_kernels_one_step")}))
        for row in top_kernels:
            log("train", "[kernel time, one step] " + json.dumps(row))
        log("train", "loss per step " + json.dumps(losses))
        check(all(np.isfinite(losses)), f"path 8 losses not finite: {losses}")
        check(losses[-1] < 0.9 * losses[0], f"path 8's loss fell from {losses[0]} to only "
              f"{losses[-1]} (must end below 0.9 x the first)")

        # Resume: the step-10 checkpoint restores on the card bit for bit,
        # and two steps from it equal the uninterrupted steps 11-12.
        p10, s10 = kept[TRAIN_CKPT_STEP]
        restored_step, restored = mgr.restore_latest({"params": params, "opt_state": state})
        check(restored_step == TRAIN_CKPT_STEP and trees_identical(
            restored, {"params": p10, "opt_state": s10}) and all(
            x.device == dev for x in tree_leaves(restored)),
            "the step-10 checkpoint did not restore bit for bit on the card")
        p, s = restored["params"], restored["opt_state"]
        resumed = []
        for i in (TRAIN_CKPT_STEP, TRAIN_CKPT_STEP + 1):
            p, s, m = step(p, s, batch_of(i))
            resumed.append(float(m["loss"]))
        p12, s12, l12 = kept[TRAIN_CKPT_STEP + 2]
        same = trees_identical(p, p12) and trees_identical(s, s12) and resumed == l12
        report["resume"] = {"from_step": restored_step, "losses": resumed, "uninterrupted": l12,
                            "bitwise_equal": same}
        check(same, f"two steps resumed from step 10 differ from steps 11-12: {resumed} "
              f"against {l12}")
        log("train", f"resumed from the step-{restored_step} checkpoint: steps 11-12 equal "
            f"the uninterrupted run bit for bit (params, optimizer state, losses {resumed})")
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del kept, p, s, p10, s10, p12, s12, restored

    # Two steps with error-feedback bf16 compression.
    c_cfg = OptConfig(lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS, compress_grads=True)
    c_step = build_train_step(cfg, ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_COMPRESS_BATCH,
                                               "train"), c_cfg,
                              accum_steps=TRAIN_COMPRESS_ACCUM, device=dev)
    c_state = adamw_init(params, c_cfg)
    c_losses = []
    for i in range(2):
        b = batches[i][:TRAIN_COMPRESS_BATCH]
        params, c_state, m = c_step(params, c_state, {"inputs": b[:, :-1], "targets": b[:, 1:]})
        c_losses.append(float(m["loss"]))
    err_max = max(float(e.abs().max()) for e in tree_leaves(c_state["err"]))
    report["compress_grads"] = {"losses": c_losses, "err_max_abs": err_max}
    check(all(np.isfinite(c_losses)) and err_max > 0,
          f"compress_grads steps: losses {c_losses}, err tree max {err_max}")
    log("train", "two compress_grads steps: " + json.dumps(report["compress_grads"]))
    del params, state, c_state, batches

    report["flash_backward"] = flash_backward_check(dev, seed)
    log("train", "flash backward vs naive autograd on the card: "
        + json.dumps(report["flash_backward"]))
    return report


# Path 9: the attention-side families. 9a serves gemma2-9b at full width
# and depth with path 7's traffic; 9b holds float32 decode against prefill
# for one pattern period (two layers where the period is one) of each of
# the six configs at full width, the local configs' prompts past their
# window; 9c runs gemma2's local attention's flash backward at train_4k's
# length.
FAMILY_SERVE_ARCH = "gemma2-9b"
FAMILY_DECODE = {  # arch: (prompt length, cache_len), batch 1
    "gemma2-9b": (4160, 4224),  # window 4,096: the ring wraps at prefill
    "gemma3-12b": (1100, 1152),  # window 1,024
    "internlm2-20b": (112, 128),
    "qwen1.5-4b": (112, 128),
    "musicgen-medium": (112, 128),  # seeded frame embeddings, not tokens
    "llama-3.2-vision-11b": (112, 128),  # with seeded vision states (1, 1,601, 4,096)
}
FAMILY_DECODE_STEPS = 16
FAMILY_CROSS_GATE = 0.5  # the cross gates init at 0 (tanh 0: the layer adds nothing)
FAMILY_FLASH_SHAPE = (1, TRAIN_SEQ, 16, 256)
FAMILY_FLASH_KW = dict(window=1024, softcap_val=50.0, scale=1.0 / 16.0)  # gemma2's local layer


def run_family_serve(seed, dev, prompts):
    """Path 9a: gemma2-9b at full width and depth in bf16 (seeded init on
    a CUDA generator) behind ServeEngine, path 7's traffic and breakdown,
    and the decode step's device time by kernel."""
    import torch
    from repro_torch.models import get_config
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_leaves

    cfg = get_config(FAMILY_SERVE_ARCH)
    report = {"config": {"name": cfg.name, "n_layers": cfg.n_layers,
                         "layer_pattern": list(cfg.layer_pattern), "d_model": cfg.d_model,
                         "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                         "head_dim": cfg.head_dim_, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                         "window": cfg.window, "dtype": cfg.dtype,
                         "params": cfg.param_count()}}
    base_alloc = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize(dev)
    report["init_s"] = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    check(abs(n_params - cfg.param_count()) / n_params < 0.02,
          f"{cfg.name}: {n_params} parameters, the config counts {cfg.param_count()}")
    report["config"]["params_allocated"] = n_params
    report["weights_bytes"] = sum(t.numel() * t.element_size() for t in leaves)
    del leaves
    report["serve"], report["breakdown"], step, _ = serve_prompts(cfg, params, dev, prompts,
                                                                  base_alloc, "family")
    report["breakdown"]["weights_read_bound_ms"] = (1e3 * report["weights_bytes"]
                                                    / HBM_BYTES_PER_S)
    _, _, _, report["top_kernels_decode_step"] = profiled_breakdown(step)
    for row in report["top_kernels_decode_step"]:
        log("family", "[kernel time, one decode step] " + json.dumps(row))
    del step, params
    return report


def family_decode_check(seed, dev, arch):
    """Path 9b for one config: one pattern period (at least two layers) at
    full width in float32 from a seeded init; a prompt prefilled once, then
    FAMILY_DECODE_STEPS decode steps (greedy tokens; musicgen the next
    seeded frame embeddings), each step's logits held to a prefill over the
    prompt plus the inputs seen so far."""
    import torch
    from repro_torch.models import get_config
    from repro_torch.models.model import decode_step, init_params, prefill

    full = get_config(arch)
    cfg = full.replace(n_layers=max(len(full.layer_pattern), 2), dtype="float32")
    s, cache_len = FAMILY_DECODE[arch]
    steps = FAMILY_DECODE_STEPS
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, g, device=dev)
    for layer in params["groups"]:
        for name in ("gate_attn", "gate_mlp"):
            if name in layer:
                layer[name].fill_(FAMILY_CROSS_GATE)
    extra = {}
    if "cross" in cfg.layer_pattern:
        extra["vision_states"] = torch.randn((1, cfg.n_image_tokens, cfg.d_model), generator=g,
                                             device=dev)
    if cfg.embed_input:
        seq = torch.randint(0, cfg.vocab_size, (1, s), generator=g, device=dev)
    else:
        seq = torch.randn((1, s + steps, cfg.d_model), generator=g, device=dev)
    key = "inputs" if cfg.embed_input else "embeds"
    logits, caches, _ = prefill(params, cfg, {key: seq[:, :s], **extra}, cache_len=cache_len)
    slots = {kind: c["k"].shape[2] for kind, c in zip(cfg.layer_pattern, caches)}
    errs = []
    for j in range(steps):
        if cfg.embed_input:
            seq = torch.cat([seq, torch.argmax(logits, dim=-1)[:, None]], dim=1)
        t = s + j
        ld, caches = decode_step(params, cfg, {key: seq[:, t:t + 1]}, caches,
                                 torch.full((1,), t, device=dev))
        lf, _, _ = prefill(params, cfg, {key: seq[:, :t + 1], **extra})
        errs.append(float((ld - lf).abs().max()))
        logits = ld
    torch.cuda.synchronize(dev)
    row = {"arch": arch, "n_layers": cfg.n_layers, "layer_pattern": list(cfg.layer_pattern),
           "d_model": cfg.d_model, "params": cfg.param_count(), "prompt": s,
           "cache_len": cache_len, "cache_slots": slots, "steps": steps,
           "ring_wrapped": "local" in slots and s > slots["local"],
           "max_abs_err": max(errs), "per_step": errs, "atol": LM_DECODE_ATOL,
           "seconds": time.perf_counter() - t0}
    del params, caches
    check(max(errs) < LM_DECODE_ATOL, f"path 9b {arch}: float32 decode differs from prefill "
          f"by {max(errs)}")
    check("local" not in slots or row["ring_wrapped"],
          f"path 9b {arch}: the prompt of {s} did not wrap the ring of {slots}")
    return row


def run_families(seed, dev, prompts):
    """Path 9: 9a gemma2-9b served, 9b decode against prefill for every
    config of the family, 9c the windowed, capped flash backward."""
    report = {"serve": run_family_serve(seed, dev, prompts), "decode_vs_prefill": []}
    for arch in FAMILY_DECODE:
        row = family_decode_check(seed, dev, arch)
        report["decode_vs_prefill"].append(row)
        log("family", "float32 decode vs prefill: " + json.dumps(
            {k: v for k, v in row.items() if k != "per_step"}))
    report["flash_backward"] = flash_backward_check(dev, seed, FAMILY_FLASH_SHAPE,
                                                    **FAMILY_FLASH_KW)
    log("family", "windowed, capped flash backward vs naive autograd on the card: "
        + json.dumps(report["flash_backward"]))
    return report


# Path 10: the LM's MoE and SSM families. 10a serves moonshot-v1-16b-a3b
# at full width and depth (56.1 GB of bf16 weights fit one card beside
# what paths 1-9 hold) and 10b zamba2-2.7b uncut, with path 7's traffic;
# 10c holds float32 decode against prefill for the four configs at full
# width and cut depth. phi3.5-moe-42b-a6.6b (83.7 GB in bf16) does not fit
# one card whole, so it runs in 10c alone.
MOE_SSM_SERVE = ("moonshot-v1-16b-a3b", "zamba2-2.7b")
MOE_SSM_DECODE = {  # arch: (layers, prompt length, cache_len), batch 1, float32
    "moonshot-v1-16b-a3b": (2, 112, 128),
    "phi3.5-moe-42b-a6.6b": (2, 112, 128),
    "mamba2-780m": (2, 600, 640),  # chunks of 256: three, the last padded
    "zamba2-2.7b": (6, 600, 640),  # one pattern period: 5 SSM layers and the shared block
}
MOE_SSM_CAPACITY = 16.0  # no token drops, as tests/test_models.py holds MoE decode
MOE_SSM_PROFILED_CALLS = 3  # a 48-layer step is thousands of kernels: keep the window short


def picked_experts(step):
    """Run step() once and return, per MoE layer in order, the number of
    distinct experts its router picked over the step's tokens."""
    import torch
    import repro_torch.models.model as model_mod

    moe_ffn = model_mod.moe_ffn
    picked = []

    def counting(params, x, *, top_k, **kw):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ params["router"], dim=-1)
        picked.append(int(torch.unique(torch.topk(probs, top_k, dim=-1).indices).numel()))
        return moe_ffn(params, x, top_k=top_k, **kw)

    model_mod.moe_ffn = counting
    try:
        step()
    finally:
        model_mod.moe_ffn = moe_ffn
    return picked


def decode_read_bytes(params, caches, n_slots, picked=None):
    """The bytes one decode step of ``n_slots`` slots must read: every
    weight leaf once, but the embedding (its slots' rows) and, with
    ``picked`` (distinct experts per layer), only the picked experts of
    each MoE leaf; every cache leaf once."""
    from repro_torch.tree import tree_leaves

    def nbytes(t):
        return t.numel() * t.element_size()

    total = sum(nbytes(t) for t in tree_leaves(caches))
    for name, t in params.items():
        if name == "embed":
            total += n_slots * t.shape[1] * t.element_size()
        elif name != "groups":
            total += sum(nbytes(x) for x in tree_leaves(t))
    for layer in params["groups"]:
        for name, t in layer.items():
            if name == "moe" and picked is not None:
                total += nbytes(t["router"])
                per_expert = sum(nbytes(t[k][0, 0]) for k in ("wi_gate", "wi_up", "wo"))
                total += per_expert * sum(picked)
            else:
                total += sum(nbytes(x) for x in tree_leaves(t))
    return total


def run_moe_ssm_serve(seed, dev, prompts, arch):
    """Path 10a/10b: ``arch`` at full width and depth in bf16 (seeded init
    on a CUDA generator) behind ServeEngine with path 7's traffic; the
    decode step (the engine's first round of 8 prefilled prompts) and
    one prefill with dispatch and on the device, the step's device time
    by kernel, and its read bound over 3.35 TB/s."""
    import torch
    from repro_torch.models import get_config
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    # Path 6's tokenizer has 32,768 ids, zamba2 32,000: ids past the
    # vocabulary wrap around it.
    prompts = prompts % cfg.vocab_size
    report = {"config": {"name": cfg.name, "n_layers": cfg.n_layers,
                         "layer_pattern": list(cfg.layer_pattern), "d_model": cfg.d_model,
                         "n_heads": cfg.n_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
                         "n_experts": cfg.n_experts, "top_k": cfg.top_k,
                         "ssm_state": cfg.ssm_state, "dtype": cfg.dtype,
                         "params": cfg.param_count()}}
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    report["mem_get_info_before"] = {"free_bytes": free, "total_bytes": total,
                                     "allocated_bytes": torch.cuda.memory_allocated(dev)}
    log("moe_ssm", f"{cfg.name}: before init " + json.dumps(report["mem_get_info_before"]))
    weights = cfg.param_count() * 2  # bf16
    check(weights < free, f"{cfg.name}: {weights} B of weights do not fit the {free} B free")
    base_alloc = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize(dev)
    report["init_s"] = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    check(abs(n_params - cfg.param_count()) / n_params < 0.02,
          f"{cfg.name}: {n_params} parameters, the config counts {cfg.param_count()}")
    report["config"]["params_allocated"] = n_params
    report["weights_bytes"] = sum(t.numel() * t.element_size() for t in leaves)
    del leaves
    t0 = time.perf_counter()
    report["serve"], report["breakdown"], step, slots = serve_prompts(
        cfg, params, dev, prompts, base_alloc, "moe_ssm", prefilled=True,
        profiled_calls=MOE_SSM_PROFILED_CALLS)
    report["serve_and_breakdown_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    picked = picked_experts(step) if cfg.n_experts else None
    read = decode_read_bytes(params, slots, LM_MAX_BATCH, picked)
    report["breakdown"].update(
        read_bytes=read, read_bound_ms=1e3 * read / HBM_BYTES_PER_S,
        weights_read_bound_ms=1e3 * report["weights_bytes"] / HBM_BYTES_PER_S,
        experts_picked_per_layer=picked)
    log("moe_ssm", f"{cfg.name}: decode step read bound " + json.dumps(
        {k: report["breakdown"][k] for k in ("read_bytes", "read_bound_ms",
                                             "weights_read_bound_ms")})
        + (f"; distinct experts picked per layer {picked}" if picked else ""))
    _, _, _, report["top_kernels_decode_step"] = profiled_breakdown(step)
    report["bound_and_kernels_s"] = time.perf_counter() - t0
    for row in report["top_kernels_decode_step"]:
        log("moe_ssm", f"[kernel time, one {cfg.name} decode step] " + json.dumps(row))
    log("moe_ssm", f"{cfg.name}: seconds " + json.dumps(
        {k: report[k] for k in ("init_s", "serve_and_breakdown_s", "bound_and_kernels_s")}))
    del step, slots, params
    torch.cuda.empty_cache()
    return report


def moe_ssm_decode_check(seed, dev, arch):
    """Path 10c for one config: full width, MOE_SSM_DECODE's depth, float32
    from a seeded init, MoE at MOE_SSM_CAPACITY; a prompt prefilled once,
    then FAMILY_DECODE_STEPS greedy decode steps, each step's logits held
    to a prefill over the prompt plus the tokens generated so far."""
    import torch
    from repro_torch.models import get_config
    from repro_torch.models.model import decode_step, init_params, prefill

    full = get_config(arch)
    n_layers, s, cache_len = MOE_SSM_DECODE[arch]
    cfg = full.replace(n_layers=n_layers, dtype="float32")
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=MOE_SSM_CAPACITY)
    steps = FAMILY_DECODE_STEPS
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, g, device=dev)
    seq = torch.randint(0, cfg.vocab_size, (1, s), generator=g, device=dev)
    logits, caches, _ = prefill(params, cfg, {"inputs": seq}, cache_len=cache_len)
    errs = []
    for j in range(steps):
        seq = torch.cat([seq, torch.argmax(logits, dim=-1)[:, None]], dim=1)
        t = s + j
        ld, caches = decode_step(params, cfg, {"inputs": seq[:, t:t + 1]}, caches,
                                 torch.full((1,), t, device=dev))
        lf, _, _ = prefill(params, cfg, {"inputs": seq[:, :t + 1]})
        errs.append(float((ld - lf).abs().max()))
        logits = ld
    torch.cuda.synchronize(dev)
    ssm_layers = any(k.startswith("ssm") for k in cfg.layer_pattern)
    row = {"arch": arch, "n_layers": cfg.n_layers, "layer_pattern": list(cfg.layer_pattern),
           "d_model": cfg.d_model, "params": cfg.param_count(), "prompt": s,
           "cache_len": cache_len, "steps": steps,
           "capacity_factor": cfg.capacity_factor if cfg.n_experts else None,
           "ssm_chunks": -(-s // cfg.ssm_chunk) if ssm_layers else None,
           "max_abs_err": max(errs), "per_step": errs, "atol": LM_DECODE_ATOL,
           "seconds": time.perf_counter() - t0}
    del params, caches
    torch.cuda.empty_cache()
    check(max(errs) < LM_DECODE_ATOL, f"path 10c {arch}: float32 decode differs from prefill "
          f"by {max(errs)}")
    check(not ssm_layers or (s > 2 * cfg.ssm_chunk and s % cfg.ssm_chunk),
          f"path 10c {arch}: the prompt of {s} does not span three chunks of "
          f"{cfg.ssm_chunk}, the last padded")
    return row


def run_moe_ssm(seed, dev, prompts):
    """Path 10: 10a moonshot-v1-16b-a3b and 10b zamba2-2.7b served, 10c
    decode against prefill for the four MoE and SSM configs."""
    report = {"serve": {arch: run_moe_ssm_serve(seed, dev, prompts, arch)
                        for arch in MOE_SSM_SERVE},
              "decode_vs_prefill": []}
    for arch in MOE_SSM_DECODE:
        row = moe_ssm_decode_check(seed, dev, arch)
        report["decode_vs_prefill"].append(row)
        log("moe_ssm", "float32 decode vs prefill: " + json.dumps(
            {k: v for k, v in row.items() if k != "per_step"}))
    return report


MESH_TRAIN_SHAPE = (4, 4096)  # path 11a: global batch x sequence
MESH_PREFILL_SLOTS = 8
MESH_CACHE_LEN = 256
MESH_DECODE_STEPS = 16
MESH_RTOL, MESH_ATOL = 1e-5, 1e-5
MESH_TIMED_CALLS = 3
# A parameter's update may differ from the meshless one by more than this
# share of the step's learning rate only where Adam's first steps flip
# lr x sign(g) for a gradient within rounding of zero: on at most
# MESH_UPDATE_OFF_SHARE of the elements.
MESH_UPDATE_TOL, MESH_UPDATE_OFF_SHARE = 0.1, 1e-3
# Path 11b's cells on the production meshes, traced on a fake process group.
DRYRUN_CELLS = (("gemma2-9b", "train_4k", "single_pod"),
                ("moonshot-v1-16b-a3b", "decode_32k", "single_pod"),
                ("mamba2-780m", "long_500k", "multi_pod"))
DRYRUN_SCRIPT = """
import json, sys
from repro_torch.launch.dryrun import MESH_RANKS, fake_world, run_cell
for arch, shape, mesh in json.loads(sys.argv[1]):
    with fake_world(MESH_RANKS[mesh]):
        rec = run_cell(arch, shape, mesh)
    print("CELL " + json.dumps(rec), flush=True)
"""


def start_dryrun():
    """Path 11b in a subprocess on the host (CUDA hidden from it), run
    beside 11a: launch/dryrun.py's cells on fake process groups of 256 and
    512 ranks under FakeTensorMode."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", DRYRUN_SCRIPT, json.dumps(DRYRUN_CELLS)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_dryrun(proc, smi):
    """Path 11b's records: per cell the per-device peak, FLOPs, bytes,
    collective bytes by op, the three roofline terms and the bottleneck;
    each cell's parameter bytes per device must equal the spec tree's
    local shards', and the train cell must have collectives."""
    out, err = proc.communicate(timeout=900)
    check(proc.returncode == 0, f"path 11b: the dry-run failed: {err[-2000:]}")
    cells = [json.loads(l[len("CELL "):]) for l in out.splitlines() if l.startswith("CELL ")]
    check(len(cells) == len(DRYRUN_CELLS), f"path 11b: {len(cells)} of {len(DRYRUN_CELLS)} cells")
    rows = []
    for rec in cells:
        name = f"{rec['arch']} {rec['shape']} {rec['mesh']}"
        check(rec["param_bytes_per_device"] == rec["param_bytes_from_specs"],
              f"path 11b {name}: {rec['param_bytes_per_device']} parameter bytes per device, "
              f"the spec tree's shards hold {rec['param_bytes_from_specs']}")
        if rec["kind"] == "train":
            check(rec["collectives"]["total_bytes"] > 0, f"path 11b {name}: no collective")
        r = rec["roofline"]
        row = {"cell": name, "n_chips": rec["n_chips"], "mesh_shape": rec["mesh_shape"],
               "peak_gib": rec["memory"]["peak_bytes"] / 2**30,
               "argument_gib": rec["memory"]["argument_bytes"] / 2**30,
               "flops_per_device": rec["cost"]["flops_per_device"],
               "bytes_per_device": rec["cost"]["bytes_per_device"],
               "bytes_lower_per_device": rec["cost"]["bytes_lower_per_device"],
               "collective_bytes_by_op": rec["collectives"]["bytes_by_op"],
               "collective_count_by_op": rec["collectives"]["count_by_op"],
               "compute_s": r["compute_s"], "memory_s": r["memory_s"],
               "memory_lower_s": r["memory_lower_s"], "collective_s": r["collective_s"],
               "bottleneck": r["bottleneck"],
               "model_flops_per_device": rec["model_flops_per_device"],
               "useful_flop_ratio": rec["useful_flop_ratio"], "trace_s": rec["trace_s"],
               "param_bytes_per_device": rec["param_bytes_per_device"],
               "rates": "H100 SXM data sheet (launch/cost_analysis.py)", "card": smi}
        rows.append(row)
        log("mesh", "11b " + json.dumps(row))
    return rows


def opt_state_vs_plain(o_mesh, o_plain, params_mesh, params_plain, lr):
    """Path 11a's check of one train step's optimizer state and update:
    Adam's counts; the worst |mesh - plain| of m and of sqrt(v) (both
    continuous in the gradient) as a share of rtol 1e-5 x (|plain| + the
    leaf's max |plain|), at most 1 where within tolerance; and the share of
    parameter elements whose update (after - before) differs from the
    meshless one by more than MESH_UPDATE_TOL x lr (a skipped or wrong
    update is off by about lr nearly everywhere)."""
    import torch
    from repro_torch.tree import tree_leaves, tree_map

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def worst(got, want):
        w = 0.0
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            tol = MESH_RTOL * (b.abs() + b.abs().max())
            w = max(w, float(((full(a) - b).abs() / tol.clamp_min(1e-30)).max()))
        return w

    (after_m, before_m), (after_p, before_p) = params_mesh, params_plain
    off = n = 0
    for a, b, ap, bp in zip(*(tree_leaves(t) for t in (after_m, before_m, after_p, before_p))):
        d = (full(a) - full(b)) - (ap - bp)
        off += int((d.abs() > MESH_UPDATE_TOL * lr).sum())
        n += d.numel()
    return {"step": (int(o_plain["step"]), int(full(o_mesh["step"]))),
            "m_worst": worst(o_mesh["m"], o_plain["m"]),
            "sqrt_v_worst": worst(tree_map(lambda t: full(t).sqrt(), o_mesh["v"]),
                                  tree_map(torch.sqrt, o_plain["v"])),
            "update_off_share": off / n}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _timed(fn, calls=MESH_TIMED_CALLS):
    """fn()'s ms with host dispatch (the median of ``calls`` synchronized
    calls after a warm-up) and its device ms (one call in a profiler
    window, every CUDA event's time). Returns (ms, device ms, last
    result)."""
    import statistics

    import torch

    out = fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out, dev_ms, n_events, _ = profiled_breakdown(fn)
    return statistics.median(walls), dev_ms, out


def run_mesh_steps(seed, dev, prompts, smi):
    """Path 11a: llcysa-analytics-100m at full width and depth through
    launch/steps.py's builders on a (data=1, model=1) DeviceMesh of the one
    card (a one-rank NCCL group): two train steps of 4 x 4,096 tokens with
    ZeRO-1 and sequence parallelism, a prefill of 8 of path 7's prompts and
    16 greedy decode steps, each held in float32 to the meshless step from
    the same parameters and batch (loss and grad norm within rtol 1e-5,
    logits within rtol 1e-5 / atol 1e-5, greedy tokens equal), then timed
    in bf16 with the mesh and without."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs import llcysa as L
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.steps import build_step, build_train_step
    from repro_torch.models.model import cast_params, decode_step, init_params, prefill
    from repro_torch.training.optimizer import OptConfig, adamw_init

    cfg = L.CONFIG
    batch_n, seq = MESH_TRAIN_SHAPE
    report = {"config": {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                         "vocab": cfg.vocab_size, "params": cfg.param_count()},
              "train_shape": {"global_batch": batch_n, "seq_len": seq},
              "prefill": {"slots": MESH_PREFILL_SLOTS, "prompt": int(prompts.shape[1]),
                          "cache_len": MESH_CACHE_LEN}, "decode_steps": MESH_DECODE_STEPS,
              "card": smi}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_dev_mesh(1, 1, device_type=dev.type)
        report["mesh"] = dict(zip(mesh.mesh_dim_names, map(int, mesh.shape)))
        g = torch.Generator(device=dev).manual_seed(seed + 11)
        raw = torch.randint(0, cfg.vocab_size, (batch_n, seq + 1), generator=g, device=dev,
                            dtype=torch.int32)
        batch = {"inputs": raw[:, :-1], "targets": raw[:, 1:]}
        shape = ShapeConfig("train_4k", seq, batch_n, "train")
        opt_cfg = OptConfig()
        x = torch.from_numpy(prompts[:MESH_PREFILL_SLOTS].astype(np.int32)).to(dev)
        p_shape = ShapeConfig("prefill", MESH_CACHE_LEN, MESH_PREFILL_SLOTS, "prefill")
        d_shape = ShapeConfig("decode", MESH_CACHE_LEN, MESH_PREFILL_SLOTS, "decode")

        # float32: the mesh's steps against the meshless ones.
        cfg32 = cfg.replace(dtype="float32")
        params = init_params(cfg32, torch.Generator(device=dev).manual_seed(seed), device=dev)
        plain = build_train_step(cfg32, shape, opt_cfg, device=dev)
        meshed = build_train_step(cfg32, shape, opt_cfg, mesh=mesh, seq_parallel=True)
        p1, o1 = params, adamw_init(params, opt_cfg)
        p2, o2 = params, adamw_init(params, opt_cfg)
        train = []
        for i in range(2):
            q1, q2 = p1, p2
            p1, o1, m1 = plain(p1, o1, batch)
            p2, o2, m2 = meshed(p2, o2, batch)
            row = {k: (float(m1[k]), float(m2[k])) for k in ("loss", "grad_norm")}
            for k, (a, b) in row.items():
                check(abs(a - b) <= MESH_RTOL * abs(a), f"path 11a train step {i + 1}: {k} "
                      f"{b} on the mesh, {a} without (rtol {MESH_RTOL})")
            row.update(opt_state_vs_plain(o2, o1, (p2, q2), (p1, q1),
                                          float(m1["lr"])))
            check(row["step"][0] == row["step"][1] == i + 1,
                  f"path 11a train step {i + 1}: Adam's count {row['step']}")
            check(max(row["m_worst"], row["sqrt_v_worst"]) <= 1.0,
                  f"path 11a train step {i + 1}: Adam's m or sqrt(v) differ past rtol "
                  f"{MESH_RTOL} (worst share of the tolerance {row['m_worst']}, "
                  f"{row['sqrt_v_worst']})")
            check(row["update_off_share"] <= MESH_UPDATE_OFF_SHARE,
                  f"path 11a train step {i + 1}: {row['update_off_share']} of the parameters "
                  f"took another update on the mesh")
            train.append(row)
        report["float32_train"] = train
        del p1, o1, p2, o2, plain, meshed
        lg1, c1, lp1 = prefill(params, cfg32, {"inputs": x}, cache_len=MESH_CACHE_LEN)
        lg2, c2, lp2 = build_step(cfg32, p_shape, mesh)(params, {"inputs": x})
        lg2 = lg2.full_tensor()
        errs = [float((lg1 - lg2).abs().max())]
        check(torch.allclose(lg2, lg1, rtol=MESH_RTOL, atol=MESH_ATOL),
              f"path 11a prefill: logits differ by {errs[0]} (rtol/atol {MESH_RTOL})")
        step = build_step(cfg32, d_shape, mesh)
        t1 = t2 = lg1.argmax(-1).to(torch.int32)[:, None]
        pos1 = pos2 = lp1 + 1
        tokens = []
        for i in range(MESH_DECODE_STEPS):
            d1, c1 = decode_step(params, cfg32, {"inputs": t1}, c1, pos1)
            d2, c2 = step(params, {"inputs": t2}, c2, pos2)
            d2 = d2.full_tensor()
            errs.append(float((d1 - d2).abs().max()))
            check(torch.allclose(d2, d1, rtol=MESH_RTOL, atol=MESH_ATOL),
                  f"path 11a decode step {i + 1}: logits differ by {errs[-1]}")
            t1, t2 = d1.argmax(-1).to(torch.int32)[:, None], d2.argmax(-1).to(torch.int32)[:, None]
            check(torch.equal(t1, t2), f"path 11a decode step {i + 1}: greedy tokens differ")
            tokens.append(t1[:, 0].tolist())
            pos1, pos2 = pos1 + 1, pos2 + 1
        report["float32_logits_max_abs_err"] = max(errs)
        report["greedy_tokens"] = tokens
        log("mesh", f"11a float32: train {json.dumps(train)}, logits max |diff| "
            f"{max(errs):.3e} over the prefill and {MESH_DECODE_STEPS} decode steps, "
            "greedy tokens equal")
        del c1, c2, step

        # bf16: each step timed with the mesh and without.
        p16 = cast_params(params, torch.bfloat16)
        del params
        times = {}
        for name, on_mesh in (("meshless", False), ("mesh", True)):
            if on_mesh:
                tstep = build_train_step(cfg, shape, opt_cfg, mesh=mesh, seq_parallel=True)
                pstep = build_step(cfg, p_shape, mesh)
                dstep = build_step(cfg, d_shape, mesh)
            else:
                tstep = build_train_step(cfg, shape, opt_cfg, device=dev)
                pstep = lambda p, b: prefill(p, cfg, b, cache_len=MESH_CACHE_LEN)  # noqa: E731
                dstep = lambda p, b, c, q: decode_step(p, cfg, b, c, q)  # noqa: E731
            pt, opt = p16, adamw_init(p16, opt_cfg)
            if on_mesh:  # laid out once, as a run's steps after its first find them
                pt = distribute_tree(p16, tstep.in_shardings[0], mesh)
                opt = distribute_tree(opt, tstep.in_shardings[1], mesh)
            t_ms, t_dev, _ = _timed(lambda: tstep(pt, opt, batch))
            p_ms, p_dev, (lg, caches, lp) = _timed(lambda: pstep(pt, {"inputs": x}))
            tok = (lg.full_tensor() if hasattr(lg, "full_tensor") else lg).argmax(-1)
            tok = tok.to(torch.int32)[:, None]
            d_ms, d_dev, _ = _timed(lambda: dstep(pt, {"inputs": tok}, caches, lp + 1),
                                    calls=MESH_DECODE_STEPS)
            times[name] = {"train_step_ms": t_ms, "train_step_device_ms": t_dev,
                           "prefill_ms": p_ms, "prefill_device_ms": p_dev,
                           "decode_step_ms": d_ms, "decode_step_device_ms": d_dev}
            log("mesh", f"11a bf16 {name}: " + json.dumps(times[name]) + f" ({smi})")
            del tstep, pstep, dstep, pt, opt, caches
        report["bf16"] = times
        report["dtensor_overhead_ms"] = {k: times["mesh"][k] - times["meshless"][k]
                                         for k in times["mesh"]}
        log("mesh", "11a DTensor's overhead on one rank (mesh minus meshless, ms): "
            + json.dumps(report["dtensor_overhead_ms"]))
    finally:
        dist.destroy_process_group()
    return report


def run_mesh(seed, dev, prompts, smi):
    """Path 11: the distribution layer. 11b (the dry-run, on the host) runs
    in a subprocess beside 11a (the mesh steps on the card)."""
    proc = start_dryrun()
    try:
        report = run_mesh_steps(seed, dev, prompts, smi)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    report["dryrun"] = finish_dryrun(proc, smi)
    return report


# Path 12: the store on a (data=1, model=1) mesh of the card.
STORE_CELL_ROWS = 4_000_000  # rows per tablet of the dry-run's store cells
STORE_CELL_SCRIPT = """
import json, sys
from repro_torch.launch.dryrun import MESH_RANKS, fake_world, run_store_cell
for mesh in ("single_pod", "multi_pod"):
    with fake_world(MESH_RANKS[mesh]):
        rec = run_store_cell(mesh, rows_per_tablet=int(sys.argv[1]))
    print("CELL " + json.dumps(rec), flush=True)
"""


def start_store_cells():
    """Path 12's dry-run cells in a subprocess on the host (CUDA hidden from
    it), run beside the mesh store: run_store_cell on the single-pod (256
    ranks) and multi-pod (512) meshes, on fake process groups."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", STORE_CELL_SCRIPT, str(STORE_CELL_ROWS)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_store_cells(proc, smi):
    """The store cells' records: each one's argument bytes per device must
    equal its slabs' (rows x (4 + 4 x 12) for rev_ts and cols, plus one
    int32 count a tablet), and it must have collectives."""
    out, err = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"path 12: the store cells failed: {err[-2000:]}")
    cells = [json.loads(l[len("CELL "):]) for l in out.splitlines() if l.startswith("CELL ")]
    check(len(cells) == 2, f"path 12: {len(cells)} of 2 store cells")
    rows = []
    for rec in cells:
        name = f"{rec['arch']} {rec['shape']} {rec['mesh']}"
        want = STORE_CELL_ROWS * (4 + 4 * 12) + 4
        check(rec["memory"]["argument_bytes"] == want,
              f"path 12 {name}: {rec['memory']['argument_bytes']} argument bytes per device, "
              f"the slabs hold {want}")
        check(rec["collectives"]["total_bytes"] > 0, f"path 12 {name}: no collective")
        r = rec["roofline"]
        row = {"cell": name, "n_chips": rec["n_chips"], "mesh_shape": rec["mesh_shape"],
               "argument_bytes": rec["memory"]["argument_bytes"],
               "peak_gib": rec["memory"]["peak_bytes"] / 2**30,
               "bytes_per_device": rec["cost"]["bytes_per_device"],
               "filter_scan_charge": rec["filter_scan_charge"],
               "collective_bytes_by_op": rec["collectives"]["bytes_by_op"],
               "collective_count_by_op": rec["collectives"]["count_by_op"],
               "compute_s": r["compute_s"], "memory_s": r["memory_s"],
               "memory_lower_s": r["memory_lower_s"], "collective_s": r["collective_s"],
               "bottleneck": r["bottleneck"], "trace_s": rec["trace_s"],
               "rates": "H100 SXM data sheet (launch/cost_analysis.py)", "card": smi}
        rows.append(row)
        log("store-mesh", "cell " + json.dumps(row))
    return rows


def store_mesh_cases(store, dq, tiers, queries):
    """Path 12's steps as (name, kind, function of a snapshot): scan steps
    of ``queries`` ((label, tree)) over the whole range; index steps of
    those the planner (on dq) plans by index; densities of the tiers and
    status=404; aggregate and index aggregate steps of path 3's specs on
    the tiers and A AND 404."""
    import numpy as np
    import torch
    from repro_torch.core import keypack, resolve_grouping
    from repro_torch.core.dist_query import (aggregate_step, density_step,
                                             index_aggregate_step, index_step, scan_step)
    from repro_torch.core.planner import plan_query

    dev = dq.device
    rts_lo, rts_hi = int(keypack.rev_ts(T_SPAN)), int(keypack.rev_ts(0)) + 1
    cases, programs = [], {}
    for label, tree in queries:
        prog = programs[label] = program_tensors(store, tree, dev)
        cases.append((f"scan {label}", "scan",
                      lambda d, p=prog: scan_step(d, p, rts_lo, rts_hi, dq.top_k)))
        plan = plan_query(dq, tree, 0, T_SPAN, w=dq.w)
        if plan.mode == "index":
            lo, hi = (torch.from_numpy(x).to(dev) for x in dq._cond_ranges(plan, 0, T_SPAN))
            cases.append((f"index {label}", "index",
                          lambda d, p=prog, lo=lo, hi=hi, c=plan.combine: index_step(
                              d, p, lo, hi, c, dq.top_k, dq.index_postings, dq.index_rows)))
    for field, value in [("domain", dom) for dom in tiers.values()] + [("status", "404")]:
        code = store.dictionaries[field].lookup(value)
        bs = dq.dist.agg_bucket_s
        lo = int(keypack.pack_agg_key(store.schema.field_id(field), code, 0))
        hi = int(keypack.pack_agg_key(store.schema.field_id(field), code, T_SPAN // bs)) + 1
        cases.append((f"density {field}={value}", "density",
                      lambda d, lo=lo, hi=hi: (density_step(d, lo, hi),)))
    for sname, spec in agg_specs().items():
        g = resolve_grouping(store, spec, 0, T_SPAN)
        vt = torch.from_numpy(g.value_table if g.value_table is not None
                              else np.ones(1, np.int32)).to(dev)
        for label, tree in queries:
            if label not in tuple(tiers) + ("A and 404",):
                continue
            prog = programs[label]
            cases.append((f"aggregate {sname} {label}", "aggregate",
                          lambda d, p=prog, g=g, vt=vt: aggregate_step(d, p, vt, g, rts_lo,
                                                                       rts_hi)))
            plan = plan_query(dq, tree, 0, T_SPAN, w=dq.w)
            if plan.mode == "index":
                lo, hi = (torch.from_numpy(x).to(dev) for x in dq._cond_ranges(plan, 0, T_SPAN))
                cases.append((f"index_aggregate {sname} {label}", "index_aggregate",
                              lambda d, p=prog, g=g, vt=vt, lo=lo, hi=hi, c=plan.combine:
                              index_aggregate_step(d, p, vt, g, lo, hi, c, dq.index_postings,
                                                   dq.index_rows)))
    return cases


def run_store_mesh(store, streams, size, tiers, queries, dev, zero_launches, read_launches,
                   smi, then=None):
    """Path 12: the store on a (data=1, model=1) DeviceMesh of the card (a
    one-rank NCCL group, destroyed after). Path 4's pre-encoded,
    pre-hashed rows go serially into a meshless plane and into a mesh plane
    of tablets_per_device 64; the published states must be equal tensor for
    tensor, the five steps equal bit for bit on ``queries`` and path 3's
    specs, and run_scheme's first batch and total equal for the four
    schemes. Then each step's ms with dispatch and device ms, with the mesh
    and without. The store cells of the dry-run run beside the checks,
    after the timed ingests and before the timed steps. ``then(mesh)``
    (path 13) runs last, in the same process group. Returns the report, the
    path's launches (counted up to the timing) and what ``then`` returned."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.core.dist_ingest import DistIngestPlane
    from repro_torch.core.dist_query import DistQueryProcessor
    from repro_torch.launch.mesh import make_dev_mesh

    report = {"card": smi, "events": size["events"], "tablets": size["tablets"]}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_dev_mesh(1, 1, device_type=dev.type)
        report["mesh"] = dict(zip(mesh.mesh_dim_names, map(int, mesh.shape)))
        zero_launches()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        kw = dict(capacity=size["capacity"], mem_rows=size["mem_rows"],
                  max_runs=size["max_runs"], append_rows=1024, device=dev)
        planes, ingest = {}, {}
        for name, extra in (("meshless", dict(n_tablets=size["tablets"])),
                            ("mesh", dict(mesh=mesh, tablets_per_device=size["tablets"]))):
            plane = DistIngestPlane.for_store(store, **kw, **extra)
            t0 = time.perf_counter()
            serial_ingest(plane, streams)
            torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0
            tel = plane.telemetry()
            check(int(tel["rows"].sum()) == size["events"], f"path 12 {name}: "
                  f"{tel['rows'].sum()} rows")
            ingest[name] = {"seconds": secs, "rows_per_s": size["events"] / secs,
                            "minor": int(tel["minor"].sum()), "major": int(tel["major"].sum())}
            planes[name] = plane
        report["ingest"] = ingest
        log("store-mesh", "serial ingest of path 4's rows: " + json.dumps(ingest) + f" ({smi})")
        cells = start_store_cells()
        try:
            launches = store_mesh_checks(report, store, planes, size, tiers, queries, dev, mesh,
                                         read_launches)
        except BaseException:
            cells.kill()
            cells.communicate()
            raise
        report["cells"] = finish_store_cells(cells, smi)
        d0, d1 = planes["meshless"].publish(), planes["mesh"].publish()
        cases = store_mesh_cases(store, DistQueryProcessor(store, dist=d0, device=dev), tiers,
                                 queries)
        timed = {}
        for name, kind, fn in cases:
            if kind in timed:  # the first case of each step
                continue
            # In turns, meshless, mesh, mesh, meshless: two readings each.
            row = {"case": name}
            for label, d in (("meshless", d0), ("mesh", d1), ("mesh", d1), ("meshless", d0)):
                row.setdefault(f"{label}_cuda_ms", []).append(cuda_ms(lambda: fn(d)))
                row.setdefault(f"{label}_device_ms", []).append(device_ms(lambda: fn(d), ("",)))
            timed[kind] = row
            log("store-mesh", f"{kind} step " + json.dumps(row) + f" ({smi})")
        report["steps"] = timed
        del d0, d1, cases, planes
        gc.collect()
        torch.cuda.empty_cache()
        after = then(mesh) if then is not None else None
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return report, launches, after


def store_mesh_checks(report, store, planes, size, tiers, queries, dev, mesh, read_launches):
    """Path 12's checks (run_store_mesh) on the two ingested planes: their
    states and published levels equal, the five steps bit for bit,
    run_scheme's first batch and total for the four schemes, and the
    path's launches. Adds to the report and returns the launches."""
    import numpy as np
    import torch
    from repro_torch.core.dist_query import DistQueryProcessor

    check(states_equal(planes["meshless"].state, planes["mesh"].state),
          "path 12: the mesh plane's state differs from the meshless plane's")
    d0, d1 = planes["meshless"].publish(), planes["mesh"].publish()
    check(d1.mesh is mesh and d1.tablets == (0, size["tablets"]) and d0.mesh is None,
          f"path 12: the mesh snapshot holds tablets {d1.tablets}")
    levels = ("rev_ts", "cols", "counts", "run_rev_ts", "run_cols", "run_counts", "mem_rev_ts",
              "mem_cols", "mem_counts", "ix_mem_k", "ix_mem_n", "ag_mem_k", "ag_mem_c", "ag_mem_n")
    check(states_equal({f: getattr(d0, f) for f in levels}, {f: getattr(d1, f) for f in levels}),
          "path 12: the published levels differ")
    log("store-mesh", "the mesh plane's state and published levels equal the meshless "
        "plane's tensor for tensor, dtypes included")
    dq0 = DistQueryProcessor(store, dist=d0, device=dev)
    dq1 = DistQueryProcessor(store, dist=d1, device=dev)
    cases = store_mesh_cases(store, dq0, tiers, queries)
    by_kind = Counter()
    for name, kind, fn in cases:
        check(states_equal(dict(enumerate(fn(d0))), dict(enumerate(fn(d1)))),
              f"path 12 {name}: the mesh step differs")
        by_kind[kind] += 1
    log("store-mesh", f"{len(cases)} steps bit for bit equal with the mesh and without: "
        + json.dumps(by_kind))
    schemes = []
    for label, tree in queries:
        if label not in tuple(tiers) + ("A and 404",):
            continue
        for scheme in SCHEMES:
            row = {"query": label, "scheme": scheme}
            for name, q in (("meshless", dq0), ("mesh", dq1)):
                t0 = time.perf_counter()
                blocks = list(q.run_scheme(scheme, 0, T_SPAN, tree))
                check(len(blocks) > 0, f"path 12 {label} {scheme} {name}: no batch")
                row[name] = {"first": blocks[0], "total": sum(b.count for b in blocks),
                             "batches": len(blocks), "s": time.perf_counter() - t0}
            a, b = row["meshless"].pop("first"), row["mesh"].pop("first")
            check(a.count == b.count and (a.lo, a.hi) == (b.lo, b.hi)
                  and a.ts.dtype == b.ts.dtype and np.array_equal(a.ts, b.ts)
                  and np.array_equal(a.cols, b.cols)
                  and row["meshless"]["total"] == row["mesh"]["total"],
                  f"path 12 {label} {scheme}: the mesh's first batch or total differs")
            schemes.append(row)
    report["schemes"] = schemes
    log("store-mesh", "run_scheme's first batch and total equal with the mesh and without: "
        + json.dumps(schemes))
    launches = read_launches()
    log("launches", "path 12 (the store on a mesh): " + json.dumps(launches))
    check(all(launches[k] > 0 for k in ("merge_runs", "filter_scan", "merge_intersect",
                                        "aggregate_combine")),
          f"a kernel of path 12 never launched: {launches}")
    report["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
    report["state_bytes"] = {k: p.state_bytes() for k, p in planes.items()}
    log("store-mesh", f"peak allocated {report['peak_allocated_bytes']} bytes with both planes; "
        f"state bytes {json.dumps(report['state_bytes'])}")
    return launches


SERVE_MESH_ROUNDS = SERVE_ROUNDS  # path 13b's rounds under ingest: cut these, never the size


def spmd_counts():
    """The control log's records by kind and bytes sent, from the
    registry, summed over every log of this process."""
    from repro_torch.obs import get_registry

    reg = get_registry()
    records = Counter()
    for key, v in reg.counter("spmd_records_total").cells().items():
        labels = dict(key)
        if labels.get("role") == "leader":
            records[labels["kind"]] += int(v)
    return dict(records), int(reg.counter("spmd_bytes_total").total())


def run_serve_mesh(mesh, store, streams, size, tiers, domain_counts, pair_counts, agg_results,
                   events, meshless, dev, zero_launches, read_launches, smi):
    """Path 13: the serve plane on a mesh plane driven through a control
    log (core/spmd.py), rank 0 the controller, inside path 12's one-rank
    process group on ``mesh``. 13a: path 4's W = 4 writer streams, on
    threads, into a mesh plane of G = 4 groups at path 4's sizes; rows
    conserved, drained with compact_step, the four schemes' totals on the
    tiers and A AND 404 equal paths 1-2 (and path 4's G = 4 plane). 13b:
    path 5's traffic on that plane: S sessions run the mix once (counts
    equal paths 1-2, the aggregate path 3's bit for bit, the densities the
    generated counts), then SERVE_MESH_ROUNDS rounds while W = 2 writers
    re-send path 5b's own events (``events``), paced as in 5b (counts
    bounded, each session's tier-A batched_scan never falls), then every
    count of the tiers and A AND 404 equals 5a's plus the appended rows;
    the compactor drains the plane; close() sends the stop record. 13c:
    the daemon with --mesh dev in this process group. ``meshless`` is the
    report of paths 4 and 5, printed beside (None: run alone, nothing
    beside). Returns the report and the path's launches."""
    import gc

    import torch
    from repro_torch.core import And, Eq
    from repro_torch.core.dist_ingest import DistIngestPlane
    from repro_torch.core.dist_query import DistQueryProcessor
    from repro_torch.core.spmd import Controller
    from repro_torch.serve_db import QueryService

    chunks, n_new, chunk = events
    n = SERVE_SESSIONS
    report = {"card": smi, "groups": 4, "writers": len(streams), "sessions": n,
              "rounds": SERVE_MESH_ROUNDS, "appended_events": n_new}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    # What earlier paths keep (path 1's plane and end-of-ingest levels, the
    # host store on the card), under the peak below.
    report["allocated_at_start_bytes"] = torch.cuda.memory_allocated(dev)
    zero_launches()
    records0, bytes0 = spmd_counts()
    ctl = Controller(store, timeout_s=600)
    plane = DistIngestPlane.for_store(
        store, capacity=size["capacity"], mem_rows=size["mem_rows"], max_runs=size["max_runs"],
        append_rows=1024, n_groups=4, device=dev, mesh=mesh, control=ctl,
        tablets_per_device=size["tablets"])
    memory = MemoryPhases(dev, plane)
    svc = None
    try:
        # 13a: threaded writers on the mesh plane.
        t0 = time.perf_counter()
        threaded_ingest(plane, streams)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        memory.mark("13a ingest")
        tel = plane.telemetry()
        check(int(tel["rows"].sum()) == size["events"],
              f"path 13a: {tel['rows'].sum()} rows, {size['events']} appended")
        check(int(tel["overflow"].sum()) == 0 and int(tel["ix_overflow"].sum()) == 0
              and int(tel["ag_overflow"].sum()) == 0, "path 13a: tablet overflow")
        t0 = time.perf_counter()
        steps = 0
        while plane.has_unfolded():
            steps += plane.compact_step()
        torch.cuda.synchronize(dev)
        drain_s = time.perf_counter() - t0
        path4 = meshless["sharded"]["runs"]["G=4, 4 threads"]["rows_per_s"] if meshless \
            else float("nan")
        report["13a"] = {"seconds": secs, "rows_per_s": size["events"] / secs,
                         "path4_g4_rows_per_s": path4,
                         "blocked_s": plane.blocked_seconds, "majors": plane.fold_events.get(
                             "ingest", 0), "drain_steps": steps, "drain_s": drain_s,
                         "locks": [{k: g.lock.snapshot()[k] for k in
                                    ("name", "total_held_s", "total_wait_s")}
                                   for g in plane.groups]}
        dq = DistQueryProcessor(store, plane, device=dev)
        wants = serve_counts(tiers, domain_counts, pair_counts)
        totals = {}
        for label, tree in [(t, Eq("domain", d)) for t, d in tiers.items()] + [
                ("A and 404", And(Eq("domain", tiers["A"]), Eq("status", "404")))]:
            for scheme in SCHEMES:
                got = sum(b.count for b in dq.run_scheme(scheme, 0, T_SPAN, tree))
                check(got == wants[label], f"path 13a {label} {scheme}: {got} rows, paths 1-2 "
                      f"(and path 4's G = 4 plane) count {wants[label]}")
                totals[f"{label} {scheme}"] = got
        report["13a"]["totals"] = totals
        del dq
        memory.mark("13a drain and totals")
        log("serve-mesh", f"13a: {size['events']} rows by {len(streams)} writer threads into "
            f"a mesh plane of 4 groups in {secs:.3f} s = {size['events'] / secs:.1f} rows/s "
            f"(path 4's G = 4 x 4 threads, meshless: {path4:.1f}); drained in "
            f"{steps} compact_step increments ({drain_s:.3f} s); the four schemes' totals on "
            f"the tiers and A AND 404 equal paths 1-2 ({smi})")

        # 13b: path 5's traffic on the mesh plane.
        spec_a = agg_specs()["a count/status/hour"]
        mix = serve_mix(tiers)
        new_dom = Counter(d for _, v in chunks for d in v["domain"])
        new_pair = Counter(p for _, v in chunks for p in zip(v["domain"], v["status"]))
        final = {k: wants[k] + v for k, v in serve_counts(tiers, new_dom, new_pair).items()}
        svc = QueryService(store, plane)
        with GcPauses() as gcs:
            mixes = [rotated(mix, i, n) for i in range(n)]
            recs_a, secs_a, _ = run_sessions(svc, mixes, "13b-5a", spec_a)
            for r in recs_a:
                check(r["count"] == wants[r["label"]],
                      f"path 13b {r['session']} {r['scheme']} {r['label']}: {r['count']} rows, "
                      f"paths 1-2 (and path 5a) count {wants[r['label']]}")
                if r["res"] is not None:
                    check(same_aggregates(r["res"], agg_results[(r["label"],
                                                                 "a count/status/hour")]),
                          f"path 13b {r['session']} aggregate {r['label']} differs from path 3")
            memory.mark("13b 5a")
            mixes_b = [rotated(mix, i, n) * SERVE_MESH_ROUNDS for i in range(n)]
            recs_b, secs_b, sess, wr = serve_under_ingest(svc, store, plane, chunks, chunk,
                                                          mixes_b, "13b-5b", spec_a, 20)
            memory.mark("13b 5b")
            for r in recs_b:
                check(wants[r["label"]] <= r["count"] <= final[r["label"]],
                      f"path 13b under ingest {r['session']} {r['scheme']} {r['label']}: "
                      f"{r['count']} rows, outside [{wants[r['label']]}, {final[r['label']]}]")
            for s in sess:
                a = [r["count"] for r in recs_b if r["session"] == s.name
                     and r["label"] == "A" and r["scheme"] == "batched_scan"]
                check(len(a) == SERVE_MESH_ROUNDS and all(y >= x for x, y in zip(a, a[1:])),
                      f"path 13b {s.name}: tier A batched_scan counts {a} fall")
            late = [r for r in recs_b if r["q"].submitted_at >= max(wr["writer_done"])]
            check(not late, f"path 13b: {len(late)} queries submitted after the writers closed")
            s = svc.session("13b-after")
            after = [serve_one(s, m, spec_a) for m in mix
                     if (m[1] == "batched_scan" and m[2] in tiers)
                     or (m[1] == "batched_index" and m[2] == "A and 404")]
            s.close()
            for r in after:
                check(r["count"] == final[r["label"]],
                      f"path 13b {r['scheme']} {r['label']}: {r['count']} rows after the "
                      f"writers closed, want {final[r['label']]}")
            check(svc.wait_idle(timeout=120), "path 13b: the service never went idle")
            t0 = time.perf_counter()
            while plane.has_unfolded() and time.perf_counter() < t0 + 300:
                time.sleep(0.02)
            check(not plane.has_unfolded(), "path 13b: the compactor never drained the plane")
            drain_b = time.perf_counter() - t0
            torch.cuda.synchronize(dev)
            memory.mark("13b drain")
        comp = svc.compactor
        folds = plane.fold_events
        svc.close()
        svc = None
    finally:
        if svc is not None:
            svc.close()
        ctl.close()  # the log's stop record
    records, sent = spmd_counts()
    records = {k: v - records0.get(k, 0) for k, v in records.items()}
    report["13b"] = {
        "5a": phase_stats(recs_a, secs_a, gcs), "5b": phase_stats(recs_b, secs_b, gcs),
        "ingest_rows_per_s": n_new / wr["ingest_s"], "append_rows_per_s": n_new / wr["append_s"],
        "counts_after": {r["label"]: r["count"] for r in after}, "drain_s": drain_b,
        "compactor": {"increments": comp.increments, "folds": comp.folds},
        "fold_events": folds}
    report["log"] = {"records": records, "records_total": sum(records.values()),
                     "bytes_sent": sent - bytes0}
    nan = {"p50_ms": float("nan"), "p99_ms": float("nan")}
    serve5 = meshless["serve"] if meshless else {
        p: {"ttfr": {}, "queries_per_s": float("nan"), "ingest_rows_per_s": float("nan"),
            "append_rows_per_s": float("nan")} for p in ("5a", "5b")}
    for phase in ("5a", "5b"):
        st, five = report["13b"][phase], serve5[phase]
        log("serve-mesh", f"13b {phase} TTFR ms p50/p99 per scheme, mesh [meshless path 5]: "
            + json.dumps({k: [round(v["p50_ms"], 3), round(v["p99_ms"], 3),
                              [round(five["ttfr"].get(k, nan)["p50_ms"], 3),
                               round(five["ttfr"].get(k, nan)["p99_ms"], 3)]]
                          for k, v in st["ttfr"].items()})
            + f"; {st['queries_per_s']:.1f} queries/s [{five['queries_per_s']:.1f}] ({smi})")
    log("serve-mesh", f"13b: ingest {report['13b']['ingest_rows_per_s']:.1f} rows/s while "
        f"serving [path 5b {serve5['5b']['ingest_rows_per_s']:.1f}], paced "
        f"({report['13b']['append_rows_per_s']:.1f} rows/s of the append time "
        f"[{serve5['5b']['append_rows_per_s']:.1f}]); counts after the writers "
        f"{json.dumps(report['13b']['counts_after'])} equal 5a's plus the appended rows; "
        f"compactor {json.dumps(report['13b']['compactor'])}, drained in {drain_b:.3f} s "
        f"({smi})")
    log("serve-mesh", f"control log: {report['log']['records_total']} records "
        f"{json.dumps(records)}, {report['log']['bytes_sent']} bytes sent (one rank: no "
        f"follower to send to)")
    log("serve-mesh", f"device memory by phase, bytes over the "
        f"{memory.marks[0]['allocated_bytes']} allocated once the plane was built: "
        f"{memory.line()}; path 5's on its plane: "
        f"{meshless['serve']['memory_line'] if meshless else 'not run'} ({smi})")
    report["memory"] = memory.marks
    del plane
    gc.collect()
    torch.cuda.empty_cache()
    report["peak_allocated_bytes"] = max(memory.peak, torch.cuda.max_memory_allocated(dev))
    # 13c: the daemon on a mesh of this process group.
    report["13c"] = run_daemon(dev, mesh=True)
    launches = read_launches()
    log("launches", "path 13 (serve plane on a mesh): " + json.dumps(launches))
    check(all(launches[k] > 0 for k in ("merge_runs", "filter_scan", "merge_intersect",
                                        "aggregate_combine")),
          f"a kernel of path 13 never launched: {launches}")
    log("serve-mesh", f"peak allocated {report['peak_allocated_bytes']} bytes, of which "
        f"{report['allocated_at_start_bytes']} allocated before path 13 began ({smi})")
    return report, launches


def host_major_inputs(store, seed):
    """merge_runs' inputs at the host store's major shape, from index
    tablet 0 of a path-6 store: a first major's K = max_runs + 1 runs of
    flush_rows int64 keys (drawn from the tablet's keys, each run sorted),
    and the tablet's own base and runs as a next major would merge them.
    Values: (keys (1, N), bounds, lengths (1, K), payload (1, N, 2))."""
    import numpy as np

    t = store.index_tablets[0]
    runs = t.snapshot_runs()
    all_keys = np.concatenate([r.keys for r in runs])
    k, r = t.max_runs + 1, t.flush_rows
    rng = np.random.default_rng(seed)
    first = [np.sort(rng.choice(all_keys, r, replace=False)) for _ in range(k)]
    out = {f"host ix first major, {k} runs of {r:,}": first}
    if len(runs) > 1:
        out[f"host ix tablet 0 base + {len(runs) - 1} runs"] = [x.keys for x in runs]
    inputs = {}
    for name, parts in out.items():
        sizes = [len(x) for x in parts]
        keys = np.concatenate(parts)[None]
        inputs[name] = (keys, [0, *np.cumsum(sizes).tolist()],
                        np.asarray([sizes], np.int32), np.zeros((*keys.shape, 2), np.int32))
    return inputs


def run_main_path(seed, dev, size=MAIN_PATH, pipeline=None, smi="not read"):
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
    from repro_torch.core.filter import And, Cmp, Eq, In, Match, Not, Or
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
    # Schema and dictionaries for the writer; path 3 fills its tablets (on
    # the card) with the events as the writer encoded them (kept here, not
    # encoded twice).
    store = EventStore(web_proxy_schema(), device=dev)
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
    out_lt_1000 = Counter()  # per domain, events with bytes_out < 1000
    in_ge_1m = 0  # events with bytes_in >= 1,000,000

    zero_launches()  # path 1: ingest and scans
    obs.enable()
    obs.clear()
    ingest_s = 0.0
    for off in range(0, events, chunk):
        n = min(chunk, events - off)
        ts, vals = parse_web_proxy_lines(source.gen_lines(n, 0, T_SPAN))
        domain_counts.update(vals["domain"])
        pair_counts.update(zip(vals["domain"], vals["status"]))
        doms = np.asarray(vals["domain"])
        out_lt_1000.update(doms[np.asarray(vals["bytes_out"]).astype(np.int64) < 1000].tolist())
        in_ge_1m += int((np.asarray(vals["bytes_in"]).astype(np.int64) >= 1_000_000).sum())
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
    # Majors and fold increments: each compacts the index and the
    # aggregate family with one combine_compact launch apiece.
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
    # The Cmp and Match filter nodes: codesets resolved on the host, run as
    # In programs (the bytes_in one of about 45,000 codes).
    cmp_a = ("A and bytes_out<1000", And(eq["A"], Cmp("bytes_out", "<", 1000)),
             out_lt_1000[tiers["A"]])
    match = ("domain d0000*", Match("domain", "d0000"),
             sum(c for dom, c in domain_counts.items() if dom.startswith("d0000")))
    for scheme in ("scan", "batched_scan"):
        queries.append(run_query(dq, scheme, cmp_a[1], cmp_a[0], cmp_a[2]))
        queries.append(run_query(dq, scheme, match[1], match[0], match[2]))
    queries.append(run_query(dq, "scan", Cmp("bytes_in", ">=", 1_000_000), "bytes_in>=1e6",
                             in_ge_1m))
    launches_1 = read_launches()
    log("launches", "path 1 (ingest and scans): " + json.dumps(launches_1))
    check(launches_1["merge_runs"] > 0 and launches_1["filter_scan"] > 0
          and launches_1["aggregate_combine"] > 0,
          f"a kernel of path 1 never launched: {launches_1}")
    check(launches_1["aggregate_combine"] == 2 * combines,
          f"aggregate_combine launched {launches_1['aggregate_combine']} times on path 1, "
          f"for {combines} majors and fold increments of two families")

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
        queries.append(run_query(dq, scheme, cmp_a[1], cmp_a[0], cmp_a[2]))
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
    log("aggregate", f"host EventStore(n_shards={store.n_shards}) filled with {store.total_rows} "
        f"events, flushed and compacted in {host_setup_s:.3f} s (set-up, untimed)")
    zero_launches()
    agg_rows, largest_a, agg_results = run_aggregations(store, dq, dev, tiers, domain_counts,
                                                        pair_counts, cmp_a)
    launches_3 = read_launches()
    obs.disable()
    log("launches", "path 3 (aggregation): " + json.dumps(launches_3))
    check(launches_3["combine_scan"] > 0 and launches_3["filter_scan"] > 0
          and launches_3["merge_intersect"] > 0, f"a kernel of path 3 never launched: {launches_3}")
    report["aggregation"] = {"host_setup_s": host_setup_s, "queries": agg_rows}

    # Path 4: the sharded plane, W = 4 writer threads into G = 1 and G = 4
    # tablet groups, then the bulk replay of the host store.
    zero_launches()
    path4_queries = [(tier, eq[tier], domain_counts[tiers[tier]]) for tier in tiers]
    path4_queries.append(("A and 404", ands["A"], pair_counts[(tiers["A"], "404")]))
    streams = writer_streams(encoded, size["tablets"], size["chunk"], 4)
    encoded.clear()
    report["sharded"], g4_plane = run_sharded(
        store, streams, dev, size, path4_queries, cmp_a, agg_results, read_launches)
    launches_4 = read_launches()
    log("launches", "path 4 (sharded plane and bulk replay): " + json.dumps(launches_4))
    check(all(launches_4[k] > 0 for k in ("merge_runs", "filter_scan", "merge_intersect",
                                           "aggregate_combine")),
          f"a kernel of path 4 never launched: {launches_4}")

    # Path 5: the serve plane on path 4's G = 4 plane, then the daemon.
    new_events = serve_events(seed, size)
    zero_launches()
    report["serve"] = run_serve(store, g4_plane, dev, size, seed, tiers, domain_counts,
                                pair_counts, agg_results, new_events)
    launches_5 = read_launches()
    log("launches", "path 5 (serve plane): " + json.dumps(launches_5))
    check(all(v > 0 for v in launches_5.values()), f"a kernel of path 5 never launched: "
          f"{launches_5}")
    combines_5 = report["serve"]["majors"] + report["serve"]["fold_increments"]
    check(launches_5["aggregate_combine"] == 2 * combines_5,
          f"aggregate_combine launched {launches_5['aggregate_combine']} times on path 5, for "
          f"{report['serve']['majors']} majors and {report['serve']['fold_increments']} fold "
          f"increments of two families")
    del g4_plane
    report["daemon"] = run_daemon(dev)

    # Path 6: the ingest pipeline into host stores on the card (the launch
    # counts are zeroed inside, after the files are staged); path 7: the
    # analytics LM served on path 6's token sequences.
    report["pipeline"], p_store, tok, prompts, launches_6 = run_pipeline(
        seed, dev, zero_launches, read_launches, **(pipeline or {}))
    host_majors = host_major_inputs(p_store, seed)
    log("launches", "path 6 (pipeline): " + json.dumps(launches_6))
    check(all(launches_6[k] > 0 for k in ("merge_runs", "filter_scan", "merge_intersect",
                                           "combine_scan")),
          f"a kernel of path 6 never launched: {launches_6}")
    zero_launches()
    report["lm"] = run_lm_serve(seed, dev, tok, prompts)
    launches_7 = read_launches()
    log("launches", "path 7 (LM serve; no kernel of its own): " + json.dumps(launches_7))
    # Path 8: the analytics LM trained on path 6's token sequences.
    zero_launches()
    t0 = time.perf_counter()
    report["lm_train"] = run_lm_train(seed, dev, tok)
    report["lm_train"]["path_seconds"] = time.perf_counter() - t0
    launches_8 = read_launches()
    log("launches", "path 8 (LM train; no kernel of its own): " + json.dumps(launches_8))
    del p_store, tok
    # Path 9: the LM's attention-side families; gemma2-9b served on path 6's
    # token sequences.
    zero_launches()
    t0 = time.perf_counter()
    report["families"] = run_families(seed, dev, prompts)
    report["families"]["path_seconds"] = time.perf_counter() - t0
    launches_9 = read_launches()
    log("launches", "path 9 (LM families; no kernel of their own): " + json.dumps(launches_9))
    # Path 10: the LM's MoE and SSM families; moonshot-v1-16b-a3b and
    # zamba2-2.7b served on path 6's token sequences.
    zero_launches()
    t0 = time.perf_counter()
    report["moe_ssm"] = run_moe_ssm(seed, dev, prompts)
    report["moe_ssm"]["path_seconds"] = time.perf_counter() - t0
    launches_10 = read_launches()
    log("launches", "path 10 (LM MoE/SSM; no kernel of their own): "
        + json.dumps(launches_10))
    # Path 11: the distribution layer; llcysa-analytics-100m's steps on a
    # (1, 1) mesh of the card, and the production-mesh dry-run on the host.
    zero_launches()
    t0 = time.perf_counter()
    report["mesh"] = run_mesh(seed, dev, prompts, smi)
    report["mesh"]["path_seconds"] = time.perf_counter() - t0
    launches_11 = read_launches()
    log("launches", "path 11 (mesh steps and dry-run; no kernel of their own): "
        + json.dumps(launches_11))
    del prompts
    # Path 12: the store on a (1, 1) mesh of the card against the meshless
    # store, on path 4's rows; the store cells of the dry-run on the host.
    store_queries = [(tier, eq[tier]) for tier in tiers] + [
        ("A and 404", ands["A"]), ("B and 404", ands["B"]), ("B or C", b_or_c),
        cmp_a[:2], match[:2], ("bytes_in>=1e6", Cmp("bytes_in", ">=", 1_000_000)),
        (f"A and bytes_in in {n_in:,}", big_in)]
    # Path 13, in path 12's process group: the serve plane and threaded
    # writers on a mesh plane driven through a control log.
    t0 = time.perf_counter()
    t13 = [0.0]

    def path_13(mesh):
        t13[0] = time.perf_counter()
        return run_serve_mesh(mesh, store, streams, size, tiers, domain_counts, pair_counts,
                              agg_results, new_events, report, dev, zero_launches,
                              read_launches, smi)

    report["store_mesh"], launches_12, (report["serve_mesh"], launches_13) = run_store_mesh(
        store, streams, size, tiers, store_queries, dev, zero_launches, read_launches, smi,
        then=path_13)
    report["store_mesh"]["path_seconds"] = t13[0] - t0
    report["serve_mesh"]["path_seconds"] = time.perf_counter() - t13[0]
    log("serve-mesh", f"path 13 took {report['serve_mesh']['path_seconds']:.3f} s")
    del streams, new_events
    paths = (launches_1, launches_2, launches_3, launches_4, launches_5, launches_6, launches_7,
             launches_8, launches_9, launches_10, launches_11, launches_12, launches_13)
    launches = {k: sum(p[k] for p in paths) for k in launches_1}
    report["launches"] = {"total": launches,
                          **{f"path_{i}": p for i, p in enumerate(paths, start=1)}}

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
    # The same merges at one group's shape of path 4's G = 4 plane.
    per_group = size["tablets"] // 4
    pre_g = {k: v[:per_group] for k, v in pre.items()}
    for fam in ("ix", "ag"):
        rc = pre_g[f"{fam}_run_c"]
        for stage, inputs in merge_inputs(pre_g, fam, KEY_PAD64).items():
            if stage == "kway":
                continue
            payload = torch.zeros((*inputs[0].shape, rc.shape[-1]), dtype=rc.dtype, device=dev)
            row = time_merge(f"{fam} {stage}, one group ({per_group} tablets)", *inputs, payload)
            del payload
            merge_rows.append(row)
            log("kernel", json.dumps({"name": "merge_runs", **row}))
    # The same kernel at the host store's major shape (path 6).
    for name, inputs in host_majors.items():
        keys, bounds, lengths, payload = (torch.from_numpy(x).to(dev) if isinstance(
            x, np.ndarray) else x for x in inputs)
        row = time_merge(name, keys, bounds, lengths, payload)
        merge_rows.append(row)
        log("kernel", json.dumps({"name": "merge_runs", **row}))
    del host_majors
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
    combine_rows = []
    for timer in (time_combine, time_groups):
        combine_rows += [timer("tier-A batch", *batch, program, op) for op in OPS]
        combine_rows.append(timer(f"tier-A batch In(bytes_in, {n_in:,} codes)", *batch,
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
    combine_rows += [timer("synthetic straddle", *syn, syn_prog, op)
                     for timer in (time_combine, time_groups) for op in OPS]
    for row in combine_rows:
        log("kernel", json.dumps({"name": "combine_scan", **row}))
    report["tier_a_batch"] = {"lo": lo_t, "hi": hi_t, "rows": int(len(keys))}

    # combine_compact at the index and aggregate families' inputs of a
    # major and a fold increment, and combine_blocks on an int32
    # combine_sorted_counts case (the host combiner).
    aggregate_rows = []
    for name, inputs in combine_inputs(pre, KEY_PAD64).items():
        aggregate_rows.append(time_compact(name, *inputs, KEY_PAD64))
        log("kernel", json.dumps({"name": "aggregate_combine", **aggregate_rows[-1]}))
    for name, inputs in combine_inputs(pre_g, KEY_PAD64).items():
        aggregate_rows.append(time_compact(f"{name}, one group ({per_group} tablets)", *inputs,
                                           KEY_PAD64))
        log("kernel", json.dumps({"name": "aggregate_combine", **aggregate_rows[-1]}))
    ck = torch.from_numpy(np.sort(rng.integers(0, 1 << 20, 1 << 22)))[None].to(dev)
    cc = torch.from_numpy(rng.integers(1, 100, (1, 1 << 22)).astype(np.int32)).to(dev)
    aggregate_rows.append(time_aggregate("combine_sorted_counts int32", ck, cc))
    log("kernel", json.dumps({"name": "aggregate_combine", **aggregate_rows[-1]}))
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
                "tier-A batch sum groups"),
        summary("aggregate_combine", "cuda", AGGREGATE_SRC, AGGREGATE_REPLACES, aggregate_rows,
                "ag two_way"),
    ]
    report["kernels"] = kernels
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    # Path 8's bitwise resume runs under torch.use_deterministic_algorithms,
    # whose cuBLAS calls need this set before CUDA starts.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
        lint = run_lint()
        run_reference(args.seed, dev)
        report = run_main_path(args.seed, dev, smi=smi)
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    report.update(lint=lint, device=kind, nvidia_smi=smi, seed=args.seed,
                  torch=torch.__version__, device_ms_by=dict(Counter(DEVICE_MS_BY)))
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
