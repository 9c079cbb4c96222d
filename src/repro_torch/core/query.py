"""Host query processor — planned, adaptively batched queries over the
host EventStore; the port of the reference's core/query.py.

A query is (event table, time range, optional filter tree). Execution
composes the planner (index scans vs tablet filtering), Algorithms 1-2
over the time range, and the scans of core/scan.py. The paper's four
§IV-B schemes map to flags:

  Scan          use_index=False, batched=False
  Batched Scan  use_index=False, batched=True
  Index         use_index=True,  batched=False
  Batched Index use_index=True,  batched=True

A fifth, Combine Scan (``aggregate=AggregateSpec(...)``), ends the
server-side iterator stack in the fused filter+combine kernel: each batch
yields per-group partial aggregates (AggregateBlocks) instead of rows.

The kernels (filter_scan, merge_intersect's membership for the AND,
combine_scan) run on the processor's ``device``: host arrays go there for
each call and the results come back as numpy. device="cpu" runs their
plain versions.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .batching import DEFAULT_K0, AdaptiveBatcher, HitRateTracker
from .device import resolve_device
from .filter import Node, TrueNode, compile_tree
from .iterators import (
    AggregateResult,
    AggregateSpec,
    CombinerIterator,
    merge_aggregate_blocks,
    resolve_grouping,
)
from .planner import QueryPlan, plan_query
from .scan import RowBlock, fetch_rows_by_keys, index_scan, scan_events
from .store import EventStore
from ..kernels.filter_scan import filter_rows, program_tensors
from ..kernels.merge_intersect import intersect_sorted, union_sorted
from ..obs import span


@dataclass
class QueryStats:
    """What a query run records: its plan, batches, rows, the index
    entries its index steps expanded, and one (lo, hi, seconds, rows)
    entry per batch."""

    batches: int = 0
    rows: int = 0
    index_keys_scanned: int = 0
    rows_filtered: int = 0
    plan: Optional[QueryPlan] = None
    batch_log: List[Tuple[float, float, float, int]] = field(default_factory=list)


@dataclass
class HostBatch:
    """One adaptive batch of a HostQueryRun: its time sub-range, its blocks
    (RowBlocks, or AggregateBlocks with aggregate=), and the matched-row
    count that drove the Alg-1 update."""

    lo: float
    hi: float
    blocks: List
    runtime: float
    rows: int


class QueryProcessor:
    """The five schemes over a host EventStore, with the kernels on
    ``device`` (default "cuda"; the CPU tests pass "cpu")."""

    def __init__(self, store: EventStore, w: float = 10.0, device="cuda"):
        self.store = store
        self.w = w
        self.device = resolve_device(device)
        self.hit_rates = HitRateTracker(default_rate=store.rows_per_second())

    # ----------------------------------------------------------- internals
    def _execute_range(self, plan: QueryPlan, t0: int, t1: int,
                       shards: Optional[Sequence[int]] = None, prog=None,
                       combiner: Optional[CombinerIterator] = None) -> Iterator:
        """Run one time range of a planned query. ``prog``: the residual
        filter program, prepared on the device once per query (a Program).
        ``combiner``: the stack's terminal iterator — rows become per-group
        aggregates."""
        store = self.store
        residual_trivial = isinstance(plan.residual, TrueNode) or plan.residual is None
        if prog is None and not residual_trivial:
            prog = program_tensors(compile_tree(store, plan.residual), self.device)
        if plan.mode == "filter":
            # Every shard's block goes through one kernel launch.
            blocks = list(scan_events(store, t0, t1, shards))
            if not blocks:
                return
            if combiner is not None:
                # Residual filter and combine fused in one launch.
                agg = combiner.combine_rows(np.concatenate([b.keys for b in blocks]),
                                            np.concatenate([b.cols for b in blocks]))
                if agg.n:
                    yield agg
                return
            if residual_trivial:
                yield from blocks
                return
            mask_all = filter_rows(np.concatenate([b.cols for b in blocks]), prog)
            off = 0
            for blk in blocks:
                mask = mask_all[off: off + blk.n]
                off += blk.n
                if mask.any():
                    yield RowBlock(blk.shard, blk.keys[mask], blk.cols[mask])
            return

        # Index mode: per shard, the index table for every condition, the
        # key sets combined, then the event rows fetched and the residual
        # applied (or, with a combiner, fused into its one launch).
        fetched: List[RowBlock] = []
        shard_list = list(shards) if shards is not None else list(range(store.n_shards))
        per_cond: List[List[np.ndarray]] = []
        for cond in plan.index_conds:
            code = store.dictionaries[cond.field].lookup(cond.value)
            codes = np.empty(0, np.int32) if code is None else np.asarray([code], np.int32)
            per_cond.append(index_scan(store, cond.field, codes, t0, t1, shard_list))
        for si, shard in enumerate(shard_list):
            sets = [np.unique(c[si]) for c in per_cond]
            if not sets:
                continue
            if plan.combine == "union":
                keys = sets[0]
                for s in sets[1:]:
                    keys = union_sorted(keys, s)
            else:
                sets.sort(key=len)  # smallest first: cheapest intersections
                keys = sets[0]
                for s in sets[1:]:
                    if keys.size == 0:
                        break
                    keys = intersect_sorted(keys, s, self.device)
            if keys.size == 0:
                continue
            blk = fetch_rows_by_keys(store, shard, keys)
            if blk.n == 0:
                continue
            if combiner is not None:
                fetched.append(blk)
                continue
            if prog is not None:
                mask = filter_rows(blk.cols, prog)
                if not mask.any():
                    continue
                blk = RowBlock(blk.shard, blk.keys[mask], blk.cols[mask])
            yield blk
        if combiner is not None and fetched:
            agg = combiner.combine_rows(np.concatenate([b.keys for b in fetched]),
                                        np.concatenate([b.cols for b in fetched]))
            if agg.n:
                yield agg

    # ------------------------------------------------------------- public
    def execute(self, t_start: int, t_stop: int, tree: Optional[Node] = None,
                use_index: bool = True, batched: bool = True,
                stats: Optional[QueryStats] = None, aggregate: Optional[AggregateSpec] = None,
                _grouping=None) -> Iterator:
        """Stream result RowBlocks for a query (see the module docstring for
        the scheme flags). With ``aggregate=`` the stream yields
        AggregateBlocks. ``_grouping``: an already-resolved grouping for
        ``aggregate`` (aggregate() passes its own)."""
        run = HostQueryRun(self, t_start, t_stop, tree, use_index=use_index, batched=batched,
                           stats=stats, aggregate=aggregate, _grouping=_grouping)
        yield from run.stream()

    def aggregate(self, spec: AggregateSpec, t_start: int, t_stop: int,
                  tree: Optional[Node] = None, use_index: bool = False, batched: bool = True,
                  stats: Optional[QueryStats] = None) -> AggregateResult:
        """Run a scan-time aggregation to completion and merge the partial
        AggregateBlocks client-side (over group cardinality only)."""
        grouping = resolve_grouping(self.store, spec, t_start, t_stop)
        blocks = list(self.execute(t_start, t_stop, tree, use_index=use_index, batched=batched,
                                   stats=stats, aggregate=spec, _grouping=grouping))
        return merge_aggregate_blocks(grouping, blocks)

    def run_scheme(self, scheme: str, t_start: int, t_stop: int, tree: Optional[Node] = None,
                   **kw) -> Iterator:
        """The paper's four schemes by name, plus 'combine_scan' (which
        requires aggregate=AggregateSpec(...))."""
        flags = {
            "scan": dict(use_index=False, batched=False),
            "batched_scan": dict(use_index=False, batched=True),
            "index": dict(use_index=True, batched=False),
            "batched_index": dict(use_index=True, batched=True),
            "combine_scan": dict(use_index=False, batched=True),
        }[scheme]
        if scheme == "combine_scan" and kw.get("aggregate") is None:
            raise ValueError("combine_scan scheme requires aggregate=AggregateSpec(...)")
        return self.execute(t_start, t_stop, tree, **flags, **kw)


class HostQueryRun:
    """QueryProcessor.execute, reified: one planned host query stepped one
    adaptive batch at a time. All per-run state is local; the shared
    HitRateTracker is thread-safe."""

    def __init__(self, qp: QueryProcessor, t_start: int, t_stop: int,
                 tree: Optional[Node] = None, use_index: bool = True, batched: bool = True,
                 stats: Optional[QueryStats] = None, aggregate: Optional[AggregateSpec] = None,
                 _grouping=None):
        self.qp = qp
        self.t_start = t_start
        self.t_stop = t_stop
        self.stats = stats
        store = qp.store
        with span("query.plan", cat="query", host=True) as sp:
            self.plan = plan_query(store, tree, t_start, t_stop, w=qp.w, use_index=use_index)
            sp.set(mode=self.plan.mode)
        if stats is not None:
            stats.plan = self.plan
        # Provably empty: no scans and no batching loop.
        self._empty = self.plan.mode == "empty"
        residual_trivial = isinstance(self.plan.residual, TrueNode) or self.plan.residual is None
        # The residual filter, prepared on the device once for every batch
        # (and for the combiner's fused launches).
        self.prog = (None if residual_trivial
                     else program_tensors(compile_tree(store, self.plan.residual), qp.device))
        self.combiner = None
        if aggregate is not None:
            grouping = _grouping or resolve_grouping(store, aggregate, t_start, t_stop)
            self.combiner = CombinerIterator(grouping, prog=self.prog, device=qp.device)
        self._single_done = False
        self.batcher: Optional[AdaptiveBatcher] = None
        if batched and not self._empty:
            # Alg 2's drive loop; b0 from the table's historical hit rate.
            self.batcher = AdaptiveBatcher(t_start=t_start, t_stop=t_stop,
                                           b0=qp.hit_rates.initial_b(DEFAULT_K0))

    @property
    def done(self) -> bool:
        if self._empty:
            return True
        if self.batcher is None:
            return self._single_done
        return self.batcher.done

    def stream(self):
        """Yield the run's blocks to completion. The unbatched schemes run
        the whole range as one batch and stream block by block as
        _execute_range makes them (the first row does not wait for the
        last); the batched schemes yield per completed adaptive batch."""
        while not self.done:
            if self.batcher is None:
                lo, hi = float(self.t_start), float(self.t_stop)
                t_begin = time.perf_counter()
                rows = 0
                for blk in self.qp._execute_range(self.plan, int(lo), int(hi), prog=self.prog,
                                                  combiner=self.combiner):
                    rows += getattr(blk, "matched", blk.n)
                    yield blk
                self._single_done = True
                if self.stats is not None:
                    self.stats.batches += 1
                    self.stats.rows += rows
                    self.stats.batch_log.append((lo, hi, time.perf_counter() - t_begin, rows))
                return
            hb = self.step()
            if hb is not None:
                yield from hb.blocks

    def step(self) -> Optional[HostBatch]:
        """Execute the next adaptive batch and return it; None once done.
        The matched-row count drives the batcher: for aggregate blocks the
        rows combined, not the groups shipped."""
        if self.done:
            return None
        if self.batcher is None:
            lo, hi = float(self.t_start), float(self.t_stop)
        else:
            lo, hi = self.batcher.next_range()
        t_begin = time.perf_counter()
        with span("query.step", cat="query", mode=self.plan.mode, host=True) as sp:
            blocks = list(self.qp._execute_range(self.plan, int(lo), int(hi), prog=self.prog,
                                                 combiner=self.combiner))
            rows = sum(getattr(b, "matched", b.n) for b in blocks)
            sp.set(rows=rows)
        runtime = time.perf_counter() - t_begin
        if self.batcher is None:
            self._single_done = True
        else:
            self.batcher.update(runtime, rows)
            self.qp.hit_rates.observe(rows, hi - lo + 1)
        if self.stats is not None:
            self.stats.batches += 1
            self.stats.rows += rows
            self.stats.batch_log.append((lo, hi, runtime, rows))
        return HostBatch(float(lo), float(hi), blocks, runtime, rows)
