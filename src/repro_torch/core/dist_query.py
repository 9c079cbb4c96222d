"""Device query execution — the paper's tablet-server scan (§IV-B scan
and batched scan) over a published snapshot of the ingest plane; the
scan half of the reference's core/dist_query.py.

All T tablets sit on one device as a leading dimension (the reference's
shard_map over the mesh and vmap over tablets). One adaptive batch is one
device step over a time sub-range:

    time-range restriction   sorted rev_ts -> per-tablet searchsorted
    filter                   the postfix predicate program, through the
                             filter_scan kernel
    count                    per tablet, summed over T
    top-k newest             per level, merged by rev_ts across levels

Every read searches ALL LSM levels of the snapshot — the base, the K
sorted-run slabs and the sealed memtable — so publish() never folds.
The index schemes (and the density reads their planning needs) come with
the next slice of the port.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from . import keypack
from .batching import AdaptiveBatcher
from .device import resolve_device
from .filter import compile_tree
from .planner import plan_query
from .store import EventStore
from ..kernels.filter_scan import filter_scan, pad_program
from ..obs import span

INVALID_TS = -1
_I32_MAX = np.iinfo(np.int32).max


@dataclass
class DistStore:
    """A published snapshot of the device tablet grid's event family at
    all LSM levels (T tablets, base capacity R, K run slots, memtable M):

      rev_ts (T, R) int32, cols (T, R, F) int32, counts (T,) int32  — base
      run_rev_ts (T, K, M), run_cols (T, K, M, F), run_counts (T, K) — runs
      mem_rev_ts (T, M), mem_cols (T, M, F), mem_counts (T,)  — sealed memtable

    Each level is sorted by rev_ts (newest first) with the INT32_MAX
    sentinel past its live count. The index and aggregate families join
    the snapshot with their readers, the index schemes.
    """

    rev_ts: torch.Tensor
    cols: torch.Tensor
    counts: torch.Tensor
    run_rev_ts: torch.Tensor
    run_cols: torch.Tensor
    run_counts: torch.Tensor
    mem_rev_ts: torch.Tensor
    mem_cols: torch.Tensor
    mem_counts: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.rev_ts.device


def _scan_level(rev, cols, live, program, probe, top_k: int):
    """Range-restrict + filter + top-k over one level, batched over its
    leading dims: rev (..., R), cols (..., R, F), live (...); probe holds
    the int32 rev_ts range [lo, hi). Returns the int32 (...) counts, and
    the (..., k) newest matches' rev_ts (INT32_MAX-padded) and (..., k, F)
    cols (-1 padded)."""
    r = rev.shape[-1]
    lead = rev.shape[:-1]
    a, b = torch.searchsorted(rev, probe.expand(*lead, 2).contiguous()).unbind(-1)
    idx = torch.arange(r, dtype=torch.int32, device=rev.device)
    in_range = (idx >= a[..., None]) & (idx < b[..., None]) & (idx < live[..., None])
    hit = filter_scan(cols, *program) & in_range
    count = hit.sum(dim=-1, dtype=torch.int32)
    rank = torch.where(hit, idx, r)
    top = torch.topk(rank, min(top_k, r), dim=-1, largest=False, sorted=True).values
    valid = top < r
    safe = top.clamp(0, r - 1).long()
    out_rev = torch.where(valid, rev.gather(-1, safe), _I32_MAX)
    f = cols.shape[-1]
    picked = cols.gather(-2, safe[..., None].expand(*safe.shape, f))
    out_cols = torch.where(valid[..., None], picked, -1)
    return count, out_rev, out_cols


def scan_step(d: DistStore, program, rts_lo: int, rts_hi: int, top_k: int = 128):
    """One scan over every tablet and every LSM level of a snapshot — the
    port of the reference's run-aware build_scan_step. ``program`` is the
    padded program as (opcodes, arg0, arg1, codesets) int32 tensors on the
    snapshot's device; the rev_ts range is [rts_lo, rts_hi). Returns the
    int32 total count, the (T, k) newest matches' rev_ts per tablet (-1
    where there is none) and their (T, k, F) cols."""
    t, f = d.cols.shape[0], d.cols.shape[-1]
    probe = torch.tensor([rts_lo, rts_hi], dtype=torch.int32).to(d.device)
    cnt, rev, cl = _scan_level(d.rev_ts, d.cols, d.counts, program, probe, top_k)
    rcnt, rrev, rcl = _scan_level(d.run_rev_ts, d.run_cols, d.run_counts, program, probe, top_k)
    mcnt, mrev, mcl = _scan_level(d.mem_rev_ts, d.mem_cols, d.mem_counts, program, probe, top_k)
    count = cnt + rcnt.sum(dim=1, dtype=torch.int32) + mcnt
    all_rev = torch.cat([rev, rrev.reshape(t, -1), mrev], dim=1)
    all_cols = torch.cat([cl, rcl.reshape(t, -1, f), mcl], dim=1)
    order = torch.sort(all_rev, dim=1, stable=True).indices[:, :top_k]
    out_rev = all_rev.gather(1, order)
    out_cols = all_cols.gather(1, order[..., None].expand(*order.shape, f))
    out_ts = torch.where(out_rev < _I32_MAX, out_rev, INVALID_TS)
    return count.sum(dtype=torch.int32), out_ts, out_cols


@dataclass
class DistBatch:
    """One batch's result: the exact global matching-row count plus the
    per-tablet top-k newest rows (BatchScanner semantics: unordered across
    tablets). lo/hi are the batch's time sub-range."""

    count: int
    ts: np.ndarray
    cols: np.ndarray
    lo: float = 0.0
    hi: float = 0.0


class QueryRun:
    """One planned query pinned to one published snapshot, stepped one
    adaptive batch at a time."""

    def __init__(self, proc: "DistQueryProcessor", tree, t_start: int, t_stop: int,
                 batched: bool = True):
        self.proc = proc
        self.tree = tree
        self.t_start = t_start
        self.t_stop = t_stop
        self.dist = proc._sync()  # pinned for the whole run
        with span("query.plan", cat="query") as sp:
            self.plan = plan_query(proc.store, tree, t_start, t_stop, use_index=False)
            sp.set(mode=self.plan.mode)
        self._single_done = False
        self.batcher: Optional[AdaptiveBatcher] = None
        if batched:
            rps = proc.store.rows_per_second()
            self.batcher = AdaptiveBatcher(t_start=t_start, t_stop=t_stop, b0=rps and 10.0 / rps)

    @property
    def done(self) -> bool:
        if self.batcher is None:
            return self._single_done
        return self.batcher.done

    def step(self) -> Optional[DistBatch]:
        """Execute the next adaptive batch and return it; None once done."""
        if self.done:
            return None
        if self.batcher is None:
            lo, hi = float(self.t_start), float(self.t_stop)
        else:
            lo, hi = self.batcher.next_range()
        t0 = time.perf_counter()
        with span("query.step", cat="query", mode=self.plan.mode) as sp:
            count, ts, cols = self.proc.scan_range(self.tree, int(lo), int(hi), dist=self.dist)
            sp.set(rows=count)
        runtime = time.perf_counter() - t0
        if self.batcher is None:
            self._single_done = True
        else:
            self.batcher.update(runtime, count)
        return DistBatch(count, ts, cols, float(lo), float(hi))


class DistQueryProcessor:
    """The scan schemes of §IV-B over a live DistIngestPlane: every query
    syncs to the plane's latest published snapshot, so rows written
    through DistBatchWriter are visible with no host round trip.

    ``device`` must be the plane's device (default "cuda"; the CPU tests
    pass "cpu")."""

    def __init__(self, store: EventStore, plane, top_k: int = 128, device="cuda"):
        dev = resolve_device(device)
        if dev != plane.device:
            raise ValueError(f"processor device {dev} is not the plane's device {plane.device}")
        self.store = store
        self.plane = plane
        self.device = dev
        self.top_k = top_k
        self.dist = plane.publish()

    def _sync(self) -> DistStore:
        """Refresh to the plane's latest published snapshot and return it."""
        self.dist = self.plane.publish()
        return self.dist

    def scan_range(self, tree, t0: int, t1: int, dist: Optional[DistStore] = None
                   ) -> Tuple[int, np.ndarray, np.ndarray]:
        """One range scan across all tablets and all LSM levels, ts in
        [t0, t1]. Returns (global count, the top-k newest matching rows per
        tablet as (ts, cols) numpy arrays). ``dist`` pins a snapshot."""
        d = dist if dist is not None else self._sync()
        opc, a0, a1, cs = pad_program(compile_tree(self.store, tree))
        flat = torch.from_numpy(np.concatenate([opc, a0, a1, cs.ravel()])).to(d.device)
        p = len(opc)
        program = (flat[:p], flat[p:2 * p], flat[2 * p:3 * p], flat[3 * p:].view(cs.shape))
        rts_lo = int(keypack.rev_ts(t1))
        rts_hi = int(keypack.rev_ts(t0)) + 1
        with span("query.scan_range", cat="query") as sp:
            total, top_ts, top_cols = scan_step(d, program, rts_lo, rts_hi, self.top_k)
            count = int(sp.fence(total))
            ts = sp.fence(top_ts).cpu().numpy()
            cols = sp.fence(top_cols).cpu().numpy()
        valid = ts != INVALID_TS
        return count, keypack.unrev_ts(ts[valid]), cols[valid]

    def execute(self, tree, t_start: int, t_stop: int, batched: bool = True
                ) -> Iterator[DistBatch]:
        """Stream DistBatch results for a filter-planned query, pinned to
        one published snapshot."""
        run = QueryRun(self, tree, t_start, t_stop, batched=batched)
        while not run.done:
            blk = run.step()
            if blk is not None:
                yield blk

    def run_scheme(self, scheme: str, t_start: int, t_stop: int, tree=None
                   ) -> Iterator[DistBatch]:
        """The paper's schemes by name. "scan" and "batched_scan" run here;
        "index" and "batched_index" come with the next slice."""
        if scheme in ("index", "batched_index"):
            raise NotImplementedError(
                f"scheme {scheme!r} needs the index path (posting slabs, the "
                "merge_intersect kernel and the density read), which comes with "
                "the next slice of the port"
            )
        batched = {"scan": False, "batched_scan": True}[scheme]
        return self.execute(tree, t_start, t_stop, batched=batched)
