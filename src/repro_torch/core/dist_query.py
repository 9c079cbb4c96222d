"""Device query execution — the paper's four §IV-B schemes (scan, batched
scan, index, batched index) over a published snapshot of the ingest
plane or of a bulk replay; the port of the reference's
core/dist_query.py.

Without a mesh, all T tablets sit on one device as a leading dimension
(the reference's vmap over tablets). On a torch.distributed DeviceMesh
every rank is a tablet server, as every chip is in the reference's
shard_map: the rank whose row-major mesh coordinate is r holds global
tablets [r * tl, (r + 1) * tl), runs the same per-tablet code on them,
and the steps combine across ranks with collectives over the default
process group (which the mesh spans): counts, truncation and densities
all-reduce with SUM, aggregates with SUM, MIN or MAX (the reference's
psum, pmin and pmax), and the per-tablet top-k slates all-gather into
global tablet order. Every host branch on a step's result then reads
the same value on every rank, so the ranks enter the same collectives.
One adaptive batch is one device step over a time sub-range. The scan
step:

    time-range restriction   sorted rev_ts -> per-tablet searchsorted
    filter                   the postfix predicate program, through the
                             filter_scan kernel: one launch for all levels
    count                    per tablet, summed over T (and the mesh)
    top-k newest             per level, merged by rev_ts across levels

The index step (paper Fig 2), for index-mode plans:

    postings    per condition and level, one contiguous slice of the
                sorted index level (two binary searches), capped at
                min(index_postings, level size), sorted into one slab
    combine     AND: membership of the first slab's rev_ts in every other
                slab, through the merge_intersect kernel; OR: a sorted
                merge
    expand      candidate rev_ts -> rows of every event level by binary
                search and prefix-sum expansion, min(index_rows, level
                size) rows per level
    filter      the FULL tree re-checks the candidate rows of every level
                (one filter_scan launch), then count and top-k as in the
                scan step

A posting or row slab that overflows reports truncation and the batch
reruns as the exact scan step. The planner's densities come from the
aggregate family (density_step): per level a searchsorted and a masked
sum, summed over T.

Scan-time aggregation (aggregate_range) reuses both: the aggregate step
filters every level in range and reduces the matching rows into a dense
per-group array (mixed-radix group ids, plain scatter reductions), and
for index-mode plans the index aggregate step reduces only the gathered
candidate rows, falling back to the aggregate step on truncation.

Every read searches ALL LSM levels of the snapshot — the base, the K
sorted-run slabs and the sealed memtable — so publish() never folds; a
base-only snapshot (from_event_store) has the base alone. A sharded
plane publishes a composite snapshot, and every read fans out over its
groups' sub-snapshots. A query's filter program is prepared on the
device once (a kernels.program_eval.Program) and every step, on every
sub-snapshot, reuses it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import keypack
from .batching import AdaptiveBatcher
from .device import resolve_device
from .filter import compile_tree
from .iterators import AggregateResult, AggregateSpec, ResolvedGrouping, resolve_grouping
from .planner import QueryPlan, plan_query
from .query import QueryStats
from .spmd import Record, StoreView
from .store import EventStore
from ..distributed.sharding import P
from ..kernels.combine_scan.ref import IDENTITY
from ..kernels.filter_scan import filter_scan_levels, program_tensors
from ..kernels.merge_intersect import member_mask
from ..obs import span

INVALID_TS = -1
_I32_MAX = np.iinfo(np.int32).max


@dataclass
class DistStore:
    """A published snapshot of the device tablet grid at all LSM levels
    (T tablets, base capacity R, K run slots, memtable M). Event family:

      rev_ts (T, R) int32, cols (T, R, F) int32, counts (T,) int32  — base
      run_rev_ts (T, K, M), run_cols (T, K, M, F), run_counts (T, K) — runs
      mem_rev_ts (T, M), mem_cols (T, M, F), mem_counts (T,)  — sealed memtable

    Index family (packed int64 keys field|value|rev_ts, n_indexed times
    the event slabs' widths): ix_keys (T, Ci) with ix_counts, ix_run_k
    (T, K, Mi) with ix_run_n, ix_mem_k (T, Mi) with ix_mem_n.

    Aggregate family (packed int64 keys field|value|bucket with int64
    counts): ag_keys (T, Ca), ag_vals (T, Ca, 1), ag_counts; ag_run_k,
    ag_run_c, ag_run_n; ag_mem_k, ag_mem_c, ag_mem_n. Keys are unique per
    tablet in the base only; run and memtable levels may repeat a key and
    readers sum across levels. agg_bucket_s is the bucketing.

    Each level is sorted with its sentinel (INT32_MAX, INT64_MAX) past its
    live count; run slots may hold stale rows past their counts after a
    major, so every search clamps by the live counts. The ix/ag fields are
    None for a plane without indexed fields; the processor then plans
    every query as a filter scan. The run and memtable fields are None
    for a base-only snapshot (a from_event_store bulk replay, folded up
    front); reads then search the base alone. density_cache memoizes the
    planner's density reads for the life of this (immutable) snapshot.

    A composite snapshot (a sharded plane's publish) has every level field
    None and holds the groups' sub-snapshots in ``groups``, in global
    tablet order; ``gens`` maps "g<i>" to each group's level generations.
    Each sub-snapshot keeps its own density_cache, so a group clean since
    the last publish keeps its densities. A plane's snapshot carries its
    level generations ({"mem", "runs", "base"}) in ``gens``.

    On a mesh (``mesh`` a DeviceMesh over the default process group) the
    level tensors hold this rank's tablets only, the global tablets
    ``tablets`` = [lo, hi); n_tablets counts every rank's. A composite
    and its sub-snapshots all carry the mesh.
    """

    rev_ts: Optional[torch.Tensor] = None
    cols: Optional[torch.Tensor] = None
    counts: Optional[torch.Tensor] = None
    run_rev_ts: Optional[torch.Tensor] = None
    run_cols: Optional[torch.Tensor] = None
    run_counts: Optional[torch.Tensor] = None
    mem_rev_ts: Optional[torch.Tensor] = None
    mem_cols: Optional[torch.Tensor] = None
    mem_counts: Optional[torch.Tensor] = None
    ix_keys: Optional[torch.Tensor] = None
    ix_counts: Optional[torch.Tensor] = None
    ix_run_k: Optional[torch.Tensor] = None
    ix_run_n: Optional[torch.Tensor] = None
    ix_mem_k: Optional[torch.Tensor] = None
    ix_mem_n: Optional[torch.Tensor] = None
    ag_keys: Optional[torch.Tensor] = None
    ag_vals: Optional[torch.Tensor] = None
    ag_counts: Optional[torch.Tensor] = None
    ag_run_k: Optional[torch.Tensor] = None
    ag_run_c: Optional[torch.Tensor] = None
    ag_run_n: Optional[torch.Tensor] = None
    ag_mem_k: Optional[torch.Tensor] = None
    ag_mem_c: Optional[torch.Tensor] = None
    ag_mem_n: Optional[torch.Tensor] = None
    agg_bucket_s: Optional[int] = None
    gens: Optional[Dict[str, object]] = None
    groups: Optional[Tuple["DistStore", ...]] = None
    mesh: Optional[object] = None
    tablets: Optional[Tuple[int, int]] = None
    density_cache: Dict[Tuple, int] = field(default_factory=dict, repr=False)

    @property
    def is_composite(self) -> bool:
        return self.groups is not None

    @property
    def n_tablets(self) -> int:
        """Global tablets: every rank's on a mesh."""
        if self.groups is not None:
            return sum(g.n_tablets for g in self.groups)
        ranks = 1 if self.mesh is None else self.mesh.size()
        return self.rev_ts.shape[0] * ranks

    @property
    def capacity(self) -> int:
        if self.groups is not None:
            return self.groups[0].capacity
        return self.rev_ts.shape[1]

    @property
    def device(self) -> torch.device:
        if self.groups is not None:
            return self.groups[0].device
        return self.rev_ts.device

    @property
    def has_index(self) -> bool:
        if self.groups is not None:
            return self.groups[0].has_index
        return self.ix_keys is not None

    @property
    def has_runs(self) -> bool:
        """True when the snapshot carries run and sealed-memtable levels (a
        plane's publish); False for a base-only snapshot."""
        if self.groups is not None:
            return self.groups[0].has_runs
        return self.run_rev_ts is not None

    def ev_levels(self):
        """(rev_ts, cols, live counts) of the base, then of the runs and the
        memtable when the snapshot has them."""
        base = (self.rev_ts, self.cols, self.counts)
        if not self.has_runs:
            return (base,)
        return (base, (self.run_rev_ts, self.run_cols, self.run_counts),
                (self.mem_rev_ts, self.mem_cols, self.mem_counts))

    def ix_levels(self):
        """(keys, live counts) of the index levels, as ev_levels."""
        base = (self.ix_keys, self.ix_counts)
        if not self.has_runs:
            return (base,)
        return (base, (self.ix_run_k, self.ix_run_n), (self.ix_mem_k, self.ix_mem_n))

    def ag_levels(self):
        """(keys, counts (..., C, 1), live counts) of the aggregate levels,
        as ev_levels."""
        base = (self.ag_keys, self.ag_vals, self.ag_counts)
        if not self.has_runs:
            return (base,)
        return (base, (self.ag_run_k, self.ag_run_c, self.ag_run_n),
                (self.ag_mem_k, self.ag_mem_c, self.ag_mem_n))


# --------------------------------------------------------------- mesh
def mesh_rank(mesh) -> Tuple[int, int]:
    """(this rank's row-major linear index over the mesh's axes, the number
    of ranks): the reference's _linear_device_index. The mesh must hold the
    default process group's ranks in row-major order, as init_device_mesh
    (and so launch/mesh.py) lays them out: every collective of the store
    runs over the default group, whose rank order is then the mesh's."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a store on a mesh needs a process group")
    order = mesh.mesh.flatten().tolist()  # the global rank at each linear index
    if order != list(range(dist.get_world_size())):
        raise ValueError(f"the store's mesh must hold the default process group's "
                         f"{dist.get_world_size()} ranks in row-major order; it holds {order}")
    return dist.get_rank(), len(order)


def tablet_specs(mesh) -> Dict[str, P]:
    """Tablets shard over all mesh axes, every rank a tablet server: the
    reference's partition specs of the base slabs."""
    axes = tuple(mesh.mesh_dim_names)
    return {"rev_ts": P(axes, None), "cols": P(axes, None, None), "counts": P(axes)}


def dist_store_shapes(mesh, rows_per_tablet: int, n_fields: int,
                      tablets_per_device: int = 1) -> Dict[str, torch.Tensor]:
    """The global shapes and dtypes of the base slabs of a store on
    ``mesh``, as meta tensors (nothing allocated), for the dry-run."""
    t = mesh.size() * tablets_per_device

    def meta(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    return {"rev_ts": meta(t, rows_per_tablet), "cols": meta(t, rows_per_tablet, n_fields),
            "counts": meta(t)}


def _group_name() -> str:
    import torch.distributed as dist

    return dist.group.WORLD.group_name


def _all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    """t reduced over every rank of the default group ("sum", "min" or
    "max"), a functional collective (the dry-run's cost model sees it)."""
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(c10d.all_reduce(t, op, _group_name()))


def _all_gather(mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's (n, ...) t as one (R * n, ...) tensor in row-major mesh
    order (mesh_rank: the default group's rank order): the reference's
    out-spec P(axes, ...)."""
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(c10d.all_gather_into_tensor(t.contiguous(), mesh.size(),
                                                        _group_name()))


_MESH_REDUCE = {"count": "sum", "sum": "sum", "min": "min", "max": "max"}


def _mesh_aggs(d: DistStore, aggs: torch.Tensor, cnts: torch.Tensor, op: str):
    """The per-rank dense (aggs, cnts) combined over the mesh: the
    reference's psum, pmin or pmax of the aggregates and psum of the counts.
    An empty group keeps its identity (0, INT32_MAX or INT32_MIN)."""
    if d.mesh is None:
        return aggs, cnts
    return _all_reduce(aggs, _MESH_REDUCE[op]), _all_reduce(cnts, "sum")


def _mesh_sums(d: DistStore, *scalars: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """int32 scalars summed over the mesh in one all-reduce."""
    if d.mesh is None:
        return scalars
    return tuple(_all_reduce(torch.stack(scalars), "sum").unbind(0))


def _mesh_slates(d: DistStore, out_ts: torch.Tensor, out_cols: torch.Tensor):
    """Per-tablet top-k slates of every rank, in global tablet order."""
    if d.mesh is None:
        return out_ts, out_cols
    return _all_gather(d.mesh, out_ts), _all_gather(d.mesh, out_cols)


# reprolint: hot-path — a mesh query's adaptive batcher reads this per batch
def _agreed_seconds(d: DistStore, seconds: float) -> float:
    """A batch's runtime as every rank's batcher must read it: on a mesh the
    slowest rank's (the all-reduced MAX), since batch ranges that differ
    between ranks would pair different steps' collectives."""
    if d.mesh is None:
        return seconds
    t = torch.tensor(seconds, dtype=torch.float64).to(d.device)
    with span("query.agree_runtime", cat="query") as sp:
        return float(sp.fence(_all_reduce(t, "max")))


def _searchsorted(seq: torch.Tensor, values: torch.Tensor, right: bool = False) -> torch.Tensor:
    """int32 insertion points of values (..., n) in the sorted rows of seq
    (..., m), leading dims equal."""
    return torch.searchsorted(seq, values.contiguous(), right=right, out_int32=True)


def _in_range(keys: torch.Tensor, probe: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Mask of the entries of each sorted row of keys (..., C) that lie in
    [probe[0], probe[1]) and below the row's live count (...)."""
    a, b = _searchsorted(keys, probe.expand(*keys.shape[:-1], 2)).unbind(-1)
    idx = torch.arange(keys.shape[-1], dtype=torch.int32, device=keys.device)
    return (idx >= a[..., None]) & (idx < b[..., None]) & (idx < live[..., None])


def _sum_levels(*parts: torch.Tensor) -> torch.Tensor:
    """Per-tablet int32 sum of a per-level quantity: (T,) for the base and
    the memtable, (T, K) for the runs."""
    total = parts[0]
    for p in parts[1:]:
        total = total + (p.sum(dim=1, dtype=torch.int32) if p.dim() == 2 else p)
    return total


def _filter_topk(rev, cols, hit, top_k: int):
    """Count and top-k newest over one level's matching rows, batched over
    leading dims: rev (..., R), cols (..., R, F), hit (..., R) the rows in
    play that pass the filter. Returns int32 (...) counts, and the (..., k)
    newest matches' rev_ts (INT32_MAX-padded) and (..., k, F) cols (-1
    padded), k = min(top_k, R)."""
    r, f = rev.shape[-1], cols.shape[-1]
    count = hit.sum(dim=-1, dtype=torch.int32)
    idx = torch.arange(r, dtype=torch.int32, device=rev.device)
    rank = torch.where(hit, idx, r)
    top = torch.topk(rank, min(top_k, r), dim=-1, largest=False, sorted=True).values
    valid = top < r
    safe = top.clamp(0, r - 1).long()
    out_rev = torch.where(valid, rev.gather(-1, safe), _I32_MAX)
    picked = cols.gather(-2, safe[..., None].expand(*safe.shape, f))
    return count, out_rev, torch.where(valid[..., None], picked, -1)


def _merge_level_topk(rev_parts: List[torch.Tensor], col_parts: List[torch.Tensor],
                      top_k: int):
    """Merge per-level top-k slates per tablet: concatenate the (T, k_i)
    rev_ts (INT32_MAX-padded) and (T, k_i, F) cols and keep the top_k
    smallest rev_ts — the newest rows — in a stable order."""
    all_rev = torch.cat(rev_parts, dim=1)
    all_cols = torch.cat(col_parts, dim=1)
    order = torch.sort(all_rev, dim=1, stable=True).indices[:, :top_k]
    f = all_cols.shape[-1]
    return all_rev.gather(1, order), all_cols.gather(1, order[..., None].expand(*order.shape, f))


def _merged_slates(parts, top_k: int):
    """Per-level (count, rev, cols) triples of the snapshot's levels ->
    int32 (T,) counts and the merged (T, k) ts (-1 where none) and (T, k,
    F) cols."""
    t, f = parts[0][1].shape[0], parts[0][2].shape[-1]
    out_rev, out_cols = _merge_level_topk([r.reshape(t, -1) for _, r, _ in parts],
                                          [c.reshape(t, -1, f) for _, _, c in parts], top_k)
    out_ts = torch.where(out_rev < _I32_MAX, out_rev, INVALID_TS)
    return _sum_levels(*(c for c, _, _ in parts)), out_ts, out_cols


def scan_step(d: DistStore, program, rts_lo: int, rts_hi: int, top_k: int = 128):
    """One scan over every tablet and every LSM level of a snapshot — the
    port of the reference's run-aware build_scan_step. ``program`` is the
    query's Program on the snapshot's device (or the original form's four
    int32 tensors); the rev_ts range is [rts_lo, rts_hi). Per level the
    range restriction, and for all levels one filter_scan launch. Returns
    the int32 total count, the (T, k) newest matches' rev_ts per tablet (-1
    where there is none) and their (T, k, F) cols. On a mesh each rank
    scans its own tablets; the count is all-reduced and the slates
    all-gathered, so every rank returns the global result."""
    probe = torch.tensor([rts_lo, rts_hi], dtype=torch.int32).to(d.device)
    levels = d.ev_levels()
    hits = filter_scan_levels([cols for _, cols, _ in levels], program)
    parts = [_filter_topk(rev, cols, hit & _in_range(rev, probe, live), top_k)
             for (rev, cols, live), hit in zip(levels, hits)]
    count, out_ts, out_cols = _merged_slates(parts, top_k)
    (total,) = _mesh_sums(d, count.sum(dtype=torch.int32))
    return (total, *_mesh_slates(d, out_ts, out_cols))


# ------------------------------------------------------------ density
def density_step(d: DistStore, lo: int, hi: int) -> torch.Tensor:
    """The planner's density read: the int64 total count over the packed
    aggregate-key range [lo, hi), per tablet and level a searchsorted and a
    masked sum (run and memtable levels may repeat a key; their counts
    add), summed over T and the mesh — the port of build_density_step."""
    probe = torch.tensor([lo, hi], dtype=torch.int64).to(d.device)
    total = torch.zeros((), dtype=torch.int64, device=d.device)
    for keys, vals, live in d.ag_levels():
        total = total + torch.where(_in_range(keys, probe, live), vals[..., 0], 0).sum()
    return total if d.mesh is None else _all_reduce(total, "sum")


# -------------------------------------------------------------- index
def _postings(keys, live, lo, hi, max_postings: int):
    """The postings of each condition over one index level, batched over
    its leading dims: keys (..., C) sorted int64, live (...) counts, lo/hi
    (n_conds,) int64 key ranges. Returns the (..., n_conds, cap) rev_ts
    (ascending, INT32_MAX-padded) with cap = min(max_postings, C), and the
    int32 (..., n_conds) postings past the cap."""
    c = keys.shape[-1]
    cap = min(max_postings, c)
    lead, nc = keys.shape[:-1], lo.shape[0]
    pos = torch.minimum(_searchsorted(keys, torch.cat([lo, hi]).expand(*lead, 2 * nc)),
                        live[..., None])
    a, cnt = pos[..., :nc], pos[..., nc:] - pos[..., :nc]
    j = torch.arange(cap, dtype=torch.int32, device=keys.device)
    idx = (a[..., None] + j).clamp(0, c - 1).long()
    kk = keys.gather(-1, idx.reshape(*lead, nc * cap)).reshape(*lead, nc, cap)
    rts = torch.where(j < cnt[..., None], (kk & keypack.TS_MAX).to(torch.int32), _I32_MAX)
    return rts, (cnt - cap).clamp(min=0)


def _posting_slabs(d: DistStore, lo, hi, max_postings: int):
    """Per-condition candidate rev_ts slabs from every index level: each
    level gives up to min(max_postings, level size) postings per tablet
    and condition, and the slates sort into one slab. Returns the int32
    (T, n_conds, S) slabs, S the sum of the per-level caps, and the int32
    (T,) postings dropped at the caps."""
    parts = [_postings(k, n, lo, hi, max_postings) for k, n in d.ix_levels()]
    t, nc = parts[0][0].shape[:2]
    # A run level's (T, K, n_conds, cap) slates line up per condition.
    slabs = torch.cat([s if s.dim() == 3 else s.transpose(1, 2).reshape(t, nc, -1)
                       for s, _ in parts], dim=-1)
    over = _sum_levels(*(o.sum(dim=-1, dtype=torch.int32) for _, o in parts))
    return torch.sort(slabs, dim=-1).values, over


def _combine_postings(slabs: torch.Tensor, combine: str):
    """The key-set combine (paper Fig 2) per tablet: AND keeps the first
    slab's rev_ts found in every other slab (one merge_intersect launch
    per further condition, over all tablets); OR is a sorted merge.
    Returns the (T, C) candidates, ascending, and their live mask —
    duplicates are dropped, since equal rev_ts expand to the same rows."""
    if combine == "intersect":
        cand = slabs[:, 0]
        keep = cand < _I32_MAX
        for i in range(1, slabs.shape[1]):
            keep &= member_mask(cand, slabs[:, i])
        cand = torch.sort(torch.where(keep, cand, _I32_MAX), dim=-1).values
    else:
        cand = torch.sort(slabs.reshape(slabs.shape[0], -1), dim=-1).values
    is_dup = torch.zeros_like(cand, dtype=torch.bool)
    is_dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
    return cand, (cand < _I32_MAX) & ~is_dup


def _expand_level(cand, live, rev, cols, nn, max_rows: int):
    """Expand the (T, C) candidate rev_ts against one event level, batched
    over its leading dims (T or T, K): candidate j covers the level's rows
    [lo_pos[j], hi_pos[j]) (binary searches clamped by the live count),
    and output slot m maps back to its candidate through one more binary
    search over the prefix sums. Returns the (..., cap) rows' rev_ts
    (INT32_MAX past the end), their (..., cap, F) cols (-1 past the end),
    the valid mask, and the int32 (...) rows matched and rows past the
    cap, with cap = min(max_rows, level size)."""
    lead, r, f = rev.shape[:-1], rev.shape[-1], cols.shape[-1]
    cap = min(max_rows, r)
    view = (cand.shape[0],) + (1,) * (len(lead) - 1) + (cand.shape[-1],)
    c = cand.reshape(view).expand(*lead, cand.shape[-1])
    lv = live.reshape(view).expand(*lead, cand.shape[-1])
    lo_pos = torch.minimum(_searchsorted(rev, c), nn[..., None])
    hi_pos = torch.minimum(_searchsorted(rev, c, right=True), nn[..., None])
    cnt_rows = torch.where(lv, hi_pos - lo_pos, 0)
    offs = torch.cumsum(cnt_rows, dim=-1, dtype=torch.int32)
    total = offs[..., -1]
    start = offs - cnt_rows
    m = torch.arange(cap, dtype=torch.int32, device=rev.device)
    j = _searchsorted(offs, m.expand(*lead, cap), right=True)
    jc = j.clamp(0, c.shape[-1] - 1).long()
    row_idx = lo_pos.gather(-1, jc) + (m - start.gather(-1, jc))
    valid = m < total[..., None]
    safe = row_idx.clamp(0, r - 1).long()
    r_rev = torch.where(valid, rev.gather(-1, safe), _I32_MAX)
    r_cols = torch.where(valid[..., None],
                         cols.gather(-2, safe[..., None].expand(*safe.shape, f)), -1)
    return r_rev, r_cols, valid, total, (total - cap).clamp(min=0)


def _expand_levels(cand, live, d: DistStore, max_rows: int):
    """_expand_level over every level of the event family."""
    return [_expand_level(cand, live, rev, cols, nn, max_rows) for rev, cols, nn in d.ev_levels()]


def _gather_candidates(d: DistStore, lo, hi, combine: str, max_postings: int, max_rows: int):
    """The index path's candidate gather (paper Fig 2 up to the row fetch):
    posting slabs per condition, the AND/OR combine, and the candidate
    rows of every event level. Returns the per-level _expand_level
    outputs and the int32 (T,) truncation and candidate-row counts."""
    slabs, post_over = _posting_slabs(d, lo, hi, max_postings)
    cand, live = _combine_postings(slabs, combine)
    levels = _expand_levels(cand, live, d, max_rows)
    truncated = post_over + _sum_levels(*(lv[4] for lv in levels))
    candidates = _sum_levels(*(lv[3] for lv in levels))
    return levels, truncated, candidates


def index_step(d: DistStore, program, lo, hi, combine: str, top_k: int = 128,
               max_postings: int = 2048, max_rows: int = 4096):
    """One index-mode step over every tablet and level — the port of the
    reference's run-aware build_index_step. lo/hi are the (n_conds,) int64
    packed index-key ranges of the plan's conditions for this batch; the
    program is the FULL tree's, re-checked on every candidate row, so a
    rev_ts shared by distinct rows costs a wasted candidate, never a
    wrong result. Returns int32 scalars (count, truncated, candidates)
    and the per-tablet top-k (ts, cols) as scan_step does; truncated > 0
    means a slab overflowed and the count is a lower bound. On a mesh the
    three scalars are summed over the ranks in one all-reduce and the
    slates all-gathered."""
    levels, truncated, candidates = _gather_candidates(d, lo, hi, combine, max_postings,
                                                       max_rows)
    hits = filter_scan_levels([lv[1] for lv in levels], program)
    parts = [_filter_topk(r_rev, r_cols, hit & valid, top_k)
             for (r_rev, r_cols, valid, _, _), hit in zip(levels, hits)]
    count, out_ts, out_cols = _merged_slates(parts, top_k)
    total, truncated, candidates = _mesh_sums(d, count.sum(dtype=torch.int32),
                                              truncated.sum(dtype=torch.int32),
                                              candidates.sum(dtype=torch.int32))
    out_ts, out_cols = _mesh_slates(d, out_ts, out_cols)
    return total, out_ts, out_cols, truncated, candidates


# -------------------------------------------------------- aggregation
def _group_ids(r_rev, r_cols, grouping: ResolvedGrouping) -> torch.Tensor:
    """Flat int64 group ids of a slab's rows: int32 mixed-radix codes plus
    the floored time bucket, clamped into [0, n_groups) (junk rows clamp
    too; callers give them the identity)."""
    gid = torch.zeros(r_rev.shape, dtype=torch.int32, device=r_rev.device)
    for fid, stride in zip(grouping.fids, grouping.strides):
        gid = gid + r_cols[..., fid] * stride
    if grouping.spec.time_bucket_s is not None:
        ts = keypack.TS_MAX - r_rev
        gid = gid + torch.div(ts, grouping.spec.time_bucket_s, rounding_mode="floor") \
            - grouping.bucket_lo
    return gid.clamp(0, grouping.size - 1).reshape(-1).long()


def _segment_aggregate(r_rev, r_cols, hit, grouping: ResolvedGrouping, value_table):
    """The CombinerIterator body on the device: the matching rows of one
    level's slab, batched over its leading dims, reduced into the dense
    group-id space. r_rev (..., R) int32, r_cols (..., R, F), hit (..., R)
    the matching rows; value_table int32 (codes -> numeric values, unread
    for count). Returns (aggs, int64 cnts), both (n_groups,): int64 sums
    for count and sum, int32 min or max."""
    op = grouping.spec.op
    n_groups = grouping.size
    dev = r_rev.device
    gid = _group_ids(r_rev, r_cols, grouping)
    hit = hit.reshape(-1)
    if grouping.value_fid is not None:
        codes = r_cols[..., grouping.value_fid].clamp(0, value_table.shape[0] - 1)
        val = value_table[codes.long()].reshape(-1)
    else:
        val = torch.ones(hit.shape, dtype=torch.int32, device=dev)
    ident = IDENTITY[op]
    if op in ("count", "sum"):
        # Sums accumulate in int64, as the host iterator stack's do.
        aggs = torch.zeros(n_groups, dtype=torch.int64, device=dev)
        aggs.index_add_(0, gid, torch.where(hit, val.to(torch.int64), 0))
    else:
        aggs = torch.full((n_groups,), ident, dtype=torch.int32, device=dev)
        aggs.scatter_reduce_(0, gid, torch.where(hit, val, ident),
                             "amin" if op == "min" else "amax")
    cnts = torch.zeros(n_groups, dtype=torch.int64, device=dev)
    cnts.index_add_(0, gid, hit.to(torch.int64))
    return aggs, cnts


def _combine_level_aggs(parts, op: str):
    """Merge per-level (aggs, cnts) partials: rows are disjoint across
    levels, so sums and counts add and min/max fold elementwise."""
    aggs, cnts = parts[0]
    for a, c in parts[1:]:
        if op in ("count", "sum"):
            aggs = aggs + a
        elif op == "min":
            aggs = torch.minimum(aggs, a)
        else:
            aggs = torch.maximum(aggs, a)
        cnts = cnts + c
    return aggs, cnts


def aggregate_step(d: DistStore, program, value_table, grouping: ResolvedGrouping,
                   rts_lo: int, rts_hi: int):
    """Scan-time aggregation over every tablet and LSM level — the port of
    the reference's run-aware build_aggregate_step: per level the rev_ts
    range [rts_lo, rts_hi) and the filter program (one filter_scan launch
    for all levels) select the rows, and _segment_aggregate reduces them
    over the tablets and run slots in one scatter (the reference's
    per-tablet segments), then over the mesh with an all-reduce of SUM, MIN
    or MAX (its psum, pmin or pmax). Returns the dense (n_groups,) aggs and
    int64 cnts."""
    probe = torch.tensor([rts_lo, rts_hi], dtype=torch.int32).to(d.device)
    levels = d.ev_levels()
    hits = filter_scan_levels([cols for _, cols, _ in levels], program)
    parts = [_segment_aggregate(rev, cols, hit & _in_range(rev, probe, live), grouping,
                                value_table)
             for (rev, cols, live), hit in zip(levels, hits)]
    op = grouping.spec.op
    return _mesh_aggs(d, *_combine_level_aggs(parts, op), op)


def index_aggregate_step(d: DistStore, program, value_table, grouping: ResolvedGrouping,
                         lo, hi, combine: str, max_postings: int = 2048,
                         max_rows: int = 4096):
    """Index-driven aggregation — the port of build_index_aggregate_step:
    index_step's candidate gather feeding _segment_aggregate, so a
    selective aggregate reduces only the candidate rows. The FULL tree
    re-checks every candidate row. Returns the dense (n_groups,) aggs and
    int64 cnts, and the int32 scalars truncated (> 0: a slab overflowed,
    the caller reruns the exact aggregate step) and candidates, all
    combined over the mesh as aggregate_step and index_step combine them."""
    levels, truncated, candidates = _gather_candidates(d, lo, hi, combine, max_postings,
                                                       max_rows)
    hits = filter_scan_levels([lv[1] for lv in levels], program)
    parts = [_segment_aggregate(r_rev, r_cols, hit & valid, grouping, value_table)
             for (r_rev, r_cols, valid, _, _), hit in zip(levels, hits)]
    op = grouping.spec.op
    aggs, cnts = _mesh_aggs(d, *_combine_level_aggs(parts, op), op)
    truncated, candidates = _mesh_sums(d, truncated.sum(dtype=torch.int32),
                                       candidates.sum(dtype=torch.int32))
    return aggs, cnts, truncated, candidates


# ---------------------------------------------------------- execution
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


class _PinnedSource:
    """The planner's density source bound to one published snapshot: a
    query plans from the same LSM state its batches execute against.
    ``profile`` (a serve_db QueryProfile, or None) accrues the density
    reads' seconds in density_acc_s."""

    def __init__(self, proc: "DistQueryProcessor", dist: DistStore, profile=None):
        self._proc = proc
        self._dist = dist
        self._profile = profile

    @property
    def schema(self):
        return self._proc.store.schema

    @property
    def dictionaries(self):
        return self._proc.store.dictionaries

    def agg_count(self, field: str, value: str, t_start: int, t_stop: int) -> int:
        if self._profile is None:
            return self._proc._agg_count_on(self._dist, field, value, t_start, t_stop)
        t0 = time.perf_counter()
        out = self._proc._agg_count_on(self._dist, field, value, t_start, t_stop)
        self._profile.density_acc_s += time.perf_counter() - t0
        return out


class QueryRun:
    """One planned query pinned to one published snapshot, stepped one
    adaptive batch at a time. An 'empty' plan dispatches no device work.

    The serve plane (repro_torch.serve_db) interleaves many sessions' runs
    under its device lock, one step per batch. Published levels are never
    written in place, so a concurrent publish or compaction cannot change
    a pinned run's results. ``profile`` (a serve_db QueryProfile, or None)
    accrues the planner's density reads and each step's device section.

    On rank 0 of a control log (core/spmd.py) the run is built on a pinned
    publish and logged ("run"), and so is every step ("step") and an
    abandoned run's close ("finish"): every follower builds and steps the
    same run, so the steps' collectives pair. The run's decisions (which
    session steps when) stay rank 0's. A request that cannot be built (a
    tree too deep for the device stack, an unknown node or field) raises
    before anything is logged; an exception once the run was logged ends
    the log."""

    def __init__(self, proc: "DistQueryProcessor", tree, t_start: int, t_stop: int,
                 use_index: bool = True, batched: bool = True,
                 stats: Optional[QueryStats] = None, profile=None):
        self._ctl = proc._control
        self.qid: Optional[int] = None
        if self._ctl is None:
            self._build(proc, tree, t_start, t_stop, use_index, batched, stats, profile)
            return
        if batched and t_stop < t_start:  # the batcher's refusal, before the log
            raise ValueError("t_stop < t_start")
        compile_tree(proc.store, tree)  # a tree that cannot compile raises before the log
        d, pub, lens = proc._pin()
        rps = proc.store.rows_per_second()
        self.qid = self._ctl.next_id()
        self._ctl.put(Record("run", (self.qid, pub, proc._params(), rps, tree, t_start, t_stop,
                                     use_index, batched, profile is not None)))
        try:
            self._build(proc._pinned(d, lens, rps), tree, t_start, t_stop, use_index, batched,
                        stats, profile)
        except BaseException as e:  # the followers built it: the log cannot go on
            self._ctl.abort(e)
            raise

    def _build(self, proc, tree, t_start, t_stop, use_index, batched, stats, profile) -> None:
        self.proc = proc
        self.tree = tree
        self.t_start = t_start
        self.t_stop = t_stop
        self.stats = stats
        self.profile = profile
        self.dist = proc._sync()  # pinned for the whole run
        source = (_PinnedSource(proc, self.dist, profile=profile) if self.dist.has_index
                  else proc.store)
        with span("query.plan", cat="query") as sp:
            self.plan = plan_query(source, tree, t_start, t_stop, w=proc.w,
                                   use_index=use_index and self.dist.has_index)
            sp.set(mode=self.plan.mode)
        if stats is not None:
            stats.plan = self.plan
        self._empty = self.plan.mode == "empty"
        # The filter program, prepared on the device once for every batch.
        self.program = None if self._empty else proc._program(tree, self.dist.device)
        self._single_done = False
        self.batcher: Optional[AdaptiveBatcher] = None
        if batched and not self._empty:
            rps = proc.store.rows_per_second()
            self.batcher = AdaptiveBatcher(t_start=t_start, t_stop=t_stop, b0=rps and 10.0 / rps)

    @property
    def done(self) -> bool:
        if self._empty:
            return True
        if self.batcher is None:
            return self._single_done
        return self.batcher.done

    # reprolint: hot-path — one serve-plane turn is N of these steps
    def step(self) -> Optional[DistBatch]:
        """Execute the next adaptive batch and return it; None once done."""
        if self.done:
            return None
        if self._ctl is None:
            return self._step()
        self._ctl.put(Record("step", (self.qid,)))
        try:
            return self._step()
        except BaseException as e:  # the followers joined this step's collectives
            self._ctl.abort(e)
            raise

    def close(self) -> None:
        """Drop a run before it is done: on rank 0 of a control log the
        followers drop theirs."""
        if self._ctl is not None and not self.done and self._ctl.live:
            self._ctl.put(Record("finish", (self.qid,)))

    # reprolint: hot-path — the body of step()
    def _step(self) -> DistBatch:
        if self.batcher is None:
            lo, hi = float(self.t_start), float(self.t_stop)
        else:
            lo, hi = self.batcher.next_range()
        t0 = time.perf_counter()
        with span("query.step", cat="query", mode=self.plan.mode) as sp:
            blk = self.proc._exec_range(self.plan, self.tree, int(lo), int(hi), self.stats,
                                        dist=self.dist, program=self.program,
                                        profile=self.profile)
            sp.set(rows=blk.count)
        runtime = _agreed_seconds(self.dist, time.perf_counter() - t0)
        if self.batcher is None:
            self._single_done = True
        else:
            self.batcher.update(runtime, blk.count)
        if self.stats is not None:
            self.stats.batches += 1
            self.stats.rows += blk.count
            self.stats.batch_log.append((lo, hi, runtime, blk.count))
        blk.lo, blk.hi = float(lo), float(hi)
        return blk


class DistQueryProcessor:
    """The four schemes of §IV-B and scan-time aggregation
    (aggregate_range) over a live DistIngestPlane or a static snapshot.
    With ``plane``, every query syncs to the plane's latest published
    snapshot, so rows written through DistBatchWriter are visible with no
    host round trip; with ``dist`` (a from_event_store replay, or a pinned
    publish) every query reads that snapshot. The planner reads its
    densities from the snapshot's aggregate tablets (agg_count), and
    index-mode plans run index_step per batch; a snapshot without indexed
    fields answers every scheme by scanning.

    ``device`` must be the plane's or the snapshot's device (default
    "cuda"; the CPU tests pass "cpu"). ``w`` is the planner's threshold;
    ``index_postings`` and ``index_rows`` cap the index step's posting and
    row slabs per level.

    On rank 0 of a plane's control log (core/spmd.py) every read that runs
    device steps — agg_count, aggregate_range, execute_batched, scan_range
    and scan_index_range without a pinned snapshot, and QueryRun — pins a
    publish and is logged first, so the followers run it with rank 0;
    a follower builds no processor of its own."""

    def __init__(self, store: EventStore, plane=None, top_k: int = 128, w: float = 10.0,
                 index_postings: int = 2048, index_rows: int = 4096, device="cuda",
                 dist: Optional[DistStore] = None):
        dev = resolve_device(device)
        ctl = getattr(plane, "control", None)
        if ctl is not None and not ctl.leads:
            raise RuntimeError(f"rank {ctl.rank} follows rank 0's control log: it runs the "
                               "queries rank 0 logs, and builds no processor of its own")
        if dist is None:
            if plane is None:
                raise ValueError("need dist= or plane=")
            if dev != plane.device:
                raise ValueError(f"processor device {dev} is not the plane's device "
                                 f"{plane.device}")
            dist = plane.publish()
        elif dev != dist.device:
            raise ValueError(f"processor device {dev} is not the snapshot's device {dist.device}")
        self.store = store
        self.plane = plane
        self.device = dev
        self.top_k = top_k
        self.w = w
        self.index_postings = index_postings
        self.index_rows = index_rows
        self.dist = dist

    def _sync(self) -> DistStore:
        """Refresh to the plane's latest published snapshot (if there is a
        plane) and return the snapshot to pin."""
        if self.plane is not None:
            self.dist = self.plane.publish()
        return self.dist

    # --------------------------------------------------------- control log
    @property
    def _control(self):
        """The plane's control log when this is its rank 0, else None."""
        ctl = getattr(self.plane, "control", None)
        return ctl if ctl is not None and ctl.leads else None

    def _pin(self) -> Tuple[DistStore, int, Dict[str, int]]:
        """plane.publish_pinned(), kept as this processor's latest snapshot
        as _sync keeps a publish: a processor that held its first snapshot
        for good would keep every level a compaction has since replaced."""
        d, pub, lens = self.plane.publish_pinned()
        self.dist = d
        return d, pub, lens

    def _params(self) -> Tuple[int, float, int, int]:
        return self.top_k, self.w, self.index_postings, self.index_rows

    def _pinned(self, d: DistStore, lens: Dict[str, int], rps: float) -> "DistQueryProcessor":
        """A processor on snapshot d that reads the dictionaries cut at
        lens, as every follower reads them for the same record."""
        return DistQueryProcessor(StoreView(self.store, lens, rps), dist=d, top_k=self.top_k,
                                  w=self.w, index_postings=self.index_postings,
                                  index_rows=self.index_rows, device=self.device)

    def _lead(self, name: str, *args, tree=None, local: Optional[dict] = None, **kwargs):
        """Run method ``name`` on a pinned publish, logged first ("call")
        so the followers run it too; ``local`` holds rank 0's own
        arguments (stats, profile), which the followers do without. The
        call's filter ``tree`` is compiled first, so that a tree that
        cannot compile raises before anything is logged."""
        ctl = self._control
        if tree is not None:
            compile_tree(self.store, tree)
        d, pub, lens = self._pin()
        rps = self.store.rows_per_second()
        proc = self._pinned(d, lens, rps)
        ctl.put(Record("call", (ctl.next_id(), pub, self._params(), rps, name, args, kwargs)))
        try:
            return getattr(proc, name)(*args, **kwargs, **(local or {}))
        except BaseException as e:  # the followers joined its collectives
            ctl.abort(e)
            raise

    # ------------------------------------------------ planner density source
    @property
    def schema(self):
        return self.store.schema

    @property
    def dictionaries(self):
        return self.store.dictionaries

    # reprolint: hot-path
    def agg_count(self, field: str, value: str, t_start: int, t_stop: int) -> int:
        """Occurrences of field=value in the bucketed time range, from the
        device's aggregate tablets at every level — the planner's d_i."""
        if self._control is not None:
            return self._lead("agg_count", field, value, t_start, t_stop)
        return self._agg_count_on(self._sync(), field, value, t_start, t_stop)

    # reprolint: hot-path — planning reads densities per condition per query
    def _agg_count_on(self, d: DistStore, field: str, value: str,
                      t_start: int, t_stop: int) -> int:
        """agg_count against one pinned snapshot, memoized in it (a
        published snapshot never changes, so its densities never go
        stale)."""
        if not d.has_index:
            return self.store.agg_count(field, value, t_start, t_stop)
        ckey = (field, value, int(t_start), int(t_stop))
        hit = d.density_cache.get(ckey)
        if hit is not None:
            return hit
        if d.groups is not None:
            # Densities sum over the disjoint groups, each memoized in its
            # own sub-snapshot, which outlives this composite while its
            # group stays clean.
            out = sum(self._agg_count_on(sub, field, value, t_start, t_stop)
                      for sub in d.groups)
            d.density_cache[ckey] = out
            return out
        code = self.store.dictionaries[field].lookup(value)
        if code is None:
            d.density_cache[ckey] = 0
            return 0
        fid = self.store.schema.field_id(field)
        b0 = int(t_start) // d.agg_bucket_s
        b1 = int(t_stop) // d.agg_bucket_s
        # keypack packs host-side numpy scalars — no device value, no sync.
        lo = int(keypack.pack_agg_key(fid, code, b0))  # reprolint: disable=no-sync-in-hot-path
        hi = int(keypack.pack_agg_key(fid, code, b1)) + 1  # reprolint: disable=no-sync-in-hot-path
        with span("query.density", cat="query", field=field, value=value) as sp:
            out = int(sp.fence(density_step(d, lo, hi)))
        d.density_cache[ckey] = out
        return out

    # ------------------------------------------------------------ steps
    def _program(self, tree, device: torch.device):
        """The tree's program prepared on the device (a Program, copied in
        one transfer); a query makes it once and every step reuses it."""
        return program_tensors(compile_tree(self.store, tree), device)

    # reprolint: hot-path — the per-batch device step of every scan scheme
    def scan_range(self, tree, t0: int, t1: int, dist: Optional[DistStore] = None,
                   program=None, profile=None) -> Tuple[int, np.ndarray, np.ndarray]:
        """One range scan across all tablets and all LSM levels, ts in
        [t0, t1]. Returns (global count, the top-k newest matching rows per
        tablet as (ts, cols) numpy arrays). ``dist`` pins a snapshot;
        ``program`` is the tree's prepared Program (made here if None);
        ``profile`` (a serve_db QueryProfile) accrues the device section in
        device_acc_s."""
        if dist is None and self._control is not None:
            return self._lead("scan_range", tree, t0, t1, tree=tree, local={"profile": profile})
        d = dist if dist is not None else self._sync()
        if program is None:
            program = self._program(tree, d.device)
        if d.groups is not None:
            # One step per group: counts sum and the top-k slates
            # concatenate (unordered across tablets, so across groups).
            parts = [self.scan_range(tree, t0, t1, dist=sub, program=program, profile=profile)
                     for sub in d.groups]
            return (sum(c for c, _, _ in parts), np.concatenate([p[1] for p in parts]),
                    np.concatenate([p[2] for p in parts]))
        rts_lo = keypack.rev_ts(int(t1))
        rts_hi = keypack.rev_ts(int(t0)) + 1
        tdev = time.perf_counter()
        with span("query.scan_range", cat="query") as sp:
            total, top_ts, top_cols = scan_step(d, program, rts_lo, rts_hi, self.top_k)
            count = int(sp.fence(total))
            ts = sp.fence(top_ts).cpu().numpy()
            cols = sp.fence(top_cols).cpu().numpy()
        if profile is not None:
            profile.device_acc_s += time.perf_counter() - tdev
        valid = ts != INVALID_TS
        return count, keypack.unrev_ts(ts[valid]), cols[valid]

    def _cond_ranges(self, plan: QueryPlan, t0: int, t1: int) -> Tuple[np.ndarray, np.ndarray]:
        """Per-condition packed index-key [lo, hi) ranges for the batch's
        time window (lo == hi for a never-seen value: no postings)."""
        rts_lo = keypack.rev_ts(t1)
        rts_hi = keypack.rev_ts(t0)
        k = len(plan.index_conds)
        lo = np.zeros(k, np.int64)
        hi = np.zeros(k, np.int64)
        for i, c in enumerate(plan.index_conds):
            code = self.store.dictionaries[c.field].lookup(c.value)
            if code is None:
                continue
            fid = self.store.schema.field_id(c.field)
            lo[i] = keypack.pack_index_key(fid, code, rts_lo)
            hi[i] = keypack.pack_index_key(fid, code, rts_hi) + 1
        return lo, hi

    # reprolint: hot-path — the per-batch device step of the index schemes
    def scan_index_range(self, plan: QueryPlan, tree, t0: int, t1: int,
                         dist: Optional[DistStore] = None, program=None, profile=None):
        """One index-mode range across all tablets and levels (paper Fig 2
        on the device): postings per condition per level, the device-side
        intersect or union, candidate rows from every level, and the FULL
        tree re-checked on them. Returns (global count, top-k (ts, cols),
        truncated, candidates); truncated > 0 means a slab overflowed and
        the count is a lower bound. ``program`` and ``profile`` as in
        scan_range."""
        if dist is None and self._control is not None:
            return self._lead("scan_index_range", plan, tree, t0, t1, tree=tree,
                              local={"profile": profile})
        d = dist if dist is not None else self._sync()
        if program is None:
            program = self._program(tree, d.device)
        if d.groups is not None:
            # Every group holds postings of the conditions: counts,
            # truncation and candidates sum, and the slates concatenate.
            parts = [self.scan_index_range(plan, tree, t0, t1, dist=sub, program=program,
                                           profile=profile)
                     for sub in d.groups]
            return (sum(p[0] for p in parts), np.concatenate([p[1] for p in parts]),
                    np.concatenate([p[2] for p in parts]), sum(p[3] for p in parts),
                    sum(p[4] for p in parts))
        lo, hi = self._cond_ranges(plan, t0, t1)
        tdev = time.perf_counter()
        ranges = torch.from_numpy(np.stack([lo, hi])).to(d.device)
        with span("query.scan_index_range", cat="query") as sp:
            total, top_ts, top_cols, truncated, cands = index_step(
                d, program, ranges[0], ranges[1], plan.combine, self.top_k,
                self.index_postings, self.index_rows)
            count, n_trunc, n_cands = (
                int(x) for x in sp.fence(torch.stack([total, truncated, cands])).cpu())
            ts = sp.fence(top_ts).cpu().numpy()
            cols = sp.fence(top_cols).cpu().numpy()
        if profile is not None:
            profile.device_acc_s += time.perf_counter() - tdev
        valid = ts != INVALID_TS
        return count, keypack.unrev_ts(ts[valid]), cols[valid], n_trunc, n_cands

    # reprolint: hot-path
    def _exec_range(self, plan: QueryPlan, tree, t0: int, t1: int,
                    stats: Optional[QueryStats] = None,
                    dist: Optional[DistStore] = None, program=None,
                    profile=None) -> DistBatch:
        d = dist if dist is not None else self.dist
        if plan.mode == "index" and d.has_index:
            count, ts, cols, truncated, cands = self.scan_index_range(
                plan, tree, t0, t1, dist=d, program=program, profile=profile)
            if stats is not None:
                stats.index_keys_scanned += cands
            if not truncated:
                return DistBatch(count, ts, cols)
            # A slab overflowed: redo this range with the exact scan step.
        count, ts, cols = self.scan_range(tree, t0, t1, dist=d, program=program,
                                          profile=profile)
        return DistBatch(count, ts, cols)

    def execute(self, tree, t_start: int, t_stop: int, use_index: bool = True,
                batched: bool = True, stats: Optional[QueryStats] = None
                ) -> Iterator[DistBatch]:
        """Stream DistBatch results for a planned query, pinned to one
        published snapshot: index-mode plans run index_step per batch,
        filter plans the scan step, and empty plans nothing."""
        run = QueryRun(self, tree, t_start, t_stop, use_index=use_index, batched=batched,
                       stats=stats)
        try:
            while not run.done:
                blk = run.step()
                if blk is not None:
                    yield blk
        finally:
            run.close()

    def run_scheme(self, scheme: str, t_start: int, t_stop: int, tree=None,
                   stats: Optional[QueryStats] = None) -> Iterator[DistBatch]:
        """The paper's four schemes by name."""
        flags = {
            "scan": dict(use_index=False, batched=False),
            "batched_scan": dict(use_index=False, batched=True),
            "index": dict(use_index=True, batched=False),
            "batched_index": dict(use_index=True, batched=True),
        }[scheme]
        return self.execute(tree, t_start, t_stop, stats=stats, **flags)

    # ------------------------------------------------------- aggregation
    @staticmethod
    def _materialize_agg(grouping: ResolvedGrouping, aggs, cnts) -> AggregateResult:
        """Host epilogue: only groups with at least one matching row exist.
        Values come back int64, counts int64 (the reference's dtypes)."""
        aggs = aggs.cpu().numpy().astype(np.int64)
        cnts = cnts.cpu().numpy()
        live = cnts > 0
        return AggregateResult(grouping, np.flatnonzero(live).astype(np.int64), aggs[live],
                               cnts[live])

    # reprolint: hot-path — one-shot aggregate turns run through here
    def aggregate_range(self, spec: AggregateSpec, tree, t0: int, t1: int,
                        use_index: bool = True, stats: Optional[QueryStats] = None,
                        dist: Optional[DistStore] = None) -> AggregateResult:
        """Scan-time aggregation over every tablet and level of one snapshot
        — the device form of QueryProcessor.aggregate, planner driven:
        index-mode plans aggregate only the gathered index candidates
        (falling back to the scan aggregation when a slab overflows),
        provably empty plans skip the device, and everything else runs the
        aggregate step. Returns the merged per-group result for ts in
        [t0, t1]. ``dist`` pins a snapshot; by default the plane's latest."""
        if dist is None and self._control is not None:
            resolve_grouping(self.store, spec, t0, t1)  # a bad spec raises before the log
            return self._lead("aggregate_range", spec, tree, t0, t1, use_index=use_index,
                              tree=tree, local={"stats": stats})
        d = dist if dist is not None else self._sync()
        grouping = resolve_grouping(self.store, spec, t0, t1)
        source = _PinnedSource(self, d) if d.has_index else self.store
        plan = plan_query(source, tree, t0, t1, w=self.w, use_index=use_index and d.has_index)
        if stats is not None:
            stats.plan = plan
        if plan.mode == "empty":
            e = np.empty(0, np.int64)
            return AggregateResult(grouping, e, e.copy(), e.copy())
        # One program and one value table serve every group. A composite
        # folds the groups' dense partials on the device: rows are disjoint
        # across groups, so sums and counts add and min/max fold
        # elementwise (each group falls back to the scan aggregation on its
        # own).
        program = self._program(tree, d.device)
        vt = grouping.value_table if grouping.value_table is not None else np.ones(1, np.int32)
        value_table = torch.from_numpy(vt).to(d.device)
        subs = d.groups if d.groups is not None else (d,)
        parts = [self._agg_range_on(sub, plan, grouping, tree, t0, t1, program, value_table,
                                    stats) for sub in subs]
        aggs, cnts = _combine_level_aggs(parts, grouping.spec.op)
        return self._materialize_agg(grouping, aggs, cnts)

    # reprolint: hot-path — aggregate_range's per-group device executor
    def _agg_range_on(self, d: DistStore, plan: QueryPlan, grouping: ResolvedGrouping,
                      tree, t0: int, t1: int, program, value_table,
                      stats: Optional[QueryStats] = None):
        """One (sub-)snapshot's aggregation as dense (aggs, cnts) device
        tensors: the index aggregate step for index-mode plans, rerun as
        the exact aggregate step when it truncated (a query.aggregate_scan
        span inside an index-mode plan is such a fallback)."""
        if plan.mode == "index" and d.has_index:
            lo, hi = self._cond_ranges(plan, t0, t1)
            ranges = torch.from_numpy(np.stack([lo, hi])).to(d.device)
            with span("query.aggregate_index", cat="query") as sp:
                aggs, cnts, truncated, cands = index_aggregate_step(
                    d, program, value_table, grouping, ranges[0], ranges[1], plan.combine,
                    self.index_postings, self.index_rows)
                n_trunc, n_cands = (int(x) for x in sp.fence(torch.stack([truncated, cands])).cpu())
            if stats is not None:
                stats.index_keys_scanned += n_cands
            if not n_trunc:
                return aggs, cnts
        with span("query.aggregate_scan", cat="query"):
            # keypack packs host-side numpy scalars — no device value, no sync.
            rts_lo = int(keypack.rev_ts(t1))  # reprolint: disable=no-sync-in-hot-path
            rts_hi = int(keypack.rev_ts(t0)) + 1  # reprolint: disable=no-sync-in-hot-path
            aggs, cnts = aggregate_step(d, program, value_table, grouping, rts_lo, rts_hi)
        return aggs, cnts

    def execute_batched(self, tree, t_start: int, t_stop: int,
                        stats: Optional[QueryStats] = None):
        """Algorithm 2 over the device scan, pinned to one snapshot: a list
        of (count, ts, cols) per adaptive batch."""
        if self._control is not None:
            return self._lead("execute_batched", tree, t_start, t_stop, tree=tree,
                              local={"stats": stats})
        d = self._sync()
        program = self._program(tree, d.device)
        rps = self.store.rows_per_second()
        batcher = AdaptiveBatcher(t_start=t_start, t_stop=t_stop, b0=rps and 10.0 / rps)
        results = []
        while not batcher.done:
            lo, hi = batcher.next_range()
            t0 = time.perf_counter()
            count, ts, cols = self.scan_range(tree, int(lo), int(hi), dist=d, program=program)
            batcher.update(_agreed_seconds(d, time.perf_counter() - t0), count)
            results.append((count, ts, cols))
            if stats is not None:
                stats.batches += 1
                stats.rows += count
        return results


def from_event_store(store: EventStore, capacity: Optional[int] = None, n_tablets: int = 1,
                     device="cuda", mesh=None) -> DistStore:
    """Re-shard a host EventStore's event tables onto the device by row
    hash (the paper's uniform random sharding), as a bulk replay through a
    DistIngestPlane: its appends and compactions build the sorted tablets
    and the index and aggregate families, and compact() folds everything
    into the base. Returns a base-only snapshot. Raises ValueError before
    the replay when ``capacity`` cannot hold the fullest tablet; by
    default the capacity is that tablet's row count. On a mesh every rank
    replays the same host store through the mesh plane and keeps its own
    n_tablets / R of the global tablets."""
    from .dist_ingest import DistIngestPlane

    rows_k, rows_c = [], []
    for tab in store.event_tablets:
        for run in tab.snapshot_runs():
            _, rts, h = keypack.unpack_event_key(run.keys)
            rows_k.append(np.stack([rts, h], 1))
            rows_c.append(run.cols)
    if rows_k:
        rk = np.concatenate(rows_k)
        rc = np.concatenate(rows_c)
    else:
        rk = np.zeros((0, 2), np.int64)
        rc = np.zeros((0, store.schema.n_fields), np.int32)
    assign = (rk[:, 1] % n_tablets).astype(np.int64)  # hash-uniform tablet choice
    most = int(np.bincount(assign, minlength=n_tablets).max())
    cap = capacity or max(most, 1)
    if most > cap:
        raise ValueError(f"tablet overflow: {most} rows for one tablet over capacity {cap}")
    # Per-tablet flush triggers are exact, so fixed slabs suffice: a tablet
    # majors every max_runs * mem_rows of its own rows.
    plane = DistIngestPlane.for_store(store, capacity=cap, n_tablets=n_tablets, mem_rows=8192,
                                      max_runs=8, append_rows=2048, device=device, mesh=mesh)
    plane.ingest(rk[:, 0].astype(np.int32), rc, assign)
    plane.compact()
    tel = plane.telemetry()
    overflow = sum(int(v.sum()) for k, v in tel.items() if k.endswith("overflow"))
    if mesh is not None:  # every rank must take the same branch below
        local = torch.tensor(overflow, dtype=torch.int64).to(plane.device)
        overflow = int(_all_reduce(local, "sum"))
    if overflow:  # the pre-check above bounds this; a plane-side loss must not pass
        raise ValueError(f"tablet overflow: {overflow} rows over capacity {cap}")
    s = plane.state
    has_ix = len(plane.families) > 1
    g = plane.group
    return DistStore(
        rev_ts=s["ev_base_k"], cols=s["ev_base_c"], counts=s["ev_base_n"],
        ix_keys=s["ix_base_k"] if has_ix else None,
        ix_counts=s["ix_base_n"] if has_ix else None,
        ag_keys=s["ag_base_k"] if has_ix else None,
        ag_vals=s["ag_base_c"] if has_ix else None,
        ag_counts=s["ag_base_n"] if has_ix else None,
        agg_bucket_s=plane.programs.agg_bucket_s if has_ix else None,
        mesh=mesh, tablets=None if mesh is None else (g.t0, g.t0 + g.n_tablets),
    )
