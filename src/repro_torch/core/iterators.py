"""Server-side iterator stack — Accumulo's composable scan-time iterators;
the port of the reference's core/iterators.py.

Every scan runs a configurable chain of iterators inside the tablet
server, so data is reduced before it crosses the network. An iterator
transforms one columnar RowBlock at a time, and a stack composes them in
order:

    VersioningIterator   newest-entry-wins on duplicate packed keys
    FilterIterator       compiled predicate program (filter_scan kernel)
    ProjectingIterator   column subset (fewer bytes to the client)
    CombinerIterator     sum/min/max/count grouped by key prefix — the
                         terminal iterator: rows become aggregates

The combiner is fused with the residual filter into one kernel launch
(kernels/combine_scan), so an aggregation query ships per-group partials
instead of rows. The kernels run on the iterator's ``device``: host rows
go there for each call and the results come back as numpy (device="cpu"
runs the plain versions).

Stack ordering rules (validated):
  * at most one CombinerIterator, and it must be last;
  * ProjectingIterator must come after any FilterIterator (the filter
    program addresses fields by schema id) and cannot precede a combiner.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from . import keypack
from .filter import FilterProgram, Node, compile_tree
from .scan import RowBlock
from ..kernels.combine_scan import combine_scan, trivial_program
from ..kernels.filter_scan import filter_rows, program_tensors
from ..kernels.program_eval import Program
from .device import resolve_device

MAX_GROUP_SPACE = 1 << 24  # dense-gid cap for the device aggregation


# --------------------------------------------------------------- aggregates
@dataclass(frozen=True)
class AggregateSpec:
    """Scan-time aggregation spec: "count events per src_ip per hour" is
    AggregateSpec(group_by=("src_ip",), time_bucket_s=3600)."""

    group_by: Tuple[str, ...]
    op: str = "count"  # 'count' | 'sum' | 'min' | 'max'
    value_field: Optional[str] = None  # aggregand for sum/min/max
    time_bucket_s: Optional[int] = None  # also group by ts // bucket

    def __post_init__(self):
        if self.op not in ("count", "sum", "min", "max"):
            raise ValueError(f"unknown combiner op {self.op!r}")
        if self.op != "count" and self.value_field is None:
            raise ValueError(f"op {self.op!r} needs value_field")
        if not self.group_by and self.time_bucket_s is None:
            raise ValueError("aggregate needs group_by fields or a time bucket")


@dataclass
class ResolvedGrouping:
    """AggregateSpec bound to a store and time range: mixed-radix packing
    of (group field codes ..., time bucket) into one int64 group id. Codes
    are dense per field and buckets dense over the query range, so the id
    space is dense — which lets the device path reduce into a fixed-size
    array."""

    spec: AggregateSpec
    fids: Tuple[int, ...]
    radices: Tuple[int, ...]  # dictionary sizes at bind time
    n_buckets: int
    bucket_lo: int  # t_start // bucket_s
    value_fid: Optional[int]
    value_table: Optional[np.ndarray]  # int32 [n_codes]: code -> numeric value

    @property
    def strides(self) -> Tuple[int, ...]:
        out: List[int] = []
        s = self.n_buckets
        for r in reversed(self.radices):
            out.append(s)
            s *= r
        return tuple(reversed(out))

    @property
    def size(self) -> int:
        s = self.n_buckets
        for r in self.radices:
            s *= r
        return s

    def group_ids(self, ts: np.ndarray, cols: np.ndarray) -> np.ndarray:
        gid = np.zeros(len(ts), np.int64)
        for fid, stride in zip(self.fids, self.strides):
            gid += cols[:, fid].astype(np.int64) * stride
        if self.spec.time_bucket_s is not None:
            gid += ts // self.spec.time_bucket_s - self.bucket_lo
        return gid

    def values(self, cols: np.ndarray) -> Optional[np.ndarray]:
        if self.value_fid is None:
            return None
        codes = np.clip(cols[:, self.value_fid], 0, len(self.value_table) - 1)
        return self.value_table[codes]

    def unpack(self, gids: np.ndarray) -> Tuple[Dict[str, np.ndarray], Optional[np.ndarray]]:
        """gids -> per-field code arrays and bucket-start timestamps."""
        rest = np.asarray(gids, np.int64)
        bucket_ts = None
        if self.spec.time_bucket_s is not None:
            b = rest % self.n_buckets
            bucket_ts = (b + self.bucket_lo) * self.spec.time_bucket_s
        rest = rest // self.n_buckets
        codes: Dict[str, np.ndarray] = {}
        for name, r in zip(reversed(self.spec.group_by), reversed(self.radices)):
            codes[name] = (rest % r).astype(np.int32)
            rest = rest // r
        return {k: codes[k] for k in self.spec.group_by}, bucket_ts


def numeric_value_table(store, field: str) -> np.ndarray:
    """code -> int32 numeric value of a numeric-string field (e.g.
    bytes_out); non-numeric strings map to 0 — the server-side decode that
    lets the combiner sum quantities, not dictionary codes."""
    d = store.dictionaries[field]
    table = np.zeros(max(len(d), 1), np.int32)
    for s, c in d._fwd.items():
        try:
            table[c] = int(float(s))
        except ValueError:
            pass
    return table


def resolve_grouping(store, spec: AggregateSpec, t_start: int, t_stop: int) -> ResolvedGrouping:
    fids = tuple(store.schema.field_id(f) for f in spec.group_by)
    radices = tuple(max(len(store.dictionaries[f]), 1) for f in spec.group_by)
    if spec.time_bucket_s is not None:
        bucket_lo = int(t_start) // spec.time_bucket_s
        n_buckets = int(t_stop) // spec.time_bucket_s - bucket_lo + 1
    else:
        bucket_lo, n_buckets = 0, 1
    value_fid = value_table = None
    if spec.value_field is not None:
        value_fid = store.schema.field_id(spec.value_field)
        value_table = numeric_value_table(store, spec.value_field)
    g = ResolvedGrouping(spec, fids, radices, n_buckets, bucket_lo, value_fid, value_table)
    if g.size > MAX_GROUP_SPACE:
        raise ValueError(
            f"group space too large ({g.size} > {MAX_GROUP_SPACE}); "
            "coarsen time_bucket_s or drop a group field"
        )
    return g


@dataclass
class AggregateBlock:
    """Per-(batch, tablet-set) partial aggregates — what the server ships
    instead of rows. gids are ResolvedGrouping-packed group ids."""

    shard: int  # -1: combined across shards in one launch
    gids: np.ndarray  # int64 [n]
    values: np.ndarray  # int64 [n] aggregate per group (overflow-safe sums)
    counts: np.ndarray  # int32 [n] matching rows per group

    @property
    def n(self) -> int:
        return int(self.gids.shape[0])

    @property
    def matched(self) -> int:
        """Rows that survived the filter (drives the adaptive batcher)."""
        return int(self.counts.sum())

    @property
    def nbytes(self) -> int:
        return self.gids.nbytes + self.values.nbytes + self.counts.nbytes


@dataclass
class AggregateResult:
    """Client-side merge of AggregateBlocks (one row per group)."""

    grouping: ResolvedGrouping
    gids: np.ndarray
    values: np.ndarray
    counts: np.ndarray

    @property
    def n_groups(self) -> int:
        return int(self.gids.shape[0])

    def total_matched(self) -> int:
        return int(self.counts.sum())

    def rows(self, store) -> List[dict]:
        """Decoded rows: {field: str, ..., 'bucket_ts': int | None,
        'value': int, 'count': int}."""
        codes, bucket_ts = self.grouping.unpack(self.gids)
        out = []
        for i in range(self.n_groups):
            row = {name: store.dictionaries[name].decode(arr[i]) for name, arr in codes.items()}
            row["bucket_ts"] = None if bucket_ts is None else int(bucket_ts[i])
            row["value"] = int(self.values[i])
            row["count"] = int(self.counts[i])
            out.append(row)
        return out


def merge_aggregate_blocks(grouping: ResolvedGrouping,
                           blocks: Iterable[AggregateBlock]) -> AggregateResult:
    """Combine partial aggregates across batches and shards — the
    client-side epilogue, over group cardinality, not row cardinality."""
    blocks = [b for b in blocks if b.n]
    if not blocks:
        e = np.empty(0, np.int64)
        return AggregateResult(grouping, e, e.copy(), np.empty(0, np.int32))
    gids = np.concatenate([b.gids for b in blocks])
    vals = np.concatenate([b.values for b in blocks])
    cnts = np.concatenate([b.counts for b in blocks])
    order = np.argsort(gids, kind="stable")
    gids, vals, cnts = gids[order], vals[order], cnts[order]
    heads = np.concatenate([[True], gids[1:] != gids[:-1]])
    starts = np.flatnonzero(heads)
    op = grouping.spec.op
    if op in ("count", "sum"):
        mvals = np.add.reduceat(vals.astype(np.int64), starts)
    elif op == "min":
        mvals = np.minimum.reduceat(vals, starts)
    else:
        mvals = np.maximum.reduceat(vals, starts)
    mcnts = np.add.reduceat(cnts.astype(np.int64), starts).astype(np.int32)
    return AggregateResult(grouping, gids[starts], mvals, mcnts)


# ---------------------------------------------------------------- iterators
class ScanIterator:
    """One stage of the server-side stack: RowBlock -> RowBlock (or, for
    the terminal combiner, RowBlock -> AggregateBlock). None drops the
    block."""

    def apply(self, block: RowBlock):
        raise NotImplementedError


class VersioningIterator(ScanIterator):
    """Accumulo's default iterator: keep the newest max_versions entries
    per key. Duplicate keys are adjacent and newest-first (rev_ts layout),
    so 'newest wins' = 'first occurrences win'."""

    def __init__(self, max_versions: int = 1):
        if max_versions < 1:
            raise ValueError("max_versions >= 1")
        self.max_versions = max_versions

    def apply(self, block: RowBlock) -> RowBlock:
        keys = block.keys
        n = len(keys)
        if n == 0:
            return block
        head = np.concatenate([[True], keys[1:] != keys[:-1]])
        run_start = np.maximum.accumulate(np.where(head, np.arange(n), 0))
        keep = np.arange(n) - run_start < self.max_versions
        if keep.all():
            return block
        return RowBlock(block.shard, keys[keep], block.cols[keep], block.field_ids)


class FilterIterator(ScanIterator):
    """The paper's §III-B filter as one stack stage: a compiled predicate
    program, prepared on ``device`` at the first block and evaluated there
    by the filter_scan kernel for every block."""

    def __init__(self, store, tree: Optional[Node] = None,
                 prog: Optional[FilterProgram] = None, device="cuda"):
        self.prog = prog if prog is not None else compile_tree(store, tree)
        self.device = device
        self._program: Optional[Program] = None

    def apply(self, block: RowBlock) -> Optional[RowBlock]:
        if block.n == 0:
            return block
        if self._program is None:
            self._program = program_tensors(self.prog, resolve_device(self.device))
        mask = filter_rows(block.cols, self._program)
        if mask.all():
            return block
        if not mask.any():
            return None
        return RowBlock(block.shard, block.keys[mask], block.cols[mask], block.field_ids)


class ProjectingIterator(ScanIterator):
    """Column-subset projection at scan time: unrequested columns never
    leave the tablet."""

    def __init__(self, store, fields: Sequence[str]):
        self.field_ids = np.asarray([store.schema.field_id(f) for f in fields], np.int32)
        self.fields = tuple(fields)

    def apply(self, block: RowBlock) -> RowBlock:
        if block.field_ids is not None:
            raise ValueError("block already projected")
        return RowBlock(block.shard, block.keys, block.cols[:, self.field_ids], self.field_ids)


class CombinerIterator(ScanIterator):
    """Scan-time aggregation (Accumulo's combiner at scan scope): group rows
    by (group field codes, time bucket) and aggregate server-side, with an
    optional residual filter fused into the same combine_scan launch on
    ``device``. ``prog`` is a FilterProgram, prepared at the first block,
    or a Program already prepared on ``device``."""

    def __init__(self, grouping: ResolvedGrouping, prog=None, device="cuda"):
        self.grouping = grouping
        self.prog = prog  # fused residual filter; None = match all
        self.device = device
        self._program: Optional[Program] = prog if isinstance(prog, Program) else None

    def combine_rows(self, keys: np.ndarray, cols: np.ndarray, shard: int = -1) -> AggregateBlock:
        if len(keys) == 0:
            e = np.empty(0, np.int64)
            return AggregateBlock(shard, e, e.copy(), np.empty(0, np.int32))
        _, rts, _ = keypack.unpack_event_key(keys)
        gids = self.grouping.group_ids(keypack.unrev_ts(rts), cols)
        order = np.argsort(gids, kind="stable")
        values = self.grouping.values(cols)
        if self._program is None:
            self._program = program_tensors(
                self.prog if self.prog is not None else trivial_program(),
                resolve_device(self.device))
        ukeys, aggs, cnts = combine_scan(
            gids[order], None if values is None else values[order], cols[order], self._program,
            op=self.grouping.spec.op)
        return AggregateBlock(shard, ukeys, aggs, cnts)

    def apply(self, block: RowBlock) -> AggregateBlock:
        if block.field_ids is not None:
            raise ValueError("combiner needs unprojected schema-wide columns")
        return self.combine_rows(block.keys, block.cols, shard=block.shard)


class IteratorStack:
    """An ordered server-side iterator chain applied to every scanned
    block; validates Accumulo-style composition rules at construction."""

    def __init__(self, iterators: Sequence[ScanIterator]):
        its = list(iterators)
        for i, it in enumerate(its):
            if isinstance(it, CombinerIterator) and i != len(its) - 1:
                raise ValueError("CombinerIterator must be the last iterator")
            if isinstance(it, ProjectingIterator):
                if any(isinstance(j, (FilterIterator, CombinerIterator)) for j in its[i + 1:]):
                    raise ValueError(
                        "ProjectingIterator must come after filters and cannot precede a combiner"
                    )
        self.iterators = its

    @property
    def terminal_combiner(self) -> Optional[CombinerIterator]:
        if self.iterators and isinstance(self.iterators[-1], CombinerIterator):
            return self.iterators[-1]
        return None

    def apply_block(self, block: RowBlock):
        out = block
        for it in self.iterators:
            out = it.apply(out)
            if out is None or out.n == 0:
                return None
        return out
