"""Device ingest plane — writable device-resident LSM tablets for all three
of the paper's tables (§IV-A); the port of the reference's
core/dist_ingest.py.

Without a mesh, all T tablets sit on one device as the leading dimension
of every state tensor (the reference's vmap over tablets). On a
torch.distributed DeviceMesh of R ranks every rank is a tablet server,
as every chip is in the reference's shard_map: T = R * tablets_per_device,
every rank takes the same batches and appends only the rows of its own
tablets, and its compactions run on its own state with no collective.
The plane shards a rank's tablets into G tablet groups, each a contiguous
tablet range with its own lock and state, so writers whose rows land on
different groups append concurrently. Group g owns the global tablets
[g * T/G, (g+1) * T/G); on a mesh the rank whose row-major mesh
coordinate is r holds tablets [g * T/G + r * tl, g * T/G + (r+1) * tl)
of it, tl = tablets_per_device / G (the reference's layout).
The LSM lifecycle runs as PyTorch steps over that state:

    append   DistBatchWriter shards encoded events by row hash; each
             tablet's rows land in its memtable slab, and the index and
             aggregate entries are synthesised from them on the device
    minor    per-tablet memtable sort into the next sorted-run slot
    major    K-way merge of the runs, then a 2-way merge with the base,
             both through the merge_runs rank kernel — blocking the writer
             that tripped it (the paper's backpressure); the index and
             aggregate families then compact their duplicate keys (the
             aggregate family summing their counts) through the
             combine_compact kernel
    fold     one increment of major compaction: the top run slot folds
             into the base (compact_step)
    seal     publish(): a fill-bounded sorted copy of every family's
             memtable

Each tablet owns three table families, kept in lockstep:

    ev   event table      key = rev_ts (int32), payload = field codes
    ix   index table      key = field|value|rev_ts packed int64, no payload;
                          duplicate keys collapse at major compaction
    ag   aggregate table  key = field|value|bucket packed int64, payload =
                          int64 count; duplicate keys sum at major compaction

Host-side mirrors of the memtable fills and run-slot counts are exact,
so flush triggers and append destinations need no device read. Appends
write the live memtable slabs in place (a published snapshot holds a
sealed copy of them, never the slabs); minor, major, fold and seal write
new tensors, so the base and run slabs a snapshot aliases never change.

On a mesh, every rank must make the same appends, compactions and seals
in the same order. Lockstep: every rank calls the same API. With a
control log (core/spmd.py), rank 0 drives the plane from any number of
threads and each group logs its append (the batch's per-chunk tablet
counts and, for each follower, its own tablets' rows), compaction and
seal under its lock; the followers apply the log in order.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import keypack
from .device import resolve_device
from .dist_query import DistStore, mesh_rank
from .ingest import BatchWriter, IngestMetrics, check_shard_guidance
from .spmd import Record, _own_rows
from .store import DEFAULT_AGG_BUCKET_SECONDS
from ..kernels.aggregate_combine import combine_compact
from ..kernels.common import pow2
from ..kernels.merge_runs import merge_pair_device, merge_sorted_device
from ..obs import MetricsRegistry, OwnedLock, span

REV_PAD = int(np.iinfo(np.int32).max)  # +inf rev_ts sentinel
KEY_PAD64 = int(np.iinfo(np.int64).max)  # +inf packed-key sentinel (ix/ag)

_plane_seq = itertools.count()  # names each plane's private metrics registry


@dataclass(frozen=True)
class _Family:
    """One table family's static shape parameters."""

    name: str
    key_dtype: torch.dtype
    sentinel: int
    width: int
    col_dtype: torch.dtype
    mem_rows: int
    capacity: int
    combine: str = "none"  # major-scope fold: "none" | "sum" | "dedup"


def _gather_rows(cols: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """cols (T, N, W) reordered along N by order (T, N')."""
    t, n = order.shape
    w = cols.shape[-1]
    if w == 0:
        return cols.new_empty((t, n, 0))
    return cols.gather(1, order[..., None].expand(t, n, w))


def _sort_masked(keys: torch.Tensor, cols: torch.Tensor, n: torch.Tensor, sentinel: int):
    """Mask entries past each tablet's fill n (T,) to the sentinel and sort
    (stable; the payload travels with its key). Shared by minor compaction
    and the publish seal."""
    valid = torch.arange(keys.shape[1], device=keys.device) < n[:, None]
    masked = torch.where(valid, keys, sentinel)
    skeys, order = torch.sort(masked, dim=1, stable=True)
    return skeys, _gather_rows(cols, order)


def _rank_within(tab: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """For each row, how many earlier rows of the chunk share its tablet."""
    order = np.argsort(tab, kind="stable")
    first = np.cumsum(counts) - counts
    j = np.empty(len(tab), np.int64)
    j[order] = np.arange(len(tab)) - first[tab[order]]
    return j


class _PlanePrograms:
    """The plane's static configuration and its five device steps (append,
    minor, major, fold_one, seal), each over a state dict of (T, ...)
    tensors, T = n_tablets: one group's tablets on this rank. ``mesh`` (a
    DeviceMesh over the default process group, or None) gives the rank's
    linear index ``rank`` of ``n_ranks``; the steps themselves run on the
    rank's state alone."""

    def __init__(self, n_fields: int, capacity: int, n_tablets: int, mem_rows: int,
                 max_runs: int, append_rows: int, indexed_fids: Tuple[int, ...],
                 agg_bucket_s: int, device: torch.device, mesh=None):
        if mesh is not None and mesh.device_type != device.type:
            raise ValueError(f"the mesh's device type {mesh.device_type!r} is not the "
                             f"plane's device {device}")
        self.mesh = mesh
        self.rank, self.n_ranks = (0, 1) if mesh is None else mesh_rank(mesh)
        self.n_fields = int(n_fields)
        self.n_tablets = int(n_tablets)
        self.capacity = int(capacity)
        self.mem_rows = int(mem_rows)
        self.max_runs = int(max_runs)
        self.append_rows = int(min(append_rows, mem_rows))
        self.indexed_fids = tuple(int(f) for f in indexed_fids)
        self.agg_bucket_s = int(agg_bucket_s)
        self.device = device
        n_idx = len(self.indexed_fids)
        fams = [_Family("ev", torch.int32, REV_PAD, self.n_fields, torch.int32,
                        self.mem_rows, self.capacity)]
        if n_idx:
            fams.append(_Family("ix", torch.int64, KEY_PAD64, 0, torch.int32,
                                n_idx * self.mem_rows, n_idx * self.capacity, "dedup"))
            fams.append(_Family("ag", torch.int64, KEY_PAD64, 1, torch.int64,
                                n_idx * self.mem_rows, n_idx * self.capacity, "sum"))
        self.families: Tuple[_Family, ...] = tuple(fams)
        # Indexed field ids and their entry offsets, kept on the device so
        # an append copies nothing but its chunk to the card.
        self._fids = torch.tensor(self.indexed_fids, dtype=torch.int64, device=device)
        self._fid_step = torch.arange(n_idx, dtype=torch.int64, device=device)[:, None]

    def init_state(self) -> Dict[str, torch.Tensor]:
        t, k, dev = self.n_tablets, self.max_runs, self.device

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        st = {"n_runs": z((t,), torch.int32), "rows": z((t,), torch.int64),
              "minor": z((t,), torch.int32), "major": z((t,), torch.int32)}
        for f in self.families:
            p, m, c = f.name, f.mem_rows, f.capacity
            st[f"{p}_mem_k"] = z((t, m), f.key_dtype)
            st[f"{p}_mem_c"] = z((t, m, f.width), f.col_dtype)
            st[f"{p}_mem_n"] = z((t,), torch.int32)
            st[f"{p}_run_k"] = torch.full((t, k, m), f.sentinel, dtype=f.key_dtype, device=dev)
            st[f"{p}_run_c"] = z((t, k, m, f.width), f.col_dtype)
            st[f"{p}_run_n"] = z((t, k), torch.int32)
            st[f"{p}_base_k"] = torch.full((t, c), f.sentinel, dtype=f.key_dtype, device=dev)
            st[f"{p}_base_c"] = z((t, c, f.width), f.col_dtype)
            st[f"{p}_base_n"] = z((t,), torch.int32)
            st[f"{p}_overflow"] = z((t,), torch.int32)
        return st

    def seal_bucket(self, fill_max: int) -> int:
        """Event-family slots the seal sorts to cover a memtable fill of
        fill_max: the fill rounded up to a power of two (at least 8), at
        most mem_rows."""
        return int(min(max(pow2(max(fill_max, 1)), 8), self.mem_rows))

    # ------------------------------------------------------------- steps
    def append(self, st: Dict[str, torch.Tensor], rows: torch.Tensor,
               plan: torch.Tensor) -> None:
        """Write one chunk into the memtables, in place. rows (n, 1+F)
        int32: rev_ts then the field codes; plan (4, n) int64: tablet id,
        flat event-slab slot, flat index/aggregate slot of the first
        indexed field, and the stride between indexed fields (the
        tablet's row count in this chunk). Index and aggregate keys are
        synthesised here from the event rows."""
        # The ONE sanctioned in-place write in the planes: the append writes
        # only the live memtables and the telemetry row counter, which
        # publish() never aliases — a snapshot seals a sorted COPY of the
        # memtables (seal(): sorted keys and cols, n.clone()), so no
        # published DistStore can see these writes.
        tab, ev_slot, ix_slot0, ix_stride = plan.unbind(0)
        rts, cols = rows[:, 0], rows[:, 1:]
        n = rts.shape[0]
        st["ev_mem_k"].view(-1)[ev_slot] = rts  # reprolint: disable=no-inplace-in-plane
        st["ev_mem_c"].view(-1, self.n_fields)[ev_slot] = cols  # reprolint: disable=no-inplace-in-plane
        ones = torch.ones(n, dtype=torch.int32, device=rts.device)
        st["ev_mem_n"].index_add_(0, tab, ones)  # reprolint: disable=no-inplace-in-plane
        st["rows"].index_add_(0, tab, ones.to(torch.int64))  # reprolint: disable=no-inplace-in-plane
        n_idx = len(self.indexed_fids)
        if not n_idx:
            return
        rts64 = rts.to(torch.int64)
        bucket = (keypack.TS_MAX - rts64) // self.agg_bucket_s
        fid = self._fids[:, None]
        code = cols.index_select(1, self._fids).T.to(torch.int64)  # (n_idx, n)
        ikeys = (fid << keypack.IX_FIELD_SHIFT) | (code << keypack.IX_VALUE_SHIFT) | rts64
        akeys = (fid << keypack.AG_FIELD_SHIFT) | (code << keypack.AG_VALUE_SHIFT) | bucket
        slots = (ix_slot0[None, :] + self._fid_step * ix_stride[None, :]).reshape(-1)
        st["ix_mem_k"].view(-1)[slots] = ikeys.reshape(-1)  # reprolint: disable=no-inplace-in-plane
        st["ag_mem_k"].view(-1)[slots] = akeys.reshape(-1)  # reprolint: disable=no-inplace-in-plane
        st["ag_mem_c"].view(-1)[slots] = 1  # reprolint: disable=no-inplace-in-plane
        st["ix_mem_n"].index_add_(0, tab, ones * n_idx)  # reprolint: disable=no-inplace-in-plane
        st["ag_mem_n"].index_add_(0, tab, ones * n_idx)  # reprolint: disable=no-inplace-in-plane

    def minor(self, st: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Flush every tablet's memtable that holds rows into its next free
        run slot (all families in lockstep). Returns the updated tensors."""
        k = self.max_runs
        nr = st["n_runs"]
        do = (st["ev_mem_n"] > 0) & (nr < k)
        slot = nr.clamp(0, k - 1).long()
        sel = do[:, None] & (torch.arange(k, device=nr.device)[None, :] == slot[:, None])
        out = {}
        for f in self.families:
            p = f.name
            n = st[f"{p}_mem_n"]
            skeys, scols = _sort_masked(st[f"{p}_mem_k"], st[f"{p}_mem_c"], n, f.sentinel)
            out[f"{p}_run_k"] = torch.where(sel[..., None], skeys[:, None], st[f"{p}_run_k"])
            out[f"{p}_run_c"] = torch.where(sel[..., None, None], scols[:, None], st[f"{p}_run_c"])
            out[f"{p}_run_n"] = torch.where(sel, n[:, None], st[f"{p}_run_n"])
            out[f"{p}_mem_n"] = torch.where(do, 0, n)
        out["n_runs"] = nr + do.to(nr.dtype)
        out["minor"] = st["minor"] + do.to(torch.int32)
        return out

    def _fold_into_base(self, st, f: _Family, fk, fc, rows_in, do, out) -> None:
        """Combine a merged (base + runs) sequence per the family's rule
        and write base and overflow for the tablets where ``do``."""
        p, c = f.name, f.capacity
        live = st[f"{p}_base_n"] + rows_in  # the merge's real keys lead, sentinels after
        if f.combine == "none":
            total, fk, fc = live, fk[:, :c], fc[:, :c]
        else:
            # One combine_compact launch: the unique keys (and, for "sum",
            # their count sums) compacted to the front and cut to c.
            vals = fc[..., 0] if f.combine == "sum" else None
            fk, sums, total = combine_compact(fk, vals, live, c, f.sentinel)
            fc = fc[:, :c] if sums is None else sums[..., None].to(fc.dtype)
        kept = total.clamp(max=c)
        out[f"{p}_base_k"] = torch.where(do[:, None], fk, st[f"{p}_base_k"])
        out[f"{p}_base_c"] = torch.where(do[:, None, None], fc, st[f"{p}_base_c"])
        out[f"{p}_base_n"] = torch.where(do, kept, st[f"{p}_base_n"])
        out[f"{p}_overflow"] = st[f"{p}_overflow"] + torch.where(do, total - kept, 0)

    def major(self, st: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Fold every run into the base: a K-way merge of the runs, then a
        2-way merge with the base, both through the merge_runs kernel."""
        nr = st["n_runs"]
        do = nr > 0
        out = {}
        for f in self.families:
            p, m = f.name, f.mem_rows
            rn = st[f"{p}_run_n"]
            within = torch.arange(m, device=rn.device)[None, None, :] < rn[..., None]
            ck = torch.where(within, st[f"{p}_run_k"], f.sentinel)
            cc = torch.where(within[..., None], st[f"{p}_run_c"], 0)
            mk, mc = merge_sorted_device(ck, cc, rn)
            rows_in = rn.sum(dim=1, dtype=torch.int32)
            fk, fc = merge_pair_device(st[f"{p}_base_k"], st[f"{p}_base_c"], st[f"{p}_base_n"],
                                       mk, mc, rows_in)
            self._fold_into_base(st, f, fk, fc, rows_in, do, out)
            out[f"{p}_run_n"] = torch.where(do[:, None], 0, rn)
        out["n_runs"] = torch.where(do, 0, nr)
        out["major"] = st["major"] + do.to(torch.int32)
        return out

    def fold_one(self, st: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One increment of major compaction: every tablet folds its top run
        slot (n_runs - 1) into its base by one 2-way merge per family, so
        the remaining slots stay a contiguous prefix."""
        nr = st["n_runs"]
        do = nr > 0
        slot = (nr - 1).clamp(min=0).long()
        tix = torch.arange(nr.shape[0], device=nr.device)
        out = {}
        for f in self.families:
            p, m = f.name, f.mem_rows
            rn = st[f"{p}_run_n"]
            rn_slot = rn[tix, slot]
            within = torch.arange(m, device=rn.device)[None, :] < rn_slot[:, None]
            ck = torch.where(within, st[f"{p}_run_k"][tix, slot], f.sentinel)
            cc = torch.where(within[..., None], st[f"{p}_run_c"][tix, slot], 0)
            fk, fc = merge_pair_device(st[f"{p}_base_k"], st[f"{p}_base_c"], st[f"{p}_base_n"],
                                       ck, cc, rn_slot)
            self._fold_into_base(st, f, fk, fc, rn_slot, do, out)
            new_rn = rn.clone()
            new_rn[tix, slot] = torch.where(do, 0, rn_slot)
            out[f"{p}_run_n"] = new_rn
        out["n_runs"] = nr - do.to(nr.dtype)
        # The increment that folds a tablet's last run completes one major.
        out["major"] = st["major"] + (do & (nr == 1)).to(torch.int32)
        return out

    def seal(self, st: Dict[str, torch.Tensor], seal_rows: int
             ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Sorted copy of every family's memtable live head, the level the
        reads search: only the head is sorted — seal_rows slots of the
        event memtable, n_indexed times that for the ix and ag memtables,
        which take one entry per indexed field per event — and the output
        keeps the full (T, mem_rows) shape with a sentinel tail. Returns
        {family: (keys, cols, live counts)}."""
        out = {}
        for f in self.families:
            p, m = f.name, f.mem_rows
            h = min(seal_rows * (m // self.mem_rows), m)
            n = st[f"{p}_mem_n"]
            hk, hc = _sort_masked(st[f"{p}_mem_k"][:, :h], st[f"{p}_mem_c"][:, :h], n, f.sentinel)
            t = hk.shape[0]
            keys = torch.cat([hk, hk.new_full((t, m - h), f.sentinel)], dim=1)
            cols = torch.cat([hc, hc.new_zeros((t, m - h, f.width))], dim=1)
            out[p] = (keys, cols, n.clone())
        return out


class TabletGroup:
    """One shard of the plane: a contiguous range of ``programs.n_tablets``
    global tablets with its own lock, device state, exact host mirrors
    (memtable fill, run-slot count, and the per-tablet rows, minor and
    major counters), generation tags, fold debt and published snapshot.
    Everything here is guarded by ``self.lock``, so writers on different
    groups never contend.

    The group owns the global tablets [g0, g0 + n_group_tablets). The
    device state holds this rank's ``n_tablets`` of them, global tablet
    ``t`` in [t0, t0 + n_tablets) as local tablet ``t - t0``; without a
    mesh that is the whole group. The host mirrors cover the whole group
    on every rank: each rank takes the same batches, so each decides every
    flush, major and fold as the reference's single controller decides it
    for the whole mesh, with no collective, and runs it on its own
    tablets. Counters
    land on the plane's shared registry, so the per-writer blocked seconds
    sum to the plane's scalar however one writer's waits split across
    groups."""

    def __init__(self, gid: int, n_groups: int, programs: _PlanePrograms, m_seal, m_blocked,
                 m_folds, m_last_seal_rows, m_group_stall, m_group_stall_events, control=None):
        self.gid = int(gid)
        self.programs = programs
        self.control = control
        self.n_tablets = programs.n_tablets  # this rank's tablets of the group
        self.n_group_tablets = programs.n_ranks * self.n_tablets
        self.g0 = self.gid * self.n_group_tablets  # global id of the group's first tablet
        self.lo = programs.rank * self.n_tablets  # this rank's first, within the group
        self.t0 = self.g0 + self.lo  # global id of local tablet 0
        self._m_seal = m_seal
        self._m_blocked = m_blocked
        self._m_folds = m_folds
        self._m_last_seal_rows = m_last_seal_rows
        self._m_group_stall = m_group_stall
        self._m_group_stall_events = m_group_stall_events
        # A single-group plane keeps the reference's lock name; a sharded
        # plane names each group's lock, so the occupancy books attribute
        # contention to the group that serialized it.
        self.lock = OwnedLock("plane_lock" if n_groups == 1 else f"plane_lock_g{self.gid}")
        # Host mirrors of every tablet of the group (all ranks'), in
        # group-local order.
        n = self.n_group_tablets
        self._fill = np.zeros(n, np.int64)  # guarded-by: lock
        self._runs_host = np.zeros(n, np.int32)  # guarded-by: lock
        self._rows_host = np.zeros(n, np.int64)  # guarded-by: lock
        self._minor_host = np.zeros(n, np.int32)  # guarded-by: lock
        self._major_host = np.zeros(n, np.int32)  # guarded-by: lock
        self._dirty = True  # guarded-by: lock
        self._published: Optional[DistStore] = None  # guarded-by: lock
        # Generation per LSM level: appends bump "mem"; a minor bumps "mem"
        # and "runs"; a fold into the base bumps "runs" and "base". The
        # sealed memtable is reused while "mem" is unchanged.
        self._gen: Dict[str, int] = {"mem": 0, "runs": 0, "base": 0}  # guarded-by: lock
        # ("mem" generation, {family: sealed (keys, cols, counts)}, seal_rows)
        self._sealed_cache: Optional[Tuple[int, Dict[str, tuple], int]] = None  # guarded-by: lock
        self.state: Dict[str, torch.Tensor] = programs.init_state()  # guarded-by: lock

    def load_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Replace the device state (same keys and shapes) and derive the
        host mirrors from it (meshless only: the mirrors cover other ranks'
        tablets)."""
        with self.lock.hold("bookkeeping"):
            if self.programs.mesh is not None:
                raise RuntimeError("load_state needs a meshless plane")
            if state.keys() != self.state.keys():
                raise ValueError("state keys differ from the plane's")
            for name, t in state.items():
                ref = self.state[name]
                if t.shape != ref.shape or t.dtype != ref.dtype or t.device != ref.device:
                    raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} {t.device} does "
                                     f"not match {tuple(ref.shape)} {ref.dtype} {ref.device}")
            self.state = dict(state)
            self._fill = state["ev_mem_n"].cpu().numpy().astype(np.int64)
            self._runs_host = state["n_runs"].cpu().numpy().astype(np.int32)
            self._rows_host = state["rows"].cpu().numpy().astype(np.int64)
            self._minor_host = state["minor"].cpu().numpy().astype(np.int32)
            self._major_host = state["major"].cpu().numpy().astype(np.int32)
            self._gen = {k: v + 1 for k, v in self._gen.items()}
            self._sealed_cache = None
            self._dirty = True

    def _log(self, kind: str, *body) -> None:  # holds: lock
        """On rank 0 of a control log, log this group's operation, under the
        lock that ordered it here."""
        if self.control is not None and self.control.leads:
            self.control.put(Record(kind, body))

    # --------------------------------------------------------- compaction
    def _run_minor(self) -> None:  # holds: lock
        pr = self.programs
        self.state.update(pr.minor(self.state))
        # Mirror the device guard: a tablet flushes iff it holds rows and
        # has a free run slot.
        flushed = (self._fill > 0) & (self._runs_host < pr.max_runs)
        self._runs_host += flushed
        self._minor_host += flushed
        self._fill = np.where(flushed, 0, self._fill)
        if flushed.any():
            self._gen["mem"] += 1
            self._gen["runs"] += 1

    def _run_major(self) -> None:  # holds: lock
        self.state.update(self.programs.major(self.state))
        self._major_host += self._runs_host > 0
        if self._runs_host.max() > 0:
            self._gen["runs"] += 1
            self._gen["base"] += 1
        # A host numpy mirror, never part of a snapshot.
        self._runs_host[:] = 0  # reprolint: disable=no-inplace-in-plane

    def _run_fold_one(self) -> None:  # holds: lock
        self.state.update(self.programs.fold_one(self.state))
        # The increment that folds a tablet's last run completes a major.
        self._major_host += self._runs_host == 1
        if self._runs_host.max() > 0:
            self._gen["runs"] += 1
            self._gen["base"] += 1
        self._runs_host = np.maximum(self._runs_host - 1, 0).astype(np.int32)

    def _fence(self) -> None:  # holds: lock
        """Wait until the card has run the work this group queued: an event
        recorded after it on the current stream. Groups share the device's
        one stream, so work other groups queued earlier completes too, but
        nothing queued later is waited for."""
        dev = self.programs.device
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
            done.synchronize()

    # ------------------------------------------------------------- ingest
    def ingest(self, rts: np.ndarray, cols: np.ndarray, tab: np.ndarray,
               writer_id: int = 0) -> float:
        """Append a pre-encoded batch whose tablet ids are local to this
        group (in [0, n_group_tablets)); on a mesh only the rows of this
        rank's tablets reach the device, and the mirrors take them all.
        Returns seconds this writer spent blocked on majors it tripped
        here; they also go to the plane's per-writer counter and, keyed by
        group, to its stall counters. On rank 0 of a control log the batch
        is logged under the lock once it applied here."""
        n = len(rts)
        if n == 0:
            return 0.0
        with span("ingest.route", cat="ingest", rows=n, writer=writer_id, group=self.gid):
            tab = np.asarray(tab).astype(np.int64)
            ar = self.programs.append_rows
            # The per-chunk tablet counts the mirrors and flushes follow,
            # here and, through the log, on every follower.
            chunk = np.arange(n, dtype=np.int64) // ar
            counts = np.bincount(chunk * self.n_group_tablets + tab,
                                 minlength=-(-n // ar) * self.n_group_tablets
                                 ).reshape(-1, self.n_group_tablets)
            own = _own_rows(rts, cols, tab, self.lo, self.n_tablets, ar,
                            whole=self.n_tablets == self.n_group_tablets)
        with self.lock.hold("ingest_append"):
            blocked = self._append_booked(counts, *own, writer_id)
            self._log("append", self.gid, rts, cols, tab, counts, writer_id, self.n_tablets, ar)
            return blocked

    def apply_append(self, counts: np.ndarray, packed: np.ndarray, tab: np.ndarray,
                     starts: np.ndarray, writer_id: int = 0) -> float:
        """A follower's side of rank 0's ingest(): the batch's per-chunk
        tablet counts (for the mirrors of every tablet) and the rows of
        this rank's tablets (ids local to them), packed, with each chunk's
        start among them."""
        with self.lock.hold("ingest_append"):
            return self._append_booked(counts, packed, tab, starts, writer_id)

    def _append_booked(self, counts, packed, tab, starts, writer_id) -> float:  # holds: lock
        with span("ingest.append", cat="ingest", rows=int(counts.sum()), writer=writer_id,
                  group=self.gid) as sp:
            blocked = self._append_rows(counts, packed, tab, starts, sp)
            sp.set(blocked_s=blocked)
        self._m_blocked.inc(blocked, writer=writer_id)
        if blocked > 0.0:
            self._m_group_stall.inc(blocked, group=self.gid)
            self._m_group_stall_events.inc(group=self.gid)
        return blocked

    def _append_rows(self, counts, packed, tab, starts, sp) -> float:  # holds: lock
        """Append chunk by chunk: counts (n_chunks, n_group_tablets) the
        batch's rows per chunk and tablet; packed (m, 1 + F) int32 the rows
        of this rank's tablets (rev_ts, then the codes), tab their tablet
        ids among this rank's, chunk i at [starts[i], starts[i + 1]).
        Sets on ``sp`` the batch's seconds in two phases, summed over its
        chunks: ``plan_s`` (room checks, destinations, the host mirrors)
        and ``enqueue_s`` (copies to the card and the append's launches);
        minors and majors have spans of their own and count in neither."""
        pr = self.programs
        t, lo, m = self.n_tablets, self.lo, pr.mem_rows
        n_idx = len(pr.indexed_fids)
        clock = time.perf_counter
        c0 = clock()
        rows_dev = torch.from_numpy(packed).to(pr.device)  # one host-to-device copy
        c1 = clock()
        plan_s, enqueue_s = 0.0, c1 - c0
        blocked = 0.0
        for i, cb_g in enumerate(counts):
            # Exact room check from the host fill mirror: flush only when
            # some tablet's memtable would overflow.
            if np.any(self._fill + cb_g > m):
                plan_s += clock() - c1
                if np.any((self._fill > 0) & (self._runs_host >= pr.max_runs)):
                    # No free run slot for a tablet that must flush: a major
                    # first, blocking this writer (backpressure) until the
                    # card has run it.
                    t0 = time.perf_counter()
                    with self.lock.reowner("fold_increment"):
                        with span("ingest.major", cat="ingest", group=self.gid):
                            self._run_major()
                            self._fence()
                    blocked += time.perf_counter() - t0
                    self._m_folds.inc(source="ingest")
                with span("ingest.minor", cat="ingest", group=self.gid):
                    self._run_minor()
                c1 = clock()
            if np.any(self._fill + cb_g > m):  # the flush above always makes room
                raise RuntimeError("memtable has no room after a flush")
            # Destinations from the exact host fill mirror: a tablet's rows
            # land after its fill, in chunk order; entry i of a row's
            # indexed fields lands i * (tablet's chunk rows) further on.
            a, b = int(starts[i]), int(starts[i + 1])
            if b > a:
                tab_c = tab[a:b]
                cb = cb_g[lo: lo + t]
                j = _rank_within(tab_c, cb)
                fill = self._fill[lo: lo + t][tab_c]
                plan = np.stack([tab_c, tab_c * m + fill + j,
                                 tab_c * (n_idx * m) + n_idx * fill + j, cb[tab_c]])
                c0 = clock()
                pr.append(self.state, rows_dev[a:b], torch.from_numpy(plan).to(pr.device))
                c2 = clock()
                plan_s += c0 - c1
                enqueue_s += c2 - c0
                c1 = c2
            self._fill += cb_g
            self._rows_host += cb_g
        plan_s += clock() - c1
        sp.set(plan_s=plan_s, enqueue_s=enqueue_s, chunks=len(counts))
        self._dirty = True
        self._gen["mem"] += 1
        return blocked

    # -------------------------------------------------------------- reads
    def snapshot(self, pub: Optional[int] = None) -> DistStore:
        """A query-visible DistStore of every level of this group's three
        families: the base and run slabs by reference, and a sealed (sorted)
        copy of the memtables — O(live fill) device work, no fold, under
        this group's lock only. Reused as is when nothing changed since the
        last snapshot; the sealed memtables are reused while the "mem"
        generation is unchanged. On a mesh every rank's mirrors move alike,
        so the ranks reuse their snapshots (and their density memos) at the
        same publishes. On rank 0 of a control log the seal is logged, with
        the id ``pub`` of the publish it belongs to."""
        with self.lock.hold("publish_seal"):
            out = self._snapshot_locked()
            self._log("snap", self.gid, pub)
            return out

    def _snapshot_locked(self) -> DistStore:  # holds: lock
        pr = self.programs
        if not self._dirty and self._published is not None:
            return self._published
        gen_mem = self._gen["mem"]
        if self._sealed_cache is not None and self._sealed_cache[0] == gen_mem:
            _, sealed, seal_rows = self._sealed_cache
            self._m_seal.inc(event="reuse")
        else:
            seal_rows = pr.seal_bucket(int(self._fill.max()))
            with span("ingest.seal", cat="ingest", seal_rows=seal_rows, group=self.gid):
                sealed = pr.seal(self.state, seal_rows)
            self._sealed_cache = (gen_mem, sealed, seal_rows)
            self._m_seal.inc(event="seal")
        self._m_last_seal_rows.set(seal_rows)
        s = self.state
        ev_k, ev_c, ev_n = sealed["ev"]
        levels = dict(
            rev_ts=s["ev_base_k"], cols=s["ev_base_c"], counts=s["ev_base_n"],
            run_rev_ts=s["ev_run_k"], run_cols=s["ev_run_c"], run_counts=s["ev_run_n"],
            mem_rev_ts=ev_k, mem_cols=ev_c, mem_counts=ev_n,
        )
        if "ix" in sealed:
            ix_k, _, ix_n = sealed["ix"]
            ag_k, ag_c, ag_n = sealed["ag"]
            levels.update(
                ix_keys=s["ix_base_k"], ix_counts=s["ix_base_n"],
                ix_run_k=s["ix_run_k"], ix_run_n=s["ix_run_n"],
                ix_mem_k=ix_k, ix_mem_n=ix_n,
                ag_keys=s["ag_base_k"], ag_vals=s["ag_base_c"], ag_counts=s["ag_base_n"],
                ag_run_k=s["ag_run_k"], ag_run_c=s["ag_run_c"], ag_run_n=s["ag_run_n"],
                ag_mem_k=ag_k, ag_mem_c=ag_c, ag_mem_n=ag_n,
                agg_bucket_s=pr.agg_bucket_s,
            )
        if pr.mesh is not None:
            levels.update(mesh=pr.mesh, tablets=(self.t0, self.t0 + self.n_tablets))
        self._published = DistStore(**levels, gens=dict(self._gen))
        self._dirty = False
        return self._published

    # ------------------------------------------------------------- warmup
    def warm_seal(self) -> None:
        """Run the seal once per bucket, 8 slots up to mem_rows, on the
        current state (results dropped), so the allocator holds every
        bucket's buffers before a query needs them."""
        with self.lock.hold("warmup"):
            pr = self.programs
            seal_rows = 8
            while True:
                pr.seal(self.state, seal_rows)
                if seal_rows >= pr.mem_rows:
                    break
                seal_rows = min(seal_rows * 2, pr.mem_rows)
            self._log("warm_seal", self.gid)

    def warm_compaction(self) -> None:
        """Run minor, one fold increment and a major once on the current
        state. On a drained group each leaves the state as it was; staged
        rows are drained and booked as an explicit fold, as compact()
        would."""
        with self.lock.hold("warmup"):
            staged = bool(self._fill.max() or self._runs_host.max())
            self._run_minor()
            self._run_fold_one()
            self._run_major()
            if staged:
                self._dirty = True
                self._m_folds.inc(source="explicit")
            self._log("warm_compaction", self.gid)

    # -------------------------------------------------------- bookkeeping
    def has_unfolded(self) -> bool:
        """True when memtables or run slots hold rows (host mirrors)."""
        with self.lock.hold("bookkeeping"):
            return bool(self._fill.max() or self._runs_host.max())

    def fold_debt(self) -> int:
        """Deepest run-slot use across this group's tablets (host mirror):
        how close its ingest is to tripping a blocking major."""
        with self.lock.hold("bookkeeping"):
            return int(self._runs_host.max())

    def counter_mirrors(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Copies of the per-tablet (rows, minor, major) host mirrors of the
        group's tablets, from g0 on."""
        with self.lock.hold("bookkeeping"):
            return self._rows_host.copy(), self._minor_host.copy(), self._major_host.copy()

    def gen_snapshot(self) -> Dict[str, int]:
        with self.lock.hold("bookkeeping"):
            return dict(self._gen)

    # --------------------------------------------------------------- fold
    def compact(self, source: str = "explicit") -> int:
        """Drain memtables into runs and runs into the base. Returns the
        minor+major passes run (0 when there was nothing to fold)."""
        with self.lock.hold("fold_increment"):
            if self._fill.max() == 0 and self._runs_host.max() == 0:
                return 0
            passes = 0
            with span("ingest.compact", cat="ingest", source=source, group=self.gid):
                while True:
                    self._run_minor()
                    self._run_major()
                    passes += 1
                    if self._fill.max() == 0:
                        break
            self._m_folds.inc(passes, source=source)
            self._dirty = True
            self._log("compact", self.gid, source, passes)
            return passes

    def compact_step(self, source: str = "explicit") -> int:
        """One bounded increment: fold the top run slot of every tablet
        into its base, or else flush the memtables into a run. Returns 1
        when an increment ran, else 0."""
        with self.lock.hold("fold_increment"):
            if self._runs_host.max() > 0:
                with span("ingest.fold_increment", cat="ingest", source=source, kind="fold",
                          group=self.gid):
                    self._run_fold_one()
            elif self._fill.max() > 0:
                with span("ingest.fold_increment", cat="ingest", source=source, kind="minor",
                          group=self.gid):
                    self._run_minor()
            else:
                return 0
            self._m_folds.inc(source=source)
            self._dirty = True
            self._log("compact_step", self.gid, source)
            return 1

    def telemetry_arrays(self) -> Dict[str, np.ndarray]:
        """Per-tablet device counters, copied to the host."""
        with self.lock.hold("bookkeeping"):
            names = {"rows": "rows", "minor": "minor", "major": "major",
                     "n_runs": "n_runs", "overflow": "ev_overflow",
                     "mem_n": "ev_mem_n", "base_n": "ev_base_n"}
            for f in self.programs.families[1:]:
                names[f"{f.name}_overflow"] = f"{f.name}_overflow"
                names[f"{f.name}_base_n"] = f"{f.name}_base_n"
            return {k: self.state[v].cpu().numpy() for k, v in names.items()}


class DistIngestPlane:
    """Device-resident LSM tablet grid: n_tablets tablets, each with a
    memtable slab (mem_rows), max_runs sorted-run slots and a base run
    (capacity rows), per family — sharded into ``n_groups`` independently
    locked :class:`TabletGroup`s, group g owning the contiguous global
    range [g * T/G, (g+1) * T/G).

    Without a mesh every tablet is on ``device``. With ``mesh`` (a
    DeviceMesh over the default process group, its device type the
    plane's) every rank holds tablets_per_device of them, n_tablets = R *
    tablets_per_device (give either; the default is one a rank), and
    n_groups must divide tablets_per_device. Every rank then calls
    ingest() with the same batches and publish() at the same points
    (lockstep) — or, with ``control`` (a core/spmd.py Controller), rank 0
    alone drives the plane from any number of threads and logs each
    append, compaction, seal and publish under the lock that ordered it,
    and the other ranks apply the log (Controller.follow) and may not
    drive their planes themselves.

    The plane is a facade: it routes batches to groups by tablet id,
    composes the groups' snapshots at publish(), picks the most-indebted
    group for compact_step() and concatenates telemetry. With n_groups=1
    it is the single-lock plane ("plane_lock"), and publish() returns the
    group's snapshot itself.

    ``device`` defaults to "cuda" and raises when CUDA is missing; the
    CPU tests pass device="cpu", which runs the kernels' plain versions."""

    def __init__(self, n_fields: int, capacity: int, n_tablets: Optional[int] = None,
                 mem_rows: int = 4096, max_runs: int = 4, append_rows: int = 1024,
                 indexed_fids: Sequence[int] = (),
                 agg_bucket_s: int = DEFAULT_AGG_BUCKET_SECONDS, n_groups: int = 1,
                 device="cuda", mesh=None, tablets_per_device: Optional[int] = None,
                 control=None):
        if n_groups < 1:
            raise ValueError(f"n_groups must be >= 1, got {n_groups}")
        self.device = resolve_device(device)
        n_ranks = 1 if mesh is None else mesh.size()
        if tablets_per_device is None:
            n_tablets = n_ranks if n_tablets is None else int(n_tablets)
            if n_tablets % n_ranks:
                raise ValueError(f"n_tablets={n_tablets} does not divide over the mesh's "
                                 f"{n_ranks} ranks")
            tablets_per_device = n_tablets // n_ranks
        elif n_tablets is not None and n_tablets != n_ranks * tablets_per_device:
            raise ValueError(f"n_tablets={n_tablets} is not {n_ranks} ranks x "
                             f"tablets_per_device={tablets_per_device}")
        if tablets_per_device % n_groups:
            what = "n_tablets" if mesh is None else "tablets_per_device"
            raise ValueError(f"n_groups={n_groups} must divide {what}={tablets_per_device}: "
                             "each group owns an equal, contiguous tablet range")
        if control is not None and mesh is None:
            raise ValueError("a control log drives a mesh plane; a meshless plane needs none")
        self.mesh = mesh
        self.control = control
        self.tablets_per_device = int(tablets_per_device)
        self.n_tablets = n_ranks * self.tablets_per_device
        self.n_groups = int(n_groups)
        self.tablets_per_group = self.n_tablets // self.n_groups
        self.metrics = MetricsRegistry(f"plane{next(_plane_seq)}")
        m = self.metrics
        self._m_seal = m.counter(
            "plane_seal_total", "publishes that ran (event=seal) vs reused (event=reuse)")
        self._m_blocked = m.counter(
            "plane_blocked_seconds_total", "writer seconds blocked on tripped majors")
        self._m_group_stall = m.counter(
            "plane_group_stall_seconds_total",
            "writer seconds blocked on tripped majors, by tablet group")
        self._m_group_stall_events = m.counter(
            "plane_group_stall_events_total",
            "ingest appends that tripped a blocking major, by tablet group")
        self._m_folds = m.counter(
            "plane_fold_events_total", "run->base folds by driving source")
        self._m_last_seal_rows = m.gauge(
            "plane_last_seal_rows", "event-family slots the last publish sorted")
        # Per-tablet counters from the groups' exact host mirrors, set at
        # publish() and telemetry() (labels: global tablet id).
        self._m_tab_rows = m.gauge("plane_tablet_rows", "rows appended per tablet (host mirror)")
        self._m_tab_minor = m.gauge(
            "plane_tablet_minor", "minor compactions per tablet (host mirror)")
        self._m_tab_major = m.gauge(
            "plane_tablet_major", "major compactions per tablet (host mirror)")
        self.programs = _PlanePrograms(
            n_fields, capacity, self.tablets_per_device // self.n_groups, mem_rows, max_runs,
            append_rows, tuple(indexed_fids), agg_bucket_s, self.device, mesh,
        )
        self.families = self.programs.families
        self.groups: Tuple[TabletGroup, ...] = tuple(
            TabletGroup(g, self.n_groups, self.programs, self._m_seal, self._m_blocked,
                        self._m_folds, self._m_last_seal_rows, self._m_group_stall,
                        self._m_group_stall_events, control)
            for g in range(self.n_groups)
        )
        # Session stats and the composite snapshot sit under a meta lock,
        # never held across device work nor taken inside a group lock.
        self._meta_lock = OwnedLock("plane_meta_lock")
        self.session_stats: Dict[int, Dict[str, float]] = {}  # guarded-by: _meta_lock
        self._composite: Optional[DistStore] = None  # guarded-by: _meta_lock
        # Level generations each group had when its gauges were last set;
        # a lock of its own, since a refresh waits on group locks.
        self._gauge_lock = threading.Lock()
        self._gauge_gens: List[Optional[Dict[str, int]]] = [None] * self.n_groups  # guarded-by: _gauge_lock

    @classmethod
    def for_store(cls, store, capacity: int, **kw) -> "DistIngestPlane":
        """Plane bound to a host store's schema: index postings and
        aggregate counts for its indexed fields, at its bucketing."""
        kw.setdefault("indexed_fids", tuple(int(f) for f in store._indexed_field_ids))
        kw.setdefault("agg_bucket_s", store.agg_bucket_seconds)
        return cls(store.schema.n_fields, capacity, **kw)

    # ------------------------------------------------------ metric views
    @property
    def seal_events(self) -> int:
        return int(self._m_seal.value(event="seal"))

    @property
    def seal_reuses(self) -> int:
        return int(self._m_seal.value(event="reuse"))

    @property
    def blocked_seconds(self) -> float:
        return self._m_blocked.total()

    @blocked_seconds.setter
    def blocked_seconds(self, v: float) -> None:
        """Only a reset to 0 is allowed: any other value would leave the
        per-writer cells out of step with the scalar."""
        if v != 0:
            raise ValueError("blocked_seconds can only be reset to 0")
        self._m_blocked.reset()

    @property
    def blocked_by_writer(self) -> Dict[int, float]:
        return {int(dict(key)["writer"]): v for key, v in self._m_blocked.cells().items()}

    @property
    def fold_events(self) -> Dict[str, int]:
        return {dict(key)["source"]: int(v) for key, v in self._m_folds.cells().items()}

    @property
    def last_seal_rows(self) -> int:
        return int(self._m_last_seal_rows.value())

    # ----------------------------------------------- single-group views
    def _single(self, what: str) -> TabletGroup:
        if self.n_groups != 1:
            raise RuntimeError(f"plane.{what} is ambiguous with n_groups > 1; "
                               f"use plane.groups[g]")
        return self.groups[0]

    @property
    def group(self) -> TabletGroup:
        """The one group of a single-group plane."""
        return self._single("group")

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        """The device state dict of a single-group plane."""
        return self._single("state").state

    def load_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Start a single-group plane from a given LSM state (see
        core/carry.py)."""
        self._single("load_state").load_state(state)

    def state_bytes(self) -> int:
        """Device bytes held by the plane's state, all groups."""
        return sum(t.numel() * t.element_size() for g in self.groups for t in g.state.values())

    def _drive(self, what: str) -> None:
        """Refuse to drive a follower's plane outside Controller.follow."""
        ctl = self.control
        if ctl is not None and not ctl.leads and not ctl.applying:
            raise RuntimeError(f"{what}: rank {ctl.rank} follows rank 0's control log; "
                               "only rank 0 drives the plane")

    # ----------------------------------------------------------- ingest
    def ingest(self, rts: np.ndarray, cols: np.ndarray, tab: np.ndarray,
               writer_id: int = 0) -> float:
        """Append a pre-encoded, pre-sharded batch: rts int32 reversed
        timestamps, cols (n, F) int32 codes, tab (n,) global tablet ids.
        Each row goes to the group owning its tablet, under that group's
        lock only; on a mesh, the device takes only the rows of this rank's
        tablets. Returns
        seconds this writer spent blocked on majors it tripped, summed over
        the groups the batch touched."""
        self._drive("ingest")
        rts = np.asarray(rts, np.int32)
        cols = np.asarray(cols, np.int32)
        tab = np.asarray(tab, np.int64)
        if len(tab) and (tab.min() < 0 or tab.max() >= self.n_tablets):
            raise ValueError(f"tablet ids must lie in [0, {self.n_tablets})")
        if self.n_groups == 1 and self.mesh is None:
            return self.groups[0].ingest(rts, cols, tab, writer_id=writer_id)
        blocked = 0.0
        for g in self.groups:
            m = (tab >= g.g0) & (tab < g.g0 + g.n_group_tablets)
            if m.any():
                blocked += g.ingest(rts[m], cols[m], tab[m] - g.g0, writer_id=writer_id)
        return blocked

    # ------------------------------------------------------------ reads
    def publish(self) -> DistStore:
        """Snapshot the plane into a query-visible DistStore (all levels,
        no fold), each group under its own lock only. A single-group plane
        returns its group's snapshot; a sharded plane returns a composite
        whose ``groups`` hold the groups' snapshots in tablet order — a
        group clean since its last snapshot gives the same object again,
        and when every group does, so does the composite. On a mesh the
        snapshot holds this rank's tablets and carries the mesh. On rank 0
        of a control log each group's seal and the composition are logged,
        so every follower composes the same snapshot objects."""
        return self._publish(False)[0]

    def publish_pinned(self) -> Tuple[DistStore, int, Dict[str, int]]:
        """publish() on rank 0 of a control log, for a query that every
        rank runs on it: (the snapshot, its publish id, the dictionary
        lengths at its publish record). Each follower keeps the snapshot
        for the one query record that names the id."""
        if self.control is None or not self.control.leads:
            raise RuntimeError("publish_pinned needs rank 0 of a control log")
        return self._publish(True)

    def _publish(self, pin: bool):
        self._drive("publish")
        ctl = self.control if self.control is not None and self.control.leads else None
        pub = ctl.next_id() if ctl is not None else None
        with span("ingest.publish", cat="ingest"):
            subs = tuple(g.snapshot(pub) for g in self.groups)
            self._update_tablet_gauges([sub.gens for sub in subs])
            return self._compose(subs, pub, pin)

    def _compose(self, subs: Tuple[DistStore, ...], pub: Optional[int] = None,
                 pin: bool = False):
        """The plane's snapshot of its groups' snapshots ``subs``: the one
        group's on a single-group plane, else a composite, reused when
        every group's snapshot is. On rank 0 of a control log the
        composition is logged under the meta lock (whose order decides the
        reuse); returns (snapshot, pub, the dictionary lengths logged)."""
        with self._meta_lock.hold("publish_compose"):
            if self.n_groups == 1:
                out = subs[0]
            else:
                cached = self._composite
                if cached is None or not all(a is b for a, b in zip(cached.groups, subs)):
                    self._composite = DistStore(
                        groups=subs, gens={f"g{g.gid}": dict(sub.gens)
                                           for g, sub in zip(self.groups, subs)},
                        mesh=self.mesh)
                out = self._composite
            lens = None
            if pub is not None:
                lens = self.control.put(Record("publish", (pub, pin)))
            return out, pub, lens

    def warm_seal(self) -> None:
        """Run every seal bucket once on every group (TabletGroup.warm_seal)."""
        self._drive("warm_seal")
        for g in self.groups:
            g.warm_seal()

    def warm_compaction(self) -> None:
        """Run every compaction step once on every group
        (TabletGroup.warm_compaction)."""
        self._drive("warm_compaction")
        for g in self.groups:
            g.warm_compaction()

    def has_unfolded(self) -> bool:
        """True when any group's memtables or run slots hold rows."""
        return any(g.has_unfolded() for g in self.groups)

    def fold_debt(self) -> int:
        """Deepest run-slot use across every tablet (host mirrors)."""
        return max(g.fold_debt() for g in self.groups)

    def compact(self, source: str = "explicit") -> int:
        """Fold memtables and runs into the base in every group. Returns the
        passes run, summed over groups."""
        self._drive("compact")
        return sum(g.compact(source) for g in self.groups)

    def compact_step(self, source: str = "explicit") -> int:
        """One bounded increment of compaction on the most-indebted group,
        ranked by (fold debt, staged rows), ties to the lower group id,
        under that group's lock only. A group that drained since the
        ranking returns 0 and the next one is tried. Returns 1 when an
        increment ran, else 0. On a control log the choice is rank 0's,
        and the followers apply the increment on the same group."""
        self._drive("compact_step")
        ranked = sorted(self.groups, key=lambda g: (g.fold_debt(), g.has_unfolded()),
                        reverse=True)
        for g in ranked:
            if g.compact_step(source):
                return 1
        return 0

    def record_session(self, session_id: int, stats: Dict[str, float]) -> None:
        """Keep a serving session's stats for telemetry()["sessions"]: the
        1,024 most recently reported sessions, in report order."""
        with self._meta_lock.hold("bookkeeping"):
            self.session_stats.pop(int(session_id), None)
            self.session_stats[int(session_id)] = dict(stats)
            while len(self.session_stats) > 1024:
                self.session_stats.pop(next(iter(self.session_stats)))

    def _update_tablet_gauges(self, gens: Sequence[Dict[str, int]]) -> None:
        """Set the per-tablet gauges from the host mirrors of every group
        whose level generations (``gens[g]``, read before this call) moved
        since its last refresh. Each change to the rows, minor or major
        mirrors bumps a generation, so a publish that finds every group
        clean takes no group lock and sets nothing."""
        with self._gauge_lock:
            for g in self.groups:
                if gens[g.gid] == self._gauge_gens[g.gid]:
                    continue
                # Read after the generations: the gauges are at least as new.
                rows, minor, major = g.counter_mirrors()
                for i in range(len(rows)):
                    t = g.g0 + i
                    self._m_tab_rows.set(float(rows[i]), tablet=t)
                    self._m_tab_minor.set(float(minor[i]), tablet=t)
                    self._m_tab_major.set(float(major[i]), tablet=t)
                self._gauge_gens[g.gid] = gens[g.gid]

    def telemetry(self) -> Dict[str, object]:
        """Per-tablet device counters in global tablet order (on a mesh,
        this rank's tablets, group by group), plus the
        plane's metric views: blocked seconds (in all and per writer), the
        sessions' stats, fold events, the level generations (per group,
        keyed "g<i>", on a sharded plane) and the seal counts."""
        parts = [g.telemetry_arrays() for g in self.groups]
        out: Dict[str, object] = {name: np.concatenate([p[name] for p in parts])
                                  for name in parts[0]}
        out["blocked_seconds"] = float(self.blocked_seconds)
        out["blocked_seconds_per_writer"] = self.blocked_by_writer
        with self._meta_lock.hold("bookkeeping"):
            out["sessions"] = {k: dict(v) for k, v in self.session_stats.items()}
        out["fold_events"] = self.fold_events
        if self.n_groups == 1:
            out["level_gen"] = self.groups[0].gen_snapshot()
        else:
            out["level_gen"] = {f"g{g.gid}": g.gen_snapshot() for g in self.groups}
        out["seal_events"] = self.seal_events
        out["seal_reuses"] = self.seal_reuses
        self._update_tablet_gauges([g.gen_snapshot() for g in self.groups])
        return out


class DistBatchWriter(BatchWriter):
    """Client-side ingest writer for the device plane: a flush encodes
    through the store's dictionaries, shards by row hash and appends
    through the plane. writer_id salts the row hash and keys the plane's
    per-writer blocked seconds; omitted, each writer gets a fresh id. On a
    lockstep mesh plane every rank runs the writer on the same events (and
    so encodes them into the same dictionary codes); each keeps its own
    tablets' rows. On a plane with a control log, writers run on rank 0
    alone, from any number of threads: the log carries each batch's rows
    and its new dictionary entries to the other ranks."""

    _next_id = itertools.count()

    def __init__(self, store, plane: DistIngestPlane, batch_rows: int = 4096,
                 metrics: Optional[IngestMetrics] = None, writer_id: Optional[int] = None):
        ctl = getattr(plane, "control", None)
        if ctl is not None and not ctl.leads:
            raise RuntimeError(f"rank {ctl.rank} follows rank 0's control log: writers run on "
                               "rank 0")
        super().__init__(store, batch_rows=batch_rows, metrics=metrics)
        self.plane = plane
        if writer_id is None:
            writer_id = next(DistBatchWriter._next_id)
        self._writer_id = np.int64(writer_id)
        self._count = 0

    def _write(self, ts: np.ndarray, values) -> float:
        ts = np.asarray(ts, dtype=np.int64)
        if np.any(ts < 0) or np.any(ts > keypack.TS_MAX):
            raise ValueError("timestamp out of 30-bit store range")
        cols = self.store.encode_events(ts, values)
        n = len(ts)
        nonce = np.arange(self._count, self._count + n, dtype=np.int64)
        self._count += n
        h = keypack.short_hash(
            *(cols[:, j] for j in range(cols.shape[1])), ts, nonce, self._writer_id
        )
        tab = (h % self.plane.n_tablets).astype(np.int32)
        rts = keypack.rev_ts(ts).astype(np.int32)
        return self.plane.ingest(rts, cols, tab, writer_id=int(self._writer_id))


def check_tablet_guidance(n_tablets: int, n_writers: int) -> bool:
    """The paper's sizing rule on the device plane: at least half as many
    tablets as parallel writers."""
    return check_shard_guidance(n_tablets, n_writers)
