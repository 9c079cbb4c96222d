"""The control log of a store served on a DeviceMesh: rank 0 is the single
controller, the other ranks follow its ordered log. The port's own; the
reference needs none, since JAX has one controller that drives every
device.

A mesh plane (core/dist_ingest.py) needs every rank to make the same
appends, compactions, seals and query steps in the same order: each rank
mirrors every tablet of its groups on the host and decides every flush,
major and fold from those mirrors, and the query steps pair their
collectives. The lockstep mode gets that by having every rank call the
same API. A :class:`Controller` gets it for threaded writers and a
threaded serve plane instead:

* on rank 0 every operation that changes or reads the device state puts
  one :class:`Record` into a FIFO, under the lock that orders the
  operation there (a group's lock for its appends, compactions and seals,
  the plane's meta lock for a publish's composition, the dispatcher for a
  query's build and steps); one sender thread drains the FIFO to every
  follower over a gloo group of its own, so NCCL carries only the steps'
  collectives;
* on ranks 1 and up, :meth:`Controller.follow` applies the records in
  order on the rank's own tablets until a stop record arrives.

Dictionary codes are assigned on rank 0 alone. Every record carries the
entries the dictionaries gained since the record before it, in code order,
and followers add them, so every rank's dictionaries equal rank 0's at
every position of the log. A query reads a snapshot pinned by a publish
record, through a view of the dictionaries cut at the length they had
when that publish was logged (:class:`StoreView`): rank 0 and every
follower resolve the same codes, plan the same conditions and read the
same densities, whatever rank 0's writers encode meanwhile.

An exception on rank 0 after it logged a query record, or a failure to
send, ends the log with an error record; a follower raises on it, on a
record it cannot apply, or when nothing arrives within the group's
timeout (rank 0 sends a tick while idle). No rank hangs past the timeout.
"""
from __future__ import annotations

import itertools
import pickle
import queue
import threading
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs import get_registry, span

STOP, ERROR, TICK = "stop", "error", "tick"


@dataclass
class Record:
    """One entry of the log: its kind, its body and the dictionary entries
    gained since the record before it ({field: (first code, values)})."""

    kind: str
    body: tuple = ()
    dicts: Optional[Dict[str, Tuple[int, List[str]]]] = None


class CappedDictionary:
    """A field dictionary seen at its first ``n`` codes (read-only)."""

    def __init__(self, d, n: int):
        self.name = d.name
        self._d = d
        self._n = int(n)
        self._fwd_cut: Optional[Dict[str, int]] = None

    def lookup(self, value: str) -> Optional[int]:
        code = self._d._fwd.get(value)
        return code if code is not None and code < self._n else None

    def decode(self, code: int) -> str:
        if not 0 <= int(code) < self._n:
            raise IndexError(f"code {code} past the view's {self._n}")
        return self._d._rev[int(code)]

    def decode_many(self, codes) -> List[str]:
        return [self.decode(c) for c in codes]

    def prefix_codes(self, prefix: str) -> np.ndarray:
        return np.asarray([c for c, s in enumerate(self._d._rev[: self._n])
                           if s.startswith(prefix)], dtype=np.int32)

    @property
    def _rev(self) -> List[str]:
        return self._d._rev[: self._n]

    @property
    def _fwd(self) -> Dict[str, int]:
        if self._fwd_cut is None:
            self._fwd_cut = {s: c for c, s in enumerate(self._d._rev[: self._n])}
        return self._fwd_cut

    def __len__(self) -> int:
        return self._n


class StoreView:
    """A store whose dictionaries are cut at ``lens`` and whose event
    density (the adaptive batcher's b0) is rank 0's ``rps``; everything
    else is the store's."""

    def __init__(self, store, lens: Dict[str, int], rps: float):
        self._store = store
        self.dictionaries = {f: CappedDictionary(store.dictionaries[f], n)
                             for f, n in lens.items()}
        self._rps = float(rps)

    def rows_per_second(self) -> float:
        return self._rps

    def __getattr__(self, name):
        return getattr(self._store, name)


class _Accrual:
    """What a follower passes where rank 0 passed a serve profile, so both
    make the same clock reads in a step."""

    density_acc_s = 0.0
    device_acc_s = 0.0


def _metrics():
    reg = get_registry()
    return (reg.counter("spmd_records_total", "control-log records by kind and rank role"),
            reg.counter("spmd_bytes_total", "control-log bytes sent (rank 0) or received"))


class Controller:
    """The control channel of one mesh store: a gloo group beside the data
    group, rank 0 leading and the other ranks following. Collective: every
    rank of the default process group builds it, after building the same
    store (the dictionaries' lengths and last entries must agree, which is
    checked). ``timeout_s`` is the gloo group's timeout."""

    def __init__(self, store, timeout_s: float = 120.0):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("a control log needs a process group")
        self.store = store
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.leads = self.rank == 0
        self.timeout_s = float(timeout_s)
        self.group = dist.new_group(backend="gloo", timeout=timedelta(seconds=timeout_s))
        lens = {f: len(d) for f, d in store.dictionaries.items()}
        tails = {f: d._rev[-1] if len(d) else None for f, d in store.dictionaries.items()}
        every = [None] * self.world
        dist.all_gather_object(every, (lens, tails), group=self.group)
        if any(e != (lens, tails) for e in every):
            raise ValueError("the ranks' dictionaries differ at the start (lengths and last "
                             f"entries): {every}")
        self._m_records, self._m_bytes = _metrics()
        self._role = "leader" if self.leads else "follower"
        self._lock = threading.Lock()
        self._logged: Dict[str, int] = dict(lens)  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        self._error: Optional[BaseException] = None  # guarded-by: _lock
        self._ids = itertools.count(1)
        self.applying = False  # a follower inside follow()
        self._fifo: "queue.Queue[Record]" = queue.Queue()
        self._sender: Optional[threading.Thread] = None
        if self.leads:
            self._sender = threading.Thread(target=self._send_loop, name="spmd-sender",
                                            daemon=True)
            self._sender.start()

    # ----------------------------------------------------------- leader
    def next_id(self) -> int:
        """A fresh id for a publish or a query run."""
        return next(self._ids)

    def put(self, rec: Record) -> Dict[str, int]:
        """Append a record to the log (rank 0; any thread). Attaches the
        dictionary entries gained since the last record and returns the
        dictionary lengths every follower will have once it applied this
        record. Raises once the log is closed or has failed."""
        if not self.leads:
            raise RuntimeError(f"rank {self.rank} follows rank 0's log; it logs nothing")
        with self._lock:
            if self._error is not None:
                raise RuntimeError(f"the control log failed: {self._error!r}") from self._error
            if self._closed:
                raise RuntimeError("the control log is closed")
            delta = {}
            for f, d in self.store.dictionaries.items():
                n0, n = self._logged[f], len(d)
                if n > n0:
                    delta[f] = (n0, d._rev[n0:n])
                    self._logged[f] = n
            rec.dicts = delta or None
            self._fifo.put(rec)
            self._m_records.inc(kind=rec.kind, role=self._role)
            return dict(self._logged)

    def abort(self, exc: BaseException) -> None:
        """End the log with an error record (rank 0): every follower
        raises on it, and every later put() and close() raises ``exc``."""
        with self._lock:
            if self._error is None:
                self._error = exc
            if self._closed:
                return
            self._closed = True
            self._fifo.put(Record(ERROR, (repr(exc),)))

    def close(self) -> None:
        """Send the stop record and wait for the sender (rank 0). Raises
        the log's failure, if it failed; a second close does nothing more."""
        if not self.leads:
            return
        with self._lock:
            if not self._closed:
                self._closed = True
                self._fifo.put(Record(STOP))
        if self._sender is not None:
            self._sender.join()
        with self._lock:
            err = self._error
        if err is not None:
            raise RuntimeError(f"the control log failed: {err!r}") from err

    @property
    def live(self) -> bool:
        """True while records can still be logged (rank 0)."""
        with self._lock:
            return not self._closed and self._error is None

    def _send_loop(self) -> None:
        tick = min(5.0, self.timeout_s / 4)
        while True:
            try:
                rec = self._fifo.get(timeout=tick)
            except queue.Empty:
                rec = Record(TICK)
            try:
                self._send(rec)
            except BaseException as e:  # every later put() and close() raises it
                self._fail_sending(e)
                return
            if rec.kind in (STOP, ERROR):
                return

    def _send(self, rec: Record) -> None:
        if self.world == 1:
            return
        data = None
        with span("spmd.send", cat="spmd", kind=rec.kind):
            for r in range(1, self.world):
                if data is None or rec.kind == "append":
                    data = pickle.dumps((rec.kind, _body_for(rec, r), rec.dicts),
                                        protocol=pickle.HIGHEST_PROTOCOL)
                self._send_bytes(data, r)

    def _send_bytes(self, data: bytes, rank: int) -> None:
        import torch
        import torch.distributed as dist

        dist.send(torch.tensor([len(data)], dtype=torch.int64), dst=rank, group=self.group)
        dist.send(torch.frombuffer(bytearray(data), dtype=torch.uint8), dst=rank,
                  group=self.group)
        self._m_bytes.inc(len(data) + 8, role=self._role)

    def _fail_sending(self, exc: BaseException) -> None:
        """The sender could not reach a follower: the log fails with
        ``exc``, and the followers it still reaches get an error record."""
        with self._lock:
            if self._error is None:
                self._error = exc
            self._closed = True
        data = pickle.dumps((ERROR, (repr(exc),), None))
        for r in range(1, self.world):
            try:
                self._send_bytes(data, r)
            except RuntimeError:  # that follower is gone; the log's error stands
                continue

    # --------------------------------------------------------- follower
    def _recv(self):
        import torch
        import torch.distributed as dist

        n = torch.empty(1, dtype=torch.int64)
        dist.recv(n, src=0, group=self.group)
        buf = torch.empty(int(n.item()), dtype=torch.uint8)
        dist.recv(buf, src=0, group=self.group)
        self._m_bytes.inc(int(n.item()) + 8, role=self._role)
        return pickle.loads(buf.numpy().tobytes())

    def _extend(self, dicts) -> None:
        """Add rank 0's new dictionary entries, each at its code."""
        for f, (first, values) in dicts.items():
            d = self.store.dictionaries[f]
            if len(d) != first:
                raise RuntimeError(f"dictionary {f!r} holds {len(d)} codes, the log's "
                                   f"entries start at {first}")
            for i, v in enumerate(values):
                if d.encode(v) != first + i:
                    raise RuntimeError(f"dictionary {f!r}: {v!r} is not code {first + i}")

    def follow(self, plane) -> int:
        """Apply rank 0's log on this rank's ``plane`` (ranks 1 and up)
        until the stop record; returns the records applied. Raises on an
        error record, on a record that does not apply, and when nothing
        arrives within the group's timeout."""
        if self.leads:
            raise RuntimeError("rank 0 leads the log; it does not follow it")
        if plane.control is not self:
            raise ValueError("the plane was not built with this control log")
        apply = _Applier(self, plane)
        n = 0
        self.applying = True
        try:
            while True:
                kind, body, dicts = self._recv()
                if dicts:
                    self._extend(dicts)
                if kind == STOP:
                    return n
                if kind == ERROR:
                    raise RuntimeError(f"rank 0 ended the log with an error: {body[0]}")
                if kind == TICK:
                    continue
                with span("spmd.apply", cat="spmd", kind=kind):
                    apply(kind, body)
                self._m_records.inc(kind=kind, role=self._role)
                n += 1
        finally:
            self.applying = False
            with self._lock:
                self._closed = True


def _body_for(rec: Record, rank: int) -> tuple:
    """What follower ``rank`` needs of a record: an append's rows of its
    own tablets and the per-chunk tablet counts; every other body whole."""
    if rec.kind != "append":
        return rec.body
    gid, rts, cols, tab, counts, writer_id, tl, append_rows = rec.body
    return (gid, counts) + _own_rows(rts, cols, tab, rank * tl, tl, append_rows) + (writer_id,)


def _own_rows(rts, cols, tab, lo: int, tl: int, append_rows: int, whole: bool = False):
    """The rows of tablets [lo, lo + tl) (group-local ids; ``whole``: every
    row is), packed as (m, 1 + F) int32 rev_ts then codes, their ids less
    lo, and where each append_rows chunk of the batch starts among them."""
    n = len(tab)
    bounds = np.append(np.arange(0, n, append_rows), n)
    if whole:
        packed = np.empty((n, 1 + cols.shape[1]), np.int32)
        packed[:, 0] = rts
        packed[:, 1:] = cols
        return packed, tab, bounds
    mine = (tab >= lo) & (tab < lo + tl)
    at = np.concatenate([[0], np.cumsum(mine)])
    packed = np.empty((int(at[-1]), 1 + cols.shape[1]), np.int32)
    packed[:, 0] = rts[mine]
    packed[:, 1:] = cols[mine]
    return packed, tab[mine] - lo, at[bounds]


class _Applier:
    """A follower's handlers, one per record kind; a query step or call
    returns what it returned on this rank."""

    def __init__(self, ctl: Controller, plane):
        self.ctl = ctl
        self.plane = plane
        self.subs: Dict[int, Dict[int, object]] = {}  # publish id -> {group: snapshot}
        self.pinned: Dict[int, Tuple[object, Dict[str, int]]] = {}  # publish id -> (store, lens)
        self.runs: Dict[int, object] = {}  # query run id -> QueryRun

    def __call__(self, kind: str, body: tuple):
        return getattr(self, f"_{kind}")(*body)

    def _group(self, gid: int):
        return self.plane.groups[gid]

    def _append(self, gid, counts, packed, tab, starts, writer_id) -> None:
        self._group(gid).apply_append(counts, packed, tab, starts, writer_id)

    def _compact_step(self, gid, source) -> None:
        if not self._group(gid).compact_step(source):
            raise RuntimeError(f"group {gid}: rank 0's compact_step ran an increment here "
                               "the mirrors do not call for")

    def _compact(self, gid, source, passes) -> None:
        got = self._group(gid).compact(source)
        if got != passes:
            raise RuntimeError(f"group {gid}: compact ran {got} passes, rank 0 {passes}")

    def _warm_seal(self, gid) -> None:
        self._group(gid).warm_seal()

    def _warm_compaction(self, gid) -> None:
        self._group(gid).warm_compaction()

    def _snap(self, gid, pub) -> None:
        sub = self._group(gid).snapshot()
        if pub is not None:
            self.subs.setdefault(pub, {})[gid] = sub

    def _publish(self, pub, pinned) -> None:
        got = self.subs.pop(pub)
        d = self.plane._compose(tuple(got[g.gid] for g in self.plane.groups))[0]
        if pinned:  # this record's dictionary entries are in: rank 0's cut
            self.pinned[pub] = (d, {f: len(x) for f, x in self.ctl.store.dictionaries.items()})

    def _processor(self, pub, params, rps):
        from .dist_query import DistQueryProcessor

        d, lens = self.pinned.pop(pub)
        top_k, w, index_postings, index_rows = params
        return DistQueryProcessor(StoreView(self.ctl.store, lens, rps), dist=d, top_k=top_k,
                                  w=w, index_postings=index_postings, index_rows=index_rows,
                                  device=self.plane.device)

    def _run(self, qid, pub, params, rps, tree, t_start, t_stop, use_index, batched,
             profiled) -> None:
        from .dist_query import QueryRun

        run = QueryRun(self._processor(pub, params, rps), tree, t_start, t_stop,
                       use_index=use_index, batched=batched,
                       profile=_Accrual() if profiled else None)
        if not run.done:
            self.runs[qid] = run

    def _step(self, qid):
        run = self.runs[qid]
        out = run.step()
        if run.done:
            del self.runs[qid]
        return out

    def _finish(self, qid) -> None:
        self.runs.pop(qid, None)

    def _call(self, cid, pub, params, rps, name, args, kwargs):
        return getattr(self._processor(pub, params, rps), name)(*args, **kwargs)

