"""QueryService — N concurrent client sessions over ONE shared device
plane; the port of the reference's serve_db/service.py.

The paper's query experiments put plural clients against tablet servers
that are simultaneously ingesting. One `QueryService` owns one
`DistIngestPlane` + `DistQueryProcessor` (and a host `QueryProcessor`
twin for oracle sessions), all on the plane's device, and serves any
number of `QuerySession`s, each streaming result batches as they
complete.

Architecture (one box per thread):

    client threads        dispatcher thread          compactor thread
    ──────────────        ─────────────────          ────────────────
    session.submit ─────▶ FairScheduler.pop_turn
    stream.results ◀───── step one adaptive batch    idle? plane.compact
      (queue.get)         under _device_lock ◀─────── (non-blocking try)
                          deliver ResultBatch

Device work is serialized by `_device_lock` (one host process drives the
card; concurrency is about FAIRNESS of interleaving, not parallel
dispatch — same regime as the paper's single-cluster experiments). The
scheduler picks whose batch runs next (TTFR priority + round-robin,
scheduler.py); the Alg-1 turn quantum bounds how long any session can
hold the device. Background compaction (compactor.py) runs ONLY when no
batch is in flight and none is queued — the query path never folds,
which `plane.telemetry()["fold_events"]` proves.

Every query run is pinned to the publish() snapshot it started on
(core/dist_query.QueryRun), so a fold or a concurrent publish can never
change an in-flight session's results — sessions see a consistent LSM
state per query, and fresh ingest becomes visible at the next query.

`_device_lock` serializes QUERY work only. Ingest never takes it: on a
sharded plane (`DistIngestPlane(n_groups=G)`) writers append under
per-tablet-group locks, so W `DistBatchWriter`s feed the plane live
while sessions stream — the paper's "query under ingest" regime — and
the only cross-plane coupling left is the compactor's non-blocking
device-lock probe before each fold increment. Snapshot pinning is
unchanged for composite stores: publish() composes per-group zero-copy
snapshots (each group's gens ride along under its own key), and a run
pinned to a composite sees every group frozen at its own generation.

Every thread enqueues its work on the card's one stream, so a session's
device wait can include writer or compactor work queued ahead of it;
span fences wait on an event recorded after the span's own work, never
on work queued later.

ON A MESH (a plane built with ``mesh=`` and ``control=``, core/spmd.py),
rank 0 is the reference's single controller: it runs this service — its
sessions, scheduler, dispatcher and compactor — and the writers, and the
plane and the processor log every operation that changes or reads the
device state (a run's build and each of its steps, on the dispatcher;
appends, folds and seals under their group locks). The other ranks follow
that log and never decide anything themselves; the dispatcher stays the
one thread of rank 0 that issues collectives. Host-backend sessions touch
no mesh state and run on rank 0 alone. The service does not own the log:
close() logs the end of every run it drops, and whoever built the
Controller closes it once the service and the writers have stopped.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Optional

from ..core.dist_query import DistQueryProcessor, QueryRun
from ..core.query import HostBatch, HostQueryRun, QueryProcessor
from ..obs import OwnedLock, span
from .compactor import BackgroundCompactor
from .scheduler import FairScheduler, QueryEntry, TurnQuantum
from .session import QuerySession, ResultBatch, StreamingQuery

SCHEME_FLAGS = {
    "scan": dict(use_index=False, batched=False),
    "batched_scan": dict(use_index=False, batched=True),
    "index": dict(use_index=True, batched=False),
    "batched_index": dict(use_index=True, batched=True),
}


class _OneShotRun:
    """Adapter: a single-dispatch query (aggregate / density) as a
    one-step run, so the scheduler treats it like any other turn. The
    whole dispatch is charged to the profile's device section (both
    adapted paths — aggregate_range, agg_count — are single fenced
    device programs; their host epilogues are the remainder of the
    step, which the service books separately)."""

    def __init__(self, fn, profile=None):
        self._fn = fn
        self._profile = profile
        self._done = False

    @property
    def done(self) -> bool:
        return self._done

    def step(self):
        t0 = time.perf_counter()
        out = self._fn()
        if self._profile is not None:
            self._profile.device_acc_s += time.perf_counter() - t0
        self._done = True
        return out


class QueryService:
    """See module docstring. The processors run on the plane's device
    (the service has no device of its own). `start=True` (default)
    launches the dispatcher and the background compactor immediately; use
    as a context manager to guarantee shutdown."""

    def __init__(
        self,
        store,
        plane,
        top_k: int = 128,
        w: float = 10.0,
        quantum: Optional[TurnQuantum] = None,
        compaction_interval: float = 0.02,
        compactor: bool = True,
        start: bool = True,
    ):
        control = getattr(plane, "control", None)
        if control is not None and not control.leads:
            raise RuntimeError(f"rank {control.rank} follows rank 0's control log: the "
                               "service runs on rank 0 alone (Controller.follow here)")
        if getattr(plane, "mesh", None) is not None and control is None:
            # Its threads would schedule each rank's queries, publishes and
            # compactions apart, and the ranks' collectives would not pair.
            raise ValueError("QueryService serves a meshless plane, or a mesh plane with a "
                             "control log (core/spmd.py Controller) that rank 0 leads")
        self.store = store
        self.plane = plane
        self.proc = DistQueryProcessor(store, plane=plane, top_k=top_k, w=w,
                                       device=plane.device)
        self.host_proc = QueryProcessor(store, w=w, device=plane.device)
        self.scheduler = FairScheduler(quantum)
        # OwnedLock: every hold is attributed to an owner class
        # (session_turn / density_read / fold_increment) so the occupancy
        # report (repro_torch.obs.occupancy_snapshot) breaks down exactly where
        # the TTFR-governing serialization point's time goes.
        self._device_lock = OwnedLock("device_lock")
        self._stop = threading.Event()
        # Turns in flight on the dispatcher. Written ONLY under the
        # scheduler's condition variable (pop_turn's on_pop hook and the
        # dispatcher's decrement), so busy() can never miss a popped-but-
        # unstarted turn.
        self._in_flight = 0  # guarded-by: scheduler._cv
        self._sessions: Dict[int, QuerySession] = {}
        self._next_sid = itertools.count()
        self._dispatcher: Optional[threading.Thread] = None
        self.compactor = (
            BackgroundCompactor(plane, self, interval=compaction_interval)
            if compactor
            else None
        )
        if start:
            self.start()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "QueryService":
        if self.scheduler._closed:
            raise RuntimeError("QueryService cannot be restarted after close()")
        if self._dispatcher is None:
            self._stop.clear()
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, name="serve-db-dispatcher", daemon=True
            )
            self._dispatcher.start()
            if self.compactor is not None:
                self.compactor.start()
        return self

    def close(self) -> None:
        """Drain nothing, stop everything: pending queries error out on
        their streams; sessions' final telemetry lands in the plane. On a
        mesh plane each dropped run's end is logged; the control log stays
        open for its owner to close."""
        self._stop.set()
        if self._dispatcher is not None:
            self._dispatcher.join()
            self._dispatcher = None
        if self.compactor is not None:
            self.compactor.stop()
        # Closing the scheduler rejects any submit that raced past
        # _enqueue's liveness check, and hands back everything queued —
        # no stream is ever left hanging without a terminal item.
        for entry in self.scheduler.close():
            if entry.run is not None and hasattr(entry.run, "close"):
                entry.run.close()
            entry.stream._finish(error=RuntimeError("QueryService closed"))
        for s in list(self._sessions.values()):
            s.close()

    def __enter__(self) -> "QueryService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- sessions
    def session(self, name: str = "", backend: str = "dist") -> QuerySession:
        sid = next(self._next_sid)
        s = QuerySession(self, sid, name=name, backend=backend)
        self._sessions[sid] = s
        return s

    def busy(self) -> bool:
        """True while any session batch is in flight or runnable — the
        compactor's keep-out signal. The pop-side increments _in_flight
        under the scheduler's condition variable, so there is no instant
        where a popped-but-unstarted turn reads as idle. The read here is
        deliberately lock-free: busy() is an advisory poll (the compactor
        re-checks under the device lock before folding), and an int read
        is atomic under the GIL, so staleness here can never fold under a
        live turn."""
        return self._in_flight > 0 or self.scheduler.has_pending()  # reprolint: disable=guarded-by

    def wait_idle(self, timeout: float = 60.0) -> bool:
        """Spin until no work is queued or in flight (lets the background
        compactor take the device)."""
        deadline = time.perf_counter() + timeout
        while self.busy():
            if time.perf_counter() > deadline:
                return False
            time.sleep(0.001)
        return True

    # ------------------------------------------------------------- internals
    def _enqueue(self, session: QuerySession, sq: StreamingQuery, stats=None) -> None:
        if self._dispatcher is None:
            raise RuntimeError("QueryService is not running (start() it first)")
        self.scheduler.submit(
            QueryEntry(
                session=session, stream=sq, stats=stats,
                ready_at=time.perf_counter(),
            )
        )

    def _report_session(self, session: QuerySession) -> None:
        self.plane.record_session(session.session_id, session.telemetry())

    def _forget_session(self, session: QuerySession) -> None:
        """Called by QuerySession.close(): the service drops its handle so
        long-lived deployments (one session per client connection) don't
        accumulate dead sessions."""
        self._sessions.pop(session.session_id, None)

    def _build_run(self, entry: QueryEntry):
        sq = entry.stream
        backend = entry.session.backend
        if sq.scheme == "aggregate":
            spec, tree = sq.tree  # (AggregateSpec, tree) packed by submit

            def agg():
                if backend == "host":
                    return self.host_proc.aggregate(
                        spec, sq.t_start, sq.t_stop, tree, stats=entry.stats
                    )
                return self.proc.aggregate_range(
                    spec, tree, sq.t_start, sq.t_stop, stats=entry.stats
                )

            def fn():
                res = agg()
                return ResultBatch(
                    seq=0, lo=sq.t_start, hi=sq.t_stop,
                    count=int(res.counts.sum()), blocks=[res],
                )

            return _OneShotRun(fn, profile=sq.profile)
        if sq.scheme == "density":
            field_, value = sq.tree  # (field, value) packed by submit
            src = self.store if backend == "host" else self.proc

            def fn():
                d = src.agg_count(field_, value, sq.t_start, sq.t_stop)
                return ResultBatch(
                    seq=0, lo=sq.t_start, hi=sq.t_stop, count=int(d)
                )

            return _OneShotRun(fn, profile=sq.profile)
        flags = SCHEME_FLAGS[sq.scheme]
        if backend == "host":
            return HostQueryRun(
                self.host_proc, sq.t_start, sq.t_stop, sq.tree,
                stats=entry.stats, **flags,
            )
        return QueryRun(
            self.proc, sq.tree, sq.t_start, sq.t_stop,
            stats=entry.stats, profile=sq.profile, **flags,
        )

    @staticmethod
    def _as_result(entry: QueryEntry, blk, wait_s: float, device_s: float) -> ResultBatch:
        if isinstance(blk, ResultBatch):  # one-shot runs build their own
            blk.wait_s, blk.device_s = wait_s, device_s
            return blk
        if isinstance(blk, HostBatch):
            return ResultBatch(
                seq=entry.seq, lo=blk.lo, hi=blk.hi, count=blk.rows,
                blocks=blk.blocks, device_s=device_s, wait_s=wait_s,
            )
        return ResultBatch(  # DistBatch
            seq=entry.seq, lo=blk.lo, hi=blk.hi, count=blk.count,
            ts=blk.ts, cols=blk.cols, device_s=device_s, wait_s=wait_s,
        )

    # reprolint: hot-path — every session batch flows through this turn
    def _run_turn(self, entry: QueryEntry) -> None:
        t0 = time.perf_counter()
        # Queue wait = runnable -> device acquired. Run construction and
        # batch execution below are SERVING cost (they count toward TTFR
        # but not toward wait_s — the contention signal must not absorb
        # planning or compile time).
        wait_s = t0 - entry.ready_at
        # Captured before serving mutates them: the scheduler's turn log
        # keys the starvation guard on first-result turns (seq0 == 0)
        # and their queue wait — the stall incremental compaction bounds.
        seq0, wait0 = entry.seq, wait_s
        # TTFR anatomy (profile.py): the stage boundaries below are read
        # off ONE thread's clock, and each stage begins at the very read
        # that closed the one before it (`edge`), so the first-result
        # stages tile the measured TTFR with no unattributed gap: a GIL
        # switch or a collector pause between two stages lands in one of
        # them. Admission closes when this turn starts.
        edge = t0
        prof = entry.stream.profile
        if entry.stream.first_result_at is None:
            prof.admission_s = t0 - entry.stream.submitted_at
            if entry.popped_at:
                prof.admission_queue_s = entry.popped_at - entry.stream.submitted_at
        if entry.run is None:
            # Built here, on the dispatcher, under the device lock:
            # planning reads densities off the card (device work), and it
            # counts toward this query's time-to-first-result like every
            # other serving cost. For the occupancy books this stretch of
            # the hold is density/planning work, not batch stepping.
            with self._device_lock.reowner("density_read"):
                with span(
                    "serve.plan", cat="serve",
                    session=entry.session.session_id, scheme=entry.stream.scheme,
                ):
                    entry.run = self._build_run(entry)
            # plan = run construction minus the density reads the
            # execution layer accumulated inside it (the fenced d_i
            # lookups are their own stage — the paper's follower cost).
            tp1 = time.perf_counter()
            prof.density_fence_s = prof.density_acc_s
            prof.plan_s = (tp1 - edge) - prof.density_fence_s
            edge = tp1
            if entry.run.done:  # provably-empty plan: zero batches
                entry.stream._finish()
                self._report_session(entry.session)
                self.scheduler.log_turn(
                    entry.session.session_id, seq0, wait0, 0,
                    time.perf_counter() - t0,
                )
                return
        quantum = self.scheduler.quantum
        budget = quantum.budget()
        served = 0
        while served < budget and not entry.run.done:
            first = entry.stream.first_result_at is None
            dev0 = prof.device_acc_s
            start = time.perf_counter()
            blk = entry.run.step()
            end = time.perf_counter()
            if blk is None:
                break
            # Device section accumulated by the execution layer during
            # step(); everything else in the step is host epilogue
            # (top-k merges, valid-row filters, batcher bookkeeping).
            # The first step's epilogue opens at `edge` (the plan's end).
            dev = prof.device_acc_s - dev0
            prof.note_step(dev, (end - (edge if first else start)) - dev, first)
            td0 = end if first else time.perf_counter()
            with span("serve.deliver", cat="serve", session=entry.session.session_id):
                entry.stream._deliver(self._as_result(entry, blk, wait_s, end - start))
            if first:
                # deliver closes at the first_result_at stamp _deliver
                # just wrote — the same instant TTFR is measured against.
                prof.note_deliver(entry.stream.first_result_at - td0, True)
                prof.commit(entry.stream.first_result_s)
            else:
                prof.note_deliver(time.perf_counter() - td0, False)
            wait_s = 0.0  # later batches of this turn never waited
            entry.seq += 1
            served += 1
            if self.scheduler.ttfr_waiting():
                break  # someone's FIRST result is pending: yield the device
        quantum.update(time.perf_counter() - t0, served)
        self.scheduler.log_turn(
            entry.session.session_id, seq0, wait0, served,
            time.perf_counter() - t0,
        )
        if entry.run.done:
            entry.stream._finish()
            self._report_session(entry.session)
        else:
            entry.ready_at = time.perf_counter()  # runnable again from now
            self.scheduler.requeue(entry)

    # reprolint: hot-path
    def _dispatch_loop(self) -> None:
        def mark():
            # Runs inside pop_turn, which calls it while HOLDING the
            # scheduler condition variable — statically invisible to the
            # lexical guarded-by check, hence the targeted suppression.
            self._in_flight += 1  # reprolint: disable=guarded-by

        while not self._stop.is_set():
            entry = self.scheduler.pop_turn(timeout=0.02, on_pop=mark)
            if entry is None:
                continue
            try:
                with self._device_lock.hold("session_turn"):
                    with span(
                        "serve.turn", cat="serve",
                        session=entry.session.session_id,
                        qid=entry.stream.qid,
                    ):
                        self._run_turn(entry)
            except BaseException as e:  # deliver, don't kill the dispatcher
                entry.stream._finish(error=e)
            finally:
                # Decrement under the cv like the increment: -= on an int
                # is a read-modify-write, and a torn update would wedge
                # busy() permanently true (compactor starves) or false
                # (fold races a turn) — found by reprolint's guarded-by
                # rule on the plane's shared counters.
                with self.scheduler._cv:
                    self._in_flight -= 1
