"""Rank bodies of tests/test_torch_serve_mesh.py: gloo processes on a CPU
(data=2, model=2) DeviceMesh, rank 0 the controller of a core/spmd.py
control log and ranks 1-3 its followers. Imports torch and repro_torch
only (the spawned ranks need no JAX); the reference's subprocess imports
the helpers at the top.

``main`` runs three phases in one process group, each on a control log
and a mesh plane of its own (test_torch_store_mesh's PLAN sizes: 8
tablets in 2 groups):

* deterministic: one session, compactor off, a fake clock in dist_query;
  rank 0 serves det_items() through a QueryService on the mesh plane and on
  a meshless plane of the same shape; the followers keep what each step
  and call returned on their rank;
* concurrent: first a query whose tree is too deep for the device stack,
  which must fail its stream and log nothing; then S = 4 session threads
  and W = 2 DistBatchWriter threads on rank 0, compactor on; the sessions
  read [0, QUERY_STOP], the writers append later events with new
  dictionary values; after the drain every rank saves its tablets and
  dictionaries, rank 0 its log;
* writers alone: W = 4 writer threads into the plane, no service.

``fail_main`` runs one failure: a follower that raises, or a rank 0 that
stops mid-run.

Rank 0's log is kept by wrapping its Controller's put (``recording``), a
follower's step and call results by wrapping the applier's handlers
(``observing``), and ``replay`` applies a kept log to a meshless plane.
"""
from __future__ import annotations

import json
import os
import pickle
import threading
import time
import types
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from _torch_store_mesh_worker import (FakeClock, STATE_FIELDS, build_tree, encoded,
                                      ingest_sequence, spec_of)

SCHEMES = ("scan", "batched_scan", "index", "batched_index")
T_SPAN = 4 * 3600
QUERY_STOP = T_SPAN - 1  # the concurrent phase's reads: [0, QUERY_STOP], one bucket short
WRITE_FROM = T_SPAN + 3600  # of the writers' events, which start an hour later
SESSIONS, WRITERS, ROUNDS = 4, 2, 2
ALONE_WRITERS = 4
TIMEOUT_S = 60


def det_items(plan):
    """The deterministic phase's submissions, in order: every query x
    range x scheme, every spec x range on the aggregation query, every
    density."""
    items = [["query", qi, ri, s] for qi in range(len(plan["queries"]))
             for ri in range(len(plan["ranges"])) for s in SCHEMES]
    items += [["aggregate", si, ri] for si in range(len(plan["specs"]))
              for ri in range(len(plan["ranges"]))]
    return items + [["density", di] for di in range(len(plan["densities"]))]


def submit_item(f, spec_cls, session, plan, item, span=None):
    """Submit one item through a session (either package's); ``span``
    replaces the item's time range."""
    kind = item[0]
    if kind == "density":
        field, value, t0, t1 = plan["densities"][item[1]]
        return session.submit_density(field, value, *(span or (t0, t1)))
    t0, t1 = span or plan["ranges"][item[2]]
    if kind == "aggregate":
        return session.submit_aggregate(spec_of(spec_cls, plan["specs"][item[1]]), t0, t1,
                                        build_tree(f, plan["queries"][plan["agg_query"]]))
    return session.submit(item[3], t0, t1, build_tree(f, plan["queries"][item[1]]))


def batches_out(prefix, rbs):
    """ResultBatches (either package's) as arrays keyed prefix|i|field."""
    out = {f"{prefix}|n": np.array(len(rbs))}
    for i, rb in enumerate(rbs):
        out[f"{prefix}|{i}|head"] = np.array([rb.seq, rb.lo, rb.hi, rb.count], np.float64)
        if rb.ts is not None:
            out[f"{prefix}|{i}|ts"] = np.asarray(rb.ts)
            out[f"{prefix}|{i}|cols"] = np.asarray(rb.cols)
        if rb.blocks:
            for k in ("gids", "values", "counts"):
                out[f"{prefix}|{i}|{k}"] = np.asarray(getattr(rb.blocks[0], k))
    return out


def result_out(prefix, value):
    """What a step or call returned on a rank, keyed as batches_out keys a
    batch (a step's head is its lo, hi and count)."""
    if hasattr(value, "ts"):
        return {f"{prefix}|head": np.array([value.lo, value.hi, value.count], np.float64),
                f"{prefix}|ts": value.ts, f"{prefix}|cols": value.cols}
    if hasattr(value, "gids"):
        return {f"{prefix}|{k}": getattr(value, k) for k in ("gids", "values", "counts")}
    return {f"{prefix}|count": np.array(int(value))}


def as_results(out, items):
    """Rank 0's batches of the deterministic phase keyed as its followers
    key the steps and calls they ran: query batches are steps, aggregates
    and densities calls, in submission order."""
    got, j = {}, 0
    for i, item in enumerate(items):
        for b in range(int(out[f"det|{i}|n"])):
            p = f"det|{i}|{b}"
            if item[0] == "query":
                got.update({f"r|{j}|head": out[f"{p}|head"][1:], f"r|{j}|ts": out[f"{p}|ts"],
                            f"r|{j}|cols": out[f"{p}|cols"]})
            elif item[0] == "aggregate":
                got.update({f"r|{j}|{k}": out[f"{p}|{k}"] for k in ("gids", "values", "counts")})
            else:
                got[f"r|{j}|count"] = np.array(int(out[f"{p}|head"][3]))
            j += 1
    return got


def recording(ctl):
    """The records rank 0 logs on ``ctl`` from now on, kept in a list by
    wrapping its put. Each group's records are put under that group's
    lock, so the list keeps every group's order (which is all a replay
    needs)."""
    kept = []
    put = ctl.put

    def keep(rec):
        lens = put(rec)
        kept.append(rec)
        return lens

    ctl.put = keep
    return kept


def observing(values):
    """Append what every query step and call a follower applies returns
    to ``values``, by wrapping the applier's handlers; returns the undo."""
    from repro_torch.core import spmd

    step, call = spmd._Applier._step, spmd._Applier._call
    spmd._Applier._step = lambda self, *a: values.append(step(self, *a))
    spmd._Applier._call = lambda self, *a: values.append(call(self, *a))

    def undo():
        spmd._Applier._step, spmd._Applier._call = step, call

    return undo


def replay(records, plane):
    """Apply rank 0's kept log to a meshless ``plane`` of the same shape:
    every append, compaction, warm-up and seal in log order (query
    records read and change nothing, so they are skipped). The plane's
    groups then hold, tablet for tablet, what the mesh's ranks hold."""
    for rec in records:
        kind, body = rec.kind, rec.body
        if kind == "append":
            gid, rts, cols, tab, _, writer_id, _, _ = body
            plane.groups[gid].ingest(rts, cols, tab, writer_id=writer_id)
        elif kind == "compact_step":
            plane.groups[body[0]].compact_step(body[1])
        elif kind == "compact":
            plane.groups[body[0]].compact(body[1])
        elif kind == "warm_seal":
            plane.groups[body[0]].warm_seal()
        elif kind == "warm_compaction":
            plane.groups[body[0]].warm_compaction()
        elif kind == "snap":
            plane.groups[body[0]].snapshot()


def deep_tree():
    """A filter tree one level deeper than the device stack holds: each
    right-nested AND keeps one more operand on the stack."""
    from repro_torch.core import And, Eq
    from repro_torch.core.filter import MAX_STACK

    tree = Eq("domain", "a.com")
    for _ in range(MAX_STACK):
        tree = And(Eq("status", "200"), tree)
    return tree


def _plane(store, plan, mesh=None, control=None):
    from repro_torch.core.dist_ingest import DistIngestPlane

    return DistIngestPlane.for_store(store, n_tablets=plan["tablets"], n_groups=plan["groups"],
                                     device="cpu", mesh=mesh, control=control, **plan["sizes"])


def _store():
    from repro_torch.core.schema import web_proxy_schema
    from repro_torch.core.store import EventStore

    return EventStore(web_proxy_schema(), device="cpu")


def serve_det(store, plane, plan):
    """det_items() through one session of a QueryService on ``plane``,
    compactor off, under a fresh fake clock."""
    from repro_torch.core import dist_query
    from repro_torch.core import filter as pf
    from repro_torch.core.iterators import AggregateSpec
    from repro_torch.serve_db import QueryService

    dist_query.time = types.SimpleNamespace(perf_counter=FakeClock().perf_counter)
    svc = QueryService(store, plane, top_k=plan["top_k"], compactor=False)
    s = svc.session("det")
    out = {}
    for i, item in enumerate(det_items(plan)):
        out.update(batches_out(f"det|{i}", submit_item(pf, AggregateSpec, s, plan, item)
                               .drain(timeout=120)))
    s.close()
    svc.close()
    dist_query.time = time
    return out


def refusals(store, plane, ctl, mesh):
    """The errors a controlled mesh plane raises where a rank may not
    drive it."""
    from repro_torch.core.dist_ingest import DistBatchWriter
    from repro_torch.core.dist_query import DistQueryProcessor
    from repro_torch.serve_db import QueryService

    if ctl.leads:
        cases = {"follow_on_rank0": lambda: ctl.follow(plane),
                 "lockstep_service": lambda: QueryService(store, _plane(store, PLAN_SHAPE, mesh),
                                                          start=False)}
    else:
        cases = {"service": lambda: QueryService(store, plane, start=False),
                 "writer": lambda: DistBatchWriter(store, plane),
                 "processor": lambda: DistQueryProcessor(store, plane, device="cpu"),
                 "ingest": lambda: plane.ingest(np.zeros(1, np.int32),
                                                np.zeros((1, 12), np.int32), np.zeros(1)),
                 "compact_step": lambda: plane.compact_step()}
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except (ValueError, RuntimeError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


PLAN_SHAPE = {"tablets": 8, "groups": 2, "sizes": {"capacity": 64}}


def rank_state(plane):
    """This rank's group states and last published snapshots, and its
    telemetry rows, as arrays."""
    out = {f"state|g{g.gid}|{k}": v.numpy() for g in plane.groups for k, v in g.state.items()}
    for g in plane.groups:
        for f in STATE_FIELDS:
            out[f"pub|g{g.gid}|{f}"] = getattr(g._published, f).numpy()
    out["rows"] = np.array(int(plane.telemetry()["rows"].sum()))
    return out


def _dicts(store):
    return {f: list(d._rev) for f, d in store.dictionaries.items()}


def _events(seed, n, t0, t1):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(t0, t1, n))
    return ts, {
        "domain": rng.choice(["a.com", "b.com", "c.com", "rare.net"], size=n).tolist(),
        "method": rng.choice(["GET", "POST", "PUT"], size=n).tolist(),
        "status": rng.choice(["200", "404"], size=n).tolist(),
        # New values: the log must carry the dictionaries' growth.
        "bytes_in": rng.integers(1 << 21, 1 << 22, n).astype(str).tolist(),
        "bytes_out": rng.integers(10, 5000, n).astype(str).tolist(),
    }


def run_threads(fns):
    """Run each function on a thread; raise the first exception."""
    errors = []

    def wrap(fn):
        try:
            fn()
        except BaseException as e:  # re-raised below, after the join
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(fn,)) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a thread hung")


def phase_det(rank, out_dir, mesh, inputs, plan):
    from repro_torch.core import dist_query
    from repro_torch.core.spmd import Controller

    store = _store()
    _, _, rts, cols, tab = encoded(store, inputs)
    ctl = Controller(store, timeout_s=TIMEOUT_S)
    plane = _plane(store, plan, mesh, ctl)
    res = {"refusals": refusals(store, plane, ctl, mesh)}
    if ctl.leads:
        ingest_sequence(plane, rts, cols, tab, plan)
        out = serve_det(store, plane, plan)
        ctl.close()
        m_store = _store()
        _, _, m_rts, m_cols, m_tab = encoded(m_store, inputs)
        m_plane = _plane(m_store, plan)
        ingest_sequence(m_plane, m_rts, m_cols, m_tab, plan)
        meshless = serve_det(m_store, m_plane, plan)
        np.savez(os.path.join(out_dir, "det_rank0.npz"), **out,
                 **{"meshless|" + k: v for k, v in meshless.items()},
                 **as_results(out, det_items(plan)))
    else:
        values = []
        undo = observing(values)
        dist_query.time = types.SimpleNamespace(perf_counter=FakeClock().perf_counter)
        try:
            res["applied"] = ctl.follow(plane)
        finally:
            dist_query.time = time
            undo()
        got = {}
        for j, v in enumerate(values):
            got.update(result_out(f"r|{j}", v))
        np.savez(os.path.join(out_dir, f"det_rank{rank}.npz"), **got)
    return res


def phase_concurrent(rank, out_dir, mesh, inputs, plan):
    from repro_torch.core import filter as pf
    from repro_torch.core.dist_ingest import DistBatchWriter
    from repro_torch.core.iterators import AggregateSpec
    from repro_torch.core.spmd import Controller
    from repro_torch.serve_db import QueryService

    store = _store()
    _, _, rts, cols, tab = encoded(store, inputs)
    ctl = Controller(store, timeout_s=TIMEOUT_S)
    plane = _plane(store, plan, mesh, ctl)
    res = {}
    if ctl.leads:
        log = recording(ctl)
        ingest_sequence(plane, rts, cols, tab, plan)
        svc = QueryService(store, plane, top_k=plan["top_k"], compaction_interval=0.005)
        first = svc.proc.dist  # the snapshot the service's processor published at its start
        # A tree the device stack cannot hold fails its own stream, as on
        # a meshless plane, and logs nothing: the log stays live.
        n_logged = len(log)
        q = svc.session("deep").submit("scan", 0, QUERY_STOP, deep_tree())
        try:
            q.drain(timeout=120)
            res["deep"] = None
        except ValueError as e:
            res["deep"] = str(e)
        res["deep_logged"] = [r.kind for r in log[n_logged:]]
        res["deep_live"] = ctl.live
        items = [it for it in det_items(plan) if it[0] != "aggregate" or it[1] == 0]
        counts = [[] for _ in range(SESSIONS)]

        def session(i):
            s = svc.session(f"c{i}")
            mine = items[i * len(items) // SESSIONS:] + items[:i * len(items) // SESSIONS]
            for _ in range(ROUNDS):
                for item in mine:
                    q = submit_item(pf, AggregateSpec, s, plan, item, span=(0, QUERY_STOP))
                    rbs = q.drain(timeout=120)
                    agg = rbs[0].blocks[0] if item[0] == "aggregate" else None
                    counts[i].append([item, sum(rb.count for rb in rbs),
                                      None if agg is None else
                                      [agg.gids.tolist(), agg.values.tolist(),
                                       agg.counts.tolist()]])
            s.close()

        def writer(w):
            wr = DistBatchWriter(store, plane, batch_rows=300, writer_id=10 + w)
            ts, vals = _events(100 + w, 2400, WRITE_FROM, 2 * T_SPAN)
            for off in range(0, len(ts), 200):
                wr.add(ts[off: off + 200], {k: v[off: off + 200] for k, v in vals.items()})
                time.sleep(0.005)
            wr.close()

        run_threads([lambda i=i: session(i) for i in range(SESSIONS)]
                    + [lambda w=w: writer(w) for w in range(WRITERS)])
        if not svc.wait_idle(timeout=120):
            raise RuntimeError("the service never went idle")
        deadline = time.perf_counter() + 120
        while plane.has_unfolded() and time.perf_counter() < deadline:
            time.sleep(0.01)
        # Each query's pinned publish became the processor's latest: it
        # holds no level the writers and the compactor have since replaced.
        res["kept_first_snapshot"] = svc.proc.dist is first
        res["drained"] = not plane.has_unfolded()
        res["background_folds"] = plane.fold_events.get("background", 0)
        plane.publish()
        svc.close()
        ctl.close()  # the stop record
        res["counts"] = counts
        with open(os.path.join(out_dir, "log.pkl"), "wb") as f:
            pickle.dump(log, f)
    else:
        res["applied"] = ctl.follow(plane)
    np.savez(os.path.join(out_dir, f"conc_rank{rank}.npz"), **rank_state(plane))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, _dicts(store))
    res["dicts_equal"] = all(e == every[0] for e in every)
    res["dict_sizes"] = {f: len(v) for f, v in every[0].items()}
    res["tablets"] = [[g.t0, g.t0 + g.n_tablets] for g in plane.groups]
    return res


def phase_alone(rank, out_dir, mesh, plan):
    from repro_torch.core.dist_ingest import DistBatchWriter
    from repro_torch.core.spmd import Controller

    store = _store()
    ctl = Controller(store, timeout_s=TIMEOUT_S)
    plane = _plane(store, plan, mesh, ctl)
    res = {}
    if ctl.leads:
        log = recording(ctl)

        def writer(w):
            wr = DistBatchWriter(store, plane, batch_rows=250, writer_id=w)
            ts, vals = _events(200 + w, 1500, 0, 2 * T_SPAN)
            for off in range(0, len(ts), 100):
                wr.add(ts[off: off + 100], {k: v[off: off + 100] for k, v in vals.items()})
            wr.close()

        run_threads([lambda w=w: writer(w) for w in range(ALONE_WRITERS)])
        plane.publish()
        ctl.close()
        with open(os.path.join(out_dir, "alone_log.pkl"), "wb") as f:
            pickle.dump(log, f)
    else:
        res["applied"] = ctl.follow(plane)
    np.savez(os.path.join(out_dir, f"alone_rank{rank}.npz"), **rank_state(plane))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, _dicts(store))
    res["dicts_equal"] = all(e == every[0] for e in every)
    return res


def _join(rank, world, store_path):
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=TIMEOUT_S))
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def main(rank: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    with open(os.path.join(out_dir, "plan.json")) as f:
        plan = json.load(f)
    mesh = _join(rank, 4, os.path.join(out_dir, "fs"))
    try:
        res = {"det": phase_det(rank, out_dir, mesh, inputs, plan),
               "concurrent": phase_concurrent(rank, out_dir, mesh, inputs, plan),
               "alone": phase_alone(rank, out_dir, mesh, plan)}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def fail_main(rank: int, out_dir: str, mode: str) -> None:
    """One failure on a controlled mesh plane of four ranks (the control
    group's timeout 15 s). mode "follower": rank 2 raises on its third
    append; "leader": rank 0 stops after one batch of a batched query,
    without closing the log. Every rank must end with a non-zero exit;
    each writes how far it got and what it raised to
    fail_<mode>_rank<r>.json first."""
    torch.set_num_threads(1)
    status = {"stage": "start", "error": None}
    try:
        _fail_body(rank, out_dir, mode, status)
    except BaseException as e:
        status["error"] = repr(e)
        raise
    finally:
        with open(os.path.join(out_dir, f"fail_{mode}_rank{rank}.json"), "w") as f:
            json.dump(status, f)


def _fail_body(rank, out_dir, mode, status):
    from repro_torch.core import Eq
    from repro_torch.core.dist_ingest import DistBatchWriter, TabletGroup
    from repro_torch.core.dist_query import DistQueryProcessor
    from repro_torch.core.spmd import Controller

    with open(os.path.join(out_dir, "plan.json")) as f:
        plan = json.load(f)
    mesh = _join(rank, 4, os.path.join(out_dir, f"fs_{mode}"))  # a loaded host starts slowly
    store = _store()
    ctl = Controller(store, timeout_s=15)
    plane = _plane(store, plan, mesh, ctl)
    if not ctl.leads:
        if mode == "follower" and rank == 2:
            calls = [0]
            append = TabletGroup.apply_append

            def failing(self, *a, **k):
                calls[0] += 1
                if calls[0] == 3:
                    raise RuntimeError("an injected follower failure")
                return append(self, *a, **k)

            TabletGroup.apply_append = failing
        status["stage"] = "following"
        status["applied"] = ctl.follow(plane)
        return  # a clean stop: the failure this test looks for
    status["stage"] = "leading"
    w = DistBatchWriter(store, plane, batch_rows=200)
    dq = DistQueryProcessor(store, plane, top_k=plan["top_k"], device="cpu")
    for i in range(40):
        ts, vals = _events(300 + i, 200, 0, T_SPAN)
        w.add(ts, vals)
        if mode == "leader" and i == 10:
            next(iter(dq.run_scheme("batched_scan", 0, T_SPAN, Eq("domain", "a.com"))))
            raise RuntimeError("rank 0 stops mid-run")
        sum(b.count for b in dq.run_scheme("batched_index", 0, T_SPAN, Eq("domain", "c.com")))
        time.sleep(0.05)
    w.close()
    ctl.close()
