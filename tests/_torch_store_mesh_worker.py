"""Rank bodies of tests/test_torch_store_mesh.py: gloo processes, each a
tablet server of the port's store on a CPU DeviceMesh. Imports torch and
repro_torch only (the spawned ranks need no JAX).

One spawn of four ranks runs three phases, each in a process group of its
own (a FileStore each, with a timeout, so a rank that skips a collective
fails the test instead of hanging it):

* world 4, a (data=2, model=2) mesh: the plan's ingest into a mesh plane
  of 8 tablets in 2 groups; every rank saves its published tablets and
  the raw outputs of the five steps, run_scheme's batches and
  aggregate_range's results for the test to hold against the reference's
  (2, 2) shard_map store; then the same checks as below for R = 4, the
  refusals (a mesh of another device type, a load_state), and a
  QueryService on a mesh plane with a control log (rank 0 serves, the
  other ranks follow) answering one query as on the meshless plane;
* world 2, a (1, 2) mesh (ranks 0 and 1): R = 2;
* world 1, a (1, 1) mesh (rank 0): R = 1.

"Meshless equals mesh" (each phase): the same ingest into a meshless
plane of the same shape and into the mesh plane; each rank's published
tablets must equal the meshless plane's slice of them, and every step,
run_scheme, aggregate_range and execute_batched must return the meshless
results, as must a DistBatchWriter's ingest and from_event_store's replay.
Mismatches are listed in the rank's JSON, which must come back empty.
"""
from __future__ import annotations

import json
import os
import types
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

TICK = 0.004  # the fake clock's step: batch runtimes are the same on every run


class FakeClock:
    """perf_counter for dist_query: TICK seconds a call, so adaptive batches
    depend on the calls made, not on the machine."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += TICK
        return self.t


def spec_of(spec_cls, desc):
    """An AggregateSpec from its JSON form."""
    return spec_cls(**dict(desc, group_by=tuple(desc["group_by"])))


def build_tree(f, desc):
    """A filter tree from its JSON form: ["eq", field, value], ["not", t],
    ["and", t, t], ["or", t, t], ["cmp", field, op, number]."""
    kind = desc[0]
    if kind == "eq":
        return f.Eq(desc[1], desc[2])
    if kind == "cmp":
        return f.Cmp(desc[1], desc[2], desc[3])
    if kind == "not":
        return f.Not(build_tree(f, desc[1]))
    node = f.And if kind == "and" else f.Or
    return node(build_tree(f, desc[1]), build_tree(f, desc[2]))


def encoded(store, inputs):
    ts = inputs["ts"].astype(np.int64)
    vals = {k[2:]: inputs[k].tolist() for k in inputs if k.startswith("v_")}
    from repro_torch.core import keypack

    cols = store.encode_events(ts, vals)
    return ts, vals, keypack.rev_ts(ts).astype(np.int32), cols, inputs["tab"].astype(np.int64)


def ingest_sequence(plane, rts, cols, tab, plan):
    """The plan's ingest: appends in chunks, compact_step increments, more
    appends (the reference runs the same calls)."""
    a, chunk = plan["first"], plan["chunk"]
    for off in range(0, a, chunk):
        plane.ingest(rts[off: min(off + chunk, a)], cols[off: min(off + chunk, a)],
                     tab[off: min(off + chunk, a)])
    for _ in range(plan["compact_steps"]):
        plane.compact_step()
    for off in range(a, len(rts), chunk):
        plane.ingest(rts[off: off + chunk], cols[off: off + chunk], tab[off: off + chunk])


def make_plane(store, plan, mesh=None, control=None):
    from repro_torch.core.dist_ingest import DistIngestPlane

    return DistIngestPlane.for_store(store, n_tablets=plan["tablets"], n_groups=plan["groups"],
                                     device="cpu", mesh=mesh, control=control, **plan["sizes"])


STATE_FIELDS = ("rev_ts", "cols", "counts", "run_rev_ts", "run_cols", "run_counts",
                "mem_rev_ts", "mem_cols", "mem_counts", "ix_keys", "ix_counts", "ix_run_k",
                "ix_run_n", "ix_mem_k", "ix_mem_n", "ag_keys", "ag_vals", "ag_counts",
                "ag_run_k", "ag_run_c", "ag_run_n", "ag_mem_k", "ag_mem_c", "ag_mem_n")


def subs_of(d):
    return d.groups if d.groups is not None else (d,)


def step_outputs(proc, d, store, plan):
    """The raw outputs of the five steps on every group of snapshot d, as
    numpy arrays keyed '<step>|<case>|g<group>|<output>'."""
    from repro_torch.core import filter as pf
    from repro_torch.core import keypack
    from repro_torch.core.dist_query import (aggregate_step, density_step, index_aggregate_step,
                                             index_step, scan_step)
    from repro_torch.core.iterators import AggregateSpec, resolve_grouping
    from repro_torch.core.planner import plan_query

    out = {}

    def put(prefix, names, tensors):
        for n, t in zip(names, tensors):
            out[f"{prefix}|{n}"] = t.numpy()

    for qi, desc in enumerate(plan["queries"]):
        tree = build_tree(pf, desc)
        program = proc._program(tree, d.device)
        for ri, (t0, t1) in enumerate(plan["ranges"]):
            rts_lo, rts_hi = int(keypack.rev_ts(t1)), int(keypack.rev_ts(t0)) + 1
            qplan = plan_query(proc, tree, t0, t1, w=proc.w)
            for g, sub in enumerate(subs_of(d)):
                put(f"scan|{qi}.{ri}|g{g}", ("count", "ts", "cols"),
                    scan_step(sub, program, rts_lo, rts_hi, plan["top_k"]))
                if qplan.mode != "index":
                    continue
                lo, hi = (torch.from_numpy(x) for x in proc._cond_ranges(qplan, t0, t1))
                for ci, (mp, mr) in enumerate(plan["caps"]):
                    put(f"index|{qi}.{ri}.{ci}|g{g}",
                        ("count", "ts", "cols", "truncated", "candidates"),
                        index_step(sub, program, lo, hi, qplan.combine, plan["top_k"], mp, mr))
            for si, sdesc in enumerate(plan["specs"] if qi == plan["agg_query"] else ()):
                grouping = resolve_grouping(store, spec_of(AggregateSpec, sdesc), t0, t1)
                vt = grouping.value_table if grouping.value_table is not None else np.ones(
                    1, np.int32)
                value_table = torch.from_numpy(vt)
                for g, sub in enumerate(subs_of(d)):
                    put(f"agg|{qi}.{ri}.{si}|g{g}", ("aggs", "cnts"),
                        aggregate_step(sub, program, value_table, grouping, rts_lo, rts_hi))
                    if qplan.mode != "index":
                        continue
                    lo, hi = (torch.from_numpy(x) for x in proc._cond_ranges(qplan, t0, t1))
                    for ci, (mp, mr) in enumerate(plan["caps"]):
                        put(f"ixagg|{qi}.{ri}.{si}.{ci}|g{g}",
                            ("aggs", "cnts", "truncated", "candidates"),
                            index_aggregate_step(sub, program, value_table, grouping, lo, hi,
                                                 qplan.combine, mp, mr))
    for di, (field, value, t0, t1) in enumerate(plan["densities"]):
        code = store.dictionaries[field].lookup(value)
        fid = store.schema.field_id(field)
        for g, sub in enumerate(subs_of(d)):
            lo = int(keypack.pack_agg_key(fid, code, t0 // sub.agg_bucket_s))
            hi = int(keypack.pack_agg_key(fid, code, t1 // sub.agg_bucket_s)) + 1
            out[f"density|{di}|g{g}|total"] = density_step(sub, lo, hi).numpy()
    return out


def scheme_outputs(proc, plan):
    """run_scheme's batches (lo, hi, count, ts, cols) for the four schemes,
    aggregate_range's results and execute_batched's batches, keyed as
    step_outputs keys its arrays."""
    from repro_torch.core import filter as pf
    from repro_torch.core.iterators import AggregateSpec

    out = {}
    for qi, desc in enumerate(plan["queries"]):
        tree = build_tree(pf, desc)
        for scheme in ("scan", "batched_scan", "index", "batched_index"):
            blocks = list(proc.run_scheme(scheme, 0, plan["t_span"], tree))
            out[f"scheme|{qi}|{scheme}|bounds"] = np.array(
                [[b.lo, b.hi, b.count] for b in blocks], np.float64).reshape(-1, 3)
            for bi, b in enumerate(blocks):
                out[f"scheme|{qi}|{scheme}|{bi}|ts"] = b.ts
                out[f"scheme|{qi}|{scheme}|{bi}|cols"] = b.cols
        for si, sdesc in enumerate(plan["specs"] if qi == plan["agg_query"] else ()):
            for use_index in (False, True):
                res = proc.aggregate_range(spec_of(AggregateSpec, sdesc), tree, 0, plan["t_span"],
                                           use_index=use_index)
                for k in ("gids", "values", "counts"):
                    out[f"aggregate_range|{qi}.{si}.{int(use_index)}|{k}"] = getattr(res, k)
    batches = proc.execute_batched(build_tree(pf, plan["queries"][0]), 0, plan["t_span"])
    for bi, (count, ts, cols) in enumerate(batches):
        out[f"execute_batched|{bi}|count"] = np.array(count)
        out[f"execute_batched|{bi}|ts"] = ts
        out[f"execute_batched|{bi}|cols"] = cols
    return out


def local_state(d):
    """This rank's published tablets, keyed 'state|g<group>|<field>'."""
    return {f"state|g{g}|{f}": getattr(sub, f).numpy()
            for g, sub in enumerate(subs_of(d)) for f in STATE_FIELDS}


def sliced_state(d, mesh_d):
    """The meshless snapshot d cut to the tablets the mesh snapshot holds."""
    out = {}
    for g, (sub, msub) in enumerate(zip(subs_of(d), subs_of(mesh_d))):
        lo, hi = msub.tablets
        base = g * sub.rev_ts.shape[0]
        for f in STATE_FIELDS:
            out[f"state|g{g}|{f}"] = getattr(sub, f)[lo - base: hi - base].numpy()
    return out


def mismatches(want, got, where):
    """Names whose arrays differ in key set, dtype, shape or any value."""
    bad = [f"{where}: keys differ: {sorted(set(want) ^ set(got))[:5]}"] \
        if want.keys() != got.keys() else []
    for k in sorted(set(want) & set(got)):
        a, b = np.asarray(want[k]), np.asarray(got[k])
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
            bad.append(f"{where} {k}: {a.dtype}{a.shape} != {b.dtype}{b.shape}")
    return bad


def meshless_equals_mesh(mesh, inputs, plan):
    """The checks of the module docstring for this process group's mesh.
    Returns (mismatches, arrays compared, the mesh snapshot's outputs)."""
    from repro_torch.core import dist_query
    from repro_torch.core.dist_ingest import DistBatchWriter
    from repro_torch.core.dist_query import DistQueryProcessor, from_event_store
    from repro_torch.core.schema import web_proxy_schema
    from repro_torch.core.store import EventStore

    store = EventStore(web_proxy_schema(), device="cpu")
    ts, vals, rts, cols, tab = encoded(store, inputs)
    planes = {name: make_plane(store, plan, m) for name, m in (("plain", None), ("mesh", mesh))}
    outs = {}
    for name, plane in planes.items():
        ingest_sequence(plane, rts, cols, tab, plan)
        d = plane.publish()
        if name == "mesh":
            assert plane.publish() is d, "a clean mesh plane must reuse its snapshot"
        proc = DistQueryProcessor(store, dist=d, top_k=plan["top_k"], device="cpu")
        dist_query.time = types.SimpleNamespace(perf_counter=FakeClock().perf_counter)
        outs[name] = (d, {**step_outputs(proc, d, store, plan), **scheme_outputs(proc, plan)})
    (d_plain, want), (d_mesh, got) = outs["plain"], outs["mesh"]
    bad = mismatches(want, got, "steps")
    bad += mismatches(sliced_state(d_plain, d_mesh), local_state(d_mesh), "state")
    n = len(want) + len(STATE_FIELDS) * len(subs_of(d_mesh))
    if d_mesh.n_tablets != plan["tablets"]:
        bad.append(f"n_tablets {d_mesh.n_tablets}")

    # DistBatchWriter on every rank, and the bulk replay of a host store.
    wplanes = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        wstore = EventStore(web_proxy_schema(), n_shards=2, device="cpu")
        wplanes[name] = (wstore, make_plane(wstore, plan, m))
        w = DistBatchWriter(wstore, wplanes[name][1], batch_rows=500, writer_id=5)
        for off in range(0, len(ts), 700):
            w.add(ts[off: off + 700], {k: v[off: off + 700] for k, v in vals.items()})
        w.close()
        wstore.ingest(ts, vals)
        wstore.flush_all()
    d_w = {k: p.publish() for k, (_, p) in wplanes.items()}
    bad += mismatches(sliced_state(d_w["plain"], d_w["mesh"]), local_state(d_w["mesh"]),
                      "writer")
    # Every rank's writer encoded the same events into the same codes.
    codes = {f: list(dct._rev) for f, dct in wplanes["mesh"][0].dictionaries.items()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, codes)
    if any(c != codes for c in every) or codes != {
            f: list(dct._rev) for f, dct in wplanes["plain"][0].dictionaries.items()}:
        bad.append("writer: the ranks' dictionary codes differ")
    wstore = wplanes["plain"][0]
    r_plain = from_event_store(wstore, n_tablets=plan["tablets"], device="cpu")
    r_mesh = from_event_store(wstore, n_tablets=plan["tablets"], device="cpu", mesh=mesh)
    lo, hi = r_mesh.tablets
    for f in ("rev_ts", "cols", "counts", "ix_keys", "ix_counts", "ag_keys", "ag_vals",
              "ag_counts"):
        a, b = getattr(r_plain, f)[lo:hi], getattr(r_mesh, f)
        if a.dtype != b.dtype or not torch.equal(a, b):
            bad.append(f"replay {f}")
    pq = DistQueryProcessor(wstore, dist=r_plain, device="cpu")
    mq = DistQueryProcessor(wstore, dist=r_mesh, device="cpu")
    from repro_torch.core import filter as pf

    for desc in plan["queries"]:
        tree = build_tree(pf, desc)
        for scheme in ("scan", "batched_index"):
            a = sum(b.count for b in pq.run_scheme(scheme, 0, plan["t_span"], tree))
            b = sum(b.count for b in mq.run_scheme(scheme, 0, plan["t_span"], tree))
            if a != b:
                bad.append(f"replay {scheme} {desc}: {a} != {b}")
    return bad, n, got, d_mesh


def refusals(mesh):
    """The errors a mesh store raises where it cannot run."""
    from repro_torch.core.dist_ingest import DistIngestPlane
    from repro_torch.core.schema import web_proxy_schema
    from repro_torch.core.store import EventStore

    out = {}
    # The mesh as one of another device type than the plane's would be.
    cuda_mesh = types.SimpleNamespace(device_type="cuda", mesh=mesh.mesh,
                                      mesh_dim_names=mesh.mesh_dim_names, size=mesh.size)
    store = EventStore(web_proxy_schema(), device="cpu")
    cases = {
        "wrong_device": lambda: DistIngestPlane(12, 64, n_tablets=8, device="cpu",
                                                mesh=cuda_mesh),
        "indivisible": lambda: DistIngestPlane(12, 64, n_tablets=6, device="cpu", mesh=mesh),
        "groups": lambda: DistIngestPlane(12, 64, tablets_per_device=2, n_groups=4,
                                          device="cpu", mesh=mesh),
        "load_state": lambda: (lambda p: p.load_state(p.state))(
            DistIngestPlane(12, 64, n_tablets=8, device="cpu", mesh=mesh)),
    }
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except (ValueError, RuntimeError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def serve_on_mesh(mesh, inputs, plan):
    """A QueryService on a mesh plane with a control log: rank 0 ingests
    the plan's events and serves one index query of the plan's AND (one
    batch: its range depends on no runtime) through one session, then
    closes the service and the log (its stop record); the other ranks
    follow. Rank 0 also serves it on a meshless plane, and returns both
    services' batches as
    ((lo, hi, count) per batch, sorted ts per batch); a follower returns
    the records it applied."""
    from repro_torch.core import filter as pf
    from repro_torch.core.schema import web_proxy_schema
    from repro_torch.core.spmd import Controller
    from repro_torch.core.store import EventStore
    from repro_torch.serve_db import QueryService

    tree = build_tree(pf, plan["queries"][1])
    out = {}
    for name in ("mesh", "meshless"):
        store = EventStore(web_proxy_schema(), device="cpu")
        _, _, rts, cols, tab = encoded(store, inputs)
        ctl = Controller(store) if name == "mesh" else None
        if ctl is not None and not ctl.leads:
            out["applied"] = ctl.follow(make_plane(store, plan, mesh, ctl))
            return out
        plane = make_plane(store, plan, None if ctl is None else mesh, ctl)
        ingest_sequence(plane, rts, cols, tab, plan)
        with QueryService(store, plane, top_k=plan["top_k"]) as svc:
            s = svc.session("one")
            rbs = s.submit("index", 0, plan["t_span"], tree).drain(timeout=120)
            s.close()
        if ctl is not None:
            ctl.close()  # the followers' stop record
        out[name] = [[[rb.lo, rb.hi, rb.count] for rb in rbs],
                     [sorted(map(int, rb.ts)) for rb in rbs]]
    return out


def _phase(rank, world, store_path, shape, body):
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        from torch.distributed.device_mesh import init_device_mesh

        body(init_device_mesh("cpu", shape, mesh_dim_names=("data", "model")))
    finally:
        dist.destroy_process_group()


def main(rank: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    with open(os.path.join(out_dir, "plan.json")) as f:
        plan = json.load(f)
    res = {}

    def four(mesh):
        bad, n, got, d = meshless_equals_mesh(mesh, inputs, plan)
        res["r4"] = {"mismatches": bad, "compared": n}
        np.savez(os.path.join(out_dir, f"port_rank{rank}.npz"), **got, **local_state(d))
        res["tablets"] = [sub.tablets for sub in subs_of(d)]
        res["refusals"] = refusals(mesh)
        res["serve"] = serve_on_mesh(mesh, inputs, plan)

    _phase(rank, 4, os.path.join(out_dir, "fs4"), (2, 2), four)
    for world, shape in ((2, (1, 2)), (1, (1, 1))):
        if rank >= world:
            break

        def sweep(mesh, world=world):
            bad, n, _, _ = meshless_equals_mesh(mesh, inputs, plan)
            res[f"r{world}"] = {"mismatches": bad, "compared": n}

        _phase(rank, world, os.path.join(out_dir, f"fs{world}"), shape, sweep)
    with open(os.path.join(out_dir, f"port_rank{rank}.json"), "w") as f:
        json.dump(res, f)
