"""The port's store on a DeviceMesh held to the reference's shard_map
store on a (data=2, model=2) mesh.

The same seeded events (pre-encoded, with tablet ids) go through the same
calls in both packages: appends in chunks (minors and blocking majors
trip), compact_step increments, more appends, publish(). The reference
runs on four host devices in a JAX subprocess
(--xla_force_host_platform_device_count=4); the port runs as four gloo
ranks (tests/_torch_store_mesh_worker.py, one spawn for the module), each
a tablet server of 2 of the 8 tablets, in 2 tablet groups. Compared with
no tolerance and with dtypes:

* every rank's published tablets (base, runs and sealed memtable of the
  event, index and aggregate families) against the reference's global
  arrays at the rank's global tablet ids, the reference's row-major
  device order (the event family's base count as ROADMAP §3 fact 2 says:
  values, the port's dtype int32);
* the raw outputs of scan_step and index_step (counts, truncation,
  candidates and the per-tablet slates, tablet for tablet, at two slab
  caps, the smaller truncating), density_step, and aggregate_step and
  index_aggregate_step for count, sum, min and max (empty groups keep
  their identities), on every group;
* run_scheme's batches for the four schemes (ranges, counts, rows) with
  a fake clock in both packages' dist_query, so the adaptive batches
  depend on the calls made, aggregate_range on scan and index plans, and
  execute_batched.

Every rank must return the same global results. The workers also check
the port alone: meshless equals mesh for R = 4, 2 and 1, the ranks'
dictionary codes, the refusals, and a QueryService on the mesh plane
with a control log (rank 0 serving, ranks 1-3 following) answering as
on the meshless plane. Last, a fake-world run_store_cell in
a subprocess: its argument bytes per device equal the slabs'.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
TESTS = str(Path(__file__).resolve().parent)
T_SPAN = 4 * 3600
N_EVENTS = 8000
STATE_FIELDS = ("rev_ts", "cols", "counts", "run_rev_ts", "run_cols", "run_counts",
                "mem_rev_ts", "mem_cols", "mem_counts", "ix_keys", "ix_counts", "ix_run_k",
                "ix_run_n", "ix_mem_k", "ix_mem_n", "ag_keys", "ag_vals", "ag_counts",
                "ag_run_k", "ag_run_c", "ag_run_n", "ag_mem_k", "ag_mem_c", "ag_mem_n")
PLAN = {
    "tablets": 8, "groups": 2,
    "sizes": {"capacity": 2048, "mem_rows": 128, "max_runs": 3, "append_rows": 128},
    "first": 6500, "chunk": 500, "compact_steps": 3,
    "queries": [["eq", "domain", "c.com"],
                ["and", ["eq", "domain", "b.com"], ["eq", "status", "404"]],
                ["or", ["eq", "domain", "c.com"], ["eq", "domain", "rare.net"]]],
    "ranges": [[0, T_SPAN], [1800, 5400]],
    "caps": [[2048, 4096], [16, 24]],  # (index postings, index rows); the second truncates
    "agg_query": 1,  # the query the aggregation specs run on (an index plan)
    "specs": [{"group_by": ["status"], "op": "count", "time_bucket_s": 3600},
              {"group_by": ["method"], "op": "sum", "value_field": "bytes_in"},
              {"group_by": ["domain"], "op": "min", "value_field": "bytes_out"},
              {"group_by": ["domain"], "op": "max", "value_field": "bytes_out"}],
    "densities": [["domain", "a.com", 0, T_SPAN], ["status", "404", 1800, 5400],
                  ["domain", "rare.net", 0, 3600]],
    "top_k": 16, "t_span": T_SPAN,
}

REF_SCRIPT = textwrap.dedent(
    """
    import json, os, sys, types
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.core import AggregateSpec, EventStore, keypack, web_proxy_schema
    from repro.core import filter as rf
    from repro.core import dist_query as dq_mod
    from repro.core.dist_ingest import DistIngestPlane
    from repro.core.dist_query import DistQueryProcessor, build_density_step
    from repro.core.filter import compile_tree
    from repro.core.iterators import resolve_grouping
    from repro.core.planner import plan_query
    from repro.kernels.filter_scan.ops import pad_program

    sys.path.insert(0, sys.argv[2])
    from _torch_store_mesh_worker import FakeClock, build_tree, ingest_sequence, spec_of

    out_dir = sys.argv[1]
    inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    plan = json.load(open(os.path.join(out_dir, "plan.json")))
    fields = json.loads(sys.argv[3])
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    store = EventStore(web_proxy_schema())
    ts = inputs["ts"].astype(np.int64)
    vals = {k[2:]: inputs[k].tolist() for k in inputs if k.startswith("v_")}
    cols = store.encode_events(ts, vals)
    rts = keypack.rev_ts(ts).astype(np.int32)
    plane = DistIngestPlane.for_store(store, mesh, tablets_per_device=plan["tablets"] // 4,
                                      n_groups=plan["groups"], **plan["sizes"])
    ingest_sequence(plane, rts, cols, inputs["tab"].astype(np.int64), plan)
    d = plane.publish()
    subs = d.groups if d.groups is not None else (d,)
    # One processor per slab cap; their step caches serve the schemes too.
    procs = [DistQueryProcessor(store, dist=d, top_k=plan["top_k"], index_postings=mp,
                                index_rows=mr) for mp, mr in plan["caps"]]
    proc = procs[0]
    out = {}
    for g, sub in enumerate(subs):
        for f in fields:
            out[f"state|g{g}|{f}"] = np.asarray(getattr(sub, f))

    def put(prefix, names, arrays):
        for n, a in zip(names, arrays):
            out[f"{prefix}|{n}"] = np.asarray(a)

    def spec(s):
        return spec_of(AggregateSpec, s)

    for qi, desc in enumerate(plan["queries"]):
        tree = build_tree(rf, desc)
        prog = compile_tree(store, tree)
        opc, a0, a1, cs = (jnp.asarray(x) for x in pad_program(prog))
        pargs = (opc, a0, a1, cs)
        for ri, (t0, t1) in enumerate(plan["ranges"]):
            rts_lo, rts_hi = int(keypack.rev_ts(t1)), int(keypack.rev_ts(t0)) + 1
            qplan = plan_query(proc, tree, t0, t1, w=proc.w)
            for g, sub in enumerate(subs):
                step, _ = proc._step(prog, sub)
                ev = (sub.rev_ts, sub.cols, sub.counts) + proc._ev_levels(sub)
                put(f"scan|{qi}.{ri}|g{g}", ("count", "ts", "cols"),
                    step(*ev, *pargs, jnp.int32(rts_lo), jnp.int32(rts_hi)))
                if qplan.mode != "index":
                    continue
                lo, hi = (jnp.asarray(x) for x in proc._cond_ranges(qplan, t0, t1))
                n_conds = len(qplan.index_conds)
                for ci, cproc in enumerate(procs):
                    step, _ = cproc._index_step(prog, n_conds, qplan.combine, sub)
                    put(f"index|{qi}.{ri}.{ci}|g{g}",
                        ("count", "ts", "cols", "truncated", "candidates"),
                        step(*proc._index_args(sub), *pargs, lo, hi))
            if qi != plan["agg_query"]:
                continue
            for si, sdesc in enumerate(plan["specs"]):
                gr = resolve_grouping(store, spec(sdesc), t0, t1)
                vt = jnp.asarray(gr.value_table if gr.value_table is not None
                                 else np.ones(1, np.int32))
                for g, sub in enumerate(subs):
                    step, _ = proc._agg_step(prog, gr, sub)
                    ev = (sub.rev_ts, sub.cols, sub.counts) + proc._ev_levels(sub)
                    put(f"agg|{qi}.{ri}.{si}|g{g}", ("aggs", "cnts"),
                        step(*ev, *pargs, vt, jnp.int32(rts_lo), jnp.int32(rts_hi),
                             jnp.int32(gr.bucket_lo)))
                    if qplan.mode != "index":
                        continue
                    lo, hi = (jnp.asarray(x) for x in proc._cond_ranges(qplan, t0, t1))
                    n_conds = len(qplan.index_conds)
                    for ci, cproc in enumerate(procs):
                        step, _ = cproc._index_agg_step(prog, gr, n_conds, qplan.combine, sub)
                        put(f"ixagg|{qi}.{ri}.{si}.{ci}|g{g}",
                            ("aggs", "cnts", "truncated", "candidates"),
                            step(*proc._index_args(sub), *pargs, vt, lo, hi,
                                 jnp.int32(gr.bucket_lo)))
    density = build_density_step(mesh, runs=True)
    for di, (field, value, t0, t1) in enumerate(plan["densities"]):
        code = store.dictionaries[field].lookup(value)
        fid = store.schema.field_id(field)
        for g, sub in enumerate(subs):
            lo = int(keypack.pack_agg_key(fid, code, t0 // sub.agg_bucket_s))
            hi = int(keypack.pack_agg_key(fid, code, t1 // sub.agg_bucket_s)) + 1
            out[f"density|{di}|g{g}|total"] = np.asarray(density(
                sub.ag_keys, sub.ag_vals, *proc._ag_levels(sub), jnp.int64(lo), jnp.int64(hi)))

    dq_mod.time = types.SimpleNamespace(perf_counter=FakeClock().perf_counter)
    for qi, desc in enumerate(plan["queries"]):
        tree = build_tree(rf, desc)
        for scheme in ("scan", "batched_scan", "index", "batched_index"):
            blocks = list(proc.run_scheme(scheme, 0, plan["t_span"], tree))
            out[f"scheme|{qi}|{scheme}|bounds"] = np.array(
                [[b.lo, b.hi, b.count] for b in blocks], np.float64).reshape(-1, 3)
            for bi, b in enumerate(blocks):
                out[f"scheme|{qi}|{scheme}|{bi}|ts"] = b.ts
                out[f"scheme|{qi}|{scheme}|{bi}|cols"] = b.cols
        for si, sdesc in enumerate(plan["specs"] if qi == plan["agg_query"] else ()):
            for use_index in (False, True):
                res = proc.aggregate_range(spec(sdesc), tree, 0, plan["t_span"],
                                           use_index=use_index)
                for k in ("gids", "values", "counts"):
                    out[f"aggregate_range|{qi}.{si}.{int(use_index)}|{k}"] = getattr(res, k)
    batches = proc.execute_batched(build_tree(rf, plan["queries"][0]), 0, plan["t_span"])
    for bi, (count, ts_b, cols_b) in enumerate(batches):
        out[f"execute_batched|{bi}|count"] = np.array(count)
        out[f"execute_batched|{bi}|ts"] = ts_b
        out[f"execute_batched|{bi}|cols"] = cols_b
    tel = plane.telemetry()
    out["telemetry|minor"] = np.asarray(tel["minor"])
    out["telemetry|major"] = np.asarray(tel["major"])
    out["telemetry|fold_events"] = np.array(sorted(tel["fold_events"].items()), dtype=object)
    np.savez(os.path.join(out_dir, "ref.npz"), **{k: v for k, v in out.items()
                                                   if v.dtype != object})
    json.dump({"fold_events": tel["fold_events"]}, open(os.path.join(out_dir, "ref.json"), "w"))
    print("REF_OK", flush=True)
    """
)


def _events(seed, n):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, T_SPAN, n))
    vals = {
        "domain": rng.choice(["a.com", "b.com", "c.com", "rare.net"], p=[0.55, 0.25, 0.17, 0.03],
                             size=n),
        "method": rng.choice(["GET", "POST", "PUT"], size=n),
        "status": rng.choice(["200", "404"], size=n, p=[0.8, 0.2]),
        "bytes_in": rng.integers(1 << 20, 1 << 21, n).astype(str),
        "bytes_out": rng.integers(10, 5000, n).astype(str),
    }
    return ts, vals, rng.integers(0, PLAN["tablets"], n)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """One spawn of the four gloo ranks beside one JAX subprocess: the
    port's arrays per rank, its JSON per rank, and the reference's arrays."""
    out = tmp_path_factory.mktemp("store_mesh")
    ts, vals, tab = _events(26, N_EVENTS)
    np.savez(out / "inputs.npz", ts=ts, tab=tab, **{f"v_{k}": v for k, v in vals.items()})
    (out / "plan.json").write_text(json.dumps(PLAN))
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(out), TESTS,
                            json.dumps(STATE_FIELDS)], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    import torch.multiprocessing as mp

    sys.path.insert(0, TESTS)
    try:
        import _torch_store_mesh_worker as worker
    finally:
        sys.path.remove(TESTS)
    try:
        mp.spawn(worker.main, args=(str(out),), nprocs=4)
    except BaseException:
        ref.kill()
        ref.communicate()
        raise
    stdout, stderr = ref.communicate(timeout=600)
    assert ref.returncode == 0 and "REF_OK" in stdout, stderr[-3000:]
    ports = [dict(np.load(out / f"port_rank{r}.npz")) for r in range(4)]
    infos = [json.loads((out / f"port_rank{r}.json").read_text()) for r in range(4)]
    return ports, infos, dict(np.load(out / "ref.npz")), json.loads((out / "ref.json").read_text())


def _global(ports, infos, key):
    """The reference's global layout of a per-tablet state array: each
    rank's tablets at their global ids within the group."""
    g = int(key.split("|")[1][1:])
    per_rank = sorted(((infos[r]["tablets"][g][0], ports[r][key]) for r in range(4)),
                      key=lambda x: x[0])
    return np.concatenate([a for _, a in per_rank])


def test_ranks_hold_the_reference_tablet_layout(mesh_run):
    _, infos, _, _ = mesh_run
    # Group g holds global tablets [4g, 4g + 4); rank r (row-major over
    # (data, model)) the one at 4g + r.
    for r, info in enumerate(infos):
        assert info["tablets"] == [[r, r + 1], [4 + r, 4 + r + 1]]


def test_ingest_tripped_minors_majors_and_folds(mesh_run):
    _, _, ref, ref_info = mesh_run
    assert ref["telemetry|minor"].min() > 0 and ref["telemetry|major"].min() > 0
    assert ref_info["fold_events"].get("ingest", 0) > 0
    assert ref_info["fold_events"].get("explicit", 0) == PLAN["compact_steps"]


@pytest.mark.parametrize("field", STATE_FIELDS)
def test_published_state_matches_reference(mesh_run, field):
    ports, infos, ref, _ = mesh_run
    for g in range(PLAN["groups"]):
        key = f"state|g{g}|{field}"
        got, want = _global(ports, infos, key), ref[key]
        if field == "counts":  # ROADMAP §3 fact 2: the reference's count drifts to int64
            assert got.dtype == np.int32
            want = want.astype(np.int32)
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("step", ["scan", "index", "density", "agg", "ixagg"])
def test_steps_match_reference_tablet_for_tablet(mesh_run, step):
    ports, _, ref, _ = mesh_run
    keys = sorted(k for k in ref if k.startswith(step + "|"))
    assert keys and keys == sorted(k for k in ports[0] if k.startswith(step + "|"))
    for key in keys:
        got, want = ports[0][key], ref[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)
        for r in range(1, 4):  # every rank returns the global result
            np.testing.assert_array_equal(ports[r][key], got, err_msg=f"rank {r} {key}")
    if step in ("index", "ixagg"):  # the small caps truncate
        assert any(ref[k] > 0 for k in keys if k.endswith("|truncated"))
        assert any(ref[k] == 0 for k in keys if k.endswith("|truncated"))
    if step == "agg":  # empty groups keep the identities
        mins = [ref[k] for k in keys if k.split("|")[1].split(".")[2] == "2" and "aggs" in k]
        assert any((a == np.iinfo(np.int32).max).any() for a in mins)


@pytest.mark.parametrize("what", ["scheme", "aggregate_range", "execute_batched"])
def test_schemes_match_reference(mesh_run, what):
    ports, _, ref, _ = mesh_run
    keys = sorted(k for k in ref if k.startswith(what + "|"))
    assert keys and keys == sorted(k for k in ports[0] if k.startswith(what + "|"))
    for key in keys:
        got, want = ports[0][key], ref[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)
        for r in range(1, 4):
            np.testing.assert_array_equal(ports[r][key], got, err_msg=f"rank {r} {key}")
    if what == "scheme":  # some batched run took more than one batch
        assert any(ref[k].shape[0] > 1 for k in keys if k.endswith("|bounds"))


@pytest.mark.parametrize("ranks", ["r4", "r2", "r1"])
def test_meshless_equals_mesh(mesh_run, ranks):
    _, infos, _, _ = mesh_run
    world = int(ranks[1:])
    for r in range(world):
        got = infos[r][ranks]
        assert got["compared"] > 100 and got["mismatches"] == [], got["mismatches"][:10]


@pytest.mark.parametrize("case, words", [
    ("wrong_device", "device type"), ("indivisible", "does not divide"),
    ("groups", "must divide tablets_per_device"), ("load_state", "meshless")])
def test_mesh_store_refusals(mesh_run, case, words):
    _, infos, _, _ = mesh_run
    for info in infos:
        assert info["refusals"][case] is not None and words in info["refusals"][case]


def test_mesh_query_service_serves(mesh_run):
    """A QueryService serves a mesh plane built with a control log: rank 0
    answers one query as the meshless plane's service does, batch for
    batch, and closes; ranks 1-3 follow its log to the stop record."""
    _, infos, _, _ = mesh_run
    got = infos[0]["serve"]
    assert got["mesh"] == got["meshless"] and sum(b[2] for b in got["mesh"][0]) > 0
    assert all(infos[r]["serve"]["applied"] > 0 for r in range(1, 4))


STORE_CELL = textwrap.dedent(
    """
    import json, sys
    from repro_torch.launch.dryrun import fake_world, run_store_cell
    with fake_world(256):
        rec = run_store_cell("single_pod", rows_per_tablet=int(sys.argv[1]))
    print("CELL " + json.dumps(rec))
    """
)


def test_store_cell_argument_bytes_are_the_slabs():
    rows = 50_000
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", STORE_CELL, str(rows)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads([l for l in proc.stdout.splitlines() if l.startswith("CELL ")][0][5:])
    assert rec["arch"] == "llcysa-store" and rec["n_chips"] == 256 and rec["kind"] == "scan"
    assert rec["memory"]["argument_bytes"] == rows * (4 + 4 * 12) + 4
    assert rec["collectives"]["total_bytes"] > 0
    assert set(rec["collectives"]["bytes_by_op"]) == {"all-reduce", "all-gather"}
    charge = rec["filter_scan_charge"]
    assert charge["bytes"] == rows * (4 * 12 + 1) and charge["flops"] == 0
