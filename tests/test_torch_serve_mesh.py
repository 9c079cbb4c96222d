"""The port's serve plane on a DeviceMesh: rank 0 the single controller of
a core/spmd.py control log, ranks 1-3 following it, held to the
reference's QueryService on a (data=2, model=2) shard_map plane.

One spawn of four gloo ranks (tests/_torch_serve_mesh_worker.py, 8
tablets in 2 groups, test_torch_store_mesh's PLAN) runs beside one JAX
subprocess on four host devices. Compared with no tolerance and with dtypes:

* deterministic phase (one session, compactor off, a fake clock in both
  packages' dist_query): every ResultBatch (seq, lo, hi, count, ts, cols;
  groups, values and counts of an aggregate) of the four schemes over
  PLAN's queries and ranges, of every spec and of every density, against
  the reference's QueryService and the port's meshless one; every
  follower's steps and calls return rank 0's results;
* concurrent phase (4 session threads, 2 writer threads, compactor on):
  every count and aggregate against the reference's host oracle; every
  rank's tablets (state and published levels) against a meshless plane
  that replays rank 0's recorded log; every rank's dictionaries equal;
* writers alone (4 threads into 2 groups): the same replay, rows
  conserved.

Then the failures (a follower that raises, a rank 0 that stops mid-run:
every rank exits non-zero within the group timeout), the refusals, and
``python -m repro_torch.serve_db --mesh dev`` on two gloo ranks.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
TESTS = str(Path(__file__).resolve().parent)
T_SPAN = 4 * 3600

sys.path.insert(0, TESTS)
try:
    from test_torch_store_mesh import PLAN, _events  # the store-on-a-mesh test's
finally:
    sys.path.remove(TESTS)

REF_SCRIPT = textwrap.dedent(
    """
    import json, os, sys, types
    import numpy as np
    import jax
    from repro.core import AggregateSpec, EventStore, QueryProcessor, keypack, web_proxy_schema
    from repro.core import filter as rf
    from repro.core import dist_query as dq_mod
    from repro.core.dist_ingest import DistIngestPlane
    from repro.serve_db import QueryService

    sys.path.insert(0, sys.argv[2])
    from _torch_store_mesh_worker import FakeClock, build_tree, ingest_sequence, spec_of
    from _torch_serve_mesh_worker import QUERY_STOP, batches_out, det_items, submit_item

    out_dir = sys.argv[1]
    inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    plan = json.load(open(os.path.join(out_dir, "plan.json")))
    ts = inputs["ts"].astype(np.int64)
    vals = {k[2:]: inputs[k].tolist() for k in inputs if k.startswith("v_")}
    store = EventStore(web_proxy_schema())
    cols = store.encode_events(ts, vals)
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    plane = DistIngestPlane.for_store(store, mesh, tablets_per_device=plan["tablets"] // 4,
                                      n_groups=plan["groups"], **plan["sizes"])
    ingest_sequence(plane, keypack.rev_ts(ts).astype(np.int32), cols,
                    inputs["tab"].astype(np.int64), plan)
    dq_mod.time = types.SimpleNamespace(perf_counter=FakeClock().perf_counter)
    svc = QueryService(store, plane, top_k=plan["top_k"], compactor=False)
    s = svc.session("det")
    out = {}
    for i, item in enumerate(det_items(plan)):
        out.update(batches_out(f"det|{i}", submit_item(rf, AggregateSpec, s, plan, item)
                               .drain(timeout=600)))
    s.close()
    svc.close()
    np.savez(os.path.join(out_dir, "ref.npz"), **out)

    # The concurrent phase's host oracle: the seed events, read over
    # [0, QUERY_STOP], which the writers never touch.
    host = EventStore(web_proxy_schema(), n_shards=4)
    host.ingest(ts, vals)
    host.flush_all()
    qp = QueryProcessor(host)
    oracle = {}
    for item in det_items(plan):
        key = json.dumps(item)
        if item[0] == "query":
            tree = build_tree(rf, plan["queries"][item[1]])
            oracle[key] = [sum(b.n for b in qp.run_scheme(item[3], 0, QUERY_STOP, tree)), None]
        elif item[0] == "aggregate":
            res = qp.aggregate(spec_of(AggregateSpec, plan["specs"][item[1]]), 0, QUERY_STOP,
                               build_tree(rf, plan["queries"][plan["agg_query"]]))
            oracle[key] = [int(res.counts.sum()), [res.gids.tolist(), res.values.tolist(),
                                                   res.counts.tolist()]]
        else:
            field, value, _, _ = plan["densities"][item[1]]
            oracle[key] = [int(host.agg_count(field, value, 0, QUERY_STOP)), None]
    json.dump(oracle, open(os.path.join(out_dir, "oracle.json"), "w"))
    print("REF_OK", flush=True)
    """
)


def _worker():
    sys.path.insert(0, TESTS)
    try:
        import _torch_serve_mesh_worker as worker
    finally:
        sys.path.remove(TESTS)
    return worker


def _spawn(target, args, n, timeout):
    """n spawned processes running target(rank, *args); their exit codes
    (None for one killed at the timeout) and the seconds until the last
    ended."""
    ctx = mp.get_context("spawn")
    sys.path.insert(0, TESTS)  # the children import the worker by name
    try:
        procs = [ctx.Process(target=target, args=(r, *args)) for r in range(n)]
        t0 = time.monotonic()
        for p in procs:
            p.start()
    finally:
        sys.path.remove(TESTS)
    for p in procs:
        p.join(max(0.0, t0 + timeout - time.monotonic()))
    secs = time.monotonic() - t0
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    return codes, secs


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The four ranks' phases beside the reference's subprocess: exit
    codes, each rank's JSON and the reference's arrays and oracle."""
    out = tmp_path_factory.mktemp("serve_mesh")
    ts, vals, tab = _events(27, 8000)
    np.savez(out / "inputs.npz", ts=ts, tab=tab, **{f"v_{k}": v for k, v in vals.items()})
    (out / "plan.json").write_text(json.dumps(PLAN))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + TESTS,
               XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(out), TESTS], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        codes, _ = _spawn(_worker().main, (str(out),), 4, timeout=400)
    except BaseException:
        ref.kill()
        ref.communicate()
        raise
    stdout, stderr = ref.communicate(timeout=600)
    assert ref.returncode == 0 and "REF_OK" in stdout, stderr[-3000:]
    assert codes == [0, 0, 0, 0], f"exit codes {codes}"
    infos = [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]
    return out, codes, infos, dict(np.load(out / "ref.npz")), json.loads(
        (out / "oracle.json").read_text())


def _equal(want, got, where):
    assert want.keys() == got.keys(), f"{where}: keys differ {sorted(set(want) ^ set(got))[:5]}"
    for k in sorted(want):
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, f"{where} {k}: {a.dtype}{a.shape} " \
                                                          f"!= {b.dtype}{b.shape}"
        np.testing.assert_array_equal(a, b, err_msg=f"{where} {k}")


@pytest.mark.parametrize("kind", ["query", "aggregate", "density"])
def test_det_batches_equal_reference_and_meshless(mesh_run, kind):
    out, _, _, ref, _ = mesh_run
    rank0 = dict(np.load(out / "det_rank0.npz"))
    items = _worker().det_items(PLAN)
    idx = [i for i, it in enumerate(items) if it[0] == kind]
    assert idx
    for i in idx:
        pre = f"det|{i}|"
        want = {k: v for k, v in ref.items() if k.startswith(pre)}
        _equal(want, {k: v for k, v in rank0.items() if k.startswith(pre)}, f"mesh {items[i]}")
        _equal(want, {k[len("meshless|"):]: v for k, v in rank0.items()
                      if k.startswith("meshless|" + pre)}, f"meshless {items[i]}")
    if kind == "query":  # some batched query took more than one batch
        assert any(int(ref[f"det|{i}|n"]) > 1 for i in idx)
        assert any(int(ref[f"det|{i}|0|head"][3]) > 0 for i in idx)


def test_followers_return_rank0_results(mesh_run):
    out, _, infos, _, _ = mesh_run
    rank0 = dict(np.load(out / "det_rank0.npz"))
    want = {k: v for k, v in rank0.items() if k.startswith("r|")}
    assert len(want) > 100
    for r in range(1, 4):
        _equal(want, dict(np.load(out / f"det_rank{r}.npz")), f"rank {r}")
        assert infos[r]["det"]["applied"] > 0


def test_concurrent_counts_equal_host_oracle(mesh_run):
    _, _, infos, _, oracle = mesh_run
    counts = infos[0]["concurrent"]["counts"]
    assert len(counts) == 4
    n = 0
    for session in counts:
        for item, count, agg in session:
            want_count, want_agg = oracle[json.dumps(item)]
            assert count == want_count, (item, count, want_count)
            assert agg == want_agg, item
            n += 1
    assert n > 100


def _replayed(log_name, out):
    from repro_torch.core.dist_ingest import DistIngestPlane
    from repro_torch.core.schema import web_proxy_schema
    from repro_torch.core.store import EventStore

    with open(out / log_name, "rb") as f:
        records = pickle.load(f)
    plane = DistIngestPlane.for_store(EventStore(web_proxy_schema(), device="cpu"),
                                      n_tablets=PLAN["tablets"], n_groups=PLAN["groups"],
                                      device="cpu", **PLAN["sizes"])
    _worker().replay(records, plane)
    return records, plane


def _held_to_replay(plane, got, rank):
    """Rank ``rank``'s group states and published levels against the
    replayed meshless plane's slice of them."""
    tl = PLAN["tablets"] // PLAN["groups"] // 4
    sl = slice(rank * tl, (rank + 1) * tl)
    n = 0
    for g in plane.groups:
        want = {f"state|g{g.gid}|{k}": v[sl].numpy() for k, v in g.state.items()}
        want.update({f"pub|g{g.gid}|{f}": getattr(g._published, f)[sl].numpy()
                     for f in _worker().STATE_FIELDS})
        _equal(want, {k: got[k] for k in want}, f"rank {rank} group {g.gid}")
        n += len(want)
    return n


@pytest.mark.parametrize("phase", ["conc", "alone"])
def test_every_rank_equals_a_replay_of_rank0_log(mesh_run, phase):
    out, _, infos, _, _ = mesh_run
    records, plane = _replayed("log.pkl" if phase == "conc" else "alone_log.pkl", out)
    kinds = {r.kind for r in records}
    assert {"append", "snap", "publish"} <= kinds
    if phase == "conc":
        assert {"run", "step", "call", "compact_step"} <= kinds
    ranks = [dict(np.load(out / f"{phase}_rank{r}.npz")) for r in range(4)]
    assert all(_held_to_replay(plane, ranks[r], r) > 50 for r in range(4))
    # Rows conserved: the seed and every writer's events, spread over the ranks.
    info = infos[0]["concurrent" if phase == "conc" else "alone"]
    written = 2 * 2400 if phase == "conc" else 4 * 1500
    seed = 8000 if phase == "conc" else 0
    assert sum(int(r["rows"]) for r in ranks) == seed + written
    assert int(plane.telemetry()["rows"].sum()) == seed + written
    assert all(i["concurrent" if phase == "conc" else "alone"]["dicts_equal"] for i in infos)
    if phase == "conc":
        assert info["drained"] and info["background_folds"] > 0
        assert not info["kept_first_snapshot"]


def test_log_carries_new_dictionary_entries(mesh_run):
    out, _, infos, _, _ = mesh_run
    records, _ = _replayed("log.pkl", out)
    grown = [r for r in records if r.dicts and "bytes_in" in r.dicts]
    assert len(grown) > 1
    # Entries arrive in code order, each record starting where the last ended.
    nxt = None
    for r in grown:
        first, values = r.dicts["bytes_in"]
        assert nxt is None or first == nxt
        nxt = first + len(values)
    assert nxt == infos[0]["concurrent"]["dict_sizes"]["bytes_in"]


@pytest.mark.parametrize("case, words", [
    ("follow_on_rank0", "rank 0 leads"), ("lockstep_service", "control log"),
    ("service", "follows rank 0"), ("writer", "writers run on rank 0"),
    ("processor", "builds no processor"), ("ingest", "only rank 0 drives"),
    ("compact_step", "only rank 0 drives")])
def test_refusals(mesh_run, case, words):
    _, _, infos, _, _ = mesh_run
    ranks = [0] if case in ("follow_on_rank0", "lockstep_service") else [1, 2, 3]
    for r in ranks:
        msg = infos[r]["det"]["refusals"][case]
        assert msg is not None and words in msg, (r, msg)


def test_a_tree_too_deep_fails_its_stream_and_leaves_the_log_live(mesh_run):
    _, _, infos, _, _ = mesh_run
    conc = infos[0]["concurrent"]
    assert conc["deep"] is not None and "too deep" in conc["deep"], conc["deep"]
    assert conc["deep_logged"] == [] and conc["deep_live"]
    # The queries after it ran on every rank, and every rank exited 0.
    assert len(conc["counts"]) == 4 and all(infos[r]["concurrent"]["applied"] > 0
                                             for r in range(1, 4))


def test_clean_close_exits_zero_everywhere(mesh_run):
    _, codes, infos, _, _ = mesh_run
    assert codes == [0, 0, 0, 0]
    assert all(infos[r]["concurrent"]["applied"] > 0 for r in range(1, 4))


@pytest.mark.parametrize("mode", ["follower", "leader"])
def test_a_failure_ends_every_rank(tmp_path, mode):
    (tmp_path / "plan.json").write_text(json.dumps(PLAN))
    codes, secs = _spawn(_worker().fail_main, (str(tmp_path), mode), 4, timeout=90)
    assert None not in codes, f"a rank hung: {codes}"
    assert all(c != 0 for c in codes), f"exit codes {codes}"
    status = [json.loads((tmp_path / f"fail_{mode}_rank{r}.json").read_text()) for r in range(4)]
    # Every rank got to its part and raised there: none failed in set-up.
    assert [s["stage"] for s in status] == ["leading"] + ["following"] * 3, status
    assert all(s["error"] for s in status), status
    first = status[2] if mode == "follower" else status[0]
    assert ("injected follower failure" if mode == "follower" else "stops mid-run") \
        in first["error"]


def test_daemon_mesh_dev_on_two_ranks(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=SRC, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.serve_db", "--mesh", "dev", "--device", "cpu",
             "--duration", "1.5", "--rows", "1200", "--sessions", "2", "--writers", "1",
             "--groups", "2", "--tablets-per-device", "2",
             "--incident-dir", str(tmp_path / "inc")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=180) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    assert "METRICS_URL=http://127.0.0.1:" in outs[0][0] and "daemon:" in outs[0][0]
    assert "followed" in outs[1][0] and "METRICS_URL" not in outs[1][0]


# ---------------------------------------------------- host-only pieces
def test_capped_dictionary_is_the_dictionary_cut():
    from repro_torch.core.schema import FieldDictionary
    from repro_torch.core.spmd import CappedDictionary

    d = FieldDictionary("domain")
    for v in ("a.com", "b.com", "ab.net", "c.com", "a.org"):
        d.encode(v)
    cut = CappedDictionary(d, 3)
    assert len(cut) == 3 and cut.lookup("ab.net") == 2 and cut.lookup("c.com") is None
    assert cut.lookup("never") is None and cut.decode_many([0, 2]) == ["a.com", "ab.net"]
    np.testing.assert_array_equal(cut.prefix_codes("a"), [0, 2])
    assert cut._fwd == {"a.com": 0, "b.com": 1, "ab.net": 2} and cut._rev == d._rev[:3]
    with pytest.raises(IndexError):
        cut.decode(3)
    whole = CappedDictionary(d, len(d))
    np.testing.assert_array_equal(whole.prefix_codes("a"), d.prefix_codes("a"))
    assert whole._fwd == d._fwd


def test_store_view_compiles_programs_on_the_cut():
    from repro_torch.core import Eq, In, Match
    from repro_torch.core.filter import compile_tree
    from repro_torch.core.schema import web_proxy_schema
    from repro_torch.core.spmd import StoreView
    from repro_torch.core.store import EventStore

    store = EventStore(web_proxy_schema(), device="cpu")
    store.encode_events(np.arange(3), {"domain": ["a.com", "b.com", "a.net"]})
    lens = {f: len(d) for f, d in store.dictionaries.items()}
    store.encode_events(np.arange(1), {"domain": ["a.new"]})  # after the cut
    view = StoreView(store, lens, rps=2.5)
    assert view.rows_per_second() == 2.5 and view.schema is store.schema
    for tree in (Eq("domain", "a.new"), In("domain", ("a.new", "b.com")), Match("domain", "a.")):
        got = compile_tree(view, tree)
        cut = EventStore(web_proxy_schema(), device="cpu")
        cut.encode_events(np.arange(3), {"domain": ["a.com", "b.com", "a.net"]})
        want = compile_tree(cut, tree)
        for f in ("opcodes", "arg0", "arg1", "codesets"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_own_rows_cut_a_batch_by_rank():
    from repro_torch.core.spmd import _own_rows

    rng = np.random.default_rng(0)
    tab = rng.integers(0, 8, 50)
    rts = np.arange(50, dtype=np.int32)
    cols = rng.integers(0, 9, (50, 3)).astype(np.int32)
    whole = _own_rows(rts, cols, tab, 0, 8, 16, whole=True)
    np.testing.assert_array_equal(whole[2], [0, 16, 32, 48, 50])
    parts = [_own_rows(rts, cols, tab, lo, 2, 16) for lo in range(0, 8, 2)]
    assert sum(len(p[0]) for p in parts) == 50
    for lo, (packed, t, starts) in zip(range(0, 8, 2), parts):
        mine = (tab >= lo) & (tab < lo + 2)
        np.testing.assert_array_equal(packed[:, 0], rts[mine])
        np.testing.assert_array_equal(packed[:, 1:], cols[mine])
        np.testing.assert_array_equal(t, tab[mine] - lo)
        np.testing.assert_array_equal(starts, [np.sum(mine[:k]) for k in (0, 16, 32, 48, 50)])


def test_a_control_log_needs_a_mesh_plane():
    from repro_torch.core.dist_ingest import DistIngestPlane

    with pytest.raises(ValueError, match="drives a mesh plane"):
        DistIngestPlane(12, 64, n_tablets=2, device="cpu", control=object())
