"""The port's sharded ingest plane (n_groups tablet groups, a lock each)
against its single-group oracle and the JAX package's sharded plane.

W threaded writers over G groups must give the same database as one
serial writer over one group: every scan count, the five aggregate
specs and the index path's hits. A serial G = 4 ingest must leave every
group's state equal to the JAX plane's group for group, bit for bit, and
both planes must pick the same group at every compact_step. Then the
facade's seams: composite aliasing, the per-tablet gauges, per-writer
blocked seconds, the most-indebted pick, validation, and the kernels'
launch counters under threads.
"""
import threading

import numpy as np
import pytest

from repro.core import EventStore as JaxEventStore, web_proxy_schema as jax_schema
from repro.core.dist_ingest import DistIngestPlane as JaxPlane
from repro.launch.mesh import make_dev_mesh

from repro_torch.core import AggregateSpec, And, Cmp, Eq, Not, Or, keypack
from repro_torch.core.dist_ingest import DistBatchWriter, DistIngestPlane, check_tablet_guidance
from repro_torch.core.dist_query import DistQueryProcessor, QueryRun
from repro_torch.core.schema import web_proxy_schema
from repro_torch.core.store import EventStore
from repro_torch.kernels import common

T_SPAN = 4 * 3600
TABLETS = 4  # divisible by 1, 2 and 4


def _events(seed, n):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, T_SPAN, n))
    vals = {
        "domain": rng.choice(["a.com", "b.com", "c.com"], p=[0.6, 0.3, 0.1], size=n).tolist(),
        "method": rng.choice(["GET", "POST"], size=n).tolist(),
        "status": rng.choice(["200", "404"], size=n).tolist(),
        "bytes_out": rng.integers(10, 5000, size=n).astype(str).tolist(),
    }
    return ts, vals


def _encoded(store, seed, n):
    """One pre-encoded, pre-assigned stream (rts, cols, global tablet ids),
    the same rows for every plane, and its events for the oracle masks."""
    ts, vals = _events(seed, n)
    cols = store.encode_events(np.asarray(ts, np.int64), vals)
    rts = keypack.rev_ts(np.asarray(ts, np.int64)).astype(np.int32)
    tab = np.random.default_rng(seed + 1).integers(0, TABLETS, n).astype(np.int32)
    return rts, cols, tab, ts, {k: np.array(v) for k, v in vals.items()}


def _plane(store, n_groups, capacity=20_000, mem_rows=256, max_runs=2):
    return DistIngestPlane.for_store(store, capacity=capacity, n_tablets=TABLETS,
                                     mem_rows=mem_rows, max_runs=max_runs, append_rows=128,
                                     n_groups=n_groups, device="cpu")


def _threaded_ingest(plane, rts, cols, tab, n_writers, chunk=None):
    """W real threads, each appending an interleaved slice of the stream
    (in chunks when given)."""
    def work(i):
        sl = slice(i, None, n_writers)
        r, c, t = rts[sl], cols[sl], tab[sl]
        step = chunk or len(r)
        for off in range(0, len(r), step):
            plane.ingest(r[off: off + step], c[off: off + step], t[off: off + step],
                         writer_id=i)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n_writers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)


TREES = [
    (Eq("domain", "c.com"), lambda v: v["domain"] == "c.com"),
    (And(Eq("domain", "b.com"), Not(Eq("method", "POST"))),
     lambda v: (v["domain"] == "b.com") & (v["method"] != "POST")),
    (Or(Eq("status", "404"), Eq("domain", "c.com")),
     lambda v: (v["status"] == "404") | (v["domain"] == "c.com")),
    (And(Eq("domain", "a.com"), Cmp("bytes_out", "<", 1000)),
     lambda v: (v["domain"] == "a.com") & (v["bytes_out"].astype(int) < 1000)),
]

AGG_SPECS = [
    AggregateSpec(group_by=("status",), time_bucket_s=3600),
    AggregateSpec(group_by=("domain", "method")),
    AggregateSpec(group_by=("domain",), op="sum", value_field="bytes_out"),
    AggregateSpec(group_by=("status",), op="min", value_field="bytes_out"),
    AggregateSpec(group_by=("status",), op="max", value_field="bytes_out"),
]


def _same_result(a, b):
    return all(np.array_equal(getattr(a, k), getattr(b, k)) and
               getattr(a, k).dtype == getattr(b, k).dtype for k in ("gids", "values", "counts"))


@pytest.mark.parametrize("n_groups", [2, 4])
@pytest.mark.parametrize("n_writers", [2, 3, 4])
def test_sharded_plane_matches_single_group_oracle(n_groups, n_writers):
    seed = 100 * n_groups + n_writers
    store = EventStore(web_proxy_schema(), n_shards=2, device="cpu")
    oracle = _plane(store, n_groups=1, mem_rows=64)
    sharded = _plane(store, n_groups=n_groups, mem_rows=64)
    rts, cols, tab, ts, varr = _encoded(store, seed, 1200)
    oracle.ingest(rts, cols, tab, writer_id=0)
    _threaded_ingest(sharded, rts, cols, tab, n_writers, chunk=97)

    tel_o, tel_s = oracle.telemetry(), sharded.telemetry()
    assert int(tel_s["rows"].sum()) == int(tel_o["rows"].sum()) == len(rts)
    assert int(tel_s["overflow"].sum()) == 0
    np.testing.assert_array_equal(tel_s["rows"], tel_o["rows"])
    assert int(tel_s["major"].sum()) > 0  # blocking majors fired under the threads

    dq_o = DistQueryProcessor(store, oracle, device="cpu")
    dq_s = DistQueryProcessor(store, sharded, device="cpu")
    d = dq_s._sync()
    assert d.is_composite and len(d.groups) == n_groups and not dq_o._sync().is_composite
    assert d.n_tablets == TABLETS and d.capacity == 20_000 and d.has_index and d.has_runs

    for tree, mask in TREES:
        for t0, t1 in [(0, T_SPAN), (1800, 5400)]:
            c_o, _, _ = dq_o.scan_range(tree, t0, t1)
            c_s, top_ts, _ = dq_s.scan_range(tree, t0, t1)
            assert c_s == c_o == int((mask(varr) & (ts >= t0) & (ts <= t1)).sum())
            assert ((top_ts >= t0) & (top_ts <= t1)).all()
        for scheme in ("scan", "batched_scan", "index", "batched_index"):
            got = sum(b.count for b in dq_s.run_scheme(scheme, 0, T_SPAN, tree))
            assert got == int(mask(varr).sum())

    for spec in AGG_SPECS:
        for use_index in (False, True):
            a_o = dq_o.aggregate_range(spec, Eq("domain", "c.com"), 0, T_SPAN,
                                       use_index=use_index)
            a_s = dq_s.aggregate_range(spec, Eq("domain", "c.com"), 0, T_SPAN,
                                       use_index=use_index)
            assert _same_result(a_s, a_o)

    # Index hits: the oracle's index-mode plan run against both snapshots.
    run = QueryRun(dq_o, Eq("domain", "c.com"), 0, T_SPAN, batched=False)
    assert run.plan.mode == "index"
    c_o, _, _, tr_o, ca_o = dq_o.scan_index_range(run.plan, run.tree, 0, T_SPAN)
    c_s, _, _, tr_s, ca_s = dq_s.scan_index_range(run.plan, run.tree, 0, T_SPAN)
    assert (c_s, tr_s, ca_s) == (c_o, tr_o, ca_o) and tr_o == 0
    # Densities sum over the groups, each memoized in its sub-snapshot.
    assert dq_s.agg_count("domain", "c.com", 0, T_SPAN) == int((varr["domain"] == "c.com").sum())
    assert all(any(k[0] == "domain" for k in sub.density_cache) for sub in d.groups)


def _numpy_state(state):
    return {k: np.asarray(v) for k, v in state.items()}


def _assert_group_states_equal(jplane, pplane, where):
    for g, (jg, pg) in enumerate(zip(jplane.groups, pplane.groups)):
        want, got = _numpy_state(jg.state), pg.state
        assert want.keys() == got.keys()
        for name, w in want.items():
            t = got[name].numpy()
            if name in ("ev_base_n", "ev_overflow"):  # the reference's int64 drift
                assert t.dtype == np.int32
                w = w.astype(np.int32)
            assert t.dtype == w.dtype and t.shape == w.shape, f"{where} g{g} {name}"
            np.testing.assert_array_equal(t, w, err_msg=f"{where} g{g} {name}")


def test_serial_sharded_ingest_matches_reference_group_for_group():
    jstore = JaxEventStore(jax_schema(), n_shards=2)
    pstore = EventStore(web_proxy_schema(), n_shards=2, device="cpu")
    sizes = dict(mem_rows=48, max_runs=2, append_rows=20)
    jplane = JaxPlane.for_store(jstore, make_dev_mesh(1, 1), capacity=160,
                                tablets_per_device=TABLETS, n_groups=4, **sizes)
    pplane = DistIngestPlane.for_store(pstore, capacity=160, n_tablets=TABLETS, n_groups=4,
                                       device="cpu", **sizes)
    rts, cols, _, _, _ = _encoded(pstore, 8, 900)
    tab = (np.arange(900) * 7 % 11 % TABLETS).astype(np.int32)
    tab[600:] = 2  # skew: one group majors more often
    for off in range(0, 900, 75):
        sl = slice(off, off + 75)
        assert jplane.ingest(rts[sl], cols[sl], tab[sl], writer_id=off % 3) >= 0.0
        pplane.ingest(rts[sl], cols[sl], tab[sl], writer_id=off % 3)
        _assert_group_states_equal(jplane, pplane, f"after append at {off}:")
    jt, pt = jplane.telemetry(), pplane.telemetry()
    for key in ("rows", "minor", "major", "n_runs", "overflow", "base_n", "ix_base_n"):
        np.testing.assert_array_equal(pt[key], np.asarray(jt[key]), err_msg=key)
    assert pt["level_gen"] == jt["level_gen"] and set(pt["level_gen"]) == {"g0", "g1", "g2", "g3"}
    assert pt["fold_events"] == jt["fold_events"]
    assert int(pt["overflow"].sum()) > 0  # the small bases overflow, as in the reference
    steps = 0
    while True:
        debts = [g.fold_debt() for g in pplane.groups]
        assert debts == [g.fold_debt() for g in jplane.groups]
        a, b = jplane.compact_step(), pplane.compact_step()
        assert a == b
        _assert_group_states_equal(jplane, pplane, f"after compact_step {steps}:")
        if not a:
            break
        steps += 1
        jd, pd = jplane.publish(), pplane.publish()
        assert pd.gens == jd.gens
    assert steps > 0 and not pplane.has_unfolded() and pplane.fold_debt() == 0


def test_composite_publish_aliases_untouched_groups():
    store = EventStore(web_proxy_schema(), n_shards=1, device="cpu")
    plane = _plane(store, n_groups=2)
    rts, cols, tab, _, _ = _encoded(store, 3, 600)
    plane.ingest(rts, cols, tab)
    ds1 = plane.publish()
    assert ds1.is_composite and len(ds1.groups) == 2 and set(ds1.gens) == {"g0", "g1"}
    assert plane.publish() is ds1  # clean plane: the cached composite
    g0_tab = (tab % plane.tablets_per_group).astype(np.int32)  # globals [0, 2)
    plane.ingest(rts[:100], cols[:100], g0_tab[:100])
    ds2 = plane.publish()
    assert ds2 is not ds1 and ds2.groups[1] is ds1.groups[1] and ds2.groups[0] is not ds1.groups[0]
    assert ds2.gens["g1"] == ds1.gens["g1"] and ds2.gens["g0"] != ds1.gens["g0"]
    dq = DistQueryProcessor(store, dist=ds2, device="cpu")
    assert dq.scan_range(None, 0, T_SPAN)[0] == 700
    # A fold increment touches one group only.
    assert plane.compact_step() == 1
    ds3 = plane.publish()
    assert sum(a is b for a, b in zip(ds2.groups, ds3.groups)) == 1


def test_per_tablet_gauges_snapshot_host_mirrors():
    store = EventStore(web_proxy_schema(), n_shards=1, device="cpu")
    plane = _plane(store, n_groups=2, mem_rows=128)
    rts, cols, tab, _, _ = _encoded(store, 5, 900)
    plane.ingest(rts, cols, tab)
    while plane.compact_step():
        pass
    tel = plane.telemetry()
    assert int(tel["major"].sum()) > 0 and int(tel["minor"].sum()) > 0
    gauges = {k: plane.metrics.gauge(f"plane_tablet_{k}") for k in ("rows", "minor", "major")}
    for t in range(TABLETS):
        for k, g in gauges.items():
            assert g.value(tablet=t) == float(tel[k][t])
    assert sum(gauges["rows"].value(tablet=t) for t in range(TABLETS)) == 900
    with pytest.raises(TypeError):
        plane.metrics.counter("plane_tablet_rows")


def test_publish_refreshes_only_the_gauges_of_changed_groups(monkeypatch):
    """A publish of clean groups sets no gauge; after an append to one
    group only its tablets are set, and every gauge equals the mirrors."""
    store = EventStore(web_proxy_schema(), n_shards=1, device="cpu")
    plane = _plane(store, n_groups=2, mem_rows=128)
    rts, cols, tab, _, _ = _encoded(store, 6, 400)
    plane.ingest(rts, cols, tab)
    plane.publish()
    gauge = plane.metrics.gauge("plane_tablet_rows")
    touched = []
    real_set = type(gauge).set
    monkeypatch.setattr(gauge, "set", lambda v, **kw: (touched.append(kw["tablet"]),
                                                      real_set(gauge, v, **kw)))
    plane.publish()
    assert touched == []
    first = tab < plane.tablets_per_group  # rows of group 0 only
    plane.ingest(rts[first], cols[first], tab[first])
    plane.publish()
    assert sorted(touched) == list(range(plane.tablets_per_group))
    rows = np.concatenate([g.counter_mirrors()[0] for g in plane.groups])
    assert [gauge.value(tablet=t) for t in range(TABLETS)] == rows.astype(float).tolist()
    assert int(rows.sum()) == 400 + int(first.sum())


def test_blocked_per_writer_sums_to_scalar_across_groups():
    store = EventStore(web_proxy_schema(), n_shards=1, device="cpu")
    plane = _plane(store, n_groups=4, mem_rows=64, max_runs=2)
    rts, cols, tab, _, _ = _encoded(store, 9, 3000)
    _threaded_ingest(plane, rts, cols, tab, n_writers=3, chunk=200)
    tel = plane.telemetry()
    per_writer = tel["blocked_seconds_per_writer"]
    assert int(tel["major"].sum()) >= 1 and plane.blocked_seconds > 0
    assert set(per_writer) <= {0, 1, 2} and per_writer == plane.blocked_by_writer
    assert abs(sum(per_writer.values()) - float(tel["blocked_seconds"])) < 1e-9
    stalls = plane.metrics.counter("plane_group_stall_seconds_total")
    assert abs(stalls.total() - plane.blocked_seconds) < 1e-9
    stall_events = plane.metrics.counter("plane_group_stall_events_total").total()
    assert 0 < stall_events <= plane.fold_events["ingest"]
    with pytest.raises(ValueError):
        plane.blocked_seconds = 1.0
    plane.blocked_seconds = 0.0
    assert plane.blocked_seconds == 0.0 and plane.blocked_by_writer == {}


def test_compact_step_folds_the_most_indebted_group():
    store = EventStore(web_proxy_schema(), n_shards=1, device="cpu")
    plane = _plane(store, n_groups=4, mem_rows=32, max_runs=4)
    rts, cols, _, _, _ = _encoded(store, 11, 400)
    # One tablet per group; a full memtable (32 rows) flushes into a run
    # when the next row arrives: group 2 ends with 3 runs, group 0 with 1,
    # and groups 1 and 3 hold rows in their memtables only.
    for tablet, n in ((2, 96), (0, 32), (1, 5), (3, 5), (2, 1), (0, 1)):
        plane.ingest(rts[:n], cols[:n], np.full(n, tablet, np.int32))
    assert [g.fold_debt() for g in plane.groups] == [1, 0, 3, 0]
    before = [g.gen_snapshot() for g in plane.groups]
    assert plane.compact_step() == 1
    after = [g.gen_snapshot() for g in plane.groups]
    assert [a != b for a, b in zip(before, after)] == [False, False, True, False]
    assert plane.fold_debt() == 2
    # Ties on debt go to the group with staged rows, then the lower id.
    picks = []
    while plane.has_unfolded():
        before = [g.gen_snapshot() for g in plane.groups]
        assert plane.compact_step() == 1
        picks.append(next(i for i, g in enumerate(plane.groups) if g.gen_snapshot() != before[i]))
    assert picks[0] == 2 and sorted(set(picks)) == [0, 1, 2, 3]
    assert plane.compact_step() == 0


def test_group_validation_and_single_group_views():
    store = EventStore(web_proxy_schema(), n_shards=1, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        _plane(store, n_groups=3)
    with pytest.raises(ValueError, match=">= 1"):
        DistIngestPlane(4, capacity=64, n_tablets=4, n_groups=0, device="cpu")
    one = _plane(store, n_groups=1)
    assert one.group is one.groups[0] and one.state is one.groups[0].state
    assert one.groups[0].lock.name == "plane_lock"
    four = _plane(store, n_groups=4)
    assert [g.t0 for g in four.groups] == [0, 1, 2, 3] and four.tablets_per_group == 1
    for attr in ("state", "group"):
        with pytest.raises(RuntimeError, match="n_groups > 1"):
            getattr(four, attr)
    with pytest.raises(ValueError, match="tablet ids"):
        four.ingest(np.zeros(1, np.int32), np.zeros((1, 12), np.int32), np.array([4]))
    assert check_tablet_guidance(4, 8) and not check_tablet_guidance(3, 8)


def test_writer_routing_spreads_over_groups():
    store = EventStore(web_proxy_schema(), n_shards=2, device="cpu")
    plane = _plane(store, n_groups=4)
    ts, vals = _events(13, 2000)
    w = DistBatchWriter(store, plane, batch_rows=500)
    w.add(ts, vals)
    w.close()
    per_group = plane.telemetry()["rows"].reshape(plane.n_groups, -1).sum(axis=1)
    assert (per_group > 0).all()
    dq = DistQueryProcessor(store, plane, device="cpu")
    assert dq.scan_range(None, 0, T_SPAN)[0] == 2000


def test_launch_counter_counts_exactly_across_threads():
    """count_launch is the only way the kernel wrappers bump their
    counters; 8 threads bumping one counter lose no count."""
    import sys

    ns = {"launches": 0}
    per_thread = 20_000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        threads = [threading.Thread(target=lambda: [common.count_launch(ns)
                                                    for _ in range(per_thread)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert ns["launches"] == 8 * per_thread


def test_every_wrapper_counts_through_count_launch():
    import inspect

    from repro_torch.kernels.aggregate_combine import ops as a
    from repro_torch.kernels.combine_scan import ops as c
    from repro_torch.kernels.filter_scan import ops as f
    from repro_torch.kernels.merge_intersect import ops as i
    from repro_torch.kernels.merge_runs import ops as m

    for mod, n in ((a, 2), (c, 2), (f, 1), (i, 1), (m, 1)):
        src = inspect.getsource(mod)
        assert src.count("count_launch(globals())") == n, mod.__name__
        assert "launches +=" not in src, mod.__name__
        assert mod.launches >= 0
