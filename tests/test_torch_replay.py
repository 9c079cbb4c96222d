"""The bulk replay (from_event_store) and the plane's remaining entry
points against the JAX package.

from_event_store must give a base-only snapshot whose arrays equal the
reference's bit for bit, and every step (scan, index, density,
aggregate, index aggregate) must read it as the reference does;
execute_batched must total the matching rows over more than one batch.
warm_seal and warm_compaction keep the reference's semantics (a no-op
on a drained plane, an explicit fold of staged rows), record_session
keeps the 1,024 newest sessions, and last_seal_rows and
check_tablet_guidance read as the reference's.
"""
import numpy as np
import pytest

from repro.core import AggregateSpec as JSpec, And as JAnd, Cmp as JCmp, Eq as JEq
from repro.core import EventStore as JaxEventStore, Not as JNot, Or as JOr
from repro.core import web_proxy_schema as jax_schema
from repro.core.dist_ingest import DistBatchWriter as JaxWriter, DistIngestPlane as JaxPlane
from repro.core.dist_ingest import check_tablet_guidance as jax_guidance
from repro.core.dist_query import DistQueryProcessor as JaxProcessor
from repro.core.dist_query import QueryRun as JaxQueryRun
from repro.core.dist_query import from_event_store as jax_from_event_store
from repro.core.query import QueryStats as JStats
from repro.launch.mesh import make_dev_mesh

from repro_torch.core import AggregateSpec, And, Cmp, Eq, Not, Or, QueryStats
from repro_torch.core.dist_ingest import DistBatchWriter, DistIngestPlane, check_tablet_guidance
from repro_torch.core.dist_query import DistQueryProcessor, QueryRun, from_event_store
from repro_torch.core.schema import web_proxy_schema
from repro_torch.core.store import EventStore

T_SPAN = 4 * 3600
TABLETS = 4


def gen_events(seed, n):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, T_SPAN, n))
    vals = {
        "domain": rng.choice(["a.com", "b.com", "c.com", "rare.net"],
                             p=[0.6, 0.25, 0.13, 0.02], size=n).tolist(),
        "method": rng.choice(["GET", "POST"], size=n).tolist(),
        "status": rng.choice(["200", "404"], size=n, p=[0.8, 0.2]).tolist(),
        "bytes_out": rng.integers(10, 5000, size=n).astype(str).tolist(),
    }
    return ts, vals


@pytest.fixture(scope="module")
def replays():
    ts, vals = gen_events(3, 6000)
    kw = dict(n_shards=4, flush_rows=1024, max_runs=3)
    js, ps = JaxEventStore(jax_schema(), **kw), EventStore(web_proxy_schema(), **kw, device="cpu")
    for s in (js, ps):
        for off in range(0, len(ts), 1500):
            s.ingest(ts[off: off + 1500], {k: v[off: off + 1500] for k, v in vals.items()})
        s.flush_all()
        s.compact_all()
    jd = jax_from_event_store(js, make_dev_mesh(1, 1), tablets_per_device=TABLETS)
    pd = from_event_store(ps, n_tablets=TABLETS, device="cpu")
    return dict(js=js, ps=ps, jd=jd, pd=pd, ts=ts, vals={k: np.array(v) for k, v in vals.items()})


BASE_FIELDS = ("rev_ts", "cols", "counts", "ix_keys", "ix_counts", "ag_keys", "ag_vals",
               "ag_counts")
LEVEL_FIELDS = ("run_rev_ts", "run_cols", "run_counts", "mem_rev_ts", "mem_cols", "mem_counts",
                "ix_run_k", "ix_run_n", "ix_mem_k", "ix_mem_n", "ag_run_k", "ag_run_c",
                "ag_run_n", "ag_mem_k", "ag_mem_c", "ag_mem_n")


def test_replay_is_base_only_and_equals_reference(replays):
    jd, pd = replays["jd"], replays["pd"]
    assert not pd.has_runs and not jd.has_runs and pd.has_index and not pd.is_composite
    assert pd.n_tablets == jd.n_tablets == TABLETS and pd.capacity == jd.capacity
    assert pd.agg_bucket_s == jd.agg_bucket_s and pd.gens is None and pd.groups is None
    for name in LEVEL_FIELDS:
        assert getattr(pd, name) is None, name
    for name in BASE_FIELDS:
        want = np.asarray(getattr(jd, name))
        got = getattr(pd, name).numpy()
        if name == "counts":
            want = want.astype(np.int32)  # the reference's base count drifts to int64
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert int(pd.counts.sum()) == len(replays["ts"])
    assert [len(lv) for lv in (pd.ev_levels(), pd.ix_levels(), pd.ag_levels())] == [1, 1, 1]


def test_replay_rejects_a_small_capacity_before_the_replay(replays):
    with pytest.raises(ValueError, match="tablet overflow"):
        from_event_store(replays["ps"], capacity=100, n_tablets=TABLETS, device="cpu")
    with pytest.raises(ValueError, match="dist= or plane="):
        DistQueryProcessor(replays["ps"], device="cpu")


def test_replay_raises_when_the_plane_reports_overflow(replays, monkeypatch):
    """The pre-check bounds the rows per tablet; an overflow the plane
    books anyway (in any family) must raise, not return a cut snapshot."""
    real = DistIngestPlane.telemetry

    def overflowing(self):
        tel = real(self)
        tel["ix_overflow"] = tel["ix_overflow"] + 1
        return tel

    monkeypatch.setattr(DistIngestPlane, "telemetry", overflowing)
    with pytest.raises(ValueError, match="tablet overflow"):
        from_event_store(replays["ps"], n_tablets=TABLETS, device="cpu")


def trees(L):
    eq, and_, not_, or_, cmp_ = L
    return [
        eq("domain", "c.com"),
        and_(eq("domain", "b.com"), not_(eq("method", "POST"))),
        or_(eq("status", "404"), eq("domain", "rare.net")),
        and_(eq("domain", "a.com"), eq("status", "404")),
        and_(eq("domain", "a.com"), cmp_("bytes_out", "<", 1000)),
        None,
    ]


JT = trees((JEq, JAnd, JNot, JOr, JCmp))
PT = trees((Eq, And, Not, Or, Cmp))


@pytest.mark.parametrize("i", range(len(PT)))
def test_every_step_reads_the_replay_as_the_reference(replays, i):
    jq = JaxProcessor(replays["js"], dist=replays["jd"])
    pq = DistQueryProcessor(replays["ps"], dist=replays["pd"], device="cpu")
    for t0, t1 in ((0, T_SPAN), (1800, 5400)):
        want, got = jq.scan_range(JT[i], t0, t1), pq.scan_range(PT[i], t0, t1)
        assert got[0] == want[0]
        np.testing.assert_array_equal(np.sort(got[1]), np.sort(want[1]))
        jrun = JaxQueryRun(jq, JT[i], t0, t1, batched=False)
        prun = QueryRun(pq, PT[i], t0, t1, batched=False)
        assert prun.plan.describe() == jrun.plan.describe()
        if prun.plan.mode == "index":
            want = jq.scan_index_range(jrun.plan, JT[i], t0, t1)
            got = pq.scan_index_range(prun.plan, PT[i], t0, t1)
            assert (got[0], got[3], got[4]) == (want[0], want[3], want[4])
    for scheme in ("scan", "batched_scan", "index", "batched_index"):
        want = sum(b.count for b in jq.run_scheme(scheme, 0, T_SPAN, JT[i]))
        assert sum(b.count for b in pq.run_scheme(scheme, 0, T_SPAN, PT[i])) == want
    for use_index in (False, True):
        js, ps = JStats(), QueryStats()
        want = jq.aggregate_range(JSpec(group_by=("status",), time_bucket_s=3600), JT[i],
                                  0, T_SPAN, use_index=use_index, stats=js)
        got = pq.aggregate_range(AggregateSpec(group_by=("status",), time_bucket_s=3600), PT[i],
                                 0, T_SPAN, use_index=use_index, stats=ps)
        for name in ("gids", "values", "counts"):
            np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)))
        assert ps.index_keys_scanned == js.index_keys_scanned


def test_replay_densities_match_reference(replays):
    jq = JaxProcessor(replays["js"], dist=replays["jd"])
    pq = DistQueryProcessor(replays["ps"], dist=replays["pd"], device="cpu")
    for fv in (("domain", "c.com"), ("status", "404"), ("domain", "never-seen")):
        for t0, t1 in ((0, T_SPAN), (3600, 7199)):
            assert pq.agg_count(*fv, t0, t1) == jq.agg_count(*fv, t0, t1)


def test_execute_batched_totals_over_several_batches(replays):
    pq = DistQueryProcessor(replays["ps"], dist=replays["pd"], device="cpu")
    stats = QueryStats()
    res = pq.execute_batched(Eq("domain", "c.com"), 0, T_SPAN, stats=stats)
    want = int((replays["vals"]["domain"] == "c.com").sum())
    assert sum(c for c, _, _ in res) == stats.rows == want
    assert stats.batches == len(res) > 1
    for _, ts, cols in res:
        assert ((ts >= 0) & (ts <= T_SPAN)).all() and cols.shape[-1] == 12


def _twin(n_groups=1, sizes=None):
    sizes = sizes or dict(mem_rows=48, max_runs=2, append_rows=20)
    js, ps = JaxEventStore(jax_schema()), EventStore(web_proxy_schema(), device="cpu")
    jplane = JaxPlane.for_store(js, make_dev_mesh(1, 1), capacity=1024,
                                tablets_per_device=TABLETS, n_groups=n_groups, **sizes)
    pplane = DistIngestPlane.for_store(ps, capacity=1024, n_tablets=TABLETS, n_groups=n_groups,
                                       device="cpu", **sizes)
    return jplane, pplane, JaxWriter(js, jplane, batch_rows=100, writer_id=4), \
        DistBatchWriter(ps, pplane, batch_rows=100, writer_id=4)


def _states_equal(jplane, pplane):
    for jg, pg in zip(jplane.groups, pplane.groups):
        for name, w in jg.state.items():
            np.testing.assert_array_equal(pg.state[name].numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_warm_seal_and_warm_compaction_match_reference(n_groups):
    jplane, pplane, jw, pw = _twin(n_groups)
    for plane in (jplane, pplane):  # on an empty plane both are no-ops
        plane.warm_seal()
        plane.warm_compaction()
        assert plane.fold_events == {} and not plane.has_unfolded()
    assert pplane.telemetry()["level_gen"] == jplane.telemetry()["level_gen"]
    ts, vals = gen_events(8, 500)
    jw.add(ts, vals)
    pw.add(ts, vals)
    jw.close()
    pw.close()
    assert pplane.has_unfolded()
    for plane in (jplane, pplane):
        plane.warm_seal()  # reads only: staged rows stay staged
    assert pplane.has_unfolded() and pplane.fold_events == jplane.fold_events
    events_before = dict(pplane.fold_events)
    for plane in (jplane, pplane):
        plane.warm_compaction()
    _states_equal(jplane, pplane)
    # Minor, fold, major: a memtable whose tablet had no free run slot
    # keeps its rows, in both packages.
    assert pplane.has_unfolded() == jplane.has_unfolded()
    assert pplane.fold_events == jplane.fold_events
    assert pplane.fold_events["explicit"] == events_before.get("explicit", 0) + n_groups
    assert pplane.telemetry()["level_gen"] == jplane.telemetry()["level_gen"]
    pq = DistQueryProcessor(pw.store, pplane, device="cpu")
    assert pq.scan_range(None, 0, T_SPAN)[0] == 500
    for plane in (jplane, pplane):  # drained: a no-op
        plane.compact()
        events = dict(plane.fold_events)
        plane.warm_compaction()
        assert plane.fold_events == events and not plane.has_unfolded()
    assert pplane.fold_events == jplane.fold_events
    _states_equal(jplane, pplane)


def test_last_seal_rows_and_seal_counts_match_reference():
    jplane, pplane, jw, pw = _twin(sizes=dict(mem_rows=256, max_runs=2, append_rows=64))
    for n in (0, 30, 100, 300):
        if n:
            ts, vals = gen_events(n, n)
            jw.add(ts, vals)
            pw.add(ts, vals)
            jw.flush()
            pw.flush()
        jplane.publish()
        pplane.publish()
        assert pplane.last_seal_rows == jplane.last_seal_rows
        assert (pplane.seal_events, pplane.seal_reuses) == (jplane.seal_events, jplane.seal_reuses)
    while jplane.compact_step():
        assert pplane.compact_step() == 1
        jplane.publish()
        pplane.publish()
        assert pplane.last_seal_rows == jplane.last_seal_rows
        assert (pplane.seal_events, pplane.seal_reuses) == (jplane.seal_events, jplane.seal_reuses)


def test_record_session_keeps_the_newest_1024():
    jplane, pplane, _, _ = _twin()
    for plane in (jplane, pplane):
        for sid in range(1100):
            plane.record_session(sid, {"batches": sid, "ttfr_s": 0.5})
        plane.record_session(200, {"batches": -1})  # a refresh moves it to the end
    jt, pt = jplane.telemetry(), pplane.telemetry()
    assert pt["sessions"] == jt["sessions"]
    assert list(pt["sessions"]) == list(jt["sessions"])
    assert len(pt["sessions"]) == 1024 and list(pt["sessions"])[-1] == 200
    assert 0 not in pt["sessions"] and pt["sessions"][1099] == {"batches": 1099, "ttfr_s": 0.5}
    assert pt["blocked_seconds_per_writer"] == {k: v for k, v in pplane.blocked_by_writer.items()}


@pytest.mark.parametrize("n_tablets,n_writers", [(1, 2), (1, 3), (2, 4), (4, 8), (3, 8), (0, 1)])
def test_check_tablet_guidance_matches_reference(n_tablets, n_writers):
    assert check_tablet_guidance(n_tablets, n_writers) == jax_guidance(n_tablets, n_writers)
