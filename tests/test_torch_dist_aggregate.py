"""The port's device aggregation (DistQueryProcessor.aggregate_range)
against the JAX reference's, and against the port's own host processor.

Both packages ingest the same numpy-seeded events into planes of the same
shape, with rows in the base, the unfolded runs and the sealed memtable
(the reference's tests/test_run_aware.py), and a second pair with nothing
folded. Aggregates are compared on scan plans (use_index=False) and index
plans, bit for bit with equal dtypes (no tolerance): the device results
carry int64 values and int64 counts, as the reference's do; the host
processor's counts are int32, as the reference host's are.
"""
import numpy as np
import pytest
import torch

from repro.core import AggregateSpec as JSpec, EventStore as JaxEventStore
from repro.core import And as JAnd, Eq as JEq, Not as JNot, Or as JOr
from repro.core import QueryStats as JaxStats, web_proxy_schema as jax_schema
from repro.core.dist_ingest import DistBatchWriter as JaxWriter, DistIngestPlane as JaxPlane
from repro.core.dist_query import DistQueryProcessor as JaxProcessor
from repro.launch.mesh import make_dev_mesh

from repro_torch.core import AggregateSpec, EventStore, QueryProcessor, QueryStats
from repro_torch.core import filter as pf
from repro_torch.core import dist_query
from repro_torch.core.dist_ingest import DistBatchWriter, DistIngestPlane
from repro_torch.core.dist_query import DistQueryProcessor
from repro_torch.core.schema import web_proxy_schema

T_SPAN = 4 * 3600
SIZES = dict(mem_rows=64, max_runs=2, append_rows=32)


def gen_events(seed, n):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, T_SPAN, n))
    vals = {
        "domain": rng.choice(["a.com", "b.com", "c.com", "rare.net"],
                             p=[0.6, 0.25, 0.13, 0.02], size=n).tolist(),
        "method": rng.choice(["GET", "POST"], size=n).tolist(),
        "status": rng.choice(["200", "404"], size=n, p=[0.8, 0.2]).tolist(),
        "bytes_in": rng.integers(1 << 20, 1 << 21, n).astype(str).tolist(),
    }
    return ts, vals


def make_twin(seed, n, sizes, **proc_kw):
    ts, vals = gen_events(seed, n)
    jstore, pstore = JaxEventStore(jax_schema()), EventStore(web_proxy_schema(), device="cpu")
    for s in (jstore, pstore):
        s.ingest(ts, vals)  # the host oracles
        s.flush_all()
    jplane = JaxPlane.for_store(jstore, make_dev_mesh(1, 1), capacity=1024,
                                tablets_per_device=4, **sizes)
    pplane = DistIngestPlane.for_store(pstore, capacity=1024, n_tablets=4, device="cpu", **sizes)
    jw = JaxWriter(jstore, jplane, batch_rows=200, writer_id=1)
    pw = DistBatchWriter(pstore, pplane, batch_rows=200, writer_id=1)
    for off in range(0, len(ts), 123):
        part = {k: v[off: off + 123] for k, v in vals.items()}
        jw.add(ts[off: off + 123], part)
        pw.add(ts[off: off + 123], part)
    jw.close()
    pw.close()
    return dict(vals=vals, jstore=jstore, pstore=pstore, pplane=pplane,
                jq=JaxProcessor(jstore, plane=jplane, **proc_kw),
                pq=DistQueryProcessor(pstore, pplane, device="cpu", **proc_kw))


@pytest.fixture(scope="module")
def twin():
    tw = make_twin(21, 1500, SIZES)
    tel = tw["pplane"].telemetry()
    assert tel["base_n"].min() > 0 and tel["n_runs"].min() > 0 and tel["mem_n"].min() > 0
    return tw


@pytest.fixture(scope="module")
def unfolded():
    tw = make_twin(5, 300, dict(mem_rows=64, max_runs=8, append_rows=32))
    tel = tw["pplane"].telemetry()
    assert tel["base_n"].max() == 0 and tel["n_runs"].min() > 0
    return tw


SPEC_ARGS = [
    dict(group_by=("method",), op="count"),
    dict(group_by=("status",), op="count", time_bucket_s=3600),
    dict(group_by=("domain", "method"), op="count", time_bucket_s=1800),
    dict(group_by=("method",), op="sum", value_field="bytes_in", time_bucket_s=3600),
    dict(group_by=("domain",), op="min", value_field="bytes_in"),
    dict(group_by=("status",), op="max", value_field="bytes_in", time_bucket_s=900),
]


def trees(eq, not_, and_, or_):
    return [
        None,
        eq("domain", "rare.net"),
        eq("domain", "c.com"),
        and_(eq("domain", "c.com"), eq("status", "404")),
        and_(eq("domain", "b.com"), not_(eq("method", "POST"))),
        or_(eq("domain", "rare.net"), eq("domain", "c.com")),
        and_(eq("domain", "rare.net"), eq("domain", "never-seen.com")),
    ]


JTREES = trees(JEq, JNot, JAnd, JOr)
PTREES = trees(pf.Eq, pf.Not, pf.And, pf.Or)
RANGES = [(0, T_SPAN), (1000, 9000)]


def assert_results_equal(got, want):
    for name in ("gids", "values", "counts"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


# (spec, tree) pairs: every op, plain and bucketed groupings, and every
# plan kind (filter, index Eq, index AND, AND with NOT, OR, empty).
CASES = [(0, 0), (1, 1), (2, 3), (3, 2), (4, 4), (5, 5), (3, 6), (0, 5)]


@pytest.mark.parametrize("fixture,case", [("twin", c) for c in CASES]
                         + [("unfolded", c) for c in CASES[1:6]])
@pytest.mark.parametrize("use_index", [False, True])
def test_aggregate_range_matches_reference(request, fixture, case, use_index):
    tw = request.getfixturevalue(fixture)
    spec, i = case
    for t0, t1 in RANGES:
        js, ps = JaxStats(), QueryStats()
        want = tw["jq"].aggregate_range(JSpec(**SPEC_ARGS[spec]), JTREES[i], t0, t1,
                                        use_index=use_index, stats=js)
        got = tw["pq"].aggregate_range(AggregateSpec(**SPEC_ARGS[spec]), PTREES[i], t0, t1,
                                       use_index=use_index, stats=ps)
        assert_results_equal(got, want)
        assert ps.plan.describe() == js.plan.describe()
        assert ps.index_keys_scanned == js.index_keys_scanned


@pytest.mark.parametrize("spec", range(len(SPEC_ARGS)))
def test_device_aggregate_matches_the_host_processor(twin, spec):
    """Port device against port host: equal groups and values; the host's
    counts are int32, the device's int64."""
    for i in range(len(PTREES) - 1):
        host = QueryProcessor(twin["pstore"], device="cpu").aggregate(
            AggregateSpec(**SPEC_ARGS[spec]), 0, T_SPAN, PTREES[i])
        dev = twin["pq"].aggregate_range(AggregateSpec(**SPEC_ARGS[spec]), PTREES[i], 0, T_SPAN)
        np.testing.assert_array_equal(dev.gids, host.gids)
        np.testing.assert_array_equal(dev.values, host.values)
        np.testing.assert_array_equal(dev.counts, host.counts)
        assert host.counts.dtype == np.int32 and dev.counts.dtype == np.int64
        assert dev.values.dtype == host.values.dtype == np.int64


def test_sum_of_large_values_needs_int64(twin):
    # No event carries a scheme, so every row falls into one group.
    spec = AggregateSpec(group_by=("scheme",), op="sum", value_field="bytes_in")
    res = twin["pq"].aggregate_range(spec, None, 0, T_SPAN, use_index=False)
    assert res.values.max() > 2**31
    assert int(res.values.sum()) == sum(int(v) for v in twin["vals"]["bytes_in"])


def test_index_plan_aggregates_only_the_candidates(twin, monkeypatch):
    """A selective aggregate rides the index step's candidate gather: the
    scan aggregation never runs and postings are expanded."""
    def forbidden(*a, **k):
        raise AssertionError("the scan aggregation ran for an index plan that fit its slabs")

    monkeypatch.setattr(dist_query, "aggregate_step", forbidden)
    stats = QueryStats()
    spec = AggregateSpec(group_by=("method",))
    got = twin["pq"].aggregate_range(spec, pf.Eq("domain", "rare.net"), 0, T_SPAN, stats=stats)
    assert stats.plan.mode == "index" and stats.index_keys_scanned > 0
    assert got.total_matched() == twin["vals"]["domain"].count("rare.net")


def test_index_truncation_falls_back_to_the_exact_scan_aggregation():
    tw = make_twin(21, 1500, SIZES, index_postings=8, index_rows=8)
    spec = AggregateSpec(group_by=("method",))
    calls = []
    step = dist_query.aggregate_step

    def counting(*a, **k):
        calls.append(1)
        return step(*a, **k)

    dist_query.aggregate_step = counting
    try:
        stats = QueryStats()
        got = tw["pq"].aggregate_range(spec, pf.Eq("domain", "c.com"), 0, T_SPAN, stats=stats)
    finally:
        dist_query.aggregate_step = step
    want = tw["jq"].aggregate_range(JSpec(group_by=("method",)), JEq("domain", "c.com"), 0, T_SPAN)
    assert_results_equal(got, want)
    assert stats.plan.mode == "index" and calls == [1]
    assert got.total_matched() == tw["vals"]["domain"].count("c.com")


def test_empty_plan_does_no_device_work(twin, monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("an empty plan reached a device step")

    monkeypatch.setattr(dist_query, "aggregate_step", forbidden)
    monkeypatch.setattr(dist_query, "index_aggregate_step", forbidden)
    stats = QueryStats()
    res = twin["pq"].aggregate_range(AggregateSpec(group_by=("method",)), PTREES[-1], 0, T_SPAN,
                                     stats=stats)
    assert stats.plan.mode == "empty" and res.n_groups == 0
    assert res.counts.dtype == np.int64


def test_aggregate_steps_are_dense_and_typed(twin):
    from repro_torch.core.iterators import resolve_grouping

    pq = twin["pq"]
    d = pq._sync()
    for op, dtype in [("count", torch.int64), ("sum", torch.int64), ("min", torch.int32),
                      ("max", torch.int32)]:
        kw = {} if op == "count" else dict(value_field="bytes_in")
        g = resolve_grouping(pq.store, AggregateSpec(group_by=("status",), op=op, **kw), 0, T_SPAN)
        vt = torch.from_numpy(g.value_table if g.value_table is not None else np.ones(1, np.int32))
        aggs, cnts = dist_query.aggregate_step(d, pq._program(None, d.device), vt, g, 0, 2**30)
        assert aggs.dtype == dtype and cnts.dtype == torch.int64
        assert aggs.shape == cnts.shape == (g.size,)
        assert int(cnts.sum()) == 1500


def test_query_stats_lives_with_the_host_processor():
    from repro_torch.core import query

    assert dist_query.QueryStats is query.QueryStats
    assert QueryStats().rows_filtered == 0
