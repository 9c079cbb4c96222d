"""The Match and Cmp filter nodes and the host-layer leftovers of the port
against the JAX package: compiled programs array for array, code-set
resolution, the host tree oracle, the dictionary's prefix codes and
decode_many, the index and aggregate key unpacking, Algorithm 2's two
drivers, the planner on Cmp trees, and Match and Cmp queries through the
host QueryProcessor (every scheme and aggregate) and DistQueryProcessor.
The same seeded events go through both packages; results must agree
exactly, with equal dtypes.
"""
import numpy as np
import pytest

from repro.core import (
    AggregateSpec as JSpec,
    And as JAnd,
    Cmp as JCmp,
    Eq as JEq,
    EventStore as JaxEventStore,
    In as JIn,
    Match as JMatch,
    Not as JNot,
    Or as JOr,
    QueryProcessor as JaxQueryProcessor,
    web_proxy_schema as jax_schema,
)
from repro.core import keypack as jk
from repro.core.batching import iter_batches as jax_iter_batches
from repro.core.batching import run_batched_query as jax_run_batched_query
from repro.core.dist_ingest import DistBatchWriter as JaxWriter, DistIngestPlane as JaxPlane
from repro.core.dist_query import DistQueryProcessor as JaxProcessor
from repro.core.filter import compile_tree as jax_compile_tree
from repro.core.filter import eval_tree_rows as jax_eval_tree_rows
from repro.core.filter import resolve_codes as jax_resolve_codes
from repro.core.planner import plan_query as jax_plan_query
from repro.core.schema import EventSchema as JSchema, FieldSpec as JField
from repro.launch.mesh import make_dev_mesh

from repro_torch.core import (
    AggregateSpec,
    And,
    Cmp,
    Eq,
    In,
    Match,
    Not,
    Or,
    QueryProcessor,
    iter_batches,
    run_batched_query,
)
from repro_torch.core import keypack as pk
from repro_torch.core.dist_ingest import DistBatchWriter, DistIngestPlane
from repro_torch.core.dist_query import DistQueryProcessor
from repro_torch.core.filter import compile_tree, eval_tree_rows, resolve_codes
from repro_torch.core.planner import plan_query
from repro_torch.core.schema import EventSchema, FieldSpec, web_proxy_schema
from repro_torch.core.store import EventStore

N = 2400
T_STOP = 2 * 3600
JLIB = dict(Eq=JEq, Cmp=JCmp, Match=JMatch, In=JIn, Not=JNot, And=JAnd, Or=JOr)
PLIB = dict(Eq=Eq, Cmp=Cmp, Match=Match, In=In, Not=Not, And=And, Or=Or)


def store_trees(L):
    """The trees of tests/test_store_query.py, Match and Cmp among them,
    and the other comparison ops."""
    return [
        L["Eq"]("domain", "gamma.net"),
        L["Eq"]("domain", "never-seen.com"),
        L["And"](L["Eq"]("domain", "alpha.com"), L["Eq"]("status", "404")),
        L["And"](L["Eq"]("domain", "eps.gov"), L["Eq"]("method", "GET"), L["Eq"]("status", "200")),
        L["Or"](L["Eq"]("domain", "delta.io"), L["Eq"]("domain", "eps.gov")),
        L["And"](L["Eq"]("domain", "beta.org"), L["Not"](L["Eq"]("method", "PUT"))),
        L["Not"](L["Eq"]("status", "200")),
        L["Match"]("domain", "a"),
        L["And"](L["Eq"]("method", "POST"), L["Cmp"]("bytes_out", "<", 1000)),
        L["Or"](L["And"](L["Eq"]("domain", "alpha.com"), L["Eq"]("status", "500")),
                L["Eq"]("domain", "gamma.net")),
        None,
        L["Cmp"]("bytes_out", "<=", 1500),
        L["Cmp"]("bytes_out", ">", 4000.5),
        L["Or"](L["Cmp"]("bytes_out", ">=", 4900), L["Match"]("domain", "never")),
        L["Cmp"]("domain", "<", 3),  # non-numeric values: no codes
        L["Cmp"]("bytes_out", "!=", 5),  # unknown op: no codes
        L["Match"]("domain", ""),
    ]


def gen_events(seed=42, n=N):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, T_STOP, n))
    data = {
        "domain": rng.choice(["alpha.com", "beta.org", "gamma.net", "delta.io", "eps.gov"],
                             p=[0.5, 0.3, 0.1, 0.07, 0.03], size=n),
        "method": rng.choice(["GET", "POST", "PUT"], size=n),
        "status": rng.choice(["200", "404", "500"], size=n, p=[0.7, 0.2, 0.1]),
        "bytes_out": rng.integers(100, 5000, n).astype(str),
    }
    return ts, {k: v.tolist() for k, v in data.items()}


@pytest.fixture(scope="module")
def stores():
    ts, vals = gen_events()
    kw = dict(n_shards=4, flush_rows=512, max_runs=4, agg_bucket_seconds=600)
    js, ps = JaxEventStore(jax_schema(), **kw), EventStore(web_proxy_schema(), **kw, device="cpu")
    for i in range(0, N, 600):
        part = {k: v[i: i + 600] for k, v in vals.items()}
        js.ingest(ts[i: i + 600], part)
        ps.ingest(ts[i: i + 600], part)
    for s in (js, ps):
        s.flush_all()
        s.compact_all()
    return js, ps, ts, vals


def assert_same_program(pp, jp):
    for name in ("opcodes", "arg0", "arg1", "codesets"):
        got, want = getattr(pp, name), getattr(jp, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert pp.max_depth == jp.max_depth


@pytest.mark.parametrize("i", range(len(store_trees(PLIB))))
def test_compiled_programs_match_reference(stores, i):
    js, ps, _, _ = stores
    jp = jax_compile_tree(js, store_trees(JLIB)[i])
    pp = compile_tree(ps, store_trees(PLIB)[i])
    assert_same_program(pp, jp)


@pytest.mark.parametrize("i", range(len(store_trees(PLIB))))
def test_eval_tree_rows_matches_reference(stores, i):
    js, ps, _, vals = stores
    cols = ps.encode_events(np.zeros(N), vals)
    np.testing.assert_array_equal(cols, js.encode_events(np.zeros(N), vals))
    want = jax_eval_tree_rows(js, store_trees(JLIB)[i], cols)
    got = eval_tree_rows(ps, store_trees(PLIB)[i], cols)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("node", [("Match", "domain", "a"), ("Match", "domain", "zzz"),
                                  ("In", "status", ("404", "nope", "200")),
                                  ("Cmp", "bytes_out", "<", 1000),
                                  ("Cmp", "bytes_out", ">=", 2500.0)])
def test_resolve_codes_matches_reference(stores, node):
    js, ps, _, _ = stores
    kind, *args = node
    want = jax_resolve_codes(js, JLIB[kind](*args))
    got = resolve_codes(ps, PLIB[kind](*args))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(TypeError):
        resolve_codes(ps, Eq("domain", "alpha.com"))


def test_prefix_codes_and_decode_many_match_reference(stores):
    js, ps, _, _ = stores
    for field, prefix in (("domain", "a"), ("domain", "d"), ("domain", ""), ("bytes_out", "4"),
                          ("method", "nothing")):
        want = js.dictionaries[field].prefix_codes(prefix)
        got = ps.dictionaries[field].prefix_codes(prefix)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    codes = np.arange(len(ps.dictionaries["bytes_out"]))[::7]
    assert ps.dictionaries["bytes_out"].decode_many(codes) == \
        js.dictionaries["bytes_out"].decode_many(codes)
    assert ps.dictionaries["domain"].decode_many([]) == []


def test_keypack_unpacking_matches_reference():
    rng = np.random.default_rng(3)
    fid = rng.integers(0, pk.MAX_FIELDS, 500)
    val = rng.integers(0, pk.MAX_VALUES, 500)
    rts = rng.integers(0, pk.TS_MAX + 1, 500)
    ikeys = pk.pack_index_key(fid, val, rts)
    akeys = pk.pack_agg_key(fid, val, rts)
    for got, want in ((pk.unpack_index_key(ikeys), jk.unpack_index_key(ikeys)),
                      (pk.unpack_agg_key(akeys), jk.unpack_agg_key(akeys))):
        for g, w, orig in zip(got, want, (fid, val, rts)):
            assert g.dtype == w.dtype == np.int64
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, orig)
    assert pk.BUCKET_MAX == jk.BUCKET_MAX
    for f, v, t0, t1 in ((3, 17, 0, 3600), (0, 0, 5, 5), (1023, pk.MAX_VALUES - 1, 100, 99)):
        got, want = pk.index_key_range(f, v, t0, t1), jk.index_key_range(f, v, t0, t1)
        assert [int(x) for x in got] == [int(x) for x in want]


def _query(seed):
    """A query callback whose runtimes and rows depend only on the range."""
    def q(lo, hi):
        rng = np.random.default_rng(seed + int(lo))
        return float(rng.uniform(1e-3, 20.0)), int(rng.integers(0, 3000))
    return q


@pytest.mark.parametrize("seed", range(3))
def test_alg2_drivers_match_reference(seed):
    b0 = 37.5 + seed
    got = run_batched_query(0, 14400, b0, _query(seed))
    want = jax_run_batched_query(0, 14400, b0, _query(seed))
    assert [(r.p, r.b, r.k) for r in got.history] == [(r.p, r.b, r.k) for r in want.history]
    assert got.done and want.done

    def drive(gen):
        ranges = []
        for (lo, hi), report in gen:
            ranges.append((lo, hi))
            report(*_query(seed)(lo, hi))
        return ranges

    assert drive(iter_batches(0, 14400, b0)) == drive(jax_iter_batches(0, 14400, b0))
    it = iter_batches(0, 14400, b0)
    next(it)
    with pytest.raises(RuntimeError, match="did not report"):
        next(it)


def _planner_stores():
    fields = ["fa", "fb", "raw"]
    rng = np.random.default_rng(0)
    n = 400
    ts = np.sort(rng.integers(0, 1000, n))
    vals = {"fa": rng.choice(["x1", "x2", "o"], n, p=[0.01, 0.02, 0.97]).tolist(),
            "fb": rng.choice(["y9", "o"], n, p=[0.05, 0.95]).tolist(),
            "raw": [str(i % 7) for i in range(n)]}
    js = JaxEventStore(JSchema("planner_test", [JField(f, indexed=f != "raw") for f in fields]),
                       n_shards=2, agg_bucket_seconds=100)
    ps = EventStore(EventSchema("planner_test", [FieldSpec(f, indexed=f != "raw")
                                                 for f in fields]),
                    n_shards=2, agg_bucket_seconds=100, device="cpu")
    js.ingest(ts, vals)
    ps.ingest(ts, vals)
    return js, ps


def planner_trees(L):
    """tests/test_planner.py's heuristic-4 Cmp trees, and Cmp beside an
    indexable Eq."""
    return [
        L["Cmp"]("raw", "<", 4),
        L["Or"](L["Eq"]("fa", "x2"), L["Cmp"]("raw", "<", 4)),
        L["And"](L["Eq"]("fa", "x2"), L["Cmp"]("raw", ">=", 2)),
        L["And"](L["Eq"]("fa", "x1"), L["Eq"]("fb", "y9"), L["Not"](L["Cmp"]("raw", "<=", 1))),
        L["Match"]("fa", "x"),
    ]


@pytest.mark.parametrize("i", range(5))
def test_planner_on_cmp_trees_matches_reference(i):
    js, ps = _planner_stores()
    jt, pt = planner_trees(JLIB)[i], planner_trees(PLIB)[i]
    jp = jax_plan_query(js, jt, 0, 1000)
    pp = plan_query(ps, pt, 0, 1000)
    assert pp.describe() == jp.describe()
    assert (pp.mode, pp.combine) == (jp.mode, jp.combine)
    assert type(pp.residual).__name__ == type(jp.residual).__name__
    assert_same_program(compile_tree(ps, pt), jax_compile_tree(js, jt))
    if i < 2:  # heuristic 4: the whole tree filters
        assert pp.mode == "filter" and pp.residual is pt


QUERY_TREES = [7, 8, 11, 13]  # Match, Eq AND Cmp, Cmp, Cmp OR Match


@pytest.mark.parametrize("i", QUERY_TREES)
@pytest.mark.parametrize("scheme", ["scan", "batched_scan", "index", "batched_index"])
def test_host_schemes_match_reference(stores, i, scheme):
    js, ps, _, _ = stores
    t0, t1 = 1000, 6000
    want = sum(b.n for b in JaxQueryProcessor(js).run_scheme(scheme, t0, t1,
                                                             store_trees(JLIB)[i]))
    got = sum(b.n for b in QueryProcessor(ps, device="cpu").run_scheme(scheme, t0, t1,
                                                                       store_trees(PLIB)[i]))
    assert got == want > 0


def _results_equal(got, want):
    for name in ("gids", "values", "counts"):
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=name)


@pytest.mark.parametrize("i", [7, 8])
def test_host_aggregate_matches_reference(stores, i):
    js, ps, _, _ = stores
    specs = [(JSpec(group_by=("status",), time_bucket_s=3600),
              AggregateSpec(group_by=("status",), time_bucket_s=3600)),
             (JSpec(group_by=("method",), op="max", value_field="bytes_out"),
              AggregateSpec(group_by=("method",), op="max", value_field="bytes_out"))]
    for jspec, pspec in specs:
        want = JaxQueryProcessor(js).aggregate(jspec, 0, T_STOP, store_trees(JLIB)[i])
        got = QueryProcessor(ps, device="cpu").aggregate(pspec, 0, T_STOP, store_trees(PLIB)[i])
        _results_equal(got, want)


@pytest.fixture(scope="module")
def planes():
    ts, vals = gen_events(seed=5, n=1200)
    jstore, pstore = JaxEventStore(jax_schema()), EventStore(web_proxy_schema(), device="cpu")
    sizes = dict(mem_rows=64, max_runs=2, append_rows=32)
    jplane = JaxPlane.for_store(jstore, make_dev_mesh(1, 1), capacity=1024,
                                tablets_per_device=4, **sizes)
    pplane = DistIngestPlane.for_store(pstore, capacity=1024, n_tablets=4, device="cpu", **sizes)
    jw = JaxWriter(jstore, jplane, batch_rows=200, writer_id=2)
    pw = DistBatchWriter(pstore, pplane, batch_rows=200, writer_id=2)
    for off in range(0, len(ts), 150):
        part = {k: v[off: off + 150] for k, v in vals.items()}
        jw.add(ts[off: off + 150], part)
        pw.add(ts[off: off + 150], part)
    jw.close()
    pw.close()
    return (JaxProcessor(jstore, plane=jplane), DistQueryProcessor(pstore, pplane, device="cpu"),
            ts, vals)


@pytest.mark.parametrize("i", [7, 8])
def test_dist_scan_and_aggregate_match_reference(planes, i):
    jq, pq, ts, vals = planes
    jt, pt = store_trees(JLIB)[i], store_trees(PLIB)[i]
    for t0, t1 in ((0, T_STOP), (900, 4000)):
        want = jq.scan_range(jt, t0, t1)
        got = pq.scan_range(pt, t0, t1)
        assert got[0] == want[0]
        np.testing.assert_array_equal(np.sort(got[1]), np.sort(want[1]))
    mask = eval_tree_rows(pq.store, pt, pq.store.encode_events(np.zeros(len(ts)), vals))
    got = pq.aggregate_range(AggregateSpec(group_by=("status",), time_bucket_s=3600), pt,
                             0, T_STOP)
    want = jq.aggregate_range(JSpec(group_by=("status",), time_bucket_s=3600), jt, 0, T_STOP)
    _results_equal(got, want)
    assert int(got.counts.sum()) == int(mask.sum()) > 0
