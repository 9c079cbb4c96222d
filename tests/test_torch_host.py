"""The port's host-side modules against the JAX package's: packed keys,
dictionaries, compiled filter programs, the Alg-1 batcher, the planner's
filter branch, the host EventStore's tablets, the synthetic source, and
the rule that the port imports neither jax nor the reference."""
import ast
import pathlib

import numpy as np
import pytest

from repro.core import keypack as jk
from repro.core import EventStore as JaxEventStore, web_proxy_schema as jax_schema
from repro.core import And as JAnd, Eq as JEq, In as JIn, Not as JNot, Or as JOr
from repro.core.batching import AdaptiveBatcher as JaxBatcher, alg1_next_k as jax_alg1
from repro.core.filter import compile_tree as jax_compile_tree
from repro.core.ingest import BatchWriter as JaxBatchWriter
from repro.core.planner import plan_query as jax_plan_query
from repro.pipeline.sources import (
    SyntheticWebProxySource as JaxSource,
    parse_web_proxy_lines as jax_parse,
)

from repro_torch.core import keypack as pk
from repro_torch.core import filter as pf
from repro_torch.core.batching import AdaptiveBatcher, alg1_next_k
from repro_torch.core.ingest import BatchWriter
from repro_torch.core.planner import plan_query
from repro_torch.core.scan import scan_events
from repro_torch.core.schema import web_proxy_schema
from repro_torch.core.store import EventStore
from repro_torch.pipeline.sources import SyntheticWebProxySource, parse_web_proxy_lines

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_packed_keys_match_reference():
    rng = np.random.default_rng(0)
    shard = rng.integers(0, jk.MAX_SHARDS, 200)
    ts = rng.integers(0, jk.TS_MAX, 200)
    h = rng.integers(0, jk.HASH_MAX, 200)
    field = rng.integers(0, 12, 200)
    value = rng.integers(0, jk.MAX_VALUES, 200)
    np.testing.assert_array_equal(pk.rev_ts(ts), jk.rev_ts(ts))
    np.testing.assert_array_equal(pk.unrev_ts(ts), jk.unrev_ts(ts))
    np.testing.assert_array_equal(pk.pack_event_key(shard, ts, h), jk.pack_event_key(shard, ts, h))
    np.testing.assert_array_equal(pk.pack_index_key(field, value, ts),
                                  jk.pack_index_key(field, value, ts))
    np.testing.assert_array_equal(pk.pack_agg_key(field, value, ts // 3600),
                                  jk.pack_agg_key(field, value, ts // 3600))
    np.testing.assert_array_equal(pk.short_hash(shard, ts, h), jk.short_hash(shard, ts, h))
    assert pk.event_key_range(3, 100, 900) == jk.event_key_range(3, 100, 900)
    # The device append synthesises keys with these shifts.
    assert pk.IX_FIELD_SHIFT == jk._IX_FIELD_SHIFT and pk.AG_FIELD_SHIFT == jk._AG_FIELD_SHIFT


def test_dictionaries_and_encoding_match_reference():
    rng = np.random.default_rng(1)
    vals = {"domain": rng.choice(["x.com", "y.com", "z.org"], 300).tolist(),
            "status": rng.choice(["200", "404"], 300).tolist()}
    js, ps = JaxEventStore(jax_schema()), EventStore(web_proxy_schema(), device="cpu")
    np.testing.assert_array_equal(ps.encode_events(np.zeros(300), vals),
                                  js.encode_events(np.zeros(300), vals))
    for name in ("domain", "status", "method"):
        for value in ("x.com", "y.com", "z.org", "200", "404", "", "never-seen"):
            assert ps.dictionaries[name].lookup(value) == js.dictionaries[name].lookup(value)
    assert ps.schema.field_names() == js.schema.field_names()


def trees(lib):
    eq, in_, not_, and_, or_ = lib
    return [
        None,
        eq("domain", "x.com"),
        eq("domain", "never-seen"),
        in_("status", ("200", "nope")),
        not_(eq("method", "GET")),
        and_(eq("domain", "x.com"), or_(eq("status", "404"), not_(in_("method", ("PUT",))))),
        or_(*(eq("domain", d) for d in ("x.com", "y.com", "z.org"))),
    ]


@pytest.mark.parametrize("i", range(7))
def test_compiled_programs_match_reference(i):
    vals = {"domain": ["x.com", "y.com", "z.org"], "status": ["200", "404", "200"],
            "method": ["GET", "PUT", "POST"]}
    js, ps = JaxEventStore(jax_schema()), EventStore(web_proxy_schema(), device="cpu")
    js.encode_events(np.zeros(3), vals)
    ps.encode_events(np.zeros(3), vals)
    jp = jax_compile_tree(js, trees((JEq, JIn, JNot, JAnd, JOr))[i])
    pp = pf.compile_tree(ps, trees((pf.Eq, pf.In, pf.Not, pf.And, pf.Or))[i])
    for name in ("opcodes", "arg0", "arg1", "codesets"):
        got, want = getattr(pp, name), getattr(jp, name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert pp.max_depth == jp.max_depth


def test_too_deep_tree_is_rejected_like_the_reference():
    ps, js = EventStore(web_proxy_schema(), device="cpu"), JaxEventStore(jax_schema())
    tree, jtree = pf.Eq("domain", "x"), JEq("domain", "x")
    for _ in range(8):  # each right-nested AND needs one more stack slot
        tree, jtree = pf.And(pf.Eq("status", "y"), tree), JAnd(JEq("status", "y"), jtree)
    with pytest.raises(ValueError, match="too deep"):
        jax_compile_tree(js, jtree)
    with pytest.raises(ValueError, match="too deep"):
        pf.compile_tree(ps, tree)


@pytest.mark.parametrize("seed", range(4))
def test_alg1_batches_match_reference(seed):
    rng = np.random.default_rng(seed)
    reports = [(float(rng.uniform(1e-4, 40.0)), int(rng.integers(0, 5000))) for _ in range(40)]
    for runtime, rows in reports[:10]:
        assert alg1_next_k(25.0, runtime, rows, 1.5, 30.0, 1.0) == jax_alg1(
            25.0, runtime, rows, 1.5, 30.0, 1.0)
    b0 = float(rng.uniform(1, 100))
    jb, pb = JaxBatcher(0, 14400, b0), AdaptiveBatcher(0, 14400, b0)
    for runtime, rows in reports:
        if jb.done:
            break
        assert pb.next_range() == jb.next_range() and pb.done == jb.done
        jb.update(runtime, rows)
        pb.update(runtime, rows)
    assert pb.done == jb.done
    assert [(r.p, r.b, r.k) for r in pb.history] == [(r.p, r.b, r.k) for r in jb.history]
    with pytest.raises(ValueError):
        AdaptiveBatcher(10, 5, 1.0)


@pytest.mark.parametrize("b0", [99.5, 40.5, 0.25, 7.0])
def test_batches_read_every_second_to_t_stop(b0):
    """The seconds the batches read, [int(lo), int(hi)] each, tile
    [t_start, t_stop] once, also where a range ends less than eps short
    of t_stop (b0 = 99.5 on [0, 100]: the reference's batches stop at
    second 99 there)."""
    rng = np.random.default_rng(int(b0 * 4))
    for t_stop in (0, 1, 100, 14400):
        pb = AdaptiveBatcher(0, t_stop, b0)
        seconds = []
        while not pb.done:
            lo, hi = pb.next_range()
            seconds.extend(range(int(lo), int(hi) + 1))
            pb.update(float(rng.uniform(1e-3, 40.0)), int(rng.integers(0, 50)))
        assert seconds == list(range(t_stop + 1))


@pytest.mark.parametrize("i", range(7))
def test_filter_plans_match_reference(i):
    js, ps = JaxEventStore(jax_schema()), EventStore(web_proxy_schema(), device="cpu")
    jt = trees((JEq, JIn, JNot, JAnd, JOr))[i]
    pt = trees((pf.Eq, pf.In, pf.Not, pf.And, pf.Or))[i]
    jp = jax_plan_query(js, jt, 0, 3600, use_index=False)
    pp = plan_query(ps, pt, 0, 3600, use_index=False)
    assert pp.mode == jp.mode == "filter"
    assert type(pp.residual).__name__ == type(jp.residual).__name__


@pytest.fixture(scope="module")
def planner_stores():
    """Both host stores over the same events, with every density regime
    the heuristics tell apart: x.com 10 rows, status s99 99 and s100 100
    rows (just under and at w = 10 times x.com's density), and common
    values in the thousands."""
    rng = np.random.default_rng(12)
    n = 3000
    vals = {"domain": rng.choice(["y.com", "z.org"], n).tolist(),
            "status": rng.choice(["200", "404"], n).tolist(),
            "method": rng.choice(["GET", "PUT", "POST"], n).tolist()}
    vals["domain"][:10] = ["x.com"] * 10
    vals["status"][10:109] = ["s99"] * 99
    vals["status"][109:209] = ["s100"] * 100
    ts = np.sort(rng.integers(0, 14400, n))
    kw = dict(n_shards=3, flush_rows=500, max_runs=2)
    js, ps = JaxEventStore(jax_schema(), **kw), EventStore(web_proxy_schema(), **kw, device="cpu")
    js.ingest(ts, vals)
    ps.ingest(ts, vals)
    return js, ps


def index_trees(lib):
    eq, in_, not_, and_, or_ = lib
    return [
        eq("domain", "x.com"),  # heuristic 1
        eq("domain", "never-seen"),  # heuristic 1, zero density: empty
        or_(eq("domain", "x.com"), eq("status", "404")),  # heuristic 2
        or_(eq("domain", "x.com"), in_("status", ("404",))),  # not all Eq: heuristic 4
        and_(eq("domain", "x.com"), eq("status", "s99")),  # 99 < 10 * 10: both indexed
        and_(eq("domain", "x.com"), eq("status", "s100")),  # 100 = 10 * 10: s100 is residual
        and_(eq("domain", "y.com"), eq("status", "404"), not_(eq("method", "GET"))),
        and_(eq("domain", "x.com"), eq("domain", "never-seen"), eq("status", "200")),  # empty
        and_(in_("method", ("GET",)), not_(eq("status", "200"))),  # no Eq child: heuristic 4
        not_(eq("domain", "x.com")),  # heuristic 4
        None,
    ]


@pytest.mark.parametrize("i", range(11))
@pytest.mark.parametrize("w", [10.0, 2.0])
@pytest.mark.parametrize("t_range", [(0, 14400), (3600, 7199)])
def test_index_plans_match_reference(planner_stores, i, w, t_range):
    js, ps = planner_stores
    jp = jax_plan_query(js, index_trees((JEq, JIn, JNot, JAnd, JOr))[i], *t_range, w=w)
    pp = plan_query(ps, index_trees((pf.Eq, pf.In, pf.Not, pf.And, pf.Or))[i], *t_range, w=w)
    assert (pp.mode, pp.combine) == (jp.mode, jp.combine)
    assert [(c.field, c.value, c.density) for c in pp.index_conds] == [
        (c.field, c.value, c.density) for c in jp.index_conds]
    assert type(pp.residual).__name__ == type(jp.residual).__name__
    assert pp.describe() == jp.describe()


def test_w_boundary_selects_like_the_reference(planner_stores):
    _, ps = planner_stores
    under = plan_query(ps, pf.And(pf.Eq("domain", "x.com"), pf.Eq("status", "s99")), 0, 14400)
    at = plan_query(ps, pf.And(pf.Eq("domain", "x.com"), pf.Eq("status", "s100")), 0, 14400)
    assert [c.value for c in under.index_conds] == ["x.com", "s99"]
    assert [c.value for c in at.index_conds] == ["x.com"]
    assert at.residual == pf.And(pf.Eq("status", "s100"))
    assert plan_query(ps, pf.Eq("domain", "x.com"), 0, 14400, use_index=False).mode == "filter"


@pytest.mark.parametrize("fv", [("domain", "x.com"), ("status", "s100"), ("method", "PUT"),
                                ("domain", "never-seen")])
def test_host_agg_count_matches_reference(planner_stores, fv):
    js, ps = planner_stores
    for t0, t1 in [(0, 14400), (3600, 7199), (5000, 5000), (7200, 3600)]:
        assert ps.agg_count(*fv, t0, t1) == js.agg_count(*fv, t0, t1)
    want = {"x.com": 10, "s100": 100}.get(fv[1])
    if want is not None:
        assert ps.agg_count(*fv, 0, 14400) == want


def test_host_store_tablets_match_reference():
    src = JaxSource(seed=5)
    ts, vals = jax_parse(src.gen_lines(3000, 0, 14400))
    kw = dict(n_shards=3, flush_rows=400, max_runs=2, seed=9)
    js, ps = JaxEventStore(jax_schema(), **kw), EventStore(web_proxy_schema(), **kw, device="cpu")
    jw, pw = JaxBatchWriter(js, batch_rows=700), BatchWriter(ps, batch_rows=700)
    for off in range(0, 3000, 450):
        part = {k: v[off: off + 450] for k, v in vals.items()}
        jw.add(ts[off: off + 450], part, nbytes=10)
        pw.add(ts[off: off + 450], part, nbytes=10)
    jw.close()
    pw.close()
    assert (pw.metrics.rows, pw.metrics.flushes, pw.metrics.bytes) == (
        jw.metrics.rows, jw.metrics.flushes, jw.metrics.bytes)
    assert ps.rows_per_second() == js.rows_per_second()
    # The tablets' runs (minor and major compactions through
    # merge_sorted_runs) are identical.
    pairs = list(zip(ps.event_tablets + ps.index_tablets + [ps.agg_tablet],
                     js.event_tablets + js.index_tablets + [js.agg_tablet]))
    assert sum(p.major_compactions for p, _ in pairs) > 0
    for p, j in pairs:
        assert (p.minor_compactions, p.major_compactions) == (
            j.minor_compactions, j.major_compactions)
        assert len(p.runs) == len(j.runs)
        for pr_, jr in zip(p.runs, j.runs):
            np.testing.assert_array_equal(pr_.keys, jr.keys)
            np.testing.assert_array_equal(pr_.cols, jr.cols)
            assert pr_.cols.dtype == jr.cols.dtype
    got = [(b.keys, b.cols) for b in scan_events(ps, 1000, 9000)]
    from repro.core.scan import scan_events as jax_scan_events

    want = [(b.keys, b.cols) for b in jax_scan_events(js, 1000, 9000)]
    assert len(got) == len(want)
    for (gk, gc), (wk, wc) in zip(got, want):
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gc, wc)


def test_synthetic_source_matches_reference():
    jl = JaxSource(seed=3).gen_lines(500, 0, 14400)
    pl = SyntheticWebProxySource(seed=3).gen_lines(500, 0, 14400)
    assert pl == jl
    jts, jcols = jax_parse(jl)
    pts, pcols = parse_web_proxy_lines(pl)
    np.testing.assert_array_equal(pts, jts)
    assert pcols == jcols
    for q in (0.0, 0.3, 0.99):
        assert SyntheticWebProxySource(seed=3).domain_by_popularity(q) == \
            JaxSource(seed=3).domain_by_popularity(q)


def port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert files
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"
