"""The port's density read, published ix/ag levels, index step and four
schemes against the JAX reference's.

Both packages ingest the same numpy-seeded events into planes of the
same shape and leave rows at every LSM level (base, runs, sealed
memtable). Everything compared is an integer, so every comparison is
exact with equal dtypes (no tolerance): densities against the JAX
processor's and both host stores' aggregate tables; snapshot levels
tensor for tensor; scan_index_range's count, truncation, candidates and
top-k slates (as multisets, since BatchScanner order is free within equal
rev_ts) for the reference's tree set (tests/test_dist_index.py); and the
totals of all four schemes against the reference and the port's host
oracle. Adaptive batch ranges depend on measured times, so only totals
are compared for the batched schemes.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from repro.core import And as JAnd, Eq as JEq, Not as JNot, Or as JOr
from repro.core import EventStore as JaxEventStore, web_proxy_schema as jax_schema
from repro.core.dist_ingest import DistBatchWriter as JaxWriter, DistIngestPlane as JaxPlane
from repro.core.dist_query import DistQueryProcessor as JaxProcessor
from repro.core.planner import plan_query as jax_plan_query
from repro.launch.mesh import make_dev_mesh

from repro_torch.core import dist_query
from repro_torch.core import filter as pf
from repro_torch.core.dist_ingest import DistBatchWriter, DistIngestPlane
from repro_torch.core.dist_query import DistQueryProcessor, QueryStats, density_step
from repro_torch.core.planner import plan_query
from repro_torch.core.scan import scan_events
from repro_torch.core.schema import web_proxy_schema
from repro_torch.core.store import EventStore
from repro_torch.kernels.filter_scan import filter_scan, pad_program

T_SPAN = 4 * 3600
SIZES = dict(mem_rows=64, max_runs=2, append_rows=32)
SCHEMES = ["scan", "batched_scan", "index", "batched_index"]


def gen_events(seed, n):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, T_SPAN, n))
    vals = {
        "domain": rng.choice(["a.com", "b.com", "c.com", "rare.net"],
                             p=[0.6, 0.25, 0.13, 0.02], size=n).tolist(),
        "method": rng.choice(["GET", "POST"], size=n).tolist(),
        "status": rng.choice(["200", "404"], size=n, p=[0.8, 0.2]).tolist(),
    }
    return ts, vals


def make_twin(seed, n, capacity, sizes, **proc_kw):
    ts, vals = gen_events(seed, n)
    jstore, pstore = JaxEventStore(jax_schema()), EventStore(web_proxy_schema(), device="cpu")
    jstore.ingest(ts, vals)
    pstore.ingest(ts, vals)  # the port's host oracle
    jplane = JaxPlane.for_store(jstore, make_dev_mesh(1, 1), capacity=capacity,
                                tablets_per_device=4, **sizes)
    pplane = DistIngestPlane.for_store(pstore, capacity=capacity, n_tablets=4, device="cpu",
                                       **sizes)
    jw = JaxWriter(jstore, jplane, batch_rows=200, writer_id=1)
    pw = DistBatchWriter(pstore, pplane, batch_rows=200, writer_id=1)
    for off in range(0, len(ts), 123):
        part = {k: v[off: off + 123] for k, v in vals.items()}
        jw.add(ts[off: off + 123], part)
        pw.add(ts[off: off + 123], part)
    jw.close()
    pw.close()
    return dict(vals=vals, jstore=jstore, pstore=pstore, jplane=jplane, pplane=pplane,
                jq=JaxProcessor(jstore, plane=jplane, **proc_kw),
                pq=DistQueryProcessor(pstore, pplane, device="cpu", **proc_kw))


@pytest.fixture(scope="module")
def twin():
    tw = make_twin(21, 1500, 1024, SIZES)
    tel = tw["pplane"].telemetry()
    # Rows at every level: folded bases, live runs and memtables.
    assert tel["base_n"].min() > 0 and tel["n_runs"].min() > 0 and tel["mem_n"].min() > 0
    return tw


@pytest.fixture(scope="module")
def unfolded():
    """Nothing folded yet: every row sits in a run or the memtable."""
    tw = make_twin(5, 300, 1024, dict(mem_rows=64, max_runs=8, append_rows=32))
    tel = tw["pplane"].telemetry()
    assert tel["base_n"].max() == 0 and tel["ag_base_n"].max() == 0 and tel["n_runs"].min() > 0
    return tw


# The reference's tree set (tests/test_dist_index.py): ANDs of two and
# three equalities, an AND with a NOT, ORs, never-seen values and None.
def trees(lib):
    eq, not_, and_, or_ = lib
    return [
        eq("domain", "rare.net"),
        eq("domain", "c.com"),
        eq("domain", "never-seen.com"),
        and_(eq("domain", "rare.net"), eq("method", "GET")),
        and_(eq("domain", "c.com"), eq("status", "404"), eq("method", "POST")),
        and_(eq("domain", "c.com"), not_(eq("method", "POST"))),
        or_(eq("domain", "rare.net"), eq("domain", "c.com")),
        or_(eq("domain", "rare.net"), eq("status", "404")),
        and_(eq("domain", "rare.net"), eq("domain", "never-seen.com")),
        None,
    ]


JTREES = trees((JEq, JNot, JAnd, JOr))
PTREES = trees((pf.Eq, pf.Not, pf.And, pf.Or))
RANGES = [(0, T_SPAN), (1800, 5400), (7000, 7000)]


def host_count(store, tree, t0, t1):
    program = tuple(torch.from_numpy(a) for a in pad_program(pf.compile_tree(store, tree)))
    return sum(int(filter_scan(torch.from_numpy(b.cols), *program).sum())
               for b in scan_events(store, t0, t1))


def plan_key(plan):
    return (plan.mode, plan.combine, [(c.field, c.value, c.density) for c in plan.index_conds],
            type(plan.residual).__name__, plan.describe())


def slate(ts, cols):
    return Counter((int(t), tuple(int(x) for x in c)) for t, c in zip(ts, cols))


# ------------------------------------------------------------- density
@pytest.mark.parametrize("fixture", ["twin", "unfolded"])
@pytest.mark.parametrize("fv", [("domain", "rare.net"), ("domain", "a.com"), ("status", "404"),
                                ("method", "GET"), ("domain", "no.such")])
@pytest.mark.parametrize("t_range", RANGES)
def test_density_read_matches_reference_and_host(request, fixture, fv, t_range):
    tw = request.getfixturevalue(fixture)
    got = tw["pq"].agg_count(*fv, *t_range)
    assert got == tw["jq"].agg_count(*fv, *t_range)
    assert got == tw["pstore"].agg_count(*fv, *t_range) == tw["jstore"].agg_count(*fv, *t_range)
    assert isinstance(got, int)


def test_density_step_is_int64_and_memoized_per_snapshot(twin):
    pq = twin["pq"]
    d = pq._sync()
    assert density_step(d, 0, 2**62).dtype == torch.int64
    d.density_cache.clear()
    first = pq._agg_count_on(d, "domain", "c.com", 0, T_SPAN)
    assert d.density_cache == {("domain", "c.com", 0, T_SPAN): first}
    assert pq.agg_count("domain", "c.com", 0, T_SPAN) == first  # same snapshot, cached


# ------------------------------------------------------------ snapshot
IX_AG_LEVELS = ["ix_keys", "ix_counts", "ix_run_k", "ix_run_n", "ix_mem_k", "ix_mem_n",
                "ag_keys", "ag_vals", "ag_counts", "ag_run_k", "ag_run_c", "ag_run_n",
                "ag_mem_k", "ag_mem_c", "ag_mem_n"]


def assert_ix_ag_levels_equal(jd, pd):
    assert pd.has_index and pd.has_runs and pd.agg_bucket_s == jd.agg_bucket_s
    for name in IX_AG_LEVELS:
        want = np.asarray(getattr(jd, name))
        got = getattr(pd, name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_published_ix_ag_levels_match_reference_after_every_publish():
    tw = make_twin(33, 700, 1024, SIZES)
    jplane, pplane = tw["jplane"], tw["pplane"]
    assert_ix_ag_levels_equal(jplane.publish(), pplane.publish())
    ts, vals = gen_events(34, 90)
    for off in range(0, 90, 30):
        part = {k: v[off: off + 30] for k, v in vals.items()}
        for w in (JaxWriter(tw["jstore"], jplane, batch_rows=30, writer_id=2),
                  DistBatchWriter(tw["pstore"], pplane, batch_rows=30, writer_id=2)):
            w.add(ts[off: off + 30], part)
            w.close()
        assert_ix_ag_levels_equal(jplane.publish(), pplane.publish())
    steps = 0
    while jplane.compact_step():
        assert pplane.compact_step() == 1
        before = pplane.publish()
        assert_ix_ag_levels_equal(jplane.publish(), before)
        steps += 1
    assert pplane.compact_step() == 0 and steps > 0


def test_fold_only_compact_step_reuses_every_sealed_family():
    tw = make_twin(35, 500, 1024, SIZES)
    pplane = tw["pplane"]
    assert pplane.telemetry()["n_runs"].max() > 0
    before = pplane.publish()
    assert pplane.compact_step() == 1  # runs exist, so this increment only folds
    after = pplane.publish()
    assert after is not before and pplane.seal_reuses > 0
    for name in ("mem_rev_ts", "mem_cols", "mem_counts", "ix_mem_k", "ix_mem_n",
                 "ag_mem_k", "ag_mem_c", "ag_mem_n"):
        assert getattr(after, name) is getattr(before, name), name
    assert after.ix_keys is not before.ix_keys  # the fold wrote a new base
    tw["jplane"].publish()
    assert tw["jplane"].compact_step() == 1
    assert_ix_ag_levels_equal(tw["jplane"].publish(), after)


def test_index_less_plane_plans_every_query_as_a_scan():
    ts, vals = gen_events(3, 400)
    store = EventStore(web_proxy_schema(), device="cpu")
    plane = DistIngestPlane(store.schema.n_fields, capacity=1024, n_tablets=2, device="cpu",
                            **SIZES)
    w = DistBatchWriter(store, plane, batch_rows=100)
    w.add(ts, vals)
    w.close()
    pq = DistQueryProcessor(store, plane, device="cpu")
    assert not pq.dist.has_index
    stats = QueryStats()
    got = sum(b.count for b in pq.run_scheme("batched_index", 0, T_SPAN,
                                             pf.Eq("domain", "c.com"), stats=stats))
    assert got == vals["domain"].count("c.com") and stats.plan.mode == "filter"


# ---------------------------------------------------------- index step
@pytest.mark.parametrize("i", range(len(PTREES)))
@pytest.mark.parametrize("t_range", RANGES)
def test_scan_index_range_matches_reference(twin, i, t_range):
    t0, t1 = t_range
    jplan = jax_plan_query(twin["jq"], JTREES[i], 0, T_SPAN)
    pplan = plan_query(twin["pq"], PTREES[i], 0, T_SPAN)
    assert plan_key(pplan) == plan_key(jplan)
    if pplan.mode != "index":
        return
    jc, jts, jcols, jtr, jca = twin["jq"].scan_index_range(jplan, JTREES[i], t0, t1)
    pc, pts, pcols, ptr, pca = twin["pq"].scan_index_range(pplan, PTREES[i], t0, t1)
    assert (pc, ptr, pca) == (jc, jtr, jca)
    assert pts.dtype == jts.dtype and pcols.dtype == jcols.dtype
    assert slate(pts, pcols) == slate(jts, jcols)
    if not ptr:
        assert pc == host_count(twin["pstore"], PTREES[i], t0, t1)


def test_index_step_outputs_are_int32(twin):
    pq = twin["pq"]
    d = pq._sync()
    plan = plan_query(pq, PTREES[4], 0, T_SPAN)
    lo, hi = (torch.from_numpy(x) for x in pq._cond_ranges(plan, 0, T_SPAN))
    out = dist_query.index_step(d, pq._program(PTREES[4], d.device), lo, hi, plan.combine)
    count, ts, cols, truncated, cands = out
    assert all(x.dtype == torch.int32 for x in out)
    assert ts.shape == (4, 128) and cols.shape == (4, 128, 12)
    assert count.shape == truncated.shape == cands.shape == ()


# -------------------------------------------------------------- schemes
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("i", range(len(PTREES)))
def test_scheme_totals_match_reference_and_host(twin, scheme, i):
    jt = sum(b.count for b in twin["jq"].run_scheme(scheme, 900, 9000, JTREES[i]))
    stats = QueryStats()
    blocks = list(twin["pq"].run_scheme(scheme, 900, 9000, PTREES[i], stats=stats))
    got = sum(b.count for b in blocks)
    assert got == jt == host_count(twin["pstore"], PTREES[i], 900, 9000)
    assert stats.rows == got and stats.batches == len(blocks)
    want_mode = plan_query(twin["pstore"], PTREES[i], 900, 9000,
                           use_index=scheme.endswith("index")).mode
    assert stats.plan.mode == want_mode
    assert all(a.hi < b.lo for a, b in zip(blocks, blocks[1:]))


def test_index_path_is_used_and_returns_matching_rows(twin):
    stats = QueryStats()
    tree = pf.Eq("domain", "rare.net")
    blocks = list(twin["pq"].run_scheme("index", 0, T_SPAN, tree, stats=stats))
    assert sum(b.count for b in blocks) == twin["vals"]["domain"].count("rare.net")
    assert stats.plan.mode == "index" and stats.index_keys_scanned > 0
    code = twin["pstore"].dictionaries["domain"].lookup("rare.net")
    fid = twin["pstore"].schema.field_id("domain")
    assert all((b.cols[:, fid] == code).all() for b in blocks)


def test_and_query_runs_the_membership_wrapper(twin, monkeypatch):
    calls = []
    wrapped = dist_query.member_mask

    def counting(a, b):
        calls.append(tuple(a.shape))
        return wrapped(a, b)

    monkeypatch.setattr(dist_query, "member_mask", counting)
    stats = QueryStats()
    tree = PTREES[4]  # AND of three equalities, all three indexed
    got = sum(b.count for b in twin["pq"].run_scheme("batched_index", 0, T_SPAN, tree,
                                                     stats=stats))
    assert got == host_count(twin["pstore"], tree, 0, T_SPAN)
    assert len(stats.plan.index_conds) == 3
    assert len(calls) == 2 * stats.batches and calls[0][0] == 4  # one call per condition


# -------------------------------------------------- fallback and empty plans
def test_truncation_falls_back_to_the_exact_scan():
    tw = make_twin(21, 1500, 1024, SIZES, index_postings=8, index_rows=8)
    tree = pf.Eq("domain", "c.com")
    plan = plan_query(tw["pq"], tree, 0, T_SPAN)
    pc, _, _, ptr, pca = tw["pq"].scan_index_range(plan, tree, 0, T_SPAN)
    jplan = jax_plan_query(tw["jq"], JTREES[1], 0, T_SPAN)
    jc, _, _, jtr, jca = tw["jq"].scan_index_range(jplan, JTREES[1], 0, T_SPAN)
    assert (pc, ptr, pca) == (jc, jtr, jca) and ptr > 0
    want = host_count(tw["pstore"], tree, 0, T_SPAN)
    for scheme in ("index", "batched_index"):
        got = sum(b.count for b in tw["pq"].run_scheme(scheme, 0, T_SPAN, tree))
        assert got == want == sum(b.count for b in tw["jq"].run_scheme(scheme, 0, T_SPAN,
                                                                       JTREES[1]))


def test_zero_density_plan_does_no_device_work(twin, monkeypatch):
    def forbidden(*args, **kw):
        raise AssertionError("an empty plan reached a device step")

    monkeypatch.setattr(dist_query, "index_step", forbidden)
    monkeypatch.setattr(dist_query, "scan_step", forbidden)
    for tree in (PTREES[2], PTREES[8]):
        for scheme in ("index", "batched_index"):
            stats = QueryStats()
            assert list(twin["pq"].run_scheme(scheme, 0, T_SPAN, tree, stats=stats)) == []
            assert stats.plan.mode == "empty" and stats.batches == 0
