"""The port's scan-time aggregation on the host against the JAX package's:
the combine_scan and aggregate_combine kernels' plain versions, every
iterator and the stack's rules, and the host QueryProcessor's five
schemes and aggregate(). The kernels' tile stitch runs only on the card
(tests/test_torch_gpu.py).

Both packages get the same numpy-seeded events. The store is integers, so
every comparison is bit for bit with equal dtypes (the tolerance is
none). The port runs on the CPU (device="cpu"), where its kernel wrappers
run their plain versions; the reference runs its jnp paths, and its
Pallas kernels in interpret mode where its own tests do.
"""
from collections import Counter

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import AggregateSpec as JSpec, EventStore as JaxEventStore
from repro.core import And as JAnd, Eq as JEq, Not as JNot, Or as JOr
from repro.core import QueryProcessor as JaxQP, QueryStats as JaxStats
from repro.core import web_proxy_schema as jax_schema
from repro.core.filter import compile_tree as jax_compile_tree
from repro.core.iterators import resolve_grouping as jax_resolve_grouping
from repro.core.scan import RowBlock as JaxRowBlock
from repro.core.scan import scan_events as jax_scan_events
from repro.kernels.aggregate_combine import combine_sorted_counts as jax_combine_sorted_counts
from repro.kernels.combine_scan import combine_scan as jax_combine_scan

from repro_torch.core import (
    AggregateSpec,
    CombinerIterator,
    EventStore,
    FilterIterator,
    IteratorStack,
    ProjectingIterator,
    QueryProcessor,
    QueryStats,
    VersioningIterator,
    merge_aggregate_blocks,
    resolve_grouping,
    web_proxy_schema,
)
from repro_torch.core import filter as pf
from repro_torch.core.scan import RowBlock, fetch_rows_by_keys, index_scan, scan_events
from repro_torch.kernels.aggregate_combine import combine_blocks, combine_sorted_counts
from repro_torch.kernels.combine_scan import combine_scan, combine_scan_ref, combine_segments
from repro_torch.kernels.filter_scan import program_tensors
from repro_torch.kernels.merge_intersect import intersect_sorted, union_sorted

T_STOP = 4 * 3600
N = 6000
OPS = ["count", "sum", "min", "max"]


@pytest.fixture(scope="module")
def stores():
    """The reference's aggregation workload (tests/test_iterators.py) at a
    third of its size, in a JAX and a port EventStore."""
    rng = np.random.default_rng(11)
    ts = np.sort(rng.integers(0, T_STOP, N))
    data = {
        "domain": rng.choice(["alpha.com", "beta.org", "gamma.net", "delta.io"],
                             p=[0.5, 0.3, 0.15, 0.05], size=N).tolist(),
        "method": rng.choice(["GET", "POST", "PUT"], size=N).tolist(),
        "status": rng.choice(["200", "404", "500"], size=N, p=[0.7, 0.2, 0.1]).tolist(),
        "bytes_out": rng.integers(100, 5000, N).astype(str).tolist(),
    }
    js = JaxEventStore(jax_schema(), n_shards=4, flush_rows=1024)
    ps = EventStore(web_proxy_schema(), n_shards=4, flush_rows=1024, device="cpu")
    for s in (js, ps):
        s.ingest(ts, data)
        s.flush_all()
        s.compact_all()
    return js, ps, ts, data


SPEC_ARGS = [
    dict(group_by=("method",), op="count"),
    dict(group_by=("status",), op="count", time_bucket_s=3600),
    dict(group_by=("status", "method"), op="count"),
    dict(group_by=("method",), op="sum", value_field="bytes_out"),
    dict(group_by=("method",), op="min", value_field="bytes_out"),
    dict(group_by=("status",), op="max", value_field="bytes_out", time_bucket_s=1800),
]


def trees(eq, not_, and_, or_):
    return [
        None,
        eq("domain", "alpha.com"),
        and_(eq("domain", "beta.org"), not_(eq("status", "500"))),
        or_(eq("domain", "gamma.net"), eq("status", "404")),
    ]


JTREES = trees(JEq, JNot, JAnd, JOr)
PTREES = trees(pf.Eq, pf.Not, pf.And, pf.Or)


def assert_same(got, want):
    """Arrays bit for bit with equal dtypes."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def assert_results_equal(got, want):
    for name in ("gids", "values", "counts"):
        assert_same(getattr(got, name), getattr(want, name))


def rows_inputs(rng, stores_, n, n_groups=50, hi=1000):
    """Sorted group keys, int32 values and codes a filter can act on."""
    _, ps, _, _ = stores_
    f = ps.schema.n_fields
    cols = np.zeros((n, f), np.int32)
    for name in ("domain", "method", "status"):
        cols[:, ps.schema.field_id(name)] = rng.integers(0, len(ps.dictionaries[name]), n)
    gids = np.sort(rng.integers(0, n_groups, n).astype(np.int64))
    vals = rng.integers(1, hi, n).astype(np.int32)
    return gids, vals, cols


def programs(stores_, jtree, ptree):
    js, ps, _, _ = stores_
    return jax_compile_tree(js, jtree), pf.compile_tree(ps, ptree)


# ------------------------------------------------------------ combine_scan
@given(seed=st.integers(0, 2**31), n=st.integers(1, 2500))
@settings(max_examples=8, deadline=None)
def test_combine_scan_matches_both_reference_backends(stores, seed, n):
    rng = np.random.default_rng(seed)
    gids, vals, cols = rows_inputs(rng, stores, n)
    jprog, pprog = programs(stores, JTREES[3], PTREES[3])
    for op in OPS:
        got = combine_scan(gids, vals, cols, pprog, op=op, device="cpu")
        for backend in ("ref", "pallas"):
            want = jax_combine_scan(gids, vals, cols, jprog, op=op, backend=backend)
            for g, w in zip(got, want):
                assert_same(g, w)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("tree", [0, 1, 2])
def test_combine_scan_matches_numpy(stores, op, tree):
    rng = np.random.default_rng(3 + tree)
    gids, vals, cols = rows_inputs(rng, stores, 3000, n_groups=40)
    jprog, pprog = programs(stores, JTREES[tree + 1], PTREES[tree + 1])
    uk, aggs, cnts = combine_scan(gids, vals, cols, pprog, op=op, device="cpu")
    assert (uk.dtype, aggs.dtype, cnts.dtype) == (np.int64, np.int64, np.int32)
    from repro.core.filter import eval_tree_rows

    mask = eval_tree_rows(stores[0], JTREES[tree + 1], cols)
    assert_same(uk, np.unique(gids[mask]))
    for i, g in enumerate(uk):
        sel = vals[(gids == g) & mask].astype(np.int64)
        want = {"count": len(sel), "sum": sel.sum(), "min": sel.min(), "max": sel.max()}[op]
        assert aggs[i] == want and cnts[i] == len(sel)


def test_combine_scan_tile_straddle(stores):
    """One group over many 1024-row reference tiles, half its rows
    filtered out (tests/test_iterators.py's straddle case)."""
    _, ps, _, _ = stores
    n = 1024 * 3
    cols = np.zeros((n, ps.schema.n_fields), np.int32)
    sfid = ps.schema.field_id("status")
    cols[:, sfid] = ps.dictionaries["status"].lookup("404")
    cols[::2, sfid] = ps.dictionaries["status"].lookup("200")
    gids = np.zeros(n, np.int64)
    vals = np.arange(1, n + 1, dtype=np.int32)
    jprog, pprog = programs(stores, JEq("status", "200"), pf.Eq("status", "200"))
    for op in OPS:
        got = combine_scan(gids, vals, cols, pprog, op=op, device="cpu")
        want = jax_combine_scan(gids, vals, cols, jprog, op=op, backend="pallas")
        for g, w in zip(got, want):
            assert_same(g, w)
    uk, aggs, cnts = combine_scan(gids, vals, cols, pprog, op="sum", device="cpu")
    assert list(uk) == [0] and cnts[0] == n // 2 and aggs[0] == vals[::2].astype(np.int64).sum()


def test_combine_scan_sums_beyond_int32(stores):
    """Values near 2**31: the group sums need int64, as in the reference's
    int64 plain version (its Pallas path routes these sums there)."""
    rng = np.random.default_rng(5)
    gids, _, cols = rows_inputs(rng, stores, 4000, n_groups=3)
    vals = rng.integers(2**31 - 1000, 2**31 - 1, 4000).astype(np.int32)
    for op in OPS:
        got = combine_scan(gids, vals, cols, None, op=op, device="cpu")
        want = jax_combine_scan(gids, vals, cols, None, op=op, backend="ref")
        for g, w in zip(got, want):
            assert_same(g, w)
    _, aggs, _ = combine_scan(gids, vals, cols, None, op="sum", device="cpu")
    assert aggs.max() > 2**31 and aggs.sum() == vals.astype(np.int64).sum()


def test_combine_scan_empty_and_trivial(stores):
    _, ps, _, _ = stores
    e = combine_scan(np.empty(0, np.int64), None, np.zeros((0, 12), np.int32), None,
                     device="cpu")
    assert [a.dtype for a in e] == [np.int64, np.int64, np.int32] and all(a.size == 0 for a in e)
    with pytest.raises(ValueError):
        combine_scan(np.zeros(3, np.int64), None, np.zeros((3, 12), np.int32), None, op="avg",
                     device="cpu")


def test_combine_segments_is_the_plain_version_on_cpu(stores):
    _, ps, _, _ = stores
    rng = np.random.default_rng(2)
    gids, vals, cols = rows_inputs(rng, stores, 500)
    program = program_tensors(pf.compile_tree(ps, PTREES[1]), "cpu")
    args = [torch.from_numpy(x) for x in (gids, vals, cols)]
    for op in OPS:
        got = combine_segments(*args, *program, op)
        want = combine_scan_ref(*args, *program, op)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="needs values"):
        combine_segments(args[0], None, args[2], *program, "sum")


# --------------------------------------------------------- aggregate_combine
@given(n=st.integers(1, 3000), nkeys=st.integers(1, 50), seed=st.integers(0, 2**31))
@settings(max_examples=10, deadline=None)
def test_combine_sorted_counts_matches_both_reference_backends(n, nkeys, seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, nkeys, n).astype(np.int64)) + (1 << 40)
    cnt = rng.integers(1, 10, n).astype(np.int32)
    got = combine_sorted_counts(keys, cnt, device="cpu")
    for backend in ("ref", "pallas"):
        want = jax_combine_sorted_counts(keys, cnt, backend=backend)
        for g, w in zip(got, want):
            assert_same(g, w)


def test_combine_sorted_counts_straddles_and_wraps_like_the_reference():
    n = 4096 * 3  # one key over three reference tiles
    keys = np.full(n, 7, np.int64)
    got = combine_sorted_counts(keys, np.ones(n, np.int32), device="cpu")
    assert list(got[0]) == [7] and list(got[1]) == [n]
    big = np.full(4, 2**30, np.int32)  # sums past int32 wrap as the reference's
    got = combine_sorted_counts(np.zeros(4, np.int64), big, device="cpu")
    want = jax_combine_sorted_counts(np.zeros(4, np.int64), big, backend="ref")
    for g, w in zip(got, want):
        assert_same(g, w)
    assert combine_sorted_counts(np.empty(0, np.int64), np.empty(0, np.int32),
                                 device="cpu")[0].size == 0


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_combine_blocks_batched_rows_match_the_reference(dtype):
    """Rows of sorted keys with sentinel tails, one launch for all rows,
    against the reference's combine_blocks_ref row by row."""
    from repro.kernels.aggregate_combine import combine_blocks_ref as jax_combine_blocks_ref
    from repro.kernels.common import split_key_lanes

    rng = np.random.default_rng(8)
    sentinel = np.iinfo(np.int64).max
    keys = np.full((4, 600), sentinel, np.int64)
    for r, live in enumerate([0, 37, 300, 600]):
        keys[r, :live] = np.sort(rng.integers(0, 30, live)) + (1 << 40)
    counts = rng.integers(0, 9, keys.shape)
    heads, sums = combine_blocks(torch.from_numpy(keys), torch.from_numpy(counts).to(dtype))
    assert heads.dtype == torch.bool and sums.dtype == torch.int64
    for r in range(4):
        hi, lo = split_key_lanes(keys[r])
        jh, js = jax_combine_blocks_ref(hi, lo, counts[r].astype(np.int32))
        np.testing.assert_array_equal(heads[r].numpy(), np.asarray(jh))
        np.testing.assert_array_equal(sums[r].numpy(), np.asarray(js).astype(np.int64))


def test_combine_blocks_rejects_what_the_kernel_does_not_take():
    k = torch.zeros((2, 3), dtype=torch.int64)
    with pytest.raises(TypeError):
        combine_blocks(k.to(torch.int32), k)
    with pytest.raises(TypeError):
        combine_blocks(k, k.to(torch.int16))
    with pytest.raises(ValueError):
        combine_blocks(k, k[:, :2])


# ------------------------------------------------------------ host sets
def test_intersect_and_union_sorted_match_the_reference():
    from repro.kernels.merge_intersect import intersect_sorted as jis, union_sorted as jus

    rng = np.random.default_rng(4)
    base = (1 << 32) - 2
    for na, nb in [(0, 5), (40, 300), (300, 40), (1, 1)]:
        a = np.unique(rng.integers(0, 500, na)) + base
        b = np.unique(rng.integers(0, 500, nb)) + base
        assert_same(intersect_sorted(a, b, device="cpu"), jis(a, b, backend="ref"))
        assert_same(union_sorted(a, b), jus(a, b))


# --------------------------------------------------------------- scanners
def test_index_scan_and_fetch_match_the_reference(stores):
    from repro.core.scan import fetch_rows_by_keys as jfetch, index_scan as jindex

    js, ps, _, _ = stores
    code = ps.dictionaries["domain"].lookup("gamma.net")
    for t0, t1 in [(0, T_STOP), (2000, 5000)]:
        got = index_scan(ps, "domain", np.asarray([code]), t0, t1)
        want = jindex(js, "domain", np.asarray([code]), t0, t1)
        assert len(got) == len(want) == 4
        for shard, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w)
            gb, wb = fetch_rows_by_keys(ps, shard, g), jfetch(js, shard, w)
            assert_same(gb.keys, wb.keys)
            assert_same(gb.cols, wb.cols)
            assert_same(gb.ts(), JaxRowBlock(shard, wb.keys, wb.cols).ts())


def test_store_flush_compact_and_n_rows(stores):
    _, ps, _, _ = stores
    assert all(len(t.runs) == 1 for t in ps.event_tablets + ps.index_tablets)
    assert sum(t.n_rows for t in ps.event_tablets) == N
    assert sum(t.n_rows for t in ps.index_tablets) == N * ps.schema.n_fields


# -------------------------------------------------------------- iterators
def _block_with_dups(rng, n_keys, max_dup):
    keys = np.sort(rng.choice(np.arange(n_keys) * 7 + 3, size=n_keys * max_dup))
    cols = rng.integers(0, 100, (len(keys), 3)).astype(np.int32)
    return keys.astype(np.int64), cols


@given(seed=st.integers(0, 2**31), max_versions=st.integers(1, 4))
@settings(max_examples=10, deadline=None)
def test_versioning_matches_the_reference(seed, max_versions):
    from repro.core import VersioningIterator as JVersioning

    keys, cols = _block_with_dups(np.random.default_rng(seed), 50, 5)
    got = VersioningIterator(max_versions).apply(RowBlock(0, keys, cols))
    want = JVersioning(max_versions).apply(JaxRowBlock(0, keys, cols))
    assert_same(got.keys, want.keys)
    assert_same(got.cols, want.cols)
    with pytest.raises(ValueError):
        VersioningIterator(0)


def stack_blocks(scan, store, stack, t0, t1):
    return [(b.shard, b.keys, b.cols, b.field_ids) for b in scan(store, t0, t1, iterators=stack)]


@pytest.mark.parametrize("tree", [1, 2, 3])
def test_filter_and_projection_stack_matches_the_reference(stores, tree):
    from repro.core import FilterIterator as JFilter, IteratorStack as JStack
    from repro.core import ProjectingIterator as JProject, VersioningIterator as JVersioning

    js, ps, _, _ = stores
    got = stack_blocks(scan_events, ps, IteratorStack([
        VersioningIterator(1), FilterIterator(ps, PTREES[tree], device="cpu"),
        ProjectingIterator(ps, ["domain", "status"])]), 1000, 8000)
    want = stack_blocks(jax_scan_events, js, JStack([
        JVersioning(1), JFilter(js, JTREES[tree]), JProject(js, ["domain", "status"])]),
        1000, 8000)
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            assert_same(a, b)


def test_filter_iterator_drops_and_keeps_whole_blocks(stores):
    _, ps, _, _ = stores
    blk = next(scan_events(ps, 0, T_STOP))
    assert FilterIterator(ps, pf.Eq("domain", "never-seen"), device="cpu").apply(blk) is None
    assert FilterIterator(ps, None, device="cpu").apply(blk) is blk


def test_stack_ordering_rules_match_the_reference(stores):
    _, ps, _, _ = stores
    grouping = resolve_grouping(ps, AggregateSpec(group_by=("method",)), 0, T_STOP)
    comb = CombinerIterator(grouping, device="cpu")
    with pytest.raises(ValueError):
        IteratorStack([comb, VersioningIterator()])
    with pytest.raises(ValueError):
        IteratorStack([ProjectingIterator(ps, ["domain"]),
                       FilterIterator(ps, pf.Eq("domain", "x"), device="cpu")])
    with pytest.raises(ValueError):
        IteratorStack([ProjectingIterator(ps, ["domain"]), comb])
    stack = IteratorStack([VersioningIterator(), FilterIterator(ps, pf.Eq("domain", "alpha.com"),
                                                                device="cpu"), comb])
    assert stack.terminal_combiner is comb
    assert IteratorStack([VersioningIterator()]).terminal_combiner is None
    blk = ProjectingIterator(ps, ["domain"]).apply(next(scan_events(ps, 0, T_STOP)))
    with pytest.raises(ValueError):
        ProjectingIterator(ps, ["status"]).apply(blk)
    with pytest.raises(ValueError):
        comb.apply(blk)


@pytest.mark.parametrize("i", range(len(SPEC_ARGS)))
def test_terminal_combiner_in_the_scan_matches_the_reference(stores, i):
    from repro.core import CombinerIterator as JComb, IteratorStack as JStack
    from repro.core import merge_aggregate_blocks as jmerge

    js, ps, _, _ = stores
    jg = jax_resolve_grouping(js, JSpec(**SPEC_ARGS[i]), 0, T_STOP)
    pg = resolve_grouping(ps, AggregateSpec(**SPEC_ARGS[i]), 0, T_STOP)
    assert (pg.fids, pg.radices, pg.strides, pg.size) == (jg.fids, jg.radices, jg.strides, jg.size)
    jprog, pprog = programs(stores, JTREES[1], PTREES[1])
    got = merge_aggregate_blocks(pg, scan_events(ps, 0, T_STOP, iterators=IteratorStack(
        [CombinerIterator(pg, prog=pprog, device="cpu")])))
    want = jmerge(jg, jax_scan_events(js, 0, T_STOP, iterators=JStack([JComb(jg, prog=jprog)])))
    assert_results_equal(got, want)
    assert got.rows(ps) == want.rows(js)


def test_aggregate_spec_rules_match_the_reference(stores):
    _, ps, _, _ = stores
    for bad in (dict(group_by=("method",), op="avg"), dict(group_by=("method",), op="sum"),
                dict(group_by=())):
        with pytest.raises(ValueError):
            AggregateSpec(**bad)
        with pytest.raises(ValueError):
            JSpec(**bad)
    with pytest.raises(ValueError, match="group space"):
        resolve_grouping(ps, AggregateSpec(group_by=("method",), time_bucket_s=1), 0, 2**25)


# ----------------------------------------------------- host query processor
@pytest.mark.parametrize("spec", range(len(SPEC_ARGS)))
@pytest.mark.parametrize("tree", range(len(PTREES)))
def test_aggregate_matches_the_reference(stores, spec, tree):
    js, ps, _, _ = stores
    for use_index, batched in [(False, True), (True, False)]:
        got = QueryProcessor(ps, device="cpu").aggregate(
            AggregateSpec(**SPEC_ARGS[spec]), 1000, T_STOP - 1000, PTREES[tree],
            use_index=use_index, batched=batched)
        want = JaxQP(js).aggregate(JSpec(**SPEC_ARGS[spec]), 1000, T_STOP - 1000, JTREES[tree],
                                   use_index=use_index, batched=batched)
        assert_results_equal(got, want)


SCHEMES = ["scan", "batched_scan", "index", "batched_index"]


def row_multiset(blocks):
    return Counter((int(k), tuple(int(x) for x in c))
                   for b in blocks for k, c in zip(b.keys, b.cols))


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("tree", range(len(PTREES)))
def test_row_schemes_match_the_reference(stores, scheme, tree):
    js, ps, ts, data = stores
    stats, jstats = QueryStats(), JaxStats()
    got = list(QueryProcessor(ps, device="cpu").run_scheme(scheme, 900, 9000, PTREES[tree],
                                                           stats=stats))
    want = list(JaxQP(js).run_scheme(scheme, 900, 9000, JTREES[tree], stats=jstats))
    assert row_multiset(got) == row_multiset(want)
    assert stats.rows == jstats.rows == sum(b.n for b in got)
    assert stats.plan.describe() == jstats.plan.describe()
    if not scheme.startswith("batched"):
        assert [(b.shard, b.n) for b in got] == [(b.shard, b.n) for b in want]


def test_combine_scan_scheme_streams_aggregate_blocks(stores):
    js, ps, _, data = stores
    spec = AggregateSpec(group_by=("method",), op="count")
    stats = QueryStats()
    blocks = list(QueryProcessor(ps, device="cpu").run_scheme(
        "combine_scan", 0, T_STOP, pf.Eq("domain", "alpha.com"), aggregate=spec, stats=stats))
    assert stats.batches > 1  # adaptive batching drove the combine scan
    total = sum(b.matched for b in blocks)
    assert total == data["domain"].count("alpha.com") == stats.rows
    assert sum(b.nbytes for b in blocks) < total * 8
    grouping = resolve_grouping(ps, spec, 0, T_STOP)
    want = JaxQP(js).aggregate(JSpec(group_by=("method",)), 0, T_STOP, JEq("domain", "alpha.com"))
    assert_results_equal(merge_aggregate_blocks(grouping, blocks), want)
    with pytest.raises(ValueError):
        next(iter(QueryProcessor(ps, device="cpu").run_scheme("combine_scan", 0, T_STOP)))


def test_empty_plan_and_step_api(stores):
    _, ps, _, _ = stores
    qp = QueryProcessor(ps, device="cpu")
    tree = pf.And(pf.Eq("domain", "alpha.com"), pf.Eq("domain", "never-seen"))
    stats = QueryStats()
    assert list(qp.run_scheme("batched_index", 0, T_STOP, tree, stats=stats)) == []
    assert stats.plan.mode == "empty" and stats.batches == 0
    from repro_torch.core.query import HostQueryRun

    run = HostQueryRun(qp, 0, T_STOP, pf.Eq("domain", "delta.io"))
    batches = []
    while not run.done:
        batches.append(run.step())
    assert run.step() is None
    assert sum(hb.rows for hb in batches) == sum(b.n for hb in batches for b in hb.blocks)


def test_processor_needs_cuda_unless_cpu_is_asked_for(stores):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryProcessor(stores[1])
