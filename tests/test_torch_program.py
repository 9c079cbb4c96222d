"""The prepared filter program, the one-launch level filter and the
pairwise merge identity, held to the JAX reference on the CPU.

On the CPU the wrappers run their plain versions. These tests check what
the CUDA kernels rely on, on numpy-seeded inputs and bit for bit (every
value is an integer or a bool, so there is no tolerance):

  * merge_runs.cu's K-way identity: an entry's rank is the sum of its
    positions in the 2-way merges with every other run, less (K-2) times
    its index; dead entries take p + the later runs' live lengths;
  * filter_scan_levels gives each level the mask filter_scan and the
    reference's program_eval_rows give it;
  * the prepared program's sorted codesets answer as the original form
    does, and a tree with an In of 10,000 bytes_in codes gives the same
    results through the port's and the reference's DistQueryProcessor.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AggregateSpec as JSpec, And as JAnd, Eq as JEq, In as JIn, Not as JNot
from repro.core import EventStore as JaxEventStore, web_proxy_schema as jax_schema
from repro.core.dist_ingest import DistBatchWriter as JaxWriter, DistIngestPlane as JaxPlane
from repro.core.dist_query import DistQueryProcessor as JaxProcessor
from repro.core.filter import compile_tree as jax_compile_tree
from repro.kernels.common import split_key_lanes
from repro.kernels.merge_runs import merge_ranks_pallas, merge_ranks_ref as jax_merge_ranks_ref
from repro.kernels.program_eval import program_eval_rows as jax_program_eval_rows
from repro.launch.mesh import make_dev_mesh

from repro_torch.core import AggregateSpec, EventStore
from repro_torch.core import filter as pf
from repro_torch.core.dist_ingest import DistBatchWriter, DistIngestPlane
from repro_torch.core.dist_query import DistQueryProcessor
from repro_torch.core.schema import web_proxy_schema
from repro_torch.kernels.filter_scan import filter_scan, filter_scan_levels, program_tensors
from repro_torch.kernels.merge_runs import merge_ranks, merge_ranks_ref
from repro_torch.kernels.program_eval import (
    MAX_STACK,
    OP_AND,
    OP_NOT,
    OP_OR,
    OP_PUSH_EQ,
    OP_PUSH_IN,
    OP_PUSH_TRUE,
    as_program,
    program_eval_rows,
)

T_SPAN = 4 * 3600


# ------------------------------------------------------------ merge_runs
def pairwise_ranks(keys, bounds, lengths):
    """merge_runs.cu's K-way identity from 2-way merges alone: a live entry
    x at index i of run j ranks sum over o != j of its position in the
    merge of runs j and o (earlier run first, so it wins ties), minus
    (K - 2) * i; a dead entry at position p ranks p + the live entries of
    the later runs."""
    b, n = keys.shape
    k = len(bounds) - 1
    caps = [bounds[o + 1] - bounds[o] for o in range(k)]
    live = torch.minimum(lengths.long().clamp(min=0), torch.tensor(caps))
    ranks = torch.zeros((b, n), dtype=torch.int64)
    for j in range(k):
        i = torch.arange(caps[j])
        own = ranks[:, bounds[j]: bounds[j + 1]]
        own -= (k - 2) * i
        for o in range(k):
            if o == j:
                continue
            lo, hi = min(j, o), max(j, o)
            pair = torch.cat([keys[:, bounds[lo]: bounds[lo + 1]],
                              keys[:, bounds[hi]: bounds[hi + 1]]], dim=1)
            two = merge_ranks_ref(pair, [0, caps[lo], caps[lo] + caps[hi]],
                                  lengths[:, [lo, hi]].contiguous())
            own += two[:, :caps[lo]] if j == lo else two[:, caps[lo]:]
        later = live[:, j + 1:].sum(dim=1)
        dead = i[None, :] >= live[:, j: j + 1]
        own[:] = torch.where(dead, bounds[j] + i[None, :] + later[:, None], own)
    return ranks.to(torch.int32)


def runs_with_duplicates(rng, b, k, r, dtype):
    """(b, k, r) sentinel-padded runs of heavy duplicates: per (row, run)
    empty, full or partly live, and one row with every run dead (r a power
    of two, as the reference's rank kernel takes it)."""
    sentinel = np.iinfo(dtype).max
    keys = np.full((b, k, r), sentinel, dtype)
    base = 1 << 40 if dtype == np.int64 else 0
    for x in range(b - 1):
        for j in range(k):
            n = [0, r, int(rng.integers(0, r + 1))][(x + j) % 3]
            keys[x, j, :n] = np.sort(rng.integers(0, 6, n)) + base
    return keys


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_pairwise_identity_matches_merge_ranks_and_reference(dtype, k):
    rng = np.random.default_rng(k)
    grid = runs_with_duplicates(rng, 4, k, 32, dtype)
    keys = torch.from_numpy(grid.reshape(4, k * 32))
    bounds = [o * 32 for o in range(k + 1)]
    lengths = torch.from_numpy((grid != np.iinfo(dtype).max).sum(axis=-1).astype(np.int32))
    got = pairwise_ranks(keys, bounds, lengths)
    assert torch.equal(got, merge_ranks_ref(keys, bounds, lengths))
    assert torch.equal(got, merge_ranks(keys, bounds, lengths))
    for x in range(4):
        if dtype == np.int32:
            hi, lo = np.zeros_like(grid[x]), grid[x]
        else:
            hi, lo = (a.reshape(grid[x].shape) for a in split_key_lanes(grid[x].reshape(-1)))
        want = np.asarray(jax_merge_ranks_ref(jnp.asarray(hi), jnp.asarray(lo)))
        np.testing.assert_array_equal(got[x].numpy().reshape(k, 32), want)
        if k > 1:
            pallas = merge_ranks_pallas(jnp.asarray(hi), jnp.asarray(lo), interpret=True)
            np.testing.assert_array_equal(got[x].numpy().reshape(k, 32), np.asarray(pallas))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_pairwise_identity_on_ragged_and_empty_runs(dtype):
    # Runs of different capacities (one of capacity 0) with stale values
    # past their lengths, as the plane's majors and folds pass them.
    rng = np.random.default_rng(5)
    caps = [7, 0, 31, 12, 1]
    parts, lens = [], []
    for cap in caps:
        n = rng.integers(0, cap + 1, 3)
        run = np.full((3, cap), -9, dtype)
        for x in range(3):
            run[x, :n[x]] = np.sort(rng.integers(0, 5, n[x]))
        parts.append(run)
        lens.append(n)
    keys = torch.from_numpy(np.concatenate(parts, axis=1))
    lengths = torch.from_numpy(np.stack(lens, axis=1).astype(np.int32))
    bounds = np.concatenate([[0], np.cumsum(caps)]).tolist()
    got = pairwise_ranks(keys, bounds, lengths)
    assert torch.equal(got, merge_ranks_ref(keys, bounds, lengths))
    assert sorted(got[0].tolist()) == list(range(bounds[-1]))


# ----------------------------------------------------------- filter_scan
DOMAINS = ["a.com", "b.com", "c.com", "d.net"]


@pytest.fixture(scope="module")
def stores():
    rng = np.random.default_rng(8)
    n = 900
    vals = {"domain": rng.choice(DOMAINS, n).tolist(),
            "status": rng.choice(["200", "404", "500"], n).tolist(),
            "bytes_in": rng.integers(0, 2000, n).astype(str).tolist()}
    js, ps = JaxEventStore(jax_schema()), EventStore(web_proxy_schema())
    cols = js.encode_events(np.zeros(n), vals)
    np.testing.assert_array_equal(ps.encode_events(np.zeros(n), vals), cols)
    return js, ps, cols


def tree_pair(lib_j, lib_p, values):
    (jeq, jin, jnot, jand), (peq, pin, pnot, pand) = lib_j, lib_p
    return (jand(jnot(jeq("domain", "a.com")), jin("bytes_in", values)),
            pand(pnot(peq("domain", "a.com")), pin("bytes_in", values)))


JLIB = (JEq, JIn, JNot, JAnd)
PLIB = (pf.Eq, pf.In, pf.Not, pf.And)


def test_filter_scan_levels_matches_per_level_filter_and_reference(stores):
    js, ps, cols = stores
    values = tuple(str(v) for v in range(0, 2000, 3)) + ("never",)
    jt, pt = tree_pair(JLIB, PLIB, values)
    program = program_tensors(pf.compile_tree(ps, pt), "cpu")
    jprog = jax_compile_tree(js, jt)
    shapes = [(3, 100), (2, 2, 50), (0,), (4, 25)]
    levels, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        levels.append(torch.from_numpy(cols[off: off + n]).reshape(*shape, cols.shape[1]))
        off += n
    masks = filter_scan_levels(levels, program)
    assert len(masks) == len(levels)
    for cols_l, mask in zip(levels, masks):
        assert mask.shape == cols_l.shape[:-1] and mask.dtype == torch.bool
        assert torch.equal(mask, filter_scan(cols_l, program))
        flat = cols_l.reshape(-1, cols.shape[1]).numpy()
        want = np.asarray(jax_program_eval_rows(
            jnp.asarray(flat), jnp.asarray(jprog.opcodes), jnp.asarray(jprog.arg0),
            jnp.asarray(jprog.arg1), jnp.asarray(jprog.codesets)))
        np.testing.assert_array_equal(mask.reshape(-1).numpy(), want)
    with pytest.raises(ValueError):
        filter_scan_levels([levels[0], levels[0][..., :5]], program)


def prepared_eval(cols, program):
    """Evaluate the prepared form as csrc/program_eval.cuh does: opcodes
    and args from ``words``, each PUSH_IN a binary search (searchsorted)
    over its set's sorted codes, found by the set offsets."""
    p, s = program.n_ops, program.n_sets
    words = program.words
    opc, arg0, arg1 = (words[i * p:(i + 1) * p].tolist() for i in range(3))
    off = words[3 * p: 3 * p + s + 1].tolist()
    codes = words[3 * p + s + 1:]
    stack, sp = torch.zeros((MAX_STACK, cols.shape[0]), dtype=torch.bool), 0
    clamp = lambda i: min(max(i, 0), MAX_STACK - 1)  # noqa: E731
    for op, f, a in zip(opc, arg0, arg1):
        if op in (OP_PUSH_EQ, OP_PUSH_IN, OP_PUSH_TRUE):
            col = cols[:, f]
            if op == OP_PUSH_EQ:
                val = col == a
            elif op == OP_PUSH_IN:
                row = codes[off[a]: off[a + 1]]
                assert torch.equal(row, row.sort().values)
                pos = torch.searchsorted(row, col.contiguous())
                val = (pos < len(row)) & (row[pos.clamp(max=max(len(row) - 1, 0))] == col) \
                    if len(row) else torch.zeros_like(col, dtype=torch.bool)
            else:
                val = torch.ones_like(col, dtype=torch.bool)
            stack[clamp(sp)] = val
            sp += 1
        elif op in (OP_AND, OP_OR):
            x, y = stack[clamp(sp - 2)], stack[clamp(sp - 1)]
            stack[clamp(sp - 2)] = (x & y) if op == OP_AND else (x | y)
            sp -= 1
        elif op == OP_NOT:
            stack[clamp(sp - 1)] = ~stack[clamp(sp - 1)]
    return stack[0]


def test_prepared_form_answers_as_the_original_form(stores):
    js, ps, cols = stores
    rng = np.random.default_rng(10)
    # 10,000 bytes_in codes: the store's own, and more interned for the test.
    ps.dictionaries["bytes_in"].encode_many([str(v) for v in range(12_000)])
    values = tuple(str(v) for v in rng.permutation(12_000)[:10_000])
    _, pt = tree_pair(JLIB, PLIB, values + ("never",))
    prog = pf.compile_tree(ps, pt)
    assert (prog.codesets >= 0).sum() == 10_000
    program = program_tensors(prog, "cpu")
    assert program.n_codes == 10_000 and program.nbytes == 4 * (
        program.header_words + program.n_codes)
    rows = torch.from_numpy(cols)
    rows[::50, 2] = -1  # negative codes match no set
    want = program_eval_rows(rows, *program)
    assert 0 < int(want.sum()) < len(cols)
    assert torch.equal(prepared_eval(rows, program), want)
    # The four-tensor route prepares the same words.
    again = as_program(tuple(program))
    assert torch.equal(again.words, program.words)
    assert torch.equal(filter_scan(rows, *program), want)


# ----------------------------------------- a 10,000-code In, end to end
@pytest.fixture(scope="module")
def big_in_twin():
    rng = np.random.default_rng(31)
    n = 10_400
    ts = np.sort(rng.integers(0, T_SPAN, n))
    vals = {"domain": rng.choice(DOMAINS, n, p=[0.4, 0.3, 0.2, 0.1]).tolist(),
            "status": rng.choice(["200", "404"], n, p=[0.8, 0.2]).tolist(),
            "bytes_in": (rng.permutation(1_000_000)[:n] + (1 << 20)).astype(str).tolist()}
    jstore, pstore = JaxEventStore(jax_schema()), EventStore(web_proxy_schema())
    for s in (jstore, pstore):
        s.ingest(ts, vals)
        s.flush_all()
    sizes = dict(mem_rows=512, max_runs=2, append_rows=256)
    jplane = JaxPlane.for_store(jstore, make_dev_mesh(1, 1), capacity=4096,
                                tablets_per_device=4, **sizes)
    pplane = DistIngestPlane.for_store(pstore, capacity=4096, n_tablets=4, device="cpu", **sizes)
    jw = JaxWriter(jstore, jplane, batch_rows=1500, writer_id=1)
    pw = DistBatchWriter(pstore, pplane, batch_rows=1500, writer_id=1)
    for off in range(0, n, 1300):
        part = {k: v[off: off + 1300] for k, v in vals.items()}
        jw.add(ts[off: off + 1300], part)
        pw.add(ts[off: off + 1300], part)
    jw.close()
    pw.close()
    tel = pplane.telemetry()
    assert tel["base_n"].min() > 0 and tel["mem_n"].min() > 0
    values = tuple(vals["bytes_in"][: 10_000])
    return dict(vals=vals, values=values, jq=JaxProcessor(jstore, plane=jplane),
                pq=DistQueryProcessor(pstore, pplane, device="cpu"), pstore=pstore)


def big_in_trees(values):
    return [(JAnd(JEq("status", "404"), JIn("bytes_in", values)),
             pf.And(pf.Eq("status", "404"), pf.In("bytes_in", values))),
            (JAnd(JEq("domain", "d.net"), JNot(JIn("bytes_in", values))),
             pf.And(pf.Eq("domain", "d.net"), pf.Not(pf.In("bytes_in", values))))]


@pytest.mark.parametrize("i", [0, 1])
def test_big_in_schemes_match_reference(big_in_twin, i):
    tw = big_in_twin
    jt, pt = big_in_trees(tw["values"])[i]
    prog = pf.compile_tree(tw["pstore"], pt)
    assert (prog.codesets >= 0).sum() == 10_000
    v = tw["vals"]
    inset = np.isin(np.asarray(v["bytes_in"]), np.asarray(tw["values"]))
    want = int(((np.asarray(v["status"]) == "404") & inset).sum()) if i == 0 else \
        int(((np.asarray(v["domain"]) == "d.net") & ~inset).sum())
    for scheme in ("scan", "batched_index"):
        jt_total = sum(b.count for b in tw["jq"].run_scheme(scheme, 0, T_SPAN, jt))
        pt_total = sum(b.count for b in tw["pq"].run_scheme(scheme, 0, T_SPAN, pt))
        assert pt_total == jt_total == want, scheme
    jc, jts, jcols = tw["jq"].scan_range(jt, 0, T_SPAN)[:3]
    pc, pts, pcols = tw["pq"].scan_range(pt, 0, T_SPAN)[:3]
    assert pc == jc
    np.testing.assert_array_equal(np.sort(pts), np.sort(np.asarray(jts)))


def test_big_in_aggregates_match_reference(big_in_twin):
    tw = big_in_twin
    jt, pt = big_in_trees(tw["values"])[0]
    args = dict(group_by=("domain",), op="count", time_bucket_s=3600)
    for use_index in (False, True):
        got = tw["pq"].aggregate_range(AggregateSpec(**args), pt, 0, T_SPAN,
                                       use_index=use_index)
        want = tw["jq"].aggregate_range(JSpec(**args), jt, 0, T_SPAN, use_index=use_index)
        for name in ("gids", "values", "counts"):
            g, w = getattr(got, name), np.asarray(getattr(want, name))
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
