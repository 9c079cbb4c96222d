"""Checks of the port's CUDA kernels that need the card.

Each kernel is held bit for bit against its plain PyTorch version on the
same CUDA tensors, and a plane on the card against the same plane on the
CPU. Where CUDA is missing every test here skips; on a machine with an
H100 run them with

    HYPOTHESIS_STORAGE_DIRECTORY=/tmp/hyp PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import filter as pf
from repro_torch.core.dist_ingest import DistBatchWriter, DistIngestPlane
from repro_torch.core.dist_query import DistQueryProcessor, QueryStats
from repro_torch.core.schema import web_proxy_schema
from repro_torch.core.store import EventStore
from repro_torch.kernels.filter_scan import filter_scan, filter_scan_levels, pad_program
from repro_torch.kernels.filter_scan import ops as filter_ops
from repro_torch.kernels.merge_intersect import member_mask, member_mask_keys
from repro_torch.kernels.merge_intersect import ops as intersect_ops
from repro_torch.kernels.merge_runs import (
    merge_pair_device,
    merge_ranks,
    merge_ranks_ref,
    merge_sorted_device,
    ops as merge_ops,
)
from repro_torch.kernels.program_eval import program_eval_rows
from repro_torch.kernels.aggregate_combine import (
    combine_blocks,
    combine_blocks_ref,
    combine_sorted_counts,
    ops as agg_ops,
)
from repro_torch.kernels.combine_scan import combine_scan, combine_scan_ref, combine_segments
from repro_torch.kernels.combine_scan import ops as combine_ops
from repro_torch.kernels.filter_scan import program_tensors
from repro_torch.kernels.merge_intersect import intersect_sorted

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda", 0)


def sorted_runs(rng, b, k, r, dtype, hi):
    sentinel = np.iinfo(dtype).max
    keys = np.full((b, k, r), sentinel, dtype)
    for i in range(b):
        for j in range(k):
            n = [0, r, int(rng.integers(0, r + 1))][(i + j) % 3]
            keys[i, j, :n] = np.sort(rng.integers(0, hi, n))
    return torch.from_numpy(keys)


def live_lengths(keys):
    return (keys != torch.iinfo(keys.dtype).max).sum(dim=-1, dtype=torch.int32)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("shape", [(1, 1, 5), (3, 2, 1000), (4, 5, 777), (64, 4, 4096)])
def test_merge_ranks_kernel_matches_plain_version(cuda, dtype, shape):
    b, k, r = shape
    keys = sorted_runs(np.random.default_rng(sum(shape)), *shape, dtype, hi=50).to(cuda)
    lengths = live_lengths(keys)
    keys = keys.reshape(b, k * r)
    bounds = [o * r for o in range(k + 1)]
    before = merge_ops.launches
    got = merge_ranks(keys, bounds, lengths)
    torch.cuda.synchronize()
    assert merge_ops.launches == before + 1
    assert got.dtype == torch.int32 and got.device == keys.device
    assert torch.equal(got, merge_ranks_ref(keys, bounds, lengths))


@pytest.mark.parametrize("k", range(1, 33))
def test_merge_ranks_tiles_split_runs_of_equal_keys(cuda, k):
    # Few distinct keys, so every tile boundary (2,048 outputs of a pair)
    # falls inside a run of equal keys, at capacities that are not
    # multiples of the tile, with empty, full and partly live runs.
    rng = np.random.default_rng(100 + k)
    caps = rng.integers(0, 9000, k).tolist()
    for dtype in (np.int32, np.int64):
        parts, lens = [], []
        for o, cap in enumerate(caps):
            n = rng.integers(0, cap + 1, 3)
            n[o % 3] = cap
            run = np.full((3, cap), -5, dtype)
            for b in range(3):
                run[b, :n[b]] = np.sort(rng.integers(0, 4, n[b]))
            parts.append(torch.from_numpy(run))
            lens.append(torch.from_numpy(n.astype(np.int32)))
        keys = torch.cat(parts, dim=1).to(cuda)
        lengths = torch.stack(lens, dim=1).to(cuda)
        bounds = np.concatenate([[0], np.cumsum(caps)]).tolist()
        before = merge_ops.launches
        got = merge_ranks(keys, bounds, lengths)
        torch.cuda.synchronize()
        assert merge_ops.launches == before + (1 if keys.numel() else 0)
        assert torch.equal(got, merge_ranks_ref(keys, bounds, lengths)), (k, dtype)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("caps", [(1000, 37), (5, 300, 0, 64), (131072, 4096)])
def test_merge_ranks_kernel_matches_plain_version_on_ragged_runs(cuda, dtype, caps):
    # Runs of different capacities, with stale values past their lengths.
    rng = np.random.default_rng(len(caps))
    parts, lens = [], []
    for cap in caps:
        run = sorted_runs(rng, 8, 1, cap, dtype, hi=200)[:, 0]
        n = live_lengths(run)
        stale = torch.arange(cap)[None, :] >= n[:, None]
        parts.append(torch.where(stale, -3, run))
        lens.append(n)
    keys = torch.cat(parts, dim=1).to(cuda)
    lengths = torch.stack(lens, dim=1).to(cuda)
    bounds = np.concatenate([[0], np.cumsum(caps)]).tolist()
    got = merge_ranks(keys, bounds, lengths)
    assert torch.equal(got, merge_ranks_ref(keys, bounds, lengths))
    assert torch.equal(got.sort(dim=1).values,
                       torch.arange(keys.shape[1], device=cuda, dtype=torch.int32).expand_as(got))


def test_merge_entry_points_match_the_cpu(cuda):
    rng = np.random.default_rng(3)
    keys = sorted_runs(rng, 3, 4, 300, np.int64, hi=80)
    cols = torch.from_numpy(rng.integers(0, 9, (3, 4, 300, 2)))
    cols = torch.where(keys[..., None] == torch.iinfo(torch.int64).max, 0, cols)
    n = live_lengths(keys)
    for got, want in zip(merge_sorted_device(keys.to(cuda), cols.to(cuda), n.to(cuda)),
                         merge_sorted_device(keys, cols, n)):
        assert torch.equal(got.cpu(), want)
    a, b = keys[:, 0], keys[:, 1, :123]
    ac, bc = cols[:, 0], cols[:, 1, :123]
    pair = (a, ac, live_lengths(a), b, bc, live_lengths(b))
    for got, want in zip(merge_pair_device(*(x.to(cuda) for x in pair)),
                         merge_pair_device(*pair)):
        assert torch.equal(got.cpu(), want)


def programs(store):
    return [
        pf.Eq("domain", "a.com"),
        pf.Or(pf.Eq("domain", "b.com"), pf.Not(pf.In("status", ("200", "zzz")))),
        pf.And(pf.In("method", ("GET", "PUT")), pf.Or(pf.Eq("status", "404"),
                                                      pf.Not(pf.Eq("domain", "c.com")))),
        None,
        pf.Eq("domain", "never-seen"),
    ]


@pytest.mark.parametrize("lead", [(4, 1000), (4, 2, 300), (4, 300), (1, 1)])
def test_filter_scan_kernel_matches_plain_version(cuda, lead):
    rng = np.random.default_rng(len(lead))
    store = EventStore(web_proxy_schema())
    n = int(np.prod(lead))
    vals = {"domain": rng.choice(["a.com", "b.com", "c.com"], n).tolist(),
            "status": rng.choice(["200", "404"], n).tolist(),
            "method": rng.choice(["GET", "PUT", "POST"], n).tolist()}
    cols = torch.from_numpy(store.encode_events(np.zeros(n), vals)).reshape(*lead, -1).to(cuda)
    for tree in programs(store):
        prog = tuple(torch.from_numpy(a).to(cuda)
                     for a in pad_program(pf.compile_tree(store, tree)))
        before = filter_ops.launches
        got = filter_scan(cols, *prog)
        assert filter_ops.launches == before + 1
        want = program_eval_rows(cols.reshape(n, -1), *prog).reshape(lead)
        assert got.dtype == torch.bool and torch.equal(got, want)


def test_filter_scan_runs_a_program_past_48_kib_of_shared_memory(cuda):
    # 64 x 256 codesets (65,632 bytes with the program) once raised past the
    # 48 KiB a launch gets without opting in; now it runs and agrees.
    opc = torch.zeros(8, dtype=torch.int32, device=cuda)
    sets = torch.full((64, 256), -1, dtype=torch.int32, device=cuda)
    cols = torch.zeros((10, 12), dtype=torch.int32, device=cuda)
    got = filter_scan(cols, opc, opc, opc, sets)
    assert torch.equal(got, program_eval_rows(cols, opc, opc, opc, sets))
    # The same table with a live last row, read by a PUSH_IN.
    sets[63, :200] = torch.arange(0, 400, 2, dtype=torch.int32, device=cuda)
    opc[0] = 2
    a0 = torch.zeros(8, dtype=torch.int32, device=cuda)
    a1 = torch.full((8,), 63, dtype=torch.int32, device=cuda)
    cols[:, 0] = torch.arange(10, dtype=torch.int32, device=cuda) * 41
    got = filter_scan(cols, opc, a0, a1, sets)
    want = program_eval_rows(cols, opc, a0, a1, sets)
    assert torch.equal(got, want) and int(want.sum()) == 5


def big_in_rows(rng, n_codes, n_rows, n_fields=12):
    """A PUSH_IN over n_codes distinct codes (unsorted, -1 padded to a
    power of two) AND an Eq, and rows about half of whose field-3 codes are
    in the set, some negative."""
    from repro_torch.core.filter import FilterProgram

    universe = rng.permutation(4 * n_codes)
    codes = universe[:n_codes].astype(np.int32)
    cs = np.full((2, 1 << (n_codes - 1).bit_length()), -1, np.int32)
    cs[1, :n_codes] = codes
    cs[0, :3] = [5, 1, 3]
    prog = FilterProgram(opcodes=np.asarray([2, 1, 2, 6, 4, 5], np.int32),
                         arg0=np.asarray([3, 4, 5, 0, 0, 0], np.int32),
                         arg1=np.asarray([1, 7, 0, 0, 0, 0], np.int32),
                         codesets=cs, max_depth=3)
    cols = rng.integers(0, 9, (n_rows, n_fields)).astype(np.int32)
    cols[:, 3] = rng.choice(universe[: 2 * n_codes], n_rows)
    cols[::97, 3] = -1
    return prog, cols


@pytest.mark.parametrize("n_codes,shared", [(8193, False), (30_000, True), (65536, False),
                                            (1_000_000, False)])
def test_filter_scan_and_combine_scan_take_big_in_sets(cuda, monkeypatch, n_codes, shared):
    """shared: stage the program whole in the opt-in shared memory (120 KB
    at 30,000 codes), past the default threshold."""
    from repro_torch.kernels import program_eval

    if shared:
        monkeypatch.setattr(program_eval, "SHARED_PROGRAM_BYTES", 227 * 1024)
    rng = np.random.default_rng(n_codes)
    prog, cols = big_in_rows(rng, n_codes, 300_000)
    program = program_tensors(prog, cuda)
    assert program.codesets.numel() * 4 > 48 * 1024  # the padded table of old
    rows = torch.from_numpy(cols).to(cuda)
    before = filter_ops.launches
    got = filter_scan(rows, program)
    torch.cuda.synchronize()
    assert filter_ops.launches == before + 1
    want = program_eval_rows(rows, *program)
    assert torch.equal(got, want) and 0 < int(want.sum()) < len(cols)
    gids = torch.from_numpy(np.sort(rng.integers(0, 5000, len(cols)))).to(cuda)
    vals = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, len(cols)).astype(np.int32)).to(cuda)
    for op in ("count", "sum", "min", "max"):
        got = combine_segments(gids, vals, rows, program, op)
        want = combine_scan_ref(gids, vals, rows, *program, op)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), op


def test_filter_scan_levels_launches_once_for_every_level(cuda):
    rng = np.random.default_rng(17)
    prog, _ = big_in_rows(rng, 30_000, 1)
    program = program_tensors(prog, cuda)
    levels = [torch.from_numpy(rng.integers(0, 60_000, shape).astype(np.int32)).to(cuda)
              for shape in ((4, 1000, 12), (4, 3, 257, 12), (4, 0, 12), (4, 300, 12))]
    levels[1] = levels[1][:, :, :200]  # a non-contiguous slice
    before = filter_ops.launches
    masks = filter_scan_levels(levels, program)
    torch.cuda.synchronize()
    assert filter_ops.launches == before + 1
    for cols, mask in zip(levels, masks):
        assert mask.shape == cols.shape[:-1] and mask.dtype == torch.bool
        want = program_eval_rows(cols.reshape(-1, 12), *program).reshape(cols.shape[:-1])
        assert torch.equal(mask, want)


def test_a_scan_step_launches_filter_scan_once(cuda):
    from repro_torch.core import dist_query

    store = EventStore(web_proxy_schema())
    rng = np.random.default_rng(18)
    n = 3000
    ts = np.sort(rng.integers(0, 14400, n))
    vals = {"domain": rng.choice(["a.com", "b.com"], n).tolist()}
    plane = DistIngestPlane.for_store(store, capacity=2048, n_tablets=4, mem_rows=128,
                                      max_runs=2, append_rows=64, device=cuda)
    w = DistBatchWriter(store, plane, batch_rows=700, writer_id=4)
    w.add(ts, vals)
    w.close()
    dq = DistQueryProcessor(store, plane, device=cuda)
    d = dq._sync()
    program = dq._program(pf.Eq("domain", "a.com"), cuda)
    before = filter_ops.launches
    total, _, _ = dist_query.scan_step(d, program, 0, 2**31 - 2)
    assert filter_ops.launches == before + 1
    assert int(total) == int((np.asarray(vals["domain"]) == "a.com").sum())


def test_card_plane_matches_cpu_plane(cuda):
    rng = np.random.default_rng(8)
    n = 5000
    ts = np.sort(rng.integers(0, 14400, n))
    vals = {"domain": rng.choice(["a.com", "b.com", "c.com"], n).tolist(),
            "status": rng.choice(["200", "404"], n).tolist()}
    store = EventStore(web_proxy_schema())
    sizes = dict(n_tablets=4, mem_rows=128, max_runs=2, append_rows=64, capacity=2048)
    planes = [DistIngestPlane.for_store(store, device=d, **sizes) for d in ("cpu", cuda)]
    for plane in planes:
        w = DistBatchWriter(store, plane, batch_rows=700, writer_id=4)
        for off in range(0, n, 600):
            w.add(ts[off: off + 600], {k: v[off: off + 600] for k, v in vals.items()})
        w.close()
    cpu, card = planes
    assert all(torch.equal(cpu.state[k], card.state[k].cpu()) for k in cpu.state)
    tree = pf.Eq("domain", "b.com")
    want = int((np.asarray(vals["domain"]) == "b.com").sum())
    for plane in planes:
        dq = DistQueryProcessor(store, plane, device=plane.device)
        for scheme in ("scan", "batched_scan"):
            assert sum(b.count for b in dq.run_scheme(scheme, 0, 14400, tree)) == want
    while cpu.compact_step():
        assert card.compact_step() == 1
        assert all(torch.equal(cpu.state[k], card.state[k].cpu()) for k in cpu.state)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 1000, 17), (5, 7, 0), (4, 0, 5),
                                   (2, 3, 4097, 300), (64, 12288, 12288)])
def test_member_mask_kernel_matches_plain_version(cuda, dtype, shape):
    *lead, n, m = shape
    rng = np.random.default_rng(sum(shape))
    sentinel = np.iinfo(dtype).max
    hi = 2**53 if dtype == np.int64 else 2**31 - 1
    b = np.sort(rng.integers(0, hi, (*lead, m)).astype(dtype), axis=-1)
    if m:
        b[..., -1] = sentinel  # the pad is an ordinary key
    pool = np.concatenate([b.reshape(-1), rng.integers(0, hi, max(n, 1)).astype(dtype),
                           np.asarray([0, sentinel], dtype)])
    a = rng.choice(pool, (*lead, n)).astype(dtype)
    ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    before = intersect_ops.launches
    got = member_mask(ta, tb)
    torch.cuda.synchronize()
    assert intersect_ops.launches == before + (1 if a.size else 0)
    assert got.dtype == torch.bool and got.shape == ta.shape and got.device == ta.device
    assert torch.equal(got, member_mask_keys(ta, tb))
    assert torch.equal(got.cpu(), member_mask_keys(torch.from_numpy(a), torch.from_numpy(b)))


def test_card_index_schemes_match_cpu_plane(cuda):
    rng = np.random.default_rng(9)
    n = 6000
    ts = np.sort(rng.integers(0, 14400, n))
    vals = {"domain": rng.choice(["a.com", "b.com", "c.com"], n, p=[0.6, 0.3, 0.1]).tolist(),
            "status": rng.choice(["200", "404"], n, p=[0.8, 0.2]).tolist()}
    store = EventStore(web_proxy_schema())
    sizes = dict(n_tablets=4, mem_rows=128, max_runs=2, append_rows=64, capacity=2048)
    planes = [DistIngestPlane.for_store(store, device=d, **sizes) for d in ("cpu", cuda)]
    for plane in planes:
        w = DistBatchWriter(store, plane, batch_rows=700, writer_id=4)
        w.add(ts, vals)
        w.close()
    trees = [pf.Eq("domain", "c.com"), pf.And(pf.Eq("domain", "c.com"), pf.Eq("status", "404")),
             pf.Or(pf.Eq("domain", "b.com"), pf.Eq("domain", "c.com")),
             pf.Eq("domain", "never-seen")]
    procs = [DistQueryProcessor(store, plane, device=plane.device) for plane in planes]
    for tree in trees:
        for f, v in [("domain", "c.com"), ("status", "404")]:
            assert procs[0].agg_count(f, v, 0, 14400) == procs[1].agg_count(f, v, 0, 14400)
        for scheme in ("index", "batched_index"):
            totals, modes = [], []
            for dq in procs:
                stats = QueryStats()
                totals.append(sum(b.count for b in dq.run_scheme(scheme, 0, 14400, tree,
                                                                 stats=stats)))
                modes.append(stats.plan.mode)
            want = sum(b.count for b in procs[0].run_scheme("scan", 0, 14400, tree))
            assert totals[0] == totals[1] == want and modes[0] == modes[1]
    d_cpu, d_card = (dq._sync() for dq in procs)
    for name in ("ix_keys", "ix_mem_k", "ag_keys", "ag_vals", "ag_mem_k", "ag_mem_c"):
        assert torch.equal(getattr(d_cpu, name), getattr(d_card, name).cpu()), name
    before = intersect_ops.launches
    list(procs[1].run_scheme("index", 0, 3600, trees[1]))
    assert intersect_ops.launches > before


def combine_inputs(rng, n, n_groups, store, long_group=False):
    f = store.schema.n_fields
    vals = {"domain": rng.choice(["a.com", "b.com", "c.com"], n).tolist(),
            "status": rng.choice(["200", "404"], n).tolist()}
    cols = store.encode_events(np.zeros(n), vals)
    gids = np.sort(rng.integers(0, n_groups, n).astype(np.int64))
    if long_group:
        gids[n // 10:] = n_groups  # one group over most of the tiles
    v = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    assert cols.shape == (n, f)
    return gids, v, cols


@pytest.mark.parametrize("n,n_groups,long_group", [(1, 1, False), (511, 3, False),
                                                   (513, 600, False), (5000, 40, True),
                                                   (1 << 20, 1000, True)])
def test_combine_scan_kernel_matches_plain_version(cuda, n, n_groups, long_group):
    rng = np.random.default_rng(n)
    store = EventStore(web_proxy_schema())
    gids, v, cols = combine_inputs(rng, n, n_groups, store, long_group)
    args = [torch.from_numpy(x).to(cuda) for x in (gids, v, cols)]
    for tree in programs(store)[:4]:
        program = program_tensors(pf.compile_tree(store, tree), cuda)
        for op in ("count", "sum", "min", "max"):
            before = combine_ops.launches
            got = combine_segments(*args, *program, op)
            torch.cuda.synchronize()
            assert combine_ops.launches == before + 1
            want = combine_scan_ref(*args, *program, op)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w), (op, tree)


def test_combine_scan_host_op_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(12)
    store = EventStore(web_proxy_schema())
    gids, v, cols = combine_inputs(rng, 70000, 5, store, long_group=True)
    prog = pf.compile_tree(store, pf.Eq("status", "404"))
    for op in ("count", "sum", "min", "max"):
        got = combine_scan(gids, v, cols, prog, op=op, device=cuda)
        want = combine_scan(gids, v, cols, prog, op=op, device="cpu")
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("shape,live", [((1, 1), [1]), ((3, 700), [0, 700, 513]),
                                        ((4, 100000), [0, 5, 40000, 100000]),
                                        ((64, 1769472), None)])
def test_aggregate_combine_kernel_matches_plain_version(cuda, dtype, shape, live):
    """Sorted keys with duplicates and sentinel tails over many tiles (the
    last shape is the aggregate family's 2-way major)."""
    rows, n = shape
    gen = torch.Generator(device=cuda).manual_seed(n)
    if live is None:
        live = [n // 2] * rows
    keys = torch.randint(0, max(n // 8, 1), shape, device=cuda, generator=gen).sort(dim=1).values
    pos = torch.arange(n, device=cuda)[None, :]
    keys = torch.where(pos < torch.tensor(live, device=cuda)[:, None], keys,
                       torch.iinfo(torch.int64).max)
    counts = torch.randint(-9, 100, shape, device=cuda, generator=gen).to(dtype)
    before = agg_ops.launches
    got = combine_blocks(keys, counts)
    torch.cuda.synchronize()
    assert agg_ops.launches == before + 1
    want = combine_blocks_ref(keys, counts)
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int64
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_combine_sorted_counts_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(13)
    keys = np.sort(rng.integers(0, 3000, 300000).astype(np.int64))
    counts = rng.integers(1, 2**20, 300000).astype(np.int32)
    for got, want in zip(combine_sorted_counts(keys, counts, device=cuda),
                         combine_sorted_counts(keys, counts, device="cpu")):
        np.testing.assert_array_equal(got, want)
    a = np.unique(rng.integers(0, 1 << 40, 5000))
    b = np.unique(np.concatenate([a[::3], rng.integers(0, 1 << 40, 2000)]))
    np.testing.assert_array_equal(intersect_sorted(a, b, device=cuda),
                                  intersect_sorted(a, b, device="cpu"))


def test_card_aggregations_match_cpu(cuda):
    """Host QueryProcessor and device aggregate_range on the card against
    the same on the CPU, scan and index plans, every op."""
    from repro_torch.core import AggregateSpec, QueryProcessor

    rng = np.random.default_rng(14)
    n = 6000
    ts = np.sort(rng.integers(0, 14400, n))
    vals = {"domain": rng.choice(["a.com", "b.com", "c.com"], n, p=[0.6, 0.3, 0.1]).tolist(),
            "status": rng.choice(["200", "404"], n, p=[0.8, 0.2]).tolist(),
            "method": rng.choice(["GET", "POST"], n).tolist(),
            "bytes_in": rng.integers(1 << 19, 1 << 20, n).astype(str).tolist()}
    store = EventStore(web_proxy_schema(), n_shards=4, flush_rows=1024)
    store.ingest(ts, vals)
    store.flush_all()
    sizes = dict(n_tablets=4, mem_rows=128, max_runs=2, append_rows=64, capacity=4096)
    planes = [DistIngestPlane.for_store(store, device=d, **sizes) for d in ("cpu", cuda)]
    before = (combine_ops.launches, agg_ops.launches)
    for plane in planes:
        w = DistBatchWriter(store, plane, batch_rows=700, writer_id=4)
        w.add(ts, vals)
        w.close()
    assert all(torch.equal(planes[0].state[k], planes[1].state[k].cpu()) for k in planes[0].state)
    assert agg_ops.launches > before[1]  # the card plane's majors combined through the kernel
    procs = [DistQueryProcessor(store, plane, device=plane.device) for plane in planes]
    specs = [AggregateSpec(group_by=("status",), time_bucket_s=3600),
             AggregateSpec(group_by=("method",), op="sum", value_field="bytes_in",
                           time_bucket_s=3600),
             AggregateSpec(group_by=("domain",), op="min", value_field="bytes_in"),
             AggregateSpec(group_by=("status",), op="max", value_field="bytes_in")]
    trees = [None, pf.Eq("domain", "c.com"),
             pf.And(pf.Eq("domain", "b.com"), pf.Eq("status", "404"))]
    for spec in specs:
        for tree in trees:
            host = [QueryProcessor(store, device=d).aggregate(spec, 0, 14400, tree)
                    for d in ("cpu", cuda)]
            for use_index in (False, True):
                dev = [dq.aggregate_range(spec, tree, 0, 14400, use_index=use_index)
                       for dq in procs]
                for res in host[1:] + dev:
                    np.testing.assert_array_equal(res.gids, host[0].gids)
                    np.testing.assert_array_equal(res.values, host[0].values)
                    np.testing.assert_array_equal(res.counts, host[0].counts)
    assert combine_ops.launches > before[0]
