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
    combine_compact,
    combine_compact_ref,
    combine_sorted_counts,
    ops as agg_ops,
)
from repro_torch.kernels.combine_scan import (
    combine_groups,
    combine_groups_ref,
    combine_scan,
    combine_scan_ref,
    combine_segments,
)
from repro_torch.kernels.combine_scan import ops as combine_ops
from repro_torch.kernels.filter_scan import program_tensors
from repro_torch.kernels.merge_intersect import intersect_sorted

from repro_torch.checkpointing import CheckpointManager, restore_checkpoint, save_checkpoint
from repro_torch.configs import ShapeConfig, llcysa
from repro_torch.launch.steps import build_train_step
from repro_torch.models import get_config, moe, ssm
from repro_torch.models.attention import flash_attention, naive_attention
from repro_torch.models.model import decode_step, forward_train, init_params, prefill
from repro_torch.training.optimizer import OptConfig, adamw_init
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

from _torch_combine_cases import CASES, IN_FIELD, IN_UNIVERSE, case_rows, filter_program, in_codes

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


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", ["sparse", "dense", "pads", "unsorted", "empty_set"])
def test_member_mask_kernel_on_sorted_probes_and_staged_slices(cuda, dtype, case):
    """Sorted probes, as the index AND gives them: a sparse set whose slice
    for one tile of probes is far past the shared staging buffer, a dense
    one, duplicates with INT_MAX pads at the end of both rows, and the same
    probes shuffled; m = 0."""
    rng = np.random.default_rng(len(case))
    sentinel = np.iinfo(dtype).max
    rows, n, m = 8, 12288, {"sparse": 200000, "empty_set": 0}.get(case, 12288)
    hi = {"sparse": 1 << 20, "dense": 1 << 16}.get(case, 1 << 12)
    b = np.sort(rng.integers(0, hi, (rows, m)), axis=1).astype(dtype)
    a = np.sort(rng.integers(0, hi, (rows, n)), axis=1).astype(dtype)
    if case in ("pads", "unsorted"):
        a[:, n // 3:] = np.sort(a[:, n // 3:] // 8, axis=1)  # many duplicates
        a.sort(axis=1)
        a[:, -1000:] = sentinel
        b[:, -3000:] = sentinel
    if case == "unsorted":
        a = rng.permuted(a, axis=1)
    ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    got = member_mask(ta, tb)
    torch.cuda.synchronize()
    want = member_mask_keys(ta, tb)
    assert torch.equal(got, want)
    assert case != "empty_set" or not bool(want.any())
    assert case == "empty_set" or bool(want.any())


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


BIG_UNIVERSE = 40_000


@pytest.mark.parametrize("kind", ["trivial", "eq", "in", "in_bitmap", "in_search"])
@pytest.mark.parametrize("case,scale", [(c, 1) for c in CASES] + [
    (c, 512) for c in ("one_group", "singletons", "straddle", "empty_between", "extremes")])
def test_combine_scan_forms_match_plain_versions(cuda, monkeypatch, case, scale, kind):
    """combine_segments (per row) and combine_groups (per group), bit for
    bit against their plain versions on every case of
    tests/_torch_combine_cases.py; scale 512 takes them across many tiles
    and every chunk of the grid (singletons: past the group buffer of a
    chunk). in_bitmap and in_search: an In of 20,000 codes (80 KB, past
    shared memory) answered from its bitmap, and searched in global
    memory with no bitmap allowed."""
    from repro_torch.kernels import program_eval

    gids, vals, cols = case_rows(case, seed=scale, scale=scale)
    codes = in_codes()
    if kind in ("in_bitmap", "in_search"):
        rng = np.random.default_rng(scale)
        codes = in_codes(n_codes=20_000, universe=BIG_UNIVERSE)
        col = cols[:, IN_FIELD]
        cols[:, IN_FIELD] = np.where(col < 0, col, np.where(
            col >= IN_UNIVERSE, BIG_UNIVERSE + 5, rng.integers(0, BIG_UNIVERSE, len(col))))
        if kind == "in_search":
            monkeypatch.setattr(program_eval, "BITMAP_MAX_BYTES", 0)
    prog = filter_program(pf, kind[:2] if kind.startswith("in") else kind, codes)
    program = program_tensors(prog, cuda)
    assert (program.n_bitmap_words > 0) == (kind == "in_bitmap")
    rows = [torch.from_numpy(x).to(cuda) for x in (gids, vals, cols)]
    if kind.startswith("in_"):
        assert torch.equal(filter_scan(rows[2], program), program_eval_rows(rows[2], *program))
    for op in ("count", "sum", "min", "max"):
        v = None if op == "count" else rows[1]
        before = combine_ops.launches
        got = combine_segments(rows[0], v, rows[2], program, op)
        *groups, n = combine_groups(rows[0], v, rows[2], program, op)
        torch.cuda.synchronize()
        assert combine_ops.launches == before + (2 if len(gids) else 0)
        want = combine_scan_ref(rows[0], rows[1], rows[2], *program, op)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), (op, "rows")
        *want_groups, m = combine_groups_ref(rows[0], rows[1], rows[2], *program, op)
        assert n.dtype == m.dtype and int(n) == int(m), op
        for g, w in zip(groups, want_groups):
            assert g.dtype == w.dtype and torch.equal(g[:int(m)], w), (op, "groups")


def test_combine_scan_kernel_refuses_misaligned_rows(cuda):
    gids, vals, cols = (torch.from_numpy(x).to(cuda) for x in case_rows("straddle"))
    program = program_tensors(filter_program(pf, "eq"), cuda)
    for form in (combine_segments, combine_groups):
        with pytest.raises(ValueError, match="16-byte"):
            form(gids[1:], vals[1:], cols[1:], program, "sum")
        with pytest.raises(ValueError, match="16-byte"):
            form(gids[:-1], vals[1:], cols[:-1], program, "sum")


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


@pytest.mark.parametrize("counts_dtype", [torch.int64, torch.int32, None])
@pytest.mark.parametrize("case", ["lives", "chained", "tail_counts", "small_cap", "ag_major"])
def test_combine_compact_kernel_matches_plain_version(cuda, case, counts_dtype):
    """Live lengths 0, 1, a tile boundary and N; keys chained over many
    tiles; nonzero counts in the sentinel tail; cap well under N; the
    aggregate family's 2-way major shape. counts None is the index
    family's dedup."""
    sentinel = torch.iinfo(torch.int64).max
    rows, n, cap, nkeys = {"lives": (5, 5000, 4000, 600), "chained": (3, 40000, 40000, 3),
                           "tail_counts": (4, 3000, 3000, 200), "small_cap": (3, 6000, 700, 5000),
                           "ag_major": (64, 1769472, 1572864, 400000)}[case]
    gen = torch.Generator(device=cuda).manual_seed(n + rows)
    live = {"lives": [0, 1, 512, 1024, n], "chained": [n, 30000, 1]}.get(case)
    if live is None:
        live = torch.randint(0, n + 1, (rows,), device=cuda, generator=gen).tolist()
    keys = torch.randint(0, nkeys, (rows, n), device=cuda, generator=gen).sort(dim=1).values
    n_live = torch.tensor(live, dtype=torch.int32, device=cuda)
    pos = torch.arange(n, device=cuda)[None, :]
    # Past n_live the keys are junk: they count as the sentinel unread.
    keys = torch.where(pos < n_live[:, None], keys, -1 if case == "lives" else sentinel)
    counts = None
    if counts_dtype is not None:
        counts = torch.randint(-9, 1 << 20, (rows, n), device=cuda, generator=gen)
        if case == "lives":
            counts = counts + (1 << 40)
        if case != "tail_counts":
            counts = torch.where(pos < n_live[:, None], counts, 0)
        counts = counts.to(counts_dtype)
    before = agg_ops.launches
    got = combine_compact(keys, counts, n_live, cap, sentinel)
    torch.cuda.synchronize()
    assert agg_ops.launches == before + 1
    want = combine_compact_ref(keys, counts, n_live, cap, sentinel)
    assert got[0].shape == (rows, cap) and got[2].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    if counts is None:
        assert got[1] is None
    else:
        assert got[1].dtype == torch.int64 and torch.equal(got[1], want[1])


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


def _sharded_stream(store, n, n_tablets, seed):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 4 * 3600, n))
    vals = {"domain": rng.choice(["a.com", "b.com", "c.com"], n, p=[0.6, 0.3, 0.1]).tolist(),
            "status": rng.choice(["200", "404"], n).tolist(),
            "bytes_out": rng.integers(64, 4096, n).astype(str).tolist()}
    cols = store.encode_events(ts, vals)
    rts = (2**30 - 1 - ts).astype(np.int32)
    return rts, cols, rng.integers(0, n_tablets, n).astype(np.int64)


def _threaded(plane, rts, cols, tab, n_writers, chunk):
    import threading

    def work(w):
        r, c, t = rts[w::n_writers], cols[w::n_writers], tab[w::n_writers]
        for off in range(0, len(r), chunk):
            plane.ingest(r[off: off + chunk], c[off: off + chunk], t[off: off + chunk],
                         writer_id=w)

    threads = [threading.Thread(target=work, args=(w,)) for w in range(n_writers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)


def test_threaded_sharded_plane_on_the_card_matches_the_cpu(cuda):
    """W = 4 writer threads into G = 4 groups on the card: every group's
    state, drained with compact_step, equals a serial ingest of the same
    rows on the CPU, and the queries agree. aggregate_combine launches
    exactly twice per major and fold increment under the threads."""
    store = EventStore(web_proxy_schema())
    rts, cols, tab = _sharded_stream(store, 12_000, 8, seed=17)
    sizes = dict(capacity=8192, n_tablets=8, mem_rows=256, max_runs=2, append_rows=128,
                 n_groups=4)
    card = DistIngestPlane.for_store(store, device=cuda, **sizes)
    cpu = DistIngestPlane.for_store(store, device="cpu", **sizes)
    before = agg_ops.launches
    _threaded(card, rts, cols, tab, 4, chunk=500)
    torch.cuda.synchronize()
    majors = card.fold_events["ingest"]
    assert majors > 0 and agg_ops.launches - before == 2 * majors
    folds = 0
    while card.has_unfolded():
        folds += card.fold_debt() > 0
        assert card.compact_step() == 1
    assert agg_ops.launches - before == 2 * (majors + folds)
    for w in range(4):
        for off in range(0, len(rts[w::4]), 500):
            cpu.ingest(rts[w::4][off: off + 500], cols[w::4][off: off + 500],
                       tab[w::4][off: off + 500], writer_id=w)
    while cpu.compact_step():
        pass
    np.testing.assert_array_equal(card.telemetry()["rows"], cpu.telemetry()["rows"])
    # Base contents per tablet as multisets: the threads' append order may
    # differ from the serial one, the sorted bases may not.
    for gc, gp in zip(card.groups, cpu.groups):
        for name in ("ev_base_k", "ev_base_n", "ix_base_k", "ix_base_n", "ag_base_k", "ag_base_c",
                     "ag_base_n"):
            assert torch.equal(gc.state[name].cpu(), gp.state[name]), name
    dqs = [DistQueryProcessor(store, p, device=p.device) for p in (card, cpu)]
    for tree in (pf.Eq("domain", "c.com"), pf.And(pf.Eq("domain", "a.com"),
                                                  pf.Cmp("bytes_out", "<", 1000))):
        for scheme in ("scan", "batched_scan", "index", "batched_index"):
            got = [sum(b.count for b in dq.run_scheme(scheme, 0, 4 * 3600, tree)) for dq in dqs]
            assert got[0] == got[1] > 0


def test_launch_counts_stay_exact_under_threads(cuda):
    """Eight threads launching merge_ranks on the card: the counter gains
    exactly one per launch."""
    import threading

    keys = torch.arange(4096, dtype=torch.int64, device=cuda).reshape(2, 2048)
    lengths = torch.full((2, 2), 1024, dtype=torch.int32, device=cuda)
    before = merge_ops.launches

    def work():
        for _ in range(200):
            merge_ranks(keys, [0, 1024, 2048], lengths)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert merge_ops.launches - before == 8 * 200


def test_fence_waits_only_for_work_queued_before_it(cuda):
    """A span's fence waits on an event recorded after its value's
    producer: it returns once that producer has run, while a kernel that
    another thread queued during the wait is still running, and it lets
    that thread run meanwhile (the wait releases the GIL)."""
    import threading
    import time

    from repro_torch import obs

    def cycles(seconds):
        return int(seconds * 2e9)  # the clock is under 2 GHz

    x = torch.ones(1024, device=cuda)
    # Warm-up. An event wait on the card once returned 5 ms into a 0.3 s
    # spin kernel without a warm-up; the cause is not known, and the wait
    # below must not do so.
    torch.cuda._sleep(cycles(0.01))
    warm = torch.cuda.Event()
    warm.record()
    warm.synchronize()
    torch.cuda.synchronize()
    late = torch.cuda.Event()
    res, waiting = {}, threading.Event()

    def fence(y):
        with obs.span("fenced", cat="t") as sp:
            waiting.set()
            res["t0"] = time.perf_counter()
            res["out"] = sp.fence((y, 3))
            res["t1"] = time.perf_counter()
        res["late_running"] = not late.query()

    obs.enable()
    try:
        torch.cuda._sleep(cycles(0.4))
        y = x * 2
        th = threading.Thread(target=fence, args=(y,))
        th.start()
        assert waiting.wait(10)
        time.sleep(0.05)  # the fence has recorded its event by now
        torch.cuda._sleep(cycles(3.0))
        late.record()
        queued_at = time.perf_counter()
        th.join(timeout=30)
    finally:
        obs.disable()
        obs.clear()
    assert not th.is_alive()
    assert res["out"][0] is y and res["out"][1] == 3
    assert queued_at < res["t1"]  # queued while the fence waited
    assert 0.2 < res["t1"] - res["t0"] < 2.0 and res["late_running"]
    torch.cuda.synchronize()
    assert torch.equal(y, torch.full_like(x, 2))


def _serve_events(seed, n):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 2 * 3600, n))
    vals = {"domain": rng.choice(["a.com", "b.com", "c.com", "rare.net"], n,
                                 p=[0.6, 0.25, 0.13, 0.02]).tolist(),
            "method": rng.choice(["GET", "POST"], n).tolist(),
            "status": rng.choice(["200", "404"], n, p=[0.8, 0.2]).tolist()}
    return ts, vals


def test_threaded_sessions_on_the_card_match_the_cpu_plane(cuda):
    """Four client threads stream every scheme over a card plane behind a
    QueryService: every count equals the same query on a CPU plane fed
    the same batches; aggregate and density sessions agree too."""
    import threading

    from repro_torch.core import AggregateSpec
    from repro_torch.serve_db import QueryService

    ts, vals = _serve_events(23, 8000)
    store = EventStore(web_proxy_schema(), n_shards=4)
    store.ingest(ts, vals)
    store.flush_all()
    planes = [DistIngestPlane.for_store(store, capacity=16_000, n_tablets=4, n_groups=2,
                                        mem_rows=1024, max_runs=6, append_rows=512, device=d)
              for d in (cuda, "cpu")]
    for p in planes:
        w = DistBatchWriter(store, p, batch_rows=1500, writer_id=3)
        w.add(ts, vals)
        w.close()
    trees = [pf.Eq("domain", "rare.net"), pf.And(pf.Eq("domain", "c.com"), pf.Eq("status", "404")),
             pf.Or(pf.Eq("domain", "rare.net"), pf.Eq("domain", "c.com")), None]
    jobs = [(scheme, ti) for scheme in ("scan", "batched_scan", "index", "batched_index")
            for ti in range(len(trees))]
    spec = AggregateSpec(group_by=("status",), op="count", time_bucket_s=3600)
    with QueryService(store, planes[1], compactor=False) as svc:
        s = svc.session("cpu")
        want = {j: s.submit(j[0], 0, 7200, trees[j[1]]).count() for j in jobs}
        want_agg = s.submit_aggregate(spec, 0, 7200, trees[1]).drain()[0].blocks[0]
        want_dens = s.submit_density("domain", "c.com", 0, 7200).count()
    got, errors = {}, []
    with QueryService(store, planes[0], compaction_interval=0.01) as svc:
        assert svc.proc.device == cuda and svc.host_proc.device == cuda

        def client(i):
            try:
                s = svc.session(f"card-{i}")
                for j in jobs[i::4]:
                    got[j] = s.submit(j[0], 0, 7200, trees[j[1]]).count(timeout=120)
                s.close()
            except BaseException as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        for backend in ("dist", "host"):
            s = svc.session(backend, backend=backend)
            res = s.submit_aggregate(spec, 0, 7200, trees[1]).drain()[0].blocks[0]
            for k in ("gids", "values", "counts"):
                np.testing.assert_array_equal(getattr(res, k), getattr(want_agg, k))
            assert s.submit_density("domain", "c.com", 0, 7200).count() == want_dens > 0
            s.close()
    assert got == want and min(want.values()) > 0


def test_serve_daemon_on_the_card_writes_an_incident_bundle(cuda, tmp_path, capsys):
    import json

    from repro_torch import obs
    from repro_torch.serve_db.__main__ import main

    try:
        rc = main(["--device", "cuda", "--rows", "1200", "--sessions", "2", "--writers", "1",
                   "--duration", "1.5", "--incident-dir", str(tmp_path / "inc"),
                   "--ttfr-slo", "0.000001", "--window", "5", "--tick", "0.1",
                   "--groups", "1", "--tablets-per-device", "2"])
    finally:
        obs.flight_disable()
        obs.flight_clear()
    assert rc == 0
    out = capsys.readouterr().out
    assert "METRICS_URL=http://127.0.0.1:" in out and f"INCIDENT_DIR={tmp_path / 'inc'}" in out
    bundles = sorted((tmp_path / "inc").glob("*_ttfr_p99"))
    assert bundles, out
    trace = json.loads((bundles[0] / "trace.json").read_text())
    assert obs.validate_chrome_trace(trace) == []
    assert any(e.get("ph") == "X" for e in trace["traceEvents"])


def test_host_store_on_the_card_matches_the_cpu_store(cuda, tmp_path):
    """Four ingest workers into a host EventStore on the card and one into
    the same store on the CPU: the card store's minor sorts, majors (one
    merge_runs launch per major of two or more runs) and combiner give the
    CPU store's rows, densities and aggregates; W = 1 on both devices gives
    equal tablets run for run."""
    from repro_torch.core import AggregateSpec, QueryProcessor
    from repro_torch.pipeline import IngestWorkerPool, SyntheticWebProxySource

    paths = SyntheticWebProxySource(n_domains=200, seed=13).write_files(
        str(tmp_path), n_files=8, lines_per_file=3000, t_start=0, t_stop=7200)
    kw = dict(n_shards=4, flush_rows=2048, max_runs=3)

    def ingest(device, n_workers):
        store = EventStore(web_proxy_schema(), device=device, **kw)
        pool = IngestWorkerPool(store, n_workers=n_workers)
        for p in paths:
            pool.submit_file(p)
        pool.drain(timeout_s=300)
        return store

    def tablets(store):
        return store.event_tablets + store.index_tablets + [store.agg_tablet]

    merge_ops.launches = 0
    card4 = ingest(cuda, 4)
    majors = sum(t.major_compactions for t in tablets(card4))
    assert majors > 0 and merge_ops.launches == majors
    assert all(t.device == cuda for t in tablets(card4))
    card1, cpu1 = ingest(cuda, 1), ingest("cpu", 1)
    for a, b in zip(tablets(card1), tablets(cpu1)):
        assert len(a.runs) == len(b.runs)
        for ra, rb in zip(a.runs, b.runs):
            np.testing.assert_array_equal(ra.keys, rb.keys)
            np.testing.assert_array_equal(ra.cols, rb.cols)
    assert card4.total_rows == cpu1.total_rows == 24_000
    spec = AggregateSpec(group_by=("status",), op="count", time_bucket_s=3600)
    want = QueryProcessor(cpu1, device="cpu").aggregate(spec, 0, 7200)

    def decoded(res, store):
        return sorted(tuple(sorted(r.items())) for r in res.rows(store))

    for store in (card4, card1):
        got = QueryProcessor(store, device=cuda).aggregate(spec, 0, 7200)
        if store is card1:  # one worker: the same dictionary codes as cpu1's
            for k in ("gids", "values", "counts"):
                np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        # Four workers number dictionary values in the order they met them.
        assert decoded(got, store) == decoded(want, cpu1)
        dom = SyntheticWebProxySource(n_domains=200, seed=13).domain_by_popularity(0.0)
        assert store.agg_count("domain", dom, 0, 7200) == cpu1.agg_count("domain", dom, 0, 7200)
    merge_ops.launches = 0
    card4.compact_all()
    assert all(len(t.runs) == 1 for t in tablets(card4))
    assert merge_ops.launches == sum(t.major_compactions for t in tablets(card4)) - majors
    assert sum(t.n_rows for t in card4.event_tablets) == 24_000


# The flash backward on the card against autograd of the naive attention on
# the same inputs: float32 elementwise within atol 1e-4 + rtol 1e-3 (sums of
# up to 700 terms in other orders); bfloat16 (inputs, output and gradients
# rounded to bf16, float32 inside both) within 2% of the tensor's largest
# magnitude, about four times what the same comparison gives on the CPU.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=100, softcap_val=30.0),
                                dict(causal=False)])
def test_flash_backward_on_the_card_matches_naive_autograd(cuda, dtype, kw):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, w = (torch.randn(shape, generator=g, device=cuda).to(dtype) for shape in
                  ((2, 700, 8, 64), (2, 700, 4, 64), (2, 700, 4, 64), (2, 700, 8, 64)))

    def run(fn, **kw2):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*xs, **kw, **kw2)
        (out.float() * w.float()).sum().backward()
        return [out.detach()] + [x.grad for x in xs]

    for got, want in zip(run(flash_attention, q_chunk=256, kv_block=128), run(naive_attention)):
        assert got.dtype == want.dtype == dtype and got.device == cuda
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
        else:
            err = float((got.float() - want.float()).abs().max())
            assert err <= 2e-2 * float(want.float().abs().max()), err


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One build_train_step step of llcysa.smoke() in float32 (no TF32): the
    loss, grad_norm and lr within rtol 1e-5, the parameters within atol
    1e-4 and Adam's moments within 1e-4 of each leaf's largest (the CPU
    parity tests' tolerances)."""
    cfg = llcysa.smoke().replace(dtype="float32")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=0)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 129))
                            .astype(np.int32))
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    out = {}
    for dev in ("cpu", cuda):
        params = tree_map(lambda x: x.to(dev), cpu_params)
        step = build_train_step(cfg, ShapeConfig("t", 128, 4, "train"), opt_cfg, loss_chunk=64,
                                accum_steps=2, device=dev)
        out[str(dev)] = step(params, adamw_init(params, opt_cfg), batch)
    (pc, sc, mc), (pg, sg, mg) = out["cpu"], out[str(cuda)]
    for key in ("loss", "grad_norm", "lr", "total_loss"):
        np.testing.assert_allclose(float(mg[key]), float(mc[key]), rtol=1e-5)
    for a, b in zip(tree_leaves(pg), tree_leaves(pc)):
        assert a.device == cuda and a.dtype == b.dtype
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)
    for key in ("m", "v"):
        for a, b in zip(tree_leaves(sg[key]), tree_leaves(sc[key])):
            assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert sg["step"].dtype == torch.int32 and int(sg["step"]) == 1


def test_checkpoint_round_trip_of_card_tensors(cuda, tmp_path):
    t = {"a": torch.randn((3, 5), device=cuda),
         "b": (torch.randn(7, device=cuda).bfloat16(), torch.tensor(4, dtype=torch.int32,
                                                                    device=cuda))}
    save_checkpoint(tmp_path / "direct", 3, t)
    mgr = CheckpointManager(tmp_path / "mgr", keep=2)
    want = tree_map(torch.clone, t)
    mgr.save(5, t)
    t["a"].add_(1.0)  # save copied to the host before it returned
    mgr.wait()
    like = tree_map(torch.zeros_like, t)
    for step, got in (restore_checkpoint(tmp_path / "direct", like),
                      mgr.restore_latest(like)):
        assert step in (3, 5)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert a.device == cuda and a.dtype == b.dtype and torch.equal(a, b)


def test_windowed_capped_flash_backward_on_the_card_matches_naive_autograd(cuda):
    """gemma2's local attention at a small size: head_dim 256, window 128,
    soft-cap 50, scale 1/16, float32; the bound of the float32 case above."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, w = (torch.randn((1, 512, 4, 256), generator=g, device=cuda) for _ in range(4))
    kw = dict(causal=True, window=128, softcap_val=50.0, scale=1.0 / 16.0)

    def run(fn, **kw2):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*xs, **kw, **kw2)
        (out * w).sum().backward()
        return [out.detach()] + [x.grad for x in xs]

    for got, want in zip(run(flash_attention, q_chunk=128, kv_block=64), run(naive_attention)):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-12b"])
def test_ring_cache_decode_on_the_card_matches_prefill_and_the_cpu(cuda, arch):
    """smoke() in float32 (no TF32): a prompt past the local window, then
    decode steps that wrap the ring further; each step's logits agree with
    a prefill over the longer prompt within tests/test_models.py's 2e-3,
    and with the same decode on the CPU within atol = rtol = 1e-4."""
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 48)))
    s = cfg.window + 4
    logits = {}
    for dev in ("cpu", cuda):
        params = tree_map(lambda x: x.to(dev), cpu_params)
        x = toks.to(dev)
        _, caches, _ = prefill(params, cfg, {"inputs": x[:, :s]}, cache_len=48)
        assert caches[0]["k"].shape[2] == min(cfg.window, 48)
        steps = []
        for t in range(s, 48):
            ld, caches = decode_step(params, cfg, {"inputs": x[:, t:t + 1]}, caches,
                                     torch.full((2,), t, device=dev))
            lf, _, _ = prefill(params, cfg, {"inputs": x[:, :t + 1]})
            assert float((ld - lf).abs().max()) < 2e-3
            steps.append(ld.cpu())
        logits[str(dev)] = torch.stack(steps)
    torch.testing.assert_close(logits[str(cuda)], logits["cpu"], rtol=1e-4, atol=1e-4)


def test_moe_ffn_on_the_card_matches_the_cpu(cuda):
    """moonshot's MoE FFN at a small width in float32 (no TF32), at the
    default capacity factor (tokens drop) and at 16: output and aux loss
    within atol = rtol = 1e-4 of the CPU's (the CPU parity tolerance)."""
    g = torch.Generator().manual_seed(4)
    d, f, e = 64, 96, 8
    p = {"router": torch.randn((d, e), generator=g) / 8,
         "wi_gate": torch.randn((e, d, f), generator=g) / 8,
         "wi_up": torch.randn((e, d, f), generator=g) / 8,
         "wo": torch.randn((e, f, d), generator=g) / 10}
    x = torch.randn((2, 40, d), generator=g) + 0.7
    for cf in (1.25, 16.0):
        out = {}
        for dev in ("cpu", cuda):
            y, aux = moe.moe_ffn({k: v.to(dev) for k, v in p.items()}, x.to(dev), top_k=2,
                                 capacity_factor=cf, act="silu")
            out[str(dev)] = (y.cpu(), aux.cpu())
        for a, b in zip(out[str(cuda)], out["cpu"]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s,chunk", [(600, 256), (256, 256), (5, 256)])
def test_ssd_chunked_on_the_card_matches_the_cpu(cuda, s, chunk):
    """mamba2's SSD at full head count (48 heads of 64, state 128): three
    chunks with padding, one chunk, a sequence shorter than the chunk;
    with an initial state. y and the final state: max |card - CPU| <=
    1e-5 x max |CPU| for each (y reaches about 140 here, and each output
    sums hundreds of float32 terms in another order on the card: an
    element-wise atol of 1e-4 missed by 1.06e-4 on one of 1,843,200
    elements on an H100)."""
    g = torch.Generator().manual_seed(s)
    b, h, p, n = 1, 48, 64, 128
    x = torch.randn((b, s, h, p), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g) - 2)
    a = -torch.exp(0.5 * torch.randn(h, generator=g))
    bm, cm = torch.randn((b, s, n), generator=g), torch.randn((b, s, n), generator=g)
    s0 = torch.randn((b, h, n, p), generator=g)
    want = ssm.ssd_chunked(x, dt, a, bm, cm, chunk, initial_state=s0)
    got = ssm.ssd_chunked(*(t.to(cuda) for t in (x, dt, a, bm, cm)), chunk,
                          initial_state=s0.to(cuda))
    for u, w in zip(got, want):
        assert u.device == cuda and u.shape == w.shape
        assert float((u.cpu() - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_zamba2_decode_on_the_card_matches_prefill_and_the_cpu(cuda):
    """zamba2's smoke() in float32: a prompt of 40 (two SSM chunks of 32,
    the second padded), then decode steps through the SSM state, the conv
    tail and the shared block's K/V; each step's logits within 2e-3 of a
    prefill over the longer prompt, and within atol = rtol = 1e-4 of the
    same decode on the CPU."""
    cfg = get_config("zamba2-2.7b", smoke=True).replace(dtype="float32")
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 48)))
    logits = {}
    for dev in ("cpu", cuda):
        params = tree_map(lambda x: x.to(dev), cpu_params)
        x = toks.to(dev)
        _, caches, _ = prefill(params, cfg, {"inputs": x[:, :40]}, cache_len=48)
        steps = []
        for t in range(40, 48):
            ld, caches = decode_step(params, cfg, {"inputs": x[:, t:t + 1]}, caches,
                                     torch.full((2,), t, device=dev))
            lf, _, _ = prefill(params, cfg, {"inputs": x[:, :t + 1]})
            assert float((ld - lf).abs().max()) < 2e-3
            steps.append(ld.cpu())
        logits[str(dev)] = torch.stack(steps)
    torch.testing.assert_close(logits[str(cuda)], logits["cpu"], rtol=1e-4, atol=1e-4)


def test_moonshot_train_gradients_on_the_card_match_the_cpu(cuda):
    """One train step's gradients of moonshot's smoke() in float32 (no
    TF32), remat on: the loss and aux loss within rtol 1e-5, every
    gradient leaf, the router's included, within atol 1e-5 and rtol 1e-4
    of the CPU's (ten times the CPU parity tests' atol: cuBLAS and the CPU
    sum in different orders)."""
    cfg = get_config("moonshot-v1-16b-a3b", smoke=True).replace(dtype="float32")
    cpu_params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 65)))
    out = {}
    for dev in ("cpu", cuda):
        flat, treedef = tree_flatten(tree_map(lambda x: x.to(dev), cpu_params))
        leaves = [x.requires_grad_(True) for x in flat]
        loss, metrics = forward_train(tree_unflatten(treedef, leaves), cfg,
                                      {"inputs": toks[:, :-1].to(dev),
                                       "targets": toks[:, 1:].to(dev)}, loss_chunk=32)
        grads = torch.autograd.grad(loss, leaves)
        out[str(dev)] = (float(loss.detach()), float(metrics["aux_loss"].detach()),
                         [x.cpu() for x in grads])
    (lg, ag, gg), (lc, ac, gc) = out[str(cuda)], out["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    np.testing.assert_allclose(ag, ac, rtol=1e-5)
    assert ac > 0
    for a, b in zip(gg, gc):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
