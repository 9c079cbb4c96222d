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
from repro_torch.core.dist_query import DistQueryProcessor
from repro_torch.core.schema import web_proxy_schema
from repro_torch.core.store import EventStore
from repro_torch.kernels.filter_scan import filter_scan, ops as filter_ops, pad_program
from repro_torch.kernels.merge_runs import (
    merge_pair_device,
    merge_ranks,
    merge_ranks_ref,
    merge_sorted_device,
    ops as merge_ops,
)
from repro_torch.kernels.program_eval import program_eval_rows

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


def test_filter_scan_rejects_a_program_too_big_for_shared_memory(cuda):
    opc = torch.zeros(8, dtype=torch.int32, device=cuda)
    sets = torch.full((64, 256), -1, dtype=torch.int32, device=cuda)
    cols = torch.zeros((10, 12), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        filter_scan(cols, opc, opc, opc, sets)


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
