"""The port's scan path against the JAX reference's.

Both packages ingest the same seeded events into planes of the same shape
and leave rows at every LSM level (base, runs, memtable). scan_range on
fixed time ranges must give the same count and the same top-k slates
(compared as multisets within equal rev_ts, since BatchScanner order is
free there), and whole-query totals of the scan schemes must agree with
the reference and with the port's host EventStore. Adaptive batch ranges
depend on measured times, so only totals are compared for batched_scan.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from repro.core import And as JAnd, Eq as JEq, In as JIn, Not as JNot, Or as JOr
from repro.core import EventStore as JaxEventStore, web_proxy_schema as jax_schema
from repro.core.dist_ingest import DistBatchWriter as JaxWriter, DistIngestPlane as JaxPlane
from repro.core.dist_query import DistQueryProcessor as JaxProcessor
from repro.launch.mesh import make_dev_mesh

from repro_torch.core import filter as pf
from repro_torch.core.dist_ingest import DistBatchWriter, DistIngestPlane
from repro_torch.core.dist_query import DistQueryProcessor, scan_step
from repro_torch.core.scan import scan_events
from repro_torch.core.schema import web_proxy_schema
from repro_torch.core.store import EventStore
from repro_torch.kernels.filter_scan import filter_scan, pad_program

T_SPAN = 4 * 3600
SIZES = dict(mem_rows=64, max_runs=2, append_rows=32)


def gen_events(seed, n):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, T_SPAN, n))
    vals = {
        "domain": rng.choice(["a.com", "b.com", "c.com", "rare.net"],
                             p=[0.6, 0.25, 0.13, 0.02], size=n).tolist(),
        "method": rng.choice(["GET", "POST", "PUT"], size=n).tolist(),
        "status": rng.choice(["200", "404"], size=n, p=[0.8, 0.2]).tolist(),
    }
    return ts, vals


@pytest.fixture(scope="module")
def twin():
    ts, vals = gen_events(21, 1300)
    jstore, pstore = JaxEventStore(jax_schema()), EventStore(web_proxy_schema(), device="cpu")
    # Host oracle: the same events through the port's host EventStore.
    pstore.ingest(ts, vals)
    jstore.ingest(ts, vals)
    jplane = JaxPlane.for_store(jstore, make_dev_mesh(1, 1), capacity=1024,
                                tablets_per_device=4, **SIZES)
    pplane = DistIngestPlane.for_store(pstore, capacity=1024, n_tablets=4, device="cpu", **SIZES)
    jw = JaxWriter(jstore, jplane, batch_rows=200, writer_id=1)
    pw = DistBatchWriter(pstore, pplane, batch_rows=200, writer_id=1)
    for off in range(0, len(ts), 123):
        part = {k: v[off: off + 123] for k, v in vals.items()}
        jw.add(ts[off: off + 123], part)
        pw.add(ts[off: off + 123], part)
    jw.close()
    pw.close()
    tel = pplane.telemetry()
    # Rows at every level: folded bases, live runs and memtables.
    assert tel["base_n"].min() > 0 and tel["n_runs"].min() > 0 and tel["mem_n"].min() > 0
    jq = JaxProcessor(jstore, plane=jplane)
    pq = DistQueryProcessor(pstore, pplane, device="cpu")
    return dict(ts=ts, vals=vals, pstore=pstore, jq=jq, pq=pq, pplane=pplane)


JTREES = [
    JEq("domain", "c.com"),
    JAnd(JEq("domain", "b.com"), JNot(JEq("method", "POST"))),
    JOr(JEq("status", "404"), JIn("domain", ("rare.net", "nope"))),
    None,
    JEq("domain", "never.seen"),
]
PTREES = [
    pf.Eq("domain", "c.com"),
    pf.And(pf.Eq("domain", "b.com"), pf.Not(pf.Eq("method", "POST"))),
    pf.Or(pf.Eq("status", "404"), pf.In("domain", ("rare.net", "nope"))),
    None,
    pf.Eq("domain", "never.seen"),
]


def slate_by_ts(ts, cols):
    return Counter((int(t), tuple(int(x) for x in c)) for t, c in zip(ts, cols))


def host_count(store, tree, t0, t1):
    program = tuple(torch.from_numpy(a) for a in pad_program(pf.compile_tree(store, tree)))
    return sum(int(filter_scan(torch.from_numpy(b.cols), *program).sum())
               for b in scan_events(store, t0, t1))


@pytest.mark.parametrize("i", range(len(PTREES)))
@pytest.mark.parametrize("t_range", [(0, T_SPAN), (1800, 5400), (7000, 7000)])
def test_scan_range_matches_reference(twin, i, t_range):
    t0, t1 = t_range
    jc, jts, jcols = twin["jq"].scan_range(JTREES[i], t0, t1)
    pc, pts, pcols = twin["pq"].scan_range(PTREES[i], t0, t1)
    assert pc == jc == host_count(twin["pstore"], PTREES[i], t0, t1)
    assert pts.dtype == jts.dtype and pcols.dtype == jcols.dtype
    assert slate_by_ts(pts, pcols) == slate_by_ts(jts, jcols)
    assert ((pts >= t0) & (pts <= t1)).all()


def test_scan_step_count_is_int32(twin):
    pq = twin["pq"]
    d = pq._sync()
    prog = pad_program(pf.compile_tree(twin["pstore"], PTREES[0]))
    total, ts, cols = scan_step(d, tuple(torch.from_numpy(a) for a in prog), 0, 2**31 - 2)
    assert total.dtype == torch.int32 and ts.dtype == torch.int32 and cols.dtype == torch.int32
    assert ts.shape == (4, 128) and cols.shape == (4, 128, 12)


@pytest.mark.parametrize("scheme", ["scan", "batched_scan"])
@pytest.mark.parametrize("i", [0, 1, 2])
def test_scheme_totals_match_reference(twin, scheme, i):
    jt = sum(b.count for b in twin["jq"].run_scheme(scheme, 0, T_SPAN, JTREES[i]))
    blocks = list(twin["pq"].run_scheme(scheme, 0, T_SPAN, PTREES[i]))
    assert sum(b.count for b in blocks) == jt == host_count(twin["pstore"], PTREES[i], 0, T_SPAN)
    if scheme == "scan":
        assert len(blocks) == 1
    # Batches tile the range in increasing order.
    assert all(a.hi < b.lo for a, b in zip(blocks, blocks[1:]))


def test_publish_between_queries_sees_new_rows(twin):
    pq, pplane = twin["pq"], twin["pplane"]
    before = pq.scan_range(PTREES[3], 0, T_SPAN)[0]
    ts, vals = gen_events(99, 50)
    w = DistBatchWriter(twin["pstore"], pplane, batch_rows=10, writer_id=2)
    w.add(ts, vals)
    w.close()
    assert pq.scan_range(PTREES[3], 0, T_SPAN)[0] == before + 50
    twin["pstore"].ingest(ts, vals)  # keep the host oracle in step


def test_processor_device_must_be_the_planes(twin):
    with pytest.raises((ValueError, RuntimeError)):
        DistQueryProcessor(twin["pstore"], twin["pplane"], device="cuda")
    plane = DistIngestPlane(12, capacity=32, n_tablets=2, mem_rows=8, device="cpu")
    assert DistQueryProcessor(twin["pstore"], plane, device="cpu").device == plane.device
