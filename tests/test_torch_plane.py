"""The port's device ingest plane against the JAX reference plane.

The same seeded events go through both packages' DistBatchWriter into
planes of the same shape (4 tablets, small slabs, the web-proxy schema's
12 indexed fields). After every flush, every minor and major tripped by
ingest, every compact_step increment and every publish, every tensor of
the port's ``plane.state`` must equal the reference's array bit for bit
with the same dtype, and the counters must agree. The port runs on the
CPU, so its merge and filter wrappers run their plain versions; the
reference runs its jnp paths.
"""
import time

import numpy as np
import pytest
import torch

from repro.core import EventStore as JaxEventStore, web_proxy_schema as jax_schema
from repro.core.dist_ingest import (
    DistBatchWriter as JaxWriter,
    DistIngestPlane as JaxPlane,
)
from repro.launch.mesh import make_dev_mesh

from repro_torch import obs
from repro_torch.core import AggregateSpec, Eq, TrueNode
from repro_torch.core.carry import plane_state_from_numpy
from repro_torch.core.dist_ingest import DistBatchWriter, DistIngestPlane, TabletGroup
from repro_torch.core.dist_query import DistQueryProcessor
from repro_torch.core.schema import web_proxy_schema
from repro_torch.core.store import EventStore
from repro_torch.obs import trace as ptrace

T_SPAN = 4 * 3600
SIZES = dict(n_tablets=4, mem_rows=48, max_runs=2, append_rows=20)


def gen_events(seed, n):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, T_SPAN, n))
    vals = {
        "domain": rng.choice(["a.com", "b.com", "c.com", "rare.net"],
                             p=[0.6, 0.25, 0.13, 0.02], size=n).tolist(),
        "method": rng.choice(["GET", "POST"], size=n).tolist(),
        "status": rng.choice(["200", "404"], size=n, p=[0.8, 0.2]).tolist(),
        "src_ip": rng.choice([f"10.0.0.{i}" for i in range(30)], size=n).tolist(),
    }
    return ts, vals


def numpy_state(state):
    return {k: np.asarray(v) for k, v in state.items()}


# The reference's event-family major computes the new base count as
# ``bn + rn.sum()`` (src/repro/core/dist_ingest.py:512); with jax x64 on,
# that sum is int64, so after the first major its ev_base_n and
# ev_overflow drift from int32 to int64. The port keeps every counter at
# the dtype it was created with; for these two arrays alone the test
# holds the values bit for bit and the port's dtype to int32.
DRIFTING_COUNTERS = {"ev_base_n", "ev_overflow"}


def assert_states_equal(jax_state, port_state, where=""):
    ref = numpy_state(jax_state)
    assert ref.keys() == port_state.keys()
    for name, want in ref.items():
        got = port_state[name].numpy()
        if name in DRIFTING_COUNTERS:
            assert got.dtype == np.int32 and want.dtype in (np.int32, np.int64), name
            want = want.astype(np.int32)
        assert got.dtype == want.dtype, f"{where}{name}: {got.dtype} != {want.dtype}"
        assert got.shape == want.shape, f"{where}{name}: {got.shape} != {want.shape}"
        np.testing.assert_array_equal(got, want, err_msg=f"{where}{name}")


class Twin:
    """One reference plane and one port plane fed identical events."""

    def __init__(self, capacity, seed=11):
        self.jstore = JaxEventStore(jax_schema(), n_shards=2)
        self.pstore = EventStore(web_proxy_schema(), n_shards=2, device="cpu")
        t = SIZES["n_tablets"]
        self.jplane = JaxPlane.for_store(
            self.jstore, make_dev_mesh(1, 1), capacity=capacity, tablets_per_device=t,
            mem_rows=SIZES["mem_rows"], max_runs=SIZES["max_runs"],
            append_rows=SIZES["append_rows"],
        )
        self.pplane = DistIngestPlane.for_store(self.pstore, capacity=capacity, device="cpu",
                                                **SIZES)
        self.jw = JaxWriter(self.jstore, self.jplane, batch_rows=150, writer_id=3)
        self.pw = DistBatchWriter(self.pstore, self.pplane, batch_rows=150, writer_id=3)
        self.seed = seed

    def check(self, where):
        assert_states_equal(self.jplane.state, self.pplane.state, where)
        jt, pt = self.jplane.telemetry(), self.pplane.telemetry()
        for key in ("rows", "minor", "major", "n_runs", "overflow", "mem_n", "base_n",
                    "ix_overflow", "ix_base_n", "ag_overflow", "ag_base_n"):
            want = np.asarray(jt[key])
            assert pt[key].dtype == (np.int64 if key == "rows" else np.int32), key
            np.testing.assert_array_equal(pt[key], want, err_msg=where + key)
        assert pt["fold_events"] == jt["fold_events"]
        assert pt["level_gen"] == jt["level_gen"]
        assert (pt["seal_events"], pt["seal_reuses"]) == (jt["seal_events"], jt["seal_reuses"])
        assert self.pplane.has_unfolded() == self.jplane.has_unfolded()

    def ingest(self, n, step=97, check_every=True):
        ts, vals = gen_events(self.seed, n)
        self.seed += 1
        for off in range(0, n, step):
            sl = slice(off, off + step)
            part = {k: v[sl] for k, v in vals.items()}
            self.jw.add(ts[sl], part)
            self.pw.add(ts[sl], part)
            if check_every:
                self.check(f"after add at {off}: ")
        self.jw.flush()
        self.pw.flush()
        self.check("after flush: ")


@pytest.fixture(scope="module", params=[1024, 96], ids=["roomy", "overflowing"])
def twin(request):
    tw = Twin(capacity=request.param)
    tw.ingest(900)
    return tw


def test_ingest_steps_match_reference(twin):
    # Ingest alone tripped minors and blocking majors in both planes.
    tel = twin.pplane.telemetry()
    assert tel["minor"].min() > 0 and tel["major"].min() > 0
    assert tel["fold_events"].get("ingest", 0) > 0
    if twin.pplane.programs.capacity < 200:
        assert tel["overflow"].sum() > 0  # the small base overflows, as in the reference
    else:
        assert tel["overflow"].sum() == 0
    twin.check("end of ingest: ")


def test_publish_matches_reference(twin):
    jd, pd = twin.jplane.publish(), twin.pplane.publish()
    for name in ("rev_ts", "cols", "counts", "run_rev_ts", "run_cols", "run_counts",
                 "mem_rev_ts", "mem_cols", "mem_counts"):
        want = np.asarray(getattr(jd, name))
        got = getattr(pd, name).numpy()
        if name == "counts":
            want = want.astype(np.int32)  # see DRIFTING_COUNTERS
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # A second publish with nothing new reuses the snapshot.
    assert twin.pplane.publish() is pd
    twin.check("after publish: ")


def test_compact_step_increments_match_reference(twin):
    twin.ingest(300, check_every=False)
    steps = 0
    while True:
        a, b = twin.jplane.compact_step(), twin.pplane.compact_step()
        assert a == b
        twin.check(f"after compact_step {steps}: ")
        if not a:
            break
        steps += 1
        # Publishing between increments reuses the sealed memtable.
        twin.jplane.publish()
        twin.pplane.publish()
        twin.check(f"after publish at step {steps}: ")
    assert steps > 0 and not twin.pplane.has_unfolded()


def test_compact_after_more_ingest_matches_reference(twin):
    twin.ingest(250, check_every=False)
    assert twin.jplane.compact() == twin.pplane.compact()
    twin.check("after compact: ")
    assert twin.pplane.compact() == 0


def test_carry_roundtrip_starts_port_from_reference_state():
    tw = Twin(capacity=1024, seed=40)
    tw.ingest(700, check_every=False)
    assert np.asarray(tw.jplane.state["major"]).min() > 0  # int64 drift included
    fresh = DistIngestPlane.for_store(tw.pstore, capacity=1024, device="cpu", **SIZES)
    fresh.load_state(plane_state_from_numpy(numpy_state(tw.jplane.state), "cpu"))
    assert_states_equal(tw.jplane.state, fresh.state)
    np.testing.assert_array_equal(fresh.group._fill, np.asarray(tw.jplane._fill))
    np.testing.assert_array_equal(fresh.group._runs_host, np.asarray(tw.jplane._runs_host))
    # Both continue from the carried state in lockstep.
    while tw.jplane.compact_step():
        assert fresh.compact_step() == 1
        assert_states_equal(tw.jplane.state, fresh.state, "carried: ")
    assert fresh.compact_step() == 0


def test_load_state_rejects_a_mismatched_state():
    plane = DistIngestPlane(3, capacity=64, n_tablets=2, mem_rows=16, device="cpu")
    state = dict(plane.state)
    state["ev_base_k"] = torch.zeros((2, 65), dtype=torch.int32)
    with pytest.raises(ValueError):
        plane.load_state(state)


def test_plane_requires_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistIngestPlane(3, capacity=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistIngestPlane.for_store(EventStore(web_proxy_schema(), device="cpu"), capacity=64)


def test_sharded_plane_is_left_for_a_later_slice():
    # Plane sharding is ported now (tests/test_torch_sharding.py holds it to
    # the reference): what stays here is the facade's validation.
    with pytest.raises(ValueError, match="divide"):
        DistIngestPlane(3, capacity=64, n_groups=2, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        DistIngestPlane(3, capacity=64, n_tablets=2, n_groups=0, device="cpu")
    plane = DistIngestPlane(3, capacity=64, n_tablets=4, mem_rows=16, n_groups=2, device="cpu")
    assert [g.lock.name for g in plane.groups] == ["plane_lock_g0", "plane_lock_g1"]
    with pytest.raises(RuntimeError, match="n_groups > 1"):
        plane.state


# ------------------------------------------------------------------ spans
@pytest.fixture
def tracing():
    """The port's tracer on and empty for one test, off and empty after."""
    obs.disable()
    obs.clear()
    obs.enable()
    yield obs.get_tracer()
    obs.disable()
    obs.clear()


@pytest.fixture
def counted_fences(monkeypatch):
    """Every span fence, counted (the call still runs)."""
    calls = []
    real = ptrace._fence

    def fence(x):
        calls.append(x)
        real(x)

    monkeypatch.setattr(ptrace, "_fence", fence)
    return calls


def _rows(n, n_tablets, seed=3):
    rng = np.random.default_rng(seed)
    rts = rng.integers(0, 1 << 30, n).astype(np.int32)
    cols = rng.integers(0, 50, (n, 12)).astype(np.int32)
    return rts, cols, rng.integers(0, n_tablets, n)


def test_ingest_records_route_and_append_phases(tracing):
    plane = DistIngestPlane(12, capacity=4096, n_tablets=4, mem_rows=1024, max_runs=2,
                            append_rows=64, device="cpu")
    plane.ingest(*_rows(3 * 64 + 5, 4), writer_id=2)
    by_name = {}
    for r in tracing.records:
        by_name.setdefault(r["name"], []).append(r)
    (route,), (app,) = by_name["ingest.route"], by_name["ingest.append"]
    assert route["args"] == {"rows": 197, "writer": 2, "group": 0}
    assert {k: app["args"][k] for k in ("rows", "writer", "group")} == route["args"]
    assert app["args"]["chunks"] == 4
    plan_s, enqueue_s = app["args"]["plan_s"], app["args"]["enqueue_s"]
    assert plan_s > 0 and enqueue_s > 0 and plan_s + enqueue_s <= app["dur"]
    assert route["t0"] + route["dur"] <= app["t0"]  # routing ends before the lock
    assert "ingest.minor" not in by_name and "ingest.major" not in by_name


def test_tripped_major_is_one_span_holding_the_group_wait(tracing, counted_fences,
                                                          monkeypatch):
    waits = []
    real = TabletGroup._fence

    def group_fence(self):
        waits.append(time.perf_counter())
        real(self)

    monkeypatch.setattr(TabletGroup, "_fence", group_fence)
    plane = DistIngestPlane(12, capacity=4096, n_tablets=2, mem_rows=32, max_runs=1,
                            append_rows=32, device="cpu")
    plane.ingest(*_rows(256, 2), writer_id=0)
    assert plane.telemetry()["major"].min() > 0
    majors = [r for r in tracing.records if r["name"] == "ingest.major"]
    assert len(majors) == len(waits) > 0
    for r, t in zip(majors, waits):
        start = tracing.epoch + r["t0"]
        assert start <= t <= start + r["dur"]
        assert "fence_n" not in r
    assert counted_fences == []  # no span of the ingest path waits on the card
    app = next(r for r in tracing.records if r["name"] == "ingest.append")
    assert app["args"]["plan_s"] + app["args"]["enqueue_s"] <= app["dur"]


# Spans whose fences each sit right before a host read of what they fence.
READBACK_SPANS = {"query.density", "query.aggregate_index", "query.scan_range",
                  "query.scan_index_range"}


@pytest.mark.parametrize("use_index", [False, True], ids=["scan", "index"])
def test_aggregate_fences_only_before_host_reads(tracing, counted_fences, use_index):
    ts, vals = gen_events(5, 600)
    store = EventStore(web_proxy_schema(), device="cpu")
    plane = DistIngestPlane.for_store(store, capacity=1024, device="cpu", **SIZES)
    w = DistBatchWriter(store, plane, batch_rows=150, writer_id=1)
    w.add(ts, vals)
    w.close()
    proc = DistQueryProcessor(store, plane, device="cpu")
    tree = Eq("status", "404") if use_index else TrueNode()
    obs.clear()
    del counted_fences[:]
    res = proc.aggregate_range(AggregateSpec(group_by=("method",)), tree, 0, T_SPAN,
                               use_index=use_index)
    assert int(np.asarray(res.counts).sum()) == (
        int(np.sum(np.asarray(vals["status"]) == "404")) if use_index else len(ts))
    recs = list(tracing.records)
    names = {r["name"] for r in recs}
    assert ("query.aggregate_index" if use_index else "query.aggregate_scan") in names
    fenced = {r["name"] for r in recs if r.get("fence_n")}
    assert fenced <= READBACK_SPANS and "query.aggregate_scan" not in fenced
    assert len(counted_fences) == sum(r.get("fence_n", 0) for r in recs)
