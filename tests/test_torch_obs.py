"""The port's observability plane (repro_torch.obs) against the reference
(repro.obs): histograms, registry snapshots and the Prometheus text equal
for the same seeded observations, Chrome traces that both validators
accept, watchdog incidents equal over the same probe series on an
injected clock, and the port's own checks of spans, sampling, the flight
recorder, lock books, the exporters and the CUDA-event fence's pass-
through. The disabled and sampled-out paths are tested by what they
record, never by a wall-clock ratio."""
import json
import threading
import time
from types import SimpleNamespace
from urllib.error import HTTPError
from urllib.request import urlopen

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs import watchdog as jwatchdog
from repro.obs.registry import MetricsRegistry as JRegistry
from repro_torch import obs
from repro_torch.core import Eq, EventStore, web_proxy_schema
from repro_torch.core.dist_ingest import DistBatchWriter, DistIngestPlane
from repro_torch.obs import trace as ptrace
from repro_torch.obs import watchdog as pwatchdog
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serve_db import QueryService

T_SPAN = 2 * 3600


def _reset(o):
    o.disable()
    o.clear()
    fr = o.get_flight()
    fr.enable(per_thread=8192)  # the default ring size, cleared if it changed
    fr.disable()
    fr.clear()


@pytest.fixture(autouse=True)
def _reset_obs():
    """Tracing, sampling and the flight recorder are process-wide: every
    test starts and ends with both off and empty."""
    for o in (obs, jobs):
        _reset(o)
    yield
    for o in (obs, jobs):
        _reset(o)


def _observations(seed, n=2000):
    """Seeded values, with some exactly on the default bucket edges."""
    rng = np.random.default_rng(seed)
    vals = rng.lognormal(mean=-4, sigma=2.0, size=n)
    edges = np.asarray(obs.Histogram.DEFAULT_EDGES)
    vals[::7] = edges[rng.integers(0, len(edges), len(vals[::7]))]
    return vals


# ---------------------------------------------------- parity with repro.obs
@pytest.mark.parametrize("edges", [None, (0.001, 0.01, 0.1, 1.0), (1.0, 2.0)])
def test_histogram_matches_reference(edges):
    vals = _observations(7)
    ours = MetricsRegistry("t_h_port").histogram("lat", edges=edges)
    ref = JRegistry("t_h_ref").histogram("lat", edges=edges)
    for i, v in enumerate(vals):
        labels = {"op": ("scan", "index")[i % 2]}
        ours.observe(float(v), exemplar=f"q{i}", **labels)
        ref.observe(float(v), exemplar=f"q{i}", **labels)
    assert ours.edges == ref.edges
    for op in ("scan", "index"):
        assert ours.snapshot(op=op) == ref.snapshot(op=op)
    # The bucket counts against numpy's half-open-on-the-left histogram.
    e = list(ours.edges)
    want = np.zeros(len(e) + 1, np.int64)
    for part in (vals[0::2], vals[1::2]):
        idx = np.searchsorted(np.asarray(e), part, side="left")
        want += np.bincount(idx, minlength=len(e) + 1)
    got = np.add(ours.snapshot(op="scan")["buckets"], ours.snapshot(op="index")["buckets"])
    np.testing.assert_array_equal(got, want)


def _fill(reg, seed):
    rng = np.random.default_rng(seed)
    c = reg.counter("rows_total", 'rows "ingested"')
    g = reg.gauge("fill", "memtable fill")
    h = reg.histogram("lat_seconds", "latency", edges=(0.01, 0.1, 1.0))
    for i in range(300):
        c.inc(float(rng.integers(1, 100)), writer=int(rng.integers(0, 4)))
        g.set(float(rng.random()), tablet=int(rng.integers(0, 3)))
        g.max(float(rng.random() * 2), kind="max")
        h.observe(float(rng.lognormal(-3, 1.5)), exemplar=f"q{i}",
                  scheme=("scan", "batched_index")[i % 2])
    c.inc(1.0, path='a"b\\c\nd')


def test_registry_snapshot_and_prometheus_text_match_reference():
    ours, ref = MetricsRegistry("t_prom_port"), JRegistry("t_prom_ref")
    _fill(ours, 3)
    _fill(ref, 3)
    assert ours.snapshot() == ref.snapshot()
    assert obs.to_prometheus_text(ours) == jobs.to_prometheus_text(ref)
    assert obs.to_prometheus_text(MetricsRegistry("t_prom_empty")) == ""


def test_chrome_trace_with_nesting_sampling_and_evicted_parents_passes_both_validators():
    obs.flight_enable(per_thread=4)
    obs.enable(sample=1 / 2)
    try:
        for i in range(6):
            with obs.span(f"root{i}", cat="t"):
                with obs.span(f"child{i}", cat="t"):
                    with obs.span(f"leaf{i}", cat="t"):
                        pass
        # A root held open past the ring's size: its children's parent is
        # evicted or not yet recorded when the dump is taken.
        with obs.span("open_root", cat="t"):
            for i in range(6):
                with obs.span(f"late{i}", cat="t"):
                    pass
            mid = obs.flight_dump(window_s=60.0)
    finally:
        obs.disable()
    doc = json.loads(json.dumps(obs.chrome_trace()))
    for d in (doc, json.loads(json.dumps(mid)), obs.flight_dump(window_s=60.0)):
        assert obs.validate_chrome_trace(d) == []
        assert jobs.validate_chrome_trace(d) == []
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    # Roots 0, 2, 4 and the open root survive the 1/2 sampler with their trees.
    assert set(names) == {f"{k}{i}" for k in ("root", "child", "leaf") for i in (0, 2, 4)} | {
        "open_root"} | {f"late{i}" for i in range(6)}
    by_name = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert by_name["leaf2"]["args"]["parent"] == by_name["child2"]["args"]["sid"]
    assert by_name["child2"]["args"]["parent"] == by_name["root2"]["args"]["sid"]
    xs = [e for e in mid["traceEvents"] if e.get("ph") == "X"]
    assert [e["name"] for e in xs] == ["late2", "late3", "late4", "late5"]
    assert all("parent" not in e["args"] for e in xs)
    for bad in ({}, {"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": 0.0,
                                      "dur": 1.0, "args": {"sid": 1, "parent": 99}}]}):
        assert obs.validate_chrome_trace(bad) == jobs.validate_chrome_trace(bad) != []


def _clock(start=1000.0):
    state = {"t": start}
    fake = SimpleNamespace(perf_counter=lambda: state["t"], time=lambda: 0.0)
    return state, fake


def test_watchdog_tick_matches_reference_on_an_injected_clock(tmp_path, monkeypatch):
    """Both watchdogs evaluate the same event, delta and gauge probe
    series on a clock the test advances: the same values every tick and
    the same incidents, cooldown included."""
    rng = np.random.default_rng(5)
    ticks = 40
    events = [[(float(j), float(rng.lognormal(-2, 1))) for j in range(int(rng.integers(0, 4)))]
              for _ in range(ticks)]
    totals = np.cumsum(rng.random(ticks) * 0.4)
    gauges = rng.random(ticks) * 1.5
    runs = {}
    for name, pkg, mod, reg in (("port", obs, pwatchdog, MetricsRegistry("t_wd_port")),
                                ("ref", jobs, jwatchdog, JRegistry("t_wd_ref"))):
        state, fake = _clock()
        monkeypatch.setattr(mod, "time", fake)
        k = {"i": 0}

        def ev_probe():
            return [(state["t"] - dt * 0.01, v) for dt, v in events[k["i"]]]

        rules = [
            pkg.WatchRule("ttfr_p99", ev_probe, 0.3, window_s=2.0, agg="p99", cooldown_s=1.0),
            pkg.WatchRule("worst", ev_probe, 0.6, window_s=1.0, agg="max", cooldown_s=3.0),
            pkg.WatchRule("wait", lambda: totals[k["i"]], 1.0, window_s=1.5, agg="delta",
                          cooldown_s=2.0),
            pkg.WatchRule("stall", lambda: gauges[k["i"]], 1.2, agg="gauge", cooldown_s=0.5),
        ]
        wd = pkg.Watchdog(rules, incident_dir=str(tmp_path / name), registry=reg)
        values = []
        for i in range(ticks):
            k["i"] = i
            wd.tick()
            values.append(wd.values())
            state["t"] += 0.25
        incidents = [(i["kind"], i["rule"], i["value"], i["threshold"],
                      i["bundle"].rsplit("/", 1)[-1]) for i in wd.incidents()]
        runs[name] = (values, incidents, reg.snapshot())
    assert runs["port"][0] == runs["ref"][0]
    assert runs["port"][1] == runs["ref"][1] and len(runs["port"][1]) >= 4
    assert runs["port"][2] == runs["ref"][2]


# ----------------------------------------------------------------- registry
def test_counter_label_semantics_and_threaded_total():
    reg = MetricsRegistry("t_counter")
    c = reg.counter("rows")
    rng = np.random.default_rng(0)
    per = {}
    for _ in range(500):
        w, v = int(rng.integers(0, 5)), float(rng.integers(1, 100))
        c.inc(v, writer=w)
        per[w] = per.get(w, 0.0) + v
    for w, total in per.items():
        assert c.value(writer=w) == total
    c.reset(writer=0)
    assert c.value(writer=0) == 0.0 and c.value(writer=1) == per.get(1, 0.0)
    hits = reg.counter("hits")

    def work(tid):
        for _ in range(2000):
            hits.inc(1, thread=tid)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert hits.total() == 8000


def test_registry_disabled_is_noop_and_kinds_collide():
    reg = MetricsRegistry("t_disabled", enabled=False)
    c, h, g = reg.counter("n"), reg.histogram("h"), reg.gauge("g")
    c.inc(5)
    h.observe(1.0)
    g.set(2.0)
    assert c.total() == 0.0 and h.count() == 0 and g.value() == 0.0
    with pytest.raises(TypeError):
        reg.gauge("n")
    assert reg.get("h") is h and reg.get("missing") is None


def test_every_registry_joins_the_exports():
    """A plane's private registry shows up in all_registries() and in the
    process-wide snapshot and text, beside the default registry."""
    store = EventStore(web_proxy_schema(), n_shards=2, device="cpu")
    plane = DistIngestPlane.for_store(store, capacity=64, n_tablets=2, mem_rows=16,
                                      device="cpu")
    plane._m_blocked.inc(0.5, writer=3)
    obs.get_registry().counter("t_default_total").inc(2)
    assert plane.metrics in obs.all_registries()
    assert obs.get_registry() in obs.all_registries()
    snap = obs.metrics_snapshot()
    assert snap["kind"] == "obs_metrics_snapshot" and snap["schema_version"] == 1
    cells = snap["registries"][plane.metrics.name]["plane_blocked_seconds_total"]["cells"]
    assert cells == {"writer=3": 0.5}
    assert "lock_occupancy" in snap
    json.dumps(snap)
    assert 'plane_blocked_seconds_total{writer="3"} 0.5' in obs.to_prometheus_text(plane.metrics)
    assert "t_default_total 2" in obs.to_prometheus_text()
    summary = obs.summary()
    assert "plane_blocked_seconds_total" in summary and "t_default_total" in summary


# -------------------------------------------------------------- OwnedLock
def test_owned_lock_books_partition_the_held_time():
    lk = obs.OwnedLock("t_lock")
    with lk.hold("a"):
        time.sleep(0.01)
        with lk.reowner("b"):
            time.sleep(0.02)
    with lk.hold("c"):
        pass
    with lk:
        pass
    snap = lk.snapshot()
    by = snap["by_owner_s"]
    assert set(by) == {"a", "b", "c", "unknown"}
    assert sum(by.values()) == pytest.approx(snap["total_held_s"], rel=1e-9)
    assert by["b"] >= 0.015 and snap["acquisitions"] == 3
    assert snap["acq_by_owner"]["a"] == 2  # one segment before and one after b


def test_owned_lock_nonblocking_acquire_and_wait_books():
    lk = obs.OwnedLock("t_lock_nb")
    assert lk.acquire(blocking=False, owner="x")
    assert lk.locked()
    assert not lk.acquire(blocking=False, owner="y")
    lk.release()
    assert not lk.locked()
    assert "y" not in lk.snapshot()["by_owner_s"] and lk.snapshot()["acquisitions"] == 1
    started = threading.Event()

    def holder():
        with lk.hold("hog"):
            started.set()
            time.sleep(0.1)

    t = threading.Thread(target=holder)
    t.start()
    assert started.wait(10)
    with lk.hold("waiter"):
        pass
    t.join(timeout=10)
    assert not t.is_alive()
    snap = lk.snapshot()
    assert snap["wait_by_owner_s"]["waiter"] > 0.05
    assert sum(snap["wait_by_owner_s"].values()) == pytest.approx(snap["total_wait_s"])
    twin = obs.OwnedLock("t_lock_nb")  # same name: the report merges the books
    with twin.hold("x"):
        pass
    merged = obs.occupancy_snapshot()["t_lock_nb"]
    assert merged["acquisitions"] == snap["acquisitions"] + 1
    assert lk in obs.all_locks() and twin in obs.all_locks()
    lk.reset()
    assert lk.snapshot()["total_wait_s"] == 0.0 and lk.snapshot()["acquisitions"] == 0


def test_lock_wait_rule_sums_locks_by_prefix():
    """"t_pfx_lock" covers t_pfx_lock_g0 and _g1 (as "plane_lock" covers a
    sharded plane's group locks), not t_other_lock."""
    locks = [obs.OwnedLock(n) for n in ("t_pfx_lock_g0", "t_pfx_lock_g1", "t_other_lock")]
    rule = obs.lock_wait_rule("wait", "t_pfx_lock", 1e-9, window_s=60.0)
    assert rule.agg == "delta" and rule.probe() == 0.0
    for lk, waited in zip(locks, (0.25, 0.5, 10.0)):
        with lk._slock:
            lk.total_wait += waited
    assert rule.probe() == pytest.approx(0.75)


# ------------------------------------------------------------------ tracing
def test_span_nesting_parent_linkage_and_thread_names():
    obs.enable()
    with obs.span("outer", cat="t"):
        with obs.span("inner", cat="t", k=3) as si:
            si.set(result=9)
    with obs.span("sibling", cat="t"):
        pass
    obs.disable()
    recs = {r["name"]: r for r in obs.get_tracer().records}
    assert set(recs) == {"outer", "inner", "sibling"}
    assert recs["inner"]["parent"] == recs["outer"]["sid"]
    assert recs["sibling"]["parent"] == 0 and recs["outer"]["parent"] == 0
    assert recs["inner"]["args"] == {"k": 3, "result": 9}
    o, i = recs["outer"], recs["inner"]
    assert o["t0"] <= i["t0"] and i["t0"] + i["dur"] <= o["t0"] + o["dur"] + 1e-6
    assert obs.get_tracer().thread_names()[o["tid"]] == threading.current_thread().name


def test_sampling_keeps_every_nth_root_with_its_children():
    obs.enable(sample=1 / 3)
    for i in range(9):
        with obs.span(f"root{i}", cat="t"):
            with obs.span(f"child{i}", cat="t"):
                pass
    obs.disable()
    assert obs.get_tracer().sample_n == 1  # disable resets the knob
    names = [r["name"] for r in obs.get_tracer().records]
    assert names == ["child0", "root0", "child3", "root3", "child6", "root6"]
    with pytest.raises(ValueError):
        obs.enable(sample=-0.5)


@pytest.mark.parametrize("mode", ["disabled", "sampled_out"])
def test_disabled_and_sampled_out_spans_record_nothing(mode):
    """Counted, not timed: a disabled or sampled-out span leaves no
    tracer record and no flight entry, and its fence and set pass
    through."""
    if mode == "sampled_out":
        obs.enable(sample=1 / 100_000)
        with obs.span("kept_first_root", cat="t"):
            pass
    for _ in range(5000):
        with obs.span("x", cat="t") as sp:
            assert sp.fence(41) == 41
            sp.set(ignored=True)
            with obs.span("x.child", cat="t"):
                pass
    obs.disable()
    names = [r["name"] for r in obs.get_tracer().records]
    assert names == ([] if mode == "disabled" else ["kept_first_root"])
    assert obs.get_flight().records() == []


def test_flight_captures_sampled_out_spans_and_lock_holds():
    obs.flight_enable()
    obs.enable(sample=1 / 3)
    lk = obs.OwnedLock("t_flight_lock")
    for i in range(9):
        with obs.span(f"fr{i}", cat="t"):
            with obs.span(f"fk{i}", cat="t"):
                pass
    with lk.hold("owner_a"):
        pass
    obs.disable()
    recs = obs.get_flight().records()
    fnames = {r["name"] for r in recs}
    assert {f"fr{i}" for i in range(9)} | {f"fk{i}" for i in range(9)} <= fnames
    assert any(r["name"] == "lock/t_flight_lock" and r["args"]["owner"] == "owner_a"
               for r in recs)
    troots = [r for r in obs.get_tracer().records if r["name"].startswith("fr")]
    assert len(troots) == 3


def test_flight_ring_wraparound_evicts_oldest():
    fr = obs.FlightRecorder(per_thread=8)
    for i in range(20):
        with fr.span(f"s{i}", cat="t"):
            pass
    recs = fr.records()
    assert [r["name"] for r in recs] == [f"s{i}" for i in range(12, 20)]
    assert len({r["sid"] for r in recs}) == 8 and all(r["sid"] >= 1 << 40 for r in recs)


def test_flight_captures_the_serve_plane_with_tracing_disabled():
    rng = np.random.default_rng(11)
    n = 2000
    ts = np.sort(rng.integers(0, T_SPAN, n))
    vals = {"domain": rng.choice(["a.com", "b.com", "rare.net"], p=[0.6, 0.38, 0.02],
                                 size=n).tolist(),
            "status": rng.choice(["200", "404"], size=n).tolist()}
    store = EventStore(web_proxy_schema(), n_shards=2, device="cpu")
    store.ingest(ts, vals)
    store.flush_all()
    obs.flight_enable()
    plane = DistIngestPlane.for_store(store, capacity=4 * n, n_tablets=2, mem_rows=256,
                                      max_runs=4, append_rows=128, device="cpu")
    w = DistBatchWriter(store, plane, batch_rows=512)
    w.add(ts, vals)
    w.close()
    plane.compact(source="explicit")
    with QueryService(store, plane, compaction_interval=0.01) as svc:
        s = svc.session("flight0")
        s.submit("batched_index", 0, T_SPAN, Eq("domain", "a.com")).drain(timeout=60.0)
    doc = obs.flight_dump(window_s=600.0)
    assert obs.validate_chrome_trace(doc) == [] and jobs.validate_chrome_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"serve.turn", "ingest.compact", "ingest.append"} <= names
    assert any(n.startswith("query.") for n in names)
    assert not obs.get_tracer().records


def test_fence_passes_values_through_unchanged():
    obs.enable()
    t = torch.arange(5)
    tup = (torch.ones(2), 3, "s")
    lst = [torch.zeros(1), None]
    dct = {"a": torch.ones(1), "b": 2.5}
    with obs.span("fenced", cat="t") as sp:
        assert sp.fence(t) is t
        assert sp.fence(tup) is tup
        assert sp.fence(lst) is lst
        assert sp.fence(dct) is dct
        assert sp.fence(7) == 7 and sp.fence(None) is None
    obs.disable()
    assert torch.equal(t, torch.arange(5))
    rec = next(r for r in obs.get_tracer().records if r["name"] == "fenced")
    assert rec.get("fence_s", 0.0) >= 0.0
    # A CPU tensor needs no event: no CUDA call is made here.
    devices = {}
    ptrace._cuda_devices((t, [t], {"k": t}), devices)
    assert devices == {}


def test_fence_counts_each_readback():
    obs.enable()
    with obs.span("three", cat="t") as sp:
        for _ in range(3):
            sp.fence(torch.ones(2))
    with obs.span("none", cat="t"):
        pass
    obs.disable()
    recs = {r["name"]: r for r in obs.get_tracer().records}
    assert recs["three"]["fence_n"] == 3 and recs["three"]["fence_s"] >= 0.0
    assert "fence_n" not in recs["none"] and "fence_s" not in recs["none"]


def test_records_between_gives_spans_on_the_host_clock():
    obs.enable()
    with obs.span("before", cat="t"):
        pass
    a = time.perf_counter()
    with obs.span("inside", cat="t"):
        time.sleep(0.002)
    b = time.perf_counter()
    time.sleep(0.002)
    with obs.span("after", cat="t"):
        pass
    obs.disable()
    tr = obs.get_tracer()
    recs = tr.records_between(a, b)
    inside = next(r for r in recs if r["name"] == "inside")
    assert a <= inside["start"] <= inside["end"] <= b
    assert inside["end"] - inside["start"] == pytest.approx(inside["dur"])
    assert "after" not in {r["name"] for r in recs}
    assert all("start" not in r for r in tr.records)  # the deque's records stay as they were


def test_dropped_counts_records_a_full_deque_pushes_out():
    tr = ptrace.Tracer(maxlen=4)
    tr.enabled = True
    for i in range(5):
        with tr.span(f"s{i}", cat="t"):
            pass
    tr.add_complete("lock/t", time.perf_counter(), 0.001, cat="lock")
    assert tr.dropped == 2 and len(tr.records) == 4
    assert [r["name"] for r in tr.records] == ["s2", "s3", "s4", "lock/t"]
    tr.clear()
    assert tr.dropped == 0 and not tr.records
    with tr.span("fresh", cat="t"):
        pass
    assert tr.dropped == 0 and len(tr.records) == 1


# ---------------------------------------------------------------- exporters
def test_prometheus_endpoint_serves_scrapes_and_stops():
    reg = MetricsRegistry("t_prom_http")
    reg.counter("scrapes_total", "scrapes").inc(3, path="/metrics")
    ep = obs.serve_prometheus(reg)
    try:
        assert ep.host == "127.0.0.1" and ep.port > 0
        body = urlopen(ep.url, timeout=5).read().decode()
        assert body == obs.to_prometheus_text(reg)
        assert 'scrapes_total{path="/metrics"} 3' in body
        with pytest.raises(HTTPError) as exc:
            urlopen(f"http://{ep.host}:{ep.port}/other", timeout=5)
        assert exc.value.code == 404
    finally:
        ep.stop()
    with pytest.raises(OSError):
        urlopen(f"http://{ep.host}:{ep.port}/metrics", timeout=1)
    with obs.serve_prometheus(reg) as ep2:
        assert urlopen(ep2.url, timeout=5).status == 200


def test_write_exporters_roundtrip(tmp_path):
    obs.enable()
    with obs.span("io", cat="t"):
        pass
    obs.disable()
    tdoc = obs.write_chrome_trace(str(tmp_path / "trace.json"))
    mdoc = obs.write_metrics_json(str(tmp_path / "metrics.json"))
    assert json.loads((tmp_path / "trace.json").read_text()) == json.loads(json.dumps(tdoc))
    assert jobs.validate_chrome_trace(tdoc) == []
    assert json.loads((tmp_path / "metrics.json").read_text())["schema_version"] == 1
    assert "lock_occupancy" in mdoc


def test_watchdog_writes_an_incident_bundle_and_survives_a_broken_probe(tmp_path):
    reg = MetricsRegistry("t_wd_bundle")
    pending = []

    def probe():
        out = list(pending)
        pending.clear()
        return out

    def bad_probe():
        raise RuntimeError("probe exploded")

    g = reg.gauge("stall_seconds", "worst increment")
    c = reg.counter("blocked_seconds_total", "writer blocked")
    wd = obs.Watchdog(
        [obs.WatchRule("ttfr_p99", probe, 0.5, window_s=30.0, agg="p99", cooldown_s=3600.0),
         obs.gauge_rule("stall", g, 0.5, cooldown_s=3600.0),
         obs.counter_delta_rule("blocked", c, 1.0, window_s=30.0, cooldown_s=3600.0),
         obs.WatchRule("boom", bad_probe, 1.0, agg="gauge")],
        incident_dir=str(tmp_path / "inc"), registry=reg, flight_window_s=60.0)
    obs.flight_enable()
    with obs.span("incident_context", cat="t"):
        pass
    wd.tick()
    assert [i["rule"] for i in wd.incidents()] == ["boom"]
    pending.append((time.perf_counter(), 1.25))
    g.set(0.75)
    c.inc(5.0, writer="w0")
    wd.tick()
    wd.tick()  # cooldown: no second bundle
    fired = [i for i in wd.incidents() if i["kind"] == "incident"]
    assert sorted(i["rule"] for i in fired) == ["blocked", "stall", "ttfr_p99"]
    for inc in fired:
        trace = json.loads(open(f"{inc['bundle']}/trace.json").read())
        assert obs.validate_chrome_trace(trace) == [] and jobs.validate_chrome_trace(trace) == []
        assert any(e.get("name") == "incident_context" for e in trace["traceEvents"])
        assert json.loads(open(f"{inc['bundle']}/metrics.json").read())["kind"] == (
            "obs_metrics_snapshot")
        assert json.loads(open(f"{inc['bundle']}/incident.json").read())["rule"] == inc["rule"]
    assert reg.counter("watchdog_incidents_total").value(rule="ttfr_p99") == 1
    with pytest.raises(ValueError):
        obs.WatchRule("bad", probe, 1.0, agg="median")
    with obs.Watchdog([], incident_dir=str(tmp_path / "inc2"), registry=reg,
                      interval_s=0.01) as live:
        time.sleep(0.05)
    assert live._thread is None
