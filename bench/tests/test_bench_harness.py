"""The harness on the CPU at small sizes: every cell resolves to its
files and runs; the result line has only its documented keys; a
configuration, a mix, a metric and a client loop added as files are found with
no edit; nothing under bench/ loads JAX or the JAX package."""
import ast
import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from bench import harness, readback
from bench.tests.conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_and_runs_for_a_second(name, tiny):
    cell = harness.resolve(name)
    w = next(w for w in MANIFEST["workloads"] if w["name"] == name)
    conf = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])
    assert (ROOT / conf["file"]).exists()
    assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()
    assert (ROOT / "bench" / "loops" / f"{cell.traffic['loop']}.py").exists()
    for m in cell.end_to_end + cell.per_layer:
        harness.metric_reader(m["name"])  # a file reads it
    out = harness.run_cell(cell, 2**31 + 3, 1.0, False, torch.device("cpu"),
                           time.perf_counter(), scale=tiny)
    assert list(out) == LINE_KEYS  # the checks last
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_counters(name, tiny):
    cell = harness.resolve(name)
    out = harness.run_cell(cell, 7, 1.0, True, torch.device("cpu"), time.perf_counter(),
                           scale=tiny)
    assert out["correct"] is True
    # On the CPU the profiler's device metrics read nothing and are left out.
    device_metrics = {m["name"] for m in cell.per_layer if m["source"] == "device_trace"}
    want = {m["name"] for m in cell.per_layer} - device_metrics
    assert set(out["metrics"]) == want
    assert "busy_s" not in out["device"] and "breakdown" not in out


def test_store_bytes_counts_each_storage_once():
    """A level that views a slab counts the slab's whole storage, and a
    storage that two levels or two groups share counts once."""
    slab = torch.zeros(4, 8, dtype=torch.int64)  # 256 bytes
    cols = torch.zeros(4, 8, 3, dtype=torch.int32)  # 384 bytes
    n = torch.zeros(4, dtype=torch.int32)  # 16 bytes
    sub = types.SimpleNamespace(
        groups=None, ev_levels=lambda: ((slab[:, :2], cols, n),),
        ix_levels=lambda: ((slab, n),), ag_levels=lambda: ((slab[1:], cols[:, :4], n),))
    assert readback.store_bytes(sub) == 256 + 384 + 16
    other = types.SimpleNamespace(groups=None, ev_levels=lambda: ((torch.zeros(5),),),
                                  ix_levels=lambda: (), ag_levels=lambda: ())
    assert readback.store_bytes(types.SimpleNamespace(groups=(sub, other, sub))) == 656 + 20


def _copy(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_added_config_mix_and_metric_are_found_without_an_edit(tmp_path, tiny):
    """A configuration, a mix of the analysts' loop that uses every kind
    of request it knows (the aggregates, densities, In sets, And and Or
    the later aggregates cell asks for) and a per-layer metric, as files."""
    manifest = _copy(tmp_path)
    cfg = json.loads((ROOT / "bench/configs/webproxy-8ts.json").read_text())
    cfg.update(name="webproxy-2ts", n_groups=2)
    (tmp_path / "bench/configs/webproxy-2ts.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "bench/traffic/analysts.json").read_text())
    mix.update(set_fields=["bytes_in"], set_size=300000, mix=[
        {"share": 2, "kind": "query", "schemes": ["index", "batched_index"], "label": "and404",
         "filter": {"and": [{"eq": ["domain", "$d1"]}, {"eq": ["status", "404"]}]}},
        {"share": 1, "kind": "query", "schemes": ["index"], "label": "or",
         "filter": {"or": [{"eq": ["domain", "$d1"]}, {"eq": ["domain", "$d2"]}]}},
        {"share": 1, "kind": "query", "schemes": ["scan"], "label": "in",
         "filter": {"and": [{"eq": ["domain", "$B"]}, {"in": ["bytes_in", "$set"]}]}},
        {"share": 2, "kind": "aggregate", "label": "a", "filter": {"eq": ["domain", "$d1"]},
         "spec": {"group_by": ["status"], "op": "count", "time_bucket_s": 3600}},
        {"share": 2, "kind": "aggregate", "label": "b", "filter": {"eq": ["domain", "$A"]},
         "spec": {"group_by": ["method"], "op": "sum", "value_field": "bytes_in",
                  "time_bucket_s": 3600}},
        {"share": 2, "kind": "aggregate", "label": "c", "filter": {"eq": ["domain", "$d1"]},
         "spec": {"group_by": ["status"], "op": "max", "value_field": "bytes_out"}},
        {"share": 2, "kind": "density", "label": "density", "field": "domain", "value": "$d1"}])
    (tmp_path / "bench/traffic/aggregates.json").write_text(json.dumps(mix))
    (tmp_path / "bench/metrics/requests_answered.py").write_text(
        "def read(run):\n    return float(len(run.first_results()))\n")
    manifest["configs"].append({"name": "webproxy-2ts", "source": "test", "reduced": ["events"],
                                "file": "bench/configs/webproxy-2ts.json", "why": "test"})
    manifest["workloads"].append({"name": "webproxy-2ts.aggregates", "config": "webproxy-2ts",
                                  "traffic": "aggregates", "chips": 1, "why": "test"})
    manifest["per_layer"].append({"name": "requests_answered", "unit": "requests",
                                  "better": "higher", "source": "program_counter",
                                  "layer": "test", "moves": "store_bytes_per_row",
                                  "workloads": ["webproxy-2ts.aggregates"]})
    for m in manifest["end_to_end"]:
        if m["name"] == "store_bytes_per_row":
            m["workloads"].append("webproxy-2ts.aggregates")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.resolve("webproxy-2ts.aggregates", root=tmp_path)
    assert cell.config["n_groups"] == 2 and cell.traffic["set_size"] == 300000
    out = harness.run_cell(cell, 1, 1.0, True, torch.device("cpu"), time.perf_counter(),
                           scale=tiny, root=tmp_path)
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["requests_answered"]["value"] >= 1
    out = harness.run_cell(cell, 1, 1.0, False, torch.device("cpu"), time.perf_counter(),
                           scale=tiny, root=tmp_path)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"setup_s", "store_bytes_per_row"}


LOOP = """
import time

from bench import clients, gen, readback
from bench.harness import Outcome, Run


def run(ctx):
    ev = gen.make_events(ctx.seed, ctx.cfg["events"], ctx.cfg["span_s"])
    plane = clients.make_plane(ctx.cfg, ctx.device)
    t0 = time.perf_counter()
    clients.preload(plane, ev, ctx.cfg, int(ctx.cell.traffic["chunk_rows"]), ctx.spans)
    window = clients.Window(t0, time.perf_counter())
    stored = readback.plane_contents(plane.publish())["ev_rows"].shape[0]
    return Outcome(Run(window, t0 - ctx.t_start), {"rows_off": abs(stored - ev.n)}, 1, 0, 0)
"""


def test_added_loop_is_found_without_an_edit(tmp_path, tiny):
    """A new kind of traffic: a client loop and the mix that names it, as files."""
    manifest = _copy(tmp_path)
    (tmp_path / "bench/loops/one_load.py").write_text(LOOP)
    (tmp_path / "bench/traffic/one_load.json").write_text(json.dumps(
        {"loop": "one_load", "chunk_rows": 65536}))
    manifest["workloads"].append({"name": "webproxy-1ts.one_load", "config": "webproxy-1ts",
                                  "traffic": "one_load", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.resolve("webproxy-1ts.one_load", root=tmp_path)
    tiny["traffic"] = {"chunk_rows": 4096}
    out = harness.run_cell(cell, 1, 1.0, False, torch.device("cpu"), time.perf_counter(),
                           scale=tiny, root=tmp_path)
    assert out["correct"] is True and out["checks"] == {"rows_off": {"value": 0, "limit": 0}}
    assert set(out["metrics"]) == {"setup_s"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_nothing_under_bench_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "bench").rglob("*.py"))
    assert files
    for path in files:
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "repro"}, path
    assert "repro_torch" not in set(_imports(ROOT / "bench" / "reference.py"))
    assert not any("benchmarks/" in p.read_text() or "benchmarks." in p.read_text()
                   for p in files if p.name != "test_bench_harness.py")


def test_forbidden_modules_are_named(monkeypatch):
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert harness.forbidden_loaded() == ["jax", "repro"]


def test_command_refuses_without_the_cards(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ, PYTHONPATH="")
    for root in (ROOT, tmp_path):
        if root == tmp_path:  # only BENCHMARK.json and the benchmark's files
            shutil.copytree(ROOT / "bench", tmp_path / "bench",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        p = subprocess.run([sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
                            "1", "--seconds", "1", "--trace", "0"], cwd=root, env=env,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout.strip() == ""
