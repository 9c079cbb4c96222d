"""Run one cell of the benchmark of the PyTorch port and judge it.

A cell (an entry of ``workloads`` in BENCHMARK.json) names a
configuration, whose file of sizes the manifest gives, and a traffic mix,
``bench/traffic/<mix>.json``: a data file whose ``loop`` key names the
client loop that reads it, ``bench/loops/<loop>.py``. Each metric the
manifest lists is read by ``bench/metrics/<name>.py`` (or, for
``<base>.<qualifier>``, by ``<base>.py``). Nothing here names a cell, a
mix, a loop or a metric: a later change adds files and manifest
entries.

A loop's ``run(ctx)`` makes the events from the seed, sets the program
up, warms up the shapes its traffic uses, measures for the window's
seconds, then checks what the timed path produced against the plain
reference (``bench/reference.py``) and returns an ``Outcome``; the
harness reads the metrics from it and builds the result line.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from . import clients, tracing

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


# -------------------------------------------------------------- manifest
@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of root's BENCHMARK.json, with its files read."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in manifest["end_to_end"] if _listed(m, name)],
                [m for m in manifest["per_layer"] if _listed(m, name)])


def _load(path: Path, prefix: str):
    name = f"{prefix}_{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(run)`` of bench/metrics/<name>.py, or of <base>.py for a
    name <base>.<qualifier> that has no file of its own."""
    d = root / "bench" / "metrics"
    path = d / f"{name}.py"
    if not path.exists():
        path = d / f"{name.split('.')[0]}.py"
    return _load(path, "bench_metric").read


def loop(name: str, root: Path = ROOT):
    """The module bench/loops/<name>.py: its ``run(ctx)`` runs a cell."""
    return _load(root / "bench" / "loops" / f"{name}.py", "bench_loop")


def port_kernel_names(root: Path = ROOT) -> List[str]:
    """The port's own CUDA kernels: every __global__ function of its
    csrc sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
    names = set()
    for src in sorted((root / "src" / "repro_torch" / "kernels" / "csrc").glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return sorted(names)


# ------------------------------------------------------------ run record
@dataclass
class Run:
    """What a run measured, for the metric readers. A loop's own Run
    adds what its metrics read."""

    window: clients.Window
    setup_s: float
    trace: Optional[tracing.DeviceTrace] = None
    kernel_names: List[str] = field(default_factory=list)
    # Bytes the published store holds per row it stores (readback.store_bytes).
    store_bytes_per_row: Optional[float] = None

    @property
    def seconds(self) -> float:
        return self.window.seconds

    def port_kernel_s(self) -> Optional[float]:
        """Device seconds in the port's own CUDA kernels over the trace."""
        if self.trace is None or not self.trace.busy_s:
            return None
        pats = [re.compile(rf"\b{re.escape(n)}\b") for n in self.kernel_names]
        return sum(s for name, s in self.trace.kernel_s.items()
                   if any(p.search(name) for p in pats))


@dataclass
class Outcome:
    """A client loop's run: the record, the numbers compared (limit 0 each),
    the requests attempted and failed, and the device's peak bytes."""

    run: Run
    checks: Dict[str, int]
    attempted: int
    failed: int
    peak: int


@dataclass
class Context:
    """What a client loop's run gets: the cell (its traffic scaled), the
    configuration, the run's arguments, the instruments and the phase
    clock; ``answers_hook`` is the tests' way to break what the reference
    judges."""

    cell: Cell
    cfg: dict
    seed: int
    seconds: float
    device: object
    t_start: float
    spans: tracing.Spans
    window: tracing.DeviceWindow
    phase: "Phases"
    answers_hook: Optional[Callable] = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def settle(self) -> None:
        """Before the window: collect the set-up's garbage and freeze what
        is left out of the collector's scans, so that a collection in the
        window walks only the window's own objects."""
        import gc

        gc.collect()
        gc.freeze()

    def peak_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        import torch

        return int(torch.cuda.max_memory_allocated(self.device))


class Phases(dict):
    """Seconds by phase of a run (set-up, reading the trace, judging), for the log."""

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self[name] = time.perf_counter() - t0


# ----------------------------------------------------------------- runs
def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             scale: Optional[dict] = None, answers_hook: Optional[Callable] = None,
             root: Path = ROOT, phases: Optional[Phases] = None) -> dict:
    """One run of a cell: returns the result line's object. ``scale``
    overrides configuration keys, and under "traffic" keys of the traffic
    file (the CPU tests' small sizes); ``answers_hook``, when the loop
    takes one, lets a test break what the reference judges; ``phases`` (a
    Phases) takes the seconds of the run's phases."""
    scale = dict(scale or {})
    traffic = dict(cell.traffic, **scale.pop("traffic", {}))
    cell = Cell(cell.name, cell.chips, cell.config, traffic, cell.end_to_end, cell.per_layer)
    cfg = dict(cell.config, **scale)
    ctx = Context(cell, cfg, seed, seconds, device, t_start, tracing.Spans(trace),
                  tracing.DeviceWindow(device, trace), Phases() if phases is None else phases,
                  answers_hook)
    got = loop(traffic["loop"], root).run(ctx)
    got.run.kernel_names = port_kernel_names(root)
    listed = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in listed:
        v = metric_reader(m["name"], root)(got.run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": _device_name(device), "count": cell.chips, "memory_peak_bytes": got.peak}
    out = {"correct": all(v == 0 for v in got.checks.values()), "attempted": int(got.attempted),
           "failed": int(got.failed), "metrics": metrics, "device": dev}
    tr = got.run.trace
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tracing.top(tr.kernel_s),
                            "idle_gaps": tracing.top(tr.idle_by_host)}
    out["checks"] = {k: {"value": int(v), "limit": 0} for k, v in got.checks.items()}
    return out


def _device_name(device) -> str:
    if device.type == "cuda":
        import torch

        return torch.cuda.get_device_name(device)
    import platform

    return platform.processor() or "cpu"


def forbidden_loaded() -> List[str]:
    """Top-level names of JAX, Flax or the JAX package in sys.modules."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))
