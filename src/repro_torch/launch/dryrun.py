"""Production-mesh dry-run: trace every (arch x shape x mesh) cell's step
on fake tensors over a fake process group and record its per-device
memory, cost and collectives; the PyTorch port of the reference's
launch/dryrun.py.

    PYTHONPATH=src python -m repro_torch.launch.dryrun               # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi_pod --force

A cell runs on rank 0 of a "fake" process group of 256 (single_pod) or
512 (multi_pod) ranks under FakeTensorMode: the step is the one
launch/steps.py builds, its arguments are DTensors whose local shards
are fake, so nothing is allocated and no card is touched, and the
collectives DTensor issues are recorded, not run. The counts are
launch/cost_analysis.py's. Results go to experiments/dryrun_torch/<arch>
__<shape>__<mesh>.json; present cells are skipped unless --force, and a
failing cell writes FAIL__<arch>__<shape>__<mesh>.json. The fake group
is destroyed after its cells.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --store-cells

runs only the two llcysa-store cells (run_store_cell): one rank's
tablet scan step of the store on the production mesh, every rank a
tablet server, written to llcysa-store__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import time
import traceback
from pathlib import Path

from ..configs.base import SHAPES
from ..models import get_config, list_archs

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
MESH_RANKS = {"single_pod": 256, "multi_pod": 512}


def assigned_archs():
    """The reference's assigned architectures: every registered one but
    llcysa-analytics-100m, the analytics LM."""
    return [a for a in list_archs() if a != "llcysa-analytics-100m"]


def plan_cells(arch_filter=None, shape_filter=None, mesh_filter=None):
    """The 40 assigned cells x 2 meshes, minus the documented skips
    (long_500k for the full-attention archs)."""
    cells = []
    for arch in assigned_archs():
        cfg = get_config(arch)
        for sname in SHAPES:
            if sname == "long_500k" and not cfg.sub_quadratic:
                continue
            for mesh_kind in ("single_pod", "multi_pod"):
                if arch_filter and arch != arch_filter:
                    continue
                if shape_filter and sname != shape_filter:
                    continue
                if mesh_filter and mesh_kind != mesh_filter:
                    continue
                cells.append((arch, sname, mesh_kind))
    return cells


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks (this process is rank
    0), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def spec_param_bytes(shapes, specs, mesh) -> int:
    """Bytes of one device's parameter shards, from the spec tree."""
    from ..distributed.sharding import local_shape, spec_map
    from ..tree import tree_leaves

    sizes = spec_map(lambda s, x: math.prod(local_shape(x.shape, s, mesh))
                     * x.dtype.itemsize, specs, shapes)
    return int(sum(tree_leaves(sizes)))


def model_flops(cfg, shape) -> float:
    """Useful FLOPs of the step: 6 N D to train, 2 N per token otherwise
    (N the active parameters)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def run_cell_on(cfg, shape, mesh, opts=None, cell=None) -> dict:
    """Trace one step of ``cfg`` at ``shape`` on ``mesh`` (of the current,
    fake, process group) and return its record."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..distributed.sharding import shard_tree_empty
    from ..launch import cost_analysis
    from ..launch.steps import build_step

    opts = dict(opts or {})
    if shape.kind == "train":
        # Megatron-style sequence parallelism, as the reference's train cells.
        opts.setdefault("seq_parallel", True)
    n_dev = mesh.size()
    t0 = time.perf_counter()
    built = build_step(cfg, shape, mesh, **opts)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = tuple(shard_tree_empty(x, s, mesh)
                     for x, s in zip(built.abstract_args, built.in_shardings))
        with torch.no_grad() if shape.kind != "train" else contextlib.nullcontext():
            rec = cost_analysis.measure(built.fn, *args)
    t_trace = time.perf_counter() - t0
    rec.pop("out")
    param_bytes = cost_analysis.local_bytes(args[0])
    spec_bytes = spec_param_bytes(built.abstract_args[0], built.in_shardings[0], mesh)
    flops = rec["cost"]["flops_per_device"]
    terms = cost_analysis.roofline_terms(flops, rec["cost"]["bytes_per_device"],
                                         rec["collectives"]["total_bytes"])
    terms["memory_lower_s"] = rec["cost"]["bytes_lower_per_device"] / cost_analysis.HBM_BW
    terms["memory_s_is"] = ("an upper bound: every local op's bytes in and out, views "
                            "skipped, no fusion; memory_lower_s reads the arguments once")
    useful = model_flops(cfg, shape) / n_dev
    arch, sname, mesh_kind = cell or (cfg.name, shape.name, "x".join(map(str, mesh.shape)))
    del args, built
    gc.collect()
    return {
        "arch": arch, "shape": sname, "mesh": mesh_kind, "n_chips": int(n_dev),
        "mesh_shape": dict(zip(mesh.mesh_dim_names, map(int, mesh.shape))),
        "kind": shape.kind, "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "params": int(cfg.param_count()), "active_params": int(cfg.active_param_count()),
        "build_s": round(t_build, 2), "trace_s": round(t_trace, 2), "torch": torch.__version__,
        **rec,
        "param_bytes_per_device": param_bytes,
        "param_bytes_from_specs": spec_bytes,
        "roofline": terms,
        "model_flops_per_device": useful,
        "useful_flop_ratio": (useful / flops) if flops else None,
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, opts=None) -> dict:
    """One production cell; needs a fake process group of the mesh's ranks
    (``fake_world``)."""
    from ..launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi_pod"), device_type="cpu")
    return run_cell_on(get_config(arch), SHAPES[shape_name], mesh, opts,
                       cell=(arch, shape_name, mesh_kind))


# How a store cell counts the filter_scan kernel, recorded in the cell.
FILTER_CHARGE_RULE = (
    "filter_scan is a ctypes launch a fake trace cannot enter: the trace runs a shape-only "
    "stub in its place and charges the bytes the launch reads and writes, rows x (4 F + 1) "
    "(the int32 codes in, one bool a row out), with 0 FLOPs")


@contextlib.contextmanager
def _filter_charged():
    """Inside, core/dist_query's filter call is a stub: empty bool masks of
    the right shapes, uncounted, with each launch charged by
    FILTER_CHARGE_RULE."""
    import torch

    from ..core import dist_query
    from ..launch import cost_analysis

    real = dist_query.filter_scan_levels

    def stub(levels, program):
        out = []
        for cols in levels:
            rows = cols.numel() // cols.shape[-1]
            cost_analysis.charge("filter_scan", rows * (cols.element_size() * cols.shape[-1] + 1))
            with cost_analysis.unseen():
                out.append(torch.empty(cols.shape[:-1], dtype=torch.bool, device=cols.device))
        return out

    dist_query.filter_scan_levels = stub
    try:
        yield
    finally:
        dist_query.filter_scan_levels = real


def run_store_cell(mesh_kind: str, rows_per_tablet: int = 4_000_000) -> dict:
    """The paper's own system on the production mesh: one rank's tablet scan
    step (filter, count, top-k; the count all-reduced and the slates
    all-gathered) over a base of ``rows_per_tablet`` rows of the web-proxy
    schema, every rank a tablet server (4M rows x 12 fields a tablet is
    about 1B rows, 200 GB, on one pod). Traced on fake tensors; needs a
    fake process group of the mesh's ranks (``fake_world``)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..core import And, Eq, EventStore, Not, web_proxy_schema
    from ..core.dist_query import DistStore, dist_store_shapes, scan_step, tablet_specs
    from ..core.filter import compile_tree
    from ..distributed.sharding import local_shape
    from ..kernels.filter_scan import program_tensors
    from ..launch import cost_analysis
    from ..launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi_pod"), device_type="cpu")
    n_chips = mesh.size()
    store = EventStore(web_proxy_schema(), n_shards=4, device="cpu")  # schema carrier
    store.ingest([0, 1], {"domain": ["a.com", "b.com"], "method": ["GET", "POST"],
                          "status": ["200", "404"]})
    program = program_tensors(compile_tree(store, And(Eq("domain", "a.com"),
                                                      Not(Eq("status", "404")))),
                              torch.device("cpu"))
    shapes = dist_store_shapes(mesh, rows_per_tablet, store.schema.n_fields)
    specs = tablet_specs(mesh)
    rank = torch.distributed.get_rank()

    def step(rev_ts, cols, counts):
        tl = rev_ts.shape[0]
        d = DistStore(rev_ts=rev_ts, cols=cols, counts=counts, mesh=mesh,
                      tablets=(rank * tl, (rank + 1) * tl))
        return scan_step(d, program, 0, int(torch.iinfo(torch.int32).max))

    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True), _filter_charged():
        args = [torch.empty(local_shape(shapes[k].shape, specs[k], mesh), dtype=shapes[k].dtype)
                for k in ("rev_ts", "cols", "counts")]
        rec = cost_analysis.measure(step, *args)
    t_trace = time.perf_counter() - t0
    rec.pop("out")
    cost = rec["cost"]
    terms = cost_analysis.roofline_terms(cost["flops_per_device"], cost["bytes_per_device"],
                                         rec["collectives"]["total_bytes"])
    terms["memory_lower_s"] = cost["bytes_lower_per_device"] / cost_analysis.HBM_BW
    return {
        "arch": "llcysa-store", "shape": f"scan_{rows_per_tablet * n_chips // 10**6}M_rows",
        "mesh": mesh_kind, "n_chips": int(n_chips),
        "mesh_shape": dict(zip(mesh.mesh_dim_names, map(int, mesh.shape))),
        "kind": "scan", "rows_per_tablet": rows_per_tablet, "trace_s": round(t_trace, 2),
        "torch": torch.__version__, **rec, "roofline": terms,
        "filter_scan_charge": {**cost["charged_by_op"].get("filter_scan", {}),
                               "rule": FILTER_CHARGE_RULE},
    }


def summary(rec: dict) -> str:
    r = rec["roofline"]
    return (f"{rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:10s} "
            f"trace={rec['trace_s']:7.1f}s peak={rec['memory']['peak_bytes'] / 2**30:7.2f}GiB "
            f"flops={rec['cost']['flops_per_device']:.3e} "
            f"bytes={rec['cost']['bytes_per_device']:.3e} "
            f"coll={rec['collectives']['total_bytes']:.3e} "
            f"comp={r['compute_s']:.2e}s mem={r['memory_s']:.2e}s "
            f"coll={r['collective_s']:.2e}s bound={r['bottleneck']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "single_pod", "multi_pod"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--store-cells", action="store_true",
                    help="run only the two llcysa-store cells")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.store_cells:
        for mesh_kind in ("single_pod", "multi_pod"):
            with fake_world(MESH_RANKS[mesh_kind]):
                rec = run_store_cell(mesh_kind)
            (out_dir / f"llcysa-store__{rec['shape']}__{mesh_kind}.json").write_text(
                json.dumps(rec, indent=1))
            r = rec["roofline"]
            print(f"OK  llcysa-store {rec['shape']} {mesh_kind} trace={rec['trace_s']:.1f}s "
                  f"peak={rec['memory']['peak_bytes'] / 2**30:.2f}GiB "
                  f"comp={r['compute_s']:.2e}s mem={r['memory_s']:.2e}s "
                  f"coll={r['collective_s']:.2e}s", flush=True)
        return
    cells = plan_cells(args.arch, args.shape, args.mesh)
    print(f"dry-run: {len(cells)} cells on fake process groups", flush=True)
    n_ok = n_skip = n_fail = 0
    for mesh_kind in ("single_pod", "multi_pod"):
        todo = []
        for arch, sname, mk in cells:
            if mk != mesh_kind:
                continue
            if (out_dir / f"{arch}__{sname}__{mk}.json").exists() and not args.force:
                n_skip += 1
            else:
                todo.append((arch, sname))
        if not todo:
            continue
        with fake_world(MESH_RANKS[mesh_kind]):
            for arch, sname in todo:
                name = f"{arch}__{sname}__{mesh_kind}"
                fail = out_dir / f"FAIL__{name}.json"
                try:
                    rec = run_cell(arch, sname, mesh_kind)
                    (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=1))
                    if fail.exists():
                        fail.unlink()
                    print("OK  " + summary(rec), flush=True)
                    n_ok += 1
                except Exception as e:  # noqa: BLE001 — a failing cell is a fault; record it
                    n_fail += 1
                    fail.write_text(json.dumps({
                        "arch": arch, "shape": sname, "mesh": mesh_kind, "error": repr(e),
                        "traceback": traceback.format_exc()}, indent=1))
                    print(f"FAIL {arch} {sname} {mesh_kind}: {e!r}", flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} failed={n_fail}", flush=True)


if __name__ == "__main__":
    main()
