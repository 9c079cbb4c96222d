"""Repeated time to first result (TTFR) of the scan schemes on one
full-size plane, for comparing two trees of the port on one card.

    python3 scripts/ttfr_repeat.py [--root DIR] [--reps N] [--seed N]

Imports ``repro_torch`` and ``chip_smoke`` from DIR (default: this
checkout), so a second tree unpacked beside this one is measured by the
same code. It fills the plane of ``chip_smoke.py``'s path 1 (64 tablets x
131,072 rows, the same 4,194,304 synthetic events of the seed) through one
``DistBatchWriter``, drains it, then with the garbage collector off runs
tiers A, B, C and "A and 404" through ``scan`` and ``batched_scan``, N
rounds with the queries interleaved, and times ``plane.publish()`` on the
drained plane N times. The last line of its output is one JSON object:
per query and scheme, the 25th, 50th, 75th and 90th percentile and the
mean of TTFR in ms and every round's TTFR, and the same statistics for
a publish. Needs a CUDA card; exits 2 without one.
"""
import argparse
import gc
import json
import os
import sys
import time

DEVICE = "cuda"


def percentiles(xs):
    xs = sorted(xs)
    out = {p: xs[min(len(xs) - 1, round(p / 100 * (len(xs) - 1)))] * 1e3 for p in (25, 50, 75, 90)}
    out["mean"] = sum(xs) / len(xs) * 1e3
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "src")]

    import torch

    if not torch.cuda.is_available():
        print("ttfr_repeat: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.dist_ingest import DistBatchWriter, DistIngestPlane
    from repro_torch.core.dist_query import DistQueryProcessor
    from repro_torch.core.filter import And, Eq
    from repro_torch.core.schema import web_proxy_schema
    from repro_torch.core.store import EventStore
    from repro_torch.pipeline.sources import SyntheticWebProxySource, parse_web_proxy_lines

    dev = torch.device(DEVICE)
    size = cs.MAIN_PATH
    source = SyntheticWebProxySource(seed=args.seed)
    store = EventStore(web_proxy_schema())
    plane = DistIngestPlane.for_store(
        store, capacity=size["capacity"], n_tablets=size["tablets"], mem_rows=size["mem_rows"],
        max_runs=size["max_runs"], append_rows=1024, device=dev)
    writer = DistBatchWriter(store, plane, batch_rows=size["chunk"], writer_id=0)
    domain_counts = {}
    for off in range(0, size["events"], size["chunk"]):
        n = min(size["chunk"], size["events"] - off)
        ts, vals = parse_web_proxy_lines(source.gen_lines(n, 0, cs.T_SPAN))
        for d in vals["domain"]:
            domain_counts[d] = domain_counts.get(d, 0) + 1
        writer.add(ts, vals)
    writer.close()
    while plane.has_unfolded():
        plane.compact_step()
    torch.cuda.synchronize(dev)

    tiers = cs.pick_tiers(source, domain_counts)
    trees = {tier: Eq("domain", dom) for tier, dom in tiers.items()}
    trees["A and 404"] = And(Eq("domain", tiers["A"]), Eq("status", "404"))
    dq = DistQueryProcessor(store, plane, device=dev)
    schemes = ("scan", "batched_scan")
    for label, tree in trees.items():  # warm-up: every kernel built and loaded
        for scheme in schemes:
            rows = sum(b.count for b in dq.run_scheme(scheme, 0, cs.T_SPAN, tree))
            if label in tiers and rows != domain_counts[tiers[label]]:
                raise SystemExit(f"{label} {scheme}: {rows} rows, want "
                                 f"{domain_counts[tiers[label]]}")
    ttfr = {(label, scheme): [] for label in trees for scheme in schemes}
    publish = []
    gc.collect()
    gc.disable()
    try:
        for _ in range(args.reps):
            for label, tree in trees.items():
                for scheme in schemes:
                    t0 = time.perf_counter()
                    it = dq.run_scheme(scheme, 0, cs.T_SPAN, tree)
                    next(it, None)
                    ttfr[(label, scheme)].append(time.perf_counter() - t0)
                    for _blk in it:
                        pass
            t0 = time.perf_counter()
            plane.publish()
            publish.append(time.perf_counter() - t0)
    finally:
        gc.enable()
    out = {"root": root, "reps": args.reps, "nvidia_smi": cs.nvidia_smi_line(),
           "publish_ms": percentiles(publish),
           "ttfr_ms": {f"{label} {scheme}": percentiles(v) for (label, scheme), v in ttfr.items()},
           "rounds_ms": {f"{label} {scheme}": [x * 1e3 for x in v]
                         for (label, scheme), v in ttfr.items()}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
