"""Path 4's threaded ingest and path 5's serve traffic on one full-size
plane, for comparing two trees of the port on one card.

    python3 scripts/ab_plane.py [--root DIR] [--reps N] [--seed N] [--device cuda|cpu]
                                [--events N --tablets N --capacity N]

Imports ``repro_torch`` from DIR (default: this checkout) and the harness,
``chip_smoke.py``'s helpers, from this checkout, so a second tree unpacked
beside this one is measured by the same code. It encodes the main path's
4,194,304 synthetic events of the seed on the host and cuts them into path
4's four writer streams. Then, N times, it appends them into a fresh plane
of 64 tablets x 131,072 rows in G = 4 groups from one thread and from four
threads (thread start to last join plus a synchronize), each drained with
compact_step. On the last drained four-thread plane a QueryService with
path 5's four sessions runs path 5a's mix N times, every count checked
against the generated events, and then path 5b once: two writers, paced by
the sessions' submits, append path 5's 524,288 new events while the
sessions run the mix SERVE_ROUNDS times. The last line of its output is
one JSON object: the card, rows/s of every ingest run with its group
locks' held and wait seconds, and per serve phase queries/s, TTFR p50/p99
per scheme and, for 5b, the writers' rows/s. ``--events``, ``--tablets``
and ``--capacity`` shrink the store for a run on the CPU. Without the
device it asks for, it exits 2.
"""
import argparse
import gc
import json
import os
import sys
import time
from collections import Counter

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ingest_run(cs, store, streams, size, dev, threaded):
    """One fresh G = 4 plane filled from the writer streams; returns the
    run's numbers and the drained plane."""
    import torch
    from repro_torch.core.dist_ingest import DistIngestPlane

    plane = DistIngestPlane.for_store(
        store, capacity=size["capacity"], n_tablets=size["tablets"], mem_rows=size["mem_rows"],
        max_runs=size["max_runs"], append_rows=1024, n_groups=4, device=dev)
    t0 = time.perf_counter()
    (cs.threaded_ingest if threaded else cs.serial_ingest)(plane, streams)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    tel = plane.telemetry()
    cs.check(int(tel["rows"].sum()) == size["events"], f"{tel['rows'].sum()} rows appended")
    cs.check(int(tel["overflow"].sum()) == 0, "tablet overflow")
    locks = [g.lock.snapshot() for g in plane.groups]
    while plane.has_unfolded():
        plane.compact_step()
    return {"threads": len(streams) if threaded else 1, "seconds": secs,
            "rows_per_s": size["events"] / secs,
            "locks_held_s": [lk["total_held_s"] for lk in locks],
            "locks_wait_s": [lk["total_wait_s"] for lk in locks]}, plane


def serve_stats(cs, recs, secs, gcs):
    st = cs.phase_stats(recs, secs, gcs)
    return {"queries": st["queries"], "seconds": secs, "queries_per_s": st["queries_per_s"],
            "ttfr_p50_p99_ms": {k: [v["p50_ms"], v["p99_ms"]] for k, v in st["ttfr"].items()},
            "queue_wait_s": st["queue_wait_s"],
            "device_step_s": st["first_result_stages_s"]["device_step"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--events", type=int, default=None)
    ap.add_argument("--tablets", type=int, default=None)
    ap.add_argument("--capacity", type=int, default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src"), HERE]

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("ab_plane: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch
    from repro_torch.core.schema import web_proxy_schema
    from repro_torch.core.store import EventStore
    from repro_torch.pipeline.sources import SyntheticWebProxySource, parse_web_proxy_lines
    from repro_torch.serve_db import QueryService

    cs.check(os.path.abspath(repro_torch.__file__).startswith(root + os.sep),
             f"repro_torch imported from {repro_torch.__file__}, not {root}")
    dev = torch.device(args.device)
    size = dict(cs.MAIN_PATH)
    for k in ("events", "tablets", "capacity"):
        if getattr(args, k) is not None:
            size[k] = getattr(args, k)
    size["chunk"] = min(size["chunk"], size["events"] // 8)

    source = SyntheticWebProxySource(seed=args.seed)
    store = EventStore(web_proxy_schema(), device=dev)
    encoded, domain_counts, pair_counts = [], Counter(), Counter()
    for off in range(0, size["events"], size["chunk"]):
        n = min(size["chunk"], size["events"] - off)
        ts, vals = parse_web_proxy_lines(source.gen_lines(n, 0, cs.T_SPAN))
        domain_counts.update(vals["domain"])
        pair_counts.update(zip(vals["domain"], vals["status"]))
        encoded.append((ts, store.encode_events(ts, vals)))
    streams = cs.writer_streams(encoded, size["tablets"], size["chunk"], 4)
    del encoded
    new_events = cs.serve_events(args.seed, size)
    tiers = cs.pick_tiers(source, domain_counts)

    ingest = {"G=4, 1 thread": [], "G=4, 4 threads": []}
    plane = None
    for _ in range(args.reps):
        for label, threaded in (("G=4, 1 thread", False), ("G=4, 4 threads", True)):
            del plane
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            run, plane = ingest_run(cs, store, streams, size, dev, threaded)
            ingest[label].append(run)
            cs.log("ab", f"{label}: {run['rows_per_s']:.1f} rows/s")

    spec_a = cs.agg_specs()["a count/status/hour"]
    base = cs.serve_counts(tiers, domain_counts, pair_counts)
    mix = cs.serve_mix(tiers)
    n = cs.SERVE_SESSIONS
    serve = {"5a": []}
    svc = QueryService(store, plane)
    try:
        with cs.GcPauses() as gcs:
            for rep in range(args.reps):
                mixes = [cs.rotated(mix, i, n) for i in range(n)]
                recs, secs, _ = cs.run_sessions(svc, mixes, f"5a-{rep}", spec_a)
                for r in recs:
                    cs.check(r["count"] == base[r["label"]],
                             f"5a {r['scheme']} {r['label']}: {r['count']} rows, want "
                             f"{base[r['label']]}")
                serve["5a"].append(serve_stats(cs, recs, secs, gcs))
                cs.log("ab", f"5a: {serve['5a'][-1]['queries_per_s']:.2f} queries/s")
            chunks, n_new, chunk = new_events
            mixes = [cs.rotated(mix, i, n) * cs.SERVE_ROUNDS for i in range(n)]
            recs, secs, _, wr = cs.serve_under_ingest(svc, store, plane, chunks, chunk, mixes,
                                                      "5b", spec_a, 10)
            serve["5b"] = serve_stats(cs, recs, secs, gcs)
            serve["5b"].update(ingest_rows_per_s=n_new / wr["ingest_s"],
                               append_s=wr["append_s"])
            cs.log("ab", f"5b: {serve['5b']['queries_per_s']:.2f} queries/s, "
                   f"{serve['5b']['ingest_rows_per_s']:.1f} rows/s appended")
    finally:
        svc.close()
    smi = cs.nvidia_smi_line() if dev.type == "cuda" else "cpu"
    print(json.dumps({"root": root, "reps": args.reps, "nvidia_smi": smi, "size": size,
                      "ingest": ingest, "serve": serve}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
