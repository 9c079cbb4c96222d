"""`python -m repro_torch.serve_db` — a long-running serve daemon on one
card; the port of the reference's `python -m repro.serve_db`.

    python -m repro_torch.serve_db [--device cuda|cpu] [--duration S] ...
    torchrun --nproc-per-node N -m repro_torch.serve_db --mesh dev ...

It runs the serve plane as a *deployment*: background writers feeding a
sharded DistIngestPlane (``--groups`` tablet groups of
``--tablets-per-device`` tablets in all, on ``--device``), N client
sessions streaming queries through the fair scheduler, a Prometheus pull
endpoint (`/metrics`, on 127.0.0.1), the flight recorder armed, and the
SLO watchdog holding the paper's latency objective — on breach it drops
an incident bundle (flight-recorder trace + metrics snapshot) into the
incident directory. ``--device`` defaults to cuda and raises when CUDA
is missing; ``--device cpu`` runs the kernels' plain versions.

``--mesh dev`` serves on a (1, R) DeviceMesh of every rank, as the
reference's daemon serves on its mesh plane: under torchrun each rank
builds the same seeded store and a mesh plane of ``--tablets-per-device``
tablets in ``--groups`` groups; rank 0 is the controller (writers,
sessions, dispatcher, compactor, /metrics, watchdog) and the other ranks
follow its control log (core/spmd.py) until it stops. Without torchrun it
joins a one-rank process group (an existing one is used as is, otherwise
one is made and destroyed). Without ``--mesh`` the plane is meshless.

Two early stdout lines are machine-readable (flushed before any long
work):

    METRICS_URL=http://127.0.0.1:<port>/metrics
    INCIDENT_DIR=<path>

Exit code 0 on a clean run (incidents are an observability outcome, not
a failure). The default SLOs are loose; an absurdly tight --ttfr-slo
induces a breach.
"""
from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import List

import numpy as np

T_SPAN = 2 * 3600

_DOMAINS = ["a.com", "b.com", "c.com", "rare.net"]
_DOMAIN_P = [0.6, 0.25, 0.13, 0.02]
_SCHEMES = ("scan", "batched_scan", "index", "batched_index")


def _gen(rng, n: int):
    ts = np.sort(rng.integers(0, T_SPAN, n))
    vals = {
        "domain": rng.choice(_DOMAINS, p=_DOMAIN_P, size=n).tolist(),
        "method": rng.choice(["GET", "POST"], size=n).tolist(),
        "status": rng.choice(["200", "404"], size=n, p=[0.8, 0.2]).tolist(),
    }
    return ts, vals


def _parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve_db",
        description="long-running serve daemon: writers + sessions + "
        "Prometheus endpoint + flight recorder + SLO watchdog",
    )
    ap.add_argument("--rows", type=int, default=6_000, help="seed rows")
    ap.add_argument("--sessions", type=int, default=4, help="query sessions")
    ap.add_argument("--writers", type=int, default=2, help="background writers")
    ap.add_argument("--duration", type=float, default=10.0, help="run seconds")
    ap.add_argument("--port", type=int, default=0, help="/metrics port (0=ephemeral)")
    ap.add_argument("--incident-dir", default="incidents", help="bundle directory")
    ap.add_argument("--groups", type=int, default=2, help="plane tablet groups")
    ap.add_argument("--tablets-per-device", type=int, default=4,
                    help="the plane's tablets on each card")
    ap.add_argument("--mesh", choices=["dev"], default=None,
                    help="serve on a DeviceMesh of every rank (rank 0 serves, the "
                    "others follow its control log)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--window", type=float, default=10.0, help="SLO window seconds")
    ap.add_argument("--tick", type=float, default=0.25, help="watchdog tick seconds")
    ap.add_argument("--cooldown", type=float, default=30.0, help="per-rule cooldown")
    ap.add_argument("--flight-window", type=float, default=30.0)
    ap.add_argument(
        "--ttfr-slo", type=float, default=2.0,
        help="p99 time-to-first-result bound (seconds)",
    )
    ap.add_argument(
        "--lock-wait-slo", type=float, default=5.0,
        help="plane-lock acquire-wait seconds per window",
    )
    ap.add_argument(
        "--stall-slo", type=float, default=1.0,
        help="worst compaction increment (seconds, gauge)",
    )
    ap.add_argument(
        "--blocked-slo", type=float, default=5.0,
        help="writer blocked-seconds per window",
    )
    return ap.parse_args(argv)


def _join_group(dev):
    """The process group of a mesh daemon: torchrun's (WORLD_SIZE set), one
    already joined, or a new one of one rank. Returns (the rank's device,
    whether this call made the group)."""
    import os
    import socket

    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dev, False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group(backend)
        return dev, True
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    return dev, True


def main(argv=None) -> int:
    args = _parse(argv)
    if not args.mesh:
        return _serve(args, args.device, None)
    import torch.distributed as dist

    from ..core.device import resolve_device
    from ..launch.mesh import make_dev_mesh

    dev, made = _join_group(resolve_device(args.device))
    try:
        return _serve(args, dev, make_dev_mesh(1, dist.get_world_size(), device_type=dev.type))
    finally:
        if made:
            dist.destroy_process_group()


def _serve(args, device, mesh) -> int:
    # Imports after argparse so `--help` stays instant.
    from ..core import EventStore, web_proxy_schema
    from ..core.dist_ingest import DistBatchWriter, DistIngestPlane
    from ..core.spmd import Controller
    from ..obs import (
        WatchRule, Watchdog, counter_delta_rule, flight_enable, gauge_rule,
        get_registry, lock_wait_rule, serve_prometheus,
    )
    from . import QueryService, ttfr_event_probe

    rng = np.random.default_rng(args.seed)
    ts, vals = _gen(rng, args.rows)
    store = EventStore(web_proxy_schema(), n_shards=4, device=device)
    store.ingest(ts, vals)
    store.flush_all()
    store.compact_all()
    # Capacity sized for seed + everything the writers can append during
    # the run (each writer is budgeted to at most re-send the seed).
    cap = 2 * args.rows * (1 + max(args.writers, 1))
    sizes = dict(n_groups=args.groups, mem_rows=512, max_runs=4, append_rows=256, device=device)
    control = None
    if mesh is None:
        plane = DistIngestPlane.for_store(store, capacity=cap,
                                          n_tablets=args.tablets_per_device, **sizes)
    else:
        control = Controller(store)
        plane = DistIngestPlane.for_store(store, capacity=cap, mesh=mesh, control=control,
                                          tablets_per_device=args.tablets_per_device, **sizes)
        if not control.leads:
            n = control.follow(plane)
            print(f"daemon: rank {control.rank} followed {n} records of rank 0's log",
                  flush=True)
            return 0
    flight_enable()
    endpoint = serve_prometheus(port=args.port)
    print(f"METRICS_URL={endpoint.url}", flush=True)
    print(f"INCIDENT_DIR={args.incident_dir}", flush=True)

    svc = QueryService(store, plane, compaction_interval=0.01)
    reg = get_registry()
    watchdog = Watchdog(
        [
            WatchRule(
                "ttfr_p99", ttfr_event_probe(), args.ttfr_slo,
                window_s=args.window, agg="p99", cooldown_s=args.cooldown,
                help="p99 time-to-first-result over the window",
            ),
            lock_wait_rule(
                "plane_lock_wait", "plane_lock", args.lock_wait_slo,
                window_s=args.window, cooldown_s=args.cooldown,
            ),
            gauge_rule(
                "compact_increment_stall",
                reg.gauge(
                    "compactor_max_increment_seconds",
                    "longest single compact_step device hold",
                ),
                args.stall_slo, cooldown_s=args.cooldown,
            ),
            counter_delta_rule(
                "writer_blocked", plane._m_blocked, args.blocked_slo,
                window_s=args.window, cooldown_s=args.cooldown,
            ),
        ],
        incident_dir=args.incident_dir,
        interval_s=args.tick,
        flight_window_s=args.flight_window,
    ).start()

    stop = threading.Event()
    served = [0] * args.sessions

    def writer_loop(wid: int) -> None:
        w = DistBatchWriter(store, plane, batch_rows=512, writer_id=wid)
        budget = args.rows  # bound memory: at most one seed re-send
        wrng = np.random.default_rng(args.seed + 1000 + wid)
        while not stop.is_set() and budget > 0:
            n = min(256, budget)
            bts, bvals = _gen(wrng, n)
            w.add(bts, bvals)
            budget -= n
            stop.wait(0.05)
        w.close()

    def session_loop(i: int) -> None:
        s = svc.session(f"daemon-{i}")
        srng = np.random.default_rng(args.seed + i)
        try:
            while not stop.is_set():
                scheme = _SCHEMES[srng.integers(len(_SCHEMES))]
                t0 = int(srng.integers(0, T_SPAN // 2))
                t1 = t0 + int(srng.integers(T_SPAN // 8, T_SPAN // 2))
                from ..core import Eq

                tree = Eq("domain", _DOMAINS[srng.integers(len(_DOMAINS))])
                try:
                    s.submit(scheme, t0, t1, tree).drain(timeout=60.0)
                    served[i] += 1
                except RuntimeError:
                    break  # service closed under us: clean shutdown race
        finally:
            if not s.closed:
                s.close()

    threads: List[threading.Thread] = [
        threading.Thread(target=writer_loop, args=(w,), name=f"writer-{w}", daemon=True)
        for w in range(args.writers)
    ] + [
        threading.Thread(target=session_loop, args=(i,), name=f"client-{i}", daemon=True)
        for i in range(args.sessions)
    ]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + args.duration
    while time.perf_counter() < deadline:
        time.sleep(0.1)
    stop.set()
    for t in threads:
        t.join(timeout=90.0)
    watchdog.stop()
    svc.close()
    if control is not None:
        control.close()  # the stop record, once the service and the writers are done
    endpoint.stop()
    incidents = [i for i in watchdog.incidents() if i.get("kind") == "incident"]
    print(
        f"daemon: {sum(served)} queries over {args.sessions} sessions, "
        f"{args.writers} writers, {len(incidents)} incident(s)",
        flush=True,
    )
    for inc in incidents:
        print(f"INCIDENT={inc['bundle']} rule={inc['rule']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
