"""Closed-loop ingest clients in back-to-back epochs.

The traffic file's keys: ``writers`` threads each append pre-encoded,
row-hashed chunks of ``chunk_rows`` rows of the configuration's stream
through ``DistIngestPlane.ingest`` (writer i takes every ``writers``-th
chunk). An epoch is a fresh plane of the configuration's sizes, made
inside the window so that its cost counts, the whole stream, then one
``publish()``. Set-up warms up with ``warm_chunks`` chunks and a publish.

After the window the last whole epoch's publish gives the bytes the
store holds a row. Judged after the window: every kept epoch's publish (one drawn from the
seed, the last whole one, and the one the window cut, published after
the close) against the reference's tables over the rows of the chunks
``ingest()`` acknowledged.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from bench import clients, gen, readback, reference
from bench.harness import Context, Outcome, Run


@dataclass
class Epoch:
    index: int
    plane: object
    pub: object = None  # the publish that ends a whole epoch; None when cut
    # (time, rows, writer, chunk) of every append ingest() acknowledged
    acks: List[Tuple[float, int, int, int]] = field(default_factory=list)
    attempted: int = 0
    errors: List[BaseException] = field(default_factory=list)
    blocked_s: float = 0.0
    group_wait_s: float = 0.0


@dataclass
class IngestRun(Run):
    writers: int = 0
    epochs: List[Epoch] = field(default_factory=list)

    def acked_in_window(self) -> int:
        """Rows ingest() acknowledged in the window."""
        return sum(a[1] for ep in self.epochs for a in ep.acks if a[0] <= self.window.t1)


class IngestEpochs:
    """Closed-loop writers over fresh planes."""

    def __init__(self, cfg: dict, traffic: dict, ev: gen.Events, device, spans):
        self.cfg, self.device, self.spans = cfg, device, spans
        self.writers = int(traffic["writers"])
        self.streams = gen.writer_chunks(ev, np.arange(ev.n), cfg["tablets"],
                                         int(traffic["chunk_rows"]), self.writers)

    def epoch(self, index: int, deadline: Optional[float] = None,
              chunks: Optional[int] = None) -> Epoch:
        """One epoch: a fresh plane, every writer's chunks (up to the
        deadline; for a warm-up, ``chunks`` in all, the same number from
        each writer), and the publish when all were appended."""
        with self.spans.span("epoch.new_plane"):
            ep = Epoch(index, clients.make_plane(self.cfg, self.device))
        lock = threading.Lock()
        todo = [s if chunks is None else s[: chunks // self.writers] for s in self.streams]

        def write(w):
            for j, ch in enumerate(todo[w]):
                if deadline is not None and time.perf_counter() >= deadline:
                    return
                with lock:
                    ep.attempted += 1
                with self.spans.span("writer.ingest"):
                    ep.plane.ingest(ch.rts, ch.cols, ch.tab, writer_id=w)
                t = time.perf_counter()
                with lock:
                    ep.acks.append((t, len(ch.rts), w, j))

        ep.errors = clients.run_threads(write, self.writers, f"epoch{index}-writer")
        whole = sum(len(c.rts) for t in todo for c in t)
        if not ep.errors and sum(a[1] for a in ep.acks) == whole:
            with self.spans.span("epoch.publish"):
                ep.pub = ep.plane.publish()
        ep.blocked_s = ep.plane.blocked_seconds
        ep.group_wait_s = sum(g.lock.snapshot()["total_wait_s"] for g in ep.plane.groups)
        return ep

    def run(self, window: clients.Window,
            keep: Tuple[int, ...]) -> Tuple[List[Epoch], Dict[int, Epoch]]:
        """Epochs back to back until the window closes. Returns every
        epoch and the kept ones by index: those in ``keep`` and the last
        whole one keep their planes and publishes, and so does the epoch
        the window cut; the others' are dropped as soon as a later epoch
        ends, so the card holds at most three planes and a fresh one."""
        epochs: List[Epoch] = []
        kept: Dict[int, Epoch] = {}
        last: Optional[Epoch] = None
        i = 0
        while time.perf_counter() < window.t1:
            ep = self.epoch(i, deadline=window.t1)
            epochs.append(ep)
            if ep.errors:
                break
            if ep.pub is not None:
                if last is not None and last.index not in keep:
                    kept.pop(last.index, None)
                    last.plane = last.pub = None
                last = ep
                kept[i] = ep
            i += 1
        return epochs, kept


def run(ctx: Context) -> Outcome:
    cfg, traffic = ctx.cfg, ctx.cell.traffic
    with ctx.phase("make events"):
        ev = gen.make_events(ctx.seed, cfg["events"], cfg["span_s"])
    with ctx.phase("route the stream"):
        eng = IngestEpochs(cfg, traffic, ev, ctx.device, ctx.spans)
    with ctx.phase("warm-up epoch"):
        # Every shape of the window, and the allocator's blocks.
        warm = eng.epoch(-1, chunks=int(traffic["warm_chunks"]))
        if warm.errors or warm.pub is None:
            raise RuntimeError(f"the warm-up epoch failed: {warm.errors}")
        del warm
        ctx.sync()
    keep = (int(np.random.default_rng([int(ctx.seed), 2]).integers(0, 2)),)
    ctx.settle()
    ctx.window.start()
    t0 = time.perf_counter()
    window = clients.Window(t0, t0 + ctx.seconds)
    epochs, kept = eng.run(window, keep)
    ctx.sync()
    run = IngestRun(window, t0 - ctx.t_start, writers=eng.writers, epochs=epochs)
    with ctx.phase("read the trace"):
        run.trace = ctx.window.stop(window.t0, window.t1, ctx.spans)
    peak = ctx.peak_bytes()

    # The cut epoch's acknowledged rows must be in its next publish too.
    cut = epochs[-1] if epochs and epochs[-1].pub is None and not epochs[-1].errors else None
    if cut is not None and cut.acks:
        cut.pub = cut.plane.publish()
        kept[cut.index] = cut
    # The store's bytes a row: the last whole epoch's publish, else the cut one's.
    whole = [ep for ep in kept.values() if ep is not cut]
    sized = max(whole, key=lambda ep: ep.index) if whole else kept.get(getattr(cut, "index", -1))
    if sized is not None:
        run.store_bytes_per_row = (readback.store_bytes(sized.pub)
                                   / sum(a[1] for a in sized.acks))
    for ep in epochs:
        if ep.index not in kept:
            ep.plane = ep.pub = None

    checks: Dict[str, int] = {"errors": sum(len(ep.errors) for ep in epochs),
                              "epochs_checked_missing": int(not kept)}
    with ctx.phase("judge"):
        checks.update(judge_epochs(kept, eng.streams, ev, cfg, ctx.device))
    attempted = sum(ep.attempted for ep in epochs)
    return Outcome(run, checks, attempted, checks["errors"], peak)


def judge_epochs(kept: Dict[int, Epoch], streams, ev: gen.Events, cfg: dict,
                 device) -> Dict[str, int]:
    """Every kept epoch's publish against the reference over the rows its
    writers' acknowledged chunks hold; each epoch's plane is let go once
    judged."""
    tally = dict.fromkeys(("ev_rows_off", "ix_keys_off", "ag_sums_off", "level_order_off",
                           "combined_repeats_off", "overflow"), 0)
    for ep in kept.values():
        chunks = sorted((w, j) for _, _, w, j in ep.acks)
        rows = np.concatenate([streams[w][j].rows for w, j in chunks])
        tab = np.concatenate([streams[w][j].tab for w, j in chunks])
        ref = reference.StoreReference(ev.ts[rows], ev.cols[rows], tab, cfg["agg_bucket_s"],
                                       device)
        got = readback.plane_contents(ep.pub)
        for k, v in reference.plane_off(ref, **got).items():
            tally[k] += v
        tel = ep.plane.telemetry()
        tally["overflow"] += int(tel["overflow"].sum() + tel["ix_overflow"].sum()
                                 + tel["ag_overflow"].sum())
        ep.plane = ep.pub = None
        del ref, got
    return tally
