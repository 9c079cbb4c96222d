"""Ingest worker pool (paper §II): "Upon receiving a filename and metadata,
the ingest worker reads lines from the file, parsing the data into entries
to be stored in the event, index and aggregate tables." A copy of the
reference's pipeline/workers.py.

Workers are threads. Each owns a BatchWriter, which writes into the store
(whose compactions run on the store's device), and a queue partition; it
heartbeats its lease while parsing, completes the task after the writer's
flush, and exits when the queue drains. The pool is elastic: workers can
be added mid-run, and a killed worker's lease expires and its file
re-queues.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List

from ..core.ingest import BatchWriter, IngestMetrics, check_shard_guidance
from ..core.store import EventStore
from .queue import FileTask, MasterIngestQueue
from .sources import parse_web_proxy_lines


@dataclass
class WorkerReport:
    name: str
    files: int = 0
    rows: int = 0
    metrics: IngestMetrics = field(default_factory=IngestMetrics)


class _Worker(threading.Thread):
    def __init__(self, name: str, pool: "IngestWorkerPool", partition: int, batch_rows: int,
                 heartbeat_every: int = 1024):
        # heartbeat_every: lines between heartbeats. The heartbeat period
        # must stay well under the lease timeout, or a live worker's file
        # is re-queued (at-least-once: a duplicate ingest).
        super().__init__(name=name, daemon=True)
        self.pool = pool
        self.partition = partition
        self.report = WorkerReport(name)
        self.writer = BatchWriter(pool.store, batch_rows=batch_rows, metrics=self.report.metrics)
        self.heartbeat_every = heartbeat_every
        self.stop_flag = threading.Event()
        self.die_silently = threading.Event()  # test hook: simulate a crash

    def run(self) -> None:
        q = self.pool.queue
        while not self.stop_flag.is_set():
            task = q.claim(self.name, self.partition)
            if task is None:
                if self.pool.closed.is_set() and q.drained():
                    break
                time.sleep(0.01)
                continue
            if self.die_silently.is_set():
                return  # crash mid-lease: no complete(), the lease expires
            try:
                q.heartbeat(self.name, task.task_id)  # before any slow work
                with open(task.path) as f:
                    lines = f.readlines()
                for i in range(0, len(lines), self.heartbeat_every):
                    chunk = lines[i: i + self.heartbeat_every]
                    ts, cols = parse_web_proxy_lines(chunk)
                    self.writer.add(ts, cols, nbytes=sum(len(line) for line in chunk))
                    q.heartbeat(self.name, task.task_id)
                self.writer.flush()
                q.complete(self.name, task.task_id)
                self.report.files += 1
                self.report.rows += len(lines)
            except Exception:  # noqa: BLE001 — a failed file must re-queue
                # Leave the lease to expire; the task re-runs elsewhere.
                time.sleep(0.01)
        self.writer.close()


class IngestWorkerPool:
    """Elastic pool of ingest workers over a master queue."""

    def __init__(self, store: EventStore, n_workers: int, batch_rows: int = 4096,
                 lease_timeout_s: float = 30.0, enforce_shard_guidance: bool = True):
        if enforce_shard_guidance and not check_shard_guidance(store.n_shards, n_workers):
            raise ValueError(
                f"paper guidance violated: n_shards={store.n_shards} < "
                f"n_clients/2={n_workers / 2} (pass enforce_shard_guidance="
                f"False to override)"
            )
        self.store = store
        self.queue = MasterIngestQueue(max(n_workers, 1), lease_timeout_s=lease_timeout_s)
        self.closed = threading.Event()
        self._workers: List[_Worker] = []
        self._batch_rows = batch_rows
        for _ in range(n_workers):
            self.add_worker()

    def add_worker(self) -> str:
        w = _Worker(f"ingest-{len(self._workers)}", self, partition=len(self._workers),
                    batch_rows=self._batch_rows)
        self._workers.append(w)
        w.start()
        return w.name

    def submit_file(self, path: str, source: str = "web_proxy") -> int:
        return self.queue.submit(FileTask(path, source))

    def kill_worker(self, idx: int) -> None:
        """Test hook: simulate a node failure (the worker dies mid-lease)."""
        self._workers[idx].die_silently.set()

    def drain(self, timeout_s: float = 300.0) -> List[WorkerReport]:
        """Close submissions, wait for the queue to drain, join workers."""
        self.closed.set()
        deadline = time.monotonic() + timeout_s
        while not self.queue.drained():
            if time.monotonic() > deadline:
                raise TimeoutError("ingest drain timeout")
            self.queue.expire_now()
            time.sleep(0.02)
        for w in self._workers:
            w.stop_flag.set()
        for w in self._workers:
            w.join(timeout=10)
        return [w.report for w in self._workers]
