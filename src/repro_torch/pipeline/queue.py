"""Master ingest queue (paper §II): "A master ingest process monitors new
data and appends these files to a partitioned queue. Multiple ingest worker
processes monitor a queue partition for work." A copy of the reference's
pipeline/queue.py.

Fault tolerance beyond the paper:
  * lease-based claims: a worker leases a task; if its heartbeat goes stale
    the lease expires and the task is re-queued (straggler and failure
    mitigation);
  * work stealing: an idle worker steals from the longest partition, so a
    slow partition cannot stall the pipeline;
  * elastic membership: workers may join mid-run, each on its own
    partition;
  * idempotency: tasks are file-grained; a re-queued file re-ingests whole
    (the per-file ``done`` registry records who completed it).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class FileTask:
    path: str
    source: str  # data source / table name (paper: "filename and metadata")
    task_id: int = 0
    attempts: int = 0


@dataclass
class _Lease:
    task: FileTask
    worker: str
    t_claim: float
    t_heartbeat: float


class MasterIngestQueue:
    def __init__(self, n_partitions: int, lease_timeout_s: float = 30.0):
        self.n_partitions = n_partitions
        self.lease_timeout_s = lease_timeout_s
        self._parts: List[List[FileTask]] = [[] for _ in range(n_partitions)]
        self._leases: Dict[int, _Lease] = {}
        self._done: Dict[int, str] = {}
        self._next_id = 0
        self._lock = threading.Lock()

    def submit(self, task: FileTask) -> int:
        """The master appends a staged file to a partition (round-robin by
        id)."""
        with self._lock:
            task.task_id = self._next_id
            self._next_id += 1
            self._parts[task.task_id % self.n_partitions].append(task)
            return task.task_id

    def claim(self, worker: str, partition: int) -> Optional[FileTask]:
        """Claim the next task from ``partition``, stealing from the longest
        other partition when it is empty."""
        with self._lock:
            self._expire_leases()
            part = self._parts[partition % self.n_partitions]
            if not part:
                richest = max(self._parts, key=len)
                if not richest:
                    return None
                part = richest  # work stealing
            task = part.pop(0)
            task.attempts += 1
            now = time.monotonic()
            self._leases[task.task_id] = _Lease(task, worker, now, now)
            return task

    def heartbeat(self, worker: str, task_id: int) -> None:
        with self._lock:
            lease = self._leases.get(task_id)
            if lease is not None and lease.worker == worker:
                lease.t_heartbeat = time.monotonic()

    def complete(self, worker: str, task_id: int) -> None:
        with self._lock:
            lease = self._leases.pop(task_id, None)
            if lease is not None:
                self._done[task_id] = worker

    def _expire_leases(self) -> None:
        """Straggler mitigation: stale leases re-queue their task."""
        now = time.monotonic()
        stale = [tid for tid, lease in self._leases.items()
                 if now - lease.t_heartbeat > self.lease_timeout_s]
        for tid in stale:
            lease = self._leases.pop(tid)
            self._parts[tid % self.n_partitions].append(lease.task)

    def expire_now(self) -> int:
        """Run the lease-expiry sweep now; returns the tasks re-queued."""
        with self._lock:
            before = len(self._leases)
            self._expire_leases()
            return before - len(self._leases)

    @property
    def pending(self) -> int:
        with self._lock:
            return sum(len(p) for p in self._parts)

    @property
    def in_flight(self) -> int:
        with self._lock:
            return len(self._leases)

    @property
    def completed(self) -> int:
        with self._lock:
            return len(self._done)

    def drained(self) -> bool:
        with self._lock:
            return not self._leases and all(not p for p in self._parts)
