"""The paper's adaptive batching (Alg 1), applied to request admission; a
copy of the reference's serving/batcher.py.

A query's time range maps to the request queue, a batch's result count
k_i to the requests admitted per scheduling round, a batch's runtime T_i
to the round's wall time (prefill + decode). The update law is
core/batching.py's ``alg1_next_k``: rounds that run hot shrink admission
toward interactive latencies, fast rounds grow it geometrically.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..core.batching import alg1_next_k


@dataclass
class AdaptiveRequestBatcher:
    k0: float = 1.0
    c: float = 1.5
    t_min: float = 0.05  # seconds: serving rounds, not analytics scans
    t_max: float = 0.5
    max_batch: int = 64
    history: List = field(default_factory=list)

    def __post_init__(self):
        self._k = float(self.k0)

    def admit(self, waiting: int, free_slots: int) -> int:
        """How many queued requests to admit this round."""
        return max(min(int(round(self._k)), waiting, free_slots), 1 if waiting and free_slots else 0)

    def update(self, runtime: float, served: int) -> None:
        """Alg 1 UPDATE with (T_i, r_i) = (round wall time, requests served
        this round)."""
        self.history.append((runtime, served))
        k_next = alg1_next_k(self._k, runtime, served, self.c, self.t_max, self.t_min)
        self._k = float(min(max(k_next, 1.0), self.max_batch))

    @property
    def k(self) -> float:
        return self._k
