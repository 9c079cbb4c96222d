"""Host BatchScanner over the event table — the CPU oracle's read path;
the part of the reference's core/scan.py this package calls."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from . import keypack
from .store import EventStore


def scan_events(store: EventStore, t_start: int, t_stop: int
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(packed keys, cols) of every shard's events with ts in
    [t_start, t_stop], shard by shard (cross-shard order unspecified)."""
    for s in range(store.n_shards):
        lo, hi = keypack.event_key_range(s, t_start, t_stop)
        keys, cols = store.event_tablets[s].scan_range(int(lo), int(hi))
        if keys.size:
            yield keys, cols
