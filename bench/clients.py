"""What the client loops share: the measured window, threads
that hand back what they raised, and the store a cell sets up (the
plane of the configuration's sizes, the host store whose dictionaries
the service reads, the preload)."""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List

import numpy as np

from . import gen


@dataclass
class Window:
    t0: float
    t1: float

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def make_plane(cfg: dict, device):
    """A fresh plane of the configuration's sizes, every field indexed."""
    from repro_torch.core.dist_ingest import DistIngestPlane

    return DistIngestPlane(len(gen.FIELDS), cfg["capacity"], n_tablets=cfg["tablets"],
                           mem_rows=cfg["mem_rows"], max_runs=cfg["max_runs"],
                           append_rows=cfg["append_rows"], n_groups=cfg["n_groups"],
                           agg_bucket_s=cfg["agg_bucket_s"],
                           indexed_fids=tuple(range(len(gen.FIELDS))), device=device)


def run_threads(target, n: int, name: str, timeout: float = 600.0) -> List[BaseException]:
    """Run target(i) on n threads; returns the exceptions they raised."""
    errors: List[BaseException] = []

    def work(i):
        try:
            target(i)
        except BaseException as e:  # handed to the caller, after the join
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,), name=f"{name}-{i}") for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        errors.append(RuntimeError(f"{name}: a thread did not end in {timeout} s"))
    return errors


def make_store(ev: gen.Events, fields, device):
    """The host EventStore whose schema and dictionaries the plane and the
    service read: the dictionaries of ``fields`` filled once per distinct
    value, in code order (one encode_many call a field)."""
    from repro_torch.core.schema import web_proxy_schema
    from repro_torch.core.store import EventStore

    store = EventStore(web_proxy_schema(), device=device)
    if store.schema.field_names() != list(gen.FIELDS):
        raise RuntimeError("the port's web-proxy schema differs from the generator's fields")
    for f in fields:
        codes = store.dictionaries[f].encode_many(ev.vocab(f))
        if not np.array_equal(codes, np.arange(len(codes))):
            raise RuntimeError(f"{f}: the store's dictionary did not take the codes in order")
    return store


def preload(plane, ev: gen.Events, cfg: dict, chunk_rows: int, spans) -> np.ndarray:
    """The stored span through the plane's ingest on one thread, then every
    group compacted (fold debt drained). Returns each row's tablet."""
    (stream,) = gen.writer_chunks(ev, np.arange(ev.n), cfg["tablets"], chunk_rows, 1)
    with spans.span("preload.ingest"):
        for ch in stream:
            plane.ingest(ch.rts, ch.cols, ch.tab, writer_id=0)
    with spans.span("preload.compact"):
        plane.compact()
    if plane.has_unfolded():
        raise RuntimeError("the preloaded plane still holds unfolded rows")
    return np.concatenate([ch.tab for ch in stream])
