"""Faults planted under the timed path, for the tests that show the
comparison with the reference fails when the program is wrong, and the
control: the reference in the program's place with one of the
configuration's guarantees broken. Each is a context manager that patches
the port (or, for the control, the answers) and undoes it on exit; the
benchmark's own runs never use them."""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np


@contextmanager
def patched(obj, name, new):
    old = vars(obj)[name]  # the raw attribute: a staticmethod stays one
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


# ------------------------------------------------------------- ingest
@contextmanager
def append_leaves_state_unchanged():
    """Every append is acknowledged, and nothing reaches the tablets."""
    from repro_torch.core.dist_ingest import TabletGroup

    with patched(TabletGroup, "_append_rows", lambda self, *a, **k: 0.0):
        yield


@contextmanager
def ingest_drops_half_the_batch():
    """ingest() appends the first half of each batch and acknowledges it all."""
    from repro_torch.core.dist_ingest import DistIngestPlane

    real = DistIngestPlane.ingest

    def half(self, rts, cols, tab, writer_id=0):
        n = len(rts) // 2
        return real(self, rts[:n], cols[:n], tab[:n], writer_id=writer_id)

    with patched(DistIngestPlane, "ingest", half):
        yield


@contextmanager
def append_alters_a_code():
    """The device append writes one row's first code off by one."""
    from repro_torch.core.dist_ingest import _PlanePrograms

    real = _PlanePrograms.append

    def altered(self, st, rows, plan):
        rows = rows.clone()
        rows[0, 1] += 1
        return real(self, st, rows, plan)

    with patched(_PlanePrograms, "append", altered):
        yield


@contextmanager
def fold_skips_the_combine():
    """A fold writes the merged keys into the base as they come, repeats
    and all, with their own counts: the multiset of keys and the
    aggregate sums stay right, the base is no longer combined."""
    import torch

    from repro_torch.core import dist_ingest

    def uncombined(keys, counts, n_live, cap, sentinel):
        sums = None if counts is None else counts[:, :cap].to(torch.int64)
        return keys[:, :cap].clone(), sums, n_live.to(torch.int32)

    with patched(dist_ingest, "combine_compact", uncombined):
        yield


@contextmanager
def minor_leaves_runs_unsorted():
    """Minor compaction and the seal mask a memtable past its fill and
    leave it in arrival order, unsorted."""
    import torch

    from repro_torch.core import dist_ingest

    def unsorted(keys, cols, n, sentinel):
        valid = torch.arange(keys.shape[1], device=keys.device) < n[:, None]
        return torch.where(valid, keys, sentinel), cols

    with patched(dist_ingest, "_sort_masked", unsorted):
        yield


@contextmanager
def publish_skips_the_seal():
    """Control: publish() leaves the memtables out (no seal, an empty
    memtable level), breaking "an acknowledged append is in the next
    publish()"."""
    from repro_torch.core.dist_ingest import _PlanePrograms

    real = _PlanePrograms.seal

    def unsealed(self, st, seal_rows):
        out = real(self, st, seal_rows)
        return {p: (k, c, n.new_zeros(n.shape)) for p, (k, c, n) in out.items()}

    with patched(_PlanePrograms, "seal", unsealed):
        yield


# ------------------------------------------------------------ serving
@contextmanager
def steps_return_nothing():
    """Every query step returns an empty batch (its state unchanged)."""
    from repro_torch.core.dist_query import DistBatch, QueryRun

    real = QueryRun._step

    def empty(self):
        blk = real(self)
        return DistBatch(0, blk.ts[:0], blk.cols[:0], blk.lo, blk.hi)

    with patched(QueryRun, "_step", empty):
        yield


@contextmanager
def scans_read_half_the_groups():
    """A composite snapshot's scan and index steps read only the first
    half of its tablet groups."""
    from repro_torch.core.dist_query import DistQueryProcessor, DistStore

    def halve(d):
        if d is not None and d.groups is not None and len(d.groups) > 1:
            return DistStore(groups=d.groups[: len(d.groups) // 2], gens=d.gens, mesh=d.mesh)
        return d

    real_scan, real_index = DistQueryProcessor.scan_range, DistQueryProcessor.scan_index_range

    def scan(self, tree, t0, t1, dist=None, **kw):
        return real_scan(self, tree, t0, t1, dist=halve(dist), **kw)

    def index(self, plan, tree, t0, t1, dist=None, **kw):
        return real_index(self, plan, tree, t0, t1, dist=halve(dist), **kw)

    with patched(DistQueryProcessor, "scan_range", scan), \
            patched(DistQueryProcessor, "scan_index_range", index):
        yield


@contextmanager
def results_alter_a_count():
    """Every result batch the service delivers counts one row too many."""
    from repro_torch.serve_db.service import QueryService

    real = QueryService._as_result

    def plus_one(entry, blk, wait_s, device_s):
        rb = real(entry, blk, wait_s, device_s)
        rb.count += 1
        return rb

    with patched(QueryService, "_as_result", staticmethod(plus_one)):
        yield


def bucketed_answers(bucket_s: int):
    """Control: the reference in the program's place, answering every
    query's count from whole aggregate buckets (the density's rounding)
    instead of the exact time range, breaking "every answer is exact".
    A hook for harness.run_cell's ``answers_hook``."""
    from . import reference

    def hook(answers, ev, device):
        qref = reference.QueryReference(ev.ts, ev.cols, np.zeros(ev.n, np.int64), {}, {}, device)
        for a in answers:
            if a.req.kind != "query" or a.error is not None or a.t_done is None:
                continue
            lo = a.req.t0 // bucket_s * bucket_s
            hi = (a.req.t1 // bucket_s + 1) * bucket_s - 1
            a.batches = [(float(a.req.t0), float(a.req.t1), qref.count(a.req.pred, lo, hi))]
            a.rows = []

    return hook
