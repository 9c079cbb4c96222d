"""The port's ingest pipeline (repro_torch.pipeline, core/ingest.py) on
the CPU: tests/test_pipeline.py's cases (drain, straggler re-queue,
elastic add, lease expiry, shard guidance, tokenizer) on the port, and
the port held to the JAX package on the same inputs with no tolerance:
byte-identical staged files, parse_web_proxy_line, the IngestMetrics
counter names and rate_series, a one-worker ingest whose host tablets
equal the reference EventStore's bit for bit, and the tokenizer's
batches."""
import time

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import ingest as jingest
from repro import pipeline as jpipeline
from repro.pipeline.tokenizer import EventTokenizer as JEventTokenizer
from repro_torch.core import EventStore, web_proxy_schema
from repro_torch.core.ingest import IngestMetrics, check_shard_guidance, rate_series
from repro_torch.pipeline import (
    EventTokenizer, FileTask, IngestWorkerPool, MasterIngestQueue, SyntheticWebProxySource,
    parse_web_proxy_line,
)
from repro_torch.pipeline.workers import WorkerReport

N_FILES, LINES = 6, 1500


def stage(tmp_path, src_cls, name):
    src = src_cls(n_domains=100, seed=5)
    return src.write_files(str(tmp_path / name), n_files=N_FILES, lines_per_file=LINES,
                           t_start=0, t_stop=7200)


@pytest.fixture()
def staged_files(tmp_path):
    return stage(tmp_path, SyntheticWebProxySource, "port")


def cpu_store(n_shards=4, **kw):
    return EventStore(web_proxy_schema(), n_shards=n_shards, device="cpu", **kw)


def test_staged_files_are_byte_identical_to_the_reference(tmp_path):
    ours = stage(tmp_path, SyntheticWebProxySource, "port")
    ref = stage(tmp_path, jpipeline.SyntheticWebProxySource, "ref")
    assert [p.rsplit("/", 1)[1] for p in ours] == [p.rsplit("/", 1)[1] for p in ref]
    for a, b in zip(ours, ref):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_parse_web_proxy_line_matches_reference(staged_files):
    with open(staged_files[2]) as f:
        lines = f.readlines()[:200]
    for line in lines:
        assert parse_web_proxy_line(line) == jpipeline.parse_web_proxy_line(line)


def test_pool_drains_all_files(staged_files):
    store = cpu_store()
    pool = IngestWorkerPool(store, n_workers=3)
    for p in staged_files:
        pool.submit_file(p)
    reports = pool.drain(timeout_s=120)
    assert store.total_rows == N_FILES * LINES
    assert sum(r.files for r in reports) == N_FILES
    assert pool.queue.completed == N_FILES
    assert sum(r.metrics.rows for r in reports) == N_FILES * LINES
    assert store.backpressure_stats()["rows"] == N_FILES * LINES


def test_straggler_requeue(staged_files):
    """A worker that dies mid-lease must not lose its file: the lease
    expires and another worker re-ingests it."""
    store = cpu_store()
    pool = IngestWorkerPool(store, n_workers=3, lease_timeout_s=2.0)
    pool.kill_worker(0)  # dies silently on its first claim
    for p in staged_files:
        pool.submit_file(p)
    pool.drain(timeout_s=120)
    assert store.total_rows == N_FILES * LINES  # nothing lost


def test_elastic_add_worker(staged_files):
    store = cpu_store()
    pool = IngestWorkerPool(store, n_workers=2)
    for p in staged_files:
        pool.submit_file(p)
    pool.add_worker()  # join mid-run
    reports = pool.drain(timeout_s=120)
    assert store.total_rows == N_FILES * LINES
    assert len(reports) == 3


def test_lease_expiry_requeues():
    q = MasterIngestQueue(n_partitions=2, lease_timeout_s=0.05)
    q.submit(FileTask("/nonexistent/x", "web_proxy"))
    task = q.claim("w0", 0)
    assert task is not None and q.in_flight == 1
    time.sleep(0.1)
    assert q.expire_now() == 1
    assert q.pending == 1  # re-queued
    t2 = q.claim("w1", 1)  # work stealing across partitions
    assert t2 is not None and t2.attempts == 2
    q.heartbeat("w0", t2.task_id)  # a stale worker's heartbeat is ignored
    q.complete("w1", t2.task_id)
    assert q.drained() and q.completed == 1


def test_shard_guidance_enforced():
    store = cpu_store(n_shards=2)
    with pytest.raises(ValueError, match="paper guidance"):
        IngestWorkerPool(store, n_workers=8)  # N=2 < 8/2
    assert check_shard_guidance(4, 8)
    assert not check_shard_guidance(3, 8)


def test_tokenizer_batches(staged_files):
    store = cpu_store()
    pool = IngestWorkerPool(store, n_workers=2)
    for p in staged_files:
        pool.submit_file(p)
    pool.drain(timeout_s=120)
    tok = EventTokenizer(store, vocab_size=8192)
    assert tok.tokens_per_event == 14
    batch = next(tok.sequences(0, 7200, seq_len=64, batch=4))
    assert batch.shape == (4, 64)
    assert batch.dtype == np.int32
    assert batch.min() >= 0 and batch.max() < 8192
    with pytest.raises(ValueError, match="vocab too small"):
        EventTokenizer(store, vocab_size=300)
    empty = next(EventTokenizer(cpu_store(), vocab_size=8192).sequences(0, 10, 8, 2))
    assert (empty == 1).all()


def test_ingest_metrics_are_the_reference_registry_view():
    assert IngestMetrics._FIELDS == jingest.IngestMetrics._FIELDS
    a, b = IngestMetrics(), IngestMetrics()
    assert a._label != b._label
    a.rows += 5
    a.blocked_seconds += 0.25
    assert (a.rows, b.rows, a.blocked_seconds) == (5, 0, 0.25)
    from repro_torch.obs import get_registry

    assert get_registry().counter("ingest_rows_total").value(writer=a._label) == 5
    assert isinstance(WorkerReport("w").metrics, IngestMetrics)


@pytest.mark.parametrize("bucket_s", [0.25, 0.1, 1.0])
def test_rate_series_matches_reference(bucket_s):
    rng = np.random.default_rng(3)
    ours, ref = [IngestMetrics() for _ in range(3)], [jingest.IngestMetrics() for _ in range(3)]
    for m, j in zip(ours, ref):
        t = np.sort(rng.uniform(100.0, 103.0, 40))
        t[::7] = 100.0 + np.round((t[::7] - 100.0) / bucket_s) * bucket_s  # on edges
        samples = [(float(x), int(n)) for x, n in zip(t, rng.integers(1, 5000, 40))]
        m.samples, j.samples = list(samples), list(samples)
    got, want = rate_series(ours, bucket_s), jingest.rate_series(ref, bucket_s)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    empty = rate_series([IngestMetrics()])
    assert empty[0].size == 0 and empty[1].size == 0


def test_one_worker_ingest_equals_the_reference_store(tmp_path):
    """W = 1: the same files through both packages' pools give equal host
    tablets run for run (minor and major compactions included), equal
    compaction counters, and equal tokenizer batches."""
    paths = stage(tmp_path, SyntheticWebProxySource, "port")
    kw = dict(n_shards=4, flush_rows=1024, max_runs=3)
    ps = cpu_store(**kw)
    js = jcore.EventStore(jcore.web_proxy_schema(), **kw)
    for store, pool_cls in ((ps, IngestWorkerPool), (js, jpipeline.IngestWorkerPool)):
        pool = pool_cls(store, n_workers=1, batch_rows=2048)
        for p in paths:
            pool.submit_file(p)
        pool.drain(timeout_s=120)
    assert ps.backpressure_stats() == js.backpressure_stats()

    def same_tablets():
        pairs = list(zip(ps.event_tablets + ps.index_tablets + [ps.agg_tablet],
                         js.event_tablets + js.index_tablets + [js.agg_tablet]))
        for pt, jt in pairs:
            assert (pt.minor_compactions, pt.major_compactions) == (
                jt.minor_compactions, jt.major_compactions)
            assert len(pt.runs) == len(jt.runs)
            for pr, jr in zip(pt.runs, jt.runs):
                assert pr.keys.dtype == jr.keys.dtype and pr.cols.dtype == jr.cols.dtype
                np.testing.assert_array_equal(pr.keys, jr.keys)
                np.testing.assert_array_equal(pr.cols, jr.cols)
        return sum(pt.major_compactions for pt, _ in pairs)

    assert same_tablets() > 0
    pt_it = EventTokenizer(ps, vocab_size=4096).sequences(0, 7200, seq_len=56, batch=3)
    jt_it = JEventTokenizer(js, vocab_size=4096).sequences(0, 7200, seq_len=56, batch=3)
    for _ in range(5):
        np.testing.assert_array_equal(next(pt_it), next(jt_it))
    ps.compact_all()
    js.compact_all()
    same_tablets()


def test_store_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EventStore(web_proxy_schema())
    assert cpu_store().device == torch.device("cpu")
    assert all(t.device == torch.device("cpu") for t in cpu_store().index_tablets)
