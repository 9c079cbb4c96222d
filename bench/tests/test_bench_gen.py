"""The frozen generator: seeded, the paper's query tiers at cell size,
every code within the store's 22 bits, and the port writers' routing."""
import json

import numpy as np
import pytest

from bench import gen
from bench.tests.conftest import ROOT


def test_same_seed_same_codes_other_seed_other_codes():
    a = gen.make_events(2**31 + 5, 3000, 14400)
    b = gen.make_events(2**31 + 5, 3000, 14400)
    c = gen.make_events(2**31 + 6, 3000, 14400)
    assert np.array_equal(a.ts, b.ts) and np.array_equal(a.cols, b.cols)
    assert {f: list(k) for f, k in a.keys.items()} == {f: list(k) for f, k in b.keys.items()}
    assert not np.array_equal(a.cols, c.cols)
    assert a.ts.min() >= 0 and a.ts.max() <= 14399 and np.all(np.diff(a.ts) >= 0)


def test_vocabulary_is_in_code_order():
    ev = gen.make_events(11, 2000, 3600)
    for f in gen.FIELDS:
        vocab = ev.vocab(f)
        assert len(vocab) == len(set(vocab)) == int(ev.cols[:, gen.FID[f]].max()) + 1
        assert ev.value_code(f, vocab[-1]) == len(vocab) - 1
    assert all(v == str(k) for v, k in zip(ev.vocab("bytes_in"), ev.numeric("bytes_in")))


@pytest.fixture(scope="module")
def cell_size_events():
    """The stored span at cell size."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / manifest["configs"][0]["file"]).read_text())
    return gen.make_events(2**31 + 99, cfg["events"], cfg["span_s"])


def test_tiers_exist_at_cell_size(cell_size_events):
    tiers = gen.tiers(cell_size_events)
    assert set(tiers) == {"A", "B", "C"}
    (a, na), (b, nb), (c, nc) = tiers["A"], tiers["B"], tiers["C"]
    assert len({a, b, c}) == 3
    assert na > 5 * nb > 10 * nc >= 300
    dom = cell_size_events.cols[:, gen.FID["domain"]]
    assert [int(np.sum(dom == cell_size_events.code("domain", k))) for k in (a, b, c)] == \
        [na, nb, nc]


def test_tiers_ask_alike_for_every_seed(cell_size_events):
    """Another seed picks tiers of nearly the same counts: the queries' work
    does not move with the seed."""
    other = gen.make_events(2**32 + 9, len(cell_size_events.ts), cell_size_events.span_s)
    a, b = gen.tiers(cell_size_events), gen.tiers(other)
    assert a["A"][0] == b["A"][0] and a["B"][0] == b["B"][0]
    for t in "ABC":
        assert abs(a[t][1] - b[t][1]) <= 0.1 * a[t][1], (t, a[t], b[t])


def test_codes_fit_22_bits(cell_size_events):
    n_src = len(cell_size_events.keys["src_ip"])
    assert n_src == int(cell_size_events.cols[:, gen.FID["src_ip"]].max()) + 1
    assert n_src < 1 << gen.VALUE_BITS
    assert int(cell_size_events.cols.max()) < 1 << gen.VALUE_BITS


def test_row_hash_routes_as_a_port_writer():
    from repro_torch.core import keypack

    ev = gen.make_events(3, 5000, 3600)
    cols = [ev.cols[:, j] for j in range(ev.cols.shape[1])]
    nonce = np.arange(5000, dtype=np.int64)
    ours = gen.short_hash(*cols, ev.ts, nonce, np.int64(7))
    theirs = keypack.short_hash(*cols, ev.ts, nonce, np.int64(7))
    assert np.array_equal(ours, theirs)
    (stream,) = gen.writer_chunks(ev, np.arange(5000), 64, 1024, 1, writer_base=7)
    assert np.array_equal(np.concatenate([c.tab for c in stream]), theirs % 64)
    assert np.array_equal(np.concatenate([c.rts for c in stream]), keypack.rev_ts(ev.ts))


def test_balanced_draws_repeat_their_set_at_every_length():
    for n in (37, 100, 1000):
        a = np.sort(gen.balanced(np.random.default_rng(1), n, 2))
        b = np.sort(gen.balanced(np.random.default_rng(2), n, 2))
        assert np.abs(a - b).max() <= 2.0 / n
    doms = gen.domains_by_popularity(gen.balanced(np.random.default_rng(3), 1000, 3))
    assert abs(np.mean(doms == 0) - gen.domain_p()[0]) < 3e-3


def test_weighted_sequence_keeps_shares_in_every_prefix():
    shares = [40, 5, 5, 3, 9, 9, 9, 20]
    seq = gen.weighted_sequence(shares, 500)
    for n in (10, 37, 100, 500):
        counts = np.bincount(seq[:n], minlength=len(shares))
        assert np.all(np.abs(counts - np.array(shares) / 100 * n) < 1.0 + 1e-9)
