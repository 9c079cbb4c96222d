"""The plain reference against answers worked out by hand, row by row in
plain Python, on a few hundred events."""
import numpy as np
import pytest
import torch

from bench import reference

CPU = torch.device("cpu")
F = 4  # fields of the hand-made events


@pytest.fixture(scope="module")
def events():
    rng = np.random.default_rng(5)
    n = 300
    ts = np.sort(rng.integers(0, 4 * 3600, n))
    cols = np.stack([rng.integers(0, 5, n), rng.integers(0, 3, n), rng.integers(0, 40, n),
                     rng.integers(0, 7, n)], axis=1).astype(np.int32)
    tab = rng.integers(0, 4, n)
    return ts, cols, tab


def passes(pred, row):
    op = pred[0]
    if op == "true":
        return True
    if op == "eq":
        return row[pred[1]] == pred[2]
    if op == "in":
        return row[pred[1]] in set(int(c) for c in pred[2])
    parts = [passes(p, row) for p in pred[1:]]
    return all(parts) if op == "and" else any(parts)


PREDS = [("true",), ("eq", 0, 2), ("in", 2, np.array([1, 5, 9, 33])),
         ("and", ("eq", 0, 1), ("eq", 1, 2)), ("or", ("eq", 3, 6), ("eq", 3, 0))]


@pytest.mark.parametrize("pred", PREDS, ids=lambda p: p[0])
def test_counts_and_densities(events, pred):
    ts, cols, tab = events
    q = reference.QueryReference(ts, cols, tab, {}, {}, CPU)
    for lo, hi in [(0, 14399), (100, 5000), (3600, 7199), (9000, 8000), (1234, 1234)]:
        want = sum(1 for t, r in zip(ts, cols) if lo <= t <= hi and passes(pred, r))
        assert q.count(pred, lo, hi) == want
    dens = sum(1 for t, r in zip(ts, cols) if 3600 <= t <= 10799 and r[0] == 3)
    assert q.density(0, 3, 4000, 9000, 3600) == dens
    assert q.density(0, None, 4000, 9000, 3600) == 0


def test_batch_rows(events):
    ts, cols, tab = events
    q = reference.QueryReference(ts, cols, tab, {}, {}, CPU)
    pred, lo, hi, k = ("eq", 1, 0), 600, 12000, 3
    by_tab = {}
    for t, r, b in zip(ts, cols, tab):
        if lo <= t <= hi and passes(pred, r):
            by_tab.setdefault(b, []).append((t, tuple(r)))
    rows = [x for v in by_tab.values() for x in sorted(v, key=lambda x: -x[0])[:k]]
    got_ts = np.array([t for t, _ in rows])
    got_cols = np.array([r for _, r in rows], np.int32)
    assert q.batch_off(pred, lo, hi, k, got_ts, got_cols) == 0
    assert q.batch_off(pred, lo, hi, k, got_ts[1:], got_cols[1:]) == 1  # one row short
    bad = got_cols.copy()
    bad[0, 3] += 100  # a row no event has
    assert q.batch_off(pred, lo, hi, k, got_ts, bad) == 1
    older = got_ts.copy()
    older[0] -= 1  # not among its tablet's k newest
    assert q.batch_off(pred, lo, hi, k, older, got_cols) >= 2


@pytest.mark.parametrize("op", ["count", "sum", "min", "max"])
@pytest.mark.parametrize("bucket_s", [None, 3600])
def test_aggregates(events, op, bucket_s):
    ts, cols, tab = events
    values = np.arange(40, dtype=np.int64) * 1000 + 7  # field 2's numeric values
    q = reference.QueryReference(ts, cols, tab, {2: values}, {0: 5, 1: 3}, CPU)
    t0, t1 = 1800, 12000
    pred = ("eq", 3, 4)
    groups = {}
    for t, r in zip(ts, cols):
        if not (t0 <= t <= t1 and passes(pred, r)):
            continue
        nb = 1 if bucket_s is None else t1 // bucket_s - t0 // bucket_s + 1
        b = 0 if bucket_s is None else t // bucket_s - t0 // bucket_s
        gid = (int(r[0]) * 3 + int(r[1])) * nb + b
        groups.setdefault(gid, []).append(int(values[r[2]]))
    gids = sorted(groups)
    agg = {"count": len, "sum": sum, "min": min, "max": max}[op]
    want = (np.array(gids), np.array([agg(groups[g]) for g in gids]),
            np.array([len(groups[g]) for g in gids]))
    got = q.aggregate(pred, [0, 1], op, None if op == "count" else 2, bucket_s, t0, t1)
    assert reference.aggregate_off(got, want) == 0
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    wrong = (want[0], want[1] + (np.arange(len(gids)) == 0), want[2])
    assert reference.aggregate_off(wrong, want) == 1
    assert reference.aggregate_off((want[0][1:], want[1][1:], want[2][1:]), want) == 1


def test_store_tables(events):
    ts, cols, tab = events
    ref = reference.StoreReference(ts, cols, tab, 3600, CPU)
    rows = {(int(b), (1 << 30) - 1 - int(t), *map(int, r)) for t, r, b in zip(ts, cols, tab)}
    got = {tuple(r) for r in ref.event_rows().tolist()}
    assert got == rows
    ix, ag = set(), {}
    for t, r, b in zip(ts, cols, tab):
        for f in range(F):
            base = (int(b) << 56) | (f << 52) | (int(r[f]) << 30)
            ix.add(base | ((1 << 30) - 1 - int(t)))
            ag[base | (int(t) // 3600)] = ag.get(base | (int(t) // 3600), 0) + 1
    assert set(ref.index_keys().tolist()) == ix
    k, c = ref.aggregate_counts()
    assert dict(zip(k.tolist(), c.tolist())) == ag


def _untag(tagged):
    return tagged >> reference.TAB_SHIFT, tagged & (reference.KEY_LIMIT - 1)


def test_plane_off_counts_every_difference(events):
    ts, cols, tab = events
    ref = reference.StoreReference(ts, cols, tab, 3600, CPU)
    ev_rows = ref.event_rows()
    ix_tab, ix_keys = _untag(ref.index_keys())
    ag_k, ag_c = ref.aggregate_counts()
    ag_tab, ag_keys = _untag(ag_k)
    # Levels may repeat an index key, and split an aggregate count.
    ix_tab2, ix_keys2 = torch.cat([ix_tab, ix_tab[:5]]), torch.cat([ix_keys, ix_keys[:5]])
    ag_c2 = ag_c.clone()
    ag_c2[0] -= 1
    whole = dict(ev_rows=ev_rows, ix_tab=ix_tab2, ix_keys=ix_keys2,
                 ag_tab=torch.cat([ag_tab, ag_tab[:1]]), ag_keys=torch.cat([ag_keys, ag_keys[:1]]),
                 ag_counts=torch.cat([ag_c2, torch.ones(1, dtype=ag_c.dtype)]), levels=[])
    assert reference.plane_off(ref, **whole) == {"ev_rows_off": 0, "ix_keys_off": 0,
                                                  "ag_sums_off": 0, "level_order_off": 0,
                                                  "combined_repeats_off": 0}
    bad = dict(whole, ev_rows=ev_rows[1:], ix_keys=ix_keys2 + (ix_keys2 == ix_keys2[7]),
               ag_counts=whole["ag_counts"] * 1)
    bad["ag_counts"][3] += 2
    off = reference.plane_off(ref, **bad)
    assert off["ev_rows_off"] == 1 and off["ix_keys_off"] >= 1 and off["ag_sums_off"] == 1
    assert reference.plane_off(ref, **dict(whole, ix_keys=ix_keys2 - (1 << 60)))["ix_keys_off"] > 0


def test_level_faults_count_disorder_and_repeats():
    keys = torch.tensor([[1, 3, 3, 7, 0], [2, 5, 4, 9, 9], [6, 6, 1, 0, 0]])
    live = torch.tensor([4, 5, 2])  # past a slab's live count nothing is read
    # Slab 1 steps down once (5 -> 4); repeats: slab 0's 3, 3, slab 1's 9, 9, slab 2's 6, 6.
    assert reference.level_faults([("ix", False, keys, live)]) == {
        "level_order_off": 1, "combined_repeats_off": 0}
    assert reference.level_faults([("ix", True, keys, live)]) == {
        "level_order_off": 1, "combined_repeats_off": 3}
    assert reference.level_faults([("ag", True, keys[:, :1], live)]) == {
        "level_order_off": 0, "combined_repeats_off": 0}


def test_multiset_diff_counts_multiplicity():
    a = torch.tensor([[1, 2], [1, 2], [3, 4]])
    assert reference.multiset_diff(a, a.clone()) == 0
    assert reference.multiset_diff(a, a[1:]) == 1
    assert reference.multiset_diff(a, torch.tensor([[1, 2], [3, 5], [3, 4]])) == 2
    assert reference.multiset_diff(a[:0], a) == 3
