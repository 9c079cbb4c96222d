"""The port's combiner-on-compaction, ``combine_compact``, against the JAX
package's ``_combine_dup_keys`` plus the cut to the base's capacity
(src/repro/core/dist_ingest.py, the aggregate family's sums and the index
family's dedup).

Both get the same numpy-seeded rows of sorted, sentinel-tailed int64 keys
and counts. The port runs on the CPU, where the wrapper runs its plain
version; the reference runs one row at a time, as its plane's vmap does.
Every comparison is bit for bit with equal dtypes (the tolerance is
none). The kernel runs only on the card (tests/test_torch_gpu.py).
"""
import numpy as np
import pytest
import torch

from repro.core.dist_ingest import _combine_dup_keys as jax_combine_dup_keys

from repro_torch.kernels.aggregate_combine import combine_compact, combine_compact_ref

SENTINEL = int(np.iinfo(np.int64).max)


def assert_same(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def reference(keys, counts, cap, dedup=False):
    """The reference per row: _combine_dup_keys, then the [:cap] cut.
    The dedup form passes int32 zeros, as the reference's plane does."""
    out = []
    for r in range(keys.shape[0]):
        vals = np.zeros(keys.shape[1], np.int32) if dedup else counts[r]
        ukeys, sums, n_unique = jax_combine_dup_keys(keys[r], vals, SENTINEL)
        out.append((np.asarray(ukeys)[:cap], np.asarray(sums)[:cap], np.asarray(n_unique)))
    return out


def check_rows(keys, counts, cap):
    """combine_compact on the batch against the reference row by row, for
    the sum form and the dedup form."""
    n_live = torch.from_numpy((keys != SENTINEL).sum(axis=1).astype(np.int32))
    tk = torch.from_numpy(keys)
    ukeys, sums, n_unique = combine_compact(tk, torch.from_numpy(counts), n_live, cap, SENTINEL)
    assert ukeys.shape == sums.shape == (keys.shape[0], cap)
    for r, (wk, ws, wn) in enumerate(reference(keys, counts, cap)):
        assert_same(ukeys[r], wk)
        assert_same(sums[r], ws)
        assert_same(n_unique[r], wn)
    dk, dsums, dn = combine_compact(tk, None, n_live, cap, SENTINEL)
    assert dsums is None
    for r, (wk, _, wn) in enumerate(reference(keys, counts, cap, dedup=True)):
        assert_same(dk[r], wk)
        assert_same(dn[r], wn)
    return ukeys, sums, n_unique


def sorted_rows(rng, lives, n, nkeys, count_dtype=np.int64, count_hi=100):
    keys = np.full((len(lives), n), SENTINEL, np.int64)
    for r, live in enumerate(lives):
        keys[r, :live] = np.sort(rng.integers(0, nkeys, live)) + (3 << 40)
    counts = rng.integers(1, count_hi, keys.shape).astype(count_dtype)
    return keys, counts


@pytest.mark.parametrize("count_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("seed", range(3))
def test_random_rows_match_the_reference(seed, count_dtype):
    rng = np.random.default_rng(seed)
    n = 1500
    keys, counts = sorted_rows(rng, rng.integers(0, n + 1, 5), n, nkeys=200,
                               count_dtype=count_dtype)
    counts[keys == SENTINEL] = 0  # the plane's merges zero the tail's counts
    check_rows(keys, counts, cap=1200)


def test_a_row_that_is_all_sentinel():
    rng = np.random.default_rng(1)
    keys, counts = sorted_rows(rng, [0, 0, 700], 900, nkeys=40)
    ukeys, sums, n_unique = check_rows(keys, counts, cap=800)
    assert n_unique.tolist()[:2] == [0, 0]
    assert (ukeys[:2] == SENTINEL).all()
    # The sentinel segment's sum, every count of the row, sits at slot 0.
    assert sums[0, 0] == int(counts[0].sum()) and (sums[0, 1:] == 0).all()


def test_a_row_with_no_sentinel():
    rng = np.random.default_rng(2)
    keys, counts = sorted_rows(rng, [900, 900], 900, nkeys=900)
    _, _, n_unique = check_rows(keys, counts, cap=900)
    assert n_unique.tolist() == [len(np.unique(keys[0])), len(np.unique(keys[1]))]


def test_one_key_spans_several_512_entry_tiles():
    rng = np.random.default_rng(3)
    n = 4096
    keys, counts = sorted_rows(rng, [3000, 4096], n, nkeys=5)
    keys[0, 100:2600] = keys[0, 100]  # one key over entries 100..2599
    keys[1, :] = 7  # one key over the whole row
    check_rows(keys, counts, cap=2048)


def test_nonzero_counts_in_the_tail_sum_at_slot_n_unique():
    rng = np.random.default_rng(4)
    keys, counts = sorted_rows(rng, [10, 500, 1023], 1024, nkeys=30)
    ukeys, sums, n_unique = check_rows(keys, counts, cap=1000)
    for r in range(3):
        u = int(n_unique[r])
        assert ukeys[r, u] == SENTINEL
        assert sums[r, u] == int(counts[r][keys[r] == SENTINEL].sum())


def test_counts_near_2_to_the_40():
    rng = np.random.default_rng(5)
    keys, _ = sorted_rows(rng, [600, 1000, 0], 1200, nkeys=20)
    counts = rng.integers((1 << 40) - 1000, (1 << 40) + 1000, keys.shape).astype(np.int64)
    _, sums, _ = check_rows(keys, counts, cap=1100)
    assert int(sums.max()) > 1 << 45  # the sums are exact past int32 and past 2**40


def test_more_unique_keys_than_the_cap():
    """total > cap: the output keeps the first cap keys, and n_unique counts
    them all (the plane books the rest as overflow)."""
    rng = np.random.default_rng(6)
    keys, counts = sorted_rows(rng, [2000, 1500, 300], 2000, nkeys=1 << 30)
    ukeys, _, n_unique = check_rows(keys, counts, cap=1024)
    assert int(n_unique[0]) > 1024 and int(n_unique[1]) > 1024
    assert (ukeys[:2] != SENTINEL).all()


def test_the_dedup_form_with_zero_counts():
    """The index family's dedup: the reference passes int32 zeros and
    discards the sums; the port passes no counts and gets no sums."""
    rng = np.random.default_rng(7)
    keys, _ = sorted_rows(rng, [0, 33, 1100, 1100], 1100, nkeys=400)
    n_live = torch.from_numpy((keys != SENTINEL).sum(axis=1).astype(np.int32))
    ukeys, sums, n_unique = combine_compact(torch.from_numpy(keys), None, n_live, 1000, SENTINEL)
    assert sums is None
    for r, (wk, ws, wn) in enumerate(reference(keys, None, 1000, dedup=True)):
        assert_same(ukeys[r], wk)
        assert_same(n_unique[r], wn)
        assert not ws.any()


def test_keys_past_n_live_count_as_the_sentinel():
    """Whatever a row holds past n_live, it combines as the sentinel."""
    rng = np.random.default_rng(8)
    keys, counts = sorted_rows(rng, [40, 300], 400, nkeys=50)
    junk = keys.copy()
    junk[0, 40:] = 5
    junk[1, 300:] = rng.integers(0, 1 << 50, 100)
    n_live = torch.tensor([40, 300], dtype=torch.int32)
    got = combine_compact(torch.from_numpy(junk), torch.from_numpy(counts), n_live, 350, SENTINEL)
    want = combine_compact(torch.from_numpy(keys), torch.from_numpy(counts), n_live, 350,
                           SENTINEL)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_the_wrapper_runs_the_plain_version_on_cpu_tensors():
    rng = np.random.default_rng(9)
    keys, counts = sorted_rows(rng, [100, 250], 300, nkeys=60)
    args = (torch.from_numpy(keys), torch.from_numpy(counts),
            torch.tensor([100, 250], dtype=torch.int32), 280, SENTINEL)
    for g, w in zip(combine_compact(*args), combine_compact_ref(*args)):
        assert torch.equal(g, w)


def test_combine_compact_rejects_what_the_kernel_does_not_take():
    k = torch.zeros((2, 3), dtype=torch.int64)
    live = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        combine_compact(k.to(torch.int32), k, live, 3, SENTINEL)
    with pytest.raises(TypeError):
        combine_compact(k, k.to(torch.int16), live, 3, SENTINEL)
    with pytest.raises(ValueError):
        combine_compact(k, k[:, :2], live, 3, SENTINEL)
    with pytest.raises(ValueError):
        combine_compact(k, k, live[:1], 3, SENTINEL)
    with pytest.raises(ValueError):
        combine_compact(k, k, live, 4, SENTINEL)
