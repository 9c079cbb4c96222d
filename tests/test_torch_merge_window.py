"""merge_window_keys (the K-way merge by windows of output ranks) against
the JAX package's, on the CPU: each window equal to the reference's, and
consecutive windows concatenating to the full merge, for int32 and int64
keys padded with the dtype-max sentinel. Inputs are made with numpy from
a seed; comparisons are exact with equal dtypes."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.merge_runs import merge_window_keys as jax_merge_window_keys

from repro_torch.kernels.merge_runs import merge_window_keys


def padded_runs(rng, k, r, dtype, hi):
    """(k, r) rows sorted ascending with a random live length each, the
    rest the sentinel; some rows empty, some full, keys repeated."""
    sentinel = np.iinfo(dtype).max
    keys = np.full((k, r), sentinel, dtype)
    for i, m in enumerate(rng.integers(0, r + 1, k)):
        keys[i, :m] = np.sort(rng.integers(0, hi, m))
    keys[0, :] = np.sort(rng.integers(0, hi, r))
    if k > 1:
        keys[1, :] = sentinel
    return keys


@pytest.mark.parametrize("dtype,hi", [(np.int32, 50), (np.int32, 2**31 - 1),
                                      (np.int64, 2**40)])
@pytest.mark.parametrize("k,r,length", [(1, 17, 5), (4, 64, 64), (6, 100, 37), (3, 9, 40)])
def test_merge_window_keys_matches_the_reference(dtype, hi, k, r, length):
    rng = np.random.default_rng([k, r, length])
    keys = padded_runs(rng, k, r, dtype, hi)
    windows = []
    for start in range(0, k * r + length, length):
        got = merge_window_keys(torch.from_numpy(keys), start, length)
        want = np.asarray(jax_merge_window_keys(jnp.asarray(keys), start, length))
        assert got.numpy().dtype == want.dtype and got.shape == (length,)
        np.testing.assert_array_equal(got.numpy(), want)
        windows.append(got.numpy())
    merged = np.concatenate(windows)
    np.testing.assert_array_equal(merged[:k * r], np.sort(keys.reshape(-1), kind="stable"))
    assert (merged[k * r:] == np.iinfo(dtype).max).all()
