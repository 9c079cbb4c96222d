"""The port's kernel wrappers against the JAX reference kernels.

On the CPU the wrappers run their plain versions; these tests hold those
to the reference's Pallas kernels (interpret mode) and jnp references on
the same numpy-seeded inputs, bit for bit and with equal dtypes (the
tolerance is none: every value is an integer or a bool). The CUDA
kernels themselves are held to the same plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.common import split_key_lanes
from repro.kernels.filter_scan import filter_scan as jax_filter_scan
from repro.kernels.merge_intersect import member_mask_keys as jax_member_mask_keys
from repro.kernels.merge_intersect.merge_intersect import intersect_mask_pallas
from repro.kernels.merge_runs import (
    merge_pair_device as jax_merge_pair_device,
    merge_ranks_pallas,
    merge_ranks_ref as jax_merge_ranks_ref,
    merge_sorted_device as jax_merge_sorted_device,
    merge_sorted_runs as jax_merge_sorted_runs,
)
from repro.kernels.program_eval import program_eval_rows as jax_program_eval_rows
from repro.core import EventStore as JaxEventStore, web_proxy_schema as jax_schema
from repro.core import And as JAnd, Eq as JEq, In as JIn, Not as JNot, Or as JOr
from repro.core.filter import compile_tree as jax_compile_tree

from repro_torch.core import filter as pf
from repro_torch.core.schema import web_proxy_schema
from repro_torch.core.store import EventStore
from repro_torch.kernels.filter_scan import filter_scan, pad_program
from repro_torch.kernels.merge_intersect import member_mask, member_mask_keys
from repro_torch.kernels.merge_runs import (
    merge_pair_device,
    merge_ranks,
    merge_ranks_ref,
    merge_sorted_device,
    merge_sorted_runs,
)
from repro_torch.kernels.program_eval import program_eval_rows


def sorted_runs(rng, b, k, r, dtype, hi=40):
    """(b, k, r) runs sorted ascending with heavy duplicates, each filled
    to a random length (some empty, some full) and sentinel-padded."""
    sentinel = np.iinfo(dtype).max
    keys = np.full((b, k, r), sentinel, dtype)
    for i in range(b):
        for j in range(k):
            n = [0, r, int(rng.integers(0, r + 1))][(i + j) % 3]
            base = 1 << 40 if dtype == np.int64 else 0
            keys[i, j, :n] = np.sort(rng.integers(0, hi, n)) + base
    return keys


def flat_runs(keys):
    """(b, k, r) sentinel-padded runs as the port's merge_ranks takes them:
    (b, k*r) keys, run bounds and int32 (b, k) live lengths."""
    b, k, r = keys.shape
    lengths = (keys != np.iinfo(keys.dtype).max).sum(axis=-1).astype(np.int32)
    return (torch.from_numpy(keys.reshape(b, k * r)), [o * r for o in range(k + 1)],
            torch.from_numpy(lengths))


def jax_lanes(keys):
    if keys.dtype == np.int32:
        return np.zeros_like(keys), keys
    hi, lo = split_key_lanes(keys.reshape(-1))
    return hi.reshape(keys.shape), lo.reshape(keys.shape)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_ranks_match_pallas_and_jnp_reference(dtype, seed):
    rng = np.random.default_rng(seed)
    keys = sorted_runs(rng, 3, 3, 32, dtype)
    got = merge_ranks(*flat_runs(keys))
    assert got.dtype == torch.int32 and got.shape == (3, 3 * 32)
    got = got.reshape(keys.shape)
    for b in range(keys.shape[0]):
        hi, lo = jax_lanes(keys[b])
        want = np.asarray(merge_ranks_pallas(jnp.asarray(hi), jnp.asarray(lo), interpret=True))
        np.testing.assert_array_equal(got[b].numpy(), want)
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(jax_merge_ranks_ref(jnp.asarray(hi), jnp.asarray(lo))))
        # A permutation of [0, K*R): the scatter after it is exact.
        assert sorted(got[b].reshape(-1).tolist()) == list(range(keys[b].size))


def test_merge_ranks_ref_is_the_cpu_path():
    keys, bounds, lengths = flat_runs(sorted_runs(np.random.default_rng(9), 2, 4, 17, np.int64))
    assert torch.equal(merge_ranks(keys, bounds, lengths), merge_ranks_ref(keys, bounds, lengths))
    with pytest.raises(TypeError):
        merge_ranks(keys.to(torch.float32), bounds, lengths)
    with pytest.raises(ValueError):
        merge_ranks(keys[0], bounds, lengths)
    with pytest.raises(ValueError):
        merge_ranks(keys, bounds[:-1], lengths)
    with pytest.raises(ValueError):
        merge_ranks(keys, bounds, lengths.to(torch.int64))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_merge_ranks_ragged_runs_ignore_entries_past_their_length(dtype):
    # Runs of different capacities back to back, with stale values (not
    # the sentinel) past each live length: the ranks equal those of the
    # same live runs sentinel-padded to one width, as the reference takes
    # them.
    rng = np.random.default_rng(11)
    caps, r = [5, 40, 17], 40
    padded = sorted_runs(rng, 4, 3, r, dtype)
    lengths = (padded != np.iinfo(dtype).max).sum(axis=-1)
    lengths = np.minimum(lengths, caps).astype(np.int32)
    for o, cap in enumerate(caps):
        padded[:, o, cap:] = np.iinfo(dtype).max
    bounds = np.concatenate([[0], np.cumsum(caps)]).tolist()
    ragged = np.concatenate([padded[:, o, :cap] for o, cap in enumerate(caps)], axis=1)
    stale = ragged.copy()
    for o in range(3):
        for b in range(4):
            stale[b, bounds[o] + lengths[b, o]: bounds[o + 1]] = -7
    got = merge_ranks(torch.from_numpy(stale), bounds, torch.from_numpy(lengths))
    assert sorted(got[0].tolist()) == list(range(bounds[-1]))
    for b in range(4):
        hi, lo = jax_lanes(padded[b])
        want = np.asarray(jax_merge_ranks_ref(jnp.asarray(hi), jnp.asarray(lo)))
        # The reference ranks the padded (3, r) grid; its live ranks are the
        # ragged ones, and the dead entries follow in (run, index) order.
        live = np.arange(r)[None, :] < lengths[b][:, None]
        got_b = np.concatenate([got[b, bounds[o]: bounds[o + 1]].numpy()
                                for o in range(3)])
        np.testing.assert_array_equal(
            got_b[np.concatenate([live[o, :cap] for o, cap in enumerate(caps)])],
            want[live])
        n_live = int(lengths[b].sum())
        dead = got_b[~np.concatenate([live[o, :cap] for o, cap in enumerate(caps)])]
        np.testing.assert_array_equal(dead, np.arange(n_live, bounds[-1]))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("width", [0, 1, 3])
def test_merge_sorted_device_matches_reference(dtype, width):
    rng = np.random.default_rng(4 + width)
    keys = sorted_runs(rng, 3, 4, 24, dtype)
    cols = rng.integers(0, 1000, keys.shape + (width,)).astype(np.int32)
    lengths = torch.from_numpy((keys != np.iinfo(dtype).max).sum(axis=-1).astype(np.int32))
    mk, mc = merge_sorted_device(torch.from_numpy(keys), torch.from_numpy(cols), lengths)
    assert mk.dtype == torch.from_numpy(keys).dtype and mc.shape == (3, 4 * 24, width)
    for b in range(3):
        wk, wc = jax_merge_sorted_device(jnp.asarray(keys[b]), jnp.asarray(cols[b]), backend="ref")
        np.testing.assert_array_equal(mk[b].numpy(), np.asarray(wk))
        np.testing.assert_array_equal(mc[b].numpy(), np.asarray(wc))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("sizes", [(40, 12), (12, 40), (33, 33)])
def test_merge_pair_device_matches_reference(dtype, sizes):
    ca, cb = sizes
    rng = np.random.default_rng(ca * cb)
    a = sorted_runs(rng, 3, 1, ca, dtype)[:, 0]
    b = sorted_runs(rng, 3, 1, cb, dtype)[:, 0]
    # Callers mask stale slots: sentinel entries carry zero cols.
    ac = np.where(a[..., None] == np.iinfo(dtype).max, 0, rng.integers(1, 9, (3, ca, 2)))
    bc = np.where(b[..., None] == np.iinfo(dtype).max, 0, rng.integers(1, 9, (3, cb, 2)))
    a_n, b_n = ((x != np.iinfo(dtype).max).sum(axis=-1).astype(np.int32) for x in (a, b))
    mk, mc = merge_pair_device(*(torch.from_numpy(x) for x in (a, ac, a_n, b, bc, b_n)))
    assert mk.shape == (3, ca + cb) and mc.dtype == torch.int64
    for i in range(3):
        wk, wc = jax_merge_pair_device(jnp.asarray(a[i]), jnp.asarray(ac[i]),
                                       jnp.asarray(b[i]), jnp.asarray(bc[i]), backend="ref")
        np.testing.assert_array_equal(mk[i].numpy(), np.asarray(wk))
        np.testing.assert_array_equal(mc[i].numpy(), np.asarray(wc))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_sorted_runs_matches_reference(seed):
    rng = np.random.default_rng(seed)
    runs = []
    for _ in range(int(rng.integers(1, 5))):
        n = int(rng.integers(0, 30))
        runs.append((np.sort(rng.integers(0, 50, n)).astype(np.int64) + (1 << 50),
                     rng.integers(0, 100, (n, 3)).astype(np.int32)))
    runs.append((np.arange(3, dtype=np.int64), np.ones((3, 3), np.int32)))
    gk, gc = merge_sorted_runs(runs, device="cpu")
    wk, wc = jax_merge_sorted_runs(runs, backend="ref")
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gc, wc)
    assert gc.dtype == wc.dtype


def test_merge_sorted_runs_keeps_width_when_every_run_is_empty():
    # Named divergence: the reference returns cols of shape (0, 0) when every
    # run is empty (src/repro/kernels/merge_runs/ops.py:42-44); the port keeps
    # the payload width.
    runs = [(np.empty(0, np.int64), np.empty((0, 3), np.int32))] * 2
    gk, gc = merge_sorted_runs(runs, device="cpu")
    wk, wc = jax_merge_sorted_runs(runs, backend="ref")
    assert gk.shape == wk.shape == (0,)
    assert gc.shape == (0, 3) and wc.shape == (0, 0)


# ------------------------------------------------------------- filter_scan
DOMAINS = ["a.com", "b.com", "c.com", "d.net", "e.org"]
METHODS = ["GET", "POST", "PUT"]
STATUS = ["200", "404", "500"]


@pytest.fixture(scope="module")
def stores():
    rng = np.random.default_rng(3)
    n = 700
    vals = {"domain": rng.choice(DOMAINS, n).tolist(), "method": rng.choice(METHODS, n).tolist(),
            "status": rng.choice(STATUS, n).tolist()}
    js, ps = JaxEventStore(jax_schema()), EventStore(web_proxy_schema(), device="cpu")
    cols = js.encode_events(np.zeros(n), vals)
    np.testing.assert_array_equal(ps.encode_events(np.zeros(n), vals), cols)
    return js, ps, cols


def random_tree(rng, depth, lib):
    """A random filter tree over domain/method/status with Eq, In (with a
    never-seen value), Not, And and Or; ``lib`` picks the node classes."""
    eq, in_, not_, and_, or_ = lib
    kind = rng.integers(0, 5 if depth > 0 else 2)
    field, values = [("domain", DOMAINS), ("method", METHODS), ("status", STATUS)][rng.integers(3)]
    if kind == 0:
        return eq(field, str(rng.choice(values + ["never-seen"])))
    if kind == 1:
        return in_(field, tuple(rng.choice(values, int(rng.integers(1, 3)))) + ("zzz",))
    if kind == 2:
        return not_(random_tree(rng, depth - 1, lib))
    kids = [random_tree(rng, depth - 1, lib) for _ in range(int(rng.integers(2, 4)))]
    return (and_ if kind == 3 else or_)(*kids)


JAX_LIB = (JEq, JIn, JNot, JAnd, JOr)
PORT_LIB = (pf.Eq, pf.In, pf.Not, pf.And, pf.Or)


def both_programs(seed, js, ps):
    jt = random_tree(np.random.default_rng(seed), 3, JAX_LIB)
    pt = random_tree(np.random.default_rng(seed), 3, PORT_LIB)
    return jax_compile_tree(js, jt), pf.compile_tree(ps, pt)


@pytest.mark.parametrize("seed", range(6))
def test_filter_scan_matches_pallas_and_program_eval(stores, seed):
    js, ps, cols = stores
    jprog, pprog = both_programs(seed, js, ps)
    padded = pad_program(pprog)
    program = tuple(torch.from_numpy(a) for a in padded)
    got = filter_scan(torch.from_numpy(cols), *program)
    assert got.dtype == torch.bool and got.shape == (cols.shape[0],)
    want_pallas = jax_filter_scan(cols, jprog, backend="pallas")
    want_eval = np.asarray(jax_program_eval_rows(jnp.asarray(cols), *map(jnp.asarray, padded)))
    np.testing.assert_array_equal(got.numpy(), want_pallas)
    np.testing.assert_array_equal(got.numpy(), want_eval)


def test_filter_scan_takes_leading_level_dims(stores):
    _, ps, cols = stores
    prog = pf.compile_tree(ps, pf.Or(pf.Eq("domain", "a.com"), pf.Not(pf.In("status", ("200",)))))
    program = tuple(torch.from_numpy(a) for a in pad_program(prog))
    flat = program_eval_rows(torch.from_numpy(cols), *program)
    shaped = filter_scan(torch.from_numpy(cols[:700]).reshape(7, 4, 25, -1), *program)
    assert shaped.shape == (7, 4, 25)
    assert torch.equal(shaped.reshape(-1), flat)
    with pytest.raises(TypeError):
        filter_scan(torch.from_numpy(cols).long(), *program)


# --------------------------------------------------------- merge_intersect
def membership_rows(rng, dtype, rows, n, m, edge):
    """(rows, n) probes and (rows, m) sorted sets with duplicates on both
    sides, about half the probes present; ``edge`` keys (0, 2**31 - 1, and
    for int64 2**53 - 1 and the INT64_MAX pad) are planted in both."""
    sentinel = np.iinfo(dtype).max
    a = np.empty((rows, n), dtype)
    b = np.full((rows, m), sentinel, dtype)
    for r in range(rows):
        live = [0, m, int(rng.integers(0, m + 1))][r % 3]  # empty, full, ragged
        pool = np.concatenate([rng.integers(0, 60, 2 * max(n, m)).astype(dtype),
                               np.asarray(edge, dtype)])
        b[r, :live] = np.sort(rng.choice(pool, live))
        a[r] = rng.choice(np.concatenate([pool, b[r]]), n)
    return a, b


EDGES = {np.int32: [0, 2**31 - 1], np.int64: [0, 2**31 - 1, 2**53 - 1, np.iinfo(np.int64).max]}


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("shape", [(1, 40, 16), (6, 33, 7), (3, 5, 64), (4, 0, 9), (4, 9, 0)])
def test_member_mask_matches_reference(dtype, shape):
    rows, n, m = shape
    a, b = membership_rows(np.random.default_rng(sum(shape)), dtype, rows, n, m, EDGES[dtype])
    got = member_mask_keys(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.bool and got.shape == (rows, n)
    assert torch.equal(member_mask(torch.from_numpy(a), torch.from_numpy(b)), got)
    for r in range(rows):
        if m == 0:
            assert not got[r].any()  # the reference cannot index an empty set
            continue
        want = np.asarray(jax_member_mask_keys(jnp.asarray(b[r]), jnp.asarray(b[r])))
        assert want.all()  # every key of a set is in it
        want = np.asarray(jax_member_mask_keys(jnp.asarray(a[r]), jnp.asarray(b[r])))
        np.testing.assert_array_equal(got[r].numpy(), want)
        np.testing.assert_array_equal(got[r].numpy(), np.isin(a[r], b[r]))


def test_member_mask_on_all_sentinel_rows_and_batched_dims():
    # Leading dims (2, 3) as (tablets, levels); one row of the set holds
    # only the sentinel, which is an ordinary value to the mask.
    rng = np.random.default_rng(5)
    a, b = membership_rows(rng, np.int32, 6, 21, 12, EDGES[np.int32])
    b[4] = np.iinfo(np.int32).max
    a[4, :3] = np.iinfo(np.int32).max
    got = member_mask(torch.from_numpy(a).reshape(2, 3, 21), torch.from_numpy(b).reshape(2, 3, 12))
    assert got.shape == (2, 3, 21)
    assert got.reshape(6, 21)[4].tolist() == [True] * 3 + [False] * 18
    for r in range(6):
        want = np.asarray(jax_member_mask_keys(jnp.asarray(a[r]), jnp.asarray(b[r])))
        np.testing.assert_array_equal(got.reshape(6, 21)[r].numpy(), want)


def test_member_mask_matches_the_pallas_kernel():
    # The TPU kernel on (hi, lo) lanes, interpret mode: A a multiple of its
    # block, B padded to a power of two with +INF in (hi, lo-unsigned) order.
    rng = np.random.default_rng(8)
    b = np.unique(np.concatenate([rng.integers(0, 1 << 52, 900), [0, 2**31 - 1, 2**53 - 1,
                                                                 (1 << 32) - 2]]))
    a = rng.choice(np.concatenate([b, rng.integers(0, 1 << 52, 900)]), 2048).astype(np.int64)
    got = member_mask(torch.from_numpy(a), torch.from_numpy(b))
    a_hi, a_lo = split_key_lanes(a)
    b_hi = np.full(1024, np.iinfo(np.int32).max, np.int32)
    b_lo = np.full(1024, -1, np.int32)
    b_hi[: b.size], b_lo[: b.size] = split_key_lanes(b)
    want = np.asarray(intersect_mask_pallas(*map(jnp.asarray, (a_hi, a_lo, b_hi, b_lo)),
                                            interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.any() and not got.all()


def test_member_mask_rejects_what_the_kernel_does_not_take():
    a = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(TypeError):
        member_mask(a, a.long())
    with pytest.raises(TypeError):
        member_mask(a.float(), a.float())
    with pytest.raises(ValueError):
        member_mask(a, torch.zeros((3, 5), dtype=torch.int32))
    with pytest.raises(ValueError):
        member_mask(torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.int32))
