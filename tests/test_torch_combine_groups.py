"""combine_scan's group form against the JAX package's host op.

``combine_groups`` (on the CPU, its plain version) and the port's host op
``combine_scan(..., device="cpu")``, which returns what combine_groups
gives, are held to ``repro.kernels.combine_scan.combine_scan`` with both
of its backends: ``ref`` and ``pallas`` in interpret mode, as
tests/test_torch_aggregate.py runs it. Every case of
tests/_torch_combine_cases.py under a trivial, an Eq and an In program,
for the four ops. The inputs are integers made with numpy from a seed,
so every comparison is exact with equal dtypes (the tolerance is none).
The prepared program's membership bitmaps, which the kernels read for
large In sets, are held to their sets here too; the kernel itself runs
on the card (tests/test_torch_gpu.py).
"""
import numpy as np
import pytest
import torch

from repro.core import filter as jf
from repro.kernels.combine_scan import combine_scan as jax_combine_scan

from repro_torch.core import filter as pf
from repro_torch.kernels import program_eval
from repro_torch.kernels.combine_scan import (
    combine_groups,
    combine_groups_ref,
    combine_scan,
    combine_scan_ref,
)
from repro_torch.kernels.filter_scan import program_tensors

from _torch_combine_cases import CASES, case_rows, filter_program, in_codes

OPS = ["count", "sum", "min", "max"]
PROGRAMS = ["trivial", "eq", "in"]


def assert_same(got, want):
    """Arrays bit for bit with equal dtypes."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", PROGRAMS)
@pytest.mark.parametrize("case", CASES)
def test_combine_groups_matches_both_reference_backends(case, kind):
    gids, vals, cols = case_rows(case)
    codes = in_codes()
    jprog, pprog = (filter_program(m, kind, codes) for m in (jf, pf))
    program = program_tensors(pprog, "cpu")
    rows = [torch.from_numpy(x) for x in (gids, vals, cols)]
    for op in OPS:
        wants = [jax_combine_scan(gids, vals, cols, jprog, op=op, backend=backend)
                 for backend in ("ref", "pallas")]
        *got, n = combine_groups(rows[0], None if op == "count" else rows[1], rows[2],
                                 program, op)
        assert n.dtype == torch.int64 and n.shape == () and int(n) == len(wants[0][0])
        host = combine_scan(gids, vals, cols, pprog, op=op, device="cpu")
        for want in wants:
            for g, h, w in zip(got, host, want):
                assert_same(g[:int(n)].numpy(), w)
                assert_same(h, w)
    if case == "all_fail" and kind != "trivial":
        assert int(n) == 0
    if case == "empty_between" and kind != "trivial":
        assert (np.asarray(got[0][:int(n)]) % 2 == 0).all() and int(n) > 1


def test_combine_groups_ref_is_the_per_row_form_compacted():
    """The group form keeps exactly the heads with a matching row of the
    per-row form (the TPU kernel's), in row order."""
    gids, vals, cols = (torch.from_numpy(x) for x in case_rows("empty_between", seed=3))
    program = program_tensors(filter_program(pf, "eq"), "cpu")
    for op in OPS:
        heads, aggs, cnts = combine_scan_ref(gids, vals, cols, *program, op)
        keys, g_aggs, g_cnts, n = combine_groups_ref(gids, vals, cols, *program, op)
        keep = heads & (cnts > 0)
        assert int(n) == int(keep.sum()) and 0 < int(n) < int(heads.sum())
        for g, w in ((keys, gids[keep]), (g_aggs, aggs[keep]), (g_cnts, cnts[keep])):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_combine_groups_takes_the_original_form_and_refuses_bad_arguments():
    gids, vals, cols = (torch.from_numpy(x) for x in case_rows("straddle", seed=4))
    prog = filter_program(pf, "in", in_codes())
    program = program_tensors(prog, "cpu")
    *got, n = combine_groups(gids, vals, cols, *program, "sum")
    *want, m = combine_groups(gids, vals, cols, program, "sum")
    assert int(n) == int(m) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        combine_groups(gids, None, cols, program, "sum")
    with pytest.raises(ValueError):
        combine_groups(gids, vals, cols, program, "mean")
    with pytest.raises(ValueError):
        combine_groups(gids.int(), vals, cols, program, "sum")


def bitmap_members(program, s, codes):
    """Membership of codes in set s read from the prepared words as
    csrc/program_eval.cuh reads it: the bitmap offsets after the codes,
    bit c % 32 of word c // 32, nothing negative or past the end."""
    words = program.words.numpy()
    table = program.header_words + program.n_codes
    b0, b1 = words[table + s], words[table + s + 1]
    bitmap = words[b0:b1].view(np.uint32)
    inside = (codes >= 0) & (codes < 32 * len(bitmap))
    c = np.where(inside, codes, 0)
    return inside & (((bitmap[c >> 5] >> (c & 31).astype(np.uint32)) & 1) == 1)


def test_prepared_bitmaps_answer_their_sets():
    """Past SHARED_PROGRAM_BYTES every set gets a bitmap over [0, its
    largest code]; the bitmap holds its members and nothing else,
    negative codes and codes past its end included."""
    rng = np.random.default_rng(9)
    big = rng.choice(1 << 20, 30_000, replace=False).astype(np.int32)
    small = np.asarray([5, 64, 3, 31, 32], np.int32)
    sets = np.full((2, 32768), -1, np.int32)
    sets[0, :5], sets[1, :30_000] = small, big
    program = program_eval.prepare_program([2, 2, 4], [3, 4, 0], [0, 1, 0], sets, "cpu")
    assert program.nbytes > program_eval.SHARED_PROGRAM_BYTES
    assert program.n_bitmap_words == (64 // 32 + 1) + (int(big.max()) // 32 + 1)
    for s, members in enumerate((small, big)):
        top = int(members.max())
        probe = np.concatenate([members, rng.integers(0, top + 1, 5000),
                                [-1, -2**31, top + 1, top + 32, top + 1000, 2**31 - 1]])
        probe = probe.astype(np.int32)
        assert (bitmap_members(program, s, probe) == np.isin(probe, members)).all()
    # The prepared form still answers as the original form.
    cols = torch.from_numpy(rng.integers(-1, 1 << 20, (3000, 6)).astype(np.int32))
    cols[::7, 3] = torch.from_numpy(rng.choice(small, 429))
    cols[::5, 4] = torch.from_numpy(rng.choice(big, 600))
    mask = program_eval.program_eval_rows(cols, *program)
    want = np.isin(cols[:, 3].numpy(), small) & np.isin(cols[:, 4].numpy(), big)
    assert 0 < int(mask.sum()) and (mask.numpy() == want).all()


def test_bitmaps_only_past_shared_memory_and_under_their_cap(monkeypatch):
    codes = np.arange(0, 40_000, 2, dtype=np.int32)[None]
    small = program_eval.prepare_program([2], [0], [0], codes[:, :1000], "cpu")
    assert small.n_bitmap_words == 0  # staged whole in shared memory: searched there
    big = program_eval.prepare_program([2], [0], [0], codes, "cpu")
    assert big.n_bitmap_words == 39_998 // 32 + 1
    monkeypatch.setattr(program_eval, "BITMAP_MAX_BYTES", 4 * (39_998 // 32))
    capped = program_eval.prepare_program([2], [0], [0], codes, "cpu")
    assert capped.n_bitmap_words == 0  # searched in global memory
    assert torch.equal(capped.words[:capped.header_words + capped.n_codes],
                       big.words[:big.header_words + big.n_codes])
