"""Inputs for the combine_scan tests of both packages: sorted group keys,
int32 values and (n, 12) codes made with numpy from a seed, and the
programs over them (numpy arrays, so the JAX and PyTorch FilterPrograms
are made from the same data). ``scale`` multiplies the row counts, so the
card's tests reach many tiles and chunks of the kernel."""
import numpy as np

F = 12
EQ_FIELD, IN_FIELD = 0, 3
IN_UNIVERSE = 200

CASES = ("one_group", "singletons", "straddle", "all_fail", "empty_between", "big_sums",
         "extremes", "empty")


def case_rows(name, seed=0, scale=1):
    """(group keys int64 (n,) ascending, values int32 (n,), codes int32
    (n, F)) of one case:

      one_group      one group over every row
      singletons     every group of one row
      straddle       groups of 300 to 2,000 rows across 512- and 1,024-row tiles
      all_fail       no row passes the Eq or In program
      empty_between  the odd groups have no matching row
      big_sums       values near 2**31 in few groups: sums past 2**31
      extremes       values of INT32_MIN and INT32_MAX (the min and max identities)
      empty          no rows
    """
    rng = np.random.default_rng([seed, CASES.index(name)])
    n = {"one_group": 5000, "singletons": 3000, "straddle": 6000, "all_fail": 4000,
         "empty_between": 5000, "big_sums": 4100, "extremes": 3000, "empty": 0}[name] * scale
    cols = rng.integers(0, 3, (n, F)).astype(np.int32)
    cols[:, IN_FIELD] = rng.integers(0, IN_UNIVERSE, n)
    cols[::97, IN_FIELD] = -1  # negative codes are in no set
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    if name == "one_group":
        gids = np.full(n, 7, np.int64)
    elif name == "singletons":
        gids = np.arange(n, dtype=np.int64) * 3
    elif name == "straddle":
        gids = np.repeat(np.arange(n), rng.integers(300, 2000, n))[:n].astype(np.int64)
    elif name == "all_fail":
        gids = np.sort(rng.integers(0, 30, n)).astype(np.int64)
        cols[:, EQ_FIELD] = 2
        cols[:, IN_FIELD] = IN_UNIVERSE + 5
    elif name == "empty_between":
        gids = np.repeat(np.arange(n), rng.integers(1, 40, n))[:n].astype(np.int64)
        cols[:, EQ_FIELD] = np.where(gids % 2 == 0, 1, 2)
        cols[gids % 2 == 1, IN_FIELD] = IN_UNIVERSE + 5
    elif name == "big_sums":
        gids = np.sort(rng.integers(0, 3, n)).astype(np.int64)
        vals = rng.integers(2**31 - 1000, 2**31 - 1, n).astype(np.int32)
    else:
        gids = np.sort(rng.integers(-50, 50, n)).astype(np.int64)
        if name == "extremes":
            vals = rng.choice(np.asarray([-2**31, 2**31 - 1, 0, 5], np.int32), n)
    return gids, vals, cols


def in_codes(seed=0, n_codes=50, universe=IN_UNIVERSE):
    """n_codes distinct codes of [0, universe), unsorted."""
    return np.random.default_rng(seed).permutation(universe)[:n_codes].astype(np.int32)


def program_arrays(kind, codes=None):
    """(opcodes, arg0, arg1, codesets) of a program: 'trivial' (every row),
    'eq' (field EQ_FIELD == 1) or 'in' (field IN_FIELD in codes)."""
    if kind == "trivial":
        return [3], [0], [0], np.full((1, 1), -1, np.int32)
    if kind == "eq":
        return [1], [EQ_FIELD], [1], np.full((1, 1), -1, np.int32)
    sets = np.full((1, len(codes)), -1, np.int32)
    sets[0] = codes
    return [2], [IN_FIELD], [0], sets


def filter_program(module, kind, codes=None):
    """A FilterProgram of ``module`` (repro.core.filter or
    repro_torch.core.filter) from program_arrays."""
    opc, a0, a1, sets = program_arrays(kind, codes)
    return module.FilterProgram(opcodes=np.asarray(opc, np.int32),
                                arg0=np.asarray(a0, np.int32),
                                arg1=np.asarray(a1, np.int32), codesets=sets, max_depth=1)
