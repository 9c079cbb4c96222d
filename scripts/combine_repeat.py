"""combine_scan's two forms, and filter_scan on In sets of 3,000 to
300,000 codes, on synthetic batches at the main path's sizes: each row
held bit for bit to the plain version and timed as chip_smoke.py times it
(its time_combine, time_groups and time_filter), without the rest of
chip_smoke's paths.

    python3 scripts/combine_repeat.py [--parent TREE]

--parent TREE also times, on the same inputs in the same process, the
combine_scan and filter_scan kernels of TREE: a checkout of the last tree
with combine_scan's one-row-a-thread design (the C entries
combine_scan_tiles, combine_scan_tile_rows and
combine_scan_accumulator_bytes), unpacked under build/. Their outputs
must equal this tree's bit for bit. The batches: 3,962,129 rows of 12
fields in 20 groups (the size of path 3's largest tier-A batch) under an
Eq matching a third of the rows and under an In of 300,000 codes out of
2**20; 1,048,576 rows whose last half is one group (chip_smoke.py's
synthetic straddle). Needs one CUDA card. Prints one JSON line per row,
then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
SEED = 7


class Parent:
    """TREE's combine_scan and filter_scan kernels, built from TREE's
    sources into its own build/ and called through its C entries. Its
    build.py and program_eval.py import nothing of the package, so they
    load beside this tree's."""

    def __init__(self, root):
        def load(name, rel):
            spec = importlib.util.spec_from_file_location(name, os.path.join(root, rel))
            mod = sys.modules[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod

        self.build = load("parent_build", "src/repro_torch/kernels/build.py")
        self.program_eval = load("parent_program_eval", "src/repro_torch/kernels/program_eval.py")
        self.lib = self.build.load_library()

    def program(self, program):
        """This tree's Program prepared by TREE."""
        return self.program_eval.prepare_program(*(t.cpu().numpy() for t in program),
                                                 program.device)

    def combine_segments(self, keys, vals, cols, program, op):
        import torch
        from repro_torch.kernels.combine_scan import OPS

        n, dev = keys.shape[0], keys.device
        heads = torch.empty(n, dtype=torch.bool, device=dev)
        aggs = torch.empty(n, dtype=torch.int64, device=dev)
        cnts = torch.empty(n, dtype=torch.int32, device=dev)
        last = torch.empty(-(-n // self.lib.combine_scan_tile_rows()), dtype=torch.int64,
                           device=dev)
        staged = program.staged_words(self.build.shared_optin_bytes()
                                      - self.lib.combine_scan_accumulator_bytes())
        self.build.check(self.lib.combine_scan_tiles(
            keys.data_ptr(), vals.data_ptr() if vals is not None else None, cols.data_ptr(), n,
            cols.shape[1], program.words.data_ptr(), program.n_ops, program.header_words,
            staged, OPS[op], heads.data_ptr(), aggs.data_ptr(), cnts.data_ptr(),
            last.data_ptr(), torch.cuda.current_stream(dev).cuda_stream), "parent combine_scan")
        return heads, aggs, cnts

    def filter_scan(self, rows, program):
        import ctypes

        import torch

        n, f = rows.shape
        out = torch.empty(n, dtype=torch.bool, device=rows.device)
        vp = ctypes.c_void_p
        self.build.check(self.lib.filter_scan_levels(
            (vp * 1)(rows.data_ptr()), (vp * 1)(out.data_ptr()), (ctypes.c_longlong * 1)(n), 1,
            f, program.words.data_ptr(), program.n_ops, program.header_words,
            program.staged_words(self.build.shared_optin_bytes()),
            torch.cuda.current_stream(rows.device).cuda_stream), "parent filter_scan")
        return out


def parent_rows(cs, row, call, want, names, per_call):
    """Add the parent's times to row after checking its output equals
    want; its calls launch per_call of the named kernels each."""
    got = call()
    same = all(cs.torch_equal(g, w) for g, w in zip(got, want)) if isinstance(
        want, tuple) else cs.torch_equal(got, want)
    cs.check(same, f"{row['shape']}: the parent's kernel disagrees")
    row.update(parent_ms=cs.cuda_ms(call), parent_device_ms=cs.device_ms(call, names, per_call=per_call),
               parent_device_ms_by=cs.DEVICE_MS_BY[-1])


def program(opcodes, arg0, arg1, codesets, dev):
    from repro_torch.core.filter import FilterProgram
    from repro_torch.kernels.filter_scan import program_tensors

    return program_tensors(FilterProgram(
        opcodes=np.asarray(opcodes, np.int32), arg0=np.asarray(arg0, np.int32),
        arg1=np.asarray(arg1, np.int32), codesets=np.asarray(codesets, np.int32),
        max_depth=1), dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="TREE")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("combine_repeat: needs one NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.combine_scan import combine_segments
    from repro_torch.kernels.filter_scan import filter_scan_levels

    dev = torch.device("cuda", 0)
    build.load_library()
    parent = Parent(args.parent) if args.parent else None
    rng = np.random.default_rng(SEED)
    n, f = 3_962_129, 12
    cols = rng.integers(0, 3, (n, f)).astype(np.int32)
    cols[:, 5] = rng.integers(0, 1 << 20, n)
    gids = np.sort(rng.integers(0, 20, n)).astype(np.int64)
    vals = rng.integers(0, 1 << 20, n).astype(np.int32)
    batch = [torch.from_numpy(x).to(dev) for x in (gids, vals, cols)]
    eq = program([1], [0], [1], [[-1]], dev)
    in_sets = {k: program([2], [5], [0], [rng.choice(1 << 20, k, replace=False)], dev)
               for k in (3_000, 12_000, 30_000, 300_000)}
    syn_gids = np.sort(rng.integers(0, 4000, 1 << 20))
    syn_gids[1 << 19:] = 4000
    syn_cols = np.zeros((1 << 20, f), np.int32)
    syn_cols[::2, 0] = 1
    syn = [torch.from_numpy(x).to(dev) for x in
           (syn_gids.astype(np.int64), rng.integers(0, 1 << 20, 1 << 20).astype(np.int32),
            syn_cols)]
    cases = [("tier-A size, Eq", batch, eq, op) for op in cs.OPS]
    cases.append(("tier-A size, In(300,000 codes)", batch, in_sets[300_000], "sum"))
    cases += [("synthetic straddle", syn, eq, op) for op in cs.OPS]
    rows = []
    for name, (keys, vals_, cols_), prog, op in cases:
        row = cs.time_combine(name, keys, vals_, cols_, prog, op)
        if parent is not None:
            v = None if op == "count" else vals_
            pprog = parent.program(prog)
            parent_rows(cs, row, lambda: parent.combine_segments(keys, v, cols_, pprog, op),
                        combine_segments(keys, v, cols_, prog, op),
                        ("combine_scan_kernel", "combine_scan_stitch"), per_call=2)
        rows.append(row)
    rows += [cs.time_groups(name, *b, prog, op) for name, b, prog, op in cases]
    for k, prog in in_sets.items():
        row = cs.time_filter(f"tier-A size, In({k:,} codes)", batch[2], prog)
        if parent is not None:
            pprog = parent.program(prog)
            parent_rows(cs, row, lambda: parent.filter_scan(batch[2], pprog),
                        filter_scan_levels([batch[2]], prog)[0].reshape(-1),
                        ("filter_levels_kernel",), per_call=1)
        rows.append(row)
    for row in rows:
        cs.check(row["max_abs_err"] == 0, f"kernel disagrees with its plain version: {row}")
        print(json.dumps(row))
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
