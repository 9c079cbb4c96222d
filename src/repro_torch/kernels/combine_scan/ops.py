"""The fused filter and combine kernel's wrappers — scan-time aggregation
(the CombinerIterator's data plane).

Rows sorted by int64 group key are filtered with the predicate program,
and the matching rows of every group are aggregated: by the CUDA kernel
(csrc/combine_scan.cu) for CUDA tensors, by its plain version (ref.py) for
CPU tensors. ``combine_groups`` returns each group with a matching row, in
key order; ``combine_segments`` has the TPU kernel's per-row form, the
aggregate at each group's first row. Both run the same kernel in one pass
over the rows. ``combine_scan`` is the host op: numpy rows in, one (group
key, aggregate, match count) per group with a matching row out.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..build import check, load_library, shared_optin_bytes
from ..common import count_launch
from ..filter_scan.ops import program_tensors
from ..program_eval import OP_PUSH_TRUE, Program, as_program
from .ref import combine_groups_ref, combine_scan_ref

# Kernel launches since the last reset (chip_smoke.py zeroes it before a
# path and reads it after).
launches = 0

# The kernel's op codes.
OPS = {"sum": 0, "min": 1, "max": 2, "count": 3}


def trivial_program():
    """The all-rows-match program (a combiner with no residual filter)."""
    from ...core.filter import FilterProgram

    return FilterProgram(
        opcodes=np.asarray([OP_PUSH_TRUE], np.int32),
        arg0=np.zeros(1, np.int32),
        arg1=np.zeros(1, np.int32),
        codesets=np.full((1, 1), -1, np.int32),
        max_depth=1,
    )


def _checked(keys, vals, cols, program, rest, name):
    """Validate the arguments of either form; returns (vals, program, op)
    with vals an empty tensor for op 'count' and the program in whichever
    form was given."""
    if len(rest) == 1:
        op = rest[0]
    elif len(rest) == 4:
        program, op = (program, *rest[:3]), rest[3]
    else:
        raise TypeError(f"{name} takes (keys, vals, cols, program, op) or "
                        "(keys, vals, cols, opcodes, arg0, arg1, codesets, op)")
    if op not in OPS:
        raise ValueError(f"unknown combiner op {op!r}")
    n = keys.shape[0]
    if vals is None:
        if op != "count":
            raise ValueError(f"op {op!r} needs values")
        vals = torch.zeros(0, dtype=torch.int32, device=keys.device)
    elif vals.shape != (n,) or vals.dtype != torch.int32:
        raise ValueError(f"vals must be int32 ({n},), got {vals.dtype} {tuple(vals.shape)}")
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError(f"keys must be int64 (n,), got {keys.dtype} {tuple(keys.shape)}")
    if cols.dtype != torch.int32 or cols.dim() != 2 or cols.shape[0] != n:
        raise ValueError(f"cols must be int32 ({n}, F), got {cols.dtype} {tuple(cols.shape)}")
    named = [("vals", vals), ("cols", cols)]
    if isinstance(program, Program):
        named.append(("program", program.words))
    else:
        named.extend(zip(("opcodes", "arg0", "arg1", "codesets"), program))
    for what, t in named:
        if t.device != keys.device:
            raise ValueError(f"{what} is on {t.device}, keys on {keys.device}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    return vals, program, op


def _kernel_args(keys, vals, cols, program, op, groups):
    """The arguments both C entries share, after the checks the kernel
    needs: contiguous, 16-byte aligned rows (the TMA copies' alignment),
    fewer than 2**31 of them, a program whose fields exist."""
    program = as_program(program, keys.device)
    n, f = cols.shape
    if program.max_field >= f:
        raise ValueError(f"the program reads field {program.max_field} of {f}")
    if n >= 2**31:
        raise ValueError(f"{n} rows do not fit the kernel's int32 row numbers")
    keys, cols = keys.contiguous(), cols.contiguous()
    vals = vals.contiguous() if op != "count" else None
    for what, t in (("keys", keys), ("vals", vals), ("cols", cols)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{what} must start on a 16-byte boundary for the kernel's "
                             f"bulk copies (data_ptr {t.data_ptr():#x})")
    lib = load_library()
    dev = keys.device
    staged = program.staged_words(
        shared_optin_bytes() - lib.combine_scan_reserved_bytes(f, int(op != "count"), int(groups)))
    # The kernel sizes its grid; the scratch holds the look-back slots of
    # every block the card can hold at once with that block shape.
    nbytes = lib.combine_scan_scratch_bytes(f, OPS[op], int(groups), program.n_ops,
                                            program.header_words, staged)
    if nbytes < 0:
        check(-nbytes, "combine_scan")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    head = (keys.data_ptr(), vals.data_ptr() if vals is not None else None, cols.data_ptr(), n,
            f, program.words.data_ptr(), program.n_ops, program.header_words, staged, OPS[op])
    tail = (scratch.data_ptr(), nbytes, torch.cuda.current_stream(dev).cuda_stream)
    return lib, head, tail, scratch


def combine_segments(keys, vals, cols, program, *rest):
    """keys int64 (n,) ascending; vals int32 (n,), or None for op 'count';
    cols int32 (n, F); then a Program on the same device and the op —
    ``combine_segments(keys, vals, cols, program, op)`` — or the original
    form's four int32 tensors and the op, which a CUDA call prepares anew.
    Returns (heads bool (n,), int64 (n,) aggregates and int32 (n,) match
    counts at the heads; the identity and 0 elsewhere), as combine_scan_ref
    does. CPU tensors run the plain version; CUDA tensors launch the
    kernel."""
    vals, program, op = _checked(keys, vals, cols, program, rest, "combine_segments")
    if keys.device.type == "cpu":
        return combine_scan_ref(keys, vals, cols, *program, op)
    n, dev = keys.shape[0], keys.device
    heads = torch.empty(n, dtype=torch.bool, device=dev)
    aggs = torch.empty(n, dtype=torch.int64, device=dev)
    cnts = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return heads, aggs, cnts
    lib, head, tail, _ = _kernel_args(keys, vals, cols, program, op, groups=False)
    check(lib.combine_scan_rows(*head, heads.data_ptr(), aggs.data_ptr(), cnts.data_ptr(),
                                *tail), "combine_scan")
    count_launch(globals())
    return heads, aggs, cnts


def combine_groups(keys, vals, cols, program, *rest):
    """The arguments of combine_segments. Returns (group keys int64,
    aggregates int64, match counts int32, n int64 of shape ()): the groups
    with at least one matching row, in key order, are the first n entries
    of each (a CUDA call's outputs have room for one group a row, and n
    stays on the card until the caller reads it). CPU tensors run the
    plain version; CUDA tensors launch the kernel."""
    vals, program, op = _checked(keys, vals, cols, program, rest, "combine_groups")
    if keys.device.type == "cpu":
        return combine_groups_ref(keys, vals, cols, *program, op)
    n, dev = keys.shape[0], keys.device
    out = (torch.empty(n, dtype=torch.int64, device=dev),
           torch.empty(n, dtype=torch.int64, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev),
           torch.zeros((), dtype=torch.int64, device=dev) if n == 0 else
           torch.empty((), dtype=torch.int64, device=dev))
    if n == 0:
        return out
    spill = [torch.empty_like(t) for t in out[:3]]
    lib, head, tail, _ = _kernel_args(keys, vals, cols, program, op, groups=True)
    check(lib.combine_scan_groups(*head, *(t.data_ptr() for t in out),
                                  *(t.data_ptr() for t in spill), *tail), "combine_scan")
    count_launch(globals())
    return out


def combine_scan(group_keys: np.ndarray, values: Optional[np.ndarray], cols: np.ndarray,
                 prog=None, op: str = "count", device="cuda"
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fused scan-time aggregation over a run sorted by group key, on
    ``device``.

    group_keys int64 (n,) ascending (equal keys = one group); values int32
    (n,), ignored for op 'count' (may be None); cols int32 (n, f) the
    filter's dictionary codes; prog the residual FilterProgram, or a
    Program prepared once per query on ``device`` (its device wins), or
    None to match every row; op 'count' | 'sum' | 'min' | 'max'.

    Returns numpy (group keys int64, aggregates int64, match counts int32)
    for the groups with at least one matching row: combine_groups, whose
    group count is the one value read back before the copies. Sums
    accumulate in int64 whatever the values (the reference's Pallas path
    routes large sums to its int64 plain version; this kernel needs no
    such route)."""
    if op not in OPS:
        raise ValueError(f"unknown combiner op {op!r}")
    group_keys = np.asarray(group_keys, dtype=np.int64)
    n = cols.shape[0]
    if group_keys.shape != (n,):
        raise ValueError(f"group_keys {group_keys.shape} do not match {n} rows")
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int32)
    from ...core.device import resolve_device  # core imports this package

    if isinstance(prog, Program):
        dev, program = prog.device, prog
    else:
        dev = resolve_device(device)
        program = program_tensors(prog if prog is not None else trivial_program(), dev)
    vals = None
    if op != "count":
        vals = torch.from_numpy(np.ascontiguousarray(values, dtype=np.int32)).to(dev)
    keys, aggs, cnts, n_groups = combine_groups(
        torch.from_numpy(group_keys).to(dev), vals,
        torch.from_numpy(np.ascontiguousarray(cols, dtype=np.int32)).to(dev), program, op)
    m = int(n_groups)
    return keys[:m].cpu().numpy(), aggs[:m].cpu().numpy(), cnts[:m].cpu().numpy()
