"""The fused filter and combine kernel's wrapper — scan-time aggregation
(the CombinerIterator's data plane).

``combine_segments`` filters rows sorted by int64 group key with the
predicate program and aggregates the matching rows of every group at the
group's first row: the CUDA kernel (csrc/combine_scan.cu) for CUDA
tensors, its plain version (ref.py) for CPU tensors. The kernel works
tile by tile, and its second pass stitches the groups that straddle
tiles. ``combine_scan`` is the host op: numpy rows in, one (group key,
aggregate, match count) per group with at least one matching row out.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..build import check, load_library, shared_optin_bytes
from ..filter_scan.ops import program_tensors
from ..program_eval import OP_PUSH_TRUE, Program, as_program
from .ref import combine_scan_ref

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


def combine_segments(keys, vals, cols, program, *rest):
    """keys int64 (n,) ascending; vals int32 (n,), or None for op 'count';
    cols int32 (n, F); then a Program on the same device and the op —
    ``combine_segments(keys, vals, cols, program, op)`` — or the original
    form's four int32 tensors and the op, which a CUDA call prepares anew.
    Returns (heads bool (n,), int64 (n,) aggregates and int32 (n,) match
    counts at the heads; the identity and 0 elsewhere), as combine_scan_ref
    does. CPU tensors run the plain version; CUDA tensors launch the
    kernel."""
    if len(rest) == 1:
        op = rest[0]
    elif len(rest) == 4:
        program, op = (program, *rest[:3]), rest[3]
    else:
        raise TypeError("combine_segments takes (keys, vals, cols, program, op) or "
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
    for name, t in named:
        if t.device != keys.device:
            raise ValueError(f"{name} is on {t.device}, keys on {keys.device}")
    if keys.device.type == "cpu":
        return combine_scan_ref(keys, vals, cols, *program, op)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    program = as_program(program, keys.device)
    if program.max_field >= cols.shape[1]:
        raise ValueError(f"the program reads field {program.max_field} of {cols.shape[1]}")
    dev = keys.device
    heads = torch.empty(n, dtype=torch.bool, device=dev)
    aggs = torch.empty(n, dtype=torch.int64, device=dev)
    cnts = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return heads, aggs, cnts
    keys, cols = keys.contiguous(), cols.contiguous()
    vals = vals.contiguous()
    lib = load_library()
    # Scratch: each tile's last true head, for the kernel's stitch pass.
    last = torch.empty(-(-n // lib.combine_scan_tile_rows()), dtype=torch.int64, device=dev)
    staged = program.staged_words(shared_optin_bytes() - lib.combine_scan_accumulator_bytes())
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.combine_scan_tiles(
        keys.data_ptr(), vals.data_ptr() if vals.numel() else None, cols.data_ptr(), n,
        cols.shape[1], program.words.data_ptr(), program.n_ops, program.header_words, staged,
        OPS[op], heads.data_ptr(), aggs.data_ptr(), cnts.data_ptr(), last.data_ptr(), stream),
        "combine_scan")
    global launches
    launches += 1
    return heads, aggs, cnts


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
    for the groups with at least one matching row. Sums accumulate in
    int64 whatever the values (the reference's Pallas path routes large
    sums to its int64 plain version; this kernel needs no such route)."""
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
    keys = torch.from_numpy(group_keys).to(dev)
    heads, aggs, cnts = combine_segments(
        keys, vals, torch.from_numpy(np.ascontiguousarray(cols, dtype=np.int32)).to(dev),
        program, op)
    keep = heads & (cnts > 0)
    return (keys[keep].cpu().numpy(), aggs[keep].cpu().numpy(), cnts[keep].cpu().numpy())
