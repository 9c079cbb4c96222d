"""The filter kernel's wrappers and the program preparation they take.

``filter_scan_levels`` evaluates a prepared predicate program
(kernels/program_eval.py) over the rows of several blocks of dictionary
codes — every LSM level of a step — in one launch of the CUDA kernel
(csrc/filter_scan.cu) for CUDA tensors, and level by level through its
plain version (ref.py) for CPU tensors. ``filter_scan`` is the one-block
form; it also takes the original form's four tensors, and then prepares
the program on every call. ``filter_rows`` runs it on numpy rows for the
host query path.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..build import check, load_library, shared_optin_bytes
from ..common import count_launch, pow2
from ..program_eval import OP_NOP, Program, as_program, prepare_program
from .ref import filter_scan_ref

# Kernel launches since the last reset (chip_smoke.py zeroes it before the
# main path and reads it after).
launches = 0

# Blocks one launch takes (csrc/filter_scan.cu, kMaxLevels).
MAX_LEVELS = 8


def pad_program(prog) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad a FilterProgram's length to a power of two and its codeset
    table to power-of-two rows and columns (-1 padded), as the
    reference's Pallas kernel takes it."""
    p = pow2(max(prog.length, 1))
    opc = np.full(p, OP_NOP, np.int32)
    a0 = np.zeros(p, np.int32)
    a1 = np.zeros(p, np.int32)
    opc[: prog.length] = prog.opcodes
    a0[: prog.length] = prog.arg0
    a1[: prog.length] = prog.arg1
    s, m = prog.codesets.shape
    cs = np.full((pow2(max(s, 1)), pow2(max(m, 1))), -1, np.int32)
    cs[:s, :m] = prog.codesets
    return opc, a0, a1, cs


def program_tensors(prog, device) -> Program:
    """A FilterProgram staged on ``device`` in one transfer (see
    program_eval.prepare_program). Prepare it once per query."""
    return prepare_program(prog.opcodes, prog.arg0, prog.arg1, prog.codesets, device)


def filter_scan_levels(levels: Sequence[torch.Tensor], program) -> List[torch.Tensor]:
    """levels: int32 (..., F) code blocks on one device, F the same for
    all; program: a Program on that device (or the original form's four
    tensors). Returns one bool (...) match mask per level. CPU tensors run
    the plain version level by level; CUDA tensors launch the kernel once
    for all levels."""
    levels = list(levels)
    if not levels:
        return []
    dev = levels[0].device
    f = levels[0].shape[-1]
    for i, cols in enumerate(levels):
        if cols.dtype != torch.int32:
            raise TypeError(f"cols must be int32, got {cols.dtype}")
        if cols.device != dev or cols.shape[-1] != f:
            raise ValueError(f"level {i} is {tuple(cols.shape)} on {cols.device}; "
                             f"level 0 is (..., {f}) on {dev}")
    if isinstance(program, Program) and program.device != dev:
        raise ValueError(f"program is on {program.device}, cols on {dev}")
    if dev.type == "cpu":
        opcodes, arg0, arg1, codesets = program
        return [filter_scan_ref(cols, opcodes, arg0, arg1, codesets) for cols in levels]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"{len(levels)} levels exceed the kernel's {MAX_LEVELS}")
    program = as_program(program, dev)
    if program.max_field >= f:
        raise ValueError(f"the program reads field {program.max_field} of {f}")
    rows = [cols.reshape(-1, f).contiguous() for cols in levels]
    sizes = [r.shape[0] for r in rows]
    flat = torch.empty(sum(sizes), dtype=torch.bool, device=dev)
    outs = list(flat.split(sizes))
    if flat.numel():
        lib = load_library()
        n = len(rows)
        check(lib.filter_scan_levels(
            (ctypes.c_void_p * n)(*(r.data_ptr() for r in rows)),
            (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs)),
            (ctypes.c_longlong * n)(*sizes), n, f, program.words.data_ptr(),
            program.n_ops, program.header_words, program.staged_words(shared_optin_bytes()),
            torch.cuda.current_stream(dev).cuda_stream), "filter_scan")
        count_launch(globals())
    return [o.view(cols.shape[:-1]) for o, cols in zip(outs, levels)]


def filter_scan(cols, program, arg0=None, arg1=None, codesets=None) -> torch.Tensor:
    """cols (..., F) int32 codes; program a Program on the same device,
    or the original form as four int32 tensors (opcodes, arg0, arg1 (P,)
    and codesets (S, M)), which a CUDA call prepares anew each time.
    Returns the bool (...) match mask."""
    if arg0 is not None:
        program = (program, arg0, arg1, codesets)
        for name, t in zip(("opcodes", "arg0", "arg1", "codesets"), program):
            if t.dtype != torch.int32:
                raise TypeError(f"{name} must be int32, got {t.dtype}")
            if t.device != cols.device:
                raise ValueError(f"{name} is on {t.device}, cols on {cols.device}")
    return filter_scan_levels([cols], program)[0]


def filter_rows(cols: np.ndarray, program: Program) -> np.ndarray:
    """The host query path's filter: a prepared Program over numpy (n, F)
    int32 codes, evaluated on the program's device. Returns the numpy bool
    (n,) mask."""
    rows = torch.from_numpy(np.ascontiguousarray(cols, dtype=np.int32)).to(program.device)
    return filter_scan(rows, program).cpu().numpy()
