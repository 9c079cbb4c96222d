"""The filter kernel's wrapper and the program padding it takes.

``filter_scan`` evaluates a compiled postfix predicate program over rows
of dictionary codes: the CUDA kernel (csrc/filter_scan.cu) for CUDA
tensors, its plain version (ref.py, over kernels/program_eval.py) for CPU
tensors. ``filter_rows`` runs it on numpy rows for the host query path.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..build import check, load_library
from ..common import pow2
from ..program_eval import OP_NOP
from .ref import filter_scan_ref

# Kernel launches since the last reset (chip_smoke.py zeroes it before the
# main path and reads it after).
launches = 0

# The kernel stages the program and codesets in shared memory; 48 KiB is
# what a launch may take without opting in to more.
MAX_SHARED_BYTES = 48 * 1024


def pad_program(prog) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad a FilterProgram's length to a power of two and its codeset
    table to power-of-two rows and columns (-1 padded)."""
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


def program_tensors(prog, device) -> Tuple[torch.Tensor, ...]:
    """A FilterProgram, padded, as the four int32 tensors (opcodes, arg0,
    arg1, codesets) on ``device``, copied in one transfer."""
    opc, a0, a1, cs = pad_program(prog)
    flat = torch.from_numpy(np.concatenate([opc, a0, a1, cs.ravel()])).to(device)
    p = len(opc)
    return flat[:p], flat[p:2 * p], flat[2 * p:3 * p], flat[3 * p:].view(cs.shape)


def filter_scan(cols, opcodes, arg0, arg1, codesets) -> torch.Tensor:
    """cols (..., F) int32 codes; opcodes/arg0/arg1 (P,) int32 and codesets
    (S, M) int32 on the same device. Returns the bool (...) match mask.
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    for name, t in (("cols", cols), ("opcodes", opcodes), ("arg0", arg0),
                    ("arg1", arg1), ("codesets", codesets)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != cols.device:
            raise ValueError(f"{name} is on {t.device}, cols on {cols.device}")
    if cols.device.type == "cpu":
        return filter_scan_ref(cols, opcodes, arg0, arg1, codesets)
    if cols.device.type != "cuda":
        raise ValueError(f"unsupported device {cols.device}")
    p = opcodes.shape[0]
    if arg0.shape != (p,) or arg1.shape != (p,) or codesets.dim() != 2:
        raise ValueError("program arrays must be (P,) and codesets (S, M)")
    s, m = codesets.shape
    if (3 * p + s * m) * 4 > MAX_SHARED_BYTES:
        raise ValueError(
            f"program ({p} ops) and codesets ({s}x{m}) exceed the kernel's "
            f"{MAX_SHARED_BYTES} bytes of shared memory"
        )
    lead, f = cols.shape[:-1], cols.shape[-1]
    rows = cols.reshape(-1, f).contiguous()
    program = torch.cat([opcodes, arg0, arg1]).contiguous()
    codesets = codesets.contiguous()
    out = torch.empty(rows.shape[0], dtype=torch.bool, device=cols.device)
    if rows.shape[0] == 0:
        return out.reshape(lead)
    lib = load_library()
    stream = torch.cuda.current_stream(cols.device).cuda_stream
    check(
        lib.filter_scan_rows(
            rows.data_ptr(), rows.shape[0], f, program.data_ptr(), p,
            codesets.data_ptr(), s, m, out.data_ptr(), stream,
        ),
        "filter_scan",
    )
    global launches
    launches += 1
    return out.reshape(lead)


def filter_rows(cols: np.ndarray, prog, device="cuda") -> np.ndarray:
    """The host query path's filter: a FilterProgram over numpy (n, F)
    int32 codes, evaluated by filter_scan on ``device``. Returns the numpy
    bool (n,) mask."""
    from ...core.device import resolve_device  # core imports this package

    dev = resolve_device(device)
    rows = torch.from_numpy(np.ascontiguousarray(cols, dtype=np.int32)).to(dev)
    return filter_scan(rows, *program_tensors(prog, dev)).cpu().numpy()
