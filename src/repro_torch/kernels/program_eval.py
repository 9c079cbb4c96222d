"""The postfix predicate program: opcodes, stack bound, its plain PyTorch
evaluator and the prepared form the kernels take.

The program format is compiled by core/filter.py. ``program_eval_rows``
evaluates its original form (opcodes, arg0, arg1 and a codeset table
padded with -1), the kernels' plain version. ``prepare_program`` stages
it once per query on a device as a ``Program``: the original form, and
for the kernels (csrc/program_eval.cuh) one flat int32 array

    [opcodes P | arg0 P | arg1 P | set offsets S+1 | codes]

where set s is codes[off[s]:off[s+1]], its non-negative codes sorted
ascending, so the kernels search a set in log2 of its size. A block
stages the whole array in shared memory while it fits under
``SHARED_PROGRAM_BYTES``; past that it stages the header (opcodes, args
and offsets) and searches the codes in place in global memory.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

OP_NOP = 0
OP_PUSH_EQ = 1
OP_PUSH_IN = 2
OP_PUSH_TRUE = 3
OP_AND = 4
OP_OR = 5
OP_NOT = 6

MAX_STACK = 8

# A program (header and codes) up to this many bytes is staged in shared
# memory by every block that evaluates it, within what a block may take
# (the card's opt-in limit less the kernel's own use); a larger one keeps
# its codes in global memory. chip_smoke.py times In sets of 3,000,
# 12,000 and 30,000 codes both ways on the base level: on the H100 shared
# memory won at 12 KB, tied at 48 KB and lost at 120 KB, where a block
# that stages the program leaves room for one block per SM (PERF.md).
SHARED_PROGRAM_BYTES = 48 * 1024


def program_eval_rows(cols, opcodes, arg0, arg1, codesets):
    """Evaluate a compiled filter program over a columnar block.

    cols (n, f) int32 dictionary codes; opcodes/arg0/arg1 (p,) int32;
    codesets (s, m) int32 padded with -1. Returns bool (n,) match mask.
    Stack indices clamp into [0, MAX_STACK), as the reference's dynamic
    indexing does; a program from compile_tree never needs the clamp.
    A code is in a set when some non-negative entry of the set's row
    equals it, so negative codes match no set.
    """
    n = cols.shape[0]
    dev = cols.device
    ops = opcodes.tolist()
    f_ids = arg0.tolist()
    args = arg1.tolist()
    stack = torch.zeros((MAX_STACK, n), dtype=torch.bool, device=dev)
    sp = 0

    def clamp(i):
        return min(max(i, 0), MAX_STACK - 1)

    for op, f, arg in zip(ops, f_ids, args):
        if op in (OP_PUSH_EQ, OP_PUSH_IN, OP_PUSH_TRUE):
            if op == OP_PUSH_EQ:
                val = cols[:, f] == arg
            elif op == OP_PUSH_IN:
                col = cols[:, f]
                val = (col >= 0) & torch.isin(col, codesets[arg])
            else:
                val = torch.ones((n,), dtype=torch.bool, device=dev)
            stack[clamp(sp)] = val
            sp += 1
        elif op in (OP_AND, OP_OR):
            a = stack[clamp(sp - 2)]
            b = stack[clamp(sp - 1)]
            stack[clamp(sp - 2)] = (a & b) if op == OP_AND else (a | b)
            sp -= 1
        elif op == OP_NOT:
            stack[clamp(sp - 1)] = ~stack[clamp(sp - 1)]
    return stack[0].clone()


@dataclass(frozen=True, eq=False)
class Program:
    """A filter program staged on one device. ``opcodes``, ``arg0``,
    ``arg1`` and ``codesets`` are the original form, which the plain
    version evaluates; iterating a Program yields them, so
    ``filter_scan(cols, *program)`` still works. ``words`` is the kernels'
    form (see the module docstring)."""

    opcodes: torch.Tensor
    arg0: torch.Tensor
    arg1: torch.Tensor
    codesets: torch.Tensor
    words: torch.Tensor
    n_ops: int
    n_sets: int
    n_codes: int
    max_field: int  # largest field id a push reads (-1: none)

    @property
    def device(self) -> torch.device:
        return self.words.device

    @property
    def header_words(self) -> int:
        return 3 * self.n_ops + self.n_sets + 1

    @property
    def nbytes(self) -> int:
        """Bytes of the program plus its codesets in the kernels' form."""
        return 4 * (self.header_words + self.n_codes)

    def __iter__(self):
        return iter((self.opcodes, self.arg0, self.arg1, self.codesets))

    def staged_words(self, budget_bytes: int) -> int:
        """Words of ``words`` a block stages in shared memory when it may
        take ``budget_bytes`` there: all of them while the program fits the
        budget and SHARED_PROGRAM_BYTES, else the header alone (the codes
        are searched in global memory), else none."""
        if self.nbytes <= min(budget_bytes, SHARED_PROGRAM_BYTES):
            return self.header_words + self.n_codes
        if 4 * self.header_words <= budget_bytes:
            return self.header_words
        return 0


def prepare_program(opcodes, arg0, arg1, codesets, device) -> Program:
    """Stage a program given as numpy arrays (opcodes/arg0/arg1 (P,),
    codesets (S, M) padded with -1) on ``device`` in one host-to-device
    copy: the original form and the kernels' sorted form."""
    opc, a0, a1 = (np.ascontiguousarray(x, dtype=np.int32).reshape(-1)
                   for x in (opcodes, arg0, arg1))
    cs = np.ascontiguousarray(codesets, dtype=np.int32)
    p = opc.shape[0]
    if a0.shape != (p,) or a1.shape != (p,) or cs.ndim != 2:
        raise ValueError("program arrays must be (P,) and codesets (S, M)")
    s = cs.shape[0]
    push_in = opc == OP_PUSH_IN
    if push_in.any() and (a1[push_in].min() < 0 or a1[push_in].max() >= s):
        raise ValueError(f"a PUSH_IN names a codeset outside the {s} rows")
    pushes = (opc == OP_PUSH_EQ) | push_in
    if pushes.any() and a0[pushes].min() < 0:
        raise ValueError("a push names a negative field id")
    rows = [np.sort(r[r >= 0]) for r in cs]
    off = np.zeros(s + 1, np.int64)
    off[1:] = np.cumsum([len(r) for r in rows])
    if off[-1] >= 2**31:
        raise ValueError(f"{off[-1]} codes do not fit int32 offsets")
    words = np.concatenate([opc, a0, a1, off.astype(np.int32), *rows]).astype(np.int32)
    flat = torch.from_numpy(np.concatenate([opc, a0, a1, cs.ravel(), words])).to(device)
    return Program(
        opcodes=flat[:p], arg0=flat[p:2 * p], arg1=flat[2 * p:3 * p],
        codesets=flat[3 * p:3 * p + cs.size].view(cs.shape), words=flat[3 * p + cs.size:],
        n_ops=p, n_sets=s, n_codes=int(off[-1]),
        max_field=int(a0[pushes].max()) if pushes.any() else -1,
    )


def as_program(program, device=None) -> Program:
    """A Program as it is, or the four original-form tensors (opcodes,
    arg0, arg1, codesets) prepared on their device (or ``device``)."""
    if isinstance(program, Program):
        return program
    opcodes, arg0, arg1, codesets = program
    for name, t in (("opcodes", opcodes), ("arg0", arg0), ("arg1", arg1),
                    ("codesets", codesets)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    return prepare_program(*(t.cpu().numpy() for t in (opcodes, arg0, arg1, codesets)),
                           device if device is not None else opcodes.device)
