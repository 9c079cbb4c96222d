"""The postfix predicate program: opcodes, stack bound and its plain
PyTorch evaluator.

The program format is compiled by core/filter.py and executed by the
``filter_scan`` CUDA kernel; ``program_eval_rows`` is the same function
written with tensor ops, the kernel's plain version.
"""
from __future__ import annotations

import torch

OP_NOP = 0
OP_PUSH_EQ = 1
OP_PUSH_IN = 2
OP_PUSH_TRUE = 3
OP_AND = 4
OP_OR = 5
OP_NOT = 6

MAX_STACK = 8


def program_eval_rows(cols, opcodes, arg0, arg1, codesets):
    """Evaluate a compiled filter program over a columnar block.

    cols (n, f) int32 dictionary codes; opcodes/arg0/arg1 (p,) int32;
    codesets (s, m) int32 padded with -1. Returns bool (n,) match mask.
    Stack indices clamp into [0, MAX_STACK), as the reference's dynamic
    indexing does; a program from compile_tree never needs the clamp.
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
                cset = codesets[arg]
                val = ((cols[:, f, None] == cset[None, :]) & (cset[None, :] >= 0)).any(dim=1)
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
