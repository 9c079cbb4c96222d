"""Plain PyTorch version of the filter kernel: the predicate program of
kernels/program_eval.py over rows with any leading level dims."""
from __future__ import annotations

import torch

from ..program_eval import program_eval_rows


def filter_scan_ref(cols, opcodes, arg0, arg1, codesets) -> torch.Tensor:
    """cols (..., F) int32 codes; opcodes/arg0/arg1 (P,) int32; codesets
    (S, M) int32. Returns the bool (...) match mask."""
    lead, f = cols.shape[:-1], cols.shape[-1]
    return program_eval_rows(cols.reshape(-1, f), opcodes, arg0, arg1, codesets).reshape(lead)
