"""The membership kernel's wrapper — the device index AND's data plane.

``member_mask(a, b)`` marks each key of ``a`` that occurs in the sorted
``b`` of the same row, batched over leading dims (the tablets): the CUDA
kernel (csrc/merge_intersect.cu) for CUDA tensors, its plain version
(ref.py) for CPU tensors. int32 and int64 keys are read as they are.

The host query path's sorted-set ops sit on top: ``intersect_sorted``
(the planner's AND, through ``member_mask`` on a given device) and
``union_sorted`` (the OR, a plain sorted union).
"""
from __future__ import annotations

import numpy as np
import torch

from ..build import check, load_library
from ..common import count_launch
from .ref import member_mask_keys

# Kernel launches since the last reset (chip_smoke.py zeroes it before a
# path and reads it after).
launches = 0

_ENTRY = {torch.int32: "member_mask_i32", torch.int64: "member_mask_i64"}


def member_mask(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., n), b (..., m) of one dtype (int32 or int64) on one device,
    with equal leading dims and each row of b sorted ascending. Returns
    bool (..., n), True where a[..., j] is in b[..., :]. CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    if a.dtype != b.dtype or a.dtype not in _ENTRY:
        raise TypeError(f"keys must share an int32 or int64 dtype, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    if a.dim() == 0 or a.shape[:-1] != b.shape[:-1]:
        raise ValueError(f"leading dims differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.device.type == "cpu":
        return member_mask_keys(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    out = torch.empty(a.shape, dtype=torch.bool, device=a.device)
    if a.numel() == 0:
        return out
    n, m = a.shape[-1], b.shape[-1]
    rows = a.numel() // n
    a_c, b_c = a.contiguous(), b.contiguous()
    lib = load_library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    check(
        getattr(lib, _ENTRY[a.dtype])(
            a_c.data_ptr(), b_c.data_ptr(), rows, n, m, out.data_ptr(), stream,
        ),
        "merge_intersect",
    )
    count_launch(globals())
    return out


def intersect_sorted(a: np.ndarray, b: np.ndarray, device="cuda") -> np.ndarray:
    """A ∩ B of two sorted int64 key sets: the larger set probes the
    smaller one through member_mask on ``device``. Returns the sorted
    int64 intersection as numpy."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    if a.size == 0 or b.size == 0:
        return np.empty(0, np.int64)
    if a.size < b.size:
        a, b = b, a
    from ...core.device import resolve_device  # core imports this package

    dev = resolve_device(device)
    mask = member_mask(torch.from_numpy(a).to(dev)[None], torch.from_numpy(b).to(dev)[None])
    return a[mask[0].cpu().numpy()]


def union_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """A ∪ B of two sorted int64 key sets, sorted and unique (a plain
    sorted union on the host)."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    return np.unique(np.concatenate([a, b]))
