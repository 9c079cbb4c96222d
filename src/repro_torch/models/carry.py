"""Parameters carried across from the reference: the reference's
``init_params`` tree, given as numpy arrays, as the port's tree of
tensors, so that both packages compute the same function from the same
weights."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.device import resolve_device
from .model import FLOAT32_LEAVES


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact through float32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_reference(tree: Any, device="cuda", dtype=None) -> Any:
    """Map the reference's parameter tree (dicts and tuples of numpy
    arrays) leaf for leaf onto tensors on ``device``, cast to ``dtype``
    when given, but the leaves the reference keeps in float32
    (``model.FLOAT32_LEAVES``: the cross-attention gates, the MoE router,
    the SSM's dt_bias, A_log and D), which keep their own dtype. The structure is the reference's, which is the
    port's."""
    dev = resolve_device(device)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(walk(v) for v in node)
        return _tensor(node, dev, None if key in FLOAT32_LEAVES else dtype)

    return walk(tree)
