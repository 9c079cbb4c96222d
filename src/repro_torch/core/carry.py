"""Load an ingest plane's LSM state from numpy arrays.

The reference plane's ``state`` dict, fetched to the host as numpy
arrays, has the same keys and shapes as this package's plane state;
``plane_state_from_numpy`` turns it into tensors on a device, and
``DistIngestPlane.load_state`` starts a plane from them. The tests start
both packages from one LSM state this way, and chip_smoke.py moves a
state built on the CPU onto the card.

Per-tablet counters (live counts, run counts, overflow, minor and major)
are int32 in this package. The reference's event-family major promotes
its base count and overflow to int64 (``bn + rn.sum()`` under jax x64),
so those arrive as int64 and are cast back, after a check that they fit.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_INT32_COUNTERS = ("n_runs", "minor", "major")


def _is_int32_counter(name: str) -> bool:
    return name in _INT32_COUNTERS or name.endswith(("_n", "_overflow"))


def plane_state_from_numpy(state: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """{name: numpy array} -> {name: tensor on ``device``}."""
    out = {}
    for name, arr in state.items():
        arr = np.array(arr)  # a writable, contiguous copy
        if _is_int32_counter(name) and arr.dtype != np.int32:
            info = np.iinfo(np.int32)
            if arr.size and (arr.min() < info.min or arr.max() > info.max):
                raise ValueError(f"{name}: counter values do not fit int32")
            arr = arr.astype(np.int32)
        out[name] = torch.from_numpy(arr).to(device)
    return out
