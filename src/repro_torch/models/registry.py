"""Architecture registry: --arch <id> -> ModelConfig (full or smoke); a
copy of the reference's models/registry.py cut to the architectures the
port runs."""
from __future__ import annotations

import importlib
from typing import List

from ..configs.base import ModelConfig

_ARCHS = {
    "llcysa-analytics-100m": "llcysa",
}


def list_archs() -> List[str]:
    """The architectures ported so far."""
    return list(_ARCHS)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; ported so far: {sorted(_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")
    return mod.smoke() if smoke else mod.CONFIG
