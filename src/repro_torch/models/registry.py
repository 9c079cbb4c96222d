"""Architecture registry: --arch <id> -> ModelConfig (full or smoke); a
copy of the reference's models/registry.py cut to the architectures the
port runs (the MoE and SSM families wait for a later slice)."""
from __future__ import annotations

import importlib
from typing import List

from ..configs.base import ModelConfig

_ARCHS = {
    "gemma2-9b": "gemma2_9b",
    "internlm2-20b": "internlm2_20b",
    "qwen1.5-4b": "qwen1_5_4b",
    "gemma3-12b": "gemma3_12b",
    "musicgen-medium": "musicgen_medium",
    "llama-3.2-vision-11b": "llama3_2_vision_11b",
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
