"""Architecture registry: --arch <id> -> ModelConfig (full or smoke); a
copy of the reference's models/registry.py, every architecture it
registers."""
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
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "zamba2-2.7b": "zamba2_2_7b",
    "llama-3.2-vision-11b": "llama3_2_vision_11b",
    "mamba2-780m": "mamba2_780m",
    "llcysa-analytics-100m": "llcysa",
}


def list_archs() -> List[str]:
    """Every registered architecture."""
    return list(_ARCHS)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")
    return mod.smoke() if smoke else mod.CONFIG
