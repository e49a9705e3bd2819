"""Architecture registry: ``--arch <id>`` → ModelConfig.

The ids are the JAX package's. Each ported module defines the exact
published ``CONFIG`` plus a ``REDUCED`` config of the same family (same
layer-kind pattern, same structural features, tiny dims) for CPU tests,
with the same values as the JAX package's.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "mixtral-8x22b": "mixtral_8x22b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "qwen2-1.5b": "qwen2_1_5b",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "gemma2-27b": "gemma2_27b",
    "mamba2-130m": "mamba2_130m",
    "musicgen-large": "musicgen_large",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}

ARCH_IDS: List[str] = ["mixtral-8x22b", "deepseek-v2-236b",
                       "phi-3-vision-4.2b", "qwen2-1.5b", "stablelm-1.6b",
                       "qwen1.5-0.5b", "gemma2-27b", "mamba2-130m",
                       "musicgen-large", "jamba-v0.1-52b"]


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"{__name__}.{_MODULES[arch_id]}")
    return mod.REDUCED if reduced else mod.CONFIG


from .shapes import SHAPE_CASES, ShapeCase, applicable, input_specs, smoke_batch  # noqa: E402

__all__ = ["ARCH_IDS", "get_config", "SHAPE_CASES", "ShapeCase",
           "applicable", "input_specs", "smoke_batch"]
