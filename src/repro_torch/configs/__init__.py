"""Architecture registry: ``get_config(arch)`` resolves an id here.

The port's copy of ``repro/configs/__init__.py``.  Every configuration is
copied, and :func:`repro_torch.models.build_model` builds every family.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES, InputShape, ModelConfig)

ARCH_IDS = (
    "granite-34b", "yi-9b", "whisper-large-v3", "granite-8b",
    "recurrentgemma-9b", "phi-3-vision-4.2b", "rwkv6-7b", "llama3-8b",
    "llama4-maverick-400b-a17b", "qwen3-moe-235b-a22b",
)

_MODULES = {
    "granite-34b": "granite_34b",
    "yi-9b": "yi_9b",
    "whisper-large-v3": "whisper_large_v3",
    "granite-8b": "granite_8b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "rwkv6-7b": "rwkv6_7b",
    "llama3-8b": "llama3_8b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
