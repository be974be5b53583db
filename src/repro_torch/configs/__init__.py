"""Architecture registry: ``get(arch_id)`` returns the full-size ModelConfig,
``get_smoke(arch_id)`` a reduced same-family config for CPU tests.

The reference's ten LM configs, every family (dense, moe, hybrid, ssm);
``tensorcodec-paper`` holds the codec's presets and is not an LM.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_ARCH_MODULES = {
    "deepseek-coder-33b": "deepseek_coder_33b",
    "minicpm-2b": "minicpm_2b",
    "starcoder2-15b": "starcoder2_15b",
    "qwen1.5-4b": "qwen1_5_4b",
    "grok-1-314b": "grok_1_314b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "mamba2-1.3b": "mamba2_1_3b",
    "internvl2-76b": "internvl2_76b",
    "musicgen-medium": "musicgen_medium",
    "tensorcodec-paper": "tensorcodec_paper",
}

ARCH_IDS = [a for a in _ARCH_MODULES if a != "tensorcodec-paper"]


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "get", "get_smoke"]
