"""Architecture registry: ``get(arch_id)`` returns the full-size ModelConfig,
``get_smoke(arch_id)`` a reduced same-family config for CPU tests.

Only the dense families are ported; the MoE, hybrid, SSM, VLM and audio
configs come with their families (ROADMAP A.9).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_ARCH_MODULES = {
    "deepseek-coder-33b": "deepseek_coder_33b",
    "minicpm-2b": "minicpm_2b",
    "starcoder2-15b": "starcoder2_15b",
    "qwen1.5-4b": "qwen1_5_4b",
}

ARCH_IDS = list(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown or unported arch {arch_id!r}; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")


def get(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "get", "get_smoke"]
