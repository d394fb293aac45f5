"""Architecture registry: ``--arch <id>`` resolution, all ten of the
reference's archs."""

from __future__ import annotations

import importlib
from typing import Any, Tuple

from repro_torch.configs.base import with_fused_linears
from repro_torch.models.transformer import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke"]

_MODULES = {
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)

_UNSET = object()   # None is itself a valid knob value (auto)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str, use_kernel: Any = _UNSET) -> ModelConfig:
    """The full config of ``arch``; ``use_kernel`` overrides the fused
    kernel knob when passed."""
    cfg = _mod(arch).CONFIG
    return cfg if use_kernel is _UNSET else with_fused_linears(cfg,
                                                               use_kernel)


def get_smoke(arch: str, use_kernel: Any = _UNSET) -> ModelConfig:
    """The smoke-size config of ``arch`` (same override)."""
    cfg = _mod(arch).SMOKE
    return cfg if use_kernel is _UNSET else with_fused_linears(cfg,
                                                               use_kernel)
