"""Architecture registry: ``--arch <id>`` resolution.  This slice ports one
arch, ``qwen3-1.7b``; the others wait (ROADMAP.md §1)."""

from __future__ import annotations

import importlib
from typing import Any, Tuple

from repro_torch.configs.base import with_fused_linears
from repro_torch.models.transformer import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke"]

_MODULES = {"qwen3-1.7b": "repro_torch.configs.qwen3_1_7b"}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)

_UNSET = object()   # None is itself a valid knob value (auto)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown or unported arch {arch!r}; "
                       f"ported: {list(_MODULES)}")
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
