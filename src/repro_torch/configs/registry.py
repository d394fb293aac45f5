"""Architecture registry: ``--arch <id>`` resolution and shape
applicability, all ten of the reference's archs in its order.

Every arch takes ``train_4k``, ``prefill_32k`` and ``decode_32k``;
``long_500k`` only a sub-quadratic one (``SUBQUADRATIC`` in its module).
"""

from __future__ import annotations

import importlib
from typing import Any, Tuple

from repro_torch.configs.base import (with_fused_linears,
                                      with_overlap_executor)
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.models.transformer import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke", "arch_shapes",
           "is_subquadratic", "all_cells"]

_MODULES = {
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)

_UNSET = object()   # None is itself a valid knob value (auto)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    return importlib.import_module(_MODULES[arch])


def _knobs(cfg: ModelConfig, use_kernel: Any, overlap: Any) -> ModelConfig:
    if use_kernel is not _UNSET:
        cfg = with_fused_linears(cfg, use_kernel)
    if overlap is not _UNSET:
        cfg = with_overlap_executor(cfg, overlap)
    return cfg


def get_config(arch: str, use_kernel: Any = _UNSET,
               overlap: Any = _UNSET) -> ModelConfig:
    """The full config of ``arch``; ``use_kernel`` overrides the fused
    kernel knob and ``overlap`` the sharded executor's overlap knob, each
    when passed."""
    return _knobs(_mod(arch).CONFIG, use_kernel, overlap)


def get_smoke(arch: str, use_kernel: Any = _UNSET,
              overlap: Any = _UNSET) -> ModelConfig:
    """The smoke-size config of ``arch`` (same overrides)."""
    return _knobs(_mod(arch).SMOKE, use_kernel, overlap)


def is_subquadratic(arch: str) -> bool:
    """Whether ``arch`` takes the ``long_500k`` cell."""
    return bool(_mod(arch).SUBQUADRATIC)


def arch_shapes(arch: str) -> Tuple[ShapeSpec, ...]:
    """The shapes of ``arch``'s dry-run cells: the three LM shapes, and
    ``long_500k`` for a sub-quadratic arch."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if is_subquadratic(arch):
        names.append("long_500k")
    return tuple(SHAPES[n] for n in names)


def all_cells():
    """Every ``(arch, shape, applicable)``, ``long_500k`` of a quadratic
    arch included with ``applicable`` False."""
    cells = []
    for arch in ARCH_IDS:
        sub = is_subquadratic(arch)
        for name, spec in SHAPES.items():
            cells.append((arch, spec, name != "long_500k" or sub))
    return cells
