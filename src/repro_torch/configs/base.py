"""Config construction helpers (port of the parts of
``repro/configs/base.py`` that the ported archs use)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.models.transformer import LayerSpec, ModelConfig

__all__ = ["dense_layers", "with_overrides", "with_fused_linears"]


def dense_layers(n: int) -> Tuple[LayerSpec, ...]:
    """``n`` identical full-attention + dense-FFN layers."""
    return tuple([LayerSpec()] * n)


def with_overrides(cfg: ModelConfig, **kw) -> ModelConfig:
    """Frozen-dataclass field override."""
    return dataclasses.replace(cfg, **kw)


def with_fused_linears(cfg: ModelConfig,
                       on: Optional[bool] = True) -> ModelConfig:
    """Set the fused-kernel knob ``spm_use_kernel`` on every SPM linear
    (None = auto, the kernel path; True = the same, forced; False = the
    composition)."""
    return dataclasses.replace(cfg, spm_use_kernel=on)
