"""Config construction helpers (port of the parts of
``repro/configs/base.py`` that the ported archs use)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.models.transformer import LayerSpec, ModelConfig

__all__ = ["dense_layers", "with_overrides", "with_fused_linears",
           "with_quantized_io"]


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


def with_quantized_io(cfg: ModelConfig) -> ModelConfig:
    """Set the int8 knobs on every SPM linear: ``spm_quant_acts`` (int8
    activation I/O between the kernel runs, for plans whose runs share one
    tile; the others keep f32/bf16 I/O) and ``spm_quant_coeffs`` (int8
    coefficient tables with one scale a stage).  Quantized linears are
    never block-fused."""
    return dataclasses.replace(cfg, spm_quant_acts=True,
                               spm_quant_coeffs=True)
