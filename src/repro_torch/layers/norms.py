"""RMSNorm, per-head qk-norm and the fused norm -> linear entry (port of
``repro/layers/norms.py``).

``rms_norm`` computes its statistics in f32 and casts back to x's dtype.
``norm_linear_apply`` runs the norm inside the block kernel's prologue
(K3 without a second stack) when the block resolves fused, so the
normalized activation is never stored; that path does not cast it back.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.eligibility import resolve_block_fuse
from repro_torch.core.linear import (LinearConfig, linear_apply,
                                     spm_block_operands)

__all__ = ["init_rms_norm", "rms_norm", "qk_norm", "norm_linear_apply"]


def init_rms_norm(d: int, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> dict:
    """``{"scale": ones(d)}``."""
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rms_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis; stats in f32, result in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def qk_norm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm over head_dim.  x: (..., head_dim)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def norm_linear_apply(norm_params, params, x: torch.Tensor,
                      cfg: LinearConfig, block_fuse: Optional[bool] = None,
                      eps: float = 1e-6) -> torch.Tensor:
    """``linear_apply(params, rms_norm(norm_params, x))``, with the norm in
    the kernel's prologue when ``block_fuse`` resolves on and the linear
    has block operands (not dense, not quantized)."""
    bundle = spm_block_operands(params, cfg)
    if resolve_block_fuse(block_fuse, bundle is not None):
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.spm_block_fused(
            x, coeffs1=bundle["coeffs"], d_in1=bundle["d_in"],
            d_out1=bundle["d_out"], bias1=bundle["bias"],
            strides1=bundle["strides"], gamma=norm_params["scale"],
            out_width=cfg.d_out, eps=eps)
    return linear_apply(params, rms_norm(norm_params, x, eps=eps), cfg)
