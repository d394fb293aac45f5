"""Feed-forward block (port of ``repro/layers/ffn.py``).

``"swiglu"`` (default) is gated, ``down(silu(gate(x)) * up(x))``, and always
takes the per-linear path: each projection is one ``spm_apply`` (K1 runs),
the gate product runs in x's dtype between them, and the pre-norm is the
plain ``rms_norm``.  Ungated ``"relu" | "silu" | "gelu"`` blocks of
block-fusible linears run as ONE K3 launch in ``ffn_block_apply``: norm, up
stack, activation, down stack and residual add.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.eligibility import (block_fusion_eligible,
                                          resolve_block_fuse)
from repro_torch.core.linear import (LinearConfig, init_linear, linear_apply,
                                     spm_block_operands)
from repro_torch.layers.norms import rms_norm
from repro_torch.params import Params

__all__ = ["FFNConfig", "init_ffn", "ffn_apply", "ffn_block_apply"]

_ACTS = {"relu": torch.relu, "silu": F.silu,
         "gelu": lambda u: F.gelu(u, approximate="tanh")}


@dataclasses.dataclass(frozen=True)
class FFNConfig:
    """FFN geometry and the SPM knobs its linears inherit."""

    d_model: int
    d_ff: int
    linear_impl: str = "dense"
    activation: str = "swiglu"           # "swiglu" | "relu" | "silu" | "gelu"
    spm_stages: Optional[int] = None
    spm_backward: str = "autodiff"
    spm_use_kernel: Optional[bool] = None
    spm_schedule: str = "butterfly"
    spm_n_shards: int = 1
    spm_overlap: Optional[bool] = None
    spm_block_fuse: Optional[bool] = None
    spm_quant_acts: bool = False
    spm_quant_coeffs: bool = False
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.activation != "swiglu" and self.activation not in _ACTS:
            raise ValueError(f"unknown ffn activation {self.activation!r}")

    def _lin(self, d_in: int, d_out: int) -> LinearConfig:
        return LinearConfig(
            d_in=d_in, d_out=d_out, impl=self.linear_impl, use_bias=False,
            n_stages=self.spm_stages, backward=self.spm_backward,
            use_kernel=self.spm_use_kernel, schedule=self.spm_schedule,
            n_shards=self.spm_n_shards, overlap=self.spm_overlap,
            param_dtype=self.param_dtype, quant_acts=self.spm_quant_acts,
            quant_coeffs=self.spm_quant_coeffs)

    @property
    def up(self) -> LinearConfig:
        """d_model -> d_ff."""
        return self._lin(self.d_model, self.d_ff)

    @property
    def gate(self) -> LinearConfig:
        """d_model -> d_ff (swiglu only)."""
        return self._lin(self.d_model, self.d_ff)

    @property
    def down(self) -> LinearConfig:
        """d_ff -> d_model."""
        return self._lin(self.d_ff, self.d_model)


def init_ffn(cfg: FFNConfig, generator: torch.Generator,
             device: torch.device) -> Params:
    """``up`` and ``down`` (and ``gate`` for swiglu)."""
    p = {"up": init_linear(cfg.up, generator, device)}
    if cfg.activation == "swiglu":
        p["gate"] = init_linear(cfg.gate, generator, device)
    p["down"] = init_linear(cfg.down, generator, device)
    return Params(p)


def ffn_apply(params, x: torch.Tensor, cfg: FFNConfig) -> torch.Tensor:
    """The FFN body alone: swiglu or ``down(act(up(x)))``."""
    u = linear_apply(params["up"], x, cfg.up)
    if cfg.activation == "swiglu":
        g = linear_apply(params["gate"], x, cfg.gate)
        h = F.silu(g) * u
    else:
        h = _ACTS[cfg.activation](u)
    return linear_apply(params["down"], h, cfg.down)


def _block_bundles(params, cfg: FFNConfig):
    if cfg.activation == "swiglu":
        return None
    up = spm_block_operands(params["up"], cfg.up)
    down = spm_block_operands(params["down"], cfg.down)
    if up is None or down is None or down["n"] != up["n"]:
        return None
    if not block_fusion_eligible(up["n"], up["strides"], down["strides"],
                                 cfg.activation):
        return None
    return up, down


def ffn_block_apply(params, norm_params, x: torch.Tensor,
                    cfg: FFNConfig) -> torch.Tensor:
    """The residual block ``x + ffn(rms_norm(x))``: one K3 launch when it
    resolves fused, else the per-linear composition.  ``norm_params=None``
    skips the norm."""
    bundles = _block_bundles(params, cfg)
    if resolve_block_fuse(cfg.spm_block_fuse, bundles is not None):
        from repro_torch.kernels import ops as kernel_ops
        up, down = bundles
        return kernel_ops.spm_block_fused(
            x, coeffs1=up["coeffs"], d_in1=up["d_in"], d_out1=up["d_out"],
            bias1=up["bias"], strides1=up["strides"],
            gamma=None if norm_params is None else norm_params["scale"],
            coeffs2=down["coeffs"], d_in2=down["d_in"],
            d_out2=down["d_out"], bias2=down["bias"],
            strides2=down["strides"], activation=cfg.activation,
            residual=True, mid_width=cfg.d_ff, out_width=cfg.d_model)
    h = rms_norm(norm_params, x) if norm_params is not None else x
    return x + ffn_apply(params, h, cfg)
