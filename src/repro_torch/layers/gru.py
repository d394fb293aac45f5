"""GRU with SPM-substituted dense maps, the paper's §6 (port of
``repro/layers/gru.py``).

Every one of the six affine maps (W_z, U_z, W_r, U_r, W_h, U_h) is an
independent instance of the linear factory, so ``linear_impl`` switches the
whole recurrence between the paper's dense baseline and SPM.  The
recurrence itself (gates, convex update) is untouched — paper §6.2:
"preserves the algebraic structure of the GRU".

The reference's ``lax.scan`` over time is a Python loop here, in the same
order: each step applies all six maps, so an SPM GRU launches six fused
operators (K1 runs) a step forward and their K2 runs backward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.linear import LinearConfig, init_linear, linear_apply
from repro_torch.device import resolve_device
from repro_torch.params import Params

__all__ = ["GRUConfig", "init_gru", "gru_apply", "gru_cell"]

_MAPS = ("wz", "uz", "wr", "ur", "wh", "uh")


@dataclasses.dataclass(frozen=True)
class GRUConfig:
    """A GRU layer; every map takes ``linear_impl``."""

    d_in: int
    d_hidden: int
    linear_impl: str = "dense"
    spm_stages: Optional[int] = None
    spm_backward: str = "autodiff"
    spm_use_kernel: Optional[bool] = None
    spm_schedule: str = "butterfly"
    spm_n_shards: int = 1
    spm_overlap: Optional[bool] = None
    spm_quant_acts: bool = False
    spm_quant_coeffs: bool = False
    param_dtype: torch.dtype = torch.float32

    def _lin(self, d_in: int, d_out: int, bias: bool) -> LinearConfig:
        return LinearConfig(
            d_in=d_in, d_out=d_out, impl=self.linear_impl, use_bias=bias,
            n_stages=self.spm_stages, backward=self.spm_backward,
            use_kernel=self.spm_use_kernel, schedule=self.spm_schedule,
            n_shards=self.spm_n_shards, overlap=self.spm_overlap,
            quant_acts=self.spm_quant_acts,
            quant_coeffs=self.spm_quant_coeffs,
            param_dtype=self.param_dtype)

    @property
    def w(self) -> LinearConfig:
        """The input maps W_. (with bias b_.)."""
        return self._lin(self.d_in, self.d_hidden, True)

    @property
    def u(self) -> LinearConfig:
        """The recurrent maps U_. (no bias)."""
        return self._lin(self.d_hidden, self.d_hidden, False)


def init_gru(generator: torch.Generator, cfg: GRUConfig,
             device=None) -> Params:
    """The six maps, drawn in the reference's order from ``generator`` on
    its own device, then moved to ``device`` (``cuda`` unless the caller
    asks for the CPU)."""
    dev = resolve_device(device)
    at = generator.device
    return Params({k: init_linear(cfg.w if k[0] == "w" else cfg.u,
                                  generator, at) for k in _MAPS}).to(dev)


def gru_cell(params, x_t: torch.Tensor, h_prev: torch.Tensor,
             cfg: GRUConfig) -> torch.Tensor:
    """One step (paper eqs. 20–23).  x_t: (B, d_in); h_prev: (B, d_h)."""
    z = torch.sigmoid(linear_apply(params["wz"], x_t, cfg.w)
                      + linear_apply(params["uz"], h_prev, cfg.u))
    r = torch.sigmoid(linear_apply(params["wr"], x_t, cfg.w)
                      + linear_apply(params["ur"], h_prev, cfg.u))
    h_tilde = torch.tanh(linear_apply(params["wh"], x_t, cfg.w)
                         + linear_apply(params["uh"], r * h_prev, cfg.u))
    return (1.0 - z) * h_prev + z * h_tilde


def gru_apply(params, x: torch.Tensor, cfg: GRUConfig,
              h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d_in) -> (hs (B, T, d_h), h_T)."""
    h = (torch.zeros(x.shape[0], cfg.d_hidden, dtype=x.dtype,
                     device=x.device) if h0 is None else h0)
    hs = []
    for t in range(x.shape[1]):
        h = gru_cell(params, x[:, t], h, cfg)
        hs.append(h)
    return torch.stack(hs, dim=1), h
