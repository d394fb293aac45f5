"""Mixture-of-Experts FFN with GShard-style capacity dispatch (port of
``repro/layers/moe.py``).

Tokens are split into G groups of S; routing capacity is per (group,
expert), so the dispatch one-hot is (G, S, E, C) with C = ``capacity(S)``.
The router is a dense d -> E map computed in f32, and the dispatch and
combine are one-hot einsums in x's dtype, as in the reference (none of
them is a Pallas kernel there).  The experts' FFNs are stored stacked,
every leaf (E, ...), and run as one ``ffn_apply`` over the (E, G*C, d)
dispatched rows: each run of each expert linear is ONE K1 launch for all
experts (K2 backward), the kernels' expert mode, as the reference's
``jax.vmap`` of ``ffn_apply`` adds a grid axis to its Pallas calls.

Semantics kept from the reference, and what follows from them:

* top-k takes the lower expert index first among equal logits (a stable
  descending sort; ``jax.lax.top_k``'s order), so an all-zero row picks
  experts 0..k-1;
* the aux loss comes from the softmax over all logits and the
  pre-capacity mask;
* a token's rank in its (group, expert) is a cumsum over the group, so a
  token's output depends on the other tokens of its group through the
  capacity;
* the one-hot einsums multiply every slot by every token of the group, so
  a NaN in one token's row reaches every expert slot of its group
  (``0 * NaN``), and with them every token of the group.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.layers.ffn import FFNConfig, ffn_apply, init_ffn
from repro_torch.params import Params

__all__ = ["MoEConfig", "init_moe", "route_groups", "moe_apply"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Expert geometry, capacity and the SPM knobs the experts inherit."""

    d_model: int
    d_ff: int                 # per-expert hidden dim
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 512     # GShard "S": tokens routed together
    shared_d_ff: int = 0      # Llama4-style always-on shared expert (0: off)
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

    def _ffn(self, d_ff: int) -> FFNConfig:
        return FFNConfig(d_model=self.d_model, d_ff=d_ff,
                         linear_impl=self.linear_impl,
                         spm_stages=self.spm_stages,
                         spm_backward=self.spm_backward,
                         spm_use_kernel=self.spm_use_kernel,
                         spm_schedule=self.spm_schedule,
                         spm_n_shards=self.spm_n_shards,
                         spm_overlap=self.spm_overlap,
                         spm_quant_acts=self.spm_quant_acts,
                         spm_quant_coeffs=self.spm_quant_coeffs,
                         param_dtype=self.param_dtype)

    @property
    def expert_ffn(self) -> FFNConfig:
        """One expert's (swiglu) FFN."""
        return self._ffn(self.d_ff)

    @property
    def shared_ffn(self) -> FFNConfig:
        """The shared expert's FFN."""
        return self._ffn(self.shared_d_ff)

    def capacity(self, group_tokens: int) -> int:
        """Slots per (group, expert): ``int(cf * k * S / E)``, at least k."""
        c = int(self.capacity_factor * self.top_k * group_tokens
                / self.n_experts)
        return max(c, self.top_k)


def init_moe(cfg: MoEConfig, generator: torch.Generator,
             device: torch.device) -> Params:
    """``router`` (d, E) 0.02-normal, ``experts`` (every leaf (E, ...)) and,
    with ``shared_d_ff``, the ``shared`` expert."""
    p = {"router": 0.02 * torch.randn(cfg.d_model, cfg.n_experts,
                                      generator=generator, device=device,
                                      dtype=cfg.param_dtype),
         "experts": init_ffn(cfg.expert_ffn, generator, device,
                             lead=(cfg.n_experts,))}
    if cfg.shared_d_ff:
        p["shared"] = init_ffn(cfg.shared_ffn, generator, device)
    return Params(p)


def _top_k_gating(logits: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (..., E) -> (gates (..., E) renormalized over the chosen k,
    mask (..., E) of the chosen).  Ties go to the lower index."""
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    # jax.nn.softmax's own formula (its exp and torch's differ by an ulp on
    # some inputs, so the gates agree with the reference's to an ulp)
    e = torch.exp(topv - topv.max(dim=-1, keepdim=True).values)
    probs = e / e.sum(dim=-1, keepdim=True)
    onehot = (topi[..., None] == torch.arange(
        logits.shape[-1], device=logits.device)).to(logits.dtype)
    gates = torch.einsum("...k,...ke->...e", probs, onehot)
    mask = onehot.sum(dim=-2) > 0
    return gates, mask


def route_groups(cfg: MoEConfig, n_tok: int) -> Tuple[int, int, int]:
    """(S, G, C) for ``n_tok`` tokens: the group size ``min(group_size,
    n_tok)``, lowered until it divides ``n_tok``, the groups, and the
    capacity.  Each expert's FFN runs over G * C rows."""
    S = min(cfg.group_size, n_tok)
    while n_tok % S:
        S -= 1
    return S, n_tok // S, cfg.capacity(S)


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, d) -> (y in x's dtype, aux f32 scalar): the Switch-style
    load-balancing loss ``sum(mean softmax * mean mask) * E / k``."""
    B, T, d = x.shape
    S, G, cap = route_groups(cfg, B * T)
    E = cfg.n_experts

    xg = x.reshape(G, S, d)
    logits = torch.matmul(xg.float(), params["router"].float())
    gates, mask = _top_k_gating(logits, cfg.top_k)         # (G, S, E)

    me = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
    ce = mask.float().mean(dim=(0, 1)) * E / cfg.top_k
    aux = torch.sum(me * ce)

    pos = torch.cumsum(mask.int(), dim=1) - 1               # (G, S, E)
    keep = mask & (pos < cap)
    gates = torch.where(keep, gates, torch.zeros_like(gates))
    slot = torch.where(keep, pos, torch.full_like(pos, -1))
    pos_oh = (slot[..., None] == torch.arange(cap, device=x.device)
              ).to(x.dtype)                                 # (G, S, E, C)
    combine = gates.to(x.dtype)[..., None] * pos_oh

    xe = torch.einsum("gsec,gsd->egcd", pos_oh, xg)
    ye = ffn_apply(params["experts"], xe.reshape(E, G * cap, d),
                   cfg.expert_ffn).reshape(E, G, cap, d)
    y = torch.einsum("gsec,egcd->gsd", combine, ye).reshape(B, T, d)
    if cfg.shared_d_ff:
        y = y + ffn_apply(params["shared"], x, cfg.shared_ffn)
    return y.to(x.dtype), aux
