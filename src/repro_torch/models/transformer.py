"""Transformer composer for attention-only, dense-FFN stacks (port of
``repro/models/transformer.py``).

One ``ModelConfig`` keeps the reference's fields, so a reference config
carries over; this slice runs the layers it needs (attention mixer, dense
FFN, default RoPE) and raises ``NotImplementedError`` for MoE, Mamba, the
shared block and M-RoPE, naming the roadmap item.  Layers run in a Python
loop over an ``nn.ModuleList`` (the reference's ``scan`` over stacked
params; ``convert.params_from_jax`` unstacks those).  With ``remat`` (the
default, as in the reference) and no cache, each layer runs under
``torch.utils.checkpoint`` (non-reentrant), as ``jax.checkpoint`` wraps it
there: the backward recomputes the layer's forward, kernels included, under
the feature-sharding context of the original forward
(``parallel/ctx.use_context``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.layers.attention import (AttentionConfig, attention_apply,
                                          init_attention, init_kv_cache)
from repro_torch.layers.embedding import (EmbeddingConfig, embed,
                                          init_embedding, unembed)
from repro_torch.layers.ffn import FFNConfig, ffn_block_apply, init_ffn
from repro_torch.layers.norms import init_rms_norm, rms_norm
from repro_torch.layers.rope import rope_angles
from repro_torch.parallel import ctx as par_ctx
from repro_torch.params import Params

__all__ = ["LayerSpec", "ModelConfig", "init_model", "init_cache",
           "forward", "dtype_of"]

_ROADMAP = "ROADMAP.md §1 (the other archs)"


def dtype_of(d: Any) -> torch.dtype:
    """A torch dtype from a dtype or its name (``"float32"``)."""
    return d if isinstance(d, torch.dtype) else getattr(torch, str(d))


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer's pattern entry (the reference's fields)."""

    mixer: str = "attn"              # "attn" | "mamba"
    mlp: str = "dense"               # "dense" | "moe" | "none"
    window: Optional[int] = None
    rope: str = "default"
    shared_block: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture and knobs: the reference's fields that this slice
    reads.  The layer pattern carries what it does not run yet (other
    mixers and MLPs, the shared block, local RoPE), which ``_supported``
    refuses by name."""

    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layers: Tuple[LayerSpec, ...]
    qk_norm: bool = False
    rope_theta: float = 1e4
    q_chunk: int = 512
    k_chunk: int = 1024
    linear_impl: str = "dense"
    spm_stages: Optional[int] = None
    spm_backward: str = "custom"
    spm_use_kernel: Optional[bool] = None  # None/True: kernels; False: off
    spm_schedule: str = "butterfly"        # "two_level" + spm_n_shards > 1:
    spm_n_shards: int = 1                  # feature axis distributable over
                                           # a feature mesh
                                           # (parallel/spm_shard.py)
    spm_overlap: Optional[bool] = None     # its overlap schedule (K5/K6)
    ffn_activation: str = "swiglu"
    spm_block_fuse: Optional[bool] = None  # None/True: block kernel; False
    spm_quant_acts: bool = False           # int8 activation I/O (K1/K2)
    spm_quant_coeffs: bool = False         # int8 per-stage coefficient tables
    tie_embeddings: bool = True
    logits_dtype: Any = "float32"
    dtype: Any = "bfloat16"
    param_dtype: Any = "float32"
    remat: bool = True               # checkpoint each layer when training

    def attn_cfg(self, spec: LayerSpec) -> AttentionConfig:
        """The attention config of one layer."""
        return AttentionConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            use_qk_norm=self.qk_norm, window=spec.window,
            linear_impl=self.linear_impl, spm_stages=self.spm_stages,
            spm_backward=self.spm_backward,
            spm_use_kernel=self.spm_use_kernel,
            spm_schedule=self.spm_schedule, spm_n_shards=self.spm_n_shards,
            spm_overlap=self.spm_overlap,
            spm_block_fuse=self.spm_block_fuse,
            spm_quant_acts=self.spm_quant_acts,
            spm_quant_coeffs=self.spm_quant_coeffs, q_chunk=self.q_chunk,
            k_chunk=self.k_chunk, param_dtype=dtype_of(self.param_dtype))

    def ffn_cfg(self) -> FFNConfig:
        """The dense FFN config."""
        return FFNConfig(
            d_model=self.d_model, d_ff=self.d_ff,
            linear_impl=self.linear_impl, activation=self.ffn_activation,
            spm_stages=self.spm_stages, spm_backward=self.spm_backward,
            spm_use_kernel=self.spm_use_kernel,
            spm_schedule=self.spm_schedule, spm_n_shards=self.spm_n_shards,
            spm_overlap=self.spm_overlap,
            spm_block_fuse=self.spm_block_fuse,
            spm_quant_acts=self.spm_quant_acts,
            spm_quant_coeffs=self.spm_quant_coeffs,
            param_dtype=dtype_of(self.param_dtype))

    def embed_cfg(self) -> EmbeddingConfig:
        """The vocabulary table config."""
        return EmbeddingConfig(
            vocab_size=self.vocab_size, d_model=self.d_model,
            tie_output=self.tie_embeddings,
            param_dtype=dtype_of(self.param_dtype))


def _supported(cfg: ModelConfig) -> None:
    for spec in cfg.layers:
        if spec.mixer != "attn":
            raise NotImplementedError(
                f"{cfg.name}: {spec.mixer} mixers are not ported yet "
                f"({_ROADMAP}: Mamba2)")
        if spec.mlp != "dense":
            raise NotImplementedError(
                f"{cfg.name}: {spec.mlp} MLPs are not ported yet "
                f"({_ROADMAP}: MoE)")
        if spec.shared_block:
            raise NotImplementedError(
                f"{cfg.name}: the shared block is not ported yet "
                f"({_ROADMAP}: zamba2)")
        if spec.rope != "default":
            raise NotImplementedError(
                f"{cfg.name}: {spec.rope} RoPE tables are not ported yet "
                f"({_ROADMAP}: mrope and local RoPE)")


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device=None) -> Params:
    """Random weights from ``seed`` on ``device`` (``cuda`` unless the
    caller asks for the CPU).  Keys: ``embed``, ``layers`` (a list: one
    ``norm1``/``mixer``/``norm2``/``mlp`` tree per layer), ``final_norm``."""
    _supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pdt = dtype_of(cfg.param_dtype)
    layers = []
    for spec in cfg.layers:
        layers.append({
            "norm1": init_rms_norm(cfg.d_model, dev, pdt),
            "mixer": init_attention(cfg.attn_cfg(spec), gen, dev),
            "norm2": init_rms_norm(cfg.d_model, dev, pdt),
            "mlp": init_ffn(cfg.ffn_cfg(), gen, dev)})
    return Params({"embed": init_embedding(cfg.embed_cfg(), gen, dev),
                   "layers": layers,
                   "final_norm": init_rms_norm(cfg.d_model, dev, pdt)})


def init_cache(batch: int, max_len: int, cfg: ModelConfig, *,
               device, dtype: torch.dtype = torch.bfloat16) -> list:
    """One ``{"mixer": {"k", "v"}}`` KV cache per layer."""
    return [{"mixer": init_kv_cache(batch, max_len, cfg.attn_cfg(spec),
                                    device, dtype)}
            for spec in cfg.layers]


def _apply_layer(lp, spec: LayerSpec, cfg: ModelConfig, h: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor, cache,
                 cache_index) -> torch.Tensor:
    """One layer: ``h + attn(norm1(h))``, then the FFN residual block."""
    y, _ = attention_apply(lp["mixer"], h, cfg.attn_cfg(spec), cos=cos,
                           sin=sin, cache=cache, cache_index=cache_index,
                           norm_params=lp["norm1"])
    h = h + y
    return ffn_block_apply(lp["mlp"], lp["norm2"], h, cfg.ffn_cfg())


def _recompute_safe_layer(sharding, lp, spec, cfg, h, cos, sin):
    """A checkpointed layer: its recompute, which may run on another
    thread, sees the forward's feature-sharding context."""
    with par_ctx.use_context(sharding):
        return _apply_layer(lp, spec, cfg, h, cos, sin, None, None)


def forward(params, cfg: ModelConfig, *, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None, cache=None,
            cache_index: Optional[int] = None, last_only: bool = False):
    """Returns ``(logits, cache)``.  ``cache=None`` is the plain causal
    forward; with a cache, T > 1 prefills from ``cache_index`` and T == 1
    decodes at the scalar ``cache_index``.  ``last_only`` computes the
    logits of the last position only, (B, 1, V), which is all a prefill
    returns."""
    _supported(cfg)
    B, T = tokens.shape
    h = embed(params["embed"], tokens, cfg.embed_cfg(), dtype_of(cfg.dtype))
    if positions is None:
        start = 0 if cache_index is None else int(cache_index)
        positions = (start + torch.arange(T, device=tokens.device)
                     ).expand(B, T)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    sharding = par_ctx.current_context()
    for i, spec in enumerate(cfg.layers):
        lp = params["layers"][i]
        if cache is None and cfg.remat:
            h = torch.utils.checkpoint.checkpoint(
                _recompute_safe_layer, sharding, lp, spec, cfg, h, cos, sin,
                use_reentrant=False)
        else:
            lc = None if cache is None else cache[i]["mixer"]
            h = _apply_layer(lp, spec, cfg, h, cos, sin, lc, cache_index)
    if last_only:
        h = h[:, -1:]
    h = rms_norm(params["final_norm"], h)
    logits = unembed(params["embed"], h.to(dtype_of(cfg.logits_dtype)),
                     cfg.embed_cfg())
    return logits, cache

