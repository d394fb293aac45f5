"""Block-pattern transformer composer (port of
``repro/models/transformer.py``).

One ``ModelConfig`` keeps the reference's fields, so a reference config
carries over: attention mixers with full or sliding-window caches, Mamba2
mixers with their conv and SSM caches, dense, MoE or no MLP, zamba2's
shared attention + FFN block applied before flagged layers, default, local
and M-RoPE tables, token or embedding inputs, ``embed_scale``.  Layers run
in a Python loop over an ``nn.ModuleList`` (the reference's ``scan`` over
stacked params, whose ``scan_group`` only ``stack_key`` reads;
``convert.params_from_jax`` unstacks groups of any length); the shared
block's params sit once at the top level.  With ``remat`` (the default, as
in the reference) and no cache, each layer runs under
``torch.utils.checkpoint`` (non-reentrant), as ``jax.checkpoint`` wraps it
there, its shared block included: the backward recomputes the layer's
forward, kernels included, under the feature-sharding context of the
original forward (``parallel/ctx.use_context``).  ``forward`` returns the
summed MoE aux loss beside the logits and the cache.
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
from repro_torch.layers.mamba2 import (Mamba2Config, init_mamba2,
                                       init_ssm_cache, mamba2_apply)
from repro_torch.layers.moe import MoEConfig, init_moe, moe_apply
from repro_torch.layers.norms import init_rms_norm, rms_norm
from repro_torch.layers.rope import mrope_angles, rope_angles
from repro_torch.parallel import ctx as par_ctx
from repro_torch.params import Params

__all__ = ["LayerSpec", "ModelConfig", "init_model", "init_cache",
           "forward", "dtype_of", "stack_groups", "stack_key",
           "model_param_count"]


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
    """Architecture and knobs: the reference's fields that the port
    reads."""

    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layers: Tuple[LayerSpec, ...]
    scan_group: int = 1              # the reference's scan period (0:
                                     # unrolled); only its parameter
                                     # layout reads it here (stack_key)
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_local_theta: float = 1e4
    rope_kind: str = "default"       # "default" | "mrope"
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    q_chunk: int = 512
    k_chunk: int = 1024
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    ssm_state: int = 0
    ssm_head: int = 64
    ssm_chunk: int = 128
    shared_attn_d_ff: int = 0        # zamba2's shared block
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
    compress_pod_grads: bool = False       # --compress-pod-grads, read by
                                           # launch.train; kept as a field
                                           # for field-for-field parity
                                           # with the reference's config
    input_kind: str = "tokens"       # "tokens" | "embeddings"
    tie_embeddings: bool = True
    embed_scale: float = 1.0
    embed_onehot: bool = False       # the lookup as a one-hot product
    logits_dtype: Any = "float32"
    dtype: Any = "bfloat16"
    param_dtype: Any = "float32"
    remat: bool = True               # checkpoint each layer when training

    def _spm(self) -> dict:
        """The SPM knobs every sub-config inherits."""
        return dict(
            linear_impl=self.linear_impl, spm_stages=self.spm_stages,
            spm_backward=self.spm_backward,
            spm_use_kernel=self.spm_use_kernel,
            spm_schedule=self.spm_schedule, spm_n_shards=self.spm_n_shards,
            spm_overlap=self.spm_overlap,
            spm_quant_acts=self.spm_quant_acts,
            spm_quant_coeffs=self.spm_quant_coeffs,
            param_dtype=dtype_of(self.param_dtype))

    def attn_cfg(self, spec: LayerSpec) -> AttentionConfig:
        """The attention config of one layer."""
        return AttentionConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            use_qk_norm=self.qk_norm, window=spec.window,
            spm_block_fuse=self.spm_block_fuse, q_chunk=self.q_chunk,
            k_chunk=self.k_chunk, **self._spm())

    def ffn_cfg(self) -> FFNConfig:
        """The dense FFN config."""
        return FFNConfig(
            d_model=self.d_model, d_ff=self.d_ff,
            activation=self.ffn_activation,
            spm_block_fuse=self.spm_block_fuse, **self._spm())

    def moe_cfg(self) -> MoEConfig:
        """The MoE MLP config."""
        return MoEConfig(
            d_model=self.d_model, d_ff=self.moe_d_ff,
            n_experts=self.n_experts, top_k=self.top_k,
            capacity_factor=self.capacity_factor,
            shared_d_ff=self.shared_d_ff, **self._spm())

    def mamba_cfg(self) -> Mamba2Config:
        """The Mamba2 mixer config."""
        return Mamba2Config(
            d_model=self.d_model, d_state=self.ssm_state,
            d_head=self.ssm_head, chunk=self.ssm_chunk, **self._spm())

    def shared_attn_cfg(self) -> AttentionConfig:
        """The shared block's attention (a global attention layer's)."""
        return self.attn_cfg(LayerSpec(mixer="attn"))

    def shared_ffn_cfg(self) -> FFNConfig:
        """The shared block's FFN."""
        return dataclasses.replace(self.ffn_cfg(),
                                   d_ff=self.shared_attn_d_ff)

    @property
    def has_shared_block(self) -> bool:
        """Whether any layer applies the shared block."""
        return any(s.shared_block for s in self.layers)

    def embed_cfg(self) -> EmbeddingConfig:
        """The vocabulary table config."""
        return EmbeddingConfig(
            vocab_size=self.vocab_size, d_model=self.d_model,
            tie_output=self.tie_embeddings,
            param_dtype=dtype_of(self.param_dtype))


def stack_groups(cfg: ModelConfig) -> int:
    """The layers in one group of the reference's stacked layout: the
    ``scan_group`` of a scanned pattern, 1 for a uniform stack (the shared
    block's flag aside), 0 when the layers are not stacked."""
    g = cfg.scan_group
    if g > 0 and cfg.n_layers % g == 0 and all(
            cfg.layers[i] == cfg.layers[i % g] for i in range(cfg.n_layers)):
        return g
    base = dataclasses.replace(cfg.layers[0], shared_block=False)
    return 1 if all(dataclasses.replace(s, shared_block=False) == base
                    for s in cfg.layers) else 0


def stack_key(cfg: ModelConfig):
    """``key(name)``: the reference's array that the port's parameter
    ``name`` is part of.  The reference stacks the layers of a scanned
    pattern (``scan_group`` g, layer i in group ``l{i % g}``) or of a
    uniform stack (one group) into one array a leaf; unstacked layers, and
    everything outside ``layers``, are arrays of their own.  Whatever acts
    on whole arrays (a per-tensor int8 scale) acts on the group."""
    g = stack_groups(cfg)

    def key(name: str) -> str:
        if not (g and name.startswith("layers.")):
            return name
        _, i, rest = name.split(".", 2)
        return f"layers.l{int(i) % g}.{rest}"

    return key


def _init_layer(spec: LayerSpec, cfg: ModelConfig, gen: torch.Generator,
                dev: torch.device) -> dict:
    pdt = dtype_of(cfg.param_dtype)
    p = {"norm1": init_rms_norm(cfg.d_model, dev, pdt)}
    if spec.mixer == "attn":
        p["mixer"] = init_attention(cfg.attn_cfg(spec), gen, dev)
    elif spec.mixer == "mamba":
        p["mixer"] = init_mamba2(cfg.mamba_cfg(), gen, dev)
    else:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    if spec.mlp != "none":
        p["norm2"] = init_rms_norm(cfg.d_model, dev, pdt)
        if spec.mlp == "dense":
            p["mlp"] = init_ffn(cfg.ffn_cfg(), gen, dev)
        elif spec.mlp == "moe":
            p["mlp"] = init_moe(cfg.moe_cfg(), gen, dev)
        else:
            raise ValueError(f"unknown mlp {spec.mlp!r}")
    return p


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device=None) -> Params:
    """Random weights from ``seed`` on ``device`` (``cuda`` unless the
    caller asks for the CPU).  Keys: ``embed``, ``layers`` (a list: one
    ``norm1``/``mixer``[/``norm2``/``mlp``] tree per layer; MoE experts
    stacked (E, ...)), ``final_norm`` and, with a shared block,
    ``shared`` (``norm1``/``attn``/``norm2``/``ffn``)."""
    dev = resolve_device(device)
    # the meta device has no generator of its own; its draws cost nothing
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    pdt = dtype_of(cfg.param_dtype)
    layers = [_init_layer(spec, cfg, gen, dev) for spec in cfg.layers]
    p = {"embed": init_embedding(cfg.embed_cfg(), gen, dev),
         "layers": layers,
         "final_norm": init_rms_norm(cfg.d_model, dev, pdt)}
    if cfg.has_shared_block:
        p["shared"] = {
            "norm1": init_rms_norm(cfg.d_model, dev, pdt),
            "attn": init_attention(cfg.shared_attn_cfg(), gen, dev),
            "norm2": init_rms_norm(cfg.d_model, dev, pdt),
            "ffn": init_ffn(cfg.shared_ffn_cfg(), gen, dev)}
    return Params(p)


def init_cache(batch: int, max_len: int, cfg: ModelConfig, *,
               device, dtype: torch.dtype = torch.bfloat16) -> list:
    """One cache a layer: ``{"mixer": {"k", "v"}}`` for attention (a
    windowed layer's a ring of ``min(max_len, window)`` slots), ``{"mixer":
    {"ssm", "conv"}}`` for Mamba (f32 whatever ``dtype``), plus a
    ``"shared"`` KV cache at each layer that applies the shared block."""
    out = []
    for spec in cfg.layers:
        c = {"mixer": (init_kv_cache(batch, max_len, cfg.attn_cfg(spec),
                                     device, dtype)
                       if spec.mixer == "attn" else
                       init_ssm_cache(batch, cfg.mamba_cfg(), device))}
        if spec.shared_block:
            c["shared"] = init_kv_cache(batch, max_len,
                                        cfg.shared_attn_cfg(), device, dtype)
        out.append(c)
    return out


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor) -> dict:
    """``{"default", "local"}`` -> (cos, sin), from positions (B, T), or
    (3, B, T) under ``mrope`` (both entries the M-RoPE table).  The local
    table uses ``rope_local_theta`` and is the default one when the two
    thetas are equal."""
    if cfg.rope_kind == "mrope":
        cs = mrope_angles(positions, cfg.head_dim, cfg.mrope_sections,
                          cfg.rope_theta)
        return {"default": cs, "local": cs}
    cs = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    local = (cs if cfg.rope_local_theta == cfg.rope_theta else
             rope_angles(positions, cfg.head_dim, cfg.rope_local_theta))
    return {"default": cs, "local": local}


def _apply_shared(shared, h: torch.Tensor, cfg: ModelConfig, rope: dict,
                  cache, cache_index, fill_len) -> torch.Tensor:
    """zamba2's shared block: ``h + attn(norm1(h))`` with the default RoPE
    table (the norm inside the attention), then its FFN residual block."""
    cos, sin = rope["default"]
    a, _ = attention_apply(shared["attn"], h, cfg.shared_attn_cfg(), cos=cos,
                           sin=sin, cache=cache, cache_index=cache_index,
                           fill_len=fill_len, norm_params=shared["norm1"])
    return ffn_block_apply(shared["ffn"], shared["norm2"], h + a,
                           cfg.shared_ffn_cfg())


def _apply_layer(lp, spec: LayerSpec, cfg: ModelConfig, h: torch.Tensor,
                 rope: dict, cache, cache_index, fill_len, shared=None,
                 aux: Optional[list] = None) -> torch.Tensor:
    """One layer: the shared block first where flagged (``shared``, its KV
    cache ``cache["shared"]``), then ``h + mixer(norm1(h))`` (attention
    with its RoPE table ``rope[spec.rope]``, or Mamba2), then the dense FFN
    residual block or ``h + moe(norm2(h))``, whose aux loss is appended to
    ``aux``.  ``cache`` is the layer's cache dict or None."""
    if spec.shared_block:
        h = _apply_shared(shared, h, cfg, rope,
                          None if cache is None else cache["shared"],
                          cache_index, fill_len)
    mc = None if cache is None else cache["mixer"]
    if spec.mixer == "attn":
        cos, sin = rope[spec.rope]
        y, _ = attention_apply(lp["mixer"], h, cfg.attn_cfg(spec), cos=cos,
                               sin=sin, cache=mc, cache_index=cache_index,
                               fill_len=fill_len, norm_params=lp["norm1"])
    else:
        y, _ = mamba2_apply(lp["mixer"], rms_norm(lp["norm1"], h),
                            cfg.mamba_cfg(), cache=mc)
    h = h + y
    if spec.mlp == "dense":
        h = ffn_block_apply(lp["mlp"], lp["norm2"], h, cfg.ffn_cfg())
    elif spec.mlp == "moe":
        y, a = moe_apply(lp["mlp"], rms_norm(lp["norm2"], h), cfg.moe_cfg())
        h = h + y
        if aux is not None:
            aux.append(a)
    return h


def _recompute_safe_layer(sharding, lp, spec, cfg, h, rope, shared):
    """A checkpointed layer, returning ``(h, aux)``: its recompute, which
    may run on another thread, sees the forward's feature-sharding
    context."""
    aux: list = []
    with par_ctx.use_context(sharding):
        h = _apply_layer(lp, spec, cfg, h, rope, None, None, None, shared,
                         aux)
    return h, (aux[0] if aux else torch.zeros((), device=h.device))


def _default_positions(cfg: ModelConfig, B: int, T: int, cache_index,
                       device) -> torch.Tensor:
    """(B, T) positions from ``cache_index`` (None: 0; an int; or a (B,)
    tensor, ``ci[:, None] + arange(T)``), broadcast to (3, B, T) under
    ``mrope``."""
    ar = torch.arange(T, device=device)
    if isinstance(cache_index, torch.Tensor):
        pos = cache_index[:, None] + ar
    else:
        start = 0 if cache_index is None else int(cache_index)
        pos = (start + ar).expand(B, T)
    if cfg.rope_kind == "mrope":
        pos = pos.expand(3, B, T)
    return pos


def forward(params, cfg: ModelConfig, *,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None, cache=None,
            cache_index=None, fill_len=None,
            last_index: Optional[torch.Tensor] = None):
    """Returns ``(logits, cache, aux)``, aux the MoE layers' summed
    load-balancing loss (an f32 zero without MoE layers).  The input is
    ``tokens`` (B, T) or ``embeds`` (B, T, d), cast to ``cfg.dtype`` and
    multiplied by ``embed_scale`` rounded to that dtype first, as the
    reference does.  ``cache=None`` is the plain causal forward; with a
    cache, T > 1 prefills from the scalar ``cache_index`` (attention-only
    stacks: an SSM cache takes one token a step) and T == 1 decodes at
    ``cache_index``: an int for the whole batch or a (B,) tensor, one
    position a row (``ci[:, None] + arange(T)``).  ``fill_len`` (an int or
    (B,)) is a right-padded prefill's true lengths: windowed layers
    ring-fill only real positions.  ``positions`` defaults from
    ``cache_index`` ((3, B, T) under ``mrope``).  ``last_index`` (B,)
    computes the logits of position ``last_index[b]`` of each row only,
    (B, 1, V), which is all a prefill returns: the hidden row is gathered
    before the final norm and the unembed."""
    dt = dtype_of(cfg.dtype)
    if tokens is not None:
        B, T = tokens.shape
        h = embed(params["embed"], tokens, cfg.embed_cfg(), dt,
                  onehot=cfg.embed_onehot)
        dev = tokens.device
    else:
        B, T = embeds.shape[:2]
        h = embeds.to(dt)
        dev = embeds.device
    if cfg.embed_scale != 1.0:
        h = h * torch.tensor(cfg.embed_scale, dtype=dt, device=dev)
    # placement hints under a device mesh; the identity elsewhere
    h = par_ctx.constrain(h, "btd")
    h = par_ctx.constrain(h, "batch_full")
    if positions is None:
        positions = _default_positions(cfg, B, T, cache_index, dev)
    rope = _rope_tables(cfg, positions)
    sharding = par_ctx.current_context()
    shared = params.get("shared")
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for i, spec in enumerate(cfg.layers):
        lp = params["layers"][i]
        if cache is None and cfg.remat:
            h, a = torch.utils.checkpoint.checkpoint(
                _recompute_safe_layer, sharding, lp, spec, cfg, h, rope,
                shared, use_reentrant=False)
            aux = aux + a
        else:
            found: list = []
            h = _apply_layer(lp, spec, cfg, h, rope,
                             None if cache is None else cache[i],
                             cache_index, fill_len, shared, found)
            for a in found:
                aux = aux + a
    if last_index is not None:
        h = torch.gather(h, 1, last_index.reshape(B, 1, 1).expand(
            B, 1, h.shape[-1]))
    h = rms_norm(params["final_norm"], h)
    logits = unembed(params["embed"], h.to(dtype_of(cfg.logits_dtype)),
                     cfg.embed_cfg())
    return logits, cache, aux


def model_param_count(params) -> int:
    """The number of scalars in a parameter tree."""
    return sum(p.numel() for p in params.parameters())
