"""GQA attention: chunked causal prefill and KV-cache decode (port of
``repro/layers/attention.py``).

Q/K/V/O go through the linear factory, so SPM replaces every projection.
With the pre-attention norm passed in (``norm_params``) and all three of
q/k/v block-fusible, each projection is one K3 launch with the RMS norm in
its prologue (the fused-qkv entry).  The score computation is plain torch:
the reference leaves it to XLA, not to a TPU kernel.

The KV cache is updated in place (the reference returns a new cache; here
that would copy every layer's cache on every token).  Decode takes a scalar
``cache_index`` (the fixed-batch engine); per-row indices, sliding-window
ring caches and ``fill_len`` belong to continuous batching, a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.eligibility import resolve_block_fuse
from repro_torch.core.linear import (LinearConfig, init_linear, linear_apply,
                                     spm_block_operands)
from repro_torch.layers.norms import qk_norm, rms_norm
from repro_torch.layers.rope import apply_rope
from repro_torch.params import Params

__all__ = ["NEG_INF", "AttentionConfig", "init_attention", "init_kv_cache",
           "chunked_causal_attention", "attention_apply"]

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """GQA geometry and the SPM knobs its projections inherit."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    use_qk_norm: bool = False
    window: Optional[int] = None        # sliding window (None = global)
    linear_impl: str = "dense"
    spm_stages: Optional[int] = None
    spm_backward: str = "autodiff"
    spm_use_kernel: Optional[bool] = None
    spm_schedule: str = "butterfly"
    spm_n_shards: int = 1
    spm_overlap: Optional[bool] = None
    spm_block_fuse: Optional[bool] = None
    spm_quant_acts: bool = False
    spm_quant_coeffs: bool = False
    q_chunk: int = 1024
    k_chunk: int = 1024
    param_dtype: torch.dtype = torch.float32

    def _lin(self, d_in: int, d_out: int) -> LinearConfig:
        return LinearConfig(
            d_in=d_in, d_out=d_out, impl=self.linear_impl, use_bias=False,
            n_stages=self.spm_stages, backward=self.spm_backward,
            use_kernel=self.spm_use_kernel, schedule=self.spm_schedule,
            n_shards=self.spm_n_shards, overlap=self.spm_overlap,
            param_dtype=self.param_dtype, quant_acts=self.spm_quant_acts,
            quant_coeffs=self.spm_quant_coeffs)

    @property
    def q_proj(self) -> LinearConfig:
        """d_model -> n_heads * head_dim."""
        return self._lin(self.d_model, self.n_heads * self.head_dim)

    @property
    def kv_proj(self) -> LinearConfig:
        """d_model -> n_kv_heads * head_dim (k and v)."""
        return self._lin(self.d_model, self.n_kv_heads * self.head_dim)

    @property
    def o_proj(self) -> LinearConfig:
        """n_heads * head_dim -> d_model."""
        return self._lin(self.n_heads * self.head_dim, self.d_model)


def init_attention(cfg: AttentionConfig, generator: torch.Generator,
                   device: torch.device) -> Params:
    """``q``, ``k``, ``v``, ``o`` projections (+ ``q_norm``/``k_norm``)."""
    p = {"q": init_linear(cfg.q_proj, generator, device),
         "k": init_linear(cfg.kv_proj, generator, device),
         "v": init_linear(cfg.kv_proj, generator, device),
         "o": init_linear(cfg.o_proj, generator, device)}
    if cfg.use_qk_norm:
        p["q_norm"] = torch.ones(cfg.head_dim, dtype=cfg.param_dtype,
                                 device=device)
        p["k_norm"] = torch.ones(cfg.head_dim, dtype=cfg.param_dtype,
                                 device=device)
    return Params(p)


def init_kv_cache(batch: int, max_len: int, cfg: AttentionConfig,
                  device: torch.device,
                  dtype: torch.dtype = torch.bfloat16) -> dict:
    """``{"k", "v"}`` of shape (batch, max_len, n_kv_heads, head_dim)."""
    if cfg.window is not None:
        raise NotImplementedError(
            "sliding-window KV caches come with the other archs "
            "(ROADMAP.md §1)")
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             window: Optional[int] = None,
                             q_offset: int = 0, q_chunk: int = 1024,
                             k_chunk: int = 1024) -> torch.Tensor:
    """Causal GQA attention with an online softmax over key chunks, in f32.

    q: (B, Tq, H, dh); k, v: (B, Tk, Hkv, dh).  Query i attends to keys
    j <= i + q_offset (and j > i + q_offset - window when windowed).  Edge
    chunks are zero-padded and their padded keys masked out (``kp < Tk``),
    as in the reference.  Returns (B, Tq, H, dh) f32.
    """
    B, Tq, H, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = dh ** -0.5
    q_chunk = min(q_chunk, Tq)
    k_chunk = min(k_chunk, Tk)
    Tq_pad = -(-Tq // q_chunk) * q_chunk
    Tk_pad = -(-Tk // k_chunk) * k_chunk
    q = F.pad(q, (0, 0, 0, 0, 0, Tq_pad - Tq))
    k = F.pad(k, (0, 0, 0, 0, 0, Tk_pad - Tk))
    v = F.pad(v, (0, 0, 0, 0, 0, Tk_pad - Tk))
    nq, nk = Tq_pad // q_chunk, Tk_pad // k_chunk
    dev = q.device
    qg = q.reshape(B, nq, q_chunk, Hkv, G, dh).float() * scale
    kg = k.reshape(B, nk, k_chunk, Hkv, dh).float()
    vg = v.reshape(B, nk, k_chunk, Hkv, dh).float()
    q_pos = q_offset + torch.arange(Tq_pad, device=dev).reshape(nq, q_chunk)
    k_pos = torch.arange(Tk_pad, device=dev).reshape(nk, k_chunk)
    outs = []
    for qi in range(nq):
        qc, qp = qg[:, qi], q_pos[qi]
        m = torch.full((B, Hkv, G, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, G, q_chunk), device=dev)
        acc = torch.zeros((B, Hkv, G, q_chunk, dh), device=dev)
        last_q = q_offset + (qi + 1) * q_chunk - 1
        for ki in range(nk):
            if window is None and ki * k_chunk > last_q:
                # every key of this chunk is in every query's future: the
                # reference's update is then exactly the identity (p = 0,
                # corr = 1), so skipping it changes no bit
                continue
            kp = k_pos[ki]
            s = torch.einsum("bthgd,bshd->bhgts", qc, kg[:, ki])
            mask = kp[None, :] <= qp[:, None]
            if window is not None:
                mask &= kp[None, :] > qp[:, None] - window
            if Tk_pad != Tk:
                mask &= kp[None, :] < Tk
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgts,bshd->bhgtd", p, vg[:, ki])
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))          # (B,qc,Hkv,G,dh)
    out = torch.cat(outs, dim=1).reshape(B, Tq_pad, H, dh)
    return out[:, :Tq]


def _decode_attention(q, ck, cv, cache_index: int, H: int, Hkv: int,
                      dh: int) -> torch.Tensor:
    B = q.shape[0]
    S = ck.shape[1]
    qg = (q.float() * dh ** -0.5).reshape(B, 1, Hkv, H // Hkv, dh)
    s = torch.einsum("bthgd,bshd->bhgts", qg, ck.float())   # (B,Hkv,G,1,S)
    valid = torch.arange(S, device=q.device) <= cache_index
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgts,bshd->bthgd", p,
                        cv.float()).reshape(B, 1, H, dh)


def attention_apply(params, x: torch.Tensor, cfg: AttentionConfig, *,
                    cos: torch.Tensor, sin: torch.Tensor,
                    cache: Optional[dict] = None,
                    cache_index: Optional[int] = None,
                    norm_params=None
                    ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, T, d).  Three modes, as in the reference: training
    (``cache=None``), prefill-into-cache (cache with T > 1, written from
    ``cache_index``, default 0) and decode (cache with T == 1, scalar
    ``cache_index``).  ``norm_params`` moves the pre-attention RMS norm
    inside: into the q/k/v kernels' prologue when fused, else one explicit
    ``rms_norm``."""
    B, T, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bundles = None
    if norm_params is not None:
        bundles = tuple(spm_block_operands(params[name], lcfg)
                        for name, lcfg in (("q", cfg.q_proj),
                                           ("k", cfg.kv_proj),
                                           ("v", cfg.kv_proj)))
        if any(b is None for b in bundles):
            bundles = None
    if norm_params is not None and resolve_block_fuse(cfg.spm_block_fuse,
                                                      bundles is not None):
        from repro_torch.kernels import ops as kernel_ops

        def _norm_proj(b, lcfg):
            return kernel_ops.spm_block_fused(
                x, coeffs1=b["coeffs"], d_in1=b["d_in"], d_out1=b["d_out"],
                bias1=b["bias"], strides1=b["strides"],
                gamma=norm_params["scale"], out_width=lcfg.d_out)

        q = _norm_proj(bundles[0], cfg.q_proj).reshape(B, T, H, dh)
        k = _norm_proj(bundles[1], cfg.kv_proj).reshape(B, T, Hkv, dh)
        v = _norm_proj(bundles[2], cfg.kv_proj).reshape(B, T, Hkv, dh)
    else:
        if norm_params is not None:
            x = rms_norm(norm_params, x)
        q = linear_apply(params["q"], x, cfg.q_proj).reshape(B, T, H, dh)
        k = linear_apply(params["k"], x, cfg.kv_proj).reshape(B, T, Hkv, dh)
        v = linear_apply(params["v"], x, cfg.kv_proj).reshape(B, T, Hkv, dh)

    if cfg.use_qk_norm:
        q = qk_norm(params["q_norm"], q)
        k = qk_norm(params["k_norm"], k)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is None or T > 1:
        out = chunked_causal_attention(q, k, v, window=cfg.window,
                                       q_chunk=cfg.q_chunk,
                                       k_chunk=cfg.k_chunk)
        if cache is not None:
            if cfg.window is not None:
                raise NotImplementedError(
                    "sliding-window ring caches come with the other archs "
                    "(ROADMAP.md §1)")
            start = 0 if cache_index is None else int(cache_index)
            cache["k"][:, start: start + T] = k.to(cache["k"].dtype)
            cache["v"][:, start: start + T] = v.to(cache["v"].dtype)
    else:
        if cfg.window is not None:
            raise NotImplementedError(
                "sliding-window ring caches come with the other archs "
                "(ROADMAP.md §1)")
        ci = int(cache_index)
        cache["k"][:, ci] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, ci] = v[:, 0].to(cache["v"].dtype)
        out = _decode_attention(q, cache["k"], cache["v"], ci, H, Hkv, dh)

    out = out.to(x.dtype).reshape(B, T, H * dh)
    return linear_apply(params["o"], out, cfg.o_proj), cache
