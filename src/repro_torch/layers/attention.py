"""GQA attention: chunked causal prefill and KV-cache decode (port of
``repro/layers/attention.py``).

Q/K/V/O go through the linear factory, so SPM replaces every projection.
With the pre-attention norm passed in (``norm_params``) and all three of
q/k/v block-fusible, each projection is one K3 launch with the RMS norm in
its prologue (the fused-qkv entry).  The score computation is plain torch:
the reference leaves it to XLA, not to a TPU kernel.

The KV cache is updated in place (the reference returns a new cache; here
that would copy every layer's cache on every token).  Decode takes a scalar
``cache_index`` (the fixed-batch engine) or a per-row ``(B,)`` tensor
(continuous batching: each row scatter-written at its own slot, its own
valid mask, no read back to the host).  A sliding-window layer (gemma3's
local layers) keeps a ring of ``min(max_len, window)`` slots: position p
lives in slot ``p % W``, a prefill fills each slot with the newest real
position of its class, and decode masks by age.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.eligibility import resolve_block_fuse
from repro_torch.core.linear import (LinearConfig, init_linear, linear_apply,
                                     spm_block_eligible, spm_block_operands)
from repro_torch.layers.norms import qk_norm, rms_norm
from repro_torch.layers.rope import apply_rope
from repro_torch.parallel.ctx import constrain, whole_features
from repro_torch.params import Params

__all__ = ["NEG_INF", "AttentionConfig", "init_attention", "init_kv_cache",
           "chunked_causal_attention", "ring_sources", "qkv_block_fused",
           "attention_apply"]

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
    """``{"k", "v"}`` of shape (batch, S, n_kv_heads, head_dim): S =
    max_len, or ``min(max_len, window)`` ring slots for a windowed
    layer."""
    s = max_len if cfg.window is None else min(max_len, cfg.window)
    shape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
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


def _decode_attention(q, ck, cv, cache_index, H: int, Hkv: int,
                      dh: int, window: Optional[int]) -> torch.Tensor:
    """One query a row over the cache: ``cache_index`` an int (the whole
    batch at one position) or a (B,) tensor (each row at its own).  A full
    cache's valid slots are ``pos <= ci``; a ring's (``window``) are the
    ``min(ci + 1, S)`` newest, ``age = (ci % S - pos) % S < min(ci + 1,
    S)``, as in the reference."""
    B = q.shape[0]
    S = ck.shape[1]
    qg = (q.float() * dh ** -0.5).reshape(B, 1, Hkv, H // Hkv, dh)
    s = torch.einsum("bthgd,bshd->bhgts", qg, ck.float())   # (B,Hkv,G,1,S)
    pos = torch.arange(S, device=q.device)[None, :]
    if isinstance(cache_index, torch.Tensor):
        ci = cache_index[:, None]                            # (B, 1)
        n_valid = torch.clamp_max(ci + 1, S)
        newest = torch.remainder(ci, S)
    else:
        ci = int(cache_index)
        n_valid, newest = min(ci + 1, S), ci % S
    if window is None:
        valid = pos <= ci
    else:
        valid = torch.remainder(newest - pos, S) < n_valid
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgts,bshd->bthgd", p,
                        cv.float()).reshape(B, 1, H, dh)


def ring_sources(start: int, T: int, S: int, lens: torch.Tensor
                 ) -> torch.Tensor:
    """The prompt position each ring slot takes at a prefill of T tokens
    from ``start`` (B rows, true lengths ``lens`` (B,)): slot j holds the
    newest real position p = j (mod S), at index ``clip(p - start, 0, T -
    1)`` of the prompt, (B, S); padded keys never enter the ring."""
    last = start + lens - 1                                  # (B,)
    j = torch.arange(S, device=lens.device)[None, :]
    p = last[:, None] - torch.remainder(last[:, None] - j, S)
    return torch.clamp(p - start, 0, T - 1)


def qkv_block_fused(cfg: AttentionConfig) -> bool:
    """Whether ``attention_apply`` runs q/k/v as three fused block launches
    (the pre-attention norm in their prologue): both projections can be a
    block's stack (``spm_block_eligible``) and ``spm_block_fuse`` is not
    False.  Else an explicit ``rms_norm`` and the linears' own runs."""
    return resolve_block_fuse(cfg.spm_block_fuse,
                              spm_block_eligible(cfg.q_proj)
                              and spm_block_eligible(cfg.kv_proj))


def attention_apply(params, x: torch.Tensor, cfg: AttentionConfig, *,
                    cos: torch.Tensor, sin: torch.Tensor,
                    cache: Optional[dict] = None,
                    cache_index=None, fill_len=None,
                    norm_params=None
                    ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, T, d).  Three modes, as in the reference:

    * training, ``cache=None``;
    * prefill-into-cache, cache with T > 1: the chunked causal attention,
      then K/V written from the scalar ``cache_index`` (default 0).  A full
      layer block-writes the whole padded block of a right-padded row: the
      decode valid mask hides the padded slots until decode overwrites
      them.  A windowed layer replaces its ring whole, each slot from
      ``ring_sources`` with ``fill_len`` (an int or (B,), default T) the
      true lengths, so padded keys never evict real ones;
    * decode, cache with T == 1: ``cache_index`` an int (the whole batch at
      one position, the fixed-batch engine) or a (B,) integer tensor (each
      row scatter-written at its own slot and masked at its own length,
      with no read back to the host: continuous batching).  A ring writes
      slot ``ci % S`` and masks by age.

    ``norm_params`` moves the pre-attention RMS norm inside: into the q/k/v
    kernels' prologue when fused, else one explicit ``rms_norm``."""
    B, T, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if norm_params is not None and qkv_block_fused(cfg):
        from repro_torch.kernels import ops as kernel_ops
        bundles = tuple(spm_block_operands(params[name], lcfg)
                        for name, lcfg in (("q", cfg.q_proj),
                                           ("k", cfg.kv_proj),
                                           ("v", cfg.kv_proj)))

        x = whole_features(x)      # x itself unless a split DTensor

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
    # placement hints under a device mesh; the identity elsewhere
    q = constrain(q, "heads")
    k = constrain(k, "kv_heads")
    v = constrain(v, "kv_heads")

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
            _prefill_write(cache, k, v, cfg.window, cache_index, fill_len)
    else:
        S = cache["k"].shape[1]
        if isinstance(cache_index, torch.Tensor):
            ci = cache_index
            slot = torch.remainder(ci, S) if cfg.window is not None else ci
            rows = torch.arange(B, device=ci.device)
            cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
        else:
            ci = int(cache_index)
            slot = ci % S if cfg.window is not None else ci
            cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        out = _decode_attention(q, cache["k"], cache["v"], ci, H, Hkv, dh,
                                cfg.window)

    # heads whole before they merge into o's features (a placement under
    # a device mesh; the identity elsewhere)
    out = whole_features(out.to(x.dtype), 2, 3).reshape(B, T, H * dh)
    return linear_apply(params["o"], out, cfg.o_proj), cache


def _prefill_write(cache: dict, k: torch.Tensor, v: torch.Tensor,
                   window: Optional[int], cache_index, fill_len) -> None:
    """A prefill's K/V into the cache, in place: a block write from the
    scalar ``cache_index`` (a full layer), or the whole ring from
    ``ring_sources`` (a windowed one)."""
    B, T = k.shape[:2]
    start = 0 if cache_index is None else int(cache_index)
    if window is None:
        cache["k"][:, start: start + T] = k.to(cache["k"].dtype)
        cache["v"][:, start: start + T] = v.to(cache["v"].dtype)
        return
    S = cache["k"].shape[1]
    lens = torch.as_tensor(T if fill_len is None else fill_len,
                           device=k.device).long().expand(B)
    src = ring_sources(start, T, S, lens)[:, :, None, None]
    for name, t in (("k", k), ("v", v)):
        idx = src.expand(B, S, *t.shape[2:])
        cache[name].copy_(torch.gather(t, 1, idx).to(cache[name].dtype))
