"""Causal-LM heads over the transformer (port of
``repro/models/causal_lm.py``): the training loss (with the MoE aux term),
``prefill`` (chunked for attention-only stacks, decode replay for SSM
stacks) and ``decode_step``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import transformer as T

__all__ = ["lm_loss", "train_metrics", "prefill", "decode_step"]

MOE_AUX_COEF = 0.01


def lm_loss(params, batch: dict, cfg: T.ModelConfig
            ) -> Tuple[torch.Tensor, dict]:
    """Next-token cross-entropy.  batch: ``tokens`` (or ``embeds`` for an
    ``input_kind == "embeddings"`` config), ``labels`` (already shifted),
    optional ``mask`` and ``positions`` ((3, B, T) under ``mrope``).  The
    loss is the masked mean ce plus ``MOE_AUX_COEF`` times the MoE layers'
    summed aux loss (0 without MoE layers), reported as ``"aux"``.  Returns
    ``(loss, metrics)`` with ``ce_weight``, the mask sum that gradient
    accumulation weights ce by."""
    kw = ({"tokens": batch["tokens"]} if cfg.input_kind == "tokens"
          else {"embeds": batch["embeds"]})
    logits, _, aux = T.forward(params, cfg,
                               positions=batch.get("positions"), **kw)
    labels = batch["labels"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    mask = batch.get("mask")
    mask = (torch.ones_like(nll) if mask is None else mask.float())
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = torch.sum(nll * mask) / denom
    loss = ce + MOE_AUX_COEF * aux
    metrics = {"loss": loss, "ce": ce, "aux": aux,
               "ppl_proxy": torch.exp(torch.clamp(ce, max=20.0)),
               "ce_weight": denom}
    return loss, metrics


def train_metrics(metrics: dict) -> dict:
    """Metrics as Python floats (one device sync)."""
    return {k: float(v) for k, v in metrics.items()}


def prefill(params, cfg: T.ModelConfig, *, max_len: int,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            cache_dtype: torch.dtype = torch.bfloat16, length=None,
            cache=None):
    """Run the prompt, ``tokens`` (B, T) or ``embeds`` (B, T, d), into a
    decode-ready cache: a fresh one, or ``cache`` (per layer ``{"mixer":
    {"k", "v"}}`` of B rows, views of a larger pool allowed), whose first T
    positions it overwrites (a windowed layer's whole ring).  Returns
    ``(logits (B, V), cache)``.

    An attention-only stack takes one chunked-attention forward that also
    writes K/V.  ``length`` (an int or (B,), default T) is the true prompt
    length of a right-padded batch: the logits are those of position
    ``length - 1`` of each row, the hidden row gathered before the final
    norm and the unembed, and windowed layers ring-fill only real
    positions.

    A stack with SSM mixers replays decode token by token (SSM caches take
    one token a step), as the reference's ``lax.scan`` does; ``length`` is
    not supported there."""
    src = tokens if tokens is not None else embeds
    B, T_len = src.shape[:2]
    if cache is None:
        cache = T.init_cache(B, max_len, cfg, device=src.device,
                             dtype=cache_dtype)
    if any(s.mixer != "attn" for s in cfg.layers):
        if length is not None:
            raise NotImplementedError(
                "per-row prompt lengths need an attention-only stack "
                "(SSM caches prefill via the sequential scan)")
        for t in range(T_len):
            kw = ({"tokens": tokens[:, t: t + 1]} if tokens is not None
                  else {"embeds": embeds[:, t: t + 1]})
            logits, cache, _ = T.forward(params, cfg, cache=cache,
                                         cache_index=t, **kw)
        return logits[:, 0], cache
    last = torch.as_tensor(T_len if length is None else length,
                           device=src.device).long().expand(B) - 1
    kw = {"tokens": tokens} if tokens is not None else {"embeds": embeds}
    logits, cache, _ = T.forward(params, cfg, cache=cache, cache_index=0,
                                 fill_len=length, last_index=last, **kw)
    return logits[:, -1], cache


def decode_step(params, cfg: T.ModelConfig, token: torch.Tensor, cache,
                cache_index):
    """One-token decode: token (B,) -> (logits (B, V), cache);
    ``cache_index`` an int or a (B,) tensor, one position a row."""
    logits, cache, _ = T.forward(params, cfg, tokens=token[:, None],
                                 cache=cache, cache_index=cache_index)
    return logits[:, 0], cache
