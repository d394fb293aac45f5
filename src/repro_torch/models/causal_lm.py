"""Causal-LM serving heads over the transformer (port of
``repro/models/causal_lm.py``: ``prefill`` for attention-only stacks and
``decode_step``; the loss waits for the training slice)."""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T

__all__ = ["prefill", "decode_step"]


def prefill(params, cfg: T.ModelConfig, *, max_len: int,
            tokens: torch.Tensor, cache_dtype: torch.dtype = torch.bfloat16):
    """Run the prompt (B, T) through one chunked-attention forward that
    also writes K/V into a fresh cache.  Returns ``(last-position logits
    (B, V), cache)``."""
    B = tokens.shape[0]
    cache = T.init_cache(B, max_len, cfg, device=tokens.device,
                         dtype=cache_dtype)
    logits, cache = T.forward(params, cfg, tokens=tokens, cache=cache,
                              cache_index=0, last_only=True)
    return logits[:, -1], cache


def decode_step(params, cfg: T.ModelConfig, token: torch.Tensor, cache,
                cache_index: int):
    """One-token decode: token (B,) -> (logits (B, V), cache)."""
    logits, cache = T.forward(params, cfg, tokens=token[:, None],
                              cache=cache, cache_index=cache_index)
    return logits[:, 0], cache
