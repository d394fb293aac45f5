"""Fixed-batch KV-cache serving (port of ``ServeEngine`` and ``serve_step``
of ``repro/serve/engine.py``; continuous batching waits for a later slice).

``generate`` prefills the prompts, samples the first token from the
prefill logits, then runs exactly ``max_new_tokens - 1`` decode steps.

Non-finite guard: a row with any NaN/inf logit takes token 0 instead of
sampling from NaN, and ``generate(..., return_flags=True)`` reports which
rows ever hit the guard.  Rows never mix, so a poisoned request flags only
itself.

Sampling noise comes from a ``torch.Generator``, so temperature > 0 does
not reproduce the reference's ``jax.random`` tokens; greedy decoding does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.models import causal_lm as LM
from repro_torch.models import transformer as T

__all__ = ["ServeEngine", "serve_step", "sample"]


def serve_step(params, cfg: T.ModelConfig, tokens: torch.Tensor, cache,
               cache_index: int):
    """One decode step for the whole batch: (B,) -> (logits (B, V), cache)."""
    return LM.decode_step(params, cfg, tokens, cache, cache_index)


def sample(logits: torch.Tensor, temperature: float,
           generator: Optional[torch.Generator] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(tokens (B,), bad (B,) bool)``: argmax for
    ``temperature <= 0``, else a draw from softmax(logits / temperature);
    rows with a non-finite logit are flagged and take token 0."""
    bad = ~torch.isfinite(logits).all(dim=-1)
    safe = torch.where(bad[:, None], torch.zeros_like(logits), logits)
    if temperature <= 0:
        return torch.argmax(safe, dim=-1), bad
    probs = torch.softmax(safe.float() / temperature, dim=-1)
    tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(bad, torch.zeros_like(tok), tok), bad


@dataclasses.dataclass
class ServeEngine:
    """Greedy or temperature generation for a batch of prompts.

    ``device`` is ``cuda`` unless the caller passes another; the params
    must already lie there.  TF32 matrix products are switched off so the
    f32 logits of ``unembed`` are full f32, as in the reference."""

    cfg: T.ModelConfig
    params: torch.nn.Module
    max_len: int
    cache_dtype: torch.dtype = torch.bfloat16
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for p in self.params.parameters():
            if p.device.type != self.device.type:
                raise ValueError(f"params lie on {p.device}, the engine runs "
                                 f"on {self.device}: move them first")
            break
        torch.backends.cuda.matmul.allow_tf32 = False

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, *, max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 return_flags: bool = False
                 ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """prompts: (B, T_prompt) int -> tokens (B, max_new_tokens) int64;
        with ``return_flags`` also (B,) bool, True for rows that hit the
        non-finite guard at any step."""
        if temperature > 0 and generator is None:
            raise ValueError("temperature > 0 requires a torch.Generator")
        prompts = torch.as_tensor(prompts, device=self.device).long()
        B, T_prompt = prompts.shape
        if T_prompt + max_new_tokens - 1 > self.max_len:
            raise ValueError(f"{T_prompt} + {max_new_tokens} tokens exceed "
                             f"max_len={self.max_len}")
        if max_new_tokens <= 0:
            empty = torch.zeros((B, 0), dtype=torch.long, device=self.device)
            flags = torch.zeros((B,), dtype=torch.bool, device=self.device)
            return (empty, flags) if return_flags else empty
        logits, cache = LM.prefill(self.params, self.cfg,
                                   max_len=self.max_len, tokens=prompts,
                                   cache_dtype=self.cache_dtype)
        tok, flags = sample(logits, temperature, generator)
        out = [tok]
        # the token sampled from step t's logits is decoded at step t+1;
        # the last sampled token is returned without a trailing decode
        for t in range(max_new_tokens - 1):
            logits, cache = serve_step(self.params, self.cfg, tok, cache,
                                       T_prompt + t)
            tok, bad = sample(logits, temperature, generator)
            flags = flags | bad
            out.append(tok)
        tokens = torch.stack(out, dim=1)
        return (tokens, flags) if return_flags else tokens
