"""GRU language model, the paper's §6 host architecture (port of
``repro/models/gru_lm.py``).

embed -> N stacked GRU layers, each residual ``h + gru(h)`` (dense or SPM
recurrent and input maps) -> the tied head.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.layers.embedding import (EmbeddingConfig, embed,
                                          init_embedding, unembed)
from repro_torch.layers.gru import GRUConfig, gru_apply, init_gru
from repro_torch.params import Params

__all__ = ["GRULMConfig", "init_gru_lm", "gru_lm_forward", "gru_lm_loss"]


@dataclasses.dataclass(frozen=True)
class GRULMConfig:
    """Vocabulary, width, depth and the linear knob of every GRU map."""

    vocab_size: int
    d_model: int
    n_layers: int = 1
    linear_impl: str = "dense"
    spm_stages: Optional[int] = None
    spm_backward: str = "custom"
    spm_use_kernel: Optional[bool] = None
    param_dtype: torch.dtype = torch.float32

    def gru_cfg(self) -> GRUConfig:
        """Each layer's GRU (square, d_model wide)."""
        return GRUConfig(d_in=self.d_model, d_hidden=self.d_model,
                         linear_impl=self.linear_impl,
                         spm_stages=self.spm_stages,
                         spm_backward=self.spm_backward,
                         spm_use_kernel=self.spm_use_kernel,
                         param_dtype=self.param_dtype)

    def embed_cfg(self) -> EmbeddingConfig:
        """The token table, tied to the head."""
        return EmbeddingConfig(vocab_size=self.vocab_size,
                               d_model=self.d_model, tie_output=True,
                               param_dtype=self.param_dtype)


def init_gru_lm(generator: torch.Generator, cfg: GRULMConfig,
                device=None) -> Params:
    """``{"embed", "grus"}`` drawn from ``generator`` on its own device (the
    table first, then each layer), then moved to ``device`` (``cuda``
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    at = generator.device
    table = init_embedding(cfg.embed_cfg(), generator, at)
    grus = [init_gru(generator, cfg.gru_cfg(), at)
            for _ in range(cfg.n_layers)]
    return Params({"embed": table, "grus": grus}).to(dev)


def gru_lm_forward(params, tokens: torch.Tensor,
                   cfg: GRULMConfig) -> torch.Tensor:
    """(B, T) tokens -> (B, T, vocab) logits."""
    h = embed(params["embed"], tokens, cfg.embed_cfg())
    for gp in params["grus"]:
        h = h + gru_apply(gp, h, cfg.gru_cfg())[0]
    return unembed(params["embed"], h, cfg.embed_cfg())


def gru_lm_loss(params, batch: dict, cfg: GRULMConfig
                ) -> Tuple[torch.Tensor, dict]:
    """Mean next-token cross-entropy of the f32 log-softmax, and bits per
    character."""
    logits = gru_lm_forward(params, batch["tokens"], cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    loss = nll.mean()
    return loss, {"loss": loss, "bpc": loss / math.log(2.0)}
