"""Token embedding and output head (port of ``repro/layers/embedding.py``).

Both stay dense whatever ``linear_impl`` says.  ``unembed`` is one plain
matrix product, which the reference leaves to XLA; logits are f32 when h is
f32, and the entry points keep TF32 off so an f32 product stays f32.

``embed`` looks rows up with ``F.embedding``, whose backward sums a
repeated token's rows in one fixed order on the CPU and on the card.
Indexing the table (``table[tokens]``) would take ``index_put_`` with
accumulation, which on the CPU adds in parallel with atomics once the grad
is large (a batch of 8 x 512 tokens), so two identical training runs
would not agree bit for bit.

Under a device mesh (the dry-run) a table whose vocabulary is split gives
partial rows, reduced at once and placed as their tokens
(``parallel/ctx.reduced``, ``placed_as``; on plain tensors the
identity).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.parallel.ctx import placed_as, placements_of, reduced

__all__ = ["EmbeddingConfig", "init_embedding", "embed", "unembed"]


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    """Vocabulary table geometry."""

    vocab_size: int
    d_model: int
    tie_output: bool = True
    param_dtype: torch.dtype = torch.float32


def init_embedding(cfg: EmbeddingConfig, generator: torch.Generator,
                   device: torch.device) -> dict:
    """``table`` (vocab, d) ~ 0.02 N(0, 1), plus ``out`` (d, vocab) when
    untied."""
    kw = dict(generator=generator, device=device, dtype=cfg.param_dtype)
    p = {"table": 0.02 * torch.randn(cfg.vocab_size, cfg.d_model, **kw)}
    if not cfg.tie_output:
        p["out"] = 0.02 * torch.randn(cfg.d_model, cfg.vocab_size, **kw)
    return p


def embed(params, tokens: torch.Tensor, cfg: EmbeddingConfig,
          dtype: torch.dtype = torch.float32,
          onehot: bool = False) -> torch.Tensor:
    """Token lookup, cast to ``dtype`` (deterministic backward: module
    docstring).  ``onehot`` computes it as ``one_hot(tokens) @ table`` in
    ``dtype``, the reference's matmul-lowered lookup: with the table's
    vocabulary split over a mesh axis it is a sharded contraction and one
    all-reduce of (tokens, d) partial sums, not a gathered table.  On a
    finite table it equals the gather bit for bit."""
    if onehot:
        oh = F.one_hot(tokens.long(), cfg.vocab_size).to(dtype)
        return _as_tokens(oh @ params["table"].to(dtype), tokens)
    return _as_tokens(F.embedding(tokens, params["table"]), tokens).to(dtype)


def _as_tokens(rows: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Looked-up rows with their partial sums reduced and placed as their
    tokens are (a split vocabulary can make ``DTensor`` gather the batch;
    on plain tensors the identity)."""
    return placed_as(reduced(rows), placements_of(tokens))


def unembed(params, h: torch.Tensor, cfg: EmbeddingConfig) -> torch.Tensor:
    """Logits ``h @ table.T`` (tied) or ``h @ out``, in h's dtype."""
    if cfg.tie_output:
        return h @ params["table"].to(h.dtype).T
    return h @ params["out"].to(h.dtype)
