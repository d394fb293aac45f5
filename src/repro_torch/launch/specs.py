"""Stand-ins for every dry-run cell on torch's ``meta`` device (port of
``repro/launch/specs.py``): shapes and dtypes with no storage.

``input_specs(cfg, shape)`` is the abstract batch of a cell;
``abstract_params``, ``abstract_state`` and ``abstract_cache`` run the
port's own ``init_model``, ``make_train_state`` and ``init_cache`` with
``device="meta"``, where nothing is allocated and a random draw costs
nothing (the ``eval_shape`` of the reference).
"""

from __future__ import annotations

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.train.state import make_train_state

__all__ = ["input_specs", "abstract_params", "abstract_state",
           "abstract_cache"]

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: T.ModelConfig, shape: ShapeSpec) -> dict:
    """The abstract batch of ``(cfg, shape)``, the reference's keys,
    shapes and dtypes:

    * train: ``tokens`` or ``embeds`` (and M-RoPE ``positions``),
      ``labels``;
    * prefill: ``tokens`` or ``embeds`` (and ``positions``);
    * decode: ``tokens`` (B,) and ``index`` (); the cache is carried
      state, from ``abstract_cache``.
    """
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _spec((B,), torch.int32),
                "index": _spec((), torch.int32)}
    out: dict = {}
    if cfg.input_kind == "tokens":
        out["tokens"] = _spec((B, S), torch.int32)
    else:
        out["embeds"] = _spec((B, S, cfg.d_model), torch.bfloat16)
        if cfg.rope_kind == "mrope":
            out["positions"] = _spec((3, B, S), torch.int32)
    if shape.kind == "train":
        out["labels"] = _spec((B, S), torch.int32)
    return out


def abstract_params(cfg: T.ModelConfig):
    """``init_model``'s parameter tree on ``meta``."""
    return T.init_model(cfg, device=META)


def abstract_state(cfg: T.ModelConfig) -> dict:
    """``make_train_state``'s state on ``meta``: params, AdamW moments,
    count and step."""
    return make_train_state(abstract_params(cfg))


def abstract_cache(cfg: T.ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> list:
    """``init_cache``'s decode cache on ``meta``."""
    return T.init_cache(batch, max_len, cfg, device=META, dtype=dtype)
