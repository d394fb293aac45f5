"""The input-shape registry of the LM family (port of
``repro/configs/shapes.py``).

``train_*`` runs the train step; ``prefill_*`` a cache-free forward over
the prompt; ``decode_*`` and ``long_*`` one decode step (one new token
against a cache of ``seq_len``).  ``long_500k`` applies only to the
sub-quadratic archs (``registry.arch_shapes``).
"""

from __future__ import annotations

import dataclasses

__all__ = ["ShapeSpec", "SHAPES", "LM_SHAPES"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input shape: global batch, sequence length and step kind."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"
    seq_sharded: bool = False  # the KV sequence over "data" (batch 1)


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode",
                           seq_sharded=True),
}

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
