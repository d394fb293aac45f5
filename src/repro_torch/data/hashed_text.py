"""AG News proxy: class-conditional hashed sparse features, the paper's §9.2
(port of ``repro/data/hashed_text.py``).

The real AG News corpus is SIMULATED: each of 4 classes owns a sparse set of
"topic" hash buckets; a document activates ``nnz`` buckets drawn from a
mixture of its class's buckets and a shared background, with tf-style
magnitudes.  This matches the regime of the paper's experiment (hashed
sparse features, 4 classes) without reproducing its exact numbers.

The draws (``hashed_text_draws``, numpy) and the build of x
(``hashed_text_build``) are apart, so the tests can feed the builder the
reference's own ``jax.random`` draws.  The builder runs on the host: a
document's duplicate buckets accumulate (``np.add.at``, in order, in f32)
as the reference's ``.at[...].add`` does, and x then moves to the device.
A CUDA scatter with ``accumulate=True`` would sum duplicates with atomics
in no fixed order, so x would differ from run to run.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["HashedTextConfig", "hashed_text_draws", "hashed_text_build",
           "hashed_text_batch"]


@dataclasses.dataclass(frozen=True)
class HashedTextConfig:
    """The simulated corpus's geometry."""

    width: int                  # hash-feature dimension (n in the paper)
    n_classes: int = 4
    nnz: int = 64               # active buckets per document
    class_frac: float = 0.35    # fraction of buckets drawn class-specific
    topics_per_class: int = 200
    seed: int = 0


@functools.lru_cache(maxsize=None)
def _class_tables(cfg: HashedTextConfig) -> np.ndarray:
    """Each class's topic buckets, (n_classes, topics_per_class), from
    ``cfg.seed``; fixed for the corpus (read-only)."""
    t = np.random.default_rng(cfg.seed).integers(
        0, cfg.width, (cfg.n_classes, cfg.topics_per_class))
    t.setflags(write=False)
    return t


def hashed_text_draws(cfg: HashedTextConfig, rng: np.random.Generator,
                      batch: int) -> tuple:
    """``(tables, y, tidx, bg_buckets, mags)``: the class tables, the
    labels, each document's picks from its class's table, its background
    buckets and its ``nnz`` magnitudes ``0.5 + Exp(1)`` (f32)."""
    n_class = int(cfg.nnz * cfg.class_frac)
    n_bg = cfg.nnz - n_class
    y = rng.integers(0, cfg.n_classes, batch)
    tidx = rng.integers(0, cfg.topics_per_class, (batch, n_class))
    bg = rng.integers(0, cfg.width, (batch, n_bg))
    mags = (0.5 + rng.exponential(size=(batch, cfg.nnz))).astype(np.float32)
    return _class_tables(cfg), y, tidx, bg, mags


def hashed_text_build(tables, y, tidx, bg_buckets, mags,
                      width: int) -> dict:
    """x and y of a batch from its draws, on the CPU: each document's class
    buckets ``tables[y, tidx]`` then its background buckets, their
    magnitudes summed where a bucket repeats, the row divided by its L2
    norm (floored at 1e-6).  ``{"x": (B, width) f32, "y": (B,) int64}``."""
    y = np.asarray(y, dtype=np.int64)
    tables, tidx = np.asarray(tables), np.asarray(tidx)
    buckets = np.concatenate([tables[y[:, None], tidx],
                              np.asarray(bg_buckets)], axis=1)
    x = np.zeros((y.shape[0], width), np.float32)
    rows = np.broadcast_to(np.arange(y.shape[0])[:, None], buckets.shape)
    np.add.at(x, (rows, buckets), np.asarray(mags, np.float32))
    norm = np.sqrt(np.sum(x * x, axis=1, keepdims=True, dtype=np.float32))
    x = x / np.maximum(norm, np.float32(1e-6))
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}


def hashed_text_batch(cfg: HashedTextConfig, rng: np.random.Generator,
                      batch: int, device=None) -> dict:
    """``{x: (B, width) float32, y: (B,)}`` on ``device`` (``cuda`` unless
    the caller asks for the CPU)."""
    dev = resolve_device(device)
    out = hashed_text_build(*hashed_text_draws(cfg, rng, batch), cfg.width)
    return {k: v.to(dev) for k, v in out.items()}
