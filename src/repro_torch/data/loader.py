"""Deterministic loader (port of ``repro/data/loader.py``'s
``batch_at``).

The batch at step ``s`` is a pure function of (seed, s): ``batch_at``
seeds a numpy generator with ``[seed, s]`` and hands it to ``batch_fn``.
That cannot equal the reference's ``jax.random`` draws, so parity tests
feed both packages the same numpy batches instead.  Host sharding and the
resume cursor come with the multi-device slice and the substrate.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["DeterministicLoader"]


class DeterministicLoader:
    """Wraps ``batch_fn(rng: np.random.Generator, global_batch) -> dict``."""

    def __init__(self, batch_fn: Callable, global_batch: int, seed: int = 0):
        self.batch_fn = batch_fn
        self.global_batch = global_batch
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        """The batch of ``step``, pure in (seed, step)."""
        return self.batch_fn(np.random.default_rng([self.seed, step]),
                             self.global_batch)
