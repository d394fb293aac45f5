"""Deterministic loader with a resumable cursor (port of
``repro/data/loader.py``).

The global batch at step ``s`` is a pure function of (seed, s):
``batch_at`` seeds a numpy generator with ``[seed, s]`` and hands it to
``batch_fn``, so a restart that restores the step counter gets the same
batches, and the cursor is the whole iterator state.  That cannot equal
the reference's ``jax.random`` draws, so parity tests feed both packages
the same numpy batches.  Host sharding slices the global batch by
``host_id``, so hosts read disjoint rows.

``resume`` is defensive: a checkpoint without a cursor, or with a broken
one, keeps the fresh cursor and logs a warning.  Losing the data order is
recoverable; a crash on the resume path is not.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Optional

import numpy as np

log = logging.getLogger("repro_torch.data")

__all__ = ["DataCursor", "DeterministicLoader"]


@dataclasses.dataclass
class DataCursor:
    """Position in the deterministic stream: (seed, step) is all of it."""

    seed: int
    step: int = 0

    def state_dict(self) -> dict:
        """The cursor as JSON (a checkpoint's ``cursor`` extra)."""
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_state(cls, d: dict) -> "DataCursor":
        """The cursor of ``state_dict``'s output."""
        return cls(seed=int(d["seed"]), step=int(d["step"]))


def _rows(batch: Any, lo: int, hi: int) -> Any:
    if isinstance(batch, dict):
        return {k: _rows(v, lo, hi) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_rows(v, lo, hi) for v in batch)
    return batch[lo:hi]


class DeterministicLoader:
    """Wraps ``batch_fn(rng: np.random.Generator, global_batch) -> batch``
    (a dict, possibly nested, of arrays or tensors with rows first)."""

    def __init__(self, batch_fn: Callable, global_batch: int, seed: int = 0,
                 n_hosts: int = 1, host_id: int = 0):
        assert global_batch % n_hosts == 0
        self.batch_fn = batch_fn
        self.global_batch = global_batch
        self.cursor = DataCursor(seed=seed)
        self.n_hosts = n_hosts
        self.host_id = host_id

    def batch_at(self, step: int):
        """This host's rows of the batch of ``step``, pure in (seed,
        step)."""
        batch = self.batch_fn(np.random.default_rng([self.cursor.seed, step]),
                              self.global_batch)
        if self.n_hosts > 1:
            per = self.global_batch // self.n_hosts
            lo = self.host_id * per
            batch = _rows(batch, lo, lo + per)
        return batch

    def __next__(self):
        b = self.batch_at(self.cursor.step)
        self.cursor.step += 1
        return b

    def __iter__(self):
        return self

    def state_dict(self) -> dict:
        """The cursor, for a checkpoint's ``cursor`` extra."""
        return self.cursor.state_dict()

    def resume(self, cursor_state: Optional[dict]) -> bool:
        """Restore the cursor from a checkpoint; True on success.  ``None``
        or a dict without ``seed``/``step`` keeps the current cursor and
        logs a warning."""
        if cursor_state is None:
            log.warning("no data cursor in checkpoint; keeping fresh "
                        "cursor (seed=%d, step=%d)",
                        self.cursor.seed, self.cursor.step)
            return False
        try:
            self.cursor = DataCursor.from_state(cursor_state)
        except (KeyError, TypeError, ValueError) as e:
            log.warning("unusable data cursor %r in checkpoint (%s); "
                        "keeping fresh cursor", cursor_state, e)
            return False
        return True
