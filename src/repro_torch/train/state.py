"""The training state (port of ``repro/train/state.py``): the parameter
tree, the AdamW state and the step counter, as a plain dict.
``tree_signature`` comes with checkpoints (ROADMAP.md §1, the substrate)."""

from __future__ import annotations

import torch

from repro_torch.optim.adamw import init_opt_state
from repro_torch.params import Params

__all__ = ["make_train_state", "param_count"]


def make_train_state(params: Params) -> dict:
    """A fresh state for ``params``, which become trainable: zero moments,
    count 0, step 0, and the weight-decay mask of the reference's layout
    (``optim/adamw.decay_mask``)."""
    params.trainable()
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    return {"params": params,
            "opt": init_opt_state(named),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def param_count(state: dict) -> int:
    """Learnable scalars in ``state["params"]``."""
    return sum(p.numel() for p in state["params"].parameters())
