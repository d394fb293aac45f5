"""AdamW, cosine schedule and global-norm clipping (port of
``repro/optim/adamw.py``).

Trees are flat dicts from a parameter's dotted name
(``Params.named_parameters``) to its tensor.  The update is functional, as
the reference's: ``adamw_update`` returns new tensors and leaves its inputs
alone, so a caller can still keep the old state (``train/step.py``'s
non-finite guard).  Moments are f32; every scalar of the schedule is f32.

Weight decay follows the reference's layout, not the port's.  The
reference decays a leaf when ``p.ndim >= 2`` (``optim/adamw.py:72``) and
stores the layers of every config the port runs stacked along a leading
layer axis: there norm scales, ``q_norm``, ``d_in``, ``d_out`` and biases
are 2-D and do decay, while ``final_norm`` is 1-D and does not.  The port
keeps one tree per layer, so ``decay_mask`` counts one axis more for
every leaf under ``layers``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

__all__ = ["OptimizerConfig", "init_opt_state", "adamw_update",
           "cosine_schedule", "global_norm", "clip_by_global_norm",
           "decay_mask"]

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """The reference's defaults."""

    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def cosine_schedule(cfg: OptimizerConfig, step: torch.Tensor
                    ) -> torch.Tensor:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay
    to ``min_lr_frac * lr`` at ``total_steps``; f32 like ``step``'s
    device."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale every leaf by ``min(1, max_norm / norm)``; returns the
    clipped tree and the norm before clipping."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (x.float() * scale).to(x.dtype) for k, x in tree.items()}, \
        norm


def decay_mask(params: Tree) -> Dict[str, bool]:
    """Whether each leaf decays: ``ndim >= 2`` in the reference's stacked
    layout, where a leaf under ``layers`` has one axis more (see the module
    docstring)."""
    return {k: p.dim() + k.startswith("layers.") >= 2
            for k, p in params.items()}


def init_opt_state(params: Tree) -> dict:
    """Zero f32 moments, count 0, and the decay mask of ``decay_mask``."""
    return {"mu": {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32,
                                 device=next(iter(params.values())).device),
            "decay": decay_mask(params)}


def adamw_update(params: Tree, grads: Tree, state: dict,
                 cfg: OptimizerConfig,
                 lr: Optional[torch.Tensor] = None
                 ) -> Tuple[Tree, dict, dict]:
    """Returns ``(new_params, new_state, {"grad_norm", "lr"})``: clip by
    the global norm, then AdamW with bias correction and decoupled decay on
    the leaves ``state["decay"]`` marks.  Keys of ``state`` other than the
    moments and the count pass through untouched."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    count = state["count"] + 1
    if lr is None:
        lr = cosine_schedule(cfg, count)
    b1, b2 = cfg.beta1, cfg.beta2
    cnt = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(b1, cnt), cnt)
    bc2 = 1.0 - torch.pow(_f32(b2, cnt), cnt)
    decay = state["decay"]
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        mu = b1 * state["mu"][k] + (1 - b1) * g
        nu = b2 * state["nu"][k] + (1 - b2) * g * g
        step = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if decay[k]:
            step = step + cfg.weight_decay * p.float()
        new_p[k] = (p.float() - lr * step).to(p.dtype)
        new_mu[k], new_nu[k] = mu, nu
    new_state = {**state, "mu": new_mu, "nu": new_nu, "count": count}
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}
