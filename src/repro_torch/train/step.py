"""Train and eval step factories (port of ``repro/train/step.py``).

``make_train_step(loss_fn, opt_cfg, ...)`` returns ``step(state, batch[,
poison]) -> (state, metrics)``:

* gradient accumulation over ``accum_steps`` microbatches (the batch split
  along axis 0; grads summed then averaged; metrics averaged, with ``ce``
  weighted by each microbatch's ``ce_weight`` so it is the masked mean of
  the whole batch, as the reference has it, ``train/step.py:108-130``);
* global-norm clipping, AdamW and the cosine schedule;
* the non-finite guard (``nan_guard``): when the grad norm or the loss is
  not finite the update is dropped on the device, with ``torch.where``
  against the old values, so params and optimizer state stay bitwise as
  they were, and ``metrics["skipped"]`` is 1;
* the chaos port (``chaos_guard``): a nonzero ``poison`` multiplies the
  grads by NaN; zero multiplies by an exact 1.0.

Params are updated in place (the reference returns a new tree): the step
owns ``state`` and returns it.  Data-parallel reduction (``grad_axis``,
``compress_grads``, ``make_pod_train_step``) is the multi-device slice.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.optim.adamw import OptimizerConfig, adamw_update

__all__ = ["make_train_step", "make_pod_train_step", "make_eval_step"]

_MULTI = "ROADMAP.md §1, item 6 (multi-device)"


def _split(batch: dict, accum_steps: int) -> list:
    b = next(iter(batch.values())).shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} does not split into {accum_steps} "
                         "microbatches")
    m = b // accum_steps
    return [{k: v[i * m: (i + 1) * m] for k, v in batch.items()}
            for i in range(accum_steps)]


def _average(stacked: list) -> dict:
    metrics = {k: torch.stack([m[k] for m in stacked]).mean(0)
               for k in stacked[0]}
    if "ce" in metrics and "ce_weight" in metrics:
        w = torch.stack([m["ce_weight"] for m in stacked])
        ce = torch.stack([m["ce"] for m in stacked])
        metrics["ce"] = torch.sum(ce * w) / torch.clamp(w.sum(), min=1.0)
        metrics["ce_weight"] = w.sum()
        if "ppl_proxy" in metrics:
            metrics["ppl_proxy"] = torch.exp(torch.clamp(metrics["ce"],
                                                         max=20.0))
    return metrics


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig, *,
                    accum_steps: int = 1, nan_guard: bool = True,
                    chaos_guard: bool = False,
                    grad_axis: Optional[str] = None,
                    compress_grads: bool = False) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)`` with tensor metrics.
    With ``chaos_guard`` the step is ``step(state, batch, poison)``."""
    if chaos_guard and not nan_guard:
        raise ValueError("chaos_guard requires nan_guard (a poisoned "
                         "update must be skipped, not applied)")
    if grad_axis is not None or compress_grads:
        raise NotImplementedError(
            f"data-parallel gradient reduction is not ported yet ({_MULTI})")

    def step(state: dict, batch: dict, poison: Any = None):
        params = state["params"]
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        micro = [batch] if accum_steps == 1 else _split(batch, accum_steps)
        losses, stacked = [], []
        for mb in micro:
            loss, metrics = loss_fn(params, mb)
            loss.backward()
            losses.append(loss.detach())
            stacked.append({k: v.detach() for k, v in metrics.items()})
        scale = 1.0 / accum_steps
        loss = torch.stack(losses).sum() * scale
        metrics = stacked[0] if accum_steps == 1 else _average(stacked)
        grads = {k: (torch.zeros_like(p, dtype=torch.float32)
                     if p.grad is None else p.grad.float() * scale
                     if accum_steps > 1 else p.grad)
                 for k, p in named.items()}
        if chaos_guard:
            if poison is None:
                raise TypeError("chaos_guard step requires the poison "
                                "argument: step(state, batch, poison)")
            factor = torch.where(
                torch.as_tensor(poison, device=loss.device) != 0,
                torch.tensor(float("nan"), device=loss.device),
                torch.tensor(1.0, device=loss.device))
            grads = {k: g * factor.to(g.dtype) for k, g in grads.items()}
        with torch.no_grad():
            values = {k: p.detach() for k, p in named.items()}
            new_p, new_opt, info = adamw_update(values, grads, state["opt"],
                                                opt_cfg)
            metrics = dict(metrics)
            metrics.update(info)
            ok = None
            if nan_guard:
                ok = torch.isfinite(info["grad_norm"]) & torch.isfinite(loss)
                metrics["skipped"] = (~ok).to(torch.float32)
            for k, p in named.items():
                p.copy_(new_p[k] if ok is None
                        else torch.where(ok, new_p[k], p))
            opt = state["opt"]
            for name in ("mu", "nu"):
                for k, t in opt[name].items():
                    t.copy_(new_opt[name][k] if ok is None
                            else torch.where(ok, new_opt[name][k], t))
            opt["count"] = (new_opt["count"] if ok is None else
                            torch.where(ok, new_opt["count"], opt["count"]))
            state["step"] = state["step"] + 1
        for p in named.values():
            p.grad = None
        return state, metrics

    return step


def make_pod_train_step(*args, **kwargs) -> Callable:
    """The data-parallel pod step: not ported yet."""
    raise NotImplementedError(f"the pod train step is not ported yet "
                              f"({_MULTI})")


def make_eval_step(loss_fn: Callable) -> Callable:
    """``step(params, batch) -> metrics``, without gradients."""
    def step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params, batch)
        return metrics
    return step
