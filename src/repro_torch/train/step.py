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
owns ``state`` and returns it.

Data parallelism (``grad_axis``): the step reduces grads, loss and metrics
over the pod bound to that axis name (``parallel.ctx.bind_axis``; one rank
a member), after the member's own accumulation; ``compress_grads`` swaps
the mean for the int8 error-feedback all-reduce
(``optim.compression.psum_compressed_ef``) with the member's residual in
``state["opt"]["ef"]``, which the non-finite guard rolls back with the
moments.  The chaos poison comes after the reduction, so a NaN never
enters the quantizer.  ``make_pod_train_step`` is the per-rank body of the
reference's ``shard_map``: params, moments and count replicated (bitwise
equal on every rank), the batch the rank's rows, the residual the rank's
own ``(1, *shape)`` row of the reference's ``P("pod")`` array.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch

from repro_torch.optim.adamw import OptimizerConfig, adamw_update
from repro_torch.optim.compression import pmean, psum_compressed_ef
from repro_torch.parallel.ctx import bind_axis, bound_axis

__all__ = ["make_train_step", "make_pod_train_step", "pod_residual",
           "make_eval_step"]


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


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
                    compress_grads: bool = False,
                    on_reduce: Optional[Callable] = None,
                    scale_key: Optional[Callable] = None) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)`` with tensor metrics.
    With ``chaos_guard`` the step is ``step(state, batch, poison)``.

    With ``grad_axis`` the step must run where that axis is bound
    (``make_pod_train_step``), else it raises ``ValueError``.
    ``on_reduce(step, local_grads, residual, grads, new_residual,
    seconds)``, when given, sees each reduction on each rank (``residual``
    and ``new_residual`` None unless compressed) and its wall seconds
    (the device synchronized before and after), before the poison.
    ``scale_key(name)``, when given, groups the compressed leaves that
    share a scale (``models.transformer.stack_key``: the reference's
    stacked arrays)."""
    if chaos_guard and not nan_guard:
        raise ValueError("chaos_guard requires nan_guard (a poisoned "
                         "update must be skipped, not applied)")
    if compress_grads and grad_axis is None:
        raise ValueError("compress_grads requires grad_axis (the int8 "
                         "compressor reduces over a named pod axis)")

    def step(state: dict, batch: dict, poison: Any = None):
        if grad_axis is not None:
            bound_axis(grad_axis)
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
        opt = state["opt"]
        new_ef = None
        if grad_axis is not None:
            residual = ({k: opt["ef"][k] for k in grads} if compress_grads
                        else None)
            if on_reduce is not None:
                _sync(loss)
                t0 = time.perf_counter()
            if compress_grads:
                reduced, new_ef = psum_compressed_ef(
                    grads, residual, grad_axis,
                    groups=(None if scale_key is None
                            else [scale_key(k) for k in grads]))
            else:
                reduced = pmean(grads, grad_axis)
            loss, metrics = pmean((loss, dict(metrics)), grad_axis)
            if on_reduce is not None:
                _sync(loss)
                on_reduce(int(state["step"]), grads, residual, reduced,
                          new_ef, time.perf_counter() - t0)
            grads = reduced
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
            new_p, new_opt, info = adamw_update(values, grads, opt, opt_cfg)
            if new_ef is not None:
                # installed before the guard's select, so that a skipped
                # step rolls the residual back too
                new_opt = {**new_opt, "ef": new_ef}
            metrics = dict(metrics)
            metrics.update(info)
            ok = None
            if nan_guard:
                ok = torch.isfinite(info["grad_norm"]) & torch.isfinite(loss)
                metrics["skipped"] = (~ok).to(torch.float32)
            for k, p in named.items():
                p.copy_(new_p[k] if ok is None
                        else torch.where(ok, new_p[k], p))
            for name in ("mu", "nu", "ef"):
                if name == "ef" and new_ef is None:
                    continue
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


def pod_residual(params: Any, n_pod: int) -> dict:
    """A compressed pod's zero error-feedback residual: shaped like each
    parameter with a leading ``(n_pod,)`` member axis, f32, keyed by the
    parameters' dotted names (``state["opt"]["ef"]``).  A rank holds its
    own row: ``pod_residual(params, 1)``."""
    named = (dict(params.named_parameters()) if hasattr(
        params, "named_parameters") else params)
    return {k: torch.zeros((n_pod,) + tuple(p.shape), dtype=torch.float32,
                           device=p.device) for k, p in named.items()}


def make_pod_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig,
                        mesh, *, axis: str = "pod", compress: bool = True,
                        **step_kwargs) -> Callable:
    """The data-parallel step over ``mesh`` (a ``parallel.ctx.PodMesh``),
    one rank's body: ``make_train_step(..., grad_axis=axis,
    compress_grads=compress)`` run with ``axis`` bound to ``mesh``.  The
    caller passes the rank's rows of the batch; with ``compress`` the
    state's ``opt["ef"]`` holds the rank's ``(1, *shape)`` rows
    (``pod_residual(params, 1)``), updated in place.  ``step_kwargs``
    (``accum_steps``, ``nan_guard``, ``chaos_guard``, ``on_reduce``,
    ``scale_key``) pass through."""
    step = make_train_step(loss_fn, opt_cfg, grad_axis=axis,
                           compress_grads=compress, **step_kwargs)

    def pod_step(state: dict, batch: dict, poison: Any = None):
        opt = state["opt"]
        rows = opt.get("ef")
        if compress:
            opt["ef"] = {k: r[0] for k, r in rows.items()}
        try:
            with bind_axis(mesh, axis):
                return step(state, batch, poison)
        finally:
            if compress:
                opt["ef"] = rows

    return pod_step


def make_eval_step(loss_fn: Callable) -> Callable:
    """``step(params, batch) -> metrics``, without gradients."""
    def step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params, batch)
        return metrics
    return step
