"""Stagewise Pairwise Mixers (SPM) — the paper's core operator (port of
``repro/core/spm.py``).

    SPM(x) = D_out * (B_L ... B_1) * D_in * x + b

with each stage B_l made of n//2 independent 2x2 blocks on disjoint pairs.
Both parameterizations normalize to per-stage coefficients ``(L, n//2, 4)``
= (a, b, c, d); the rotation variant maps theta to (cos, -sin, sin, cos).

``spm_apply`` routes a ``two_level`` operator with ``n_shards > 1`` through
the feature-sharded executor (``parallel/spm_shard.py``) when a matching
feature mesh is active (``parallel/ctx.activation_sharding(mesh,
shard_feature=True)``), an eligible operator through the fused kernel path
(``kernels/ops.spm_stack_fused``: K1 on the card, its plain f32 version on
CPU tensors) and everything else through the composition below, which
computes in ``x.dtype`` as the reference's XLA composition does.  The
composition's backward follows ``SPMConfig.backward`` as the reference's
``_make_core`` does: ``autodiff`` (torch autograd through the stages),
``custom`` (the closed-form eqs. 12-14 from the saved stage inputs) or
``custom_inverse`` (rotation only: each stage input rebuilt from its output
by ``apply_stage_inverse``, so only the output is saved).  The kernel path
has its own closed-form backward (K2, ``kernels/ops.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import pairings
from repro_torch.core.eligibility import sharded_eligible, use_fused_kernel
from repro_torch.core.pairings import Schedule, Stage
from repro_torch.kernels.ref import stage_vjp
from repro_torch.params import Params

__all__ = ["SPMConfig", "init_spm", "stage_coeffs", "apply_stage",
           "apply_stage_inverse", "forward_stages", "spm_apply",
           "spm_matrix"]


@dataclasses.dataclass(frozen=True)
class SPMConfig:
    """Static configuration of one SPM operator (the reference's fields that
    the forward reads)."""

    n: int
    n_stages: int
    variant: str = "general"          # "general" | "rotation"
    schedule: str = "butterfly"       # pairings.make_schedule kinds
    use_diag: bool = True
    use_bias: bool = True
    backward: str = "autodiff"        # "autodiff" | "custom" | "custom_inverse"
    init_mode: str = "orthogonal"     # "orthogonal" | "identity"
    init_scale: float = 0.05
    # Shards of the feature axis for schedule="two_level": the mesh size
    # the sharded executor runs on, and the schedule's block split unless
    # ``schedule_shards`` pins it.
    n_shards: int = 1
    # The two_level schedule's block split, apart from the shards that
    # execute it (default: ``n_shards``).  A schedule built for S blocks
    # runs on any power-of-two divisor m of S (strides below n/m become
    # shard-local runs, the rest partner exchanges), so a restart onto
    # fewer shards keeps the same operator:
    # ``dataclasses.replace(cfg, n_shards=m, schedule_shards=S)``.
    schedule_shards: Optional[int] = None
    seed: int = 0
    param_dtype: torch.dtype = torch.float32
    # Fused kernel path, tri-state: None (auto) and True take the kernel
    # path when eligible; False keeps the composition.
    use_kernel: Optional[bool] = None
    # Overlap schedule of the sharded executor, tri-state
    # (eligibility.resolve_overlap): True splits every step into row
    # blocks and fuses each {local run -> cross} pair into K5/K6 on the
    # card; None (auto) and False keep the step-serial schedule.
    overlap: Optional[bool] = None
    # Int8 modes of the kernel path (kernels/quant.py conventions), inert
    # on the composition; compute stays f32.  quant_acts: int8 activation
    # I/O between the runs, for plans whose runs share one tile
    # (eligibility.quant_acts_eligible; others keep f32/bf16 I/O).
    # quant_coeffs: int8 coefficient tables with one scale a stage; the
    # coefficient grads are those of the dequantized table.  The sharded
    # executor reads quant_coeffs alone (one scale a stage of each shard's
    # own table) and ignores quant_acts, as the reference's does.
    quant_acts: bool = False
    quant_coeffs: bool = False

    def __post_init__(self):
        if self.variant not in ("general", "rotation"):
            raise ValueError(f"bad variant {self.variant!r}")
        if self.backward == "custom_inverse" and self.variant != "rotation":
            raise ValueError("custom_inverse backward requires the rotation "
                             "variant (blocks must be orthogonal)")

    @functools.cached_property
    def pairing(self) -> Schedule:
        """The operator's pairing schedule (built once; two_level splits
        into ``schedule_shards or n_shards`` blocks)."""
        return pairings.make_schedule(
            self.schedule, self.n, self.n_stages,
            n_shards=self.schedule_shards or self.n_shards, seed=self.seed)

    @property
    def n_pairs(self) -> int:
        """Pairs per stage (the odd lane, if any, rides ``res_scale``)."""
        return self.n // 2

    @property
    def odd(self) -> bool:
        """Odd width: one lane per stage stays unpaired."""
        return self.n % 2 == 1


def init_spm(cfg: SPMConfig, generator: torch.Generator,
             device: torch.device, lead: Tuple[int, ...] = ()) -> Params:
    """Random per-pair rotations plus small noise (``init_mode=
    "orthogonal"``) or identity plus noise, as the reference initializes;
    the numbers come from ``generator`` (torch, so not the reference's).
    The parameter names are the reference's pytree keys.  ``lead`` (the
    MoE's ``(E,)``) stacks that many independent operators on every
    leaf."""
    dt = cfg.param_dtype
    L, P = cfg.n_stages, cfg.n_pairs
    kw = dict(generator=generator, device=device, dtype=dt)
    lead = tuple(lead)

    def uniform_angle():
        return (torch.rand(*lead, L, P, **kw) * 2 - 1) * math.pi

    def const(value, *shape):
        return torch.full((*lead, *shape), value, dtype=dt, device=device)

    p: dict = {}
    if cfg.variant == "rotation":
        p["theta"] = (cfg.init_scale * torch.randn(*lead, L, P, **kw)
                      if cfg.init_mode == "identity" else uniform_angle())
    else:
        if cfg.init_mode == "identity":
            base = torch.tensor([1.0, 0.0, 0.0, 1.0], dtype=dt,
                                device=device).expand(*lead, L, P, 4)
        else:
            th = uniform_angle()
            c, s = torch.cos(th), torch.sin(th)
            base = torch.stack([c, -s, s, c], dim=-1)
        p["mix"] = base + cfg.init_scale * torch.randn(*lead, L, P, 4, **kw)
    if cfg.odd:
        p["res_scale"] = const(1.0, L)
    if cfg.use_diag:
        p["d_in"] = const(1.0, cfg.n)
        p["d_out"] = const(1.0, cfg.n)
    if cfg.use_bias:
        p["bias"] = const(0.0, cfg.n)
    return Params(p)


def stage_coeffs(params, cfg: SPMConfig) -> torch.Tensor:
    """Either parameterization as (L, n_pairs, 4) = (a, b, c, d)."""
    if cfg.variant == "rotation":
        th = params["theta"]
        c, s = torch.cos(th), torch.sin(th)
        return torch.stack([c, -s, s, c], dim=-1)
    return params["mix"]


def apply_stage(x: torch.Tensor, coeffs: torch.Tensor, stage: Stage,
                res_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply one stage B_l to the last axis of x; coeffs (n_pairs, 4).
    Stride stages mix ``(i, i+s)`` inside groups of 2s; permutation stages
    mix ``(perm[2i], perm[2i+1])`` and scale an odd last lane by
    ``res_scale``."""
    a, b, c, d = coeffs.unbind(-1)
    n = x.shape[-1]
    lead = x.shape[:-1]
    if stage.structured:
        s = stage.stride
        g = n // (2 * s)
        xr = x.reshape(*lead, g, 2, s)
        x0, x1 = xr[..., 0, :], xr[..., 1, :]
        ar, br, cr, dr = (v.reshape(g, s) for v in (a, b, c, d))
        y0 = ar * x0 + br * x1
        y1 = cr * x0 + dr * x1
        return torch.stack([y0, y1], dim=-2).reshape(*lead, n)
    perm = torch.as_tensor(stage.perm, device=x.device)
    inv = torch.as_tensor(np.argsort(stage.perm), device=x.device)
    n_pairs = n // 2
    xg = x[..., perm]
    xp = xg[..., : 2 * n_pairs].reshape(*lead, n_pairs, 2)
    y0 = a * xp[..., 0] + b * xp[..., 1]
    y1 = c * xp[..., 0] + d * xp[..., 1]
    yp = torch.stack([y0, y1], dim=-1).reshape(*lead, 2 * n_pairs)
    if n % 2:
        rs = (res_scale if res_scale is not None
              else torch.ones((), dtype=x.dtype, device=x.device))
        yp = torch.cat([yp, (xg[..., -1] * rs)[..., None]], dim=-1)
    return yp[..., inv]


def apply_stage_inverse(y: torch.Tensor, coeffs: torch.Tensor,
                        stage: Stage,
                        res_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Invert one stage through each block's 2x2 inverse (for rotation
    blocks, the transpose)."""
    a, b, c, d = coeffs.unbind(-1)
    det = a * d - b * c
    inv = torch.stack([d / det, -b / det, -c / det, a / det], dim=-1)
    inv_rs = None if res_scale is None else 1.0 / res_scale
    return apply_stage(y, inv, stage, res_scale=inv_rs)


def forward_stages(coeffs: torch.Tensor, res_scales: Optional[torch.Tensor],
                   x: torch.Tensor, sched: Schedule,
                   collect: bool = False):
    """Run every stage of ``sched`` in order; with ``collect`` also return
    the list of stage inputs."""
    zs = []
    z = x
    for ell, stage in enumerate(sched.stages):
        if collect:
            zs.append(z)
        rs = None if res_scales is None else res_scales[ell]
        z = apply_stage(z, coeffs[ell], stage, res_scale=rs)
    return (z, zs) if collect else z


def _stage_grads(z_in: torch.Tensor, delta: torch.Tensor,
                 coeffs: torch.Tensor, stage: Stage,
                 res_scale: Optional[torch.Tensor]):
    """Closed-form grads of one stage (paper eqs. 12-14, pairwise):
    ``(g_input, g_coeffs (n_pairs, 4), g_res_scale or None)``, the
    parameter grads summed over every leading (batch) axis."""
    n = z_in.shape[-1]
    lead = z_in.shape[:-1]
    bdims = tuple(range(len(lead)))

    def bsum(t):
        return t.sum(dim=bdims) if bdims else t

    if stage.structured:
        return (*stage_vjp(z_in, delta, coeffs, stage.stride), None)
    perm = torch.as_tensor(stage.perm, device=z_in.device)
    inv = torch.as_tensor(np.argsort(stage.perm), device=z_in.device)
    n_pairs = n // 2
    zg = z_in[..., perm]
    dg = delta[..., perm]
    zp = zg[..., : 2 * n_pairs].reshape(*lead, n_pairs, 2)
    dp = dg[..., : 2 * n_pairs].reshape(*lead, n_pairs, 2)
    x0, x1 = zp[..., 0], zp[..., 1]
    d0, d1 = dp[..., 0], dp[..., 1]
    a, b, c, d = coeffs.unbind(-1)
    gp = torch.stack([a * d0 + c * d1, b * d0 + d * d1],
                     dim=-1).reshape(*lead, 2 * n_pairs)
    g_rs = None
    if n % 2:
        rs = (res_scale if res_scale is not None
              else torch.ones((), dtype=z_in.dtype, device=z_in.device))
        g_rs = (dg[..., -1] * zg[..., -1]).sum()
        gp = torch.cat([gp, (dg[..., -1] * rs)[..., None]], dim=-1)
    g_cf = torch.stack([bsum(d0 * x0), bsum(d0 * x1), bsum(d1 * x0),
                        bsum(d1 * x1)], dim=-1)
    return gp[..., inv], g_cf, g_rs


def _walk_back(sched: Schedule, coeffs, res_scales, delta, stage_input):
    """The closed-form reverse walk shared by both custom modes;
    ``stage_input(ell, z_out)`` gives stage ell's input."""
    g_cf, g_rs = [], []
    z = None
    for ell in range(len(sched.stages) - 1, -1, -1):
        stage = sched.stages[ell]
        rs = res_scales[ell]
        z = stage_input(ell, z)
        delta, gc, grs = _stage_grads(z, delta, coeffs[ell], stage, rs)
        g_cf.append(gc)
        g_rs.append(grs if grs is not None
                    else torch.zeros((), dtype=delta.dtype,
                                     device=delta.device))
    return (torch.stack(g_cf[::-1], dim=0), torch.stack(g_rs[::-1]),
            delta)


class _CustomCore(torch.autograd.Function):
    """``custom``: saves every stage input, eqs. 12-14 backward."""

    @staticmethod
    def forward(ctx, coeffs, res_scales, x, sched):
        y, zs = forward_stages(coeffs, res_scales, x, sched, collect=True)
        ctx.sched = sched
        ctx.save_for_backward(coeffs, res_scales, *zs)
        return y

    @staticmethod
    def backward(ctx, gy):
        coeffs, res_scales, *zs = ctx.saved_tensors
        g_cf, g_rs, g_x = _walk_back(ctx.sched, coeffs, res_scales, gy,
                                     lambda ell, _: zs[ell])
        return g_cf, g_rs, g_x, None


class _InverseCore(torch.autograd.Function):
    """``custom_inverse``: saves only the output and rebuilds each stage
    input from the one after it (orthogonal blocks)."""

    @staticmethod
    def forward(ctx, coeffs, res_scales, x, sched):
        y = forward_stages(coeffs, res_scales, x, sched)
        ctx.sched = sched
        ctx.save_for_backward(coeffs, res_scales, y)
        return y

    @staticmethod
    def backward(ctx, gy):
        coeffs, res_scales, y = ctx.saved_tensors
        sched = ctx.sched

        def stage_input(ell, z_out):
            z_out = y if z_out is None else z_out
            return apply_stage_inverse(z_out, coeffs[ell], sched.stages[ell],
                                       res_scale=res_scales[ell])

        g_cf, g_rs, g_x = _walk_back(sched, coeffs, res_scales, gy,
                                     stage_input)
        return g_cf, g_rs, g_x, None


def _core(coeffs, res_scales, x, sched: Schedule, mode: str):
    """The L-stage composition with the backward of ``mode``."""
    if mode == "autodiff":
        return forward_stages(coeffs, res_scales, x, sched)
    if mode == "custom":
        return _CustomCore.apply(coeffs, res_scales, x, sched)
    if mode == "custom_inverse":
        return _InverseCore.apply(coeffs, res_scales, x, sched)
    raise ValueError(f"unknown backward mode {mode!r}")


def spm_apply(params, x: torch.Tensor, cfg: SPMConfig, *,
              in_width: Optional[int] = None,
              out_width: Optional[int] = None) -> torch.Tensor:
    """Full SPM forward ``y = D_out (B_L...B_1) D_in x + bias`` on the last
    axis.  ``in_width`` / ``out_width`` embed a rectangular map: x is
    (..., in_width), zero-filled to n, and the first ``out_width`` outputs
    are returned.  The kernel path computes in f32 with I/O in x's dtype;
    the composition computes in x's dtype.  A sharded operator
    (``n_shards > 1``) under a feature mesh of that size runs in the
    sharded executor, whose local runs take the kernel path.

    Params stacked over a leading expert axis (an MoE's experts: tables
    (E, L, n/2, 4), vectors (E, n)) take x (E, ..., width): the kernel path
    runs each run of all experts in one expert-mode launch, the sharded
    executor each step of all experts at once; the composition runs them
    one at a time."""
    n = cfg.n
    table = params["theta" if cfg.variant == "rotation" else "mix"]
    if table.dim() == (3 if cfg.variant == "rotation" else 4):
        return _spm_apply_experts(params, x, cfg, in_width, out_width)
    in_width = None if in_width == n else in_width
    out_width = None if out_width == n else out_width
    expect = in_width if in_width is not None else n
    if x.shape[-1] != expect:
        raise ValueError(f"expected (..., {expect}), got {tuple(x.shape)}")
    sched = cfg.pairing
    if cfg.n_shards > 1:
        from repro_torch.parallel import ctx as par_ctx  # lazy: core light
        mesh = par_ctx.feature_mesh(cfg.n_shards)
        if mesh is not None and sharded_eligible(cfg, sched):
            from repro_torch.parallel import spm_shard
            return spm_shard.spm_apply_sharded(
                params, x, cfg, mesh, in_width=in_width, out_width=out_width)
    if use_fused_kernel(cfg, sched):
        from repro_torch.kernels import ops as kernel_ops  # lazy: core light
        return kernel_ops.spm_stack_fused(
            x, stage_coeffs(params, cfg), sched.strides(),
            d_in=params["d_in"] if cfg.use_diag else None,
            d_out=params["d_out"] if cfg.use_diag else None,
            bias=params["bias"] if cfg.use_bias else None,
            in_width=in_width, out_width=out_width,
            quant_acts=cfg.quant_acts, quant_coeffs=cfg.quant_coeffs)
    if in_width is not None:
        x = F.pad(x, (0, n - in_width))
    coeffs = stage_coeffs(params, cfg).to(x.dtype)
    res_scales = params.get("res_scale")
    res_scales = (torch.ones(cfg.n_stages, dtype=x.dtype, device=x.device)
                  if res_scales is None else res_scales.to(x.dtype))
    z = x
    if cfg.use_diag:
        z = z * params["d_in"].to(x.dtype)
    z = _core(coeffs, res_scales, z, sched, cfg.backward)
    if cfg.use_diag:
        z = z * params["d_out"].to(x.dtype)
    if cfg.use_bias:
        z = z + params["bias"].to(x.dtype)
    if out_width is not None:
        z = z[..., :out_width]
    return z


def _spm_apply_experts(params, x: torch.Tensor, cfg: SPMConfig, in_width,
                       out_width) -> torch.Tensor:
    """``spm_apply`` over params with a leading expert axis."""
    coeffs = stage_coeffs(params, cfg)
    E = coeffs.shape[0]
    if x.shape[0] != E:
        raise ValueError(f"expected x ({E}, ..., width), got "
                         f"{tuple(x.shape)}")
    if cfg.n_shards > 1:
        from repro_torch.parallel import ctx as par_ctx
        mesh = par_ctx.feature_mesh(cfg.n_shards)
        if mesh is not None and sharded_eligible(cfg, cfg.pairing):
            from repro_torch.parallel import spm_shard
            return spm_shard.spm_apply_sharded(
                params, x, cfg, mesh, in_width=in_width, out_width=out_width)
    if use_fused_kernel(cfg, cfg.pairing):
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.spm_stack_fused(
            x, coeffs, cfg.pairing.strides(),
            d_in=params["d_in"] if cfg.use_diag else None,
            d_out=params["d_out"] if cfg.use_diag else None,
            bias=params["bias"] if cfg.use_bias else None,
            in_width=in_width, out_width=out_width,
            quant_acts=cfg.quant_acts, quant_coeffs=cfg.quant_coeffs)
    return torch.stack([
        spm_apply({k: params[k][e] for k in params.keys()}, x[e], cfg,
                  in_width=in_width, out_width=out_width)
        for e in range(E)])


def spm_matrix(params, cfg: SPMConfig) -> torch.Tensor:
    """The full n x n operator W with ``spm_apply(params, x) == W @ x +
    bias`` (tests and analysis only, O(n^2 L))."""
    p = {k: params[k] for k in params.keys()}
    if cfg.use_bias:
        p["bias"] = torch.zeros_like(p["bias"])
    leaf = next(iter(p.values()))
    eye = torch.eye(cfg.n, dtype=torch.float32, device=leaf.device)
    return spm_apply(p, eye, cfg).T
