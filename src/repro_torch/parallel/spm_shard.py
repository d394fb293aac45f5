"""The feature-sharded two_level SPM executor, step-serial (port of
``repro/parallel/spm_shard.py`` without the overlap schedule).

With ``n = n_shards * n_local`` features in contiguous shard blocks, every
stage of a two_level schedule (``core/eligibility.plan_steps``) is one of
two shapes:

* **shard-local run** (``n_local % (2*s) == 0``): each shard runs the
  maximal run of local stages on its ``(rows, n_local)`` slab through K1
  (``kernels/spm_stack.py``; the plain version on CPU tensors) or, with the
  kernel path off, the 2x2 composition;
* **cross stage** (``s = k * n_local``, ``k`` a power of two): lane ``r``
  of shard ``j`` pairs with lane ``r`` of shard ``j XOR k``.  The partner
  hands over its slab (``_exchange``) and each shard mixes locally: the
  low partner (``j & k == 0``) computes ``y0 = a*z + b*zp``, the high one
  ``y1 = c*zp + d*z``.

The whole operator is one ``torch.autograd.Function`` over the global
``(rows, in_width or n)`` input (the reference's ``custom_vjp`` around its
``shard_map``).  Its forward walks the steps in order, every shard's local
run and then, at a cross step, every shard's exchange and mix; the backward
walks them in reverse.  The exchange is its own transpose, so the backward
issues the same hand-overs (of the saved stage input, for the coefficient
grads, and of the cotangent).  Each shard returns only the coefficient-grad
components its role owns (low: a, b; high: c, d); the per-step tables are
built outside the Function by differentiable indexing (``_step_tables``),
so autograd's scatter-add merges the two partners' partials into the shared
rows.  Diagonal and bias grads are per-shard slices of (n,) vectors.

Operator boundaries fold as in the reference: ``d_in`` into the first K1
run of a first local step, ``d_out``/``bias`` into the last K1 run of a
last local step, or, when the schedule ends on a cross stage, into the mix
itself, scaling the mixed sum on the store (after the add).

A rectangular ``in_width`` enters whole (feature-replicated) and the first
local run reads each shard's ``n_local`` window straight out of it: K1's
and K2's ``col_base`` mode, x read at global column ``(col_base + j) *
n_tile + c`` and zero past the global ``in_width``, so no padded copy is
made.  The backward remats through the same windowed read and K2 returns
the shard's ``(rows, n_local)`` g_x slab; the slabs are assembled and cut
to ``in_width``.  The output is assembled to ``(rows, n)`` and cut to
``out_width``; its cotangent enters the backward zero-padded to n.

The mesh (``parallel/ctx.FeatureMesh``) binds each shard to a device.  This
slice keeps every shard on the input's own device, and a mesh that places
one elsewhere raises: a hand-over is then the partner's slab itself, and no
shard's work leaves the card (or the CPU) its input is on.  Shards on
distinct cards with a real transport, and the overlap schedule (K5/K6), are
later slices (ROADMAP.md).  The mix computes in the activation dtype, rounding
after each operation as the reference's CPU run does (bf16 included).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import spm as spm_mod
from repro_torch.core.eligibility import plan_steps, resolve_shard_kernel
from repro_torch.core.pairings import Stage
from repro_torch.kernels import spm_stack as K
from repro_torch.kernels.ops import plan_runs_for_rows
from repro_torch.parallel.ctx import FeatureMesh

__all__ = ["spm_apply_sharded", "cross_partner_perm", "ShardPlan"]

AXIS = "model"


def cross_partner_perm(n_shards: int, k: int) -> Tuple[Tuple[int, int], ...]:
    """The partner map of a cross stage: shard j <-> j XOR k (an
    involution, so the backward makes the same exchange)."""
    return tuple((j, j ^ k) for j in range(n_shards))


@functools.lru_cache(maxsize=None)
def _cross_coeff_rows(n_shards: int, n_local: int, k: int) -> np.ndarray:
    """(n_shards, n_local) pair-row indices of a cross stage: lane r of
    shard j (and of its partner j XOR k: the rows are shared) uses pair
    Q(j)*n_local + r with Q(j) = ((j & ~k) // 2k)*k + ((j & ~k) % 2k)."""
    j = np.arange(n_shards)
    jl = j & ~k                       # the pair's low-partner shard id
    q = (jl // (2 * k)) * k + (jl % (2 * k))
    return q[:, None] * n_local + np.arange(n_local)[None, :]


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """The static description of one sharded operator call.

    ``in_width`` / ``out_width`` are the global rectangular widths (None:
    square).  ``win_in``: the first local run reads the input through K1's
    and K2's windowed (``col_base``) mode; ``fold_*``: the diagonal and
    bias operands fold into the boundary runs or the ending mix instead of
    running as separate elementwise ops."""

    n: int
    n_local: int
    n_shards: int
    steps: Tuple[tuple, ...]
    has_din: bool
    has_dout: bool
    has_bias: bool
    use_kernel: bool
    in_width: Optional[int] = None
    out_width: Optional[int] = None

    @property
    def first_local(self) -> bool:
        return self.steps[0][0] == "local"

    @property
    def last_local(self) -> bool:
        return self.steps[-1][0] == "local"

    @property
    def fold_din(self) -> bool:
        """D_in folds into the first kernel run of the first local step."""
        return self.has_din and self.use_kernel and self.first_local

    @property
    def fold_dout(self) -> bool:
        """D_out folds into the last kernel run of a last local step, or
        into the mix of a last cross stage, scaling the mixed sum on the
        store."""
        return self.has_dout and (self.use_kernel if self.last_local
                                  else True)

    @property
    def fold_bias(self) -> bool:
        """Bias folds exactly like ``fold_dout``."""
        return self.has_bias and (self.use_kernel if self.last_local
                                  else True)

    @property
    def win_in(self) -> bool:
        """The first kernel run reads the (rows, in_width) global input
        through a windowed (``col_base``) call."""
        return (self.in_width is not None and self.use_kernel
                and self.first_local)

    @property
    def saves_x_res(self) -> bool:
        """Whether the stage-0 input is kept apart from the step inputs:
        the whole x under ``win_in``, else the pre-D_in slab when g_din is
        computed outside the kernels."""
        return self.win_in or (self.has_din and not self.fold_din)

    @property
    def saves_z_last(self) -> bool:
        """z_L (before D_out) is kept only when g_dout is computed outside
        the kernels."""
        return self.has_dout and not self.fold_dout

    def shard_slice(self, j: int) -> slice:
        """Shard j's columns of the (n,) feature axis."""
        return slice(j * self.n_local, (j + 1) * self.n_local)


@functools.lru_cache(maxsize=None)
def _cross_rows_on(n_shards: int, n_local: int, k: int,
                   device: torch.device) -> torch.Tensor:
    """``_cross_coeff_rows`` as an index tensor on ``device``, made once:
    a copy from the host at every call would wait for the device."""
    return torch.as_tensor(_cross_coeff_rows(n_shards, n_local, k),
                           device=device)


def _step_tables(coeffs: torch.Tensor, steps, n_shards: int,
                 n_local: int) -> Tuple[torch.Tensor, ...]:
    """Per-step coefficient tables with a leading shard axis.  A local step
    takes shard j's contiguous pair block of each of its stages,
    ``(S, Lr, n_local/2, 4)``; a cross step the shared partner rows,
    ``(S, n_local, 4)``.  Differentiable: the cross case is a gather whose
    backward scatter-adds the two partners' partials into the shared rows.
    Each shard's table is contiguous."""
    nl2 = n_local // 2
    tabs = []
    for step in steps:
        if step[0] == "local":
            _, start, run = step
            blk = coeffs[start: start + len(run)]          # (Lr, n/2, 4)
            tabs.append(blk.reshape(len(run), n_shards, nl2, 4)
                        .transpose(0, 1).contiguous())     # (S, Lr, nl2, 4)
        else:
            _, ell, k = step
            rows = _cross_rows_on(n_shards, n_local, k, coeffs.device)
            tabs.append(coeffs[ell][rows])                 # (S, n_local, 4)
    return tuple(tabs)


def _window_slab(x_full: torch.Tensor, base_col: int, n_local: int,
                 width: int) -> torch.Tensor:
    """One shard's (rows, n_local) slab of a feature-complete (rows, width)
    operand, zero past ``width``: the read of the composition path (the
    kernel path reads the window in K1 and K2 without this copy)."""
    col = base_col + torch.arange(n_local, device=x_full.device)
    slab = x_full[:, col.clamp(max=width - 1)]
    return torch.where(col < width, slab, torch.zeros_like(slab))


# ---------------------------------------------------------------------------
# cross stages
# ---------------------------------------------------------------------------

def _exchange(slabs: List[torch.Tensor], k: int) -> List[torch.Tensor]:
    """The partner exchange of a cross stage: shard j receives the slab of
    its partner in ``cross_partner_perm`` (all shards share one device)."""
    return [slabs[p] for _, p in cross_partner_perm(len(slabs), k)]


def _cross_mix(z, zp, cf, low: bool, d_out=None, bias=None):
    """The local 2x2 half of a cross stage in the activation dtype: the low
    partner computes ``a*z + b*zp``, the high one ``c*zp + d*z``.  The
    operand order is the reference's (``spm_shard.py:354``), which elastic
    re-sharding keeps bitwise.  A schedule-ending stage scales the mixed
    sum by ``d_out`` after the add, then adds ``bias``."""
    a, b, c, d = (cf[:, i].to(z.dtype) for i in range(4))
    y = a * z + b * zp if low else c * zp + d * z
    if d_out is not None:
        y = y * d_out.to(z.dtype)
    if bias is not None:
        y = y + bias.to(z.dtype)
    return y


def _cross_bwd(z_in, delta, cfs, k: int, plan: ShardPlan, d_out=None,
               has_bias: bool = False):
    """The backward of a cross stage over all shards.  ``z_in`` and
    ``delta`` are per-shard lists; returns ``(g_in, g_cf, g_dout,
    g_bias)``, per-shard lists, the last two None unless folded here.

    Each shard receives its partner's saved input and cotangent (the same
    exchange).  Its coefficient grads fill only the components its role
    owns: low (d0, x0) with x1 = zp: g_a = sum d0 x0, g_b = sum d0 x1;
    high (d1, x1) with x0 = zp: g_c = sum d1 x0, g_d = sum d1 x1.  With a
    folded ``d_out`` the raw output cotangent arrives: ``g_bias`` sums it,
    ``g_dout`` contracts it with the mix output rematted in f32 in the
    forward's operand order, and each shard scales it by its own d_out
    slice before the exchange."""
    S = plan.n_shards
    zp = _exchange(z_in, k)
    g_dout = g_bias = None
    if d_out is not None or has_bias:
        if has_bias:
            g_bias = [delta[j].float().sum(0) for j in range(S)]
        if d_out is not None:
            g_dout = []
            for j in range(S):
                a, b, c, d = (cfs[j][:, i].float() for i in range(4))
                zf, zpf = z_in[j].float(), zp[j].float()
                m = a * zf + b * zpf if j & k == 0 else c * zpf + d * zf
                g_dout.append((delta[j].float() * m).sum(0))
            delta = [delta[j] * d_out[j].to(delta[j].dtype)
                     for j in range(S)]
    dp = _exchange(delta, k)
    g_in, g_cf = [], []
    for j in range(S):
        a, b, c, d = (cfs[j][:, i].to(delta[j].dtype) for i in range(4))
        low = j & k == 0
        # g_x0 = a d0 + c d1 on the low shard; g_x1 = b d0 + d d1 on the high
        g_in.append(a * delta[j] + c * dp[j] if low
                    else b * dp[j] + d * delta[j])
        s_own = (delta[j].float() * z_in[j].float()).sum(0)
        s_swp = (delta[j].float() * zp[j].float()).sum(0)
        zero = torch.zeros_like(s_own)
        g_cf.append(torch.stack([s_own, s_swp, zero, zero], dim=-1) if low
                    else torch.stack([zero, zero, s_swp, s_own], dim=-1))
    return g_in, g_cf, g_dout, g_bias


# ---------------------------------------------------------------------------
# shard-local runs
# ---------------------------------------------------------------------------

def _segment_fwd(z, cf, run: Tuple[int, ...], plan: ShardPlan, *,
                 d_in=None, d_out=None, bias=None,
                 col_base: Optional[int] = None):
    """A maximal run of local stages on one shard's slab: K1 once per
    planned run, ``d_in`` folded into the first and ``d_out``/``bias`` into
    the last, or the composition with the kernel path off.  With
    ``col_base`` (a global column) ``z`` is the whole (rows, in_width)
    input and the first run reads this shard's window of it."""
    if plan.use_kernel:
        runs = plan_runs_for_rows(plan.n_local, run, z.shape[0])
        off = 0
        for r, (run_strides, n_tile) in enumerate(runs):
            first, last = r == 0, r == len(runs) - 1
            win = first and col_base is not None
            z = K.spm_stack_kernel_call(
                z, cf[off: off + len(run_strides)],
                d_in if first else None, d_out if last else None,
                bias if last else None, strides=run_strides, n_tile=n_tile,
                in_width=plan.in_width if win else None,
                col_base=col_base // n_tile if win else None)
            off += len(run_strides)
        return z
    for i, s in enumerate(run):
        z = spm_mod.apply_stage(z, cf[i].to(z.dtype), Stage(stride=s))
    return z


def _segment_bwd(z_in, delta, cf, run: Tuple[int, ...], plan: ShardPlan, *,
                 d_in=None, d_out=None, has_bias: bool = False,
                 col_base: Optional[int] = None):
    """The closed-form backward of a local run from its saved input: the
    forward's runs are rematted but for the last, then K2 once per run in
    reverse (the first in the windowed mode with ``col_base``, returning
    this shard's (rows, n_local) g_x), or with the kernel path off the
    composition's per-stage eqs. 12-14.  Returns ``(delta, g_coeffs,
    g_din, g_dout, g_bias)``, the last three None unless folded here."""
    if plan.use_kernel:
        runs = plan_runs_for_rows(plan.n_local, run, delta.shape[0])
        zs, z, off = [], z_in, 0
        for r, (run_strides, n_tile) in enumerate(runs):
            zs.append(z)
            win = r == 0 and col_base is not None
            if r < len(runs) - 1:          # the last output is not needed
                z = K.spm_stack_kernel_call(
                    z, cf[off: off + len(run_strides)],
                    d_in if r == 0 else None, strides=run_strides,
                    n_tile=n_tile,
                    in_width=plan.in_width if win else None,
                    col_base=col_base // n_tile if win else None)
            off += len(run_strides)
        offs = np.cumsum([0] + [len(rs) for rs, _ in runs])
        g_parts = [None] * len(runs)
        g_din = g_dout = g_bias = None
        for r in range(len(runs) - 1, -1, -1):
            run_strides, n_tile = runs[r]
            first, last = r == 0, r == len(runs) - 1
            win = first and col_base is not None
            out = K.spm_stack_bwd_kernel_call(
                zs[r], cf[offs[r]: offs[r + 1]], delta,
                d_in if first else None, d_out if last else None,
                strides=run_strides, n_tile=n_tile,
                has_bias=last and has_bias,
                in_width=plan.in_width if win else None,
                col_base=col_base // n_tile if win else None)
            delta, g_parts[r] = out[0], out[1]
            vecs = list(out[2:])
            if first and d_in is not None:
                g_din = vecs.pop(0)
            if last and d_out is not None:
                g_dout = vecs.pop(0)
            if last and has_bias:
                g_bias = vecs.pop(0)
        return delta, torch.cat(g_parts, dim=0), g_din, g_dout, g_bias
    zs, z = [], z_in
    for i, s in enumerate(run):
        zs.append(z)
        if i < len(run) - 1:
            z = spm_mod.apply_stage(z, cf[i].to(z.dtype), Stage(stride=s))
    g_cf = []
    for i in range(len(run) - 1, -1, -1):
        delta, gc, _ = spm_mod._stage_grads(
            zs[i], delta, cf[i].to(delta.dtype), Stage(stride=run[i]), None)
        g_cf.append(gc)
    return delta, torch.stack(g_cf[::-1], dim=0), None, None, None


# ---------------------------------------------------------------------------
# the walk over all shards
# ---------------------------------------------------------------------------

def _shard_operands(plan: ShardPlan, tables, d_in, d_out, bias):
    """Shard j's operands: its table of every step and its slices of the
    (n,) vectors (None where absent)."""
    ops = []
    for j in range(plan.n_shards):
        sl = plan.shard_slice(j)

        def vec(v):
            return None if v is None else v[sl]

        ops.append(dict(tabs=[t[j] for t in tables],
                        d_in=vec(d_in), d_out=vec(d_out), bias=vec(bias)))
    return ops


def _walk_fwd(plan: ShardPlan, ops, x2: torch.Tensor):
    """The forward over all shards: returns the per-shard output slabs and
    the residuals ``(x_res, step_ins, z_last)`` (per-shard lists; x_res is
    x2 itself under ``win_in``; None where not kept)."""
    S = plan.n_shards
    fdt = x2.dtype
    if plan.in_width is None:
        z = [x2[:, plan.shard_slice(j)].contiguous() for j in range(S)]
    elif plan.win_in:
        z = [x2] * S
    else:
        z = [_window_slab(x2, j * plan.n_local, plan.n_local, plan.in_width)
             for j in range(S)]
    x_res = x2 if plan.win_in else (list(z) if plan.saves_x_res else None)
    if plan.has_din and not plan.fold_din:
        z = [z[j] * ops[j]["d_in"].to(fdt) for j in range(S)]
    step_ins = []
    n_steps = len(plan.steps)
    for i, step in enumerate(plan.steps):
        first, last = i == 0, i == n_steps - 1
        step_ins.append(None if (first and plan.win_in) else list(z))
        if step[0] == "cross":
            k = step[2]
            zp = _exchange(z, k)
            z = [_cross_mix(
                z[j], zp[j], ops[j]["tabs"][i], j & k == 0,
                d_out=ops[j]["d_out"] if last and plan.fold_dout else None,
                bias=ops[j]["bias"] if last and plan.fold_bias else None)
                for j in range(S)]
        else:
            z = [_segment_fwd(
                z[j], ops[j]["tabs"][i], step[2], plan,
                d_in=ops[j]["d_in"] if first and plan.fold_din else None,
                d_out=ops[j]["d_out"] if last and plan.fold_dout else None,
                bias=ops[j]["bias"] if last and plan.fold_bias else None,
                col_base=j * plan.n_local if first and plan.win_in else None)
                for j in range(S)]
    z_last = list(z) if plan.saves_z_last else None
    if plan.has_dout and not plan.fold_dout:
        z = [z[j] * ops[j]["d_out"].to(fdt) for j in range(S)]
    if plan.has_bias and not plan.fold_bias:
        z = [z[j] + ops[j]["bias"].to(fdt) for j in range(S)]
    return z, (x_res, step_ins, z_last)


def _walk_bwd(plan: ShardPlan, ops, res, gys: List[torch.Tensor]):
    """The backward over all shards from the per-shard output cotangent
    slabs: returns per-shard ``(g_x slabs, g_tables (per step), g_din,
    g_dout, g_bias)``, the vector grads None where absent."""
    S = plan.n_shards
    x_res, step_ins, z_last = res
    g_din = g_dout = g_bias = None
    delta = gys
    if plan.has_bias and not plan.fold_bias:
        g_bias = [g.float().sum(0) for g in gys]
    if plan.has_dout and not plan.fold_dout:
        g_dout = [(gys[j].float() * z_last[j].float()).sum(0)
                  for j in range(S)]
        delta = [gys[j] * ops[j]["d_out"].to(gys[j].dtype)
                 for j in range(S)]
    n_steps = len(plan.steps)
    g_tabs: List[Optional[list]] = [None] * n_steps
    for i in range(n_steps - 1, -1, -1):
        step = plan.steps[i]
        first, last = i == 0, i == n_steps - 1
        if step[0] == "cross":
            delta, g_tabs[i], gd, gb = _cross_bwd(
                step_ins[i], delta, [o["tabs"][i] for o in ops], step[2],
                plan,
                d_out=([o["d_out"] for o in ops]
                       if last and plan.fold_dout else None),
                has_bias=last and plan.fold_bias)
            g_dout = gd if gd is not None else g_dout
            g_bias = gb if gb is not None else g_bias
            continue
        outs = []
        for j in range(S):
            z_in = x_res if (first and plan.win_in) else step_ins[i][j]
            outs.append(_segment_bwd(
                z_in, delta[j], ops[j]["tabs"][i],
                step[2], plan,
                d_in=ops[j]["d_in"] if first and plan.fold_din else None,
                d_out=ops[j]["d_out"] if last and plan.fold_dout else None,
                has_bias=last and plan.fold_bias,
                col_base=j * plan.n_local if first and plan.win_in
                else None))
        delta = [o[0] for o in outs]
        g_tabs[i] = [o[1] for o in outs]
        if first and plan.fold_din:
            g_din = [o[2] for o in outs]
        if last and plan.fold_dout:
            g_dout = [o[3] for o in outs]
        if last and plan.fold_bias:
            g_bias = [o[4] for o in outs]
    if plan.has_din and not plan.fold_din:
        g_din = [(delta[j].float() * x_res[j].float()).sum(0)
                 for j in range(S)]
        delta = [delta[j] * ops[j]["d_in"].to(delta[j].dtype)
                 for j in range(S)]
    return delta, g_tabs, g_din, g_dout, g_bias


class _ShardedCore(torch.autograd.Function):
    """The sharded operator: ``x2`` (rows, in_width or n) -> (rows,
    out_width or n), differentiable in x2, the step tables and the vector
    operands."""

    @staticmethod
    def forward(ctx, plan: ShardPlan, d_in, d_out, bias, x2, *tables):
        ops = _shard_operands(plan, tables, d_in, d_out, bias)
        z, (x_res, step_ins, z_last) = _walk_fwd(plan, ops, x2)
        y2 = torch.cat(z, dim=-1)
        if plan.out_width is not None:
            y2 = y2[:, :plan.out_width].contiguous()
        # residuals flattened for save_for_backward (so that a checkpoint
        # around the caller can drop and rebuild them)
        S = plan.n_shards
        saved = [x2 if plan.win_in else None]
        saved += x_res if isinstance(x_res, list) else [None] * S
        for ins in step_ins:
            saved += ins if ins is not None else [None] * S
        saved += z_last if z_last is not None else [None] * S
        ctx.plan = plan
        ctx.x_dtype = x2.dtype
        ctx.layout = (isinstance(x_res, list),
                      [ins is not None for ins in step_ins],
                      z_last is not None)
        ctx.save_for_backward(d_in, d_out, bias, *tables, *saved)
        return y2

    @staticmethod
    def backward(ctx, gy2):
        plan = ctx.plan
        S, n_steps = plan.n_shards, len(plan.steps)
        d_in, d_out, bias, *rest = ctx.saved_tensors
        tables, saved = rest[:n_steps], rest[n_steps:]
        x2_win, saved = saved[0], saved[1:]
        has_x_list, has_ins, has_z_last = ctx.layout
        x_res = x2_win if plan.win_in else (
            list(saved[:S]) if has_x_list else None)
        saved = saved[S:]
        step_ins = []
        for keep in has_ins:
            step_ins.append(list(saved[:S]) if keep else None)
            saved = saved[S:]
        z_last = list(saved[:S]) if has_z_last else None
        ops = _shard_operands(plan, tables, d_in, d_out, bias)
        gy2 = gy2.to(ctx.x_dtype)
        if plan.out_width is not None:
            gy2 = F.pad(gy2, (0, plan.n - plan.out_width))
        gys = [gy2[:, plan.shard_slice(j)].contiguous() for j in range(S)]
        delta, g_tabs, g_din, g_dout, g_bias = _walk_bwd(
            plan, ops, (x_res, step_ins, z_last), gys)
        g_x2 = torch.cat(delta, dim=-1)
        if plan.in_width is not None:
            g_x2 = g_x2[:, :plan.in_width]
        g_tables = [torch.stack(gs, dim=0).to(t.dtype)
                    for gs, t in zip(g_tabs, tables)]

        def vec(parts, like):
            return None if like is None else torch.cat(parts).to(like.dtype)

        return (None, vec(g_din, d_in), vec(g_dout, d_out), vec(g_bias, bias),
                g_x2, *g_tables)


def _device_of(dev: torch.device) -> torch.device:
    """``dev`` with its index: a bare ``cuda`` names the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def spm_apply_sharded(params, x: torch.Tensor, cfg, mesh: FeatureMesh, *,
                      in_width: Optional[int] = None,
                      out_width: Optional[int] = None) -> torch.Tensor:
    """The feature-sharded SPM forward, differentiable in x and the
    parameters: semantically ``core.spm.spm_apply`` on the same params and
    config.  The mesh's ``"model"`` axis must have ``cfg.n_shards`` shards,
    all on ``x``'s device (shards on distinct devices are a later slice).

    ``x`` is (..., in_width or n).  A rectangular input enters whole and
    the first local run reads each shard's window of it (K1's and K2's
    ``col_base`` mode; a local gather without the kernel path).  The
    output is assembled from the shards' slabs and cut to ``out_width``.
    """
    n = cfg.n
    if mesh.shape[AXIS] != cfg.n_shards:
        raise ValueError(
            f"mesh axis {AXIS!r} has size {mesh.shape[AXIS]}, operator has "
            f"n_shards={cfg.n_shards}")
    home = _device_of(x.device)
    if any(_device_of(d) != home for d in mesh.devices):
        raise ValueError(
            f"mesh shards on {[str(d) for d in mesh.devices]}, input on "
            f"{x.device}: every shard must be on the input's device")
    # rows shard over no mesh axis: a FeatureMesh has no data axis
    # (``parallel/sharding.data_axes``; ROADMAP.md §1: DP axes)
    if cfg.quant_acts or cfg.quant_coeffs:
        raise NotImplementedError("int8 tables on the sharded path are a "
                                  "later slice (ROADMAP.md §1: quant_cf)")
    in_width = None if in_width == n else in_width
    out_width = None if out_width == n else out_width
    steps = plan_steps(n, cfg.pairing.strides(), cfg.n_shards)
    n_local = n // cfg.n_shards
    in_w = in_width if in_width is not None else n
    if x.shape[-1] != in_w:
        raise ValueError(f"expected (..., {in_w}), got {tuple(x.shape)}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, in_w).contiguous()
    plan = ShardPlan(
        n=n, n_local=n_local, n_shards=cfg.n_shards, steps=steps,
        has_din=cfg.use_diag, has_dout=cfg.use_diag, has_bias=cfg.use_bias,
        use_kernel=resolve_shard_kernel(cfg, steps), in_width=in_width,
        out_width=out_width)
    coeffs = spm_mod.stage_coeffs(params, cfg)
    if plan.use_kernel:
        coeffs = coeffs.float()        # the kernels read f32 tables
    tables = _step_tables(coeffs, steps, cfg.n_shards, n_local)

    def vec(name, present):
        if not present:
            return None
        v = params[name]
        return v.float().contiguous() if plan.use_kernel else v

    y2 = _ShardedCore.apply(plan, vec("d_in", cfg.use_diag),
                            vec("d_out", cfg.use_diag),
                            vec("bias", cfg.use_bias), x2, *tables)
    return y2.reshape(*lead, y2.shape[-1])
