"""Public entries of the fused SPM operator (port of ``repro/kernels/ops.py``).

``spm_stack_fused`` plans the stride schedule into maximal tile-local runs
(``plan_runs``, copied from the reference as pure arithmetic) and launches
K1 once per run, with ``d_in`` folded into the first run and
``d_out``/``bias`` into the last.  Between two runs the activation is
stored in x's dtype, as the reference's run chain stores it.  It is a
``torch.autograd.Function``: the forward saves each run's input, and the
backward launches K2 once per run, in reverse, carrying the dead-tile chain
(``_fused_bwd`` of the reference).

``spm_block_fused`` launches K3 once for a whole norm -> SPM [-> act -> SPM
-> residual] block; its backward is one K4 launch from x and the row
statistics alone.

On CUDA tensors both backwards launch their kernels or raise; on CPU
tensors the wrappers run their plain versions, so the port's CPU path is
the reference's forced-kernel path.  Grads come back in each input's
dtype: g_x in x's, the rest f32 (as the parameters).

Tile caps come from Hopper's shared memory, not the TPU's VMEM: the default
cap ``MAX_TILE`` is the reference's 2048 (a 16-row f32 block of it is
128 KiB), and tiny-row (decode) calls widen it to the widest tile whose
``TINY_ROW_THRESHOLD`` f32 rows fit one block's shared memory.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.eligibility import (TINY_ROW_THRESHOLD,
                                          block_fusion_eligible,
                                          tiny_row_call)
from repro_torch.kernels import spm_stack as K

__all__ = ["MAX_TILE", "TINY_ROW_MAX_TILE", "plan_runs", "tile_cap_for_rows",
           "plan_runs_for_rows", "spm_stack_fused", "forward_runs",
           "backward_runs", "spm_block_fused"]

MAX_TILE = 2048
# 232,448 B / (8 rows x 4 B) = 7264 lanes: a decode block of all its rows
# fits on chip at any tile up to this width (6144 for the n=6144 FFN).
TINY_ROW_MAX_TILE = K.SMEM_BYTES // (TINY_ROW_THRESHOLD * 4)


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


@functools.lru_cache(maxsize=None)
def plan_runs(n: int, strides: Tuple[int, ...], max_tile: int = MAX_TILE
              ) -> Tuple[Tuple[Tuple[int, ...], int], ...]:
    """Split ``strides`` into runs of (strides, n_tile): every stride s of a
    run has ``n_tile % (2*s) == 0`` and ``n % n_tile == 0``.  Greedy: a run
    grows while the lcm of its pair spans stays within ``max_tile``; its
    tile is the largest multiple of that lcm dividing n, capped at
    ``max_tile``.  Identical arithmetic to the reference."""
    for s in strides:
        if n % (2 * s) != 0:
            raise ValueError(f"stride {s} invalid for n={n}")
    runs = []
    cur: list = []
    cur_lcm = 1

    def close():
        nonlocal cur, cur_lcm
        if not cur:
            return
        tile = cur_lcm
        k = 1
        while True:
            cand = cur_lcm * (k + 1)
            if cand > max_tile or n % cand != 0:
                break
            k += 1
            tile = cand
        runs.append((tuple(cur), tile))
        cur, cur_lcm = [], 1

    for s in strides:
        span = 2 * s
        new_lcm = _lcm(cur_lcm, span)
        if cur and new_lcm > max_tile:
            close()
            new_lcm = span
        cur.append(s)
        cur_lcm = new_lcm
    close()
    return tuple(runs)


def tile_cap_for_rows(n_rows: int) -> int:
    """Feature-tile cap for a call with ``n_rows`` flattened rows:
    ``MAX_TILE``, widened to ``TINY_ROW_MAX_TILE`` for tiny-row calls."""
    if tiny_row_call(n_rows):
        return max(MAX_TILE, TINY_ROW_MAX_TILE)
    return MAX_TILE


def plan_runs_for_rows(n: int, strides: Sequence[int], n_rows: int
                       ) -> Tuple[Tuple[Tuple[int, ...], int], ...]:
    """The run plan a call with ``n_rows`` rows executes: ``plan_runs``
    under ``tile_cap_for_rows``.  The executor and the launch-count check
    of ``chip_smoke.py`` both call it."""
    strides = tuple(int(s) for s in strides)
    return plan_runs(n, strides, tile_cap_for_rows(n_rows))


def _widths(n: int, in_width, out_width):
    in_width = None if in_width == n else in_width
    out_width = None if out_width == n else out_width
    for w, name in ((in_width, "in_width"), (out_width, "out_width")):
        if w is not None and not 0 < w <= n:
            raise ValueError(f"{name}={w} outside (0, {n}]")
    return in_width, out_width


class _StackFn(torch.autograd.Function):
    """The full operator over planned runs: K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, z, coeffs, d_in, d_out, bias, runs, in_width,
                out_width):
        z, saved = forward_runs(z, coeffs, runs, d_in, d_out, bias,
                                in_width, out_width)
        ctx.runs, ctx.in_width, ctx.out_width = runs, in_width, out_width
        ctx.has = (d_in is not None, d_out is not None, bias is not None)
        ctx.save_for_backward(coeffs, d_in, d_out, *saved)
        return z

    @staticmethod
    def backward(ctx, gy):
        coeffs, d_in, d_out, *saved = ctx.saved_tensors
        has_din, has_dout, has_bias = ctx.has
        outs = backward_runs(K.spm_stack_bwd_kernel_call, saved, coeffs,
                             gy.to(saved[0].dtype).contiguous(), ctx.runs,
                             d_in, d_out, has_bias, ctx.in_width,
                             ctx.out_width)
        first, last = list(outs[0][2:]), list(outs[-1][2:])
        g_din = first.pop(0) if has_din else None
        if len(outs) == 1:
            last = first
        g_dout = last.pop(0) if has_dout else None
        g_bias = last.pop(0) if has_bias else None
        delta = outs[0][0]
        if ctx.in_width is not None and delta.shape[-1] != ctx.in_width:
            delta = delta[:, :ctx.in_width]   # g_x came back widened
        return (delta, torch.cat([o[1] for o in outs], dim=0), g_din,
                g_dout, g_bias, None, None, None)


def forward_runs(z, coeffs, runs, d_in, d_out, bias,
                 in_width: Optional[int], out_width: Optional[int]
                 ) -> Tuple[torch.Tensor, list]:
    """A planned run chain: K1 once per run, ``d_in`` folded into the
    first and ``d_out``/``bias`` into the last; returns the output and each
    run's input, which ``backward_runs`` takes back."""
    saved, off = [], 0
    for r, (run_strides, n_tile) in enumerate(runs):
        last = r == len(runs) - 1
        saved.append(z)
        z = K.spm_stack_kernel_call(
            z, coeffs[off: off + len(run_strides)],
            d_in if r == 0 else None, d_out if last else None,
            bias if last else None, strides=run_strides, n_tile=n_tile,
            in_width=in_width if r == 0 else None,
            out_width=out_width if last else None)
        off += len(run_strides)
    return z, saved


def backward_runs(bwd, saved, coeffs, gy, runs, d_in, d_out,
                  has_bias: bool, in_width: Optional[int],
                  out_width: Optional[int]) -> list:
    """The backward of a planned run chain: ``bwd`` (K2's wrapper or its
    plain version) once per run, in reverse, each run's g_x the cotangent
    of the run before; returns each run's outputs in plan order.

    The dead-tile chain (the reference's ``_fused_bwd``): a run's backward
    visits only the tiles holding live cotangent and returns a g_x that is
    exactly zero from its first skipped column, so the run upstream prunes
    the same columns (``dead_from``), re-derived at its own tile width."""
    n = 2 * coeffs.shape[1]
    offs, off = [], 0
    for run_strides, _ in runs:
        offs.append(off)
        off += len(run_strides)
    outs = [None] * len(runs)
    delta, dead = gy, None
    for r in range(len(runs) - 1, -1, -1):
        run_strides, n_tile = runs[r]
        last = r == len(runs) - 1
        outs[r] = bwd(saved[r], coeffs[offs[r]: offs[r] + len(run_strides)],
                      delta, d_in if r == 0 else None,
                      d_out if last else None, strides=run_strides,
                      n_tile=n_tile, has_bias=last and has_bias,
                      in_width=in_width if r == 0 else None,
                      out_width=out_width if last else None,
                      dead_from=None if last else dead)
        live = out_width if last else dead
        if live is not None and -(-live // n_tile) * n_tile < n:
            dead = -(-live // n_tile) * n_tile
        else:
            dead = None
        delta = outs[r][0]
    return outs


def spm_stack_fused(x: torch.Tensor, coeffs: torch.Tensor,
                    strides: Sequence[int], *,
                    d_in: Optional[torch.Tensor] = None,
                    d_out: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    in_width: Optional[int] = None,
                    out_width: Optional[int] = None) -> torch.Tensor:
    """The fused SPM operator over the last axis of ``x`` (..., in_width or
    n) -> (..., out_width or n), one K1 launch per planned run;
    differentiable in x, coeffs and the diagonals and bias (one K2 launch
    per run)."""
    strides = tuple(int(s) for s in strides)
    n = 2 * coeffs.shape[1]
    in_width, out_width = _widths(n, in_width, out_width)
    expect = in_width if in_width is not None else n
    if x.shape[-1] != expect:
        raise ValueError(f"expected (..., {expect}), got {tuple(x.shape)}")
    lead = x.shape[:-1]
    z = x.reshape(-1, expect).contiguous()
    runs = plan_runs_for_rows(n, strides, z.shape[0])
    f32 = (lambda t: None if t is None else t.float().contiguous())
    z = _StackFn.apply(z, f32(coeffs), f32(d_in), f32(d_out), f32(bias),
                       runs, in_width, out_width)
    return z.reshape(*lead, z.shape[-1])


def spm_block_fused(x: torch.Tensor, *, coeffs1: torch.Tensor,
                    d_in1: torch.Tensor, d_out1: torch.Tensor,
                    strides1: Sequence[int],
                    bias1: Optional[torch.Tensor] = None,
                    gamma: Optional[torch.Tensor] = None,
                    coeffs2: Optional[torch.Tensor] = None,
                    d_in2: Optional[torch.Tensor] = None,
                    d_out2: Optional[torch.Tensor] = None,
                    bias2: Optional[torch.Tensor] = None,
                    strides2: Optional[Sequence[int]] = None,
                    activation: Optional[str] = None,
                    residual: bool = False,
                    in_width: Optional[int] = None,
                    mid_width: Optional[int] = None,
                    out_width: Optional[int] = None,
                    eps: float = 1e-6) -> torch.Tensor:
    """``y = [x +] stack2(act(stack1(rms_norm(x))))`` over the last axis in
    one K3 launch (backward: one K4 launch); every piece optional as in the
    reference (``gamma=None``
    skips the norm, ``strides2=None`` ends after stack 1).  Widths default
    as in the reference: ``in_width = x.shape[-1]``, ``out_width = n``,
    ``mid_width`` n with a second stack and ``out_width`` without.  Raises
    when the block is not ``block_fusion_eligible``."""
    strides1 = tuple(int(s) for s in strides1)
    strides2 = None if strides2 is None else tuple(int(s) for s in strides2)
    n = 2 * coeffs1.shape[1]
    if not block_fusion_eligible(n, strides1, strides2, activation):
        raise ValueError(f"block fusion ineligible: n={n}, "
                         f"strides1={strides1}, strides2={strides2}, "
                         f"activation={activation!r}")
    in_width = x.shape[-1] if in_width is None else in_width
    out_width = n if out_width is None else out_width
    if mid_width is None:
        mid_width = n if strides2 is not None else out_width
    if x.shape[-1] != in_width:
        raise ValueError(f"expected (..., {in_width}), got {tuple(x.shape)}")
    if gamma is not None and gamma.shape[-1] != n:
        # zero-fill the RMS scale to the operator width (dead lanes are 0)
        gamma = F.pad(gamma.float(), (0, n - gamma.shape[-1]))
    lead = x.shape[:-1]
    x2 = x.reshape(-1, in_width).contiguous()
    f32 = (lambda t: None if t is None else t.float().contiguous())
    statics = dict(strides1=strides1, strides2=strides2,
                   activation=activation, residual=residual,
                   in_width=in_width, mid_width=mid_width,
                   out_width=out_width)
    y = _BlockFn.apply(x2, f32(gamma), f32(coeffs1), f32(d_in1),
                       f32(d_out1), f32(bias1), f32(coeffs2), f32(d_in2),
                       f32(d_out2), f32(bias2), statics, eps)
    return y.reshape(*lead, out_width)


class _BlockFn(torch.autograd.Function):
    """The residual block: K3 forward, K4 backward.  Saves only x and the
    (rows, 1) row statistics beside the operands."""

    @staticmethod
    def forward(ctx, x2, gamma, cf1, din1, dout1, bias1, cf2, din2, dout2,
                bias2, statics, eps):
        y, rstd = K.spm_block_kernel_call(
            x2, cf1, din1, dout1, bias1, gamma, cf2, din2, dout2, bias2,
            eps=eps, **statics)
        ctx.statics = statics
        ctx.save_for_backward(x2, rstd, gamma, cf1, din1, dout1, bias1, cf2,
                              din2, dout2, bias2)
        return y

    @staticmethod
    def backward(ctx, gy):
        (x2, rstd, gamma, cf1, din1, dout1, bias1, cf2, din2, dout2,
         bias2) = ctx.saved_tensors
        out = list(K.spm_block_bwd_kernel_call(
            x2, gy.to(x2.dtype).contiguous(), cf1, din1, dout1, bias1,
            gamma, rstd, cf2, din2, dout2, bias2, **ctx.statics))
        gx = out.pop(0)
        g_gamma = out.pop(0) if gamma is not None else None
        g_cf1, g_din1, g_dout1 = out.pop(0), out.pop(0), out.pop(0)
        g_bias1 = out.pop(0) if bias1 is not None else None
        g_cf2 = g_din2 = g_dout2 = g_bias2 = None
        if cf2 is not None:
            g_cf2, g_din2, g_dout2 = out.pop(0), out.pop(0), out.pop(0)
            if bias2 is not None:
                g_bias2 = out.pop(0)
        return (gx, g_gamma, g_cf1, g_din1, g_dout1, g_bias1, g_cf2, g_din2,
                g_dout2, g_bias2, None, None)
