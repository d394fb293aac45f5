"""Public entries of the fused SPM operator (port of ``repro/kernels/ops.py``).

``spm_stack_fused`` plans the stride schedule into maximal tile-local runs
(``plan_runs``, copied from the reference as pure arithmetic) and launches
K1 once per run, with ``d_in`` folded into the first run and
``d_out``/``bias`` into the last.  Between two runs the activation is
stored in x's dtype, as the reference's run chain stores it.  It is a
``torch.autograd.Function``: the forward saves each run's input, and the
backward launches K2 once per run, in reverse, carrying the dead-tile chain
(``_fused_bwd`` of the reference).

With ``quant_acts`` / ``quant_coeffs`` the chain runs K1's and K2's int8
modes as the reference's quantized ``_fused_core`` does: int8 activations
between quantize-at-entry and dequantize-at-exit (plans whose runs share
one tile only), int8 coefficient tables with per-stage scales, f32
compute.  ``spm_stack_fused_q8`` is the int8-in, int8-out forward.

An (E, L, n/2, 4) table with x (E, ..., d) is the expert mode (the
reference's ``jax.vmap`` of the operator over the MoE expert axis): the
plan is that of one expert's rows, and each run is ONE K1 launch for all E
experts forward and one K2 launch backward (their expert mode), never a
loop over the experts.  The int8 modes are per expert there, as vmap makes
the reference's: rows padded and scale blocks counted from each expert's
row 0 (``scale_block_rows`` of one expert's rows), one table scale per
expert and stage, eligibility decided on one expert's plan.

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
                                          quant_acts_eligible, tiny_row_call)
from repro_torch.kernels import quant as Q
from repro_torch.kernels import spm_stack as K
from repro_torch.parallel.ctx import (grad_placed_as, placed_as,
                                      placements_of)

__all__ = ["MAX_TILE", "TINY_ROW_MAX_TILE", "plan_runs", "tile_cap_for_rows",
           "plan_runs_for_rows", "spm_stack_fused", "spm_stack_fused_q8",
           "forward_runs", "backward_runs", "spm_block_fused"]

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
    """The full operator over planned runs: K1 forward, K2 backward.

    With ``quant`` = ``(scale_rows, acts, coeffs)`` it is the reference's
    quantized ``_fused_core``.  ``coeffs``: the f32 table is quantized per
    stage here and again, deterministically, in the backward, whose
    coefficient grads (of the dequantized table) pass straight through to
    the f32 table.  ``acts``: rows are zero-padded to a multiple of
    ``scale_rows``, x is quantized once at entry, the runs chain int8 codes
    and scales, and the output is dequantized at exit into x's dtype; only
    the int8 run inputs and their scales are saved, and the entry
    quantization passes the cotangent straight through."""

    @staticmethod
    def forward(ctx, x2, coeffs, d_in, d_out, bias, runs, in_width,
                out_width, quant):
        scale_rows, q_acts, q_coeffs = quant or (None, False, False)
        kcf, scf = Q.quantize_coeffs(coeffs) if q_coeffs else (coeffs, None)
        rows = x2.shape[-2]
        z = x2
        if q_acts:
            z = Q.quantize_blocks(_pad_rows(x2, scale_rows), scale_rows,
                                  runs[0][1])
        y, saved = forward_runs(z, kcf, runs, d_in, d_out, bias, in_width,
                                out_width, coeff_scale=scf,
                                scale_rows=scale_rows)
        if q_acts:
            y = Q.dequantize_blocks(*y, scale_rows, runs[-1][1],
                                    dtype=x2.dtype)[..., :rows, :]
            saved = [t for pair in saved for t in pair]
        ctx.runs, ctx.in_width, ctx.out_width = runs, in_width, out_width
        ctx.quant, ctx.rows, ctx.x_dtype = quant, rows, x2.dtype
        ctx.has = (d_in is not None, d_out is not None, bias is not None)
        ctx.y_placements = placements_of(y)
        ctx.save_for_backward(coeffs, d_in, d_out, *saved)
        return y

    @staticmethod
    def backward(ctx, gy):
        coeffs, d_in, d_out, *saved = ctx.saved_tensors
        has_din, has_dout, has_bias = ctx.has
        scale_rows, q_acts, q_coeffs = ctx.quant or (None, False, False)
        kcf, scf = Q.quantize_coeffs(coeffs) if q_coeffs else (coeffs, None)
        # gy itself unless a DTensor (a dry-run's mesh): then laid out as y
        gy = placed_as(gy, ctx.y_placements).to(ctx.x_dtype).contiguous()
        if q_acts:
            gy = _pad_rows(gy, scale_rows)
            saved = list(zip(saved[0::2], saved[1::2]))
        outs = backward_runs(K.spm_stack_bwd_kernel_call, saved, kcf, gy,
                             ctx.runs, d_in, d_out, has_bias, ctx.in_width,
                             ctx.out_width, coeff_scale=scf,
                             scale_rows=scale_rows)
        first, last = list(outs[0][2:]), list(outs[-1][2:])
        g_din = first.pop(0) if has_din else None
        if len(outs) == 1:
            last = first
        g_dout = last.pop(0) if has_dout else None
        g_bias = last.pop(0) if has_bias else None
        delta = outs[0][0]
        if q_acts:
            delta = delta[..., :ctx.rows, :]  # the rows padded for scales
        if ctx.in_width is not None and delta.shape[-1] != ctx.in_width:
            delta = delta[..., :ctx.in_width]   # g_x came back widened
        return (delta, torch.cat([o[1] for o in outs], dim=-3), g_din,
                g_dout, g_bias, None, None, None, None)


def _pad_rows(x2: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Rows (axis -2: each expert's own) zero-padded to a multiple of
    ``block_rows``."""
    pad = -x2.shape[-2] % block_rows
    return F.pad(x2, (0, 0, 0, pad)) if pad else x2


def _stages(coeffs: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Stages [lo, hi) of an (L, n/2, 4) or expert (E, L, n/2, 4) table
    (a view)."""
    return coeffs[..., lo:hi, :, :]


def _stage_scales(coeff_scale: Optional[torch.Tensor], lo: int,
                  hi: int) -> Optional[torch.Tensor]:
    """Stages [lo, hi) of (L,) or expert (E, L) table scales, contiguous
    (the kernels read an expert's scales L apart)."""
    return None if coeff_scale is None \
        else coeff_scale[..., lo:hi].contiguous()


def forward_runs(z, coeffs, runs, d_in, d_out, bias,
                 in_width: Optional[int], out_width: Optional[int], *,
                 coeff_scale: Optional[torch.Tensor] = None,
                 scale_rows: Optional[int] = None):
    """A planned run chain: K1 once per run, ``d_in`` folded into the
    first and ``d_out``/``bias`` into the last; returns the output and each
    run's input, which ``backward_runs`` takes back.  ``coeff_scale`` (L,)
    marks an int8 table.  With ``z`` a ``(q int8, scales)`` pair every run
    reads and writes int8 (``scale_rows`` rows a scale), and the output and
    each saved input are such pairs."""
    saved, off = [], 0
    for r, (run_strides, n_tile) in enumerate(runs):
        last = r == len(runs) - 1
        nL = len(run_strides)
        saved.append(z)
        q8 = isinstance(z, tuple)
        x, x_scale = z if q8 else (z, None)
        z = K.spm_stack_kernel_call(
            x, _stages(coeffs, off, off + nL),
            d_in if r == 0 else None, d_out if last else None,
            bias if last else None, x_scale,
            _stage_scales(coeff_scale, off, off + nL),
            strides=run_strides, n_tile=n_tile,
            in_width=in_width if r == 0 else None,
            out_width=out_width if last else None, quant_out=q8,
            scale_rows=scale_rows)
        off += nL
    return z, saved


def backward_runs(bwd, saved, coeffs, gy, runs, d_in, d_out,
                  has_bias: bool, in_width: Optional[int],
                  out_width: Optional[int], *,
                  coeff_scale: Optional[torch.Tensor] = None,
                  scale_rows: Optional[int] = None) -> list:
    """The backward of a planned run chain: ``bwd`` (K2's wrapper or its
    plain version) once per run, in reverse, each run's g_x the cotangent
    of the run before; returns each run's outputs in plan order.  A saved
    input may be a ``(q int8, scales)`` pair (``forward_runs``).

    The dead-tile chain (the reference's ``_fused_bwd``): a run's backward
    visits only the tiles holding live cotangent and returns a g_x that is
    exactly zero from its first skipped column, so the run upstream prunes
    the same columns (``dead_from``), re-derived at its own tile width."""
    n = 2 * coeffs.shape[-2]
    offs, off = [], 0
    for run_strides, _ in runs:
        offs.append(off)
        off += len(run_strides)
    outs = [None] * len(runs)
    delta, dead = gy, None
    for r in range(len(runs) - 1, -1, -1):
        run_strides, n_tile = runs[r]
        last = r == len(runs) - 1
        lo, hi = offs[r], offs[r] + len(run_strides)
        x, x_scale = saved[r] if isinstance(saved[r], tuple) \
            else (saved[r], None)
        outs[r] = bwd(x, _stages(coeffs, lo, hi), delta,
                      d_in if r == 0 else None,
                      d_out if last else None, x_scale,
                      _stage_scales(coeff_scale, lo, hi),
                      strides=run_strides, n_tile=n_tile,
                      has_bias=last and has_bias,
                      in_width=in_width if r == 0 else None,
                      out_width=out_width if last else None,
                      dead_from=None if last else dead,
                      scale_rows=scale_rows)
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
                    out_width: Optional[int] = None,
                    quant_acts: bool = False,
                    quant_coeffs: bool = False) -> torch.Tensor:
    """The fused SPM operator over the last axis of ``x`` (..., in_width or
    n) -> (..., out_width or n), one K1 launch per planned run;
    differentiable in x, coeffs and the diagonals and bias (one K2 launch
    per run).

    ``quant_acts`` moves the run chain's activations as int8 with one
    scale per (``scale_block_rows``, tile) block; a plan whose runs do not
    share one tile (``quant_acts_eligible``) keeps f32/bf16 activation
    I/O, as the reference does.  ``quant_coeffs`` moves the table as int8
    with one scale a stage.  Compute stays f32 in both.

    An (E, L, n/2, 4) table with (E, n) vectors and x (E, ..., in_width
    or n) is the expert mode: the plan is that of one expert's rows, and
    each run one expert-mode launch for all experts; the int8 modes are
    per expert (scale blocks of one expert's rows, (E, L) table
    scales)."""
    strides = tuple(int(s) for s in strides)
    n = 2 * coeffs.shape[-2]
    in_width, out_width = _widths(n, in_width, out_width)
    expect = in_width if in_width is not None else n
    if x.shape[-1] != expect:
        raise ValueError(f"expected (..., {expect}), got {tuple(x.shape)}")
    lead = x.shape[:-1]
    if coeffs.dim() == 4:
        if x.dim() < 2 or x.shape[0] != coeffs.shape[0]:
            raise ValueError(f"expected x ({coeffs.shape[0]}, ..., "
                             f"{expect}), got {tuple(x.shape)}")
        z = x.reshape(x.shape[0], -1, expect).contiguous()
    else:
        z = x.reshape(-1, expect).contiguous()
    runs = plan_runs_for_rows(n, strides, z.shape[-2])
    quant = None
    q_acts = bool(quant_acts) and quant_acts_eligible(runs)
    if q_acts or quant_coeffs:
        quant = (Q.scale_block_rows(runs, z.shape[-2], x.element_size())
                 if q_acts else None, q_acts, bool(quant_coeffs))
    f32 = (lambda t: None if t is None else t.float().contiguous())
    z = _StackFn.apply(z, f32(coeffs), f32(d_in), f32(d_out), f32(bias),
                       runs, in_width, out_width, quant)
    # the grad laid out as the output before its reshape's grad (DTensors)
    return grad_placed_as(z.reshape(*lead, z.shape[-1]))


def spm_stack_fused_q8(qx: torch.Tensor, x_scale: torch.Tensor,
                       coeffs: torch.Tensor, strides: Sequence[int], *,
                       d_in: Optional[torch.Tensor] = None,
                       d_out: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None,
                       in_width: Optional[int] = None,
                       out_width: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8 in, int8 out, forward only (the reference's inference entry).

    ``qx`` (B, in_width or n) int8 and ``x_scale`` its (B // scale_rows,
    tiles) f32 scales from ``quant.quantize_blocks``; ``scale_rows`` is
    read off their shapes.  Every run reads and writes int8 and reads an
    int8 table; returns ``(qy int8 (B, out_width or n), y_scale)`` without
    dequantizing.  Raises when the plan's runs do not share one tile."""
    strides = tuple(int(s) for s in strides)
    n = 2 * coeffs.shape[1]
    in_width, out_width = _widths(n, in_width, out_width)
    if qx.dtype != torch.int8 or qx.dim() != 2:
        raise TypeError(f"qx must be 2-D int8, got {qx.dtype}")
    B = qx.shape[0]
    if x_scale.shape[0] == 0 or B % x_scale.shape[0]:
        raise ValueError(f"rows {B} not a multiple of scale rows "
                         f"{x_scale.shape[0]}")
    runs = plan_runs_for_rows(n, strides, B)
    if not quant_acts_eligible(runs):
        raise ValueError(f"run plan {runs} is not uniform-tile; int8 "
                         "activation I/O cannot chain across its runs")
    f32 = (lambda t: None if t is None else t.float().contiguous())
    cf, scf = Q.quantize_coeffs(coeffs)
    with torch.no_grad():
        y, _ = forward_runs((qx.contiguous(), x_scale.float().contiguous()),
                            cf, runs, f32(d_in), f32(d_out), f32(bias),
                            in_width, out_width, coeff_scale=scf,
                            scale_rows=B // x_scale.shape[0])
    return y


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
    return grad_placed_as(y.reshape(*lead, out_width))


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
        ctx.y_placements = placements_of(y)
        ctx.save_for_backward(x2, rstd, gamma, cf1, din1, dout1, bias1, cf2,
                              din2, dout2, bias2)
        return y

    @staticmethod
    def backward(ctx, gy):
        (x2, rstd, gamma, cf1, din1, dout1, bias1, cf2, din2, dout2,
         bias2) = ctx.saved_tensors
        gy = placed_as(gy, ctx.y_placements)    # gy itself on a tensor
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
