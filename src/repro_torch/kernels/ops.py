"""Public entries of the fused SPM operator (port of ``repro/kernels/ops.py``,
forward only).

``spm_stack_fused`` plans the stride schedule into maximal tile-local runs
(``plan_runs``, copied from the reference as pure arithmetic) and launches
K1 once per run, with ``d_in`` folded into the first run and
``d_out``/``bias`` into the last.  Between two runs the activation is
stored in x's dtype, as the reference's run chain stores it.
``spm_block_fused`` launches K3 once for a whole norm -> SPM [-> act -> SPM
-> residual] block.

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
           "plan_runs_for_rows", "spm_stack_fused", "spm_block_fused"]

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


def spm_stack_fused(x: torch.Tensor, coeffs: torch.Tensor,
                    strides: Sequence[int], *,
                    d_in: Optional[torch.Tensor] = None,
                    d_out: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    in_width: Optional[int] = None,
                    out_width: Optional[int] = None) -> torch.Tensor:
    """The fused SPM operator over the last axis of ``x`` (..., in_width or
    n) -> (..., out_width or n), one K1 launch per planned run."""
    strides = tuple(int(s) for s in strides)
    n = 2 * coeffs.shape[1]
    in_width, out_width = _widths(n, in_width, out_width)
    expect = in_width if in_width is not None else n
    if x.shape[-1] != expect:
        raise ValueError(f"expected (..., {expect}), got {tuple(x.shape)}")
    lead = x.shape[:-1]
    z = x.reshape(-1, expect).contiguous()
    runs = plan_runs_for_rows(n, strides, z.shape[0])
    coeffs = coeffs.float().contiguous()
    off = 0
    for r, (run_strides, n_tile) in enumerate(runs):
        last = r == len(runs) - 1
        z = K.spm_stack_kernel_call(
            z, coeffs[off: off + len(run_strides)],
            d_in if r == 0 else None,
            d_out if last else None,
            bias if last else None,
            strides=run_strides, n_tile=n_tile,
            in_width=in_width if r == 0 else None,
            out_width=out_width if last else None)
        off += len(run_strides)
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
    one K3 launch; every piece optional as in the reference (``gamma=None``
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
    y, _ = K.spm_block_kernel_call(
        x2, f32(coeffs1), f32(d_in1), f32(d_out1), f32(bias1), f32(gamma),
        f32(coeffs2), f32(d_in2), f32(d_out2), f32(bias2),
        strides1=strides1, strides2=strides2, activation=activation,
        residual=residual, in_width=in_width, mid_width=mid_width,
        out_width=out_width, eps=eps)
    return y.reshape(*lead, out_width)
