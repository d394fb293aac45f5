"""Block-scale int8 quantization (port of ``repro/kernels/quant.py``).

Activations quantize per (row block, feature tile): one f32 scale for each
``(scale_rows, n_tile)`` block, the granularity the int8 modes of K1 and
K2 read and write.  Coefficient tables quantize per stage.  The scale is
``absmax / 127 + 1e-12`` in f32 (always finite and positive), the code
``clip(round(v / scale), -127, 127)`` with round half to even and true
IEEE division, and dequantization one rounded multiply ``q * scale``.  A
NaN or Inf in a block makes its scale NaN or Inf (the absmax keeps it) and
its codes 0 where the quotient is NaN, so the block dequantizes to NaN.
These run as plain torch around the kernels, as the reference runs them in
XLA outside its kernels.

Every division here divides by a tensor on the operand's device, never by
a Python number: PyTorch's CUDA division by a host scalar multiplies by
its reciprocal, which rounds differently from the reference.

``scale_block_rows`` fixes which rows share a scale.  It is the
reference's row-block arithmetic (``pick_block_rows_for_plan`` over
``pick_block_rows`` and ``vmem_bytes``, 12 MiB), copied as the int8 mode's
contract so the port's codes equal the reference's at every shape; it
budgets nothing on this card.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["quantize_blocks", "dequantize_blocks", "quantize_coeffs",
           "dequantize_coeffs", "block_scale_bound", "scale_block_rows"]

_EPS = 1e-12


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    return absmax / torch.full_like(absmax, 127.0) + _EPS


def _code(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # a NaN quotient (a block holding NaN or Inf, whose scale is then NaN
    # or Inf) codes as 0, as the reference's cast gives; the block's scale
    # keeps the non-finite value, so it dequantizes to NaN
    q = torch.clamp(torch.round(v / scale), -127, 127)
    return torch.nan_to_num(q, nan=0.0).to(torch.int8)


def quantize_blocks(x2: torch.Tensor, block_rows: int, n_tile: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., B, W) -> ``(q int8 (..., B, W), scales f32 (..., B //
    block_rows, ceil(W / n_tile)))``.  B must be a multiple of
    ``block_rows``; a trailing partial tile is scaled over its real columns
    only.  Leading axes are independent operands (an MoE's experts, the
    reference's ``jax.vmap``): each one's scale grid starts at its own row
    0."""
    *lead, B, W = x2.shape
    if B % block_rows:
        raise ValueError(f"rows {B} not a multiple of {block_rows}")
    nb, ncol = B // block_rows, -(-W // n_tile)
    xf = F.pad(x2.float(), (0, ncol * n_tile - W))
    xr = xf.reshape(*lead, nb, block_rows, ncol, n_tile)
    scales = _scale(xr.abs().amax(dim=(-3, -1)))
    q = _code(xr, scales[..., :, None, :, None])
    return (q.reshape(*lead, B, ncol * n_tile)[..., :W].contiguous(),
            scales)


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor,
                      block_rows: int, n_tile: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The inverse of ``quantize_blocks`` up to its rounding: ``q * scale``
    in f32, then cast to ``dtype``."""
    *lead, B, W = q.shape
    nb, ncol = B // block_rows, -(-W // n_tile)
    qf = F.pad(q.float(), (0, ncol * n_tile - W))
    xr = (qf.reshape(*lead, nb, block_rows, ncol, n_tile)
          * scales[..., :, None, :, None])
    return xr.reshape(*lead, B, ncol * n_tile)[..., :W].to(dtype)


def quantize_coeffs(coeffs: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., L, n_pairs, 4) -> ``(q int8, scales f32 (..., L))``, one scale
    a stage (of each expert, under leading axes)."""
    cf = coeffs.float()
    scales = _scale(cf.abs().amax(dim=(-2, -1)))
    return _code(cf, scales[..., None, None]).contiguous(), scales


def dequantize_coeffs(q: torch.Tensor, scales: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` per stage: the multiply the kernels do on load."""
    return (q.float() * scales[..., None, None]).to(dtype)


def block_scale_bound(x2: torch.Tensor, block_rows: int,
                      n_tile: int) -> float:
    """The largest block scale of ``quantize_blocks`` on this input: the
    worst per-element step, which error bounds are derived from."""
    return float(quantize_blocks(x2, block_rows, n_tile)[1].max())


def _vmem_bytes(block_rows: int, n_tile: int, n_stages: int,
                dtype_bytes: int) -> int:
    act = (n_stages + 2) * block_rows * n_tile * 4
    io = 3 * block_rows * n_tile * dtype_bytes
    cf = 2 * n_stages * (n_tile // 2) * 4 * 4
    return act + io + cf


def _pick_rows(n_tile: int, n_stages: int, dtype_bytes: int,
               budget: int = 12 * 2 ** 20) -> int:
    bb = 8
    while bb < 1024 and _vmem_bytes(bb * 2, n_tile, n_stages,
                                    dtype_bytes) <= budget:
        bb *= 2
    return bb


def scale_block_rows(runs, n_rows: int, dtype_bytes: int) -> int:
    """Rows that share one activation scale for a call of ``n_rows`` rows
    over the run plan ``runs`` (``((strides, n_tile), ...)``), with
    ``dtype_bytes`` the activation dtype's size.

    This defines which rows share a scale, not a memory budget: it is the
    reference's ``pick_block_rows_for_plan`` arithmetic (the power of two
    from 8 to 1024 whose modelled TPU working set fits 12 MiB for every
    run, capped at the next power of two of ``n_rows``), kept as the int8
    mode's contract so that the port's int8 codes equal the reference's."""
    br = min(_pick_rows(n_tile, len(run_strides), dtype_bytes)
             for run_strides, n_tile in runs)
    return min(br, max(8, 1 << (n_rows - 1).bit_length()))
