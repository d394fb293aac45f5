"""Plain-torch oracle for the SPM stage stack (port of
``repro/kernels/ref.py``).

    z_0 = x;   z_l = B_l z_{l-1};   return z_L

``coeffs`` is (L, n//2, 4) holding (a, b, c, d) per pair; ``strides`` holds
per-stage strides with ``n % (2*s) == 0``.  Computes in ``x.dtype``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["stage", "spm_stack_ref", "spm_full_ref"]


def stage(z: torch.Tensor, cf: torch.Tensor, s: int) -> torch.Tensor:
    """One stride-``s`` stage on the last axis.  z: (..., n); cf: (n//2, 4).
    Pair ``p = g*s + j`` mixes lanes ``g*2s + j`` and ``g*2s + j + s``."""
    n = z.shape[-1]
    lead = z.shape[:-1]
    g = n // (2 * s)
    zr = z.reshape(*lead, g, 2, s)
    x0, x1 = zr[..., 0, :], zr[..., 1, :]
    a, b, c, d = (cf[:, i].reshape(g, s) for i in range(4))
    y0 = a * x0 + b * x1
    y1 = c * x0 + d * x1
    return torch.stack([y0, y1], dim=-2).reshape(*lead, n)


def spm_stack_ref(x: torch.Tensor, coeffs: torch.Tensor,
                  strides: Tuple[int, ...]) -> torch.Tensor:
    """All stages of ``strides`` applied in order."""
    z = x
    for ell, s in enumerate(strides):
        z = stage(z, coeffs[ell].to(z.dtype), s)
    return z


def spm_full_ref(x: torch.Tensor, coeffs: torch.Tensor,
                 strides: Tuple[int, ...],
                 d_in: Optional[torch.Tensor] = None,
                 d_out: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The full operator ``y = D_out (B_L...B_1) D_in x + bias``."""
    z = x if d_in is None else x * d_in.to(x.dtype)
    z = spm_stack_ref(z, coeffs, strides)
    if d_out is not None:
        z = z * d_out.to(z.dtype)
    if bias is not None:
        z = z + bias.to(z.dtype)
    return z
