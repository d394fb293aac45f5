"""Plain-torch oracle for the SPM stage stack (port of
``repro/kernels/ref.py``).

    z_0 = x;   z_l = B_l z_{l-1};   return z_L

``coeffs`` is (L, n//2, 4) holding (a, b, c, d) per pair; ``strides`` holds
per-stage strides with ``n % (2*s) == 0``.  Computes in ``x.dtype``.  A
batch of tables (E, L, n//2, 4) (an MoE's experts) takes x (E, ..., n),
table e for x[e].

The backward is closed form (paper eqs. 12-14): ``stage_vjp`` for one
stage, ``walk_back`` for a stack from its saved stage inputs, and
``spm_stack_grads_ref`` for the whole stack.  The plain versions of K2 and
K4 and the composition path's custom backward all walk through them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

__all__ = ["stage", "stage_vjp", "stages_collect", "walk_back",
           "spm_stack_ref", "spm_stack_grads_ref", "spm_full_ref"]


def _pairs(cf: torch.Tensor, g: int, s: int, z_dim: int):
    """A stage table's (a, b, c, d) as (g, s) planes against the (..., g, s)
    halves of a z of ``z_dim`` axes; a batch of tables (E, n//2, 4) as (E,
    1, ..., g, s)."""
    planes = cf.reshape(*cf.shape[:-2], g, s, 4).unbind(-1)
    if cf.dim() == 2:
        return planes
    unit = (1,) * (z_dim + 1 - cf.dim())
    return tuple(t.reshape(*cf.shape[:-2], *unit, g, s) for t in planes)


def stage(z: torch.Tensor, cf: torch.Tensor, s: int) -> torch.Tensor:
    """One stride-``s`` stage on the last axis.  z: (..., n); cf: (n//2, 4)
    (or a batch (E, n//2, 4) for z (E, ..., n)).  Pair ``p = g*s + j``
    mixes lanes ``g*2s + j`` and ``g*2s + j + s``."""
    n = z.shape[-1]
    lead = z.shape[:-1]
    g = n // (2 * s)
    x0, x1 = z.reshape(*lead, g, 2, s).unbind(-2)
    a, b, c, d = _pairs(cf, g, s, z.dim())
    y0 = a * x0 + b * x1
    y1 = c * x0 + d * x1
    return torch.stack([y0, y1], dim=-2).reshape(*lead, n)


def stage_vjp(z: torch.Tensor, delta: torch.Tensor, cf: torch.Tensor,
              s: int, col_sum: Optional[Callable] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of one stride-``s`` stage from its input ``z`` and the
    cotangent ``delta`` of its output: ``(B^T delta, g_cf (n//2, 4))``.
    ``col_sum`` reduces each pair-grad term over the leading axes (default:
    their sum); with a batch of tables it keeps the batch axis, (E, g, s),
    and g_cf is (E, n//2, 4)."""
    n = z.shape[-1]
    lead = z.shape[:-1]
    if col_sum is None:
        bdims = tuple(range(len(lead)))
        col_sum = (lambda t: t.sum(dim=bdims)) if bdims else (lambda t: t)
    g = n // (2 * s)
    x0, x1 = z.reshape(*lead, g, 2, s).unbind(-2)
    d0, d1 = delta.reshape(*lead, g, 2, s).unbind(-2)
    a, b, c, d = _pairs(cf, g, s, z.dim())
    batch = cf.shape[:-2]
    g_cf = torch.stack([col_sum(d0 * x0).reshape(*batch, -1),
                        col_sum(d0 * x1).reshape(*batch, -1),
                        col_sum(d1 * x0).reshape(*batch, -1),
                        col_sum(d1 * x1).reshape(*batch, -1)], dim=-1)
    g_in = torch.stack([a * d0 + c * d1, b * d0 + d * d1],
                       dim=-2).reshape(*lead, n)
    return g_in, g_cf


def stages_collect(z: torch.Tensor, coeffs: torch.Tensor,
                   strides: Tuple[int, ...]
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """All stages applied in order: ``(z_L, [z_0, ..., z_{L-1}])``."""
    zs = []
    for ell, s in enumerate(strides):
        zs.append(z)
        z = stage(z, coeffs[..., ell, :, :], s)
    return z, zs


def walk_back(zs: Sequence[torch.Tensor], delta: torch.Tensor,
              coeffs: torch.Tensor, strides: Tuple[int, ...],
              col_sum: Optional[Callable] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reverse walk of a stack from its stage inputs ``zs``:
    ``(delta_0, g_coeffs ([E,] L, n//2, 4))``."""
    parts = []
    for ell in range(len(strides) - 1, -1, -1):
        delta, g_cf = stage_vjp(zs[ell], delta, coeffs[..., ell, :, :],
                                strides[ell], col_sum)
        parts.append(g_cf)
    return delta, torch.stack(parts[::-1], dim=-3)


def spm_stack_ref(x: torch.Tensor, coeffs: torch.Tensor,
                  strides: Tuple[int, ...]) -> torch.Tensor:
    """All stages of ``strides`` applied in order."""
    z = x
    for ell, s in enumerate(strides):
        z = stage(z, coeffs[..., ell, :, :].to(z.dtype), s)
    return z


def spm_stack_grads_ref(x: torch.Tensor, coeffs: torch.Tensor,
                        strides: Tuple[int, ...], gy: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stack's VJP in closed form: ``(g_x, g_coeffs)``, the parameter
    grads summed over every leading axis."""
    _, zs = stages_collect(x, coeffs.to(x.dtype), strides)
    return walk_back(zs, gy, coeffs.to(gy.dtype), strides)


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
