"""Rotary position embeddings (port of ``repro/layers/rope.py``; M-RoPE
waits for a later slice).

The rotation is half-split: the first half of head_dim rotates against the
second half, as the reference computes it.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["rope_angles", "apply_rope"]


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: positions (..., T) int -> (..., T, head_dim//2) f32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., T, H, head_dim); cos/sin: (..., T, head_dim//2) broadcast
    over heads.  Computes in f32, returns x's dtype."""
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
