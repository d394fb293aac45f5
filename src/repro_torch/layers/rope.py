"""Rotary position embeddings, standard RoPE and multi-axis M-RoPE (port of
``repro/layers/rope.py``).

The rotation is half-split: the first half of head_dim rotates against the
second half, as the reference computes it.  The frequencies are the
reference's ``theta ** (-arange(half) / half)`` in f32, correctly rounded:
the power is taken in f64 on the host and rounded once, which gives the
reference's table bit for bit (``torch.pow`` in f32 misses it by an ulp at
some entries, an angle error that grows with the position).  They are
built once per (head_dim, theta, device), so a decode step copies nothing
to the card.

M-RoPE (Qwen2-VL) splits the half dimension into sections, each rotated
by its own (temporal, height, width) position id; when the three ids
coincide it is 1-D RoPE bit for bit.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["rope_freqs", "rope_angles", "mrope_angles", "apply_rope"]


@functools.lru_cache(maxsize=None)
def _freqs(head_dim: int, theta: float, device: str) -> torch.Tensor:
    half = head_dim // 2
    exps = -np.arange(half, dtype=np.float32) / np.float32(half)
    f = np.power(np.float64(np.float32(theta)), exps.astype(np.float64))
    return torch.from_numpy(f.astype(np.float32)).to(device)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    """The (head_dim // 2,) f32 frequencies ``theta ** (-i / half)``."""
    return _freqs(int(head_dim), float(theta), str(torch.device(device)))


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: positions (..., T) int -> (..., T, head_dim//2) f32."""
    ang = positions.float()[..., None] * rope_freqs(head_dim, theta,
                                                    positions.device)
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions: torch.Tensor, head_dim: int,
                 sections: Sequence[int], theta: float = 10000.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE tables: positions (3, ..., T) of (t, h, w) ids; ``sections``
    are half-dim section sizes summing to head_dim // 2 (e.g. (16, 24, 24)
    for head_dim 128).  Section k of the angles comes from axis k's ids."""
    half = head_dim // 2
    if sum(sections) != half or positions.shape[0] != len(sections):
        raise ValueError(f"sections {tuple(sections)} and ids of shape "
                         f"{tuple(positions.shape)} for head_dim {head_dim}")
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang_all = positions.float()[..., None] * freqs       # (3, ..., T, half)
    parts, off = [], 0
    for axis, sec in enumerate(sections):
        parts.append(ang_all[axis][..., off: off + sec])
        off += sec
    ang = torch.cat(parts, dim=-1)
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
