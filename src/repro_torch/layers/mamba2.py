"""Mamba2 / SSD (state-space duality) mixer, chunked-scan formulation (port
of ``repro/layers/mamba2.py``).

Training runs the SSD algorithm of arXiv:2405.21060: the sequence is split
into chunks of Q; within a chunk the output is the quadratic form masked by
the cumulative decay L, across chunks a sequential loop carries the (H, P,
N) state.  Decode is the O(1) recurrence ``h <- a h + dt B x`` with a conv
cache and an SSM cache, both f32 whatever the KV cache's dtype, updated in
place (as the port's KV caches are).

The in and out projections go through the linear factory (SPM: K1 runs,
K2 backward).  The scan itself is XLA einsums in the reference, no Pallas
kernel, so plain torch is its port, in f32 as there.  The reference's
three-operand einsums are contracted pairwise here, in an order that never
builds a (b, c, Q, Q, H, P) intermediate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.linear import LinearConfig, init_linear, linear_apply
from repro_torch.layers.norms import init_rms_norm, rms_norm
from repro_torch.params import Params

__all__ = ["Mamba2Config", "init_mamba2", "mamba2_apply", "init_ssm_cache"]


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    """SSD geometry and the SPM knobs its projections inherit."""

    d_model: int
    d_state: int = 64
    d_head: int = 64               # P
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128
    linear_impl: str = "dense"
    spm_stages: Optional[int] = None
    spm_backward: str = "autodiff"
    spm_use_kernel: Optional[bool] = None
    spm_schedule: str = "butterfly"
    spm_n_shards: int = 1
    spm_overlap: Optional[bool] = None
    spm_quant_acts: bool = False
    spm_quant_coeffs: bool = False
    param_dtype: Any = torch.float32

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.d_head

    @property
    def d_in_proj(self) -> int:
        """[z, x, B, C, dt] (one SSM group)."""
        return 2 * self.d_inner + 2 * self.d_state + self.n_heads

    def _lin(self, d_in: int, d_out: int) -> LinearConfig:
        return LinearConfig(
            d_in=d_in, d_out=d_out, impl=self.linear_impl, use_bias=False,
            n_stages=self.spm_stages, backward=self.spm_backward,
            use_kernel=self.spm_use_kernel, schedule=self.spm_schedule,
            n_shards=self.spm_n_shards, overlap=self.spm_overlap,
            quant_acts=self.spm_quant_acts,
            quant_coeffs=self.spm_quant_coeffs,
            param_dtype=self.param_dtype)

    @property
    def in_proj(self) -> LinearConfig:
        """d_model -> d_in_proj."""
        return self._lin(self.d_model, self.d_in_proj)

    @property
    def out_proj(self) -> LinearConfig:
        """d_inner -> d_model."""
        return self._lin(self.d_inner, self.d_model)


def init_mamba2(cfg: Mamba2Config, generator: torch.Generator,
                device: torch.device) -> Params:
    """The reference's leaves: the projections, the depthwise conv,
    ``A_log`` = log(linspace(1, 16, H)), ``D`` = 1, ``dt_bias`` the
    softplus inverse of a log-uniform dt in [0.001, 0.1], the gated norm."""
    H = cfg.n_heads
    conv_dim = cfg.d_inner + 2 * cfg.d_state
    dt_ = cfg.param_dtype
    kw = dict(generator=generator, device=device, dtype=dt_)
    p = {"in_proj": init_linear(cfg.in_proj, generator, device),
         "out_proj": init_linear(cfg.out_proj, generator, device),
         "conv_w": 0.1 * torch.randn(cfg.d_conv, conv_dim, **kw)}
    lo, hi = math.log(0.001), math.log(0.1)
    dt = torch.exp(torch.rand(H, **kw) * (hi - lo) + lo)
    p.update({
        "conv_b": torch.zeros(conv_dim, dtype=dt_, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=dt_,
                                          device=device)),
        "D": torch.ones(H, dtype=dt_, device=device),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm": init_rms_norm(cfg.d_inner, device, dt_)})
    return Params(p)


def init_ssm_cache(batch: int, cfg: Mamba2Config, device,
                   dtype: torch.dtype = torch.float32) -> dict:
    """``{"ssm": (B, H, P, N), "conv": (B, d_conv - 1, conv_dim)}`` zeros."""
    conv_dim = cfg.d_inner + 2 * cfg.d_state
    return {"ssm": torch.zeros(batch, cfg.n_heads, cfg.d_head, cfg.d_state,
                               dtype=dtype, device=device),
            "conv": torch.zeros(batch, cfg.d_conv - 1, conv_dim,
                                dtype=dtype, device=device)}


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) -> (..., Q, Q): ``out[i, j] = sum_{k=j+1..i} a[k]`` on
    and below the diagonal, -inf above it (masked before any ``exp``, so
    the upper triangle's overflowing differences never reach a grad)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def _ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """The SSD scan.  x (b, T, H, P); dt (b, T, H); A (H,) (``A_log``); B, C
    (b, T, N); D (H,).  Returns y (b, T, H, P) and the final state (b, H, P,
    N).  Q = min(chunk, T), lowered until it divides T (a prime T gives
    Q = 1)."""
    b, T, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, T)
    while T % Q:
        Q -= 1
    nc = T // Q

    xd = x * dt[..., None]                     # fold dt into the inputs
    a = dt * (-torch.exp(A))                   # log-decay a step (b, T, H)
    xc = xd.reshape(b, nc, Q, H, P)
    ac = a.reshape(b, nc, Q, H)
    Bc = B.reshape(b, nc, Q, N)
    Cc = C.reshape(b, nc, Q, N)

    acs = torch.cumsum(ac, dim=2)                          # (b, nc, Q, H)
    L = torch.exp(_segsum(ac.movedim(-1, -2)))             # (b, nc, H, Q, Q)

    # intra-chunk: y = (C B^T . L) x, as (cb . L) then a matmul over s
    cb = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)           # (b, nc, Q, Q)
    yd = torch.einsum("bchqs,bcshp->bcqhp", cb[:, :, None] * L, xc)

    # chunk-final states: h_c = sum_s exp(acs_Q - acs_s) B_s x_s
    decay_to_end = torch.exp(acs[:, :, -1:, :] - acs)      # (b, nc, Q, H)
    states = torch.einsum("bcsn,bcshp->bchpn", Bc,
                          xc * decay_to_end[..., None])    # (b, nc, H, P, N)

    # inter-chunk recurrence, the state before each chunk
    chunk_decay = torch.exp(acs[:, :, -1, :])              # (b, nc, H)
    h = torch.zeros(b, H, P, N, dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(prev, dim=1)                      # (b, nc, H, P, N)

    # inter-chunk contribution: y += C_t exp(acs_t) h_prev
    yi = torch.einsum("bcqn,bchpn->bcqhp", Cc, h_prev) \
        * torch.exp(acs)[..., None]
    y = (yd + yi).reshape(b, T, H, P) + x * D[None, None, :, None]
    return y, h


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  u (B, T, C); w (K, C); b (C,)."""
    K = w.shape[0]
    T = u.shape[1]
    up = F.pad(u, (0, 0, K - 1, 0))
    out = torch.zeros_like(u)
    for i in range(K):
        out = out + up[:, i: i + T, :] * w[i]
    return out + b


def _softplus(t: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(t, 0)."""
    return torch.logaddexp(t, torch.zeros_like(t))


def mamba2_apply(params, x: torch.Tensor, cfg: Mamba2Config, *,
                 cache: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, T, d) -> (y (B, T, d), cache).  With ``cache`` (one token,
    T == 1) the step updates the conv and SSM caches in place and returns
    them."""
    Bsz, T, _ = x.shape
    H, P, N = cfg.n_heads, cfg.d_head, cfg.d_state
    di = cfg.d_inner
    zxbcdt = linear_apply(params["in_proj"], x, cfg.in_proj)
    z, xin, Bv, Cv, dt = torch.split(zxbcdt, [di, di, N, N, H], dim=-1)
    conv_in = torch.cat([xin, Bv, Cv], dim=-1)
    w = params["conv_w"].to(x.dtype)
    bconv = params["conv_b"].to(x.dtype)

    if cache is None:
        conv = F.silu(_causal_conv(conv_in, w, bconv))
    else:
        hist = torch.cat([cache["conv"].to(x.dtype), conv_in], dim=1)
        acc = bconv + torch.einsum("kc,bkc->bc", w, hist)[:, None, :]
        conv = F.silu(acc)
        cache["conv"].copy_(hist[:, 1:, :])

    xc, Bc, Cc = torch.split(conv, [di, N, N], dim=-1)
    xh = xc.reshape(Bsz, T, H, P)
    dt = _softplus(dt.float() + params["dt_bias"].float())
    A = params["A_log"].float()
    D = params["D"].float()

    if cache is None:
        y, _ = _ssd_chunked(xh.float(), dt, A, Bc.float(), Cc.float(), D,
                            cfg.chunk)
    else:
        # the O(1) step: h <- exp(-exp(A) dt) h + dt B x
        a = torch.exp(dt[:, 0, :] * (-torch.exp(A)))            # (B, H)
        h = cache["ssm"].float()
        x0 = xh[:, 0].float()
        upd = (dt[:, 0, :, None, None] * x0[..., None]) \
            * Bc[:, 0].float()[:, None, None, :]
        h = h * a[..., None, None] + upd
        yv = torch.einsum("bhpn,bn->bhp", h, Cc[:, 0].float())
        y = (yv + x0 * D[None, :, None])[:, None]
        cache["ssm"].copy_(h)

    y = y.reshape(Bsz, T, di).to(x.dtype)
    y = rms_norm(params["norm"], y * F.silu(z))
    return linear_apply(params["out_proj"], y, cfg.out_proj), cache
