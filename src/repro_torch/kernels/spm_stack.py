"""Torch wrappers of the hand-written SPM kernels, their plain versions and
their launch counters.

* **K1** ``spm_stack_kernel_call`` — one planned run of the fused operator
  (``csrc/spm_stack.cu``); replaces ``repro/kernels/spm_stack.py``
  ``_kernel`` / ``spm_stack_kernel_call`` (:157 / :338).
* **K2** ``spm_stack_bwd_kernel_call`` — the backward of one run
  (``csrc/spm_stack_bwd.cu``); replaces ``_bwd_kernel`` /
  ``spm_stack_bwd_kernel_call`` (:523 / :608).
* **K3** ``spm_block_kernel_call`` — the norm -> SPM [-> activation -> SPM
  -> residual] block forward (``csrc/spm_block.cu``); replaces
  ``_block_kernel`` / ``spm_block_kernel_call`` (:873 / :1028).
* **K4** ``spm_block_bwd_kernel_call`` — that block's backward from x and
  rstd (``csrc/spm_block_bwd.cu``); replaces ``_block_bwd_kernel`` /
  ``spm_block_bwd_kernel_call`` (:925 / :1117).

All four are memory-bound on an H100 (a few flops per element and stage
against 2-4 bytes of I/O per element): the bound is the bytes moved over
3.35 TB/s.  The sources say what each design does about it.

A wrapper runs its plain version (``spm_stack_plain``,
``spm_stack_bwd_plain``, ``spm_block_plain``, ``spm_block_bwd_plain``: the
same function in f32, rounding where the kernel rounds) only when its input
lies on the CPU.  For a CUDA tensor it launches the kernel, adds one to
``<wrapper>.launches`` and returns, or raises: there is no fallback.

The backward kernels sum their parameter grads over rows in per-block
partials and finish with an ordered sum, so two launches agree bit for
bit; against the plain version those sums differ in order only.  The plain
versions take ``col_sum`` (default ``t.sum(0)``): passing
``lambda t: t.abs().sum(0)`` returns the sums of the terms' magnitudes in
place of the parameter grads, which the on-card checks scale their limits
by.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import spm_stack_ref, stages_collect, walk_back

__all__ = ["spm_stack_kernel_call", "spm_stack_plain",
           "spm_stack_bwd_kernel_call", "spm_stack_bwd_plain",
           "spm_block_kernel_call", "spm_block_plain",
           "spm_block_bwd_kernel_call", "spm_block_bwd_plain",
           "pick_block_rows", "bwd_geometry", "bwd_live_tiles",
           "reset_launch_counts", "SMEM_BYTES", "NUM_SMS", "ACTIVATIONS"]

SMEM_BYTES = 232_448   # H100: dynamic shared memory one block may use
NUM_SMS = 132          # H100 SXM streaming multiprocessors
MAX_STAGES = 32        # csrc/spm_common.cuh SPM_MAX_STAGES
_IO = {torch.float32: 0, torch.bfloat16: 1}
ACTIVATIONS = {None: 0, "relu": 1, "silu": 2, "gelu": 3}

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn(lib: str, name: str, argtypes: tuple):
    from repro_torch.kernels import build
    f = getattr(build.library(lib), name)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def pick_block_rows(n_rows: int, n_tile: int, n_tiles: int = 1) -> int:
    """Rows per thread block: the most (up to 16, a power of two) whose f32
    tile fits half the shared memory (two blocks per SM), then halved
    while the grid holds fewer than two blocks per SM — decode calls get
    one row per block, so their few rows spread over several SMs."""
    br = 16
    while br > 1 and br * n_tile * 4 > SMEM_BYTES // 2:
        br //= 2
    while br > 1 and -(-n_rows // br) * n_tiles < 2 * NUM_SMS:
        br //= 2
    return br


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_vec(v: Optional[torch.Tensor], n: int, dev: torch.device,
               name: str) -> None:
    if v is None:
        return
    if v.shape != (n,) or v.dtype != torch.float32 or v.device != dev \
            or not v.is_contiguous():
        raise ValueError(f"{name}: need a contiguous f32 ({n},) tensor on "
                         f"{dev}, got {tuple(v.shape)} {v.dtype} {v.device}")


def _check_cuda_operands(x, coeffs, vecs, n):
    if x.dtype not in _IO:
        raise TypeError(f"kernel I/O must be f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for cf, name in coeffs:
        if cf is None:
            continue
        if (cf.dtype != torch.float32 or cf.device != x.device
                or not cf.is_contiguous() or cf.shape[1:] != (n // 2, 4)
                or cf.data_ptr() % 16):
            raise ValueError(f"{name}: need a contiguous 16-byte-aligned "
                             f"f32 (L, {n // 2}, 4) tensor on {x.device}")
        if cf.shape[0] > MAX_STAGES:
            raise ValueError(f"{name}: at most {MAX_STAGES} stages")
    for v, name in vecs:
        _check_vec(v, n, x.device, name)


def _strides_arg(strides: Sequence[int]):
    return (ctypes.c_int * max(1, len(strides)))(*strides)


# ---------------------------------------------------------------------------
# K1: one planned run of the fused operator
# ---------------------------------------------------------------------------

def spm_stack_plain(x: torch.Tensor, coeffs: torch.Tensor,
                    d_in: Optional[torch.Tensor] = None,
                    d_out: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None, *,
                    strides: Tuple[int, ...],
                    in_width: Optional[int] = None,
                    out_width: Optional[int] = None) -> torch.Tensor:
    """K1's plain version: ``[D_out](B_l..B_1)[D_in] x [+bias]`` in f32,
    x zero-filled from ``in_width`` to n, the output cut to ``out_width``,
    returned in x's dtype.  Feature tiles need no emulation: every stride
    of a run keeps its pairs inside one tile."""
    n = 2 * coeffs.shape[1]
    z = x.float()
    if z.shape[-1] < n:
        z = F.pad(z, (0, n - z.shape[-1]))
    if d_in is not None:
        z = z * d_in.float()
    z = spm_stack_ref(z, coeffs.float(), tuple(strides))
    if d_out is not None:
        z = z * d_out.float()
    if bias is not None:
        z = z + bias.float()
    if out_width is not None:
        z = z[..., :out_width]
    return z.to(x.dtype)


def spm_stack_kernel_call(x: torch.Tensor, coeffs: torch.Tensor,
                          d_in: Optional[torch.Tensor] = None,
                          d_out: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None, *,
                          strides: Tuple[int, ...], n_tile: int,
                          in_width: Optional[int] = None,
                          out_width: Optional[int] = None) -> torch.Tensor:
    """K1: x (B, in_width or n) -> y (B, out_width or n) in x's dtype, for
    coeffs (L, n//2, 4) f32 whose strides all keep pairs inside an
    ``n_tile``-wide tile; d_in/d_out/bias (n,) f32 are folded in."""
    n = 2 * coeffs.shape[1]
    strides = tuple(int(s) for s in strides)
    in_w = n if in_width is None else int(in_width)
    out_w = n if out_width is None else int(out_width)
    if x.dim() != 2 or x.shape[1] != in_w:
        raise ValueError(f"expected x (B, {in_w}), got {tuple(x.shape)}")
    if coeffs.shape[0] != len(strides) or n % n_tile or not (
            0 < in_w <= n and 0 < out_w <= n):
        raise ValueError(f"bad run: n={n} n_tile={n_tile} "
                         f"L={coeffs.shape[0]} strides={strides} "
                         f"in={in_w} out={out_w}")
    for s in strides:
        if n_tile % (2 * s):
            raise ValueError(f"stride {s} crosses an {n_tile}-wide tile")
    if x.device.type == "cpu":
        return spm_stack_plain(x, coeffs, d_in, d_out, bias, strides=strides,
                               in_width=in_w, out_width=out_width)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_cuda_operands(x, [(coeffs, "coeffs")],
                         [(d_in, "d_in"), (d_out, "d_out"),
                          (bias, "bias")], n)
    B = x.shape[0]
    y = torch.empty((B, out_w), dtype=x.dtype, device=x.device)
    if B == 0:
        return y
    block_rows = pick_block_rows(B, n_tile, -(-out_w // n_tile))
    if block_rows * n_tile * 4 > SMEM_BYTES:
        raise ValueError(f"{block_rows} rows x {n_tile} f32 exceed "
                         f"{SMEM_BYTES} B of shared memory")
    fn = _fn("spm_stack", "spm_stack_fwd",
             (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
              ctypes.POINTER(ctypes.c_int), _I, _P))
    rc = fn(_IO[x.dtype], _ptr(x), _ptr(y), _ptr(coeffs), _ptr(d_in),
            _ptr(d_out), _ptr(bias), B, n, n_tile, in_w, out_w, block_rows,
            _strides_arg(strides), len(strides), _stream(x))
    if rc != 0:
        raise RuntimeError(f"spm_stack_fwd launch failed: cudaError {rc}")
    spm_stack_kernel_call.launches += 1
    return y


spm_stack_kernel_call.launches = 0


# ---------------------------------------------------------------------------
# shared by the backward kernels
# ---------------------------------------------------------------------------

def _col_sum(t: torch.Tensor) -> torch.Tensor:
    return t.sum(0)


def bwd_geometry(n_rows: int, width: int, n_tiles: int, n_live: int,
                 extra: int = 0) -> Tuple[int, int, bool]:
    """``(chunk_rows, n_groups, in_shared)`` of a backward launch whose
    blocks keep ``n_tiles`` f32 tiles of (chunk_rows, width) plus ``extra``
    floats per row.  Chunk rows: the most (up to 16, a power of two) that
    fit a block's shared memory; 1 from a global scratch slab when one row
    does not fit.  Row groups (blocks per feature tile): enough for about
    one wave over the SMs across ``n_live`` tiles, at most one per chunk."""
    def smem(cr):
        return (-(-cr * extra // 4) * 4 + n_tiles * cr * width) * 4

    cr = 16
    while cr > 1 and smem(cr) > SMEM_BYTES:
        cr //= 2
    in_shared = smem(cr) <= SMEM_BYTES
    per_sm = min(4, SMEM_BYTES // smem(cr)) if in_shared else 2
    chunks = -(-n_rows // cr)
    groups = min(chunks, max(1, -(-NUM_SMS * per_sm // n_live)))
    return cr, groups, in_shared


def bwd_live_tiles(n: int, n_tile: int, in_width: Optional[int],
                   out_width: Optional[int], dead_from: Optional[int]
                   ) -> Tuple[int, int]:
    """``(visited feature tiles, g_x width)`` of one run's backward, as the
    reference plans them (``spm_stack.py:670-698``): tiles from the first
    all-dead column (``out_width``, ``dead_from``) on are skipped, and g_x
    is widened to the visited width when ``in_width`` would leave whole
    visited tiles past its edge (the caller slices)."""
    live = n
    if out_width is not None:
        live = min(live, out_width)
    if dead_from is not None:
        live = min(live, dead_from)
    vis = min(n // n_tile, -(-live // n_tile))
    gx_w = n if in_width is None else in_width
    if -(-gx_w // n_tile) < vis:
        gx_w = vis * n_tile
    return vis, gx_w


# ---------------------------------------------------------------------------
# K2: the backward of one planned run
# ---------------------------------------------------------------------------

def spm_stack_bwd_plain(x: torch.Tensor, coeffs: torch.Tensor,
                        gy: torch.Tensor,
                        d_in: Optional[torch.Tensor] = None,
                        d_out: Optional[torch.Tensor] = None, *,
                        strides: Tuple[int, ...], n_tile: int,
                        has_bias: bool = False,
                        in_width: Optional[int] = None,
                        out_width: Optional[int] = None,
                        dead_from: Optional[int] = None,
                        col_sum=_col_sum) -> tuple:
    """K2's plain version in f32: the same outputs as
    ``spm_stack_bwd_kernel_call``.  Every per-row value (the remat, the
    cotangent walk, g_x) rounds where the kernel rounds; only the sums
    over rows differ in order.  Dead tiles come back as exact zeros."""
    n = 2 * coeffs.shape[1]
    vis, gx_w = bwd_live_tiles(n, n_tile, in_width, out_width, dead_from)
    cf = coeffs.float()
    x_raw = x.float()
    x_raw = F.pad(x_raw, (0, n - x_raw.shape[-1]))
    g = gy.float()
    g = F.pad(g, (0, n - g.shape[-1]))
    z = x_raw * d_in.float() if d_in is not None else x_raw
    z, zs = stages_collect(z, cf, strides)
    g_bias = col_sum(g) if has_bias else None
    g_dout = None
    if d_out is not None:
        g_dout = col_sum(g * z)
        g = g * d_out.float()
    g, g_cf = walk_back(zs, g, cf, strides, col_sum)
    g_din = None
    if d_in is not None:
        g_din = col_sum(g * x_raw)
        g = g * d_in.float()
    live = vis * n_tile
    g = g.clone()
    g[:, live:] = 0.0
    g_cf[:, live // 2:] = 0.0
    out = (g[:, :gx_w].to(x.dtype), g_cf)
    for v in (g_din, g_dout, g_bias):
        if v is not None:
            v = v.clone()
            v[live:] = 0.0
            out += (v,)
    return out


def spm_stack_bwd_kernel_call(x: torch.Tensor, coeffs: torch.Tensor,
                              gy: torch.Tensor,
                              d_in: Optional[torch.Tensor] = None,
                              d_out: Optional[torch.Tensor] = None, *,
                              strides: Tuple[int, ...], n_tile: int,
                              has_bias: bool = False,
                              in_width: Optional[int] = None,
                              out_width: Optional[int] = None,
                              dead_from: Optional[int] = None) -> tuple:
    """K2: the backward of one run from its saved input x (B, in_width or
    n) and the cotangent gy (B, out_width or n), both in x's dtype.
    Returns ``(g_x (B, gx_w) in x's dtype, g_coeffs (L, n//2, 4))`` then
    ``g_din``, ``g_dout``, ``g_bias`` (n,) for the operands present, all
    f32.  ``gx_w`` is ``bwd_live_tiles``'s: in_width, widened when it would
    leave visited tiles past its edge.  ``dead_from`` declares gy exactly
    zero from that column on (an upstream run of a multi-run plan)."""
    n = 2 * coeffs.shape[1]
    strides = tuple(int(s) for s in strides)
    in_w = n if in_width is None else int(in_width)
    gy_w = n if out_width is None else int(out_width)
    if x.dim() != 2 or x.shape[1] != in_w or gy.dim() != 2 \
            or gy.shape != (x.shape[0], gy_w):
        raise ValueError(f"expected x (B, {in_w}) and gy (B, {gy_w}), got "
                         f"{tuple(x.shape)} and {tuple(gy.shape)}")
    if coeffs.shape[0] != len(strides) or n % n_tile or not (
            0 < in_w <= n and 0 < gy_w <= n):
        raise ValueError(f"bad run: n={n} n_tile={n_tile} "
                         f"L={coeffs.shape[0]} strides={strides} "
                         f"in={in_w} out={gy_w}")
    for s in strides:
        if n_tile % (2 * s):
            raise ValueError(f"stride {s} crosses an {n_tile}-wide tile")
    kw = dict(strides=strides, n_tile=n_tile, has_bias=has_bias,
              in_width=in_width, out_width=out_width, dead_from=dead_from)
    if x.device.type == "cpu":
        return spm_stack_bwd_plain(x, coeffs, gy, d_in, d_out, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_cuda_operands(x, [(coeffs, "coeffs")],
                         [(d_in, "d_in"), (d_out, "d_out")], n)
    if gy.dtype != x.dtype or gy.device != x.device \
            or not gy.is_contiguous():
        raise ValueError("gy must be contiguous, on x's device, in x's "
                         "dtype")
    vis, gx_w = bwd_live_tiles(n, n_tile, in_width, out_width, dead_from)
    B, L = x.shape[0], len(strides)
    dev = x.device
    gx = torch.empty((B, gx_w), dtype=x.dtype, device=dev)
    g_cf = torch.empty((L, n // 2, 4), dtype=torch.float32, device=dev)
    g_vec = torch.empty((3, n), dtype=torch.float32, device=dev)
    if B == 0:
        for t in (gx, g_cf, g_vec):
            t.zero_()
    else:
        cr, G, in_shared = bwd_geometry(B, n_tile, L + 1, vis)
        part_cf = torch.empty((G, L, n // 2, 4), dtype=torch.float32,
                              device=dev)
        part_vec = torch.empty((G, 3, n), dtype=torch.float32, device=dev)
        grid_tiles = max(vis, -(-gx_w // n_tile))
        scratch = None if in_shared else torch.empty(
            (grid_tiles * G * (L + 1) * cr * n_tile,), dtype=torch.float32,
            device=dev)
        fn = _fn("spm_stack_bwd", "spm_stack_bwd",
                 (_I,) + (_P,) * 11 + (_I,) * 10
                 + (ctypes.POINTER(ctypes.c_int), _I, _P))
        rc = fn(_IO[x.dtype], _ptr(x), _ptr(gy), _ptr(gx), _ptr(coeffs),
                _ptr(d_in), _ptr(d_out), _ptr(g_cf), _ptr(g_vec),
                _ptr(part_cf), _ptr(part_vec), _ptr(scratch), B, n, n_tile,
                in_w, gy_w, gx_w, vis, cr, G, int(has_bias),
                _strides_arg(strides), L, _stream(x))
        if rc != 0:
            raise RuntimeError(f"spm_stack_bwd launch failed: cudaError {rc}")
        spm_stack_bwd_kernel_call.launches += 1
    out = (gx, g_cf)
    for present, row in ((d_in is not None, 0), (d_out is not None, 1),
                         (has_bias, 2)):
        if present:
            out += (g_vec[row],)
    return out


spm_stack_bwd_kernel_call.launches = 0


# ---------------------------------------------------------------------------
# K3: norm -> SPM [-> activation -> SPM -> residual] block forward
# ---------------------------------------------------------------------------

def _act(u: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    if activation == "relu":
        return torch.relu(u)
    if activation == "silu":
        return u * torch.sigmoid(u)
    if activation == "gelu":
        return F.gelu(u, approximate="tanh")   # the reference's tanh gelu
    return u


def spm_block_plain(x: torch.Tensor, coeffs1: torch.Tensor,
                    d_in1: torch.Tensor, d_out1: torch.Tensor,
                    bias1: Optional[torch.Tensor] = None,
                    gamma: Optional[torch.Tensor] = None,
                    coeffs2: Optional[torch.Tensor] = None,
                    d_in2: Optional[torch.Tensor] = None,
                    d_out2: Optional[torch.Tensor] = None,
                    bias2: Optional[torch.Tensor] = None, *,
                    strides1: Tuple[int, ...],
                    strides2: Optional[Tuple[int, ...]] = None,
                    activation: Optional[str] = None,
                    residual: bool = False, in_width: int, mid_width: int,
                    out_width: int, eps: float = 1e-6
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K3's plain version in f32: returns ``(y (B, out_width) in x's
    dtype, rstd (B, 1) f32 or None without gamma)``.  The RMS mean divides
    by ``in_width``; the mid boundary is masked to ``mid_width`` before the
    activation."""
    n = 2 * coeffs1.shape[1]
    lane = torch.arange(n, device=x.device)
    x_raw = F.pad(x.float(), (0, n - in_width))
    rstd = None
    z = x_raw
    if gamma is not None:
        var = (x_raw * x_raw).sum(-1, keepdim=True) / in_width
        rstd = torch.rsqrt(var + eps)
        z = x_raw * rstd * gamma.float()
    z = z * d_in1.float()
    z = spm_stack_ref(z, coeffs1.float(), tuple(strides1))
    z = z * d_out1.float()
    if bias1 is not None:
        z = z + bias1.float()
    if strides2 is not None or activation is not None:
        z = _act(torch.where(lane < mid_width, z, 0.0), activation)
    if strides2 is not None:
        z = z * d_in2.float()
        z = spm_stack_ref(z, coeffs2.float(), tuple(strides2))
        z = z * d_out2.float()
        if bias2 is not None:
            z = z + bias2.float()
    if residual:
        z = z + x_raw
    return z[:, :out_width].to(x.dtype), rstd


def spm_block_kernel_call(x: torch.Tensor, coeffs1: torch.Tensor,
                          d_in1: torch.Tensor, d_out1: torch.Tensor,
                          bias1: Optional[torch.Tensor] = None,
                          gamma: Optional[torch.Tensor] = None,
                          coeffs2: Optional[torch.Tensor] = None,
                          d_in2: Optional[torch.Tensor] = None,
                          d_out2: Optional[torch.Tensor] = None,
                          bias2: Optional[torch.Tensor] = None, *,
                          strides1: Tuple[int, ...],
                          strides2: Optional[Tuple[int, ...]] = None,
                          activation: Optional[str] = None,
                          residual: bool = False, in_width: int,
                          mid_width: int, out_width: int, eps: float = 1e-6
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K3: x (B, in_width) -> ``(y (B, out_width), rstd (B, 1) f32 or
    None)``.  gamma is (n,) f32, zero past ``in_width``; ``strides2=None``
    is the norm-prologue-only form.  Every stride must keep its pairs
    inside the full width n (one tile)."""
    n = 2 * coeffs1.shape[1]
    strides1 = tuple(int(s) for s in strides1)
    strides2 = None if strides2 is None else tuple(int(s) for s in strides2)
    if x.dim() != 2 or x.shape[1] != in_width:
        raise ValueError(f"expected x (B, {in_width}), got "
                         f"{tuple(x.shape)}")
    for s in strides1 + (strides2 or ()):
        if n % (2 * s):
            raise ValueError(f"stride {s} invalid for n={n}")
    if (strides2 is None) != (coeffs2 is None):
        raise ValueError("strides2 and coeffs2 go together")
    if residual and out_width != in_width:
        raise ValueError("residual needs out_width == in_width")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    for w in (in_width, mid_width, out_width):
        if not 0 < w <= n:
            raise ValueError(f"width {w} outside (0, {n}]")
    kw = dict(strides1=strides1, strides2=strides2, activation=activation,
              residual=residual, in_width=in_width, mid_width=mid_width,
              out_width=out_width, eps=eps)
    if x.device.type == "cpu":
        return spm_block_plain(x, coeffs1, d_in1, d_out1, bias1, gamma,
                               coeffs2, d_in2, d_out2, bias2, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_cuda_operands(
        x, [(coeffs1, "coeffs1"), (coeffs2, "coeffs2")],
        [(d_in1, "d_in1"), (d_out1, "d_out1"), (bias1, "bias1"),
         (gamma, "gamma"), (d_in2, "d_in2"), (d_out2, "d_out2"),
         (bias2, "bias2")], n)
    if strides2 is not None and (d_in2 is None or d_out2 is None):
        raise ValueError("a second stack needs d_in2 and d_out2")
    B = x.shape[0]
    y = torch.empty((B, out_width), dtype=x.dtype, device=x.device)
    rstd = (torch.empty((B, 1), dtype=torch.float32, device=x.device)
            if gamma is not None else None)
    if B == 0:
        return y, rstd
    block_rows = pick_block_rows(B, n)
    if (-(-block_rows // 4) * 4 + block_rows * n) * 4 > SMEM_BYTES:
        raise ValueError(f"{block_rows} rows x {n} f32 exceed "
                         f"{SMEM_BYTES} B of shared memory")
    s2 = strides2 or ()
    fn = _fn("spm_block", "spm_block_fwd",
             (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
              _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
              ctypes.POINTER(ctypes.c_int), _I,
              ctypes.POINTER(ctypes.c_int), _I, _P))
    rc = fn(_IO[x.dtype], _ptr(x), _ptr(y), _ptr(rstd), _ptr(gamma),
            _ptr(coeffs1), _ptr(d_in1), _ptr(d_out1), _ptr(bias1),
            _ptr(coeffs2), _ptr(d_in2), _ptr(d_out2), _ptr(bias2),
            B, n, in_width, mid_width, out_width, block_rows,
            ACTIVATIONS[activation], int(residual), float(eps),
            _strides_arg(strides1), len(strides1), _strides_arg(s2),
            len(s2), _stream(x))
    if rc != 0:
        raise RuntimeError(f"spm_block_fwd launch failed: cudaError {rc}")
    spm_block_kernel_call.launches += 1
    return y, rstd


spm_block_kernel_call.launches = 0


# ---------------------------------------------------------------------------
# K4: the block backward from x and rstd
# ---------------------------------------------------------------------------

def _act_grad(u: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    """The reference's ``_act_grad`` (``spm_stack.py:855``)."""
    if activation == "relu":
        return (u > 0).to(u.dtype)
    if activation == "silu":
        sg = torch.sigmoid(u)
        return sg * (1.0 + u * (1.0 - sg))
    if activation == "gelu":
        k = 0.7978845608028654
        t = torch.tanh(k * (u + 0.044715 * u * u * u))
        return (0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * k
                * (1.0 + 3 * 0.044715 * u * u))
    return torch.ones_like(u)


def spm_block_bwd_plain(x: torch.Tensor, gy: torch.Tensor,
                        coeffs1: torch.Tensor, d_in1: torch.Tensor,
                        d_out1: torch.Tensor,
                        bias1: Optional[torch.Tensor] = None,
                        gamma: Optional[torch.Tensor] = None,
                        rstd: Optional[torch.Tensor] = None,
                        coeffs2: Optional[torch.Tensor] = None,
                        d_in2: Optional[torch.Tensor] = None,
                        d_out2: Optional[torch.Tensor] = None,
                        bias2: Optional[torch.Tensor] = None, *,
                        strides1: Tuple[int, ...],
                        strides2: Optional[Tuple[int, ...]] = None,
                        activation: Optional[str] = None,
                        residual: bool = False, in_width: int,
                        mid_width: int, out_width: int,
                        col_sum=_col_sum) -> tuple:
    """K4's plain version in f32: the same outputs as
    ``spm_block_bwd_kernel_call``.  The remat and both walks round where the
    kernel rounds; the activation's exp/tanh, the row mean of the norm's
    grad and the sums over rows may differ from the kernel's by rounding."""
    n = 2 * coeffs1.shape[1]
    lane = torch.arange(n, device=x.device)
    two = strides2 is not None
    x_raw = F.pad(x.float(), (0, n - in_width))
    xh = z0 = x_raw
    if gamma is not None:
        xh = x_raw * rstd.float()
        z0 = xh * gamma.float()
    cf1 = coeffs1.float()
    z1, zs1 = stages_collect(z0 * d_in1.float(), cf1, strides1)
    u = z1 * d_out1.float()
    if bias1 is not None:
        u = u + bias1.float()
    if two or activation is not None:
        u = torch.where(lane < mid_width, u, 0.0)
    g = F.pad(gy.float(), (0, n - out_width))
    out_vec = {}
    if two:
        cf2 = coeffs2.float()
        h = _act(u, activation)
        z2, zs2 = stages_collect(h * d_in2.float(), cf2, strides2)
        if bias2 is not None:
            out_vec["b2"] = col_sum(g)
        out_vec["dout2"] = col_sum(g * z2)
        delta, g_cf2 = walk_back(zs2, g * d_out2.float(), cf2, strides2,
                                 col_sum)
        out_vec["din2"] = col_sum(delta * h)
        dh = torch.where(lane < mid_width, delta * d_in2.float(), 0.0)
        du = dh * _act_grad(u, activation)
    elif activation is not None:
        du = g * _act_grad(u, activation)
    else:
        du = g
    g_bias1 = col_sum(du) if bias1 is not None else None
    g_dout1 = col_sum(du * z1)
    delta, g_cf1 = walk_back(zs1, du * d_out1.float(), cf1, strides1,
                             col_sum)
    g_din1 = col_sum(delta * z0)
    dz0 = torch.where(lane < in_width, delta * d_in1.float(), 0.0)
    if gamma is not None:
        g_gamma = col_sum(dz0 * xh)
        gxh = dz0 * gamma.float()
        mean = (gxh * xh).sum(-1, keepdim=True) / in_width
        gx = rstd.float() * (gxh - xh * mean)
    else:
        gx = dz0
    if residual:
        gx = gx + g
    out = (gx[:, :in_width].to(x.dtype),)
    if gamma is not None:
        out += (g_gamma,)
    out += (g_cf1, g_din1, g_dout1)
    if bias1 is not None:
        out += (g_bias1,)
    if two:
        out += (g_cf2, out_vec["din2"], out_vec["dout2"])
        if bias2 is not None:
            out += (out_vec["b2"],)
    return out


def spm_block_bwd_kernel_call(x: torch.Tensor, gy: torch.Tensor,
                              coeffs1: torch.Tensor, d_in1: torch.Tensor,
                              d_out1: torch.Tensor,
                              bias1: Optional[torch.Tensor] = None,
                              gamma: Optional[torch.Tensor] = None,
                              rstd: Optional[torch.Tensor] = None,
                              coeffs2: Optional[torch.Tensor] = None,
                              d_in2: Optional[torch.Tensor] = None,
                              d_out2: Optional[torch.Tensor] = None,
                              bias2: Optional[torch.Tensor] = None, *,
                              strides1: Tuple[int, ...],
                              strides2: Optional[Tuple[int, ...]] = None,
                              activation: Optional[str] = None,
                              residual: bool = False, in_width: int,
                              mid_width: int, out_width: int) -> tuple:
    """K4: from x (B, in_width), gy (B, out_width) in x's dtype and, with
    the norm, rstd (B, 1) f32 saved by K3, returns ``(g_x (B, in_width) in
    x's dtype, [g_gamma], g_coeffs1, g_din1, g_dout1, [g_bias1],
    [g_coeffs2, g_din2, g_dout2, [g_bias2]])``, bracketed entries present
    when their operand is; every parameter grad f32 and exactly zero on
    padded lanes."""
    n = 2 * coeffs1.shape[1]
    strides1 = tuple(int(s) for s in strides1)
    strides2 = None if strides2 is None else tuple(int(s) for s in strides2)
    if x.dim() != 2 or x.shape[1] != in_width or gy.dim() != 2 \
            or gy.shape != (x.shape[0], out_width):
        raise ValueError(f"expected x (B, {in_width}) and gy "
                         f"(B, {out_width}), got {tuple(x.shape)} and "
                         f"{tuple(gy.shape)}")
    for s in strides1 + (strides2 or ()):
        if n % (2 * s):
            raise ValueError(f"stride {s} invalid for n={n}")
    if (strides2 is None) != (coeffs2 is None):
        raise ValueError("strides2 and coeffs2 go together")
    if (gamma is None) != (rstd is None):
        raise ValueError("gamma and rstd go together")
    if residual and out_width != in_width:
        raise ValueError("residual needs out_width == in_width")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    for w in (in_width, mid_width, out_width):
        if not 0 < w <= n:
            raise ValueError(f"width {w} outside (0, {n}]")
    kw = dict(strides1=strides1, strides2=strides2, activation=activation,
              residual=residual, in_width=in_width, mid_width=mid_width,
              out_width=out_width)
    ops = (coeffs1, d_in1, d_out1, bias1, gamma, rstd, coeffs2, d_in2,
           d_out2, bias2)
    if x.device.type == "cpu":
        return spm_block_bwd_plain(x, gy, *ops, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_cuda_operands(
        x, [(coeffs1, "coeffs1"), (coeffs2, "coeffs2")],
        [(d_in1, "d_in1"), (d_out1, "d_out1"), (bias1, "bias1"),
         (gamma, "gamma"), (d_in2, "d_in2"), (d_out2, "d_out2"),
         (bias2, "bias2")], n)
    if strides2 is not None and (d_in2 is None or d_out2 is None):
        raise ValueError("a second stack needs d_in2 and d_out2")
    if gy.dtype != x.dtype or gy.device != x.device \
            or not gy.is_contiguous():
        raise ValueError("gy must be contiguous, on x's device, in x's "
                         "dtype")
    B = x.shape[0]
    if rstd is not None and (rstd.shape != (B, 1) or rstd.dtype !=
                             torch.float32 or not rstd.is_contiguous()):
        raise ValueError(f"rstd: need a contiguous f32 ({B}, 1) tensor")
    dev = x.device
    L1 = len(strides1)
    L2 = 0 if strides2 is None else len(strides2)
    gx = torch.empty((B, in_width), dtype=x.dtype, device=dev)
    g_cf1 = torch.empty((L1, n // 2, 4), dtype=torch.float32, device=dev)
    g_cf2 = (None if strides2 is None else
             torch.empty((L2, n // 2, 4), dtype=torch.float32, device=dev))
    g_vec = torch.empty((7, n), dtype=torch.float32, device=dev)
    if B == 0:
        for t in (gx, g_cf1, g_cf2, g_vec):
            if t is not None:
                t.zero_()
    else:
        tiles = L1 + 1 + (L2 + 1 if strides2 is not None else 0)
        cr, G, in_shared = bwd_geometry(B, n, tiles, 1, extra=1)
        part_cf1 = torch.empty((G, L1, n // 2, 4), dtype=torch.float32,
                               device=dev)
        part_cf2 = (None if strides2 is None else torch.empty(
            (G, L2, n // 2, 4), dtype=torch.float32, device=dev))
        part_vec = torch.empty((G, 7, n), dtype=torch.float32, device=dev)
        scratch = None if in_shared else torch.empty(
            (G * tiles * cr * n,), dtype=torch.float32, device=dev)
        s2 = strides2 or ()
        fn = _fn("spm_block_bwd", "spm_block_bwd",
                 (_I,) + (_P,) * 20 + (_I,) * 9
                 + (ctypes.POINTER(ctypes.c_int), _I,
                    ctypes.POINTER(ctypes.c_int), _I, _P))
        rc = fn(_IO[x.dtype], _ptr(x), _ptr(gy), _ptr(gx), _ptr(rstd),
                _ptr(gamma), _ptr(coeffs1), _ptr(d_in1), _ptr(d_out1),
                _ptr(bias1), _ptr(coeffs2), _ptr(d_in2), _ptr(d_out2),
                _ptr(bias2), _ptr(g_cf1), _ptr(g_cf2), _ptr(g_vec),
                _ptr(part_cf1), _ptr(part_cf2), _ptr(part_vec),
                _ptr(scratch), B, n, in_width, mid_width, out_width, cr, G,
                ACTIVATIONS[activation], int(residual),
                _strides_arg(strides1), L1, _strides_arg(s2), len(s2),
                _stream(x))
        if rc != 0:
            raise RuntimeError(f"spm_block_bwd launch failed: cudaError {rc}")
        spm_block_bwd_kernel_call.launches += 1
    out = (gx,)
    if gamma is not None:
        out += (g_vec[0],)
    out += (g_cf1, g_vec[1], g_vec[2])
    if bias1 is not None:
        out += (g_vec[3],)
    if strides2 is not None:
        out += (g_cf2, g_vec[4], g_vec[5])
        if bias2 is not None:
            out += (g_vec[6],)
    return out


spm_block_bwd_kernel_call.launches = 0


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    spm_stack_kernel_call.launches = 0
    spm_stack_bwd_kernel_call.launches = 0
    spm_block_kernel_call.launches = 0
    spm_block_bwd_kernel_call.launches = 0
