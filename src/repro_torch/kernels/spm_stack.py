"""Torch wrappers of the hand-written SPM kernels, their plain versions and
their launch counters.

* **K1** ``spm_stack_kernel_call`` — one planned run of the fused operator
  (``csrc/spm_stack.cu``); replaces ``repro/kernels/spm_stack.py``
  ``_kernel`` / ``spm_stack_kernel_call`` (:157 / :338).
* **K3** ``spm_block_kernel_call`` — the norm -> SPM [-> activation -> SPM
  -> residual] block forward (``csrc/spm_block.cu``); replaces
  ``_block_kernel`` / ``spm_block_kernel_call`` (:873 / :1028).

Both are memory-bound on an H100 (a few flops per element and stage against
2-4 bytes of I/O per element): the bound is the bytes moved over 3.35 TB/s.
The sources say what each design does about it.

A wrapper runs its plain version (``spm_stack_plain``, ``spm_block_plain``:
the same function in f32, op for op) only when its input lies on the CPU.
For a CUDA tensor it launches the kernel, adds one to ``<wrapper>.launches``
and returns, or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import spm_stack_ref

__all__ = ["spm_stack_kernel_call", "spm_stack_plain",
           "spm_block_kernel_call", "spm_block_plain", "pick_block_rows",
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


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    spm_stack_kernel_call.launches = 0
    spm_block_kernel_call.launches = 0
