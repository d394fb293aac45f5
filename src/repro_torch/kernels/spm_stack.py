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
* **K5** ``spm_overlap_kernel_call`` — one ``{local run -> cross stage}``
  pair of the sharded executor over every shard: each shard's local run,
  the exchange with its XOR-k partner and the 2x2 mix
  (``csrc/spm_overlap.cu``); replaces ``_overlap_kernel`` /
  ``spm_overlap_kernel_call`` (:1319 / :1382).
* **K6** ``spm_overlap_bwd_kernel_call`` — that pair's backward from the
  local run's input (``csrc/spm_overlap_bwd.cu``); replaces
  ``_overlap_bwd_kernel`` / ``spm_overlap_bwd_kernel_call`` (:1479 /
  :1590).

All six are memory-bound on an H100 (a few flops per element and stage
against 2-4 bytes of I/O per element): the bound is the bytes moved over
3.35 TB/s.  The sources say what each design does about it.

A wrapper runs its plain version (``spm_stack_plain``,
``spm_stack_bwd_plain``, ``spm_block_plain``, ``spm_block_bwd_plain``,
``spm_overlap_plain``, ``spm_overlap_bwd_plain``: the
same function in f32, rounding where the kernel rounds) only when its input
lies on the CPU.  For a CUDA tensor it launches the kernel, adds one to
``<wrapper>.launches`` and returns, or raises: there is no fallback.

K1 and K2 have a windowed mode (the reference's ``col_base``), the read of
the feature-sharded executor (``parallel/spm_shard.py``): x is the whole
(B, in_width) operand shared by the shards and the kernel reads one shard's
window of it, column ``(col_base + j) * n_tile + c`` against the global
``in_width``, while the table, the vectors, y and g_x are the shard's own.
K2 can read gy the same way against the global ``out_width``.  Their
``window_launches`` count the launches in this mode; K5's and K6's count
those reading a rectangular input (``in_width``), their
``int8_launches`` those with an int8 table.

K1 and K2 have int8 modes (the reference's ``x_scale``, ``coeff_scale``
and ``quant_out``; scale conventions in ``kernels/quant.py``): int8
activations with one scale per (``scale_rows``, ``n_tile``) block, and int8
coefficient tables with one scale per stage.  Compute stays f32.  K1's and
K2's ``int8_launches`` count the launches in an int8 mode and
``int8_io_launches`` those with int8 activations, beside ``launches``,
which counts them all.

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

from repro_torch.kernels import quant as Q
from repro_torch.kernels.ref import spm_stack_ref, stages_collect, walk_back

__all__ = ["spm_stack_kernel_call", "spm_stack_plain",
           "spm_stack_bwd_kernel_call", "spm_stack_bwd_plain",
           "spm_block_kernel_call", "spm_block_plain",
           "spm_block_bwd_kernel_call", "spm_block_bwd_plain",
           "spm_overlap_kernel_call", "spm_overlap_plain",
           "spm_overlap_bwd_kernel_call", "spm_overlap_bwd_plain",
           "pick_block_rows", "bwd_geometry", "bwd_live_tiles",
           "int8_cta_rows",
           "reset_launch_counts", "SMEM_BYTES", "NUM_SMS", "ACTIVATIONS"]

SMEM_BYTES = 232_448   # H100: dynamic shared memory one block may use
NUM_SMS = 132          # H100 SXM streaming multiprocessors
MAX_STAGES = 32        # csrc/spm_common.cuh SPM_MAX_STAGES
_IO = {torch.float32: 0, torch.bfloat16: 1}
_IO_INT8 = 2           # csrc/spm_common.cuh SPM_IO_INT8
_Q8_STATIC_SMEM = 1024  # the int8 kernel's static shared memory, at most
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


def _check_coeffs(cf, n: int, dev: torch.device, name: str,
                  scale: Optional[torch.Tensor] = None) -> None:
    """An f32 (L, n/2, 4) table read as float4s, or with ``scale`` an int8
    one read as char4s with its (L,) f32 stage scales."""
    if cf is None:
        return
    dt, align = (torch.float32, 16) if scale is None else (torch.int8, 4)
    if (cf.dtype != dt or cf.device != dev or not cf.is_contiguous()
            or cf.shape[1:] != (n // 2, 4) or cf.data_ptr() % align):
        raise ValueError(f"{name}: need a contiguous {align}-byte-aligned "
                         f"{dt} (L, {n // 2}, 4) tensor on {dev}")
    if cf.shape[0] > MAX_STAGES:
        raise ValueError(f"{name}: at most {MAX_STAGES} stages")
    if scale is not None and (
            scale.shape != (cf.shape[0],) or scale.dtype != torch.float32
            or scale.device != dev or not scale.is_contiguous()):
        raise ValueError(f"{name}: need contiguous f32 ({cf.shape[0]},) "
                         f"stage scales on {dev}")


def _check_cuda_operands(x, coeffs, vecs, n, x_scale=None, n_tile=None,
                         scale_rows=None):
    """x f32 or bf16 (int8 with ``x_scale``, its (B // scale_rows,
    ceil(width / n_tile)) f32 block scales); ``coeffs`` pairs of (table,
    name) or (table, name, stage scales); (n,) f32 vectors."""
    if x_scale is None and x.dtype not in _IO:
        raise TypeError(f"kernel I/O must be f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x_scale is not None:
        want = (x.shape[0] // scale_rows, -(-x.shape[1] // n_tile))
        if (x_scale.shape != want or x_scale.dtype != torch.float32
                or x_scale.device != x.device
                or not x_scale.is_contiguous()):
            raise ValueError(f"x_scale: need contiguous f32 {want} on "
                             f"{x.device}, got {tuple(x_scale.shape)} "
                             f"{x_scale.dtype}")
    for cf, name, *scale in coeffs:
        _check_coeffs(cf, n, x.device, name, *scale)
    for v, name in vecs:
        _check_vec(v, n, x.device, name)


def _check_quant_args(x, coeffs, x_scale, coeff_scale, scale_rows,
                      quant_out=None):
    """The int8 operands' dtypes and the scale grid, on any device."""
    if (x_scale is not None) != (x.dtype == torch.int8):
        raise TypeError("int8 x and x_scale go together")
    if (coeff_scale is not None) != (coeffs.dtype == torch.int8):
        raise TypeError("int8 coeffs and coeff_scale go together")
    if quant_out is not None and quant_out != (x_scale is not None):
        raise ValueError("int8 activation I/O reads and writes int8: "
                         "x_scale and quant_out go together")
    if x_scale is not None or quant_out:
        if scale_rows is None or scale_rows <= 0 \
                or x.shape[0] % scale_rows:
            raise ValueError(f"rows {x.shape[0]} must be a multiple of "
                             f"scale_rows={scale_rows}")


def _count(fn, x_scale, coeff_scale, window: bool = False) -> None:
    fn.launches += 1
    if window:
        fn.window_launches += 1
    if x_scale is not None or coeff_scale is not None:
        fn.int8_launches += 1
    if x_scale is not None:
        fn.int8_io_launches += 1


def _strides_arg(strides: Sequence[int]):
    return (ctypes.c_int * max(1, len(strides)))(*strides)


def _window(t: torch.Tensor, col_base: int, n_tile: int,
            n: int) -> torch.Tensor:
    """Columns ``[col_base*n_tile, col_base*n_tile + n)`` of ``t`` (B, w),
    zero past w: the lanes a windowed kernel reads."""
    c0 = col_base * n_tile
    t = F.pad(t, (0, max(0, c0 + n - t.shape[-1])))
    return t[:, c0: c0 + n]


def _check_window(col_base, in_width, out_width, quant) -> None:
    if col_base is None:
        return
    if col_base < 0 or quant:
        raise ValueError("the windowed mode takes a base tile >= 0 and no "
                         "int8 activations")
    if in_width is None and out_width is None:
        raise ValueError("the windowed mode reads x (in_width) or gy "
                         "(out_width) at the global column")


def _plain_coeffs(coeffs, coeff_scale) -> torch.Tensor:
    return (coeffs.float() if coeff_scale is None
            else Q.dequantize_coeffs(coeffs, coeff_scale))


def _plain_x(x, x_scale, scale_rows, n_tile) -> torch.Tensor:
    return (x.float() if x_scale is None
            else Q.dequantize_blocks(x, x_scale, scale_rows, n_tile))


# ---------------------------------------------------------------------------
# K1: one planned run of the fused operator
# ---------------------------------------------------------------------------

def spm_stack_plain(x: torch.Tensor, coeffs: torch.Tensor,
                    d_in: Optional[torch.Tensor] = None,
                    d_out: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    x_scale: Optional[torch.Tensor] = None,
                    coeff_scale: Optional[torch.Tensor] = None, *,
                    strides: Tuple[int, ...],
                    in_width: Optional[int] = None,
                    out_width: Optional[int] = None,
                    n_tile: Optional[int] = None,
                    quant_out: bool = False,
                    scale_rows: Optional[int] = None,
                    col_base: Optional[int] = None):
    """K1's plain version: ``[D_out](B_l..B_1)[D_in] x [+bias]`` in f32,
    x zero-filled from ``in_width`` to n, the output cut to ``out_width``,
    returned in x's dtype.  Feature tiles need no emulation: every stride
    of a run keeps its pairs inside one tile.  With ``col_base`` x is the
    global (B, in_width) operand and its window from column
    ``col_base * n_tile`` is read, zero past ``in_width``.

    The int8 modes round where the kernel rounds: int8 x is ``q * scale``
    of its (``scale_rows``, ``n_tile``) block, an int8 table ``q * scale``
    of its stage, and ``quant_out`` returns ``(q int8, scales)`` with one
    scale for each (``scale_rows``, ``n_tile``) block of the output, its
    absmax taken over the whole tile, lanes past ``out_width`` included."""
    n = 2 * coeffs.shape[1]
    z = _plain_x(x, x_scale, scale_rows, n_tile)
    if col_base is not None:
        z = _window(z, col_base, n_tile, n)
    if z.shape[-1] < n:
        z = F.pad(z, (0, n - z.shape[-1]))
    if d_in is not None:
        z = z * d_in.float()
    z = spm_stack_ref(z, _plain_coeffs(coeffs, coeff_scale), tuple(strides))
    if d_out is not None:
        z = z * d_out.float()
    if bias is not None:
        z = z + bias.float()
    out_w = n if out_width is None else out_width
    if quant_out:
        q, scales = Q.quantize_blocks(z[:, :-(-out_w // n_tile) * n_tile],
                                      scale_rows, n_tile)
        return q[:, :out_w].contiguous(), scales
    return z[:, :out_w].to(x.dtype)


def int8_cta_rows(n_rows: int, n_tile: int, n_tiles: int,
                   scale_rows: int) -> int:
    """Rows a block takes in the int8 activation mode: ``pick_block_rows``,
    within the scale block, and at least an eighth of it, so that a
    cluster of at most 8 blocks (the portable size) holds one scale
    block.  Raises when those rows' f32 tile exceeds shared memory."""
    cta = min(pick_block_rows(n_rows, n_tile, n_tiles), scale_rows)
    cta = max(cta, scale_rows // 8)
    if cta * n_tile * 4 > SMEM_BYTES - _Q8_STATIC_SMEM:
        raise ValueError(
            f"a {scale_rows} x {n_tile} scale block needs {cta}-row blocks "
            f"of {cta * n_tile * 4} B f32 in a cluster of "
            f"{scale_rows // cta}: more than the {SMEM_BYTES} B of shared "
            f"memory a block has")
    return cta


def spm_stack_kernel_call(x: torch.Tensor, coeffs: torch.Tensor,
                          d_in: Optional[torch.Tensor] = None,
                          d_out: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None,
                          x_scale: Optional[torch.Tensor] = None,
                          coeff_scale: Optional[torch.Tensor] = None, *,
                          strides: Tuple[int, ...], n_tile: int,
                          in_width: Optional[int] = None,
                          out_width: Optional[int] = None,
                          quant_out: bool = False,
                          scale_rows: Optional[int] = None,
                          col_base: Optional[int] = None):
    """K1: x (B, in_width or n) -> y (B, out_width or n) in x's dtype, for
    coeffs (L, n//2, 4) f32 whose strides all keep pairs inside an
    ``n_tile``-wide tile; d_in/d_out/bias (n,) f32 are folded in.

    Windowed mode (``col_base``, a base feature tile): x is the global
    (B, in_width) operand, in_width may exceed n, and feature tile j reads
    x's tile ``col_base + j``, zero from the global ``in_width`` on; y is
    the full (B, n) slab.  No ``out_width``, no int8 activations.

    Int8 modes: ``coeff_scale`` (L,) f32 marks an int8 table, dequantized
    a stage at a time on chip.  ``x_scale`` marks int8 x with one scale for
    each (``scale_rows``, ``n_tile``) block and goes with ``quant_out``:
    the result is requantized on the store and returned as ``(y int8,
    y_scale (B // scale_rows, ceil(out_width / n_tile)) f32)``.  B must be
    a multiple of ``scale_rows``; each scale block is one thread-block
    cluster.  A scale block no cluster can hold on chip raises."""
    n = 2 * coeffs.shape[1]
    strides = tuple(int(s) for s in strides)
    in_w = n if in_width is None else int(in_width)
    out_w = n if out_width is None else int(out_width)
    if x.dim() != 2 or x.shape[1] != in_w:
        raise ValueError(f"expected x (B, {in_w}), got {tuple(x.shape)}")
    if coeffs.shape[0] != len(strides) or n % n_tile or not (
            0 < in_w and (col_base is not None or in_w <= n)
            and 0 < out_w <= n):
        raise ValueError(f"bad run: n={n} n_tile={n_tile} "
                         f"L={coeffs.shape[0]} strides={strides} "
                         f"in={in_w} out={out_w}")
    for s in strides:
        if n_tile % (2 * s):
            raise ValueError(f"stride {s} crosses an {n_tile}-wide tile")
    _check_quant_args(x, coeffs, x_scale, coeff_scale, scale_rows, quant_out)
    _check_window(col_base, in_width, None, x_scale is not None or quant_out)
    if col_base is not None and out_width is not None:
        raise ValueError("K1's windowed mode stores the whole (B, n) slab")
    if x.device.type == "cpu":
        return spm_stack_plain(x, coeffs, d_in, d_out, bias, x_scale,
                               coeff_scale, strides=strides, in_width=in_w,
                               out_width=out_width, n_tile=n_tile,
                               quant_out=quant_out, scale_rows=scale_rows,
                               col_base=col_base)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_cuda_operands(x, [(coeffs, "coeffs", coeff_scale)],
                         [(d_in, "d_in"), (d_out, "d_out"), (bias, "bias")],
                         n, x_scale, n_tile, scale_rows)
    B = x.shape[0]
    tiles = -(-out_w // n_tile)
    if quant_out:
        y = torch.empty((B, out_w), dtype=torch.int8, device=x.device)
        ys = torch.empty((B // scale_rows, tiles), dtype=torch.float32,
                         device=x.device)
    else:
        y = torch.empty((B, out_w), dtype=x.dtype, device=x.device)
        ys = None
    if B == 0:
        return (y, ys) if quant_out else y
    if quant_out:
        block_rows = int8_cta_rows(B, n_tile, tiles, scale_rows)
    else:
        block_rows = pick_block_rows(B, n_tile, tiles)
        if block_rows * n_tile * 4 > SMEM_BYTES:
            raise ValueError(f"{block_rows} rows x {n_tile} f32 exceed "
                             f"{SMEM_BYTES} B of shared memory")
    fn = _fn("spm_stack", "spm_stack_fwd",
             (_I,) + (_P,) * 9 + (_I,) * 8
             + (ctypes.POINTER(ctypes.c_int), _I, _P))
    io = _IO_INT8 if quant_out else _IO[x.dtype]
    x_off = 0 if col_base is None else int(col_base) * n_tile
    rc = fn(io, _ptr(x), _ptr(x_scale), _ptr(y), _ptr(ys), _ptr(coeffs),
            _ptr(coeff_scale), _ptr(d_in), _ptr(d_out), _ptr(bias), B, n,
            n_tile, in_w, out_w, x_off, block_rows, scale_rows or 0,
            _strides_arg(strides), len(strides), _stream(x))
    if rc != 0:
        raise RuntimeError(f"spm_stack_fwd launch failed: cudaError {rc}")
    _count(spm_stack_kernel_call, x_scale, coeff_scale,
           col_base is not None)
    return (y, ys) if quant_out else y


spm_stack_kernel_call.launches = 0
spm_stack_kernel_call.int8_launches = 0
spm_stack_kernel_call.int8_io_launches = 0
spm_stack_kernel_call.window_launches = 0


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
                        d_out: Optional[torch.Tensor] = None,
                        x_scale: Optional[torch.Tensor] = None,
                        coeff_scale: Optional[torch.Tensor] = None, *,
                        strides: Tuple[int, ...], n_tile: int,
                        has_bias: bool = False,
                        in_width: Optional[int] = None,
                        out_width: Optional[int] = None,
                        dead_from: Optional[int] = None,
                        scale_rows: Optional[int] = None,
                        col_base: Optional[int] = None,
                        col_sum=_col_sum) -> tuple:
    """K2's plain version in f32: the same outputs as
    ``spm_stack_bwd_kernel_call``.  Every per-row value (the remat, the
    cotangent walk, g_x) rounds where the kernel rounds; only the sums
    over rows differ in order.  Dead tiles come back as exact zeros.  An
    int8 x or table is dequantized as K1's plain version does it.  With
    ``col_base`` x (with ``in_width``) and gy (with ``out_width``) are read
    through the window, as K1's plain version reads x."""
    n = 2 * coeffs.shape[1]
    cf = _plain_coeffs(coeffs, coeff_scale)
    x_raw = _plain_x(x, x_scale, scale_rows, n_tile)
    g = gy.float()
    if col_base is not None:
        if in_width is not None:
            x_raw = _window(x_raw, col_base, n_tile, n)
        if out_width is not None:
            g = _window(g, col_base, n_tile, n)
        in_width = out_width = dead_from = None
    vis, gx_w = bwd_live_tiles(n, n_tile, in_width, out_width, dead_from)
    x_raw = F.pad(x_raw, (0, n - x_raw.shape[-1]))
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
    out = (g[:, :gx_w].to(gy.dtype if x_scale is not None else x.dtype),
           g_cf)
    for v in (g_din, g_dout, g_bias):
        if v is not None:
            v = v.clone()
            v[live:] = 0.0
            out += (v,)
    return out


def spm_stack_bwd_kernel_call(x: torch.Tensor, coeffs: torch.Tensor,
                              gy: torch.Tensor,
                              d_in: Optional[torch.Tensor] = None,
                              d_out: Optional[torch.Tensor] = None,
                              x_scale: Optional[torch.Tensor] = None,
                              coeff_scale: Optional[torch.Tensor] = None, *,
                              strides: Tuple[int, ...], n_tile: int,
                              has_bias: bool = False,
                              in_width: Optional[int] = None,
                              out_width: Optional[int] = None,
                              dead_from: Optional[int] = None,
                              scale_rows: Optional[int] = None,
                              col_base: Optional[int] = None) -> tuple:
    """K2: the backward of one run from its saved input x (B, in_width or
    n) and the cotangent gy (B, out_width or n), both in x's dtype.
    Returns ``(g_x (B, gx_w) in x's dtype, g_coeffs (L, n//2, 4))`` then
    ``g_din``, ``g_dout``, ``g_bias`` (n,) for the operands present, all
    f32.  ``gx_w`` is ``bwd_live_tiles``'s: in_width, widened when it would
    leave visited tiles past its edge.  ``dead_from`` declares gy exactly
    zero from that column on (an upstream run of a multi-run plan).

    Int8 modes, as K1's: ``x_scale`` marks a saved int8 x (its
    (``scale_rows``, ``n_tile``) blocks dequantized on load, so the remat
    replays the quantized forward; gy and g_x are then f32 or bf16), and
    ``coeff_scale`` an int8 table; g_coeffs is the grad of the
    dequantized table.

    Windowed mode (``col_base``, a base feature tile, as K1's): with
    ``in_width`` x is the global (B, in_width) operand read through the
    window, with ``out_width`` gy the global (B, out_width) one, each zero
    past its global width; g_x is the full (B, n) slab and every tile is
    visited (no ``dead_from``).  No int8 x."""
    n = 2 * coeffs.shape[1]
    strides = tuple(int(s) for s in strides)
    in_w = n if in_width is None else int(in_width)
    gy_w = n if out_width is None else int(out_width)
    if x.dim() != 2 or x.shape[1] != in_w or gy.dim() != 2 \
            or gy.shape != (x.shape[0], gy_w):
        raise ValueError(f"expected x (B, {in_w}) and gy (B, {gy_w}), got "
                         f"{tuple(x.shape)} and {tuple(gy.shape)}")
    cap = max(in_w, gy_w) if col_base is not None else n
    if coeffs.shape[0] != len(strides) or n % n_tile or not (
            0 < in_w <= cap and 0 < gy_w <= cap):
        raise ValueError(f"bad run: n={n} n_tile={n_tile} "
                         f"L={coeffs.shape[0]} strides={strides} "
                         f"in={in_w} out={gy_w}")
    for s in strides:
        if n_tile % (2 * s):
            raise ValueError(f"stride {s} crosses an {n_tile}-wide tile")
    _check_quant_args(x, coeffs, x_scale, coeff_scale, scale_rows)
    _check_window(col_base, in_width, out_width, x_scale is not None)
    if col_base is not None and dead_from is not None:
        raise ValueError("the windowed mode visits every tile: no dead_from")
    kw = dict(strides=strides, n_tile=n_tile, has_bias=has_bias,
              in_width=in_width, out_width=out_width, dead_from=dead_from,
              scale_rows=scale_rows, col_base=col_base)
    if x.device.type == "cpu":
        return spm_stack_bwd_plain(x, coeffs, gy, d_in, d_out, x_scale,
                                   coeff_scale, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_cuda_operands(x, [(coeffs, "coeffs", coeff_scale)],
                         [(d_in, "d_in"), (d_out, "d_out")], n, x_scale,
                         n_tile, scale_rows)
    io_dt = x.dtype if x_scale is None else gy.dtype
    if io_dt not in _IO or gy.dtype != io_dt or gy.device != x.device \
            or not gy.is_contiguous():
        raise ValueError("gy must be contiguous, on x's device, in x's "
                         "dtype (f32 or bf16 beside an int8 x)")
    if col_base is None:
        vis, gx_w = bwd_live_tiles(n, n_tile, in_width, out_width,
                                   dead_from)
        x_off = gy_off = 0
    else:
        vis, gx_w = n // n_tile, n
        x_off = int(col_base) * n_tile if in_width is not None else 0
        gy_off = int(col_base) * n_tile if out_width is not None else 0
    B, L = x.shape[0], len(strides)
    dev = x.device
    gx = torch.empty((B, gx_w), dtype=io_dt, device=dev)
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
                 (_I,) + (_P,) * 13 + (_I,) * 13
                 + (ctypes.POINTER(ctypes.c_int), _I, _P))
        rc = fn(_IO[io_dt], _ptr(x), _ptr(x_scale), _ptr(gy), _ptr(gx),
                _ptr(coeffs), _ptr(coeff_scale), _ptr(d_in), _ptr(d_out),
                _ptr(g_cf), _ptr(g_vec), _ptr(part_cf), _ptr(part_vec),
                _ptr(scratch), B, n, n_tile, in_w, gy_w, gx_w, x_off,
                gy_off, vis, cr, G, int(has_bias), scale_rows or 0,
                _strides_arg(strides), L, _stream(x))
        if rc != 0:
            raise RuntimeError(f"spm_stack_bwd launch failed: cudaError {rc}")
        _count(spm_stack_bwd_kernel_call, x_scale, coeff_scale,
               col_base is not None)
    out = (gx, g_cf)
    for present, row in ((d_in is not None, 0), (d_out is not None, 1),
                         (has_bias, 2)):
        if present:
            out += (g_vec[row],)
    return out


spm_stack_bwd_kernel_call.launches = 0
spm_stack_bwd_kernel_call.int8_launches = 0
spm_stack_bwd_kernel_call.int8_io_launches = 0
spm_stack_bwd_kernel_call.window_launches = 0


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


# ---------------------------------------------------------------------------
# K5 / K6: a {local run -> cross stage} pair of the sharded executor
# ---------------------------------------------------------------------------
#
# One launch covers every shard of a feature mesh on one device.  The
# operands are global: x (B, in_w) with shard j's lanes at columns
# j * n_local + c (zero from in_w on: the windowed read of a rectangular
# first run is the same read), the stacked local tables (S, L, n_local/2,
# 4), and (n,) vectors whose slice j is shard j's.  Shard j pairs with
# shard j ^ k; the role (low: j & k == 0) is resolved in the vectors the
# caller passes, so the kernels are role-free.


def _check_pair(x, coeffs, coeff_scale, vecs, strides, n_tile, k,
                in_width):
    """Shapes of a pair call, on any device: returns ``(S, n_local, n,
    in_w)``."""
    if coeffs.dim() != 4 or coeffs.shape[3] != 4:
        raise ValueError(f"coeffs: need (S, L, n_local/2, 4), got "
                         f"{tuple(coeffs.shape)}")
    S, L = coeffs.shape[:2]
    nl = 2 * coeffs.shape[2]
    n = S * nl
    in_w = n if in_width is None else int(in_width)
    if S < 2 or S & (S - 1) or k <= 0 or k & (k - 1) or S % (2 * k):
        raise ValueError(f"{S} shards cannot pair over k={k}")
    if L != len(strides) or nl % n_tile or not 0 < in_w <= n:
        raise ValueError(f"bad pair: S={S} n_local={nl} n_tile={n_tile} "
                         f"L={L} strides={strides} in={in_w}")
    for st in strides:
        if n_tile % (2 * st):
            raise ValueError(f"stride {st} crosses an {n_tile}-wide tile")
    if x.dim() != 2 or x.shape[1] != in_w:
        raise ValueError(f"expected x (B, {in_w}), got {tuple(x.shape)}")
    if (coeff_scale is not None) != (coeffs.dtype == torch.int8):
        raise TypeError("int8 coeffs and coeff_scale go together")
    if coeff_scale is not None and coeff_scale.shape != (S, L):
        raise ValueError(f"coeff_scale: need ({S}, {L}), got "
                         f"{tuple(coeff_scale.shape)}")
    for v, name in vecs:
        if v is not None and v.shape != (n,):
            raise ValueError(f"{name}: need ({n},), got {tuple(v.shape)}")
    return S, nl, n, in_w


def _pair_tables(coeffs, coeff_scale) -> torch.Tensor:
    """The stacked local tables in f32, int8 ones dequantized per shard and
    stage as the kernels dequantize them on load."""
    if coeff_scale is None:
        return coeffs.float()
    S, L = coeffs.shape[:2]
    return Q.dequantize_coeffs(coeffs.reshape(S * L, *coeffs.shape[2:]),
                               coeff_scale.reshape(S * L)
                               ).reshape(coeffs.shape)


def _check_pair_cuda(x, coeffs, coeff_scale, vecs) -> None:
    """The kernels' operand rules on the card: contiguous f32 or bf16 x,
    contiguous aligned tables and scales, contiguous f32 vectors."""
    if x.dtype not in _IO or not x.is_contiguous():
        raise TypeError(f"kernel I/O must be contiguous f32 or bf16, got "
                        f"{x.dtype}")
    if not coeffs.is_contiguous() or (coeff_scale is not None
                                      and not coeff_scale.is_contiguous()):
        raise ValueError("coeffs and coeff_scale must be contiguous")
    _check_coeffs(coeffs[0], 2 * coeffs.shape[2], x.device, "coeffs",
                  None if coeff_scale is None else coeff_scale[0])
    for v, name in vecs:
        _check_vec(v, coeffs.shape[0] * 2 * coeffs.shape[2], x.device, name)


def _kbit(k: int) -> int:
    return k.bit_length() - 1


def spm_overlap_plain(x: torch.Tensor, coeffs: torch.Tensor,
                      mix_a: torch.Tensor, mix_b: torch.Tensor,
                      d_in: Optional[torch.Tensor] = None,
                      d_out: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None,
                      coeff_scale: Optional[torch.Tensor] = None, *,
                      strides: Tuple[int, ...], n_tile: int, k: int,
                      in_width: Optional[int] = None) -> torch.Tensor:
    """K5's plain version over every shard, rounding where the kernel
    rounds: shard j's local run in f32 from its lanes of x (zero from
    ``in_width`` on) [times d_in], rounded to x's dtype (the slab a shard
    sends), then ``y = mix_a * z_j + mix_b * z_(j^k)`` in f32, ``* d_out``
    after the add, ``+ bias``, one rounding on the store."""
    S, nl, n, _ = _check_pair(x, coeffs, coeff_scale,
                              [(mix_a, "mix_a"), (mix_b, "mix_b"),
                               (d_in, "d_in"), (d_out, "d_out"),
                               (bias, "bias")], strides, n_tile, k, in_width)
    cf = _pair_tables(coeffs, coeff_scale)
    xf = F.pad(x.float(), (0, n - x.shape[1]))
    sent = []
    for j in range(S):
        z = xf[:, j * nl:(j + 1) * nl]
        if d_in is not None:
            z = z * d_in[j * nl:(j + 1) * nl].float()
        sent.append(spm_stack_ref(z, cf[j], tuple(strides)
                                  ).to(x.dtype).float())
    ys = []
    for j in range(S):
        sl = slice(j * nl, (j + 1) * nl)
        y = mix_a[sl].float() * sent[j] + mix_b[sl].float() * sent[j ^ k]
        if d_out is not None:
            y = y * d_out[sl].float()
        if bias is not None:
            y = y + bias[sl].float()
        ys.append(y)
    return torch.cat(ys, dim=-1).to(x.dtype)


def spm_overlap_kernel_call(x: torch.Tensor, coeffs: torch.Tensor,
                            mix_a: torch.Tensor, mix_b: torch.Tensor,
                            d_in: Optional[torch.Tensor] = None,
                            d_out: Optional[torch.Tensor] = None,
                            bias: Optional[torch.Tensor] = None,
                            coeff_scale: Optional[torch.Tensor] = None, *,
                            strides: Tuple[int, ...], n_tile: int, k: int,
                            in_width: Optional[int] = None) -> torch.Tensor:
    """K5: x (B, in_width or n) -> y (B, n) in x's dtype, for the stacked
    local tables coeffs (S, L, n_local/2, 4) f32 (or int8 with
    ``coeff_scale`` (S, L) f32) whose strides keep pairs inside an
    ``n_tile``-wide tile.  Shard j's local run reads its lanes of x,
    columns ``j * n_local + c``, zero from ``in_width`` on (the windowed
    read of a rectangular first run), folds d_in, and is mixed with shard
    ``j ^ k``'s: ``y = mix_a * z + mix_b * z_partner`` (the role-resolved
    cross coefficients), then ``* d_out`` and ``+ bias`` when the schedule
    ends on this cross stage.  Vectors are (n,) f32."""
    strides = tuple(int(st) for st in strides)
    S, nl, n, in_w = _check_pair(
        x, coeffs, coeff_scale, [(mix_a, "mix_a"), (mix_b, "mix_b"),
                                 (d_in, "d_in"), (d_out, "d_out"),
                                 (bias, "bias")], strides, n_tile, k,
        in_width)
    if x.device.type == "cpu":
        return spm_overlap_plain(x, coeffs, mix_a, mix_b, d_in, d_out, bias,
                                 coeff_scale, strides=strides, n_tile=n_tile,
                                 k=k, in_width=in_width)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    vecs = [(mix_a, "mix_a"), (mix_b, "mix_b"), (d_in, "d_in"),
            (d_out, "d_out"), (bias, "bias")]
    _check_pair_cuda(x, coeffs, coeff_scale, vecs)
    B = x.shape[0]
    y = torch.empty((B, n), dtype=x.dtype, device=x.device)
    if B == 0:
        return y
    tiles = nl // n_tile
    per_row = n_tile * (4 + x.element_size())     # f32 tile + send slot
    block_rows = pick_block_rows(B, n_tile, S * tiles)
    while block_rows > 1 and block_rows * per_row > SMEM_BYTES:
        block_rows //= 2
    if block_rows * per_row > SMEM_BYTES:
        raise ValueError(f"a {n_tile}-wide tile and its send slot exceed "
                         f"{SMEM_BYTES} B of shared memory")
    fn = _fn("spm_overlap", "spm_overlap_fwd",
             (_I,) + (_P,) * 9 + (_I,) * 7
             + (ctypes.POINTER(ctypes.c_int), _I, _P))
    rc = fn(_IO[x.dtype], _ptr(x), _ptr(y), _ptr(coeffs), _ptr(coeff_scale),
            _ptr(mix_a), _ptr(mix_b), _ptr(d_in), _ptr(d_out), _ptr(bias),
            B, S, nl, n_tile, in_w, _kbit(k), block_rows,
            _strides_arg(strides), len(strides), _stream(x))
    if rc != 0:
        raise RuntimeError(f"spm_overlap_fwd launch failed: cudaError {rc}")
    _count(spm_overlap_kernel_call, None, coeff_scale,
           in_width is not None)
    return y


spm_overlap_kernel_call.launches = 0
spm_overlap_kernel_call.int8_launches = 0
spm_overlap_kernel_call.window_launches = 0


def spm_overlap_bwd_plain(x: torch.Tensor, coeffs: torch.Tensor,
                          gy: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                          d_in: Optional[torch.Tensor] = None,
                          d_out: Optional[torch.Tensor] = None,
                          coeff_scale: Optional[torch.Tensor] = None, *,
                          strides: Tuple[int, ...], n_tile: int, k: int,
                          in_width: Optional[int] = None,
                          col_sum=_col_sum) -> tuple:
    """K6's plain version over every shard, rounding where the kernel
    rounds: each shard's package is its cotangent ``gy [* d_out]`` and its
    rematted run output ``z_out``, both rounded to gy's dtype; ``s_own =
    sum delta * z_out`` and ``s_swp = sum delta * z_partner`` over the
    packages, ``t_own``/``t_swp`` the same over the raw gy (with d_out);
    the transpose mix ``u * delta + v * delta_partner`` in f32 enters the
    reverse walk over the f32 remat.  Only the sums over rows differ from
    the kernel's, in order."""
    S, nl, n, _ = _check_pair(x, coeffs, coeff_scale,
                              [(u, "u"), (v, "v"), (d_in, "d_in"),
                               (d_out, "d_out")], strides, n_tile, k,
                              in_width)
    if gy.shape != (x.shape[0], n):
        raise ValueError(f"expected gy ({x.shape[0]}, {n}), got "
                         f"{tuple(gy.shape)}")
    strides = tuple(strides)
    io = gy.dtype
    cf = _pair_tables(coeffs, coeff_scale)
    xf = F.pad(x.float(), (0, n - x.shape[1]))
    gyf = gy.float()
    sls = [slice(j * nl, (j + 1) * nl) for j in range(S)]
    x_raw, zs, pk_d, pk_z = [], [], [], []
    for j, sl in enumerate(sls):
        x_raw.append(xf[:, sl])
        z0 = x_raw[j] * d_in[sl].float() if d_in is not None else x_raw[j]
        z, zj = stages_collect(z0, cf[j], strides)
        zs.append(zj)
        d = gyf[:, sl] * d_out[sl].float() if d_out is not None \
            else gyf[:, sl]
        pk_d.append(d.to(io).float())
        pk_z.append(z.to(io).float())
    gx, g_cf, outs = [], [], {k_: [] for k_ in
                              ("s_own", "s_swp", "g_din", "t_own", "t_swp")}
    for j, sl in enumerate(sls):
        p = j ^ k
        outs["s_own"].append(col_sum(pk_d[j] * pk_z[j]))
        outs["s_swp"].append(col_sum(pk_d[j] * pk_z[p]))
        if d_out is not None:
            outs["t_own"].append(col_sum(gyf[:, sl] * pk_z[j]))
            outs["t_swp"].append(col_sum(gyf[:, sl] * pk_z[p]))
        dmid = u[sl].float() * pk_d[j] + v[sl].float() * pk_d[p]
        d0, gc = walk_back(zs[j], dmid, cf[j], strides, col_sum)
        g_cf.append(gc)
        if d_in is not None:
            outs["g_din"].append(col_sum(d0 * x_raw[j]))
            d0 = d0 * d_in[sl].float()
        gx.append(d0)
    res = (torch.cat(gx, dim=-1).to(io), torch.stack(g_cf, dim=0),
           torch.cat(outs["s_own"]), torch.cat(outs["s_swp"]))
    if d_in is not None:
        res += (torch.cat(outs["g_din"]),)
    if d_out is not None:
        res += (torch.cat(outs["t_own"]), torch.cat(outs["t_swp"]))
    return res


def spm_overlap_bwd_kernel_call(x: torch.Tensor, coeffs: torch.Tensor,
                                gy: torch.Tensor, u: torch.Tensor,
                                v: torch.Tensor,
                                d_in: Optional[torch.Tensor] = None,
                                d_out: Optional[torch.Tensor] = None,
                                coeff_scale: Optional[torch.Tensor] = None,
                                *, strides: Tuple[int, ...], n_tile: int,
                                k: int, in_width: Optional[int] = None
                                ) -> tuple:
    """K6: the backward of one K5 pair from the local run's input x (B,
    in_width or n, as K5 reads it) and the cotangent gy (B, n) of K5's
    output, in x's dtype.  ``u``/``v`` (n,) are the role-resolved
    transpose mix (``delta_mid = u * delta + v * delta_partner``).  With
    ``d_out`` (the pair ends the schedule) each shard's sent cotangent is
    ``gy * d_out``.  Returns ``(g_x (B, n) in x's dtype, g_coeffs (S, L,
    n_local/2, 4), s_own (n,), s_swp (n,)[, g_din (n,)][, t_own (n,),
    t_swp (n,)])``, all grads f32: ``s_own = sum delta * z_out``, ``s_swp
    = sum delta * z_partner`` (the caller places them by role), ``t_own``/
    ``t_swp`` the same sums over the raw gy, for ``g_dout = mix_a * t_own
    + mix_b * t_swp``."""
    strides = tuple(int(st) for st in strides)
    vecs = [(u, "u"), (v, "v"), (d_in, "d_in"), (d_out, "d_out")]
    S, nl, n, in_w = _check_pair(x, coeffs, coeff_scale, vecs, strides,
                                 n_tile, k, in_width)
    if gy.shape != (x.shape[0], n):
        raise ValueError(f"expected gy ({x.shape[0]}, {n}), got "
                         f"{tuple(gy.shape)}")
    if x.device.type == "cpu":
        return spm_overlap_bwd_plain(x, coeffs, gy, u, v, d_in, d_out,
                                     coeff_scale, strides=strides,
                                     n_tile=n_tile, k=k, in_width=in_width)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_pair_cuda(x, coeffs, coeff_scale, vecs)
    if gy.dtype != x.dtype or gy.device != x.device \
            or not gy.is_contiguous():
        raise ValueError("gy must be contiguous, on x's device, in x's "
                         "dtype")
    B, L = x.shape[0], len(strides)
    dev = x.device
    tiles = nl // n_tile
    gx = torch.empty((B, n), dtype=x.dtype, device=dev)
    g_cf = torch.empty((S, L, nl // 2, 4), dtype=torch.float32, device=dev)
    g_vec = torch.empty((5, n), dtype=torch.float32, device=dev)
    if B == 0:
        for t in (gx, g_cf, g_vec):
            t.zero_()
    else:
        # the package (the cotangent and z_out in x's dtype) rides beside
        # the L+1 remat tiles, as floats per row
        pkg = -(-2 * n_tile * x.element_size() // 4)
        cr, G, in_shared = bwd_geometry(B, n_tile, L + 1, S * tiles,
                                        extra=pkg)
        if not in_shared and cr * pkg * 4 > SMEM_BYTES:
            raise ValueError(f"a {n_tile}-wide package exceeds {SMEM_BYTES}"
                             f" B of shared memory")
        part_cf = torch.empty((G, S, L, nl // 2, 4), dtype=torch.float32,
                              device=dev)
        part_vec = torch.empty((G, 5, n), dtype=torch.float32, device=dev)
        scratch = None if in_shared else torch.empty(
            (S * tiles * G * (L + 1) * cr * n_tile,), dtype=torch.float32,
            device=dev)
        fn = _fn("spm_overlap_bwd", "spm_overlap_bwd",
                 (_I,) + (_P,) * 14 + (_I,) * 8
                 + (ctypes.POINTER(ctypes.c_int), _I, _P))
        rc = fn(_IO[x.dtype], _ptr(x), _ptr(gy), _ptr(gx), _ptr(coeffs),
                _ptr(coeff_scale), _ptr(u), _ptr(v), _ptr(d_in),
                _ptr(d_out), _ptr(g_cf), _ptr(g_vec), _ptr(part_cf),
                _ptr(part_vec), _ptr(scratch), B, S, nl, n_tile, in_w,
                _kbit(k), cr, G, _strides_arg(strides), L, _stream(x))
        if rc != 0:
            raise RuntimeError(f"spm_overlap_bwd launch failed: cudaError "
                               f"{rc}")
        _count(spm_overlap_bwd_kernel_call, None, coeff_scale,
               in_width is not None)
    res = (gx, g_cf, g_vec[0], g_vec[1])
    if d_in is not None:
        res += (g_vec[4],)
    if d_out is not None:
        res += (g_vec[2], g_vec[3])
    return res


spm_overlap_bwd_kernel_call.launches = 0
spm_overlap_bwd_kernel_call.int8_launches = 0
spm_overlap_bwd_kernel_call.window_launches = 0


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch counts to 0."""
    for fn in (spm_stack_kernel_call, spm_stack_bwd_kernel_call,
               spm_block_kernel_call, spm_block_bwd_kernel_call,
               spm_overlap_kernel_call, spm_overlap_bwd_kernel_call):
        for name in ("launches", "int8_launches", "int8_io_launches",
                     "window_launches"):
            if hasattr(fn, name):
                setattr(fn, name, 0)
