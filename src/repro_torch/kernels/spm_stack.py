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

Each does a few flops per element and stage against 2-4 bytes of I/O per
element, so its bound on an H100 is mostly the bytes moved over 3.35 TB/s;
what holds them above it is the stage walk on chip.  The sources say what
each design does about it.  K2, K4 and K6 run on one backward engine
(``csrc/spm_bwd_engine.cuh``) whose launch shape the pure-Python planner
``bwd_plan`` chooses (its mirrors of the engine's stage modes, passes and
slot maps are checked on the CPU; K4 through its block form, with a second
stack and the norm's row statistics).  K1, K3 and K5 run on one forward
engine (``csrc/spm_fwd_engine.cuh``) whose launch shape ``fwd_plan``
chooses (its mirrors of the engine's passes, groups and row chunks are
checked on the CPU, with a float32 emulation of the walk; K3 through its
block form).

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
``int8_launches`` those with an int8 table.  K2's ``split_launches``
count those in its split mode (a lone stage wider than one cluster).

K1 and K2 have an expert mode (the reference's ``jax.vmap`` of a run over
the MoE expert axis, which adds a grid axis to the Pallas call): with an
(E, L, n/2, 4) table, x (E, B, width) and (E, n) vectors, one launch runs
the same run of all E experts, each over its own B rows (the plan is one
expert's), and K2 sums each expert's grads over its rows only.  Their
``expert_launches`` count those launches (``launches`` counts them too);
the plain versions loop over the experts.  The int8 and windowed modes
take no expert axis: they raise (``ROADMAP.md`` §1).

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
from typing import List, NamedTuple, Optional, Sequence, Tuple

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
           "bwd_live_tiles", "BwdPlan", "bwd_plan", "bwd_smem_bytes",
           "bwd_block_smem_bytes", "bwd_slot_pairs", "bwd_split_pairs",
           "bwd_stage_modes", "bwd_passes", "bwd_quad_lanes",
           "bwd_row_slices",
           "bwd_row_chunks", "bwd_clusters_resident", "FwdPlan",
           "fwd_plan", "fwd_passes", "fwd_group_lanes", "fwd_smem_bytes",
           "fwd_row_chunks", "fwd_clusters_resident",
           "reset_launch_counts", "SMEM_BYTES", "NUM_SMS", "ACTIVATIONS"]

SMEM_BYTES = 232_448   # H100: dynamic shared memory one block may use
NUM_SMS = 132          # H100 SXM streaming multiprocessors
MAX_STAGES = 32        # csrc/spm_common.cuh SPM_MAX_STAGES
_IO = {torch.float32: 0, torch.bfloat16: 1}
_IO_INT8 = 2           # csrc/spm_common.cuh SPM_IO_INT8
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


def _shape_args(plan) -> tuple:
    """A ``BwdPlan``'s launch shape as the backward kernels take it."""
    return (plan.lane_blocks, plan.lanes, plan.pair_slots, plan.row_slices,
            plan.chunk_rows, plan.groups)


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


_EXPERT_LATER = ("the expert mode of K1 and K2 takes no int8 operands and "
                 "no window (ROADMAP.md §1: int8 and feature sharding in "
                 "the expert mode)")


def _expert_check(x, coeffs, vecs, strides, n_tile, in_w, out_w, int8,
                  window) -> None:
    """The expert mode's operands on any device: x (E, B, in_w), an
    (E, L, n/2, 4) table, (E, n) vectors; no int8 operand, no window."""
    if int8 or window:
        raise NotImplementedError(_EXPERT_LATER)
    E, L, half = coeffs.shape[:3]
    n = 2 * half
    if x.dim() != 3 or x.shape[0] != E or x.shape[2] != in_w:
        raise ValueError(f"expected x ({E}, B, {in_w}), got "
                         f"{tuple(x.shape)}")
    if L != len(strides) or n % n_tile or not (0 < in_w <= n
                                               and 0 < out_w <= n):
        raise ValueError(f"bad run: n={n} n_tile={n_tile} L={L} "
                         f"strides={strides} in={in_w} out={out_w}")
    for s in strides:
        if n_tile % (2 * s):
            raise ValueError(f"stride {s} crosses an {n_tile}-wide tile")
    for v, name in vecs:
        if v is not None and tuple(v.shape) != (E, n):
            raise ValueError(f"{name}: need ({E}, {n}), got "
                             f"{tuple(v.shape)}")


def _expert_cuda_check(x, coeffs, vecs) -> int:
    """The expert mode's operands on the card; returns the pairs from one
    expert's table to the next's (a run's stages may be a view of a longer
    table: only each expert's own (L, n/2, 4) block must be dense)."""
    E, L, half, _ = coeffs.shape
    dev = x.device
    if x.dtype not in _IO or not x.is_contiguous():
        raise ValueError("expert x must be contiguous f32 or bf16")
    if (coeffs.dtype != torch.float32 or coeffs.device != dev
            or coeffs.stride()[1:] != (half * 4, 4, 1)
            or coeffs.stride(0) % 4 or coeffs.stride(0) < L * half * 4
            or coeffs.data_ptr() % 16):
        raise ValueError(f"coeffs: need an f32 (E, L, {half}, 4) table on "
                         f"{dev}, each expert's (L, {half}, 4) block dense")
    if L > MAX_STAGES:
        raise ValueError(f"coeffs: at most {MAX_STAGES} stages")
    for v, name in vecs:
        if v is not None and (v.dtype != torch.float32 or v.device != dev
                              or not v.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous f32 (E, n) tensor "
                             f"on {dev}")
    return coeffs.stride(0) // 4


def _at(t: Optional[torch.Tensor], e: int) -> Optional[torch.Tensor]:
    return None if t is None else t[e]


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
    absmax taken over the whole tile, lanes past ``out_width`` included.

    An (E, L, n/2, 4) table is the expert mode: x (E, B, width) and (E, n)
    vectors, one expert at a time, stacked."""
    if coeffs.dim() == 4:
        return torch.stack([spm_stack_plain(
            x[e], coeffs[e], _at(d_in, e), _at(d_out, e), _at(bias, e),
            strides=strides, in_width=in_width, out_width=out_width,
            n_tile=n_tile) for e in range(coeffs.shape[0])])
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


# ---------------------------------------------------------------------------
# the forward engine's launch shape (K1, K5)
# ---------------------------------------------------------------------------

FWD_MAX_FUSE = 3        # csrc/spm_fwd_engine.cuh kMaxFuse: stages a pass fuses
FWD_MAX_THREADS = 256   # its __launch_bounds__
FWD_MAX_ROWS = 64       # rows a chunk, at most
FWD_DECODE_ROWS = 16    # calls of at most this many rows: a row a group
FWD_DECODE_BLOCKS = 8   # blocks a decode call spreads its rows and lanes over
FWD_DECODE_LANES = 2048  # lanes a decode block holds, at most
FWD_MIN_LANES = 128     # lanes a block keeps when a tile's lanes are split
FWD_MIN_RES_ROWS = 12   # rows a chunk a resident table must leave room for
_FWD_Q8_STATIC = 34 * 4  # the int8 kernel's static shared memory


class FwdPlan(NamedTuple):
    """The launch shape of a K1 or K5 forward (``fwd_plan``)."""
    lane_blocks: int   # C: blocks splitting a tile's lanes (decode rows)
    lanes: int         # w = n_tile / C, lanes a block owns
    row_blocks: int    # Cr: blocks sharing an int8 scale block's rows
    threads: int       # T
    chunk_rows: int    # R: rows a block walks through the passes at once
    groups: int        # G: row groups (clusters) a tile
    cluster: int       # blocks a cluster: C * Cr * sides
    resident: bool     # the tile's table kept in shared memory
    passes: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def fwd_passes(n_tile: int, lane_blocks: int, strides: Tuple[int, ...]
               ) -> Optional[Tuple[Tuple[int, int, bool], ...]]:
    """The forward engine's passes (``csrc/spm_fwd_engine.cuh``
    ``plan_passes``): ``(first stage, stages, across lane blocks)``.  The
    stages local to the w = n_tile / C lanes of a block (w % 2s == 0) fuse
    greedily, up to ``FWD_MAX_FUSE`` consecutive strides that ascend and
    nest (each a multiple of twice the one before); the stages after the
    first one that is not local must form one such group, the last pass,
    run across the lane blocks.  None when the lanes cannot be split so."""
    C, L = lane_blocks, len(strides)
    w = n_tile // C
    e = 0
    while e < L and w % (2 * strides[e]) == 0:
        e += 1
    if e < L:
        if C == 1 or e == 0 or L - e > FWD_MAX_FUSE \
                or any(strides[k] % (2 * strides[k - 1])
                       for k in range(e + 1, L)) \
                or (n_tile >> (L - e)) % C:
            return None
    out, l = [], 0
    while l < L:
        end = e if l < e else L
        n = 1
        while n < FWD_MAX_FUSE and l + n < end \
                and strides[l + n] % (2 * strides[l + n - 1]) == 0:
            n += 1
        out.append((l, n, l >= e))
        l += n
    return tuple(out)


def fwd_group_lanes(n_tile: int, lane_blocks: int, strides: Sequence[int],
                    first: int, count: int, cross: bool
                    ) -> List[List[Tuple[int, ...]]]:
    """The groups of a pass (``csrc/spm_fwd_engine.cuh`` ``group_base``):
    ``[c][u]`` -> the 2^count tile lanes of block c's group u, lane j at
    m0 + (sum of the strides of j's set bits), stage ``first + k`` pairing
    lanes j and j + 2^k.  Group u's base m0 has u's digits in the radices
    s_0, s_1 / 2 s_0, s_2 / 2 s_1, ... of the pass's strides.  A local
    pass's groups are block c's lanes [c w, (c+1) w); a cross pass's are
    the tile's, block c taking the c-th share."""
    C = lane_blocks
    w = n_tile // C
    ss = strides[first:first + count]

    def base(u):
        q, m0 = u, 0
        for k, s in enumerate(ss):
            q, a = divmod(q, s if k == 0 else s // (2 * ss[k - 1]))
            m0 += a if k == 0 else 2 * ss[k - 1] * a
        return m0 + 2 * ss[-1] * q

    offs = [sum(s for k, s in enumerate(ss) if j >> k & 1)
            for j in range(1 << count)]
    out = []
    for c in range(C):
        if cross:
            per = (n_tile >> count) // C
            us, lane0 = range(c * per, (c + 1) * per), 0
        else:
            us, lane0 = range(w >> count), c * w
        out.append([tuple(lane0 + base(u) + o for o in offs) for u in us])
    return out


def fwd_smem_bytes(n_stages: int, lanes: int, rows: int,
                   x_bytes: int, resident: bool, tile: bool,
                   slot_bytes: int = 0, cf_bytes: int = 16,
                   stats: bool = False) -> int:
    """Shared memory of one block of the forward engine
    (``csrc/spm_fwd_engine.cuh`` ``layout``): the resident table
    (``n_stages`` x ``lanes``/2 entries of ``cf_bytes``: 16 f32, 4 int8),
    the f32 tile of ``rows`` x ``lanes`` (``tile``: more than one pass, an
    int8 store, or K3's second stack), x staged once in its own type, K5's
    two send slots, and K3's rstd a row (``stats``).  (The plan of stages
    and passes is a kernel parameter.)"""
    L, w, R = n_stages, lanes, rows
    b = 0
    if resident:
        b += _align16(L * (w // 2) * cf_bytes)
    if tile:
        b += _align16(R * w * 4)
    b += _align16(R * w * x_bytes) + 2 * _align16(R * w * slot_bytes)
    if stats:
        b += _align16(R * 4)
    return b


def _fwd_threads(n_tile: int, C: int, passes, R: int) -> int:
    """Threads a block: enough for every group of the widest pass to walk
    each of its rows at once, a whole number of warps, 32 to
    ``FWD_MAX_THREADS``."""
    most = max(((n_tile >> n) // C if cross else (n_tile // C) >> n)
               for _, n, cross in passes)
    return max(32, min(FWD_MAX_THREADS, -(-most * R // 32) * 32))


def _fwd_clusters(T: int, smem: int, cluster: int) -> int:
    """Clusters of ``cluster`` blocks the card holds at once, estimated:
    blocks an SM by registers (128 a thread, or more: one block of
    ``FWD_MAX_THREADS``), shared memory and threads,
    times the clusters of one block an SM that the GPCs hold
    (``CLUSTERS_RESIDENT``)."""
    per_sm = max(1, min(65536 // (T * 128), 233472 // (smem + 1024),
                        2048 // T))
    return CLUSTERS_RESIDENT.get(cluster, NUM_SMS // cluster) * per_sm


@functools.lru_cache(maxsize=None)
def fwd_plan(n_rows: int, n_tile: int, strides: Tuple[int, ...], tiles: int,
             io_bytes: int, x_bytes: Optional[int] = None,
             scale_rows: Optional[int] = None, sides: int = 1,
             cf_bytes: int = 16, block: bool = False,
             strides2: Optional[Tuple[int, ...]] = None,
             norm: bool = False) -> FwdPlan:
    """The forward engine's launch shape for ``n_rows`` rows of ``tiles``
    independent ``n_tile``-wide feature tiles (K5: partner pairs times
    shard tiles, ``sides`` = 2 for its two-block clusters and send slots)
    of a run of ``strides``, I/O of ``io_bytes`` a value, x of ``x_bytes``
    and a table of ``cf_bytes`` a pair (16 f32, 4 int8).

    * Decode rows (at most ``FWD_DECODE_ROWS``): a row a group, and for f32
      / bf16 K1 the fewest lane blocks C (1 to 8, ``FWD_MIN_LANES`` lanes a
      block or more, a split ``fwd_passes`` allows) that give
      ``FWD_DECODE_BLOCKS`` blocks of at most ``FWD_DECODE_LANES`` lanes,
      else the most: a one-row call's table reads spread over C SMs.  Each
      block copies its share of the local stages' table into shared
      memory at once (one latency, not one a pass); a cross pass reads its
      pairs from L2.
    * Int8 activations (``scale_rows``): a chunk is one scale block, its
      rows over Cr row blocks (1, 2, 4, 8), Cr the one whose estimated
      rounds of resident clusters times (rows + 4) is least; the table
      resident when it fits and a group walks two chunks or more, or at
      decode rows.
    * Otherwise one block a tile, its table resident in shared memory when
      that leaves room for a chunk of ``FWD_MIN_RES_ROWS`` rows (or all
      rows) and a group walks two chunks or more, else read from L2 once
      a chunk (the o tile's 176 KiB table: splitting its lanes to keep it
      resident cost more in the cross pass than it saved).  Rows R: the
      most (up to ``FWD_MAX_ROWS``) that fit, then evened over the row
      groups.
    * Row groups G: one wave of resident clusters (``_fwd_clusters``) over
      the tiles, at most one a row.
    * K3's block form (``block``; ``strides`` stack 1, ``strides2`` the
      second stack or None, ``norm`` the RMS prologue): one block a tile at
      every row count (no lane split: the norm's row sum stays in a block),
      the f32 tile kept whenever there is a second stack, rstd a row beside
      it, threads for the wider of the two stacks' passes; only stack 1's
      table may be resident.  ``passes`` counts both stacks'.

    Raises when no shape holds a chunk in shared memory.  Pure and cached:
    a launch's host overhead stays a dictionary lookup."""
    x_bytes = io_bytes if x_bytes is None else x_bytes
    L = len(strides)
    q8 = scale_rows is not None
    slot = io_bytes if sides == 2 else 0
    budget = SMEM_BYTES - (_FWD_Q8_STATIC if q8 else 0)
    two = strides2 is not None
    if (two or norm) and not block:
        raise ValueError("strides2 and norm are K3's block form")
    extra = fwd_passes(n_tile, 1, tuple(strides2)) if two else ()

    def smem(C, R, res):
        ps = fwd_passes(n_tile, C, strides)
        return fwd_smem_bytes(L, n_tile // C, R, x_bytes, res,
                              len(ps) > 1 or q8 or two, slot, cf_bytes,
                              stats=norm)

    def most_rows(C, res, cap):
        R = 0
        while R < cap and smem(C, R + 1, res) <= budget:
            R += 1
        return R

    def shape(C, Cr, R, G, res):
        ps = fwd_passes(n_tile, C, strides) + extra
        return FwdPlan(C, n_tile // C, Cr, _fwd_threads(n_tile, C, ps, R), R,
                       G, C * Cr * sides, res, len(ps), smem(C, R, res))

    def too_big(what):
        return ValueError(f"{what} of a {L}-stage run on a {n_tile}-wide "
                          f"tile does not fit {budget} B of shared memory")

    if q8:
        chunks = n_rows // scale_rows
        best = None
        for Cr in (1, 2, 4, 8):
            R = scale_rows // Cr
            if scale_rows % Cr or smem(1, R, False) > budget:
                continue
            T = _fwd_threads(n_tile, 1, fwd_passes(n_tile, 1, strides), R)
            G = min(chunks, max(1, _fwd_clusters(T, smem(1, R, False), Cr)
                                // tiles))
            cost = -(-chunks // G) * (R + 4)
            if best is None or cost < best[0]:
                best = (cost, Cr, R, G)
        if best is None:
            raise too_big(f"a {scale_rows}-row scale block")
        _, Cr, R, G = best
        res = (-(-chunks // G) >= 2 or n_rows <= FWD_DECODE_ROWS) \
            and smem(1, R, True) <= budget
        return shape(1, Cr, R, G, res)

    cap = min(FWD_MAX_ROWS, n_rows)

    def split_ok(C):
        return n_tile % C == 0 and (C == 1 or n_tile // C >= FWD_MIN_LANES) \
            and fwd_passes(n_tile, C, strides) is not None

    if n_rows <= FWD_DECODE_ROWS:
        # a row a group, each tile over the fewest lane blocks that make
        # FWD_DECODE_BLOCKS blocks of at most FWD_DECODE_LANES lanes
        ok = [c for c in ((1,) if sides > 1 or block else range(1, 9))
              if split_ok(c) and smem(c, 1, False) <= budget]
        if not ok:
            raise too_big("one row")
        C = next((c for c in ok if c * n_rows >= FWD_DECODE_BLOCKS
                  and n_tile // c <= FWD_DECODE_LANES), ok[-1])
        return shape(C, 1, 1, n_rows, smem(C, 1, True) <= budget)
    C = 1
    res = most_rows(C, True, cap) >= min(FWD_MIN_RES_ROWS, n_rows)
    if fwd_passes(n_tile, C, strides) is None:
        raise ValueError(f"strides {strides} cannot split a {n_tile}-wide "
                         f"tile over {C} blocks")
    R = most_rows(C, res, cap)
    if R < 1:
        raise too_big("one row")
    T = _fwd_threads(n_tile, C, fwd_passes(n_tile, C, strides) + extra, R)
    G = min(n_rows, max(1, _fwd_clusters(T, smem(C, R, res), C * sides)
                        // tiles))
    per_group = -(-n_rows // G)
    R = -(-per_group // -(-per_group // R))
    G = min(G, -(-n_rows // R))
    if res and -(-n_rows // (R * G)) < 2:
        res = False      # one chunk a group: copying the table gains nothing
    return shape(C, 1, R, G, res)


def fwd_row_chunks(n_rows: int, plan: FwdPlan,
                   scale_rows: Optional[int] = None
                   ) -> List[Tuple[int, int, int, int]]:
    """``(group, first row, rows, row block)`` of every chunk a forward
    launch walks, in each group's order: group g takes chunks g, g + G, ...
    (the kernels' ``chunk``); with int8 activations a chunk is scale block
    g + kG, row block r taking its rows [r R, (r+1) R)."""
    out = []
    R, G = plan.chunk_rows, plan.groups
    for g in range(G):
        k = g
        while True:
            if scale_rows is None:
                r0 = k * R
                if r0 >= n_rows:
                    break
                out.append((g, r0, min(R, n_rows - r0), 0))
            else:
                if k >= n_rows // scale_rows:
                    break
                out += [(g, k * scale_rows + r * R, R, r)
                        for r in range(plan.row_blocks)]
            k += G
    return out


def fwd_clusters_resident(kernel: str, dtype, strides: Sequence[int],
                          n_tile: int, plan: FwdPlan) -> int:
    """Clusters of ``plan``'s shape the card holds at once
    (``cudaOccupancyMaxActiveClusters``) for ``kernel`` "K1" (``dtype``
    f32, bf16 or int8 activations) or "K5"; needs the card and the built
    kernels."""
    io = _IO_INT8 if dtype == torch.int8 else _IO[dtype]
    if kernel == "K1":
        fn = _fn("spm_stack", "spm_stack_fwd_clusters",
                 (_I, ctypes.POINTER(ctypes.c_int)) + (_I,) * 7)
        return int(fn(io, _strides_arg(strides), len(strides), n_tile,
                      plan.lane_blocks, plan.row_blocks, plan.threads,
                      plan.chunk_rows, int(plan.resident)))
    fn = _fn("spm_overlap", "spm_overlap_fwd_clusters",
             (_I, ctypes.POINTER(ctypes.c_int)) + (_I,) * 5)
    return int(fn(io, _strides_arg(strides), len(strides), n_tile,
                  plan.threads, plan.chunk_rows, int(plan.resident)))


def _fwd_shape_args(plan: FwdPlan) -> tuple:
    """A ``FwdPlan``'s launch shape as K1 takes it."""
    return (plan.lane_blocks, plan.row_blocks, plan.threads,
            plan.chunk_rows, plan.groups, int(plan.resident))


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
    a multiple of ``scale_rows``; each scale block is one chunk of a
    thread-block cluster.  A scale block no cluster can hold on chip
    raises.  The launch shape is ``fwd_plan``'s.

    Expert mode (an (E, L, n/2, 4) table): x (E, B, in_width) -> y (E, B,
    out_width), d_in/d_out/bias (E, n); one launch for all E experts, the
    plan that of one expert's B rows over E times its tiles.  No int8
    operand, no window."""
    strides = tuple(int(s) for s in strides)
    if coeffs.dim() == 4:
        return _stack_experts(x, coeffs, d_in, d_out, bias, strides, n_tile,
                              in_width, out_width,
                              x_scale is not None or coeff_scale is not None
                              or quant_out, col_base is not None)
    n = 2 * coeffs.shape[1]
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
    io = _IO_INT8 if quant_out else _IO[x.dtype]
    plan = fwd_plan(B, n_tile, strides, tiles, 1 if quant_out else
                    x.element_size(),
                    scale_rows=scale_rows if quant_out else None,
                    cf_bytes=16 if coeff_scale is None else 4)
    x_off = 0 if col_base is None else int(col_base) * n_tile
    rc = _k1_fn()(io, _ptr(x), _ptr(x_scale), _ptr(y), _ptr(ys),
                  _ptr(coeffs), _ptr(coeff_scale), _ptr(d_in), _ptr(d_out),
                  _ptr(bias), B, n, n_tile, in_w, out_w, x_off,
                  scale_rows or 0, *_fwd_shape_args(plan),
                  _strides_arg(strides), len(strides), 1,
                  len(strides) * (n // 2), _stream(x))
    if rc != 0:
        raise RuntimeError(f"spm_stack_fwd launch failed: cudaError {rc}")
    _count(spm_stack_kernel_call, x_scale, coeff_scale,
           col_base is not None)
    return (y, ys) if quant_out else y


def _k1_fn():
    return _fn("spm_stack", "spm_stack_fwd",
               (_I,) + (_P,) * 9 + (_I,) * 13
               + (ctypes.POINTER(ctypes.c_int), _I, _I, ctypes.c_long, _P))


def _stack_experts(x, coeffs, d_in, d_out, bias, strides, n_tile, in_width,
                   out_width, int8: bool, window: bool):
    """K1's expert mode (``spm_stack_kernel_call``)."""
    n = 2 * coeffs.shape[2]
    in_w = n if in_width is None else int(in_width)
    out_w = n if out_width is None else int(out_width)
    vecs = [(d_in, "d_in"), (d_out, "d_out"), (bias, "bias")]
    _expert_check(x, coeffs, vecs, strides, n_tile, in_w, out_w, int8,
                  window)
    if x.device.type == "cpu":
        return spm_stack_plain(x, coeffs, d_in, d_out, bias, strides=strides,
                               in_width=in_w, out_width=out_width,
                               n_tile=n_tile)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    cf_es = _expert_cuda_check(x, coeffs, vecs)
    E, B = x.shape[:2]
    y = torch.empty((E, B, out_w), dtype=x.dtype, device=x.device)
    if B == 0 or E == 0:
        return y
    tiles = -(-out_w // n_tile)
    plan = fwd_plan(B, n_tile, strides, tiles * E, x.element_size())
    rc = _k1_fn()(_IO[x.dtype], _ptr(x), None, _ptr(y), None, _ptr(coeffs),
                  None, _ptr(d_in), _ptr(d_out), _ptr(bias), B, n, n_tile,
                  in_w, out_w, 0, 0, *_fwd_shape_args(plan),
                  _strides_arg(strides), len(strides), E, cf_es, _stream(x))
    if rc != 0:
        raise RuntimeError(f"spm_stack_fwd (experts) launch failed: "
                           f"cudaError {rc}")
    _count(spm_stack_kernel_call, None, None)
    spm_stack_kernel_call.expert_launches += 1
    return y


spm_stack_kernel_call.launches = 0
spm_stack_kernel_call.int8_launches = 0
spm_stack_kernel_call.int8_io_launches = 0
spm_stack_kernel_call.window_launches = 0
spm_stack_kernel_call.expert_launches = 0


# ---------------------------------------------------------------------------
# shared by the backward kernels
# ---------------------------------------------------------------------------

def _col_sum(t: torch.Tensor) -> torch.Tensor:
    return t.sum(0)


# Clusters of C blocks, one block an SM, that an H100's GPCs hold at once
# (cudaOccupancyMaxActiveClusters at the plans' shared memory, measured on
# an H100 80GB HBM3 by chip_smoke.py): the row groups of a backward launch
# are sized to one wave of them.
CLUSTERS_RESIDENT = {1: 132, 2: 66, 4: 30, 8: 15}
BWD_MIN_ROWS = 5       # rows a chunk the planner takes more lane blocks for
BWD_MAX_THREADS = 512  # csrc/spm_bwd_engine.cuh __launch_bounds__


def _align16(b: int) -> int:
    return (b + 15) & ~15


def bwd_smem_bytes(n_stages: int, lanes: int, chunk_rows: int, nvec: int,
                   x_bytes: int, io_bytes: int, package: bool,
                   row_slices: int = 1, spare: bool = True,
                   passes: Optional[int] = None,
                   gy_bytes: Optional[int] = None) -> int:
    """Shared memory of one block of the backward engine
    (``csrc/spm_bwd_engine.cuh`` ``layout``): the table and its grad sums
    (``n_stages`` x ``lanes``/2 float4 each), two passes' grad sums of row
    slices 1 .. ``row_slices`` - 1, the stages' and passes' set-up (24 and
    28 bytes each), ``nvec`` per-lane sums, ``passes`` + 1 f32 remat tiles
    of ``chunk_rows`` x ``lanes`` (each pass's input and z_L; one more,
    ``spare``, for the cotangent to change layout into when a stage runs
    in layout B), x staged twice, gy once (``gy_bytes`` a lane: its 4-byte
    word when z_L is in layout B) and, for K6, the two-slab package."""
    L, w, R = n_stages, lanes, chunk_rows
    P = L if passes is None else passes
    gyb = io_bytes if gy_bytes is None else gy_bytes
    b = 2 * _align16(L * (w // 2) * 16)
    b += _align16(4 * (row_slices - 1) * (w // 2) * 16)
    b += _align16(L * 24) + _align16(P * 28) + _align16(nvec * w * 4)
    b += _align16((P + 1 + spare) * R * w * 4) + 2 * _align16(R * w * x_bytes)
    b += _align16(R * w * gyb)
    if package:
        b += 2 * _align16(R * w * io_bytes)
    return b


class BwdPlan(NamedTuple):
    """The launch shape of a K2 or K6 backward (``bwd_plan``)."""
    lane_blocks: int   # C: blocks splitting a feature tile's lanes
    lanes: int         # w = n_tile / C, lanes a block owns
    pair_slots: int    # w / 2 pairs a block processes in each stage
    row_slices: int    # threads share a slot's rows in this many slices
    threads: int       # pair_slots * row_slices
    chunk_rows: int    # R: rows a chunk (one walk between barriers)
    groups: int        # G: row groups, one cluster each, per tile
    cluster: int       # blocks a cluster: lane_blocks * sides
    smem_bytes: int
    streamed: int = 0  # K4: stacks whose table and grad sums stream from L2
    split: int = 0     # K2's split mode: blocks a lone stage's tile splits
                       # into (``bwd_split_pairs``), each w = 2 pair_slots
                       # lanes, no cluster; 0 otherwise


def bwd_block_smem_bytes(n_tile: int, lane_blocks: int, chunk_rows: int,
                         strides1: Sequence[int],
                         strides2: Optional[Sequence[int]], io_bytes: int,
                         norm: bool, streamed: int = 0) -> int:
    """Shared memory of one block of K4 on the backward engine
    (``csrc/spm_block_bwd.cu`` ``block_layout``): for each stack its table
    and grad sums (``n_stages`` x ``lanes``/2 float4 each; none for the
    first ``streamed`` stacks, whose tables stream from a device-memory
    slab), its stages' and passes' set-up, and its tiles (passes + 1, + 1
    with layout B); then two passes' grad sums of row slices 1 ..
    ``row_slices`` - 1, the per-lane sums (g_gamma, g_din1, g_dout1,
    g_bias1 [, g_din2, g_dout2, g_bias2]), x staged twice, gy once (its
    4-byte word when the z_L it meets is in layout B) and, with the norm,
    36 floats a row of row statistics.  Stack 1's z_L is kept in layout A
    when a second stack follows."""
    C = lane_blocks
    w, R = n_tile // C, chunk_rows
    stacks = [tuple(int(s) for s in strides1)]
    if strides2 is not None:
        stacks.append(tuple(int(s) for s in strides2))
    b = 0
    for i, ss in enumerate(stacks):
        L, P = len(ss), len(bwd_passes(n_tile, C, ss))
        if i >= streamed:
            b += 2 * _align16(L * (w // 2) * 16)
        b += _align16(L * 24) + _align16(P * 28)
        b += _align16((P + 1 + ("B" in bwd_stage_modes(n_tile, C, ss)))
                      * R * w * 4)
    rs = bwd_row_slices(w // 2)
    nvec = 7 if len(stacks) == 2 else 4
    tail_b = bwd_stage_modes(n_tile, C, stacks[-1])[-1] == "B"
    b += _align16(4 * (rs - 1) * (w // 2) * 16) + _align16(nvec * w * 4)
    b += 2 * _align16(R * w * io_bytes)
    b += _align16(R * w * (4 if tail_b else io_bytes))
    if norm:
        b += _align16(36 * R * 4)
    return b


def bwd_plan(n_rows: int, n_tile: int, strides: Sequence[int], tiles: int,
             io_bytes: int, x_bytes: Optional[int] = None, nvec: int = 3,
             package: bool = False, sides: int = 1, block: bool = False,
             strides2: Optional[Sequence[int]] = None,
             norm: bool = False) -> BwdPlan:
    """The backward engine's launch shape (``_bwd_plan``), cached: a
    launch's host overhead stays a dictionary lookup."""
    return _bwd_plan(n_rows, n_tile, tuple(int(s) for s in strides), tiles,
                     io_bytes, x_bytes, nvec, package, sides, block,
                     None if strides2 is None
                     else tuple(int(s) for s in strides2), norm)


@functools.lru_cache(maxsize=None)
def _bwd_plan(n_rows: int, n_tile: int, strides: Tuple[int, ...],
              tiles: int, io_bytes: int, x_bytes: Optional[int], nvec: int,
              package: bool, sides: int, block: bool,
              strides2: Optional[Tuple[int, ...]], norm: bool) -> BwdPlan:
    """The backward engine's launch shape for ``n_rows`` rows of ``tiles``
    independent ``n_tile``-wide feature tiles (K6: partner pairs times
    shard tiles) of a run of ``strides``, I/O of ``io_bytes`` a value
    and x of ``x_bytes``; ``sides`` = 2 doubles each cluster for K6's
    partner shards.  Lane blocks C (1, 2, 4, 8; C * sides <= 8): the
    fewest whose chunk holds ``BWD_MIN_ROWS`` rows (or all of them), else
    the C holding the most: a pass across blocks costs more than the rows
    more blocks would add.  Row groups G: one wave of resident clusters
    over the tiles, at most one a chunk, the rows then spread evenly over
    the groups' chunks.  Row slices: ``bwd_row_slices``.  Raises when no
    split holds one row's remat and the table on chip.

    K2's split mode, where no split of the lanes fits (a lone stage of
    stride s on a tile wider than 8 blocks of ``BWD_MAX_THREADS`` pair
    slots: the FFN's super-strides at n = 9216 to 25600): the tile's s
    pairs go to s / P blocks of P pairs, P the largest power of two
    dividing s up to ``BWD_MAX_THREADS``, each an independent one-block
    "cluster" walking a tile of 2P lanes (``bwd_split_pairs``); row groups
    as above over ``tiles`` times s / P of them.

    K4's block form (``block``; ``strides`` stack 1, ``strides2`` the
    second stack or None, ``norm`` the norm's row statistics; one tile,
    ``bwd_block_smem_bytes``): the same choice over lane blocks and
    ``streamed``, the stacks whose tables and grad sums stream from a
    device-memory slab (stack 1's, then both): at up to 4 blocks, the
    tables on chip, then stack 1's streamed, then both; only then 8
    blocks.  Streaming both tables over 4 blocks was measured faster than
    holding them on chip over 8 (``benchmarks/torch_block_plans.py``: the
    11 + 11-stage block on 2048 lanes), whose cross-block passes and
    8-block barriers cost more than the L2 reads.  Raises when no split
    leaves a row, or none has at most ``BWD_MAX_THREADS`` pair slots a
    block."""
    x_bytes = io_bytes if x_bytes is None else x_bytes
    L = len(strides)
    two = strides2 is not None
    if (two or norm) and not block:
        raise ValueError("strides2 and norm are K4's block form")

    def smem(w, R, streamed):
        C = n_tile // w
        if block:
            return bwd_block_smem_bytes(n_tile, C, R, strides, strides2,
                                        io_bytes, norm, streamed)
        modes = bwd_stage_modes(n_tile, C, strides)
        # K2 keeps z_L in its last pass's layout, K6 (the package) in A
        tail_b = bool(modes) and modes[-1] == "B" and not package
        return bwd_smem_bytes(L, w, R, nvec, x_bytes, io_bytes, package,
                              bwd_row_slices(w // 2), "B" in modes,
                              len(bwd_passes(n_tile, C, strides)),
                              4 if tail_b else io_bytes)

    best = None
    want = min(BWD_MIN_ROWS, n_rows)
    splits = [C for C in (1, 2, 4, 8)
              if C * sides <= 8 and n_tile % (2 * C) == 0
              and n_tile // C // 2 <= BWD_MAX_THREADS]
    levels = range(2 + two if block else 1)
    order = [(C, s) for s in levels for C in splits if C <= 4] + \
        [(C, s) for C in splits if C > 4 for s in levels]
    for C, s in order:
        w = n_tile // C
        R = 0
        while R < n_rows and smem(w, R + 1, s) <= SMEM_BYTES:
            R += 1
        if R >= want:
            best = (C, w, R, s)
            break
        if R >= 1 and (best is None or R > best[2]):
            best = (C, w, R, s)
    if best is None and L == 1 and not (block or package) and sides == 1:
        return _split_plan(n_rows, n_tile, strides[0], tiles, io_bytes,
                           x_bytes, nvec)
    if best is None:
        what = (f"K4's block of {L}" + (f" + {len(strides2)}" if two
                                        else "") + " stages"
                if block else f"the backward of a {L}-stage run")
        raise ValueError(
            f"{what} on a {n_tile}-wide tile does not fit {SMEM_BYTES} B "
            f"of shared memory in any split of its lanes over up to "
            f"{8 // sides} blocks of at most {BWD_MAX_THREADS} pair slots")
    C, w, R, streamed = best
    G, R = _groups(n_rows, R, tiles, C * sides)
    pb = w // 2
    rs = bwd_row_slices(pb)
    return BwdPlan(C, w, pb, rs, pb * rs, R, G, C * sides,
                   smem(w, R, streamed), streamed)


def _groups(n_rows: int, R: int, tiles: int, cluster: int
            ) -> Tuple[int, int]:
    """Row groups G (one wave of resident clusters of ``cluster`` blocks
    over ``tiles`` tiles, at most one a chunk) and the rows a chunk R,
    spread evenly over them."""
    chunks = -(-n_rows // R)
    G = min(chunks, max(1, CLUSTERS_RESIDENT[cluster] // max(1, tiles)))
    per_group = -(-n_rows // G)
    R = -(-per_group // -(-per_group // R))
    return min(G, -(-n_rows // R)), R


def _split_plan(n_rows: int, n_tile: int, s: int, tiles: int,
                io_bytes: int, x_bytes: int, nvec: int) -> BwdPlan:
    """K2's split mode for one stage of stride ``s`` on an ``n_tile`` =
    2s tile (``_bwd_plan``)."""
    P = 1
    while s % (2 * P) == 0 and 2 * P <= BWD_MAX_THREADS:
        P *= 2
    if n_tile != 2 * s or P < 4:
        raise ValueError(f"a lone stage of stride {s} on a {n_tile}-wide "
                         f"tile has no split into blocks of 4 or more pairs")
    w, pieces = 2 * P, s // P

    def smem(R):
        return bwd_smem_bytes(1, w, R, nvec, x_bytes, io_bytes, False,
                              bwd_row_slices(P), False, 1, io_bytes)

    R = 0
    while R < n_rows and smem(R + 1) <= SMEM_BYTES:
        R += 1
    if R == 0:
        raise ValueError(f"K2's split of a {n_tile}-wide tile into blocks "
                         f"of {w} lanes does not fit {SMEM_BYTES} B")
    G, R = _groups(n_rows, R, tiles * pieces, 1)
    rs = bwd_row_slices(P)
    return BwdPlan(1, w, P, rs, P * rs, R, G, 1, smem(R), 0, pieces)


def bwd_split_pairs(n_tile: int, plan: BwdPlan) -> List[List[int]]:
    """Split mode's pairs (``csrc/spm_stack_bwd.cu``): ``[j][q]`` -> the
    pair of one tile that slot q of its block j processes, ``j P + q`` (P =
    ``plan.pair_slots``), whose lanes are tile columns ``j P + q`` and that
    plus s = n_tile / 2."""
    P = plan.pair_slots
    return [[j * P + q for q in range(P)] for j in range(plan.split)]


def bwd_row_slices(pair_slots: int) -> int:
    """Row slices for a block of ``pair_slots`` slots (threads = slots x
    slices, a warp on consecutive slots of one slice): the fewest, a power
    of two up to 32, giving 128 threads, within ``BWD_MAX_THREADS``; one
    where that many would not make whole warps (the engine's
    ``valid_shape``)."""
    rs = 1
    while rs < 32 and pair_slots * rs < 128 and \
            pair_slots * rs * 2 <= BWD_MAX_THREADS:
        rs *= 2
    return rs if pair_slots * rs % 32 == 0 else 1


def bwd_stage_modes(n_tile: int, lane_blocks: int, strides: Sequence[int]
                    ) -> List[str]:
    """How the backward engine runs each stage of a tile split over C lane
    blocks of w lanes (``csrc/spm_bwd_engine.cuh`` ``setup_stages``): "A"
    (block c owns lanes [c w, (c+1) w)) when w % 2s == 0; "B" (block c
    owns the lanes equal to c mod C) for a run of two or more other
    stages whose strides C divides; else across blocks in layout A,
    "paired" when s is a multiple of w (blocks c and c ^ s/w split the
    pairs between them), "cross" otherwise."""
    C, w = lane_blocks, n_tile // lane_blocks
    L = len(strides)
    out, l = [], 0
    while l < L:
        e = l
        while e < L and w % (2 * strides[e]) and strides[e] % C == 0:
            e += 1
        if e - l >= 2:
            out += ["B"] * (e - l)
            l = e
            continue
        s = strides[l]
        out.append("A" if w % (2 * s) == 0 else
                   "paired" if s % w == 0 else "cross")
        l += 1
    return out


def bwd_passes(n_tile: int, lane_blocks: int, strides: Sequence[int]
               ) -> List[Tuple[int, int]]:
    """The backward engine's passes (``csrc/spm_bwd_engine.cuh``
    ``plan_walk``): ``(first stage, stages)``; two consecutive stages
    local to one layout ("A" or "B") fuse when their strides, in that
    layout's offsets (s, or s / C in B), nest: the larger a multiple of
    twice the smaller.  A fused pass keeps only its first stage's input,
    recomputing the second's in the reverse walk."""
    C = lane_blocks
    modes = bwd_stage_modes(n_tile, C, strides)
    out, l = [], 0
    while l < len(strides):
        n = 1
        if l + 1 < len(strides) and modes[l] == modes[l + 1] \
                and modes[l] in ("A", "B"):
            f = C if modes[l] == "B" else 1
            a, b = sorted((strides[l] // f, strides[l + 1] // f))
            if b % (2 * a) == 0:
                n = 2
        out.append((l, n))
        l += n
    return out


def bwd_quad_lanes(n_tile: int, lane_blocks: int, strides: Sequence[int],
                   first: int) -> List[List[Tuple[int, int, int, int]]]:
    """The quads of a fused pass from stage ``first`` (``csrc/
    spm_bwd_engine.cuh`` ``quad``): ``[c][u]`` -> the tile lanes at
    offsets m0, m0 + d1, m0 + d2, m0 + d1 + d2 of block c (d1, d2 the two
    stages' strides in the pass's layout); stage ``first`` pairs the first
    with the second and the third with the fourth, the next stage the
    first with the third and the second with the fourth."""
    C = lane_blocks
    w = n_tile // C
    b_lay = bwd_stage_modes(n_tile, C, strides)[first] == "B"
    f = C if b_lay else 1
    d1, d2 = strides[first] // f, strides[first + 1] // f
    da, db = min(d1, d2), max(d1, d2)
    out = []
    for c in range(C):
        quads = []
        for u in range(w // 4):
            ub, rb = divmod(u, db // 2)
            m0 = ub * 2 * db + (rb // da) * 2 * da + rb % da
            ms = (m0, m0 + d1, m0 + d2, m0 + d1 + d2)
            quads.append(tuple(m * C + c if b_lay else c * w + m
                               for m in ms))
        out.append(quads)
    return out


def bwd_slot_pairs(n_tile: int, lane_blocks: int, strides: Sequence[int]
                   ) -> List[List[List[int]]]:
    """The pair each slot of each lane block processes in each stage
    (``csrc/spm_bwd_engine.cuh`` ``slot_lane0``): ``[l][c][q]`` -> the
    pair's index in the tile, whose lanes are ``(p // s) * 2s + p % s``
    and that plus s.  In layout A (and "cross") slot q of block c is pair
    ``c w/2 + q``; in layout B the pair of the block's offsets m0 = ``(q //
    d) 2d + q % d`` and m0 + d, d = s / C, lanes ``m C + c``; "paired":
    lane ``c w + q`` of the low block, ``c w + w/2 + q - s`` of the high
    one."""
    C = lane_blocks
    w = n_tile // C
    half = w // 2
    out = []
    for s, mode in zip(strides, bwd_stage_modes(n_tile, C, strides)):
        rows = []
        for c in range(C):
            row = []
            for q in range(half):
                if mode == "B":
                    d = s // C
                    row.append((q // d) * s + (q % d) * C + c)
                    continue
                if mode == "paired":
                    lane = c * w + half + q - s if (c // (s // w)) & 1 \
                        else c * w + q
                    row.append((lane // (2 * s)) * s + lane % (2 * s))
                    continue
                row.append(c * half + q)
            rows.append(row)
        out.append(rows)
    return out


def bwd_clusters_resident(kernel: str, dtype: torch.dtype,
                          strides: Sequence[int], plan: BwdPlan) -> int:
    """Clusters of ``plan``'s shape the card holds at once
    (``cudaOccupancyMaxActiveClusters``) for ``kernel`` "K2" or "K6" with
    f32 or bf16 I/O; needs the card and the built kernels."""
    lib, name = (("spm_stack_bwd", "spm_stack_bwd_clusters") if kernel == "K2"
                 else ("spm_overlap_bwd", "spm_overlap_bwd_clusters"))
    fn = _fn(lib, name, (_I, ctypes.POINTER(ctypes.c_int)) + (_I,) * 6)
    return int(fn(_IO[dtype], _strides_arg(strides), len(strides),
                  plan.lane_blocks, plan.lanes, plan.pair_slots,
                  plan.row_slices, plan.chunk_rows))


def bwd_row_chunks(n_rows: int, chunk_rows: int, groups: int
                   ) -> List[Tuple[int, int, int]]:
    """``(group, first row, rows)`` of every chunk a backward launch walks,
    in each group's order: group g takes chunks g, g + G, ... (the kernels'
    row loop)."""
    out = []
    for g in range(groups):
        r0 = g * chunk_rows
        while r0 < n_rows:
            out.append((g, r0, min(chunk_rows, n_rows - r0)))
            r0 += groups * chunk_rows
    return out


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
    through the window, as K1's plain version reads x.

    An (E, L, n/2, 4) table is the expert mode, one expert at a time:
    every output stacked over the experts."""
    if coeffs.dim() == 4:
        outs = [spm_stack_bwd_plain(
            x[e], coeffs[e], gy[e], _at(d_in, e), _at(d_out, e),
            strides=strides, n_tile=n_tile, has_bias=has_bias,
            in_width=in_width, out_width=out_width, dead_from=dead_from,
            col_sum=col_sum) for e in range(coeffs.shape[0])]
        return tuple(torch.stack(ts) for ts in zip(*outs))
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
    visited (no ``dead_from``).  No int8 x.

    Expert mode (an (E, L, n/2, 4) table): x (E, B, in_width), gy (E, B,
    out_width), d_in/d_out (E, n); one launch for all E experts, each
    expert's grads summed over its own rows; every output gains the
    leading E axis.  No int8 operand, no window."""
    strides = tuple(int(s) for s in strides)
    if coeffs.dim() == 4:
        return _stack_bwd_experts(
            x, coeffs, gy, d_in, d_out, strides, n_tile, has_bias, in_width,
            out_width, dead_from,
            x_scale is not None or coeff_scale is not None,
            col_base is not None)
    n = 2 * coeffs.shape[1]
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
        plan = bwd_plan(B, n_tile, strides, vis, gy.element_size(),
                        x.element_size())
        if plan.split and col_base is not None:
            raise ValueError("K2's split mode (a lone stage wider than a "
                             "cluster) takes no window")
        G = plan.groups
        part_cf = torch.empty((G, L, n // 2, 4), dtype=torch.float32,
                              device=dev)
        part_vec = torch.empty((G, 3, n), dtype=torch.float32, device=dev)
        rc = _k2_fn()(_IO[io_dt], _ptr(x), _ptr(x_scale), _ptr(gy),
                      _ptr(gx), _ptr(coeffs), _ptr(coeff_scale), _ptr(d_in),
                      _ptr(d_out), _ptr(g_cf), _ptr(g_vec), _ptr(part_cf),
                      _ptr(part_vec), B, n, n_tile, in_w, gy_w, gx_w, x_off,
                      gy_off, vis, int(has_bias), scale_rows or 0,
                      *_shape_args(plan), plan.split, _strides_arg(strides),
                      L, 1, L * (n // 2), _stream(x))
        if rc != 0:
            raise RuntimeError(f"spm_stack_bwd launch failed: cudaError {rc}")
        _count(spm_stack_bwd_kernel_call, x_scale, coeff_scale,
               col_base is not None)
        spm_stack_bwd_kernel_call.split_launches += bool(plan.split)
    out = (gx, g_cf)
    for present, row in ((d_in is not None, 0), (d_out is not None, 1),
                         (has_bias, 2)):
        if present:
            out += (g_vec[row],)
    return out


def _k2_fn():
    return _fn("spm_stack_bwd", "spm_stack_bwd",
               (_I,) + (_P,) * 12 + (_I,) * 18
               + (ctypes.POINTER(ctypes.c_int), _I, _I, ctypes.c_long, _P))


def _stack_bwd_experts(x, coeffs, gy, d_in, d_out, strides, n_tile,
                       has_bias, in_width, out_width, dead_from,
                       int8: bool, window: bool) -> tuple:
    """K2's expert mode (``spm_stack_bwd_kernel_call``)."""
    E, L, half, _ = coeffs.shape
    n = 2 * half
    in_w = n if in_width is None else int(in_width)
    gy_w = n if out_width is None else int(out_width)
    vecs = [(d_in, "d_in"), (d_out, "d_out")]
    _expert_check(x, coeffs, vecs, strides, n_tile, in_w, gy_w, int8,
                  window)
    if gy.shape != (E, x.shape[1], gy_w):
        raise ValueError(f"expected gy ({E}, {x.shape[1]}, {gy_w}), got "
                         f"{tuple(gy.shape)}")
    if x.device.type == "cpu":
        return spm_stack_bwd_plain(x, coeffs, gy, d_in, d_out,
                                   strides=strides, n_tile=n_tile,
                                   has_bias=has_bias, in_width=in_width,
                                   out_width=out_width, dead_from=dead_from)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    cf_es = _expert_cuda_check(x, coeffs, vecs)
    if gy.dtype != x.dtype or gy.device != x.device \
            or not gy.is_contiguous():
        raise ValueError("gy must be contiguous, on x's device, in x's "
                         "dtype")
    vis, gx_w = bwd_live_tiles(n, n_tile, in_width, out_width, dead_from)
    B = x.shape[1]
    dev = x.device
    gx = torch.empty((E, B, gx_w), dtype=x.dtype, device=dev)
    g_cf = torch.empty((E, L, half, 4), dtype=torch.float32, device=dev)
    g_vec = torch.empty((E, 3, n), dtype=torch.float32, device=dev)
    if B == 0 or E == 0:
        for t in (gx, g_cf, g_vec):
            t.zero_()
    else:
        plan = bwd_plan(B, n_tile, strides, vis * E, gy.element_size(),
                        x.element_size())
        G = plan.groups
        part_cf = torch.empty((E, G, L, half, 4), dtype=torch.float32,
                              device=dev)
        part_vec = torch.empty((E, G, 3, n), dtype=torch.float32,
                               device=dev)
        rc = _k2_fn()(_IO[x.dtype], _ptr(x), None, _ptr(gy), _ptr(gx),
                      _ptr(coeffs), None, _ptr(d_in), _ptr(d_out),
                      _ptr(g_cf), _ptr(g_vec), _ptr(part_cf),
                      _ptr(part_vec), B, n, n_tile, in_w, gy_w, gx_w, 0, 0,
                      vis, int(has_bias), 0, *_shape_args(plan), plan.split,
                      _strides_arg(strides), L, E, cf_es, _stream(x))
        if rc != 0:
            raise RuntimeError(f"spm_stack_bwd (experts) launch failed: "
                               f"cudaError {rc}")
        _count(spm_stack_bwd_kernel_call, None, None)
        spm_stack_bwd_kernel_call.expert_launches += 1
        spm_stack_bwd_kernel_call.split_launches += bool(plan.split)
    out = (gx, g_cf)
    for present, row in ((d_in is not None, 0), (d_out is not None, 1),
                         (has_bias, 2)):
        if present:
            out += (g_vec[:, row],)
    return out


spm_stack_bwd_kernel_call.launches = 0
spm_stack_bwd_kernel_call.int8_launches = 0
spm_stack_bwd_kernel_call.int8_io_launches = 0
spm_stack_bwd_kernel_call.window_launches = 0
spm_stack_bwd_kernel_call.split_launches = 0
spm_stack_bwd_kernel_call.expert_launches = 0


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
    inside the full width n (one tile), and each stack has at least one
    stage on the card.  The launch shape is ``fwd_plan``'s block form."""
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
    if not strides1 or strides2 == ():
        raise ValueError("each stack of the block kernel needs a stage")
    B = x.shape[0]
    y = torch.empty((B, out_width), dtype=x.dtype, device=x.device)
    rstd = (torch.empty((B, 1), dtype=torch.float32, device=x.device)
            if gamma is not None else None)
    if B == 0:
        return y, rstd
    plan = fwd_plan(B, n, strides1, 1, x.element_size(), block=True,
                    strides2=strides2, norm=gamma is not None)
    s2 = strides2 or ()
    fn = _fn("spm_block", "spm_block_fwd",
             (_I,) + (_P,) * 12 + (_I,) * 7 + (ctypes.c_float,) + (_I,) * 4
             + (ctypes.POINTER(ctypes.c_int), _I,
                ctypes.POINTER(ctypes.c_int), _I, _P))
    rc = fn(_IO[x.dtype], _ptr(x), _ptr(y), _ptr(rstd), _ptr(gamma),
            _ptr(coeffs1), _ptr(d_in1), _ptr(d_out1), _ptr(bias1),
            _ptr(coeffs2), _ptr(d_in2), _ptr(d_out2), _ptr(bias2),
            B, n, in_width, mid_width, out_width,
            ACTIVATIONS[activation], int(residual), float(eps),
            plan.threads, plan.chunk_rows, plan.groups, int(plan.resident),
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
    padded lanes.  On the card each stack has at least one stage; the
    launch shape is ``bwd_plan``'s block form (a plan whose tables stream
    from device memory, ``streamed``, included)."""
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
    if not strides1 or strides2 == ():
        raise ValueError("each stack of the block kernel needs a stage")
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
        plan = bwd_plan(B, n, strides1, 1, x.element_size(), block=True,
                        strides2=strides2, norm=gamma is not None)
        G, C = plan.groups, plan.lane_blocks
        part_cf1 = torch.empty((G, L1, n // 2, 4), dtype=torch.float32,
                               device=dev)
        part_cf2 = (None if strides2 is None else torch.empty(
            (G, L2, n // 2, 4), dtype=torch.float32, device=dev))
        nvec = 4 if strides2 is None else 7
        part_vec = torch.empty((G, nvec, n), dtype=torch.float32, device=dev)
        slab = L1 + (L2 if plan.streamed > 1 else 0)
        slabs = None if not plan.streamed else torch.empty(
            (G * C, 2 * slab, plan.pair_slots, 4), dtype=torch.float32,
            device=dev)
        s2 = strides2 or ()
        fn = _fn("spm_block_bwd", "spm_block_bwd",
                 (_I,) + (_P,) * 20 + (_I,) * 14
                 + (ctypes.POINTER(ctypes.c_int), _I,
                    ctypes.POINTER(ctypes.c_int), _I, _P))
        rc = fn(_IO[x.dtype], _ptr(x), _ptr(gy), _ptr(gx), _ptr(rstd),
                _ptr(gamma), _ptr(coeffs1), _ptr(d_in1), _ptr(d_out1),
                _ptr(bias1), _ptr(coeffs2), _ptr(d_in2), _ptr(d_out2),
                _ptr(bias2), _ptr(g_cf1), _ptr(g_cf2), _ptr(g_vec),
                _ptr(part_cf1), _ptr(part_cf2), _ptr(part_vec),
                _ptr(slabs), B, n, in_width, mid_width, out_width,
                ACTIVATIONS[activation], int(residual), *_shape_args(plan),
                plan.streamed, _strides_arg(strides1), L1, _strides_arg(s2),
                len(s2), _stream(x))
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
    # a cluster holds both partners of a pair (and their send slots)
    plan = fwd_plan(B, n_tile, strides, S // 2 * tiles, x.element_size(),
                    sides=2, cf_bytes=16 if coeff_scale is None else 4)
    fn = _fn("spm_overlap", "spm_overlap_fwd",
             (_I,) + (_P,) * 9 + (_I,) * 10
             + (ctypes.POINTER(ctypes.c_int), _I, _P))
    rc = fn(_IO[x.dtype], _ptr(x), _ptr(y), _ptr(coeffs), _ptr(coeff_scale),
            _ptr(mix_a), _ptr(mix_b), _ptr(d_in), _ptr(d_out), _ptr(bias),
            B, S, nl, n_tile, in_w, _kbit(k), plan.threads, plan.chunk_rows,
            plan.groups, int(plan.resident), _strides_arg(strides),
            len(strides), _stream(x))
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
        # a cluster holds both partners of a pair (and the package)
        plan = bwd_plan(B, n_tile, strides, S // 2 * tiles,
                        x.element_size(), nvec=5, package=True, sides=2)
        G = plan.groups
        part_cf = torch.empty((G, S, L, nl // 2, 4), dtype=torch.float32,
                              device=dev)
        part_vec = torch.empty((G, 5, n), dtype=torch.float32, device=dev)
        fn = _fn("spm_overlap_bwd", "spm_overlap_bwd",
                 (_I,) + (_P,) * 13 + (_I,) * 12
                 + (ctypes.POINTER(ctypes.c_int), _I, _P))
        rc = fn(_IO[x.dtype], _ptr(x), _ptr(gy), _ptr(gx), _ptr(coeffs),
                _ptr(coeff_scale), _ptr(u), _ptr(v), _ptr(d_in),
                _ptr(d_out), _ptr(g_cf), _ptr(g_vec), _ptr(part_cf),
                _ptr(part_vec), B, S, nl, n_tile, in_w, _kbit(k),
                *_shape_args(plan), _strides_arg(strides), L, _stream(x))
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
                     "window_launches", "split_launches", "expert_launches"):
            if hasattr(fn, name):
                setattr(fn, name, 0)
