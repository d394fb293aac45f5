"""The feature-sharded two_level SPM executor (port of
``repro/parallel/spm_shard.py``).

With ``n = n_shards * n_local`` features in contiguous shard blocks, every
stage of a two_level schedule (``core/eligibility.plan_steps``) is one of
two shapes:

* **shard-local run** (``n_local % (2*s) == 0``): each shard runs the
  maximal run of local stages on its ``(rows, n_local)`` slab through K1
  (``kernels/spm_stack.py``; the plain version on CPU tensors) or, with the
  kernel path off, the 2x2 composition;
* **cross stage** (``s = k * n_local``, ``k`` a power of two): lane ``r``
  of shard ``j`` pairs with lane ``r`` of shard ``j XOR k``.  The partner
  hands over its slab (``_exchange``) and each shard mixes locally: the
  low partner (``j & k == 0``) computes ``y0 = a*z + b*zp``, the high one
  ``y1 = c*zp + d*z``.

The whole operator is one ``torch.autograd.Function`` over the global
``(rows, in_width or n)`` input (the reference's ``custom_vjp`` around its
``shard_map``).  Its forward walks the steps in order, every shard's local
run and then, at a cross step, every shard's exchange and mix; the backward
walks them in reverse.  Between steps the activations are global ``(rows,
n)`` tensors: a step reads each shard's columns as a view and assembles
its shards' outputs, a fused pair takes and returns the global tensor.
The exchange is its own transpose, so the backward issues the same
hand-overs (of the saved stage input, for the coefficient grads, and of
the cotangent).  Each shard returns only the coefficient-grad
components its role owns (low: a, b; high: c, d); the per-step tables are
built outside the Function by differentiable indexing (``_step_tables``),
so autograd's scatter-add merges the two partners' partials into the shared
rows.  Diagonal and bias grads are per-shard slices of (n,) vectors.

Operator boundaries fold as in the reference: ``d_in`` into the first K1
run of a first local step, ``d_out``/``bias`` into the last K1 run of a
last local step, or, when the schedule ends on a cross stage, into the mix
itself, scaling the mixed sum on the store (after the add).

A rectangular ``in_width`` enters whole (feature-replicated) and the first
local run reads each shard's ``n_local`` window straight out of it: K1's
and K2's ``col_base`` mode, x read at global column ``(col_base + j) *
n_tile + c`` and zero past the global ``in_width``, so no padded copy is
made.  The backward remats through the same windowed read and K2 returns
the shard's ``(rows, n_local)`` g_x slab; the slabs are assembled and cut
to ``in_width``.  Without the kernel path a rectangular input enters
zero-padded to n.  The output is cut to ``out_width``; its cotangent
enters the backward zero-padded to n.

**The overlap schedule** (``SPMConfig.overlap``, resolved by
``core/eligibility.resolve_overlap``): every step splits the rows into
``ShardPlan.row_blocks`` and runs block by block, the reference's
row-block pipeline, and each ``{local run -> cross stage}`` pair
(``overlap_segments``) whose local run plans to one kernel run is one
fused kernel launch over every shard on the card (``rdma_crosses``,
``core/eligibility.resolve_rdma``): K5 forward, the local run, the
exchange with the partner and the mix, and K6 backward, which remats the
local run's output, so the forward keeps no input for that cross step.
Elsewhere (a CPU input, the composition) a pair runs block by block
through the exchange, as the reference's interpret mode does.  The row
blocks change only how the per-block grad partials are grouped: the
reference's split on a CPU input, so that the tests compare like with
like, and one block on the card, where the mesh is one device and no
exchange latency is there to hide (the steps outside the pairs would
only issue their per-shard ops once a block).

**int8 tables** (``quant_cf``: the kernel path and ``quant_coeffs``): every
shard-local run, K1/K2 and K5/K6 alike, reads an int8 table with one scale
a stage taken from that shard's own table (``_quant_tables``), requantized
the same way in the backward, so the grads are those of the dequantized
tables (straight through).  Cross-stage coefficients stay f32, and int8
activations (``quant_acts``) do not apply here, as in the reference.

**Experts** (an MoE's stacked expert operators: tables (E, L, n/2, 4),
vectors (E, n), x (E, rows, in_width); the reference's ``jax.vmap`` of
its sharded executor over the expert axis): every step runs all experts
at once.  The step tables are (S, E, ...), shard-major; the exchanges
and the cross mixes are one elementwise op for all experts (rounding
after each op in the activation dtype, as above); a local run is one
K1/K2 expert-mode launch a planned run (windowed per expert), a fused
pair one K5/K6 launch over every shard and expert.  Rows, row blocks and
the plans are one expert's, every sum over rows is each expert's own,
and int8 tables have one scale a shard, expert and stage.  Without the
kernel path the composition runs an expert at a time.

The mesh (``parallel/ctx.FeatureMesh``) binds each shard to a device.
On a one-process mesh every shard must be on the input's own device, and
a mesh that places one elsewhere raises: a hand-over is then the partner's
slab itself (in K5/K6 the partner block's shared memory), and no shard's
work leaves the card (or the CPU) its input is on.  The mix of a cross
step outside a pair kernel computes in the activation dtype, rounding
after each operation as the reference's CPU run does (bf16 included); K5
mixes in f32 after one rounding of each slab, as the reference's pair
kernel does.

**One shard a rank** (the mesh's rank form, the reference's ``shard_map``
over a ``"model"`` axis of devices): rank j runs only shard j's steps, the
same functions on the same operands, so the rounding points are the
one-process walk's.  Between steps it keeps its own (rows, n_local) slab;
the operator's input and output stay replicated (everything outside the
SPM operators runs replicated on every rank): the input enters whole (a
windowed first run reads the rank's window of it), the output is one
``all_gather`` of the slabs.  A cross stage's exchange is one
``batch_isend_irecv`` with rank j XOR k (``FeatureMesh.exchange``), the
backward makes the same exchanges, and the grads are assembled inside the
backward by one ``all_gather``: g_x's slabs, each step's table grad (each
element has one owning rank, so the assembly is the exact sum over the
ranks, taken before autograd carries it through ``_step_tables`` and
``stage_coeffs``) and the vector grads.  Every rank makes the same
collectives in the same order, the recompute of a checkpointed layer
included.  The overlap schedule splits the rows into the reference's row
blocks (there is exchange latency to hide), and on the card each fused
pair runs as K5's and K6's rank mode (``kernels/spm_stack.py``
``spm_overlap_rank_call``, ``spm_overlap_bwd_rank_call``): the send kernel
stores the rank's block straight into the partner rank's receive slot
(``kernels/peer.py``).  An expert stack over a rank mesh is expert
parallelism (ROADMAP.md §1 item 6b) and raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import spm as spm_mod
from repro_torch.core.eligibility import (OVERLAP_ROW_BLOCKS,
                                          overlap_segments, plan_steps,
                                          resolve_overlap, resolve_rdma,
                                          resolve_shard_kernel, split_rows)
from repro_torch.core.pairings import Stage
from repro_torch.kernels import quant as Q
from repro_torch.kernels import spm_stack as K
from repro_torch.kernels.ops import (_stage_scales, _stages, plan_runs,
                                    plan_runs_for_rows)
from repro_torch.parallel import ctx as par_ctx
from repro_torch.parallel.ctx import FeatureMesh

__all__ = ["spm_apply_sharded", "cross_partner_perm", "ShardPlan",
           "pick_row_blocks"]

AXIS = "model"


def cross_partner_perm(n_shards: int, k: int) -> Tuple[Tuple[int, int], ...]:
    """The partner map of a cross stage: shard j <-> j XOR k (an
    involution, so the backward makes the same exchange)."""
    return tuple((j, j ^ k) for j in range(n_shards))


@functools.lru_cache(maxsize=None)
def _cross_coeff_rows(n_shards: int, n_local: int, k: int) -> np.ndarray:
    """(n_shards, n_local) pair-row indices of a cross stage: lane r of
    shard j (and of its partner j XOR k: the rows are shared) uses pair
    Q(j)*n_local + r with Q(j) = ((j & ~k) // 2k)*k + ((j & ~k) % 2k)."""
    j = np.arange(n_shards)
    jl = j & ~k                       # the pair's low-partner shard id
    q = (jl // (2 * k)) * k + (jl % (2 * k))
    return q[:, None] * n_local + np.arange(n_local)[None, :]


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """The static description of one sharded operator call.

    ``in_width`` / ``out_width`` are the global rectangular widths (None:
    square).  ``win_in``: the first local run reads the input through K1's
    and K2's windowed (``col_base``) mode; ``fold_*``: the diagonal and
    bias operands fold into the boundary runs or the ending mix instead of
    running as separate elementwise ops.  ``row_blocks`` (empty: the
    step-serial schedule) are the overlap schedule's row blocks,
    ``rdma_crosses`` the cross steps fused with their local run into K5/K6,
    ``quant_cf`` whether the local runs read int8 tables, ``experts``
    whether the operator carries a leading expert axis; ``mesh`` the
    feature mesh (None or a one-process mesh: this process runs every
    shard; a rank mesh: only its rank's)."""

    n: int
    n_local: int
    n_shards: int
    steps: Tuple[tuple, ...]
    has_din: bool
    has_dout: bool
    has_bias: bool
    use_kernel: bool
    in_width: Optional[int] = None
    out_width: Optional[int] = None
    row_blocks: Tuple[int, ...] = ()
    rdma_crosses: Tuple[int, ...] = ()
    quant_cf: bool = False
    experts: bool = False
    mesh: Optional[FeatureMesh] = dataclasses.field(default=None,
                                                    compare=False,
                                                    repr=False)

    @property
    def ranked(self) -> bool:
        """Whether the mesh is a rank mesh (one shard a rank)."""
        return self.mesh is not None and self.mesh.ranked

    @property
    def shards(self) -> Tuple[int, ...]:
        """The shards this process runs."""
        return (self.mesh.shards if self.ranked
                else tuple(range(self.n_shards)))

    @property
    def overlap(self) -> bool:
        """Whether the row-block (overlap) schedule is engaged."""
        return bool(self.row_blocks)

    @property
    def segments(self) -> Tuple[tuple, ...]:
        """The overlap segmentation of ``steps`` (``overlap_segments``)."""
        return overlap_segments(self.steps)

    @property
    def first_local(self) -> bool:
        return self.steps[0][0] == "local"

    @property
    def last_local(self) -> bool:
        return self.steps[-1][0] == "local"

    @property
    def fold_din(self) -> bool:
        """D_in folds into the first kernel run of the first local step."""
        return self.has_din and self.use_kernel and self.first_local

    @property
    def fold_dout(self) -> bool:
        """D_out folds into the last kernel run of a last local step, or
        into the mix of a last cross stage, scaling the mixed sum on the
        store."""
        return self.has_dout and (self.use_kernel if self.last_local
                                  else True)

    @property
    def fold_bias(self) -> bool:
        """Bias folds exactly like ``fold_dout``."""
        return self.has_bias and (self.use_kernel if self.last_local
                                  else True)

    @property
    def win_in(self) -> bool:
        """The first kernel run reads the (rows, in_width) global input
        through a windowed (``col_base``) call."""
        return (self.in_width is not None and self.use_kernel
                and self.first_local)

    @property
    def saves_x_res(self) -> bool:
        """Whether the stage-0 input is kept apart from the step inputs:
        the whole x under ``win_in``, else the pre-D_in slab when g_din is
        computed outside the kernels."""
        return self.win_in or (self.has_din and not self.fold_din)

    @property
    def saves_z_last(self) -> bool:
        """z_L (before D_out) is kept only when g_dout is computed outside
        the kernels."""
        return self.has_dout and not self.fold_dout

    @property
    def saved_step_inputs(self) -> Tuple[bool, ...]:
        """Which steps' inputs the forward keeps: not the first under
        ``win_in`` (x itself is kept), not a fused pair's cross step (K6
        remats it from the pair's input), every other."""
        return tuple(not ((i == 0 and self.win_in) or i in self.rdma_crosses)
                     for i in range(len(self.steps)))

    def shard_slice(self, j: int) -> slice:
        """Shard j's columns of the (n,) feature axis."""
        return slice(j * self.n_local, (j + 1) * self.n_local)


@functools.lru_cache(maxsize=None)
def _cross_rows_on(n_shards: int, n_local: int, k: int,
                   device: torch.device) -> torch.Tensor:
    """``_cross_coeff_rows`` as an index tensor on ``device``, made once:
    a copy from the host at every call would wait for the device."""
    return torch.as_tensor(_cross_coeff_rows(n_shards, n_local, k),
                           device=device)


@functools.lru_cache(maxsize=None)
def _low_on(n_shards: int, k: int, device: torch.device) -> torch.Tensor:
    """(S, 1) bool: whether shard j is the low partner of a cross stage
    (``j & k == 0``), on ``device``, made once."""
    return torch.as_tensor([[(j & k) == 0] for j in range(n_shards)],
                           device=device)


def _step_tables(coeffs: torch.Tensor, steps, n_shards: int,
                 n_local: int) -> Tuple[torch.Tensor, ...]:
    """Per-step coefficient tables with a leading shard axis.  A local step
    takes shard j's contiguous pair block of each of its stages,
    ``(S, Lr, n_local/2, 4)``; a cross step the shared partner rows,
    ``(S, n_local, 4)``; an expert stack (E, L, n/2, 4) gives ``(S, E,
    ...)`` of each.  Differentiable: the cross case is a gather whose
    backward scatter-adds the two partners' partials into the shared rows.
    Each shard's local table is contiguous."""
    nl2 = n_local // 2
    lead = coeffs.shape[:-3]
    tabs = []
    for step in steps:
        if step[0] == "local":
            _, start, run = step
            blk = coeffs[..., start: start + len(run), :, :]
            tabs.append(blk.reshape(*lead, len(run), n_shards, nl2, 4)
                        .movedim(-3, 0).contiguous())   # (S, [E,] Lr, nl2, 4)
        else:
            _, ell, k = step
            rows = _cross_rows_on(n_shards, n_local, k, coeffs.device)
            t = coeffs[..., ell, :, :][..., rows, :]    # ([E,] S, n_local, 4)
            tabs.append(t.movedim(-3, 0))
    return tuple(tabs)


def _quant_tables(plan: ShardPlan, tables) -> Tuple[Optional[tuple], ...]:
    """Under ``quant_cf``, each local step's int8 tables ``(q (S, [E,] Lr,
    n_local/2, 4), scales (S, [E,] Lr))``: one scale a stage of each
    shard's own table (of each expert: ``kernels/quant.quantize_coeffs`` of
    that shard's slab, as the reference quantizes inside its shard body);
    None for cross steps and without ``quant_cf``."""
    return tuple(Q.quantize_coeffs(t.detach())
                 if plan.quant_cf and step[0] == "local" else None
                 for step, t in zip(plan.steps, tables))


# ---------------------------------------------------------------------------
# the overlap schedule's row blocks
# ---------------------------------------------------------------------------

def pick_row_blocks(rows: int, block_rows: int,
                    target: int = OVERLAP_ROW_BLOCKS) -> Tuple[int, ...]:
    """Per-shard row-block sizes of the overlap schedule (the reference's
    arithmetic): ``rows`` split into at most ``target`` contiguous blocks,
    each a multiple of ``block_rows``, the last taking any remainder."""
    if rows <= 0:
        return (max(rows, 0),) if rows else ()
    units = max(1, rows // block_rows)
    nb = max(1, min(target, units))
    base, extra = divmod(units, nb)
    sizes = [(base + (1 if b < extra else 0)) * block_rows
             for b in range(nb)]
    sizes[-1] += rows - sum(sizes)
    return tuple(sz for sz in sizes if sz > 0)


def _overlap_row_blocks(steps, n_local: int, rows: int, dtype_bytes: int,
                        use_kernel: bool) -> Tuple[int, ...]:
    """The row blocks the reference's overlap schedule gives ``rows``:
    with the kernel path, its row block (``pick_block_rows_for_plan``, of
    which ``kernels/quant.scale_block_rows`` is the copy) halved while the
    slab has fewer than ``OVERLAP_ROW_BLOCKS`` of them (not below 8), and
    the rows padded to it; one row without.  The reference's zero padding
    rows come off the last block here (they add nothing)."""
    if use_kernel:
        br = min(Q.scale_block_rows(plan_runs(n_local, st[2]), rows,
                                    dtype_bytes)
                 for st in steps if st[0] == "local")
        while br > 8 and rows // br < OVERLAP_ROW_BLOCKS:
            br //= 2
    else:
        br = 1
    padded = -(-rows // br) * br
    blocks = list(pick_row_blocks(padded, br))
    if blocks:
        blocks[-1] -= padded - rows
    return tuple(b for b in blocks if b > 0)


def _rdma_cross_indices(steps, n_local: int) -> Tuple[int, ...]:
    """The cross steps a fused pair kernel (K5/K6) takes: the cross of each
    ``("pair", local, cross)`` segment whose local run plans to one kernel
    run (the reference's rule)."""
    out = []
    i = 0
    for seg in overlap_segments(steps):
        if seg[0] == "pair":
            if len(plan_runs(n_local, seg[1][2])) == 1:
                out.append(i + 1)
            i += 2
        else:
            i += 1
    return tuple(out)


def _overlap_split(t: torch.Tensor, blocks: Tuple[int, ...]):
    """``t``'s rows (axis -2: each expert's) cut into the plan's row
    blocks (views)."""
    return [t] if len(blocks) <= 1 else list(torch.split(t, blocks, dim=-2))


def _join(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def _low_b(n_shards: int, k: int, device, ndim: int) -> torch.Tensor:
    """``_low_on`` shaped (S, 1, ..., 1) with ``ndim`` axes, to select
    over a shard-major (S, [E,] ...) tensor."""
    return _low_on(n_shards, k, device).reshape(n_shards,
                                                *([1] * (ndim - 1)))


def _flat_shards(t: torch.Tensor) -> torch.Tensor:
    """(S, [E,] n_local) per-shard vectors -> ([E,] n), shard j's lanes at
    j * n_local."""
    t = t.movedim(0, -2)
    return t.reshape(*t.shape[:-2], -1)


def _slab_sums(plan: ShardPlan, t: torch.Tensor) -> torch.Tensor:
    """The sum over rows of this process's lanes of ``t``, each shard's
    (rows, n_local) slab summed on its own: the same sums whether one
    process holds every shard or a rank holds one."""
    return torch.cat([t[..., plan.shard_slice(p)].contiguous().sum(-2)
                      for p in range(len(plan.shards))], dim=-1)


def _sum_vec_lists(parts):
    """The sum over row blocks, in block order, of per-block grads (None
    where absent)."""
    if parts[0] is None:
        return None
    return functools.reduce(torch.add, parts)


# ---------------------------------------------------------------------------
# cross stages
# ---------------------------------------------------------------------------

def _exchange(slabs: List[torch.Tensor], k: int,
              mesh: Optional[FeatureMesh] = None) -> List[torch.Tensor]:
    """The partner exchange of a cross stage: each of this process's shards
    receives the slab of its partner in ``cross_partner_perm``: on a
    one-process mesh (every shard here) the partner's slab itself, on a
    rank mesh the partner rank's, over the group."""
    if mesh is not None and mesh.ranked:
        return [mesh.exchange(slabs[0], k)]
    return [slabs[p] for _, p in cross_partner_perm(len(slabs), k)]


def _cross_mix(z, zp, cf, low: bool, d_out=None, bias=None):
    """The local 2x2 half of a cross stage in the activation dtype: the low
    partner computes ``a*z + b*zp``, the high one ``c*zp + d*z``.  The
    operand order is the reference's (``spm_shard.py:354``), which elastic
    re-sharding keeps bitwise.  A schedule-ending stage scales the mixed
    sum by ``d_out`` after the add, then adds ``bias``."""
    a, b, c, d = (cf[..., i].unsqueeze(-2).to(z.dtype) for i in range(4))
    y = a * z + b * zp if low else c * zp + d * z
    if d_out is not None:
        y = y * d_out.unsqueeze(-2).to(z.dtype)
    if bias is not None:
        y = y + bias.unsqueeze(-2).to(z.dtype)
    return y


def _cross_bwd(z_in, delta, cfs, k: int, plan: ShardPlan, d_out=None,
               has_bias: bool = False):
    """The backward of a cross stage over this process's shards
    (``plan.shards``).  ``z_in`` and ``delta`` are per-shard lists;
    returns ``(g_in, g_cf, g_dout, g_bias)``, per-shard lists, the last two
    None unless folded here.

    Each shard receives its partner's saved input and cotangent (the same
    exchange).  Its coefficient grads fill only the components its role
    owns: low (d0, x0) with x1 = zp: g_a = sum d0 x0, g_b = sum d0 x1;
    high (d1, x1) with x0 = zp: g_c = sum d1 x0, g_d = sum d1 x1.  With a
    folded ``d_out`` the raw output cotangent arrives: ``g_bias`` sums it,
    ``g_dout`` contracts it with the mix output rematted in f32 in the
    forward's operand order, and each shard scales it by its own d_out
    slice before the exchange."""
    shards = plan.shards
    zp = _exchange(z_in, k, plan.mesh)
    g_dout = g_bias = None
    if d_out is not None or has_bias:
        if has_bias:
            g_bias = [dl.float().sum(-2) for dl in delta]
        if d_out is not None:
            g_dout = []
            for j, sh in enumerate(shards):
                a, b, c, d = (cfs[j][..., i].unsqueeze(-2).float()
                              for i in range(4))
                zf, zpf = z_in[j].float(), zp[j].float()
                m = a * zf + b * zpf if sh & k == 0 else c * zpf + d * zf
                g_dout.append((delta[j].float() * m).sum(-2))
            delta = [delta[j] * d_out[j].unsqueeze(-2).to(delta[j].dtype)
                     for j in range(len(shards))]
    dp = _exchange(delta, k, plan.mesh)
    g_in, g_cf = [], []
    for j, sh in enumerate(shards):
        a, b, c, d = (cfs[j][..., i].unsqueeze(-2).to(delta[j].dtype)
                      for i in range(4))
        low = sh & k == 0
        # g_x0 = a d0 + c d1 on the low shard; g_x1 = b d0 + d d1 on the high
        g_in.append(a * delta[j] + c * dp[j] if low
                    else b * dp[j] + d * delta[j])
        s_own = (delta[j].float() * z_in[j].float()).sum(-2)
        s_swp = (delta[j].float() * zp[j].float()).sum(-2)
        zero = torch.zeros_like(s_own)
        g_cf.append(torch.stack([s_own, s_swp, zero, zero], dim=-1) if low
                    else torch.stack([zero, zero, s_swp, s_own], dim=-1))
    return g_in, g_cf, g_dout, g_bias


def _cross_role_vecs(cf: torch.Tensor, k: int):
    """The role-resolved forward mix vectors of a cross step over all
    shards, ([E,] n) each: ``y = mix_a * z + mix_b * zp`` with (mix_a,
    mix_b) = (a, b) on the low partner and (d, c) on the high."""
    low = _low_b(cf.shape[0], k, cf.device, cf.dim() - 1)
    return (_flat_shards(torch.where(low, cf[..., 0], cf[..., 3])),
            _flat_shards(torch.where(low, cf[..., 1], cf[..., 2])))


# ---------------------------------------------------------------------------
# shard-local runs
# ---------------------------------------------------------------------------

def _segment_fwd(z, cf, run: Tuple[int, ...], plan: ShardPlan, *,
                 qcf=None, d_in=None, d_out=None, bias=None,
                 col_base: Optional[int] = None):
    """A maximal run of local stages on one shard's slab: K1 once per
    planned run, ``d_in`` folded into the first and ``d_out``/``bias`` into
    the last, or the composition with the kernel path off.  With
    ``col_base`` (a global column) ``z`` is the whole (rows, in_width)
    input and the first run reads this shard's window of it.  ``qcf``:
    the run's int8 table and stage scales (``quant_cf``).  An expert
    stack's run is one expert-mode launch a planned run (the composition:
    an expert at a time)."""
    if plan.use_kernel:
        kcf, scf = qcf if qcf is not None else (cf, None)
        runs = plan_runs_for_rows(plan.n_local, run, z.shape[-2])
        z = z.contiguous()
        off = 0
        for r, (run_strides, n_tile) in enumerate(runs):
            first, last = r == 0, r == len(runs) - 1
            win = first and col_base is not None
            lo, hi = off, off + len(run_strides)
            z = K.spm_stack_kernel_call(
                z, _stages(kcf, lo, hi), d_in if first else None,
                d_out if last else None, bias if last else None,
                coeff_scale=_stage_scales(scf, lo, hi),
                strides=run_strides, n_tile=n_tile,
                in_width=plan.in_width if win else None,
                col_base=col_base // n_tile if win else None)
            off += len(run_strides)
        return z
    if plan.experts:
        one = dataclasses.replace(plan, experts=False)
        return torch.stack([_segment_fwd(z[e], cf[e], run, one)
                            for e in range(cf.shape[0])])
    for i, s in enumerate(run):
        z = spm_mod.apply_stage(z, cf[i].to(z.dtype), Stage(stride=s))
    return z


def _segment_bwd(z_in, delta, cf, run: Tuple[int, ...], plan: ShardPlan, *,
                 qcf=None, d_in=None, d_out=None, has_bias: bool = False,
                 col_base: Optional[int] = None):
    """The closed-form backward of a local run from its saved input: the
    forward's runs are rematted but for the last, then K2 once per run in
    reverse (the first in the windowed mode with ``col_base``, returning
    this shard's (rows, n_local) g_x), or with the kernel path off the
    composition's per-stage eqs. 12-14.  Returns ``(delta, g_coeffs,
    g_din, g_dout, g_bias)``, g_coeffs in the table's dtype, the last
    three None unless folded here.  Experts as ``_segment_fwd``."""
    if plan.use_kernel:
        kcf, scf = qcf if qcf is not None else (cf, None)
        runs = plan_runs_for_rows(plan.n_local, run, delta.shape[-2])
        delta = delta.contiguous()
        zs, z, off = [], z_in.contiguous(), 0
        for r, (run_strides, n_tile) in enumerate(runs):
            zs.append(z)
            win = r == 0 and col_base is not None
            lo, hi = off, off + len(run_strides)
            if r < len(runs) - 1:          # the last output is not needed
                z = K.spm_stack_kernel_call(
                    z, _stages(kcf, lo, hi), d_in if r == 0 else None,
                    coeff_scale=_stage_scales(scf, lo, hi),
                    strides=run_strides, n_tile=n_tile,
                    in_width=plan.in_width if win else None,
                    col_base=col_base // n_tile if win else None)
            off += len(run_strides)
        offs = np.cumsum([0] + [len(rs) for rs, _ in runs])
        g_parts = [None] * len(runs)
        g_din = g_dout = g_bias = None
        for r in range(len(runs) - 1, -1, -1):
            run_strides, n_tile = runs[r]
            first, last = r == 0, r == len(runs) - 1
            win = first and col_base is not None
            lo, hi = int(offs[r]), int(offs[r + 1])
            out = K.spm_stack_bwd_kernel_call(
                zs[r], _stages(kcf, lo, hi), delta,
                d_in if first else None, d_out if last else None,
                coeff_scale=_stage_scales(scf, lo, hi),
                strides=run_strides, n_tile=n_tile,
                has_bias=last and has_bias,
                in_width=plan.in_width if win else None,
                col_base=col_base // n_tile if win else None)
            delta, g_parts[r] = out[0], out[1]
            vecs = list(out[2:])
            if first and d_in is not None:
                g_din = vecs.pop(0)
            if last and d_out is not None:
                g_dout = vecs.pop(0)
            if last and has_bias:
                g_bias = vecs.pop(0)
        return delta, torch.cat(g_parts, dim=-3), g_din, g_dout, g_bias
    if plan.experts:
        one = dataclasses.replace(plan, experts=False)
        outs = [_segment_bwd(z_in[e], delta[e], cf[e], run, one)
                for e in range(cf.shape[0])]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]), None, None, None)
    zs, z = [], z_in
    for i, s in enumerate(run):
        zs.append(z)
        if i < len(run) - 1:
            z = spm_mod.apply_stage(z, cf[i].to(z.dtype), Stage(stride=s))
    g_cf = []
    for i in range(len(run) - 1, -1, -1):
        delta, gc, _ = spm_mod._stage_grads(
            zs[i], delta, cf[i].to(delta.dtype), Stage(stride=run[i]), None)
        g_cf.append(gc)
    return (delta, torch.stack(g_cf[::-1], dim=0).to(cf.dtype), None, None,
            None)


# ---------------------------------------------------------------------------
# the fused pairs (K5 forward, K6 backward)
# ---------------------------------------------------------------------------

def _pair_run(plan: ShardPlan, li: int):
    """The strides and tile of a fused pair's local run (one planned
    run)."""
    (run_strides, n_tile), = plan_runs(plan.n_local, plan.steps[li][2])
    return run_strides, n_tile


def _mine(plan: ShardPlan, v):
    """This process's lanes of a ([E,] n) vector: all of it on a
    one-process mesh, the rank's shard slice on a rank mesh."""
    if v is None or not plan.ranked:
        return v
    return v[..., plan.shard_slice(plan.mesh.rank)].contiguous()


def _pair_operands(plan: ShardPlan, glob: dict, li: int, ci: int):
    """A fused pair's local table (int8 and stage scales under
    ``quant_cf``) and whether its run is the schedule's first (folding d_in
    and, under ``win_in``, reading the windowed input) and its cross the
    last (folding d_out and bias)."""
    q = glob["qtabs"][li]
    cf, scf = q if q is not None else (glob["tabs"][li], None)
    if plan.ranked:
        j = plan.mesh.rank
        cf, scf = cf[j], (None if scf is None else scf[j])
    return cf, scf, li == 0, ci == len(plan.steps) - 1


def _pair_fwd(plan: ShardPlan, glob: dict, li: int, ci: int,
              x: torch.Tensor) -> torch.Tensor:
    """One ``{local run -> cross}`` pair through K5 (its plain version on a
    CPU input): on a one-process mesh over every shard, x the global (rows,
    n) input, or the (rows, in_width) one under ``win_in``, returning the
    global (rows, n) output; on a rank mesh K5's rank mode over this rank's
    shard, x its (rows, n_local) slab or the windowed whole input, the
    partner's slab over the IPC slots, returning the rank's slab.  When the
    pair's cross stage ends the schedule, d_out scales the mixed sum after
    the add and bias follows, on the store."""
    k = plan.steps[ci][2]
    mesh = plan.mesh
    cf, scf, first, last = _pair_operands(plan, glob, li, ci)
    run_strides, n_tile = _pair_run(plan, li)
    mix_a, mix_b = (_mine(plan, v)
                    for v in _cross_role_vecs(glob["tabs"][ci], k))
    win = first and plan.win_in
    vecs = dict(d_in=glob["d_in"] if first and plan.fold_din else None,
                d_out=glob["d_out"] if last and plan.fold_dout else None,
                bias=glob["bias"] if last and plan.fold_bias else None)
    if plan.ranked:
        return K.spm_overlap_rank_call(
            x.contiguous(), cf, mix_a, mix_b, **vecs, coeff_scale=scf,
            strides=run_strides, n_tile=n_tile, k=k, mesh=mesh,
            blocks=plan.row_blocks,
            col_base=mesh.rank * plan.n_local if win else 0,
            in_width=plan.in_width if win else None)
    return K.spm_overlap_kernel_call(
        x, cf, mix_a, mix_b, **vecs, coeff_scale=scf, strides=run_strides,
        n_tile=n_tile, k=k, in_width=plan.in_width if win else None)


def _pair_bwd(plan: ShardPlan, glob: dict, li: int, ci: int,
              x: torch.Tensor, gy: torch.Tensor):
    """The backward of a fused pair through K6 (its rank mode on a rank
    mesh) from the pair's input ``x`` (as ``_pair_fwd`` read it) and the
    cotangent ``gy`` of its output.  Returns ``(g_x, g_local (S', Lr,
    n_local/2, 4), g_cross (S', n_local, 4), g_din, g_dout, g_bias)`` over
    this process's S' shards, the vectors over its lanes or None: s_own /
    s_swp placed in the role-owned (a, b) / (c, d) slots, ``g_dout = mix_a
    * t_own + mix_b * t_swp`` from the raw-cotangent sums, ``g_bias`` the
    raw cotangent summed."""
    S, nl = plan.n_shards, plan.n_local
    k = plan.steps[ci][2]
    mesh = plan.mesh
    cf, scf, first, last = _pair_operands(plan, glob, li, ci)
    fold_dout = last and plan.fold_dout
    run_strides, n_tile = _pair_run(plan, li)
    cfc = glob["tabs"][ci]
    low = _low_b(S, k, cfc.device, cfc.dim() - 1)
    # the transpose mix: g_mid = u * delta + v * delta_p with (u, v) =
    # (a, c) on the low partner and (d, b) on the high
    u = _mine(plan, _flat_shards(torch.where(low, cfc[..., 0], cfc[..., 3])))
    v = _mine(plan, _flat_shards(torch.where(low, cfc[..., 2], cfc[..., 1])))
    win = first and plan.win_in
    vecs = dict(d_in=glob["d_in"] if first and plan.fold_din else None,
                d_out=glob["d_out"] if fold_dout else None)
    if plan.ranked:
        out = K.spm_overlap_bwd_rank_call(
            x.contiguous(), cf, gy, u, v, **vecs, coeff_scale=scf,
            strides=run_strides, n_tile=n_tile, k=k, mesh=mesh,
            blocks=plan.row_blocks,
            col_base=mesh.rank * nl if win else 0,
            in_width=plan.in_width if win else None)
        out = (out[0], out[1].unsqueeze(0), *out[2:])
    else:
        out = K.spm_overlap_bwd_kernel_call(
            x, cf, gy, u, v, **vecs, coeff_scale=scf, strides=run_strides,
            n_tile=n_tile, k=k, in_width=plan.in_width if win else None)
    gx, g_local, s_own, s_swp = out[:4]
    rest = list(out[4:])                  # [g_din?] + [t_own, t_swp]?
    g_din = rest.pop(0) if first and plan.fold_din else None
    g_dout = g_bias = None
    if fold_dout:
        mix_a, mix_b = (_mine(plan, w) for w in _cross_role_vecs(cfc, k))
        g_dout = mix_a.float() * rest[0] + mix_b.float() * rest[1]
    if last and plan.fold_bias:
        g_bias = _slab_sums(plan, gy.float())

    def per_shard(t):      # ([E,] S' * n_local) -> (S', [E,] n_local)
        return t.reshape(*t.shape[:-1], -1, nl).movedim(-2, 0)

    so, sw = per_shard(s_own), per_shard(s_swp)
    zero = torch.zeros_like(so)
    mlow = low[list(plan.shards)]
    g_cross = torch.where(mlow[..., None],
                          torch.stack([so, sw, zero, zero], dim=-1),
                          torch.stack([zero, zero, sw, so], dim=-1))
    return gx, g_local, g_cross.to(cfc.dtype), g_din, g_dout, g_bias


# ---------------------------------------------------------------------------
# the walk over this process's shards
# ---------------------------------------------------------------------------

def _shard_operands(plan: ShardPlan, tables, qtabs, d_in, d_out, bias):
    """The operands of each of this process's shards (``plan.shards``):
    its table of every step (and its int8 table of each local step under
    ``quant_cf``) and its slices of the (n,) vectors (None where
    absent)."""
    ops = []
    for j in plan.shards:
        sl = plan.shard_slice(j)

        def vec(v):
            return None if v is None else v[..., sl].contiguous()

        ops.append(dict(shard=j, tabs=[t[j] for t in tables],
                        qtabs=[None if q is None else (q[0][j], q[1][j])
                               for q in qtabs],
                        d_in=vec(d_in), d_out=vec(d_out), bias=vec(bias)))
    return ops


def _spans(plan: ShardPlan):
    """``(segment, first step index)`` of the walk: the overlap segments,
    or every step alone on the step-serial schedule."""
    segs = (plan.segments if plan.overlap
            else tuple(("one", st) for st in plan.steps))
    out, i = [], 0
    for seg in segs:
        out.append((seg, i))
        i += len(seg) - 1
    return out


def _is_fused(plan: ShardPlan, seg, i0: int) -> bool:
    return seg[0] == "pair" and (i0 + 1) in plan.rdma_crosses


def _step_fwd(plan: ShardPlan, ops, i: int, z, blocks):
    """Step i over this process's shards, row block by row block, from
    their ``(rows, S' * n_local)`` input (the whole ``(rows, in_width)``
    one of a windowed first run, which every shard reads): returns their
    output, shard p of them at columns ``p * n_local``."""
    step = plan.steps[i]
    first, last = i == 0, i == len(plan.steps) - 1
    win = first and plan.win_in
    outs = []
    for zb in _overlap_split(z, blocks):
        blk = [zb if win else zb[..., plan.shard_slice(p)]
               for p in range(len(ops))]
        if step[0] == "cross":
            k = step[2]
            zp = _exchange(blk, k, plan.mesh)
            ys = [_cross_mix(
                blk[p], zp[p], o["tabs"][i], o["shard"] & k == 0,
                d_out=o["d_out"] if last and plan.fold_dout else None,
                bias=o["bias"] if last and plan.fold_bias else None)
                for p, o in enumerate(ops)]
        else:
            ys = [_segment_fwd(
                blk[p], o["tabs"][i], step[2], plan,
                qcf=o["qtabs"][i],
                d_in=o["d_in"] if first and plan.fold_din else None,
                d_out=o["d_out"] if last and plan.fold_dout else None,
                bias=o["bias"] if last and plan.fold_bias else None,
                col_base=o["shard"] * plan.n_local if win else None)
                for p, o in enumerate(ops)]
        outs.append(torch.cat(ys, dim=-1))
    return _join(outs)


def _step_bwd(plan: ShardPlan, ops, i: int, z_in, delta, blocks):
    """The backward of step i over this process's shards, row block by row
    block, from its input (as ``_step_fwd`` read it) and the cotangent:
    ``(delta, g_table (S', ...), g_din, g_dout, g_bias)``, each grad summed
    over the blocks in order, the vectors None unless folded here."""
    step = plan.steps[i]
    first, last = i == 0, i == len(plan.steps) - 1
    win = first and plan.win_in
    parts = []
    for zb, db in zip(_overlap_split(z_in, blocks),
                      _overlap_split(delta, blocks)):
        zs = [zb if win else zb[..., plan.shard_slice(p)]
              for p in range(len(ops))]
        ds = [db[..., plan.shard_slice(p)] for p in range(len(ops))]
        if step[0] == "cross":
            parts.append((*_cross_bwd(
                zs, ds, [o["tabs"][i] for o in ops], step[2], plan,
                d_out=([o["d_out"] for o in ops] if last and plan.fold_dout
                       else None),
                has_bias=last and plan.fold_bias), None))
            continue
        outs = [_segment_bwd(
            zs[p], ds[p], o["tabs"][i], step[2], plan,
            qcf=o["qtabs"][i],
            d_in=o["d_in"] if first and plan.fold_din else None,
            d_out=o["d_out"] if last and plan.fold_dout else None,
            has_bias=last and plan.fold_bias,
            col_base=o["shard"] * plan.n_local if win else None)
            for p, o in enumerate(ops)]
        parts.append(tuple([o[m] for o in outs] for m in (0, 1, 3, 4, 2)))

    def summed(m, join):
        if parts[0][m] is None or parts[0][m][0] is None:
            return None
        return _sum_vec_lists([join(p[m]) for p in parts])

    def cat(vs):
        return torch.cat(vs, dim=-1)

    return (_join([torch.cat(p[0], dim=-1) for p in parts]),
            summed(1, torch.stack), summed(4, cat), summed(2, cat),
            summed(3, cat))


def _walk_fwd(plan: ShardPlan, ops, glob, x2: torch.Tensor):
    """The forward over this process's shards from the whole input x2:
    returns their (rows, S' * n_local) output and the residuals ``(x_res,
    step_ins, z_last)``, each over the same lanes or None: x_res is x2
    itself under ``win_in``, else the pre-D_in input; a step input is None
    where not kept.  A rectangular input without the windowed read enters
    zero-padded to n; on a rank mesh a step reads only the rank's lanes."""
    fdt = x2.dtype
    blocks = plan.row_blocks or (x2.shape[-2],)
    z = x2
    if plan.in_width is not None and not plan.win_in:
        z = F.pad(x2, (0, plan.n - plan.in_width))
    if plan.ranked and not plan.win_in:
        z = z[..., plan.shard_slice(plan.mesh.rank)]
    x_res = z if plan.saves_x_res else None
    if plan.has_din and not plan.fold_din:
        z = z * glob["d_in"].unsqueeze(-2).to(fdt)
    keep = plan.saved_step_inputs
    step_ins: List = [None] * len(plan.steps)
    for seg, i0 in _spans(plan):
        if _is_fused(plan, seg, i0):
            if keep[i0]:
                step_ins[i0] = z
            z = _pair_fwd(plan, glob, i0, i0 + 1, z)
            continue
        for i in range(i0, i0 + len(seg) - 1):
            if keep[i]:
                step_ins[i] = z
            z = _step_fwd(plan, ops, i, z, blocks)
    z_last = z if plan.saves_z_last else None
    if plan.has_dout and not plan.fold_dout:
        z = z * glob["d_out"].unsqueeze(-2).to(fdt)
    if plan.has_bias and not plan.fold_bias:
        z = z + glob["bias"].unsqueeze(-2).to(fdt)
    return z, (x_res, step_ins, z_last)


def _walk_bwd(plan: ShardPlan, ops, glob, res, gy2: torch.Tensor):
    """The backward over this process's shards from the cotangent of their
    output: returns ``(g_x, g_tables (per step, (S', ...)), g_din, g_dout,
    g_bias)``, g_x and the vectors over the same lanes, or None where
    absent."""
    x_res, step_ins, z_last = res
    blocks = plan.row_blocks or (gy2.shape[-2],)
    g_din = g_dout = g_bias = None
    delta = gy2
    if plan.has_bias and not plan.fold_bias:
        g_bias = _slab_sums(plan, gy2.float())
    if plan.has_dout and not plan.fold_dout:
        g_dout = _slab_sums(plan, gy2.float() * z_last.float())
        delta = gy2 * glob["d_out"].unsqueeze(-2).to(gy2.dtype)
    g_tabs: List = [None] * len(plan.steps)
    for seg, i0 in reversed(_spans(plan)):
        vecs = []
        if _is_fused(plan, seg, i0):
            li, ci = i0, i0 + 1
            x_in = x_res if li == 0 and plan.win_in else step_ins[li]
            delta, g_tabs[li], g_tabs[ci], *v = _pair_bwd(
                plan, glob, li, ci, x_in, delta.contiguous())
            vecs.append(v)
        else:
            for i in range(i0 + len(seg) - 2, i0 - 1, -1):
                z_in = x_res if i == 0 and plan.win_in else step_ins[i]
                delta, g_tabs[i], *v = _step_bwd(plan, ops, i, z_in, delta,
                                                 blocks)
                vecs.append(v)
        for gd, go, gb in vecs:
            g_din = gd if gd is not None else g_din
            g_dout = go if go is not None else g_dout
            g_bias = gb if gb is not None else g_bias
    if plan.has_din and not plan.fold_din:
        g_din = _slab_sums(plan, delta.float() * x_res.float())
        delta = delta * glob["d_in"].unsqueeze(-2).to(delta.dtype)
    return delta, g_tabs, g_din, g_dout, g_bias


def _gather_lanes(mesh: FeatureMesh, t: torch.Tensor) -> torch.Tensor:
    """A rank's (..., n_local) lanes of a rank mesh assembled into (...,
    n) in shard order (one ``all_gather``)."""
    return torch.cat(mesh.all_gather(t.contiguous()), dim=-1)


def _gather_grads(mesh: FeatureMesh, g_x, g_tabs, vecs):
    """The rank's grads assembled over the ranks in one ``all_gather`` of
    their bytes: g_x's (rows, n_local) slab into (rows, n), each step's
    (1, ...) table grad into (S, ...) (each element has one owning rank,
    so this is the sum over the ranks, exactly), each (n_local,) vector
    into (n,) (None stays None)."""
    parts = [g_x, *g_tabs, *(v for v in vecs if v is not None)]
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in parts])
    per_rank = []
    for buf in mesh.all_gather(flat):
        out, off = [], 0
        for t in parts:
            nb = t.numel() * t.element_size()
            out.append(buf[off: off + nb].view(t.dtype).view(t.shape))
            off += nb
        per_rank.append(out)

    def joined(i, dim):
        return torch.cat([r[i] for r in per_rank], dim=dim)

    nt = len(g_tabs)
    tabs = [joined(1 + i, 0) for i in range(nt)]
    out_vecs, i = [], 1 + nt
    for v in vecs:
        out_vecs.append(None if v is None else joined(i, -1))
        i += v is not None
    return joined(0, -1), tabs, out_vecs


class _ShardedCore(torch.autograd.Function):
    """The sharded operator: ``x2`` ([E,] rows, in_width or n) -> ([E,]
    rows, out_width or n), differentiable in x2, the step tables and the
    vector operands.  On a rank mesh x2, the output and their grads are
    replicated over the ranks; each rank walks its own shard and the
    output, g_x and the parameter grads are assembled over the group."""

    @staticmethod
    def forward(ctx, plan: ShardPlan, d_in, d_out, bias, x2, *tables):
        qtabs = _quant_tables(plan, tables)
        ops = _shard_operands(plan, tables, qtabs, d_in, d_out, bias)
        glob = dict(tabs=tables, qtabs=qtabs, d_in=_mine(plan, d_in),
                    d_out=_mine(plan, d_out), bias=_mine(plan, bias))
        y2, (x_res, step_ins, z_last) = _walk_fwd(plan, ops, glob, x2)
        if plan.ranked:
            y2 = _gather_lanes(plan.mesh, y2)
        if plan.out_width is not None:
            y2 = y2[..., :plan.out_width].contiguous()
        ctx.plan = plan
        ctx.x_dtype = x2.dtype
        ctx.save_for_backward(d_in, d_out, bias, x_res, z_last, *step_ins,
                              *tables)
        return y2

    @staticmethod
    def backward(ctx, gy2):
        plan = ctx.plan
        d_in, d_out, bias, x_res, z_last, *rest = ctx.saved_tensors
        step_ins = rest[:len(plan.steps)]
        tables = tuple(rest[len(plan.steps):])
        qtabs = _quant_tables(plan, tables)
        ops = _shard_operands(plan, tables, qtabs, d_in, d_out, bias)
        glob = dict(tabs=tables, qtabs=qtabs, d_in=_mine(plan, d_in),
                    d_out=_mine(plan, d_out), bias=_mine(plan, bias))
        gy2 = gy2.to(ctx.x_dtype)
        if plan.out_width is not None:
            gy2 = F.pad(gy2, (0, plan.n - plan.out_width))
        gy2 = _mine(plan, gy2).contiguous()
        g_x2, g_tabs, g_din, g_dout, g_bias = _walk_bwd(
            plan, ops, glob, (x_res, step_ins, z_last), gy2)
        if plan.ranked:
            g_x2, g_tabs, (g_din, g_dout, g_bias) = _gather_grads(
                plan.mesh, g_x2, g_tabs, (g_din, g_dout, g_bias))
        if plan.in_width is not None:
            g_x2 = g_x2[..., :plan.in_width]

        def vec(g, like):
            return None if like is None else g.to(like.dtype)

        return (None, vec(g_din, d_in), vec(g_dout, d_out),
                vec(g_bias, bias), g_x2,
                *(g.to(t.dtype) for g, t in zip(g_tabs, tables)))


def _device_of(dev: torch.device) -> torch.device:
    """``dev`` with its index: a bare ``cuda`` names the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _on_local_rows(params, x, cfg, mesh: FeatureMesh, in_width,
                   out_width) -> torch.Tensor:
    """A ``DTensor`` x (a dry-run's device mesh: rows split over the data
    axes, the feature axis whole on every rank of the rank mesh's group)
    runs the rank walk on this rank's own rows and whole params; the
    output is placed as x, and the params' grads are partial over the mesh
    dims that split the rows (the walk assembles them over its group)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    x = par_ctx.whole_features(x)
    pl = tuple(x.placements)
    grad_pl = [Partial() if p.is_shard() else Replicate() for p in pl]
    local = {k: (v.to_local(grad_placements=grad_pl)
                 if isinstance(v, DTensor) else v)
             for k, v in ((k, params[k]) for k in params.keys())}
    y = spm_apply_sharded(local, x.to_local(), cfg, mesh, in_width=in_width,
                          out_width=out_width)
    return DTensor.from_local(y, x.device_mesh, pl, run_check=False)


def spm_apply_sharded(params, x: torch.Tensor, cfg, mesh: FeatureMesh, *,
                      in_width: Optional[int] = None,
                      out_width: Optional[int] = None) -> torch.Tensor:
    """The feature-sharded SPM forward, differentiable in x and the
    parameters: semantically ``core.spm.spm_apply`` on the same params and
    config.  The mesh's ``"model"`` axis must have ``cfg.n_shards`` shards:
    on a one-process mesh all on ``x``'s device, on a rank mesh one a rank
    (x, the params and the output replicated over the ranks; each rank
    walks its own shard).

    ``x`` is (..., in_width or n).  A rectangular input enters whole and
    the first local run reads each shard's window of it (K1's and K2's
    ``col_base`` mode, or K5's read; a local gather without the kernel
    path).  The output is assembled from the shards' slabs and cut to
    ``out_width``.  ``cfg.overlap`` engages the overlap schedule
    (``core/eligibility.resolve_overlap``), its pairs fused into K5/K6 on
    a CUDA input with the kernel path on; ``cfg.quant_coeffs`` with the
    kernel path gives every local run int8 tables (``quant_cf``), and
    ``cfg.quant_acts`` does not apply here.

    Params stacked over a leading expert axis (tables (E, L, n/2, 4),
    vectors (E, n)) take x (E, ..., in_width or n): every step runs all
    experts at once, each over its own rows (the reference's ``jax.vmap``
    of this executor).
    """
    if par_ctx.placements_of(x) is not None:
        return _on_local_rows(params, x, cfg, mesh, in_width, out_width)
    n = cfg.n
    if mesh.shape[AXIS] != cfg.n_shards:
        raise ValueError(
            f"mesh axis {AXIS!r} has size {mesh.shape[AXIS]}, operator has "
            f"n_shards={cfg.n_shards}")
    home = _device_of(x.device)
    if mesh.ranked:
        if _device_of(mesh.device) != home:
            raise ValueError(f"rank {mesh.rank}'s shard is on "
                             f"{mesh.device}, input on {x.device}")
    elif any(_device_of(d) != home for d in mesh.devices):
        raise ValueError(
            f"mesh shards on {[str(d) for d in mesh.devices]}, input on "
            f"{x.device}: every shard must be on the input's device")
    # rows shard over no mesh axis here: a FeatureMesh has no data axis,
    # and a pod member gets its rows before the model (every rank builds
    # the global batch and takes its own, ``parallel/sharding.member_rows``)
    in_width = None if in_width == n else in_width
    out_width = None if out_width == n else out_width
    steps = plan_steps(n, cfg.pairing.strides(), cfg.n_shards)
    n_local = n // cfg.n_shards
    in_w = in_width if in_width is not None else n
    if x.shape[-1] != in_w:
        raise ValueError(f"expected (..., {in_w}), got {tuple(x.shape)}")
    coeffs = spm_mod.stage_coeffs(params, cfg)
    experts = coeffs.dim() == 4
    if experts and mesh.ranked:
        raise NotImplementedError(
            "an expert stack over a mesh of ranks is expert parallelism "
            "(ROADMAP.md §1 item 6b), not ported yet")
    if experts and x.shape[0] != coeffs.shape[0]:
        raise ValueError(f"expected x ({coeffs.shape[0]}, ..., {in_w}), "
                         f"got {tuple(x.shape)}")
    lead = x.shape[:-1]
    x2 = (x.reshape(x.shape[0], -1, in_w) if experts
          else x.reshape(-1, in_w)).contiguous()
    use_kernel = resolve_shard_kernel(cfg, steps)
    overlap = resolve_overlap(cfg, steps)
    rdma = overlap and resolve_rdma(use_kernel, x.device.type == "cuda")
    plan = ShardPlan(
        n=n, n_local=n_local, n_shards=cfg.n_shards, steps=steps,
        has_din=cfg.use_diag, has_dout=cfg.use_diag, has_bias=cfg.use_bias,
        use_kernel=use_kernel, in_width=in_width, out_width=out_width,
        row_blocks=(() if not overlap
                    else (x2.shape[-2],) if not split_rows(rdma, mesh.ranked)
                    else _overlap_row_blocks(steps, n_local, x2.shape[-2],
                                             x2.element_size(), use_kernel)),
        rdma_crosses=_rdma_cross_indices(steps, n_local) if rdma else (),
        quant_cf=use_kernel and bool(cfg.quant_coeffs), experts=experts,
        mesh=mesh)
    if plan.use_kernel:
        coeffs = coeffs.float()        # the kernels read f32 tables
    tables = _step_tables(coeffs, steps, cfg.n_shards, n_local)

    def vec(name, present):
        if not present:
            return None
        v = params[name]
        return v.float().contiguous() if plan.use_kernel else v

    y2 = _ShardedCore.apply(plan, vec("d_in", cfg.use_diag),
                            vec("d_out", cfg.use_diag),
                            vec("bias", cfg.use_bias), x2, *tables)
    return y2.reshape(*lead, y2.shape[-1])
