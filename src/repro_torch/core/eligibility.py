"""Fast-path predicates for the SPM executors (port of
``repro/core/eligibility.py``).

The tri-state knobs keep their meaning with one change: ``None`` (auto)
means "on the card" here where it meant "on TPU" there.  The port's home is the
GPU, so auto resolves to the kernel path; on CPU tensors the kernel
wrappers run their plain PyTorch versions, which makes the port's CPU path
the reference's forced-kernel path (``use_kernel=True``,
``spm_block_fuse=True``, interpret mode).  ``False`` keeps the composition
(``core/spm.py``), which computes in ``x.dtype``.

The feature-sharded executor (``parallel/spm_shard.py``) reads
``plan_steps``, ``sharded_eligible``, ``resolve_shard_kernel``, and for its
overlap schedule ``overlap_segments``, ``resolve_overlap``, ``resolve_rdma``
and ``OVERLAP_ROW_BLOCKS``.  The port has no TPU, so the overlap knob's auto
stays off (``True`` forces the schedule), and the fused pair kernels (K5,
K6) take the place of the reference's RDMA pair whenever the kernel path is
on and the input is on the card.  The matrix of which executor can take an
operator is the reference's:

===========================  ===========  ============  ================
property                     composition  fused kernel  sharded executor
===========================  ===========  ============  ================
permutation pairings         yes          no            no
odd n                        yes          no            no
backward=custom_inverse      yes          no            no
n % n_shards != 0            yes          yes           no
odd n_local (stride-1 list)  yes          yes           no
non-XOR cross stride         yes          yes           no
===========================  ===========  ============  ================
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

from repro_torch.core.pairings import Schedule

__all__ = ["plan_steps", "sharded_eligible", "resolve_shard_kernel",
           "resolve_overlap", "resolve_rdma", "split_rows",
           "overlap_segments",
           "OVERLAP_ROW_BLOCKS", "kernel_eligible", "use_fused_kernel", "TINY_ROW_THRESHOLD",
           "tiny_row_call", "BLOCK_MAX_TILE", "BLOCK_ACTIVATIONS",
           "block_fusion_eligible", "resolve_block_fuse",
           "quant_acts_eligible"]

# Row blocks a shard slab splits into under the overlap schedule (the
# reference's value): block i's exchange can hide under block i+1's work.
OVERLAP_ROW_BLOCKS = 4

# Decode calls reach the kernels with rows = batch slots (1-8).  At or
# under this row count the planner widens feature tiles
# (kernels/ops.plan_runs_for_rows) so a decode step makes fewer runs.
TINY_ROW_THRESHOLD = 8


def tiny_row_call(n_rows: int) -> bool:
    """Whether a call with ``n_rows`` flattened rows takes the tiny-row
    (decode) plan with wider feature tiles."""
    return 0 < n_rows <= TINY_ROW_THRESHOLD


def quant_acts_eligible(runs) -> bool:
    """Whether a run plan (``((strides, n_tile), ...)``) can move int8
    activations: one feature tile across every run, because run r's
    per-(row block, tile) scales are run r+1's input scales.  Other plans
    keep f32/bf16 activation I/O, the reference's own fallback; int8
    coefficients have no such condition."""
    return len({n_tile for _, n_tile in runs}) == 1


def _is_pow2(k: int) -> bool:
    return k > 0 and (k & (k - 1)) == 0


@functools.lru_cache(maxsize=None)
def plan_steps(n: int, strides: Tuple[int, ...],
               n_shards: int) -> Tuple[tuple, ...]:
    """Split a stride schedule into shard-executable steps:
    ``("local", stage_offset, run_strides)`` for a maximal run of stages
    whose pairs stay inside one ``n_local = n / n_shards`` block, and
    ``("cross", stage_index, k)`` for a stage of stride ``k * n_local``
    (``k`` a power of two) that pairs shard ``j`` with shard ``j XOR k``.
    Raises ``ValueError`` for a stage that is neither."""
    if n % n_shards:
        raise ValueError(f"n={n} not divisible by n_shards={n_shards}")
    n_local = n // n_shards
    steps = []
    run: list = []
    run_start = 0
    for ell, s in enumerate(strides):
        if n % (2 * s):
            raise ValueError(f"stride {s} invalid for n={n}")
        if s < n_local and n_local % (2 * s) == 0:
            if not run:
                run_start = ell
            run.append(s)
            continue
        if run:
            steps.append(("local", run_start, tuple(run)))
            run = []
        k, rem = divmod(s, n_local)
        if rem or not _is_pow2(k) or n_shards % (2 * k):
            raise ValueError(
                f"stride {s} is neither local to n_local={n_local} nor a "
                f"power-of-two multiple partner exchange over "
                f"{n_shards} shards")
        steps.append(("cross", ell, k))
    if run:
        steps.append(("local", run_start, tuple(run)))
    return tuple(steps)


@functools.lru_cache(maxsize=None)
def overlap_segments(steps: Tuple[tuple, ...]) -> Tuple[tuple, ...]:
    """Group ``plan_steps`` output into overlap segments: ``("pair",
    local_step, cross_step)`` for a local run followed by a cross stage
    (the shape K5/K6 fuse), ``("one", step)`` for any other step."""
    segs = []
    i = 0
    while i < len(steps):
        if (steps[i][0] == "local" and i + 1 < len(steps)
                and steps[i + 1][0] == "cross"):
            segs.append(("pair", steps[i], steps[i + 1]))
            i += 2
        else:
            segs.append(("one", steps[i]))
            i += 1
    return tuple(segs)


def sharded_eligible(cfg, sched: Optional[Schedule] = None) -> bool:
    """Whether the sharded executor can express this operator exactly:
    even n divisible by ``n_shards > 1``, all-structured stages each either
    shard-local or an XOR partner exchange, and a backward other than
    ``custom_inverse`` (the executor saves step inputs, not outputs)."""
    if cfg.n_shards <= 1 or cfg.odd or cfg.n % cfg.n_shards:
        return False
    if cfg.backward == "custom_inverse":
        return False
    sched = cfg.pairing if sched is None else sched
    if not sched.all_structured:
        return False
    try:
        plan_steps(cfg.n, sched.strides(), cfg.n_shards)
    except ValueError:
        return False
    return True


def resolve_shard_kernel(cfg, steps) -> bool:
    """Whether the sharded executor's local runs take the kernel path:
    ``False`` never, a schedule without local steps never (nothing to
    fuse), otherwise (``True`` or auto) the kernels."""
    if cfg.use_kernel is False:
        return False
    return any(step[0] == "local" for step in steps)


def resolve_overlap(cfg, steps) -> bool:
    """Whether the sharded executor takes the overlap schedule (row-block
    split steps, pairs fused into K5/K6 on the card): ``False`` never, a
    schedule without a cross stage never (nothing to overlap), ``True``
    always, and auto (``None``) never: the reference engages it on auto
    only on a TPU."""
    overlap = getattr(cfg, "overlap", None)
    if overlap is False or not any(step[0] == "cross" for step in steps):
        return False
    return bool(overlap)


def resolve_rdma(use_kernel: bool, on_cuda: bool) -> bool:
    """Whether the overlap schedule's ``{local run -> cross}`` pairs run as
    fused kernels (K5 forward, K6 backward): the kernel path on and the
    input on the card.  On a one-process mesh a pair is one launch over
    every shard; on a mesh of ranks it is K5's and K6's rank mode, the
    partner's slab over IPC slots between the ranks.  Elsewhere
    (a CPU input, a CPU rank mesh, the composition) the pairs take the
    per-block exchange, as the reference's interpret mode does."""
    return bool(use_kernel and on_cuda)


def split_rows(rdma: bool, ranked: bool) -> bool:
    """Whether the overlap schedule splits the rows into the reference's
    row blocks (``OVERLAP_ROW_BLOCKS``): across ranks, where there is
    exchange latency to hide, and wherever the pairs take the per-block
    exchange; not for the one-process fused pairs on the card, whose
    partners exchange on chip (one block)."""
    return ranked or not rdma


def kernel_eligible(cfg, sched: Optional[Schedule] = None) -> bool:
    """Whether the fused kernel can express this operator exactly:
    all-structured (stride) stages, even n, and a backward mode other than
    ``custom_inverse``."""
    sched = cfg.pairing if sched is None else sched
    return (sched.all_structured and not cfg.odd
            and cfg.backward != "custom_inverse")


def use_fused_kernel(cfg, sched: Optional[Schedule] = None) -> bool:
    """Resolve the tri-state ``use_kernel`` knob: ``False`` never, an
    ineligible operator never, otherwise (``True`` or auto) the kernel
    path."""
    if cfg.use_kernel is False:
        return False
    return kernel_eligible(cfg, sched)


# The block kernel (K3) keeps a whole row of width n in shared memory, so
# the feature axis must fit one tile; the same cap as the reference keeps
# the two packages' routing identical.
BLOCK_MAX_TILE = 2048

# Activations the block kernel's epilogue computes (None: norm prologue
# only, the fused-qkv entry).  swiglu is excluded: its gate is a second
# SPM over the same input, not a chainable epilogue.
BLOCK_ACTIVATIONS = (None, "relu", "silu", "gelu")


def block_fusion_eligible(n: int, strides1, strides2=None,
                          activation=None) -> bool:
    """Whether a norm -> stack 1 [-> activation -> stack 2] block runs as
    one block-kernel launch: even ``n <= BLOCK_MAX_TILE``, every stride of
    either stack tile-local at full width, and a supported activation."""
    if n <= 0 or n % 2 or n > BLOCK_MAX_TILE:
        return False
    for s in tuple(strides1) + tuple(strides2 if strides2 else ()):
        if n % (2 * int(s)):
            return False
    return activation in BLOCK_ACTIVATIONS


def resolve_block_fuse(block_fuse: Optional[bool], eligible: bool) -> bool:
    """Resolve the tri-state ``spm_block_fuse`` knob: ``False`` never, an
    ineligible block never, otherwise (``True`` or auto) the block
    kernel."""
    return eligible and block_fuse is not False
