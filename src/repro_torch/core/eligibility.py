"""Fast-path predicates for the single-device SPM executors.

Port of the single-device half of ``repro/core/eligibility.py``.  The
tri-state knobs keep their meaning with one change: ``None`` (auto) means
"on the card" here where it meant "on TPU" there.  The port's home is the
GPU, so auto resolves to the kernel path; on CPU tensors the kernel
wrappers run their plain PyTorch versions, which makes the port's CPU path
the reference's forced-kernel path (``use_kernel=True``,
``spm_block_fuse=True``, interpret mode).  ``False`` keeps the composition
(``core/spm.py``), which computes in ``x.dtype``.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.pairings import Schedule

__all__ = ["kernel_eligible", "use_fused_kernel", "TINY_ROW_THRESHOLD",
           "tiny_row_call", "BLOCK_MAX_TILE", "BLOCK_ACTIVATIONS",
           "block_fusion_eligible", "resolve_block_fuse",
           "quant_acts_eligible"]

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
