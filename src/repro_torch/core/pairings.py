"""Pairing schedules for Stagewise Pairwise Mixers (paper §2.1, §5).

A numpy-only copy of ``repro/core/pairings.py``: the port imports nothing
from the JAX package, and its schedules must equal the reference's
bitwise (``tests/test_torch_spm.py`` holds them to that).

A *pairing* for one stage partitions the ``n`` coordinates into ``n//2``
disjoint pairs (plus one optional unpaired residual lane when ``n`` is odd).
The paper allows arbitrary pairings per stage; on TPU arbitrary pairings
lower to dynamic gathers, so we distinguish two representations:

* **Structured (stride) pairings** — pair ``(i, i + s)`` inside contiguous
  groups of ``2s``.  These lower to a reshape ``(n,) -> (n/2s, 2, s)`` plus a
  vectorized 2x2 mix: a pure layout transform, VPU-friendly, no gather.
  Valid whenever ``n % (2*s) == 0``.
* **General (permutation) pairings** — an explicit index permutation; pairs
  are ``(perm[2i], perm[2i+1])``.  Paper-faithful fully-general path.

``Schedule`` holds one entry per stage.  ``two_level_schedule`` produces the
sharding-aware ordering used by the distributed fast path (DESIGN.md §3.4):
all shard-local strides first, then the cross-shard strides, so the latter
map onto ``collective_permute`` partner exchanges.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "Stage",
    "Schedule",
    "butterfly_schedule",
    "brick_schedule",
    "random_schedule",
    "two_level_schedule",
    "valid_strides",
    "connectivity_components",
]


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: perm arrays
class Stage:
    """One mixing stage: either a stride (structured) or a permutation."""

    stride: Optional[int] = None          # structured pairing if not None
    perm: Optional[np.ndarray] = None     # general pairing if not None

    def __post_init__(self):
        if (self.stride is None) == (self.perm is None):
            raise ValueError("exactly one of stride/perm must be set")

    @property
    def structured(self) -> bool:
        return self.stride is not None


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash (see Stage)
class Schedule:
    """L pairing stages over an n-dimensional feature space."""

    n: int
    stages: tuple  # tuple[Stage, ...]

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def n_pairs(self) -> int:
        return self.n // 2

    @property
    def all_structured(self) -> bool:
        return all(s.structured for s in self.stages)

    def strides(self) -> tuple:
        """The per-stage stride tuple of an all-structured schedule (the
        form the fused kernels and the distributed executor consume)."""
        if not self.all_structured:
            raise ValueError("schedule contains general (perm) stages")
        return tuple(s.stride for s in self.stages)


def valid_strides(n: int) -> list:
    """All strides ``s`` with ``n % (2*s) == 0``, ascending."""
    return [s for s in range(1, n // 2 + 1) if n % (2 * s) == 0]


def _pow2_strides(n: int) -> list:
    """Power-of-two strides valid for n, ascending: 1, 2, 4, ..."""
    out, s = [], 1
    while n % (2 * s) == 0:
        out.append(s)
        s *= 2
    return out


def _butterfly_strides(n: int) -> list:
    """The butterfly stride recipe for width n: power-of-two strides
    ascending, then (for n = 2^k * m with odd m > 1) the odd-factor
    super-strides m * 2^j largest first.  Shared by butterfly_schedule and
    every level of two_level_schedule (the recipe applies alike to the
    full width, the shard-local block, and the shard index)."""
    base = _pow2_strides(n)
    k = len(base)
    m = n >> k
    cross = []
    if m > 1 and k:
        for j in range(k - 1, -1, -1):
            s = m << j
            if n % (2 * s) == 0:
                cross.append(s)
    return base + cross


def butterfly_schedule(n: int, n_stages: int) -> Schedule:
    """Default TPU-native schedule: power-of-two strides, ascending, plus
    "super-strides" that cross the odd-factor blocks of non-power-of-two n.

    For ``n = 2^k * m`` (m odd), strides ``1..2^(k-1)`` fully mix each
    ``2^k`` block; appended strides ``m*2^j`` (largest first) connect the m
    blocks.  The result is cycled/truncated to ``n_stages``.  Connectivity of
    the union of chosen strides is guaranteed (tested via
    ``connectivity_components``).
    """
    if n < 2 or n % 2:
        raise ValueError(f"butterfly_schedule requires even n >= 2, got {n}")
    cycle = _butterfly_strides(n)
    strides = [cycle[i % len(cycle)] for i in range(n_stages)]
    return Schedule(n=n, stages=tuple(Stage(stride=s) for s in strides))


def brick_schedule(n: int, n_stages: int) -> Schedule:
    """Adjacent pairing with alternating half-offset (brick-wall pattern).

    Stage 2t pairs (2i, 2i+1); stage 2t+1 pairs (2i+1, 2i+2) cyclically.
    Mixing radius grows linearly — included for ablations (paper permits any
    schedule); butterfly mixes exponentially faster.
    """
    if n < 2 or n % 2:
        raise ValueError("brick_schedule requires even n >= 2")
    stages = []
    for ell in range(n_stages):
        if ell % 2 == 0:
            stages.append(Stage(stride=1))
        else:
            perm = np.roll(np.arange(n), -1)  # pairs (2i+1, 2i+2)
            stages.append(Stage(perm=perm))
    return Schedule(n=n, stages=tuple(stages))


def random_schedule(n: int, n_stages: int, seed: int = 0) -> Schedule:
    """Fully general pairings: an independent random perfect matching per
    stage (paper §5: pairings 'may be chosen arbitrarily and independently').
    Odd n leaves the last permuted coordinate unpaired (residual lane)."""
    rng = np.random.default_rng(seed)
    stages = []
    for _ in range(n_stages):
        stages.append(Stage(perm=rng.permutation(n)))
    return Schedule(n=n, stages=tuple(stages))


def two_level_schedule(n: int, n_stages: int, n_shards: int) -> Schedule:
    """Sharding-aware butterfly: all shard-local strides first (stride <
    n_local), then cross-shard strides (multiples of n_local, ascending).

    With the feature axis sharded ``n = n_shards * n_local``, every stage is
    one of exactly two shapes the distributed executor
    (``parallel/spm_shard.py``) can realize:

    * **local** — ``n_local % (2*s) == 0``: pairs stay inside one shard
      block, so the stage runs on the shard-resident slab (fused Pallas
      kernel on TPU) with no communication.  Local strides follow the
      butterfly recipe applied WITHIN the block (power-of-two strides of
      ``n_local`` plus its odd-factor super-strides).
    * **cross** — ``s = k * n_local`` with ``k`` a power of two and
      ``n_shards % (2*k) == 0``: the stage pairs shard ``j`` with shard
      ``j XOR k`` — a partner exchange implementable as
      ``collective_permute`` plus a local 2x2 mix.

    The previous builder reused the GLOBAL power-of-two strides for the
    cross list, which for odd-factor ``n_local`` (e.g. n=48, 8 shards ->
    n_local=6) could emit strides straddling shard blocks without being a
    multiple of ``n_local``; crosses are now derived from the shard index
    butterfly directly, so the XOR-partner invariant holds by construction.
    When no valid local stride exists (e.g. ``n_local == 1`` or odd
    ``n_local``) the schedule falls back to ``local = [1]`` — still a valid
    stage for the unsharded executor (``n`` even), though such a stage pairs
    across shard boundaries and keeps the operator off the distributed path.
    """
    if n % n_shards:
        raise ValueError(f"n={n} not divisible by n_shards={n_shards}")
    n_local = n // n_shards
    local = _butterfly_strides(n_local)
    # Cross multipliers k follow the butterfly recipe ON THE SHARD INDEX:
    # power-of-two k give XOR partner exchanges; for even non-power-of-two
    # n_shards the odd-factor super-strides connect the remaining shard
    # blocks — valid global strides, but NOT partner exchanges, so such
    # schedules stay off the distributed executor (it is restricted to
    # power-of-two shard counts) while keeping the operator fully
    # connected.
    ks = _butterfly_strides(n_shards)
    cross = [k * n_local for k in ks]
    if not ks and n_shards > 1:
        # odd n_shards: no block-aligned cross stride exists at all (any
        # k*n_local needs n_shards % 2k == 0).  Fall back to the global
        # butterfly strides >= n_local so connectivity is preserved.
        cross = [s for s in _butterfly_strides(n) if s >= n_local]
    if not local:
        local = [1]
    cycle = sorted(set(local)) + sorted(set(cross))
    strides = [cycle[i % len(cycle)] for i in range(n_stages)]
    return Schedule(n=n, stages=tuple(Stage(stride=s) for s in strides))


def make_schedule(kind: str, n: int, n_stages: int, *, n_shards: int = 1,
                  seed: int = 0) -> Schedule:
    """Build a pairing schedule by kind: "butterfly" (default TPU-native),
    "brick" (ablation), "random" (fully general pairings), or "two_level"
    (sharding-aware; ``n_shards`` selects the block split)."""
    if kind == "butterfly":
        return butterfly_schedule(n, n_stages)
    if kind == "brick":
        return brick_schedule(n, n_stages)
    if kind == "random":
        return random_schedule(n, n_stages, seed=seed)
    if kind == "two_level":
        return two_level_schedule(n, n_stages, n_shards)
    raise ValueError(f"unknown schedule kind: {kind!r}")


def default_n_stages(n: int, cap: int = 12) -> int:
    """Paper §2.2 / §9.2: L <= log2 n for small n, log2 n for large n; the
    paper's own large-width runs fix L=12.  We use min(ceil(log2 n), cap)."""
    return max(1, min(int(np.ceil(np.log2(max(n, 2)))), cap))


# ---------------------------------------------------------------------------
# analysis helpers (test/benchmark only)
# ---------------------------------------------------------------------------

def _stage_pairs(stage: Stage, n: int) -> np.ndarray:
    """Return (n//2, 2) int array of paired coordinate indices."""
    if stage.structured:
        s = stage.stride
        g = n // (2 * s)
        idx = np.arange(n).reshape(g, 2, s)
        return np.stack([idx[:, 0, :].ravel(), idx[:, 1, :].ravel()], axis=1)
    perm = stage.perm
    npairs = len(perm) // 2
    return perm[: 2 * npairs].reshape(npairs, 2)


def connectivity_components(schedule: Schedule) -> int:
    """Number of connected components of the union pairing graph.  1 means
    the composed operator can couple every coordinate with every other."""
    parent = list(range(schedule.n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for st in schedule.stages:
        for a, b in _stage_pairs(st, schedule.n):
            ra, rb = find(int(a)), find(int(b))
            if ra != rb:
                parent[ra] = rb
    return len({find(i) for i in range(schedule.n)})
