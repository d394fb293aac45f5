"""The backward engine's planner (``kernels/spm_stack.py`` ``bwd_plan``)
and its order of summation, on the CPU.

K2 and K6 run on one engine (``csrc/spm_bwd_engine.cuh``): a cluster of
lane blocks holds a feature tile for a row group's whole range, and a row
group walks its chunks of ``chunk_rows`` rows.  These tests hold the pure
Python side of it: every row in exactly one chunk, every pair of a stage in
exactly one slot of the cluster (one writer per partial entry), the shared
memory and cluster within the card's limits, and the engine's order of the
sums over rows, emulated in float32, within gamma_rows of the plain
version's grads -- which a dropped chunk of rows breaks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import spm_stack as K  # noqa: E402
from repro_torch.kernels.ref import stages_collect, walk_back  # noqa: E402

QKV = tuple(1 << i for i in range(11))
SHARD_FFN = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)

# (label, n_tile, strides, tiles, io bytes, x bytes, K6) at the shapes of
# chip_smoke.py's K2 and K6 phases: the o run and the FFN runs (2048-wide
# tiles, then the 3072 stage on a 6144 tile, and the tiny-row 6144 run),
# int8 x, the sharded gate/up (768-wide tiles) and o (512) runs, and K6's
# q/k/v/o pair (4 shards of 512) and 2-shard pair (1024).
SHAPES = [
    ("o", 2048, QKV, 1, 2, 2, False),
    ("o f32", 2048, QKV, 1, 4, 4, False),
    ("o int8 x", 2048, QKV, 1, 2, 1, False),
    ("gate/up run 1", 2048, QKV, 3, 2, 2, False),
    ("gate/up run 2", 6144, (3072,), 1, 2, 2, False),
    ("tiny-row run", 6144, QKV + (3072,), 1, 2, 2, False),
    ("tiny-row run f32", 6144, QKV + (3072,), 1, 4, 4, False),
    ("up shard", 768, SHARD_FFN, 2, 2, 2, False),
    ("o shard", 512, QKV[:9], 1, 2, 2, False),
    ("K6 q/k/v/o", 512, QKV[:9], 2, 2, 2, True),
    ("K6 q/k/v/o f32", 512, QKV[:9], 2, 4, 4, True),
    ("K6 S=2", 1024, QKV[:10], 1, 2, 2, True),
]
ROWS = [1, 8, 1000, 4072, 4096]


def _plan(n_rows, nt, strides, tiles, io, xb, k6):
    if k6:
        return K.bwd_plan(n_rows, nt, strides, tiles, io, nvec=5,
                          package=True, sides=2)
    return K.bwd_plan(n_rows, nt, strides, tiles, io, xb)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("label, nt, strides, tiles, io, xb, k6", SHAPES)
def test_plan_covers_rows_once_within_the_card(label, nt, strides, tiles, io,
                                               xb, k6, rows):
    """Every row in exactly one chunk of one group, every group walking at
    least one chunk; the block's shared memory within 232,448 B and the
    planner's own byte count; a cluster of at most 8 blocks; at most 512
    threads a block."""
    p = _plan(rows, nt, strides, tiles, io, xb, k6)
    assert p.lane_blocks * p.lanes == nt and p.pair_slots * 2 == p.lanes
    assert p.cluster == p.lane_blocks * (2 if k6 else 1) <= 8
    assert p.smem_bytes <= K.SMEM_BYTES
    modes = K.bwd_stage_modes(nt, p.lane_blocks, strides)
    passes = len(K.bwd_passes(nt, p.lane_blocks, strides))
    gyb = 4 if modes[-1] == "B" and not k6 else io
    assert p.smem_bytes == K.bwd_smem_bytes(len(strides), p.lanes,
                                            p.chunk_rows, 5 if k6 else 3,
                                            io if k6 else xb, io, k6,
                                            p.row_slices, "B" in modes,
                                            passes, gyb)
    assert p.threads == p.pair_slots * p.row_slices <= K.BWD_MAX_THREADS
    chunks = K.bwd_row_chunks(rows, p.chunk_rows, p.groups)
    seen = np.zeros(rows, dtype=int)
    for _, r0, n in chunks:
        assert 0 < n <= p.chunk_rows
        seen[r0: r0 + n] += 1
    assert (seen == 1).all()
    assert {g for g, _, _ in chunks} == set(range(p.groups))


@pytest.mark.parametrize("label, nt, strides, tiles, io, xb, k6", SHAPES)
def test_each_pair_has_one_slot(label, nt, strides, tiles, io, xb, k6):
    """At every stage the slots of a cluster's lane blocks cover the tile's
    pairs exactly once (one writer per partial entry), and a stage the
    engine runs in one of its layouts keeps both lanes of each of a
    block's pairs in that block: lanes [c w, (c+1) w) in layout A, the
    lanes equal to c mod C in layout B."""
    for rows in (8, 4096):
        p = _plan(rows, nt, strides, tiles, io, xb, k6)
        C, w = p.lane_blocks, p.lanes
        modes = K.bwd_stage_modes(nt, C, strides)
        for s, mode, slots in zip(strides, modes,
                                  K.bwd_slot_pairs(nt, C, strides)):
            flat = sorted(q for row in slots for q in row)
            assert flat == list(range(nt // 2)), (label, s)
            for c, row in enumerate(slots):
                for q in row:
                    i0 = (q // s) * 2 * s + q % s
                    if mode == "A":
                        assert i0 // w == c and (i0 + s) // w == c
                    elif mode == "B":
                        assert i0 % C == c and (i0 + s) % C == c
                    elif mode == "paired":
                        assert c in (i0 // w, (i0 + s) // w)


@pytest.mark.parametrize("label, nt, strides, tiles, io, xb, k6", SHAPES)
def test_fused_passes_cover_each_pair_once(label, nt, strides, tiles, io, xb,
                                           k6):
    """A pass fusing two stages gives each thread a quad of lanes: across
    the quads of every block the first stage's pairs (lanes 0-1, 2-3 of a
    quad) and the second's (0-2, 1-3) each come exactly once, and a quad's
    lanes all lie in the block that walks it (layout A: its own range;
    layout B: the lanes equal to c mod C)."""
    for rows in (8, 4096):
        p = _plan(rows, nt, strides, tiles, io, xb, k6)
        C, w = p.lane_blocks, p.lanes
        for first, n in K.bwd_passes(nt, C, strides):
            if n == 1:
                continue
            lay = K.bwd_stage_modes(nt, C, strides)[first]
            quads = K.bwd_quad_lanes(nt, C, strides, first)
            for j, pairs in ((0, ((0, 1), (2, 3))), (1, ((0, 2), (1, 3)))):
                s = strides[first + j]
                seen = set()
                for c, qs in enumerate(quads):
                    for qd in qs:
                        for a, b in pairs:
                            i0, i1 = qd[a], qd[b]
                            assert i1 == i0 + s and i0 % (2 * s) < s
                            seen.add(i0)
                        for i in qd:
                            assert (i // w == c) if lay == "A" else \
                                (i % C == c)
                assert len(seen) == nt // 2, (label, first, j)


def test_passes_fuse_nested_strides():
    """The 2048-wide tile over 8 blocks walks 11 stages in 6 passes (five
    fused pairs, the last of them in layout B, then the 1024 stage); the
    sharded 768-wide tile fuses only (1, 2)."""
    assert K.bwd_passes(2048, 8, QKV) == \
        [(0, 2), (2, 2), (4, 2), (6, 2), (8, 2), (10, 1)]
    assert K.bwd_passes(768, 2, SHARD_FFN)[:2] == [(0, 2), (2, 1)]
    assert K.bwd_passes(96, 8, (1, 2, 3, 6, 24, 48, 4, 12)) == \
        [(0, 2), (2, 2), (4, 2), (6, 1), (7, 1)]


def test_strides_take_the_layout_that_holds_them():
    """At the 2048-wide tile over 8 blocks of 256 lanes, strides 1..128
    run in layout A and the run 256, 512, 1024 in layout B; a lone stride
    past the blocks reaches across them, one lane local where it is a
    multiple of the block width (the 3072 stage over 8 blocks of 768, K6's
    256 over 2 blocks of 256), both lanes wherever they are otherwise (the
    sharded 768-wide tile's 64 over 4 blocks of 192)."""
    assert K.bwd_stage_modes(2048, 8, QKV) == ["A"] * 8 + ["B"] * 3
    assert K.bwd_stage_modes(6144, 8, (3072,)) == ["paired"]
    assert K.bwd_stage_modes(512, 2, QKV[:9]) == ["A"] * 8 + ["paired"]
    assert K.bwd_stage_modes(768, 4, SHARD_FFN) == ["A"] * 11 + ["cross"]
    # the GPU tests' forced lane splits of a 96-wide tile
    mixed = (1, 2, 3, 6, 24, 48, 4, 12)
    assert K.bwd_stage_modes(96, 8, mixed) == \
        ["A"] * 4 + ["B", "B", "cross", "paired"]
    assert K.bwd_stage_modes(96, 4, mixed) == ["A"] * 4 + ["B"] * 2 + \
        ["A"] * 2
    assert K.bwd_stage_modes(96, 2, mixed) == ["A"] * 5 + ["paired"] + \
        ["A"] * 2


def test_plan_raises_when_nothing_fits():
    """A run whose table and grad sums fill a block's shared memory in
    every split of its lanes raises rather than launching."""
    with pytest.raises(ValueError, match="does not fit"):
        K.bwd_plan(8, 8192, (1,) * 32, 1, 4)


def _gamma(k):
    u = 2.0 ** -24
    return k * u / (1 - k * u)


def _engine_sum(terms, plan):
    """The engine's order of a sum over rows, in float32: within a chunk
    each row slice sums its rows (rs, rs + slices, ...) in order, the
    slices' sums are added to their group's accumulator in slice order,
    chunk by chunk, and the groups' accumulators are summed in group order
    (spm_sum_partials)."""
    n_rows = terms.shape[0]
    rs = plan.row_slices
    groups = [np.zeros(terms.shape[1:], np.float32)
              for _ in range(plan.groups)]
    for g, r0, n in K.bwd_row_chunks(n_rows, plan.chunk_rows, plan.groups):
        for sl in range(rs):
            acc = np.zeros(terms.shape[1:], np.float32)
            for r in range(sl, n, rs):
                acc = acc + terms[r0 + r]
            groups[g] = groups[g] + acc
    out = np.zeros(terms.shape[1:], np.float32)
    for acc in groups:
        out = out + acc
    return out


def _terms(seed, n_rows, nt, strides):
    """Each row's eq. 14 pair-grad terms of a seeded run in float32, as
    the plain version forms them: (n_rows, L, nt/2, 4)."""
    rng = np.random.default_rng(seed)
    L = len(strides)
    x = torch.from_numpy(rng.standard_normal((n_rows, nt), np.float32))
    gy = torch.from_numpy(rng.standard_normal((n_rows, nt), np.float32))
    cf = torch.from_numpy(
        0.5 * rng.standard_normal((L, nt // 2, 4)).astype(np.float32))
    _, zs = stages_collect(x, cf, strides)
    _, per_row = walk_back(zs, gy, cf, strides, lambda t: t)
    return per_row.reshape(L, n_rows, nt // 2, 4).permute(1, 0, 2, 3).numpy()


@pytest.mark.parametrize("n_rows, nt, strides", [
    (1000, 64, (1, 2, 4, 8, 16, 32)),     # 4 row slices a slot
    (777, 48, (1, 3, 6, 12, 24)),         # strides that are not powers of 2
])
def test_engine_order_of_sums_within_gamma_rows(n_rows, nt, strides):
    """The engine's order of the pair-grad sums over rows, emulated in
    float32, stays within gamma_rows of the sum of the terms' magnitudes
    of the plain version's grads; leaving out one chunk of rows breaks
    it."""
    terms = _terms(n_rows + nt, n_rows, nt, strides)
    plan = K.bwd_plan(n_rows, nt, strides, 1, 4)
    assert plan.row_slices > 1 and plan.groups > 1
    want = torch.from_numpy(terms).sum(0).numpy()     # the plain version's
    mags = np.abs(terms.astype(np.float64)).sum(0)
    lim = _gamma(n_rows) * mags
    got = _engine_sum(terms, plan)
    assert (np.abs(got.astype(np.float64) - want) <= lim).all()
    g, r0, n = K.bwd_row_chunks(n_rows, plan.chunk_rows, plan.groups)[-1]
    dropped = terms.copy()
    dropped[r0: r0 + n] = 0
    bad = _engine_sum(dropped, plan)
    assert not (np.abs(bad.astype(np.float64) - want) <= lim).all()


def _linears(cfg):
    """(name, LinearConfig) of every SPM linear of a config's layers: the
    attention's q, k/v and o, the dense FFN's gate, up and down, the MoE
    experts' (planned over one expert's rows) and the shared expert's, the
    Mamba2 in and out projections, and zamba2's shared block (attention
    and FFN)."""
    def attn(tag, acfg):
        return [(tag + "q", acfg.q_proj), (tag + "kv", acfg.kv_proj),
                (tag + "o", acfg.o_proj)]

    def ffn(tag, fcfg):
        return [(tag + "gate", fcfg.gate), (tag + "up", fcfg.up),
                (tag + "down", fcfg.down)]

    out = []
    if any(s.mixer == "attn" for s in cfg.layers):
        out += attn("", cfg.attn_cfg(cfg.layers[0]))
    if any(s.mixer == "mamba" for s in cfg.layers):
        mcfg = cfg.mamba_cfg()
        out += [("in_proj", mcfg.in_proj), ("out_proj", mcfg.out_proj)]
    if any(s.mlp == "dense" for s in cfg.layers):
        out += ffn("", cfg.ffn_cfg())
    if any(s.mlp == "moe" for s in cfg.layers):
        out += ffn("expert ", cfg.moe_cfg().expert_ffn)
        if cfg.shared_d_ff:
            out += ffn("shared expert ", cfg.moe_cfg().shared_ffn)
    if cfg.has_shared_block:
        out += attn("shared ", cfg.shared_attn_cfg())
        out += ffn("shared ", cfg.shared_ffn_cfg())
    return out


@pytest.mark.parametrize("rows", [1, 8, 160, 512, 4096])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-12b", "qwen2-vl-7b",
                                  "musicgen-medium", "minitron-4b",
                                  "qwen3-32b", "qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e", "mamba2-370m",
                                  "zamba2-1.2b"])
def test_every_registered_linear_has_its_plans(arch, rows):
    """Every run of every linear of every registered config (at full width)
    gets a K1 plan and a K2 plan at bf16, and K3/K4 block plans where the
    linear is block-fusible: no launch on the main path raises for want of
    a plan.  The lone stages on tiles wider than one cluster (9216 ...
    25600 lanes) take K2's split mode."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.core.eligibility import block_fusion_eligible
    from repro_torch.kernels import ops
    assert arch in ARCH_IDS
    cfg = get_config(arch)
    for name, lin in _linears(cfg):
        scfg = lin.spm_config()
        strides = scfg.pairing.strides()
        n = scfg.n
        for rs, nt in ops.plan_runs_for_rows(n, strides, rows):
            f = K.fwd_plan(rows, nt, rs, n // nt, 2)
            b = K.bwd_plan(rows, nt, rs, n // nt, 2)
            assert f.smem_bytes <= K.SMEM_BYTES
            assert b.smem_bytes <= K.SMEM_BYTES, (name, rs, nt)
            assert bool(b.split) == (nt > 2 * 8 * K.BWD_MAX_THREADS), \
                (name, rs, nt)
        if block_fusion_eligible(n, strides):
            assert K.fwd_plan(rows, n, strides, 1, 2, block=True,
                              norm=True).smem_bytes <= K.SMEM_BYTES
            assert K.bwd_plan(rows, n, strides, 1, 2, block=True,
                              norm=True).smem_bytes <= K.SMEM_BYTES


@pytest.mark.parametrize("io", [2, 4])
@pytest.mark.parametrize("rows", [1, 8, 1000, 2048, 4096])
@pytest.mark.parametrize("nt, tiles", [(9216, 1), (9472, 2), (12800, 2),
                                       (15360, 1), (18944, 1), (25600, 1)])
def test_split_plan_covers_pairs_and_rows_once(nt, tiles, rows, io):
    """K2's split mode: every pair of the lone stage's tile in exactly one
    slot of one block, both its lanes in that block's two segments, each
    block a one-block cluster of at most 512 threads whose shared memory
    is the engine's layout for one stage of stride P on 2P lanes within
    232,448 B; every row in exactly one chunk of one group."""
    s = nt // 2
    p = K.bwd_plan(rows, nt, (s,), tiles, io)
    P = p.pair_slots
    assert p.split == s // P and p.split * P == s and P >= 4
    assert (p.lane_blocks, p.cluster, p.lanes) == (1, 1, 2 * P)
    assert P & (P - 1) == 0 and p.threads == P * p.row_slices \
        <= K.BWD_MAX_THREADS
    assert p.smem_bytes <= K.SMEM_BYTES
    assert p.smem_bytes == K.bwd_smem_bytes(1, 2 * P, p.chunk_rows, 3, io,
                                            io, False, p.row_slices, False,
                                            1, io)
    assert K.bwd_stage_modes(2 * P, 1, (P,)) == ["A"]
    pairs = K.bwd_split_pairs(nt, p)
    flat = sorted(q for blk in pairs for q in blk)
    assert flat == list(range(s))
    for j, blk in enumerate(pairs):
        # the block's low segment: columns [j P, (j + 1) P), the high one
        # s on, inside the tile
        assert blk == list(range(j * P, (j + 1) * P))
        assert blk[-1] + s < nt
    chunks = K.bwd_row_chunks(rows, p.chunk_rows, p.groups)
    seen = np.zeros(rows, dtype=int)
    for _, r0, n in chunks:
        assert 0 < n <= p.chunk_rows
        seen[r0: r0 + n] += 1
    assert (seen == 1).all()
    assert {g for g, _, _ in chunks} == set(range(p.groups))
