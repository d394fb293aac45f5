"""The forward engine's planner (``kernels/spm_stack.py`` ``fwd_plan``) and
its walk, on the CPU.

K1 and K5 run on one engine (``csrc/spm_fwd_engine.cuh``): row groups walk
chunks of ``chunk_rows`` rows through passes that fuse up to three stages
in registers, a tile's lanes split over a cluster at decode rows, an int8
chunk one scale block.  These tests hold the pure Python side of it: every
row in exactly one chunk, every lane of every pass in exactly one group,
the shared memory and cluster within the card's limits, and a float32
emulation of the planned walk (fused stages applied group by group, one
rounding per product and sum) equal to ``spm_stack_plain`` and
``spm_overlap_plain`` bit for bit -- which a dropped stage or chunk breaks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import quant as Q  # noqa: E402
from repro_torch.kernels import spm_stack as K  # noqa: E402

QKV = tuple(1 << i for i in range(11))
SHARD_FFN = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)

# (label, n_tile, strides, tiles, io bytes, x bytes, int8 scale block rows
# or None, sides) at the shapes of chip_smoke.py's K1 and K5 phases: the o
# run in bf16 and f32, the FFN chains (2048-wide tiles, then the 3072 stage
# on a 6144 tile) and the decode run on one 6144 tile, int8 activations
# (64 x 2048 scale blocks; the decode run's 8 x 6144), the gate/up shard
# run (768-wide tiles, strides that do not nest), the o shard run, and
# K5's q/k/v/o pair (4 shards of 512) and 2-shard pair (1024).
SHAPES = [
    ("o", 2048, QKV, 1, 2, 2, None, 1),
    ("o f32", 2048, QKV, 1, 4, 4, None, 1),
    ("FFN run 1", 2048, QKV, 3, 2, 2, None, 1),
    ("FFN run 2", 6144, (3072,), 1, 2, 2, None, 1),
    ("decode run", 6144, QKV + (3072,), 1, 2, 2, None, 1),
    ("decode run f32", 6144, QKV + (3072,), 1, 4, 4, None, 1),
    ("o int8", 2048, QKV, 1, 1, 1, 64, 1),
    ("decode int8", 6144, QKV + (3072,), 1, 1, 1, 8, 1),
    ("up shard", 768, SHARD_FFN, 2, 2, 2, None, 1),
    ("o shard", 512, QKV[:9], 1, 2, 2, None, 1),
    ("K5 q/k/v/o", 512, QKV[:9], 2, 2, 2, None, 2),
    ("K5 q/k/v/o f32", 512, QKV[:9], 2, 4, 4, None, 2),
    ("K5 S=2", 1024, QKV[:10], 1, 2, 2, None, 2),
]
ROWS = [1, 8, 1000, 4072, 4096]


def _plan(rows, nt, strides, tiles, io, xb, sr, sides):
    return K.fwd_plan(rows, nt, strides, tiles, io, xb, scale_rows=sr,
                      sides=sides)


def _padded(rows, sr):
    return rows if sr is None else -(-rows // sr) * sr


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("label, nt, strides, tiles, io, xb, sr, sides",
                         SHAPES)
def test_plan_covers_rows_once_within_the_card(label, nt, strides, tiles, io,
                                               xb, sr, sides, rows):
    """Every row in exactly one chunk of one group (an int8 chunk exactly
    one scale block over the cluster's row blocks), every group walking at
    least one chunk; the block's shared memory within 232,448 B and the
    planner's own byte count; a cluster of at most 8 blocks; 32 to 256
    threads, whole warps."""
    B = _padded(rows, sr)
    p = _plan(B, nt, strides, tiles, io, xb, sr, sides)
    passes = K.fwd_passes(nt, p.lane_blocks, strides)
    assert passes is not None and p.passes == len(passes)
    assert p.lane_blocks * p.lanes == nt
    assert p.cluster == p.lane_blocks * p.row_blocks * sides <= 8
    assert p.smem_bytes <= K.SMEM_BYTES
    assert p.smem_bytes == K.fwd_smem_bytes(
        len(strides), p.lanes, p.chunk_rows, xb, p.resident,
        len(passes) > 1 or sr is not None, io if sides == 2 else 0)
    assert 32 <= p.threads <= K.FWD_MAX_THREADS and p.threads % 32 == 0
    if sr is not None:
        assert p.row_blocks * p.chunk_rows == sr and p.lane_blocks == 1
    chunks = K.fwd_row_chunks(B, p, sr)
    seen = np.zeros(B, dtype=int)
    for _, r0, n, _ in chunks:
        assert 0 < n <= p.chunk_rows
        seen[r0: r0 + n] += 1
    assert (seen == 1).all()
    assert {g for g, *_ in chunks} == set(range(p.groups))


def _pairs_of(strides, passes, groups):
    """Each stage's pairs, (low lane, high lane), as the planned groups
    apply them."""
    got = {}
    for (first, count, _), per_block in zip(passes, groups):
        for blk in per_block:
            for lanes in blk:
                for k in range(count):
                    for j in range(1 << count):
                        if not j >> k & 1:
                            got.setdefault(first + k, []).append(
                                (lanes[j], lanes[j | 1 << k]))
    return got


@pytest.mark.parametrize("label, nt, strides", [
    ("o", 2048, QKV), ("decode run", 6144, QKV + (3072,)),
    ("up shard", 768, SHARD_FFN), ("o shard", 512, QKV[:9]),
    ("descending", 64, (16, 8, 4, 2, 1)), ("mixed", 96, (1, 2, 3, 6, 24, 48,
                                                         4, 12))])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 8])
def test_passes_take_every_pair_once(label, nt, strides, C):
    """Every stage in exactly one pass, in order, fused at most three deep
    over ascending nested strides (the o tile's 11 stages in 4 passes, K5's
    9 in 3); every lane of a pass in exactly one group of one block; each
    stage's pairs exactly the stride's pairs, (i, i + s) with i mod 2s <
    s.  A split the engine cannot take (a trailing run that is not one
    nested group of at most 3, a first stage not local) is refused."""
    if nt % C:
        return
    passes = K.fwd_passes(nt, C, strides)
    if passes is None:
        w = nt // C
        e = next(i for i, s in enumerate(strides) if w % (2 * s))
        tail = strides[e:]
        assert C > 1 and (e == 0 or len(tail) > 3 or any(
            b % (2 * a) for a, b in zip(tail, tail[1:]))
            or (nt >> len(tail)) % C)
        return
    assert [s for f, n, _ in passes for s in range(f, f + n)] == \
        list(range(len(strides)))
    for f, n, cross in passes:
        ss = strides[f:f + n]
        assert all(b % (2 * a) == 0 for a, b in zip(ss, ss[1:]))
        assert not cross or (C > 1 and (f, n, cross) == passes[-1])
    if C == 1 and label == "o":
        assert len(passes) == 4
    if C == 1 and label == "o shard":
        assert len(passes) == 3
    groups = [K.fwd_group_lanes(nt, C, strides, f, n, x)
              for f, n, x in passes]
    for (f, n, cross), per_block in zip(passes, groups):
        lanes = sorted(i for blk in per_block for grp in blk for i in grp)
        assert lanes == list(range(nt))
        if not cross:
            w = nt // C
            assert all(i // w == c for c, blk in enumerate(per_block)
                       for grp in blk for i in grp)
    for l, pairs in _pairs_of(strides, passes, groups).items():
        s = strides[l]
        want = sorted((i, i + s) for i in range(nt) if i % (2 * s) < s)
        assert sorted(pairs) == want


# --------------------------------------------------------------------------
# the planned walk, emulated in float32
# --------------------------------------------------------------------------

def _walk(z, cf, strides, nt, plan, tile, drop_stage=None):
    """The passes of ``plan`` over the rows ``z`` (rows, nt) of one tile,
    group by group as the engine's registers hold them: stage k of a pass
    mixes lanes j and j + 2^k of each group, y0 = a x0 + b x1, y1 = c x0 +
    d x1, each product and sum rounded in float32."""
    passes = K.fwd_passes(nt, plan.lane_blocks, strides)
    for f, n, cross in passes:
        per_block = K.fwd_group_lanes(nt, plan.lane_blocks, strides, f, n,
                                      cross)
        lanes = torch.tensor([g for blk in per_block for g in blk])
        v = z[:, lanes]                      # rows x groups x 2^n
        for k in range(n):
            l, s = f + k, strides[f + k]
            if l == drop_stage:
                continue
            for j in range(1 << n):
                if j >> k & 1:
                    continue
                lo = lanes[:, j]
                p = tile * (nt // 2) + (lo // (2 * s)) * s + lo % (2 * s)
                c = cf[l][p]
                x0, x1 = v[:, :, j].clone(), v[:, :, j | 1 << k].clone()
                v[:, :, j] = c[:, 0] * x0 + c[:, 1] * x1
                v[:, :, j | 1 << k] = c[:, 2] * x0 + c[:, 3] * x1
        z[:, lanes] = v
    return z


def emulate_k1(x, coeffs, d_in, d_out, bias, x_scale=None,
               coeff_scale=None, *, strides, n_tile, plan, in_width=None,
               out_width=None, col_base=None, quant_out=False,
               scale_rows=None, drop_stage=None, drop_chunk=None):
    """K1 on the engine, emulated: x (dequantized, windowed, zero past
    in_width) staged chunk by chunk (``fwd_row_chunks``), times d_in, the
    planned passes, d_out and bias, the store cut to out_width -- or, with
    ``quant_out``, each scale block (one chunk over its row blocks) coded
    with its own absmax.  A row no chunk visits stays NaN."""
    n = 2 * coeffs.shape[1]
    cf = K._plain_coeffs(coeffs, coeff_scale)
    xf = K._plain_x(x, x_scale, scale_rows, n_tile)
    if col_base is not None:
        xf = K._window(xf, col_base, n_tile, n)
    xf = torch.nn.functional.pad(xf, (0, n - xf.shape[1]))
    B = xf.shape[0]
    out_w = n if out_width is None else out_width
    tiles = -(-out_w // n_tile)
    z_all = torch.full((B, tiles * n_tile), float("nan"))
    chunks = K.fwd_row_chunks(B, plan, scale_rows if quant_out else None)
    for t in range(tiles):
        cols = slice(t * n_tile, (t + 1) * n_tile)
        for i, (_, r0, rows, _) in enumerate(chunks):
            if i == drop_chunk:
                continue
            z = xf[r0:r0 + rows, cols].clone()
            if d_in is not None:
                z = z * d_in[cols]
            z = _walk(z, cf, strides, n_tile, plan, t, drop_stage)
            if d_out is not None:
                z = z * d_out[cols]
            if bias is not None:
                z = z + bias[cols]
            z_all[r0:r0 + rows, cols] = z
    if quant_out:
        blocks = z_all.reshape(B // scale_rows, scale_rows, tiles, n_tile)
        amax = blocks.abs().amax(dim=(1, 3))
        scale = amax / torch.full_like(amax, 127.0) + 1e-12
        q = torch.clamp(torch.round(blocks / scale[:, None, :, None]),
                        -127, 127)
        q = torch.nan_to_num(q, nan=0.0).to(torch.int8)
        return q.reshape(B, -1)[:, :out_w].contiguous(), scale
    return z_all[:, :out_w].to(x.dtype)


def emulate_k5(x, coeffs, mix_a, mix_b, d_in=None, d_out=None, bias=None,
               *, strides, n_tile, k, plan, in_width=None, drop_chunk=None):
    """K5 on the engine, emulated: each shard's local run walked chunk by
    chunk, rounded into its send slot (x's dtype), then mixed with its
    partner's slot in float32, d_out after the add, bias, one rounding on
    the store."""
    S, L, half = coeffs.shape[:3]
    nl = 2 * half
    n = S * nl
    xf = torch.nn.functional.pad(x.float(), (0, n - x.shape[1]))
    B = x.shape[0]
    slots = torch.full((B, n), float("nan"))
    for j in range(S):
        for t in range(nl // n_tile):
            cols = slice(j * nl + t * n_tile, j * nl + (t + 1) * n_tile)
            for i, (_, r0, rows, _) in enumerate(K.fwd_row_chunks(B, plan)):
                if i == drop_chunk:
                    continue
                z = xf[r0:r0 + rows, cols].clone()
                if d_in is not None:
                    z = z * d_in[cols]
                z = _walk(z, coeffs[j].float(), strides, n_tile, plan, t)
                slots[r0:r0 + rows, cols] = z.to(x.dtype).float()
    ys = []
    for j in range(S):
        own = slice(j * nl, (j + 1) * nl)
        peer = slice((j ^ k) * nl, ((j ^ k) + 1) * nl)
        y = mix_a[own] * slots[:, own] + mix_b[own] * slots[:, peer]
        if d_out is not None:
            y = y * d_out[own]
        if bias is not None:
            y = y + bias[own]
        ys.append(y)
    return torch.cat(ys, dim=-1).to(x.dtype)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dtype)


def _rotations(rng, *lead):
    th = rng.uniform(-np.pi, np.pi, lead)
    c, s = np.cos(th), np.sin(th)
    return _t(np.stack([c, -s, s, c], -1)
              + 0.05 * rng.standard_normal(lead + (4,)))


# (label, n, strides, n_tile, rows, in_width, out_width, col_base, dtype,
# int8 acts, int8 table): the o tile at chunked, ragged, decode and one
# row, the FFN runs (the 3072 stage on 6144 alone, and the decode run's
# lane split over 3 blocks), the gate/up shard run through the window
# (tiles of 768, a straddling shard), int8 activations and table (a
# padded scale block) and a table alone.
K1_CASES = [
    ("o chunks", 2048, QKV, 2048, 300, None, None, None, torch.bfloat16,
     False, False),
    ("o decode", 2048, QKV, 2048, 8, None, 1024, None, torch.float32,
     False, False),
    ("o one row", 2048, QKV, 2048, 1, None, None, None, torch.bfloat16,
     False, False),
    ("3072 run", 6144, (3072,), 6144, 40, None, 2048, None, torch.bfloat16,
     False, False),
    ("decode run", 6144, QKV + (3072,), 6144, 8, 2048, None, None,
     torch.bfloat16, False, False),
    ("up shard 1", 1536, SHARD_FFN, 768, 300, 2048, None, 2,
     torch.bfloat16, False, True),
    ("up shard 1 decode", 1536, SHARD_FFN, 768, 8, 2048, None, 2,
     torch.float32, False, False),
    ("o int8", 2048, QKV, 2048, 200, None, None, None, torch.bfloat16,
     True, True),
    ("decode int8", 6144, QKV + (3072,), 6144, 8, None, None, None,
     torch.bfloat16, True, True),
]


def _k1_case(label, n, strides, nt, rows, in_w, out_w, col_base, dtype, q_acts,
             q_cf, seed=0):
    rng = _rng(seed)
    cf = _rotations(rng, len(strides), n // 2)
    d_in, d_out = (_t(1 + 0.1 * rng.standard_normal(n)) for _ in range(2))
    bias = _t(0.1 * rng.standard_normal(n))
    x = _t(rng.standard_normal((rows, in_w or n)))
    kw = dict(strides=strides, n_tile=nt, in_width=in_w, out_width=out_w,
              col_base=col_base)
    cs = None
    if q_cf:
        cf, cs = Q.quantize_coeffs(cf)
    xs = sr = None
    if q_acts:
        sr = Q.scale_block_rows(((strides, nt),), rows, 2)
        x = torch.nn.functional.pad(x, (0, 0, 0, -rows % sr))
        x, xs = Q.quantize_blocks(x, sr, nt)
        kw.update(quant_out=True, scale_rows=sr)
    else:
        x = x.to(dtype)
    plan = K.fwd_plan(x.shape[0], nt, strides, -(-(out_w or n) // nt),
                      1 if q_acts else x.element_size(), scale_rows=sr)
    return (x, cf, d_in, d_out, bias, xs, cs), kw, plan


@pytest.mark.parametrize(
    "label, n, strides, nt, rows, in_w, out_w, col_base, dtype, q_acts, q_cf",
    K1_CASES)
def test_emulated_k1_walk_is_the_plain_version(label, n, strides, nt, rows,
                                               in_w, out_w, col_base, dtype,
                                               q_acts, q_cf):
    """The planned walk (fused passes in registers, chunks over row groups,
    lanes split at decode rows, int8 chunks one scale block) is K1's plain
    version bit for bit; the emulation with a stage or a chunk dropped is
    not."""
    args, kw, plan = _k1_case(label, n, strides, nt, rows, in_w, out_w,
                              col_base, dtype, q_acts, q_cf)
    want = K.spm_stack_plain(*args, **kw)
    got = emulate_k1(*args, plan=plan, **kw)
    same = (lambda a, b: torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            ) if q_acts else torch.equal
    assert same(got, want)
    assert not same(emulate_k1(*args, plan=plan, drop_stage=len(strides) - 1,
                               **kw), want)
    if len(K.fwd_row_chunks(args[0].shape[0], plan,
                            kw.get("scale_rows") if q_acts else None)) > 1:
        bad = emulate_k1(*args, plan=plan, drop_chunk=1, **kw)
        assert not same(bad, want)


# (label, S, n_local, strides, n_tile, k, rows, in_width, fold, dtype)
K5_CASES = [
    ("q/k/v/o", 4, 512, QKV[:9], 512, 1, 300, None, False, torch.bfloat16),
    ("q/k/v/o decode", 4, 512, QKV[:9], 512, 1, 8, None, False,
     torch.float32),
    ("S=2 end", 2, 1024, QKV[:10], 1024, 1, 100, None, True, torch.bfloat16),
    ("window", 4, 512, QKV[:9], 512, 1, 77, 1792, False, torch.bfloat16),
    ("k=2 tiles", 4, 24, (1, 2, 4), 8, 2, 40, 64, True, torch.float32),
]


@pytest.mark.parametrize("label, S, nl, strides, nt, k, rows, in_w, fold, "
                         "dtype", K5_CASES)
def test_emulated_k5_walk_is_the_plain_version(label, S, nl, strides, nt, k,
                                               rows, in_w, fold, dtype):
    """K5's planned walk (each shard's run in fused passes over the pair's
    chunks, the slab rounded into its slot, the mix from both slots) is
    K5's plain version bit for bit; with a chunk dropped it is not."""
    rng = _rng(S * nl + rows)
    n = S * nl
    cf = _rotations(rng, S, len(strides), nl // 2)
    ma, mb, d_in = (_t(1 + 0.1 * rng.standard_normal(n)) for _ in range(3))
    d_out = _t(1 + 0.1 * rng.standard_normal(n)) if fold else None
    bias = _t(0.1 * rng.standard_normal(n)) if fold else None
    x = _t(rng.standard_normal((rows, in_w or n))).to(dtype)
    kw = dict(strides=strides, n_tile=nt, k=k, in_width=in_w)
    plan = K.fwd_plan(rows, nt, strides, S // 2 * (nl // nt),
                      x.element_size(), sides=2)
    want = K.spm_overlap_plain(x, cf, ma, mb, d_in, d_out, bias, **kw)
    got = emulate_k5(x, cf, ma, mb, d_in, d_out, bias, plan=plan, **kw)
    assert torch.equal(got, want)
    if len(K.fwd_row_chunks(rows, plan)) > 1:
        bad = emulate_k5(x, cf, ma, mb, d_in, d_out, bias, plan=plan,
                         drop_chunk=1, **kw)
        assert not torch.equal(bad, want)


def test_decode_and_training_shapes():
    """At decode rows each row is a group, and a tile's lanes spread over
    the fewest lane blocks that give 8 blocks of at most 2048 lanes, each
    copying its share of the table into shared memory at once: at 8 rows
    the o tile and the shard runs in one block a row, the 6144-wide decode
    run over 3 (its 3072 stage a pass across them); at one row the o tile
    over 8 blocks (its 256, 512, 1024 stages one pass across them), the
    768-lane shard run over 4.  At training rows one block takes a tile:
    K5's and the shard run's tables stay resident, and so does the single
    3072 stage's; the o tile's 176 KiB table is read from L2 a chunk at a
    time (4 passes, 16-row chunks).  17 rows make 17 groups of one row.
    An int8 decode scale block spreads its rows over 8 blocks."""
    for rows, nt, strides, C in ((8, 2048, QKV, 1), (8, 768, SHARD_FFN, 1),
                                 (8, 6144, QKV + (3072,), 3),
                                 (1, 2048, QKV, 8), (1, 768, SHARD_FFN, 4)):
        p = K.fwd_plan(rows, nt, strides, 1, 2)
        assert (p.lane_blocks, p.chunk_rows, p.groups, p.resident) == (
            C, 1, rows, True), (rows, nt, p)
    assert K.fwd_passes(2048, 8, QKV)[-1] == (8, 3, True)
    p = K.fwd_plan(4096, 2048, QKV, 1, 2)
    assert (p.lane_blocks, p.passes, p.chunk_rows, p.resident) == (
        1, 4, 16, False)
    assert K.fwd_plan(4096, 512, QKV[:9], 2, 2, sides=2).resident
    assert K.fwd_plan(4096, 768, SHARD_FFN, 2, 2).resident
    assert K.fwd_plan(4096, 6144, (3072,), 1, 2).resident
    assert K.fwd_plan(17, 2048, QKV, 1, 2).groups == 17
    q = K.fwd_plan(8, 6144, QKV + (3072,), 1, 1, scale_rows=8)
    assert (q.lane_blocks, q.row_blocks, q.chunk_rows) == (1, 8, 1)


def test_scale_block_too_large_raises():
    """A 1024 x 512 scale block needs 128-row blocks of 320 KiB in a
    cluster of 8: more shared memory than a block has."""
    with pytest.raises(ValueError, match="shared memory"):
        K.fwd_plan(1024, 512, (1, 256), 1, 1, scale_rows=1024)
