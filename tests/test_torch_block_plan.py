"""K3's and K4's launch shapes on the port's engines, and their walks and
orders of summation, on the CPU.

K3 (``csrc/spm_block.cu``) runs on the forward engine through
``fwd_plan``'s block form: one block a tile, the norm's row sum before pass
0, stack 1's last pass sinking into the tile through the mid epilogue when
a second stack follows.  K4 (``csrc/spm_block_bwd.cu``) runs on the
backward engine through ``bwd_plan``'s block form: a cluster of lane
blocks holds both stacks' tables and grad sums (or streams them from
device memory where no split holds them), and the norm's row mean is
summed per thread, per block and across the cluster in a fixed order.
These tests hold the pure Python side: every row in exactly one chunk, the
shared memory and the cluster within the card's limits, every eligible
block planned or refused by name, a float32 emulation of K3's planned
walk bit for bit ``spm_block_plain`` given its rstd, and K4's order of
sums (row chunks, groups, the cross-block row mean) within gamma_rows of
``spm_block_bwd_plain`` -- which a dropped chunk, a dropped stage or a
lane block missing from the row mean breaks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.eligibility import block_fusion_eligible  # noqa: E402
from repro_torch.kernels import spm_stack as K  # noqa: E402
from repro_torch.kernels.ref import stages_collect, walk_back  # noqa: E402

F = torch.nn.functional
QKV = tuple(1 << i for i in range(11))
SHARD_FFN = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)

# (label, n, strides1, strides2): the q and k/v forms of qwen3-1.7b (one
# 11-stage stack on 2048 lanes), the two-stack form with 11 + 11 and 12 + 12
# stages, and a non-nested stride set (the 768-lane shard run's).
FORMS = [
    ("q/kv", 2048, QKV, None),
    ("two 11+11", 2048, QKV, QKV),
    ("two 12+12", 2048, QKV + (1,), (1,) + QKV),
    ("non-nested", 768, SHARD_FFN, SHARD_FFN[::-1]),
]
ROWS = [1, 8, 1000, 4072, 4096]


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("label, n, s1, s2", FORMS)
@pytest.mark.parametrize("io", [2, 4])
def test_block_plans_cover_rows_once_within_the_card(label, n, s1, s2, rows,
                                                     io):
    """K3: one block a tile, whole warps of at most 256 threads, shared
    memory within 232,448 B and equal to ``fwd_smem_bytes``, every row in
    one chunk of one group.  K4: a cluster of at most 8 lane blocks, at
    most 512 threads in whole warps (or one row slice), shared memory
    within 232,448 B and equal to ``bwd_block_smem_bytes``, every row in
    one chunk of one group."""
    p = K.fwd_plan(rows, n, s1, 1, io, block=True, strides2=s2, norm=True)
    ps1 = K.fwd_passes(n, 1, s1)
    ps2 = K.fwd_passes(n, 1, s2) if s2 else ()
    assert (p.lane_blocks, p.row_blocks, p.cluster) == (1, 1, 1)
    assert p.passes == len(ps1) + len(ps2)
    assert 32 <= p.threads <= K.FWD_MAX_THREADS and p.threads % 32 == 0
    assert p.smem_bytes <= K.SMEM_BYTES
    assert p.smem_bytes == K.fwd_smem_bytes(
        len(s1), n, p.chunk_rows, io, p.resident,
        len(ps1) > 1 or s2 is not None, 0, stats=True)
    seen = np.zeros(rows, dtype=int)
    for _, r0, m, _ in K.fwd_row_chunks(rows, p):
        seen[r0:r0 + m] += 1
    assert (seen == 1).all()

    q = K.bwd_plan(rows, n, s1, 1, io, block=True, strides2=s2, norm=True)
    assert q.cluster == q.lane_blocks <= 8 and q.lanes * q.lane_blocks == n
    assert q.threads == q.pair_slots * q.row_slices <= K.BWD_MAX_THREADS
    assert q.row_slices == 1 or q.threads % 32 == 0
    assert q.smem_bytes <= K.SMEM_BYTES
    assert q.smem_bytes == K.bwd_block_smem_bytes(
        n, q.lane_blocks, q.chunk_rows, s1, s2, io, True, q.streamed)
    seen = np.zeros(rows, dtype=int)
    groups = set()
    for g, r0, m in K.bwd_row_chunks(rows, q.chunk_rows, q.groups):
        seen[r0:r0 + m] += 1
        groups.add(g)
    assert (seen == 1).all() and groups == set(range(q.groups))
    if label == "q/kv" and rows >= 1000:
        # K2's o-run shape: 4 lane blocks of 512, 6 (bf16) or 5 rows
        assert (q.lane_blocks, q.chunk_rows, q.streamed) == (
            4, 6 if io == 2 else 5, 0)
    if label == "two 11+11" and rows >= 1000:
        # both tables streamed over 4 blocks, measured faster than both on
        # chip over 8 (benchmarks/torch_block_plans.py)
        assert (q.lane_blocks, q.streamed) == (4, 2)


def _eligible_shapes():
    """Eligible blocks at every kind of width (2, 6, 96, 200, 2046, 2048
    lanes), one stage to 32 a stack, the largest and smallest valid
    strides, one stack or two."""
    out = []
    for n in (2, 6, 96, 200, 2046, 2048):
        valid = [s for s in range(1, n // 2 + 1) if n % (2 * s) == 0]
        for L1 in (1, 11, 32):
            for L2 in (None, 1, 32):
                for pick in (valid[-1], valid[0]):
                    s1 = tuple(valid[(i * 7) % len(valid)]
                               for i in range(L1 - 1)) + (pick,)
                    s2 = None if L2 is None else (pick,) * L2
                    assert block_fusion_eligible(n, s1, s2, "silu")
                    out.append((n, s1, s2))
    return out


def test_every_eligible_block_is_planned_or_refused_by_name():
    """Every block ``block_fusion_eligible`` admits, up to 32 stages a
    stack, gets a K3 plan, and a K4 plan or a ValueError naming K4's block:
    where no split up to 4 blocks holds a block's tables on chip (32
    stages, or two stacks, on 2048 lanes) its plan streams them (the named
    mode ``streamed``: stack 1's, or both); 2046 lanes (1023 pairs, no
    split into whole blocks of at most 512 slots) is refused."""
    modes = set()
    for n, s1, s2 in _eligible_shapes():
        for io in (2, 4):
            p = K.fwd_plan(64, n, s1, 1, io, block=True, strides2=s2,
                           norm=True)
            assert p.smem_bytes <= K.SMEM_BYTES and p.lane_blocks == 1
            try:
                q = K.bwd_plan(64, n, s1, 1, io, block=True, strides2=s2,
                               norm=True)
            except ValueError as e:
                assert "K4's block" in str(e) and n == 2046
                modes.add("refused")
                continue
            assert q.smem_bytes <= K.SMEM_BYTES
            modes.add(("streamed", q.streamed))
    assert {("streamed", 0), ("streamed", 1), ("streamed", 2),
            "refused"} <= modes
    q = K.bwd_plan(4096, 2048, (1,) * 32, 1, 4, block=True,
                   strides2=(1,) * 32, norm=True)
    assert q.streamed == 2 and q.smem_bytes <= K.SMEM_BYTES


# --------------------------------------------------------------------------
# K3's planned walk, emulated in float32
# --------------------------------------------------------------------------

def _walk(z, cf, strides, plan, drop_stage=None):
    """The forward engine's passes over the rows ``z`` of the one tile,
    group by group (``fwd_group_lanes``), each product and sum rounded in
    float32."""
    nt = z.shape[1]
    for f, m, cross in K.fwd_passes(nt, 1, strides):
        lanes = torch.tensor(K.fwd_group_lanes(nt, 1, strides, f, m,
                                               cross)[0])
        v = z[:, lanes]
        for k in range(m):
            l, s = f + k, strides[f + k]
            if l == drop_stage:
                continue
            for j in range(1 << m):
                if j >> k & 1:
                    continue
                lo = lanes[:, j]
                c = cf[l][(lo // (2 * s)) * s + lo % (2 * s)]
                x0, x1 = v[:, :, j].clone(), v[:, :, j | 1 << k].clone()
                v[:, :, j] = c[:, 0] * x0 + c[:, 1] * x1
                v[:, :, j | 1 << k] = c[:, 2] * x0 + c[:, 3] * x1
        z[:, lanes] = v
    return z


def emulate_k3(x, cf1, d_in1, d_out1, bias1, gamma, cf2, d_in2, d_out2,
               bias2, *, rstd, strides1, strides2, activation, residual,
               in_width, mid_width, out_width, plan, drop_stage=None,
               drop_chunk=None):
    """K3 on the engine, emulated: each chunk (``fwd_row_chunks``) of the
    staged x (zero past in_width) through the norm prologue with the given
    rstd, ((x rstd) gamma) d_in1, stack 1's passes, the mid epilogue
    (d_out1, bias1, the mid_width mask, the activation, d_in2) and stack 2's
    passes, or stack 1's epilogue; the residual; the store cut to
    out_width.  A row no chunk visits stays NaN."""
    n = 2 * cf1.shape[1]
    lane = torch.arange(n)
    xr = F.pad(x.float(), (0, n - in_width))
    out = torch.full((x.shape[0], n), float("nan"))
    two = strides2 is not None
    for i, (_, r0, m, _) in enumerate(K.fwd_row_chunks(x.shape[0], plan)):
        if i == drop_chunk:
            continue
        z = xr[r0:r0 + m].clone()
        if gamma is not None:
            z = z * rstd[r0:r0 + m] * gamma
        z = _walk(z * d_in1, cf1, strides1, plan, drop_stage) * d_out1
        if bias1 is not None:
            z = z + bias1
        if two or activation is not None:
            z = K._act(torch.where(lane < mid_width, z, 0.0), activation)
        if two:
            z = _walk(z * d_in2, cf2, strides2, plan) * d_out2
            if bias2 is not None:
                z = z + bias2
        if residual:
            z = z + xr[r0:r0 + m]
        out[r0:r0 + m] = z
    return out[:, :out_width].to(x.dtype)


def _rotations(rng, L, half):
    th = rng.uniform(-np.pi, np.pi, (L, half))
    c, s = np.cos(th), np.sin(th)
    a = np.stack([c, -s, s, c], -1) + 0.05 * rng.standard_normal((L, half, 4))
    return torch.from_numpy(a.astype(np.float32))


def _block_case(seed, n, s1, s2, rows, act, residual, in_w, mid_w, out_w):
    rng = np.random.default_rng(seed)

    def vec(scale=0.1, base=1.0):
        return torch.from_numpy(
            (base + scale * rng.standard_normal(n)).astype(np.float32))

    gamma = vec()
    gamma[in_w:] = 0.0
    ops = dict(coeffs1=_rotations(rng, len(s1), n // 2), d_in1=vec(),
               d_out1=vec(), bias1=vec(base=0.0), gamma=gamma)
    kw = dict(strides1=s1, strides2=s2, activation=act, residual=residual,
              in_width=in_w, mid_width=mid_w, out_width=out_w)
    if s2 is not None:
        ops.update(coeffs2=_rotations(rng, len(s2), n // 2), d_in2=vec(),
                   d_out2=vec(), bias2=vec(base=0.0))
    x = torch.from_numpy(rng.standard_normal((rows, in_w)).astype(np.float32))
    gy = torch.from_numpy(
        rng.standard_normal((rows, out_w)).astype(np.float32))
    return x, gy, ops, kw


# (label, n, strides1, strides2, rows, activation, residual, in, mid, out,
# dtype): the q and k/v forms (ragged rows, decode rows), the two-stack
# forms with each activation, with and without the residual, a padded
# width, and non-nested strides.
K3_CASES = [
    ("q", 256, QKV[:8], None, 300, None, False, 256, 256, 256,
     torch.bfloat16),
    ("kv decode", 256, QKV[:8], None, 8, None, False, 256, 128, 128,
     torch.float32),
    ("relu res", 128, QKV[:7], QKV[:7], 77, "relu", True, 128, 96, 128,
     torch.bfloat16),
    ("silu", 128, QKV[:7], QKV[:7][::-1], 40, "silu", False, 128, 96, 112,
     torch.float32),
    ("gelu padded", 96, (1, 2, 3, 6, 24, 48), (4, 12, 1), 33, "gelu", True,
     90, 80, 90, torch.bfloat16),
    ("act one stack", 96, (1, 3, 6, 12), None, 21, "silu", False, 90, 64, 96,
     torch.float32),
]


@pytest.mark.parametrize("label, n, s1, s2, rows, act, res, in_w, mid_w, "
                         "out_w, dtype", K3_CASES)
def test_emulated_k3_walk_is_the_plain_version(label, n, s1, s2, rows, act,
                                               res, in_w, mid_w, out_w,
                                               dtype):
    """Given the plain version's rstd, K3's planned walk (norm prologue,
    fused passes over the chunks, mid epilogue, second stack, residual) is
    ``spm_block_plain`` bit for bit; with a stage or a chunk dropped it is
    not."""
    x, _, ops, kw = _block_case(rows + n, n, s1, s2, rows, act, res, in_w,
                                mid_w, out_w)
    x = x.to(dtype)
    want, rstd = K.spm_block_plain(x, **ops, **kw)
    plan = K.fwd_plan(rows, n, s1, 1, x.element_size(), block=True,
                      strides2=s2, norm=True)
    args = [ops.get(k) for k in ("coeffs1", "d_in1", "d_out1", "bias1",
                                 "gamma", "coeffs2", "d_in2", "d_out2",
                                 "bias2")]
    got = emulate_k3(x, *args, rstd=rstd, plan=plan, **kw)
    assert torch.equal(got, want)
    bad = emulate_k3(x, *args, rstd=rstd, plan=plan, drop_stage=len(s1) - 1,
                     **kw)
    assert not torch.equal(bad, want)
    if len(K.fwd_row_chunks(rows, plan)) > 1:
        assert not torch.equal(emulate_k3(x, *args, rstd=rstd, plan=plan,
                                          drop_chunk=1, **kw), want)


# --------------------------------------------------------------------------
# K4's order of summation, emulated in float32
# --------------------------------------------------------------------------

def _gamma(k):
    u = 2.0 ** -24
    return k * u / (1 - k * u)


def _engine_sum(terms, plan, slices, drop_chunk=None):
    """The backward engine's order of a sum over rows in float32: each row
    slice sums its rows of a chunk in order, the slices' sums go to the
    group's accumulator in slice order chunk by chunk, and the groups'
    accumulators are summed in group order."""
    acc = [np.zeros(terms.shape[1:], np.float32) for _ in range(plan.groups)]
    for i, (g, r0, m) in enumerate(K.bwd_row_chunks(
            terms.shape[0], plan.chunk_rows, plan.groups)):
        if i == drop_chunk:
            continue
        for sl in range(slices):
            part = np.zeros(terms.shape[1:], np.float32)
            for r in range(sl, m, slices):
                part = part + terms[r0 + r]
            acc[g] = acc[g] + part
    out = np.zeros(terms.shape[1:], np.float32)
    for a in acc:
        out = out + a
    return out


def _row_mean(gxh, xh, plan, in_width, drop_block=None):
    """The kernel's row mean of gxh xh: thread t of lane block c sums its
    lanes (c w + 2t, c w + 2t + 1), 32 partials sum the threads t = j mod
    32 in order, the block sums its partials in order, and the blocks' sums
    are added in rank order; / in_width."""
    B = gxh.shape[0]
    C, pb = plan.lane_blocks, plan.pair_slots
    p = (gxh[:, 0::2] * xh[:, 0::2] + gxh[:, 1::2] * xh[:, 1::2]).numpy()
    p = p.reshape(B, C, pb)
    red = np.zeros((B, C, 32), np.float32)
    for t in range(pb):
        red[:, :, t % 32] = red[:, :, t % 32] + p[:, :, t]
    blk = np.zeros((B, C), np.float32)
    for j in range(32):
        blk = blk + red[:, :, j]
    tot = np.zeros(B, np.float32)
    for c in range(C):
        if c != drop_block:
            tot = tot + blk[:, c]
    return torch.from_numpy(tot)[:, None] / in_width


def emulate_k4(x, gy, coeffs1, d_in1, d_out1, bias1=None, gamma=None,
               rstd=None, coeffs2=None, d_in2=None, d_out2=None, bias2=None,
               *, strides1, strides2, activation, residual, in_width,
               mid_width, out_width, plan, drop_chunk=None,
               drop_block=None, stats=None):
    """K4 on the engine, emulated: each row's values as the kernel forms
    them (rounded in float32 as the plain version rounds), the row mean in
    the kernel's order (``_row_mean``), every grad summed over rows in the
    engine's order (``_engine_sum``: pair grads over the plan's row slices,
    per-lane sums in one slice).  Returns ``spm_block_bwd_plain``'s
    outputs; ``stats`` gets each row's sum of |gxh xh|, the magnitudes of
    the row mean's terms."""
    n = 2 * coeffs1.shape[1]
    lane = torch.arange(n)
    two = strides2 is not None
    each = (lambda t: t)
    xr = F.pad(x.float(), (0, n - in_width))
    xh = z0 = xr
    if gamma is not None:
        xh = xr * rstd
        z0 = xh * gamma
    z1, zs1 = stages_collect(z0 * d_in1, coeffs1, strides1)
    u = z1 * d_out1
    if bias1 is not None:
        u = u + bias1
    if two or activation is not None:
        u = torch.where(lane < mid_width, u, 0.0)
    g = F.pad(gy.float(), (0, n - out_width))
    terms = {}
    if two:
        h = K._act(u, activation)
        z2, zs2 = stages_collect(h * d_in2, coeffs2, strides2)
        terms["b2"], terms["dout2"] = g, g * z2
        delta, terms["cf2"] = walk_back(zs2, g * d_out2, coeffs2, strides2,
                                        each)
        terms["din2"] = delta * h
        du = torch.where(lane < mid_width, delta * d_in2, 0.0) \
            * K._act_grad(u, activation)
    elif activation is not None:
        du = g * K._act_grad(u, activation)
    else:
        du = g
    terms["b1"], terms["dout1"] = du, du * z1
    delta, terms["cf1"] = walk_back(zs1, du * d_out1, coeffs1, strides1,
                                    each)
    terms["din1"] = delta * z0
    dz0 = torch.where(lane < in_width, delta * d_in1, 0.0)
    if gamma is not None:
        terms["gamma"] = dz0 * xh
        gxh = dz0 * gamma
        mean = _row_mean(gxh, xh, plan, in_width, drop_block)
        if stats is not None:
            stats["mean_mag"] = (gxh * xh).abs().sum(-1, keepdim=True)
        gx = rstd * (gxh - xh * mean)
    else:
        gx = dz0
    if residual:
        gx = gx + g

    def total(key):
        t = terms[key]
        if key.startswith("cf"):      # (L, B n/2, 4) -> (B, L, n/2, 4)
            t = t.reshape(t.shape[0], x.shape[0], n // 2, 4).permute(
                1, 0, 2, 3)
            return torch.from_numpy(_engine_sum(
                t.contiguous().numpy(), plan, plan.row_slices, drop_chunk))
        return torch.from_numpy(_engine_sum(t.numpy(), plan, 1, drop_chunk))

    out = (gx[:, :in_width].to(x.dtype),)
    if gamma is not None:
        out += (total("gamma"),)
    out += (total("cf1"), total("din1"), total("dout1"))
    if bias1 is not None:
        out += (total("b1"),)
    if two:
        out += (total("cf2"), total("din2"), total("dout2"))
        if bias2 is not None:
            out += (total("b2"),)
    return out


def _k4_within(got, want, mags, mean_mag, x, rstd, rows, in_width):
    """g_x within the row mean's reordering (2 gamma_in_width of its terms'
    magnitudes ``mean_mag``, carried through rstd |xh|) plus 4 f32 ulps;
    every grad within gamma_rows of the sum of its terms' magnitudes."""
    gw, gg = want[0].double(), got[0].double()
    xh = x.double() * rstd.double()
    lim = (2 * _gamma(in_width) * rstd.double() * xh.abs()
           * mean_mag.double() / in_width + 4 * 2.0 ** -23 * gw.abs())
    if not ((gg - gw).abs() <= lim).all():
        return False
    for a, b, m in zip(got[1:], want[1:], mags[1:]):
        if not ((a.double() - b.double()).abs()
                <= _gamma(rows) * m.double()).all():
            return False
    return True


# (label, n, strides1, strides2, rows, activation, residual, in, mid, out,
# lane blocks forced or None): the q form over the planner's split and
# over 4 lane blocks (a row mean across the cluster), k/v at ragged rows,
# the two-stack forms with and without the residual.
K4_CASES = [
    ("q", 256, QKV[:8], None, 300, None, False, 256, 256, 256, None),
    ("q over 4 blocks", 256, QKV[:8], None, 300, None, False, 256, 256, 256,
     4),
    ("kv ragged", 256, QKV[:8], None, 203, None, False, 256, 256, 128, 2),
    ("relu res", 128, QKV[:7], QKV[:7], 77, "relu", True, 128, 96, 128, 4),
    ("gelu padded", 96, (1, 2, 3, 6, 24, 48), (4, 12, 1), 51, "gelu", False,
     90, 80, 96, 2),
]


@pytest.mark.parametrize("label, n, s1, s2, rows, act, res, in_w, mid_w, "
                         "out_w, C", K4_CASES)
def test_emulated_k4_sums_within_gamma_rows(label, n, s1, s2, rows, act,
                                            res, in_w, mid_w, out_w, C):
    """K4's order of sums (row chunks, row slices, groups, the cross-block
    row mean), emulated in float32, stays within gamma_rows of the plain
    version's grads and within the row mean's reordering of its g_x; a
    dropped chunk or a lane block missing from the row mean breaks it."""
    x, gy, ops, kw = _block_case(rows * n, n, s1, s2, rows, act, res, in_w,
                                 mid_w, out_w)
    _, rstd = K.spm_block_plain(x, **ops, **kw)
    plan = K.bwd_plan(rows, n, s1, 1, 4, block=True, strides2=s2, norm=True)
    if C is not None:
        w = n // C
        rs = K.bwd_row_slices(w // 2)
        plan = plan._replace(lane_blocks=C, lanes=w, pair_slots=w // 2,
                             row_slices=rs, threads=w // 2 * rs,
                             chunk_rows=7, groups=3, cluster=C)
    assert len(K.bwd_row_chunks(rows, plan.chunk_rows, plan.groups)) > 1
    want = K.spm_block_bwd_plain(x, gy, rstd=rstd, **ops, **kw)
    mags = K.spm_block_bwd_plain(x, gy, rstd=rstd,
                                 col_sum=lambda t: t.abs().sum(0), **ops,
                                 **kw)
    emu = dict(rstd=rstd, plan=plan, **ops, **kw)
    stats = {}
    got = emulate_k4(x, gy, stats=stats, **emu)
    check = (lambda out: _k4_within(out, want, mags, stats["mean_mag"], x,
                                    rstd, rows, in_w))
    assert check(got)
    assert not check(emulate_k4(x, gy, drop_chunk=1, **emu))
    if plan.lane_blocks > 1:
        assert not check(emulate_k4(x, gy, drop_block=plan.lane_blocks - 1,
                                    **emu))
