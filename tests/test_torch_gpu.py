"""The PyTorch port's CUDA kernels against their plain versions, on the
card.  A CUDA kernel has no CPU mode, so these tests skip (with the reason)
where no Hopper GPU is present; run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are derived as in ``tests/test_torch_spm.py``.
"""

import copy
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import spm_stack as K  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

pytestmark = pytest.mark.gpu

QKV = tuple(1 << i for i in range(11))
FFN = QKV + (3072,)


@pytest.fixture
def cuda():
    """The card, with the kernels built; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs compute capability >= 9.0 (kernels built for "
                    "sm_90a)")
    from repro_torch.kernels import build
    build.load_all()
    return torch.device("cuda")


def _tol(dtype, depth, ref):
    eps32 = float(torch.finfo(torch.float32).eps)
    return 8 * (depth * eps32 + float(torch.finfo(dtype).eps)) * (
        ref.float().abs().max().item() + 1)


def _rnd(gen, *shape, scale=1.0):
    return scale * torch.randn(*shape, generator=gen, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, strides, rows, in_w, out_w", [
    (2048, QKV, 8, 2048, 2048), (2048, QKV, 300, 2048, 2048),
    (6144, FFN, 40, 2048, 6144), (6144, FFN, 40, 6144, 2048),
    (6144, FFN, 5, 2048, 6144), (6144, FFN, 7, 6144, 2048),
    (2048, QKV, 4072, 2048, 2048), (2048, QKV, 1000, 2048, 1024),
    (2048, QKV, 1, 2048, 2048), (6144, FFN, 1, 2048, 6144),
    (6144, FFN, 1000, 6144, 2048)])
def test_k1_matches_plain(cuda, dtype, n, strides, rows, in_w, out_w):
    """K1 through the fused operator against the CPU within the depth
    bound, and each run's launch bit for bit its plain version on the card
    and a second launch (ragged chunks, decode lane splits, the 3072 stage
    on a 6144 tile)."""
    gen = torch.Generator(device="cuda").manual_seed(rows)
    cf = _rnd(gen, len(strides), n // 2, 4, scale=0.5)
    vec = [1 + 0.1 * _rnd(gen, n), 1 + 0.1 * _rnd(gen, n),
           0.1 * _rnd(gen, n)]
    x = _rnd(gen, rows, in_w).to(dtype)
    before = K.spm_stack_kernel_call.launches
    got = ops.spm_stack_fused(x, cf, strides, d_in=vec[0], d_out=vec[1],
                              bias=vec[2], in_width=in_w, out_width=out_w)
    n_runs = len(ops.plan_runs_for_rows(n, strides, rows))
    assert K.spm_stack_kernel_call.launches - before == n_runs
    z, off = x, 0
    runs = ops.plan_runs_for_rows(n, strides, rows)
    for r, (rs, nt) in enumerate(runs):
        last = r == len(runs) - 1
        kw = dict(strides=rs, n_tile=nt,
                  in_width=in_w if r == 0 and in_w != n else None,
                  out_width=out_w if last and out_w != n else None)
        args = (z, cf[off:off + len(rs)], vec[0] if r == 0 else None,
                vec[1] if last else None, vec[2] if last else None)
        z = K.spm_stack_kernel_call(*args, **kw)
        assert torch.equal(z, K.spm_stack_plain(*args, **kw))
        assert torch.equal(z, K.spm_stack_kernel_call(*args, **kw))
        off += len(rs)
    ref = ops.spm_stack_fused(x.cpu(), cf.cpu(), strides, d_in=vec[0].cpu(),
                              d_out=vec[1].cpu(), bias=vec[2].cpu(),
                              in_width=in_w, out_width=out_w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (rows, out_w)
    np.testing.assert_allclose(
        got.float().cpu().numpy(), ref.float().numpy(), rtol=0,
        atol=_tol(dtype, 3 * len(strides) + 3, ref) * n_runs)


def _forced_fwd_plan(monkeypatch, **fields):
    """Make the forward kernels take the given launch-shape fields
    (``FwdPlan``'s) whatever the planner would choose."""
    plan = K.fwd_plan

    def forced(*a, **kw):
        p = plan(*a, **kw)
        f = dict(fields)
        C = f.get("lane_blocks", p.lane_blocks)
        f.setdefault("threads", 256)
        return p._replace(lanes=p.lanes * p.lane_blocks // C,
                          cluster=p.cluster // p.lane_blocks * C, **f)
    monkeypatch.setattr(K, "fwd_plan", forced)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, strides, C, resident", [
    (2048, QKV, 1, False), (2048, QKV, 1, True), (2048, QKV, 2, False),
    (2048, QKV, 4, False), (2048, QKV, 8, False), (6144, FFN, 3, False),
    (768, (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64), 4, False),
    (96, (1, 2, 3, 6, 24, 48, 4, 12), 1, False),
    (96, (1, 2, 3, 6, 24, 48, 4, 12), 1, True)])
def test_k1_every_lane_split_matches_plain(cuda, monkeypatch, dtype, n,
                                           strides, C, resident):
    """The forward engine forced to each lane split of a tile (a cross
    pass over 1, 2 or 3 stages reading the peers' tiles, or none), to
    chunks of 3 rows over 2 row groups, so the cluster barriers repeat a
    chunk, and (one block a tile) to each table source, resident in shared
    memory or read from L2: K1 bit for bit its plain version, a second
    launch bitwise, x rows not 16-byte aligned where the width is 90."""
    _forced_fwd_plan(monkeypatch, lane_blocks=C, chunk_rows=3, groups=2,
                     resident=resident)
    gen = torch.Generator(device="cuda").manual_seed(n + C)
    cf = _rnd(gen, len(strides), n // 2, 4, scale=0.5)
    d_in, d_out, b = (1 + 0.1 * _rnd(gen, n), 1 + 0.1 * _rnd(gen, n),
                      0.1 * _rnd(gen, n))
    in_w = 90 if n == 96 else n
    x = _rnd(gen, 11, in_w).to(dtype)
    kw = dict(strides=strides, n_tile=n, in_width=in_w, out_width=n - 5)
    got = K.spm_stack_kernel_call(x, cf, d_in, d_out, b, **kw)
    again = K.spm_stack_kernel_call(x, cf, d_in, d_out, b, **kw)
    want = K.spm_stack_plain(x, cf, d_in, d_out, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("q8", [False, True])
def test_k1_table_in_shared_memory_or_not_matches_plain(cuda, monkeypatch,
                                                        resident, q8):
    """The gate/up shard run (tiles of 768, strides that do not nest) in
    5-row chunks over 3 row groups, the table resident in shared memory
    (an int8 table dequantized there once) or read from L2 each chunk:
    bit for bit the plain version."""
    from repro_torch.kernels import quant as Q
    _forced_fwd_plan(monkeypatch, chunk_rows=5, groups=3, resident=resident)
    strides = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cf = _rnd(gen, len(strides), 768, 4, scale=0.5)
    cs = None
    if q8:
        cf, cs = Q.quantize_coeffs(cf)
    d_in, d_out = 1 + 0.1 * _rnd(gen, 1536), 1 + 0.1 * _rnd(gen, 1536)
    x = _rnd(gen, 77, 2048).to(torch.bfloat16)
    kw = dict(strides=strides, n_tile=768, in_width=2048, col_base=2)
    got = K.spm_stack_kernel_call(x, cf, d_in, d_out, None, None, cs, **kw)
    want = K.spm_stack_plain(x, cf, d_in, d_out, None, None, cs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_fwd_plans_can_be_scheduled(cuda):
    """cudaOccupancyMaxActiveClusters holds at least one cluster of each
    planned K1 and K5 shape at the serving and training shapes."""
    shapes = [("K1", torch.bfloat16, 2048, QKV, 4096, 1, None),
              ("K1", torch.float32, 2048, QKV, 4096, 1, None),
              ("K1", torch.bfloat16, 2048, QKV, 8, 1, None),
              ("K1", torch.bfloat16, 6144, FFN, 8, 1, None),
              ("K1", torch.int8, 2048, QKV, 4096, 1, 64),
              ("K1", torch.bfloat16, 768,
               (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64), 4096, 2, None),
              ("K5", torch.bfloat16, 512, QKV[:9], 4096, 2, None),
              ("K5", torch.float32, 512, QKV[:9], 4096, 2, None)]
    for kernel, dt, nt, strides, rows, tiles, sr in shapes:
        esz = torch.tensor([], dtype=dt).element_size()
        p = K.fwd_plan(rows, nt, strides, tiles, esz, scale_rows=sr,
                       sides=2 if kernel == "K5" else 1)
        assert K.fwd_clusters_resident(kernel, dt, strides, nt, p) >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, out_w, act, two", [
    (8, 2048, None, False), (333, 1024, None, False),
    (64, 2048, "relu", True), (64, 2048, "silu", True),
    (64, 2048, "gelu", True)])
def test_k3_matches_plain(cuda, dtype, rows, out_w, act, two):
    n = 2048
    gen = torch.Generator(device="cuda").manual_seed(rows + out_w)
    kw = dict(coeffs1=_rnd(gen, 11, n // 2, 4, scale=0.5),
              d_in1=1 + 0.1 * _rnd(gen, n), d_out1=1 + 0.1 * _rnd(gen, n),
              bias1=0.1 * _rnd(gen, n), gamma=1 + 0.1 * _rnd(gen, n),
              strides1=QKV, in_width=n, out_width=out_w, mid_width=out_w)
    if two:
        kw.update(coeffs2=_rnd(gen, 11, n // 2, 4, scale=0.5),
                  d_in2=1 + 0.1 * _rnd(gen, n), d_out2=1 + 0.1 * _rnd(gen, n),
                  bias2=0.1 * _rnd(gen, n), strides2=QKV, activation=act,
                  residual=True, mid_width=1536)
    x = _rnd(gen, rows, n).to(dtype)
    before = K.spm_block_kernel_call.launches
    y, rstd = K.spm_block_kernel_call(x, **kw)
    assert K.spm_block_kernel_call.launches - before == 1
    yp, rstd_p = K.spm_block_plain(x, **kw)
    torch.cuda.synchronize()
    depth = n + 3 * 11 * (2 if two else 1) + 12
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               yp.float().cpu().numpy(), rtol=0,
                               atol=_tol(dtype, depth, yp))
    np.testing.assert_allclose(rstd.cpu().numpy(), rstd_p.cpu().numpy(),
                               rtol=8 * n * 2.0 ** -23)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((4, 16), dtype=torch.float16, device="cuda")
    cf = torch.zeros((2, 8, 4), device="cuda")
    with pytest.raises(TypeError, match="f32 or bf16"):
        K.spm_stack_kernel_call(x, cf, strides=(1, 2), n_tile=16)
    with pytest.raises(ValueError, match="coeffs"):
        K.spm_stack_kernel_call(x.float(), cf.double(), strides=(1, 2),
                                n_tile=16)


def test_smoke_model_on_card_matches_cpu(cuda):
    """The f32 smoke model: the kernels on the card give the plain
    versions' greedy tokens on the CPU."""
    cfg = get_smoke("qwen3-1.7b")
    params = T.init_model(cfg, seed=0, device="cpu")
    cpu_tokens = ServeEngine(cfg=cfg, params=params, max_len=16,
                             cache_dtype=torch.float32, device="cpu"
                             ).generate(torch.arange(16).reshape(2, 8) % 7,
                                        max_new_tokens=6)
    params.to("cuda")
    K.reset_launch_counts()
    gpu_tokens = ServeEngine(cfg=cfg, params=params, max_len=16,
                             cache_dtype=torch.float32).generate(
        torch.arange(16).reshape(2, 8) % 7, max_new_tokens=6)
    assert K.spm_stack_kernel_call.launches > 0
    assert K.spm_block_kernel_call.launches == 3 * cfg.n_layers * 6
    np.testing.assert_array_equal(gpu_tokens.cpu().numpy(),
                                  cpu_tokens.numpy())


def _gamma(k):
    u = 2.0 ** -24
    return k * u / (1 - k * u)


def _grads_within(got, want, mags, k, rel=0.0):
    for g, w, m in zip(got, want, mags):
        lim = (_gamma(k) + rel) * m.float()
        d = (g.float() - w.float()).abs()
        assert bool((d <= lim).all()), (d - lim).max().item()


def _abs_sum(t):
    return t.abs().sum(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, strides, n_tile, rows, in_w, out_w, dead", [
    (2048, QKV, 2048, 300, 2048, 2048, None),
    (6144, FFN[:11], 2048, 64, 2048, 6144, None),
    (6144, FFN, 6144, 8, 2048, 6144, None),          # 8 lane blocks, layout B
    (4096, QKV, 2048, 33, 4096, 1024, None),         # dead-tile skip
    (6144, FFN[:11], 2048, 40, 6144, 6144, 2048),    # dead_from
    (2048, QKV, 2048, 4072, 2048, 2048, None),       # ragged, layouts A and B
    (2048, QKV, 2048, 1, 2048, 2048, None),          # one row
    (1536, (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64), 768, 1000, 1536,
     1536, None),                                    # strides not powers of 2
    (512, QKV[:9], 512, 1000, 512, 512, None),       # one lane block
    (6144, (3072,), 6144, 1000, 6144, 2048, None),   # blocks 4 apart pair up
    (256, QKV[:8], 256, 77, 201, 256, None)])        # unaligned rows of x
def test_k2_matches_plain(cuda, dtype, n, strides, n_tile, rows, in_w,
                          out_w, dead):
    """g_x bit for bit; parameter grads within gamma_rows times the sum of
    their terms' magnitudes (the same terms summed in another order); a
    second launch bitwise equal.  The cases span the planner's lane splits
    (``bwd_plan``: 1, 2, 4 and 8 lane blocks a tile), strides in layouts A
    and B and a lone stride pairing blocks lane for lane, ragged row
    counts and rows whose 16-byte staging does not align."""
    gen = torch.Generator(device="cuda").manual_seed(rows + n)
    cf = _rnd(gen, len(strides), n // 2, 4, scale=0.5)
    d_in, d_out = 1 + 0.1 * _rnd(gen, n), 1 + 0.1 * _rnd(gen, n)
    x = _rnd(gen, rows, in_w).to(dtype)
    gy = _rnd(gen, rows, out_w).to(dtype)
    if dead is not None:
        gy[:, dead:] = 0
    kw = dict(strides=strides, n_tile=n_tile, has_bias=True,
              in_width=None if in_w == n else in_w,
              out_width=None if out_w == n else out_w, dead_from=dead)
    before = K.spm_stack_bwd_kernel_call.launches
    got = K.spm_stack_bwd_kernel_call(x, cf, gy, d_in, d_out, **kw)
    again = K.spm_stack_bwd_kernel_call(x, cf, gy, d_in, d_out, **kw)
    assert K.spm_stack_bwd_kernel_call.launches - before == 2
    want = K.spm_stack_bwd_plain(x, cf, gy, d_in, d_out, **kw)
    mags = K.spm_stack_bwd_plain(x, cf, gy, d_in, d_out, col_sum=_abs_sum,
                                 **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    _grads_within(got[1:], want[1:], mags[1:], rows)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, n_tile, rows, in_w, out_w, dead, int8", [
    (9216, 9216, 8, 9216, 9216, None, False),       # minitron-4b's gate/up
    (9216, 9216, 2048, 9216, 9216, None, False),
    (25600, 25600, 8, 25600, 25600, None, False),   # qwen3-32b's
    (25600, 25600, 2048, 25600, 25600, None, False),
    (18944, 9472, 300, 18944, 3584, None, False),   # two tiles, one dead
    (18944, 9472, 77, 18944, 18944, 9472, False),   # dead_from
    (15360, 15360, 33, 3840, 15360, None, False),   # x zero past in_width
    (9216, 9216, 300, 9216, 9216, None, True),      # int8 x (--quantize)
    (18944, 9472, 77, 18944, 18944, None, True),    # a scale for each tile
    (15360, 15360, 33, 3840, 15360, None, True)])   # int8 x past in_width
def test_k2_lone_wide_stage_matches_plain(cuda, dtype, n, n_tile, rows, in_w,
                                          out_w, dead, int8):
    """K2's split mode: a lone stage on a tile wider than one cluster's 8
    blocks of 512 pair slots (``bwd_plan``'s ``split``), held as
    ``test_k2_matches_plain`` holds the other plans: g_x bit for bit, the
    grads within gamma_rows, a second launch bitwise equal; with an int8
    x (``x_scale``) as ``--quantize`` saves it, dequantized with the scale
    of its tile."""
    from repro_torch.kernels import quant as Q
    strides = (n_tile // 2,)
    gen = torch.Generator(device="cuda").manual_seed(rows + n)
    cf = _rnd(gen, 1, n // 2, 4, scale=0.5)
    d_in, d_out = 1 + 0.1 * _rnd(gen, n), 1 + 0.1 * _rnd(gen, n)
    x, xs, sr = _rnd(gen, rows, in_w), None, None
    if int8:
        sr = Q.scale_block_rows([(strides, n_tile)], rows, 2)
        x, xs = Q.quantize_blocks(ops._pad_rows(x, sr), sr, n_tile)
        rows = x.shape[0]
    else:
        x = x.to(dtype)
    plan = K.bwd_plan(rows, n_tile, strides, n // n_tile, 2,
                      x.element_size())
    assert plan.split > 0 and plan.cluster == 1
    gy = _rnd(gen, rows, out_w).to(dtype)
    if dead is not None:
        gy[:, dead:] = 0
    kw = dict(strides=strides, n_tile=n_tile, has_bias=True,
              in_width=None if in_w == n else in_w,
              out_width=None if out_w == n else out_w, dead_from=dead,
              scale_rows=sr)
    before = (K.spm_stack_bwd_kernel_call.launches,
              K.spm_stack_bwd_kernel_call.split_launches)
    got = K.spm_stack_bwd_kernel_call(x, cf, gy, d_in, d_out, xs, **kw)
    again = K.spm_stack_bwd_kernel_call(x, cf, gy, d_in, d_out, xs, **kw)
    assert (K.spm_stack_bwd_kernel_call.launches - before[0],
            K.spm_stack_bwd_kernel_call.split_launches - before[1]) == (2, 2)
    want = K.spm_stack_bwd_plain(x, cf, gy, d_in, d_out, xs, **kw)
    mags = K.spm_stack_bwd_plain(x, cf, gy, d_in, d_out, xs,
                                 col_sum=_abs_sum, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and got[0].dtype == dtype
    _grads_within(got[1:], want[1:], mags[1:], rows)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _arch_linears(arch):
    """(name, LinearConfig) of a full-width layer's linears that run on K1
    and K2: q, k and v unless they fuse into block launches."""
    from repro_torch.configs import get_config
    from repro_torch.layers.attention import qkv_block_fused
    cfg = get_config(arch)
    acfg, fcfg = cfg.attn_cfg(cfg.layers[0]), cfg.ffn_cfg()
    lins = [("o", acfg.o_proj), ("gate", fcfg.gate), ("down", fcfg.down)]
    if not qkv_block_fused(acfg):
        lins += [("q", acfg.q_proj), ("kv", acfg.kv_proj)]
    return lins


@pytest.mark.parametrize("rows", [5, 300])
@pytest.mark.parametrize("arch", ["gemma3-12b", "qwen2-vl-7b",
                                  "musicgen-medium", "minitron-4b",
                                  "qwen3-32b"])
def test_arch_linears_match_plain(cuda, arch, rows):
    """Every K1/K2 linear of each arch at full width (its own widths, run
    plan and row-count tile cap), bf16: the run chain's output bit for bit
    (``forward_runs``), and its backward (``backward_runs``) with g_x bit
    for bit and the grads within gamma_rows."""
    gen = torch.Generator(device="cuda").manual_seed(rows)
    for name, lin in _arch_linears(arch):
        scfg = lin.spm_config()
        n = scfg.n
        runs = ops.plan_runs_for_rows(n, scfg.pairing.strides(), rows)
        L = sum(len(rs) for rs, _ in runs)
        cf = _rnd(gen, L, n // 2, 4, scale=0.5)
        d_in, d_out = 1 + 0.1 * _rnd(gen, n), 1 + 0.1 * _rnd(gen, n)
        b = 0.1 * _rnd(gen, n)
        widths = (None if lin.d_in == n else lin.d_in,
                  None if lin.d_out == n else lin.d_out)
        x = _rnd(gen, rows, lin.d_in).bfloat16()
        gy = _rnd(gen, rows, lin.d_out).bfloat16()
        y, saved = ops.forward_runs(x, cf, runs, d_in, d_out, b, *widths)
        z = x
        for r, (rs, nt) in enumerate(runs):
            off = sum(len(q) for q, _ in runs[:r])
            last = r == len(runs) - 1
            z = K.spm_stack_plain(
                z, cf[off: off + len(rs)], d_in if r == 0 else None,
                d_out if last else None, b if last else None, strides=rs,
                in_width=widths[0] if r == 0 else None,
                out_width=widths[1] if last else None)
        args = (saved, cf, gy, runs, d_in, d_out, True, *widths)
        got = ops.backward_runs(K.spm_stack_bwd_kernel_call, *args)
        want = ops.backward_runs(K.spm_stack_bwd_plain, *args)
        mags = ops.backward_runs(functools.partial(
            K.spm_stack_bwd_plain, col_sum=_abs_sum), *args)
        torch.cuda.synchronize()
        assert torch.equal(y, z), (arch, name)
        for a, p, m in zip(got, want, mags):
            assert torch.equal(a[0], p[0]), (arch, name)
            _grads_within(a[1:], p[1:], m[1:], rows)


def _forced_plan(monkeypatch, C, R, G):
    """Make the backward kernels take C lane blocks, R-row chunks and G row
    groups whatever the planner would choose."""
    plan = K.bwd_plan

    def forced(n_rows, n_tile, *a, **kw):
        p = plan(n_rows, n_tile, *a, **kw)
        w = n_tile // C
        rs = K.bwd_row_slices(w // 2)
        return p._replace(lane_blocks=C, lanes=w, pair_slots=w // 2,
                          row_slices=rs, threads=w // 2 * rs,
                          chunk_rows=R, groups=G,
                          cluster=C * p.cluster // p.lane_blocks)
    monkeypatch.setattr(K, "bwd_plan", forced)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_k2_every_lane_split_matches_plain(cuda, monkeypatch, dtype, C):
    """The engine forced to each lane split of a 96-wide tile whose
    strides take every mode (``bwd_stage_modes``; at 8 blocks of 12 lanes:
    layout A, a run in layout B, a stride reaching across blocks
    wherever, a pair of blocks lane for lane) and fused passes in both
    layouts (``bwd_passes``): g_x bit for bit, grads within gamma_rows, a
    second launch bitwise; 77 rows in chunks of 5 over 3 row groups, x
    and gy rows not 16-byte aligned."""
    n, strides = 96, (1, 2, 3, 6, 24, 48, 4, 12)
    _forced_plan(monkeypatch, C, 5, 3)
    gen = torch.Generator(device="cuda").manual_seed(C)
    cf = _rnd(gen, len(strides), n // 2, 4, scale=0.5)
    d_in, d_out = 1 + 0.1 * _rnd(gen, n), 1 + 0.1 * _rnd(gen, n)
    x = _rnd(gen, 77, 90).to(dtype)
    gy = _rnd(gen, 77, n).to(dtype)
    kw = dict(strides=strides, n_tile=n, has_bias=True, in_width=90)
    got = K.spm_stack_bwd_kernel_call(x, cf, gy, d_in, d_out, **kw)
    again = K.spm_stack_bwd_kernel_call(x, cf, gy, d_in, d_out, **kw)
    want = K.spm_stack_bwd_plain(x, cf, gy, d_in, d_out, **kw)
    mags = K.spm_stack_bwd_plain(x, cf, gy, d_in, d_out, col_sum=_abs_sum,
                                 **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    _grads_within(got[1:], want[1:], mags[1:], 77)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_k6_every_lane_split_matches_plain(cuda, monkeypatch, dtype, C):
    """K6 forced to each lane split of 4 shards of 96 lanes (the K2
    test's strides: layouts A and B, fused passes, a pair of blocks lane
    for lane), d_out folded, a windowed input: g_x bit for bit, the grads
    and sums within gamma_rows, a second launch bitwise; 77 rows in
    chunks of 5 over 3 row groups."""
    S, nl, strides = 4, 96, (1, 2, 3, 6, 24, 48, 4, 12)
    _forced_plan(monkeypatch, C, 5, 3)
    gen = torch.Generator(device="cuda").manual_seed(10 + C)
    cf, (_, _, u, v), d_in, d_out, _, x, gy = _pair_operands(
        gen, S, nl, strides, 77, 300, True, dtype)
    kw = dict(strides=strides, n_tile=nl, k=2, in_width=300)
    got = K.spm_overlap_bwd_kernel_call(x, cf, gy, u, v, d_in, d_out, **kw)
    again = K.spm_overlap_bwd_kernel_call(x, cf, gy, u, v, d_in, d_out, **kw)
    ref = K.spm_overlap_bwd_plain(x, cf, gy, u, v, d_in, d_out, **kw)
    mags = K.spm_overlap_bwd_plain(x, cf, gy, u, v, d_in, d_out,
                                   col_sum=_abs_sum, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0])
    _grads_within(got[1:], ref[1:], mags[1:], 77)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, out_w, act, two, res", [
    (8, 2048, None, False, False), (333, 1024, None, False, False),
    (64, 2048, "relu", True, True), (64, 1536, "silu", True, False),
    (64, 2048, "gelu", True, True)])
def test_k4_matches_plain(cuda, dtype, rows, out_w, act, two, res):
    """g_x within the K3 test's bound; parameter grads within gamma_rows
    times the sum of magnitudes, plus, past an activation, the f32 term of
    its exp/tanh; a second launch bitwise equal."""
    n = 2048
    gen = torch.Generator(device="cuda").manual_seed(rows + out_w)
    kw = dict(coeffs1=_rnd(gen, 11, n // 2, 4, scale=0.5),
              d_in1=1 + 0.1 * _rnd(gen, n), d_out1=1 + 0.1 * _rnd(gen, n),
              bias1=0.1 * _rnd(gen, n), gamma=1 + 0.1 * _rnd(gen, n),
              strides1=QKV, in_width=n, out_width=out_w, mid_width=out_w)
    if two:
        kw.update(coeffs2=_rnd(gen, 11, n // 2, 4, scale=0.5),
                  d_in2=1 + 0.1 * _rnd(gen, n), d_out2=1 + 0.1 * _rnd(gen, n),
                  bias2=0.1 * _rnd(gen, n), strides2=QKV, activation=act,
                  residual=res, mid_width=1536)
    x = _rnd(gen, rows, n).to(dtype)
    gy = _rnd(gen, rows, out_w).to(dtype)
    _, rstd = K.spm_block_kernel_call(x, **kw)
    before = K.spm_block_bwd_kernel_call.launches
    got = K.spm_block_bwd_kernel_call(x, gy, rstd=rstd, **kw)
    again = K.spm_block_bwd_kernel_call(x, gy, rstd=rstd, **kw)
    assert K.spm_block_bwd_kernel_call.launches - before == 2
    want = K.spm_block_bwd_plain(x, gy, rstd=rstd, **kw)
    mags = K.spm_block_bwd_plain(x, gy, rstd=rstd, col_sum=_abs_sum, **kw)
    torch.cuda.synchronize()
    depth = n + 3 * 11 * (2 if two else 1) + 12
    np.testing.assert_allclose(got[0].float().cpu().numpy(),
                               want[0].float().cpu().numpy(), rtol=0,
                               atol=_tol(dtype, depth, want[0]))
    rel = 8 * (4 + 3 * 22 + 12) * 2.0 ** -23 if act else 0.0
    _grads_within(got[1:], want[1:], mags[1:], rows, rel)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


MIXED = (1, 2, 3, 6, 24, 48, 4, 12)


def _block_kw(gen, n, s1, s2, act, res, in_w, mid_w, out_w, bias=True):
    """A block's operands on the card: near-rotation tables, diagonals near
    1, gamma zero past in_w."""
    gamma = 1 + 0.1 * _rnd(gen, n)
    gamma[in_w:] = 0.0
    kw = dict(coeffs1=_rnd(gen, len(s1), n // 2, 4, scale=0.5),
              d_in1=1 + 0.1 * _rnd(gen, n), d_out1=1 + 0.1 * _rnd(gen, n),
              bias1=0.1 * _rnd(gen, n) if bias else None, gamma=gamma,
              strides1=s1, in_width=in_w, out_width=out_w, mid_width=mid_w,
              activation=act, residual=res)
    if s2 is not None:
        kw.update(coeffs2=_rnd(gen, len(s2), n // 2, 4, scale=0.5),
                  d_in2=1 + 0.1 * _rnd(gen, n), d_out2=1 + 0.1 * _rnd(gen, n),
                  bias2=0.1 * _rnd(gen, n) if bias else None, strides2=s2)
    return kw


def _k3_composition(x, rstd, kw):
    """K3's function given its rstd, composed of plain pieces: ((x rstd)
    gamma) d_in1 rounded in that order, spm_stack_plain with d_out1 and
    bias1, the mid_width mask and the activation, stack 2 through
    spm_stack_plain, the residual, the store."""
    n = 2 * kw["coeffs1"].shape[1]
    lane = torch.arange(n, device=x.device)
    xr = torch.nn.functional.pad(x.float(), (0, n - kw["in_width"]))
    z = (xr * rstd * kw["gamma"]) * kw["d_in1"]
    z = K.spm_stack_plain(z, kw["coeffs1"], None, kw["d_out1"], kw["bias1"],
                          strides=kw["strides1"])
    two = kw.get("strides2") is not None
    if two or kw["activation"] is not None:
        z = K._act(torch.where(lane < kw["mid_width"], z, 0.0),
                   kw["activation"])
    if two:
        z = K.spm_stack_plain(z, kw["coeffs2"], kw["d_in2"], kw["d_out2"],
                              kw["bias2"], strides=kw["strides2"])
    if kw["residual"]:
        z = z + xr
    return z[:, :kw["out_width"]].to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, s1, s2, rows, act, res, in_w, mid_w, out_w", [
    (2048, QKV, None, 4072, None, False, 2048, 2048, 2048),   # q, ragged
    (2048, QKV, None, 1, None, False, 2048, 1024, 1024),      # k/v, one row
    (2048, QKV, None, 8, None, False, 2048, 1024, 1024),      # k/v, decode
    (2048, QKV, QKV, 67, "relu", True, 2048, 1536, 2048),
    (96, MIXED, MIXED[::-1], 45, "relu", True, 90, 80, 90),
    (96, MIXED, None, 45, None, True, 90, 96, 90)])
def test_k3_is_the_plain_composition_given_its_rstd(cuda, dtype, n, s1, s2,
                                                    rows, act, res, in_w,
                                                    mid_w, out_w):
    """With the kernel's own rstd, y is bit for bit the plain composition
    (only the row's sum of squares is summed in another order), rstd within
    the sum's reordering of the plain version's; a second launch bitwise."""
    gen = torch.Generator(device="cuda").manual_seed(rows + n)
    kw = _block_kw(gen, n, s1, s2, act, res, in_w, mid_w, out_w)
    x = _rnd(gen, rows, in_w).to(dtype)
    y, rstd = K.spm_block_kernel_call(x, **kw)
    y2, rstd2 = K.spm_block_kernel_call(x, **kw)
    _, rstd_p = K.spm_block_plain(x, **kw)
    want = _k3_composition(x, rstd, kw)
    torch.cuda.synchronize()
    assert torch.equal(y, want)
    assert torch.equal(y, y2) and torch.equal(rstd, rstd2)
    np.testing.assert_allclose(rstd.cpu().numpy(), rstd_p.cpu().numpy(),
                               rtol=8 * (math.sqrt(n) + 4) * 2.0 ** -23)


def _k4_check(x, gy, kw, dtype, rows):
    """K4 against its plain version from K3's rstd: g_x within the K3
    test's bound, every grad within gamma_rows of its terms' magnitudes
    (exact zeros on dead lanes), a second launch bitwise."""
    n = 2 * kw["coeffs1"].shape[1]
    _, rstd = K.spm_block_kernel_call(x, **kw)
    got = K.spm_block_bwd_kernel_call(x, gy, rstd=rstd, **kw)
    again = K.spm_block_bwd_kernel_call(x, gy, rstd=rstd, **kw)
    want = K.spm_block_bwd_plain(x, gy, rstd=rstd, **kw)
    mags = K.spm_block_bwd_plain(x, gy, rstd=rstd, col_sum=_abs_sum, **kw)
    torch.cuda.synchronize()
    two = kw.get("strides2") is not None
    L = len(kw["strides1"]) + (len(kw["strides2"]) if two else 0)
    np.testing.assert_allclose(got[0].float().cpu().numpy(),
                               want[0].float().cpu().numpy(), rtol=0,
                               atol=_tol(dtype, n + 3 * L + 12, want[0]))
    rel = 8 * (4 + 3 * L + 12) * 2.0 ** -23 if kw["activation"] else 0.0
    _grads_within(got[1:], want[1:], mags[1:], rows, rel)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    in_w = kw["in_width"]
    assert not got[1][in_w:].any() and not got[3][in_w:].any()
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, out_w", [(4072, 2048), (4072, 1024),
                                         (1, 2048), (1, 1024)])
def test_k4_ragged_and_one_row_match_plain(cuda, dtype, rows, out_w):
    """The q and k/v forms at 4072 rows (no chunk or row group even) and
    one row."""
    gen = torch.Generator(device="cuda").manual_seed(rows + out_w)
    kw = _block_kw(gen, 2048, QKV, None, None, False, 2048, out_w, out_w)
    x = _rnd(gen, rows, 2048).to(dtype)
    gy = _rnd(gen, rows, out_w).to(dtype)
    _k4_check(x, gy, kw, dtype, rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("form", ["norm", "two", "one act"])
def test_k4_every_lane_split_matches_plain(cuda, monkeypatch, dtype, C,
                                           form):
    """K4 forced to each lane split of a 96-wide tile whose strides take
    every mode of the engine (layouts A and B, a stride reaching across
    blocks, a pair of blocks lane for lane), 5-row chunks over 3 row groups
    (the row mean crosses the cluster every chunk): the q form with a
    padded width, the two-stack form with the residual, one stack with an
    activation and no bias; g_x and grads as ``_k4_check``, dead lanes
    exactly zero."""
    _forced_plan(monkeypatch, C, 5, 3)
    gen = torch.Generator(device="cuda").manual_seed(C)
    s2, act, res = {"norm": (None, None, False),
                    "two": (MIXED[::-1], "gelu", True),
                    "one act": (None, "silu", False)}[form]
    out_w = 90 if res else 84
    kw = _block_kw(gen, 96, MIXED, s2, act, res, 90, 80, out_w,
                   bias=form != "one act")
    x = _rnd(gen, 77, 90).to(dtype)
    gy = _rnd(gen, 77, out_w).to(dtype)
    _k4_check(x, gy, kw, dtype, 77)


@pytest.mark.parametrize("streamed", [1, 2])
def test_k4_streamed_tables_match_plain(cuda, monkeypatch, streamed):
    """The named mode for blocks whose tables stay off chip: stack 1's (and
    stack 2's) table and grad sums stream from a device-memory slab,
    forced on a small two-stack block; and the 32 + 32-stage block on 2048
    lanes, whose tables the planner streams itself."""
    plan = K.bwd_plan

    def forced(*a, **kw):
        return plan(*a, **kw)._replace(streamed=streamed)
    monkeypatch.setattr(K, "bwd_plan", forced)
    gen = torch.Generator(device="cuda").manual_seed(streamed)
    kw = _block_kw(gen, 96, MIXED, MIXED[::-1], "relu", True, 90, 80, 90)
    x = _rnd(gen, 77, 90)
    _k4_check(x, _rnd(gen, 77, 90), kw, torch.float32, 77)
    monkeypatch.setattr(K, "bwd_plan", plan)
    big = tuple(1 << (i % 11) for i in range(32))
    assert K.bwd_plan(64, 2048, big, 1, 4, block=True, strides2=big,
                      norm=True).streamed >= 1
    kw = _block_kw(gen, 2048, big, big[::-1], "silu", True, 2048, 1536, 2048)
    x = _rnd(gen, 64, 2048)
    _k4_check(x, _rnd(gen, 64, 2048), kw, torch.float32, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R, G, resident", [(3, 2, False), (3, 2, True),
                                            (1, 5, True)])
def test_k3_chunk_shapes_match_plain(cuda, monkeypatch, dtype, R, G,
                                     resident):
    """K3 forced to 3-row chunks over 2 row groups (and one-row chunks over
    5), stack 1's table resident in shared memory or read from L2: the q
    form and the two-stack form with the residual bit for bit the plain
    composition given the kernel's rstd."""
    _forced_fwd_plan(monkeypatch, chunk_rows=R, groups=G, resident=resident)
    gen = torch.Generator(device="cuda").manual_seed(R * G)
    for s2, act, res in ((None, None, False), (QKV[::-1], "relu", True)):
        kw = _block_kw(gen, 2048, QKV, s2, act, res, 2048, 1536,
                       2048 if res else 1024)
        x = _rnd(gen, 23, 2048).to(dtype)
        y, rstd = K.spm_block_kernel_call(x, **kw)
        want = _k3_composition(x, rstd, kw)
        torch.cuda.synchronize()
        assert torch.equal(y, want)


def test_smoke_train_steps_on_card_match_cpu(cuda):
    """Two steps of the f32 smoke model: the losses and the params after
    each step on the card within the CPU tests' depth bound of the CPU's;
    the backward kernels ran."""
    from repro_torch.models import causal_lm as LM
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train import make_train_state, make_train_step
    cfg = get_smoke("qwen3-1.7b")
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (4, 13), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for dev in ("cpu", "cuda"):
        params = T.init_model(cfg, seed=0, device="cpu").to(dev)
        state = make_train_state(params)
        step = make_train_step(lambda p, b: LM.lm_loss(p, b, cfg),
                               OptimizerConfig(lr=1e-2, warmup_steps=1,
                                               total_steps=2))
        K.reset_launch_counts()
        losses = []
        for _ in range(2):
            state, m = step(state, {k: v.to(dev) for k, v in
                                    batch.items()})
            losses.append(float(m["loss"]))
        out[dev] = (losses, {k: v.detach().cpu() for k, v in
                             params.state_dict().items()})
        if dev == "cuda":
            assert K.spm_stack_bwd_kernel_call.launches > 0
            assert K.spm_block_bwd_kernel_call.launches == \
                2 * 3 * cfg.n_layers
    depth = 2 * (cfg.n_layers * (2 * cfg.d_model + 200) + 2 * cfg.d_model)
    rel = 8 * depth * 2.0 ** -23
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=rel)
    p_cpu, p_gpu = out["cpu"][1], out["cuda"][1]
    p0 = T.init_model(cfg, seed=0, device="cpu").state_dict()
    diff = sum(float(((p_gpu[k] - p_cpu[k]) ** 2).sum()) for k in p_cpu)
    moved = sum(float(((p_cpu[k] - p0[k]) ** 2).sum()) for k in p_cpu)
    assert diff ** 0.5 <= rel * moved ** 0.5


@pytest.mark.parametrize("mode", ["acts", "coeffs", "both"])
@pytest.mark.parametrize("n, strides, rows, in_w, out_w, dtype", [
    (2048, QKV, 64, 2048, 2048, torch.bfloat16),   # 8-row blocks, cluster 8
    (2048, QKV, 40, 2048, 1024, torch.float32),    # edge tile, padded rows
    (6144, FFN, 8, 2048, 6144, torch.bfloat16),    # one 6144 run, cluster 8
    (2048, QKV, 1000, 2048, 2048, torch.bfloat16),   # ragged chunks
    (2048, QKV, 4072, 2048, 2048, torch.bfloat16),   # a padded scale block
    (2048, QKV, 1, 2048, 2048, torch.float32)])      # one row
def test_int8_k1_k2_match_plain(cuda, mode, n, strides, rows, in_w, out_w,
                                dtype):
    """K1's int8 codes and scales and K2's g_x bit for bit against the
    plain versions, in each int8 mode, a chunk one scale block over a
    cluster of row blocks (several where the block has 8 rows or more);
    K2's parameter grads within gamma_rows times the sum of magnitudes;
    second launches bitwise equal; the int8 launches counted apart."""
    from repro_torch.kernels import quant as Q
    q_acts, q_cf = mode in ("acts", "both"), mode in ("coeffs", "both")
    gen = torch.Generator(device="cuda").manual_seed(rows + n)
    ((rs, nt),) = ops.plan_runs_for_rows(n, strides, rows)
    sr = Q.scale_block_rows([(rs, nt)], rows, 2)
    cf = _rnd(gen, len(strides), n // 2, 4, scale=0.5)
    vec = [1 + 0.1 * _rnd(gen, n), 1 + 0.1 * _rnd(gen, n),
           0.1 * _rnd(gen, n)]
    x = ops._pad_rows(_rnd(gen, rows, in_w), sr)
    cf, cs = Q.quantize_coeffs(cf) if q_cf else (cf, None)
    x, xs = Q.quantize_blocks(x, sr, nt) if q_acts else (x.to(dtype), None)
    if q_acts:
        p = K.fwd_plan(x.shape[0], nt, rs, -(-out_w // nt), 1, scale_rows=sr)
        assert p.row_blocks * p.chunk_rows == sr
        assert p.row_blocks > 1 or sr < 8
    kw = dict(strides=rs, n_tile=nt, in_width=None if in_w == n else in_w,
              out_width=None if out_w == n else out_w, quant_out=q_acts,
              scale_rows=sr)
    K.reset_launch_counts()
    got = K.spm_stack_kernel_call(x, cf, *vec, xs, cs, **kw)
    again = K.spm_stack_kernel_call(x, cf, *vec, xs, cs, **kw)
    want = K.spm_stack_plain(x, cf, *vec, xs, cs, **kw)
    gy = _rnd(gen, x.shape[0], out_w).to(dtype)
    bkw = dict(kw, has_bias=True)
    bkw.pop("quant_out")
    g = K.spm_stack_bwd_kernel_call(x, cf, gy, *vec[:2], xs, cs, **bkw)
    g2 = K.spm_stack_bwd_kernel_call(x, cf, gy, *vec[:2], xs, cs, **bkw)
    gp = K.spm_stack_bwd_plain(x, cf, gy, *vec[:2], xs, cs, **bkw)
    mags = K.spm_stack_bwd_plain(x, cf, gy, *vec[:2], xs, cs,
                                 col_sum=_abs_sum, **bkw)
    torch.cuda.synchronize()
    for fn in (K.spm_stack_kernel_call, K.spm_stack_bwd_kernel_call):
        assert (fn.launches, fn.int8_launches,
                fn.int8_io_launches) == (2, 2, 2 if q_acts else 0)
    pairs = zip(got, want) if q_acts else [(got, want)]
    assert all(torch.equal(a, b) for a, b in pairs)
    if q_acts:
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    else:
        assert torch.equal(got, again)
    assert torch.equal(g[0], gp[0]) and g[0].dtype == dtype
    _grads_within(g[1:], gp[1:], mags[1:], x.shape[0])
    assert all(torch.equal(a, b) for a, b in zip(g, g2))


def test_int8_scale_block_too_large_raises(cuda):
    """A 1024 x 512 scale block (n = 512, strides (1, 256), bf16: the
    reference's grid) needs 128-row blocks of 256 KiB f32 in a cluster of
    8: more shared memory than a block has, so the call raises instead of
    running elsewhere."""
    from repro_torch.kernels import quant as Q
    strides = (1, 256)
    runs = ops.plan_runs_for_rows(512, strides, 1024)
    assert runs == ((strides, 512),)
    sr = Q.scale_block_rows(runs, 1024, 2)
    assert sr == 1024
    x, xs = Q.quantize_blocks(torch.randn(1024, 512, device="cuda"), sr, 512)
    cf = torch.randn(2, 256, 4, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        K.spm_stack_kernel_call(x, cf, None, None, None, xs, strides=strides,
                                n_tile=512, quant_out=True, scale_rows=sr)
    with pytest.raises(ValueError, match="shared memory"):
        ops.spm_stack_fused(torch.randn(1024, 512, device="cuda",
                                        dtype=torch.bfloat16), cf, strides,
                            quant_acts=True)


@pytest.mark.parametrize("rows", [64, 1000, 4072, 1])
def test_int8_k1_nonfinite_store_matches_plain(cuda, rows):
    """Scale blocks holding a NaN and an Inf (tile 0 of three, through
    d_out) and an Inf alone (tile 1), each a chunk over a cluster of row
    blocks: the cluster's absmax keeps them, so those scales are NaN and
    Inf and every code 0, exactly the plain version's (NaN equal to NaN);
    tile 2 stays finite.  Ragged row counts are padded to the scale block,
    as the fused entry pads them; a padded zero row times the Inf of d_out
    makes its block's scale in tile 1 NaN, as in the plain version."""
    from repro_torch.kernels import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(99)
    n = 6144
    ((rs, nt),) = ops.plan_runs_for_rows(n, QKV, max(rows, 64))
    assert n // nt == 3
    sr = Q.scale_block_rows([(rs, nt)], rows, 2)
    x = ops._pad_rows(_rnd(gen, rows, n), sr)
    p = K.fwd_plan(x.shape[0], nt, rs, n // nt, 1, scale_rows=sr)
    assert p.row_blocks * p.chunk_rows == sr
    assert p.row_blocks > 1 or sr < 8
    qx, xs = Q.quantize_blocks(x, sr, nt)
    qc, sc = Q.quantize_coeffs(_rnd(gen, len(rs), n // 2, 4, scale=0.5))
    d_out = torch.ones(n, device="cuda")
    d_out[5], d_out[9], d_out[nt + 3] = math.nan, math.inf, math.inf
    kw = dict(strides=rs, n_tile=nt, quant_out=True, scale_rows=sr)
    kq, ks = K.spm_stack_kernel_call(qx, qc, None, d_out, None, xs, sc, **kw)
    pq, ps = K.spm_stack_plain(qx, qc, None, d_out, None, xs, sc, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kq, pq)
    assert torch.allclose(ks, ps, rtol=0, atol=0, equal_nan=True)
    full = rows // sr    # scale blocks holding no padded (zero) row
    assert ks[:, 0].isnan().all() and ks[:full, 1].isinf().all()
    assert ks[full:, 1].isnan().all()     # a padded row's 0 x Inf
    assert torch.isfinite(ks[:, 2]).all()
    assert not kq[:, :2 * nt].any() and kq[:, 2 * nt:].any()


def test_quantized_smoke_model_on_card_matches_cpu(cuda):
    """The f32 smoke model under with_quantized_io: every linear's K1
    launch moves int8 activations and no block kernel runs.  The CPU
    replays the card's int8 codes (``kernels.codes.CodeTape``), so each
    chain's CPU output from the card's entry must be the card's bit for
    bit, the CPU's own entry codes within one of the card's, and the
    logits within the f32 depth bound alone."""
    from repro_torch.configs import with_quantized_io
    from repro_torch.kernels.codes import CodeTape
    cfg = with_quantized_io(get_smoke("qwen3-1.7b"))
    params = T.init_model(cfg, seed=0, device="cpu")
    toks = torch.arange(32).reshape(2, 16) % 11
    card = T.init_model(cfg, seed=0, device="cpu").to("cuda")
    K.reset_launch_counts()
    with CodeTape() as rec:
        got = T.forward(card, cfg, tokens=toks.cuda())[0]
    torch.cuda.synchronize()
    assert K.spm_stack_kernel_call.int8_io_launches == 7 * cfg.n_layers
    assert K.spm_block_kernel_call.launches == 0
    with CodeTape(replay=rec) as cpu:
        want = T.forward(params, cfg, tokens=toks)[0]
    codes = cpu.summary()
    assert codes["chains"] == codes["recorded"] == 7 * cfg.n_layers
    assert codes["out_differ"] == 0 and codes["entry_max_diff"] <= 1
    depth = cfg.n_layers * (2 * cfg.d_model + 200) + 2 * cfg.d_model
    rel = 8 * depth * 2.0 ** -23
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=0,
                               atol=rel * want.abs().max().item())


SHARD_FFN = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)   # two_level n=6144


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [8, 300, 1000, 4072, 1])
@pytest.mark.parametrize("shard", [0, 1, 2, 3])
def test_window_k1_k2_match_plain(cuda, dtype, rows, shard):
    """The windowed (``col_base``) modes at the gate/up shard shapes: one
    shard's n_local=1536 slab of the global in_width=2048 input, tiles of
    768 (shard 0 live, 1 straddling, 2 and 3 past the edge).  K1 and K2's
    g_x bit for bit, K2's grads within gamma_rows of the sum of
    magnitudes, the window launches counted apart; then K2's gy window
    against a global out_width=2048 cotangent."""
    nl, nt, in_w = 1536, 768, 2048
    base = shard * nl // nt
    gen = torch.Generator(device="cuda").manual_seed(shard + rows)
    cf = _rnd(gen, len(SHARD_FFN), nl // 2, 4, scale=0.5)
    d_in, d_out, b = (1 + 0.1 * _rnd(gen, nl), 1 + 0.1 * _rnd(gen, nl),
                      0.1 * _rnd(gen, nl))
    x = _rnd(gen, rows, in_w).to(dtype)
    kw = dict(strides=SHARD_FFN, n_tile=nt, in_width=in_w, col_base=base)
    before = (K.spm_stack_kernel_call.window_launches,
              K.spm_stack_bwd_kernel_call.window_launches)
    y = K.spm_stack_kernel_call(x, cf, d_in, d_out, b, **kw)
    want = K.spm_stack_plain(x, cf, d_in, d_out, b, **kw)
    gy = _rnd(gen, rows, nl).to(dtype)
    got = K.spm_stack_bwd_kernel_call(x, cf, gy, d_in, d_out,
                                      has_bias=True, **kw)
    ref = K.spm_stack_bwd_plain(x, cf, gy, d_in, d_out, has_bias=True, **kw)
    mags = K.spm_stack_bwd_plain(x, cf, gy, d_in, d_out, has_bias=True,
                                 col_sum=_abs_sum, **kw)
    torch.cuda.synchronize()
    assert (K.spm_stack_kernel_call.window_launches - before[0],
            K.spm_stack_bwd_kernel_call.window_launches - before[1]) == (1, 1)
    assert y.shape == (rows, nl) and torch.equal(y, want)
    if shard >= 2:
        assert torch.equal(y, b.to(dtype).expand(rows, -1))
    assert got[0].shape == (rows, nl) and torch.equal(got[0], ref[0])
    _grads_within(got[1:], ref[1:], mags[1:], rows)
    live = max(0, min(nl, in_w - shard * nl))
    assert not got[2][live:].any()                # g_din past in_width
    # gy read through the window: the down projection's shape
    xs = _rnd(gen, rows, nl).to(dtype)
    gkw = dict(strides=SHARD_FFN, n_tile=nt, out_width=in_w, col_base=base,
               has_bias=True)
    gyw = _rnd(gen, rows, in_w).to(dtype)
    got = K.spm_stack_bwd_kernel_call(xs, cf, gyw, d_in, d_out, **gkw)
    ref = K.spm_stack_bwd_plain(xs, cf, gyw, d_in, d_out, **gkw)
    mags = K.spm_stack_bwd_plain(xs, cf, gyw, d_in, d_out,
                                 col_sum=_abs_sum, **gkw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0])
    _grads_within(got[1:], ref[1:], mags[1:], rows)
    assert not got[4][live:].any()                # g_bias past out_width


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, L, in_w, out_w, rows", [
    (2048, 11, 2048, 1024, 40), (6144, 12, 2048, 6144, 40),
    (6144, 12, 6144, 2048, 33), (96, 7, 64, 96, 12)])
def test_sharded_operator_matches_unsharded_on_card(cuda, dtype, n, L, in_w,
                                                    out_w, rows):
    """The sharded operator over a 4-shard mesh on the card against the
    unsharded port on the card: K1/K2 launch once per shard and planned
    run, the windowed ones for a narrow input; in f32 the forward is the
    unsharded one bit for bit (the kernels and the mix round alike), in
    bf16 within one rounding per stored slab; the grads within the
    operator's depth."""
    from repro_torch.core.spm import SPMConfig, init_spm, spm_apply
    from repro_torch.parallel import activation_sharding, make_feature_mesh
    cfg = SPMConfig(n=n, n_stages=L, schedule="two_level", n_shards=4,
                    backward="custom")
    gen = torch.Generator(device="cuda").manual_seed(n + rows)
    p = init_spm(cfg, gen, torch.device("cuda"))
    for k in ("d_in", "d_out", "bias"):
        p[k].data += 0.1 * _rnd(gen, n)
    for v in p.parameters():
        v.requires_grad_(True)
    x = _rnd(gen, rows, in_w).to(dtype).requires_grad_(True)
    gy = _rnd(gen, rows, out_w).to(dtype)
    wrt = [x] + list(p.parameters())

    def run():
        y = spm_apply(p, x, cfg, in_width=in_w, out_width=out_w)
        return [y] + list(torch.autograd.grad(y, wrt, gy))

    un = run()
    K.reset_launch_counts()
    with activation_sharding(make_feature_mesh(4), shard_feature=True):
        sh = run()
    torch.cuda.synchronize()
    from repro_torch.core.eligibility import plan_steps
    steps = plan_steps(n, cfg.pairing.strides(), 4)
    runs = sum(len(ops.plan_runs_for_rows(n // 4, s[2], rows))
               for s in steps if s[0] == "local")
    assert K.spm_stack_kernel_call.launches >= 4 * runs
    assert K.spm_stack_bwd_kernel_call.launches == 4 * runs
    windowed = 4 if in_w < n and steps[0][0] == "local" else 0
    assert K.spm_stack_kernel_call.window_launches == windowed
    assert K.spm_stack_bwd_kernel_call.window_launches == windowed
    if dtype == torch.float32:
        assert torch.equal(sh[0], un[0])
    io = len(steps) + 1
    for a, b in zip(sh, un):
        np.testing.assert_allclose(
            a.detach().float().cpu().numpy(),
            b.detach().float().cpu().numpy(), rtol=0,
            atol=io * _tol(dtype, 2 * (3 * L + 3) + rows, b))


@pytest.mark.parametrize("mesh_dev, x_dev", [("cpu", "cuda"), ("cuda", "cpu")])
def test_sharded_operator_refuses_a_mesh_off_the_input_device(cuda, mesh_dev,
                                                              x_dev):
    """A CPU mesh with a CUDA input (and the reverse) raises: the sharded
    path never moves the card's work to the CPU's plain versions."""
    from repro_torch.core.spm import SPMConfig, init_spm, spm_apply
    from repro_torch.parallel import activation_sharding, make_feature_mesh
    cfg = SPMConfig(n=64, n_stages=6, schedule="two_level", n_shards=4,
                    backward="custom")
    p = init_spm(cfg, torch.Generator(device=x_dev).manual_seed(0),
                 torch.device(x_dev))
    x = torch.ones(3, 64, device=x_dev)
    K.reset_launch_counts()
    with activation_sharding(make_feature_mesh(4, device=mesh_dev),
                             shard_feature=True):
        with pytest.raises(ValueError, match="input's device"):
            spm_apply(p, x, cfg)
    assert K.spm_stack_kernel_call.launches == 0


# K5/K6 cases: (S, n_local, strides, n_tile, k, rows, in_w, fold, int8):
# the q/k/v/o pair of qwen3-1.7b over 4 shards (n_local 512, 9 stages, d_in
# folded), its 2-shard pair ending the schedule (d_out and bias folded), a
# k=2 pair, a windowed first run with several feature tiles a shard (the
# smoke FFN's shape), and an int8 table.
PAIR_CASES = [
    (4, 512, tuple(1 << i for i in range(9)), 512, 1, 300, None, False,
     False),
    (4, 512, tuple(1 << i for i in range(9)), 512, 1, 8, None, False, False),
    (2, 1024, tuple(1 << i for i in range(10)), 1024, 1, 64, None, True,
     False),
    (4, 64, (1, 2, 4, 8), 64, 2, 33, None, True, False),
    (4, 24, (1, 2, 4), 8, 1, 40, 64, True, False),
    (4, 512, tuple(1 << i for i in range(9)), 512, 1, 300, 1792, False,
     True),
    (4, 512, tuple(1 << i for i in range(9)), 512, 1, 4072, None, False,
     False),                                     # ragged row chunks
    (4, 512, tuple(1 << i for i in range(9)), 512, 1, 1, None, False, False),
    (2, 1024, tuple(1 << i for i in range(10)), 1024, 1, 1000, None, True,
     False),                                     # 4 lane blocks a side
    (4, 512, tuple(1 << i for i in range(9)), 512, 1, 1000, 1792, False,
     True),                                      # windowed, int8, ragged
    (4, 512, tuple(1 << i for i in range(9)), 512, 1, 4072, None, False,
     True),
]


def _pair_operands(gen, S, nl, strides, rows, in_w, fold, dtype):
    n = S * nl
    th = (torch.rand(S, len(strides), nl // 2, generator=gen,
                     device="cuda") * 2 - 1) * math.pi
    c, s = torch.cos(th), torch.sin(th)
    cf = torch.stack([c, -s, s, c], dim=-1).contiguous()
    vecs = [1 + 0.1 * _rnd(gen, n) for _ in range(4)]     # mix_a/b or u/v
    d_in = 1 + 0.1 * _rnd(gen, n)
    d_out = 1 + 0.1 * _rnd(gen, n) if fold else None
    bias = 0.1 * _rnd(gen, n) if fold else None
    x = _rnd(gen, rows, in_w or n).to(dtype)
    gy = _rnd(gen, rows, n).to(dtype)
    return cf, vecs, d_in, d_out, bias, x, gy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S, nl, strides, nt, k, rows, in_w, fold, q8",
                         PAIR_CASES)
def test_k5_k6_match_plain(cuda, dtype, S, nl, strides, nt, k, rows, in_w,
                           fold, q8):
    """K5 bit for bit its plain version (every product and sum rounds
    alike); K6's g_x bit for bit, its table grads and the s, t and g_din
    sums within gamma_rows of the sum of their terms' magnitudes; one
    launch each, the window and int8 launches counted apart."""
    from repro_torch.kernels import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(S * nl + rows)
    cf, (ma, mb, u, v), d_in, d_out, bias, x, gy = _pair_operands(
        gen, S, nl, strides, rows, in_w, fold, dtype)
    scale = None
    if q8:
        L = len(strides)
        q, scale = Q.quantize_coeffs(cf.reshape(S * L, nl // 2, 4))
        cf, scale = q.reshape(S, L, nl // 2, 4), scale.reshape(S, L)
    kw = dict(strides=strides, n_tile=nt, k=k, in_width=in_w)
    K.reset_launch_counts()
    y = K.spm_overlap_kernel_call(x, cf, ma, mb, d_in, d_out, bias, scale,
                                  **kw)
    got = K.spm_overlap_bwd_kernel_call(x, cf, gy, u, v, d_in, d_out, scale,
                                        **kw)
    want = K.spm_overlap_plain(x, cf, ma, mb, d_in, d_out, bias, scale, **kw)
    ref = K.spm_overlap_bwd_plain(x, cf, gy, u, v, d_in, d_out, scale, **kw)
    mags = K.spm_overlap_bwd_plain(x, cf, gy, u, v, d_in, d_out, scale,
                                   col_sum=_abs_sum, **kw)
    torch.cuda.synchronize()
    for fn in (K.spm_overlap_kernel_call, K.spm_overlap_bwd_kernel_call):
        assert (fn.launches, fn.window_launches, fn.int8_launches) == (
            1, int(in_w is not None), int(q8))
    assert y.shape == (rows, S * nl) and torch.equal(y, want)
    assert torch.equal(y, K.spm_overlap_kernel_call(x, cf, ma, mb, d_in,
                                                    d_out, bias, scale, **kw))
    assert len(got) == len(ref) == 5 + (2 if fold else 0)
    assert got[0].dtype == dtype and torch.equal(got[0], ref[0])
    _grads_within(got[1:], ref[1:], mags[1:], rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("q8", [False, True])
def test_k5_chunk_shapes_match_plain(cuda, monkeypatch, dtype, resident, q8):
    """K5 forced to 5-row chunks over 3 row groups (a pair's slots
    double-buffered over 6 chunks, the last one short), with the shard
    tables resident in shared memory or read from L2 each chunk, f32 or
    int8: bit for bit its plain version, a second launch bitwise."""
    from repro_torch.kernels import quant as Q
    _forced_fwd_plan(monkeypatch, chunk_rows=5, groups=3, resident=resident)
    S, nl, strides = 4, 512, tuple(1 << i for i in range(9))
    gen = torch.Generator(device="cuda").manual_seed(5)
    cf, (ma, mb, _, _), d_in, _, _, x, _ = _pair_operands(
        gen, S, nl, strides, 77, None, False, dtype)
    scale = None
    if q8:
        L = len(strides)
        q, scale = Q.quantize_coeffs(cf.reshape(S * L, nl // 2, 4))
        cf, scale = q.reshape(S, L, nl // 2, 4), scale.reshape(S, L)
    kw = dict(strides=strides, n_tile=nl, k=2)
    args = (x, cf, ma, mb, d_in, None, None, scale)
    y = K.spm_overlap_kernel_call(*args, **kw)
    y2 = K.spm_overlap_kernel_call(*args, **kw)
    want = K.spm_overlap_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, want) and torch.equal(y, y2)


def _overlap_io(steps, pairs):
    """``(fwd, bwd)``: the roundings to the I/O dtype on a path of a
    sharded operator with the kernel path, d_in, d_out and bias, forward
    and backward (as ``tests/test_torch_overlap.py`` ``_depth_io`` counts
    them): a local step once, a cross step's mix three times (cast,
    product, sum), an elementwise d_out or bias op twice; a fused pair (a
    cross step in ``pairs``) its sent slab and store, and backward its
    sent cotangent when d_out folds into it and g_x."""
    last = len(steps) - 1
    fwd = bwd = 0
    for i, st in enumerate(steps):
        if i in pairs:
            continue
        if i + 1 in pairs:
            fwd, bwd = fwd + 2, bwd + 1
        else:
            r = 1 if st[0] == "local" else 3
            fwd, bwd = fwd + r, bwd + r
    if steps[-1][0] == "cross" and last not in pairs:
        fwd, bwd = fwd + 4, bwd + 2
    return fwd, bwd + int(last in pairs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, L, S, in_w, out_w, rows", [
    (2048, 11, 4, 2048, 2048, 300), (2048, 11, 2, 2048, 1024, 40),
    (96, 7, 4, 64, 96, 12), (64, 9, 8, 64, 64, 40)])
def test_overlap_operator_matches_serial_on_card(cuda, dtype, n, L, S, in_w,
                                                 out_w, rows):
    """The overlap schedule on the card (each fused pair one K5 and one K6
    launch over every shard) against the step-serial sharded operator on
    the card: in f32 the forward bit for bit (K5's local run and mix round
    as K1 and the step-serial mix do).  Every output within a per-element
    bound: ``depth`` f32 roundings and both sides' I/O roundings on a path
    (``_overlap_io``; in bf16 the step-serial mix rounds each cast, product
    and sum), each at most one unit roundoff of the element's magnitude,
    the same operator run on the absolute values of the params, input
    and cotangent; a parameter grad adds one f32 rounding per row."""
    from repro_torch.core.eligibility import overlap_segments, plan_steps
    from repro_torch.core.spm import SPMConfig, init_spm, spm_apply
    from repro_torch.parallel import activation_sharding, make_feature_mesh
    from repro_torch.parallel.spm_shard import _rdma_cross_indices
    gen = torch.Generator(device="cuda").manual_seed(n + rows + S)
    cfgs = [SPMConfig(n=n, n_stages=L, schedule="two_level", n_shards=S,
                      backward="custom", overlap=ov) for ov in (False, True)]
    p = init_spm(cfgs[0], gen, torch.device("cuda"))
    for key in ("d_in", "d_out", "bias"):
        p[key].data += 0.1 * _rnd(gen, n)
    for t in p.parameters():
        t.requires_grad_(True)
    x = _rnd(gen, rows, in_w).to(dtype).requires_grad_(True)
    gy = _rnd(gen, rows, out_w).to(dtype)
    wrt = [x] + list(p.parameters())
    outs = []
    for cfg in cfgs:
        K.reset_launch_counts()
        with activation_sharding(make_feature_mesh(S), shard_feature=True):
            y = spm_apply(p, x, cfg, in_width=in_w, out_width=out_w)
            outs.append([y] + list(torch.autograd.grad(y, wrt, gy)))
    torch.cuda.synchronize()
    steps = plan_steps(n, cfgs[0].pairing.strides(), S)
    pairs = len(_rdma_cross_indices(steps, n // S))
    assert pairs and any(sg[0] == "pair" for sg in overlap_segments(steps))
    assert K.spm_overlap_kernel_call.launches == pairs
    assert K.spm_overlap_bwd_kernel_call.launches == pairs
    ser, ov = outs
    if dtype == torch.float32:
        assert torch.equal(ov[0], ser[0])
    # the magnitudes: the unsharded operator on absolute values, in f32
    from repro_torch.params import Params
    pa = Params({k: t.detach().abs() for k, t in p.named_parameters()})
    for t in pa.parameters():
        t.requires_grad_(True)
    xa = x.detach().float().abs().requires_grad_(True)
    ya = spm_apply(pa, xa, cfgs[0], in_width=in_w, out_width=out_w)
    mags = [ya] + list(torch.autograd.grad(ya, [xa] + list(pa.parameters()),
                                           gy.float().abs()))
    io = [a + b for a, b in zip(_overlap_io(steps, ()),
                                _overlap_io(steps, _rdma_cross_indices(
                                    steps, n // S)))]
    eps32 = float(torch.finfo(torch.float32).eps)
    u_io = float(torch.finfo(dtype).eps) / 2
    depth = 3 * L + 3
    names = ["y", "x"] + [k for k, _ in p.named_parameters()]
    for name, a, b, m in zip(names, ov, ser, mags):
        d, f = (depth, io[0]) if name == "y" else (2 * depth, io[1])
        if name not in ("y", "x"):
            d += rows
            f = {"mix": io[0] + io[1], "d_in": io[1], "d_out": io[0],
                 "bias": 0}[name]
        lim = (d * eps32 + f * u_io) * m.detach().float()
        err = (a.detach().float() - b.detach().float()).abs()
        assert bool((err <= lim).all()), (name, (err - lim).max().item())


def test_overlap_raises_without_the_pair_kernel(cuda, monkeypatch):
    """A CUDA input on the kernel path with K5's library missing raises: the
    overlap path never falls back to the per-block exchange (or a plain
    version) on the card."""
    from repro_torch.core.spm import SPMConfig, init_spm, spm_apply
    from repro_torch.kernels import build
    from repro_torch.parallel import activation_sharding, make_feature_mesh
    from repro_torch.parallel import spm_shard as sh
    cfg = SPMConfig(n=64, n_stages=6, schedule="two_level", n_shards=4,
                    backward="custom", overlap=True)
    p = init_spm(cfg, torch.Generator(device="cuda").manual_seed(0),
                 torch.device("cuda"))
    real = build.library

    def missing(name):
        if name.startswith("spm_overlap"):
            raise build.BuildError(f"{name}: not built")
        return real(name)

    mixes = []
    monkeypatch.setattr(build, "library", missing)
    monkeypatch.setattr(sh, "_cross_mix", lambda *a, **kw: mixes.append(1))
    K._fn.cache_clear()
    try:
        with activation_sharding(make_feature_mesh(4), shard_feature=True):
            with pytest.raises(build.BuildError, match="spm_overlap"):
                spm_apply(p, torch.ones(16, 64, device="cuda"), cfg)
    finally:
        K._fn.cache_clear()
    assert not mixes


# ---------------------------------------------------------------------------
# the paper's own models: K1/K2 at their f32 shapes, a training step each
# ---------------------------------------------------------------------------

def _butterfly(n, L):
    from repro_torch.core.pairings import make_schedule
    return make_schedule("butterfly", n, L).strides()


@pytest.mark.parametrize("n, L, rows", [
    (256, 8, 256), (512, 9, 256), (1024, 10, 256),    # Table 1 tiles
    (2048, 12, 256),                                  # stride 1 again
    (4096, 12, 256), (4096, 12, 4096),                # 11 on 2048, then 2048
    (4096, 12, 8)])                                   # one run on 4096
def test_k1_k2_paper_shapes_match_plain(cuda, n, L, rows):
    """f32 over each run chain ``plan_runs_for_rows`` gives the paper's
    models: every K1 run bit for bit its plain version and a second launch;
    K2's g_x bit for bit, its grads within gamma_rows of their terms'
    magnitudes, a second launch bitwise."""
    strides = _butterfly(n, L)
    runs = ops.plan_runs_for_rows(n, strides, rows)
    gen = torch.Generator(device="cuda").manual_seed(n + rows)
    cf = _rnd(gen, L, n // 2, 4, scale=0.5)
    d_in, d_out, b = (1 + 0.1 * _rnd(gen, n), 1 + 0.1 * _rnd(gen, n),
                      0.1 * _rnd(gen, n))
    x, gy = _rnd(gen, rows, n), _rnd(gen, rows, n)
    z, off = x, 0
    for r, (rs, nt) in enumerate(runs):
        last = r == len(runs) - 1
        args = (z, cf[off:off + len(rs)], d_in if r == 0 else None,
                d_out if last else None, b if last else None)
        z = K.spm_stack_kernel_call(*args, strides=rs, n_tile=nt)
        assert torch.equal(z, K.spm_stack_plain(*args, strides=rs))
        assert torch.equal(z, K.spm_stack_kernel_call(*args, strides=rs,
                                                      n_tile=nt))
        off += len(rs)
    _, saved = ops.forward_runs(x, cf, runs, d_in, d_out, b, None, None)
    args = (saved, cf, gy, runs, d_in, d_out, True, None, None)
    got = ops.backward_runs(K.spm_stack_bwd_kernel_call, *args)
    again = ops.backward_runs(K.spm_stack_bwd_kernel_call, *args)
    want = ops.backward_runs(K.spm_stack_bwd_plain, *args)
    mags = ops.backward_runs(
        lambda *a, **kw: K.spm_stack_bwd_plain(*a, col_sum=_abs_sum, **kw),
        *args)
    torch.cuda.synchronize()
    for g, a, w, m in zip(got, again, want, mags):
        assert torch.equal(g[0], w[0])
        _grads_within(g[1:], w[1:], m[1:], rows)
        assert all(torch.equal(u, v) for u, v in zip(g, a))


def _step_on_both(init, loss_fn, batch, lr):
    """One training step of a model on the CPU and on the card from the same
    weights and batch: (loss, grads, params before, params after) each."""
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train import make_train_state, make_train_step
    out = {}
    params = init()
    sides = {"cuda": copy.deepcopy(params).to("cuda"), "cpu": params}
    for dev, p in sides.items():
        b = {k: v.to(dev) for k, v in batch.items()}
        state = make_train_state(p)
        loss, _ = loss_fn(p, b)
        loss.backward()
        grads = {k: q.grad.cpu() for k, q in p.named_parameters()}
        p0 = {k: q.detach().cpu().clone() for k, q in p.named_parameters()}
        make_train_step(loss_fn, OptimizerConfig(lr=lr, warmup_steps=0))(
            state, b)
        out[dev] = (loss.item(), grads, p0,
                    {k: q.detach().cpu() for k, q in p.named_parameters()})
    return out


def _hold_step(out, depth):
    """Phase 7's criterion: the loss, each grad as a relative norm and the
    params after AdamW within 8 sqrt(depth) eps32 relative."""
    rel = 8 * math.sqrt(depth) * 2.0 ** -23
    (lc, gc, p0, pc), (la, ga, _, pa) = out["cpu"], out["cuda"]
    assert abs(la - lc) <= rel * abs(lc)
    for k in gc:
        assert (ga[k] - gc[k]).norm() <= rel * gc[k].norm(), k
    diff = sum(float(((pa[k] - pc[k]) ** 2).sum()) for k in pc) ** 0.5
    moved = sum(float(((pc[k] - p0[k]) ** 2).sum()) for k in pc) ** 0.5
    assert diff <= rel * moved


def test_paper_mlp_step_on_card_matches_cpu(cuda):
    """One step of the Table 2 student (w=4096, L=12: two K1 and two K2
    runs) on hashed text, the card against the CPU."""
    from repro_torch.configs.paper import AGNEWS_L, student_cfg
    from repro_torch.data import HashedTextConfig, hashed_text_batch
    from repro_torch.models import init_mlp, mlp_loss
    w, rows = 4096, 64
    cfg = student_cfg(w, 4, "spm_general", n_stages=AGNEWS_L)
    batch = hashed_text_batch(HashedTextConfig(width=w),
                              np.random.default_rng(0), rows, device="cpu")
    K.reset_launch_counts()
    out = _step_on_both(
        lambda: init_mlp(torch.Generator().manual_seed(0), cfg, "cpu"),
        lambda p, b: mlp_loss(p, b, cfg), batch, 3e-3)
    assert K.spm_stack_kernel_call.launches == 4
    assert K.spm_stack_bwd_kernel_call.launches == 4
    _hold_step(out, 2 * (3 * AGNEWS_L + 4 + w + 4) + rows)


def test_paper_gru_lm_step_on_card_matches_cpu(cuda):
    """One step of the §6 GRU-LM (rotation variant, closed-form backward,
    d=512, B=4, T=8: six K1 runs a time step forward, six K2 back), the
    card against the CPU."""
    from repro_torch.models import GRULMConfig, gru_lm_loss, init_gru_lm
    d, B, T, V = 512, 4, 8, 256
    cfg = GRULMConfig(vocab_size=V, d_model=d, linear_impl="spm_rotation",
                      spm_backward="custom")
    ch = torch.from_numpy(np.random.default_rng(1).integers(0, V,
                                                           (B, T + 1)))
    K.reset_launch_counts()
    out = _step_on_both(
        lambda: init_gru_lm(torch.Generator().manual_seed(0), cfg, "cpu"),
        lambda p, b: gru_lm_loss(p, b, cfg),
        {"tokens": ch[:, :-1], "labels": ch[:, 1:]}, 1e-3)
    assert K.spm_stack_kernel_call.launches == 2 * 6 * T
    assert K.spm_stack_bwd_kernel_call.launches == 2 * 6 * T
    L = cfg.gru_cfg().u.spm_config().n_stages
    _hold_step(out, 2 * (T * (2 * (3 * L + 4) + 12) + d + V) + B * T)


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_continuous_churn_parity_on_card(cuda, cache_dtype):
    """Continuous batching on the card at smoke size, through K1 and K3:
    the reference's churn mix (every bucket, greedy and sampled, top-k and
    top-p) under staggered arrivals gives each request bit for bit the
    tokens it gives served alone through an engine with the same two
    slots; the tick runs at two rows whatever the churn, every prefill at
    one row of its bucket, and the launches follow that plan."""
    from repro_torch.serve import ContinuousBatchingEngine, Request
    cfg = get_smoke("qwen3-1.7b")
    params = T.init_model(cfg, seed=0, device="cuda")
    mix = [(8, 5, 0.0, 0, 1.0), (5, 6, 0.8, 0, 1.0), (12, 4, 1.2, 5, 1.0),
           (24, 6, 0.7, 0, 0.9), (7, 3, 1.0, 50, 0.95), (16, 2, 0.0, 0, 1.0)]

    def requests():
        rng = np.random.default_rng(3)
        return [Request(prompt=rng.integers(0, cfg.vocab_size, plen),
                        max_new_tokens=mnew, temperature=t, top_k=k,
                        top_p=p, rid=i)
                for i, (plen, mnew, t, k, p) in enumerate(mix)]

    eng = ContinuousBatchingEngine(cfg, params, slots=2, max_len=48,
                                   cache_dtype=cache_dtype, seed=7)
    eng.serve([Request(prompt=np.zeros(4, np.int64), max_new_tokens=2,
                       rid=999)])
    inner, ticks = eng._tick, []
    eng._tick = lambda: ticks.append(1) or inner()
    K.reset_launch_counts()
    results, _ = eng.serve(requests(), arrival_ticks=[0, 0, 1, 3, 3, 6])
    eng._tick = inner
    per = {}
    for rows in {eng._bucket(len(r.prompt)) for r in requests()} | {2}:
        k1 = k3 = 0
        spec = cfg.layers[0]
        for lin in (cfg.attn_cfg(spec).o_proj, cfg.ffn_cfg().gate,
                    cfg.ffn_cfg().up, cfg.ffn_cfg().down):
            sc = lin.spm_config()
            k1 += len(ops.plan_runs_for_rows(sc.n, sc.pairing.strides(),
                                             rows))
        per[rows] = (cfg.n_layers * k1, cfg.n_layers * 3)
    want = [sum(per[eng._bucket(len(r.prompt))][i] for r in requests())
            + len(ticks) * per[2][i] for i in (0, 1)]
    assert [K.spm_stack_kernel_call.launches,
            K.spm_block_kernel_call.launches] == want
    for r in requests():
        solo, _ = eng.serve([r])
        assert solo[r.rid]["tokens"] == results[r.rid]["tokens"], r.rid
        assert not results[r.rid]["flagged"]
        assert all(0 <= t < cfg.vocab_size for t in solo[r.rid]["tokens"])


def _expert_linears(arch):
    """(name, LinearConfig) of an MoE arch's expert linears (gate/up share
    a shape) at full width."""
    from repro_torch.configs import get_config
    fcfg = get_config(arch).moe_cfg().expert_ffn
    return [("gate/up", fcfg.gate), ("down", fcfg.down)]


@pytest.mark.parametrize("arch, rows, bwd", [
    ("qwen3-moe-30b-a3b", 160, True), ("qwen3-moe-30b-a3b", 80, False),
    ("qwen3-moe-30b-a3b", 8, False), ("llama4-scout-17b-a16e", 160, True),
    ("llama4-scout-17b-a16e", 80, False),
    ("llama4-scout-17b-a16e", 1, False)])
def test_expert_mode_matches_plain(cuda, arch, rows, bwd):
    """K1 and K2 in their expert mode at the expert linears' shapes (rows
    a expert: a training step's G * cap, a prefill's and decode's), bf16:
    one launch a run for all experts, counted apart; the run chain's output
    bit for bit the per-expert plain versions'; K2's g_x bit for bit, its
    grads within gamma_rows of one expert's rows, a second launch
    bitwise."""
    from repro_torch.configs import get_config
    E = get_config(arch).n_experts
    gen = torch.Generator(device="cuda").manual_seed(rows)
    for name, lin in _expert_linears(arch):
        scfg = lin.spm_config()
        n = scfg.n
        runs = ops.plan_runs_for_rows(n, scfg.pairing.strides(), rows)
        L = sum(len(rs) for rs, _ in runs)
        cf = _rnd(gen, E, L, n // 2, 4, scale=0.5)
        d_in, d_out = 1 + 0.1 * _rnd(gen, E, n), 1 + 0.1 * _rnd(gen, E, n)
        widths = (None if lin.d_in == n else lin.d_in,
                  None if lin.d_out == n else lin.d_out)
        x = _rnd(gen, E, rows, lin.d_in).bfloat16()
        K.reset_launch_counts()
        y, saved = ops.forward_runs(x, cf, runs, d_in, d_out, None, *widths)
        assert K.spm_stack_kernel_call.expert_launches == len(runs) \
            == K.spm_stack_kernel_call.launches
        z = x
        for r, (rs, nt) in enumerate(runs):
            off = sum(len(q) for q, _ in runs[:r])
            last = r == len(runs) - 1
            z = K.spm_stack_plain(
                z, cf[:, off: off + len(rs)], d_in if r == 0 else None,
                d_out if last else None, strides=rs, n_tile=nt,
                in_width=widths[0] if r == 0 else None,
                out_width=widths[1] if last else None)
        torch.cuda.synchronize()
        assert torch.equal(y, z), (arch, name)
        if not bwd:
            continue
        gy = _rnd(gen, E, rows, lin.d_out).bfloat16()
        args = (saved, cf, gy, runs, d_in, d_out, False, *widths)
        got = ops.backward_runs(K.spm_stack_bwd_kernel_call, *args)
        again = ops.backward_runs(K.spm_stack_bwd_kernel_call, *args)
        assert K.spm_stack_bwd_kernel_call.expert_launches == 2 * len(runs)
        want = ops.backward_runs(K.spm_stack_bwd_plain, *args)
        mags = ops.backward_runs(functools.partial(
            K.spm_stack_bwd_plain, col_sum=_abs_sum), *args)
        torch.cuda.synchronize()
        for a, b, p, m in zip(got, again, want, mags):
            assert torch.equal(a[0], p[0]), (arch, name)
            _grads_within(a[1:], p[1:], m[1:], rows)
            assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e", "mamba2-370m",
                                  "zamba2-1.2b"])
def test_moe_and_ssm_smoke_models_on_card_match_cpu(cuda, arch):
    """The f32 smoke models on the card give the CPU's greedy tokens (SSM
    stacks through decode replay); the MoE experts through the expert mode
    only, and one training step's loss within the f32 bound."""
    from repro_torch.models import causal_lm as LM
    cfg = get_smoke(arch)
    params = T.init_model(cfg, seed=0, device="cpu")
    prompts = torch.arange(16).reshape(2, 8) % 7
    cpu_tokens = ServeEngine(cfg=cfg, params=params, max_len=16,
                             cache_dtype=torch.float32, device="cpu"
                             ).generate(prompts, max_new_tokens=6)
    batch = {"tokens": prompts, "labels": (prompts + 1) % 7}
    cpu_loss = LM.lm_loss(params, batch, cfg)[0].item()
    card = copy.deepcopy(params).to("cuda")
    K.reset_launch_counts()
    gpu_tokens = ServeEngine(cfg=cfg, params=card, max_len=16,
                             cache_dtype=torch.float32).generate(
        prompts, max_new_tokens=6)
    assert K.spm_stack_kernel_call.launches > 0
    if cfg.n_experts:
        assert K.spm_stack_kernel_call.expert_launches > 0
    np.testing.assert_array_equal(gpu_tokens.cpu().numpy(),
                                  cpu_tokens.numpy())
    card.trainable()
    loss = LM.lm_loss(card, {k: v.cuda() for k, v in batch.items()},
                      cfg)[0]
    loss.backward()
    if cfg.n_experts:
        assert K.spm_stack_bwd_kernel_call.expert_launches > 0
    assert abs(loss.item() - cpu_loss) <= 1e-4 * (abs(cpu_loss) + 1)


def _expert_lin(arch, name, shards=None):
    """An MoE arch's expert linear at full width (``with_feature_sharding``
    when ``shards``): its LinearConfig and SPMConfig."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import with_feature_sharding
    cfg = get_config(arch)
    if shards:
        cfg = with_feature_sharding(cfg, shards)
    lin = getattr(cfg.moe_cfg().expert_ffn, name)
    return lin, lin.spm_config()


def _q8_plain_chain(z, kcf, scf, runs, d_in, d_out, widths, q_acts, sr):
    """The int8 run chain through K1's plain version, run by run."""
    for r, (rs, nt) in enumerate(runs):
        off = sum(len(q) for q, _ in runs[:r])
        last = r == len(runs) - 1
        x, xs = z if q_acts else (z, None)
        z = K.spm_stack_plain(
            x, kcf[:, off: off + len(rs)], d_in if r == 0 else None,
            d_out if last else None, None, xs,
            scf[:, off: off + len(rs)].contiguous(), strides=rs,
            n_tile=nt, in_width=widths[0] if r == 0 else None,
            out_width=widths[1] if last else None, quant_out=q_acts,
            scale_rows=sr)
    return z


@pytest.mark.parametrize("arch, rows, bwd", [
    ("qwen3-moe-30b-a3b", 160, True), ("qwen3-moe-30b-a3b", 8, False),
    ("qwen3-moe-30b-a3b", 5, True), ("qwen3-moe-30b-a3b", 1, True),
    ("llama4-scout-17b-a16e", 160, True), ("llama4-scout-17b-a16e", 5, True),
    ("llama4-scout-17b-a16e", 1, False)])
def test_expert_int8_matches_plain(cuda, arch, rows, bwd):
    """K1's and K2's int8 modes over the expert axis at the expert
    linears' shapes (rows a expert: a training step's, a decode's, and 1
    and 5), bf16, int8 tables with (E, L) stage scales and, where one
    expert's plan allows (``quant_acts_eligible``: qwen3-moe, not
    llama4), int8 activations whose scale grid restarts at each expert's
    row 0 (rows padded per expert).  One launch a run for all experts;
    K1's codes and scales bit for bit the per-expert plain versions', K2's
    g_x bit for bit, its grads within gamma_rows of one expert's rows."""
    from repro_torch.configs import get_config
    from repro_torch.core.eligibility import (quant_acts_eligible,
                                              tiny_row_call)
    from repro_torch.kernels import quant as Q
    E = get_config(arch).n_experts
    gen = torch.Generator(device="cuda").manual_seed(rows + E)
    for name in ("gate", "down"):
        lin, scfg = _expert_lin(arch, name)
        n = scfg.n
        runs = ops.plan_runs_for_rows(n, scfg.pairing.strides(), rows)
        L = sum(len(rs) for rs, _ in runs)
        kcf, scf = Q.quantize_coeffs(_rnd(gen, E, L, n // 2, 4, scale=0.5))
        d_in, d_out = 1 + 0.1 * _rnd(gen, E, n), 1 + 0.1 * _rnd(gen, E, n)
        widths = (None if lin.d_in == n else lin.d_in,
                  None if lin.d_out == n else lin.d_out)
        x = _rnd(gen, E, rows, lin.d_in).bfloat16()
        q_acts = quant_acts_eligible(runs)
        if not tiny_row_call(rows):     # tiny rows widen the tile cap
            assert q_acts == (arch == "qwen3-moe-30b-a3b")
        sr = Q.scale_block_rows(runs, rows, 2) if q_acts else None
        z = (Q.quantize_blocks(ops._pad_rows(x, sr), sr, runs[0][1])
             if q_acts else x)
        K.reset_launch_counts()
        y, saved = ops.forward_runs(z, kcf, runs, d_in, d_out, None,
                                    *widths, coeff_scale=scf, scale_rows=sr)
        fn = K.spm_stack_kernel_call
        assert fn.expert_launches == fn.int8_launches == len(runs) \
            == fn.launches
        assert fn.int8_io_launches == (len(runs) if q_acts else 0)
        want = _q8_plain_chain(z, kcf, scf, runs, d_in, d_out, widths,
                               q_acts, sr)
        torch.cuda.synchronize()
        if q_acts:
            assert y[1].shape == (E, -(-rows // sr),
                                  -(-lin.d_out // runs[-1][1]))
            assert torch.equal(y[0], want[0]) and torch.equal(y[1], want[1])
        else:
            assert torch.equal(y, want), (arch, name)
        if not bwd:
            continue
        rows_p = z[0].shape[1] if q_acts else rows
        gy = _rnd(gen, E, rows_p, lin.d_out).bfloat16()
        args = (saved, kcf, gy, runs, d_in, d_out, False, *widths)
        kw = dict(coeff_scale=scf, scale_rows=sr)
        got = ops.backward_runs(K.spm_stack_bwd_kernel_call, *args, **kw)
        again = ops.backward_runs(K.spm_stack_bwd_kernel_call, *args, **kw)
        bfn = K.spm_stack_bwd_kernel_call
        assert bfn.expert_launches == bfn.int8_launches == 2 * len(runs)
        assert bfn.int8_io_launches == (2 * len(runs) if q_acts else 0)
        want = ops.backward_runs(K.spm_stack_bwd_plain, *args, **kw)
        mags = ops.backward_runs(functools.partial(
            K.spm_stack_bwd_plain, col_sum=_abs_sum), *args, **kw)
        torch.cuda.synchronize()
        for a, b, p, m in zip(got, again, want, mags):
            assert torch.equal(a[0], p[0]), (arch, name)
            _grads_within(a[1:], p[1:], m[1:], rows_p)
            assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("arch, rows", [
    ("qwen3-moe-30b-a3b", 160), ("qwen3-moe-30b-a3b", 5),
    ("qwen3-moe-30b-a3b", 1), ("llama4-scout-17b-a16e", 160),
    ("llama4-scout-17b-a16e", 5)])
@pytest.mark.parametrize("q8", [False, True])
def test_expert_window_matches_plain(cuda, arch, rows, q8):
    """K1's and K2's windowed (``col_base``) mode over the expert axis at
    the sharded executor's first local run of a rectangular expert input
    (qwen3-moe's down, 768 of n_local = 512 lanes a shard; llama4's gate,
    5120 of 2048), every shard, bf16, with and without an int8 table:
    each expert's window read from its own rows, K1 and K2's g_x bit for
    bit, K2's grads within gamma_rows, window and expert launches counted
    apart."""
    from repro_torch.configs import get_config
    from repro_torch.core.eligibility import plan_steps
    from repro_torch.kernels import quant as Q
    E = get_config(arch).n_experts
    lin, scfg = _expert_lin(arch, "down" if arch.startswith("qwen")
                            else "gate", shards=4)
    n, in_w = scfg.n, lin.d_in
    nl = n // 4
    steps = plan_steps(n, scfg.pairing.strides(), 4)
    assert steps[0][0] == "local" and in_w < n
    (rs, nt), *_ = ops.plan_runs_for_rows(nl, steps[0][2], rows)
    gen = torch.Generator(device="cuda").manual_seed(rows + nl)
    x = _rnd(gen, E, rows, in_w).bfloat16()
    for shard in range(4):
        cf = _rnd(gen, E, len(rs), nl // 2, 4, scale=0.5)
        scf = None
        if q8:
            cf, scf = Q.quantize_coeffs(cf)
        d_in = 1 + 0.1 * _rnd(gen, E, nl)
        kw = dict(strides=rs, n_tile=nt, in_width=in_w,
                  col_base=shard * nl // nt)
        K.reset_launch_counts()
        y = K.spm_stack_kernel_call(x, cf, d_in, coeff_scale=scf, **kw)
        gy = _rnd(gen, E, rows, nl).bfloat16()
        got = K.spm_stack_bwd_kernel_call(x, cf, gy, d_in, coeff_scale=scf,
                                          **kw)
        for fn in (K.spm_stack_kernel_call, K.spm_stack_bwd_kernel_call):
            assert (fn.launches, fn.window_launches, fn.expert_launches,
                    fn.int8_launches) == (1, 1, 1, int(q8))
        want = K.spm_stack_plain(x, cf, d_in, coeff_scale=scf, **kw)
        ref = K.spm_stack_bwd_plain(x, cf, gy, d_in, coeff_scale=scf, **kw)
        mags = K.spm_stack_bwd_plain(x, cf, gy, d_in, coeff_scale=scf,
                                     col_sum=_abs_sum, **kw)
        torch.cuda.synchronize()
        assert y.shape == (E, rows, nl) and torch.equal(y, want)
        assert got[0].shape == (E, rows, nl) and torch.equal(got[0], ref[0])
        _grads_within(got[1:], ref[1:], mags[1:], rows)
        live = max(0, min(nl, in_w - shard * nl))
        assert not got[2][:, live:].any()           # g_din past in_width


@pytest.mark.parametrize("arch, rows, rect, fold", [
    ("qwen3-moe-30b-a3b", 160, False, False),
    ("qwen3-moe-30b-a3b", 160, True, False),
    ("qwen3-moe-30b-a3b", 5, True, True),
    ("qwen3-moe-30b-a3b", 1, False, True),
    ("llama4-scout-17b-a16e", 160, True, False),
    ("llama4-scout-17b-a16e", 5, False, True)])
@pytest.mark.parametrize("q8", [False, True])
def test_k5_k6_expert_match_plain(cuda, arch, rows, rect, fold, q8):
    """K5 and K6 over the expert axis at the sharded expert linears' first
    pair (4 shards; qwen3-moe n_local 512, llama4 2048), bf16, with a
    rectangular input (``rect``: the linear's in_width) or not, the
    schedule's end folded in (``fold``) or not, an int8 table ((S, E, L)
    scales) or not: one launch each for every shard and expert; K5 bit
    for bit the per-expert plain version, K6's g_x bit for bit, its table
    grads and sums within gamma_rows of one expert's rows."""
    from repro_torch.configs import get_config
    from repro_torch.core.eligibility import plan_steps
    from repro_torch.kernels import quant as Q
    E = get_config(arch).n_experts
    lin, scfg = _expert_lin(arch, "down" if arch.startswith("qwen")
                            else "gate", shards=4)
    S, n = 4, scfg.n
    nl = n // S
    steps = plan_steps(n, scfg.pairing.strides(), S)
    assert steps[0][0] == "local" and steps[1][0] == "cross"
    (rs, nt), = ops.plan_runs(nl, steps[0][2])
    k = steps[1][2]
    in_w = lin.d_in if rect else None
    gen = torch.Generator(device="cuda").manual_seed(rows + nl + rect)
    th = (torch.rand(S, E, len(rs), nl // 2, generator=gen, device="cuda")
          * 2 - 1) * math.pi
    c, s = torch.cos(th), torch.sin(th)
    cf = torch.stack([c, -s, s, c], dim=-1).contiguous()
    scale = None
    if q8:
        cf, scale = Q.quantize_coeffs(cf)
    ma, mb, u, v, d_in = (1 + 0.1 * _rnd(gen, E, n) for _ in range(5))
    d_out = 1 + 0.1 * _rnd(gen, E, n) if fold else None
    bias = 0.1 * _rnd(gen, E, n) if fold else None
    x = _rnd(gen, E, rows, in_w or n).bfloat16()
    gy = _rnd(gen, E, rows, n).bfloat16()
    kw = dict(strides=rs, n_tile=nt, k=k, in_width=in_w)
    K.reset_launch_counts()
    y = K.spm_overlap_kernel_call(x, cf, ma, mb, d_in, d_out, bias, scale,
                                  **kw)
    got = K.spm_overlap_bwd_kernel_call(x, cf, gy, u, v, d_in, d_out, scale,
                                        **kw)
    for fn in (K.spm_overlap_kernel_call, K.spm_overlap_bwd_kernel_call):
        assert (fn.launches, fn.expert_launches, fn.window_launches,
                fn.int8_launches) == (1, 1, int(rect), int(q8))
    want = K.spm_overlap_plain(x, cf, ma, mb, d_in, d_out, bias, scale, **kw)
    ref = K.spm_overlap_bwd_plain(x, cf, gy, u, v, d_in, d_out, scale, **kw)
    mags = K.spm_overlap_bwd_plain(x, cf, gy, u, v, d_in, d_out, scale,
                                   col_sum=_abs_sum, **kw)
    torch.cuda.synchronize()
    assert y.shape == (E, rows, n) and torch.equal(y, want)
    assert len(got) == len(ref) == 5 + (2 if fold else 0)
    assert got[1].shape == (S, E, len(rs), nl // 2, 4)
    assert torch.equal(got[0], ref[0])
    _grads_within(got[1:], ref[1:], mags[1:], rows)


# ---------------------------------------------------------------------------
# K5 / K6 rank mode: two ranks sharing the card
# ---------------------------------------------------------------------------

def _rank_gpu_job(pod, cases, rows):
    import chip_smoke
    return chip_smoke.rank_pair_job(pod, cases, rows, False)


def test_k5_k6_rank_mode_on_two_ranks_sharing_the_card(cuda):
    """K5's and K6's rank mode on 2 ranks that share the card (gloo, CUDA
    IPC slots between the ranks' processes): each rank's y and g_x bit
    for bit its plain version (the per-block exchange over the group) and
    the one-card K5/K6's columns, the table and vector grads within
    gamma_rows, a second call bit for bit; and the transport's schedule
    on the card: after every call each channel's data and credit words
    stand at its last sequence number (every block consumed, every credit
    drained).  Cases: q/k/v/o's local run (n_local 512, 9 stages) with
    k = 1 over 4 row blocks and over 1, an int8 table, a windowed first
    read, d_out and bias folded."""
    import os
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from repro_torch.launch.mesh import run_ranks
    strides = tuple(1 << i for i in range(9))
    cases = [("k=1", 512, strides, 512, 1, None, False, False),
             ("int8", 512, strides, 512, 1, None, False, True),
             ("window", 512, strides, 512, 1, 768, False, False),
             ("fold", 512, strides, 512, 1, None, True, False)]
    for rows in (1000, 8):
        ranks = run_ranks(2, _rank_gpu_job, (cases, rows), device="cuda")
        for r, res in enumerate(ranks):
            for c in res:
                assert c["ok"], (r, rows, c)
                assert c["drained"] and c["k5_one_card"] and \
                    c["gx_one_card"], (r, rows, c["case"])
