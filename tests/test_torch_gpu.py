"""The PyTorch port's CUDA kernels against their plain versions, on the
card.  A CUDA kernel has no CPU mode, so these tests skip (with the reason)
where no Hopper GPU is present; run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are derived as in ``tests/test_torch_spm.py``.
"""

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
    (6144, FFN, 5, 2048, 6144), (6144, FFN, 7, 6144, 2048)])
def test_k1_matches_plain(cuda, dtype, n, strides, rows, in_w, out_w):
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
    ref = ops.spm_stack_fused(x.cpu(), cf.cpu(), strides, d_in=vec[0].cpu(),
                              d_out=vec[1].cpu(), bias=vec[2].cpu(),
                              in_width=in_w, out_width=out_w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (rows, out_w)
    np.testing.assert_allclose(
        got.float().cpu().numpy(), ref.float().numpy(), rtol=0,
        atol=_tol(dtype, 3 * len(strides) + 3, ref) * n_runs)


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
    (6144, FFN, 6144, 8, 2048, 6144, None),          # remat in global scratch
    (4096, QKV, 2048, 33, 4096, 1024, None),         # dead-tile skip
    (6144, FFN[:11], 2048, 40, 6144, 6144, 2048)])   # dead_from
def test_k2_matches_plain(cuda, dtype, n, strides, n_tile, rows, in_w,
                          out_w, dead):
    """g_x bit for bit; parameter grads within gamma_rows times the sum of
    their terms' magnitudes (the same terms summed in another order); a
    second launch bitwise equal."""
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
    (6144, FFN, 8, 2048, 6144, torch.bfloat16)])   # one 6144 run, cluster 8
def test_int8_k1_k2_match_plain(cuda, mode, n, strides, rows, in_w, out_w,
                                dtype):
    """K1's int8 codes and scales and K2's g_x bit for bit against the
    plain versions, in each int8 mode, where a scale block spans a cluster
    of several blocks; K2's parameter grads within gamma_rows times the sum
    of magnitudes; second launches bitwise equal; the int8 launches
    counted apart."""
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
        assert K.int8_cta_rows(x.shape[0], nt, -(-out_w // nt), sr) < sr
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


def test_int8_k1_nonfinite_store_matches_plain(cuda):
    """Scale blocks holding a NaN and an Inf (tile 0 of three, through
    d_out) and an Inf alone (tile 1), each spanning a cluster of 8 blocks:
    the cluster's absmax keeps them, so those scales are NaN and Inf and
    every code 0, exactly the plain version's (NaN equal to NaN); tile 2
    stays finite."""
    from repro_torch.kernels import quant as Q
    gen = torch.Generator(device="cuda").manual_seed(99)
    n, rows = 6144, 64
    ((rs, nt),) = ops.plan_runs_for_rows(n, QKV, rows)
    assert n // nt == 3
    sr = Q.scale_block_rows([(rs, nt)], rows, 2)
    assert K.int8_cta_rows(rows, nt, n // nt, sr) < sr
    qx, xs = Q.quantize_blocks(_rnd(gen, rows, n), sr, nt)
    qc, sc = Q.quantize_coeffs(_rnd(gen, len(rs), n // 2, 4, scale=0.5))
    d_out = torch.ones(n, device="cuda")
    d_out[5], d_out[9], d_out[nt + 3] = math.nan, math.inf, math.inf
    kw = dict(strides=rs, n_tile=nt, quant_out=True, scale_rows=sr)
    kq, ks = K.spm_stack_kernel_call(qx, qc, None, d_out, None, xs, sc, **kw)
    pq, ps = K.spm_stack_plain(qx, qc, None, d_out, None, xs, sc, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kq, pq)
    assert torch.allclose(ks, ps, rtol=0, atol=0, equal_nan=True)
    assert ks[:, 0].isnan().all() and ks[:, 1].isinf().all()
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
