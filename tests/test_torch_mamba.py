"""The port's SSM archs on the CPU, against the JAX reference: the Mamba2
mixer (``_segsum``, the chunked SSD scan, the causal conv, the O(1) decode
step), mamba2-370m and zamba2-1.2b (its shared attention + FFN block) at
smoke size, prefill by decode replay and greedy generation, and the
continuous engine's refusal of SSM stacks.

The reference runs its smoke configs as they are (the XLA composition on
the CPU), jitted once a test where it is jitted; the port runs its kernels'
plain versions.  Inputs are numpy draws from a seed.  Both sides compute
the same f32 function with rounding in other orders (XLA's fused loops,
its cumsum and exp against torch's), so results are held to a depth bound
in f32 ulps, as ``tests/test_torch_train.py`` holds the dense models.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.layers import mamba2 as J_SSM  # noqa: E402
from repro.models import causal_lm as J_LM  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, tree_from_jax  # noqa: E402
from repro_torch.core.pairings import default_n_stages  # noqa: E402
from repro_torch.layers import mamba2 as SSM  # noqa: E402
from repro_torch.models import causal_lm as LM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine,  # noqa: E402
                               ServeEngine)

SSM_ARCHS = ("mamba2-370m", "zamba2-1.2b")
EPS32 = float(np.finfo(np.float32).eps)


def _close(got, want, depth, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=8 * depth * EPS32 * (float(np.abs(want).max()) + 1),
        err_msg=what)


# ---------------------------------------------------------------------------
# the mixer's pieces
# ---------------------------------------------------------------------------

def test_segsum_masks_before_the_exp():
    """``_segsum`` within a cumsum's roundings of the reference's, -inf
    above the diagonal, and ``exp`` of it has finite grads where the upper
    triangle's differences would overflow (masked before the exp)."""
    a = -np.abs(np.random.default_rng(0).standard_normal((2, 3, 9))).astype(
        np.float32)
    want = np.asarray(J_SSM._segsum(jnp.asarray(a)))
    got = SSM._segsum(torch.from_numpy(a)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin], 9)
    big = torch.full((1, 8), -60.0, requires_grad=True)   # exp(+420) above
    torch.exp(SSM._segsum(big)).sum().backward()
    assert torch.isfinite(big.grad).all()


@pytest.mark.parametrize("T_len, chunk", [(16, 8), (12, 8), (13, 8),
                                          (7, 128)])
def test_ssd_chunked_matches_the_reference(T_len, chunk):
    """The chunked scan at T a multiple of the chunk, not one (Q = 6), a
    prime T (Q = 1) and T shorter than the chunk: y and the final state
    within the bound of its sums (Q, N and P terms a chain)."""
    rng = np.random.default_rng(T_len)
    b, H, P, N = 2, 3, 4, 5
    x = rng.standard_normal((b, T_len, H, P)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, T_len, H))).astype(np.float32) * .3
    A = rng.standard_normal(H).astype(np.float32)
    B = rng.standard_normal((b, T_len, N)).astype(np.float32)
    C = rng.standard_normal((b, T_len, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    jy, jh = jax.jit(lambda *a: J_SSM._ssd_chunked(*a, chunk))(
        *map(jnp.asarray, (x, dt, A, B, C, D)))
    ty, th = SSM._ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C, D)),
                              chunk)
    depth = 4 * (T_len + N + P + 8)
    _close(ty.numpy(), jy, depth, "y")
    _close(th.numpy(), jh, depth, "state")


def test_causal_conv_matches_the_reference():
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = np.asarray(jax.jit(J_SSM._causal_conv)(u, w, b))
    got = SSM._causal_conv(*map(torch.from_numpy, (u, w, b))).numpy()
    _close(got, want, 8)


def _mixer_pair(seed=0):
    jcfg = j_get_smoke("mamba2-370m").mamba_cfg()
    tcfg = get_smoke("mamba2-370m").mamba_cfg()
    jp = J_SSM.init_mamba2(jax.random.PRNGKey(seed), jcfg)
    tp = tree_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _mixer_depth(cfg) -> int:
    L_in = default_n_stages(max(cfg.d_model, cfg.d_in_proj))
    L_out = default_n_stages(max(cfg.d_inner, cfg.d_model))
    return (3 * L_in + 12 + 4 * (cfg.chunk + cfg.d_state + cfg.d_head)
            + cfg.d_inner + 3 * L_out + 8)


def test_mixer_training_and_decode_steps_match_the_reference():
    """``mamba2_apply`` over 13 tokens (chunk 8: Q = 1), then three decode
    steps from a cache holding a random state: outputs, the f32 conv and
    SSM caches within the bound; the caches stay f32."""
    jcfg, jp, tcfg, tp = _mixer_pair()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 13, tcfg.d_model)).astype(np.float32)
    jy, _ = jax.jit(lambda p, x: J_SSM.mamba2_apply(p, x, jcfg))(
        jp, jnp.asarray(x))
    with torch.no_grad():
        ty, _ = SSM.mamba2_apply(tp, torch.from_numpy(x), tcfg)
    depth = _mixer_depth(tcfg)
    _close(ty.numpy(), jy, depth, "train")
    jc = J_SSM.init_ssm_cache(2, jcfg)
    jc = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
          for k, v in jc.items()}
    tc = SSM.init_ssm_cache(2, tcfg, "cpu")
    assert all(v.dtype == torch.float32 for v in tc.values())
    for k in tc:
        tc[k].copy_(torch.from_numpy(np.array(jc[k])))
    jstep = jax.jit(lambda p, x, c: J_SSM.mamba2_apply(p, x, jcfg, cache=c))
    for t in range(3):
        xt = x[:, t: t + 1]
        jy, jc = jstep(jp, jnp.asarray(xt), jc)
        with torch.no_grad():
            ty, tc = SSM.mamba2_apply(tp, torch.from_numpy(xt), tcfg,
                                      cache=tc)
        _close(ty.numpy(), jy, depth * (t + 1), f"decode {t}")
        for k in ("conv", "ssm"):
            _close(tc[k].numpy(), jc[k], depth * (t + 1), k)


# ---------------------------------------------------------------------------
# the smoke models
# ---------------------------------------------------------------------------

def _depth(cfg) -> int:
    """Dependent f32 roundings of an SSM smoke model's forward: each
    layer's mixer (``_mixer_depth``) and norms, and zamba2's shared block
    (attention and FFN, counted as ``tests/test_torch_archs.py`` counts a
    dense layer) where it applies."""
    per_layer = _mixer_depth(cfg.mamba_cfg()) + 2 * cfg.d_model + 2
    out = cfg.n_layers * per_layer + 2 * cfg.d_model
    if cfg.has_shared_block:
        L_attn = default_n_stages(max(cfg.d_model,
                                      cfg.n_heads * cfg.head_dim))
        L_ffn = default_n_stages(max(cfg.d_model, cfg.shared_attn_d_ff))
        shared = (cfg.d_model + 6 * L_attn + 8 + cfg.head_dim + 32
                  + 3 * (3 * L_ffn + 4) + cfg.d_model)
        out += sum(s.shared_block for s in cfg.layers) * shared
    return out


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for arch in SSM_ARCHS:
        jcfg = j_get_smoke(arch)
        jp = J_T.init_model(jax.random.PRNGKey(0), jcfg)
        tcfg = get_smoke(arch)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                             device="cpu")
        out[arch] = (jcfg, jp, tcfg, tp)
    return out


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_smoke_ssm_models_match_the_reference(pairs, arch, monkeypatch):
    """Forward logits, ``lm_loss`` and every parameter's grad of the smoke
    model (zamba2 with its shared block before layers 0 and 2, the block's
    grads summed over both) within the depth bound."""
    jcfg, jp, tcfg, tp = pairs[arch]
    jcfg = dataclasses.replace(jcfg, remat=False)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                         device="cpu").trainable()
    rng = np.random.default_rng(1)
    b = {"tokens": rng.integers(0, tcfg.vocab_size, (2, 12)),
         "labels": rng.integers(0, tcfg.vocab_size, (2, 12)),
         "mask": (rng.random((2, 12)) > 0.2).astype(np.float32)}
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
          for k, v in b.items()}
    seen, j_forward = [], J_T.forward

    def forward(*a, **k):
        out = j_forward(*a, **k)
        seen.append(out[0])
        return out
    monkeypatch.setattr(J_T, "forward", forward)

    @jax.jit
    def ref(p, jb):
        def loss_fn(q):
            loss, m = J_LM.lm_loss(q, jb, jcfg)
            return loss, seen[-1]
        (loss, logits), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return loss, g, logits

    jl, jg, jlog = ref(jp, jb)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, m = LM.lm_loss(tp, tb, tcfg)
    loss.backward()
    with torch.no_grad():
        logits, _, aux = T.forward(tp, tcfg, tokens=tb["tokens"])
    assert float(aux) == 0.0 == m["aux"].item()
    depth = _depth(tcfg)
    _close(logits.numpy(), jlog, depth, "logits")
    assert abs(loss.item() - float(jl)) <= \
        8 * (depth + tcfg.vocab_size) * EPS32 * (abs(float(jl)) + 1)
    rel = 8 * 2 * depth * EPS32
    want = dict(params_from_jax(jax.tree.map(np.asarray, jg), tcfg,
                                device="cpu").named_parameters())
    for k, p in tp.named_parameters():
        w = want[k].detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=rel * (np.abs(w).max() + 1e-6),
                                   err_msg=f"{arch} {k}")


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_replay_prefill_and_greedy_generate_match_the_reference(pairs,
                                                                arch):
    """In f32: the port's ``prefill`` (decode replay, the shared block's KV
    cache written a token at a time) gives the reference's last logits and
    caches within the bound; ``ServeEngine.generate``'s greedy tokens equal
    the reference engine's; the replayed prefill's logits agree with the
    chunked forward's within the reference's own contract (atol 2e-3,
    ``tests/test_layers.py``); ``length`` is refused."""
    jcfg, jp, tcfg, tp = pairs[arch]
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 9))
    jl, jc = J_LM.prefill(jp, jcfg, max_len=16, tokens=jnp.asarray(
        toks, jnp.int32), cache_dtype=jnp.float32)
    with torch.inference_mode():
        tl, tc = LM.prefill(tp, tcfg, max_len=16,
                            tokens=torch.from_numpy(toks),
                            cache_dtype=torch.float32)
        full, _, _ = T.forward(tp, tcfg, tokens=torch.from_numpy(toks))
    depth = _depth(tcfg) * 9
    _close(tl.numpy(), jl, depth, "prefill logits")
    np.testing.assert_allclose(tl.numpy(), full[:, -1].numpy(), atol=2e-3)
    if isinstance(jc, dict):                 # stacked: {"l0": (G, ...)}
        jc = [jax.tree.map(lambda a: a[i], jc["l0"])
              for i in range(tcfg.n_layers)]
    for i, (tci, jci) in enumerate(zip(tc, jc)):
        for part in tci:
            for k in tci[part]:
                _close(tci[part][k].numpy(), jci[part][k], depth,
                       f"layer {i} {part} {k}")
                assert tci[part][k].dtype == torch.float32
    want = JServeEngine(cfg=jcfg, params=jp, max_len=16,
                        cache_dtype=jnp.float32).generate(
        jnp.asarray(toks[:, :6], jnp.int32), max_new_tokens=6)
    got = ServeEngine(cfg=tcfg, params=tp, max_len=16,
                      cache_dtype=torch.float32, device="cpu").generate(
        torch.from_numpy(toks[:, :6]), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(NotImplementedError, match="attention-only"):
        LM.prefill(tp, tcfg, max_len=16, tokens=torch.from_numpy(toks),
                   length=torch.tensor([9, 7]))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_continuous_engine_refuses_ssm_stacks(pairs, arch, monkeypatch,
                                              capsys):
    """The continuous engine refuses SSM stacks with the reference's
    message, and ``launch.serve --continuous`` reports the refusal."""
    _, _, tcfg, tp = pairs[arch]
    with pytest.raises(ValueError, match="attention-only"):
        ContinuousBatchingEngine(tcfg, tp, slots=2, max_len=16,
                                 device="cpu")
    from repro_torch.launch import serve as launch_serve
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", arch, "--smoke", "--device", "cpu",
        "--continuous", "--batch", "2", "--prompt-len", "4",
        "--new-tokens", "2"])
    with pytest.raises(SystemExit, match="attention-only"):
        launch_serve.main()
