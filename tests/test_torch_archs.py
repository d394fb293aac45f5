"""The port's other dense-attention archs on the CPU, against the JAX
reference: gemma3-12b (5:1 local:global, sliding-window ring caches,
local RoPE, ``embed_scale``), qwen2-vl-7b (M-RoPE, embedding inputs),
musicgen-medium (embedding inputs), minitron-4b and qwen3-32b.

The reference runs its smoke configs as they are (``spm_use_kernel`` at
auto: the XLA composition on the CPU), jitted once per arch; the port runs
its kernels' plain versions.  Weights go across with ``params_from_jax``,
inputs are numpy draws from a seed.  Where both sides compute the same f32
function with rounding in other orders (and XLA's cos/sin against torch's,
one ulp apart), results are held to the Higham-style depth bound of
``tests/test_torch_train.py``; the ring caches' contents and masks are held
bit for bit on inputs whose every value is exact.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.layers import attention as J_A  # noqa: E402
from repro.layers import rope as J_R  # noqa: E402
from repro.layers.embedding import embed as j_embed  # noqa: E402
from repro.models import causal_lm as J_LM  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.pairings import default_n_stages  # noqa: E402
from repro_torch.layers import attention as A  # noqa: E402
from repro_torch.layers import rope as R  # noqa: E402
from repro_torch.models import causal_lm as LM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.params import Params  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine, Request  # noqa: E402

NEW = ("gemma3-12b", "qwen2-vl-7b", "musicgen-medium", "minitron-4b",
       "qwen3-32b")
EPS32 = float(np.finfo(np.float32).eps)
COS_ULP = 2.0 ** -23     # XLA's cos/sin against torch's on equal angles


def _depth(cfg) -> int:
    """Dependent f32 roundings through the model's forward, counted as
    ``tests/test_torch_train.py`` counts them, with this config's stage
    counts and a RoPE rounding a layer."""
    L_attn = default_n_stages(max(cfg.d_model, cfg.n_heads * cfg.head_dim))
    L_ffn = default_n_stages(max(cfg.d_model, cfg.d_ff))
    per_layer = (cfg.d_model + 3 * L_attn + 8 + cfg.head_dim + 32
                 + 3 * L_attn + 3 * (3 * L_ffn + 4) + cfg.d_model + 2)
    return cfg.n_layers * per_layer + 2 * cfg.d_model


def _np_dtype(d):
    return np.dtype(d).name


# ---------------------------------------------------------------------------
# configs and tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_the_reference_field_for_field(arch):
    """Every field the port's ModelConfig has equals the reference's, in
    the full config and the smoke one (dtypes by name, the layer pattern
    spec by spec)."""
    assert set(NEW) < set(ARCH_IDS)
    t_fields = {f.name for f in dataclasses.fields(T.ModelConfig)}
    for tc, jc in ((get_config(arch), j_get_config(arch)),
                   (get_smoke(arch), j_get_smoke(arch))):
        for name in t_fields:
            a, b = getattr(tc, name), getattr(jc, name)
            if name in ("dtype", "param_dtype", "logits_dtype"):
                assert _np_dtype(a) == _np_dtype(b), (arch, name)
            elif name == "layers":
                assert [dataclasses.asdict(s) for s in a] == \
                    [dataclasses.asdict(s) for s in b], arch
            else:
                assert a == b, (arch, name, a, b)


def test_local_global_layers_match_the_reference():
    for n, k, w in ((48, 5, 1024), (6, 5, 8), (12, 2, 16)):
        assert [dataclasses.asdict(s) for s in
                t_base.local_global_layers(n, k, w)] == \
            [dataclasses.asdict(s) for s in
             j_base.local_global_layers(n, k, w)]
    with pytest.raises(ValueError):
        t_base.local_global_layers(7, 5, 8)


@pytest.mark.parametrize("head_dim, theta", [
    (16, 1e6), (16, 1e4), (8, 1e4), (128, 1e6), (256, 1e6), (256, 1e4),
    (64, 1e4), (128, 1e4)])
def test_rope_frequencies_are_the_references_bit_for_bit(head_dim, theta):
    """The frequencies, correctly rounded from f64 on the host, equal the
    reference's ``theta ** (-arange(half) / half)`` bit for bit, so every
    angle ``position * freq`` does too; cos/sin of equal angles differ
    between XLA and torch by at most an ulp of 1."""
    half = head_dim // 2
    want = np.asarray(theta ** (-jnp.arange(0, half, dtype=jnp.float32)
                                / half))
    got = R.rope_freqs(head_dim, theta, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    pos = np.arange(0, 40_000, 37).reshape(1, -1)
    jc, js = J_R.rope_angles(jnp.asarray(pos), head_dim, theta)
    tc, ts = R.rope_angles(torch.from_numpy(pos), head_dim, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=COS_ULP)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=COS_ULP)


@pytest.mark.parametrize("head_dim, sections", [(16, (2, 3, 3)),
                                                (128, (16, 24, 24))])
def test_mrope_angles_match_the_reference(head_dim, sections):
    """Distinct (t, h, w) ids: each section of the port's table is the
    rope table of its own axis, bit for bit, and within an ulp of 1 of the
    reference's; coinciding ids give ``rope_angles`` bit for bit."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 5000, (3, 2, 40))
    jc, js = J_R.mrope_angles(jnp.asarray(ids), head_dim, sections, 1e6)
    tc, ts = R.mrope_angles(torch.from_numpy(ids), head_dim, sections, 1e6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=COS_ULP)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=COS_ULP)
    off = 0
    for axis, sec in enumerate(sections):
        c1, s1 = R.rope_angles(torch.from_numpy(ids[axis]), head_dim, 1e6)
        assert torch.equal(tc[..., off: off + sec], c1[..., off: off + sec])
        assert torch.equal(ts[..., off: off + sec], s1[..., off: off + sec])
        off += sec
    same = torch.from_numpy(np.broadcast_to(ids[0], ids.shape).copy())
    cm, sm = R.mrope_angles(same, head_dim, sections, 1e6)
    cr, sr = R.rope_angles(torch.from_numpy(ids[0]), head_dim, 1e6)
    assert torch.equal(cm, cr) and torch.equal(sm, sr)


@pytest.mark.parametrize("arch", ["gemma3-12b", "qwen2-vl-7b", "qwen3-32b"])
def test_rope_tables_match_the_reference(arch):
    """``_rope_tables``: the same keys, the local table from
    ``rope_local_theta`` (the default one itself when the thetas agree),
    both M-RoPE under ``mrope``; each within an ulp of 1 of the
    reference's."""
    tcfg, jcfg = get_smoke(arch), j_get_smoke(arch)
    pos = np.arange(24).reshape(1, 24) * np.array([[1], [3]])
    if tcfg.rope_kind == "mrope":
        pos = np.stack([pos, pos // 2, pos % 5])
    jt = J_T._rope_tables(jcfg, jnp.asarray(pos))
    tt = T._rope_tables(tcfg, torch.from_numpy(pos))
    assert set(tt) == set(jt) == {"default", "local"}
    for key in tt:
        for a, b in zip(tt[key], jt[key]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=COS_ULP)
    if tcfg.rope_kind == "mrope" or tcfg.rope_local_theta == tcfg.rope_theta:
        assert tt["local"] is tt["default"]
    else:
        want = R.rope_angles(torch.from_numpy(pos), tcfg.head_dim,
                             tcfg.rope_local_theta)
        assert all(torch.equal(a, b) for a, b in zip(tt["local"], want))


def test_embed_scale_rounds_to_the_activation_dtype_first(monkeypatch):
    """In bf16, sqrt(3840) = 61.97 rounds to 62.0 before the product, as
    the reference's ``h * jnp.asarray(embed_scale, h.dtype)``: the hidden
    state entering layer 0 is the reference's bit for bit, and not the
    product with the unrounded scale."""
    cfg = dataclasses.replace(get_smoke("gemma3-12b"), dtype="bfloat16",
                              embed_scale=3840 ** 0.5)
    assert float(torch.tensor(3840 ** 0.5, dtype=torch.bfloat16)) == 62.0
    params = T.init_model(cfg, seed=0, device="cpu")
    seen = []

    def first(lp, spec, c, h, *a):
        seen.append(h)
        return h
    monkeypatch.setattr(T, "_apply_layer", first)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 7))
    with torch.no_grad():
        T.forward(params, cfg, tokens=torch.from_numpy(toks))
    table = jnp.asarray(params["embed"]["table"].numpy())
    h = j_embed({"table": table}, jnp.asarray(toks),
                j_get_smoke("gemma3-12b").embed_cfg(), jnp.bfloat16)
    want = np.asarray((h * jnp.asarray(3840 ** 0.5, h.dtype))
                      .astype(jnp.float32))
    got = seen[0].float().numpy()
    np.testing.assert_array_equal(got, want)
    unrounded = (np.asarray(h.astype(jnp.float32)) * 3840 ** 0.5).astype(
        jnp.bfloat16).astype(np.float32)
    assert not np.array_equal(got, unrounded)


# ---------------------------------------------------------------------------
# the five smoke models against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pairs():
    """arch -> (reference config, reference params, port config, port
    params), built once."""
    out = {}
    for arch in NEW:
        jcfg = j_get_smoke(arch)
        jp = J_T.init_model(jax.random.PRNGKey(0), jcfg)
        tcfg = get_smoke(arch)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                             device="cpu")
        out[arch] = (jcfg, jp, tcfg, tp)
    return out


def _batch(cfg, B=2, T_len=12, seed=0):
    """numpy inputs: tokens or embeddings, labels, a mask, and distinct
    (3, B, T) M-RoPE ids from a 3 x 4 patch grid under ``mrope``."""
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab_size, (B, T_len)),
         "mask": (rng.random((B, T_len)) > 0.2).astype(np.float32)}
    if cfg.input_kind == "tokens":
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, T_len))
    else:
        b["embeds"] = rng.standard_normal((B, T_len, cfg.d_model)).astype(
            np.float32)
    if cfg.rope_kind == "mrope":
        i = np.arange(T_len)
        grid = np.stack([i // 12, (i // 4) % 3, i % 4])
        b["positions"] = np.broadcast_to(grid[:, None] + np.arange(B)[
            None, :, None], (3, B, T_len)).copy()
    return b


@pytest.mark.parametrize("arch", NEW)
def test_smoke_logits_loss_and_grads_match_reference(pairs, arch,
                                                     monkeypatch):
    """Forward logits, ``lm_loss`` and every parameter's grad of the smoke
    model (qwen2-vl and musicgen through ``embeds``, qwen2-vl with distinct
    M-RoPE ids) within the depth bound at each one's scale."""
    jcfg, jp, tcfg, tp = pairs[arch]
    # the reference's remat only recomputes (and would double its compile)
    jcfg = dataclasses.replace(jcfg, remat=False)
    tp = copy.deepcopy(tp).trainable()
    b = _batch(tcfg)
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
          for k, v in b.items()}
    kw = "tokens" if tcfg.input_kind == "tokens" else "embeds"
    # the logits come out of lm_loss's own forward, as its aux: a second
    # forward in the same trace would cost a second compile of the model
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
            return loss, (m["ce"], seen[-1])
        (loss, (ce, logits)), g = jax.value_and_grad(loss_fn,
                                                     has_aux=True)(p)
        return loss, ce, g, logits

    jl, jce, jg, jlog = ref(jp, jb)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, m = LM.lm_loss(tp, tb, tcfg)
    loss.backward()
    with torch.no_grad():
        logits, _, _ = T.forward(tp, tcfg, positions=tb.get("positions"),
                                 **{kw: tb[kw]})
    depth = _depth(tcfg)
    ref_logits = np.asarray(jlog)
    np.testing.assert_allclose(
        logits.numpy(), ref_logits, rtol=0,
        atol=8 * depth * EPS32 * (np.abs(ref_logits).max() + 1))
    tol = 8 * (depth + tcfg.vocab_size) * EPS32 * (abs(float(jl)) + 1)
    assert abs(loss.item() - float(jl)) <= tol
    assert abs(m["ce"].item() - float(jce)) <= tol
    rel = 8 * 2 * depth * EPS32
    want = dict(params_from_jax(jax.tree.map(np.asarray, jg), tcfg,
                                device="cpu").named_parameters())
    for k, p in tp.named_parameters():
        w = want[k].detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=rel * (np.abs(w).max() + 1e-6),
                                   err_msg=f"{arch} {k}")


def _logit_atol(cfg, ref):
    return 8 * _depth(cfg) * EPS32 * (float(np.abs(ref).max()) + 1)


def test_gemma3_ring_prefill_and_decode_match_reference(pairs):
    """gemma3 smoke (window 8): a 13-token prefill then 6 decoded tokens,
    every local layer's ring wrapping, against the reference's ``prefill``
    and ``decode_step``, with a scalar ``cache_index``, a per-row (B,) one,
    and a right-padded batch with per-row lengths: logits within the depth
    bound, greedy tokens equal, the caches (rings of 8 slots, full layers
    of 24) within it."""
    jcfg, jp, tcfg, tp = pairs["gemma3-12b"]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab_size, (2, 13))
    lens = np.array([13, 10])
    jpre = jax.jit(lambda p, t, n: J_LM.prefill(
        p, jcfg, max_len=24, tokens=t, cache_dtype=jnp.float32, length=n))
    jdec = jax.jit(lambda p, t, c, i: J_LM.decode_step(p, jcfg, t, c, i))
    for mode in ("scalar", "per-row", "padded"):
        n = lens if mode == "padded" else np.array([13, 13])
        jl, jc = jpre(jp, jnp.asarray(toks, jnp.int32),
                      jnp.asarray(n, jnp.int32))
        with torch.inference_mode():
            tl, tc = LM.prefill(tp, tcfg, max_len=24,
                                tokens=torch.from_numpy(toks),
                                cache_dtype=torch.float32,
                                length=torch.from_numpy(n) if mode ==
                                "padded" else None)
        ci = n.copy()
        for step in range(7):
            ref = np.asarray(jl)
            np.testing.assert_allclose(tl.numpy(), ref, rtol=0,
                                       atol=_logit_atol(tcfg, ref),
                                       err_msg=f"{mode} step {step}")
            tok = np.argmax(ref, -1)
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
            for i, spec in enumerate(tcfg.layers):
                for name in ("k", "v"):
                    want = np.asarray(jc[f"l{i}"]["mixer"][name][0])
                    got = tc[i]["mixer"][name].numpy()
                    assert got.shape[1] == (8 if spec.window else 24)
                    np.testing.assert_allclose(got, want, rtol=0,
                                               atol=64 * _depth(tcfg)
                                               * EPS32)
            if step == 6:
                break
            # the reference decodes per row throughout (one compile): at
            # equal positions its scatter writes what its scalar path
            # writes, and the port's scalar path is held to it
            t_ci = 13 + step if mode == "scalar" else torch.from_numpy(ci)
            jl, jc = jdec(jp, jnp.asarray(tok, jnp.int32), jc,
                          jnp.asarray(ci, jnp.int32))
            with torch.inference_mode():
                tl, tc = LM.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                        t_ci)
            ci = ci + 1


# ---------------------------------------------------------------------------
# the ring itself, bit for bit
# ---------------------------------------------------------------------------

W_RING, D_RING = 4, 16


def _ring_layer():
    """One windowed attention layer whose every value is exact on both
    sides: dense projections of 0/1 weights (k = 0, so every valid key
    weighs the same; v and o the identity), RoPE tables cos = 1, sin = 0,
    and inputs one-hot in a feature that encodes (row, position): each
    output feature then sums at most one nonzero term, ``1 / valid
    keys``."""
    kw = dict(d_model=D_RING, n_heads=1, n_kv_heads=1, head_dim=D_RING,
              window=W_RING, linear_impl="dense", q_chunk=4, k_chunk=4)
    eye = np.eye(D_RING, dtype=np.float32)
    w = {"q": eye, "k": np.zeros_like(eye), "v": eye, "o": eye}
    jp = {k: {"w": jnp.asarray(v)} for k, v in w.items()}
    tp = Params({k: {"w": torch.from_numpy(v.copy())} for k, v in w.items()})
    return J_A.AttentionConfig(**kw), jp, A.AttentionConfig(**kw), tp


def _onehot(B, T_len, t0=0):
    x = np.zeros((B, T_len, D_RING), np.float32)
    for b in range(B):
        for t in range(T_len):
            x[b, t, (t0 + t + 5 * b) % D_RING] = 1.0
    return x


def test_ring_fill_and_decode_masks_are_the_references_bit_for_bit():
    """Ring contents after a prefill (full, short of the window, and
    right-padded with per-row lengths, which keeps padded keys out of the
    ring) and every decode step's output (the valid mask ``age < min(ci +
    1, W)``, a scalar and a per-row ``cache_index``, across the wrap) equal
    the reference's bit for bit."""
    jcfg, jp, tcfg, tp = _ring_layer()
    B = 2
    for T_len, lens in ((6, None), (2, None), (7, np.array([7, 3])),
                        (5, np.array([2, 5]))):
        x = _onehot(B, T_len)
        cos = np.ones((B, T_len, D_RING // 2), np.float32)
        sin = np.zeros_like(cos)
        jcache = J_A.init_kv_cache(B, 12, jcfg, jnp.float32)
        _, jcache = J_A.attention_apply(
            jp, jnp.asarray(x), jcfg, cos=jnp.asarray(cos),
            sin=jnp.asarray(sin), cache=jcache,
            cache_index=jnp.asarray(0, jnp.int32),
            fill_len=None if lens is None else jnp.asarray(lens))
        tcache = A.init_kv_cache(B, 12, tcfg, torch.device("cpu"),
                                 torch.float32)
        assert tcache["v"].shape[1] == W_RING
        with torch.no_grad():
            A.attention_apply(tp, torch.from_numpy(x), tcfg,
                              cos=torch.from_numpy(cos),
                              sin=torch.from_numpy(sin), cache=tcache,
                              cache_index=0,
                              fill_len=None if lens is None
                              else torch.from_numpy(lens))
        for name in ("k", "v"):
            np.testing.assert_array_equal(tcache[name].numpy(),
                                          np.asarray(jcache[name]))
        n = np.full(B, T_len) if lens is None else lens
        per_row = lens is not None
        jc = dict(jcache)
        for step in range(6):
            xd = _onehot(B, 1, t0=T_len + step + 7)
            c1 = np.ones((B, 1, D_RING // 2), np.float32)
            s1 = np.zeros_like(c1)
            ci = n + step
            jy, jc = J_A.attention_apply(
                jp, jnp.asarray(xd), jcfg, cos=jnp.asarray(c1),
                sin=jnp.asarray(s1), cache=jc,
                cache_index=jnp.asarray(ci if per_row else int(ci[0]),
                                        jnp.int32))
            with torch.no_grad():
                ty, _ = A.attention_apply(
                    tp, torch.from_numpy(xd), tcfg,
                    cos=torch.from_numpy(c1), sin=torch.from_numpy(s1),
                    cache=tcache,
                    cache_index=torch.from_numpy(ci) if per_row
                    else int(ci[0]))
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy),
                                          err_msg=f"T={T_len} step {step}")
            for name in ("k", "v"):
                np.testing.assert_array_equal(tcache[name].numpy(),
                                              np.asarray(jc[name]))


def test_ring_sources_keep_padded_keys_out():
    """Slot j takes the newest real position p = j (mod S); a row shorter
    than the ring repeats its position 0 in the slots no position reaches,
    which decode masks by age."""
    src = A.ring_sources(0, 7, 4, torch.tensor([7, 3, 1]))
    assert src.tolist() == [[4, 5, 6, 3], [0, 1, 2, 0], [0, 0, 0, 0]]


# ---------------------------------------------------------------------------
# the continuous engine over ring caches
# ---------------------------------------------------------------------------

def test_continuous_churn_over_rings_with_a_planted_nan(pairs):
    """gemma3 smoke through ``ContinuousBatchingEngine``, 2 slots, 6
    requests with prompts shorter and longer than the window: each
    request's tokens in the churning pool equal its tokens served alone at
    the same slot count, bit for bit; with NaN planted in every ring and
    full row of each slot just before each admit, the tokens are unchanged
    and no request is flagged: an admit replaces the whole row."""
    _, _, cfg, params = pairs["gemma3-12b"]
    lens = (3, 11, 20, 8, 14, 5)

    def reqs():
        g = np.random.default_rng(9)
        return [Request(prompt=torch.from_numpy(
                    g.integers(0, cfg.vocab_size, n)),
                        max_new_tokens=4 + i % 3, rid=i)
                for i, n in enumerate(lens)]

    def engine():
        return ContinuousBatchingEngine(cfg, params, slots=2, max_len=32,
                                        cache_dtype=torch.float32,
                                        device="cpu")

    eng = engine()
    pool, _ = eng.serve(reqs(), arrival_ticks=[0, 0, 1, 2, 2, 5])
    planted = engine()
    inner = planted._admit

    def admit(batch, tick, results):
        for slot, _ in batch:
            for c in planted._cache:
                c["mixer"]["k"][slot].fill_(float("nan"))
                c["mixer"]["v"][slot].fill_(float("nan"))
        return inner(batch, tick, results)
    planted._admit = admit
    poisoned, _ = planted.serve(reqs(), arrival_ticks=[0, 0, 1, 2, 2, 5])
    for r in reqs():
        alone, _ = engine().serve([r])
        assert alone[r.rid]["tokens"] == pool[r.rid]["tokens"], r.rid
        assert poisoned[r.rid]["tokens"] == pool[r.rid]["tokens"], r.rid
        assert not pool[r.rid]["flagged"] and not poisoned[r.rid]["flagged"]
        assert len(pool[r.rid]["tokens"]) == r.max_new_tokens
