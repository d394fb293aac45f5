"""The port's MoE archs on the CPU, against the JAX reference:
qwen3-moe-30b-a3b (128 experts, top-8) and llama4-scout-17b-a16e (16
experts, top-1, a shared expert), the MoE layer itself, the expert mode of
the fused linear, and what the four archs of this slice share with the
reference's parameter trees (the decay mask, the converters).

The reference runs its smoke configs as they are (``spm_use_kernel`` at
auto: the XLA composition on the CPU, its experts under ``jax.vmap``); the
port runs its kernels' plain versions, the experts through the expert mode
of K1/K2's wrappers (on the CPU, the per-expert plain versions).  Inputs
are numpy draws from a seed; weights go across with ``tree_from_jax`` /
``params_from_jax``.  Where both sides compute the same f32 function with
rounding in other orders, results are held to the Higham-style depth bound
of ``tests/test_torch_train.py``; routing decisions (which expert, which
slot) are held exactly.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.layers import moe as J_M  # noqa: E402
from repro.models import causal_lm as J_LM  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.train import make_train_state as j_make_train_state  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.convert import (params_from_jax, state_from_jax,  # noqa: E402
                                 tree_from_jax)
from repro_torch.core.linear import linear_apply  # noqa: E402
from repro_torch.core.pairings import default_n_stages  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import spm_stack as K  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.layers import moe as M  # noqa: E402
from repro_torch.layers.ffn import init_ffn  # noqa: E402
from repro_torch.models import causal_lm as LM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import decay_mask  # noqa: E402

MOE = ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e")
SLICE = MOE + ("mamba2-370m", "zamba2-1.2b")
EPS32 = float(np.finfo(np.float32).eps)


def _np_dtype(d):
    if isinstance(d, torch.dtype):
        return str(d).split(".")[-1]
    return np.dtype(d).name


def _same_fields(t, j, where):
    """Every field of the port's dataclass equals the reference's (dtypes
    by name)."""
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name.endswith("dtype"):
            assert _np_dtype(a) == _np_dtype(b), (where, f.name)
        else:
            assert a == b, (where, f.name, a, b)


def ref_leaves(tree, cfg):
    """(port key, numpy leaf) of every leaf of a reference parameter tree
    (numpy leaves), stacked layers ``{"l<i>": (G, ...)}`` unstacked into
    the port's ``layers.<layer>`` keys as ``params_from_jax`` does."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        leaf = np.asarray(leaf)
        if keys[0] == "layers" and keys[1].startswith("l") \
                and isinstance(tree["layers"], dict):
            per = len(tree["layers"])
            i = int(keys[1][1:])
            for g in range(leaf.shape[0]):
                out[".".join(["layers", str(g * per + i)] + keys[2:])] = \
                    leaf[g]
        else:
            out[".".join(keys)] = leaf
    return out


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SLICE)
def test_configs_and_sub_configs_match_the_reference(arch):
    """The full and smoke configs field for field, and the sub-configs the
    layers read: ``moe_cfg`` (and its expert and shared FFNs),
    ``mamba_cfg`` (with its in and out projections), ``shared_attn_cfg``
    and ``shared_ffn_cfg``, and ``has_shared_block``."""
    for tc, jc in ((get_config(arch), j_get_config(arch)),
                   (get_smoke(arch), j_get_smoke(arch))):
        for f in dataclasses.fields(T.ModelConfig):
            a, b = getattr(tc, f.name), getattr(jc, f.name)
            if f.name in ("dtype", "param_dtype", "logits_dtype"):
                assert _np_dtype(a) == _np_dtype(b), (arch, f.name)
            elif f.name == "layers":
                assert [dataclasses.asdict(s) for s in a] == \
                    [dataclasses.asdict(s) for s in b]
            else:
                assert a == b, (arch, f.name)
        assert tc.has_shared_block == jc.has_shared_block
        if tc.n_experts:
            _same_fields(tc.moe_cfg(), jc.moe_cfg(), "moe")
            _same_fields(tc.moe_cfg().expert_ffn, jc.moe_cfg().expert_ffn,
                         "expert")
            assert tc.moe_cfg().capacity(512) == jc.moe_cfg().capacity(512)
        if any(s.mixer == "mamba" for s in tc.layers):
            _same_fields(tc.mamba_cfg(), jc.mamba_cfg(), "mamba")
            for lin in ("in_proj", "out_proj"):
                a = getattr(tc.mamba_cfg(), lin)
                b = getattr(jc.mamba_cfg(), lin)
                assert (a.d_in, a.d_out, a.impl) == (b.d_in, b.d_out,
                                                     b.impl)
        if tc.has_shared_block:
            _same_fields(tc.shared_attn_cfg(), jc.shared_attn_cfg(), "sa")
            _same_fields(tc.shared_ffn_cfg(), jc.shared_ffn_cfg(), "sf")


def test_layer_pattern_helpers_match_the_reference():
    for n, k in ((48, 6), (38, 6), (4, 2), (7, 3)):
        for tf, jf, args in ((t_base.moe_layers, j_base.moe_layers, (n,)),
                             (t_base.mamba_layers, j_base.mamba_layers,
                              (n,)),
                             (t_base.hybrid_layers, j_base.hybrid_layers,
                              (n, k))):
            assert [dataclasses.asdict(s) for s in tf(*args)] == \
                [dataclasses.asdict(s) for s in jf(*args)]


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def test_top_k_gating_ties_and_gates():
    """All-zero rows pick experts 0..k-1 and tied logits the lower index,
    as ``jax.lax.top_k`` does; the masks equal the reference's exactly and
    the gates within an ulp (XLA's exp and torch's differ by one on some
    inputs; the gate arithmetic is the reference's formula)."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 16, 8)).astype(np.float32)
    logits[0] = 0.0
    logits[1, :, 5] = logits[1, :, 2]          # a tie, 2 before 5
    logits[2] = np.round(logits[2])            # many ties
    for k in (1, 2, 8):
        jg, jm = jax.jit(lambda x: J_M._top_k_gating(x, k))(
            jnp.asarray(logits))
        tg, tm = M._top_k_gating(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                                   atol=EPS32)
        assert tm[0].sum(-1).eq(k).all()
        assert tm[0, :, :k].all()
        np.testing.assert_allclose(tg[0, :, :k].numpy(), 1.0 / k, rtol=0,
                                   atol=EPS32)


def _moe_pair(arch, **over):
    jc = dataclasses.replace(j_get_smoke(arch).moe_cfg(), **over)
    tc = dataclasses.replace(get_smoke(arch).moe_cfg(), **over)
    jp = J_M.init_moe(jax.random.PRNGKey(1), jc)
    tp = tree_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, tc, tp


def _moe_atol(cfg, ref) -> float:
    """Dependent f32 roundings of one MoE layer: the router's dot, the
    top-k softmax, each expert's three SPM stacks and gate product, the
    combine's k terms, and the shared expert's FFN."""
    L = default_n_stages(max(cfg.d_model, cfg.d_ff))
    depth = (cfg.d_model + cfg.n_experts + 3 * (3 * L + 4) + 4 * cfg.top_k
             + (3 * (3 * L + 4) if cfg.shared_d_ff else 0))
    return 8 * depth * EPS32 * (float(np.abs(ref).max()) + 1)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_apply_matches_the_reference(arch, cf):
    """``moe_apply`` on 3 groups of 16 tokens, at the config's capacity
    factor and at 0.5 (tokens dropped at capacity): the routing (mask and
    kept slots) exactly the reference's, y within the depth bound (llama4
    with its shared expert on the same x), aux within the bound of its
    softmax and means."""
    jc, jp, tc, tp = _moe_pair(arch, capacity_factor=cf, group_size=16)
    x = np.random.default_rng(0).standard_normal((2, 24, 64)).astype(
        np.float32)
    jy, ja = jax.jit(lambda p, x: J_M.moe_apply(p, x, jc))(jp,
                                                          jnp.asarray(x))
    ty, ta = M.moe_apply(tp, torch.from_numpy(x), tc)
    if cf < 1:
        cap = tc.capacity(16)
        logits = torch.from_numpy(x).reshape(3, 16, 64) @ tp["router"]
        _, mask = M._top_k_gating(logits, tc.top_k)
        assert int(mask.sum(1).max()) > cap     # some tokens dropped
    ref = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), ref, rtol=0,
                               atol=_moe_atol(tc, ref))
    assert abs(float(ta) - float(ja)) <= \
        8 * (tc.n_experts + 48) * EPS32 * (abs(float(ja)) + 1)


@pytest.mark.parametrize("arch", MOE)
def test_a_nan_row_poisons_its_group_as_in_the_reference(arch):
    """One NaN token row: every token of its group comes out NaN on both
    sides (the one-hot dispatch multiplies it into every slot: ``0 * NaN``),
    the other groups finite and within the bound, aux NaN on both."""
    jc, jp, tc, tp = _moe_pair(arch, group_size=16)
    x = np.random.default_rng(1).standard_normal((2, 24, 64)).astype(
        np.float32)
    x[1, 3, 7] = np.nan                      # token 27: group 1 of 3
    jy, ja = jax.jit(lambda p, x: J_M.moe_apply(p, x, jc))(jp,
                                                          jnp.asarray(x))
    ty, ta = M.moe_apply(tp, torch.from_numpy(x), tc)
    ref = np.asarray(jy).reshape(3, 16, 64)
    got = ty.numpy().reshape(3, 16, 64)
    assert np.isnan(ref[1]).all() and np.isnan(got[1]).all()
    for g in (0, 2):
        assert np.isfinite(got[g]).all()
        np.testing.assert_allclose(got[g], ref[g], rtol=0,
                                   atol=_moe_atol(tc, ref[g]))
    assert np.isnan(float(ja)) and np.isnan(float(ta))


def test_expert_linear_is_per_expert_linear_bit_for_bit():
    """The expert mode's plain path (the wrappers on CPU tensors) against
    ``linear_apply`` of each expert alone, forward and every grad bit for
    bit, on the smoke qwen3-moe expert's rectangular up (64 -> 32) and
    down (32 -> 64) linears."""
    cfg = get_smoke("qwen3-moe-30b-a3b").moe_cfg().expert_ffn
    gen = torch.Generator().manual_seed(0)
    p = init_ffn(cfg, gen, torch.device("cpu"), lead=(5,)).trainable()
    x = torch.randn(5, 7, cfg.d_model, generator=gen, requires_grad=True)
    for name in ("up", "down"):
        lin = getattr(cfg, name)
        xin = x if name == "up" else torch.randn(5, 7, cfg.d_ff,
                                                 generator=gen,
                                                 requires_grad=True)
        y = linear_apply(p[name], xin, lin)
        gy = torch.randn(y.shape, generator=gen)
        got = torch.autograd.grad(y, [xin] + list(p[name].parameters()), gy)
        for e in range(5):
            pe = {k: v[e].detach().clone().requires_grad_()
                  for k, v in p[name].named_parameters()}
            xe = xin[e].detach().clone().requires_grad_()
            ye = linear_apply(pe, xe, lin)
            assert torch.equal(ye, y[e])
            want = torch.autograd.grad(ye, [xe] + list(pe.values()), gy[e])
            for g, w in zip(got, want):
                assert torch.equal(g[e], w)


def test_expert_mode_plans_once_per_run_and_refuses_int8(monkeypatch):
    """A multi-run expert plan: one wrapper call a run for all experts
    (the run chain of ``spm_stack_fused``); int8 and windowed operands are
    refused, naming the roadmap."""
    E, n, rows = 3, 64, 6
    strides = tuple(1 << i for i in range(6))
    gen = torch.Generator().manual_seed(1)
    cf = torch.randn(E, 6, n // 2, 4, generator=gen)
    x = torch.randn(E, rows, 40, generator=gen)
    calls = []
    real = K.spm_stack_kernel_call

    def spy(*a, **kw):
        calls.append(kw["n_tile"])
        return real(*a, **kw)
    runs = ops.plan_runs(n, strides, 16)
    assert len(runs) > 1
    monkeypatch.setattr(ops, "plan_runs_for_rows",
                        lambda n_, s_, r_: ops.plan_runs(n_, s_, 16))
    monkeypatch.setattr(K, "spm_stack_kernel_call", spy)
    y = ops.spm_stack_fused(x, cf, strides, in_width=40, out_width=50)
    monkeypatch.undo()
    assert len(calls) == len(runs) and y.shape == (E, rows, 50)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.spm_stack_fused(x, cf, strides, in_width=40, quant_coeffs=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        K.spm_stack_kernel_call(torch.zeros(E, rows, n), cf,
                                strides=strides, n_tile=n, col_base=0,
                                in_width=n)


# ---------------------------------------------------------------------------
# the smoke models against the reference
# ---------------------------------------------------------------------------

def _depth(cfg) -> int:
    """Dependent f32 roundings of an MoE smoke model's forward, counted as
    ``tests/test_torch_archs.py`` counts a dense one, the MoE layer's as
    ``_moe_atol``'s."""
    L_attn = default_n_stages(max(cfg.d_model, cfg.n_heads * cfg.head_dim))
    L_ffn = default_n_stages(max(cfg.d_model, cfg.moe_d_ff))
    moe = (cfg.d_model + cfg.n_experts + 3 * (3 * L_ffn + 4)
           + 4 * cfg.top_k + (3 * (3 * L_ffn + 4) if cfg.shared_d_ff else 0))
    per_layer = (cfg.d_model + 3 * L_attn + 8 + cfg.head_dim + 32
                 + 3 * L_attn + moe + cfg.d_model + 2)
    return cfg.n_layers * per_layer + 2 * cfg.d_model


@pytest.mark.parametrize("arch", MOE)
def test_smoke_moe_models_match_the_reference(arch, monkeypatch):
    """Logits, ``lm_loss`` (ce + 0.01 aux) and aux, and every parameter's
    grad of the smoke model within the depth bound at each one's scale."""
    jcfg = dataclasses.replace(j_get_smoke(arch), remat=False)
    tcfg = get_smoke(arch)
    jp = J_T.init_model(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                         device="cpu").trainable()
    rng = np.random.default_rng(0)
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
            return loss, (m["ce"], m["aux"], seen[-1])
        (loss, (ce, aux, logits)), g = jax.value_and_grad(
            loss_fn, has_aux=True)(p)
        return loss, ce, aux, g, logits

    jl, jce, jaux, jg, jlog = ref(jp, jb)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, m = LM.lm_loss(tp, tb, tcfg)
    loss.backward()
    with torch.no_grad():
        logits, _, aux = T.forward(tp, tcfg, tokens=tb["tokens"])
    depth = _depth(tcfg)
    ref_logits = np.asarray(jlog)
    np.testing.assert_allclose(
        logits.numpy(), ref_logits, rtol=0,
        atol=8 * depth * EPS32 * (np.abs(ref_logits).max() + 1))
    tol = 8 * (depth + tcfg.vocab_size) * EPS32 * (abs(float(jl)) + 1)
    assert abs(loss.item() - float(jl)) <= tol
    assert abs(m["ce"].item() - float(jce)) <= tol
    assert float(jaux) > 0
    for a in (m["aux"], aux):
        assert abs(a.item() - float(jaux)) <= tol
    rel = 8 * 2 * depth * EPS32
    want = dict(params_from_jax(jax.tree.map(np.asarray, jg), tcfg,
                                device="cpu").named_parameters())
    for k, p in tp.named_parameters():
        w = want[k].detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=rel * (np.abs(w).max() + 1e-6),
                                   err_msg=f"{arch} {k}")


# ---------------------------------------------------------------------------
# the parameter trees of the four archs
# ---------------------------------------------------------------------------

def _ref_shapes(arch):
    jcfg = j_get_smoke(arch)
    return jcfg, jax.eval_shape(
        lambda: J_T.init_model(jax.random.PRNGKey(0), jcfg))


@pytest.mark.parametrize("arch", SLICE)
def test_decay_mask_is_the_references_rule(arch):
    """The reference decays ``p.ndim >= 2`` on its stacked tree (experts
    (G, E, ...), zamba2's ``{"l0": (38, ...)}`` with its shared block
    unstacked at the top level); the port's ``decay_mask`` gives the same
    verdict for every leaf, mapped through ``params_from_jax``'s paths."""
    jcfg, shapes = _ref_shapes(arch)
    assert jcfg.stacked_params and isinstance(shapes["layers"], dict)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [str(k.key) for k in path]
        tail = ".".join(keys[2:] if keys[0] == "layers" else keys)
        want[(keys[0] == "layers", tail)] = len(leaf.shape) >= 2
    tparams = T.init_model(get_smoke(arch), device="cpu")
    got = decay_mask(dict(tparams.named_parameters()))
    seen = set()
    for k, v in got.items():
        layer = k.startswith("layers.")
        key = (layer, k.split(".", 2)[2] if layer else k)
        seen.add(key)
        assert v == want[key], k
    assert seen == want.keys()
    if arch == "zamba2-1.2b":
        assert got["shared.attn.q.d_in"] is False
        assert got["layers.3.mixer.A_log"] is True
    if arch == "qwen3-moe-30b-a3b":
        assert got["layers.1.mlp.experts.up.d_in"] is True


@pytest.mark.parametrize("arch", SLICE)
def test_params_and_state_from_jax_carry_the_trees(arch):
    """The reference's tree of each arch (numpy draws in its stacked
    shape) through ``params_from_jax`` and ``state_from_jax``: the port's
    keys are the reference's leaves unstacked (the expert axis and the
    top-level ``shared`` block kept), each leaf bit for bit, the same keys
    and shapes as the port's own ``init_model``, and the moments, count
    and step carried likewise."""
    jcfg, shapes = _ref_shapes(arch)
    tcfg = get_smoke(arch)
    rng = np.random.default_rng(4)
    jp = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), shapes)
    want = ref_leaves(jp, jcfg)
    got = {k: v.detach().numpy() for k, v in
           params_from_jax(jp, tcfg, device="cpu").named_parameters()}
    own = {k: tuple(v.shape) for k, v in
           T.init_model(tcfg, device="cpu").named_parameters()}
    assert got.keys() == want.keys() == own.keys()
    for k in want:
        assert got[k].shape == own[k]
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jstate = jax.tree.map(np.asarray, j_make_train_state(
        jax.tree.map(jnp.asarray, jp)))
    jstate["opt"]["mu"] = jax.tree.map(lambda a: a + 1, jstate["opt"]["mu"])
    jstate["step"] = np.int32(7)
    ts = state_from_jax(jstate, tcfg, device="cpu")
    mu = ref_leaves(jstate["opt"]["mu"], jcfg)
    for k, v in ts["opt"]["mu"].items():
        np.testing.assert_array_equal(v.numpy(), mu[k], err_msg=k)
    assert int(ts["step"]) == 7


def test_launch_train_refuses_quantize_for_moe(capsys):
    """``--quantize`` with an MoE arch is refused when the arguments are
    parsed, naming the roadmap; the SSM archs keep it."""
    for arch in MOE:
        with pytest.raises(SystemExit):
            launch_train.build_parser().parse_args(
                ["--arch", arch, "--smoke", "--quantize"])
        assert "ROADMAP" in capsys.readouterr().err
    for arch in ("mamba2-370m", "zamba2-1.2b"):
        assert launch_train.build_parser().parse_args(
            ["--arch", arch, "--smoke", "--quantize"]).quantize


def test_smoke_moe_trains_through_launch_train():
    """Two steps of the smoke qwen3-moe through ``launch.train.train`` on
    the CPU: finite losses, aux reported and positive, the expert leaves
    moved."""
    args = launch_train.build_parser().parse_args(
        ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
         "--steps", "2", "--batch", "2", "--seq", "16"])
    seen = []
    state = launch_train.train(
        args, on_step=lambda s, st, m, dt: seen.append(m))
    assert len(seen) == 2
    assert all(np.isfinite(m["loss"]) and m["aux"] > 0 for m in seen)
    fresh = T.init_model(get_smoke("qwen3-moe-30b-a3b"), device="cpu")
    moved = copy.deepcopy(dict(state["params"].named_parameters()))
    key = "layers.0.mlp.experts.gate.mix"
    assert not torch.equal(moved[key], dict(fresh.named_parameters())[key])
