"""The paper's own models in the PyTorch port, on the CPU, against the JAX
reference.

* the MLP student (``models/mlp.py``): forward and grads, with the
  reference on its XLA composition and on its kernel path (Pallas
  interpret mode), and 3 AdamW steps of the Table 1 student against the
  reference's jitted ``make_train_step``, fed the same numpy batches;
* the Table 1 teacher's labels for the reference's own x;
* the Table 2 hashed-text builder fed the reference's own draws (with
  duplicate buckets, which must accumulate);
* the Tables 3–4 char-LM loss and grads, both runners loaded by path;
* the §6 GRU (``gru_cell``, ``gru_apply``) and one GRU-LM step, rotation
  variant with the closed-form backward;
* ``tree_from_jax`` on the four trees and ``params_from_jax`` on qwen3.

Weights are numpy from a seed in the reference's tree (drawn as its inits
draw them; the teacher's are its own) and go through ``tree_from_jax``;
inputs are numpy from a seed.  The port runs its default path: the kernel path,
which on CPU tensors is the kernels' plain versions.  Tolerances are
Higham's gamma_k ~ k eps, times 8, with k the depth of dependent f32
roundings counted for each result (as ``tests/test_torch_train.py``
counts them); each value is held at its own result's scale.
"""

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.configs.paper import student_cfg as j_student_cfg  # noqa: E402
from repro.data import hashed_text as J_HT  # noqa: E402
from repro.data import teacher as J_TE  # noqa: E402
from repro.layers import gru as J_GRU  # noqa: E402
from repro.models import gru_lm as J_GLM  # noqa: E402
from repro.models import mlp as J_MLP  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.optim import OptimizerConfig as JOptCfg  # noqa: E402
from repro.optim import adamw as J_OPT  # noqa: E402
from repro.train import make_train_state as j_make_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.paper import student_cfg  # noqa: E402
from repro_torch.convert import params_from_jax, tree_from_jax  # noqa: E402
from repro_torch.data import (DeterministicLoader,  # noqa: E402
                              HashedTextConfig, TeacherConfig,
                              hashed_text_batch, hashed_text_build,
                              make_teacher, teacher_batch, teacher_logits)
from repro_torch.layers import gru as T_GRU  # noqa: E402
from repro_torch.models import gru_lm as T_GLM  # noqa: E402
from repro_torch.models import mlp as T_MLP  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.train import make_train_state, make_train_step  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return tree_from_jax(_np(tree), device="cpu")


def _flat_ref(tree, prefix=""):
    """The reference's numpy leaves under the port's dotted names."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat_ref(v, f"{prefix}{k}."))
    return out


def _value_and_grad(loss_fn, params):
    """``((loss, metrics), grads)`` of the reference (traced inside the
    caller's ``jax.jit``: eager dispatch of every stage op is slow, and one
    compile a test keeps the file short)."""
    return jax.value_and_grad(loss_fn, has_aux=True)(params)


def _ref_params(make, seed):
    """The reference's parameter tree of ``make`` (its structure from
    ``jax.eval_shape``, so no compile) with numpy values drawn as its inits
    draw them: random rotations (``theta`` uniform in (-pi, pi); general
    blocks those plus 0.05 noise), diagonals 1 + 0.1 N, biases 0.1 N, dense
    weights N / sqrt(d_in), embedding tables 0.02 N."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name in ("theta", "mix"):
            th = rng.uniform(-np.pi, np.pi, a.shape[:2])
            if name == "theta":
                return th.astype(np.float32)
            c, s = np.cos(th), np.sin(th)
            return (np.stack([c, -s, s, c], -1) + 0.05 * rng.standard_normal(
                a.shape)).astype(np.float32)
        z = rng.standard_normal(a.shape)
        scale = {"d_in": 0.1, "d_out": 0.1, "res_scale": 0.1, "b": 0.1,
                 "bias": 0.1, "table": 0.02, "embed": 0.02}.get(
                     name, a.shape[0] ** -0.5)
        one = float(name in ("d_in", "d_out", "res_scale"))
        return (one + scale * z).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(make))


def _numpy_like(tree, seed):
    """A tree of the reference's structure (from ``jax.eval_shape``, so no
    compile) with numpy normal leaves of its shapes and dtypes."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        a.dtype), tree)


def _grads_close(tparams, jgrads, k: int):
    """Every leaf's grad within 8 gamma_k of the leaf's largest reference
    grad (k: the roundings behind one grad element, forward, backward and
    the sum over rows)."""
    ref = _flat_ref(_np(jgrads))
    got = {n: p.grad for n, p in tparams.named_parameters()}
    assert set(got) == set(ref)
    for n, g in got.items():
        scale = float(np.abs(ref[n]).max())
        np.testing.assert_allclose(g.numpy(), ref[n], rtol=0,
                                   atol=8 * k * EPS32 * scale, err_msg=n)


def _rng_batch(seed, rows, width, n_classes):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, width), dtype=np.float32),
            rng.integers(0, n_classes, rows))


# ---------------------------------------------------------------------------
# the MLP student
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl, width, ref_kernel", [
    ("spm_general", 128, None), ("spm_general", 64, True),
    ("dense", 128, None)])
def test_mlp_forward_and_grads_match_reference(impl, width, ref_kernel):
    """Logits and every grad.  ``ref_kernel=True`` runs the reference's
    Pallas kernel pair in interpret mode, else its XLA composition; the
    port takes its kernel path either way."""
    jcfg = dataclasses.replace(j_student_cfg(width, 10, impl),
                               spm_use_kernel=ref_kernel)
    tcfg = student_cfg(width, 10, impl)
    x, y = _rng_batch(2, 32, width, 10)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y, jnp.int32)}
    jp = _ref_params(lambda: J_MLP.init_mlp(jax.random.PRNGKey(1), jcfg), 1)

    @jax.jit
    def ref_side(p):
        return (J_MLP.mlp_apply(p, jb["x"], jcfg),
                _value_and_grad(lambda q: J_MLP.mlp_loss(q, jb, jcfg), p))

    ref, ((jl, jm), jg) = ref_side(jp)
    ref = np.asarray(ref)
    tp = _port(jp).trainable()
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    L = tcfg.mix.spm_config().n_stages if impl != "dense" else 0
    depth = 3 * L + 4 + width + 1       # the stages, diag, bias, head dot
    got = T_MLP.mlp_apply(tp, tb["x"], tcfg)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=8 * depth * EPS32 * np.abs(ref).max())
    tl, tm = T_MLP.mlp_loss(tp, tb, tcfg)
    tl.backward()
    k = depth + 10                      # and the softmax over 10 classes
    assert abs(float(tl.detach()) - float(jl)) <= \
        8 * k * EPS32 * abs(float(jl))
    assert float(tm["acc"]) == float(jm["acc"])
    _grads_close(tp, jg, 2 * k + 32)    # forward, backward, 32 rows


def test_student_three_steps_match_reference():
    """Three AdamW steps of the Table 1 student, width 128, with the
    reference's jitted step and the same numpy batches: the loss and grad
    norm at each step, and the params after it within the grads' relative
    error times the update (AdamW's update is invariant to the grads'
    scale)."""
    width = 128
    jcfg = j_student_cfg(width, 10, "spm_general")
    tcfg = student_cfg(width, 10, "spm_general")
    opt = dict(lr=3e-3, total_steps=3)
    jstep = jax.jit(j_make_step(lambda p, b: J_MLP.mlp_loss(p, b, jcfg),
                                JOptCfg(**opt)))
    tstep = make_train_step(lambda p, b: T_MLP.mlp_loss(p, b, tcfg),
                            OptimizerConfig(**opt))
    jp = _ref_params(lambda: J_MLP.init_mlp(jax.random.PRNGKey(0), jcfg), 0)
    jstate = j_make_state(jp)
    tstate = make_train_state(_port(jp))
    p0 = _flat_ref(jp)
    L = tcfg.mix.spm_config().n_stages
    rel = 8 * 2 * (3 * L + 4 + width + 10 + 64) * EPS32
    for s in range(3):
        x, y = _rng_batch(10 + s, 64, width, 10)
        jstate, jm = jstep(jstate, {"x": jnp.asarray(x),
                                    "y": jnp.asarray(y, jnp.int32)})
        tstate, tm = tstep(tstate, {"x": torch.from_numpy(x),
                                    "y": torch.from_numpy(y)})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=rel, err_msg=f"step {s} {key}")
        ref = _flat_ref(_np(jstate["params"]))
        got = {n: p.detach().numpy()
               for n, p in tstate["params"].named_parameters()}
        diff = sum(float(((got[n] - ref[n]) ** 2).sum()) for n in ref) ** .5
        moved = sum(float(((ref[n] - p0[n]) ** 2).sum()) for n in ref) ** .5
        assert diff <= rel * moved, (s, diff, moved)


# ---------------------------------------------------------------------------
# the data generators
# ---------------------------------------------------------------------------

def test_teacher_labels_match_reference():
    """The port's labels for the reference's own x, from the reference's
    teacher: equal wherever the top-two logit gap exceeds twice the
    logits' bound, which nearly every row does."""
    tc = TeacherConfig(width=128)
    jtc = J_TE.TeacherConfig(width=128)

    @jax.jit
    def ref_side(key):
        t = J_TE.make_teacher(jtc)
        return t, J_TE.teacher_batch(t, jtc, key, 256)

    jteacher, jb = ref_side(jax.random.PRNGKey(3))
    teacher = {"spm": _port(jteacher["spm"]),
               "w2": torch.from_numpy(np.array(jteacher["w2"]))}
    logits = teacher_logits(teacher, torch.from_numpy(np.array(jb["x"])),
                            tc)
    top2 = logits.topk(2, dim=-1).values
    L = tc.spm_cfg().n_stages
    bound = 8 * (3 * L + 3 + 128) * EPS32 * float(logits.abs().max())
    decided = ((top2[:, 0] - top2[:, 1]) > 2 * bound).numpy()
    assert int(decided.sum()) >= 250
    np.testing.assert_array_equal(logits.argmax(-1).numpy()[decided],
                                  np.asarray(jb["y"])[decided])


def test_teacher_batch_is_a_pure_function_of_the_step():
    tc = TeacherConfig(width=64)
    teacher = make_teacher(tc, device="cpu")
    loader = DeterministicLoader(
        lambda rng, n: teacher_batch(teacher, tc, rng, n), 16, seed=0)
    a, b = loader.batch_at(7), loader.batch_at(7)
    assert a["x"].shape == (16, 64) and a["x"].dtype == torch.float32
    assert torch.equal(a["x"], b["x"]) and torch.equal(a["y"], b["y"])
    assert not torch.equal(a["x"], loader.batch_at(8)["x"])
    assert torch.equal(a["y"], teacher_logits(teacher, a["x"], tc)
                       .argmax(-1))


def test_hashed_text_build_matches_reference():
    """The builder fed the reference's own draws (recomputed from the key
    splits of ``hashed_text.py:41-51``) gives the reference's batch: y
    exactly, x within the bound of its sums (duplicate buckets add up to
    nnz magnitudes, the norm sums width squares), each element at its own
    scale, so every zero stays exactly zero."""
    cfg = J_HT.HashedTextConfig(width=64)
    batch = 16
    n_class = int(cfg.nnz * cfg.class_frac)

    @jax.jit
    def ref_side(key):
        ky, kc, kb, _, kv = jax.random.split(key, 5)
        draws = (
            jax.random.randint(ky, (batch,), 0, cfg.n_classes),
            jax.random.randint(kc, (batch, n_class), 0,
                               cfg.topics_per_class),
            jax.random.randint(kb, (batch, cfg.nnz - n_class), 0,
                               cfg.width),
            0.5 + jax.random.exponential(kv, (batch, cfg.nnz)))
        return J_HT.hashed_text_batch(cfg, key, batch), draws

    ref, draws = ref_side(jax.random.PRNGKey(5))
    y, tidx, bg, mags = (np.asarray(d) for d in draws)
    tables = np.asarray(J_HT._class_tables(cfg))
    buckets = np.concatenate([tables[y[:, None], tidx], bg], 1)
    assert any(len(set(row)) < len(row) for row in buckets)
    got = hashed_text_build(tables, y, tidx, bg, mags, cfg.width)
    np.testing.assert_array_equal(got["y"].numpy(), np.asarray(ref["y"]))
    want = np.asarray(ref["x"])
    k = cfg.nnz + cfg.width + 2
    err = np.abs(got["x"].numpy() - want)
    assert bool((err <= 8 * k * EPS32 * np.abs(want)).all()), err.max()


def test_hashed_text_batch_rows_are_unit_norm_and_seeded():
    cfg = HashedTextConfig(width=128)
    a = hashed_text_batch(cfg, np.random.default_rng(1), 8, device="cpu")
    b = hashed_text_batch(cfg, np.random.default_rng(1), 8, device="cpu")
    assert a["x"].shape == (8, 128) and a["x"].dtype == torch.float32
    assert torch.equal(a["x"], b["x"]) and torch.equal(a["y"], b["y"])
    np.testing.assert_allclose(a["x"].norm(dim=1).numpy(), 1.0,
                               rtol=8 * 130 * EPS32)
    assert int(a["y"].max()) < cfg.n_classes


# ---------------------------------------------------------------------------
# the Tables 3-4 char-LM, both runners loaded by path
# ---------------------------------------------------------------------------

def _load(name, monkeypatch):
    """A runner module loaded by path (the repository root importable,
    the module registered for its dataclasses)."""
    monkeypatch.syspath_prepend(REPO)
    path = os.path.join(REPO, "benchmarks", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mod)
    spec.loader.exec_module(mod)
    return mod


def test_charlm_loss_matches_reference_runner(monkeypatch):
    ref_mod = _load("table34_charlm.py", monkeypatch)
    port_mod = _load("torch_table34_charlm.py", monkeypatch)
    d = 64
    jcfg = ref_mod.CharLMCfg(d=d, impl="spm_general")
    tcfg = port_mod.CharLMCfg(d=d, impl="spm_general")
    ch = np.random.default_rng(4).integers(0, ref_mod.VOCAB, (2, 9))
    jb = {"tokens": jnp.asarray(ch[:, :-1], jnp.int32),
          "labels": jnp.asarray(ch[:, 1:], jnp.int32)}

    jp = _ref_params(lambda: ref_mod.init_charlm(jcfg), 4)
    (_, jm), jg = jax.jit(lambda p: _value_and_grad(
        lambda q: ref_mod.charlm_loss(q, jb, jcfg), p))(jp)
    tp = _port(jp).trainable()
    tb = {"tokens": torch.from_numpy(ch[:, :-1]),
          "labels": torch.from_numpy(ch[:, 1:])}
    tl, tm = port_mod.charlm_loss(tp, tb, tcfg)
    tl.backward()
    k = 3 * tcfg.n_stages + 4 + d + ref_mod.VOCAB
    for key in ("loss", "bpc"):
        assert abs(float(tm[key].detach()) - float(jm[key])) <= \
            8 * k * EPS32 * abs(float(jm[key])), key
    _grads_close(tp, jg, 2 * k + 16)


# ---------------------------------------------------------------------------
# the §6 GRU and GRU-LM
# ---------------------------------------------------------------------------

GRU_KW = dict(linear_impl="spm_rotation", spm_backward="custom")


def _gru_step_depth(L):
    """Roundings of one recurrence step: the U_h map after the U_r map and
    its gate (each 3L stages plus diag and bias), the sums and
    nonlinearities between them and the convex update."""
    return 2 * (3 * L + 4) + 12


def test_gru_cell_and_apply_match_reference():
    d, B, T = 64, 2, 8
    jcfg = J_GRU.GRUConfig(d_in=d, d_hidden=d, **GRU_KW)
    tcfg = T_GRU.GRUConfig(d_in=d, d_hidden=d, **GRU_KW)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, T, d), dtype=np.float32)
    h0 = rng.standard_normal((B, d), dtype=np.float32)

    jp = _ref_params(lambda: J_GRU.init_gru(jax.random.PRNGKey(6), jcfg), 6)
    want, (jhs, jh) = jax.jit(lambda p: (J_GRU.gru_cell(p, x[:, 0], h0, jcfg),
                                         J_GRU.gru_apply(p, x, jcfg)))(jp)
    tp = _port(jp)
    step = _gru_step_depth(tcfg.u.spm_config().n_stages)
    want = np.asarray(want)
    with torch.no_grad():
        got = T_GRU.gru_cell(tp, torch.from_numpy(x[:, 0]),
                             torch.from_numpy(h0), tcfg)
        ths, th = T_GRU.gru_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=8 * step * EPS32 * np.abs(want).max())
    assert ths.shape == (B, T, d)
    tol = 8 * T * step * EPS32 * float(np.abs(np.asarray(jhs)).max())
    np.testing.assert_allclose(ths.numpy(), np.asarray(jhs), rtol=0,
                               atol=tol)
    np.testing.assert_array_equal(th.numpy(), ths[:, -1].numpy())
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=tol)


def test_gru_lm_step_matches_reference():
    """One GRU-LM training step (one layer, d_model 64, T=8): the loss,
    every grad, and the params after AdamW within the grads' relative
    error times the update."""
    d, B, T, V = 64, 2, 8, 32
    jcfg = J_GLM.GRULMConfig(vocab_size=V, d_model=d, **GRU_KW)
    tcfg = T_GLM.GRULMConfig(vocab_size=V, d_model=d, **GRU_KW)
    ch = np.random.default_rng(7).integers(0, V, (B, T + 1))
    jb = {"tokens": jnp.asarray(ch[:, :-1], jnp.int32),
          "labels": jnp.asarray(ch[:, 1:], jnp.int32)}
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=2)

    jp = _ref_params(lambda: J_GLM.init_gru_lm(jax.random.PRNGKey(7), jcfg),
                     7)
    (_, jm), jg = jax.jit(lambda p: _value_and_grad(
        lambda q: J_GLM.gru_lm_loss(q, jb, jcfg), p))(jp)
    # the reference step's update (``train/step.py``: clip, then AdamW),
    # apart from its grads so the recurrence compiles once
    jp1 = jax.jit(lambda p, g: J_OPT.adamw_update(
        p, g, J_OPT.init_opt_state(p), JOptCfg(**opt))[0])(jp, jg)
    tp = _port(jp)
    assert isinstance(tp["grus"], torch.nn.ModuleList)
    tb = {"tokens": torch.from_numpy(ch[:, :-1]),
          "labels": torch.from_numpy(ch[:, 1:])}
    L = tcfg.gru_cfg().u.spm_config().n_stages
    k = 2 * (T * _gru_step_depth(L) + d + V) + B * T
    tstate = make_train_state(tp)
    tl, tm = T_GLM.gru_lm_loss(tp, tb, tcfg)
    tl.backward()
    for key in ("loss", "bpc"):
        assert abs(float(tm[key].detach()) - float(jm[key])) <= \
            8 * k * EPS32 * abs(float(jm[key])), key
    _grads_close(tp, jg, k)
    tstate, _ = make_train_step(lambda p, b: T_GLM.gru_lm_loss(p, b, tcfg),
                                OptimizerConfig(**opt))(tstate, tb)
    p0, ref = _flat_ref(_np(jp)), _flat_ref(_np(jp1))
    got = {n: p.detach().numpy() for n, p in tp.named_parameters()}
    diff = sum(float(((got[n] - ref[n]) ** 2).sum()) for n in ref) ** .5
    moved = sum(float(((ref[n] - p0[n]) ** 2).sum()) for n in ref) ** .5
    assert diff <= 8 * k * EPS32 * moved, (diff, moved)


# ---------------------------------------------------------------------------
# converting the trees
# ---------------------------------------------------------------------------

def test_tree_from_jax_keeps_every_leaf_of_the_paper_trees(monkeypatch):
    """The MLP's, the teacher's, the char-LM's (a bare table at the top)
    and the GRU-LM's (a list of layers) trees, as the reference builds
    them: the same dotted keys, every leaf bitwise, on the asked device."""
    ref_mod = _load("table34_charlm.py", monkeypatch)
    key = jax.random.PRNGKey(8)
    makers = {
        "mlp": lambda: J_MLP.init_mlp(key, j_student_cfg(64, 10,
                                                         "spm_general")),
        "teacher": lambda: J_TE.make_teacher(J_TE.TeacherConfig(width=64)),
        "charlm": lambda: ref_mod.init_charlm(ref_mod.CharLMCfg(
            d=64, impl="spm_general")),
        "gru_lm": lambda: J_GLM.init_gru_lm(key, J_GLM.GRULMConfig(
            vocab_size=16, d_model=32, n_layers=2, **GRU_KW))}
    for i, (name, make) in enumerate(makers.items()):
        tree = _numpy_like(jax.eval_shape(make), i)
        want = _flat_ref(tree)
        sd = tree_from_jax(tree, device="cpu").state_dict()
        assert sorted(sd) == sorted(want), name
        for k, v in sd.items():
            assert v.device.type == "cpu" and v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_params_from_jax_unstacks_qwen3_as_before():
    """The stacked smoke qwen3 tree: layer i's leaves are row i // g of
    group l{i % g}; the other keys as they are."""
    jcfg = j_get_smoke("qwen3-1.7b")
    tcfg = get_smoke("qwen3-1.7b")
    jp = _numpy_like(jax.eval_shape(
        lambda: J_T.init_model(jax.random.PRNGKey(0), jcfg)), 9)
    got = params_from_jax(jp, tcfg, device="cpu").state_dict()
    g = len(jp["layers"])
    want = {}
    for k, v in jp.items():
        if k != "layers":
            want.update(_flat_ref(v, f"{k}."))
    for i in range(tcfg.n_layers):
        stacked = _flat_ref(jp["layers"][f"l{i % g}"], f"layers.{i}.")
        want.update({k: v[i // g] for k, v in stacked.items()})
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
