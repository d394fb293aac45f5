"""The PyTorch port's training slice on the CPU, against the JAX reference.

* ``adamw_update`` on a stacked-layout tree (the reference's layout for
  every config the port runs), so that the weight-decay mask counts the
  layer axis: per-layer 1-D leaves decay, ``final_norm`` does not;
* ``lm_loss`` with a mask;
* three training steps of the smoke ``qwen3-1.7b``: the reference runs its
  forced-kernel path (``use_kernel=True``, ``spm_block_fuse=True``, Pallas
  interpret mode) with remat on, the port its plain versions on the CPU;
  both get the same numpy batches;
* the step's guards and accumulation, and ``launch.train`` at smoke size.

Tolerances are derived as in ``tests/test_torch_model.py``: the depth of
dependent f32 roundings (Higham's gamma_k ~ k eps) times 8, at the
result's scale.
"""

import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.models import causal_lm as J_LM  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.optim import adamw as J_opt  # noqa: E402
from repro.train import make_train_state as j_make_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import DeterministicLoader, build_corpus  # noqa: E402
from repro_torch.kernels import spm_stack as K  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import causal_lm as LM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw as T_opt  # noqa: E402
from repro_torch.train import make_train_state, make_train_step  # noqa: E402
from repro_torch.train.chaos import ChaosSchedule  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)


def _model_depth(cfg) -> int:
    """Dependent f32 roundings through the smoke model's forward (as
    ``tests/test_torch_model.py`` counts them); the backward walks the same
    chain once more."""
    L_attn, L_ffn = 6, 7      # default_n_stages(64), default_n_stages(96)
    per_layer = (cfg.d_model + 3 * L_attn + 8 + cfg.head_dim + 32
                 + 3 * L_attn + 3 * (3 * L_ffn + 4) + cfg.d_model)
    return cfg.n_layers * per_layer + 2 * cfg.d_model


def _flat(tree) -> dict:
    return {k: v.detach().clone() for k, v in tree.state_dict().items()}


@pytest.fixture(scope="module")
def smoke_pair():
    jcfg = dataclasses.replace(j_get_smoke("qwen3-1.7b", use_kernel=True),
                               spm_block_fuse=True)
    assert jcfg.remat and jcfg.stacked_params
    jparams = J_T.init_model(jax.random.PRNGKey(0), jcfg)
    tcfg = get_smoke("qwen3-1.7b")
    return jcfg, jparams, tcfg


def _port_params(jparams, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                           device="cpu")


# ---------------------------------------------------------------------------
# AdamW with the reference's layout
# ---------------------------------------------------------------------------

def test_adamw_matches_reference_on_stacked_tree():
    """Two updates of a stacked-layout tree: the per-layer 1-D leaves (a
    norm scale, a diagonal, a bias) carry a layer axis in the reference and
    decay there; ``final_norm`` stays 1-D and does not.  The port's mask
    counts the axis; a bare ``ndim >= 2`` test would not decay them."""
    rng = np.random.default_rng(0)
    n_layers, d = 3, 8

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    jtree = {"embed": {"table": r(5, d)}, "final_norm": {"scale": r(d)},
             "layers": {"l0": {"norm1": {"scale": r(n_layers, d)},
                               "mixer": {"q": {"d_in": r(n_layers, d),
                                               "mix": r(n_layers, 4, 4)}},
                               "mlp": {"up": {"bias": r(n_layers, d)}}}}}
    cfg = T_opt.OptimizerConfig(lr=0.1, weight_decay=0.5, warmup_steps=1,
                                total_steps=4, clip_norm=2.0)
    jcfg = J_opt.OptimizerConfig(**dataclasses.asdict(cfg))
    tcfg = dataclasses.replace(get_smoke("qwen3-1.7b"), n_layers=n_layers,
                               layers=get_smoke("qwen3-1.7b").layers[:1]
                               * n_layers)
    flat = lambda tree: _flat(params_from_jax(tree, tcfg,  # noqa: E731
                                              device="cpu"))
    params = flat(jtree)
    mask = T_opt.decay_mask(params)
    assert mask["layers.1.norm1.scale"] and mask["layers.0.mlp.up.bias"]
    assert not mask["final_norm.scale"]
    assert params["layers.1.norm1.scale"].dim() == 1
    jstate = J_opt.init_opt_state(jtree)
    tstate = T_opt.init_opt_state(params)
    jp, tp = jtree, params
    for step in range(2):
        g = jax.tree.map(lambda a: r(*a.shape), jtree)
        jp, jstate, jinfo = J_opt.adamw_update(jp, g, jstate, jcfg)
        tp, tstate, tinfo = T_opt.adamw_update(tp, flat(g), tstate, cfg)
        ref = flat(jax.tree.map(np.asarray, jp))
        # clip, moments, bias correction and the step: about 20 dependent
        # roundings a step, at the parameters' scale
        for k in ref:
            np.testing.assert_allclose(
                tp[k].numpy(), ref[k].numpy(), rtol=0,
                atol=8 * 20 * (step + 1) * EPS32
                * (float(ref[k].abs().max()) + 1))
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]),
                                   rtol=8 * 64 * EPS32)
        np.testing.assert_allclose(float(tinfo["lr"]), float(jinfo["lr"]),
                                   rtol=8 * 8 * EPS32)
    assert int(tstate["count"]) == 2


def test_cosine_schedule_matches_reference():
    cfg = T_opt.OptimizerConfig(warmup_steps=10, total_steps=100)
    jcfg = J_opt.OptimizerConfig(warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(T_opt.cosine_schedule(cfg, torch.tensor(s))),
            float(J_opt.cosine_schedule(jcfg, jnp.asarray(s))),
            rtol=8 * 8 * EPS32)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def test_lm_loss_matches_reference(smoke_pair):
    jcfg, jparams, tcfg = smoke_pair
    tparams = _port_params(jparams, tcfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (2, 12))
    labels = rng.integers(0, tcfg.vocab_size, (2, 12))
    mask = (rng.random((2, 12)) > 0.3).astype(np.float32)
    jl, jm = J_LM.lm_loss(jparams, {"tokens": jnp.asarray(toks, jnp.int32),
                                    "labels": jnp.asarray(labels, jnp.int32),
                                    "mask": jnp.asarray(mask)}, jcfg)
    with torch.no_grad():
        tl, tm = LM.lm_loss(tparams, {"tokens": torch.from_numpy(toks),
                                      "labels": torch.from_numpy(labels),
                                      "mask": torch.from_numpy(mask)}, tcfg)
    tol = 8 * (_model_depth(tcfg) + tcfg.vocab_size) * EPS32 \
        * (abs(float(jl)) + 1)
    for k in ("loss", "ce"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0,
                                   atol=tol)
    assert float(tm["aux"]) == 0.0 == float(jm["aux"])
    assert float(tm["ce_weight"]) == float(jm["ce_weight"]) == mask.sum()
    assert set(tm) == set(jm)


# ---------------------------------------------------------------------------
# three steps against the reference
# ---------------------------------------------------------------------------

def test_three_smoke_steps_match_reference(smoke_pair):
    """Loss and grad norm at each step within the model's f32 depth bound;
    the step-0 grads of every leaf within it, at that leaf's scale; the
    params after each step: AdamW's update is invariant to the grads'
    scale, so it moves by the grads' relative error, and the difference of
    the params is held to that error times the update's size."""
    jcfg, jparams, tcfg = smoke_pair
    opt = dict(lr=1e-2, total_steps=3, warmup_steps=1)
    jstep = jax.jit(j_make_step(lambda p, b: J_LM.lm_loss(p, b, jcfg),
                                J_opt.OptimizerConfig(**opt),
                                chaos_guard=True))
    tstep = make_train_step(lambda p, b: LM.lm_loss(p, b, tcfg),
                            T_opt.OptimizerConfig(**opt), chaos_guard=True)
    jstate = j_make_state(jparams)
    tstate = make_train_state(_port_params(jparams, tcfg))
    p0 = _flat(tstate["params"])
    loader = DeterministicLoader(
        launch_train.make_batch_fn(tcfg, 16, build_corpus(20_000, seed=0)),
        4, seed=0)
    rel = 8 * 2 * _model_depth(tcfg) * EPS32      # forward and backward
    for s in range(3):
        batch = loader.batch_at(s)
        jb = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()}
        if s == 0:
            jg = jax.grad(lambda p: J_LM.lm_loss(p, jb, jcfg)[0])(
                jstate["params"])
            jg = _flat(params_from_jax(jax.tree.map(np.asarray, jg), tcfg,
                                       device="cpu"))
            loss, _ = LM.lm_loss(tstate["params"], batch, tcfg)
            loss.backward()
            for k, p in tstate["params"].named_parameters():
                np.testing.assert_allclose(
                    p.grad.numpy(), jg[k].numpy(), rtol=0,
                    atol=rel * (float(jg[k].abs().max()) + 1e-6), err_msg=k)
        jstate, jm = jstep(jstate, jb, 0.0)
        tstate, tm = tstep(tstate, batch, 0.0)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=rel, err_msg=f"step {s} {k}")
        assert float(tm["skipped"]) == 0.0
        ref = _flat(params_from_jax(jax.tree.map(np.asarray,
                                                 jstate["params"]), tcfg,
                                    device="cpu"))
        got = _flat(tstate["params"])
        diff = sum(float(((got[k] - ref[k]) ** 2).sum()) for k in ref) ** .5
        moved = sum(float(((ref[k] - p0[k]) ** 2).sum()) for k in ref) ** .5
        assert diff <= rel * moved, (s, diff, moved)


# ---------------------------------------------------------------------------
# the step's guards, accumulation and remat
# ---------------------------------------------------------------------------

def _smoke_state(seed=0):
    cfg = get_smoke("qwen3-1.7b")
    params = T.init_model(cfg, seed=seed, device="cpu")
    return cfg, make_train_state(params)


def _batch(cfg, b=4, t=8, seed=0):
    loader = DeterministicLoader(
        launch_train.make_batch_fn(cfg, t, build_corpus(5_000, seed=0)), b,
        seed=seed)
    return loader.batch_at(0)


def test_poisoned_step_leaves_state_bitwise_unchanged():
    cfg, state = _smoke_state()
    step = make_train_step(lambda p, b: LM.lm_loss(p, b, cfg),
                           T_opt.OptimizerConfig(), chaos_guard=True)
    state, m = step(state, _batch(cfg), 0.0)
    before = _flat(state["params"])
    mu = {k: v.clone() for k, v in state["opt"]["mu"].items()}
    nu = {k: v.clone() for k, v in state["opt"]["nu"].items()}
    count = int(state["opt"]["count"])
    state, m = step(state, _batch(cfg, seed=1), 1.0)
    assert float(m["skipped"]) == 1.0 and not np.isfinite(
        float(m["grad_norm"]))
    for k, v in _flat(state["params"]).items():
        assert torch.equal(v, before[k]), k
    for k in mu:
        assert torch.equal(state["opt"]["mu"][k], mu[k])
        assert torch.equal(state["opt"]["nu"][k], nu[k])
    assert int(state["opt"]["count"]) == count
    assert int(state["step"]) == 2
    state, m = step(state, _batch(cfg, seed=2), 0.0)
    assert float(m["skipped"]) == 0.0 and int(state["opt"]["count"]) == 2


def test_accumulation_weights_ce_by_mask():
    """Two microbatches with uneven masks: ce is the masked mean of the
    whole batch, and the grads equal one full-batch step's when the masks
    are even."""
    cfg, state = _smoke_state()
    step = make_train_step(lambda p, b: LM.lm_loss(p, b, cfg),
                           T_opt.OptimizerConfig(), accum_steps=2)
    batch = _batch(cfg, b=4)
    mask = torch.ones(4, 8)
    mask[0, 3:] = 0.0
    batch["mask"] = mask
    with torch.no_grad():
        parts = [LM.lm_loss(state["params"], {k: v[i * 2:(i + 1) * 2]
                                              for k, v in batch.items()},
                            cfg)[1] for i in range(2)]
    want = sum(float(p["ce"]) * float(p["ce_weight"]) for p in parts) \
        / float(mask.sum())
    _, m = step(state, batch, None)
    np.testing.assert_allclose(float(m["ce"]), want, rtol=8 * 64 * EPS32)
    assert float(m["ce_weight"]) == float(mask.sum())


def test_remat_runs_each_forward_kernel_call_twice(monkeypatch):
    """With remat every layer's forward runs again in the backward: twice
    the calls of the forward wrappers, once the backward wrappers (the
    plain path counts no launch on the CPU, so the calls are counted
    here)."""
    calls = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    for name, fn in (("K1", "spm_stack_kernel_call"),
                     ("K2", "spm_stack_bwd_kernel_call"),
                     ("K3", "spm_block_kernel_call"),
                     ("K4", "spm_block_bwd_kernel_call")):
        real = getattr(K, fn)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(K, fn, counted)
    for remat, factor in ((True, 2), (False, 1)):
        cfg = dataclasses.replace(get_smoke("qwen3-1.7b"), remat=remat)
        params = T.init_model(cfg, seed=0, device="cpu").trainable()
        for k in calls:
            calls[k] = 0
        loss, _ = LM.lm_loss(params, _batch(cfg, b=2), cfg)
        loss.backward()
        # per layer: q, k, v on K3; o, gate, up, down one run each on K1
        assert calls == {"K1": factor * 4 * cfg.n_layers,
                         "K3": factor * 3 * cfg.n_layers,
                         "K2": 4 * cfg.n_layers, "K4": 3 * cfg.n_layers}


def test_multi_device_pieces_raise():
    """The pod's errors, as the reference's: compression without an axis,
    and a step that reduces over an axis no pod binds."""
    with pytest.raises(ValueError, match="requires grad_axis"):
        make_train_step(lambda p, b: None, T_opt.OptimizerConfig(),
                        compress_grads=True)
    cfg, state = _smoke_state()
    step = make_train_step(lambda p, b: LM.lm_loss(p, b, cfg),
                           T_opt.OptimizerConfig(), grad_axis="pod")
    with pytest.raises(ValueError, match="unbound axis"):
        step(state, _batch(cfg))
    assert int(state["step"]) == 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_train_two_smoke_steps_on_cpu(capsys):
    args = launch_train.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
         "--seq", "8", "--log-every", "1"])
    seen = []
    state = launch_train.train(
        args, chaos=ChaosSchedule.parse("nan@1"),
        on_step=lambda s, st, m, dt: seen.append((s, m["skipped"],
                                                  m["loss"])))
    assert [s for s, _, _ in seen] == [0, 1]
    assert [k for _, k, _ in seen] == [0.0, 1.0]
    assert all(np.isfinite(loss) for _, _, loss in seen)
    assert int(state["step"]) == 2 and int(state["opt"]["count"]) == 1
    assert "step     2" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--pod-dp", "2"],
                                  ["--compress-pod-grads"]])
def test_launch_train_refuses_later_slices(flag):
    """The pod flags are ported: a batch the pod does not divide is
    refused, as in the reference; ``--compress-pod-grads`` without a pod
    trains one process's step (the knob matters under a pod only)."""
    args = launch_train.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--steps", "1", "--batch", "3",
         "--seq", "8"] + flag)
    if "--pod-dp" in flag:
        with pytest.raises(ValueError, match="must divide by --pod-dp 2"):
            launch_train.train(args)
        return
    state = launch_train.train(args)
    assert int(state["step"]) == 1 and "ef" not in state["opt"]


def test_launch_train_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = argparse.Namespace(**vars(launch_train.build_parser().parse_args(
        ["--smoke"])))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.train(args)
