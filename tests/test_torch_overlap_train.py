"""Parity of the port's overlap-scheduled sharded executor with the JAX
reference on the smoke model, on the CPU.

* three training steps of ``with_overlap_executor(with_feature_sharding(
  SMOKE, 4), True)`` on a 4-shard CPU mesh against the reference's under
  a mesh of 4 host devices, once with ``with_quantized_io`` (int8 tables on
  the sharded path; the sharded path ignores int8 activations);
* the same converted params giving the same logits with overlap on and
  off, and with int8 tables sharded and unsharded.

The reference's side runs in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (this file run as a
script), as ``tests/test_torch_shard.py`` runs its worker; its state and
step outputs are pinned replicated on its mesh, so its step compiles once.
The operator-level parity is ``tests/test_torch_overlap.py``.  Tolerances
are derived as in ``tests/test_torch_shard.py``.
"""

import copy
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.configs.base import (  # noqa: E402
    with_feature_sharding as j_with_feature_sharding,
    with_overlap_executor as j_with_overlap_executor,
    with_quantized_io as j_with_quantized_io)
from repro.models import causal_lm as J_LM  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.optim import adamw as J_opt  # noqa: E402
from repro.parallel.ctx import activation_sharding as j_sharding  # noqa: E402
from repro.train import make_train_state as j_make_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402

TRAIN_SHARDS = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
TRAIN_STEPS = 3
TRAIN_BATCH, TRAIN_SEQ = 4, 16
OPT = dict(lr=1e-2, total_steps=3, warmup_steps=1)


def _j_train_cfg(quant: bool):
    cfg = dataclasses.replace(j_get_smoke("qwen3-1.7b", use_kernel=True),
                              spm_block_fuse=True)
    cfg = j_with_overlap_executor(j_with_feature_sharding(cfg, TRAIN_SHARDS),
                                  True)
    return j_with_quantized_io(cfg) if quant else cfg


def _worker(inputs_path: str, out_path: str) -> None:
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    assert jax.device_count() == TRAIN_SHARDS, jax.device_count()
    mesh = Mesh(np.asarray(jax.devices()), ("model",))
    rep = NamedSharding(mesh, P())
    batches = np.load(inputs_path)
    out = {}
    for quant in (False, True):
        jcfg = _j_train_cfg(quant)
        tag = f"train{'_q8' if quant else ''}"
        state = jax.device_put(
            j_make_state(J_T.init_model(jax.random.PRNGKey(0), jcfg)), rep)
        step = jax.jit(j_make_step(lambda p, b: J_LM.lm_loss(p, b, jcfg),
                                   J_opt.OptimizerConfig(**OPT),
                                   chaos_guard=True), out_shardings=rep)
        with j_sharding(mesh, shard_feature=True):
            for s in range(TRAIN_STEPS):
                jb = {k: jax.device_put(jnp.asarray(batches[f"{k}{s}"],
                                                    jnp.int32), rep)
                      for k in ("tokens", "labels")}
                state, m = step(state, jb, 0.0)
                for k in ("loss", "grad_norm", "skipped"):
                    out[f"{tag}/{k}{s}"] = np.asarray(m[k])
                for i, leaf in enumerate(jax.tree.leaves(state["params"])):
                    out[f"{tag}/params{s}/{i}"] = np.asarray(leaf)
    np.savez(out_path, **out)


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
    sys.exit(0)


from repro_torch.configs import (get_smoke,  # noqa: E402
                                 with_feature_sharding,
                                 with_overlap_executor, with_quantized_io)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import DeterministicLoader, build_corpus  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import causal_lm as LM  # noqa: E402
from repro_torch.optim import adamw as T_opt  # noqa: E402
from repro_torch.parallel import (activation_sharding,  # noqa: E402
                                  make_feature_mesh)
from repro_torch.parallel import spm_shard as T_sh  # noqa: E402
from repro_torch.train import make_train_state, make_train_step  # noqa: E402


def _train_batches():
    tcfg = with_feature_sharding(get_smoke("qwen3-1.7b"), TRAIN_SHARDS)
    loader = DeterministicLoader(
        launch_train.make_batch_fn(tcfg, TRAIN_SEQ,
                                   build_corpus(20_000, seed=0)),
        TRAIN_BATCH, seed=0)
    return [loader.batch_at(s) for s in range(TRAIN_STEPS)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's training results (``_worker``), computed once."""
    d = tmp_path_factory.mktemp("overlap_train_ref")
    inputs = {f"{k}{s}": b[k].numpy() for s, b in enumerate(_train_batches())
              for k in ("tokens", "labels")}
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_"
                        f"platform_device_count={TRAIN_SHARDS}")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = (os.path.join(REPO, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(d / "inputs.npz"),
         str(d / "ref.npz")], capture_output=True, text=True, timeout=900,
        cwd=REPO, env=env)
    assert r.returncode == 0, (f"reference worker failed (rc={r.returncode})"
                               f":\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    return dict(np.load(d / "ref.npz"))


def _t_train_cfg(quant: bool):
    cfg = with_overlap_executor(
        with_feature_sharding(get_smoke("qwen3-1.7b"), TRAIN_SHARDS), True)
    return with_quantized_io(cfg) if quant else cfg


def _model_depth(cfg) -> int:
    """Dependent f32 roundings through the smoke model's forward, as
    ``tests/test_torch_shard.py`` counts them."""
    L_attn, L_ffn = 6, 7
    per_layer = (cfg.d_model + 3 * L_attn + 8 + cfg.head_dim + 32
                 + 3 * L_attn + 3 * (3 * L_ffn + 4) + cfg.d_model)
    return cfg.n_layers * per_layer + 2 * cfg.d_model


def _cpu_mesh():
    return make_feature_mesh(TRAIN_SHARDS, device="cpu")


def _flat(tree) -> dict:
    return {k: v.detach().clone() for k, v in tree.state_dict().items()}


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8_tables"])
def test_three_overlap_smoke_steps_match_reference(reference, quant):
    """Three steps of ``with_overlap_executor(with_feature_sharding(SMOKE,
    4), True)`` (and with ``with_quantized_io``), the port under a 4-shard
    CPU mesh and the reference under its 4-device mesh, the same batches:
    the loss and grad norm at each step and the params after each step,
    held as ``tests/test_torch_shard.py`` holds the step-serial ones (both
    sides read the same int8 tables)."""
    jcfg = _j_train_cfg(quant)
    tcfg = _t_train_cfg(quant)
    tag = f"train{'_q8' if quant else ''}"
    jparams = J_T.init_model(jax.random.PRNGKey(0), jcfg)
    treedef = jax.tree.structure(jparams)
    n_leaves = treedef.num_leaves

    def ref_tree(prefix):
        leaves = [reference[f"{tag}/{prefix}/{i}"] for i in range(n_leaves)]
        return _flat(params_from_jax(jax.tree.unflatten(treedef, leaves),
                                     tcfg, device="cpu"))

    state = make_train_state(params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    p0 = _flat(state["params"])
    step = make_train_step(lambda p, b: LM.lm_loss(p, b, tcfg),
                           T_opt.OptimizerConfig(**OPT), chaos_guard=True)
    rel = 8 * 2 * _model_depth(tcfg) * EPS32      # forward and backward
    with activation_sharding(_cpu_mesh(), shard_feature=True):
        for s, batch in enumerate(_train_batches()):
            state, m = step(state, batch, 0.0)
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(
                    float(m[k]), float(reference[f"{tag}/{k}{s}"]),
                    rtol=rel, err_msg=f"step {s} {k}")
            assert float(m["skipped"]) == 0.0
            assert float(reference[f"{tag}/skipped{s}"]) == 0.0
            ref = ref_tree(f"params{s}")
            got = _flat(state["params"])
            diff = sum(float(((got[k] - ref[k]) ** 2).sum())
                       for k in ref) ** .5
            moved = sum(float(((ref[k] - p0[k]) ** 2).sum())
                        for k in ref) ** .5
            assert diff <= rel * moved, (s, diff, moved)


def _logits(tcfg, params, toks, mesh):
    from repro_torch.models import transformer as T
    with torch.no_grad():
        if mesh is None:
            return T.forward(params, tcfg, tokens=toks)[0]
        with activation_sharding(mesh, shard_feature=True):
            return T.forward(params, tcfg, tokens=toks)[0]


def _dequantized(params, shards):
    """A copy of ``params`` with every SPM table replaced by its int8 round
    trip as the reference quantizes it (``repro.kernels.quant``): one
    scale a stage of each shard's local table (its cross stages untouched)
    with ``shards``, one a stage of the whole table without."""
    from repro.core import eligibility as J_el
    from repro.core import pairings as J_pair
    from repro.kernels import quant as J_Q

    def round_trip(tab):
        return np.array(J_Q.dequantize_coeffs(
            *J_Q.quantize_coeffs(jnp.asarray(tab))))

    out = copy.deepcopy(params)
    tables = {k: v for k, v in out.state_dict().items()
              if k.endswith(".mix")}
    assert len(tables) == 7 * get_smoke("qwen3-1.7b").n_layers
    for t in tables.values():
        cf = t.numpy()
        L, n = cf.shape[0], 2 * cf.shape[1]
        if shards is None:
            new = round_trip(cf)
        else:
            new, nl2 = cf.copy(), n // shards // 2
            for st in J_el.plan_steps(n, J_pair.make_schedule(
                    "two_level", n, L, n_shards=shards).strides(), shards):
                if st[0] == "local":
                    for j in range(shards):
                        sl = (slice(st[1], st[1] + len(st[2])),
                              slice(j * nl2, (j + 1) * nl2))
                        new[sl] = round_trip(cf[sl])
        with torch.no_grad():
            t.copy_(torch.from_numpy(new))
    return out


def test_converted_params_give_the_same_logits_overlap_and_int8(
        monkeypatch):
    """``convert.params_from_jax`` needs no new leaf for the overlap
    schedule or for int8 tables on the sharded path.  The same converted
    params give the same logits with overlap on and off (within the
    model's f32 depth; every SPM linear runs sharded, the q/k/v/o ones on
    the overlap schedule).  With ``quant_coeffs``, sharded (one scale a
    stage of each shard's table) and unsharded (one of the whole table),
    each side gives the logits of its own dequantized tables, as the
    reference quantizes them, run in f32, within the same f32 bound; the
    unquantized model and the tables quantized whole instead of per
    shard both miss the sharded side by more than it."""
    jcfg = _j_train_cfg(False)
    base = with_feature_sharding(get_smoke("qwen3-1.7b"), TRAIN_SHARDS)
    ov = with_overlap_executor(base, True)
    params = params_from_jax(jax.tree.map(np.asarray, J_T.init_model(
        jax.random.PRNGKey(0), jcfg)), ov, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, ov.vocab_size, (2, 12)))
    plans = []
    orig = T_sh._ShardedCore.apply

    def spy(plan, *a):
        plans.append(plan)
        return orig(plan, *a)

    monkeypatch.setattr(T_sh._ShardedCore, "apply", spy)
    serial = _logits(base, params, toks, _cpu_mesh())
    assert plans and not any(p.overlap for p in plans)
    plans.clear()
    over = _logits(ov, params, toks, _cpu_mesh())
    # q, k, v, o (n=64) take the overlap schedule; gate, up, down (n=96 in
    # the smoke model, ending on a cross stage) too
    assert len(plans) == 14 and all(p.overlap for p in plans)
    rel = 8 * _model_depth(ov) * EPS32
    scale = float(serial.abs().max()) + 1
    np.testing.assert_allclose(over.numpy(), serial.numpy(), rtol=0,
                               atol=rel * scale)
    plans.clear()
    q_sh = _logits(with_quantized_io(ov), params, toks, _cpu_mesh())
    assert len(plans) == 14 and all(p.quant_cf for p in plans)
    q_un = _logits(dataclasses.replace(base, spm_quant_coeffs=True), params,
                   toks, None)
    per_shard = _dequantized(params, TRAIN_SHARDS)
    whole = _dequantized(params, None)

    def gap(a, b):
        return float((a - b).abs().max()) / (rel * scale)

    assert gap(q_sh, _logits(ov, per_shard, toks, _cpu_mesh())) <= 1
    assert gap(q_un, _logits(base, whole, toks, None)) <= 1
    # planted faults: no quantization, the whole table's scales
    assert gap(q_sh, over) > 1
    assert gap(q_sh, _logits(ov, whole, toks, _cpu_mesh())) > 1
