"""The PyTorch port's serving slice on the CPU: the smoke ``qwen3-1.7b``
against the JAX reference, the non-finite-flags contract, the device
policy, and the rule that the port imports nothing of JAX.

The reference runs its forced-kernel path (``use_kernel=True``,
``spm_block_fuse=True``: Pallas interpret mode), which is the path the
port's kernel wrappers take, running their plain versions on CPU tensors.
Weights go from the reference to the port through
``repro_torch.convert.params_from_jax``.
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.models import causal_lm as J_LM  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import spm_stack as K  # noqa: E402
from repro_torch.models import causal_lm as LM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
EPS32 = float(np.finfo(np.float32).eps)


def _logit_tol(cfg, ref) -> float:
    """Derived bound on the logits of two f32 implementations that round
    in different orders: every layer is a chain of dependent roundings
    (qkv norm sum over d_model, 3 per stage of each SPM stack, the
    attention score sum over head_dim and softmax sum over the keys, the
    FFN's three stacks), then the final norm and the unembed sum over
    d_model; Higham's gamma_k ~ k eps, times 8, at the logits' scale."""
    L_attn = 6   # default_n_stages(64)
    L_ffn = 7    # default_n_stages(96)
    per_layer = (cfg.d_model + 3 * L_attn + 8 + cfg.head_dim + 32
                 + 3 * L_attn + 3 * (3 * L_ffn + 4) + cfg.d_model)
    depth = cfg.n_layers * per_layer + 2 * cfg.d_model
    return 8 * depth * EPS32 * (float(np.max(np.abs(ref))) + 1.0)


@pytest.fixture(scope="module")
def smoke_pair():
    jcfg = dataclasses.replace(j_get_smoke("qwen3-1.7b", use_kernel=True),
                               spm_block_fuse=True)
    jparams = J_T.init_model(jax.random.PRNGKey(0), jcfg)
    tcfg = get_smoke("qwen3-1.7b")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_converted_params_follow_reference_keys(smoke_pair):
    _, _, tcfg, tparams = smoke_pair
    keys = set(tparams.state_dict())
    for k in ("embed.table", "final_norm.scale", "layers.1.norm1.scale",
              "layers.0.mixer.q.mix", "layers.0.mixer.k.d_in",
              "layers.0.mixer.v.d_out", "layers.0.mixer.o.mix",
              "layers.0.mixer.q_norm", "layers.0.mlp.gate.mix",
              "layers.0.mlp.up.mix", "layers.0.mlp.down.d_out",
              "layers.1.norm2.scale"):
        assert k in keys, k
    # the port's own init makes the same tree
    own = T.init_model(tcfg, seed=0, device="cpu").state_dict()
    assert set(own) == keys
    for k, v in own.items():
        assert v.shape == tparams.state_dict()[k].shape, k


def test_smoke_prefill_and_decode_logits_match_reference(smoke_pair):
    """Prefill and two decode steps of the f32 smoke model: logits within
    the derived bound, greedy tokens equal."""
    jcfg, jparams, tcfg, tparams = smoke_pair
    toks = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    jl, jc = J_LM.prefill(jparams, jcfg, max_len=16,
                          tokens=jnp.asarray(toks), cache_dtype=jnp.float32)
    with torch.inference_mode():
        tl, tc = LM.prefill(tparams, tcfg, max_len=16,
                            tokens=torch.from_numpy(toks).long(),
                            cache_dtype=torch.float32)
    for step in range(3):
        ref = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), ref, rtol=0,
                                   atol=_logit_tol(tcfg, ref))
        tok = np.argmax(ref, -1)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
        jl, jc = J_LM.decode_step(jparams, jcfg, jnp.asarray(tok, jnp.int32),
                                  jc, jnp.asarray(8 + step, jnp.int32))
        with torch.inference_mode():
            tl, tc = LM.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                    tc, 8 + step)


def test_smoke_greedy_tokens_match_reference(smoke_pair):
    jcfg, jparams, tcfg, tparams = smoke_pair
    prompts = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    ref = JServeEngine(cfg=jcfg, params=jparams, max_len=16,
                       cache_dtype=jnp.float32).generate(
        jnp.asarray(prompts), max_new_tokens=5)
    got = ServeEngine(cfg=tcfg, params=tparams, max_len=16,
                      cache_dtype=torch.float32, device="cpu").generate(
        torch.from_numpy(prompts), max_new_tokens=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_generate_runs_max_new_minus_one_decode_steps(monkeypatch):
    cfg = get_smoke("qwen3-1.7b")
    params = T.init_model(cfg, seed=0, device="cpu")
    calls = []
    real = LM.decode_step
    monkeypatch.setattr(LM, "decode_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    eng = ServeEngine(cfg=cfg, params=params, max_len=12, device="cpu")
    out = eng.generate(torch.zeros((1, 4), dtype=torch.long),
                       max_new_tokens=6)
    assert out.shape == (1, 6) and len(calls) == 5
    sampled = eng.generate(torch.zeros((1, 4), dtype=torch.long),
                           max_new_tokens=3, temperature=0.8,
                           generator=torch.Generator().manual_seed(0))
    assert sampled.shape == (1, 3)
    assert bool(((sampled >= 0) & (sampled < cfg.vocab_size)).all())
    with pytest.raises(ValueError, match="Generator"):
        eng.generate(torch.zeros((1, 4), dtype=torch.long),
                     max_new_tokens=2, temperature=0.8)


def test_flags_isolate_poisoned_request():
    """The contract of the reference's ``tests/test_serve.py``
    ``test_flags_isolate_poisoned_request``, held for the port: a NaN
    embedding row flags ONLY the request whose prompt uses that token, its
    tokens degrade to the in-range fallback 0, and the clean request in
    the same batch stays unflagged.  (The reference itself fails this on
    JAX 0.9.0 by flagging the clean row too, so it is held against the
    contract, not against the reference's output.)"""
    cfg = dataclasses.replace(get_smoke("qwen3-1.7b"), tie_embeddings=False)
    params = T.init_model(cfg, seed=0, device="cpu")
    with torch.no_grad():
        params["embed"]["table"][3] = float("nan")
    eng = ServeEngine(cfg=cfg, params=params, max_len=16,
                      cache_dtype=torch.float32, device="cpu")
    prompts = torch.tensor([[1, 2, 3, 4], [1, 2, 4, 5]])
    out, flags = eng.generate(prompts, max_new_tokens=4, return_flags=True)
    assert bool(flags[0]) and not bool(flags[1])
    np.testing.assert_array_equal(out[0].numpy(), 0)
    assert bool(((out >= 0) & (out < cfg.vocab_size)).all())


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    """With no GPU, the entry points raise unless the caller names the
    CPU; they never carry on quietly on the CPU."""
    from repro_torch.launch import serve as launch_serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_model(cfg, seed=0)
    params = T.init_model(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg=cfg, params=params, max_len=8)
    monkeypatch.setattr(sys, "argv", ["serve", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"layers": []}, cfg)
    from repro_torch import kernels_available
    assert kernels_available() is False


def test_launch_serve_runs_on_cpu_when_asked(monkeypatch, capsys):
    from repro_torch.launch import serve as launch_serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--smoke", "--device", "cpu", "--batch", "2",
        "--prompt-len", "5", "--new-tokens", "3"])
    launch_serve.main()
    assert "generated (2, 3) on cpu" in capsys.readouterr().out


def test_wrappers_never_fall_back_off_cpu():
    """A tensor that is neither on the CPU nor on a GPU gets no plain
    version: the wrapper raises, and counts no launch."""
    K.reset_launch_counts()
    x = torch.empty((4, 16), device="meta")
    cf = torch.empty((2, 8, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.spm_stack_kernel_call(x, cf, strides=(1, 2), n_tile=16)
    with pytest.raises(ValueError, match="no kernel"):
        K.spm_block_kernel_call(x, cf, torch.empty(16, device="meta"),
                                torch.empty(16, device="meta"),
                                strides1=(1, 2), in_width=16, mid_width=16,
                                out_width=16)
    assert K.spm_stack_kernel_call.launches == 0
    assert K.spm_block_kernel_call.launches == 0


def test_cpu_plain_path_counts_no_launch():
    cfg = get_smoke("qwen3-1.7b")
    params = T.init_model(cfg, seed=0, device="cpu")
    K.reset_launch_counts()
    ServeEngine(cfg=cfg, params=params, max_len=8, device="cpu").generate(
        torch.zeros((1, 4), dtype=torch.long), max_new_tokens=2)
    assert K.spm_stack_kernel_call.launches == 0
    assert K.spm_block_kernel_call.launches == 0


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax_and_no_repro():
    """No module of the port, nor ``chip_smoke.py``, imports ``jax`` or
    ``repro`` (AST check), and importing every module of the port in a
    fresh interpreter loads neither."""
    bad = []
    for f in _port_files():
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    bad.append(f"{f.relative_to(REPO)}: {name}")
    assert not bad, bad
    mods = [".".join(f.relative_to(REPO / "src").with_suffix("").parts)
            .removesuffix(".__init__")
            for f in _port_files()[:-1]]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "import chip_smoke\n"
            + "leak = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro')]\n"
            + "assert not leak, leak\n")
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:{REPO}")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
