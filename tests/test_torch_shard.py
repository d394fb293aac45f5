"""Parity of the port's feature-sharded SPM executor with the JAX reference,
on the CPU.

* the plan: ``plan_steps``, ``sharded_eligible``, ``cross_partner_perm``,
  ``_cross_coeff_rows`` and the step tables, bitwise;
* the windowed (``col_base``) plain versions of K1 and K2 against the
  reference's interpret-mode kernels, standalone (no mesh): live,
  straddling and dead windows, f32 and bf16, the gy window too;
* the sharded operator (forward, and the grads in x, the table, d_in,
  d_out and bias) against ``repro.parallel.spm_shard.spm_apply_sharded``
  under a mesh of 4 host devices.  The JAX side runs in a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (this file run as
  a script), as ``tests/test_distributed.py`` runs its worker;
* the sharded port against the unsharded port and unsharded ``repro``;
* three training steps of ``with_feature_sharding(SMOKE, 4)`` under a
  4-shard CPU mesh against the reference's under its 4-device mesh, and
  the same converted params giving the same logits sharded and unsharded.

Inputs come from numpy with fixed seeds.  Tolerances are derived as in
``tests/test_torch_grad.py``: ``depth`` dependent f32 roundings plus the
I/O roundings, at the reference's scale, times 8; a parameter grad sums
one term per row on top.  The reference's bf16 cross mix rounds after each
operation (its CPU run keeps no excess precision there), so with the
kernel path off the bf16 operator is held bit for bit.
"""

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
    with_feature_sharding as j_with_feature_sharding)
from repro.core import eligibility as J_el  # noqa: E402
from repro.core import pairings as J_pair  # noqa: E402
from repro.core import spm as J_spm  # noqa: E402
from repro.kernels import spm_stack as J_K  # noqa: E402
from repro.models import causal_lm as J_LM  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.optim import adamw as J_opt  # noqa: E402
from repro.parallel import spm_shard as J_sh  # noqa: E402
from repro.parallel.ctx import activation_sharding as j_sharding  # noqa: E402
from repro.train import make_train_state as j_make_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402

N_DEV = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
EPS = {"f32": EPS32, "bf16": 2.0 ** -7}
TRAIN_STEPS = 3
TRAIN_BATCH, TRAIN_SEQ = 4, 16
OPT = dict(lr=1e-2, total_steps=3, warmup_steps=1)

# id: (n, L, dtype, use_kernel, in_width, out_width, rows).  Every case
# has 4 shards.  n=64 L=6: local (1,2,4,8), cross k=1, cross k=2 (ends on
# a cross stage: d_out and bias fold into the mix); n=64 L=7 adds a final
# local run (they fold into K1); n=96 L=7 is the smoke FFN: a windowed
# first run when in_width=64, ending on cross k=1.
OP_CASES = {
    "square-kernel": (64, 6, "f32", True, None, None, 12),
    "square-compose": (64, 6, "f32", False, None, None, 12),
    "ffn-up-kernel": (96, 7, "f32", True, 64, None, 12),
    "ffn-up-compose": (96, 7, "f32", False, 64, None, 12),
    "ffn-down-kernel": (96, 7, "f32", True, None, 64, 12),
    "rect-kernel": (64, 7, "f32", True, 50, 40, 12),
    "rect-compose": (64, 7, "f32", False, 50, 40, 12),
    "ffn-up-bf16-compose": (96, 7, "bf16", False, 64, None, 12),
    "rect-bf16-kernel": (64, 7, "bf16", True, 50, 40, 12),
}


def _op_inputs(case):
    """The numpy operands of an operator case, from a seed."""
    n, L, _, _, in_w, out_w, rows = OP_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    return dict(
        mix=(0.6 * rng.standard_normal((L, n // 2, 4))).astype(np.float32),
        d_in=(1 + 0.1 * rng.standard_normal(n)).astype(np.float32),
        d_out=(1 + 0.1 * rng.standard_normal(n)).astype(np.float32),
        bias=(0.1 * rng.standard_normal(n)).astype(np.float32),
        x=rng.standard_normal((rows, in_w or n)).astype(np.float32),
        gy=rng.standard_normal((rows, out_w or n)).astype(np.float32))


def _j_cfg(case):
    n, L, _, uk, _, _, _ = OP_CASES[case]
    return J_spm.SPMConfig(n=n, n_stages=L, schedule="two_level",
                           n_shards=N_DEV, backward="custom",
                           use_kernel=uk, overlap=False)


def _j_train_cfg():
    cfg = dataclasses.replace(j_get_smoke("qwen3-1.7b", use_kernel=True),
                              spm_block_fuse=True)
    return j_with_feature_sharding(cfg, N_DEV)


# ---------------------------------------------------------------------------
# the reference's side, run as a script under 4 forced host devices
# ---------------------------------------------------------------------------

def _worker(inputs_path: str, out_path: str) -> None:
    from jax.sharding import Mesh
    assert jax.device_count() == N_DEV, jax.device_count()
    mesh = Mesh(np.asarray(jax.devices()[:N_DEV]), ("model",))
    out = {}
    for case, (n, L, dt, uk, in_w, out_w, rows) in OP_CASES.items():
        a = _op_inputs(case)
        jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
        cfg = _j_cfg(case)
        p = {k: jnp.asarray(a[k]) for k in ("mix", "d_in", "d_out", "bias")}
        x = jnp.asarray(a["x"], jdt)

        def f(p, x, cfg=cfg, in_w=in_w, out_w=out_w):
            return J_spm.spm_apply(p, x, cfg, in_width=in_w, out_width=out_w)

        with j_sharding(mesh, shard_feature=True):
            y, vjp = jax.vjp(jax.jit(f), p, x)
            gp, gx = vjp(jnp.asarray(a["gy"], jdt))
        out[f"{case}/y"] = np.asarray(y.astype(jnp.float32))
        out[f"{case}/gx"] = np.asarray(gx.astype(jnp.float32))
        for k, v in gp.items():
            out[f"{case}/g_{k}"] = np.asarray(v, np.float32)

    jcfg = _j_train_cfg()
    batches = np.load(inputs_path)
    state = j_make_state(J_T.init_model(jax.random.PRNGKey(0), jcfg))
    step = jax.jit(j_make_step(lambda p, b: J_LM.lm_loss(p, b, jcfg),
                               J_opt.OptimizerConfig(**OPT),
                               chaos_guard=True))
    with j_sharding(mesh, shard_feature=True):
        for s in range(TRAIN_STEPS):
            jb = {k: jnp.asarray(batches[f"{k}{s}"], jnp.int32)
                  for k in ("tokens", "labels")}
            if s == 0:
                g = jax.jit(jax.grad(
                    lambda p: J_LM.lm_loss(p, jb, jcfg)[0]))(state["params"])
                for i, leaf in enumerate(jax.tree.leaves(g)):
                    out[f"train/grad0/{i}"] = np.asarray(leaf)
            state, m = step(state, jb, 0.0)
            for k in ("loss", "grad_norm", "skipped"):
                out[f"train/{k}{s}"] = np.asarray(m[k])
            for i, leaf in enumerate(jax.tree.leaves(state["params"])):
                out[f"train/params{s}/{i}"] = np.asarray(leaf)
    np.savez(out_path, **out)


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

from repro_torch.configs import (get_smoke,  # noqa: E402
                                 with_feature_sharding)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import eligibility as T_el  # noqa: E402
from repro_torch.core import pairings as T_pair  # noqa: E402
from repro_torch.core import spm as T_spm  # noqa: E402
from repro_torch.data import DeterministicLoader, build_corpus  # noqa: E402
from repro_torch.kernels import spm_stack as K  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import causal_lm as LM  # noqa: E402
from repro_torch.optim import adamw as T_opt  # noqa: E402
from repro_torch.parallel import (activation_sharding,  # noqa: E402
                                  make_feature_mesh)
from repro_torch.parallel import spm_shard as T_sh  # noqa: E402
from repro_torch.params import Params  # noqa: E402
from repro_torch.train import make_train_state, make_train_step  # noqa: E402

TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _tol(dtype, depth, ref, io_roundings=1):
    """Derived bound: ``depth`` f32 roundings plus ``io_roundings``
    roundings to the I/O dtype, at the reference's scale, times 8."""
    scale = float(np.max(np.abs(ref))) + 1.0
    return 8 * (depth * EPS32 + io_roundings * EPS[dtype]) * scale


def _close(got, ref, dtype, depth, io_roundings=1, err_msg=""):
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, (got.shape, ref.shape, err_msg)
    np.testing.assert_allclose(got, ref, rtol=0, err_msg=err_msg,
                               atol=_tol(dtype, depth, ref, io_roundings))


def _cpu_mesh():
    return make_feature_mesh(N_DEV, device="cpu")


def _flat(tree) -> dict:
    return {k: v.detach().clone() for k, v in tree.state_dict().items()}


def _port_params(jparams, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                           device="cpu")


def _train_batches():
    tcfg = with_feature_sharding(get_smoke("qwen3-1.7b"), N_DEV)
    loader = DeterministicLoader(
        launch_train.make_batch_fn(tcfg, TRAIN_SEQ,
                                   build_corpus(20_000, seed=0)),
        TRAIN_BATCH, seed=0)
    return [loader.batch_at(s) for s in range(TRAIN_STEPS)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded results (``_worker``), computed once."""
    d = tmp_path_factory.mktemp("shard_ref")
    inputs = {f"{k}{s}": b[k].numpy() for s, b in enumerate(_train_batches())
              for k in ("tokens", "labels")}
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + f" --xla_force_host_platform_device_count={N_DEV}")
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


# ---------------------------------------------------------------------------
# the plan, bitwise
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(64, 6, 4), (64, 7, 4), (96, 7, 4), (48, 6, 4), (64, 8, 8),
               (2048, 11, 4), (6144, 12, 4), (256, 8, 8), (32, 5, 2)]


@pytest.mark.parametrize("n,L,S", PLAN_SHAPES)
def test_plan_steps_and_tables_match_reference(n, L, S):
    """The two_level schedule's steps, the cross partners and rows, and
    the per-step tables (and their grads' scatter into the coefficients)
    equal the reference's bit for bit."""
    strides = T_pair.make_schedule("two_level", n, L, n_shards=S).strides()
    assert strides == J_pair.make_schedule("two_level", n, L,
                                           n_shards=S).strides()
    steps = T_el.plan_steps(n, strides, S)
    assert steps == J_el.plan_steps(n, strides, S)
    n_local = n // S
    for step in steps:
        if step[0] == "cross":
            k = step[2]
            assert (T_sh.cross_partner_perm(S, k)
                    == J_sh.cross_partner_perm(S, k))
            np.testing.assert_array_equal(
                T_sh._cross_coeff_rows(S, n_local, k),
                J_sh._cross_coeff_rows(S, n_local, k))
    rng = np.random.default_rng(n + L)
    cf = rng.standard_normal((L, n // 2, 4)).astype(np.float32)
    jt = J_sh._step_tables(jnp.asarray(cf), steps, S, n_local)
    tcf = torch.from_numpy(cf).requires_grad_(True)
    tt = T_sh._step_tables(tcf, steps, S, n_local)
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    # the transpose: partner partials scatter-add into the shared rows
    cots = [rng.standard_normal(a.shape).astype(np.float32) for a in tt]
    _, vjp = jax.vjp(lambda c: J_sh._step_tables(c, steps, S, n_local),
                     jnp.asarray(cf))
    (jg,) = vjp(tuple(jnp.asarray(c) for c in cots))
    (tg,) = torch.autograd.grad(tt, [tcf], [torch.from_numpy(c)
                                            for c in cots])
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("n,L,S,sched,backward", [
    (64, 6, 4, "two_level", "custom"), (96, 7, 4, "two_level", "custom"),
    (64, 6, 1, "two_level", "custom"), (64, 6, 3, "two_level", "custom"),
    (64, 6, 4, "random", "custom"), (65, 6, 4, "two_level", "custom"),
    (64, 6, 4, "two_level", "custom_inverse"),
    (64, 6, 4, "butterfly", "custom"), (48, 6, 8, "two_level", "custom")])
def test_sharded_eligible_matches_reference(n, L, S, sched, backward):
    variant = "rotation" if backward == "custom_inverse" else "general"
    kw = dict(n=n, n_stages=L, schedule=sched, n_shards=S,
              backward=backward, variant=variant)
    tcfg, jcfg = T_spm.SPMConfig(**kw), J_spm.SPMConfig(**kw)
    assert T_el.sharded_eligible(tcfg) == J_el.sharded_eligible(jcfg)
    if T_el.sharded_eligible(tcfg):
        steps = T_el.plan_steps(n, tcfg.pairing.strides(), S)
        # the port's auto is the kernel path: the reference forced on
        for uk in (None, True, False):
            want = J_el.resolve_shard_kernel(
                dataclasses.replace(jcfg, use_kernel=uk), steps, True)
            got = T_el.resolve_shard_kernel(
                dataclasses.replace(tcfg, use_kernel=uk), steps)
            assert got == want


def test_plan_steps_rejects_what_the_reference_rejects():
    for n, strides, S in [(64, (1, 48), 4), (96, (1, 36), 4), (64, (3,), 4),
                          (64, (1,), 3)]:
        with pytest.raises(ValueError):
            J_el.plan_steps(n, strides, S)
        with pytest.raises(ValueError):
            T_el.plan_steps(n, strides, S)


# ---------------------------------------------------------------------------
# the windowed plain versions against the interpret-mode kernels
# ---------------------------------------------------------------------------

WIN_N, WIN_NT, WIN_IN, WIN_ROWS = 32, 16, 40, 8
WIN_STRIDES = (1, 2, 4, 8)
# base tile 0: live; 2: straddles in_width=40 (columns 32-63); 4: dead
WIN_BASES = {"live": 0, "straddle": 2, "dead": 4}


def _win_operands(base, gy_width=None):
    rng = np.random.default_rng(base + 7)
    L = len(WIN_STRIDES)
    cf = (0.6 * rng.standard_normal((L, WIN_N // 2, 4))).astype(np.float32)
    d_in, d_out, bias = (
        (1 + 0.1 * rng.standard_normal(WIN_N)).astype(np.float32)
        for _ in range(3))
    x = rng.standard_normal((WIN_ROWS, WIN_IN)).astype(np.float32)
    gy = rng.standard_normal((WIN_ROWS, gy_width or WIN_N)).astype(
        np.float32)
    return cf, d_in, d_out, bias, x, gy


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", list(WIN_BASES))
def test_k1_window_plain_matches_interpret_kernel(window, dtype):
    """K1's windowed read: the shard's (rows, n_local) slab from the global
    (rows, in_width) x at base tile ``col_base``; a dead window comes out
    exactly ``bias``."""
    base = WIN_BASES[window]
    cf, d_in, d_out, bias, x, _ = _win_operands(base)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    ref = np.asarray(J_K.spm_stack_kernel_call(
        jnp.asarray(x, jdt), jnp.asarray(cf), jnp.asarray(d_in),
        jnp.asarray(d_out), jnp.asarray(bias),
        jnp.asarray([base], jnp.int32), strides=WIN_STRIDES,
        block_rows=WIN_ROWS, n_tile=WIN_NT, in_width=WIN_IN,
        interpret=True).astype(jnp.float32))
    got = K.spm_stack_kernel_call(
        torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(cf),
        torch.from_numpy(d_in), torch.from_numpy(d_out),
        torch.from_numpy(bias), strides=WIN_STRIDES, n_tile=WIN_NT,
        in_width=WIN_IN, col_base=base)
    assert got.dtype == TDT[dtype] and got.shape == (WIN_ROWS, WIN_N)
    _close(got, ref, dtype, 3 * len(WIN_STRIDES) + 3)
    if window == "dead":
        want = torch.from_numpy(bias).to(TDT[dtype]).expand(WIN_ROWS, -1)
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("reads", ["x", "x-and-gy", "gy"])
@pytest.mark.parametrize("window", list(WIN_BASES))
def test_k2_window_plain_matches_interpret_kernel(window, reads, dtype):
    """K2's windowed remat of x (``in_width``) and its windowed gy read
    (``out_width``), apart and together: g_x is the shard's full slab;
    every grad on lanes past a global width that multiplies by x (or by
    gy) is exactly zero."""
    base = WIN_BASES[window]
    out_w = 44 if "gy" in reads else None
    in_w = WIN_IN if "x" in reads else None
    cf, d_in, d_out, _, x, gy = _win_operands(base, out_w)
    if in_w is None:                # x is the shard's own slab
        x = np.random.default_rng(base).standard_normal(
            (WIN_ROWS, WIN_N)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    kw = dict(strides=WIN_STRIDES, n_tile=WIN_NT, has_bias=True,
              in_width=in_w, out_width=out_w)
    ref = J_K.spm_stack_bwd_kernel_call(
        jnp.asarray(x, jdt), jnp.asarray(cf), jnp.asarray(gy, jdt),
        jnp.asarray(d_in), jnp.asarray(d_out),
        jnp.asarray([base], jnp.int32), block_rows=WIN_ROWS,
        interpret=True, **kw)
    ref = [np.asarray(jnp.asarray(r, jnp.float32)).reshape(np.shape(r))
           for r in ref]
    got = K.spm_stack_bwd_kernel_call(
        torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(cf),
        torch.from_numpy(gy).to(TDT[dtype]), torch.from_numpy(d_in),
        torch.from_numpy(d_out), col_base=base, **kw)
    assert len(got) == len(ref) == 5
    assert got[0].shape == (WIN_ROWS, WIN_N) and got[0].dtype == TDT[dtype]
    depth = 6 * len(WIN_STRIDES) + 3
    _close(got[0], ref[0], dtype, depth)
    for g, r in zip(got[1:], ref[1:]):
        _close(g, r.reshape(g.shape), dtype, depth + WIN_ROWS)
    if in_w is not None:            # g_din on lanes past the global width
        assert not got[2][max(0, in_w - base * WIN_NT):].any()
        if window == "dead":        # x all zero: no pair grad at all
            assert not got[1].any()
    if out_w is not None:           # g_dout, g_bias past the global width
        live = max(0, out_w - base * WIN_NT)
        assert not got[3][live:].any() and not got[4][live:].any()


# ---------------------------------------------------------------------------
# the sharded operator against the reference's, under 4 host devices
# ---------------------------------------------------------------------------

def _port_op(case, mesh=None):
    """The port's operator (sharded under ``mesh``, else unsharded) and
    its grads from the case's numpy operands."""
    n, L, dt, uk, in_w, out_w, rows = OP_CASES[case]
    a = _op_inputs(case)
    cfg = T_spm.SPMConfig(n=n, n_stages=L, schedule="two_level",
                          n_shards=N_DEV, backward="custom", use_kernel=uk)
    p = Params({k: torch.from_numpy(a[k]) for k in
                ("mix", "d_in", "d_out", "bias")})
    for v in p.parameters():
        v.requires_grad_(True)
    x = torch.from_numpy(a["x"]).to(TDT[dt]).requires_grad_(True)
    if mesh is None:
        y = T_spm.spm_apply(p, x, cfg, in_width=in_w, out_width=out_w)
    else:
        with activation_sharding(mesh, shard_feature=True):
            y = T_spm.spm_apply(p, x, cfg, in_width=in_w, out_width=out_w)
    names = ["x", "mix", "d_in", "d_out", "bias"]
    grads = torch.autograd.grad(
        y, [x] + [p[k] for k in names[1:]],
        torch.from_numpy(a["gy"]).to(TDT[dt]))
    return y, dict(zip(names, grads))


@pytest.mark.parametrize("case", list(OP_CASES))
def test_sharded_operator_matches_reference(reference, case):
    """Forward and every grad against ``spm_apply_sharded`` under the
    reference's 4-device mesh.  Depth: the operator's L stages at 3
    roundings each plus the diagonals and bias, twice for the backward; a
    parameter grad adds its rows.  bf16: one I/O rounding per step's
    stored slab.  With the kernel path off the bf16 operator rounds after
    every operation on both sides: y and g_x are held bit for bit."""
    n, L, dt, uk, in_w, out_w, rows = OP_CASES[case]
    y, g = _port_op(case, _cpu_mesh())
    steps = T_el.plan_steps(n, T_pair.make_schedule(
        "two_level", n, L, n_shards=N_DEV).strides(), N_DEV)
    io = len(steps) + 1
    depth = 3 * L + 3
    r = {k.split("/", 1)[1]: v for k, v in reference.items()
         if k.startswith(case + "/")}
    assert y.dtype == TDT[dt]
    _close(y, r["y"], dt, depth, io, "y")
    _close(g["x"], r["gx"], dt, 2 * depth, 2 * io, "g_x")
    for k in ("mix", "d_in", "d_out", "bias"):
        _close(g[k], r[f"g_{k}"], dt, 2 * depth + rows, 2 * io, f"g_{k}")
    if dt == "bf16" and not uk:
        np.testing.assert_array_equal(y.detach().float().numpy(), r["y"])
        np.testing.assert_array_equal(g["x"].float().numpy(), r["gx"])
    if in_w is not None:             # no lane past in_width reaches d_in
        assert not g["d_in"][in_w:].any()


@pytest.mark.parametrize("case", [c for c in OP_CASES
                                  if OP_CASES[c][2] == "f32"])
def test_sharded_matches_unsharded_port_and_reference(case):
    """In f32 the sharded port equals the unsharded port (the same stages
    in another grouping) and the unsharded reference within the
    operator's depth; the sharded forward with the kernel path on is the
    unsharded one bit for bit (the kernels and the mix round alike)."""
    n, L, _, uk, in_w, out_w, rows = OP_CASES[case]
    y_sh, g_sh = _port_op(case, _cpu_mesh())
    y_un, g_un = _port_op(case)
    a = _op_inputs(case)
    jcfg = _j_cfg(case)
    jp = {k: jnp.asarray(a[k]) for k in ("mix", "d_in", "d_out", "bias")}
    y_j, vjp = jax.vjp(lambda p, x: J_spm.spm_apply(
        p, x, jcfg, in_width=in_w, out_width=out_w), jp,
        jnp.asarray(a["x"]))
    gp_j, gx_j = vjp(jnp.asarray(a["gy"]))
    depth = 3 * L + 3
    _close(y_sh, y_un.detach().numpy(), "f32", depth, 0)
    _close(y_sh, np.asarray(y_j), "f32", depth, 0)
    if uk:
        assert torch.equal(y_sh, y_un)
    _close(g_sh["x"], np.asarray(gx_j), "f32", 2 * depth, 0)
    for k in ("x", "mix", "d_in", "d_out", "bias"):
        _close(g_sh[k], g_un[k].numpy(), "f32", 2 * depth + rows, 0, k)
        if k != "x":
            _close(g_sh[k], np.asarray(gp_j[k]), "f32", 2 * depth + rows, 0,
                   k)


def test_cpu_mesh_runs_plain_versions_only():
    """On CPU shards the sharded path launches no kernel (every wrapper
    runs its plain version), and a mesh of another size leaves the
    operator unsharded."""
    K.reset_launch_counts()
    _port_op("rect-kernel", _cpu_mesh())
    assert K.spm_stack_kernel_call.launches == 0
    assert K.spm_stack_bwd_kernel_call.launches == 0
    cfg = T_spm.SPMConfig(n=64, n_stages=6, schedule="two_level",
                          n_shards=4)
    from repro_torch.parallel import ctx
    with activation_sharding(make_feature_mesh(2, device="cpu"),
                             shard_feature=True):
        assert ctx.feature_mesh(cfg.n_shards) is None
    with activation_sharding(_cpu_mesh()):
        assert ctx.feature_mesh(cfg.n_shards) is None


@pytest.mark.parametrize("mesh_devs, x_dev", [
    (("cpu",) * N_DEV, "meta"), (("meta",) * N_DEV, "cpu"),
    (("cpu", "meta", "cpu", "cpu"), "cpu")])
def test_mesh_off_the_input_device_raises(mesh_devs, x_dev):
    """Every shard must be on the input's device: a mesh that places one
    elsewhere raises, so no shard's work moves off the input's device."""
    from repro_torch.parallel.ctx import FeatureMesh
    cfg = T_spm.SPMConfig(n=64, n_stages=6, schedule="two_level",
                          n_shards=N_DEV, backward="custom")
    p = T_spm.init_spm(cfg, torch.Generator().manual_seed(0),
                       torch.device("cpu"))
    x = torch.zeros(3, 64, device=x_dev)
    mesh = FeatureMesh(tuple(torch.device(d) for d in mesh_devs))
    with activation_sharding(mesh, shard_feature=True):
        with pytest.raises(ValueError, match="input's device"):
            T_spm.spm_apply(p, x, cfg)


@pytest.mark.parametrize("S,k", [(2, 1), (4, 1), (4, 2), (8, 4)])
def test_exchange_follows_cross_partner_perm(S, k):
    """The executor's hand-over gives shard j the slab of its partner in
    the reference's ``cross_partner_perm``."""
    slabs = [torch.full((2, 3), float(j)) for j in range(S)]
    got = T_sh._exchange(slabs, k)
    for (j, p), g in zip(J_sh.cross_partner_perm(S, k), got):
        assert g is slabs[p], (j, p)


def test_feature_mesh_has_no_data_axes():
    """Rows shard over no axis of a feature mesh, as over the reference's
    one-axis ``("model",)`` mesh."""
    from jax.sharding import Mesh

    from repro.parallel import sharding as J_shd
    from repro_torch.parallel import data_axes
    jmesh = Mesh(np.asarray(jax.devices()[:1]), ("model",))
    assert data_axes(_cpu_mesh()) == J_shd.data_axes(jmesh) == ()


# ---------------------------------------------------------------------------
# the sharded smoke model
# ---------------------------------------------------------------------------

def _model_depth(cfg) -> int:
    """Dependent f32 roundings through the smoke model's forward, as
    ``tests/test_torch_train.py`` counts them (the attention linears have
    6 stages and the FFN's 7 under the two_level schedule too)."""
    L_attn, L_ffn = 6, 7
    per_layer = (cfg.d_model + 3 * L_attn + 8 + cfg.head_dim + 32
                 + 3 * L_attn + 3 * (3 * L_ffn + 4) + cfg.d_model)
    return cfg.n_layers * per_layer + 2 * cfg.d_model


def test_converted_params_give_the_same_logits_sharded_and_not(
        monkeypatch):
    """``convert.params_from_jax`` carries the reference's params to the
    port with no new leaf: the sharded operator reads the same (L, n/2, 4)
    tables, so the same converted params give the same logits with the
    4-shard mesh on and off, within the model's f32 depth; no linear
    block-fuses and every SPM linear runs sharded."""
    from repro_torch.models import transformer as T
    jcfg = _j_train_cfg()
    tcfg = with_feature_sharding(get_smoke("qwen3-1.7b"), N_DEV)
    params = _port_params(J_T.init_model(jax.random.PRNGKey(0), jcfg), tcfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 12)))
    calls = []
    orig = T_sh.spm_apply_sharded

    def spy(*a, **kw):
        calls.append(a[2].n)
        return orig(*a, **kw)

    monkeypatch.setattr(T_sh, "spm_apply_sharded", spy)
    K.reset_launch_counts()
    with torch.no_grad():
        un = T.forward(params, tcfg, tokens=toks)[0]
        assert not calls
        with activation_sharding(_cpu_mesh(), shard_feature=True):
            sh = T.forward(params, tcfg, tokens=toks)[0]
    assert K.spm_block_kernel_call.launches == 0
    # q, k, v, o (n=64) and gate, up, down (n=96) in each of 2 layers
    assert sorted(calls) == sorted([64] * 8 + [96] * 6)
    rel = 8 * _model_depth(tcfg) * EPS32
    np.testing.assert_allclose(sh.numpy(), un.numpy(), rtol=0,
                               atol=rel * (float(un.abs().max()) + 1))


def test_three_sharded_smoke_steps_match_reference(reference):
    """Three steps of ``with_feature_sharding(SMOKE, 4)``, the port under a
    4-shard CPU mesh and the reference under its 4-device mesh, the same
    batches: the loss and grad norm at each step, the step-0 grads of
    every leaf and the params after each step, held as
    ``tests/test_torch_train.py`` holds the unsharded steps."""
    jcfg = _j_train_cfg()
    tcfg = with_feature_sharding(get_smoke("qwen3-1.7b"), N_DEV)
    jparams = J_T.init_model(jax.random.PRNGKey(0), jcfg)
    treedef = jax.tree.structure(jparams)
    n_leaves = treedef.num_leaves

    def ref_tree(prefix):
        leaves = [reference[f"{prefix}/{i}"] for i in range(n_leaves)]
        return _flat(params_from_jax(jax.tree.unflatten(treedef, leaves),
                                     tcfg, device="cpu"))

    state = make_train_state(_port_params(jparams, tcfg))
    p0 = _flat(state["params"])
    step = make_train_step(lambda p, b: LM.lm_loss(p, b, tcfg),
                           T_opt.OptimizerConfig(**OPT), chaos_guard=True)
    rel = 8 * 2 * _model_depth(tcfg) * EPS32      # forward and backward
    with activation_sharding(_cpu_mesh(), shard_feature=True):
        for s, batch in enumerate(_train_batches()):
            if s == 0:
                jg = ref_tree("train/grad0")
                loss, _ = LM.lm_loss(state["params"], batch, tcfg)
                loss.backward()
                for k, p in state["params"].named_parameters():
                    np.testing.assert_allclose(
                        p.grad.numpy(), jg[k].numpy(), rtol=0,
                        atol=rel * (float(jg[k].abs().max()) + 1e-6),
                        err_msg=k)
            state, m = step(state, batch, 0.0)
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(
                    float(m[k]), float(reference[f"train/{k}{s}"]),
                    rtol=rel, err_msg=f"step {s} {k}")
            assert float(m["skipped"]) == 0.0
            assert float(reference[f"train/skipped{s}"]) == 0.0
            ref = ref_tree(f"train/params{s}")
            got = _flat(state["params"])
            diff = sum(float(((got[k] - ref[k]) ** 2).sum())
                       for k in ref) ** .5
            moved = sum(float(((ref[k] - p0[k]) ** 2).sum())
                        for k in ref) ** .5
            assert diff <= rel * moved, (s, diff, moved)


def test_checkpoint_recompute_keeps_the_forward_context():
    """A checkpointed layer's recompute routes every linear as its forward
    did, whichever thread runs it: on the card the autograd engine's own
    thread recomputes, where the caller's context is not set.  Here the
    backward runs outside the context: the grads must equal those of a
    backward inside it, and the sharded executor must run in both."""
    from repro_torch.models import transformer as T
    tcfg = with_feature_sharding(get_smoke("qwen3-1.7b"), N_DEV)
    assert tcfg.remat
    batch = _train_batches()[0]
    grads = []
    for inside in (True, False):
        params = T.init_model(tcfg, seed=0, device="cpu")
        for p in params.parameters():
            p.requires_grad_(True)
        with activation_sharding(_cpu_mesh(), shard_feature=True):
            loss, _ = LM.lm_loss(params, batch, tcfg)
            if inside:
                loss.backward()
        if not inside:
            loss.backward()
        grads.append({k: p.grad.clone() for k, p in
                      params.named_parameters()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k
