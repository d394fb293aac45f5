"""The MoE archs under the reference's int8 and feature-sharding knobs, on
the CPU, against the JAX reference, whose expert linears run under
``jax.vmap`` over the expert axis.

* K1's and K2's int8 expert mode (plain versions, through the wrappers)
  against the reference's interpret-mode kernels under ``jax.vmap``, with
  a row count that is not a multiple of the scale block: each expert's
  rows are padded and scaled on their own.  A planted fault that scales
  the experts' rows as one flattened operand must fail;
* ``spm_stack_fused`` on an expert table with ``quant_acts`` and
  ``quant_coeffs`` against ``jax.vjp`` of the reference's under vmap;
* the stacked expert operator under a 4-shard mesh, step-serial and
  overlap, with and without int8 tables: forward and the grads in x, the
  table, d_in, d_out and bias against ``spm_apply`` of the reference
  under vmap inside its 4-device mesh (its ``spm_apply_sharded``).  The
  reference runs in a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (this file run
  as a script), as ``tests/test_torch_shard.py`` runs it;
* the smoke ``qwen3-moe-30b-a3b`` under ``with_quantized_io`` (logits and
  one training step, code flips counted) and under
  ``with_feature_sharding`` (logits), and ``launch.train --quantize``.

Inputs come from numpy with fixed seeds.  Tolerances are derived as in
``tests/test_torch_quant.py`` (f32 depth bounds, one int8 step for each
code that differs from the reference's, each flip of exactly one) and
``tests/test_torch_shard.py`` (the operator's depth, a parameter grad's
rows on top).
"""

import math
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
from repro.configs.base import with_quantized_io as j_quantized  # noqa: E402
from repro.core import spm as J_spm  # noqa: E402
from repro.kernels import ops as J_ops  # noqa: E402
from repro.kernels import quant as J_Q  # noqa: E402
from repro.kernels import spm_stack as J_K  # noqa: E402
from repro.models import causal_lm as J_LM  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.parallel.ctx import activation_sharding as j_sharding  # noqa: E402

N_DEV = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
STEP = 1.0 / 127.0          # one int8 step, relative to its block's absmax
E_OP = 3                    # experts of the operator cases
PARAMS = ("mix", "d_in", "d_out", "bias")

# id: (n, L, in_width, out_width, overlap, quant_coeffs, rows a expert).
# 4 shards: n=64 L=6 is local (1,2,4,8), cross k=1, cross k=2; n=96 L=7
# the smoke FFN (a windowed first run when in_width=64, ending on cross
# k=1); n=64 L=7 adds a last local run.  On the overlap schedule the
# first {local -> cross} pair takes the row blocks of one expert's rows.
SH_CASES = {
    "serial-square": (64, 6, None, None, False, False, 12),
    "serial-rect-int8": (96, 7, 64, None, False, True, 12),
    "serial-down": (96, 7, None, 64, False, False, 10),
    "overlap-rect": (64, 7, 50, 40, True, False, 12),
    "overlap-rect-int8": (96, 7, 64, None, True, True, 12),
}
SMOKE_TOKENS = (2, 12)


def _sh_inputs(case):
    """The numpy operands of a sharded expert case, from a seed."""
    n, L, in_w, out_w, _, _, rows = SH_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))

    def f32(a):
        return a.astype(np.float32)
    return dict(
        mix=f32(0.6 * rng.standard_normal((E_OP, L, n // 2, 4))),
        d_in=f32(1 + 0.1 * rng.standard_normal((E_OP, n))),
        d_out=f32(1 + 0.1 * rng.standard_normal((E_OP, n))),
        bias=f32(0.1 * rng.standard_normal((E_OP, n))),
        x=f32(rng.standard_normal((E_OP, rows, in_w or n))),
        gy=f32(rng.standard_normal((E_OP, rows, out_w or n))))


def _j_sh_cfg(case):
    n, L, _, _, overlap, q, _ = SH_CASES[case]
    return J_spm.SPMConfig(n=n, n_stages=L, schedule="two_level",
                           n_shards=N_DEV, backward="custom",
                           use_kernel=True, overlap=overlap, quant_coeffs=q)


def _j_smoke_sharded():
    return j_with_feature_sharding(
        j_get_smoke("qwen3-moe-30b-a3b", use_kernel=True), N_DEV)


def _smoke_tokens(vocab):
    return np.random.default_rng(5).integers(0, vocab, SMOKE_TOKENS)


# ---------------------------------------------------------------------------
# the reference's side, run as a script under 4 forced host devices
# ---------------------------------------------------------------------------

def _worker(out_path: str) -> None:
    from jax.sharding import Mesh
    assert jax.device_count() == N_DEV, jax.device_count()
    mesh = Mesh(np.asarray(jax.devices()[:N_DEV]), ("model",))
    out = {}
    for case, (n, L, in_w, out_w, _, _, _) in SH_CASES.items():
        a = _sh_inputs(case)
        cfg = _j_sh_cfg(case)
        p = {k: jnp.asarray(a[k]) for k in PARAMS}

        def f(p, x, cfg=cfg, in_w=in_w, out_w=out_w):
            return jax.vmap(lambda pe, xe: J_spm.spm_apply(
                pe, xe, cfg, in_width=in_w, out_width=out_w))(p, x)

        with j_sharding(mesh, shard_feature=True):
            y, vjp = jax.vjp(jax.jit(f), p, jnp.asarray(a["x"]))
            gp, gx = vjp(jnp.asarray(a["gy"]))
        out[f"{case}/y"] = np.asarray(y)
        out[f"{case}/gx"] = np.asarray(gx)
        for k, v in gp.items():
            out[f"{case}/g_{k}"] = np.asarray(v)
    jcfg = _j_smoke_sharded()
    jp = J_T.init_model(jax.random.PRNGKey(0), jcfg)
    toks = jnp.asarray(_smoke_tokens(jcfg.vocab_size))
    with j_sharding(mesh, shard_feature=True):
        out["smoke/logits"] = np.asarray(jax.jit(
            lambda p, t: J_T.forward(p, jcfg, tokens=t)[0])(jp, toks))
    np.savez(out_path, **out)


if __name__ == "__main__":
    _worker(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

from repro_torch.configs import (get_smoke, with_feature_sharding,  # noqa: E402
                                 with_quantized_io)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import spm as T_spm  # noqa: E402
from repro_torch.core.eligibility import quant_acts_eligible  # noqa: E402
from repro_torch.core.pairings import default_n_stages  # noqa: E402
from repro_torch.data import DeterministicLoader, build_corpus  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.kernels import quant as Q  # noqa: E402
from repro_torch.kernels import spm_stack as K  # noqa: E402
from repro_torch.kernels.codes import CodeTape  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import causal_lm as LM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw as T_opt  # noqa: E402
from repro_torch.parallel import (activation_sharding,  # noqa: E402
                                  make_feature_mesh)
from repro_torch.parallel import spm_shard as T_sh  # noqa: E402
from repro_torch.params import Params  # noqa: E402
from repro_torch.train import make_train_state, make_train_step  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.detach().float().numpy()


def _jdt(dtype):
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]


def _rot(rng, lead, L, n, noise=0.05):
    """Random rotations plus noise, as ``init_spm`` draws them."""
    th = rng.uniform(-np.pi, np.pi, (*lead, L, n // 2))
    c, s = np.cos(th), np.sin(th)
    base = np.stack([c, -s, s, c], axis=-1)
    return (base + noise * rng.standard_normal(base.shape)).astype(
        np.float32)


def _bound(depth, ref, io_eps=0.0):
    """``depth`` f32 roundings plus one I/O rounding, at the reference's
    scale, times 8."""
    return 8 * (depth * EPS32 + io_eps) * (float(np.abs(ref).max()) + 1)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded results (``_worker``), computed once."""
    d = tmp_path_factory.mktemp("moe_modes_ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + f" --xla_force_host_platform_device_count={N_DEV}")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = (os.path.join(REPO, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(d / "ref.npz")],
        capture_output=True, text=True, timeout=900, cwd=REPO, env=env)
    assert r.returncode == 0, (f"reference worker failed (rc={r.returncode})"
                               f":\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    return dict(np.load(d / "ref.npz"))


# ---------------------------------------------------------------------------
# K1 / K2 int8 expert mode against the interpret-mode kernels under vmap
# ---------------------------------------------------------------------------

# n, n_tile, strides, rows a expert (not a multiple of 8), scale rows,
# in_width, out_width
Q_CASE = (32, 16, (1, 2, 4, 8), 12, 8, 20, 12)


def _q_case():
    n, nt, strides, rows, sr, in_w, out_w = Q_CASE
    rng = np.random.default_rng(11)
    L = len(strides)
    x = rng.standard_normal((E_OP, rows, in_w)).astype(np.float32)
    x *= np.array([1.0, 4.0, 0.25], np.float32)[:, None, None]
    return dict(n=n, nt=nt, L=L, sr=sr, rows=rows, x=x,
                cf=_rot(rng, (E_OP,), L, n),
                d_in=(1 + 0.1 * rng.standard_normal((E_OP, n))).astype(
                    np.float32),
                d_out=(1 + 0.1 * rng.standard_normal((E_OP, n))).astype(
                    np.float32),
                bias=(0.1 * rng.standard_normal((E_OP, n))).astype(
                    np.float32),
                kw=dict(strides=strides, n_tile=nt, in_width=in_w,
                        out_width=out_w))


def _ref_entry(c):
    """The reference's entry quantization under vmap: each expert's rows
    padded to its scale block, then scaled on their own."""
    pad = -c["rows"] % c["sr"]

    def one(x):
        return J_Q.quantize_blocks(jnp.pad(x, ((0, pad), (0, 0))), c["sr"],
                                   c["nt"])
    return jax.vmap(one)(jnp.asarray(c["x"]))


def _entry_values(q, s, c):
    """The dequantized entry activations, (E, rows, in_width)."""
    return Q.dequantize_blocks(q, s, c["sr"], c["nt"])[:, :c["rows"]]


def _flattened_entry(c):
    """A planted fault: the experts' rows scaled as one flattened (E *
    rows) operand, the trap a test that does not build its reference
    expert by expert would miss."""
    x = _t(c["x"]).reshape(E_OP * c["rows"], -1)
    q, s = Q.quantize_blocks(T_ops._pad_rows(x, c["sr"]), c["sr"], c["nt"])
    deq = Q.dequantize_blocks(q, s, c["sr"], c["nt"])[:E_OP * c["rows"]]
    return deq.reshape(E_OP, c["rows"], -1)


def _check_codes(q, s, q_ref, s_ref, z, nt, sr, depth):
    """As ``tests/test_torch_quant.py``: scales within 2 ulps, codes equal
    but for flips of one next to a half-integer; returns the flips."""
    s, s_ref = s.numpy(), np.asarray(s_ref)
    np.testing.assert_allclose(s, s_ref, rtol=2 * EPS32, atol=0)
    q, q_ref = q.numpy().astype(np.int32), np.asarray(q_ref).astype(np.int32)
    w = q.shape[1]
    blk = np.repeat(np.repeat(s, sr, axis=0), nt, axis=1)[:, :w]
    v = z[:, :w] / blk
    err = 8 * depth * EPS32 * np.abs(z).max() / blk \
        + 127 * np.abs(s - s_ref).max() / blk
    flip = q != q_ref
    assert np.all(np.abs(q - q_ref)[flip] == 1)
    half = np.abs(np.abs(v - np.floor(v)) - 0.5)
    assert np.all(half[flip] <= err[flip]), (half[flip], err[flip])
    return int(flip.sum())


def test_k1_k2_expert_int8_match_vmapped_interpret_kernels():
    """Int8 x (12 rows an expert, scale blocks of 8: each expert's padded
    rows enter its own last block), an int8 table with (E, L) scales, the
    requantizing store, then K2 from the saved codes: the expert mode of
    the wrappers against the reference's interpret kernels under
    ``jax.vmap``.  Entry codes and scales bit for bit; K1's output codes
    within one (counted flips), scales within 2 ulps; K2 within its f32
    bounds.  The flattened-experts fault gives other entry values."""
    c = _q_case()
    sr, nt, L = c["sr"], c["nt"], c["L"]
    jq, js = _ref_entry(c)
    qx, xs = Q.quantize_blocks(T_ops._pad_rows(_t(c["x"]), sr), sr, nt)
    assert xs.shape == (E_OP, 2, 2)
    np.testing.assert_array_equal(qx.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(js))
    ref_vals = _np(jax.vmap(lambda q, s: J_Q.dequantize_blocks(
        q, s, sr, nt))(jq, js))[:, :c["rows"]]
    assert np.array_equal(_entry_values(qx, xs, c).numpy(), ref_vals)
    assert not np.array_equal(_flattened_entry(c).numpy(), ref_vals)
    qc, sc = Q.quantize_coeffs(_t(c["cf"]))
    assert sc.shape == (E_OP, L)
    jqc, jsc = jax.vmap(J_Q.quantize_coeffs)(jnp.asarray(c["cf"]))
    np.testing.assert_array_equal(qc.numpy(), np.asarray(jqc))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc).reshape(
        E_OP, L))
    vec = [jnp.asarray(c[k]) for k in ("d_in", "d_out", "bias")]
    kw = c["kw"]

    def j_fwd(q, s, cq, cs, di, do, b):
        return J_K.spm_stack_kernel_call(
            q, cq, d_in=di, d_out=do, bias=b, x_scale=s,
            coeff_scale=cs.reshape(-1, 1), block_rows=sr, quant_out=True,
            interpret=True, **kw)
    jyq, jys = jax.vmap(j_fwd)(jq, js, jqc, jsc, *vec)
    tv = [_t(c[k]) for k in ("d_in", "d_out", "bias")]
    yq, ys = K.spm_stack_kernel_call(qx, qc, *tv, xs, sc, quant_out=True,
                                     scale_rows=sr, **kw)
    assert yq.shape == jyq.shape and ys.shape == jys.shape
    for e in range(E_OP):
        z = K.spm_stack_plain(
            Q.dequantize_blocks(qx[e], xs[e], sr, nt),
            Q.dequantize_coeffs(qc[e], sc[e]), tv[0][e], tv[1][e],
            tv[2][e], strides=kw["strides"],
            in_width=kw["in_width"]).numpy()
        _check_codes(yq[e], ys[e], jyq[e], jys[e], z, nt, sr, 3 * L + 3)
    rng = np.random.default_rng(7)
    gy = rng.standard_normal((E_OP, qx.shape[1], kw["out_width"])).astype(
        np.float32)

    def j_bwd(q, s, cq, cs, g, di, do):
        return J_K.spm_stack_bwd_kernel_call(
            q, cq, g, d_in=di, d_out=do, x_scale=s,
            coeff_scale=cs.reshape(-1, 1), block_rows=sr, has_bias=True,
            interpret=True, **kw)
    ref = jax.vmap(j_bwd)(jq, js, jqc, jsc, jnp.asarray(gy), *vec[:2])
    got = K.spm_stack_bwd_kernel_call(qx, qc, _t(gy), tv[0], tv[1], xs, sc,
                                      has_bias=True, scale_rows=sr, **kw)
    assert len(got) == len(ref) == 5
    for i, (g, r) in enumerate(zip(got, ref)):
        r = _np(r)
        assert g.shape == r.shape, i
        depth = 3 * L + 3 + (qx.shape[1] if i else 0)
        np.testing.assert_allclose(_np(g), r, rtol=0, atol=_bound(depth, r),
                                   err_msg=i)


@pytest.mark.parametrize("mode", ["coeffs", "both"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_expert_quant_matches_reference_vjp(dtype, mode):
    """``spm_stack_fused`` on an (E, L, n/2, 4) table with ``quant_acts``
    and ``quant_coeffs`` against ``jax.vjp`` of ``jax.vmap`` of the
    reference's, whose ``block_rows`` is the port's ``scale_block_rows``
    of one expert's rows (12, padded to 16 an expert).  The output within
    its f32 bound plus one step of its block (the exit dequantizes q * s,
    so a flip moves it by s); every grad within the backward's f32
    bound."""
    n, strides, rows, in_w, out_w = 64, (1, 2, 4, 8, 16, 32), 12, 48, 64
    qa = mode == "both"
    rng = np.random.default_rng(rows + len(mode))
    L = len(strides)
    runs = T_ops.plan_runs_for_rows(n, strides, rows)
    assert len(runs) == 1 and quant_acts_eligible(runs)
    sr = Q.scale_block_rows(runs, rows, 4 if dtype == torch.float32 else 2)
    assert rows % sr
    args = [rng.standard_normal((E_OP, rows, in_w)).astype(np.float32),
            _rot(rng, (E_OP,), L, n)] + [
        (m + s * rng.standard_normal((E_OP, n))).astype(np.float32)
        for m, s in ((1.0, 0.1), (1.0, 0.1), (0.0, 0.3))]
    gy = rng.standard_normal((E_OP, rows, out_w)).astype(np.float32)
    jdt = _jdt(dtype)

    def one(x, cf, di, do, b):
        return J_ops.spm_stack_fused(x, cf, strides, d_in=di, d_out=do,
                                     bias=b, in_width=in_w, out_width=out_w,
                                     block_rows=sr, quant_acts=qa,
                                     quant_coeffs=True, interpret=True)
    jargs = [jnp.asarray(args[0], jdt)] + [jnp.asarray(a) for a in args[1:]]
    y_ref, vjp = jax.vjp(jax.vmap(one), *jargs)
    ref = vjp(jnp.asarray(gy, jdt))
    targs = [_t(args[0]).to(dtype)] + [_t(a) for a in args[1:]]
    for a in targs:
        a.requires_grad_(True)
    y = T_ops.spm_stack_fused(targs[0], targs[1], strides, d_in=targs[2],
                              d_out=targs[3], bias=targs[4], in_width=in_w,
                              out_width=out_w, quant_acts=qa,
                              quant_coeffs=True)
    y.backward(_t(gy).to(dtype))
    assert y.dtype == dtype and y.shape == (E_OP, rows, out_w)
    y_ref = _np(y_ref)
    io = float(torch.finfo(dtype).eps)
    tol = _bound(3 * L + 3, y_ref, io)
    if qa:
        _, s = Q.quantize_blocks(T_ops._pad_rows(_t(y_ref), sr), sr,
                                 runs[0][1])
        tol = tol + float(s.max()) * (1 + io)
    np.testing.assert_allclose(_np(y), y_ref, rtol=0, atol=tol)
    for i, (a, r) in enumerate(zip(targs, ref)):
        r = _np(r)
        assert a.grad.dtype == a.dtype
        d = 3 * L + 3 + (rows if i else 0)
        np.testing.assert_allclose(_np(a.grad), r, rtol=0,
                                   atol=_bound(d, r, io), err_msg=i)


# ---------------------------------------------------------------------------
# the stacked expert operator under the 4-shard mesh
# ---------------------------------------------------------------------------

def _port_sharded(case):
    """The port's sharded expert operator and its grads, from the case's
    numpy operands, under a 4-shard CPU mesh; the executor's calls are
    recorded."""
    n, L, in_w, out_w, overlap, q, rows = SH_CASES[case]
    a = _sh_inputs(case)
    cfg = T_spm.SPMConfig(n=n, n_stages=L, schedule="two_level",
                          n_shards=N_DEV, backward="custom", use_kernel=True,
                          overlap=overlap, quant_coeffs=q)
    p = Params({k: torch.from_numpy(a[k]) for k in PARAMS})
    for v in p.parameters():
        v.requires_grad_(True)
    x = torch.from_numpy(a["x"]).requires_grad_(True)
    with activation_sharding(make_feature_mesh(N_DEV, device="cpu"),
                             shard_feature=True):
        y = T_spm.spm_apply(p, x, cfg, in_width=in_w, out_width=out_w)
    grads = torch.autograd.grad(y, [x] + [p[k] for k in PARAMS],
                                torch.from_numpy(a["gy"]))
    return y, dict(zip(("x",) + PARAMS, grads))


@pytest.mark.parametrize("case", list(SH_CASES))
def test_sharded_expert_operator_matches_vmapped_reference(reference, case,
                                                           monkeypatch):
    """Forward and every grad of the stacked expert operator (3 experts)
    under the 4-shard mesh against the reference's ``spm_apply`` under
    ``jax.vmap`` inside its 4-device mesh: step-serial and overlap, with
    and without int8 tables (one scale a shard, expert and stage, equal on
    both sides), rectangular inputs through the windowed first run.  One
    executor call for all experts.  Depth: the operator's L stages at 3
    roundings each plus the diagonals and bias, twice for the backward; a
    parameter grad adds its rows."""
    n, L, in_w, out_w, overlap, q, rows = SH_CASES[case]
    calls, real = [], T_sh.spm_apply_sharded

    def spy(params, x, *a, **kw):
        calls.append(tuple(x.shape))
        return real(params, x, *a, **kw)
    monkeypatch.setattr(T_sh, "spm_apply_sharded", spy)
    K.reset_launch_counts()
    y, g = _port_sharded(case)
    assert calls == [(E_OP, rows, in_w or n)]
    r = {k.split("/", 1)[1]: v for k, v in reference.items()
         if k.startswith(case + "/")}
    depth = 3 * L + 3
    assert y.shape == r["y"].shape
    np.testing.assert_allclose(_np(y), r["y"], rtol=0,
                               atol=_bound(depth, r["y"]))
    np.testing.assert_allclose(_np(g["x"]), r["gx"], rtol=0,
                               atol=_bound(2 * depth, r["gx"]))
    for k in PARAMS:
        w = r[f"g_{k}"]
        assert g[k].shape == w.shape, k
        np.testing.assert_allclose(_np(g[k]), w, rtol=0,
                                   atol=_bound(2 * depth + rows, w),
                                   err_msg=k)
    if in_w is not None:             # no lane past in_width reaches d_in
        assert not g["d_in"][:, in_w:].any()


def test_sharded_expert_operator_is_each_expert_sharded():
    """The stacked run equals each expert's operator run through the
    sharded executor alone, bit for bit (every op of the batched steps is
    per expert), on both schedules with an int8 table."""
    for case in ("serial-rect-int8", "overlap-rect-int8"):
        n, L, in_w, out_w, overlap, q, rows = SH_CASES[case]
        a = _sh_inputs(case)
        cfg = T_spm.SPMConfig(n=n, n_stages=L, schedule="two_level",
                              n_shards=N_DEV, backward="custom",
                              use_kernel=True, overlap=overlap,
                              quant_coeffs=q)
        y, _ = _port_sharded(case)
        with activation_sharding(make_feature_mesh(N_DEV, device="cpu"),
                                 shard_feature=True), torch.no_grad():
            for e in range(E_OP):
                pe = Params({k: torch.from_numpy(a[k][e]) for k in PARAMS})
                ye = T_spm.spm_apply(pe, torch.from_numpy(a["x"][e]), cfg,
                                     in_width=in_w, out_width=out_w)
                assert torch.equal(y[e].detach(), ye), (case, e)


# ---------------------------------------------------------------------------
# the smoke qwen3-moe under the knobs
# ---------------------------------------------------------------------------

def _depth(cfg) -> int:
    """Dependent f32 roundings of the MoE smoke model's forward, counted
    as ``tests/test_torch_moe.py`` counts them."""
    L_attn = default_n_stages(max(cfg.d_model, cfg.n_heads * cfg.head_dim))
    L_ffn = default_n_stages(max(cfg.d_model, cfg.moe_d_ff))
    moe = (cfg.d_model + cfg.n_experts + 3 * (3 * L_ffn + 4)
           + 4 * cfg.top_k + (3 * (3 * L_ffn + 4) if cfg.shared_d_ff else 0))
    per_layer = (cfg.d_model + 3 * L_attn + 8 + cfg.head_dim + 32
                 + 3 * L_attn + moe + cfg.d_model + 2)
    return cfg.n_layers * per_layer + 2 * cfg.d_model


def _reference_codes(monkeypatch) -> list:
    """Every requantizing K1 call of the reference from now on, in the
    order it runs (under vmap, one callback an expert, in expert order):
    (entry codes, entry scales, output codes, output scales)."""
    seen = []
    real = J_K.spm_stack_kernel_call

    def tap(x, *a, **k):
        out = real(x, *a, **k)
        if k.get("quant_out"):
            jax.debug.callback(
                lambda *t: seen.append(tuple(np.asarray(v) for v in t)),
                x, k["x_scale"], *out, ordered=True)
        return out
    monkeypatch.setattr(J_K, "spm_stack_kernel_call", tap)
    return seen


def _flips(port: list, ref: list) -> int:
    """The codes that differ between the port's chains (``CodeTape``; an
    expert-mode chain split into its experts) and the reference's, entries
    and outputs; each must differ by one."""
    flat = []
    for call in port:
        if call[0].dim() == 3:
            flat += [tuple(t[e] for t in call)
                     for e in range(call[0].shape[0])]
        else:
            flat.append(call)
    assert len(flat) == len(ref) > 0
    total = 0
    for p, r in zip(flat, ref):
        for a, b in ((p[0], r[0]), (p[2], r[2])):
            a = a.numpy().astype(np.int32)
            b = b.astype(np.int32)
            assert a.shape == b.shape
            d = np.abs(a - b)
            assert d.max() <= 1
            total += int((d != 0).sum())
    return total


@pytest.fixture(scope="module")
def quant_moe():
    jcfg = j_quantized(j_get_smoke("qwen3-moe-30b-a3b", use_kernel=True))
    jparams = J_T.init_model(jax.random.PRNGKey(0), jcfg)
    tcfg = with_quantized_io(get_smoke("qwen3-moe-30b-a3b"))
    return jcfg, jparams, tcfg


def _port_params(jparams, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                           device="cpu")


def test_convert_needs_nothing_for_quantized_or_sharded_moe(quant_moe):
    """The int8 tables derive from the f32 parameters and the sharded
    executor reads the same (E, L, n/2, 4) tables, so a quantized or
    sharded MoE config's parameters are the plain config's, tensor for
    tensor."""
    jcfg, jparams, _ = quant_moe
    plain = get_smoke("qwen3-moe-30b-a3b")
    b = _port_params(jparams, plain).state_dict()
    for cfg in (with_quantized_io(plain), with_feature_sharding(plain, 4)):
        a = _port_params(jparams, cfg).state_dict()
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_quantized_moe_smoke_logits_and_step_match_reference(quant_moe,
                                                             monkeypatch):
    """The smoke qwen3-moe under ``with_quantized_io``: every expert chain
    moves int8 activations through one expert-mode launch a run; logits
    within the f32 depth bound plus one step for each code that differs
    from the reference's (whose experts run under vmap); then one
    training step's loss, grad norm and params within the forward and
    backward bound plus the step's flips.  The unquantized model's logits
    fall outside the bound."""
    jcfg, jparams, tcfg = quant_moe
    ref_codes = _reference_codes(monkeypatch)
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 16))
    jlog = np.asarray(J_T.forward(jparams, jcfg,
                                  tokens=jnp.asarray(tokens))[0], np.float32)
    jax.effects_barrier()
    params = _port_params(jparams, tcfg)
    with torch.no_grad(), CodeTape() as tape:
        tlog = T.forward(params, tcfg, tokens=torch.from_numpy(tokens))[0]
    experts = [c for c in tape.calls if c[0].dim() == 3]
    assert len(experts) == 3 * tcfg.n_layers
    assert all(c[0].shape[0] == tcfg.n_experts for c in experts)
    flips = _flips(tape.calls, ref_codes)
    rel = 8 * _depth(tcfg) * EPS32 + flips * STEP
    limit = rel * (np.abs(jlog).max() + 1)
    np.testing.assert_allclose(tlog.float().numpy(), jlog, rtol=0,
                               atol=limit)
    plain_cfg = get_smoke("qwen3-moe-30b-a3b")
    with torch.no_grad():
        plain = T.forward(_port_params(jparams, plain_cfg), plain_cfg,
                          tokens=torch.from_numpy(tokens))[0]
    assert np.abs(plain.float().numpy() - jlog).max() > limit
    # one training step from the same state
    from repro.optim import adamw as J_opt
    from repro.train import make_train_state as j_make_state
    from repro.train import make_train_step as j_make_step
    opt = dict(lr=1e-2, total_steps=1, warmup_steps=1)
    batch = DeterministicLoader(launch_train.make_batch_fn(
        tcfg, 16, build_corpus(20_000, seed=0)), 2, seed=0).batch_at(0)
    jb = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()}
    ref_codes.clear()
    jstate, jm = jax.jit(j_make_step(
        lambda p, b: J_LM.lm_loss(p, b, jcfg), J_opt.OptimizerConfig(**opt),
        chaos_guard=True))(j_make_state(jparams), jb, 0.0)
    jax.effects_barrier()
    tstate = make_train_state(_port_params(jparams, tcfg))
    p0 = {k: v.clone() for k, v in tstate["params"].state_dict().items()}
    step = make_train_step(lambda p, b: LM.lm_loss(p, b, tcfg),
                           T_opt.OptimizerConfig(**opt), chaos_guard=True)
    with CodeTape() as tape:
        tstate, tm = step(tstate, batch, 0.0)
    rel = 8 * 2 * _depth(tcfg) * EPS32 + _flips(tape.calls, ref_codes) * STEP
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rel,
                                   err_msg=k)
    assert float(tm["skipped"]) == 0.0
    ref = _port_params(jstate["params"], tcfg).state_dict()
    got = tstate["params"].state_dict()
    diff = math.sqrt(sum(float(((got[k] - ref[k]) ** 2).sum())
                         for k in ref))
    moved = math.sqrt(sum(float(((ref[k] - p0[k]) ** 2).sum())
                          for k in ref))
    assert diff <= rel * moved, (diff / moved, rel)


def test_sharded_moe_smoke_logits_match_reference(reference, monkeypatch):
    """The smoke qwen3-moe under ``with_feature_sharding(cfg, 4)`` and the
    4-shard CPU mesh: every SPM linear runs in the sharded executor, the
    experts in one call a linear with their axis; logits within the
    model's f32 depth bound of the reference's under its 4-device mesh."""
    jcfg = _j_smoke_sharded()
    tcfg = with_feature_sharding(get_smoke("qwen3-moe-30b-a3b"), N_DEV)
    params = _port_params(J_T.init_model(jax.random.PRNGKey(0), jcfg), tcfg)
    calls, real = [], T_sh.spm_apply_sharded

    def spy(p, x, *a, **kw):
        calls.append(tuple(x.shape))
        return real(p, x, *a, **kw)
    monkeypatch.setattr(T_sh, "spm_apply_sharded", spy)
    toks = torch.from_numpy(_smoke_tokens(tcfg.vocab_size))
    with torch.no_grad(), activation_sharding(
            make_feature_mesh(N_DEV, device="cpu"), shard_feature=True):
        logits = T.forward(params, tcfg, tokens=toks)[0]
    experts = [c for c in calls if len(c) == 3 and c[0] == tcfg.n_experts]
    assert len(experts) == 3 * tcfg.n_layers
    want = reference["smoke/logits"]
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=_bound(_depth(tcfg), want))


def test_launch_train_quantize_moe_on_cpu(capsys):
    """``launch.train --arch qwen3-moe-30b-a3b --smoke --quantize
    --device cpu`` runs to its end: finite losses, aux reported."""
    args = launch_train.build_parser().parse_args(
        ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
         "--quantize", "--steps", "2", "--batch", "2", "--seq", "8",
         "--log-every", "1"])
    seen = []
    state = launch_train.train(
        args, on_step=lambda s, st, m, dt: seen.append(m))
    assert len(seen) == 2
    assert all(np.isfinite(m["loss"]) and m["aux"] > 0 for m in seen)
    assert int(state["step"]) == 2
    assert "quantize=True" in capsys.readouterr().out
