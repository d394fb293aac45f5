"""Parity of the PyTorch port's SPM core and kernel plain versions with the
JAX reference, on the CPU.

* schedules, run plans and eligibility: bitwise equal;
* K1's plain version against ``repro.kernels.ops.spm_stack_fused`` run in
  Pallas interpret mode, at the n=6144 FFN width (2-run and 1-run plans);
* K3's plain version against ``repro.kernels.ops.spm_block_fused`` in
  interpret mode (fused-qkv form at n=2048, two-stack forms at small n);
* ``spm_apply(use_kernel=False)`` against the reference's composition.

Inputs come from numpy with fixed seeds.  Tolerances are derived, as in
``tests/test_block_fusion.py``: ``depth`` dependent f32 roundings
(Higham's gamma_k ~ k eps) plus one I/O-dtype rounding per stored
intermediate, scaled by the reference's magnitude, times 8 for the
freedom of association between the two implementations.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import eligibility as J_el  # noqa: E402
from repro.core import pairings as J_pair  # noqa: E402
from repro.core import spm as J_spm  # noqa: E402
from repro.kernels import ops as J_ops  # noqa: E402
from repro_torch.core import eligibility as T_el  # noqa: E402
from repro_torch.core import pairings as T_pair  # noqa: E402
from repro_torch.core import spm as T_spm  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.params import Params  # noqa: E402

FFN_STRIDES = tuple(1 << i for i in range(11)) + (3072,)   # n=6144, L=12
QKV_STRIDES = tuple(1 << i for i in range(11))             # n=2048, L=11


def _eps(dtype) -> float:
    return float(torch.finfo(dtype).eps)


def _tol(io_dtype, depth, ref, io_roundings=1):
    """Derived bound: depth f32 roundings plus ``io_roundings`` roundings
    to the I/O dtype, at the reference's scale, times 8."""
    scale = float(np.max(np.abs(ref))) + 1.0
    return 8 * (depth * _eps(torch.float32)
                + io_roundings * _eps(io_dtype)) * scale


def _jdt(dtype):
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _operands(rng, n, L, scale=0.4):
    cf = (scale * rng.standard_normal((L, n // 2, 4))).astype(np.float32)
    d_in = (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    d_out = (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return cf, d_in, d_out, bias


# ---------------------------------------------------------------------------
# schedules, plans, eligibility: bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["butterfly", "brick", "random",
                                  "two_level"])
@pytest.mark.parametrize("n", [2, 12, 96, 2048, 6144])
def test_schedules_equal_reference(kind, n):
    for L in (1, 7, 12):
        kw = dict(n_shards=4 if n % 4 == 0 else 1, seed=3)
        a = J_pair.make_schedule(kind, n, L, **kw)
        b = T_pair.make_schedule(kind, n, L, **kw)
        assert len(a.stages) == len(b.stages)
        for sa, sb in zip(a.stages, b.stages):
            assert sa.stride == sb.stride
            if sa.perm is not None:
                np.testing.assert_array_equal(sa.perm, sb.perm)
        if a.all_structured:
            assert a.strides() == b.strides()
    assert J_pair.default_n_stages(n) == T_pair.default_n_stages(n)


@pytest.mark.parametrize("n, strides", [
    (6144, FFN_STRIDES), (2048, QKV_STRIDES), (96, (1, 2, 4, 8, 16, 48, 24)),
    (64, (1, 2, 4, 8, 16, 32)), (24, (1, 3, 6, 2, 12))])
def test_plans_equal_reference(n, strides):
    """The port's planner is the reference's arithmetic; at decode rows its
    tile cap comes from shared memory, and its plan equals the reference's
    ``plan_runs`` called with that cap."""
    for cap in (8, 64, 2048, 4096, 8192):
        assert T_ops.plan_runs(n, strides, cap) == J_ops.plan_runs(
            n, strides, cap)
    for rows in (1, 4, 8, 9, 16, 4096):
        cap = T_ops.tile_cap_for_rows(rows)
        assert T_ops.plan_runs_for_rows(n, strides, rows) == \
            J_ops.plan_runs(n, strides, cap)
        assert T_el.tiny_row_call(rows) == J_el.tiny_row_call(rows)


def test_ffn_plans_at_serving_rows():
    """The n=6144 FFN linears plan to two runs at prefill rows and to one
    6144-wide run at decode rows (the tiny-row cap is 7264 lanes)."""
    assert T_ops.TINY_ROW_MAX_TILE == 232448 // 32
    assert T_ops.plan_runs_for_rows(6144, FFN_STRIDES, 4096) == (
        (QKV_STRIDES, 2048), ((3072,), 6144))
    assert T_ops.plan_runs_for_rows(6144, FFN_STRIDES, 8) == (
        (FFN_STRIDES, 6144),)
    assert T_ops.plan_runs_for_rows(2048, QKV_STRIDES, 8) == (
        (QKV_STRIDES, 2048),)


@pytest.mark.parametrize("n", [2, 64, 96, 2048, 2050, 6144])
def test_block_eligibility_equal_reference(n):
    strides = T_pair.make_schedule("butterfly", n, 8).strides()
    for act in (None, "relu", "silu", "gelu", "swiglu"):
        assert T_el.block_fusion_eligible(n, strides, strides, act) == \
            J_el.block_fusion_eligible(n, strides, strides, act)
    for knob in (None, True, False):
        for elig in (True, False):
            # the port's auto is the reference's forced setting
            want = J_el.resolve_block_fuse(
                True if knob is None else knob, elig, False)
            assert T_el.resolve_block_fuse(knob, elig) == want


@pytest.mark.parametrize("schedule, n", [("butterfly", 16), ("random", 16),
                                         ("random", 15)])
@pytest.mark.parametrize("backward", ["custom", "custom_inverse"])
def test_kernel_eligibility_equal_reference(schedule, n, backward):
    variant = "rotation" if backward == "custom_inverse" else "general"
    for knob in (None, True, False):
        jc = J_spm.SPMConfig(n=n, n_stages=4, schedule=schedule,
                             backward=backward, variant=variant,
                             use_kernel=knob)
        tc = T_spm.SPMConfig(n=n, n_stages=4, schedule=schedule,
                             backward=backward, variant=variant,
                             use_kernel=knob)
        assert T_el.kernel_eligible(tc) == J_el.kernel_eligible(jc)
        jforced = dataclasses.replace(jc, use_kernel=(
            True if knob is None else knob))
        assert T_el.use_fused_kernel(tc) == J_el.use_fused_kernel(jforced)


# ---------------------------------------------------------------------------
# the composition path (use_kernel=False)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["general", "rotation"])
@pytest.mark.parametrize("n, schedule, in_w, out_w", [
    (32, "butterfly", 20, 32), (24, "butterfly", 24, 10),
    (15, "random", 15, 15), (16, "brick", 16, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spm_apply_composition_matches_reference(variant, n, schedule, in_w,
                                                 out_w, dtype):
    """Same params, same inputs: the composition computes in x's dtype on
    both sides, stage by stage in the same order."""
    rng = np.random.default_rng(n)
    L = 5
    jcfg = J_spm.SPMConfig(n=n, n_stages=L, variant=variant,
                           schedule=schedule, use_kernel=False, seed=1)
    tcfg = T_spm.SPMConfig(n=n, n_stages=L, variant=variant,
                           schedule=schedule, use_kernel=False, seed=1)
    p = {"d_in": 1 + 0.1 * rng.standard_normal(n),
         "d_out": 1 + 0.1 * rng.standard_normal(n),
         "bias": 0.1 * rng.standard_normal(n)}
    if variant == "rotation":
        p["theta"] = rng.uniform(-np.pi, np.pi, (L, n // 2))
    else:
        p["mix"] = 0.5 * rng.standard_normal((L, n // 2, 4))
    if n % 2:
        p["res_scale"] = 1 + 0.1 * rng.standard_normal(L)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((3, in_w)).astype(np.float32)
    ref = _np(J_spm.spm_apply({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x, _jdt(dtype)), jcfg,
                              in_width=in_w, out_width=out_w))
    got = T_spm.spm_apply(Params({k: torch.from_numpy(v)
                                  for k, v in p.items()}),
                          torch.from_numpy(x).to(dtype), tcfg,
                          in_width=in_w, out_width=out_w)
    assert got.dtype == dtype and got.shape == (3, out_w)
    # every stage rounds to x's dtype on both sides: L + 3 roundings of
    # the working dtype (the cos/sin of rotation add one each)
    depth = L + 4
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=_tol(dtype, depth, ref,
                                         io_roundings=depth))


def test_init_spm_shapes_match_reference():
    for variant in ("general", "rotation"):
        for n in (16, 15):
            jc = J_spm.SPMConfig(n=n, n_stages=3, variant=variant)
            tc = T_spm.SPMConfig(n=n, n_stages=3, variant=variant)
            jp = J_spm.init_spm(jax.random.PRNGKey(0), jc)
            tp = T_spm.init_spm(tc, torch.Generator().manual_seed(0),
                                torch.device("cpu"))
            assert set(jp) == set(tp.keys())
            for k in jp:
                assert tuple(jp[k].shape) == tuple(tp[k].shape)
                assert tp[k].dtype == torch.float32


# ---------------------------------------------------------------------------
# K1 plain version vs the reference's interpret-mode kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [16, 4], ids=["rows16-2run", "rows4-1run"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_w, out_w", [(2048, 6144), (6144, 2048)],
                         ids=["up", "down"])
def test_k1_plain_matches_interpret_kernel(rows, dtype, in_w, out_w):
    """n=6144, L=12 (the qwen3-1.7b FFN linears), rectangular, random
    diagonals and bias.  The plan splits at 16 rows and not at 4."""
    n = 6144
    rng = np.random.default_rng(rows + in_w)
    cf, d_in, d_out, bias = _operands(rng, n, len(FFN_STRIDES))
    x = rng.standard_normal((rows, in_w)).astype(np.float32)
    jx = jnp.asarray(x, _jdt(dtype))
    ref = _np(J_ops.spm_stack_fused(
        jx, jnp.asarray(cf), FFN_STRIDES, d_in=jnp.asarray(d_in),
        d_out=jnp.asarray(d_out), bias=jnp.asarray(bias), in_width=in_w,
        out_width=out_w, interpret=True))
    got = T_ops.spm_stack_fused(
        torch.from_numpy(x).to(dtype), torch.from_numpy(cf), FFN_STRIDES,
        d_in=torch.from_numpy(d_in), d_out=torch.from_numpy(d_out),
        bias=torch.from_numpy(bias), in_width=in_w, out_width=out_w)
    assert got.dtype == dtype and got.shape == (rows, out_w)
    n_runs = len(T_ops.plan_runs_for_rows(n, FFN_STRIDES, rows))
    assert n_runs == (2 if rows > 8 else 1)
    # one I/O rounding per stored run output; each stage is 3 dependent
    # roundings (two products, one sum), plus the diagonals and bias
    depth = 3 * len(FFN_STRIDES) + 3
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=_tol(dtype, depth, ref,
                                         io_roundings=n_runs))


# ---------------------------------------------------------------------------
# K3 plain version vs the reference's interpret-mode block kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_w", [2048, 1024], ids=["q", "kv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_qkv_form_matches_interpret_kernel(out_w, dtype):
    """The norm-prologue-only form at the qwen3-1.7b width: n=2048, L=11,
    outputs 2048 (q) and 1024 (k, v)."""
    n, rows = 2048, 8
    rng = np.random.default_rng(out_w)
    cf, d_in, d_out, bias = _operands(rng, n, len(QKV_STRIDES))
    gamma = (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    ref = _np(J_ops.spm_block_fused(
        jnp.asarray(x, _jdt(dtype)), coeffs1=jnp.asarray(cf),
        d_in1=jnp.asarray(d_in), d_out1=jnp.asarray(d_out),
        bias1=jnp.asarray(bias), strides1=QKV_STRIDES,
        gamma=jnp.asarray(gamma), out_width=out_w, interpret=True))
    got = T_ops.spm_block_fused(
        torch.from_numpy(x).to(dtype), coeffs1=torch.from_numpy(cf),
        d_in1=torch.from_numpy(d_in), d_out1=torch.from_numpy(d_out),
        bias1=torch.from_numpy(bias), strides1=QKV_STRIDES,
        gamma=torch.from_numpy(gamma), out_width=out_w)
    assert got.dtype == dtype and got.shape == (rows, out_w)
    # the row sum of squares over n lanes adds up to n roundings in the
    # worst order (log2 n pairwise); 3 per stage, norm and diagonals
    depth = n + 3 * len(QKV_STRIDES) + 6
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=_tol(dtype, depth, ref))


@pytest.mark.parametrize("activation", ["relu", "silu", "gelu"])
@pytest.mark.parametrize("residual", [True, False], ids=["res", "nores"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_two_stack_matches_interpret_kernel(activation, residual, dtype):
    """Two-stack block at n=64 with a narrower mid width (the mask before
    the activation) and, without residual, a narrower output."""
    n, rows, in_w, mid_w = 64, 8, 48, 40
    out_w = in_w if residual else 56
    strides = (1, 2, 4, 8, 16, 32)
    rng = np.random.default_rng(7)
    ops1 = _operands(rng, n, len(strides))
    ops2 = _operands(rng, n, len(strides))
    gamma = (1 + 0.1 * rng.standard_normal(in_w)).astype(np.float32)
    x = rng.standard_normal((rows, in_w)).astype(np.float32)
    J = lambda a: jnp.asarray(a)   # noqa: E731
    Tt = torch.from_numpy
    ref = _np(J_ops.spm_block_fused(
        jnp.asarray(x, _jdt(dtype)), coeffs1=J(ops1[0]), d_in1=J(ops1[1]),
        d_out1=J(ops1[2]), bias1=J(ops1[3]), strides1=strides,
        gamma=J(gamma), coeffs2=J(ops2[0]), d_in2=J(ops2[1]),
        d_out2=J(ops2[2]), bias2=J(ops2[3]), strides2=strides,
        activation=activation, residual=residual, mid_width=mid_w,
        out_width=out_w, interpret=True))
    got = T_ops.spm_block_fused(
        Tt(x).to(dtype), coeffs1=Tt(ops1[0]), d_in1=Tt(ops1[1]),
        d_out1=Tt(ops1[2]), bias1=Tt(ops1[3]), strides1=strides,
        gamma=Tt(gamma), coeffs2=Tt(ops2[0]), d_in2=Tt(ops2[1]),
        d_out2=Tt(ops2[2]), bias2=Tt(ops2[3]), strides2=strides,
        activation=activation, residual=residual, mid_width=mid_w,
        out_width=out_w)
    assert got.dtype == dtype and got.shape == (rows, out_w)
    depth = n + 6 * len(strides) + 16   # sum, two stacks, norm/act/diag
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=_tol(dtype, depth, ref))


# ---------------------------------------------------------------------------
# layer entries over the block kernel, and the linear's parameter count
# ---------------------------------------------------------------------------

def _linear_pair(rng, d_in, d_out, n_stages=None):
    from repro.core.linear import LinearConfig as JLin
    from repro_torch.core.linear import LinearConfig as TLin
    kw = dict(d_in=d_in, d_out=d_out, impl="spm_general", use_bias=False,
              n_stages=n_stages)
    jl, tl = JLin(use_kernel=True, **kw), TLin(**kw)
    scfg = tl.spm_config()
    p = {"mix": 0.5 * rng.standard_normal((scfg.n_stages, scfg.n // 2, 4)),
         "d_in": 1 + 0.1 * rng.standard_normal(scfg.n),
         "d_out": 1 + 0.1 * rng.standard_normal(scfg.n)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return (jl, {k: jnp.asarray(v) for k, v in p.items()},
            tl, Params({k: torch.from_numpy(v) for k, v in p.items()}))


@pytest.mark.parametrize("d_out", [64, 32])
def test_norm_linear_apply_matches_reference(d_out):
    """The norm -> linear entry through K3's prologue (the reference
    forced to its block kernel, the port at auto)."""
    from repro.layers.norms import norm_linear_apply as j_nla
    from repro_torch.layers.norms import norm_linear_apply as t_nla
    rng = np.random.default_rng(d_out)
    jl, jp, tl, tp = _linear_pair(rng, 64, d_out)
    gamma = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    ref = _np(j_nla({"scale": jnp.asarray(gamma)}, jp, jnp.asarray(x), jl,
                    block_fuse=True))
    got = t_nla({"scale": torch.from_numpy(gamma)}, tp,
                torch.from_numpy(x), tl)
    depth = 64 + 3 * tl.spm_config().n_stages + 6
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=_tol(torch.float32, depth, ref))


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_ungated_ffn_block_matches_reference(activation):
    """An ungated FFN block (norm, up, activation, down, residual) is one
    K3 launch in the port and one block kernel in the reference."""
    from repro.layers.ffn import FFNConfig as JF
    from repro.layers.ffn import ffn_block_apply as j_fba
    from repro_torch.layers.ffn import FFNConfig as TF
    from repro_torch.layers.ffn import ffn_block_apply as t_fba
    rng = np.random.default_rng(5)
    jup, jpu, tup, tpu = _linear_pair(rng, 48, 64)
    jdn, jpd, tdn, tpd = _linear_pair(rng, 64, 48)
    kw = dict(d_model=48, d_ff=64, linear_impl="spm_general",
              activation=activation)
    jcfg = JF(spm_use_kernel=True, spm_block_fuse=True, **kw)
    tcfg = TF(**kw)
    gamma = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    x = rng.standard_normal((4, 48)).astype(np.float32)
    ref = _np(j_fba({"up": jpu, "down": jpd}, {"scale": jnp.asarray(gamma)},
                    jnp.asarray(x), jcfg))
    got = t_fba(Params({"up": tpu, "down": tpd}),
                {"scale": torch.from_numpy(gamma)}, torch.from_numpy(x),
                tcfg)
    depth = 64 + 6 * tup.spm_config().n_stages + 16
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=_tol(torch.float32, depth, ref))


@pytest.mark.parametrize("impl", ["dense", "spm_general", "spm_rotation"])
@pytest.mark.parametrize("d_in, d_out", [(64, 64), (2048, 6144), (15, 7)])
def test_linear_param_count_matches_reference(impl, d_in, d_out):
    from repro.core.linear import LinearConfig as JLin
    from repro.core.linear import linear_param_count as j_count
    from repro_torch.core.linear import LinearConfig as TLin
    from repro_torch.core.linear import linear_param_count as t_count
    assert t_count(TLin(d_in, d_out, impl=impl)) == j_count(
        JLin(d_in, d_out, impl=impl))
