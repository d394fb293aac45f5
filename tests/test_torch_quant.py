"""The PyTorch port's int8 path on the CPU, against the JAX reference.

* the quantization primitives of ``kernels/quant.py`` and the scale grid
  (``scale_block_rows``): bitwise;
* K1's and K2's int8 plain versions against the reference's
  interpret-mode kernels (``x_scale``, ``coeff_scale``, ``quant_out``),
  with an ``out_width`` edge tile, ``in_width`` and a bias with padded
  rows;
* ``spm_stack_fused(quant_acts, quant_coeffs)`` against ``jax.vjp`` of the
  reference's, the f32 fallback of a non-uniform plan, and
  ``spm_stack_fused_q8``;
* the smoke ``qwen3-1.7b`` under ``with_quantized_io``: logits and three
  training steps against the reference's quantized model, and
  ``launch.train --quantize``.

Inputs come from numpy with fixed seeds.  Tolerances are derived:

* f32 arithmetic as in ``tests/test_torch_grad.py``: ``depth`` dependent
  roundings (Higham's gamma_k ~ k eps) at the reference's scale, times 8;
* an int8 code is ``round(v / s)``.  The port and the reference compute v
  in f32 by different but equally rounded routes, so a code may differ by
  one where v / s lies within the f32 error of v (over s) of a
  half-integer.  Each such flip is checked to be one, and counted; a
  dequantized value then differs by one step, the block scale s;
* through a model, the port's and the reference's int8 codes are
  recorded (the reference's through an ordered debug callback in its K1
  call, which runs inside scan, vjp and jit) and compared chain by chain:
  every code within one, and the codes that differ counted.  A model
  whose codes all agree computes the same f32 function on both sides and
  is held to the f32 bound; each counted flip moves its value by one
  step, 1/127 of its block's absmax, and adds one step to the bound, as
  the f32 bound adds eps for every rounding (``tests/test_kernels.py``
  ``_quant_tol`` counts quantization events the same way).  Planted
  faults (the unquantized model, half the batch, a 1.4x update) must
  fall outside the bound.
"""

import argparse
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.configs import with_quantized_io as j_quantized  # noqa: E402
from repro.kernels import ops as J_ops  # noqa: E402
from repro.kernels import quant as J_Q  # noqa: E402
from repro.kernels import spm_stack as J_K  # noqa: E402
from repro.models import causal_lm as J_LM  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.optim import adamw as J_opt  # noqa: E402
from repro.train import make_train_state as j_make_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402
from repro_torch.configs import get_smoke, with_quantized_io  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import pairings as T_pair  # noqa: E402
from repro_torch.core.eligibility import quant_acts_eligible  # noqa: E402
from repro_torch.data import DeterministicLoader, build_corpus  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.kernels.codes import CodeTape  # noqa: E402
from repro_torch.kernels import quant as Q  # noqa: E402
from repro_torch.kernels import spm_stack as K  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import causal_lm as LM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw as T_opt  # noqa: E402
from repro_torch.train import make_train_state, make_train_step  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)
STEP = 1.0 / 127.0          # one int8 step, relative to its block's absmax


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


def _jdt(dtype):
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]


def _vec(rng, n, mean=1.0, scale=0.1):
    return (mean + scale * rng.standard_normal(n)).astype(np.float32)


def _rot(rng, L, n, noise=0.05):
    """Random rotations plus noise, as ``init_spm`` draws them: every stage
    keeps its input's norm, so all stages carry the signal."""
    th = rng.uniform(-np.pi, np.pi, (L, n // 2))
    c, s = np.cos(th), np.sin(th)
    base = np.stack([c, -s, s, c], axis=-1)
    return (base + noise * rng.standard_normal((L, n // 2, 4))).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the primitives and the scale grid: bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, W, block_rows, n_tile", [
    (16, 64, 8, 32),          # whole tiles, two row blocks
    (8, 40, 8, 16),           # a partial trailing tile
    (24, 96, 8, 96),          # one tile a row block
])
def test_block_primitives_match_reference(B, W, block_rows, n_tile):
    rng = np.random.default_rng(W)
    x = (rng.standard_normal((B, W)) * rng.uniform(0.1, 10, (B, 1))).astype(
        np.float32)
    x[:block_rows] = 0.0                 # an all-zero row block
    q, s = Q.quantize_blocks(_t(x), block_rows, n_tile)
    jq, js = J_Q.quantize_blocks(jnp.asarray(x), block_rows, n_tile)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert not q[:block_rows].any()      # zeros quantize to exact zeros
    d = Q.dequantize_blocks(q, s, block_rows, n_tile)
    jd = J_Q.dequantize_blocks(jq, js, block_rows, n_tile)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert Q.block_scale_bound(_t(x), block_rows, n_tile) == \
        J_Q.block_scale_bound(jnp.asarray(x), block_rows, n_tile)


def test_coeff_primitives_match_reference():
    rng = np.random.default_rng(5)
    cf = (rng.standard_normal((4, 24, 4))
          * np.array([1e-3, 1.0, 30.0, 0.0])[:, None, None]).astype(
        np.float32)                      # per-stage scales, an all-zero one
    q, s = Q.quantize_coeffs(_t(cf))
    jq, js = J_Q.quantize_coeffs(jnp.asarray(cf))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[:, 0])
    assert not q[3].any()
    np.testing.assert_array_equal(
        Q.dequantize_coeffs(q, s).numpy(),
        np.asarray(J_Q.dequantize_coeffs(jq, js)))


def test_nonfinite_blocks_match_reference():
    """A NaN or an Inf in a block reaches its scale (the absmax keeps it,
    as ``jnp.max`` does), every code of the block is 0, and the block
    dequantizes to NaN; other blocks are untouched.  Bitwise the
    reference, NaN equal to NaN."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((16, 48)).astype(np.float32)
    x[1, 3], x[2, 7] = np.nan, np.inf       # block (0, 0): NaN and Inf
    x[9, 20] = -np.inf                      # block (1, 1): -Inf alone
    q, s = Q.quantize_blocks(_t(x), 8, 16)
    jq, js = J_Q.quantize_blocks(jnp.asarray(x), 8, 16)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert np.isnan(s[0, 0]) and np.isinf(s[1, 1])
    assert not q[:8, :16].any() and not q[8:, 16:32].any()
    d = Q.dequantize_blocks(q, s, 8, 16).numpy()
    assert np.isnan(d[:8, :16]).all() and np.isnan(d[8:, 16:32]).all()
    assert np.isfinite(d[:8, 16:]).all() and np.isfinite(d[8:, :16]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [64, 96, 2048, 6144])
def test_scale_grid_matches_reference(n, dtype):
    """The rows that share a scale, for each row count, from the port's
    own plan: equal to the reference's ``pick_block_rows_for_plan`` over
    the reference's plan (which is the same plan)."""
    strides = T_pair.make_schedule("butterfly", n,
                                   T_pair.default_n_stages(n)).strides()
    nbytes = 4 if dtype == torch.float32 else 2
    for rows in (3, 8, 32, 512, 4096):
        runs = T_ops.plan_runs_for_rows(n, strides, rows)
        jruns = J_ops.plan_runs_for_rows(n, strides, rows, nbytes)
        assert runs == jruns, (rows, runs, jruns)
        assert Q.scale_block_rows(runs, rows, nbytes) == \
            J_ops.pick_block_rows_for_plan(jruns, rows, nbytes), rows


# ---------------------------------------------------------------------------
# K1 / K2 int8 plain versions against the interpret-mode kernels
# ---------------------------------------------------------------------------

INT8_CASES = {
    # n, n_tile, strides, real rows, scale rows, in_width, out_width, bias
    "edge-tile": (32, 16, (1, 2, 4, 8), 16, 8, 20, 12, 0.1),
    "kv-half-tile": (64, 64, (1, 2, 4, 8, 16, 32), 8, 8, None, 32, 0.1),
    "padded-rows": (32, 32, (1, 2, 4, 8, 16), 5, 8, None, None, 2.0),
}


def _int8_case(case, x_scale_of=1.0):
    n, nt, strides, rows, sr, in_w, out_w, bscale = INT8_CASES[case]
    rng = np.random.default_rng(len(case))
    L = len(strides)
    cf = _rot(rng, L, n)
    d_in, d_out = _vec(rng, n), _vec(rng, n)
    bias = (bscale * rng.standard_normal(n)).astype(np.float32)
    x = np.zeros((-(-rows // sr) * sr, in_w or n), np.float32)
    x[:rows] = x_scale_of * rng.standard_normal((rows, in_w or n))
    qx, xs = Q.quantize_blocks(_t(x), sr, nt)
    qc, sc = Q.quantize_coeffs(_t(cf))
    kw = dict(strides=strides, n_tile=nt,
              in_width=None if in_w in (None, n) else in_w,
              out_width=None if out_w in (None, n) else out_w)
    return (n, nt, L, sr, x, cf, d_in, d_out, bias, qx, xs, qc, sc, kw)


def _check_codes(q, s, q_ref, s_ref, z, nt, sr, depth):
    """Scales within the f32 error of the absmax they divide (one
    rounding each side, at most 2 ulps apart); codes equal but for flips
    of one where v = z / s lies within the f32 error of z (over s) plus
    the scales' difference (times |v| <= 127) of a half-integer.  Returns
    the count of flips."""
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


@pytest.mark.parametrize("case", list(INT8_CASES))
def test_k1_int8_plain_matches_interpret_kernel(case):
    """int8 x, int8 table, requantizing store.  The output scales cover
    the whole tile (lanes past out_width included) and the zero rows the
    caller padded (which come out as the bias)."""
    (n, nt, L, sr, x, cf, d_in, d_out, bias, qx, xs, qc, sc,
     kw) = _int8_case(case)
    jq, js = J_K.spm_stack_kernel_call(
        jnp.asarray(qx.numpy()), jnp.asarray(qc.numpy()), d_in=d_in,
        d_out=d_out, bias=bias, x_scale=jnp.asarray(xs.numpy()),
        coeff_scale=jnp.asarray(sc.numpy()).reshape(-1, 1),
        block_rows=sr, quant_out=True, interpret=True, **kw)
    q, s = K.spm_stack_plain(qx, qc, _t(d_in), _t(d_out), _t(bias), xs, sc,
                             quant_out=True, scale_rows=sr, **kw)
    assert q.dtype == torch.int8 and q.shape == jq.shape
    assert s.shape == js.shape
    # the f32 values the codes round, over whole tiles
    z = K.spm_stack_plain(Q.dequantize_blocks(qx, xs, sr, nt),
                          Q.dequantize_coeffs(qc, sc), _t(d_in), _t(d_out),
                          _t(bias), strides=kw["strides"],
                          in_width=kw["in_width"]).numpy()
    flips = _check_codes(q, s, jq, js, z, nt, sr, 3 * L + 3)
    print(f"{case}: {flips} flips of {q.numel()} codes")


def test_k1_int8_nonfinite_store_matches_interpret_kernel():
    """The requantizing store on scale blocks holding non-finite values:
    d_out puts a NaN and an Inf in tile 0 and an Inf alone in tile 1 (of
    four).  The absmax keeps them (a NaN or Inf scale, every code 0, the
    block NaN once dequantized) and tiles 2-3 stay finite; codes and
    scales bitwise the reference's, NaN equal to NaN.  The kernel is held
    to this plain version on the card (tests/test_torch_gpu.py)."""
    n, nt, sr, rows = 64, 16, 8, 16
    strides = (1, 2, 4, 8)
    rng = np.random.default_rng(13)
    qx, xs = Q.quantize_blocks(_t(rng.standard_normal((rows, n)).astype(
        np.float32)), sr, nt)
    qc, sc = Q.quantize_coeffs(_t(_rot(rng, len(strides), n)))
    d_out = np.ones(n, np.float32)
    d_out[3], d_out[9], d_out[nt + 2] = np.nan, np.inf, np.inf
    jq, js = J_K.spm_stack_kernel_call(
        jnp.asarray(qx.numpy()), jnp.asarray(qc.numpy()), d_out=d_out,
        x_scale=jnp.asarray(xs.numpy()),
        coeff_scale=jnp.asarray(sc.numpy()).reshape(-1, 1), strides=strides,
        n_tile=nt, block_rows=sr, quant_out=True, interpret=True)
    q, s = K.spm_stack_plain(qx, qc, None, _t(d_out), None, xs, sc,
                             strides=strides, n_tile=nt, quant_out=True,
                             scale_rows=sr)
    jq, js = np.asarray(jq), np.asarray(js)
    np.testing.assert_array_equal(q[:, :2 * nt].numpy(), jq[:, :2 * nt])
    np.testing.assert_array_equal(s[:, :2].numpy(), js[:, :2])
    assert np.isnan(s[:, 0]).all() and np.isinf(s[:, 1]).all()
    assert not q[:, :2 * nt].any() and q[:, 2 * nt:].any()
    # the finite tiles as in the test above: scales within 2 ulps, codes
    # but for counted flips next to a half-integer
    z = K.spm_stack_plain(Q.dequantize_blocks(qx, xs, sr, nt),
                          Q.dequantize_coeffs(qc, sc), None, _t(d_out),
                          strides=strides).numpy()
    _check_codes(q[:, 2 * nt:], s[:, 2:], jq[:, 2 * nt:], js[:, 2:],
                 z[:, 2 * nt:], nt, sr, 3 * len(strides) + 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(INT8_CASES))
def test_k1_int8_coeffs_plain_matches_interpret_kernel(case, dtype):
    """An int8 table with f32/bf16 activation I/O (the FFN's mode)."""
    (n, nt, L, sr, x, cf, d_in, d_out, bias, qx, xs, qc, sc,
     kw) = _int8_case(case)
    ref = J_K.spm_stack_kernel_call(
        jnp.asarray(x, _jdt(dtype)), jnp.asarray(qc.numpy()), d_in=d_in,
        d_out=d_out, bias=bias,
        coeff_scale=jnp.asarray(sc.numpy()).reshape(-1, 1),
        block_rows=sr, interpret=True, **kw)
    got = K.spm_stack_plain(_t(x).to(dtype), qc, _t(d_in), _t(d_out),
                            _t(bias), None, sc, **kw)
    assert got.dtype == dtype
    ref = _np(ref)
    tol = 8 * ((3 * L + 3) * EPS32 + float(torch.finfo(dtype).eps)) * (
        np.abs(ref).max() + 1)
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(INT8_CASES))
def test_k2_int8_plain_matches_interpret_kernel(case, dtype):
    """The backward from a saved int8 x and an int8 table: g_x in gy's
    dtype, grads of the dequantized table; f32 bounds as K2's (the inputs
    are the same int8 codes on both sides)."""
    (n, nt, L, sr, x, cf, d_in, d_out, bias, qx, xs, qc, sc,
     kw) = _int8_case(case)
    rng = np.random.default_rng(7)
    gy = rng.standard_normal((qx.shape[0], kw["out_width"] or n)).astype(
        np.float32)
    ref = J_K.spm_stack_bwd_kernel_call(
        jnp.asarray(qx.numpy()), jnp.asarray(qc.numpy()),
        jnp.asarray(gy, _jdt(dtype)), d_in=d_in, d_out=d_out,
        x_scale=jnp.asarray(xs.numpy()),
        coeff_scale=jnp.asarray(sc.numpy()).reshape(-1, 1), block_rows=sr,
        has_bias=True, interpret=True, **kw)
    got = K.spm_stack_bwd_plain(qx, qc, _t(gy).to(dtype), _t(d_in),
                                _t(d_out), xs, sc, has_bias=True,
                                scale_rows=sr, **kw)
    assert len(got) == len(ref) == 5 and got[0].dtype == dtype
    depth = 3 * L + 3
    for i, (g, r) in enumerate(zip(got, ref)):
        r = _np(r)
        d = depth + (qx.shape[0] if i else 0)
        tol = 8 * (d * EPS32 + float(torch.finfo(dtype).eps)) * (
            np.abs(r).max() + 1)
        np.testing.assert_allclose(_np(g), r, rtol=0, atol=tol)


def test_int8_wrappers_check_their_operands():
    (n, nt, L, sr, x, cf, d_in, d_out, bias, qx, xs, qc, sc,
     kw) = _int8_case("edge-tile")
    with pytest.raises(TypeError, match="x_scale"):
        K.spm_stack_kernel_call(qx, qc, None, None, None, None, sc,
                                quant_out=True, scale_rows=sr, **kw)
    with pytest.raises(ValueError, match="quant_out"):
        K.spm_stack_kernel_call(qx, qc, None, None, None, xs, sc,
                                scale_rows=sr, **kw)
    with pytest.raises(TypeError, match="coeff"):
        K.spm_stack_kernel_call(qx, _t(cf), None, None, None, xs, sc,
                                quant_out=True, scale_rows=sr, **kw)
    with pytest.raises(ValueError, match="multiple"):
        K.spm_stack_kernel_call(qx[:-1], qc, None, None, None, xs, sc,
                                quant_out=True, scale_rows=sr, **kw)


# ---------------------------------------------------------------------------
# the fused entry against jax.vjp
# ---------------------------------------------------------------------------

FUSED_CASES = {
    # n, strides, rows, in_width, out_width
    "square-padded": (64, (1, 2, 4, 8, 16, 32), 12, 64, 64),
    "rect-up": (96, (1, 2, 4, 8, 16, 48, 24), 16, 64, 96),
    "rect-down": (96, (1, 2, 4, 8, 16, 48, 24), 16, 96, 64),
}


@pytest.mark.parametrize("mode", ["acts", "coeffs", "both"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_quant_matches_reference_vjp(case, dtype, mode):
    """Outputs and every grad of ``spm_stack_fused(quant_acts,
    quant_coeffs)`` against ``jax.vjp`` of the reference's, whose
    ``block_rows`` is the port's ``scale_block_rows``.  The plans here are
    one run, so the entry codes are equal on both sides and only the
    output codes can flip: an output within its f32 bound plus one step
    of its block (the exit dequantizes q * s, so a flip moves it by s).
    The backward remats from the same saved codes: f32 bounds."""
    n, strides, rows, in_w, out_w = FUSED_CASES[case]
    qa, qc = mode in ("acts", "both"), mode in ("coeffs", "both")
    rng = np.random.default_rng(rows + in_w + out_w)
    L = len(strides)
    runs = T_ops.plan_runs_for_rows(n, strides, rows)
    assert len(runs) == 1 and quant_acts_eligible(runs)
    sr = Q.scale_block_rows(runs, rows, 4 if dtype == torch.float32 else 2)
    args = [rng.standard_normal((rows, in_w)).astype(np.float32),
            _rot(rng, L, n), _vec(rng, n), _vec(rng, n),
            _vec(rng, n, 0.0, 0.3)]
    gy = rng.standard_normal((rows, out_w)).astype(np.float32)
    jdt = _jdt(dtype)

    def j_fn(x, c, di, do, b):
        return J_ops.spm_stack_fused(x, c, strides, d_in=di, d_out=do,
                                     bias=b, in_width=in_w, out_width=out_w,
                                     block_rows=sr, quant_acts=qa,
                                     quant_coeffs=qc, interpret=True)

    jargs = [jnp.asarray(args[0], jdt)] + [jnp.asarray(a) for a in args[1:]]
    y_ref, vjp = jax.vjp(j_fn, *jargs)
    ref = vjp(jnp.asarray(gy, jdt))
    targs = [_t(args[0]).to(dtype)] + [_t(a) for a in args[1:]]
    for a in targs:
        a.requires_grad_(True)
    y = T_ops.spm_stack_fused(targs[0], *targs[1:2], strides,
                              d_in=targs[2], d_out=targs[3], bias=targs[4],
                              in_width=in_w, out_width=out_w,
                              quant_acts=qa, quant_coeffs=qc)
    y.backward(_t(gy).to(dtype))
    assert y.dtype == dtype and y.shape == (rows, out_w)
    y_ref = _np(y_ref)
    io = float(torch.finfo(dtype).eps)
    f32 = 8 * ((3 * L + 3) * EPS32 + io) * (np.abs(y_ref).max() + 1)
    tol = f32
    if qa:
        _, s = Q.quantize_blocks(
            T_ops._pad_rows(_t(y_ref), sr), sr, runs[0][1])
        tol = f32 + np.repeat(s.numpy(), sr, axis=0)[:rows].max() * (1 + io)
    np.testing.assert_allclose(_np(y.detach()), y_ref, rtol=0, atol=tol)
    for i, (a, r) in enumerate(zip(targs, ref)):
        r = _np(r)
        assert a.grad.dtype == a.dtype
        d = 3 * L + 3 + (rows if i else 0)
        np.testing.assert_allclose(
            _np(a.grad), r, rtol=0,
            atol=8 * (d * EPS32 + io) * (np.abs(r).max() + 1), err_msg=i)


def test_quant_acts_on_a_non_uniform_plan_falls_back_bitwise():
    """Runs of two tiles cannot chain int8 scales: the activations stay
    f32, bit for bit the unquantized path, as in the reference."""
    B, n, strides = 64, 4096, (1, 2048)
    runs = T_ops.plan_runs_for_rows(n, strides, B)
    assert not quant_acts_eligible(runs)
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((B, n)).astype(np.float32))
    cf = _t((0.4 * rng.standard_normal((2, n // 2, 4))).astype(np.float32))
    assert torch.equal(T_ops.spm_stack_fused(x, cf, strides),
                       T_ops.spm_stack_fused(x, cf, strides,
                                             quant_acts=True))


def test_spm_stack_fused_q8_matches_reference():
    """int8 in, int8 out over a whole plan: codes against the reference's
    entry as in the K1 test (flips of one, each next to a half-integer),
    and a non-uniform plan raises."""
    B, n, strides, sr = 16, 128, (1, 2, 4, 8, 16, 32, 64), 8
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, n)).astype(np.float32)
    cf = _rot(rng, len(strides), n)
    di, do = _vec(rng, n), _vec(rng, n)
    bias = _vec(rng, n, 0.0)
    (run,) = T_ops.plan_runs_for_rows(n, strides, B)
    qx, xs = Q.quantize_blocks(_t(x), sr, run[1])
    q, s = T_ops.spm_stack_fused_q8(qx, xs, _t(cf), strides, d_in=_t(di),
                                    d_out=_t(do), bias=_t(bias))
    jq, js = J_ops.spm_stack_fused_q8(
        jnp.asarray(qx.numpy()), jnp.asarray(xs.numpy()), jnp.asarray(cf),
        strides, d_in=di, d_out=do, bias=bias, interpret=True)
    qc, sc = Q.quantize_coeffs(_t(cf))
    z = K.spm_stack_plain(Q.dequantize_blocks(qx, xs, sr, run[1]),
                          Q.dequantize_coeffs(qc, sc), _t(di), _t(do),
                          _t(bias), strides=strides).numpy()
    _check_codes(q, s, jq, js, z, run[1], sr, 3 * len(strides) + 3)
    with pytest.raises(ValueError, match="uniform"):
        T_ops.spm_stack_fused_q8(
            Q.quantize_blocks(_t(rng.standard_normal((64, 4096)).astype(
                np.float32)), 8, 2048)[0],
            torch.ones(8, 2), torch.ones(2, 2048, 4), (1, 2048))


# ---------------------------------------------------------------------------
# the quantized smoke model
# ---------------------------------------------------------------------------

def _reference_codes(monkeypatch) -> list:
    """Every requantizing K1 call of the reference from now on, in the
    order it runs: (entry codes, entry scales, output codes, output
    scales), through an ordered debug callback, which runs inside scan,
    vjp and jit.  Every smoke plan is one run, so a call is a chain."""
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
    """The codes that differ between the port's chains (``CodeTape``) and
    the reference's, entries and outputs; each must differ by one."""
    assert len(port) == len(ref) > 0
    total = 0
    for p, r in zip(port, ref):
        for a, b in ((p[0], r[0]), (p[2], r[2])):
            a = a.numpy().astype(np.int32)
            b = b.astype(np.int32)
            assert a.shape == b.shape
            d = np.abs(a - b)
            assert d.max() <= 1
            total += int((d != 0).sum())
    return total


def _depth(cfg) -> int:
    """Dependent f32 roundings through the smoke model's forward, as
    ``tests/test_torch_train.py`` counts them."""
    L_attn, L_ffn = 6, 7
    per_layer = (cfg.d_model + 3 * L_attn + 8 + cfg.head_dim + 32
                 + 3 * L_attn + 3 * (3 * L_ffn + 4) + cfg.d_model)
    return cfg.n_layers * per_layer + 2 * cfg.d_model


@pytest.fixture(scope="module")
def quant_pair():
    jcfg = j_quantized(dataclasses.replace(
        j_get_smoke("qwen3-1.7b", use_kernel=True), spm_block_fuse=True))
    jparams = J_T.init_model(jax.random.PRNGKey(0), jcfg)
    tcfg = with_quantized_io(get_smoke("qwen3-1.7b"))
    return jcfg, jparams, tcfg


def _port_params(jparams, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                           device="cpu")


def test_convert_needs_nothing_for_quantized_configs(quant_pair):
    """The int8 tables derive from the f32 parameters, so a quantized
    config's parameters are the unquantized config's, tensor for tensor."""
    jcfg, jparams, tcfg = quant_pair
    plain_cfg = dataclasses.replace(jcfg, spm_quant_acts=False,
                                    spm_quant_coeffs=False)
    jplain = J_T.init_model(jax.random.PRNGKey(0), plain_cfg)
    a = _port_params(jparams, tcfg).state_dict()
    b = _port_params(jplain, get_smoke("qwen3-1.7b")).state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_quantized_smoke_logits_match_reference(quant_pair, monkeypatch):
    """The forward logits of the quantized smoke model within the f32
    depth bound plus one step for each code that differs from the
    reference's; every linear moved int8 activations.  The unquantized
    model's logits must fall outside that bound."""
    jcfg, jparams, tcfg = quant_pair
    ref_codes = _reference_codes(monkeypatch)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 16))
    jlog = np.asarray(J_T.forward(jparams, jcfg,
                                  tokens=jnp.asarray(tokens))[0], np.float32)
    jax.effects_barrier()
    params = _port_params(jparams, tcfg)
    with torch.no_grad(), CodeTape() as tape:
        tlog = T.forward(params, tcfg, tokens=torch.from_numpy(tokens))[0]
    assert len(tape.calls) == 7 * tcfg.n_layers
    assert all(c[0].dtype == torch.int8 for c in tape.calls)
    flips = _flips(tape.calls, ref_codes)
    rel = 8 * _depth(tcfg) * EPS32 + flips * STEP
    limit = rel * np.abs(jlog).max()
    np.testing.assert_allclose(tlog.float().numpy(), jlog, rtol=0,
                               atol=limit)
    with torch.no_grad():
        plain = T.forward(_port_params(jparams, get_smoke("qwen3-1.7b")),
                          get_smoke("qwen3-1.7b"),
                          tokens=torch.from_numpy(tokens))[0]
    gap = np.abs(plain.float().numpy() - jlog).max()
    err = np.abs(tlog.float().numpy() - jlog).max()
    top = np.abs(jlog).max()
    print(f"logits: {err / top:.3e} of max|logit| (limit {rel:.3e}, "
          f"{flips} codes differ); unquantized model {gap / top:.3e}")
    assert gap > limit


def test_three_quantized_smoke_steps_match_reference(quant_pair,
                                                     monkeypatch):
    """Three ``--quantize`` training steps: loss and grad norm at each
    step, the step-0 grads and the params after each step, within the
    forward and backward f32 bound plus one step for each code of the
    step (forward and remat) that differs from the reference's.  From the
    first state, a step on half the batch and a step with a 1.4x learning
    rate must move the params outside that bound."""
    jcfg, jparams, tcfg = quant_pair
    ref_codes = _reference_codes(monkeypatch)
    opt = dict(lr=1e-2, total_steps=3, warmup_steps=1)
    jstep = jax.jit(j_make_step(lambda p, b: J_LM.lm_loss(p, b, jcfg),
                                J_opt.OptimizerConfig(**opt),
                                chaos_guard=True))

    def tstep_for(**kw):
        return make_train_step(lambda p, b: LM.lm_loss(p, b, tcfg),
                               T_opt.OptimizerConfig(**dict(opt, **kw)),
                               chaos_guard=True)
    tstep = tstep_for()
    jstate = j_make_state(jparams)
    tstate = make_train_state(_port_params(jparams, tcfg))
    flat = (lambda tree: {k: v.detach().clone()  # noqa: E731
                          for k, v in tree.state_dict().items()})
    p0 = flat(tstate["params"])
    loader = DeterministicLoader(
        launch_train.make_batch_fn(tcfg, 16, build_corpus(20_000, seed=0)),
        4, seed=0)
    f32 = 8 * 2 * _depth(tcfg) * EPS32

    def params_gap(got, ref):
        diff = math.sqrt(sum(float(((got[k] - ref[k]) ** 2).sum())
                             for k in ref))
        moved = math.sqrt(sum(float(((ref[k] - p0[k]) ** 2).sum())
                              for k in ref))
        return diff / moved

    for s in range(3):
        batch = loader.batch_at(s)
        jb = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()}
        if s == 0:
            jg = jax.grad(lambda p: J_LM.lm_loss(p, jb, jcfg)[0])(
                jstate["params"])
            jax.effects_barrier()
            jg = flat(_port_params(jg, tcfg))
            with CodeTape() as tape:
                loss, _ = LM.lm_loss(tstate["params"], batch, tcfg)
                loss.backward()
            rel = f32 + _flips(tape.calls, ref_codes) * STEP
            for k, p in tstate["params"].named_parameters():
                np.testing.assert_allclose(
                    p.grad.numpy(), jg[k].numpy(), rtol=0,
                    atol=rel * (float(jg[k].abs().max()) + 1e-6), err_msg=k)
            # planted faults, each from a copy of the first state
            faults = []
            for kw, b in (({}, {k: v[:2] for k, v in batch.items()}),
                          ({"lr": 1.4e-2}, batch)):
                st = make_train_state(_port_params(jparams, tcfg))
                tstep_for(**kw)(st, b, 0.0)
                faults.append(flat(st["params"]))
        ref_codes.clear()
        jstate, jm = jstep(jstate, jb, 0.0)
        jax.effects_barrier()
        with CodeTape() as tape:
            tstate, tm = tstep(tstate, batch, 0.0)
        rel = f32 + _flips(tape.calls, ref_codes) * STEP
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=rel, err_msg=f"step {s} {k}")
        assert float(tm["skipped"]) == 0.0
        ref = flat(_port_params(jstate["params"], tcfg))
        gap = params_gap(flat(tstate["params"]), ref)
        print(f"step {s}: params {gap:.3e} of the update (limit {rel:.3e})")
        assert gap <= rel, s
        if s == 0:
            gaps = [params_gap(f, ref) for f in faults]
            print(f"half the batch {gaps[0]:.3e}, 1.4x update {gaps[1]:.3e}")
            assert all(g > rel for g in gaps)


def test_code_tape_replays_and_catches_a_planted_fault(quant_pair,
                                                       monkeypatch):
    """A replay of a recording on the same side gives the same logits and
    codes bit for bit; a chain whose output scales are off by one f32 ulp
    on the replaying side is reported as differing."""
    _, jparams, tcfg = quant_pair
    params = _port_params(jparams, tcfg)
    tokens = torch.arange(32).reshape(2, 16) % tcfg.vocab_size

    def run():
        with torch.no_grad():
            return T.forward(params, tcfg, tokens=tokens)[0]
    with CodeTape() as rec:
        want = run()
    with CodeTape(replay=rec) as same:
        got = run()
    assert torch.equal(got, want)
    assert same.summary() == dict(
        chains=7 * tcfg.n_layers, recorded=7 * tcfg.n_layers,
        codes=same.summary()["codes"], entry_flips=0, entry_max_diff=0,
        out_differ=0)
    real = K.spm_stack_plain

    def off_by_an_ulp(*a, **k):
        out = real(*a, **k)
        if k.get("quant_out"):
            return out[0], torch.nextafter(out[1], out[1] + 1)
        return out
    monkeypatch.setattr(K, "spm_stack_plain", off_by_an_ulp)
    with CodeTape(replay=rec) as bad:
        run()
    assert bad.summary()["out_differ"] == 7 * tcfg.n_layers


def test_nan_inside_quantized_model_skips_the_step(quant_pair):
    """A NaN made inside the network (a d_out lane of one layer's o
    projection) reaches the next requantizing store, whose block scale
    keeps it: the loss is not finite, the guarded step skips, and the
    state is unchanged."""
    _, jparams, tcfg = quant_pair
    state = make_train_state(_port_params(jparams, tcfg))
    d_out = dict(state["params"].named_parameters())[
        "layers.0.mixer.o.d_out"]
    with torch.no_grad():
        d_out[5] = float("nan")
    before = {k: v.clone() for k, v in state["params"].state_dict().items()}
    step = make_train_step(lambda p, b: LM.lm_loss(p, b, tcfg),
                           T_opt.OptimizerConfig(), chaos_guard=True)
    batch = DeterministicLoader(launch_train.make_batch_fn(
        tcfg, 16, build_corpus(20_000, seed=0)), 2, seed=0).batch_at(0)
    state, m = step(state, batch, 0.0)
    assert not math.isfinite(float(m["loss"])) and float(m["skipped"]) == 1
    after = state["params"].state_dict()
    for k, v in before.items():        # NaN equal to NaN
        assert torch.equal(after[k].isnan(), v.isnan()), k
        assert torch.equal(after[k].nan_to_num(), v.nan_to_num()), k


def test_launch_train_quantize_on_cpu(capsys):
    args = launch_train.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--quantize", "--steps", "2",
         "--batch", "2", "--seq", "8", "--log-every", "1"])
    seen = []
    state = launch_train.train(
        args, on_step=lambda s, st, m, dt: seen.append(m["loss"]))
    assert len(seen) == 2 and all(np.isfinite(v) for v in seen)
    assert int(state["step"]) == 2
    assert "quantize=True" in capsys.readouterr().out


def test_launch_train_quantize_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = argparse.Namespace(**vars(launch_train.build_parser().parse_args(
        ["--smoke", "--quantize"])))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.train(args)
