"""Parity of the PyTorch port's backward with the JAX reference, on the CPU.

* the stack's closed-form VJP oracle (``ref.spm_stack_grads_ref``) against
  the reference's;
* K2's plain version (``spm_stack_bwd_plain``) against the reference's
  ``spm_stack_bwd_kernel_call`` in Pallas interpret mode: rectangular
  widths, multi-tile runs, the ``dead_from`` skip, the tiny-row wide run;
* K4's plain version (``spm_block_bwd_plain``) against
  ``spm_block_bwd_kernel_call`` in interpret mode, in every form, with the
  padded-lane grads exactly zero;
* the autograd entries ``spm_stack_fused`` and ``spm_block_fused`` against
  ``jax.vjp`` of the reference's entries, including the n=6144 two-run plan;
* the composition's ``custom`` and ``custom_inverse`` backwards and
  ``spm_matrix``.

Inputs come from numpy with fixed seeds.  Tolerances are derived as in
``tests/test_torch_spm.py``: ``depth`` dependent f32 roundings plus the
I/O roundings, at the reference's scale, times 8.  A parameter grad sums
one term per row, so its depth adds the row count.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import spm as J_spm  # noqa: E402
from repro.kernels import ops as J_ops  # noqa: E402
from repro.kernels import spm_stack as J_K  # noqa: E402
from repro.kernels.ref import spm_stack_grads_ref as j_grads_ref  # noqa: E402
from repro_torch.core import spm as T_spm  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.kernels import spm_stack as K  # noqa: E402
from repro_torch.kernels.ref import spm_stack_grads_ref  # noqa: E402
from repro_torch.params import Params  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)
FFN_STRIDES = tuple(1 << i for i in range(11)) + (3072,)


def _tol(io_dtype, depth, ref, io_roundings=1):
    scale = float(np.max(np.abs(ref))) + 1.0
    return 8 * (depth * EPS32
                + io_roundings * float(torch.finfo(io_dtype).eps)) * scale


def _jdt(dtype):
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _vec(rng, n, base=1.0, scale=0.1):
    return (base + scale * rng.standard_normal(n)).astype(np.float32)


def _close(got, ref, dtype, depth, io_roundings=1):
    ref = _np(ref)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=_tol(dtype, depth, ref, io_roundings))


# ---------------------------------------------------------------------------
# the closed-form oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lead,n,strides", [
    ((6,), 16, (1, 2, 4, 8)),
    ((2, 3), 24, (4, 1, 12, 2)),
])
def test_stack_grads_ref_matches_reference(lead, n, strides):
    """g_x within the walk's depth (L products and sums a lane); g_coeffs
    sums one term per leading element on top of it."""
    rng = np.random.default_rng(n)
    L = len(strides)
    cf = (0.6 * rng.standard_normal((L, n // 2, 4))).astype(np.float32)
    x = rng.standard_normal(lead + (n,)).astype(np.float32)
    gy = rng.standard_normal(lead + (n,)).astype(np.float32)
    rgx, rgcf = j_grads_ref(jnp.asarray(x), jnp.asarray(cf), strides,
                            jnp.asarray(gy))
    gx, gcf = spm_stack_grads_ref(_t(x), _t(cf), strides, _t(gy))
    _close(gx, rgx, torch.float32, 4 * L, io_roundings=0)
    _close(gcf, rgcf, torch.float32, 4 * L + int(np.prod(lead)),
           io_roundings=0)


# ---------------------------------------------------------------------------
# K2: plain version vs the reference's interpret-mode backward kernel
# ---------------------------------------------------------------------------

K2_CASES = {
    # n, n_tile, strides, rows, in_width, out_width, dead_from
    "rect-multitile": (32, 8, (1, 2, 4), 8, 20, 12, None),
    "square-multitile": (32, 8, (4, 1, 2), 8, None, None, None),
    "dead-from": (32, 8, (1, 2, 4), 8, None, None, 16),
    "narrow-in-widened-gx": (32, 8, (2, 1), 8, 6, None, None),
    "tiny-row-wide-run": (48, 48, (1, 2, 4, 8, 24, 3), 4, 16, 48, None),
    "dead-tile-skip": (64, 16, (1, 2, 4, 8), 8, None, 16, None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_plain_matches_interpret_kernel(case, dtype):
    n, nt, strides, rows, in_w, out_w, dead = K2_CASES[case]
    rng = np.random.default_rng(len(case))
    L = len(strides)
    cf = (0.6 * rng.standard_normal((L, n // 2, 4))).astype(np.float32)
    d_in, d_out = _vec(rng, n), _vec(rng, n)
    x = rng.standard_normal((rows, in_w or n)).astype(np.float32)
    gy = rng.standard_normal((rows, out_w or n)).astype(np.float32)
    if dead is not None:
        gy[:, dead:] = 0.0           # an upstream run's cotangent
    jx, jgy = (jnp.asarray(a, _jdt(dtype)) for a in (x, gy))
    kw = dict(strides=strides, n_tile=nt, has_bias=True,
              in_width=None if in_w in (None, n) else in_w,
              out_width=None if out_w in (None, n) else out_w,
              dead_from=dead)
    ref = J_K.spm_stack_bwd_kernel_call(
        jx, jnp.asarray(cf), jgy, d_in=_j(d_in), d_out=_j(d_out),
        block_rows=rows, interpret=True, **kw)
    got = K.spm_stack_bwd_plain(
        torch.from_numpy(x).to(dtype), _t(cf),
        torch.from_numpy(gy).to(dtype), _t(d_in), _t(d_out), **kw)
    assert len(got) == len(ref) == 5
    assert got[0].dtype == dtype
    depth = 3 * L + 3
    _close(got[0], ref[0], dtype, depth)
    for g, r in zip(got[1:], ref[1:]):
        assert g.dtype == torch.float32
        _close(g, r, dtype, depth + rows)
    vis, _ = K.bwd_live_tiles(n, nt, kw["in_width"], kw["out_width"], dead)
    if vis * nt < n:                 # the skipped tiles: exact zeros
        assert not got[1][:, vis * nt // 2:].any()
        for v in got[2:]:
            assert not v[vis * nt:].any()


# ---------------------------------------------------------------------------
# K4: plain version vs the reference's interpret-mode block backward
# ---------------------------------------------------------------------------

K4_FORMS = {
    # two stacks, activation, residual, norm, in_w, mid_w, out_w, biases
    "qkv-norm-prologue": (False, None, False, True, 64, 48, 48, True),
    "prologue-no-bias": (False, None, False, True, 48, 40, 40, False),
    "one-stack-relu": (False, "relu", False, True, 64, 40, 40, True),
    "relu-residual": (True, "relu", True, True, 48, 40, 48, True),
    "silu-residual": (True, "silu", True, True, 48, 40, 48, True),
    "gelu-residual": (True, "gelu", True, True, 48, 40, 48, True),
    "silu-narrow-out": (True, "silu", False, True, 64, 40, 30, True),
    "gelu-no-norm": (True, "gelu", False, False, 64, 50, 56, False),
}


def _block_operands(rng, n, L, form):
    two, act, res, norm, in_w, mid_w, out_w, biases = form
    ops = {"coeffs1": (0.5 * rng.standard_normal((L, n // 2, 4))
                       ).astype(np.float32),
           "d_in1": _vec(rng, n), "d_out1": _vec(rng, n),
           "bias1": _vec(rng, n, 0.0) if biases else None}
    if norm:
        g = np.zeros(n, np.float32)
        g[:in_w] = _vec(rng, in_w)
        ops["gamma"] = g
    if two:
        ops.update(coeffs2=(0.5 * rng.standard_normal((L, n // 2, 4))
                            ).astype(np.float32),
                   d_in2=_vec(rng, n), d_out2=_vec(rng, n),
                   bias2=_vec(rng, n, 0.0) if biases else None)
    statics = dict(strides2=None, activation=act, residual=res,
                   in_width=in_w, mid_width=mid_w, out_width=out_w)
    return ops, statics


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", list(K4_FORMS))
def test_k4_plain_matches_interpret_kernel(form, dtype):
    n, rows = 64, 8
    strides = (1, 2, 4, 8, 16, 32)
    rng = np.random.default_rng(len(form) + 3)
    ops, st = _block_operands(rng, n, len(strides), K4_FORMS[form])
    two = "coeffs2" in ops
    st.update(strides1=strides, strides2=strides if two else None)
    x = rng.standard_normal((rows, st["in_width"])).astype(np.float32)
    gy = rng.standard_normal((rows, st["out_width"])).astype(np.float32)
    jx, jgy = (jnp.asarray(a, _jdt(dtype)) for a in (x, gy))
    jops = {k: _j(v) for k, v in ops.items()}
    fwd = J_K.spm_block_kernel_call(jx, block_rows=rows, interpret=True,
                                    **jops, **st)
    rstd = fwd[1] if "gamma" in ops else None
    ref = J_K.spm_block_bwd_kernel_call(jx, jgy, rstd=rstd, block_rows=rows,
                                        interpret=True, **jops, **st)
    got = K.spm_block_bwd_plain(
        torch.from_numpy(x).to(dtype), torch.from_numpy(gy).to(dtype),
        rstd=_t(rstd), **{k: _t(v) for k, v in ops.items()}, **st)
    assert len(got) == len(ref)
    assert got[0].dtype == dtype and got[0].shape == (rows, st["in_width"])
    depth = n + 6 * len(strides) + 16     # the row mean, both stacks
    _close(got[0], ref[0], dtype, depth)
    for g, r in zip(got[1:], ref[1:]):
        assert g.dtype == torch.float32
        _close(g, r, dtype, depth + rows)
    # padded lanes: exact zeros in every vector grad past its width
    names = (["gamma"] if "gamma" in ops else []) + ["cf1", "din1", "dout1"]
    names += ["b1"] if ops["bias1"] is not None else []
    if two:
        names += ["cf2", "din2", "dout2"]
        names += ["b2"] if ops["bias2"] is not None else []
    grads = dict(zip(names, got[1:]))
    in_w, mid_w, out_w = st["in_width"], st["mid_width"], st["out_width"]
    if "gamma" in grads:
        assert not grads["gamma"][in_w:].any()
    if two:
        assert not grads["dout2"][out_w:].any()
        if "b2" in grads:
            assert not grads["b2"][out_w:].any()
        assert not grads["dout1"][mid_w:].any()
        if "b1" in grads:
            assert not grads["b1"][mid_w:].any()
    else:
        assert not grads["dout1"][out_w:].any()


# ---------------------------------------------------------------------------
# the autograd entries against jax.vjp of the reference's entries
# ---------------------------------------------------------------------------

def _vjp_pair(j_fn, t_fn, args, gy, dtype):
    """(reference grads, port grads) of ``sum(f(*args) * gy)``; args[0]
    is the activation (cast to ``dtype``), the rest f32 parameters."""
    jargs = [jnp.asarray(args[0], _jdt(dtype))] + [_j(a) for a in args[1:]]
    y, vjp = jax.vjp(j_fn, *jargs)
    ref = vjp(jnp.asarray(gy, y.dtype))
    targs = [torch.from_numpy(args[0]).to(dtype)] + [_t(a) for a in args[1:]]
    for a in targs:
        a.requires_grad_(True)
    out = t_fn(*targs)
    out.backward(torch.from_numpy(gy).to(out.dtype))
    return ref, [a.grad for a in targs], out


@pytest.mark.parametrize("rows", [16, 4], ids=["2run", "1run"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_w, out_w", [(2048, 6144), (6144, 2048)],
                         ids=["up", "down"])
def test_spm_stack_fused_grads_match_vjp(rows, dtype, in_w, out_w):
    """n=6144, L=12, the qwen3-1.7b FFN widths: two runs at 16 rows (the
    dead-tile chain from the down projection's narrow output), one
    6144-wide run at 4."""
    n = 6144
    rng = np.random.default_rng(rows + in_w)
    cf = (0.3 * rng.standard_normal((12, n // 2, 4))).astype(np.float32)
    args = [rng.standard_normal((rows, in_w)).astype(np.float32), cf,
            _vec(rng, n), _vec(rng, n), _vec(rng, n, 0.0)]
    gy = rng.standard_normal((rows, out_w)).astype(np.float32)

    def j_fn(x, c, di, do, b):
        return J_ops.spm_stack_fused(x, c, FFN_STRIDES, d_in=di, d_out=do,
                                     bias=b, in_width=in_w,
                                     out_width=out_w, interpret=True)

    def t_fn(x, c, di, do, b):
        return T_ops.spm_stack_fused(x, c, FFN_STRIDES, d_in=di, d_out=do,
                                     bias=b, in_width=in_w,
                                     out_width=out_w)

    ref, got, _ = _vjp_pair(j_fn, t_fn, args, gy, dtype)
    n_runs = len(T_ops.plan_runs_for_rows(n, FFN_STRIDES, rows))
    assert got[0].dtype == dtype
    depth = 3 * 12 + 3
    _close(got[0], ref[0], dtype, depth, io_roundings=n_runs)
    for g, r in zip(got[1:], ref[1:]):
        assert g.dtype == torch.float32
        _close(g, r, dtype, depth + rows, io_roundings=n_runs)


@pytest.mark.parametrize("form", ["qkv-norm-prologue", "silu-residual",
                                  "gelu-no-norm"])
def test_spm_block_fused_grads_match_vjp(form):
    n, rows = 64, 6
    strides = (1, 2, 4, 8, 16, 32)
    rng = np.random.default_rng(11)
    ops, st = _block_operands(rng, n, len(strides), K4_FORMS[form])
    two = "coeffs2" in ops
    names = [k for k, v in ops.items() if v is not None]
    x = rng.standard_normal((rows, st["in_width"])).astype(np.float32)
    gy = rng.standard_normal((rows, st["out_width"])).astype(np.float32)
    kw = dict(strides1=strides, strides2=strides if two else None,
              activation=st["activation"], residual=st["residual"],
              mid_width=st["mid_width"], out_width=st["out_width"])

    def j_fn(xx, *vals):
        return J_ops.spm_block_fused(xx, **dict(zip(names, vals)), **kw,
                                     interpret=True)

    def t_fn(xx, *vals):
        return T_ops.spm_block_fused(xx, **dict(zip(names, vals)), **kw)

    ref, got, _ = _vjp_pair(j_fn, t_fn, [x] + [ops[k] for k in names], gy,
                            torch.float32)
    depth = n + 6 * len(strides) + 16
    for g, r in zip(got, ref):
        _close(g, r, torch.float32, depth + rows)


def test_autograd_entries_save_only_what_the_reference_saves():
    """spm_block_fused's backward needs x and the row statistics alone:
    with the norm, its saved activations are x (rows, in_w) and rstd
    (rows, 1); spm_stack_fused saves one input per planned run."""
    n, rows = 64, 5
    rng = np.random.default_rng(0)
    ops, st = _block_operands(rng, n, 6, K4_FORMS["silu-residual"])
    x = torch.from_numpy(rng.standard_normal((rows, 48)).astype(
        np.float32)).requires_grad_(True)
    y = T_ops.spm_block_fused(
        x, **{k: _t(v) for k, v in ops.items()}, strides1=(1, 2, 4, 8, 16,
                                                           32),
        strides2=(1, 2, 4, 8, 16, 32), activation="silu", residual=True,
        mid_width=40, out_width=48)
    node = y.grad_fn.next_functions[0][0]       # under the final reshape
    shapes = {tuple(t.shape) for t in node.saved_tensors if t is not None}
    assert (rows, 48) in shapes and (rows, 1) in shapes
    assert not any(s[0] == rows and s not in ((rows, 48), (rows, 1))
                   for s in shapes)


# ---------------------------------------------------------------------------
# the composition's closed-form backward modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant, backward, n, schedule", [
    ("general", "custom", 16, "butterfly"),
    ("general", "custom", 15, "random"),
    ("rotation", "custom_inverse", 16, "butterfly"),
    ("rotation", "custom_inverse", 15, "random"),
    ("rotation", "custom", 24, "brick"),
])
def test_composition_backward_modes_match_reference(variant, backward, n,
                                                    schedule):
    """``use_kernel=False``: the port follows ``cfg.backward`` as the
    reference's ``_make_core`` does; grads of x and of every parameter."""
    L = 4
    rng = np.random.default_rng(n + L)
    kw = dict(n=n, n_stages=L, variant=variant, backward=backward,
              schedule=schedule, use_kernel=False, seed=1)
    jc, tc = J_spm.SPMConfig(**kw), T_spm.SPMConfig(**kw)
    p = {"d_in": _vec(rng, n), "d_out": _vec(rng, n),
         "bias": _vec(rng, n, 0.0)}
    if variant == "rotation":
        p["theta"] = rng.uniform(-np.pi, np.pi, (L, n // 2)).astype(
            np.float32)
    else:
        p["mix"] = (0.5 * rng.standard_normal((L, n // 2, 4))).astype(
            np.float32)
    if n % 2:
        p["res_scale"] = _vec(rng, L)
    x = rng.standard_normal((3, n)).astype(np.float32)
    gy = rng.standard_normal((3, n)).astype(np.float32)
    jg, jgx = jax.grad(lambda pp, xx: jnp.sum(J_spm.spm_apply(pp, xx, jc)
                                              * gy), argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = Params({k: _t(v) for k, v in p.items()}).trainable()
    tx = _t(x).requires_grad_(True)
    (T_spm.spm_apply(tp, tx, tc) * _t(gy)).sum().backward()
    # each stage rounds 3 times forward and back; the inverse adds the
    # 2x2 inverse's division; cos/sin of the rotation one each
    depth = 8 * L + 8
    _close(tx.grad, jgx, torch.float32, depth)
    for k in p:
        _close(tp[k].grad, jg[k], torch.float32, depth + 3)
    np.testing.assert_allclose(
        T_spm.spm_matrix(tp, tc).detach().numpy(),
        _np(J_spm.spm_matrix({k: jnp.asarray(v) for k, v in p.items()},
                             jc)),
        rtol=0, atol=_tol(torch.float32, depth, np.ones(1)))


def test_backward_wrappers_never_fall_back_off_cpu():
    """A tensor neither on the CPU nor on a GPU gets no plain version:
    K2's and K4's wrappers raise and count no launch."""
    K.reset_launch_counts()
    meta = torch.device("meta")
    x = torch.empty((4, 16), device=meta)
    cf = torch.empty((2, 8, 4), device=meta)
    vec = torch.empty(16, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        K.spm_stack_bwd_kernel_call(x, cf, x, strides=(1, 2), n_tile=16)
    with pytest.raises(ValueError, match="no kernel"):
        K.spm_block_bwd_kernel_call(x, x, cf, vec, vec, strides1=(1, 2),
                                    in_width=16, mid_width=16, out_width=16)
    assert K.spm_stack_bwd_kernel_call.launches == 0
    assert K.spm_block_bwd_kernel_call.launches == 0
