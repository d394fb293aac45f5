"""Parity of the port's overlap-scheduled sharded executor and of int8 tables
on the sharded path with the JAX reference, on the CPU.

* the plan: ``overlap_segments``, ``resolve_overlap``, ``pick_row_blocks``
  and the row blocks a call gets, ``_rdma_cross_indices`` and the
  placeholder residual of a fused pair's cross step, bitwise;
* the overlap operator (the per-block exchange: forward, and the grads in
  x, the table, d_in, d_out and bias) against
  ``repro.parallel.spm_shard.spm_apply_sharded`` with ``overlap=True``
  under a mesh of 2, 4 or 8 host devices, on the reference's own
  overlap cases (``tests/test_distributed.py`` ``OVERLAP_CASES``);
* the fused pair branch (K5/K6's plain versions, driven through a
  ``ShardPlan`` built by hand with ``rdma_crosses`` set) against the same
  reference: a pair that ends the schedule (d_out and bias folded, the
  t sums), a windowed first run, d_in folded, f32 and bf16;
* K5's and K6's plain versions against the reference's pair kernel bodies
  (``_overlap_kernel``, ``_overlap_bwd_kernel``: their stage helpers and
  mix, one row block, the exchange as an index), which have no interpret
  mode: y and g_x bit for bit, so every rounding point (the sent slab, the
  own cotangent read back rounded, the raw gy of the t sums) is the
  reference's; the sums within gamma_rows of their terms' magnitudes;
  planted faults fail these checks;
* ``quant_coeffs`` on the sharded path, step-serial and overlap: the
  per-shard int8 codes and scales bitwise, the outputs and grads against
  the reference's within the f32 bound, overlap against step-serial as
  sharp as the reference holds them;
* (the smoke model's training steps are in
  ``tests/test_torch_overlap_train.py``).

The reference's side runs in one subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (this file run as a
script), as ``tests/test_torch_shard.py`` runs its worker.  Inputs come
from numpy with fixed seeds.  The operator checks bound each element by
its own magnitude: ``depth`` dependent f32 roundings plus ``io`` roundings
to the I/O dtype, each at most one epsilon (twice the unit roundoff, so
the sum covers both sides' errors) of the element's magnitude, which the
reference computes as the same operator on the absolute values of the
tables, diagonals, bias, input and cotangent (``|D_out| |B_L| ... |B_1|
|D_in| |x| + |bias|`` and its transpose; a parameter grad's magnitude is
the sum over rows of its terms' magnitudes, and it adds one rounding per
row).  Planted faults (a dropped partner term, zeroed rows, zeroed grads)
must fail these bounds.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import eligibility as J_el  # noqa: E402
from repro.core import spm as J_spm  # noqa: E402
from repro.kernels import ops as J_ops  # noqa: E402
from repro.kernels import quant as J_Q  # noqa: E402
from repro.parallel import spm_shard as J_sh  # noqa: E402
from repro.parallel.ctx import activation_sharding as j_sharding  # noqa: E402

N_DEV = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
EPS = {"f32": EPS32, "bf16": 2.0 ** -7}
ROWS = (4, 40)          # the reference's overlap cases: 160 rows

# The reference's OVERLAP_CASES (tests/test_distributed.py:362), then three
# whose first {local -> cross} pair ends the schedule: n=64 over 2 shards
# (local 1..16, cross k=1) and the smoke FFN's up projection (n=96 over 4,
# a windowed first run from in_width 64, cross k=1), f32 and bf16.
# (id, n, shards, L, dtype, diag, bias, kernel, in_w, out_w)
OV_CASES = [
    ("ov_2way", 64, 2, 6, "f32", True, True, False, None, None),
    ("ov_4way", 64, 4, 8, "f32", True, True, False, None, None),
    ("ov_8way", 64, 8, 9, "f32", True, True, False, None, None),
    ("ov_kernel", 64, 4, 7, "f32", True, True, True, None, None),
    ("ov_kernel_8way", 64, 8, 9, "f32", True, True, True, None, None),
    ("ov_no_diag_bias", 64, 4, 8, "f32", False, False, True, None, None),
    ("ov_rect", 64, 4, 7, "f32", True, True, True, 50, 40),
    ("ov_rect_widen", 64, 4, 7, "f32", True, True, True, 40, 60),
    ("ov_bf16", 64, 4, 8, "bf16", True, True, False, None, None),
    ("ov_bf16_kernel_rect", 64, 4, 7, "bf16", True, True, True, 50, 40),
    ("pair_end_2way", 64, 2, 6, "f32", True, True, True, None, None),
    ("pair_end_win", 96, 4, 7, "f32", True, True, True, 64, None),
    ("pair_end_win_bf16", 96, 4, 7, "bf16", True, True, True, 64, None),
]
OV = {c[0]: c[1:] for c in OV_CASES}
PAIR_CASES = [c[0] for c in OV_CASES if c[7]]

# the reference's test_sharded_quant_coeffs_parity cases (n=64, L=7, f32,
# kernel path): (shards, overlap)
QUANT_CASES = [(2, False), (4, False), (8, False), (4, True), (8, True)]


def _qid(shards, overlap):
    return f"q{shards}_{'overlap' if overlap else 'serial'}"


def _ov_inputs(case):
    """The numpy operands of an operator case, from a seed."""
    n, S, L, _, diag, bias, _, in_w, out_w = OV[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    a = dict(mix=(0.6 * rng.standard_normal((L, n // 2, 4))).astype(
        np.float32))
    if diag:
        a["d_in"] = (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
        a["d_out"] = (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    if bias:
        a["bias"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
    a["x"] = rng.standard_normal(ROWS + (in_w or n,)).astype(np.float32)
    a["gy"] = rng.standard_normal(ROWS + (out_w or n,)).astype(np.float32)
    return a


def _q_inputs(shards, overlap):
    rng = np.random.default_rng(100 + shards)
    return dict(
        mix=(0.6 * rng.standard_normal((7, 32, 4))).astype(np.float32),
        d_in=(1 + 0.1 * rng.standard_normal(64)).astype(np.float32),
        d_out=(1 + 0.1 * rng.standard_normal(64)).astype(np.float32),
        bias=(0.1 * rng.standard_normal(64)).astype(np.float32),
        x=rng.standard_normal(ROWS + (64,)).astype(np.float32),
        gy=rng.standard_normal(ROWS + (64,)).astype(np.float32))


def _j_cfg(case, overlap=True):
    n, S, L, _, diag, bias, uk, _, _ = OV[case]
    return J_spm.SPMConfig(n=n, n_stages=L, schedule="two_level",
                           n_shards=S, use_diag=diag, use_bias=bias,
                           backward="custom", use_kernel=uk,
                           overlap=overlap)


PARAM_KEYS = ("mix", "d_in", "d_out", "bias")

# K5/K6 kernel-level cases: (S, n_local, k, in_w, fold d_out/bias, int8
# table, dtype).  The local run is one tile (strides 1 .. n_local/2), as
# the reference's pair kernel runs it; d_in is always folded.
KP_CASES = [
    ("kp_qkvo_bf16", 4, 16, 1, None, False, False, "bf16"),
    ("kp_end_bf16", 2, 32, 1, None, True, False, "bf16"),
    ("kp_win_end_bf16", 4, 32, 1, 100, True, False, "bf16"),
    ("kp_k2_end_f32", 4, 16, 2, None, True, False, "f32"),
    ("kp_int8_win_bf16", 4, 16, 1, 52, True, True, "bf16"),
    ("kp_int8_f32", 4, 16, 1, None, False, True, "f32"),
]
KP = {c[0]: c[1:] for c in KP_CASES}
KP_ROWS = 40


def _kp_strides(nl):
    return tuple(1 << i for i in range(nl.bit_length() - 1))


def _kp_inputs(case):
    """The numpy operands of a kernel case, from a seed: x (rows, in_w or
    n), gy (rows, n), the stacked local tables (S, L, n_local/2, 4) (int8
    codes with (S, L) scales for an int8 case) and the (n,) vectors."""
    S, nl, k, in_w, fold, q8, _ = KP[case]
    n, L = S * nl, len(_kp_strides(nl))
    rng = np.random.default_rng(sum(map(ord, case)))
    a = {}
    if q8:
        a["cf"] = rng.integers(-127, 128, (S, L, nl // 2, 4)).astype(np.int8)
        a["scf"] = (0.6 / 127 * (1 + rng.random((S, L)))).astype(np.float32)
    else:
        a["cf"] = (0.6 * rng.standard_normal((S, L, nl // 2, 4))).astype(
            np.float32)
    for key in ("mix_a", "mix_b", "u", "v", "d_in") + (
            ("d_out",) if fold else ()):
        a[key] = (1 + 0.3 * rng.standard_normal(n)).astype(np.float32)
    if fold:
        a["bias"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
    a["x"] = rng.standard_normal((KP_ROWS, in_w or n)).astype(np.float32)
    a["gy"] = rng.standard_normal((KP_ROWS, n)).astype(np.float32)
    return a


# ---------------------------------------------------------------------------
# the reference's side, run as a script under 8 forced host devices
# ---------------------------------------------------------------------------

def _j_op(out, tag, a, cfg, mesh, dt, in_w=None, out_w=None):
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    p = {k: jnp.asarray(a[k]) for k in PARAM_KEYS if k in a}
    x = jnp.asarray(a["x"], jdt)

    @jax.jit
    def f(p, x, gy):
        y, vjp = jax.vjp(lambda p, x: J_spm.spm_apply(
            p, x, cfg, in_width=in_w, out_width=out_w), p, x)
        return (y,) + vjp(gy)

    if mesh is None:
        y, gp, gx = f(p, x, jnp.asarray(a["gy"], jdt))
    else:
        with j_sharding(mesh, shard_feature=True):  # one compile a case
            y, gp, gx = f(p, x, jnp.asarray(a["gy"], jdt))
    out[f"{tag}/y"] = np.asarray(y.astype(jnp.float32))
    out[f"{tag}/gx"] = np.asarray(gx.astype(jnp.float32))
    for k, v in gp.items():
        out[f"{tag}/g_{k}"] = np.asarray(v, np.float32)


def _abs_inputs(a, dt):
    """The operands' absolute values, the input and cotangent as the I/O
    dtype holds them: the magnitude operator's operands."""
    out = {k: np.abs(v) for k, v in a.items()}
    if dt == "bf16":
        for k in ("x", "gy"):
            out[k] = np.abs(np.asarray(jnp.asarray(a[k], jnp.bfloat16)
                                       .astype(jnp.float32)))
    return out


def _worker(out_path: str) -> None:
    from jax.sharding import Mesh
    assert jax.device_count() == N_DEV, jax.device_count()

    def mesh(s):
        return Mesh(np.asarray(jax.devices()[:s]), ("model",))

    out = {}
    for case, (n, S, L, dt, diag, bias, _, in_w, out_w) in OV.items():
        a = _ov_inputs(case)
        _j_op(out, case, a, _j_cfg(case), mesh(S), dt, in_w, out_w)
        # the magnitudes: the unsharded composition on |operands| in f32
        mcfg = J_spm.SPMConfig(n=n, n_stages=L, schedule="two_level",
                               n_shards=S, use_diag=diag, use_bias=bias,
                               backward="custom", use_kernel=False)
        _j_op(out, f"{case}/mag", _abs_inputs(a, dt), mcfg, None, "f32",
              in_w, out_w)
    for case in KP:
        _j_pair_kernels(out, case)
    for S, ov in QUANT_CASES:
        cfg = J_spm.SPMConfig(n=64, n_stages=7, schedule="two_level",
                              n_shards=S, backward="custom", use_kernel=True,
                              overlap=ov, quant_coeffs=True)
        _j_op(out, _qid(S, ov), _q_inputs(S, ov), cfg, mesh(S), "f32")
    np.savez(out_path, **out)


def _j_pair_kernels(out, case):
    """The reference's pair kernels' bodies (``_overlap_kernel``,
    ``_overlap_bwd_kernel``) over every shard with the rows as one block
    and the partner exchange as an index, op by op: its stage helpers
    (``_apply_stages_fwd``, ``_stage_walk_bwd``, ``_mask_cols``) and its
    mix, prologue and roundings, transcribed.  Also the sums of the terms'
    magnitudes of each grad sum (the table grads from the walk over
    absolute values, an upper bound)."""
    from repro.kernels import spm_stack as JK
    S, nl, k, in_w, fold, q8, dt = KP[case]
    a = _kp_inputs(case)
    strides = _kp_strides(nl)
    L, n = len(strides), S * nl
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    f32 = jnp.float32
    v = {key: jnp.asarray(a[key]) for key in a if key not in ("x", "gy")}

    def scf(j):
        return v["scf"][j].reshape(L, 1) if q8 else None

    def sl(t, j):
        return t[..., j * nl:(j + 1) * nl]

    def run(x, gy, v):
        xp = jnp.pad(x, ((0, 0), (0, n - x.shape[1])))
        x_raw = []
        for j in range(S):
            z = sl(xp, j).astype(f32)
            if in_w is not None:
                z = JK._mask_cols(z, j, in_w)
            x_raw.append(z)
        z_out = [JK._apply_stages_fwd(x_raw[j] * sl(v["d_in"], j),
                                      v["cf"][j], strides, scf_ref=scf(j))
                 for j in range(S)]
        # K5: the sent slab in the I/O dtype, the mix in f32, one store
        sent = [z.astype(jdt) for z in z_out]
        ys = []
        for j in range(S):
            y = (sl(v["mix_a"], j) * sent[j].astype(f32)
                 + sl(v["mix_b"], j) * sent[j ^ k].astype(f32))
            if fold:
                y = y * sl(v["d_out"], j)
                y = y + sl(v["bias"], j)
            ys.append(y.astype(jdt))
        # K6: the package (delta [* d_out], z_out) in the I/O dtype
        pk_d = [(sl(gy, j).astype(f32) * sl(v["d_out"], j)).astype(jdt)
                if fold else sl(gy, j).astype(jdt) for j in range(S)]
        res = {"y": jnp.concatenate(ys, -1)}
        acc = {key: [] for key in ("gx", "g_cf", "s_own", "s_swp", "g_din",
                                   "t_own", "t_swp", "m_cf", "m_s_own",
                                   "m_s_swp", "m_g_din", "m_t_own",
                                   "m_t_swp")}
        for j in range(S):
            p = j ^ k
            delta, zo = pk_d[j].astype(f32), sent[j].astype(f32)
            delta_p, zp = pk_d[p].astype(f32), sent[p].astype(f32)
            for name, t in (("s_own", delta * zo), ("s_swp", delta * zp)):
                acc[name].append(jnp.sum(t, 0))
                acc["m_" + name].append(jnp.sum(jnp.abs(t), 0))
            if fold:
                gy_raw = sl(gy, j).astype(f32)
                for name, t in (("t_own", gy_raw * zo),
                                ("t_swp", gy_raw * zp)):
                    acc[name].append(jnp.sum(t, 0))
                    acc["m_" + name].append(jnp.sum(jnp.abs(t), 0))
            dmid = sl(v["u"], j) * delta + sl(v["v"], j) * delta_p
            z0 = x_raw[j] * sl(v["d_in"], j)
            _, zs = JK._apply_stages_fwd(z0, v["cf"][j], strides,
                                         collect=True, scf_ref=scf(j))
            d0, gcf = JK._stage_walk_bwd(zs, dmid, v["cf"][j], strides,
                                         scf_ref=scf(j))
            acf = jnp.abs(v["cf"][j].astype(f32)
                          * (scf(j)[:, :, None] if q8 else 1.0))
            md0, mcf = JK._stage_walk_bwd([jnp.abs(t) for t in zs],
                                          jnp.abs(dmid), acf, strides)
            acc["g_cf"].append(gcf)
            acc["m_cf"].append(mcf)
            acc["g_din"].append(jnp.sum(d0 * x_raw[j], 0))
            acc["m_g_din"].append(jnp.sum(md0 * jnp.abs(x_raw[j]), 0))
            acc["gx"].append((d0 * sl(v["d_in"], j)).astype(jdt))
        for key, parts in acc.items():
            if parts:
                res[key] = (jnp.stack(parts) if key in ("g_cf", "m_cf")
                            else jnp.concatenate(parts, -1))
        return res

    # op by op, as the kernel body states each rounding: a jitted XLA
    # computation may contract a product and a sum into one FMA
    with jax.disable_jit():
        res = run(jnp.asarray(a["x"], jdt), jnp.asarray(a["gy"], jdt), v)
    for key, t in res.items():
        out[f"{case}/{key}"] = np.asarray(t.astype(f32))


if __name__ == "__main__":
    _worker(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

from repro_torch.core import eligibility as T_el  # noqa: E402
from repro_torch.core import pairings as T_pair  # noqa: E402
from repro_torch.core import spm as T_spm  # noqa: E402
from repro_torch.kernels import spm_stack as K  # noqa: E402
from repro_torch.parallel import (activation_sharding,  # noqa: E402
                                  make_feature_mesh)
from repro_torch.parallel import spm_shard as T_sh  # noqa: E402
from repro_torch.params import Params  # noqa: E402

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


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's results (``_worker``), computed once."""
    d = tmp_path_factory.mktemp("overlap_ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + f" --xla_force_host_platform_device_count={N_DEV}")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = (os.path.join(REPO, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(d / "ref.npz")],
        capture_output=True, text=True, timeout=900,
        cwd=REPO, env=env)
    assert r.returncode == 0, (f"reference worker failed (rc={r.returncode})"
                               f":\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    return dict(np.load(d / "ref.npz"))


def _ref(reference, tag):
    return {k.split("/", 1)[1]: v for k, v in reference.items()
            if k.startswith(tag + "/")}


def _mag_ratio(got, ref, mag, dtype, depth, io):
    """The worst ``|got - ref|`` over its per-element bound ``(depth *
    eps32 + io * eps_io) * mag`` (at most 1 passes); an element whose
    magnitude is 0 must match exactly."""
    got = np.asarray(got.detach().float().numpy() if torch.is_tensor(got)
                     else got, np.float64)
    ref = np.asarray(ref, np.float64).reshape(got.shape)
    lim = (depth * EPS32 + io * EPS[dtype]) * np.asarray(
        mag, np.float64).reshape(got.shape)
    d = np.abs(got - ref)
    if np.any((lim == 0) & (d > 0)):
        return np.inf
    return float(np.max(d / np.where(lim > 0, lim, 1.0), initial=0.0))


# ---------------------------------------------------------------------------
# the plan, bitwise
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(64, 6, 4), (64, 7, 4), (96, 7, 4), (64, 8, 8), (64, 9, 8),
               (64, 6, 2), (2048, 11, 4), (2048, 11, 2), (6144, 12, 4),
               (256, 8, 8), (48, 6, 4)]


@pytest.mark.parametrize("n,L,S", PLAN_SHAPES)
def test_overlap_plan_matches_reference(n, L, S):
    """``overlap_segments``, ``_rdma_cross_indices`` and
    ``resolve_overlap`` (the port's auto is the reference's off-TPU auto)
    equal the reference's; so do the placeholder residuals of a plan with
    fused pairs (the forward keeps no input for a fused cross step)."""
    from jax.sharding import Mesh, PartitionSpec as P
    strides = T_pair.make_schedule("two_level", n, L, n_shards=S).strides()
    steps = T_el.plan_steps(n, strides, S)
    assert T_el.overlap_segments(steps) == J_el.overlap_segments(steps)
    n_local = n // S
    rdma = T_sh._rdma_cross_indices(steps, n_local)
    assert rdma == J_sh._rdma_cross_indices(steps, n_local)
    for ov in (None, True, False):
        tcfg = T_spm.SPMConfig(n=n, n_stages=L, schedule="two_level",
                               n_shards=S, overlap=ov)
        jcfg = J_spm.SPMConfig(n=n, n_stages=L, schedule="two_level",
                               n_shards=S, overlap=ov)
        assert T_el.resolve_overlap(tcfg, steps) == \
            J_el.resolve_overlap(jcfg, steps, False)
    for uk in (True, False):
        for cuda in (True, False):
            assert T_el.resolve_rdma(uk, cuda) == (uk and cuda)
    jmesh = Mesh(np.asarray(jax.devices()[:1]), ("model",))
    for in_w, kernel in ((None, True), (n - 6, True), (None, False)):
        kw = dict(n=n, n_local=n_local, n_shards=S, steps=steps,
                  has_din=True, has_dout=True, has_bias=True,
                  use_kernel=kernel, in_width=in_w,
                  rdma_crosses=rdma if kernel else ())
        tplan = T_sh.ShardPlan(row_blocks=(8, 8), **kw)
        jplan = J_sh.ShardPlan(mesh=jmesh, block_rows=8, interpret=False,
                               row_blocks=(8, 8), **kw)
        assert tplan.overlap and jplan.overlap
        assert tplan.segments == jplan.segments
        assert tplan.saved_step_inputs == tuple(
            sp != P(None) for sp in jplan.res_specs()[1])


@pytest.mark.parametrize("rows,block_rows", [
    (160, 32), (160, 1), (16, 1), (7, 8), (0, 8), (4096, 256), (4096, 8),
    (12, 4), (33, 8), (8, 8), (1, 1)])
def test_pick_row_blocks_matches_reference(rows, block_rows):
    assert (T_sh.pick_row_blocks(rows, block_rows)
            == J_sh.pick_row_blocks(rows, block_rows))


@pytest.mark.parametrize("n,L,S,rows,dt,kernel", [
    (64, 7, 4, 160, 4, True), (64, 9, 8, 160, 4, True),
    (64, 6, 4, 160, 4, False), (96, 7, 4, 12, 2, True),
    (2048, 11, 4, 4096, 2, True), (2048, 11, 4, 8, 2, True),
    (64, 6, 2, 150, 4, True)])
def test_row_blocks_match_reference(n, L, S, rows, dt, kernel):
    """The row blocks a call gets are the reference's for the same rows
    (its ``spm_apply_sharded`` arithmetic: the kernel's row block, halved
    toward ``OVERLAP_ROW_BLOCKS`` blocks, the rows padded to it), less the
    reference's zero padding rows, which come off the last block."""
    steps = T_el.plan_steps(n, T_pair.make_schedule(
        "two_level", n, L, n_shards=S).strides(), S)
    n_local = n // S
    br = 1
    if kernel:
        br = min(J_ops.pick_block_rows_for_plan(
            J_ops.plan_runs(n_local, st[2]), rows, dtype_bytes=dt)
            for st in steps if st[0] == "local")
        while br > 8 and rows // br < J_el.OVERLAP_ROW_BLOCKS:
            br //= 2
    padded = -(-rows // br) * br
    want = list(J_sh.pick_row_blocks(padded, br))
    want[-1] -= padded - rows
    got = T_sh._overlap_row_blocks(steps, n_local, rows, dt, kernel)
    assert got == tuple(w for w in want if w > 0)
    assert sum(got) == rows


# ---------------------------------------------------------------------------
# the operator against the reference's, under 2, 4 or 8 host devices
# ---------------------------------------------------------------------------

def _port_params(a):
    p = Params({k: torch.from_numpy(a[k]) for k in PARAM_KEYS if k in a})
    for v in p.parameters():
        v.requires_grad_(True)
    return p


def _grads(y, p, x, gy):
    names = ["x"] + [k for k in PARAM_KEYS if k in p.keys()]
    grads = torch.autograd.grad(y, [x] + [p[k] for k in names[1:]], gy)
    return dict(zip(names, grads))


def _port_op(a, cfg, dt, in_w=None, out_w=None, mesh=True):
    """The port's operator through ``spm_apply`` (sharded under a CPU mesh
    of ``cfg.n_shards``, else unsharded) and its grads."""
    p = _port_params(a)
    x = torch.from_numpy(a["x"]).to(TDT[dt]).requires_grad_(True)
    if mesh:
        with activation_sharding(make_feature_mesh(cfg.n_shards,
                                                   device="cpu"),
                                 shard_feature=True):
            y = T_spm.spm_apply(p, x, cfg, in_width=in_w, out_width=out_w)
    else:
        y = T_spm.spm_apply(p, x, cfg, in_width=in_w, out_width=out_w)
    return y, _grads(y, p, x, torch.from_numpy(a["gy"]).to(TDT[dt]))


def _t_cfg(case, overlap=True):
    n, S, L, _, diag, bias, uk, _, _ = OV[case]
    return T_spm.SPMConfig(n=n, n_stages=L, schedule="two_level",
                           n_shards=S, use_diag=diag, use_bias=bias,
                           backward="custom", use_kernel=uk,
                           overlap=overlap)


def _depth_io(case, dt, fused=False):
    """``(depth, io)`` of an operator case.  ``depth``: its L stages at 3
    f32 roundings each plus the diagonals and bias.  ``io``: for each
    output, the roundings to the I/O dtype on a path, the port's and the
    reference's added (each at most one unit roundoff of the element's
    magnitude).  A local step rounds once (its stored slab or g_x), a
    cross step's mix three times on a path (the coefficient's cast, the
    product, the sum), an elementwise d_in, d_out or bias op twice (the
    cast, the operation); a fused pair (``fused``: the port's K5/K6) rounds
    its sent slab and its store, and in the backward the cotangent it sends
    (when d_out folds into it) and g_x, with d_out and bias applied in f32
    before the store.  The table grads take both directions' roundings,
    the d_out grad the forward's, the d_in grad the backward's; the bias
    grad sums the cotangent as it came in."""
    n, S, L, _, diag, bias, uk = OV[case][:7]
    steps = T_el.plan_steps(n, T_pair.make_schedule(
        "two_level", n, L, n_shards=S).strides(), S)
    last = len(steps) - 1
    in_kernel = uk and steps[-1][0] == "local"     # d_out/bias fold in K1
    fold_din = uk and steps[0][0] == "local"

    def count(port):
        pairs = set(T_sh._rdma_cross_indices(steps, n // S)) \
            if port and fused else set()
        end_pair = last in pairs
        fwd = bwd = 0
        for i, st in enumerate(steps):
            if i in pairs:
                continue
            if i + 1 in pairs:
                fwd, bwd = fwd + 2, bwd + 1
            else:
                r = 1 if st[0] == "local" else 3
                fwd, bwd = fwd + r, bwd + r
        if not (in_kernel or end_pair):
            fwd += 2 * diag + 2 * bias
            bwd += 2 * diag
        bwd += int(diag and end_pair)
        if diag and not fold_din:
            fwd, bwd = fwd + 2, bwd + 2
        return fwd, bwd

    (fr, br), (fp, bp) = count(False), count(True)
    fwd, bwd = fr + fp, br + bp
    return 3 * L + 3, dict(y=fwd, x=bwd, mix=fwd + bwd, d_in=bwd,
                           d_out=fwd, bias=0)


def _check_ratios(case, y, g, r, dt, rows, fused=False):
    """Each output's worst error over its per-element bound against the
    reference (``_depth_io``): y within the operator's depth, g_x within
    twice it, a parameter grad (a sum over rows) one f32 rounding per row
    on top, each with its I/O roundings."""
    depth, io = _depth_io(case, dt, fused)
    out = {"y": _mag_ratio(y, r["y"], r["mag/y"], dt, depth, io["y"] / 2),
           "x": _mag_ratio(g["x"], r["gx"], r["mag/gx"], dt, 2 * depth,
                           io["x"] / 2)}
    for k in PARAM_KEYS:
        if k in g:
            out[k] = _mag_ratio(g[k], r[f"g_{k}"], r[f"mag/g_{k}"], dt,
                                2 * depth + rows, io[k] / 2)
    return out


def _check_against(case, y, g, r, dt, rows, fused=False):
    assert y.dtype == TDT[dt]
    assert y.shape == r["y"].reshape(-1, r["y"].shape[-1]).shape
    ratios = _check_ratios(case, y, g, r, dt, rows, fused)
    assert max(ratios.values()) <= 1, ratios


@pytest.mark.parametrize("case", list(OV))
def test_overlap_operator_matches_reference(reference, case):
    """The overlap schedule on the CPU (per-block exchange) against
    ``spm_apply_sharded`` with ``overlap=True``: forward and every grad,
    each element within its own magnitude's bound.  With the kernel path
    off in bf16 both sides round after every operation: y and g_x bit for
    bit."""
    n, S, L, dt, _, _, uk, in_w, out_w = OV[case]
    a = dict(_ov_inputs(case))
    a["x"], a["gy"] = (a[k].reshape(-1, a[k].shape[-1]) for k in ("x", "gy"))
    cfg = _t_cfg(case)
    assert T_el.resolve_overlap(cfg, T_el.plan_steps(
        n, cfg.pairing.strides(), S))
    y, g = _port_op(a, cfg, dt, in_w, out_w)
    r = _ref(reference, case)
    _check_against(case, y, g, r, dt, a["x"].shape[0])
    if dt == "bf16" and not uk:
        np.testing.assert_array_equal(y.float().detach().numpy(),
                                      r["y"].reshape(y.shape))
        np.testing.assert_array_equal(g["x"].float().numpy(),
                                      r["gx"].reshape(g["x"].shape))


def _pair_op(a, case, dt, monkeypatch):
    """The operator through a ``ShardPlan`` built by hand with the fused
    pairs set (``rdma_crosses``), as ``spm_apply_sharded`` builds it for a
    CUDA input: on these CPU tensors the pairs run K5's and K6's plain
    versions through their wrappers.  Returns y, the grads and the pair
    wrapper calls."""
    n, S, L, _, diag, bias, _, in_w, out_w = OV[case]
    cfg = _t_cfg(case)
    steps = T_el.plan_steps(n, cfg.pairing.strides(), S)
    n_local = n // S
    x2 = torch.from_numpy(a["x"]).to(TDT[dt]).requires_grad_(True)
    plan = T_sh.ShardPlan(
        n=n, n_local=n_local, n_shards=S, steps=steps, has_din=diag,
        has_dout=diag, has_bias=bias, use_kernel=True,
        in_width=None if in_w == n else in_w,
        out_width=None if out_w == n else out_w,
        row_blocks=T_sh._overlap_row_blocks(steps, n_local, x2.shape[0],
                                            x2.element_size(), True),
        rdma_crosses=T_sh._rdma_cross_indices(steps, n_local))
    assert plan.rdma_crosses and len(plan.row_blocks) > 1
    calls = []
    for name in ("spm_overlap_kernel_call", "spm_overlap_bwd_kernel_call"):
        orig = getattr(K, name)

        def spy(*args, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*args, **kw)

        monkeypatch.setattr(K, name, spy)
    p = _port_params(a)
    tables = T_sh._step_tables(T_spm.stage_coeffs(p, cfg).float(), steps, S,
                               n_local)

    def vec(k):
        return p[k].float() if k in p.keys() else None

    y = T_sh._ShardedCore.apply(plan, vec("d_in"), vec("d_out"), vec("bias"),
                                x2, *tables)
    g = _grads(y, p, x2, torch.from_numpy(a["gy"]).to(TDT[dt]))
    return y, g, calls, plan


@pytest.mark.parametrize("case", PAIR_CASES)
def test_fused_pair_branch_matches_reference(reference, case, monkeypatch):
    """The fused pair branch, K5/K6 as their plain versions run them,
    against the reference's overlap schedule: forward and every grad, each
    element within its own magnitude's bound (in bf16 plus the reference's
    extra mix roundings: the pair mixes in f32 after one rounding of each
    slab).  Every fused pair is one K5 forward and one K6 backward."""
    dt = OV[case][3]
    a = dict(_ov_inputs(case))
    a["x"], a["gy"] = (a[k].reshape(-1, a[k].shape[-1]) for k in ("x", "gy"))
    y, g, calls, plan = _pair_op(a, case, dt, monkeypatch)
    n_pairs = len(plan.rdma_crosses)
    assert calls == (["spm_overlap_kernel_call"] * n_pairs
                     + ["spm_overlap_bwd_kernel_call"] * n_pairs)
    _check_against(case, y, g, _ref(reference, case), dt, a["x"].shape[0],
                   fused=True)


@pytest.mark.parametrize("case", ["pair_end_win_bf16",
                                  "ov_bf16_kernel_rect"])
def test_operator_bound_catches_planted_faults(reference, case,
                                               monkeypatch):
    """The per-element bound of the two tests above is sharp enough to see
    a wrong result: the pair kernel's partner term dropped, half the rows
    of y zeroed, g_x or any parameter grad zeroed each fail it, while the
    fused pair branch as it is passes."""
    dt = OV[case][3]
    a = dict(_ov_inputs(case))
    a["x"], a["gy"] = (a[k].reshape(-1, a[k].shape[-1]) for k in ("x", "gy"))
    r, rows = _ref(reference, case), a["x"].shape[0]
    y, g, _, _ = _pair_op(a, case, dt, monkeypatch)
    ratios = functools.partial(_check_ratios, case, dt=dt, rows=rows,
                               fused=True, r=r)
    assert max(ratios(y=y, g=g).values()) <= 1
    y0 = y.detach().clone()
    y0[: rows // 2] = 0
    assert ratios(y=y0, g=g)["y"] > 1
    for key in g:
        zero = dict(g, **{key: torch.zeros_like(g[key])})
        assert ratios(y=y, g=zero)[key] > 1, key
    orig = K.spm_overlap_kernel_call

    def no_partner(x, cf, mix_a, mix_b, *args, **kw):
        return orig(x, cf, mix_a, torch.zeros_like(mix_b), *args, **kw)

    monkeypatch.setattr(K, "spm_overlap_kernel_call", no_partner)
    y1, g1, _, _ = _pair_op(a, case, dt, monkeypatch)
    assert ratios(y=y1, g=g1)["y"] > 1


@pytest.mark.parametrize("case", ["pair_end_2way", "pair_end_win",
                                  "ov_kernel"])
def test_fused_pair_branch_matches_per_block_exchange_in_f32(case,
                                                             monkeypatch):
    """In f32 the fused pair's forward is the per-block exchange's bit for
    bit (the same roundings: the slab stored in f32, the mix product by
    product), its grads within the operator's depth (sums in another
    order)."""
    a = dict(_ov_inputs(case))
    a["x"], a["gy"] = (a[k].reshape(-1, a[k].shape[-1]) for k in ("x", "gy"))
    y, g, _, _ = _pair_op(a, case, "f32", monkeypatch)
    in_w, out_w = OV[case][7:9]
    y2, g2 = _port_op(a, _t_cfg(case), "f32", in_w, out_w)
    assert torch.equal(y, y2)
    depth = _depth_io(case, "f32")[0]
    for k in g:
        _close(g[k], g2[k].numpy(), "f32", 2 * depth + a["x"].shape[0], 0, k)


# ---------------------------------------------------------------------------
# K5 / K6 plain versions against the reference's pair kernel bodies
# ---------------------------------------------------------------------------

def _gamma(k):
    u = EPS32 / 2
    return k * u / (1 - k * u)


def _kp_port(case, **change):
    """K5 and K6 through their wrappers on CPU tensors (the plain
    versions) on a kernel case's operands, with ``change`` overriding
    operands (a planted fault)."""
    S, nl, k, in_w, fold, q8, dt = KP[case]
    io = change.pop("io", TDT[dt])
    a = dict(_kp_inputs(case), **change)
    t = {key: torch.from_numpy(val) for key, val in a.items()}
    x, gy = (t[key].to(TDT[dt]).to(io) for key in ("x", "gy"))
    kw = dict(strides=_kp_strides(nl), n_tile=nl, k=k, in_width=in_w)
    scale = t.get("scf")
    y = K.spm_overlap_kernel_call(x, t["cf"], t["mix_a"], t["mix_b"],
                                  t["d_in"], t.get("d_out"), t.get("bias"),
                                  scale, **kw)
    g = K.spm_overlap_bwd_kernel_call(x, t["cf"], gy, t["u"], t["v"],
                                      t["d_in"], t.get("d_out"), scale, **kw)
    names = ["gx", "g_cf", "s_own", "s_swp", "g_din"] + (
        ["t_own", "t_swp"] if fold else [])
    return y, dict(zip(names, g))


def _kp_ratios(case, y, g, r):
    """Bitwise flags for y and g_x and, for each grad sum, the worst error
    over gamma_rows times the sum of its terms' magnitudes."""
    out = {"y": torch.equal(y.float(), torch.from_numpy(r["y"])),
           "gx": torch.equal(g["gx"].float(), torch.from_numpy(r["gx"]))}
    for key in g:
        if key != "gx":
            mag = r["m_cf" if key == "g_cf" else f"m_{key}"]
            lim = _gamma(KP_ROWS) * mag
            d = np.abs(g[key].numpy().astype(np.float64) - r[key])
            out[key] = float(np.max(d / np.where(lim > 0, lim, 1.0)))
    return out


@pytest.mark.parametrize("case", list(KP))
def test_pair_plain_versions_match_reference_kernel_bodies(reference, case):
    """K5's plain version is the reference's pair kernel body bit for bit,
    K6's g_x too (so the sent slab, the own cotangent read back rounded,
    z_out rounded and the f32 remat of the walk round where the
    reference's do), and K6's table grads and s, t and g_din sums lie
    within gamma_rows of the sums of their terms' magnitudes (the rows
    summed in another order)."""
    y, g = _kp_port(case)
    ratios = _kp_ratios(case, y, g, _ref(reference, case))
    assert ratios.pop("y") and ratios.pop("gx"), case
    assert max(ratios.values()) <= 1, ratios


@pytest.mark.parametrize("case", ["kp_end_bf16", "kp_int8_win_bf16"])
def test_pair_kernel_checks_catch_planted_faults(reference, case):
    """The checks above fail on each planted fault: the sent slab left
    unrounded (the run in f32, only the store rounded), the partner term
    dropped, half the rows of y zeroed, the package left unrounded (K6 in
    f32, g_x rounded at the end), the t sums taken from the rounded
    cotangent instead of the raw gy, and a table grad zeroed."""
    r = _ref(reference, case)
    a = _kp_inputs(case)
    y32, g32 = _kp_port(case, io=torch.float32)
    dt = TDT[KP[case][6]]
    assert not _kp_ratios(case, y32.to(dt), g32, r)["y"]
    assert not _kp_ratios(case, y32, dict(g32, gx=g32["gx"].to(dt)),
                          r)["gx"]
    y, g = _kp_port(case, mix_b=np.zeros_like(a["mix_b"]))
    assert not _kp_ratios(case, y, g, r)["y"]
    y, g = _kp_port(case)
    y0 = y.clone()
    y0[: KP_ROWS // 2] = 0
    assert not _kp_ratios(case, y0, g, r)["y"]
    d_out = torch.from_numpy(a["d_out"])
    t_bad = dict(g, t_own=g["s_own"] / d_out, t_swp=g["s_swp"] / d_out)
    ratios = _kp_ratios(case, y, t_bad, r)
    assert ratios["t_own"] > 1 and ratios["t_swp"] > 1
    assert _kp_ratios(case, y, dict(g, g_cf=torch.zeros_like(g["g_cf"])),
                      r)["g_cf"] > 1


# ---------------------------------------------------------------------------
# int8 tables on the sharded path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,L,S", [(64, 7, 2), (64, 7, 4), (64, 7, 8),
                                   (96, 7, 4), (2048, 11, 4)])
def test_per_shard_int8_tables_match_reference(n, L, S):
    """Each local step's int8 codes and scales are the reference's per
    shard, bit for bit: one scale a stage of that shard's own table."""
    strides = T_pair.make_schedule("two_level", n, L, n_shards=S).strides()
    steps = T_el.plan_steps(n, strides, S)
    n_local = n // S
    cf = (0.6 * np.random.default_rng(n + S).standard_normal(
        (L, n // 2, 4))).astype(np.float32)
    plan = T_sh.ShardPlan(n=n, n_local=n_local, n_shards=S, steps=steps,
                          has_din=True, has_dout=True, has_bias=True,
                          use_kernel=True, quant_cf=True)
    tt = T_sh._step_tables(torch.from_numpy(cf), steps, S, n_local)
    qt = T_sh._quant_tables(plan, tt)
    jt = J_sh._step_tables(jnp.asarray(cf), steps, S, n_local)
    for step, q, t in zip(steps, qt, jt):
        if step[0] == "cross":
            assert q is None
            continue
        for j in range(S):
            jq, js = J_Q.quantize_coeffs(t[j])
            np.testing.assert_array_equal(q[0][j].numpy(), np.asarray(jq))
            np.testing.assert_array_equal(q[1][j].numpy(),
                                          np.asarray(js).reshape(-1))
    off = dataclasses.replace(plan, quant_cf=False)
    assert all(q is None for q in T_sh._quant_tables(off, tt))


def _q_port(S, ov):
    a = dict(_q_inputs(S, ov))
    a["x"], a["gy"] = (a[k].reshape(-1, 64) for k in ("x", "gy"))
    cfg = T_spm.SPMConfig(n=64, n_stages=7, schedule="two_level",
                          n_shards=S, backward="custom", use_kernel=True,
                          overlap=ov, quant_coeffs=True, quant_acts=True)
    return a, _port_op(a, cfg, "f32")


@pytest.mark.parametrize("shards,overlap", QUANT_CASES,
                         ids=[_qid(*c) for c in QUANT_CASES])
def test_sharded_quant_coeffs_match_reference(reference, shards, overlap):
    """``quant_coeffs`` through the sharded executor (``quant_acts`` set
    too: the sharded path ignores it, as the reference's does) against the
    reference's, which reads the same int8 tables: forward and grads
    within the f32 bound of the operator's depth.  Overlap against
    step-serial is the reference's sharp claim (the same tables, rows
    re-blocked): the forward within its rtol 1e-5 / atol 1e-6 (here bit
    for bit)."""
    a, (y, g) = _q_port(shards, overlap)
    r = _ref(reference, _qid(shards, overlap))
    depth = 3 * 7 + 3
    _close(y, r["y"].reshape(y.shape), "f32", depth, 0, "y")
    _close(g["x"], r["gx"].reshape(g["x"].shape), "f32", 2 * depth, 0, "gx")
    for k in PARAM_KEYS:
        _close(g[k], r[f"g_{k}"], "f32", 2 * depth + a["x"].shape[0], 0, k)
    if overlap:
        _, (y_ser, _) = _q_port(shards, False)
        np.testing.assert_allclose(y.detach().numpy(), y_ser.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert torch.equal(y, y_ser)
