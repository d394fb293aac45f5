"""The feature-sharded executor with one shard a rank, on the CPU.

The port's rank form of ``FeatureMesh``
(``launch/mesh.make_feature_rank_mesh``) runs shard j on rank j of a gloo
group: each rank walks its own shard, hands a cross stage's slab to rank
j XOR k (``batch_isend_irecv``) and assembles the output and the grads by
``all_gather``.  The ranks start
once per rank count (``launch.mesh.run_ranks``, one torch thread a rank)
and every case runs inside that spawn:

* the rank executor at 2 and 4 ranks against the one-process executor on
  a CPU ``FeatureMesh`` (which each rank also runs), bit for bit: the
  forward, g_x, the grads of the table, d_in, d_out and bias; step-serial
  and overlap, square and windowed ``in_width``, a schedule ending on a
  cross stage with d_out and bias folded into the mix, the composition;
* K5's and K6's rank-mode plain versions (the per-block exchange over the
  group) against the one-process pair's plain versions, each rank's
  columns bit for bit (one row block; with several, every value but the
  table and vector sums over rows, which group by block);
* two training steps of a 2-layer smoke ``qwen3-1.7b`` under
  ``with_feature_sharding(cfg, 4)`` on 4 ranks: params, moments and loss
  bit for bit across the ranks and the one-process sharded step;
* the mesh rules (size, experts, the two forms kept apart).

The slot, sequence and credit schedule of the rank-mode transport
(``kernels/peer.pair_schedule``) is checked by a simulation of two ranks'
streams.  One operator case is held to the reference's sharded operator
under 4 forced host devices (a subprocess: this file run as a script, as
``tests/test_torch_shard.py`` runs its worker), within the bound that file
derives.  A rank that raises mid-forward ends the group: the others fail
within 30 s.
"""

import dataclasses
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
EPS = {"f32": EPS32, "bf16": 2.0 ** -7}

# id: (n, L, dtype, use_kernel, in_width, out_width, rows, overlap) at
# S = 4 (n_local 16 or 24); the 2-rank run takes the square ones at S = 2.
# n=64 L=6: local (1, 2, 4, 8), cross k=1, cross k=2 (ends on a cross:
# d_out and bias fold into the mix); n=96 L=7 with in_width 64: a windowed
# first run; L=7 at n=64 ends on a local run (they fold into K1).
OP_CASES = {
    "square-serial": (64, 6, "f32", True, None, None, 12, False),
    "square-overlap": (64, 6, "bf16", True, None, None, 40, True),
    "window-serial": (96, 7, "bf16", True, 64, None, 12, False),
    "window-overlap": (96, 7, "f32", True, 64, None, 40, True),
    "rect-local-end": (64, 7, "f32", True, 50, 40, 12, False),
    "compose-bf16": (64, 6, "bf16", False, 50, 40, 12, False),
    "compose-overlap": (64, 6, "f32", False, None, None, 12, True),
}
TWO_RANK_CASES = ("square-serial", "square-overlap", "compose-overlap")
REF_CASE = "window-serial"            # held to the reference's operator
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LAYERS = 2, 2, 16, 2


def _op_inputs(case):
    n, L, _, _, in_w, out_w, rows, _ = OP_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    return dict(
        mix=(0.6 * rng.standard_normal((L, n // 2, 4))).astype(np.float32),
        d_in=(1 + 0.1 * rng.standard_normal(n)).astype(np.float32),
        d_out=(1 + 0.1 * rng.standard_normal(n)).astype(np.float32),
        bias=(0.1 * rng.standard_normal(n)).astype(np.float32),
        x=rng.standard_normal((rows, in_w or n)).astype(np.float32),
        gy=rng.standard_normal((rows, out_w or n)).astype(np.float32))


# ---------------------------------------------------------------------------
# the reference's side, run as a script under 4 forced host devices
# ---------------------------------------------------------------------------

def _ref_worker(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.core import spm as J_spm
    from repro.parallel.ctx import activation_sharding as j_sharding
    n, L, dt, uk, in_w, out_w, _, ov = OP_CASES[REF_CASE]
    a = _op_inputs(REF_CASE)
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    cfg = J_spm.SPMConfig(n=n, n_stages=L, schedule="two_level", n_shards=4,
                          backward="custom", use_kernel=uk, overlap=ov)
    p = {k: jnp.asarray(a[k]) for k in ("mix", "d_in", "d_out", "bias")}

    def f(p, x):
        return J_spm.spm_apply(p, x, cfg, in_width=in_w, out_width=out_w)

    with j_sharding(Mesh(np.asarray(jax.devices()[:4]), ("model",)),
                    shard_feature=True):
        y, vjp = jax.vjp(jax.jit(f), p, jnp.asarray(a["x"], jdt))
        gp, gx = vjp(jnp.asarray(a["gy"], jdt))
    out = {"y": np.asarray(y.astype(jnp.float32)),
           "gx": np.asarray(gx.astype(jnp.float32))}
    out.update({f"g_{k}": np.asarray(v, np.float32) for k, v in gp.items()})
    np.savez(out_path, **out)


if __name__ == "__main__":
    _ref_worker(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the ranks' jobs (module level: they pickle)
# ---------------------------------------------------------------------------

def _spm_cfg(case, S):
    from repro_torch.core import spm as T_spm
    n, L, _, uk, _, _, _, ov = OP_CASES[case]
    return T_spm.SPMConfig(n=n, n_stages=L, schedule="two_level",
                           n_shards=S, backward="custom", use_kernel=uk,
                           overlap=ov)


def _operator(case, S, mesh):
    """The case's y, g_x and param grads under ``mesh`` (f32 numpy)."""
    from repro_torch.core import spm as T_spm
    from repro_torch.parallel import activation_sharding
    from repro_torch.params import Params
    n, L, dt, _, in_w, out_w, _, _ = OP_CASES[case]
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    a = _op_inputs(case)
    p = Params({k: torch.from_numpy(a[k])
                for k in ("mix", "d_in", "d_out", "bias")})
    for k in p.keys():
        p[k].requires_grad_(True)
    x = torch.from_numpy(a["x"]).to(tdt).requires_grad_(True)
    with activation_sharding(mesh, shard_feature=True):
        y = T_spm.spm_apply(p, x, _spm_cfg(case, S), in_width=in_w,
                            out_width=out_w)
        y.backward(torch.from_numpy(a["gy"]).to(tdt))
    out = {"y": y.detach().float().numpy(), "gx": x.grad.float().numpy()}
    out.update({f"g_{k}": p[k].grad.numpy() for k in p.keys()})
    return out


def _rank_pair_cases(mesh):
    """K5's and K6's rank-mode plain versions against the one-process
    pair's, on this rank's columns: ``{name: bool}`` of bitwise checks."""
    from repro_torch.kernels import spm_stack as K
    S, j = mesh.shape["model"], mesh.rank
    nl, L, strides, nt = 16, 4, (1, 2, 4, 8), 16
    out = {}
    for k in [2 ** i for i in range(S.bit_length() - 1)]:
        for win, dt, q in ((False, torch.float32, False),
                           (True, torch.bfloat16, False),
                           (False, torch.bfloat16, True)):
            rng = np.random.default_rng(100 * k + 10 * win + q)
            n = S * nl
            in_w = n - nl // 2 if win else n
            x = torch.from_numpy(rng.standard_normal((10, in_w))
                                 .astype(np.float32)).to(dt)
            cf = torch.from_numpy((0.6 * rng.standard_normal(
                (S, L, nl // 2, 4))).astype(np.float32))
            vec = [torch.from_numpy((1 + 0.1 * rng.standard_normal(n))
                                    .astype(np.float32)) for _ in range(5)]
            mix_a, mix_b, d_in, d_out, bias = vec
            scale = None
            if q:
                from repro_torch.kernels import quant as Q
                cf, scale = Q.quantize_coeffs(cf)
            gy = torch.from_numpy(rng.standard_normal((10, n))
                                  .astype(np.float32)).to(dt)
            kw = dict(strides=strides, n_tile=nt, k=k)
            y1 = K.spm_overlap_plain(x, cf, mix_a, mix_b, d_in, d_out, bias,
                                     scale, in_width=in_w if win else None,
                                     **kw)
            b1 = K.spm_overlap_bwd_plain(x, cf, gy, mix_a, mix_b, d_in,
                                         d_out, scale,
                                         in_width=in_w if win else None,
                                         **kw)
            sl = slice(j * nl, (j + 1) * nl)
            xr = x if win else x[:, sl].contiguous()
            rkw = dict(kw, mesh=mesh, col_base=j * nl if win else 0,
                       in_width=in_w if win else None)
            sc = None if scale is None else scale[j]
            for blocks in ((10,), (4, 4, 2)):
                y2 = K.spm_overlap_rank_call(
                    xr, cf[j], mix_a[sl], mix_b[sl], d_in[sl], d_out[sl],
                    bias[sl], sc, blocks=blocks, **rkw)
                b2 = K.spm_overlap_bwd_rank_call(
                    xr, cf[j], gy[:, sl].contiguous(), mix_a[sl], mix_b[sl],
                    d_in[sl], d_out[sl], sc, blocks=blocks, **rkw)
                tag = f"k{k} win{int(win)} {dt} q{int(q)} nb{len(blocks)}"
                out[f"{tag} y"] = torch.equal(y1[:, sl], y2)
                out[f"{tag} gx"] = torch.equal(b1[0][:, sl], b2[0])
                if len(blocks) == 1:
                    out[f"{tag} g_cf"] = torch.equal(b1[1][j], b2[1])
                    out[f"{tag} vecs"] = all(
                        torch.equal(a[sl], b) for a, b in zip(b1[2:], b2[2:]))
                else:       # the per-block sums group the rows otherwise
                    out[f"{tag} g_cf"] = torch.allclose(
                        b1[1][j], b2[1], rtol=0,
                        atol=64 * EPS32 * float(b1[1].abs().max() + 1))
    return out


def _smoke_train(mesh, S):
    """Two steps of the 2-layer smoke model, sharded over ``mesh``: the
    losses and the digests of params, moments and count after each."""
    from repro_torch.configs import get_smoke, with_feature_sharding
    from repro_torch.data import DeterministicLoader, build_corpus
    from repro_torch.launch import train as LT
    from repro_torch.models import causal_lm as LM
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.parallel import activation_sharding
    from repro_torch.train import (make_train_state, make_train_step,
                                   state_digest)
    base = get_smoke("qwen3-1.7b")
    cfg = with_feature_sharding(dataclasses.replace(
        base, n_layers=TRAIN_LAYERS, layers=base.layers[:TRAIN_LAYERS]), S)
    state = make_train_state(T.init_model(cfg, seed=0, device="cpu"))
    step = make_train_step(lambda p, b: LM.lm_loss(p, b, cfg),
                           adamw.OptimizerConfig(lr=1e-2, total_steps=3,
                                                 warmup_steps=1),
                           chaos_guard=True)
    loader = DeterministicLoader(LT.make_batch_fn(
        cfg, TRAIN_SEQ, build_corpus(20_000, seed=0)), TRAIN_BATCH, seed=0)
    out = []
    with activation_sharding(mesh, shard_feature=True):
        for s in range(TRAIN_STEPS):
            state, m = step(state, loader.batch_at(s), 0.0)
            opt = state["opt"]
            out.append((float(m["loss"]), float(m["skipped"]), state_digest(
                {"params": state["params"], "mu": opt["mu"],
                 "nu": opt["nu"], "count": opt["count"]})))
    return out


def _rank_job(pod, cases, train: bool):
    """One rank's cases: each operator case on its rank mesh and on a
    one-process mesh (``{case: (rank, one-process)}``), the rank-mode pair
    checks, the training steps (rank mesh, and rank 0 one-process), and
    the mesh rules."""
    from repro_torch.launch.mesh import make_feature_rank_mesh
    from repro_torch.parallel import make_feature_mesh
    S = pod.size
    mesh = make_feature_rank_mesh(S, "cpu")
    one = make_feature_mesh(S, device="cpu")
    res = {"ops": {c: (_operator(c, S, mesh), _operator(c, S, one))
                   for c in cases},
           "pairs": _rank_pair_cases(mesh)}
    if train:
        res["train"] = _smoke_train(mesh, S)
        if pod.rank == 0:
            res["train_one"] = _smoke_train(one, S)
    res["rules"] = _mesh_rules(mesh, S)
    return res


def _mesh_rules(mesh, S):
    """The rank mesh's rules: ``{name: bool}``."""
    from repro_torch.core import spm as T_spm
    from repro_torch.parallel import activation_sharding, make_feature_mesh
    from repro_torch.parallel import spm_shard as T_sh
    from repro_torch.params import Params
    out = {"ranked": mesh.ranked and mesh.shards == (mesh.rank,),
           "forms_apart": (mesh != make_feature_mesh(S, device="cpu")
                           and not make_feature_mesh(S, "cpu").ranked)}
    cfg = T_spm.SPMConfig(n=64, n_stages=6, schedule="two_level",
                          n_shards=2 * S, backward="custom")
    p = T_spm.init_spm(cfg, torch.Generator().manual_seed(0),
                       torch.device("cpu"))
    try:
        T_sh.spm_apply_sharded(p, torch.zeros(3, 64), cfg, mesh)
        out["size_raises"] = False
    except ValueError as e:
        out["size_raises"] = "n_shards" in str(e)
    cfg = dataclasses.replace(cfg, n_shards=S)
    ep = Params({k: torch.stack([p[k]] * 2) for k in p.keys()})
    try:
        with activation_sharding(mesh, shard_feature=True):
            T_spm.spm_apply(ep, torch.zeros(2, 3, 64), cfg)
        out["experts_raise"] = False
    except NotImplementedError as e:
        out["experts_raise"] = "6b" in str(e)
    return out


def _fault_job(pod):
    """Rank 1 raises inside the forward, before its first exchange, while
    rank 0 waits in it."""
    from repro_torch.launch.mesh import make_feature_rank_mesh
    from repro_torch.parallel import spm_shard as T_sh
    mesh = make_feature_rank_mesh(pod.size, "cpu")
    if pod.rank == 1:
        T_sh._exchange = None          # the planted fault: a broken walk
    return _operator("square-serial", pod.size, mesh)


# ---------------------------------------------------------------------------
# the fixtures: one spawn per rank count, the reference meanwhile
# ---------------------------------------------------------------------------

if multiprocessing.parent_process() is None:
    from repro_torch.kernels import peer
    from repro_torch.launch.mesh import run_ranks


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``{2: ranks, 4: ranks, "ref": arrays}``: the port's ranks (every
    case in one spawn per rank count) while the reference's worker runs."""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = (os.path.join(REPO, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             str(d / "ref.npz")], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=env)
    try:
        out = {4: run_ranks(4, _rank_job, (tuple(OP_CASES), True),
                            device="cpu", threads=1, timeout_s=300),
               2: run_ranks(2, _rank_job, (TWO_RANK_CASES, False),
                            device="cpu", threads=1, timeout_s=300)}
    finally:
        stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0, (f"reference worker failed "
                                  f"(rc={proc.returncode}):\n"
                                  f"{stdout[-4000:]}\n{stderr[-4000:]}")
    out["ref"] = dict(np.load(d / "ref.npz"))
    return out


# ---------------------------------------------------------------------------
# the rank executor against the one-process executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,case", [(4, c) for c in OP_CASES]
                         + [(2, c) for c in TWO_RANK_CASES])
def test_rank_executor_is_the_one_process_executor_bitwise(spawned, S,
                                                           case):
    """Every rank's forward, g_x and param grads equal the one-process
    executor's bit for bit (the output and every grad are replicated)."""
    for r, res in enumerate(spawned[S]):
        got, want = res["ops"][case]
        assert set(got) == set(want) == {"y", "gx", "g_mix", "g_d_in",
                                         "g_d_out", "g_bias"}
        for key in want:
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("S", [2, 4])
def test_rank_mode_pair_plain_versions_match_the_one_process_pair(spawned,
                                                                 S):
    """K5's and K6's rank-mode plain versions (the per-block exchange over
    the group) give each rank the one-process pair's columns: y and g_x
    bit for bit, at one block the table and vector grads too, at three
    blocks the table grads within the rows' f32 sums."""
    for r, res in enumerate(spawned[S]):
        bad = [k for k, ok in res["pairs"].items() if not ok]
        assert not bad, (r, bad)
        assert len(res["pairs"]) == 21 * (S.bit_length() - 1)


def test_rank_executor_matches_reference(spawned):
    """One operator case (a windowed bf16 first run, step-serial) on 4
    ranks against the reference's sharded operator under 4 host devices,
    within ``tests/test_torch_shard.py``'s derived bound: depth f32
    roundings plus one bf16 I/O rounding at the reference's scale, times
    8; a parameter grad adds one term a row."""
    ref = spawned["ref"]
    n, L, dt, _, _, _, rows, _ = OP_CASES[REF_CASE]
    got = spawned[4][0]["ops"][REF_CASE][0]
    for key, depth in (("y", L + 2), ("gx", 2 * L + 2), ("g_mix", 2 * L + 2
                                                          + rows),
                       ("g_d_in", 2 * L + 2 + rows),
                       ("g_d_out", 2 * L + 2 + rows),
                       ("g_bias", rows)):
        want = ref[key]
        tol = 8 * (depth * EPS32 + EPS[dt]) * (float(np.abs(want).max()) + 1)
        np.testing.assert_allclose(got[key], want, rtol=0, atol=tol,
                                   err_msg=key)


def test_two_sharded_steps_on_ranks_are_the_one_process_steps(spawned):
    """Two steps of the 2-layer smoke ``qwen3-1.7b`` under
    ``with_feature_sharding(cfg, 4)``: every rank's loss, params, moments
    and count bit for bit equal, and equal to the one-process sharded
    step's."""
    ranks = spawned[4]
    one = ranks[0]["train_one"]
    assert len(one) == TRAIN_STEPS and all(s[1] == 0.0 for s in one)
    for r, res in enumerate(ranks):
        assert res["train"] == one, r


@pytest.mark.parametrize("S", [2, 4])
def test_mesh_rules(spawned, S):
    """A mesh whose size is not the operator's ``n_shards`` raises; an
    expert stack over a rank mesh raises, naming §1 item 6b; the rank form
    is never taken for the one-process form."""
    for res in spawned[S]:
        assert res["rules"] == {"ranked": True, "forms_apart": True,
                                "size_raises": True, "experts_raise": True}


# ---------------------------------------------------------------------------
# the transport's schedule
# ---------------------------------------------------------------------------

def _simulate(calls):
    """Two ranks' streams running ``pair_schedule`` for each ``nb`` of
    ``calls`` in turn, interleaved one op at a time while they can run (a
    wait blocks its stream until the word has reached its number): checks
    that no slot is rewritten before its credit, that a consume reads the
    partner's block of its own number, and returns the final words."""
    ranks = []
    for _ in range(2):
        seq, ops = 0, []
        for nb in calls:
            sched, seq = peer.pair_schedule(nb, seq)
            ops.extend(sched)
        ranks.append(dict(ops=ops, pc=0, data=[0, 0], credit=[0, 0],
                          recv=[None, None], consumed=[True, True]))
    while any(r["pc"] < len(r["ops"]) for r in ranks):
        moved = False
        for me, r in enumerate(ranks):
            if r["pc"] >= len(r["ops"]):
                continue
            op = r["ops"][r["pc"]]
            other = ranks[1 - me]
            if op.kind == "data_wait" and r["data"][op.slot] < op.seq:
                continue
            if op.kind == "credit_wait" and r["credit"][op.slot] < op.seq:
                continue
            if op.kind == "send":
                assert other["consumed"][op.slot], ("slot rewritten before "
                                                    "its credit", op)
                other["recv"][op.slot] = op.seq
                other["consumed"][op.slot] = False
            elif op.kind == "signal":
                assert op.seq > other["data"][op.slot]
                other["data"][op.slot] = op.seq
            elif op.kind == "consume":
                assert r["recv"][op.slot] == op.seq, op
                r["consumed"][op.slot] = True
            elif op.kind == "credit":
                assert op.seq > other["credit"][op.slot]
                other["credit"][op.slot] = op.seq
            r["pc"] += 1
            moved = True
        assert moved, "the two streams wait on each other"
    return ranks


@pytest.mark.parametrize("nb", [1, 2, 3, 4, 5])
def test_pair_schedule_slots_credits_and_drain(nb):
    """Over two calls in a row: sends before the previous block's consume,
    no slot rewritten before its credit, the numbers strictly growing, and
    every credit consumed by the end of each call (the drain)."""
    ops, nxt = peer.pair_schedule(nb, 7)
    assert nxt == 7 + nb
    seqs = [o.seq for o in ops if o.kind == "send"]
    assert seqs == list(range(8, 8 + nb))
    kinds = [(o.kind, o.block) for o in ops]
    for i in range(1, nb):
        assert kinds.index(("send", i)) < kinds.index(("consume", i - 1))
    drained = {o.slot: o.seq for o in ops[-min(nb, peer.SLOTS):]}
    assert all(o.kind == "credit_wait" for o in ops[-min(nb, peer.SLOTS):])
    assert drained == {i % peer.SLOTS: 7 + i + 1
                       for i in range(max(0, nb - 2), nb)}
    ranks = _simulate([nb, nb])
    for r in ranks:
        assert all(r["consumed"])
        last = {}
        for i in range(2 * nb):             # block i % nb of call i // nb
            last[(i % nb) % peer.SLOTS] = i + 1
        assert r["credit"] == [last.get(s, 0) for s in range(peer.SLOTS)]
        assert r["data"] == r["credit"]


def test_pair_schedule_over_mixed_calls():
    """Calls of 3, 1, 5 and 2 blocks in a row through one channel."""
    ranks = _simulate([3, 1, 5, 2])
    assert all(all(r["consumed"]) for r in ranks)
    assert max(ranks[0]["credit"]) == 11


# ---------------------------------------------------------------------------
# a failing rank
# ---------------------------------------------------------------------------

def test_a_rank_that_raises_ends_the_group():
    """Rank 1 raises inside the forward while rank 0 waits in the exchange:
    the group ends and rank 0 fails well inside 30 s, never at the
    collective timeout."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1"):
        run_ranks(2, _fault_job, device="cpu", threads=1, timeout_s=300)
    assert time.perf_counter() - t0 < 30
