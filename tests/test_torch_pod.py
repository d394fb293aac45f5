"""The port's data-parallel pod on the CPU, against the JAX reference.

The port runs one ``torch.distributed`` rank a pod member (gloo, one torch
thread a rank); the reference one controller over a ("pod",) mesh under
``shard_map``.  The reference's side runs once, in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (this file run as a
script, one process a mode, at once), each of its steps jitted once; the
port's side runs once, in one
pod of 4 ranks (``launch.mesh.run_ranks``) that also forms a 2-member
subgroup, while the reference computes.  The two meet on the same inputs:

* the plain functions (``compress``, ``decompress``, the tree forms with a
  ``(mu, nu)`` pair, ``ef_step``, ``init_residual``) bit for bit against
  the reference as its compiled step runs them (jitted: XLA contracts the
  residual's ``g' - q*s`` into one rounding), on an absmax that is no
  multiple of 127 and on values at .5 codes;
* the collectives over 2 and 4 members with wildly different magnitudes
  (as ``tests/test_distributed.py`` draws them): ``psum_compressed`` and
  ``psum_compressed_ef`` bit for bit, ``pmean`` bit for bit at 2 and
  within n - 1 f32 roundings at 4 (the members' sum in another order);
* the pod step against the reference's pod step, on the smoke
  ``qwen3-1.7b``, both modes, a healthy step then a poisoned one, within
  the bound ``tests/test_torch_train.py`` derives; compressed, a code may
  differ between the packages only where the pre-quantization value lies
  within that bound of a .5 boundary, and such flips are counted;
* the reference's convergence contract (``tests/test_distributed.py``'s
  compressed-pod test) at ``--pod-dp 4``: both modes train below the
  initial loss, within 5% of each other, every rank bitwise equal;
* checkpoints: a pod checkpoint has the reference's signature and layout
  (``opt.ef`` of shape ``(n, ...)``), the reference restores it, each rank
  restores its own row, a pod of another size is refused, and a
  ``preempt@`` run resumes bit for bit equal to the uninterrupted run.
"""

import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
N_DEV = 4
B, T_SEQ = 4, 16                 # the pod step's global batch
LR = 1e-2


def _member_grads(n: int, seed: int) -> dict:
    """Per-member grads ``{"a": (n, 40, 33), "b": (n, 7)}`` and residuals:
    odd members 200x the even ones (a member's local scale would put them
    on another grid); member 1's absmax is 127 exactly (scale 1.0) with
    entries at .5 codes."""
    rng = np.random.default_rng(seed)
    mag = np.array([2.0 if i % 2 else 0.01 for i in range(n)], np.float32)
    a = (rng.standard_normal((n, 40, 33)) * mag[:, None, None]
         ).astype(np.float32)
    b = (rng.standard_normal((n, 7)) * mag[:, None] * 3).astype(np.float32)
    a[1] *= np.float32(127.0) / np.abs(a[1]).max()
    a[1, 0, :6] = [127.0, 0.5, 1.5, -2.5, -3.5, 100.5]
    ra = (rng.standard_normal((n, 40, 33)) * 1e-3).astype(np.float32)
    rb = (rng.standard_normal((n, 7)) * 1e-3).astype(np.float32)
    return {"g_a": a, "g_b": b, "r_a": ra, "r_b": rb}


def _draw_params(shapes, seed: int = 0) -> list:
    """Numpy leaves for the reference's parameter tree: rotation 2x2
    blocks with noise for the SPM tables, 1 + noise for diagonals and norm
    scales, small normals elsewhere."""
    import jax
    rng = np.random.default_rng(seed)
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['mix']"):
            th = rng.uniform(-np.pi, np.pi, shape[:-1])
            v = np.stack([np.cos(th), -np.sin(th), np.sin(th), np.cos(th)],
                         -1) + 0.05 * rng.standard_normal(shape)
        elif any(name.endswith(f"['{k}']") for k in ("d_in", "d_out",
                                                    "scale")) \
                or name.endswith("_norm']"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        out.append(v.astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# the reference's side (run as a script)
# ---------------------------------------------------------------------------

def _ref_worker(inp: str, outp: str, mode: int) -> None:
    """The reference's pod step in ``mode`` (0: mean, 1: compressed; the
    two run in two processes at once) and, in mode 0, the collectives."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_smoke
    from repro.models import causal_lm as J_LM
    from repro.models import transformer as J_T
    from repro.optim import compression as JC
    from repro.optim.adamw import OptimizerConfig
    from repro.train import make_pod_train_step, make_train_state

    d = dict(np.load(inp))
    out = {}
    devs = jax.devices()
    for n in ((2, 4) if mode == 0 else ()):
        mesh = Mesh(np.asarray(devs[:n]), ("pod",))
        g = {k: jnp.asarray(d[f"c{n}_g_{k}"]) for k in ("a", "b")}
        r = {k: jnp.asarray(d[f"c{n}_r_{k}"]) for k in ("a", "b")}

        def body(g, r):
            g = jax.tree.map(lambda x: x[0], g)
            r = jax.tree.map(lambda x: x[0], r)
            pc = JC.psum_compressed(g, "pod")
            tot, new = JC.psum_compressed_ef(g, r, "pod")
            pm = jax.tree.map(lambda x: jax.lax.pmean(x, "pod"), g)
            return jax.tree.map(lambda x: x[None], (pc, tot, new, pm))

        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                              out_specs=P("pod"), check_rep=False))
        for name, t in zip(("pc", "tot", "new", "pm"), f(g, r)):
            for k in ("a", "b"):
                out[f"c{n}_{name}_{k}"] = np.asarray(t[k])

    cfg = get_smoke("qwen3-1.7b")
    shapes = jax.eval_shape(lambda: J_T.init_model(jax.random.PRNGKey(0),
                                                   cfg))
    treedef = jax.tree.structure(shapes)
    n_leaves = treedef.num_leaves
    params = treedef.unflatten([jnp.asarray(d[f"p{i}"])
                                for i in range(n_leaves)])
    mesh = Mesh(np.asarray(devs[:2]), ("pod",))
    opt = OptimizerConfig(lr=LR, total_steps=2, warmup_steps=1)
    loss_fn = lambda p, b: J_LM.lm_loss(p, b, cfg)      # noqa: E731
    batches = [{k: jnp.asarray(d[f"{k}{s}"], jnp.int32)
                for k in ("tokens", "labels")} for s in range(2)]
    state = make_train_state(params, ef_pod=2 if mode else 0)
    # one compile: the step's outputs have its inputs' types
    step = jax.jit(make_pod_train_step(loss_fn, opt, mesh,
                                       compress=bool(mode),
                                       chaos_guard=True)).lower(
        state, batches[0], np.float32(0)).compile()
    for s in range(2):
        state, m = step(state, batches[s], np.float32(s))
        pre = f"m{mode}s{s}"
        for key in ("loss", "grad_norm", "skipped"):
            out[f"{pre}_{key}"] = np.asarray(m[key])
        for part in ("mu", "nu"):
            for i, x in enumerate(jax.tree.leaves(state["opt"][part])):
                out[f"{pre}_{part}_{i}"] = np.asarray(x)
        for i, x in enumerate(jax.tree.leaves(state["params"])):
            out[f"{pre}_params_{i}"] = np.asarray(x)
        if mode:
            for i, x in enumerate(jax.tree.leaves(state["opt"]["ef"])):
                out[f"{pre}_ef_{i}"] = np.asarray(x)
    np.savez(outp, **out)


if __name__ == "__main__":
    _ref_worker(sys.argv[1], sys.argv[2], int(sys.argv[3]))
    sys.exit(0)

torch = pytest.importorskip("torch")


# ---------------------------------------------------------------------------
# the port's side: one pod of 4 ranks (functions that pickle by name)
# ---------------------------------------------------------------------------

def _smoke_args(*extra):
    from repro_torch.launch import train as LT
    return LT.build_parser().parse_args(
        ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
         "--log-every", "100", "--backoff-base", "0"] + list(extra))


def _replicated_digest(state) -> str:
    """Digest of what a pod replicates (params, moments, count)."""
    from repro_torch.train import state_digest
    opt = state["opt"]
    return state_digest({"params": state["params"], "mu": opt["mu"],
                         "nu": opt["nu"], "count": opt["count"]})


def _numpy(tree: dict) -> dict:
    return {k: v.detach().clone().numpy() for k, v in tree.items()}


def _pod_step_job(sub, job, out):
    """The 2-member pod step, both modes: a healthy step then a poisoned
    one, the state after each and the step-0 reduction's inputs."""
    from repro_torch.configs import get_smoke
    from repro_torch.convert import params_from_jax
    from repro_torch.models import causal_lm as LM
    from repro_torch.models.transformer import stack_key
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.parallel.sharding import member_rows
    from repro_torch.train import (make_pod_train_step, make_train_state,
                                   pod_residual)
    cfg = get_smoke("qwen3-1.7b")
    opt = OptimizerConfig(lr=LR, total_steps=2, warmup_steps=1)
    seen = {}

    def capture(step, local, residual, reduced, new_ef, seconds):
        if step == 0:
            seen["local"] = _numpy(local)
            seen["reduced"] = _numpy(reduced)

    for mode in (0, 1):
        params = params_from_jax(job["params"], cfg, device="cpu")
        state = make_train_state(params)
        if mode:
            state["opt"]["ef"] = pod_residual(params, 1)
        step = make_pod_train_step(lambda p, b: LM.lm_loss(p, b, cfg), opt,
                                   sub, compress=bool(mode),
                                   chaos_guard=True, on_reduce=capture,
                                   scale_key=stack_key(cfg))
        for s in range(2):
            batch = member_rows({k: torch.from_numpy(job[f"{k}{s}"])
                                 for k in ("tokens", "labels")}, sub)
            state, m = step(state, batch, float(s))
            pre = f"m{mode}s{s}"
            out[pre] = {
                "metrics": LM.train_metrics(m),
                "params": _numpy(dict(state["params"].named_parameters())),
                "mu": _numpy(state["opt"]["mu"]),
                "nu": _numpy(state["opt"]["nu"]),
                "count": int(state["opt"]["count"]),
                "ef": _numpy(state["opt"]["ef"]) if mode else None}
        out[f"m{mode}_local"] = seen.pop("local")
        out[f"m{mode}_reduced"] = seen.pop("reduced")


def _ckpt_job(world, sub, job, out):
    """A pod checkpoint of an unstacked tree saved by 2 members, restored
    by each, and refused by a pod of 4."""
    from repro_torch.convert import tree_from_jax
    from repro_torch.train import (make_train_state, pod_residual,
                                   restore_checkpoint, save_checkpoint)
    d = job["ckpt_dir"]

    def fresh():
        params = tree_from_jax(job["tree"], device="cpu")
        state = make_train_state(params)
        state["opt"]["ef"] = pod_residual(params, 1)
        return state

    if sub is not None:
        state = fresh()
        with torch.no_grad():
            for i, t in enumerate(state["opt"]["ef"].values()):
                t.copy_(torch.arange(t.numel(), dtype=torch.float32)
                        .reshape(t.shape) * (sub.rank + 1) + i)
            for t in state["opt"]["mu"].values():
                t.fill_(0.25)
        state["step"] += 3
        save_checkpoint(d, 3, state, extra={"cursor": {"seed": 0,
                                                        "step": 3}},
                        mesh=sub)
        like = fresh()
        restore_checkpoint(d, like, mesh=sub)
        out["ckpt_row_ok"] = all(
            torch.equal(like["opt"]["ef"][k], v)
            for k, v in state["opt"]["ef"].items()) and all(
            torch.equal(like["opt"]["mu"][k], v)
            for k, v in state["opt"]["mu"].items())
    world.barrier()
    try:
        restore_checkpoint(d, fresh(), mesh=world)
        out["ckpt_other_size"] = "restored"
    except ValueError as e:
        out["ckpt_other_size"] = str(e)


def _train_jobs(world, job, out):
    """Through ``launch.train.train`` joining the 4-rank group: the
    convergence contract's two runs, and a preempted compressed run
    against its uninterrupted twin."""
    from repro_torch.launch import train as LT
    from repro_torch.train.fault import FaultEventLog
    for mode in (0, 1):
        extra = ["--compress-pod-grads"] if mode else []
        st = LT.train(_smoke_args("--steps", "20", "--batch", "8", "--seq",
                                  "32", "--pod-dp", "4", *extra))
        out[f"conv{mode}_digest"] = _replicated_digest(st)
        out[f"conv{mode}_ef"] = "ef" in st["opt"]
        if world.rank == 0:
            out[f"conv{mode}_state"] = st
    finals = {}
    for name, spec, ckpt in (("clean", "nan@1", ""),
                             ("preempted", "nan@1;preempt@3",
                              job["resume_dir"])):
        log = FaultEventLog()
        st = LT.train(_smoke_args(
            "--steps", "6", "--batch", "8", "--seq", "16", "--pod-dp", "4",
            "--compress-pod-grads", "--ckpt-every", "2", "--chaos-spec", spec,
            *(["--ckpt-dir", ckpt] if ckpt else [])), event_log=log)
        finals[name] = (_replicated_digest(st),
                        {k: v.clone() for k, v in st["opt"]["ef"].items()},
                        int(st["step"]))
        out[f"{name}_events"] = log.kinds()
    out["resume_same"] = (finals["clean"][0] == finals["preempted"][0]
                          and finals["clean"][2] == finals["preempted"][2]
                          and all(torch.equal(v, finals["preempted"][1][k])
                                  for k, v in finals["clean"][1].items()))


def _port_jobs(world, job):
    """Every port-side job on one rank of the 4-rank pod; returns what the
    parent compares (rank 0's train states stay in the parent)."""
    import torch.distributed as dist

    from repro_torch.parallel.ctx import PodMesh, bind_axis
    from repro_torch.optim import compression as C
    group = dist.new_group([0, 1])
    sub = (PodMesh(rank=world.rank, size=2, device=world.device,
                   backend="gloo", group=group) if world.rank < 2 else None)
    out = {}
    for n, mesh in ((2, sub), (4, world)):
        if mesh is None:
            continue
        g = {k: torch.from_numpy(job[f"c{n}_g_{k}"][mesh.rank].copy())
             for k in ("a", "b")}
        r = {k: torch.from_numpy(job[f"c{n}_r_{k}"][mesh.rank].copy())
             for k in ("a", "b")}
        with bind_axis(mesh):
            pc = C.psum_compressed(g, "pod")
            tot, new = C.psum_compressed_ef(g, r, "pod")
            pm = C.pmean(g, "pod")
        for name, t in (("pc", pc), ("tot", tot), ("new", new), ("pm", pm)):
            for k in ("a", "b"):
                out[f"c{n}_{name}_{k}"] = t[k].numpy()
    if sub is not None:
        _pod_step_job(sub, job, out)
    _ckpt_job(world, sub, job, out)
    _train_jobs(world, job, out)
    return out


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def _model_depth(cfg) -> int:
    """Dependent f32 roundings through the smoke model's forward, as
    ``tests/test_torch_train.py`` counts them."""
    L_attn, L_ffn = 6, 7
    per_layer = (cfg.d_model + 3 * L_attn + 8 + cfg.head_dim + 32
                 + 3 * L_attn + 3 * (3 * L_ffn + 4) + cfg.d_model)
    return cfg.n_layers * per_layer + 2 * cfg.d_model


# A pod rank imports this file only for _port_jobs: the reference's
# imports would cost each rank seconds, and nothing below needs them
# there.
if multiprocessing.parent_process() is None:
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke as j_get_smoke
    from repro.models import transformer as J_T
    from repro.optim import compression as JC
    from repro.train import checkpoint as J_ckpt
    from repro.train import state as J_state
    from repro_torch.configs import get_smoke
    from repro_torch.convert import params_from_jax, tree_from_jax
    from repro_torch.data import DeterministicLoader, build_corpus
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import (make_host_mesh,
                                         make_production_mesh, run_ranks)
    from repro_torch.models import causal_lm as LM
    from repro_torch.models.transformer import stack_key
    from repro_torch.optim import compression as C
    from repro_torch.parallel.ctx import PodMesh
    from repro_torch.parallel.sharding import (batch_spec,
                                               data_axes, member_rows)
    from repro_torch.train import make_train_state, tree_signature

    REL = 8 * 2 * _model_depth(get_smoke("qwen3-1.7b")) * EPS32


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """``(reference, port)``: the reference worker's arrays and the port's
    per-rank results, computed at once (the subprocess runs while the
    ranks do)."""
    d = tmp_path_factory.mktemp("pod")
    jcfg = j_get_smoke("qwen3-1.7b")
    shapes = jax.eval_shape(lambda: J_T.init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    leaves = _draw_params(shapes)
    tcfg = get_smoke("qwen3-1.7b")
    loader = DeterministicLoader(
        LT.make_batch_fn(tcfg, T_SEQ, build_corpus(20_000, seed=0)), B,
        seed=0)
    inputs = {f"p{i}": x for i, x in enumerate(leaves)}
    for s in range(2):
        for k, v in loader.batch_at(s).items():
            inputs[f"{k}{s}"] = v.numpy()
    for n in (2, 4):
        inputs.update({f"c{n}_{k}": v
                       for k, v in _member_grads(n, seed=n).items()})
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + f" --xla_force_host_platform_device_count={N_DEV}")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = (os.path.join(REPO, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(d / "inputs.npz"),
         str(d / f"ref{mode}.npz"), str(mode)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
        for mode in (0, 1)]
    rng = np.random.default_rng(4)
    tree = {"mix": rng.standard_normal((3, 4)).astype(np.float32),
            "head": {"w": rng.standard_normal((4, 2)).astype(np.float32),
                     "b": rng.standard_normal(2).astype(np.float32)}}
    job = dict(inputs, params=jax.tree.unflatten(
        jax.tree.structure(shapes), leaves), tree=tree,
        ckpt_dir=str(d / "ckpt"), resume_dir=str(d / "resume"))
    try:
        port = run_ranks(N_DEV, _port_jobs, (job,), device="cpu", threads=1,
                         timeout_s=300)
    finally:
        logs = [p.communicate(timeout=900) for p in procs]
    ref = {}
    for mode, (p, (stdout, stderr)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, (f"reference worker {mode} failed "
                                   f"(rc={p.returncode}):\n"
                                   f"{stdout[-4000:]}\n{stderr[-4000:]}")
        ref.update(np.load(d / f"ref{mode}.npz"))
    ref["_treedef"] = jax.tree.structure(shapes)
    return ref, port, job


# ---------------------------------------------------------------------------
# the plain functions, in this process
# ---------------------------------------------------------------------------

def _plain_inputs():
    c = _member_grads(2, seed=7)
    return c["g_a"][1], c["g_a"][0], c["r_a"][0]


def test_compress_and_decompress_match_reference_bitwise():
    for x in _plain_inputs():
        q, s = C.compress(torch.from_numpy(x))
        jq, js = jax.jit(JC.compress)(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert q.dtype == torch.int8 and s.dim() == 0
        assert np.float32(s) == np.asarray(js)
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            got = C.decompress(q, s, dt).float().numpy()
            want = np.asarray(jax.jit(JC.decompress, static_argnums=2)(
                jq, js, jdt).astype(jnp.float32))
            np.testing.assert_array_equal(got, want)
    # the .5 codes round half to even
    q, s = C.compress(torch.from_numpy(_plain_inputs()[0]))
    assert float(s) == 1.0
    assert q[0, :6].tolist() == [127, 0, 2, -2, -4, 100]


def test_tree_forms_match_reference_and_keep_pairs():
    g, h, r = _plain_inputs()
    tree = ({"w": torch.from_numpy(g), "v": {"b": torch.from_numpy(h[0])}},
            {"w": torch.from_numpy(r), "v": {"b": torch.from_numpy(h[1])}})
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    ct = C.compress_tree(tree)
    jct = jax.jit(JC.compress_tree)(jtree)
    assert isinstance(ct, tuple) and len(ct) == 2       # (mu, nu) kept
    assert not C._is_compressed_leaf(ct)
    assert C._is_compressed_leaf(ct[0]["w"])
    for (q, s), (jq, js) in zip(
            [ct[0]["w"], ct[0]["v"]["b"], ct[1]["w"], ct[1]["v"]["b"]],
            [jct[0]["w"], jct[0]["v"]["b"], jct[1]["w"], jct[1]["v"]["b"]]):
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert np.float32(s) == np.asarray(js)
    back = C.decompress_tree(ct, tree)
    jback = jax.jit(JC.decompress_tree)(jct, jtree)
    for i in range(2):
        for a, b in ((back[i]["w"], jback[i]["w"]),
                     (back[i]["v"]["b"], jback[i]["v"]["b"])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ef_step_and_init_residual_match_reference_bitwise():
    g, h, r = _plain_inputs()
    grads = {"w": torch.from_numpy(g), "h": torch.from_numpy(h)}
    res = {"w": torch.from_numpy(r), "h": torch.from_numpy(r * 3)}
    out, new = C.ef_step(grads, res)
    jout, jnew = jax.jit(JC.ef_step)(
        {k: jnp.asarray(v.numpy()) for k, v in grads.items()},
        {k: jnp.asarray(v.numpy()) for k, v in res.items()})
    for k in grads:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
        np.testing.assert_array_equal(new[k].numpy(), np.asarray(jnew[k]))
    zero = C.init_residual({"w": grads["w"].to(torch.bfloat16)})
    jzero = JC.init_residual({"w": jnp.zeros(g.shape, jnp.bfloat16)})
    assert zero["w"].dtype == torch.float32
    assert np.asarray(jzero["w"]).dtype == np.float32
    assert not zero["w"].any() and zero["w"].shape == g.shape


def test_mesh_helpers():
    for r in range(4):
        mesh = PodMesh(rank=r, size=4, device=torch.device("cpu"))
        assert data_axes(mesh) == ("pod",) == mesh.axis_names
        assert batch_spec(mesh) == (("pod",),)
        assert mesh.shape == {"pod": 4}
        batch = {"tokens": torch.arange(24).reshape(8, 3),
                 "positions": torch.arange(48).reshape(3, 8, 2)}
        rows = member_rows(batch, mesh)
        # P("pod"): member r holds rows [2r, 2r + 2)
        assert torch.equal(rows["tokens"], batch["tokens"][2 * r:2 * r + 2])
        assert torch.equal(rows["positions"],
                           batch["positions"][:, 2 * r:2 * r + 2])
    host = make_host_mesh("cpu")
    assert host.size == 1 and member_rows(batch, host) is batch
    with pytest.raises(NotImplementedError, match="item 7"):
        make_production_mesh()
    with pytest.raises(ValueError, match="unbound axis"):
        C.pmean({"a": torch.ones(2)}, "pod")
    with pytest.raises(ValueError, match="split over a pod"):
        member_rows({"tokens": torch.zeros(3, 2)},
                    PodMesh(rank=0, size=2, device=torch.device("cpu")))


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_collectives_match_reference(sides, n):
    """Each rank's results bit for bit the reference's member's, and the
    plain version over the stacked members (``member_sum_compressed_ef``)
    bit for bit too."""
    ref, port, _ = sides
    c = _member_grads(n, seed=n)
    tot, new = C.member_sum_compressed_ef(
        {k: torch.from_numpy(c[f"g_{k}"]) for k in ("a", "b")},
        {k: torch.from_numpy(c[f"r_{k}"]) for k in ("a", "b")})
    for k in ("a", "b"):
        np.testing.assert_array_equal(tot[k].numpy(), ref[f"c{n}_tot_{k}"][0])
        np.testing.assert_array_equal(new[k].numpy(), ref[f"c{n}_new_{k}"])
        for name in ("pc", "tot", "new"):
            for r in range(n):
                np.testing.assert_array_equal(
                    port[r][f"c{n}_{name}_{k}"], ref[f"c{n}_{name}_{k}"][r],
                    err_msg=f"{name} {k} member {r}")
        pm = [port[r][f"c{n}_pm_{k}"] for r in range(n)]
        for r in range(1, n):
            np.testing.assert_array_equal(pm[r], pm[0])   # replicated
        want = ref[f"c{n}_pm_{k}"][0]
        if n == 2:
            np.testing.assert_array_equal(pm[0], want)
        else:
            bound = (n - 1) * EPS32 * np.abs(c[f"g_{k}"]).sum(0) / n
            assert np.all(np.abs(pm[0] - want) <= bound)


# ---------------------------------------------------------------------------
# the pod step against the reference's
# ---------------------------------------------------------------------------

def _ref_tree(ref, pre, part, tcfg, member=None):
    """The reference's ``part`` leaves after step ``pre``, in the port's
    names (unstacked); ``member`` picks a row of the residual."""
    leaves = [ref[f"{pre}_{part}_{i}"] for i in range(
        ref["_treedef"].num_leaves)]
    if member is not None:
        leaves = [x[member] for x in leaves]
    tree = jax.tree.unflatten(ref["_treedef"], leaves)
    return {k: v.detach().numpy() for k, v in params_from_jax(
        tree, tcfg, device="cpu").named_parameters()}


def _scale(gs):
    """The pod-max scale of one leaf's member grads, as both packages
    compute it (f32)."""
    return max(np.float32(np.abs(g).max()) / np.float32(127)
               + np.float32(1e-12) for g in gs)


@pytest.mark.parametrize("mode", [0, 1], ids=["mean", "compressed"])
def test_pod_step_matches_reference(sides, mode):
    """Step 0: loss, grad norm, params within the derived bound (params
    over the elements whose codes agree, compressed).  Step 1 is poisoned:
    skipped on both sides and every rank's state bitwise unchanged."""
    ref, port, job = sides
    tcfg = get_smoke("qwen3-1.7b")
    r0, r1 = port[0], port[1]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(r0[f"m{mode}s0"]["metrics"][key],
                                   float(ref[f"m{mode}s0_{key}"]), rtol=REL)
    flips = {}
    if mode:
        # The reference's codes at step 0 come from its new residual: r' =
        # g' - q*s with |r'| <= s/2 and g' (zero residual before) within
        # the bound of the port's g', so q = round((g'_port - r') / s).
        gp = [r0["m1_local"], r1["m1_local"]]
        key = stack_key(tcfg)          # a scale spans a reference array
        group = {}
        for k in gp[0]:
            group.setdefault(key(k), []).append(k)
        n_flip = n_band = 0
        for k in gp[0]:
            members = [g[j] for g in gp for j in group[key(k)]]
            tol = REL * (max(np.abs(g).max() for g in members) + 1e-6)
            s_p = _scale(members)
            ds = REL * s_p + tol / 127        # the scales' difference
            flip = np.zeros(gp[0][k].shape, bool)
            for m in range(2):
                ef_r = _ref_tree(ref, "m1s0", "ef", tcfg, member=m)[k]
                u = gp[m][k] / s_p
                qp = np.clip(np.round(u), -127, 127)
                qr = np.clip(np.round((gp[m][k] - ef_r) / s_p), -127, 127)
                # within the bound of a .5 boundary, in code units
                band = (np.abs(np.abs(u - np.floor(u)) - 0.5)
                        <= 2 * (tol + np.abs(u) * ds) / s_p)
                f = qp != qr
                assert not np.any(f & ~band), (k, m)
                n_flip += int(f.sum())
                n_band += int(band.sum())
                flip |= f
                # each member's new residual: equal codes leave the
                # grads' and the scales' differences
                ef_p = (r0, r1)[m]["m1s0"]["ef"][k][0]
                err = np.abs(ef_p - ef_r)
                assert np.all(err[~f] <= tol + 128 * ds + REL * s_p), k
                assert np.all(err[f] <= s_p + tol + 128 * ds), k
            flips[k] = flip
        assert n_flip <= n_band
        print(f"compressed step 0: {n_flip} code flips of {n_band} "
              f"values within the bound of a .5 boundary")
    ref_p = _ref_tree(ref, f"m{mode}s0", "params", tcfg)
    p0 = {k: v.detach().numpy() for k, v in params_from_jax(
        job["params"], tcfg, device="cpu").named_parameters()}
    got = r0[f"m{mode}s0"]["params"]
    keep = {k: ~flips.get(k, np.zeros(v.shape, bool)) for k, v in got.items()}
    diff = sum(float(((got[k] - ref_p[k])[keep[k]] ** 2).sum())
               for k in got) ** .5
    moved = sum(float(((ref_p[k] - p0[k])[keep[k]] ** 2).sum())
                for k in got) ** .5
    assert diff <= REL * moved, (diff, moved)
    for k, f in flips.items():
        assert np.all(np.abs(got[k] - ref_p[k])[f] <= 2.5 * LR), k
    # the poisoned step
    assert float(ref[f"m{mode}s1_skipped"]) == 1.0
    for r in (r0, r1):
        before, after = r[f"m{mode}s0"], r[f"m{mode}s1"]
        assert after["metrics"]["skipped"] == 1.0
        assert after["count"] == before["count"] == 1
        for part in ("params", "mu", "nu") + (("ef",) if mode else ()):
            for k, v in before[part].items():
                np.testing.assert_array_equal(after[part][k], v,
                                              err_msg=f"{part} {k}")
    # replicated across the two ranks, bit for bit
    for part in ("params", "mu", "nu"):
        for k, v in r0[f"m{mode}s0"][part].items():
            np.testing.assert_array_equal(r1[f"m{mode}s0"][part][k], v)
    for k, v in r0[f"m{mode}_reduced"].items():
        np.testing.assert_array_equal(r1[f"m{mode}_reduced"][k], v)


# ---------------------------------------------------------------------------
# training, convergence and checkpoints
# ---------------------------------------------------------------------------

def test_convergence_contract_at_pod_4(sides):
    _, port, _ = sides
    cfg = get_smoke("qwen3-1.7b")
    held = LT.make_batch_fn(cfg, 32, build_corpus(200_000, seed=0))(
        np.random.default_rng(99), 16)
    with torch.no_grad():
        from repro_torch.models import transformer as T
        l0 = float(LM.lm_loss(T.init_model(cfg, seed=0, device="cpu"),
                              held, cfg)[0])
        lu, lc = (float(LM.lm_loss(port[0][f"conv{m}_state"]["params"],
                                   held, cfg)[0]) for m in (0, 1))
    assert lu < l0 and lc < l0
    assert abs(lc - lu) <= 0.05 * lu, (lc, lu, l0)
    for m in (0, 1):
        assert len({p[f"conv{m}_digest"] for p in port}) == 1
        assert all(p[f"conv{m}_ef"] == bool(m) for p in port)


def test_preempted_pod_run_resumes_bitwise(sides):
    _, port, _ = sides
    for p in port:
        assert p["resume_same"]
    events = port[0]["preempted_events"]
    assert "chaos_preempt" in events and "restart" in events
    assert "skip" in port[0]["clean_events"]


def test_pod_checkpoint_has_the_reference_layout(sides):
    _, port, job = sides
    assert port[0]["ckpt_row_ok"] and port[1]["ckpt_row_ok"]
    for p in port:
        assert "structure mismatch" in p["ckpt_other_size"]
    tree = job["tree"]
    params = tree_from_jax(tree, device="cpu")
    jstate = J_state.make_train_state(jax.tree.map(jnp.asarray, tree),
                                      ef_pod=2)
    sig = tree_signature(make_train_state(params, ef_pod=2))
    assert sig == J_state.tree_signature(jstate)
    meta = J_ckpt.verify_checkpoint(job["ckpt_dir"], 3)
    assert meta == []
    got, extra = J_ckpt.restore_checkpoint(job["ckpt_dir"], jstate)
    assert extra == {"cursor": {"seed": 0, "step": 3}}
    assert int(got["step"]) == 3
    for i, leaf in enumerate(jax.tree.leaves(got["opt"]["ef"])):
        leaf = np.asarray(leaf)
        assert leaf.shape[0] == 2
        for r in range(2):
            want = np.arange(leaf[r].size, dtype=np.float32).reshape(
                leaf[r].shape) * (r + 1)
            # leaves in the reference's order: the port's keys sorted
            assert np.all(leaf[r] - want == leaf[r].flat[0]), (i, r)


# ---------------------------------------------------------------------------
# a fault on one rank alone
# ---------------------------------------------------------------------------

def _fault_on_rank_1(s, state, metrics, seconds):
    """``on_step`` that fails rank 1 alone after step 1 (pickles by name)."""
    import torch.distributed as dist
    if s == 1 and dist.get_rank() == 1:
        raise RuntimeError("planted fault on rank 1")


def test_a_fault_on_one_rank_ends_the_pod(tmp_path):
    """A fault that only rank 1 raises is not restarted: rank 1 alone
    would rejoin at ``init_state``'s digest gather while rank 0 waits in
    the step's reduction.  The pod ends with rank 1's error long before
    the collective timeout, and no rank logs a restart."""
    from repro_torch.train.fault import FaultEventLog
    log = FaultEventLog()
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="planted fault on rank 1"):
        LT.train(_smoke_args("--steps", "4", "--batch", "4", "--seq", "16",
                             "--pod-dp", "2", "--ckpt-dir", str(tmp_path),
                             "--ckpt-every", "1"),
                 event_log=log, on_step=_fault_on_rank_1)
    assert time.perf_counter() - t0 < 120
    assert "restart" not in log.kinds()
