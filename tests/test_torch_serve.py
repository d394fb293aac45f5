"""The port's continuous batching on the CPU against the reference's
``ContinuousBatchingEngine`` (``repro/serve/engine.py``), on the smoke
``qwen3-1.7b``: per-request sampling given the reference's own Gumbel
noise, per-row decode positions and bucketed prefill, greedy tokens, churn
parity at equal slot count, the tick's fixed operation sequence, and the
torch serve bench's schedule numbers against ``BENCH_serve.json``.

The reference runs its default path (the XLA composition on the CPU) with
weights drawn in numpy in its tree's shape (``jax.eval_shape``), so no RNG
compiles; its continuous engine runs once in this module.
"""

import dataclasses
import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.models import causal_lm as J_LM  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import engine as J_E  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import causal_lm as LM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import (ContinuousBatchingEngine, Request,  # noqa: E402
                               ServeEngine)
from repro_torch.serve import engine as E  # noqa: E402

from repro_torch.serve.schedule import TickRecorder  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
EPS32 = float(np.finfo(np.float32).eps)
# the reference's churn mix (tests/test_serve.py ``_requests``):
# (prompt_len, max_new, temperature, top_k, top_p)
MIX = [(8, 5, 0.0, 0, 1.0), (5, 6, 0.8, 0, 1.0), (12, 4, 1.2, 5, 1.0),
       (24, 6, 0.7, 0, 0.9), (7, 3, 1.0, 50, 0.95), (16, 2, 0.0, 0, 1.0)]
ARRIVALS = [0, 0, 1, 3, 3, 6]


def _logit_tol(cfg, ref) -> float:
    """``tests/test_torch_model.py``'s derived bound on the logits of two
    f32 implementations that round in different orders (Higham's gamma_k
    over each layer's chain of dependent roundings, times 8, at the
    logits' scale)."""
    L_attn, L_ffn = 6, 7
    per_layer = (cfg.d_model + 3 * L_attn + 8 + cfg.head_dim + 32
                 + 3 * L_attn + 3 * (3 * L_ffn + 4) + cfg.d_model)
    depth = cfg.n_layers * per_layer + 2 * cfg.d_model
    return 8 * depth * EPS32 * (float(np.max(np.abs(ref))) + 1.0)


def _ref_params(jcfg, seed=0):
    """The reference's parameter tree (shape from ``jax.eval_shape``) with
    numpy draws as its init draws them: stage blocks random rotations plus
    0.05 noise, diagonals and norm scales 1 + 0.1 N, the table 0.5 N."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "mix":
            th = rng.uniform(-np.pi, np.pi, a.shape[:-1])
            c, s = np.cos(th), np.sin(th)
            return (np.stack([c, -s, s, c], -1) + 0.05 * rng.standard_normal(
                a.shape)).astype(np.float32)
        z = rng.standard_normal(a.shape)
        if name == "table":
            return (0.5 * z).astype(np.float32)
        return (1 + 0.1 * z).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(lambda: J_T.init_model(jax.random.PRNGKey(0),
                                                    jcfg)))


@pytest.fixture(scope="module")
def pair():
    jcfg = j_get_smoke("qwen3-1.7b")
    jparams = jax.tree.map(jnp.asarray, _ref_params(jcfg))
    tcfg = get_smoke("qwen3-1.7b")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _mix_requests(vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, vocab, plen), max_new_tokens=mnew,
                    temperature=t, top_k=k, top_p=p, rid=i)
            for i, (plen, mnew, t, k, p) in enumerate(MIX)]


def _ref_noise(base, rids, steps, V):
    """The reference's Gumbel draws: row b's noise is ``gumbel(fold_in(
    fold_in(base, rid), step), (V,))``, what ``categorical`` adds."""
    keys = [jax.random.fold_in(jax.random.fold_in(base, r), s)
            for r, s in zip(rids, steps)]
    return keys, np.stack([np.asarray(jax.random.gumbel(k, (V,),
                                                        jnp.float32))
                           for k in keys])


def test_sample_rows_match_reference_given_its_noise():
    """The port's sampling rule fed the reference's own noise gives the
    reference's tokens and flags bit for bit: greedy, temperature, top-k
    (ties at the k-th value kept), top-p, both filters, k >= V, p outside
    (0, 1), and non-finite rows (token 0, flagged), over three steps."""
    V = 256
    rng = np.random.default_rng(0)
    # (temperature, top_k, top_p)
    rows = [(0.0, 0, 1.0), (0.8, 0, 1.0), (1.2, 5, 1.0), (0.7, 0, 0.9),
            (1.0, 50, 0.95), (1.0, V, 1.0), (1.0, V + 7, 0.5),
            (0.9, 0, 1.5), (0.9, 0, 0.0), (1.1, 8, 1.0), (0.6, 0, 0.3),
            (0.9, 3, 0.8), (0.0, 5, 0.5)]
    B = len(rows) + 2
    temp = np.array([r[0] for r in rows] + [0.9, 0.0], np.float32)
    topk = np.array([r[1] for r in rows] + [0, 0], np.int32)
    topp = np.array([r[2] for r in rows] + [1.0, 1.0], np.float32)
    base = jax.random.PRNGKey(7)
    ref_fn = jax.jit(J_E._sample_rows)
    sampled = 0
    for step in range(3):
        logits = (2.0 * rng.standard_normal((B, V))).astype(np.float32)
        logits[9] = np.round(logits[9])           # ties at the k-th value
        logits[-2, 17] = np.nan
        logits[-1, 3] = np.inf
        rids = np.arange(B) + 100
        keys, noise = _ref_noise(base, rids, [step] * B, V)
        want, want_bad = ref_fn(jnp.asarray(logits), jnp.stack(keys),
                                jnp.asarray(temp), jnp.asarray(topk),
                                jnp.asarray(topp))
        got, bad = E._sample_rows(
            torch.from_numpy(logits), torch.from_numpy(noise),
            torch.from_numpy(temp), torch.from_numpy(topk).long(),
            torch.from_numpy(topp))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(bad.numpy(), np.asarray(want_bad))
        assert got[-2] == 0 and got[-1] == 0 and bad[-2] and bad[-1]
        sampled += int((got[:-2] != torch.from_numpy(logits[:-2]).argmax(
            -1)).sum())
    assert sampled > 0            # the noise moved some tokens off argmax


def test_gumbel_noise_is_a_pure_function_of_rid_step_and_index():
    """The port's own noise: a row's values depend on (seed, rid, step)
    alone, not on its slot or the rows beside it; they are finite, differ
    across rid, step and seed, and are standard Gumbel (mean near Euler's
    gamma, variance near pi^2 / 6)."""
    rid = torch.tensor([4, 9, 4, 2])
    step = torch.tensor([0, 3, 1, 3])
    g = E.gumbel_noise(5, rid, step, 512)
    alone = E.gumbel_noise(5, rid[1:2], step[1:2], 512)
    assert torch.equal(g[1], alone[0])
    assert torch.isfinite(g).all()
    assert not torch.equal(g[0], g[2]) and not torch.equal(g[1], g[3])
    assert not torch.equal(g, E.gumbel_noise(6, rid, step, 512))
    big = E.gumbel_noise(0, torch.arange(64), torch.zeros(64).long(), 1024)
    assert abs(big.mean().item() - 0.5772) < 0.02
    assert abs(big.var().item() - np.pi ** 2 / 6) < 0.06


def test_per_row_decode_and_length_prefill_match_reference(pair):
    """A right-padded batch of two prompts (5 and 12 tokens, bucket 16):
    ``prefill(length=...)`` takes each row's last real position, then two
    decode steps at per-row positions; the logits stay within the derived
    bound and the argmax tokens agree."""
    jcfg, jparams, tcfg, tparams = pair
    rng = np.random.default_rng(2)
    lens = np.array([5, 12], np.int32)
    toks = np.zeros((2, 16), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, tcfg.vocab_size, n)
    j_prefill = jax.jit(lambda p, t, n: J_LM.prefill(
        p, jcfg, max_len=24, tokens=t, cache_dtype=jnp.float32, length=n))
    j_decode = jax.jit(lambda p, t, c, i: J_LM.decode_step(p, jcfg, t, c, i))
    jl, jc = j_prefill(jparams, jnp.asarray(toks), jnp.asarray(lens))
    with torch.inference_mode():
        tl, tc = LM.prefill(tparams, tcfg, max_len=24,
                            tokens=torch.from_numpy(toks).long(),
                            cache_dtype=torch.float32,
                            length=torch.from_numpy(lens))
    ci = lens.copy()
    for step in range(3):
        ref = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), ref, rtol=0,
                                   atol=_logit_tol(tcfg, ref))
        tok = np.argmax(ref, -1).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
        jl, jc = j_decode(jparams, jnp.asarray(tok), jc, jnp.asarray(ci))
        with torch.inference_mode():
            tl, tc = LM.decode_step(tparams, tcfg,
                                    torch.from_numpy(tok).long(), tc,
                                    torch.from_numpy(ci).long())
        ci = ci + 1


def test_continuous_greedy_matches_reference_engine_and_generate(pair):
    """A greedy churn over two slots with mixed buckets (8 and 16) and
    staggered arrivals: the port's tokens equal the reference engine's,
    request by request, and each equals the port's ``generate`` of the
    prompt alone; the schedule (admitted and finished ticks, stats) is the
    reference's."""
    jcfg, jparams, tcfg, tparams = pair
    rng = np.random.default_rng(4)
    spec = [(5, 6), (12, 4), (8, 5), (3, 3)]
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n, _ in spec]
    arrivals = [0, 0, 1, 2]
    jeng = JEngine(jcfg, jparams, slots=2, max_len=32,
                   cache_dtype=jnp.float32)
    want, wstats = jeng.serve(
        [JRequest(prompt=jnp.asarray(p, jnp.int32), max_new_tokens=m, rid=i)
         for i, (p, (_, m)) in enumerate(zip(prompts, spec))],
        arrival_ticks=arrivals)
    eng = ContinuousBatchingEngine(tcfg, tparams, slots=2, max_len=32,
                                   cache_dtype=torch.float32, device="cpu")
    got, stats = eng.serve(
        [Request(prompt=p, max_new_tokens=m, rid=i)
         for i, (p, (_, m)) in enumerate(zip(prompts, spec))],
        arrival_ticks=arrivals)
    assert stats == wstats
    fixed = ServeEngine(cfg=tcfg, params=tparams, max_len=32,
                        cache_dtype=torch.float32, device="cpu")
    for i, (p, (_, m)) in enumerate(zip(prompts, spec)):
        assert got[i]["tokens"] == want[i]["tokens"], i
        for key in ("flagged", "admitted_tick", "finished_tick"):
            assert got[i][key] == want[i][key], (i, key)
        alone = fixed.generate(torch.from_numpy(p)[None], max_new_tokens=m)
        assert got[i]["tokens"] == alone[0].tolist(), i


def test_churn_parity_at_equal_slot_count(pair):
    """The reference's acceptance mix (every bucket, greedy and sampled,
    top-k and top-p on and off) under its staggered arrivals: each request
    gives bit for bit the tokens it gives served alone through an engine
    with the same two slots; admits respect arrivals and capacity."""
    _, _, tcfg, tparams = pair
    eng = ContinuousBatchingEngine(tcfg, tparams, slots=2, max_len=48,
                                   seed=7, device="cpu")
    eng.serve([Request(prompt=np.zeros(4, np.int64), max_new_tokens=2,
                       rid=999)])
    reqs = _mix_requests(tcfg.vocab_size)
    results, stats = eng.serve(reqs, arrival_ticks=ARRIVALS)
    alone = ContinuousBatchingEngine(tcfg, tparams, slots=2, max_len=48,
                                     seed=7, device="cpu")
    moved = 0
    for r in _mix_requests(tcfg.vocab_size):
        solo, _ = alone.serve([r])
        assert solo[r.rid]["tokens"] == results[r.rid]["tokens"], r.rid
        assert len(results[r.rid]["tokens"]) == r.max_new_tokens
        assert all(0 <= t < tcfg.vocab_size for t in solo[r.rid]["tokens"])
        moved += r.temperature > 0
    assert moved == 4
    for i, r in enumerate(reqs):
        res = results[r.rid]
        assert res["admitted_tick"] >= ARRIVALS[i]
        assert res["finished_tick"] >= res["admitted_tick"]
        assert not res["flagged"]
    assert stats["occupied_slot_ticks"] <= stats["ticks"] * eng.slots
    # a sampled request reproduces across serves (noise keyed on rid,
    # step and seed) and moves with the seed
    again, _ = eng.serve([_mix_requests(tcfg.vocab_size)[1]])
    assert again[1]["tokens"] == results[1]["tokens"]
    other = ContinuousBatchingEngine(tcfg, tparams, slots=2, max_len=48,
                                     seed=8, device="cpu")
    moved_seed, _ = other.serve([_mix_requests(tcfg.vocab_size)[1]])
    assert moved_seed[1]["tokens"] != results[1]["tokens"]


def test_tick_issues_one_operation_sequence_with_no_host_read(pair):
    """Across an arbitrary churn (arrivals, evictions, every sampling mode,
    one to two active slots) every tick after warm-up issues the same aten
    operations on the same shapes, dtypes and scalar arguments, and none
    reads a value back to the host: the tick is ready for capture."""
    _, _, tcfg, tparams = pair
    eng = ContinuousBatchingEngine(tcfg, tparams, slots=2, max_len=48,
                                   seed=7, device="cpu")
    eng.serve([Request(prompt=np.zeros(4, np.int64), max_new_tokens=2,
                       rid=999)])
    rec = TickRecorder()
    eng._tick = rec.wrap(eng._tick)
    _, stats = eng.serve(_mix_requests(tcfg.vocab_size),
                         arrival_ticks=ARRIVALS)
    assert len(rec.ticks) >= 10 and len(rec.ticks) <= stats["ticks"]
    first = rec.ticks[0]
    assert all(t == first for t in rec.ticks[1:])
    names = {str(op) for op, *_ in first}
    for banned in ("aten._local_scalar_dense", "aten.nonzero", "aten.item"):
        assert not any(n.startswith(banned) for n in names), banned
    assert any(n.startswith("aten.index_put") for n in names)


def test_single_token_requests_validation_and_ssm_stacks(pair):
    """``max_new_tokens = 1`` finishes at its admit tick with no decode
    tick owed; the two ``ValueError``s of ``serve``; a stack with a
    non-attention mixer is refused."""
    _, _, tcfg, tparams = pair
    eng = ContinuousBatchingEngine(tcfg, tparams, slots=2, max_len=16,
                                   device="cpu")
    results, stats = eng.serve([Request(prompt=np.arange(4),
                                        max_new_tokens=1, rid=0)])
    res = results[0]
    assert len(res["tokens"]) == 1
    assert res["finished_tick"] == res["admitted_tick"] == 0
    assert stats["occupied_slot_ticks"] == 0 and stats["tokens"] == 1
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.serve([Request(prompt=np.arange(4), max_new_tokens=0)])
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.serve([Request(prompt=np.arange(12), max_new_tokens=8)])
    ssm = dataclasses.replace(
        tcfg, layers=(T.LayerSpec(mixer="mamba"),) + tcfg.layers[1:])
    with pytest.raises(ValueError, match="attention-only"):
        ContinuousBatchingEngine(ssm, tparams, slots=1, max_len=16,
                                 device="cpu")


def test_flags_isolate_poisoned_request_in_the_pool():
    """The contract of the reference's ``tests/test_serve.py``
    ``test_flags_isolate_poisoned_request`` for the continuous engine: a
    NaN embedding row flags only the request whose prompt uses that
    token, its tokens are the fallback 0, and the clean request beside it
    in the pool stays unflagged; the next tenant of the poisoned slot is
    clean (its row is replaced whole).  (The reference itself fails that
    test on JAX 0.9.0, so the port is held to the contract, not to the
    reference's output.)"""
    cfg = dataclasses.replace(get_smoke("qwen3-1.7b"), tie_embeddings=False)
    params = T.init_model(cfg, seed=0, device="cpu")
    with torch.no_grad():
        params["embed"]["table"][3] = float("nan")
    eng = ContinuousBatchingEngine(cfg, params, slots=2, max_len=16,
                                   cache_dtype=torch.float32, device="cpu")
    # rid 0 decodes NaN K/V up to position 10, past its bucket of 8
    results, _ = eng.serve([
        Request(prompt=[1, 2, 3, 4], max_new_tokens=8, rid=0),
        Request(prompt=[1, 2, 4, 5], max_new_tokens=8, rid=1),
        Request(prompt=[6, 7, 8], max_new_tokens=3, rid=2)],
        arrival_ticks=[0, 0, 1])
    assert results[0]["flagged"] and not results[1]["flagged"]
    assert results[0]["tokens"] == [0] * 8
    assert all(0 <= t < cfg.vocab_size for t in results[1]["tokens"])
    # rid 2 takes the poisoned request's slot after it leaves
    assert results[2]["admitted_tick"] > results[0]["admitted_tick"]
    assert not results[2]["flagged"]


def test_continuous_entry_points(monkeypatch, capsys):
    """``launch.serve --continuous`` runs on the CPU when asked and prints
    the reference's summary; without a GPU the engine and the launcher
    raise unless the caller names the CPU."""
    from repro_torch.launch import serve as launch_serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--smoke", "--device", "cpu", "--continuous", "--batch",
        "3", "--slots", "2", "--prompt-len", "5", "--new-tokens", "3",
        "--arrival-every", "1"])
    launch_serve.main()
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens in" in out
    assert "tok/s, occupancy" in out and "latency" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("qwen3-1.7b")
    params = T.init_model(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(cfg, params, slots=2, max_len=8)
    monkeypatch.setattr(sys, "argv", ["serve", "--smoke", "--continuous"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main()


def test_torch_serve_bench_schedule_matches_bench_serve(tmp_path):
    """``benchmarks/torch_serve_bench.py --smoke --device cpu``: the
    schedule numbers of every load (ticks, tokens, occupancy, latency
    percentiles) equal the committed ``BENCH_serve.json``'s (they depend
    only on the seeded arrivals and the evict-on-count policy), and the
    tick issues one operation sequence after warm-up over the busiest load
    (recording every load's ticks takes some 10 s on the CPU)."""
    spec = importlib.util.spec_from_file_location(
        "torch_serve_bench", REPO / "benchmarks" / "torch_serve_bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    out = tmp_path / "torch_serve_bench.json"
    assert bench.main(["--smoke", "--device", "cpu", "--out", str(out),
                       "--record-loads", "2.0"]) == 0
    got = json.loads(out.read_text())
    want = json.loads((REPO / "BENCH_serve.json").read_text())
    assert got["tick_op_sequences"] == 1
    for key in ("arch", "slots", "requests", "max_new"):
        assert got[key] == want[key], key
    keys = ("offered_load", "ticks", "tokens", "occupancy_milli",
            "p50_latency_ticks", "p99_latency_ticks")
    assert ([{k: r[k] for k in keys} for r in got["loads"]]
            == [{k: r[k] for k in keys} for r in want["loads"]])
