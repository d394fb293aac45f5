#!/usr/bin/env python3
"""Drive the PyTorch port on one GPU and hold its kernels to their plain
versions.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. **Build** K1 (``csrc/spm_stack.cu``) and K2 (``csrc/spm_stack_bwd.cu``)
   with their int8 and windowed modes, K3 (``csrc/spm_block.cu``), K4
   (``csrc/spm_block_bwd.cu``), K5 (``csrc/spm_overlap.cu``) and K6
   (``csrc/spm_overlap_bwd.cu``) from the checkout with ``nvcc`` for
   ``sm_90a``, one process per source, all at once.
2. **Kernels**: each kernel against its plain version on the card, on the
   same inputs, at the serving path's shapes, in bf16 and f32, with random
   near-orthogonal stages (each keeps its input's norm, so all stages carry
   the signal) and random diagonals and bias.  K1 must agree bit for bit;
   K3 within two I/O ulps of each element plus a derived f32 term.  Also
   the kernel's and the plain version's time, the bound (the function's
   bytes over 3.35 TB/s or its f32 operations over 67 TFLOP/s, whichever
   is larger) and, for K1, a dense ``torch.matmul`` of the same map as a
   yardstick the port never calls.
3. **Serve**: full-width ``qwen3-1.7b`` with weights made from a seed,
   ``ServeEngine.generate`` for batch 8, prompt 512, 64 greedy tokens, bf16
   KV cache; each kernel's launch count must equal the count the port's own
   run plan implies.  Prefill ms, decode tokens/s and peak memory.
4. **Model parity**: the same weights through the port on the card
   (kernels) and on the CPU (plain versions), batch 4, prompt 16, 24
   teacher-forced steps; logits within a bf16-derived tolerance, tokens
   equal wherever the top-2 gap exceeds it.  Then two rows of the served
   batch are replayed on the CPU (prompt 512, the served tokens fed back):
   every served token whose CPU top-2 gap exceeds the tolerance must be
   the CPU's argmax.

5. **Backward kernels**: K2 and K4 against their plain versions on the
   card, in bf16 and f32: K2 over the run chains of the o, gate/up and down
   projections at 4096 rows, the tiny-row 6144-wide run and a rectangular
   run whose dead-tile skip fires; K4 in the q and k/v norm-prologue forms
   at 4096 rows and the two-stack forms at 256 rows.  K2's g_x bit for bit,
   K4's within 2 I/O ulps plus K3's f32 term; every parameter grad within
   gamma_k times the sum of its terms' magnitudes (k rows); a second launch
   bitwise equal to the first.  Times as in phase 2; K2's yardstick is the
   two ``torch.matmul`` of a dense linear's backward.
6. **Train**: full-width ``qwen3-1.7b`` from a seed through
   ``launch.train.train``: batch 8, seq 512, 6 steps, the third poisoned.
   Every loss finite, only the poisoned step skipped and the state bitwise
   unchanged by it, each kernel's launches equal to the plan (remat runs
   each forward twice).  Step ms (median of steps 2-6), tokens/s, peak
   memory.
7. **Train parity**: the same full-width weights with f32 activations, one
   step on the card and on the CPU: the loss, every parameter's grad (as a
   relative norm) and the updated params within a derived f32 bound.
8. **int8 kernels**: the int8 modes of K1 and K2 against their plain
   versions on the card (``q8_cases``): the o projection at 4096 rows in
   each mode, k/v with out_width 1024 inside the scale tile, an 8-row
   n=6144 decode run (a cluster of 8 blocks), 4072 rows with a bias (a
   padded scale block), and int8 coefficients alone on the two-run
   gate/up chain.  K1's codes and scales bit for bit, K2's g_x bit for bit
   and its grads as phase 5's, second launches bitwise; times, bounds and
   the dense yardsticks as phases 2 and 5.  Then scale blocks holding a
   NaN and an Inf, and an Inf alone: NaN and Inf scales, codes 0, exactly
   the plain version's.
9. **int8 train**: phase 6 with ``--quantize``: int8 activations on q, k,
   v, o (one-run plans), int8 tables everywhere; launches equal to the
   plan with the int8 modes counted apart, no K3/K4.
10. **int8 train parity**: phase 7 on the quantized model, the CPU
   replaying the card's int8 codes chain by chain
   (``kernels.codes.CodeTape``), so that one flipped code does not carry
   quantization noise through the later layers: within phase 7's f32
   bound; each chain's CPU output from the card's entry bit for bit the
   card's; the CPU's own entry codes within one of the card's and flipped
   no more often than ``flip_budget``.
11. **int8 serve**: ``ServeEngine.generate`` of the quantized model (batch
   8, prompt 512, 64 tokens): launches equal to the plan, prefill ms and
   decode tokens/s; then teacher-forced logits against the CPU at batch 4,
   prompt 16, 32 steps, the codes replayed as in phase 10, within phase
   4's bf16 bound, with at least ``MIN_DECIDED`` tokens decided.
12. **Windowed kernels**: K1's and K2's ``col_base`` modes at the gate/up
   shard shapes of ``with_feature_sharding(qwen3-1.7b, 4)`` (n_local 1536
   of the global in_width 2048, tiles of 768, shards 0-3: live,
   straddling, past the edge), 4096 and 8 rows, bf16 and f32: K1 bit for
   bit (a dead shard exactly its bias), K2 as phase 5 with g_din exactly
   zero past in_width; K2's gy window at the down shape.  Times, bounds
   and ``torch.matmul`` with the window's dense (2048, 1536) map.
13. **Sharded train and serve**: full-width ``with_feature_sharding(
   qwen3-1.7b, 4)`` on a 4-shard mesh on one card under
   ``activation_sharding(mesh, shard_feature=True)``: 6 steps of batch 8
   x seq 512 with the third poisoned, then one ``generate`` of 8 x 512 +
   16 tokens; K1/K2 launches (windowed counted apart) equal to the plan
   from ``plan_steps`` and ``plan_runs_for_rows``, K3 = K4 = 0.  Step ms,
   tokens/s and peak memory beside phase 6's.
14. **Sharded train parity**: phase 7 on the sharded model, each side
   under a 4-shard mesh on its own device.
15. **Pair kernels**: K5 and K6 against their plain versions
   (``pair_cases``: the q/k/v/o pair over 4 shards, the 2-shard pair that
   ends its schedule with d_out and bias folded, a windowed first run, an
   int8 table) at 4096 and 8 rows, bf16 and f32: K5 bit for bit, K6's g_x
   bit for bit and its grads within gamma_rows; times, bounds and the
   pair step's dense products as yardstick.  Then K1's and K2's windowed
   modes with an int8 table at phase 12's shard shapes, held as there.
16. **Overlap train and serve**: phase 13 with ``with_overlap_executor``:
   each q/k/v/o pair one K5 launch over every shard forward (twice with
   remat) and one K6 backward, gate/up/down step-serial; launches equal
   to the plan from ``plan_steps``, ``overlap_segments`` and
   ``plan_runs_for_rows``, K3 = K4 = 0.  Step ms, tokens/s, peak memory
   and a traced step's busy ms beside phase 13's.
17. **int8 overlap train**: phase 16's model with ``with_quantized_io``,
   3 steps: every K1/K2/K5/K6 launch reads an int8 table (counted apart,
   as planned), no int8 activations.
18. **Overlap train parity**: phase 14 with the overlap schedule: the
   card's pairs through K5/K6 against phase 14's CPU step (the same f32
   function, the grads summed in other groups), reused.

The line before the last lists the kernels as one JSON object; the last
line is ``{"ok": true, "device": {...}}``.  Without a GPU, or run away from
the repository, the script exits non-zero and prints no result.  The full
per-shape table goes to ``out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOP_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
EPS = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}
TIMED = 30                      # launches per timing
DEVICE = "cuda"


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


class Timer:
    """Mean device ms of ``fn()`` over ``TIMED`` calls, with the L2 cache
    flushed before each, timed by CUDA events around each call.  A spin
    kernel ahead of each call lets the host enqueue the call before the
    device reaches it, so the events see device time, not the host's
    launch overhead."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(TIMED):
            torch.cuda._sleep(2_000_000)       # about 1 ms of spinning
            self.flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / TIMED


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def untimed(fn):
    """In place of ``Timer`` for a case that is checked but not timed."""
    return None


def fmt_ms(t) -> str:
    return "untimed" if t is None else f"{t:.4f}"


MANT_BITS = {"float32": 23, "bfloat16": 7}


def ulp(t, dtype_name: str):
    """The spacing of ``dtype_name`` at each element of ``t`` (normal
    range), as f32: 2^(floor(log2 |t|) - mantissa bits)."""
    torch = sys.modules["torch"]
    mag = t.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - MANT_BITS[dtype_name])


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def k1_cases():
    """(label, n, strides, rows, in_w, out_w): the o projection (n=2048,
    L=11) and the FFN linears (n=6144, L=12) at prefill and decode rows."""
    qkv = tuple(1 << i for i in range(11))
    ffn = qkv + (3072,)
    return [("o", 2048, qkv, 4096, 2048, 2048),
            ("o", 2048, qkv, 8, 2048, 2048),
            ("up", 6144, ffn, 4096, 2048, 6144),
            ("down", 6144, ffn, 4096, 6144, 2048),
            ("up", 6144, ffn, 8, 2048, 6144),
            ("down", 6144, ffn, 8, 6144, 2048)]


def k3_cases():
    """(label, rows, out_w, activation, two_stacks): the fused q and k/v
    projections at prefill and decode rows, and the two-stack forms with
    residual and each activation (mid width 1536 < n, so the mask before
    the activation matters)."""
    return [("q", 4096, 2048, None, False), ("q", 8, 2048, None, False),
            ("kv", 4096, 1024, None, False), ("kv", 8, 1024, None, False),
            ("ffn-relu", 256, 2048, "relu", True),
            ("ffn-silu", 256, 2048, "silu", True),
            ("ffn-gelu", 256, 2048, "gelu", True)]


def k3_f32_term(n: int, n_stages: int, scale: float) -> float:
    """The f32 part of K3's limit.  Kernel and plain version round op for
    op alike except (i) the row's sum of squares, summed in another order
    (Higham and Mary's probabilistic bound: lambda sqrt(n) u, lambda = 8),
    (ii) rsqrt (2 ulps each side) and (iii) the activation's exp/tanh (a
    few ulps).  Every later op is shared and norm-preserving, so the
    difference carries to the output at the output's scale; 3 roundings a
    stage and 12 for the rest, times 8."""
    eps = EPS["float32"]
    return 8 * (math.sqrt(n) + 4 + 3 * n_stages + 12) * eps * scale


def run_kernel_phase(torch, K, ops, timer):
    """K1 is held bit for bit: its kernel rounds every product and sum on
    its own (``__fmul_rn``/``__fadd_rn``), as the plain version's eager
    ops do, and sums nothing else.  K3 is held within two ulps of the I/O
    type at each element plus ``k3_f32_term``."""
    rows_out = []
    failures = []
    g = torch.Generator(device=DEVICE).manual_seed(1234)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=DEVICE)

    def mix(L, n):
        # random rotations plus 0.05 noise, as init_spm draws them: each
        # stage keeps its input's norm, so all L stages carry the signal
        th = (torch.rand(L, n // 2, generator=g, device=DEVICE) * 2 - 1) \
            * math.pi
        c, s = torch.cos(th), torch.sin(th)
        return torch.stack([c, -s, s, c], dim=-1) + rnd(L, n // 2, 4,
                                                        scale=0.05)

    def vec(n):
        return 1 + 0.1 * rnd(n)

    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        for label, n, strides, rows, in_w, out_w in k1_cases():
            cf = mix(len(strides), n)
            d_in, d_out, b = vec(n), vec(n), 0.1 * rnd(n)
            x = rnd(rows, in_w).to(dt)
            runs = ops.plan_runs_for_rows(n, strides, rows)
            launches, off = [], 0
            for r, (rs, nt) in enumerate(runs):
                last = r == len(runs) - 1
                launches.append(dict(
                    coeffs=cf[off: off + len(rs)], strides=rs, n_tile=nt,
                    d_in=d_in if r == 0 else None,
                    d_out=d_out if last else None, bias=b if last else None,
                    in_width=in_w if r == 0 else None,
                    out_width=out_w if last else None))
                off += len(rs)

            def chain(fn, x=x, launches=launches):
                z = x
                for kw in launches:
                    kw = dict(kw)
                    if fn is K.spm_stack_plain:
                        kw.pop("n_tile")       # tiles change no result
                    z = fn(z, kw.pop("coeffs"), kw.pop("d_in"),
                           kw.pop("d_out"), kw.pop("bias"), **kw)
                return z

            kern = chain(K.spm_stack_kernel_call)
            plain = chain(K.spm_stack_plain)
            torch.cuda.synchronize()
            err = (kern.float() - plain.float()).abs().max().item()
            scale = plain.float().abs().max().item()
            ms = timer(lambda: chain(K.spm_stack_kernel_call))
            plain_ms = timer(lambda: chain(K.spm_stack_plain))
            # the function reads x and writes y once; the plan also reads
            # each run's coefficients and vectors for the tiles it computes
            # and, between two runs, writes and reads the intermediate
            esz = x.element_size()
            io = rows * (in_w + out_w) * esz
            table = flops = 0.0
            for kw in launches:
                nt = kw["n_tile"]
                ow = kw["out_width"] or n
                tiles = -(-ow // nt)
                L = len(kw["strides"])
                table += L * tiles * nt // 2 * 16
                table += 4 * tiles * nt * sum(
                    kw[v] is not None for v in ("d_in", "d_out", "bias"))
                flops += rows * tiles * nt * (3 * L + 2)
            between = 2 * rows * n * esz * (len(launches) - 1)
            bms, bby = bound(io + table, flops)
            plan_bms, _ = bound(io + table + between, flops)
            # yardstick: one dense product computing the same linear map
            eye = torch.eye(in_w, device=DEVICE)
            dense = chain(K.spm_stack_plain, x=eye,
                          launches=[dict(kw, bias=None) for kw in launches])
            dense = dense.to(dt)
            lib_ms = timer(lambda: torch.matmul(x, dense))
            ok = err == 0 and bool(torch.isfinite(kern.float()).all())
            rows_out.append(dict(
                kernel="K1", case=label, dtype=dname, rows=rows, n=n,
                in_width=in_w, out_width=out_w,
                runs=[[list(rs), nt] for rs, nt in runs],
                launches_per_call=len(runs), max_abs_err=err, tol=0.0,
                out_scale=scale, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=bby, plan_bound_ms=plan_bms, library_ms=lib_ms,
                ok=ok))
            log(f"K1 {label:5s} {dname:8s} rows={rows:5d} runs={len(runs)} "
                f"err={err:.3e} tol=0 max|y|={scale:.3f} ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({bby}) "
                f"plan_bound_ms={plan_bms:.4f} library_ms={lib_ms:.4f} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"K1 {label} {dname} rows={rows}")

        n = 2048
        strides = tuple(1 << i for i in range(11))
        for label, rows, out_w, act, two in k3_cases():
            kw = dict(coeffs1=mix(11, n), d_in1=vec(n),
                      d_out1=vec(n), bias1=0.1 * rnd(n), gamma=vec(n),
                      strides1=strides, in_width=n, out_width=out_w,
                      mid_width=out_w)
            if two:
                kw.update(coeffs2=mix(11, n),
                          d_in2=vec(n), d_out2=vec(n), bias2=0.1 * rnd(n),
                          strides2=strides, activation=act, residual=True,
                          mid_width=1536)
            x = rnd(rows, n).to(dt)
            kern, rstd_k = K.spm_block_kernel_call(x, **kw)
            plain, rstd_p = K.spm_block_plain(x, **kw)
            torch.cuda.synchronize()
            diff = (kern.float() - plain.float()).abs()
            err = diff.max().item()
            scale = plain.float().abs().max().item()
            L_tot = 11 * (2 if two else 1)
            t32 = k3_f32_term(n, L_tot, scale)
            limit = 2 * ulp(plain, dname) + t32
            worst = (diff / limit).max().item()
            rerr = ((rstd_k - rstd_p).abs() / rstd_p).max().item()
            rtol = 8 * (math.sqrt(n) + 4) * EPS["float32"]
            ms = timer(lambda: K.spm_block_kernel_call(x, **kw))
            plain_ms = timer(lambda: K.spm_block_plain(x, **kw))
            # the function reads x once (the kernel's second read for the
            # residual is its own cost), writes y and rstd once, and reads
            # both coefficient slabs and every vector
            nbytes = (rows * (n + out_w) * x.element_size() + rows * 4
                      + L_tot * n // 2 * 16 + 4 * n * (7 if two else 4))
            flops = rows * n * (3 * L_tot + (12 if two else 6))
            bms, bby = bound(nbytes, flops)
            ok = (worst <= 1 and rerr <= rtol
                  and bool(torch.isfinite(kern.float()).all()))
            rows_out.append(dict(
                kernel="K3", case=label, dtype=dname, rows=rows, n=n,
                in_width=n, out_width=out_w, activation=act,
                two_stacks=two, launches_per_call=1, max_abs_err=err,
                err_over_limit=worst, tol_f32_term=t32, tol_ulps=2,
                out_scale=scale, rstd_rel_err=rerr, rstd_rtol=rtol, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                library_ms=None, ok=ok))
            log(f"K3 {label:8s} {dname:8s} rows={rows:5d} err={err:.3e} "
                f"err/limit={worst:.3f} (2 ulps + {t32:.2e}) max|y|="
                f"{scale:.3f} rstd_rel={rerr:.2e} (tol {rtol:.2e}) "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} "
                f"({bby}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"K3 {label} {dname} rows={rows}")
    return rows_out, failures


# ---------------------------------------------------------------------------
# phase 3: serving full-width qwen3-1.7b through the kernels
# ---------------------------------------------------------------------------

def planned_launches(cfg, ops, rows: int):
    """(K1, K3) launches of one forward over ``rows`` flattened rows, from
    the port's own run plan: per layer three fused q/k/v (K3), the o
    projection's runs and the runs of gate, up and down (K1)."""
    spec = cfg.layers[0]
    acfg, fcfg = cfg.attn_cfg(spec), cfg.ffn_cfg()
    k1 = 0
    for lin in (acfg.o_proj, fcfg.gate, fcfg.up, fcfg.down):
        scfg = lin.spm_config()
        k1 += len(ops.plan_runs_for_rows(scfg.n, scfg.pairing.strides(),
                                         rows))
    return cfg.n_layers * k1, cfg.n_layers * 3


def run_serve_phase(torch, K, ops, T, ServeEngine, cfg, batch=8,
                    prompt_len=512, new=64):
    t0 = time.perf_counter()
    params = T.init_model(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServeEngine(cfg=cfg, params=params, max_len=prompt_len + new,
                      cache_dtype=torch.bfloat16, device=DEVICE)
    gen = torch.Generator().manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen)
    eng.generate(prompts[:, :16], max_new_tokens=2)   # warm-up: cuBLAS etc.
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    tokens, flags = eng.generate(prompts, max_new_tokens=new,
                                 return_flags=True)
    torch.cuda.synchronize()
    got = (K.spm_stack_kernel_call.launches, K.spm_block_kernel_call.launches)
    peak = torch.cuda.max_memory_allocated()
    pre = planned_launches(cfg, ops, batch * prompt_len)
    dec = planned_launches(cfg, ops, batch)
    want = (pre[0] + (new - 1) * dec[0], pre[1] + (new - 1) * dec[1])

    def wall(n_tokens):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.generate(prompts, max_new_tokens=n_tokens)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    t1 = min(wall(1) for _ in range(2))
    tn = min(wall(new) for _ in range(2))
    res = dict(batch=batch, prompt_len=prompt_len, new_tokens=new,
               init_s=init_s, prefill_ms=t1 * 1e3,
               decode_tok_per_s=batch * (new - 1) / (tn - t1),
               generate_s=tn, peak_mem_bytes=peak,
               launches={"K1": got[0], "K3": got[1]},
               planned={"K1": want[0], "K3": want[1]},
               planned_per_forward={"prefill": pre, "decode": dec})
    ok_shape = tuple(tokens.shape) == (batch, new)
    in_range = bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    ok = got == want and ok_shape and in_range and not bool(flags.any())
    log(f"serve: init {init_s:.1f} s, prefill {t1 * 1e3:.1f} ms, decode "
        f"{res['decode_tok_per_s']:.1f} tok/s, generate {tn:.2f} s, peak "
        f"{peak / 2**30:.2f} GiB, launches K1={got[0]} (planned {want[0]}) "
        f"K3={got[1]} (planned {want[1]}), tokens {tuple(tokens.shape)} "
        f"in range={in_range} flagged={int(flags.sum())} "
        f"{'ok' if ok else 'FAIL'}")
    return params, res, ok, (prompts, tokens)


# ---------------------------------------------------------------------------
# phase 4: the same weights on the card and on the CPU
# ---------------------------------------------------------------------------

REPLAY_ROWS = 2         # served rows replayed on the CPU
REPLAY_STEPS = 16       # served tokens checked per replayed row
MIN_DECIDED = 16        # tokens the parity phase must decide, at least


def run_parity_phase(torch, LM, cfg, params, served_prompts, served_tokens):
    """Two checks of the card against the CPU on the same weights.

    1. Teacher-forced: both sides decode the card's greedy tokens (batch 4,
       prompt 16, 24 steps), so each step compares logits of the same
       inputs; they must agree within the tolerance below, and tokens must
       be equal wherever the card's top-2 gap exceeds it.
    2. Replay of the served batch: ``REPLAY_ROWS`` rows of the serve
       phase's prompts go through the CPU, which is then fed the card's
       served tokens; each served token whose CPU top-2 gap exceeds the
       tolerance must be the CPU's argmax.

    Tolerance, from bf16: the logits are ``h . w_v`` with h the final
    normalized state, stored in bf16, and ``|h|_2 <= sqrt(d) max|scale|``.
    If every element of h lands one bf16 rounding (relative 2^-8) away
    from the exact value on each side, a logit moves by at most
    ``2 * 2^-8 * |h|_2 * max_v |w_v|_2`` (Cauchy-Schwarz).  Together the
    two checks must decide at least ``MIN_DECIDED`` tokens."""
    cpu_params = copy.deepcopy(params).to("cpu")
    gen = torch.Generator().manual_seed(11)
    batch, plen, steps = 4, 16, 24
    prompts = torch.randint(0, cfg.vocab_size, (batch, plen), generator=gen)
    emb = cpu_params["embed"]
    w = emb["table"] if cfg.tie_embeddings else emb["out"].T
    h_norm = (cfg.d_model ** 0.5
              * cpu_params["final_norm"]["scale"].abs().max().item())
    t = 2 * 2.0 ** -8 * h_norm * w.float().norm(dim=-1).max().item()

    def gap(lg):
        top2 = lg.topk(2, dim=-1).values
        return top2[:, 0] - top2[:, 1]

    worst, mism, checked = 0.0, 0, 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        max_len = plen + steps
        lg, cg = LM.prefill(params, cfg, max_len=max_len,
                            tokens=prompts.to(DEVICE))
        lc, cc = LM.prefill(cpu_params, cfg, max_len=max_len, tokens=prompts)
        for step in range(steps):
            a, b = lg.float().cpu(), lc.float()
            err = (a - b).abs().max().item()
            worst = max(worst, err)
            if err > t or not bool(torch.isfinite(a).all()):
                log(f"parity: step {step} logits err {err:.3e} > tol "
                    f"{t:.3e} FAIL")
                return dict(max_abs_err=err, tol=t, step=step), False
            decided = gap(a) > t
            checked += int(decided.sum())
            mism += int((a.argmax(-1) != b.argmax(-1))[decided].sum())
            tok = a.argmax(-1)
            if step + 1 < steps:
                lg, cg = LM.decode_step(params, cfg, tok.to(DEVICE), cg,
                                        plen + step)
                lc, cc = LM.decode_step(cpu_params, cfg, tok, cc, plen + step)
        tf_s = time.perf_counter() - t0

        # replay of the served batch on the CPU
        t0 = time.perf_counter()
        sp = served_prompts[:REPLAY_ROWS].cpu()
        st = served_tokens[:REPLAY_ROWS].cpu()
        r_checked = r_mism = 0
        lc, cc = LM.prefill(cpu_params, cfg,
                            max_len=sp.shape[1] + REPLAY_STEPS, tokens=sp)
        for step in range(REPLAY_STEPS):
            b = lc.float()
            decided = gap(b) > t
            r_checked += int(decided.sum())
            r_mism += int((b.argmax(-1) != st[:, step])[decided].sum())
            if step + 1 < REPLAY_STEPS:
                lc, cc = LM.decode_step(cpu_params, cfg, st[:, step], cc,
                                        sp.shape[1] + step)
        replay_s = time.perf_counter() - t0
    res = dict(max_abs_err=worst, tol=t, batch=batch, prompt_len=plen,
               steps=steps, compared=batch * steps, decided_tokens=checked,
               token_mismatches=mism, replay_rows=REPLAY_ROWS,
               replay_prompt_len=int(sp.shape[1]), replay_steps=REPLAY_STEPS,
               replay_decided=r_checked, replay_mismatches=r_mism,
               teacher_forced_s=tf_s, replay_s=replay_s)
    ok = (mism == 0 and r_mism == 0
          and checked + r_checked >= MIN_DECIDED)
    log(f"parity: logits max err {worst:.3e} (tol {t:.3e}) over "
        f"{batch}x{steps} teacher-forced steps, {checked} tokens decided "
        f"by a top-2 gap > tol, {mism} differ; served replay "
        f"{REPLAY_ROWS}x{REPLAY_STEPS}: {r_checked} decided, {r_mism} "
        f"differ (at least {MIN_DECIDED} decided in all; "
        f"{tf_s:.1f} s + {replay_s:.1f} s) {'ok' if ok else 'FAIL'}")
    return res, ok


# ---------------------------------------------------------------------------
# phase 5: the backward kernels K2 and K4 against their plain versions
# ---------------------------------------------------------------------------

U32 = 2.0 ** -24                # f32 unit roundoff


def gamma_k(k: int) -> float:
    """Higham's gamma_k = k u / (1 - k u): the bound on the relative error
    of a sum of k terms in any order, against the sum of the terms'
    magnitudes."""
    return k * U32 / (1 - k * U32)


def k2_cases():
    """(label, n, strides, rows, in_w, out_w): the backward of the o
    projection and of gate/up and down at 4096 rows (two runs for the
    n=6144 linears), the tiny-row 8-row 6144-wide run (its remat tiles do
    not fit shared memory), and a rectangular two-tile run whose dead-tile
    skip fires (n=4096, out_width 1024 at tile 2048)."""
    qkv = tuple(1 << i for i in range(11))
    ffn = qkv + (3072,)
    return [("o", 2048, qkv, 4096, 2048, 2048),
            ("gate/up", 6144, ffn, 4096, 2048, 6144),
            ("down", 6144, ffn, 4096, 6144, 2048),
            ("up-tiny", 6144, ffn, 8, 2048, 6144),
            ("rect-dead", 4096, qkv, 1024, 4096, 1024)]


def k4_cases():
    """(label, rows, out_w, activation, two_stacks, residual): the q and
    k/v norm-prologue forms at 4096 rows, the two-stack forms at 256 rows
    with each activation, with and without the residual."""
    out = [("q", 4096, 2048, None, False, False),
           ("kv", 4096, 1024, None, False, False)]
    for act in ("relu", "silu", "gelu"):
        for res in (True, False):
            out.append((f"ffn-{act}{'-res' if res else ''}", 256,
                        2048 if res else 1536, act, True, res))
    return out


def grads_within(got, want, mags, k, rel=0.0):
    """Largest ratio of |got - want| to (gamma_k + rel) * mags over the
    elements of each pair (0/0 counts 0: both exactly zero)."""
    torch = sys.modules["torch"]
    worst = 0.0
    for g, w, m in zip(got, want, mags):
        lim = (gamma_k(k) + rel) * m.float()
        d = (g.float() - w.float()).abs()
        over = torch.where(lim > 0, d / torch.where(lim > 0, lim, 1.0),
                           torch.where(d > 0, float("inf"), 0.0))
        worst = max(worst, over.max().item())
    return worst


def run_bwd_kernel_phase(torch, K, ops, timer):
    """K2's g_x is held bit for bit (every per-row value rounds as the
    plain version rounds); each parameter grad within gamma_k times the sum
    of its terms' magnitudes (k the row count: the two sum the same terms
    in other orders), which also demands exact zeros wherever every term
    is zero (padded lanes, skipped tiles).  K4's g_x within 2 I/O ulps plus
    the f32 term of K3 (the norm's row mean is summed in another order,
    the activation's exp/tanh may differ by a few ulps); its parameter
    grads as K2's, plus, where an activation sits between the stacks, the
    same f32 term relative to the sum of magnitudes.  A second launch must
    give bitwise equal outputs."""
    rows_out, failures = [], []
    g = torch.Generator(device=DEVICE).manual_seed(4321)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=DEVICE)

    def mix(L, n):
        th = (torch.rand(L, n // 2, generator=g, device=DEVICE) * 2 - 1) \
            * math.pi
        c, s = torch.cos(th), torch.sin(th)
        return torch.stack([c, -s, s, c], dim=-1) + rnd(L, n // 2, 4,
                                                        scale=0.05)

    def vec(n):
        return 1 + 0.1 * rnd(n)

    abs_sum = (lambda t: t.abs().sum(0))
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        esz = torch.tensor([], dtype=dt).element_size()
        for label, n, strides, rows, in_w, out_w in k2_cases():
            L = len(strides)
            cf = mix(L, n)
            d_in, d_out, b = vec(n), vec(n), 0.1 * rnd(n)
            x = rnd(rows, in_w).to(dt)
            gy = rnd(rows, out_w).to(dt)
            runs = ops.plan_runs_for_rows(n, strides, rows)
            widths = (None if in_w == n else in_w,
                      None if out_w == n else out_w)
            _, saved = ops.forward_runs(x, cf, runs, d_in, d_out, b,
                                        *widths)
            args = (saved, cf, gy, runs, d_in, d_out, True, *widths)
            kern = ops.backward_runs(K.spm_stack_bwd_kernel_call, *args)
            again = ops.backward_runs(K.spm_stack_bwd_kernel_call, *args)
            plain = ops.backward_runs(K.spm_stack_bwd_plain, *args)
            mags = ops.backward_runs(functools.partial(
                K.spm_stack_bwd_plain, col_sum=abs_sum), *args)
            torch.cuda.synchronize()
            gx_err = max((a[0].float() - p[0].float()).abs().max().item()
                         for a, p in zip(kern, plain))
            worst = max(grads_within(a[1:], p[1:], m[1:], rows)
                        for a, p, m in zip(kern, plain, mags))
            det = all(torch.equal(u, v) for a, c in zip(kern, again)
                      for u, v in zip(a, c))
            err = max(gx_err, max((u - v).abs().max().item()
                                  for a, p in zip(kern, plain)
                                  for u, v in zip(a[1:], p[1:])))
            ms = timer(lambda: ops.backward_runs(
                K.spm_stack_bwd_kernel_call, *args))
            plain_ms = timer(lambda: ops.backward_runs(
                K.spm_stack_bwd_plain, *args))
            # the function reads x and gy and writes g_x once, reads the
            # coefficient slabs and vectors and writes their grads; it
            # remats 3 flops per element and stage, walks back 7 (eq. 14's
            # four products and sums, B^T delta's six ops per pair)
            nbytes = rows * (2 * in_w + out_w) * esz
            flops = 0.0
            for rs, nt in runs:
                nbytes += 2 * len(rs) * n // 2 * 16
                flops += rows * n * (10 * len(rs) + 6)
            nbytes += 2 * 3 * 4 * n
            bms, bby = bound(nbytes, flops)
            # yardstick: a dense linear's backward, g_x = gy W^T and
            # g_W = x^T gy, which the port never calls
            w = rnd(in_w, out_w).to(dt)
            lib_ms = timer(lambda: (torch.matmul(gy, w.T),
                                    torch.matmul(x.T, gy)))
            ok = gx_err == 0 and worst <= 1 and det and all(
                bool(torch.isfinite(t.float()).all()) for a in kern
                for t in a)
            rows_out.append(dict(
                kernel="K2", case=label, dtype=dname, rows=rows, n=n,
                in_width=in_w, out_width=out_w,
                runs=[[list(rs), nt] for rs, nt in runs],
                launches_per_call=len(runs), gx_max_abs_err=gx_err,
                max_abs_err=err, grad_err_over_limit=worst,
                deterministic=det, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=bby, library_ms=lib_ms, ok=ok))
            log(f"K2 {label:9s} {dname:8s} rows={rows:5d} runs={len(runs)} "
                f"gx_err={gx_err:.3e} (tol 0) grad err/limit={worst:.3f} "
                f"det={det} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={bms:.4f} ({bby}) library_ms={lib_ms:.4f} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"K2 {label} {dname} rows={rows}")

        n = 2048
        strides = tuple(1 << i for i in range(11))
        for label, rows, out_w, act, two, res in k4_cases():
            kw = dict(coeffs1=mix(11, n), d_in1=vec(n), d_out1=vec(n),
                      bias1=0.1 * rnd(n), gamma=vec(n), strides1=strides,
                      in_width=n, out_width=out_w, mid_width=out_w)
            if two:
                kw.update(coeffs2=mix(11, n), d_in2=vec(n), d_out2=vec(n),
                          bias2=0.1 * rnd(n), strides2=strides,
                          activation=act, residual=res, mid_width=1536)
            x = rnd(rows, n).to(dt)
            gy = rnd(rows, out_w).to(dt)
            _, rstd = K.spm_block_kernel_call(x, **kw)
            kern = K.spm_block_bwd_kernel_call(x, gy, rstd=rstd, **kw)
            again = K.spm_block_bwd_kernel_call(x, gy, rstd=rstd, **kw)
            plain = K.spm_block_bwd_plain(x, gy, rstd=rstd, **kw)
            mags = K.spm_block_bwd_plain(x, gy, rstd=rstd, col_sum=abs_sum,
                                         **kw)
            torch.cuda.synchronize()
            L_tot = 11 * (2 if two else 1)
            diff = (kern[0].float() - plain[0].float()).abs()
            t32 = k3_f32_term(n, L_tot, plain[0].float().abs().max().item())
            gx_worst = (diff / (2 * ulp(plain[0], dname) + t32)).max().item()
            rel = (8 * (4 + 3 * L_tot + 12) * EPS["float32"]
                   if act is not None else 0.0)
            worst = grads_within(kern[1:], plain[1:], mags[1:], rows, rel)
            det = all(torch.equal(u, v) for u, v in zip(kern, again))
            err = max((u.float() - v.float()).abs().max().item()
                      for u, v in zip(kern, plain))
            ms = timer(lambda: K.spm_block_bwd_kernel_call(x, gy, rstd=rstd,
                                                           **kw))
            plain_ms = timer(lambda: K.spm_block_bwd_plain(x, gy, rstd=rstd,
                                                           **kw))
            n_vec = 4 + (4 if two else 0)
            nbytes = (rows * (2 * n + out_w) * x.element_size() + rows * 4
                      + 2 * L_tot * n // 2 * 16 + 2 * 4 * n * n_vec)
            flops = rows * n * (10 * L_tot + (30 if two else 12))
            bms, bby = bound(nbytes, flops)
            ok = (gx_worst <= 1 and worst <= 1 and det
                  and all(bool(torch.isfinite(t.float()).all())
                          for t in kern))
            rows_out.append(dict(
                kernel="K4", case=label, dtype=dname, rows=rows, n=n,
                out_width=out_w, activation=act, two_stacks=two,
                residual=res, launches_per_call=1, max_abs_err=err,
                gx_err_over_limit=gx_worst, tol_f32_term=t32, tol_ulps=2,
                grad_err_over_limit=worst, grad_rel_term=rel,
                deterministic=det, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=bby, library_ms=None, ok=ok))
            log(f"K4 {label:13s} {dname:8s} rows={rows:5d} err={err:.3e} "
                f"gx err/limit={gx_worst:.3f} grad err/limit={worst:.3f} "
                f"det={det} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={bms:.4f} ({bby}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"K4 {label} {dname} rows={rows}")
    return rows_out, failures


# ---------------------------------------------------------------------------
# phase 6: training full-width qwen3-1.7b through the kernels
# ---------------------------------------------------------------------------

def planned_train_launches(cfg, ops, rows: int) -> dict:
    """Launches of one training step over ``rows`` rows.  With remat
    every layer's forward runs twice (under the checkpoint and again in
    the backward's recompute; the non-reentrant recompute stops early only
    after the last op that saves tensors, the FFN's residual add, which
    launches nothing); the backward launches K2 once per forward K1 run
    and K4 once per K3 launch."""
    k1, k3 = planned_launches(cfg, ops, rows)
    f = 2 if cfg.remat else 1
    return {"K1": f * k1, "K3": f * k3, "K2": k1, "K4": k3}


def run_train_phase(torch, K, ops, launch_train, cfg, batch=8, seq=512,
                    steps=6, poisoned=2, quantize=False):
    """``launch.train.train`` for ``steps`` steps, the ``poisoned``-th
    poisoned; with ``quantize`` its ``--quantize`` flag, whose launches are
    held to ``planned_q8_train_launches`` (int8 modes counted apart, no
    K3/K4)."""
    args = launch_train.build_parser().parse_args(
        ["--arch", cfg.name, "--steps", str(steps), "--batch", str(batch),
         "--seq", str(seq), "--log-every", "1"]
        + (["--quantize"] if quantize else []))
    losses, skipped, secs = [], [], []
    snap, unchanged = {}, None

    def on_step(s, state, metrics, dt):
        nonlocal unchanged
        losses.append(metrics["loss"])
        skipped.append(metrics["skipped"])
        secs.append(dt)
        opt = state["opt"]
        if s == poisoned - 1:
            snap.update({("p", k): v.detach().clone() for k, v in
                         state["params"].named_parameters()})
            snap.update({(m, k): v.clone() for m in ("mu", "nu")
                         for k, v in opt[m].items()})
            snap["count"] = opt["count"].clone()
        if s == poisoned:
            now = dict(state["params"].named_parameters())
            same = torch.equal(opt["count"], snap.pop("count"))
            for (where, k), v in snap.items():
                cur = now[k] if where == "p" else opt[where][k]
                same = same and torch.equal(cur, v)
            unchanged = same
            snap.clear()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    launch_train.train(args, poison=lambda s: float(s == poisoned),
                       on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if quantize:
        got = q8_counts(K)
        per_step = planned_q8_train_launches(cfg, ops, batch * seq)
    else:
        got = {k: v for k, v in q8_counts(K).items() if " " not in k}
        per_step = planned_train_launches(cfg, ops, batch * seq)
    want = {k: steps * v for k, v in per_step.items()}
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(secs[1:])
    med = steady[len(steady) // 2] if len(steady) % 2 else \
        0.5 * (steady[len(steady) // 2 - 1] + steady[len(steady) // 2])
    res = dict(batch=batch, seq=seq, steps=steps, poisoned_step=poisoned,
               losses=losses, skipped=skipped, step_s=secs,
               step_ms_median=med * 1e3, tokens_per_s=batch * seq / med,
               wall_s=wall, peak_mem_bytes=peak, launches=got,
               planned=want, planned_per_step=per_step,
               poisoned_state_unchanged=unchanged)
    finite = all(math.isfinite(v) for v in losses)
    only = skipped == [float(s == poisoned) for s in range(steps)]
    ok = finite and only and bool(unchanged) and got == want
    log(f"{'int8 ' if quantize else ''}train: {steps} steps of batch "
        f"{batch} x seq {seq}, losses "
        f"{[round(v, 4) for v in losses]}, skipped {skipped}, poisoned "
        f"step unchanged={unchanged}, step {med * 1e3:.1f} ms (median of "
        f"steps 2-{steps}), {batch * seq / med:.0f} tokens/s, peak "
        f"{peak / 2**30:.2f} GiB, launches {got} (planned {want}) "
        f"{'ok' if ok else 'FAIL'}")
    return res, ok


# ---------------------------------------------------------------------------
# phase 7: one training step on the card against the CPU
# ---------------------------------------------------------------------------

def run_train_parity_phase(torch, T, LM, train_mod, adamw, cfg, batch=2,
                           seq=16, shards=0, overlap=False, cpu_side=None):
    """The same full-width weights, f32 activations, one step on the card
    (kernels) and on the CPU (plain versions): the loss, each parameter's
    grad as a relative norm, and the updated params.  With ``shards``
    (phase 14) the model is ``with_feature_sharding(cfg, shards)`` and each
    side runs under a mesh of that many shards on its own device; the
    card's side must launch the windowed modes and no K3/K4.  With
    ``overlap`` (phase 18) the model also takes ``with_overlap_executor``:
    the card runs each q/k/v/o pair through K5/K6 (which it must launch).
    ``cpu_side``: the CPU's results of an earlier call on the same weights
    and batch, reused in place of a new CPU run (phase 18 reuses phase
    14's step-serial step: the overlap schedule computes the same f32
    function, its grads summed in other groups, which the bound covers).
    Returns ``(result, ok, the CPU's side)``.

    Tolerance: both sides compute the same f32 function with the same
    ops, rounding in other orders (the kernels' row sums, cuBLAS against
    the CPU's matrix products, the attention and softmax sums).  ``depth``
    counts the dependent roundings as the CPU tests do (per layer the
    norm's d_model, 3 per stage of each stack, the head's scores over
    head_dim and keys, the FFN's three stacks and the residual path),
    forward and backward; each result is held to Higham and Mary's
    probabilistic bound lambda sqrt(depth) eps relative (lambda = 8), as
    K3's row sum is.  AdamW's update is invariant to the grads' scale, so
    the params move by the grads' relative error times the update."""
    from repro_torch.configs import (with_feature_sharding,
                                     with_overlap_executor)
    from repro_torch.kernels import spm_stack as K
    from repro_torch.parallel import activation_sharding, make_feature_mesh
    cfg = dataclasses.replace(cfg, dtype="float32")
    if shards:
        cfg = with_feature_sharding(cfg, shards)
    if overlap:
        cfg = with_overlap_executor(cfg, True)
    params = T.init_model(cfg, seed=0, device="cpu")
    card = copy.deepcopy(params).to(DEVICE)
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    L_attn, L_ffn = 11, 12
    per_layer = (cfg.d_model + 3 * L_attn + 8 + cfg.head_dim + seq
                 + 3 * L_attn + 3 * (3 * L_ffn + 4) + cfg.d_model)
    depth = 2 * (cfg.n_layers * per_layer + 2 * cfg.d_model)
    rel = 8 * math.sqrt(depth) * EPS["float32"]
    t0 = time.perf_counter()
    out = {} if cpu_side is None else {"cpu": cpu_side}
    for side, p in (("cpu", params), ("card", card)):
        if side in out:
            continue
        dev = "cpu" if side == "cpu" else DEVICE
        ctx = (activation_sharding(make_feature_mesh(shards, device=dev),
                                   shard_feature=True)
               if shards else contextlib.nullcontext())
        K.reset_launch_counts()
        with ctx:
            state = train_mod.make_train_state(p)
            bd = {k: v.to(dev) for k, v in b.items()}
            loss, _ = LM.lm_loss(p, bd, cfg)
            loss.backward()
            grads = {k: q.grad.detach().float().cpu() for k, q in
                     p.named_parameters()}
            p0 = {k: q.detach().cpu().clone()
                  for k, q in p.named_parameters()}
            step = train_mod.make_train_step(
                lambda pp, bb: LM.lm_loss(pp, bb, cfg),
                adamw.OptimizerConfig())
            state, m = step(state, bd)
        counts = (K.spm_stack_kernel_call.window_launches,
                  K.spm_stack_bwd_kernel_call.window_launches,
                  K.spm_block_kernel_call.launches,
                  K.spm_block_bwd_kernel_call.launches,
                  K.spm_overlap_kernel_call.launches,
                  K.spm_overlap_bwd_kernel_call.launches)
        p1 = {k: q.detach().cpu() for k, q in p.named_parameters()}
        moved = math.sqrt(sum(float(((p1[k] - p0[k]) ** 2).sum())
                              for k in p1))
        out[side] = dict(loss=loss.item(), grads=grads, counts=counts,
                         p1=p1, moved=moved, skipped=float(m["skipped"]))
        del p0
    secs = time.perf_counter() - t0
    a, c = out["card"], out["cpu"]
    loss_err = abs(a["loss"] - c["loss"])
    loss_ok = loss_err <= rel * abs(c["loss"])
    worst_name, worst = None, 0.0
    for k, gc in c["grads"].items():
        num = (a["grads"][k] - gc).norm().item()
        den = gc.norm().item()
        r = num / den if den > 0 else (0.0 if num == 0 else math.inf)
        if r >= worst:
            worst_name, worst = k, r
    diff = math.sqrt(sum(float(((a["p1"][k] - c["p1"][k]) ** 2).sum())
                         for k in c["p1"]))
    moved = c["moved"]
    ok = (loss_ok and worst <= rel and diff <= rel * moved
          and a["skipped"] == 0.0 == c["skipped"])
    if shards:      # the card's side ran the windowed kernels, no K3/K4
        ok = ok and min(a["counts"][:2]) > 0 and a["counts"][2:4] == (0, 0)
    # the overlap schedule ran its pairs through K5/K6 on the card only
    ok = ok and (min(a["counts"][4:]) > 0) == overlap \
        and c["counts"][4:] == (0, 0)
    res = dict(batch=batch, seq=seq, shards=shards, overlap=overlap,
               cpu_reused=cpu_side is not None,
               loss_card=a["loss"],
               loss_cpu=c["loss"], loss_abs_err=loss_err,
               worst_grad_rel_err=worst, worst_grad=worst_name,
               params_diff_norm=diff, update_norm=moved, rel_tol=rel,
               card_window_block_pair_launches=a["counts"], seconds=secs)
    log(f"{'overlap ' if overlap else ''}{'sharded ' if shards else ''}"
        f"train parity: loss card "
        f"{a['loss']:.6f} cpu {c['loss']:.6f} "
        f"(err {loss_err:.2e}), worst grad rel err {worst:.2e} "
        f"({worst_name}), params diff {diff:.3e} vs update {moved:.3e}; "
        f"tol {rel:.2e} relative ({secs:.1f} s"
        f"{', the CPU side reused' if cpu_side is not None else ''}) "
        f"{'ok' if ok else 'FAIL'}")
    return res, ok, c


# ---------------------------------------------------------------------------
# phase 8: the int8 modes of K1 and K2 against their plain versions
# ---------------------------------------------------------------------------

def q8_cases():
    """(label, n, strides, rows, in_w, out_w, modes): the o projection at
    4096 rows in every int8 mode; k/v at 4096 rows, where out_width 1024
    drops half of the scale tile; a decode run of 8 rows at n=6144 (one
    row a block, a cluster of 8); 4072 rows with a bias, which leaves a
    partially padded scale block; and int8 coefficients alone on the
    two-run gate/up chain at 4096 rows (its tiles differ, so its
    activations stay bf16).  "acts" is int8 activation I/O, "coeffs" an
    int8 table, "both" the two together."""
    qkv = tuple(1 << i for i in range(11))
    ffn = qkv + (3072,)
    return [("o", 2048, qkv, 4096, 2048, 2048, ("acts", "coeffs", "both")),
            ("kv", 2048, qkv, 4096, 2048, 1024, ("both",)),
            ("up-decode", 6144, ffn, 8, 2048, 6144, ("both",)),
            ("o-4072", 2048, qkv, 4072, 2048, 2048, ("both",)),
            ("gate/up", 6144, ffn, 4096, 2048, 6144, ("coeffs",))]


def run_q8_kernel_phase(torch, K, ops, Q, timer):
    """K1's codes and scales (int8 activations) or its output (int8 table
    alone) bit for bit against the plain version: both round the same ops
    alike, dequantize with one multiply, take an order-free max and divide
    by IEEE division.  K2's g_x bit for bit and its parameter grads within
    gamma_k times the sum of their terms' magnitudes, as phase 5.  Second
    launches bitwise equal to the first.  Activations are bf16 where they
    are not int8; rows are padded to the scale block, as the fused entry
    pads them."""
    rows_out, failures = [], []
    g = torch.Generator(device=DEVICE).manual_seed(8642)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=DEVICE)

    def mix(L, n):
        th = (torch.rand(L, n // 2, generator=g, device=DEVICE) * 2 - 1) \
            * math.pi
        c, s = torch.cos(th), torch.sin(th)
        return torch.stack([c, -s, s, c], dim=-1) + rnd(L, n // 2, 4,
                                                        scale=0.05)

    abs_sum = (lambda t: t.abs().sum(0))
    dt = torch.bfloat16
    for label, n, strides, rows, in_w, out_w, modes in q8_cases():
        runs = ops.plan_runs_for_rows(n, strides, rows)
        L = len(strides)
        cf = mix(L, n)
        d_in, d_out, b = 1 + 0.1 * rnd(n), 1 + 0.1 * rnd(n), 0.1 * rnd(n)
        widths = (None if in_w == n else in_w, None if out_w == n else out_w)
        for mode in modes:
            q_acts = mode in ("acts", "both")
            q_cf = mode in ("coeffs", "both")
            sr = Q.scale_block_rows(runs, rows, 2) if q_acts else None
            x = rnd(rows, in_w)
            if q_acts:
                x = Q.quantize_blocks(ops._pad_rows(x, sr), sr, runs[0][1])
            else:
                x = x.to(dt)
            kcf, scf = Q.quantize_coeffs(cf) if q_cf else (cf, None)
            B = (x[0] if q_acts else x).shape[0]

            def chain(fn, z=x):
                off = 0
                for r, (rs, nt) in enumerate(runs):
                    last = r == len(runs) - 1
                    zq, zs = z if q_acts else (z, None)
                    z = fn(zq, kcf[off: off + len(rs)],
                           d_in if r == 0 else None,
                           d_out if last else None, b if last else None, zs,
                           None if scf is None else scf[off: off + len(rs)],
                           strides=rs, n_tile=nt,
                           in_width=widths[0] if r == 0 else None,
                           out_width=widths[1] if last else None,
                           quant_out=q_acts, scale_rows=sr)
                    off += len(rs)
                return z

            kern, again, plain = (chain(K.spm_stack_kernel_call),
                                  chain(K.spm_stack_kernel_call),
                                  chain(K.spm_stack_plain))
            _, saved = ops.forward_runs(x, kcf, runs, d_in, d_out, b,
                                        *widths, coeff_scale=scf,
                                        scale_rows=sr)
            gy = rnd(B, out_w).to(dt)
            args = (saved, kcf, gy, runs, d_in, d_out, True, *widths)
            bkw = dict(coeff_scale=scf, scale_rows=sr)
            gk = ops.backward_runs(K.spm_stack_bwd_kernel_call, *args, **bkw)
            g2 = ops.backward_runs(K.spm_stack_bwd_kernel_call, *args, **bkw)
            gp = ops.backward_runs(K.spm_stack_bwd_plain, *args, **bkw)
            mags = ops.backward_runs(functools.partial(
                K.spm_stack_bwd_plain, col_sum=abs_sum), *args, **bkw)
            torch.cuda.synchronize()
            outs = (kern, again, plain) if q_acts else \
                ((kern,), (again,), (plain,))
            fwd_ok = all(torch.equal(u, v) for u, v in zip(outs[0], outs[2]))
            fwd_det = all(torch.equal(u, v) for u, v in zip(outs[0], outs[1]))
            n_codes = outs[0][0].numel()
            code_diff = int((outs[0][0] != outs[2][0]).sum())
            gx_err = max((a[0].float() - p[0].float()).abs().max().item()
                         for a, p in zip(gk, gp))
            worst = max(grads_within(a[1:], p[1:], m[1:], B)
                        for a, p, m in zip(gk, gp, mags))
            bwd_det = all(torch.equal(u, v) for a, c in zip(gk, g2)
                          for u, v in zip(a, c))
            ms = timer(lambda: chain(K.spm_stack_kernel_call))
            plain_ms = timer(lambda: chain(K.spm_stack_plain))
            bms_ = timer(lambda: ops.backward_runs(
                K.spm_stack_bwd_kernel_call, *args, **bkw))
            bplain_ms = timer(lambda: ops.backward_runs(
                K.spm_stack_bwd_plain, *args, **bkw))
            # bytes each function must move: activations at 1 byte (int8)
            # or 2 (bf16), the block scales, the table at 1 byte a
            # coefficient plus its stage scales (or 4 bytes f32), the
            # vectors; K2 also reads gy and writes g_x (bf16) and the f32
            # grads.  Operations: 3 a stage and element, 2 for the
            # diagonals and bias, 3 to quantize (abs-max, divide, round),
            # 1 to dequantize; K2 as phase 5.
            asz = 1 if q_acts else 2
            csz = 1 if q_cf else 4
            blocks = 2 * (B // sr) * -(-n // runs[0][1]) * 4 if q_acts else 0
            table = sum(len(rs) * n // 2 * 4 * csz for rs, _ in runs)
            vecs = 3 * 4 * n
            f_bytes = B * (in_w + out_w) * asz + blocks + table + vecs
            f_flops = B * n * (3 * L + 2 + (4 if q_acts else 0))
            fbound, fby = bound(f_bytes, f_flops)
            b_bytes = (B * in_w * asz + blocks // 2 + B * (out_w + in_w) * 2
                       + table + sum(len(rs) * n // 2 * 16 for rs, _ in runs)
                       + 2 * vecs)
            b_flops = B * n * (10 * L + 6 * len(runs) + (1 if q_acts else 0))
            bbound, bby = bound(b_bytes, b_flops)
            eye = torch.eye(in_w, device=DEVICE)
            dense = K.spm_stack_plain(
                eye, cf, d_in, d_out, strides=strides,
                out_width=widths[1]).to(dt)
            xb = rnd(B, in_w).to(dt)
            f_lib = timer(lambda: torch.matmul(xb, dense))
            w = dense.T.contiguous()
            b_lib = timer(lambda: (torch.matmul(gy, w), torch.matmul(xb.T,
                                                                     gy)))
            ok = (fwd_ok and fwd_det and gx_err == 0 and worst <= 1
                  and bwd_det and all(bool(torch.isfinite(t.float()).all())
                                      for a in gk for t in a))
            cta = (K.int8_cta_rows(B, runs[0][1],
                                   -(-out_w // runs[0][1]), sr)
                   if q_acts else None)
            base = dict(case=label, mode=mode, dtype="int8" if q_acts
                        else "bfloat16", rows=rows, padded_rows=B, n=n,
                        in_width=in_w, out_width=out_w,
                        runs=[[list(rs), nt] for rs, nt in runs],
                        launches_per_call=len(runs), scale_rows=sr,
                        block_rows=cta,
                        cluster=(sr // cta) if q_acts else None)
            rows_out.append(dict(
                base, kernel="K1 int8", codes=n_codes, codes_differing=code_diff,
                bitwise=fwd_ok, deterministic=fwd_det, max_abs_err=float(
                    max((u.float() - v.float()).abs().max().item()
                        for u, v in zip(outs[0], outs[2]))),
                ms=ms, plain_ms=plain_ms, bound_ms=fbound, bound_by=fby,
                library_ms=f_lib, ok=fwd_ok and fwd_det))
            rows_out.append(dict(
                base, kernel="K2 int8", gx_max_abs_err=gx_err,
                max_abs_err=gx_err, grad_err_over_limit=worst,
                deterministic=bwd_det, ms=bms_, plain_ms=bplain_ms,
                bound_ms=bbound, bound_by=bby, library_ms=b_lib,
                ok=gx_err == 0 and worst <= 1 and bwd_det))
            log(f"int8 {label:9s} {mode:6s} rows={rows:5d} runs={len(runs)} "
                f"scale_rows={sr} cluster={base['cluster']} | K1 bitwise="
                f"{fwd_ok} det={fwd_det} ms={ms:.4f} plain_ms="
                f"{plain_ms:.4f} bound_ms={fbound:.4f} ({fby}) library_ms="
                f"{f_lib:.4f} | K2 gx_err={gx_err:.3e} grad err/limit="
                f"{worst:.3f} det={bwd_det} ms={bms_:.4f} plain_ms="
                f"{bplain_ms:.4f} bound_ms={bbound:.4f} ({bby}) library_ms="
                f"{b_lib:.4f} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"int8 {label} {mode}")
    return rows_out, failures


def run_q8_nonfinite_case(torch, K, ops, Q):
    """K1's requantizing store on scale blocks that hold non-finite values,
    against the plain version: n = 6144 in one run of three 2048-wide
    tiles at 64 rows (clusters of 8 blocks); d_out carries a NaN and an
    Inf in tile 0 and an Inf in tile 1.  The absmax keeps them, as
    torch.amax does, so every scale of tile 0 is NaN, of tile 1 Inf, and
    every code in both 0 (the blocks dequantize to NaN); tile 2 stays
    finite.  Codes and scales exactly the plain version's, NaN equal to
    NaN."""
    g = torch.Generator(device=DEVICE).manual_seed(99)
    n, rows = 6144, 64
    ((rs, nt),) = ops.plan_runs_for_rows(n, tuple(1 << i for i in range(11)),
                                         rows)
    sr = Q.scale_block_rows([(rs, nt)], rows, 2)
    qx, xs = Q.quantize_blocks(
        torch.randn(rows, n, generator=g, device=DEVICE), sr, nt)
    qc, sc = Q.quantize_coeffs(0.5 * torch.randn(
        len(rs), n // 2, 4, generator=g, device=DEVICE))
    d_out = torch.ones(n, device=DEVICE)
    d_out[5], d_out[9], d_out[nt + 3] = math.nan, math.inf, math.inf
    kw = dict(strides=rs, n_tile=nt, quant_out=True, scale_rows=sr)
    kq, ks = K.spm_stack_kernel_call(qx, qc, None, d_out, None, xs, sc, **kw)
    pq, ps = K.spm_stack_plain(qx, qc, None, d_out, None, xs, sc, **kw)
    torch.cuda.synchronize()
    same = torch.equal(kq, pq) and torch.allclose(ks, ps, rtol=0, atol=0,
                                                  equal_nan=True)
    blocks = (bool(ks[:, 0].isnan().all()) and bool(ks[:, 1].isinf().all())
              and bool(torch.isfinite(ks[:, 2]).all())
              and not bool(kq[:, :2 * nt].any()) and bool(kq[:, 2 * nt:].any()))
    ok = same and blocks
    log(f"int8 nonfinite rows={rows} n={n} tiles={n // nt} scale_rows={sr}: "
        f"codes and scales as the plain version={same}, NaN/Inf/finite "
        f"tiles as expected={blocks} {'ok' if ok else 'FAIL'}")
    return dict(rows=rows, n=n, n_tile=nt, scale_rows=sr, bitwise=same,
                blocks_as_expected=blocks, ok=ok)


# ---------------------------------------------------------------------------
# phases 9-11: int8 training, its parity with the CPU, int8 serving
# ---------------------------------------------------------------------------

def linear_runs(cfg, ops, rows: int):
    """(runs, int8-activation eligible) of each of a layer's seven SPM
    linears at ``rows`` rows, from the port's own plan."""
    from repro_torch.core.eligibility import quant_acts_eligible
    spec = cfg.layers[0]
    acfg, fcfg = cfg.attn_cfg(spec), cfg.ffn_cfg()
    out = []
    for lin in (acfg.q_proj, acfg.kv_proj, acfg.kv_proj, acfg.o_proj,
                fcfg.gate, fcfg.up, fcfg.down):
        scfg = lin.spm_config()
        runs = ops.plan_runs_for_rows(scfg.n, scfg.pairing.strides(), rows)
        out.append((len(runs), quant_acts_eligible(runs)))
    return out


def planned_q8_launches(cfg, ops, rows: int) -> dict:
    """K1 launches of one quantized forward: every linear on K1 (none
    block-fuses), each in an int8 mode (its table), those of the linears
    whose runs share a tile with int8 activations; K3 none."""
    lin = linear_runs(cfg, ops, rows)
    k1 = cfg.n_layers * sum(r for r, _ in lin)
    io = cfg.n_layers * sum(r for r, e in lin if e)
    return {"K1": k1, "K1 int8": k1, "K1 int8 io": io, "K3": 0}


def planned_q8_train_launches(cfg, ops, rows: int) -> dict:
    """One quantized training step: the forward's launches twice (remat),
    K2 once per forward K1 run with the same int8 modes, no K3/K4."""
    f = planned_q8_launches(cfg, ops, rows)
    m = 2 if cfg.remat else 1
    return {"K1": m * f["K1"], "K1 int8": m * f["K1 int8"],
            "K1 int8 io": m * f["K1 int8 io"], "K2": f["K1"],
            "K2 int8": f["K1 int8"], "K2 int8 io": f["K1 int8 io"],
            "K3": 0, "K4": 0}


def q8_counts(K) -> dict:
    return {"K1": K.spm_stack_kernel_call.launches,
            "K1 int8": K.spm_stack_kernel_call.int8_launches,
            "K1 int8 io": K.spm_stack_kernel_call.int8_io_launches,
            "K2": K.spm_stack_bwd_kernel_call.launches,
            "K2 int8": K.spm_stack_bwd_kernel_call.int8_launches,
            "K2 int8 io": K.spm_stack_bwd_kernel_call.int8_io_launches,
            "K3": K.spm_block_kernel_call.launches,
            "K4": K.spm_block_bwd_kernel_call.launches}


def flip_budget(rel: float, codes: int) -> float:
    """How many of ``codes`` entry codes the two sides may make otherwise
    when their inputs agree within ``rel`` of the block's absmax: a code
    flips only where the quotients v / s of the two sides straddle a
    half-integer; v moves the quotient by at most 127 rel and s by as much
    again (|v / s| <= 127), and with the fractional parts spread evenly at
    most a 254 rel share of the codes straddle one."""
    return 254 * rel * codes


def run_q8_train_parity_phase(torch, T, LM, train_mod, adamw, cfg, batch=2,
                              seq=16):
    """The quantized full-width model with f32 activations, one step on the
    card and on the CPU, the CPU replaying the card's int8 codes
    (``kernels.codes.CodeTape``): each int8 chain on the CPU starts from
    the card's entry codes and hands the card's output codes on, so the two
    sides differ by f32 roundings alone and are held to phase 7's f32
    bound: the loss, each parameter's grad (relative norm) and the update.
    Left to itself, one code that an f32 difference flips moves every later
    value by a step, and over 28 layers the two sides part at quantization
    noise.  Per chain, the CPU's output from the card's entry must be the
    card's bit for bit (the kernels against the plain versions inside the
    model), and the entry codes the CPU would have made itself must lie
    within one of the card's, at most ``flip_budget`` of them."""
    from repro_torch.kernels.codes import CodeTape
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = T.init_model(cfg, seed=0, device="cpu")
    card = copy.deepcopy(params).to(DEVICE)
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    L_attn, L_ffn = 11, 12
    per_layer = (cfg.d_model + 3 * L_attn + 8 + cfg.head_dim + seq
                 + 3 * L_attn + 3 * (3 * L_ffn + 4) + cfg.d_model)
    depth = 2 * (cfg.n_layers * per_layer + 2 * cfg.d_model)
    rel = 8 * math.sqrt(depth) * EPS["float32"]
    t0 = time.perf_counter()
    out, tapes = {}, {}
    for side, p in (("card", card), ("cpu", params)):
        dev = "cpu" if side == "cpu" else DEVICE
        state = train_mod.make_train_state(p)
        bd = {k: v.to(dev) for k, v in b.items()}
        with CodeTape(replay=tapes.get("card")) as tape:
            loss, _ = LM.lm_loss(p, bd, cfg)
            loss.backward()
        tapes[side] = tape
        grads = {k: q.grad.detach().float().cpu() for k, q in
                 p.named_parameters()}
        p0 = {k: q.detach().cpu().clone() for k, q in p.named_parameters()}
        step = train_mod.make_train_step(
            lambda pp, bb: LM.lm_loss(pp, bb, cfg), adamw.OptimizerConfig())
        with CodeTape(replay=tapes.get("card_step")) as tape:
            state, m = step(state, bd)
        tapes[f"{side}_step"] = tape
        out[side] = dict(loss=loss.item(), grads=grads, p0=p0,
                         p1={k: q.detach().cpu() for k, q in
                             p.named_parameters()},
                         skipped=float(m["skipped"]))
    secs = time.perf_counter() - t0
    codes = {k: tapes[k].summary() for k in ("cpu", "cpu_step")}
    a, c = out["card"], out["cpu"]
    loss_err = abs(a["loss"] - c["loss"])
    worst_name, worst = None, 0.0
    for k, gc in c["grads"].items():
        num = (a["grads"][k] - gc).norm().item()
        den = gc.norm().item()
        r = num / den if den > 0 else (0.0 if num == 0 else math.inf)
        if r >= worst:
            worst_name, worst = k, r
    diff = math.sqrt(sum(float(((a["p1"][k] - c["p1"][k]) ** 2).sum())
                         for k in c["p1"]))
    moved = math.sqrt(sum(float(((c["p1"][k] - c["p0"][k]) ** 2).sum())
                          for k in c["p1"]))
    codes_ok = all(
        v["chains"] == v["recorded"] > 0 and v["out_differ"] == 0
        and v["entry_max_diff"] <= 1
        and v["entry_flips"] <= flip_budget(rel, v["codes"])
        for v in codes.values())
    ok = (codes_ok and loss_err <= rel * abs(c["loss"]) and worst <= rel
          and diff <= rel * moved and a["skipped"] == 0.0 == c["skipped"])
    res = dict(batch=batch, seq=seq, loss_card=a["loss"], loss_cpu=c["loss"],
               loss_abs_err=loss_err, loss_rel_err=loss_err / abs(c["loss"]),
               worst_grad_rel_err=worst, worst_grad=worst_name,
               params_diff_norm=diff, update_norm=moved,
               params_diff_over_update=diff / moved, codes=codes,
               flip_budget_share=254 * rel, rel_tol=rel, seconds=secs)
    cs = codes["cpu"]
    log(f"int8 train parity (CPU replays the card's codes): loss card "
        f"{a['loss']:.6f} cpu {c['loss']:.6f} (err {loss_err:.2e}), worst "
        f"grad rel err {worst:.2e} ({worst_name}), params diff {diff:.3e} "
        f"vs update {moved:.3e}; tol {rel:.2e} relative; {cs['chains']} "
        f"chains, outputs differing {cs['out_differ']}, entry codes flipped "
        f"{cs['entry_flips']} of {cs['codes']} (budget "
        f"{flip_budget(rel, cs['codes']):.0f}, max diff "
        f"{cs['entry_max_diff']}); step: {codes['cpu_step']} ({secs:.1f} s) "
        f"{'ok' if ok else 'FAIL'}")
    return res, ok


def run_q8_serve_phase(torch, K, ops, T, LM, ServeEngine, cfg, batch=8,
                       prompt_len=512, new=64, tf_batch=4, tf_prompt=16,
                       tf_steps=32):
    """Greedy serving of the quantized model (bf16 KV cache): launches
    equal to the plan, prefill ms and decode tokens/s; then the same
    weights teacher-forced on the card and on the CPU (batch 4, prompt 16,
    32 steps), the CPU replaying the card's int8 codes as in phase 10, so
    the logits are held to phase 4's bf16 bound alone: within it, tokens
    equal wherever the top-2 gap exceeds it, at least ``MIN_DECIDED``
    tokens decided.  Per chain the CPU's output from the card's entry must
    be the card's bit for bit, its own entry codes within one of the
    card's (bf16 rounding between the chains flips many; they are
    counted)."""
    from repro_torch.kernels.codes import CodeTape
    params = T.init_model(cfg, seed=0, device=DEVICE)
    eng = ServeEngine(cfg=cfg, params=params, max_len=prompt_len + new,
                      cache_dtype=torch.bfloat16, device=DEVICE)
    gen = torch.Generator().manual_seed(17)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen)
    eng.generate(prompts[:, :16], max_new_tokens=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    tokens, flags = eng.generate(prompts, max_new_tokens=new,
                                 return_flags=True)
    torch.cuda.synchronize()
    got = q8_counts(K)
    pre = planned_q8_launches(cfg, ops, batch * prompt_len)
    dec = planned_q8_launches(cfg, ops, batch)
    want = {k: pre[k] + (new - 1) * dec[k] for k in pre}
    got_fwd = {k: got[k] for k in want}
    peak = torch.cuda.max_memory_allocated()

    def wall(n_tokens):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.generate(prompts, max_new_tokens=n_tokens)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    t1 = min(wall(1) for _ in range(2))
    tn = min(wall(new) for _ in range(2))
    launch_ok = got_fwd == want and got["K2"] == 0 and got["K4"] == 0
    ok_tokens = (tuple(tokens.shape) == (batch, new) and not bool(flags.any())
                 and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()))

    cpu_params = copy.deepcopy(params).to("cpu")
    tp = torch.randint(0, cfg.vocab_size, (tf_batch, tf_prompt),
                       generator=gen)
    emb = cpu_params["embed"]
    w = emb["table"] if cfg.tie_embeddings else emb["out"].T
    hw = (cfg.d_model ** 0.5
          * cpu_params["final_norm"]["scale"].abs().max().item()
          * w.float().norm(dim=-1).max().item())
    t_bf16 = 2 * 2.0 ** -8 * hw
    t0 = time.perf_counter()
    logits = {}
    recs = {}
    with torch.inference_mode():
        for side, p in (("card", params), ("cpu", cpu_params)):
            dev = DEVICE if side == "card" else "cpu"
            with CodeTape(replay=recs.get("card")) as rec:
                lg, cache = LM.prefill(p, cfg, max_len=tf_prompt + tf_steps,
                                       tokens=tp.to(dev))
                seq = [lg.float().cpu()]
                for step in range(tf_steps - 1):
                    tok = logits["card"][step].argmax(-1) if side == "cpu" \
                        else seq[-1].argmax(-1)
                    lg, cache = LM.decode_step(p, cfg, tok.to(dev), cache,
                                               tf_prompt + step)
                    seq.append(lg.float().cpu())
            logits[side], recs[side] = seq, rec
    tf_s = time.perf_counter() - t0
    codes = recs["cpu"].summary()
    tol = t_bf16
    worst, decided, mism = 0.0, 0, 0
    for a, c in zip(logits["card"], logits["cpu"]):
        worst = max(worst, (a - c).abs().max().item())
        top2 = a.topk(2, dim=-1).values
        dec_rows = (top2[:, 0] - top2[:, 1]) > tol
        decided += int(dec_rows.sum())
        mism += int((a.argmax(-1) != c.argmax(-1))[dec_rows].sum())
    finite = all(bool(torch.isfinite(a).all()) for a in logits["card"])
    codes_ok = (codes["chains"] == codes["recorded"] > 0
                and codes["out_differ"] == 0 and codes["entry_max_diff"] <= 1)
    parity_ok = (codes_ok and finite and worst <= tol and mism == 0
                 and decided >= MIN_DECIDED)
    res = dict(batch=batch, prompt_len=prompt_len, new_tokens=new,
               prefill_ms=t1 * 1e3,
               decode_tok_per_s=batch * (new - 1) / (tn - t1),
               generate_s=tn, peak_mem_bytes=peak, launches=got,
               planned=want, planned_per_forward={"prefill": pre,
                                                  "decode": dec},
               parity=dict(batch=tf_batch, prompt_len=tf_prompt,
                           steps=tf_steps, max_abs_err=worst, tol=tol,
                           codes=codes, decided_tokens=decided,
                           min_decided=MIN_DECIDED, token_mismatches=mism,
                           seconds=tf_s))
    ok = launch_ok and ok_tokens and parity_ok
    log(f"int8 serve: prefill {t1 * 1e3:.1f} ms, decode "
        f"{res['decode_tok_per_s']:.1f} tok/s, generate {tn:.2f} s, peak "
        f"{peak / 2**30:.2f} GiB, launches {got_fwd} (planned {want}); "
        f"parity (CPU replays the card's codes): logits max err "
        f"{worst:.3e} (tol {tol:.3e}), {codes['chains']} chains, outputs "
        f"differing {codes['out_differ']}, entry codes flipped "
        f"{codes['entry_flips']} of {codes['codes']} (max diff "
        f"{codes['entry_max_diff']}), {decided} tokens decided (at least "
        f"{MIN_DECIDED}), {mism} differ ({tf_s:.1f} s) "
        f"{'ok' if ok else 'FAIL'}")
    return res, ok


# ---------------------------------------------------------------------------
# phases 12-14: the feature-sharded executor
# ---------------------------------------------------------------------------

SHARDS = 4


def shard_run(spm_cfg, rows: int):
    """The local run of a sharded linear's first step and its plan at
    ``rows`` rows: ``(n_local, run strides, ((strides, n_tile), ...))``."""
    from repro_torch.core.eligibility import plan_steps
    from repro_torch.kernels import ops
    steps = plan_steps(spm_cfg.n, spm_cfg.pairing.strides(),
                       spm_cfg.n_shards)
    n_local = spm_cfg.n // spm_cfg.n_shards
    return n_local, steps, [ops.plan_runs_for_rows(n_local, st[2], rows)
                            for st in steps if st[0] == "local"]


def run_window_kernel_phase(torch, K, timer, scfg):
    """K1's and K2's windowed (``col_base``) modes at the gate/up shard
    shapes of ``scfg`` (n=6144 over 4 shards: n_local 1536, in_width 2048),
    every shard (0 live, 1 straddling column 2048, 2 and 3 past it), at
    training and decode rows, bf16 and f32; then K2 reading gy through the
    window of a global out_width=2048 cotangent (the down projection's
    shape).  K1 bit for bit and a dead shard exactly its bias; K2's g_x bit
    for bit and its grads within gamma_rows of the sum of magnitudes (as
    phase 5), g_din exactly zero past in_width; second launches bitwise.
    The bound counts the x columns the window reads, not the slab's.
    Last, the sharded path's unwindowed K1/K2 shapes, shard 0 (every shard
    has its shape), bf16, 4096 and 8 rows, held to the same criteria: the
    o projection's 9-stage run (n_local 512, d_out folded into the mix, so
    not into K1) and the down projection's 12-stage run (n_local 1536),
    with the operands the executor folds into them."""
    rows_out, failures = [], []
    g = torch.Generator(device=DEVICE).manual_seed(2468)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=DEVICE)

    def mix(L, n):
        th = (torch.rand(L, n // 2, generator=g, device=DEVICE) * 2 - 1) \
            * math.pi
        c, s = torch.cos(th), torch.sin(th)
        return torch.stack([c, -s, s, c], dim=-1) + rnd(L, n // 2, 4,
                                                        scale=0.05)

    abs_sum = (lambda t: t.abs().sum(0))
    lin = scfg.ffn_cfg().up
    spm = lin.spm_config()
    in_w = lin.d_in
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        esz = torch.tensor([], dtype=dt).element_size()
        for rows in (4096, 8):
            nl, steps, plans = shard_run(spm, rows)
            assert steps[0][0] == "local" and len(plans[0]) == 1, plans
            (rs, nt), = plans[0]
            L = len(rs)
            for shard in range(spm.n_shards):
                base = shard * nl // nt
                live = max(0, min(nl, in_w - shard * nl))
                cf = mix(L, nl)
                d_in, d_out, b = 1 + 0.1 * rnd(nl), 1 + 0.1 * rnd(nl), \
                    0.1 * rnd(nl)
                x = rnd(rows, in_w).to(dt)
                gy = rnd(rows, nl).to(dt)
                kw = dict(strides=rs, n_tile=nt, in_width=in_w,
                          col_base=base)
                y = K.spm_stack_kernel_call(x, cf, d_in, d_out, b, **kw)
                y2 = K.spm_stack_kernel_call(x, cf, d_in, d_out, b, **kw)
                yp = K.spm_stack_plain(x, cf, d_in, d_out, b, **kw)
                bw = dict(kw, has_bias=True)
                gk = K.spm_stack_bwd_kernel_call(x, cf, gy, d_in, d_out,
                                                 **bw)
                gk2 = K.spm_stack_bwd_kernel_call(x, cf, gy, d_in, d_out,
                                                  **bw)
                gp = K.spm_stack_bwd_plain(x, cf, gy, d_in, d_out, **bw)
                gm = K.spm_stack_bwd_plain(x, cf, gy, d_in, d_out,
                                           col_sum=abs_sum, **bw)
                torch.cuda.synchronize()
                k1_err = (y.float() - yp.float()).abs().max().item()
                dead_ok = (shard * nl < in_w
                           or torch.equal(y, b.to(dt).expand(rows, -1)))
                gx_err = (gk[0].float() - gp[0].float()).abs().max().item()
                worst = grads_within(gk[1:], gp[1:], gm[1:], rows)
                zeros = not gk[2][live:].any()
                det = torch.equal(y, y2) and all(
                    torch.equal(u, v) for u, v in zip(gk, gk2))
                # the dense map of this shard's window: (in_width, n_local)
                w = K.spm_stack_plain(torch.eye(in_w, device=DEVICE), cf,
                                      d_in, d_out, None, **kw).to(dt)
                k1 = dict(ms=timer(lambda: K.spm_stack_kernel_call(
                    x, cf, d_in, d_out, b, **kw)),
                    plain_ms=timer(lambda: K.spm_stack_plain(
                        x, cf, d_in, d_out, b, **kw)),
                    library_ms=timer(lambda: torch.matmul(x, w)))
                k2 = dict(ms=timer(lambda: K.spm_stack_bwd_kernel_call(
                    x, cf, gy, d_in, d_out, **bw)),
                    plain_ms=timer(lambda: K.spm_stack_bwd_plain(
                        x, cf, gy, d_in, d_out, **bw)),
                    library_ms=timer(lambda: (torch.matmul(gy, w.T),
                                              torch.matmul(x.T, gy))))
                # K1 reads the live columns of x, writes the slab, reads
                # the table and three vectors; K2 reads x's live columns,
                # gy, the table and two vectors, writes g_x, the table's
                # grads and three vector grads
                k1["bound_ms"], k1["bound_by"] = bound(
                    rows * (live + nl) * esz + L * nl // 2 * 16 + 3 * 4 * nl,
                    rows * nl * (3 * L + 2))
                k2["bound_ms"], k2["bound_by"] = bound(
                    rows * (live + 2 * nl) * esz + 2 * L * nl // 2 * 16
                    + 5 * 4 * nl, rows * nl * (10 * L + 6))
                ok1 = k1_err == 0 and dead_ok and bool(
                    torch.isfinite(y.float()).all())
                ok2 = gx_err == 0 and worst <= 1 and zeros and all(
                    bool(torch.isfinite(t.float()).all()) for t in gk)
                common = dict(case=f"up shard {shard}", dtype=dname,
                              rows=rows, n=nl, in_width=in_w, n_tile=nt,
                              col_base=base, live_columns=live,
                              deterministic=det, launches_per_call=1)
                rows_out.append(dict(common, kernel="K1 col_base",
                                     max_abs_err=k1_err, dead_is_bias=dead_ok,
                                     ok=ok1 and det, **k1))
                rows_out.append(dict(common, kernel="K2 col_base",
                                     gx_max_abs_err=gx_err,
                                     max_abs_err=max(gx_err, max(
                                         (u - v).abs().max().item()
                                         for u, v in zip(gk[1:], gp[1:]))),
                                     grad_err_over_limit=worst,
                                     dead_lane_grads_zero=zeros,
                                     ok=ok2 and det, **k2))
                log(f"col_base up s{shard} {dname:8s} rows={rows:5d} "
                    f"base={base} live={live:4d} | K1 err={k1_err:.1e} "
                    f"dead=bias:{dead_ok} ms={k1['ms']:.4f} plain_ms="
                    f"{k1['plain_ms']:.4f} bound_ms={k1['bound_ms']:.4f} "
                    f"({k1['bound_by']}) library_ms={k1['library_ms']:.4f} "
                    f"| K2 gx_err={gx_err:.1e} grad err/limit={worst:.3f} "
                    f"zeros={zeros} ms={k2['ms']:.4f} plain_ms="
                    f"{k2['plain_ms']:.4f} bound_ms={k2['bound_ms']:.4f} "
                    f"({k2['bound_by']}) library_ms="
                    f"{k2['library_ms']:.4f} det={det} "
                    f"{'ok' if ok1 and ok2 and det else 'FAIL'}")
                if not (ok1 and ok2 and det):
                    failures.append(f"col_base up shard {shard} {dname} "
                                    f"rows={rows}")
                # K2 reading gy through the window (out_width 2048)
                xs = rnd(rows, nl).to(dt)
                gyw = rnd(rows, in_w).to(dt)
                gkw = dict(strides=rs, n_tile=nt, out_width=in_w,
                           col_base=base, has_bias=True)
                gk = K.spm_stack_bwd_kernel_call(xs, cf, gyw, d_in, d_out,
                                                 **gkw)
                gp = K.spm_stack_bwd_plain(xs, cf, gyw, d_in, d_out, **gkw)
                gm = K.spm_stack_bwd_plain(xs, cf, gyw, d_in, d_out,
                                           col_sum=abs_sum, **gkw)
                torch.cuda.synchronize()
                gx_err = (gk[0].float() - gp[0].float()).abs().max().item()
                worst = grads_within(gk[1:], gp[1:], gm[1:], rows)
                zeros = not gk[3][live:].any() and not gk[4][live:].any()
                ok = gx_err == 0 and worst <= 1 and zeros
                rows_out.append(dict(
                    kernel="K2 col_base gy", case=f"down shard {shard}",
                    dtype=dname, rows=rows, n=nl, out_width=in_w,
                    n_tile=nt, col_base=base, live_columns=live,
                    gx_max_abs_err=gx_err, grad_err_over_limit=worst,
                    dead_lane_grads_zero=zeros, max_abs_err=gx_err, ok=ok))
                log(f"col_base gy down s{shard} {dname:8s} rows={rows:5d} "
                    f"K2 gx_err={gx_err:.1e} grad err/limit={worst:.3f} "
                    f"zeros={zeros} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"col_base gy down shard {shard} "
                                    f"{dname} rows={rows}")
    dt = torch.bfloat16
    acfg = scfg.attn_cfg(scfg.layers[0])
    for name, lin in (("o", acfg.o_proj), ("down", scfg.ffn_cfg().down)):
        spm = lin.spm_config()
        for rows in (4096, 8):
            nl, steps, plans = shard_run(spm, rows)
            assert steps[0][0] == "local" and len(plans[0]) == 1, plans
            (rs, nt), = plans[0]
            last_local = len(steps) == 1
            cf = mix(len(rs), nl)
            d_in = 1 + 0.1 * rnd(nl)
            d_out = 1 + 0.1 * rnd(nl) if last_local and spm.use_diag \
                else None
            b = 0.1 * rnd(nl) if last_local and spm.use_bias else None
            x = rnd(rows, nl).to(dt)
            gy = rnd(rows, nl).to(dt)
            kw = dict(strides=rs, n_tile=nt)
            bw = dict(kw, has_bias=b is not None)
            y = K.spm_stack_kernel_call(x, cf, d_in, d_out, b, **kw)
            y2 = K.spm_stack_kernel_call(x, cf, d_in, d_out, b, **kw)
            yp = K.spm_stack_plain(x, cf, d_in, d_out, b, **kw)
            gk = K.spm_stack_bwd_kernel_call(x, cf, gy, d_in, d_out, **bw)
            gk2 = K.spm_stack_bwd_kernel_call(x, cf, gy, d_in, d_out, **bw)
            gp = K.spm_stack_bwd_plain(x, cf, gy, d_in, d_out, **bw)
            gm = K.spm_stack_bwd_plain(x, cf, gy, d_in, d_out,
                                       col_sum=abs_sum, **bw)
            torch.cuda.synchronize()
            k1_err = (y.float() - yp.float()).abs().max().item()
            gx_err = (gk[0].float() - gp[0].float()).abs().max().item()
            worst = grads_within(gk[1:], gp[1:], gm[1:], rows)
            det = torch.equal(y, y2) and all(
                torch.equal(u, v) for u, v in zip(gk, gk2))
            ok1 = k1_err == 0 and bool(torch.isfinite(y.float()).all())
            ok2 = gx_err == 0 and worst <= 1 and all(
                bool(torch.isfinite(t.float()).all()) for t in gk)
            k1_ms = timer(lambda: K.spm_stack_kernel_call(
                x, cf, d_in, d_out, b, **kw))
            k2_ms = timer(lambda: K.spm_stack_bwd_kernel_call(
                x, cf, gy, d_in, d_out, **bw))
            common = dict(case=f"{name} shard 0", dtype="bfloat16",
                          rows=rows, n=nl, n_tile=nt, stages=len(rs),
                          folds_d_out=d_out is not None, deterministic=det,
                          launches_per_call=1)
            rows_out.append(dict(common, kernel="K1", max_abs_err=k1_err,
                                 ms=k1_ms, ok=ok1 and det))
            rows_out.append(dict(common, kernel="K2", gx_max_abs_err=gx_err,
                                 max_abs_err=max(gx_err, max(
                                     (u - v).abs().max().item()
                                     for u, v in zip(gk[1:], gp[1:]))),
                                 grad_err_over_limit=worst, ms=k2_ms,
                                 ok=ok2 and det))
            log(f"shard {name:4s} s0 bfloat16 rows={rows:5d} n_local={nl} "
                f"tile={nt} L={len(rs)} | K1 err={k1_err:.1e} "
                f"ms={k1_ms:.4f} | K2 gx_err={gx_err:.1e} grad err/limit="
                f"{worst:.3f} ms={k2_ms:.4f} det={det} "
                f"{'ok' if ok1 and ok2 and det else 'FAIL'}")
            if not (ok1 and ok2 and det):
                failures.append(f"{name} shard 0 bfloat16 rows={rows}")
    return rows_out, failures


def linear_plan(lin, rows: int) -> dict:
    """Launches of one sharded linear over ``rows`` rows on the card, from
    ``plan_steps``, ``overlap_segments``, ``plan_runs`` and
    ``plan_runs_for_rows``: under the overlap schedule a ``pair`` segment
    whose local run plans to one kernel run is one K5 forward and one K6
    backward over every shard; every other local step is K1 for each
    shard and planned run over all the rows (on the card the rows are one
    block; K2 likewise; ``K1 bwd remat`` the runs the backward remats),
    the first run windowed when the input is narrower than n."""
    from repro_torch.core.eligibility import (overlap_segments, plan_steps,
                                              resolve_overlap)
    from repro_torch.kernels import ops
    spm = lin.spm_config()
    S = spm.n_shards
    nl = spm.n // S
    steps = plan_steps(spm.n, spm.pairing.strides(), S)
    win = lin.d_in < spm.n and steps[0][0] == "local"
    out = dict.fromkeys(("K1", "K1 col_base", "K1 bwd remat", "K5",
                         "K5 col_base"), 0)
    i = 0
    for seg in (overlap_segments(steps) if resolve_overlap(spm, steps)
                else tuple(("one", st) for st in steps)):
        if seg[0] == "pair" and len(ops.plan_runs(nl, seg[1][2])) == 1:
            out["K5"] += 1
            out["K5 col_base"] += int(i == 0 and win)
            i += 2
            continue
        for st in seg[1:]:
            if st[0] == "local":
                runs = ops.plan_runs_for_rows(nl, st[2], rows)
                out["K1"] += S * len(runs)
                out["K1 bwd remat"] += S * (len(runs) - 1)
                out["K1 col_base"] += S * int(i == 0 and win)
            i += 1
    return out


def planned_sharded_launches(scfg, rows: int) -> dict:
    """Launches of one sharded forward over ``rows`` rows: ``linear_plan``
    summed over every linear of every layer; no linear block-fuses (K3
    0)."""
    spec = scfg.layers[0]
    acfg, fcfg = scfg.attn_cfg(spec), scfg.ffn_cfg()
    tot = dict.fromkeys(("K1", "K1 col_base", "K1 bwd remat", "K5",
                         "K5 col_base"), 0)
    for lin in (acfg.q_proj, acfg.kv_proj, acfg.kv_proj, acfg.o_proj,
                fcfg.gate, fcfg.up, fcfg.down):
        for k, v in linear_plan(lin, rows).items():
            tot[k] += scfg.n_layers * v
    tot["K3"] = 0
    return tot


def with_int8(plan: dict, quant: bool) -> dict:
    """``plan`` with the int8 counts: under ``with_quantized_io`` every
    sharded K1/K2/K5/K6 launch reads an int8 table (the sharded path takes
    no int8 activations); none otherwise."""
    out = dict(plan)
    for k in ("K1", "K2", "K5", "K6"):
        out[f"{k} int8"] = plan.get(k, 0) if quant else 0
    out["K1 int8 io"] = out["K2 int8 io"] = 0
    return out


def planned_sharded_train_launches(scfg, rows: int) -> dict:
    """One sharded training step: the forward twice (remat), then K2 once
    per forward K1 run (windowed where the forward's is) plus the
    backward's own remat runs, K6 once per K5; no K3/K4."""
    f = planned_sharded_launches(scfg, rows)
    m = 2 if scfg.remat else 1
    return with_int8(
        {"K1": m * f["K1"] + f["K1 bwd remat"],
         "K1 col_base": m * f["K1 col_base"], "K2": f["K1"],
         "K2 col_base": f["K1 col_base"], "K3": 0, "K4": 0,
         "K5": m * f["K5"], "K5 col_base": m * f["K5 col_base"],
         "K6": f["K5"], "K6 col_base": f["K5 col_base"]},
        scfg.spm_quant_coeffs)


def sharded_counts(K) -> dict:
    out = {"K1": K.spm_stack_kernel_call.launches,
           "K1 col_base": K.spm_stack_kernel_call.window_launches,
           "K2": K.spm_stack_bwd_kernel_call.launches,
           "K2 col_base": K.spm_stack_bwd_kernel_call.window_launches,
           "K3": K.spm_block_kernel_call.launches,
           "K4": K.spm_block_bwd_kernel_call.launches,
           "K5": K.spm_overlap_kernel_call.launches,
           "K5 col_base": K.spm_overlap_kernel_call.window_launches,
           "K6": K.spm_overlap_bwd_kernel_call.launches,
           "K6 col_base": K.spm_overlap_bwd_kernel_call.window_launches}
    for k, fn in (("K1", K.spm_stack_kernel_call),
                  ("K2", K.spm_stack_bwd_kernel_call),
                  ("K5", K.spm_overlap_kernel_call),
                  ("K6", K.spm_overlap_bwd_kernel_call)):
        out[f"{k} int8"] = fn.int8_launches
    out["K1 int8 io"] = K.spm_stack_kernel_call.int8_io_launches
    out["K2 int8 io"] = K.spm_stack_bwd_kernel_call.int8_io_launches
    return out


def run_sharded_phase(torch, K, T, LM, train_mod, adamw, ServeEngine,
                      launch_train, cfg, baseline, batch=8, seq=512,
                      steps=6, poisoned=2, new=16, overlap=False,
                      quant=False, serve=True, trace=True,
                      label="sharded"):
    """Full-width ``with_feature_sharding(cfg, 4)`` on a 4-shard mesh on
    one card (``overlap``: with ``with_overlap_executor``; ``quant``: with
    ``with_quantized_io``), driven as the reference drives it:
    ``make_train_step`` under ``activation_sharding(mesh,
    shard_feature=True)``, ``steps`` steps of batch 8 x seq 512 with the
    ``poisoned``-th poisoned (as ``launch.train.train`` runs them: its
    batches, seed and optimizer), then (``serve``) one ``generate`` of 8 x
    512 prompts + 16 tokens.  Launches equal the plan, windowed and int8
    ones counted apart, K3 = K4 = 0; the poisoned step leaves the state
    bitwise unchanged.  Step ms, tokens/s and peak memory beside
    ``baseline``'s step of the same call; then (``trace``) one more step
    traced on the device alone (``launch.profile_train``'s measure): its
    busy time, the idle share of the median step and the time by kernel
    group."""
    from repro_torch.configs import (with_feature_sharding,
                                     with_overlap_executor,
                                     with_quantized_io)
    from repro_torch.data import DeterministicLoader, build_corpus
    from repro_torch.launch.profile_train import busy_us, group_of
    from repro_torch.parallel import activation_sharding, make_feature_mesh
    from torch.profiler import ProfilerActivity, profile
    scfg = with_feature_sharding(cfg, SHARDS)
    if overlap:
        scfg = with_overlap_executor(scfg, True)
    if quant:
        scfg = with_quantized_io(scfg)
    mesh = make_feature_mesh(SHARDS, device=DEVICE)
    args = launch_train.build_parser().parse_args(
        ["--arch", cfg.name, "--steps", str(steps), "--batch", str(batch),
         "--seq", str(seq)])
    loader = DeterministicLoader(
        launch_train.make_batch_fn(scfg, seq,
                                   build_corpus(200_000, seed=args.seed)),
        batch, seed=args.seed)
    opt_cfg = adamw.OptimizerConfig(lr=args.lr, total_steps=steps,
                                    warmup_steps=max(steps // 20, 1))
    step_fn = train_mod.make_train_step(
        lambda p, b: LM.lm_loss(p, b, scfg), opt_cfg, chaos_guard=True)
    params = T.init_model(scfg, seed=args.seed, device=DEVICE)
    state = train_mod.make_train_state(params)
    losses, skipped, secs = [], [], []
    unchanged = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    with activation_sharding(mesh, shard_feature=True):
        for s in range(steps):
            batch_s = {k: v.to(DEVICE) for k, v in loader.batch_at(s).items()}
            if s == poisoned:
                snap = ({k: v.detach().clone() for k, v in
                         state["params"].named_parameters()},
                        {m: {k: v.clone() for k, v in state["opt"][m].items()}
                         for m in ("mu", "nu")},
                        state["opt"]["count"].clone())
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_s, float(s == poisoned))
            metrics = LM.train_metrics(metrics)         # syncs the device
            secs.append(time.perf_counter() - t0)
            losses.append(metrics["loss"])
            skipped.append(metrics["skipped"])
            if s == poisoned:
                now = dict(state["params"].named_parameters())
                unchanged = (
                    torch.equal(state["opt"]["count"], snap[2])
                    and all(torch.equal(now[k], v)
                            for k, v in snap[0].items())
                    and all(torch.equal(state["opt"][m][k], v)
                            for m in ("mu", "nu")
                            for k, v in snap[1][m].items()))
                del snap
        torch.cuda.synchronize()
        train_got = sharded_counts(K)
        peak = torch.cuda.max_memory_allocated()
        per_step = planned_sharded_train_launches(scfg, batch * seq)
        train_want = {k: steps * v for k, v in per_step.items()}
        busy_ms, groups = None, {}
        if trace:
            # one more step with the device traced (profile_train's
            # measure): its busy time against the untraced median step
            batch_s = {k: v.to(DEVICE) for k, v in
                       loader.batch_at(steps).items()}
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                state, metrics = step_fn(state, batch_s, 0.0)
                LM.train_metrics(metrics)
            intervals = []
            for ev in prof.events():
                if ev.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                intervals.append((ev.time_range.start, ev.time_range.end))
                gr = groups.setdefault(group_of(ev.name), [0, 0.0])
                gr[0] += 1
                gr[1] += ev.time_range.elapsed_us() / 1e3
            busy_ms = busy_us(intervals) / 1e3
        del state, params
        torch.cuda.empty_cache()
        if not serve:
            tokens = flags = None

        if serve:
            sparams = T.init_model(scfg, seed=0, device=DEVICE)
            eng = ServeEngine(cfg=scfg, params=sparams, max_len=seq + new,
                              cache_dtype=torch.bfloat16, device=DEVICE)
            gen = torch.Generator().manual_seed(7)
            prompts = torch.randint(0, cfg.vocab_size, (batch, seq),
                                    generator=gen)
            eng.generate(prompts[:, :16], max_new_tokens=2)   # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            tokens, flags = eng.generate(prompts, max_new_tokens=new,
                                         return_flags=True)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            serve_got = sharded_counts(K)
            serve_peak = torch.cuda.max_memory_allocated()
            t0 = time.perf_counter()
            eng.generate(prompts, max_new_tokens=1)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            del eng, sparams
            torch.cuda.empty_cache()
    steady = sorted(secs[1:])
    med = steady[len(steady) // 2] if len(steady) % 2 else \
        0.5 * (steady[len(steady) // 2 - 1] + steady[len(steady) // 2])
    finite = all(math.isfinite(v) for v in losses)
    only = skipped == [float(s == poisoned) for s in range(steps)]
    train_ok = (finite and only and train_got == train_want
                and (poisoned is None or bool(unchanged)))
    res = dict(shards=SHARDS, mesh_devices=[str(d) for d in mesh.devices],
               overlap=overlap, int8_tables=quant,
               batch=batch, seq=seq, steps=steps, poisoned_step=poisoned,
               losses=losses, skipped=skipped, step_s=secs,
               step_ms_median=med * 1e3, tokens_per_s=batch * seq / med,
               peak_mem_bytes=peak, launches=train_got, planned=train_want,
               planned_per_step=per_step, poisoned_state_unchanged=unchanged,
               traced_step_device_busy_ms=busy_ms,
               device_idle_share=(None if busy_ms is None
                                  else 1.0 - busy_ms / (med * 1e3)),
               traced_step_groups={g: {"launches": n, "ms": ms} for g, (n, ms)
                                   in sorted(groups.items(),
                                             key=lambda kv: -kv[1][1])},
               baseline=baseline["label"],
               baseline_step_ms_median=baseline["step_ms_median"],
               baseline_tokens_per_s=baseline["tokens_per_s"],
               baseline_peak_mem_bytes=baseline["peak_mem_bytes"],
               label=label)
    log(f"{label} train ({SHARDS} shards on {mesh.devices[0]}): {steps} "
        f"steps of batch {batch} x seq {seq}, losses "
        f"{[round(v, 4) for v in losses]}, skipped {skipped}, poisoned step "
        f"unchanged={unchanged}, step {med * 1e3:.1f} ms ({baseline['label']}"
        f" {baseline['step_ms_median']:.1f}), {batch * seq / med:.0f} "
        f"tokens/s ({baseline['tokens_per_s']:.0f}), peak "
        f"{peak / 2**30:.2f} GiB ({baseline['peak_mem_bytes'] / 2**30:.2f}),"
        f" launches {train_got} (planned {train_want}) "
        f"{'ok' if train_ok else 'FAIL'}"
        + ("" if busy_ms is None else
           f"; a traced step: device busy {busy_ms:.1f} ms (idle "
           f"{res['device_idle_share']:.1%} of the median step), by group "
           + ", ".join(f"{g} {ms:.1f} ms/{n}" for g, (n, ms) in
                       sorted(groups.items(), key=lambda kv: -kv[1][1]))))
    if not serve:
        return res, train_ok
    pre = planned_sharded_launches(scfg, batch * seq)
    dec = planned_sharded_launches(scfg, batch)
    serve_want = with_int8(
        {"K1": pre["K1"] + (new - 1) * dec["K1"],
         "K1 col_base": pre["K1 col_base"] + (new - 1) * dec["K1 col_base"],
         "K2": 0, "K2 col_base": 0, "K3": 0, "K4": 0,
         "K5": pre["K5"] + (new - 1) * dec["K5"],
         "K5 col_base": pre["K5 col_base"] + (new - 1) * dec["K5 col_base"],
         "K6": 0, "K6 col_base": 0}, quant)
    in_range = bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    serve_ok = (serve_got == serve_want and tuple(tokens.shape)
                == (batch, new) and in_range and not bool(flags.any()))
    res["serve"] = dict(new_tokens=new, generate_s=gen_s,
                        prefill_ms=prefill_s * 1e3,
                        decode_tok_per_s=batch * (new - 1)
                        / max(gen_s - prefill_s, 1e-9),
                        peak_mem_bytes=serve_peak, launches=serve_got,
                        planned=serve_want)
    log(f"{label} serve: generate {batch} x {seq} + {new} in {gen_s:.2f} s, "
        f"prefill {prefill_s * 1e3:.1f} ms, peak {serve_peak / 2**30:.2f} "
        f"GiB, launches {serve_got} (planned {serve_want}), tokens "
        f"{tuple(tokens.shape)} in range={in_range} "
        f"flagged={int(flags.sum())} {'ok' if serve_ok else 'FAIL'}")
    return res, train_ok and serve_ok


# ---------------------------------------------------------------------------
# phases 15-18: the overlap schedule (K5/K6) and int8 tables when sharded
# ---------------------------------------------------------------------------

def pair_cases(cfg):
    """(label, S, n_local, strides, k, in_width, fold, int8) of the K5/K6
    cases: the q/k/v/o pair of ``with_feature_sharding(cfg, 4)`` (n_local
    512, 9 stages, k=1, d_in folded, the schedule going on to cross k=2),
    the same operator's pair over 2 shards (n_local 1024, 10 stages), which
    ends its schedule (d_out and bias folded, the t sums), a windowed first
    run (the input n - n_local/2 wide, 1792: shard 3 straddles), and the
    q/k/v/o pair with an int8 table."""
    from repro_torch.configs import with_feature_sharding
    from repro_torch.core.eligibility import plan_steps
    out = []
    for S, label, win, fold, q8 in ((4, "qkvo", False, False, False),
                                    (2, "S=2 end", False, True, False),
                                    (4, "window", True, False, False),
                                    (4, "int8 table", False, False, True)):
        spm = with_feature_sharding(cfg, S).attn_cfg(
            cfg.layers[0]).o_proj.spm_config()
        steps = plan_steps(spm.n, spm.pairing.strides(), S)
        assert steps[0][0] == "local" and steps[1] == ("cross",
                                                        steps[1][1], 1)
        assert (len(steps) == 2) == fold, steps
        nl = spm.n // S
        out.append((label, S, nl, steps[0][2], 1,
                    spm.n - nl // 2 if win else None, fold, q8))
    return out


def run_pair_kernel_phase(torch, K, Q, timer, cfg):
    """K5 and K6 against their plain versions on the card (``pair_cases``)
    at 4096 and 8 rows, bf16 and f32: K5 bit for bit (every product and
    sum rounds as the plain version's eager ops do), K6's g_x bit for bit
    and its table grads and s, t and g_din sums within gamma_rows of the
    sum of their terms' magnitudes (as phase 5); second launches bitwise.
    Times (in bf16; the f32 cases are checked, not timed), bounds, and as
    yardstick the S/2 dense products of the pair step, ``(B, 2 n_local) @
    (2 n_local, 2 n_local)`` (K6: the two of their backward), one batched
    ``torch.matmul`` each.  Then K1's and K2's windowed mode with an int8
    table at the gate/up shard shapes (phase 12's cases, the table
    quantized per stage of the shard), held as phase 12 holds them."""
    rows_out, failures = [], []
    g = torch.Generator(device=DEVICE).manual_seed(97531)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=DEVICE)

    def mix(*lead):
        th = (torch.rand(*lead, generator=g, device=DEVICE) * 2 - 1) \
            * math.pi
        c, s_ = torch.cos(th), torch.sin(th)
        return (torch.stack([c, -s_, s_, c], dim=-1)
                + rnd(*lead, 4, scale=0.05)).contiguous()

    abs_sum = (lambda t: t.abs().sum(0))
    for label, S, nl, strides, k, in_w, fold, q8 in pair_cases(cfg):
        n, L = S * nl, len(strides)
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).split(".")[-1]
            esz = torch.tensor([], dtype=dt).element_size()
            for rows in (4096, 8):
                cf, scale = mix(S, L, nl // 2), None
                cf_bytes = S * L * nl // 2 * 16
                if q8:
                    q, scale = Q.quantize_coeffs(cf.reshape(S * L, nl // 2,
                                                            4))
                    cf, scale = q.reshape(S, L, nl // 2, 4), \
                        scale.reshape(S, L)
                    cf_bytes = S * L * (nl // 2 * 4 + 4)
                ma, mb, u, v = (1 + 0.1 * rnd(n) for _ in range(4))
                d_in = 1 + 0.1 * rnd(n)
                d_out = 1 + 0.1 * rnd(n) if fold else None
                bias = 0.1 * rnd(n) if fold else None
                x = rnd(rows, in_w or n).to(dt)
                gy = rnd(rows, n).to(dt)
                kw = dict(strides=strides, n_tile=nl, k=k, in_width=in_w)
                fwd = (x, cf, ma, mb, d_in, d_out, bias, scale)
                bwd = (x, cf, gy, u, v, d_in, d_out, scale)
                y = K.spm_overlap_kernel_call(*fwd, **kw)
                y2 = K.spm_overlap_kernel_call(*fwd, **kw)
                yp = K.spm_overlap_plain(*fwd, **kw)
                gk = K.spm_overlap_bwd_kernel_call(*bwd, **kw)
                gk2 = K.spm_overlap_bwd_kernel_call(*bwd, **kw)
                gp = K.spm_overlap_bwd_plain(*bwd, **kw)
                gm = K.spm_overlap_bwd_plain(*bwd, col_sum=abs_sum, **kw)
                torch.cuda.synchronize()
                k5_err = (y.float() - yp.float()).abs().max().item()
                gx_err = (gk[0].float() - gp[0].float()).abs().max().item()
                worst = grads_within(gk[1:], gp[1:], gm[1:], rows)
                det = torch.equal(y, y2) and all(
                    torch.equal(a, b) for a, b in zip(gk, gk2))
                # the yardstick: the pair step's S/2 dense 2 n_local maps
                xb = torch.randn(S // 2, rows, 2 * nl, generator=g,
                                 device=DEVICE).to(dt)
                w = torch.randn(S // 2, 2 * nl, 2 * nl, generator=g,
                                device=DEVICE).to(dt)
                gb = torch.randn(S // 2, rows, 2 * nl, generator=g,
                                 device=DEVICE).to(dt)
                live = min(in_w or n, n)
                vec5 = 3 + (2 if fold else 0)
                tm = timer if dt == torch.bfloat16 else untimed
                k5 = dict(ms=tm(lambda: K.spm_overlap_kernel_call(
                    *fwd, **kw)),
                    plain_ms=tm(lambda: K.spm_overlap_plain(*fwd, **kw)),
                    library_ms=tm(lambda: torch.matmul(xb, w)))
                k6 = dict(ms=tm(lambda: K.spm_overlap_bwd_kernel_call(
                    *bwd, **kw)),
                    plain_ms=tm(lambda: K.spm_overlap_bwd_plain(
                        *bwd, **kw)),
                    library_ms=tm(lambda: (
                        torch.matmul(gb, w.transpose(1, 2)),
                        torch.matmul(xb.transpose(1, 2), gb))))
                # K5 reads x's live columns, the tables and the vectors and
                # writes y; K6 reads x, gy, the tables and vectors, writes
                # g_x, the tables' grads (f32) and its vector sums
                n_sums = 2 + 1 + (2 if fold else 0)
                k5["bound_ms"], k5["bound_by"] = bound(
                    rows * (live + n) * esz + cf_bytes + vec5 * 4 * n,
                    rows * n * (3 * L + 4 + (2 if fold else 0)))
                k6["bound_ms"], k6["bound_by"] = bound(
                    rows * (live + 2 * n) * esz + cf_bytes
                    + S * L * nl // 2 * 16 + (3 + fold) * 4 * n
                    + n_sums * 4 * n, rows * n * (10 * L + 14))
                ok5 = k5_err == 0 and bool(torch.isfinite(y.float()).all())
                ok6 = gx_err == 0 and worst <= 1 and all(
                    bool(torch.isfinite(t.float()).all()) for t in gk)
                common = dict(case=label, dtype=dname, rows=rows, shards=S,
                              n_local=nl, stages=L, k=k, in_width=in_w,
                              folds_d_out=fold, int8_table=q8,
                              deterministic=det, launches_per_call=1)
                rows_out.append(dict(common, kernel="K5",
                                     max_abs_err=k5_err, ok=ok5 and det,
                                     **k5))
                rows_out.append(dict(common, kernel="K6",
                                     gx_max_abs_err=gx_err,
                                     max_abs_err=max(gx_err, max(
                                         (a - b).abs().max().item()
                                         for a, b in zip(gk[1:], gp[1:]))),
                                     grad_err_over_limit=worst,
                                     ok=ok6 and det, **k6))
                log(f"pair {label:10s} S={S} n_local={nl} L={L} {dname:8s} "
                    f"rows={rows:5d} | K5 err={k5_err:.1e} "
                    f"ms={fmt_ms(k5['ms'])} "
                    f"plain_ms={fmt_ms(k5['plain_ms'])} "
                    f"bound_ms={k5['bound_ms']:.4f} ({k5['bound_by']}) "
                    f"library_ms={fmt_ms(k5['library_ms'])} | K6 "
                    f"gx_err={gx_err:.1e} grad err/limit={worst:.3f} "
                    f"ms={fmt_ms(k6['ms'])} "
                    f"plain_ms={fmt_ms(k6['plain_ms'])} "
                    f"bound_ms={k6['bound_ms']:.4f} ({k6['bound_by']}) "
                    f"library_ms={fmt_ms(k6['library_ms'])} "
                    f"det={det} {'ok' if ok5 and ok6 and det else 'FAIL'}")
                if not (ok5 and ok6 and det):
                    failures.append(f"pair {label} {dname} rows={rows}")
    # K1 / K2 windowed with an int8 table: the gate/up shards
    from repro_torch.configs import with_feature_sharding
    lin = with_feature_sharding(cfg, SHARDS).ffn_cfg().up
    spm = lin.spm_config()
    in_w = lin.d_in
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        esz = torch.tensor([], dtype=dt).element_size()
        for rows in (4096, 8):
            nl, steps, plans = shard_run(spm, rows)
            (rs, nt), = plans[0]
            L = len(rs)
            for shard in range(spm.n_shards):
                base = shard * nl // nt
                live = max(0, min(nl, in_w - shard * nl))
                q, scale = Q.quantize_coeffs(mix(L, nl // 2))
                d_in, d_out, b = 1 + 0.1 * rnd(nl), 1 + 0.1 * rnd(nl), \
                    0.1 * rnd(nl)
                x = rnd(rows, in_w).to(dt)
                gy = rnd(rows, nl).to(dt)
                kw = dict(coeff_scale=scale, strides=rs, n_tile=nt,
                          in_width=in_w, col_base=base)
                bw = dict(kw, has_bias=True)
                y = K.spm_stack_kernel_call(x, q, d_in, d_out, b, **kw)
                y2 = K.spm_stack_kernel_call(x, q, d_in, d_out, b, **kw)
                yp = K.spm_stack_plain(x, q, d_in, d_out, b, **kw)
                gk = K.spm_stack_bwd_kernel_call(x, q, gy, d_in, d_out, **bw)
                gk2 = K.spm_stack_bwd_kernel_call(x, q, gy, d_in, d_out,
                                                  **bw)
                gp = K.spm_stack_bwd_plain(x, q, gy, d_in, d_out, **bw)
                gm = K.spm_stack_bwd_plain(x, q, gy, d_in, d_out,
                                           col_sum=abs_sum, **bw)
                torch.cuda.synchronize()
                k1_err = (y.float() - yp.float()).abs().max().item()
                dead_ok = (shard * nl < in_w
                           or torch.equal(y, b.to(dt).expand(rows, -1)))
                gx_err = (gk[0].float() - gp[0].float()).abs().max().item()
                worst = grads_within(gk[1:], gp[1:], gm[1:], rows)
                zeros = not gk[2][live:].any()
                det = torch.equal(y, y2) and all(
                    torch.equal(a, c) for a, c in zip(gk, gk2))
                w = K.spm_stack_plain(torch.eye(in_w, device=DEVICE), q,
                                      d_in, d_out, None, **kw).to(dt)
                tm = timer if dt == torch.bfloat16 else untimed
                k1 = dict(ms=tm(lambda: K.spm_stack_kernel_call(
                    x, q, d_in, d_out, b, **kw)),
                    plain_ms=tm(lambda: K.spm_stack_plain(
                        x, q, d_in, d_out, b, **kw)),
                    library_ms=tm(lambda: torch.matmul(x, w)))
                k2 = dict(ms=tm(lambda: K.spm_stack_bwd_kernel_call(
                    x, q, gy, d_in, d_out, **bw)),
                    plain_ms=tm(lambda: K.spm_stack_bwd_plain(
                        x, q, gy, d_in, d_out, **bw)),
                    library_ms=tm(lambda: (torch.matmul(gy, w.T),
                                           torch.matmul(x.T, gy))))
                # as phase 12, the table read as int8 codes and L scales
                cfb = L * (nl // 2 * 4 + 4)
                k1["bound_ms"], k1["bound_by"] = bound(
                    rows * (live + nl) * esz + cfb + 3 * 4 * nl,
                    rows * nl * (3 * L + 2))
                k2["bound_ms"], k2["bound_by"] = bound(
                    rows * (live + 2 * nl) * esz + cfb + L * nl // 2 * 16
                    + 5 * 4 * nl, rows * nl * (10 * L + 6))
                ok1 = k1_err == 0 and dead_ok and bool(
                    torch.isfinite(y.float()).all())
                ok2 = gx_err == 0 and worst <= 1 and zeros and all(
                    bool(torch.isfinite(t.float()).all()) for t in gk)
                common = dict(case=f"up shard {shard}", dtype=dname,
                              rows=rows, n=nl, in_width=in_w, n_tile=nt,
                              col_base=base, live_columns=live,
                              deterministic=det, launches_per_call=1)
                rows_out.append(dict(common, kernel="K1 col_base int8",
                                     max_abs_err=k1_err, dead_is_bias=dead_ok,
                                     ok=ok1 and det, **k1))
                rows_out.append(dict(common, kernel="K2 col_base int8",
                                     gx_max_abs_err=gx_err,
                                     max_abs_err=max(gx_err, max(
                                         (a - c).abs().max().item()
                                         for a, c in zip(gk[1:], gp[1:]))),
                                     grad_err_over_limit=worst,
                                     dead_lane_grads_zero=zeros,
                                     ok=ok2 and det, **k2))
                log(f"col_base int8 up s{shard} {dname:8s} rows={rows:5d} "
                    f"live={live:4d} | K1 err={k1_err:.1e} dead=bias:"
                    f"{dead_ok} ms={fmt_ms(k1['ms'])} "
                    f"plain_ms={fmt_ms(k1['plain_ms'])} "
                    f"bound_ms={k1['bound_ms']:.4f} ({k1['bound_by']}) "
                    f"library_ms={fmt_ms(k1['library_ms'])} | K2 "
                    f"gx_err={gx_err:.1e} grad err/limit={worst:.3f} "
                    f"zeros={zeros} ms={fmt_ms(k2['ms'])} "
                    f"plain_ms={fmt_ms(k2['plain_ms'])} "
                    f"bound_ms={k2['bound_ms']:.4f} ({k2['bound_by']}) "
                    f"library_ms={fmt_ms(k2['library_ms'])} "
                    f"det={det} {'ok' if ok1 and ok2 and det else 'FAIL'}")
                if not (ok1 and ok2 and det):
                    failures.append(f"col_base int8 up shard {shard} "
                                    f"{dname} rows={rows}")
    return rows_out, failures


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from the repository (src/repro_torch "
              "missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.configs import with_feature_sharding, with_quantized_io
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import quant as Q
    from repro_torch import train as train_mod
    from repro_torch.kernels import spm_stack as K
    from repro_torch.launch import train as launch_train
    from repro_torch.models import causal_lm as LM
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    secs = build.build_all()
    build.load_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    phase_s = {}

    def phase(tag, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[tag] = time.perf_counter() - t
        log(f"phase {tag}: {phase_s[tag]:.1f} s")
        return out

    timer = Timer(torch)
    kernel_rows, failures = phase("2", run_kernel_phase, torch, K, ops,
                                  timer)
    cfg = get_config("qwen3-1.7b")
    params, serve, serve_ok, served = phase(
        "3", run_serve_phase, torch, K, ops, T, ServeEngine, cfg)
    parity, parity_ok = phase("4", run_parity_phase, torch, LM, cfg, params,
                              *served)
    del params, served
    bwd_rows, bwd_failures = phase("5", run_bwd_kernel_phase, torch, K, ops,
                                   timer)
    kernel_rows += bwd_rows
    failures += bwd_failures
    train, train_ok = phase("6", run_train_phase, torch, K, ops,
                            launch_train, cfg)
    tparity, tparity_ok, _ = phase("7", run_train_parity_phase, torch, T,
                                   LM, train_mod, adamw, cfg)
    q8_rows, q8_failures = phase("8", run_q8_kernel_phase, torch, K, ops, Q,
                                 timer)
    kernel_rows += q8_rows
    failures += q8_failures
    nonfinite = phase("8 nonfinite", run_q8_nonfinite_case, torch, K, ops,
                      Q)
    if not nonfinite["ok"]:
        failures.append("int8 nonfinite")
    qcfg = with_quantized_io(cfg)
    q8_train, q8_train_ok = phase("9", run_train_phase, torch, K, ops,
                                  launch_train, cfg, quantize=True)
    q8_tparity, q8_tparity_ok = phase(
        "10", run_q8_train_parity_phase, torch, T, LM, train_mod, adamw,
        qcfg)
    q8_serve, q8_serve_ok = phase("11", run_q8_serve_phase, torch, K, ops,
                                  T, LM, ServeEngine, qcfg)
    win_rows, win_failures = phase("12", run_window_kernel_phase, torch, K,
                                   timer, with_feature_sharding(cfg, SHARDS))
    kernel_rows += win_rows
    failures += win_failures
    sharded, sharded_ok = phase(
        "13", run_sharded_phase, torch, K, T, LM, train_mod, adamw,
        ServeEngine, launch_train, cfg, dict(train, label="unsharded"))
    sparity, sparity_ok, sharded_cpu = phase(
        "14", run_train_parity_phase, torch, T, LM, train_mod, adamw, cfg,
        shards=SHARDS)
    pair_rows, pair_failures = phase("15", run_pair_kernel_phase, torch, K,
                                     Q, timer, cfg)
    kernel_rows += pair_rows
    failures += pair_failures
    overlap, overlap_ok = phase(
        "16", run_sharded_phase, torch, K, T, LM, train_mod, adamw,
        ServeEngine, launch_train, cfg,
        dict(sharded, label="step-serial sharded"), overlap=True,
        label="overlap")
    q8_overlap, q8_overlap_ok = phase(
        "17", run_sharded_phase, torch, K, T, LM, train_mod, adamw,
        ServeEngine, launch_train, cfg, dict(overlap, label="overlap"),
        steps=3, poisoned=None, overlap=True, quant=True, serve=False,
        trace=False, label="int8 overlap")
    oparity, oparity_ok, _ = phase(
        "18", run_train_parity_phase, torch, T, LM, train_mod, adamw, cfg,
        shards=SHARDS, overlap=True, cpu_side=sharded_cpu)
    del sharded_cpu

    def head(kernel, case, dtype, rows, mode=None):
        return next(r for r in kernel_rows if (r["kernel"], r["case"],
                                               r["dtype"], r["rows"],
                                               r.get("mode"))
                    == (kernel, case, dtype, rows, mode))

    k1 = head("K1", "o", "bfloat16", 4096)
    k3 = head("K3", "q", "bfloat16", 4096)
    k2 = head("K2", "o", "bfloat16", 4096)
    k4 = head("K4", "q", "bfloat16", 4096)
    k1q = head("K1 int8", "o", "int8", 4096, "both")
    k2q = head("K2 int8", "o", "int8", 4096, "both")
    k1w = head("K1 col_base", "up shard 0", "bfloat16", 4096)
    k2w = head("K2 col_base", "up shard 0", "bfloat16", 4096)
    k5 = head("K5", "qkvo", "bfloat16", 4096)
    k6 = head("K6", "qkvo", "bfloat16", 4096)
    k1wq = head("K1 col_base int8", "up shard 0", "bfloat16", 4096)
    k2wq = head("K2 col_base int8", "up shard 0", "bfloat16", 4096)
    entries = []
    # launches: K1 and K3 from the serve phase (their main path), K2 and
    # K4 from the train phase (theirs); train_launches has all four
    for name, r, src, rep, launches in (
            ("K1 spm_stack_fwd", k1,
             "src/repro_torch/kernels/csrc/spm_stack.cu",
             "src/repro/kernels/spm_stack.py:157", serve["launches"]),
            ("K2 spm_stack_bwd", k2,
             "src/repro_torch/kernels/csrc/spm_stack_bwd.cu",
             "src/repro/kernels/spm_stack.py:523", train["launches"]),
            ("K3 spm_block_fwd", k3,
             "src/repro_torch/kernels/csrc/spm_block.cu",
             "src/repro/kernels/spm_stack.py:873", serve["launches"]),
            ("K4 spm_block_bwd", k4,
             "src/repro_torch/kernels/csrc/spm_block_bwd.cu",
             "src/repro/kernels/spm_stack.py:925", train["launches"]),
            # int8 modes: launches from the --quantize train phase
            ("K1 int8 spm_stack_fwd", k1q,
             "src/repro_torch/kernels/csrc/spm_stack.cu",
             "src/repro/kernels/spm_stack.py:157", q8_train["launches"]),
            ("K2 int8 spm_stack_bwd", k2q,
             "src/repro_torch/kernels/csrc/spm_stack_bwd.cu",
             "src/repro/kernels/spm_stack.py:523", q8_train["launches"]),
            # windowed modes: launches from the sharded train phase
            ("K1 col_base spm_stack_fwd", k1w,
             "src/repro_torch/kernels/csrc/spm_stack.cu",
             "src/repro/kernels/spm_stack.py:393", sharded["launches"]),
            ("K2 col_base spm_stack_bwd", k2w,
             "src/repro_torch/kernels/csrc/spm_stack_bwd.cu",
             "src/repro/kernels/spm_stack.py:664", sharded["launches"])):
        key = name.rsplit(" ", 1)[0]
        by = (q8_train if "int8" in key else
              sharded if "col_base" in key else train)
        entries.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[key],
            train_launches=by["launches"][key],
            max_abs_err=max(x["max_abs_err"] for x in kernel_rows
                            if x["kernel"] == key),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    # the pair kernels: launches from the overlap train phase; the windowed
    # int8-table modes from the int8 overlap phase, whose every K1/K2
    # launch read an int8 table (held to the plan)
    q8l = q8_overlap["launches"]
    for name, key, r, src, rep_, launches in (
            ("K5 spm_overlap_fwd", "K5", k5,
             "src/repro_torch/kernels/csrc/spm_overlap.cu",
             "src/repro/kernels/spm_stack.py:1319",
             overlap["launches"]["K5"]),
            ("K6 spm_overlap_bwd", "K6", k6,
             "src/repro_torch/kernels/csrc/spm_overlap_bwd.cu",
             "src/repro/kernels/spm_stack.py:1479",
             overlap["launches"]["K6"]),
            ("K1 col_base int8 spm_stack_fwd", "K1 col_base int8", k1wq,
             "src/repro_torch/kernels/csrc/spm_stack.cu",
             "src/repro/kernels/spm_stack.py:393",
             q8l["K1 col_base"] if q8l["K1 int8"] == q8l["K1"] else 0),
            ("K2 col_base int8 spm_stack_bwd", "K2 col_base int8", k2wq,
             "src/repro_torch/kernels/csrc/spm_stack_bwd.cu",
             "src/repro/kernels/spm_stack.py:664",
             q8l["K2 col_base"] if q8l["K2 int8"] == q8l["K2"] else 0)):
        entries.append(dict(
            name=name, route="cuda", source=src, replaces=rep_,
            launches=launches,
            max_abs_err=max(x["max_abs_err"] for x in kernel_rows
                            if x["kernel"] == key),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    report = dict(gpu=smi, kernels=kernel_rows, serve=serve, parity=parity,
                  train=train, train_parity=tparity, int8_nonfinite=nonfinite,
                  int8_train=q8_train,
                  int8_train_parity=q8_tparity, int8_serve=q8_serve,
                  sharded=sharded, sharded_train_parity=sparity,
                  overlap=overlap, int8_overlap=q8_overlap,
                  overlap_train_parity=oparity,
                  seconds=time.perf_counter() - t_start,
                  phase_seconds=phase_s,
                  headline_shapes={"K1": "o projection, bf16, 4096 rows",
                                   "K2": "o projection, bf16, 4096 rows",
                                   "K3": "q projection, bf16, 4096 rows",
                                   "K4": "q projection, bf16, 4096 rows",
                                   "K1 int8": "o projection, int8 "
                                              "activations and table, 4096 "
                                              "rows",
                                   "K2 int8": "the same",
                                   "K1 col_base": "gate/up shard 0 of 4 "
                                                  "(n_local 1536 of "
                                                  "in_width 2048), bf16, "
                                                  "4096 rows",
                                   "K2 col_base": "the same",
                                   "K5": "q/k/v/o pair over 4 shards "
                                         "(n_local 512, 9 stages, k=1), "
                                         "bf16, 4096 rows",
                                   "K6": "the same",
                                   "K1 col_base int8": "gate/up shard 0 "
                                                       "with an int8 table, "
                                                       "bf16, 4096 rows",
                                   "K2 col_base int8": "the same"})
    os.makedirs(os.path.join(HERE, "out"), exist_ok=True)
    with open(os.path.join(HERE, "out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    ok = (not failures and serve_ok and parity_ok and train_ok
          and tparity_ok and q8_train_ok and q8_tparity_ok and q8_serve_ok
          and sharded_ok and sparity_ok and overlap_ok and q8_overlap_ok
          and oparity_ok)
    log(f"total {report['seconds']:.1f} s")
    if not ok:
        print(f"chip_smoke: FAILED kernels={failures} serve={serve_ok} "
              f"parity={parity_ok} train={train_ok} "
              f"train_parity={tparity_ok} int8_train={q8_train_ok} "
              f"int8_train_parity={q8_tparity_ok} "
              f"int8_serve={q8_serve_ok} sharded={sharded_ok} "
              f"sharded_train_parity={sparity_ok} overlap={overlap_ok} "
              f"int8_overlap={q8_overlap_ok} "
              f"overlap_train_parity={oparity_ok}", file=sys.stderr)
        return 1
    log(f"kernels: {[e['name'] for e in entries]}")
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
