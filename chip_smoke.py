#!/usr/bin/env python3
"""Drive the PyTorch port on one GPU and hold its kernels to their plain
versions.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. **Build** K1 (``csrc/spm_stack.cu``) and K3 (``csrc/spm_block.cu``) from
   the checkout with ``nvcc`` for ``sm_90a``, all sources at once.
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

The line before the last lists the kernels as one JSON object; the last
line is ``{"ok": true, "device": {...}}``.  Without a GPU, or run away from
the repository, the script exits non-zero and prints no result.  The full
per-shape table goes to ``out/chip_smoke.json``.
"""

from __future__ import annotations

import copy
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


def main() -> int:
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
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import spm_stack as K
    from repro_torch.models import causal_lm as LM
    from repro_torch.models import transformer as T
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

    timer = Timer(torch)
    kernel_rows, failures = run_kernel_phase(torch, K, ops, timer)
    cfg = get_config("qwen3-1.7b")
    params, serve, serve_ok, served = run_serve_phase(
        torch, K, ops, T, ServeEngine, cfg)
    parity, parity_ok = run_parity_phase(torch, LM, cfg, params, *served)

    def head(kernel, case, dtype, rows):
        return next(r for r in kernel_rows if (r["kernel"], r["case"],
                                               r["dtype"], r["rows"])
                    == (kernel, case, dtype, rows))

    k1 = head("K1", "o", "bfloat16", 4096)
    k3 = head("K3", "q", "bfloat16", 4096)
    entries = []
    for name, r, src, rep in (
            ("K1 spm_stack_fwd", k1,
             "src/repro_torch/kernels/csrc/spm_stack.cu",
             "src/repro/kernels/spm_stack.py:157"),
            ("K3 spm_block_fwd", k3,
             "src/repro_torch/kernels/csrc/spm_block.cu",
             "src/repro/kernels/spm_stack.py:873")):
        entries.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=serve["launches"][name[:2]],
            max_abs_err=max(x["max_abs_err"] for x in kernel_rows
                            if x["kernel"] == name[:2]),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    report = dict(gpu=smi, kernels=kernel_rows, serve=serve, parity=parity,
                  headline_shapes={"K1": "o projection, bf16, 4096 rows",
                                   "K3": "q projection, bf16, 4096 rows"})
    os.makedirs(os.path.join(HERE, "out"), exist_ok=True)
    with open(os.path.join(HERE, "out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    ok = not failures and serve_ok and parity_ok
    if not ok:
        print(f"chip_smoke: FAILED kernels={failures} serve={serve_ok} "
              f"parity={parity_ok}", file=sys.stderr)
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
