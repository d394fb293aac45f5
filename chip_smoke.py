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
   K3 within two I/O ulps of each element plus a derived f32 term, and,
   given its own rstd, bit for bit a composition of plain pieces
   (``k3_composition``) wherever no silu or gelu sits between its stacks.
   Also the kernel's and the plain version's time, the bound (the
   function's bytes over 3.35 TB/s or its f32 operations over 67 TFLOP/s,
   whichever is larger) and a yardstick the port never calls: for K1 a
   dense ``torch.matmul`` of the same map, for K3's one-stack forms
   ``torch.matmul(F.rms_norm(x), W)``.  Each K1 and K3 time (here and in
   phases 8, 12 and 15, K5's too) is logged beside the previous design's
   (``PREV_MS``), each case with its launch shape
   (``kernels.spm_stack.fwd_plan``, K3 its block form) and, for K1 and
   K5, the clusters of that shape the card holds at once; second launches
   bitwise.
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
   gamma_k times the sum of its terms' magnitudes (k rows; lanes past
   out_width exactly 0); a second launch bitwise equal to the first.
   Times as in phase 2, each K2, K4 and K6 time (here and in phases 8,
   12, 15) logged beside the previous design's (``PREV_MS``), K4's with
   its launch shape (``bwd_plan``'s block form); K2's and K4's yardstick
   is the two ``torch.matmul`` of a dense linear's backward (for each
   linear of K4's block).
   Then (``5 ragged``) K2 and K6 in every mode at 4072 rows (no chunk or
   row group of the backward engine comes out even) and 8, untimed, held
   to the same criteria; and (``5 block ragged``) K3 and K4 in the q, k/v
   and two-stack forms at 4072 rows and one row, bf16 and f32, held as
   phases 2 and 5 hold them.
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
   Then (``15 ragged``) K1 and K5 in every mode at 4072 rows (no chunk or
   row group of the forward engine comes out even) and one row, bf16 and
   f32, untimed: bit for bit, second launches bitwise.
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
19. **The paper's own models** (``configs/paper.py``, ``models/mlp.py``,
   ``models/gru_lm.py``, the char-LM of
   ``benchmarks/torch_table34_charlm.py``), f32.  K1 and K2 against their
   plain versions at every run those models give them
   (``paper_kernel_cases``: tiles of 256-2048 at 256 rows, 12 stages on
   2048, the 4096 split into 11 stages on 2048 then stride 2048 on 4096 at
   256 and 4096 rows, one 12-stage run on a 4096 tile at 8 rows), held as
   phases 2 and 5, timed beside ``torch.matmul`` with the same map.  One
   training step of the Table 1 student (w=256), the Table 2 student
   (w=4096), the char-LM (d=4096, B=4, T=32) and the GRU-LM
   (``spm_rotation``, d=4096, B=4, T=16) on the card against the CPU
   within phase 7's f32 bound, K1/K2 launches as planned; the teacher's
   labels equal wherever the top-two gap exceeds the bound.  Then timed
   steps (``benchmarks/torch_common.time_step``) of every model, dense and
   SPM, at the paper's sizes (Table 1 w=256-2048 and Table 2 w=2048, 4096
   at batch 256; the char-LM d=4096, B=32, T=128; the GRU-LM SPM only, 3
   steps): ms a step, rows or tokens a second, dense/SPM, peak memory,
   K1/K2 launches equal to ``plan_runs_for_rows``'s runs a step.

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


def k3_composition(torch, K, x, rstd, kw):
    """K3's function given its rstd, composed of plain pieces: ((x rstd)
    gamma) d_in1 rounded in that order, ``spm_stack_plain`` with d_out1 and
    bias1, the mid_width mask and the activation, stack 2 through
    ``spm_stack_plain``, the residual, the store.  Only the row's sum of
    squares (rstd) is the kernel's own, so it holds the stage walk bit for
    bit."""
    n = 2 * kw["coeffs1"].shape[1]
    lane = torch.arange(n, device=x.device)
    xr = torch.nn.functional.pad(x.float(), (0, n - kw["in_width"]))
    z = (xr * rstd * kw["gamma"]) * kw["d_in1"]
    z = K.spm_stack_plain(z, kw["coeffs1"], None, kw["d_out1"],
                          kw.get("bias1"), strides=kw["strides1"])
    two = kw.get("strides2") is not None
    if two or kw.get("activation") is not None:
        z = K._act(torch.where(lane < kw["mid_width"], z, 0.0),
                   kw.get("activation"))
    if two:
        z = K.spm_stack_plain(z, kw["coeffs2"], kw["d_in2"], kw["d_out2"],
                              kw.get("bias2"), strides=kw["strides2"])
    if kw.get("residual"):
        z = z + xr
    return z[:, :kw["out_width"]].to(x.dtype)


def block_plans(K, rows, n, kw, io_bytes):
    """K3's and K4's launch shapes (``fwd_plan``'s and ``bwd_plan``'s block
    forms) of a case, as dicts."""
    s2 = kw.get("strides2")
    f = K.fwd_plan(rows, n, kw["strides1"], 1, io_bytes, block=True,
                   strides2=s2, norm=kw.get("gamma") is not None)
    b = K.bwd_plan(rows, n, kw["strides1"], 1, io_bytes, block=True,
                   strides2=s2, norm=kw.get("gamma") is not None)
    return f._asdict(), b._asdict()


def bwd_plan_str(p) -> str:
    """A backward launch shape in a few characters: lane blocks, threads,
    rows a chunk, row groups, stacks streamed from device memory."""
    return (f"C{p['lane_blocks']} T{p['threads']} R{p['chunk_rows']} "
            f"G{p['groups']}{' streamed ' + str(p['streamed']) if p['streamed'] else ''}")


def run_kernel_phase(torch, K, ops, timer):
    """K1 is held bit for bit: its kernel rounds every product and sum on
    its own (``__fmul_rn``/``__fadd_rn``), as the plain version's eager
    ops do, and sums nothing else.  K3 is held within two ulps of the I/O
    type at each element plus ``k3_f32_term``, and, given its own rstd,
    bit for bit to ``k3_composition`` wherever no silu or gelu sits between
    the stacks (CUDA's expf/tanhf are not PyTorch's)."""
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
            again = chain(K.spm_stack_kernel_call)
            ok = (err == 0 and torch.equal(kern, again)
                  and bool(torch.isfinite(kern.float()).all()))
            plans = [fwd_plan_of(K, rows, kw["n_tile"], kw["strides"],
                                 -(-(kw["out_width"] or n) // kw["n_tile"]),
                                 x.element_size()) for kw in launches]
            prev = prev_ms("K1", label, dname, rows)
            # clusters of the first run's shape the card holds at once
            held = K.fwd_clusters_resident(
                "K1", dt, launches[0]["strides"], launches[0]["n_tile"],
                K.FwdPlan(**plans[0]))
            ok = ok and held >= 1
            rows_out.append(dict(
                kernel="K1", case=label, dtype=dname, rows=rows, n=n,
                in_width=in_w, out_width=out_w,
                runs=[[list(rs), nt] for rs, nt in runs], fwd_plans=plans,
                clusters_resident=held,
                launches_per_call=len(runs), max_abs_err=err, tol=0.0,
                out_scale=scale, ms=ms, prev_ms=prev, plain_ms=plain_ms,
                bound_ms=bms, bound_by=bby, plan_bound_ms=plan_bms,
                library_ms=lib_ms, ok=ok))
            log(f"K1 {label:5s} {dname:8s} rows={rows:5d} runs={len(runs)} "
                f"err={err:.3e} tol=0 max|y|={scale:.3f} ms={ms:.4f} "
                f"(before {fmt_ms(prev)}) "
                f"plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({bby}) "
                f"plan_bound_ms={plan_bms:.4f} library_ms={lib_ms:.4f} "
                f"plans={[plan_str(q) for q in plans]} resident clusters="
                f"{held} {'ok' if ok else 'FAIL'}")
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
            again, _ = K.spm_block_kernel_call(x, **kw)
            plain, rstd_p = K.spm_block_plain(x, **kw)
            comp = k3_composition(torch, K, x, rstd_k, kw)
            torch.cuda.synchronize()
            bitwise = torch.equal(kern, comp)
            comp_err = (kern.float() - comp.float()).abs().max().item()
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
            # yardstick (one stack): the norm and one dense product with
            # the same operator, torch.matmul(F.rms_norm(x), W)
            lib_ms = None
            if not two:
                W = K.spm_stack_plain(torch.eye(n, device=DEVICE),
                                      kw["coeffs1"], kw["d_in1"],
                                      kw["d_out1"], strides=strides)
                W = W[:, :out_w].to(dt).contiguous()
                gam = kw["gamma"].to(dt)
                lib_ms = timer(lambda: torch.matmul(
                    torch.nn.functional.rms_norm(x, (n,), gam, eps=1e-6), W))
            exact = act in (None, "relu")
            ok = (worst <= 1 and rerr <= rtol and (bitwise or not exact)
                  and torch.equal(kern, again)
                  and bool(torch.isfinite(kern.float()).all()))
            prev = prev_ms("K3", label, dname, rows)
            fplan, _ = block_plans(K, rows, n, kw, x.element_size())
            rows_out.append(dict(
                kernel="K3", case=label, dtype=dname, rows=rows, n=n,
                prev_ms=prev, fwd_plan=fplan,
                in_width=n, out_width=out_w, activation=act,
                two_stacks=two, launches_per_call=1, max_abs_err=err,
                err_over_limit=worst, tol_f32_term=t32, tol_ulps=2,
                bitwise_given_rstd=bitwise, composition_max_abs_err=comp_err,
                out_scale=scale, rstd_rel_err=rerr, rstd_rtol=rtol, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                library_ms=lib_ms, ok=ok))
            log(f"K3 {label:8s} {dname:8s} rows={rows:5d} err={err:.3e} "
                f"err/limit={worst:.3f} (2 ulps + {t32:.2e}) max|y|="
                f"{scale:.3f} rstd_rel={rerr:.2e} (tol {rtol:.2e}) "
                f"given rstd: bitwise={bitwise} ({comp_err:.1e}"
                f"{'' if exact else ', expf/tanhf'}) "
                f"ms={ms:.4f} (before {fmt_ms(prev)}) plain_ms={plain_ms:.4f} "
                f"bound_ms={bms:.4f} ({bby}) library_ms={fmt_ms(lib_ms)} "
                f"plan={plan_str(fplan)} {'ok' if ok else 'FAIL'}")
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


# Times of the previous design of each redesigned kernel, from this
# script's runs on an NVIDIA H100 80GB HBM3 at 700.00 W (bf16 unless the key
# says otherwise): (kernel, case, mode, dtype, rows) -> ms, logged beside
# this run's times.  K2 and K6: a block a feature tile and row chunk, the
# table read from L2 and the grad partials read and written in device
# memory every chunk.  K1 and K5: one stage a pass over 8- or 16-row
# blocks, the table read from L2 at every stage.  K3 and K4 (the first
# design, as K1's and K2's; from this script's run of the tree before their
# redesign): K3 one stage a pass over 16-row blocks, K4 a block a row
# chunk with its grad partials in device memory.
PREV_MS = {
    ('K2', 'o', None, 'bfloat16', 4096): 0.702,
    ('K2', 'gate/up', None, 'bfloat16', 4096): 2.256,
    ('K2', 'down', None, 'bfloat16', 4096): 2.3065,
    ('K2', 'up-tiny', None, 'bfloat16', 8): 0.0986,
    ('K2', 'rect-dead', None, 'bfloat16', 1024): 0.2009,
    ('K2', 'o', None, 'float32', 4096): 0.7889,
    ('K2', 'gate/up', None, 'float32', 4096): 2.4407,
    ('K2', 'down', None, 'float32', 4096): 2.5185,
    ('K2', 'up-tiny', None, 'float32', 8): 0.0975,
    ('K2', 'rect-dead', None, 'float32', 1024): 0.2139,
    ('K2 int8', 'o', 'acts', 'int8', 4096): 0.7558,
    ('K2 int8', 'o', 'coeffs', 'bfloat16', 4096): 0.7764,
    ('K2 int8', 'o', 'both', 'int8', 4096): 0.8147,
    ('K2 int8', 'kv', 'both', 'int8', 4096): 0.8079,
    ('K2 int8', 'up-decode', 'both', 'int8', 8): 0.1129,
    ('K2 int8', 'o-4072', 'both', 'int8', 4072): 0.8075,
    ('K2 int8', 'gate/up', 'coeffs', 'bfloat16', 4096): 2.4216,
    ('K2 col_base', 'up shard 0', None, 'bfloat16', 4096): 0.39,
    ('K2 col_base', 'up shard 1', None, 'bfloat16', 4096): 0.3851,
    ('K2 col_base', 'up shard 2', None, 'bfloat16', 4096): 0.3376,
    ('K2 col_base', 'up shard 3', None, 'bfloat16', 4096): 0.3368,
    ('K2 col_base', 'up shard 0', None, 'bfloat16', 8): 0.034,
    ('K2 col_base', 'up shard 1', None, 'bfloat16', 8): 0.0335,
    ('K2 col_base', 'up shard 2', None, 'bfloat16', 8): 0.0313,
    ('K2 col_base', 'up shard 3', None, 'bfloat16', 8): 0.0314,
    ('K2 col_base', 'up shard 0', None, 'float32', 4096): 0.3923,
    ('K2 col_base', 'up shard 1', None, 'float32', 4096): 0.3859,
    ('K2 col_base', 'up shard 2', None, 'float32', 4096): 0.3352,
    ('K2 col_base', 'up shard 3', None, 'float32', 4096): 0.3359,
    ('K2 col_base', 'up shard 0', None, 'float32', 8): 0.0336,
    ('K2 col_base', 'up shard 1', None, 'float32', 8): 0.0334,
    ('K2 col_base', 'up shard 2', None, 'float32', 8): 0.031,
    ('K2 col_base', 'up shard 3', None, 'float32', 8): 0.0316,
    ('K2', 'o shard 0', None, 'bfloat16', 4096): 0.122,
    ('K2', 'o shard 0', None, 'bfloat16', 8): 0.0346,
    ('K2', 'down shard 0', None, 'bfloat16', 4096): 0.3859,
    ('K2', 'down shard 0', None, 'bfloat16', 8): 0.0342,
    ('K6', 'qkvo', None, 'bfloat16', 4096): 0.5772,
    ('K6', 'qkvo', None, 'bfloat16', 8): 0.0454,
    ('K6', 'S=2 end', None, 'bfloat16', 4096): 0.4854,
    ('K6', 'S=2 end', None, 'bfloat16', 8): 0.0394,
    ('K6', 'window', None, 'bfloat16', 4096): 0.5726,
    ('K6', 'window', None, 'bfloat16', 8): 0.0447,
    ('K6', 'int8 table', None, 'bfloat16', 4096): 0.5942,
    ('K6', 'int8 table', None, 'bfloat16', 8): 0.0459,
    ('K2 col_base int8', 'up shard 0', None, 'bfloat16', 4096): 0.437,
    ('K2 col_base int8', 'up shard 1', None, 'bfloat16', 4096): 0.4294,
    ('K2 col_base int8', 'up shard 2', None, 'bfloat16', 4096): 0.3796,
    ('K2 col_base int8', 'up shard 3', None, 'bfloat16', 4096): 0.3791,
    ('K2 col_base int8', 'up shard 0', None, 'bfloat16', 8): 0.0368,
    ('K2 col_base int8', 'up shard 1', None, 'bfloat16', 8): 0.0366,
    ('K2 col_base int8', 'up shard 2', None, 'bfloat16', 8): 0.0347,
    ('K2 col_base int8', 'up shard 3', None, 'bfloat16', 8): 0.0346,
    ('K1', 'o', None, 'bfloat16', 4096): 0.0978,
    ('K1', 'o', None, 'bfloat16', 8): 0.0211,
    ('K1', 'up', None, 'bfloat16', 4096): 0.3372,
    ('K1', 'down', None, 'bfloat16', 4096): 0.3257,
    ('K1', 'up', None, 'bfloat16', 8): 0.0508,
    ('K1', 'down', None, 'bfloat16', 8): 0.0475,
    ('K1', 'o', None, 'float32', 4096): 0.0931,
    ('K1', 'o', None, 'float32', 8): 0.0208,
    ('K1', 'up', None, 'float32', 4096): 0.3546,
    ('K1', 'down', None, 'float32', 4096): 0.3414,
    ('K1', 'up', None, 'float32', 8): 0.0508,
    ('K1', 'down', None, 'float32', 8): 0.0472,
    ('K3', 'q', None, 'bfloat16', 4096): 0.1015,
    ('K3', 'q', None, 'bfloat16', 8): 0.0227,
    ('K3', 'kv', None, 'bfloat16', 4096): 0.0995,
    ('K3', 'kv', None, 'bfloat16', 8): 0.023,
    ('K3', 'ffn-relu', None, 'bfloat16', 256): 0.0378,
    ('K3', 'ffn-silu', None, 'bfloat16', 256): 0.0379,
    ('K3', 'ffn-gelu', None, 'bfloat16', 256): 0.0384,
    ('K3', 'q', None, 'float32', 4096): 0.1038,
    ('K3', 'q', None, 'float32', 8): 0.0232,
    ('K3', 'kv', None, 'float32', 4096): 0.1025,
    ('K3', 'kv', None, 'float32', 8): 0.0233,
    ('K3', 'ffn-relu', None, 'float32', 256): 0.0386,
    ('K3', 'ffn-silu', None, 'float32', 256): 0.0386,
    ('K3', 'ffn-gelu', None, 'float32', 256): 0.0388,
    ('K4', 'q', None, 'bfloat16', 4096): 0.7365,
    ('K4', 'kv', None, 'bfloat16', 4096): 0.7365,
    ('K4', 'ffn-relu-res', None, 'bfloat16', 256): 0.2139,
    ('K4', 'ffn-relu', None, 'bfloat16', 256): 0.2091,
    ('K4', 'ffn-silu-res', None, 'bfloat16', 256): 0.2143,
    ('K4', 'ffn-silu', None, 'bfloat16', 256): 0.2093,
    ('K4', 'ffn-gelu-res', None, 'bfloat16', 256): 0.2145,
    ('K4', 'ffn-gelu', None, 'bfloat16', 256): 0.2114,
    ('K4', 'q', None, 'float32', 4096): 0.8268,
    ('K4', 'kv', None, 'float32', 4096): 0.7687,
    ('K4', 'ffn-relu-res', None, 'float32', 256): 0.2155,
    ('K4', 'ffn-relu', None, 'float32', 256): 0.2123,
    ('K4', 'ffn-silu-res', None, 'float32', 256): 0.215,
    ('K4', 'ffn-silu', None, 'float32', 256): 0.2125,
    ('K4', 'ffn-gelu-res', None, 'float32', 256): 0.2155,
    ('K4', 'ffn-gelu', None, 'float32', 256): 0.2134,
    ('K1 int8', 'o', 'acts', 'int8', 4096): 0.1211,
    ('K1 int8', 'o', 'coeffs', 'bfloat16', 4096): 0.093,
    ('K1 int8', 'o', 'both', 'int8', 4096): 0.123,
    ('K1 int8', 'kv', 'both', 'int8', 4096): 0.118,
    ('K1 int8', 'up-decode', 'both', 'int8', 8): 0.0586,
    ('K1 int8', 'o-4072', 'both', 'int8', 4072): 0.1232,
    ('K1 int8', 'gate/up', 'coeffs', 'bfloat16', 4096): 0.3489,
    ('K1 col_base', 'up shard 0', None, 'bfloat16', 4096): 0.0687,
    ('K1 col_base', 'up shard 1', None, 'bfloat16', 4096): 0.061,
    ('K1 col_base', 'up shard 2', None, 'bfloat16', 4096): 0.0585,
    ('K1 col_base', 'up shard 3', None, 'bfloat16', 4096): 0.0586,
    ('K1 col_base', 'up shard 0', None, 'bfloat16', 8): 0.0144,
    ('K1 col_base', 'up shard 1', None, 'bfloat16', 8): 0.0142,
    ('K1 col_base', 'up shard 2', None, 'bfloat16', 8): 0.0146,
    ('K1 col_base', 'up shard 3', None, 'bfloat16', 8): 0.0142,
    ('K1 col_base', 'up shard 0', None, 'float32', 4096): 0.0712,
    ('K1 col_base', 'up shard 1', None, 'float32', 4096): 0.0596,
    ('K1 col_base', 'up shard 2', None, 'float32', 4096): 0.0584,
    ('K1 col_base', 'up shard 3', None, 'float32', 4096): 0.0582,
    ('K1 col_base', 'up shard 0', None, 'float32', 8): 0.0142,
    ('K1 col_base', 'up shard 1', None, 'float32', 8): 0.0141,
    ('K1 col_base', 'up shard 2', None, 'float32', 8): 0.0144,
    ('K1 col_base', 'up shard 3', None, 'float32', 8): 0.0141,
    ('K1', 'o shard 0', None, 'bfloat16', 4096): 0.0264,
    ('K1', 'o shard 0', None, 'bfloat16', 8): 0.0113,
    ('K1', 'down shard 0', None, 'bfloat16', 4096): 0.0684,
    ('K1', 'down shard 0', None, 'bfloat16', 8): 0.0141,
    ('K5', 'qkvo', None, 'bfloat16', 4096): 0.0947,
    ('K5', 'qkvo', None, 'bfloat16', 8): 0.0136,
    ('K5', 'qkvo', None, 'float32', 4096): 0.1181,
    ('K5', 'qkvo', None, 'float32', 8): 0.0133,
    ('K5', 'S=2 end', None, 'bfloat16', 4096): 0.1022,
    ('K5', 'S=2 end', None, 'bfloat16', 8): 0.0153,
    ('K5', 'S=2 end', None, 'float32', 4096): 0.1562,
    ('K5', 'S=2 end', None, 'float32', 8): 0.0152,
    ('K5', 'window', None, 'bfloat16', 4096): 0.0939,
    ('K5', 'window', None, 'bfloat16', 8): 0.0135,
    ('K5', 'window', None, 'float32', 4096): 0.1166,
    ('K5', 'window', None, 'float32', 8): 0.0133,
    ('K5', 'int8 table', None, 'bfloat16', 4096): 0.0939,
    ('K5', 'int8 table', None, 'bfloat16', 8): 0.0133,
    ('K5', 'int8 table', None, 'float32', 4096): 0.1189,
    ('K5', 'int8 table', None, 'float32', 8): 0.0134,
    ('K1 col_base int8', 'up shard 0', None, 'bfloat16', 4096): 0.0695,
    ('K1 col_base int8', 'up shard 1', None, 'bfloat16', 4096): 0.0617,
    ('K1 col_base int8', 'up shard 2', None, 'bfloat16', 4096): 0.0598,
    ('K1 col_base int8', 'up shard 3', None, 'bfloat16', 4096): 0.0599,
    ('K1 col_base int8', 'up shard 0', None, 'bfloat16', 8): 0.015,
    ('K1 col_base int8', 'up shard 1', None, 'bfloat16', 8): 0.0148,
    ('K1 col_base int8', 'up shard 2', None, 'bfloat16', 8): 0.0148,
    ('K1 col_base int8', 'up shard 3', None, 'bfloat16', 8): 0.0146,
    ('K1 col_base int8', 'up shard 0', None, 'float32', 4096): 0.0719,
    ('K1 col_base int8', 'up shard 1', None, 'float32', 4096): 0.0609,
    ('K1 col_base int8', 'up shard 2', None, 'float32', 4096): 0.0595,
    ('K1 col_base int8', 'up shard 3', None, 'float32', 4096): 0.0597,
    ('K1 col_base int8', 'up shard 0', None, 'float32', 8): 0.0148,
    ('K1 col_base int8', 'up shard 1', None, 'float32', 8): 0.0151,
    ('K1 col_base int8', 'up shard 2', None, 'float32', 8): 0.0148,
    ('K1 col_base int8', 'up shard 3', None, 'float32', 8): 0.0145,
}


def prev_ms(kernel, case, dtype, rows, mode=None):
    """The previous design's time of a case (None where untimed)."""
    return PREV_MS.get((kernel, case, mode, dtype, rows))


def fwd_plan_of(K, rows, n_tile, strides, tiles, io_bytes, scale_rows=None,
                sides=1):
    """The forward engine's launch shape of a K1 or K5 launch, as a dict."""
    return K.fwd_plan(rows, n_tile, strides, tiles, io_bytes,
                      scale_rows=scale_rows, sides=sides)._asdict()


def plan_str(p) -> str:
    """A launch shape in a few characters: lane blocks x row blocks, threads,
    rows a chunk, row groups, passes, resident table."""
    return (f"C{p['lane_blocks']}x{p['row_blocks']} T{p['threads']} "
            f"R{p['chunk_rows']} G{p['groups']} P{p['passes']}"
            f"{' res' if p['resident'] else ''}")


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
    # the backward engine's launch shapes for the main runs, and how many of
    # their clusters the card holds at once (the planner's CLUSTERS_RESIDENT)
    qkv = tuple(1 << i for i in range(11))
    for kern, args, kw in (
            ("K2", (4096, 2048, qkv, 1, 2, 2), {}),
            ("K2", (4096, 2048, qkv, 3, 2, 2), {}),
            ("K2", (4096, 6144, (3072,), 1, 2, 2), {}),
            ("K6", (4096, 512, qkv[:9], 2, 2),
             dict(nvec=5, package=True, sides=2))):
        plan = K.bwd_plan(*args, **kw)
        held = K.bwd_clusters_resident(kern, torch.bfloat16, args[2], plan)
        log(f"{kern} plan rows={args[0]} tile={args[1]} L={len(args[2])} "
            f"tiles={args[3]}: lane blocks {plan.lane_blocks}, rows a chunk "
            f"{plan.chunk_rows}, row groups {plan.groups}, threads "
            f"{plan.threads}, {plan.smem_bytes} B shared; clusters of "
            f"{plan.cluster} resident {held} (planned "
            f"{K.CLUSTERS_RESIDENT[plan.cluster]})")
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
            p15 = prev_ms("K2", label, dname, rows)
            rows_out.append(dict(
                kernel="K2", case=label, dtype=dname, rows=rows, n=n,
                in_width=in_w, out_width=out_w,
                runs=[[list(rs), nt] for rs, nt in runs],
                launches_per_call=len(runs), gx_max_abs_err=gx_err,
                max_abs_err=err, grad_err_over_limit=worst,
                deterministic=det, ms=ms, prev_ms=p15, plain_ms=plain_ms,
                bound_ms=bms, bound_by=bby, library_ms=lib_ms, ok=ok))
            log(f"K2 {label:9s} {dname:8s} rows={rows:5d} runs={len(runs)} "
                f"gx_err={gx_err:.3e} (tol 0) grad err/limit={worst:.3f} "
                f"det={det} ms={ms:.4f} (before {fmt_ms(p15)}) "
                f"plain_ms={plain_ms:.4f} "
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
            # yardstick: a dense backward's two products for each linear of
            # the block, g_x = gy W^T and g_W = xh^T gy
            # (xh stands in for the mid activation and its cotangent)
            xh = (x.float() * rstd).to(dt)
            w_out = rnd(n, out_w).to(dt)
            if two:
                w_mid = rnd(n, n).to(dt)
                prods = (lambda: (torch.matmul(gy, w_out.T),
                                  torch.matmul(xh.T, gy),
                                  torch.matmul(xh, w_mid.T),
                                  torch.matmul(xh.T, xh)))
            else:
                prods = (lambda: (torch.matmul(gy, w_out.T),
                                  torch.matmul(xh.T, gy)))
            lib_ms = timer(prods)
            # g_dout and g_bias of the stack gy meets: exactly 0 on every
            # lane past out_width (no cotangent reaches it)
            tail = kern[8:10] if two else kern[4:6]
            dead_zero = out_w == n or not any(bool(v[out_w:].any())
                                              for v in tail)
            ok = (gx_worst <= 1 and worst <= 1 and det and dead_zero
                  and all(bool(torch.isfinite(t.float()).all())
                          for t in kern))
            prev = prev_ms("K4", label, dname, rows)
            _, bplan = block_plans(K, rows, n, kw, x.element_size())
            rows_out.append(dict(
                kernel="K4", case=label, dtype=dname, rows=rows, n=n,
                out_width=out_w, activation=act, two_stacks=two,
                residual=res, launches_per_call=1, max_abs_err=err,
                gx_err_over_limit=gx_worst, tol_f32_term=t32, tol_ulps=2,
                grad_err_over_limit=worst, grad_rel_term=rel,
                dead_lanes_zero=dead_zero, bwd_plan=bplan,
                deterministic=det, ms=ms, prev_ms=prev, plain_ms=plain_ms,
                bound_ms=bms, bound_by=bby, library_ms=lib_ms, ok=ok))
            log(f"K4 {label:13s} {dname:8s} rows={rows:5d} err={err:.3e} "
                f"gx err/limit={gx_worst:.3f} grad err/limit={worst:.3f} "
                f"det={det} dead lanes 0={dead_zero} ms={ms:.4f} "
                f"(before {fmt_ms(prev)}) plain_ms={plain_ms:.4f} "
                f"bound_ms={bms:.4f} ({bby}) library_ms={lib_ms:.4f} "
                f"plan={bwd_plan_str(bplan)} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"K4 {label} {dname} rows={rows}")
    return rows_out, failures


def _flat(out):
    """A backward's outputs as one tuple: a run chain's per-run tuples
    (g_x first) or one call's."""
    if isinstance(out, list):
        return tuple(t for run in out for t in run)
    return tuple(out)


def check_bwd(torch, call, plain, mags, rows):
    """Run a K2/K6 case twice and hold it to its plain version: every g_x
    bit for bit, every other output within gamma_rows of the sum of its
    terms' magnitudes, the second launch bitwise the first, all finite.
    Returns (ok, g_x error, grad error over its limit, deterministic)."""
    a, b = call(), call()
    pl, mg = plain(), mags()
    torch.cuda.synchronize()
    gxs = [(u, v) for u, v in zip(a if isinstance(a, list) else [a],
                                  pl if isinstance(pl, list) else [pl])]
    gx_err = max((u[0].float() - v[0].float()).abs().max().item()
                 for u, v in gxs)
    worst = max(grads_within(u[1:], v[1:], m[1:], rows) for (u, v), m in
                zip(gxs, mg if isinstance(mg, list) else [mg]))
    det = all(torch.equal(u, v) for u, v in zip(_flat(a), _flat(b)))
    finite = all(bool(torch.isfinite(t.float()).all()) for t in _flat(a))
    return gx_err == 0 and worst <= 1 and det and finite, gx_err, worst, det


def run_bwd_ragged_phase(torch, K, ops, Q, cfg):
    """K2 and K6 in every mode at a row count that fills no chunk or row
    group evenly (4072) and at 8 rows, untimed, held as phases 5, 12 and
    15 hold them (``check_bwd``): K2's o run in bf16 and f32, the gate/up
    and down chains, a run whose dead-tile skip fires, an int8 table, the
    x window, the gy window and the x window with an int8 table at the
    gate/up shard shapes; K6's q/k/v/o pair, the 2-shard pair folding
    d_out, a windowed pair and an int8 table.  (Int8 activations pad rows
    to the scale block: phase 8 covers them, 4072 rows included.)"""
    rows_out, failures = [], []
    g = torch.Generator(device=DEVICE).manual_seed(1357)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=DEVICE)

    def mix(*lead):
        th = (torch.rand(*lead, generator=g, device=DEVICE) * 2 - 1) \
            * math.pi
        c, s_ = torch.cos(th), torch.sin(th)
        return (torch.stack([c, -s_, s_, c], dim=-1)
                + rnd(*lead, 4, scale=0.05)).contiguous()

    abs_sum = (lambda t: t.abs().sum(0))
    qkv = tuple(1 << i for i in range(11))
    ffn = qkv + (3072,)

    def record(kernel, case, dtype, rows, res):
        ok, gx_err, worst, det = res
        rows_out.append(dict(kernel=kernel, case=case, dtype=dtype,
                             rows=rows, gx_max_abs_err=gx_err,
                             grad_err_over_limit=worst, deterministic=det,
                             ok=ok))
        log(f"ragged {kernel:16s} {case:14s} {dtype:8s} rows={rows:5d} "
            f"gx_err={gx_err:.1e} grad err/limit={worst:.3f} det={det} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"ragged {kernel} {case} {dtype} rows={rows}")

    # K2 run chains through the executor's run plan
    chains = [("o", 2048, qkv, 2048, 2048, torch.bfloat16, 4072),
              ("o", 2048, qkv, 2048, 2048, torch.float32, 4072),
              ("o", 2048, qkv, 2048, 2048, torch.bfloat16, 8),
              ("gate/up", 6144, ffn, 2048, 6144, torch.bfloat16, 4072),
              ("down", 6144, ffn, 6144, 2048, torch.bfloat16, 4072),
              ("rect-dead", 4096, qkv, 4096, 1024, torch.bfloat16, 4072)]
    for label, n, strides, in_w, out_w, dt, rows in chains:
        for q8 in ((False, True) if label == "o" and rows == 4072
                   and dt == torch.bfloat16 else (False,)):
            cf = mix(len(strides), n // 2)
            kcf, scf = Q.quantize_coeffs(cf) if q8 else (cf, None)
            d_in, d_out, b = 1 + 0.1 * rnd(n), 1 + 0.1 * rnd(n), \
                0.1 * rnd(n)
            x = rnd(rows, in_w).to(dt)
            gy = rnd(rows, out_w).to(dt)
            runs = ops.plan_runs_for_rows(n, strides, rows)
            widths = (None if in_w == n else in_w,
                      None if out_w == n else out_w)
            _, saved = ops.forward_runs(x, kcf, runs, d_in, d_out, b,
                                        *widths, coeff_scale=scf)
            args = (saved, kcf, gy, runs, d_in, d_out, True, *widths)
            kw = dict(coeff_scale=scf)
            res = check_bwd(
                torch,
                lambda: ops.backward_runs(K.spm_stack_bwd_kernel_call,
                                          *args, **kw),
                lambda: ops.backward_runs(K.spm_stack_bwd_plain, *args,
                                          **kw),
                lambda: ops.backward_runs(functools.partial(
                    K.spm_stack_bwd_plain, col_sum=abs_sum), *args, **kw),
                rows)
            record("K2 int8 table" if q8 else "K2", label,
                   str(dt).split(".")[-1], rows, res)
    # K2's windows at the gate/up shard shapes (shard 1 straddles in_w)
    from repro_torch.configs import with_feature_sharding
    lin = with_feature_sharding(cfg, SHARDS).ffn_cfg().up
    nl, _, plans = shard_run(lin.spm_config(), 4072)
    (rs, nt), = plans[0]
    in_w = lin.d_in
    for kind in ("x", "gy", "x int8 table"):
        cf = mix(len(rs), nl // 2)
        kcf, scf = Q.quantize_coeffs(cf) if "int8" in kind else (cf, None)
        d_in, d_out = 1 + 0.1 * rnd(nl), 1 + 0.1 * rnd(nl)
        shard = 1 if kind != "gy" else 0
        base = shard * nl // nt
        if kind == "gy":
            x = rnd(4072, nl).to(torch.bfloat16)
            gy = rnd(4072, in_w).to(torch.bfloat16)
            kw = dict(strides=rs, n_tile=nt, out_width=in_w, col_base=base,
                      has_bias=True)
        else:
            x = rnd(4072, in_w).to(torch.bfloat16)
            gy = rnd(4072, nl).to(torch.bfloat16)
            kw = dict(coeff_scale=scf, strides=rs, n_tile=nt, in_width=in_w,
                      col_base=base, has_bias=True)
        res = check_bwd(
            torch,
            lambda: K.spm_stack_bwd_kernel_call(x, kcf, gy, d_in, d_out,
                                                **kw),
            lambda: K.spm_stack_bwd_plain(x, kcf, gy, d_in, d_out, **kw),
            lambda: K.spm_stack_bwd_plain(x, kcf, gy, d_in, d_out,
                                          col_sum=abs_sum, **kw),
            4072)
        record("K2 col_base", f"{kind} s{shard}", "bfloat16", 4072, res)
    # K6's pair cases
    for label, S, nl, strides, k, in_w, fold, q8 in pair_cases(cfg):
        n = S * nl
        L = len(strides)
        cf, scale = mix(S, L, nl // 2), None
        if q8:
            q, scale = Q.quantize_coeffs(cf.reshape(S * L, nl // 2, 4))
            cf, scale = q.reshape(S, L, nl // 2, 4), scale.reshape(S, L)
        u, v, d_in = (1 + 0.1 * rnd(n) for _ in range(3))
        d_out = 1 + 0.1 * rnd(n) if fold else None
        x = rnd(4072, in_w or n).to(torch.bfloat16)
        gy = rnd(4072, n).to(torch.bfloat16)
        kw = dict(strides=strides, n_tile=nl, k=k, in_width=in_w)
        bwd = (x, cf, gy, u, v, d_in, d_out, scale)
        res = check_bwd(
            torch, lambda: K.spm_overlap_bwd_kernel_call(*bwd, **kw),
            lambda: K.spm_overlap_bwd_plain(*bwd, **kw),
            lambda: K.spm_overlap_bwd_plain(*bwd, col_sum=abs_sum, **kw),
            4072)
        record("K6", label, "bfloat16", 4072, res)
    return rows_out, failures


def run_block_ragged_phase(torch, K):
    """K3 and K4 at a row count that fills no chunk or row group evenly
    (4072) and at one row, bf16 and f32, untimed: the q and k/v forms and
    the two-stack form (relu, the residual, mid width 1536).  K3 within
    phase 2's limit and bit for bit ``k3_composition`` given its rstd, K4
    as phase 5 holds it (g_x within 2 I/O ulps plus K3's f32 term, grads
    within gamma_rows, lanes past out_width exactly 0); second launches
    bitwise."""
    rows_out, failures = [], []
    g = torch.Generator(device=DEVICE).manual_seed(2468)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=DEVICE)

    def mix(L, n):
        th = (torch.rand(L, n // 2, generator=g, device=DEVICE) * 2 - 1) \
            * math.pi
        c, s_ = torch.cos(th), torch.sin(th)
        return torch.stack([c, -s_, s_, c], dim=-1) + rnd(L, n // 2, 4,
                                                          scale=0.05)

    abs_sum = (lambda t_: t_.abs().sum(0))
    n = 2048
    strides = tuple(1 << i for i in range(11))
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        for rows in (4072, 1):
            for label, out_w, two in (("q", 2048, False), ("kv", 1024, False),
                                      ("ffn-relu-res", 2048, True)):
                kw = dict(coeffs1=mix(11, n), d_in1=1 + 0.1 * rnd(n),
                          d_out1=1 + 0.1 * rnd(n), bias1=0.1 * rnd(n),
                          gamma=1 + 0.1 * rnd(n), strides1=strides,
                          in_width=n, out_width=out_w, mid_width=out_w)
                if two:
                    kw.update(coeffs2=mix(11, n), d_in2=1 + 0.1 * rnd(n),
                              d_out2=1 + 0.1 * rnd(n), bias2=0.1 * rnd(n),
                              strides2=strides, activation="relu",
                              residual=True, mid_width=1536)
                x = rnd(rows, n).to(dt)
                gy = rnd(rows, out_w).to(dt)
                y, rstd = K.spm_block_kernel_call(x, **kw)
                y2, _ = K.spm_block_kernel_call(x, **kw)
                yp, _ = K.spm_block_plain(x, **kw)
                comp = k3_composition(torch, K, x, rstd, kw)
                got = K.spm_block_bwd_kernel_call(x, gy, rstd=rstd, **kw)
                again = K.spm_block_bwd_kernel_call(x, gy, rstd=rstd, **kw)
                want = K.spm_block_bwd_plain(x, gy, rstd=rstd, **kw)
                mags = K.spm_block_bwd_plain(x, gy, rstd=rstd,
                                             col_sum=abs_sum, **kw)
                torch.cuda.synchronize()
                L_tot = 11 * (2 if two else 1)
                lim = 2 * ulp(yp, dname) + k3_f32_term(
                    n, L_tot, yp.float().abs().max().item())
                k3_worst = ((y.float() - yp.float()).abs() / lim).max().item()
                k3_ok = (k3_worst <= 1 and torch.equal(y, comp)
                         and torch.equal(y, y2))
                gx_lim = 2 * ulp(want[0], dname) + k3_f32_term(
                    n, L_tot, want[0].float().abs().max().item())
                gx_worst = ((got[0].float() - want[0].float()).abs()
                            / gx_lim).max().item()
                worst = grads_within(got[1:], want[1:], mags[1:], rows)
                det = all(torch.equal(a, b) for a, b in zip(got, again))
                tail = got[8:10] if two else got[4:6]
                dead = out_w == n or not any(bool(v[out_w:].any())
                                             for v in tail)
                k4_ok = (gx_worst <= 1 and worst <= 1 and det and dead
                         and all(bool(torch.isfinite(v.float()).all())
                                 for v in got))
                for kern, ok, msg in (
                        ("K3", k3_ok, f"err/limit={k3_worst:.3f} bitwise "
                                      f"given rstd={torch.equal(y, comp)}"),
                        ("K4", k4_ok, f"gx err/limit={gx_worst:.3f} grad "
                                      f"err/limit={worst:.3f} det={det} "
                                      f"dead lanes 0={dead}")):
                    rows_out.append(dict(kernel=kern, case=label,
                                         dtype=dname, rows=rows, check=msg,
                                         ok=ok))
                    log(f"ragged {kern} {label:13s} {dname:8s} rows={rows:5d} "
                        f"{msg} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        failures.append(f"ragged {kern} {label} {dname} "
                                        f"rows={rows}")
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
            fplan = (K.fwd_plan(B, runs[0][1], runs[0][0],
                                -(-out_w // runs[0][1]), 1, scale_rows=sr)
                     if q_acts else None)
            base = dict(case=label, mode=mode, dtype="int8" if q_acts
                        else "bfloat16", rows=rows, padded_rows=B, n=n,
                        in_width=in_w, out_width=out_w,
                        runs=[[list(rs), nt] for rs, nt in runs],
                        launches_per_call=len(runs), scale_rows=sr,
                        block_rows=fplan and fplan.chunk_rows,
                        cluster=fplan and fplan.row_blocks)
            k1_prev = prev_ms("K1 int8", label, base["dtype"], rows, mode)
            plans = [fwd_plan_of(K, B, nt, rs, -(-(out_w if r == len(runs) - 1
                                                  else n) // nt),
                                 1 if q_acts else 2, sr if q_acts else None)
                     for r, (rs, nt) in enumerate(runs)]
            rows_out.append(dict(
                base, kernel="K1 int8", codes=n_codes, codes_differing=code_diff,
                bitwise=fwd_ok, deterministic=fwd_det, max_abs_err=float(
                    max((u.float() - v.float()).abs().max().item()
                        for u, v in zip(outs[0], outs[2]))),
                ms=ms, prev_ms=k1_prev, fwd_plans=plans, plain_ms=plain_ms,
                bound_ms=fbound, bound_by=fby,
                library_ms=f_lib, ok=fwd_ok and fwd_det))
            b15 = prev_ms("K2 int8", label, base["dtype"], rows, mode)
            rows_out.append(dict(
                base, kernel="K2 int8", gx_max_abs_err=gx_err,
                max_abs_err=gx_err, grad_err_over_limit=worst,
                deterministic=bwd_det, ms=bms_, prev_ms=b15,
                plain_ms=bplain_ms, bound_ms=bbound, bound_by=bby,
                library_ms=b_lib, ok=gx_err == 0 and worst <= 1 and bwd_det))
            log(f"int8 {label:9s} {mode:6s} rows={rows:5d} runs={len(runs)} "
                f"scale_rows={sr} cluster={base['cluster']} | K1 bitwise="
                f"{fwd_ok} det={fwd_det} ms={ms:.4f} (before "
                f"{fmt_ms(k1_prev)}) plans={[plan_str(q) for q in plans]} "
                f"plain_ms="
                f"{plain_ms:.4f} bound_ms={fbound:.4f} ({fby}) library_ms="
                f"{f_lib:.4f} | K2 gx_err={gx_err:.3e} grad err/limit="
                f"{worst:.3f} det={bwd_det} ms={bms_:.4f} plain_ms="
                f"{bplain_ms:.4f} bound_ms={bbound:.4f} ({bby}) library_ms="
                f"{b_lib:.4f} (before {fmt_ms(b15)}) "
                f"{'ok' if ok else 'FAIL'}")
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
                k1["prev_ms"] = prev_ms("K1 col_base", f"up shard {shard}",
                                        dname, rows)
                k1["fwd_plan"] = fwd_plan_of(K, rows, nt, rs, nl // nt, esz)
                rows_out.append(dict(common, kernel="K1 col_base",
                                     max_abs_err=k1_err, dead_is_bias=dead_ok,
                                     ok=ok1 and det, **k1))
                k2["prev_ms"] = prev_ms("K2 col_base", f"up shard {shard}",
                                        dname, rows)
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
                    f"dead=bias:{dead_ok} ms={k1['ms']:.4f} (before "
                    f"{fmt_ms(k1['prev_ms'])}) "
                    f"plan={plan_str(k1['fwd_plan'])} plain_ms="
                    f"{k1['plain_ms']:.4f} bound_ms={k1['bound_ms']:.4f} "
                    f"({k1['bound_by']}) library_ms={k1['library_ms']:.4f} "
                    f"| K2 gx_err={gx_err:.1e} grad err/limit={worst:.3f} "
                    f"zeros={zeros} ms={k2['ms']:.4f} (before "
                    f"{fmt_ms(k2['prev_ms'])}) plain_ms="
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
            k1_prev = prev_ms("K1", f"{name} shard 0", "bfloat16", rows)
            rows_out.append(dict(common, kernel="K1", max_abs_err=k1_err,
                                 ms=k1_ms, prev_ms=k1_prev, ok=ok1 and det))
            s15 = prev_ms("K2", f"{name} shard 0", "bfloat16", rows)
            rows_out.append(dict(common, kernel="K2", gx_max_abs_err=gx_err,
                                 max_abs_err=max(gx_err, max(
                                     (u - v).abs().max().item()
                                     for u, v in zip(gk[1:], gp[1:]))),
                                 grad_err_over_limit=worst, ms=k2_ms,
                                 prev_ms=s15, ok=ok2 and det))
            log(f"shard {name:4s} s0 bfloat16 rows={rows:5d} n_local={nl} "
                f"tile={nt} L={len(rs)} | K1 err={k1_err:.1e} "
                f"ms={k1_ms:.4f} (before {fmt_ms(k1_prev)}) | K2 "
                f"gx_err={gx_err:.1e} grad err/limit="
                f"{worst:.3f} ms={k2_ms:.4f} (before {fmt_ms(s15)}) "
                f"det={det} "
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
    from repro_torch.parallel import activation_sharding, make_feature_mesh
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
            busy_ms, groups = traced_device_ms(
                torch, lambda: LM.train_metrics(step_fn(state, batch_s,
                                                        0.0)[1]))
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
    Times (K5's in bf16 and f32, K6's in bf16: its f32 cases are checked,
    not timed), bounds, and as
    yardstick the S/2 dense products of the pair step, ``(B, 2 n_local) @
    (2 n_local, 2 n_local)`` (K6: the two of their backward), one batched
    ``torch.matmul`` each.  Then K1's and K2's windowed mode with an int8
    table at the gate/up shard shapes (phase 12's cases, the table
    quantized per stage of the shard), held as phase 12 holds them (K1
    timed in bf16 and f32, K2 in bf16)."""
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
                k5 = dict(ms=timer(lambda: K.spm_overlap_kernel_call(
                    *fwd, **kw)),
                    plain_ms=timer(lambda: K.spm_overlap_plain(*fwd, **kw)),
                    library_ms=timer(lambda: torch.matmul(xb, w)))
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
                k5["prev_ms"] = prev_ms("K5", label, dname, rows)
                k5["fwd_plan"] = fwd_plan_of(K, rows, nl, strides, S // 2,
                                             esz, sides=2)
                k5["clusters_resident"] = K.fwd_clusters_resident(
                    "K5", dt, strides, nl, K.FwdPlan(**k5["fwd_plan"]))
                ok5 = ok5 and k5["clusters_resident"] >= 1
                rows_out.append(dict(common, kernel="K5",
                                     max_abs_err=k5_err, ok=ok5 and det,
                                     **k5))
                k6["prev_ms"] = prev_ms("K6", label, dname, rows)
                rows_out.append(dict(common, kernel="K6",
                                     gx_max_abs_err=gx_err,
                                     max_abs_err=max(gx_err, max(
                                         (a - b).abs().max().item()
                                         for a, b in zip(gk[1:], gp[1:]))),
                                     grad_err_over_limit=worst,
                                     ok=ok6 and det, **k6))
                log(f"pair {label:10s} S={S} n_local={nl} L={L} {dname:8s} "
                    f"rows={rows:5d} | K5 err={k5_err:.1e} "
                    f"ms={fmt_ms(k5['ms'])} (before "
                    f"{fmt_ms(k5['prev_ms'])}) "
                    f"plan={plan_str(k5['fwd_plan'])} resident clusters="
                    f"{k5['clusters_resident']} "
                    f"plain_ms={fmt_ms(k5['plain_ms'])} "
                    f"bound_ms={k5['bound_ms']:.4f} ({k5['bound_by']}) "
                    f"library_ms={fmt_ms(k5['library_ms'])} | K6 "
                    f"gx_err={gx_err:.1e} grad err/limit={worst:.3f} "
                    f"ms={fmt_ms(k6['ms'])} (before "
                    f"{fmt_ms(k6['prev_ms'])}) "
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
                k1 = dict(ms=timer(lambda: K.spm_stack_kernel_call(
                    x, q, d_in, d_out, b, **kw)),
                    plain_ms=timer(lambda: K.spm_stack_plain(
                        x, q, d_in, d_out, b, **kw)),
                    library_ms=timer(lambda: torch.matmul(x, w)))
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
                k1["prev_ms"] = prev_ms("K1 col_base int8",
                                        f"up shard {shard}", dname, rows)
                rows_out.append(dict(common, kernel="K1 col_base int8",
                                     max_abs_err=k1_err, dead_is_bias=dead_ok,
                                     ok=ok1 and det, **k1))
                k2["prev_ms"] = prev_ms("K2 col_base int8",
                                        f"up shard {shard}", dname, rows)
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
                    f"{dead_ok} ms={fmt_ms(k1['ms'])} (before "
                    f"{fmt_ms(k1['prev_ms'])}) "
                    f"plain_ms={fmt_ms(k1['plain_ms'])} "
                    f"bound_ms={k1['bound_ms']:.4f} ({k1['bound_by']}) "
                    f"library_ms={fmt_ms(k1['library_ms'])} | K2 "
                    f"gx_err={gx_err:.1e} grad err/limit={worst:.3f} "
                    f"zeros={zeros} ms={fmt_ms(k2['ms'])} (before "
                    f"{fmt_ms(k2['prev_ms'])}) "
                    f"plain_ms={fmt_ms(k2['plain_ms'])} "
                    f"bound_ms={k2['bound_ms']:.4f} ({k2['bound_by']}) "
                    f"library_ms={fmt_ms(k2['library_ms'])} "
                    f"det={det} {'ok' if ok1 and ok2 and det else 'FAIL'}")
                if not (ok1 and ok2 and det):
                    failures.append(f"col_base int8 up shard {shard} "
                                    f"{dname} rows={rows}")
    return rows_out, failures


def run_fwd_ragged_phase(torch, K, ops, Q, cfg):
    """K1 and K5 in every mode at a row count that fills no chunk or row
    group evenly (4072) and at one row, in bf16 and f32, untimed: bit for
    bit their plain versions (int8 codes and scales included) and a second
    launch bitwise.  K1: the o run with an f32 and an int8 table, the
    gate/up and down chains, the x window at the gate/up shard shapes
    (shard 1 straddling in_width, shard 3 past it) with an f32 and an int8
    table, int8 activations (a padded scale block at 4072); K5: every pair
    case of ``pair_cases``.  (Phases 2, 8, 12 and 15 cover 4096 and 8
    rows.)"""
    rows_out, failures = [], []
    g = torch.Generator(device=DEVICE).manual_seed(2024)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=DEVICE)

    def mix(*lead):
        th = (torch.rand(*lead, generator=g, device=DEVICE) * 2 - 1) \
            * math.pi
        c, s_ = torch.cos(th), torch.sin(th)
        return (torch.stack([c, -s_, s_, c], dim=-1)
                + rnd(*lead, 4, scale=0.05)).contiguous()

    def flat(out):
        return out if isinstance(out, tuple) else (out,)

    def check(kernel, case, dtype, rows, call, plain):
        a, b, p = flat(call()), flat(call()), flat(plain())
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in zip(a, p))
        det = all(torch.equal(u, v) for u, v in zip(a, b))
        finite = all(bool(torch.isfinite(u.float()).all()) for u in a)
        ok = same and det and finite
        rows_out.append(dict(kernel=kernel, case=case, dtype=dtype,
                             rows=rows, bitwise=same, deterministic=det,
                             ok=ok))
        log(f"ragged {kernel:16s} {case:16s} {dtype:8s} rows={rows:5d} "
            f"bitwise={same} det={det} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"ragged {kernel} {case} {dtype} rows={rows}")

    qkv = tuple(1 << i for i in range(11))
    ffn = qkv + (3072,)
    from repro_torch.configs import with_feature_sharding
    lin = with_feature_sharding(cfg, SHARDS).ffn_cfg().up
    for rows in (4072, 1):
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).split(".")[-1]
            # K1 run chains through the executor's run plan
            for label, n, strides, in_w, out_w, q8 in (
                    ("o", 2048, qkv, 2048, 2048, False),
                    ("o int8 table", 2048, qkv, 2048, 2048, True),
                    ("gate/up", 6144, ffn, 2048, 6144, False),
                    ("down", 6144, ffn, 6144, 2048, False)):
                cf = mix(len(strides), n // 2)
                kcf, scf = Q.quantize_coeffs(cf) if q8 else (cf, None)
                vec = (1 + 0.1 * rnd(n), 1 + 0.1 * rnd(n), 0.1 * rnd(n))
                x = rnd(rows, in_w).to(dt)
                runs = ops.plan_runs_for_rows(n, strides, rows)

                def chain(fn, x=x, runs=runs, kcf=kcf, scf=scf, vec=vec,
                          n=n, in_w=in_w, out_w=out_w):
                    z, off = x, 0
                    for r, (rs, nt) in enumerate(runs):
                        last = r == len(runs) - 1
                        z = fn(z, kcf[off:off + len(rs)],
                               vec[0] if r == 0 else None,
                               vec[1] if last else None,
                               vec[2] if last else None, None,
                               None if scf is None else
                               scf[off:off + len(rs)],
                               strides=rs, n_tile=nt,
                               in_width=in_w if r == 0 and in_w != n
                               else None,
                               out_width=out_w if last and out_w != n
                               else None)
                        off += len(rs)
                    return z
                check("K1", label, dname, rows,
                      lambda: chain(K.spm_stack_kernel_call),
                      lambda: chain(K.spm_stack_plain))
            # the x window at the gate/up shard shapes
            nl, _, plans = shard_run(lin.spm_config(), rows)
            (rs, nt), = plans[0]
            for shard in (1, 3):
                for q8 in (False, True):
                    cf = mix(len(rs), nl // 2)
                    kcf, scf = Q.quantize_coeffs(cf) if q8 else (cf, None)
                    vec = (1 + 0.1 * rnd(nl), 1 + 0.1 * rnd(nl),
                           0.1 * rnd(nl))
                    x = rnd(rows, lin.d_in).to(dt)
                    kw = dict(strides=rs, n_tile=nt, in_width=lin.d_in,
                              col_base=shard * nl // nt)
                    args = (x, kcf, *vec, None, scf)
                    check("K1 col_base int8" if q8 else "K1 col_base",
                          f"up shard {shard}", dname, rows,
                          lambda: K.spm_stack_kernel_call(*args, **kw),
                          lambda: K.spm_stack_plain(*args, **kw))
            # K5's pair cases
            for label, S, nl, strides, k, in_w, fold, q8 in pair_cases(cfg):
                n, L = S * nl, len(strides)
                cf, scale = mix(S, L, nl // 2), None
                if q8:
                    q, scale = Q.quantize_coeffs(cf.reshape(S * L, nl // 2,
                                                            4))
                    cf, scale = q.reshape(S, L, nl // 2, 4), \
                        scale.reshape(S, L)
                ma, mb, d_in = (1 + 0.1 * rnd(n) for _ in range(3))
                d_out = 1 + 0.1 * rnd(n) if fold else None
                bias = 0.1 * rnd(n) if fold else None
                x = rnd(rows, in_w or n).to(dt)
                kw = dict(strides=strides, n_tile=nl, k=k, in_width=in_w)
                fwd = (x, cf, ma, mb, d_in, d_out, bias, scale)
                check("K5", label, dname, rows,
                      lambda: K.spm_overlap_kernel_call(*fwd, **kw),
                      lambda: K.spm_overlap_plain(*fwd, **kw))
        # int8 activations: the o run, rows padded to the scale block
        ((rs, nt),) = ops.plan_runs_for_rows(2048, qkv, rows)
        sr = Q.scale_block_rows([(rs, nt)], rows, 2)
        for mode in ("acts", "both"):
            cf = mix(len(rs), 1024)
            kcf, scf = Q.quantize_coeffs(cf) if mode == "both" else \
                (cf, None)
            vec = (1 + 0.1 * rnd(2048), 1 + 0.1 * rnd(2048),
                   0.1 * rnd(2048))
            qx, xs = Q.quantize_blocks(ops._pad_rows(rnd(rows, 2048), sr),
                                       sr, nt)
            kw = dict(strides=rs, n_tile=nt, quant_out=True, scale_rows=sr)
            args = (qx, kcf, *vec, xs, scf)
            check("K1 int8", f"o {mode}", "int8", rows,
                  lambda: K.spm_stack_kernel_call(*args, **kw),
                  lambda: K.spm_stack_plain(*args, **kw))
    return rows_out, failures


# ---------------------------------------------------------------------------
# phase 19: the paper's own models
# ---------------------------------------------------------------------------

PAPER_BATCH = 256       # Tables 1-2 (``configs/paper.T1_BATCH``)
PAPER_BUDGET_S = 120    # phase 19's seconds, at most
PAPER_VOCAB = 256       # the char-LMs' byte vocabulary


def paper_modules():
    """The modules phase 19 drives: the port's paper configs, data, MLP and
    GRU-LM, and the runners' char-LM and ``time_step``."""
    import types
    from benchmarks import torch_common as TC
    from benchmarks import torch_table34_charlm as CL
    from repro_torch import data as D
    from repro_torch import train as train_mod
    from repro_torch.configs import paper as P
    from repro_torch.core import pairings
    from repro_torch.kernels import ops
    from repro_torch.models import gru_lm as GLM
    from repro_torch.models import mlp as MLP
    from repro_torch.optim import adamw
    return types.SimpleNamespace(TC=TC, CL=CL, D=D, train_mod=train_mod,
                                 P=P, pairings=pairings, ops=ops, GLM=GLM,
                                 MLP=MLP, adamw=adamw)


def paper_kernel_cases(pairings):
    """(label, n, strides, rows): the f32 runs the paper's models give K1
    and K2: the Table 1 students at 256 rows on tiles of 256, 512, 1024 and
    2048 (L = 8-11), Table 2's 12 stages on 2048 (stride 1 again), the
    4096-wide linears split into 11 stages on a 2048 tile and the lone
    stride-2048 stage on 4096 (256 rows: Table 2; 4096: the char-LM), and
    the GRU-LM's 8 rows, one 12-stage run on a 4096 tile."""
    def bf(n, L):
        return pairings.make_schedule("butterfly", n, L).strides()
    return [("t1 w256", 256, bf(256, 8), PAPER_BATCH),
            ("t1 w512", 512, bf(512, 9), PAPER_BATCH),
            ("t1 w1024", 1024, bf(1024, 10), PAPER_BATCH),
            ("t1 w2048", 2048, bf(2048, 11), PAPER_BATCH),
            ("t2 w2048", 2048, bf(2048, 12), PAPER_BATCH),
            ("t2 w4096", 4096, bf(4096, 12), PAPER_BATCH),
            ("charlm d4096", 4096, bf(4096, 12), 4096),
            ("gru d4096 B8", 4096, bf(4096, 12), 8)]


def run_paper_kernel_phase(torch, K, ops, pairings, timer):
    """K1 and K2 in f32 over each run chain ``plan_runs_for_rows`` gives
    the paper's shapes, held as phases 2 and 5 hold them: K1 bit for bit
    its plain version and a second launch bitwise; K2's g_x bit for bit,
    its grads within gamma_rows of the sums of their terms' magnitudes, a
    second launch bitwise.  Logged with each run's launch shapes
    (``fwd_plan``, ``bwd_plan``), the chain's ms, its bound, the plain
    chain's ms and, as yardstick, ``torch.matmul`` with the same dense map
    (TF32 off) and a dense backward's two products."""
    rows_out, failures = [], []
    g = torch.Generator(device=DEVICE).manual_seed(1919)
    abs_sum = (lambda t: t.abs().sum(0))

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=DEVICE)

    def mix(L, n):
        th = (torch.rand(L, n // 2, generator=g, device=DEVICE) * 2 - 1) \
            * math.pi
        c, s = torch.cos(th), torch.sin(th)
        return torch.stack([c, -s, s, c], dim=-1) + rnd(L, n // 2, 4,
                                                        scale=0.05)

    for label, n, strides, rows in paper_kernel_cases(pairings):
        L = len(strides)
        cf = mix(L, n)
        d_in, d_out, b = 1 + 0.1 * rnd(n), 1 + 0.1 * rnd(n), 0.1 * rnd(n)
        x, gy = rnd(rows, n), rnd(rows, n)
        runs = ops.plan_runs_for_rows(n, strides, rows)

        def chain(call, x=x, runs=runs):
            z, off = x, 0
            for r, (rs, nt) in enumerate(runs):
                last = r == len(runs) - 1
                kw = dict(strides=rs) if call is K.spm_stack_plain else \
                    dict(strides=rs, n_tile=nt)
                z = call(z, cf[off: off + len(rs)],
                         d_in if r == 0 else None, d_out if last else None,
                         b if last else None, **kw)
                off += len(rs)
            return z

        kern = chain(K.spm_stack_kernel_call)
        again = chain(K.spm_stack_kernel_call)
        plain = chain(K.spm_stack_plain)
        _, saved = ops.forward_runs(x, cf, runs, d_in, d_out, b, None, None)
        args = (saved, cf, gy, runs, d_in, d_out, True, None, None)
        bwd_ok, gx_err, worst, det = check_bwd(
            torch, lambda: ops.backward_runs(K.spm_stack_bwd_kernel_call,
                                             *args),
            lambda: ops.backward_runs(K.spm_stack_bwd_plain, *args),
            lambda: ops.backward_runs(functools.partial(
                K.spm_stack_bwd_plain, col_sum=abs_sum), *args), rows)
        torch.cuda.synchronize()
        err = (kern - plain).abs().max().item()
        fwd_ok = (err == 0 and torch.equal(kern, again)
                  and bool(torch.isfinite(kern).all()))
        # times: the chain as the model runs it, its plain version, and the
        # dense yardsticks (the same linear map as one f32 product)
        ms1 = timer(lambda: chain(K.spm_stack_kernel_call))
        plain1 = timer(lambda: chain(K.spm_stack_plain))
        dense = chain(K.spm_stack_plain, x=torch.eye(n, device=DEVICE)) - b
        lib1 = timer(lambda: torch.matmul(x, dense))
        ms2 = timer(lambda: ops.backward_runs(K.spm_stack_bwd_kernel_call,
                                              *args))
        plain2 = timer(lambda: ops.backward_runs(K.spm_stack_bwd_plain,
                                                 *args))
        lib2 = timer(lambda: (torch.matmul(gy, dense.T),
                              torch.matmul(x.T, gy)))
        # bounds as phases 2 and 5 count them (f32 I/O)
        nb1 = rows * 2 * n * 4 + L * n // 2 * 16 + 3 * 4 * n
        fl1 = rows * n * (3 * L + 2 * len(runs))
        nb2 = rows * 3 * n * 4 + 2 * L * n // 2 * 16 + 2 * 3 * 4 * n
        fl2 = rows * n * (10 * L + 6 * len(runs))
        b1, by1 = bound(nb1, fl1)
        b2, by2 = bound(nb2, fl2)
        fplans = [fwd_plan_of(K, rows, nt, rs, n // nt, 4) for rs, nt in runs]
        bplans = [K.bwd_plan(rows, nt, rs, n // nt, 4, 4)._asdict()
                  for rs, nt in runs]
        runs_l = [[list(rs), nt] for rs, nt in runs]
        rows_out.append(dict(
            kernel="K1", case=label, dtype="float32", rows=rows, n=n,
            runs=runs_l, fwd_plans=fplans, launches_per_call=len(runs),
            max_abs_err=err, tol=0.0, ms=ms1, plain_ms=plain1, bound_ms=b1,
            bound_by=by1, library_ms=lib1, ok=fwd_ok))
        rows_out.append(dict(
            kernel="K2", case=label, dtype="float32", rows=rows, n=n,
            runs=runs_l, bwd_plans=bplans, launches_per_call=len(runs),
            gx_max_abs_err=gx_err, max_abs_err=gx_err,
            grad_err_over_limit=worst, deterministic=det, ms=ms2,
            plain_ms=plain2, bound_ms=b2, bound_by=by2, library_ms=lib2,
            ok=bwd_ok))
        log(f"paper K1 {label:13s} rows={rows:5d} runs="
            f"{[(len(rs), nt) for rs, nt in runs]} err={err:.1e} (tol 0) "
            f"ms={ms1:.4f} plain_ms={plain1:.4f} bound_ms={b1:.4f} ({by1}) "
            f"matmul_ms={lib1:.4f} plans={[plan_str(p) for p in fplans]} "
            f"{'ok' if fwd_ok else 'FAIL'}")
        log(f"paper K2 {label:13s} rows={rows:5d} gx_err={gx_err:.1e} (tol 0)"
            f" grad err/limit={worst:.3f} det={det} ms={ms2:.4f} plain_ms="
            f"{plain2:.4f} bound_ms={b2:.4f} ({by2}) matmul_ms={lib2:.4f} "
            f"plans={[bwd_plan_str(p) for p in bplans]} "
            f"{'ok' if bwd_ok else 'FAIL'}")
        if not fwd_ok:
            failures.append(f"paper K1 {label}")
        if not bwd_ok:
            failures.append(f"paper K2 {label}")
    return rows_out, failures


@dataclasses.dataclass
class PaperModel:
    """One of the paper's models at one size, its weights made on the CPU
    from a seed and its batch from numpy."""
    label: str
    init: object            # () -> params on the CPU
    loss: object            # (params, batch) -> (loss, metrics)
    batch: dict             # CPU tensors
    launches: int           # K1 (and K2) launches a forward (backward)
    depth: int              # dependent f32 roundings of a grad
    tokens: int             # rows (Tables 1-2) or tokens a step


def paper_model(torch, M, kind, impl, width, B, T=None, seed=0):
    """``kind`` "t1" (Table 1 student, teacher labels), "t2" (Table 2
    student, hashed text), "charlm" (Tables 3-4) or "gru" (the §6 GRU-LM,
    one layer, the closed-form backward)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    gen = (lambda: torch.Generator().manual_seed(seed))

    def runs(lin, rows):
        if not lin.is_spm:
            return 0
        scfg = lin.spm_config()
        return len(M.ops.plan_runs_for_rows(scfg.n, scfg.pairing.strides(),
                                            rows))

    def stages(lin):
        return lin.spm_config().n_stages if lin.is_spm else 0

    if kind in ("t1", "t2"):
        t1 = kind == "t1"
        n_cls = M.P.T1_CLASSES if t1 else M.P.AGNEWS_CLASSES
        cfg = M.P.student_cfg(width, n_cls, impl,
                              n_stages=None if t1 else M.P.AGNEWS_L)
        if t1:
            tc = M.D.TeacherConfig(width=width, n_classes=n_cls)
            batch = M.D.teacher_batch(M.D.make_teacher(tc, device="cpu"),
                                      tc, rng, B)
        else:
            batch = M.D.hashed_text_batch(M.D.HashedTextConfig(
                width=width, n_classes=n_cls), rng, B, device="cpu")
        fwd = 3 * stages(cfg.mix) + 4 + width + n_cls
        return PaperModel(
            f"{'Table 1' if t1 else 'Table 2'} w={width} {impl}",
            lambda: M.MLP.init_mlp(gen(), cfg, "cpu"),
            lambda p, b: M.MLP.mlp_loss(p, b, cfg), batch,
            runs(cfg.mix, B), 2 * fwd + B, B)
    ch = torch.from_numpy(rng.integers(0, PAPER_VOCAB, (B, T + 1)))
    batch = {"tokens": ch[:, :-1], "labels": ch[:, 1:]}
    if kind == "charlm":
        cfg = M.CL.CharLMCfg(d=width, impl=impl)
        fwd = 3 * stages(cfg.proj) + 4 + width + PAPER_VOCAB
        return PaperModel(
            f"char-LM d={width} {impl}", lambda: M.CL.init_charlm(cfg, "cpu"),
            lambda p, b: M.CL.charlm_loss(p, b, cfg), batch,
            runs(cfg.proj, B * T), 2 * fwd + B * T, B * T)
    cfg = M.GLM.GRULMConfig(vocab_size=PAPER_VOCAB, d_model=width,
                            linear_impl=impl, spm_backward="custom")
    u = cfg.gru_cfg().u
    fwd = T * (2 * (3 * stages(u) + 4) + 12) + width + PAPER_VOCAB
    return PaperModel(
        f"GRU-LM d={width} {impl}",
        lambda: M.GLM.init_gru_lm(gen(), cfg, "cpu"),
        lambda p, b: M.GLM.gru_lm_loss(p, b, cfg), batch,
        6 * T * runs(u, B), 2 * fwd + B * T, B * T)


def paper_step(M, model):
    """The runners' step for ``model``: AdamW at the paper's rates (Tables
    1-2 lr 3e-3; the LMs 1e-3, no warm-up)."""
    lr = 3e-3 if model.label.startswith("Table") else 1e-3
    return M.train_mod.make_train_step(
        model.loss, M.adamw.OptimizerConfig(lr=lr, warmup_steps=0))


def paper_parity_cases(torch, M):
    return [paper_model(torch, M, "t1", "spm_general", 256, PAPER_BATCH),
            paper_model(torch, M, "t2", "spm_general", 4096, PAPER_BATCH),
            paper_model(torch, M, "charlm", "spm_general", 4096, 4, 32),
            paper_model(torch, M, "gru", "spm_rotation", 4096, 4, 16)]


def run_paper_parity_phase(torch, K, M):
    """Each model's training step on the card (K1/K2) against the CPU
    (their plain versions) with the same weights and batch, as phase 7
    holds the transformer: the loss, every grad as a relative norm and the
    params after AdamW, within 8 sqrt(depth) eps32 relative, depth the
    model's dependent roundings (the stage walks forward and back, the
    head's and the softmax's sums, the GRU's steps, the grads' row sums).
    The card's K1 and K2 launches equal the plan (two forwards and two
    backwards: the grads, then the step).  Then the Table 1 teacher's
    labels on the card against the CPU's, equal wherever the CPU's top-two
    gap exceeds twice 8 gamma_k of its logits (k = 3L + 3 + width); the
    other rows are counted."""
    results, ok_all = [], True
    for model in paper_parity_cases(torch, M):
        t0 = time.perf_counter()
        rel = 8 * math.sqrt(model.depth) * EPS["float32"]
        params = model.init()
        out = {}
        for side, p in (("cpu", params), ("card", copy.deepcopy(params).to(
                DEVICE))):
            dev = "cpu" if side == "cpu" else DEVICE
            b = {k: v.to(dev) for k, v in model.batch.items()}
            K.reset_launch_counts()
            state = M.train_mod.make_train_state(p)
            loss, _ = model.loss(p, b)
            loss.backward()
            grads = {k: q.grad.detach().cpu() for k, q in
                     p.named_parameters()}
            p0 = {k: q.detach().cpu().clone()
                  for k, q in p.named_parameters()}
            state, m = paper_step(M, model)(state, b)
            out[side] = dict(
                loss=loss.item(), grads=grads, p0=p0,
                p1={k: q.detach().cpu() for k, q in p.named_parameters()},
                launches=(K.spm_stack_kernel_call.launches,
                          K.spm_stack_bwd_kernel_call.launches),
                skipped=float(m["skipped"]))
        a, c = out["card"], out["cpu"]
        loss_err = abs(a["loss"] - c["loss"]) / abs(c["loss"])
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
        want = (2 * model.launches, 2 * model.launches)
        ok = (loss_err <= rel and worst <= rel and diff <= rel * moved
              and a["skipped"] == 0.0 == c["skipped"]
              and a["launches"] == want and c["launches"] == (0, 0))
        secs = time.perf_counter() - t0
        results.append(dict(
            model=model.label, loss_card=a["loss"], loss_cpu=c["loss"],
            loss_rel_err=loss_err, worst_grad_rel_err=worst,
            worst_grad=worst_name, params_diff_norm=diff, update_norm=moved,
            rel_tol=rel, card_launches=a["launches"], planned=want,
            seconds=secs, ok=ok))
        log(f"paper parity {model.label}: loss card {a['loss']:.6f} cpu "
            f"{c['loss']:.6f} (rel {loss_err:.1e}), worst grad rel err "
            f"{worst:.1e} ({worst_name}), params diff {diff:.2e} vs update "
            f"{moved:.2e}; tol {rel:.1e}; K1/K2 launches {a['launches']} "
            f"(planned {want}) {secs:.1f} s {'ok' if ok else 'FAIL'}")
        ok_all = ok_all and ok
    # the Table 1 teacher's labels
    tc = M.D.TeacherConfig(width=256)
    L = tc.spm_cfg().n_stages
    import numpy as np
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (PAPER_BATCH, 256), dtype=np.float32))
    K.reset_launch_counts()
    lc = M.D.teacher_logits(M.D.make_teacher(tc, device="cpu"), x, tc)
    la = M.D.teacher_logits(M.D.make_teacher(tc, device=DEVICE),
                            x.to(DEVICE), tc).cpu()
    launched = K.spm_stack_kernel_call.launches
    bound_ = 8 * (3 * L + 3 + 256) * EPS["float32"] * lc.abs().max().item()
    top2 = lc.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * bound_
    same = bool((la.argmax(-1) == lc.argmax(-1))[decided].all())
    n_undecided = int((~decided).sum())
    t_ok = same and launched == 1
    log(f"paper teacher labels (w=256, {PAPER_BATCH} rows): equal on the "
        f"{int(decided.sum())} decided rows={same}, {n_undecided} within "
        f"2 x {bound_:.1e} of a tie, K1 launches {launched} (planned 1) "
        f"{'ok' if t_ok else 'FAIL'}")
    results.append(dict(model="Table 1 teacher labels", decided=int(
        decided.sum()), undecided=n_undecided, equal=same, launches=launched,
        ok=t_ok))
    return results, ok_all and t_ok


def paper_timed_cases(torch, M):
    """(model, steps timed after warm-up): every paper width, dense and
    SPM; the GRU-LM SPM only, one warm-up and 3 timed steps."""
    P = M.P
    out = []
    for w in P.TEACHER_WIDTHS:
        for impl in ("dense", "spm_general"):
            out.append((lambda w=w, impl=impl: paper_model(
                torch, M, "t1", impl, w, P.T1_BATCH), 2, 5))
    for w in P.AGNEWS_WIDTHS:
        for impl in ("dense", "spm_general"):
            out.append((lambda w=w, impl=impl: paper_model(
                torch, M, "t2", impl, w, PAPER_BATCH), 2, 5))
    for impl in ("dense", "spm_general"):
        out.append((lambda impl=impl: paper_model(
            torch, M, "charlm", impl, P.CHARLM_D, P.CHARLM_B, P.CHARLM_T),
            2, 5))
    out.append((lambda: paper_model(torch, M, "gru", "spm_rotation",
                                    P.CHARLM_D, P.CHARLM_B, P.CHARLM_T),
                1, 3))
    return out


def traced_device_ms(torch, fn):
    """A call of ``fn`` under ``torch.profiler`` tracing the device alone
    (``launch.profile_train``'s measure), after one warm-up call under the
    profiler (the first kernels of a trace started cold can go
    unrecorded): the device's busy ms (the union of kernel intervals) and
    ``{kernel group: [launches, ms]}``."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.launch.profile_train import busy_us, group_of
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    intervals, groups = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        intervals.append((ev.time_range.start, ev.time_range.end))
        gr = groups.setdefault(group_of(ev.name), [0, 0.0])
        gr[0] += 1
        gr[1] += ev.time_range.elapsed_us() / 1e3
    return busy_us(intervals) / 1e3, groups


def run_paper_timed_phase(torch, K, M):
    """A training step of each model on the card, timed by the runners'
    ``torch_common.time_step`` (the median wall-clock step, synchronized;
    f32, TF32 off for the dense products): ms a step, rows or tokens a
    second, peak memory, and K1/K2 launches equal to the plan over the
    warm-up and timed steps; then a step traced on the device
    (``traced_device_ms``): its busy ms, idle share against the median
    step, and device ms by kernel group.  For Table 1 the teacher labels one batch on
    the card first: one K1 launch, no K2."""
    results, ok_all = [], True
    dense_ms = {}
    for make, warmup, iters in paper_timed_cases(torch, M):
        model = make()
        params = model.init().to(DEVICE)
        state = M.train_mod.make_train_state(params)
        step = paper_step(M, model)
        batch = {k: v.to(DEVICE) for k, v in model.batch.items()}
        label_launches = None
        if model.label.startswith("Table 1"):
            import numpy as np
            width = batch["x"].shape[1]
            tc = M.D.TeacherConfig(width=width)
            teacher = M.D.make_teacher(tc, device=DEVICE)
            K.reset_launch_counts()
            batch = M.D.teacher_batch(teacher, tc,
                                      np.random.default_rng(0), PAPER_BATCH)
            torch.cuda.synchronize()
            label_launches = (K.spm_stack_kernel_call.launches,
                              K.spm_stack_bwd_kernel_call.launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        ms = M.TC.time_step(step, state, batch, warmup=warmup,
                            iters=iters) * 1e3
        got = (K.spm_stack_kernel_call.launches,
               K.spm_stack_bwd_kernel_call.launches)
        want = ((warmup + iters) * model.launches,) * 2
        peak = torch.cuda.max_memory_allocated()
        # a traced step: its device busy ms against the median step
        busy, groups = traced_device_ms(torch, lambda: step(state, batch))
        top = sorted(groups.items(), key=lambda kv: -kv[1][1])[:4]
        ok = got == want and label_launches in (None, (1, 0))
        impl = model.label.rsplit(" ", 1)[1]
        key = model.label.rsplit(" ", 1)[0]
        if impl == "dense":
            dense_ms[key] = ms
        speedup = (dense_ms[key] / ms if impl != "dense" and key in dense_ms
                   else None)
        rate = model.tokens / ms * 1e3
        results.append(dict(
            model=model.label, ms_per_step=ms, per_s=rate,
            unit="rows" if model.label.startswith("Table") else "tokens",
            dense_over_spm=speedup, peak_mem_bytes=peak,
            device_busy_ms=busy, device_idle_share=1 - busy / ms,
            device_ms_by_group={g: v[1] for g, v in groups.items()},
            launches_by_group={g: v[0] for g, v in groups.items()},
            launches=got,
            planned=want, label_launches=label_launches, warmup=warmup,
            iters=iters, ok=ok))
        log(f"paper step {model.label}: {ms:.3f} ms (median of {iters} "
            f"after {warmup}), {rate:,.0f} "
            f"{'rows' if model.label.startswith('Table') else 'tokens'}/s, "
            f"peak {peak / 2**30:.2f} GiB"
            f"{'' if speedup is None else f', dense/SPM {speedup:.2f}x'}; "
            f"a traced step busy {busy:.3f} ms ({1 - busy / ms:.0%} idle), "
            f"{', '.join(f'{g} {v[1]:.3f} ({v[0]})' for g, v in top)}; "
            f"K1/K2 launches {got} (planned {want})"
            f"{'' if label_launches is None else f', labels {label_launches} (planned (1, 0))'}"
            f" {'ok' if ok else 'FAIL'}")
        ok_all = ok_all and ok
        del params, state, batch
    return results, ok_all


def run_paper_phase(torch, K, timer):
    """Phase 19: the kernels at the paper's shapes, the four models' steps
    against the CPU, then the timed steps.  Returns (report, failures)."""
    M = paper_modules()
    out, secs = {}, {}
    t = time.perf_counter()
    out["kernels"], failures = run_paper_kernel_phase(torch, K, M.ops,
                                                      M.pairings, timer)
    secs["kernels"] = time.perf_counter() - t
    out["parity"], parity_ok = run_paper_parity_phase(torch, K, M)
    secs["parity"] = time.perf_counter() - t - secs["kernels"]
    out["steps"], steps_ok = run_paper_timed_phase(torch, K, M)
    secs["steps"] = time.perf_counter() - t - secs["kernels"] \
        - secs["parity"]
    log("phase 19 parts: " + ", ".join(f"{k} {v:.1f} s"
                                       for k, v in secs.items()))
    out["seconds"] = secs
    failures += [] if parity_ok else ["paper parity"]
    failures += [] if steps_ok else ["paper steps"]
    return out, failures


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
    sys.path.insert(0, HERE)
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
    ragged_rows, ragged_failures = phase("5 ragged", run_bwd_ragged_phase,
                                         torch, K, ops, Q, cfg)
    failures += ragged_failures
    block_rows, block_failures = phase("5 block ragged",
                                       run_block_ragged_phase, torch, K)
    ragged_rows += block_rows
    failures += block_failures
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
    fragged_rows, fragged_failures = phase("15 ragged", run_fwd_ragged_phase,
                                           torch, K, ops, Q, cfg)
    failures += fragged_failures
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
    paper, paper_failures = phase("19 paper", run_paper_phase, torch, K,
                                  timer)
    failures += paper_failures
    if phase_s["19 paper"] > PAPER_BUDGET_S:
        failures.append(f"phase 19 took {phase_s['19 paper']:.1f} s of "
                        f"its {PAPER_BUDGET_S} s")

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
    report = dict(gpu=smi, kernels=kernel_rows, ragged=ragged_rows,
                  fwd_ragged=fragged_rows,
                  serve=serve, parity=parity,
                  train=train, train_parity=tparity, int8_nonfinite=nonfinite,
                  int8_train=q8_train,
                  int8_train_parity=q8_tparity, int8_serve=q8_serve,
                  sharded=sharded, sharded_train_parity=sparity,
                  overlap=overlap, int8_overlap=q8_overlap,
                  overlap_train_parity=oparity,
                  paper=paper,
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
