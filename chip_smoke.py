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
4. **Model parity**: the same weights, cut to their first
   ``PARITY_LAYERS`` (8) layers at full width, through the port on the
   card (kernels) and on the CPU (plain versions), batch 4, prompt 16, 24
   teacher-forced steps; logits within a bf16-derived tolerance, tokens
   equal wherever the top-2 gap exceeds it.  Then one row of the served
   batch is replayed on the CPU (prompt 512, the served tokens fed back):
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
7. **Train parity**: the same full-width weights with f32 activations, cut
   to their first ``PARITY_LAYERS`` (8) layers, one step on the card and
   on the CPU: the loss, every parameter's grad (as a relative norm) and
   the updated params within a derived f32 bound.
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
10. **int8 train parity**: phase 7 on the quantized model cut to its first
   ``PARITY_LAYERS`` (8) layers at full width, the CPU
   replaying the card's int8 codes chain by chain
   (``kernels.codes.CodeTape``), so that one flipped code does not carry
   quantization noise through the later layers: within phase 7's f32
   bound; each chain's CPU output from the card's entry bit for bit the
   card's; the CPU's own entry codes within one of the card's and flipped
   no more often than ``flip_budget``.
11. **int8 serve**: ``ServeEngine.generate`` of the quantized model cut
   to ``Q8_SERVE_LAYERS`` (8) of its 28 layers (batch 8, prompt 512, 64
   tokens): launches equal to the plan, prefill ms and decode tokens/s;
   then teacher-forced logits of its first 8 layers
   against the CPU at batch 4, prompt 16, 32 steps, the codes replayed as
   in phase 10, within phase
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
   ``activation_sharding(mesh, shard_feature=True)``: ``SHARDED_STEPS``
   (4) steps of batch 8 x seq 512 with the third poisoned, then one
   ``generate`` of 8 x 512 +
   16 tokens; K1/K2 launches (windowed counted apart) equal to the plan
   from ``plan_steps`` and ``plan_runs_for_rows``, K3 = K4 = 0.  Step ms,
   tokens/s and peak memory beside phase 6's.
14. **Sharded train parity**: phase 7 on the sharded model cut to its
   first 8 layers, each side under a 4-shard mesh on its own device.
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
20. **Continuous serve**: ``ContinuousBatchingEngine`` on full-width
   ``qwen3-1.7b`` cut to ``CB_LAYERS`` (8) of its 28 layers (8 slots,
   ``max_len`` 576, bf16 KV cache): 24
   requests (prompts 9-512, so buckets 16-512; 16, 32 or 64 tokens;
   greedy, top-k, top-p, both) at Poisson arrivals of 0.25 and 2.0
   requests a tick after a warm-up request.  Every request its tokens, in
   range, unflagged; admits after arrivals; K1/K3 launches equal to the
   plan (one prefill row of each bucket, each tick at 8 rows).  Churn
   parity bit for bit (each request at both loads, and three served alone
   through an 8-slot engine); greedy requests against batch 1 on the card,
   teacher-forced: equal tokens wherever the top-2 gap exceeds phase 4's
   bound; K1/K3 against their plain
   versions at every row count the serve gave them (8, and each bucket's
   16-512) as in phase 2.  Tokens/s, ms a tick,
   occupancy, p50/p99 latency in ticks, admit ms per bucket, peak memory,
   a traced tick's busy ms and idle share.  Then 8 requests each on
   ``with_quantized_io`` (K1's int8 modes) and on the 4-shard overlap
   executor (K5) at full width and 8 layers: tokens in range, launches as
   planned.
21. **Chaos train**: the training substrate through ``launch.train.train``
   on full-width, full-depth ``qwen3-1.7b`` from seed 0 (batch 8, seq 512,
   12 steps, ``--ckpt-every 6``, ``--backoff-base 0``).  Two clean lives
   must agree bit for bit (every param, moment, count and step).  A third,
   with a checkpoint dir under ``nan@6+5;corrupt@11:delmeta;preempt@11;
   slow@11:2.0``, saves step_6, skips 6-10 and rolls back, replays 6-11
   (sleeping 2 s before 11) and saves step_12, loses its meta.json and is
   preempted; the restart quarantines step_12, walks back to step_6 and
   replays.  It must end bit for bit the clean lives' state, with exactly
   5 ``skip``, ``rollback``, ``slow_step`` at 11, ``chaos_corrupt``,
   ``chaos_preempt``, ``restart`` and ``quarantine``, a ``corrupt.12.*``
   dir and a final step_12 that verifies; K1-K4 launches equal to the
   plan times the steps each life ran; the restart's allocation no larger
   than before it.  Reported beside the card's name and power limit:
   checkpoint bytes, each save (device-to-host, write, hashing, publish),
   verify and restore in ms, the chaos life's extra wall time and replayed
   steps, step ms, each life's peak memory.  The directory is under
   ``tempfile.mkdtemp()`` (20 GB free needed, else the phase fails) and is
   removed.  Then the elastic restart at n = 2048 (11 stages), 4096 rows
   of f32, schedule pinned to 4 shards: a run trained 4-way that rolls
   back, has step_9 truncated and is preempted, then resumed 2-way, must
   equal bit for bit a fault-free run trained 4-way for steps 0-5 and
   2-way for 6-11; one step's grads of the same state on 4 and on 2
   shards within gamma_rows of their terms' magnitudes; K1 and K2 at each
   width's local runs (512 and 1024 lanes) against their plain versions
   as phase 12 holds them.

22. **The other dense-attention archs** (``run_archs_phase``):
   gemma3-12b (5:1 local:global, 1024-slot rings), qwen2-vl-7b (M-RoPE,
   embedding inputs), musicgen-medium (embedding inputs, fused q/k/v),
   minitron-4b and qwen3-32b, each at full width from seed 0, cut to a
   quarter of its depth (``ARCH_LAYERS``; gemma3-12b's two 5:1 groups):
   ``ServeEngine.generate`` of 4 rows, 16 tokens (gemma3-12b's prompt 1280,
   so every ring wraps in prefill and decode; the others 256), K1/K3
   launches equal to the plan (q/k/v as K1 runs where they do not fuse);
   two training steps of 4 x 512 through ``launch.train.train``
   (qwen2-vl-7b with a 16 x 16 patch grid's M-RoPE ids), K1-K4 launches
   and K2's split-mode launches equal to the plan, losses and grad norms
   finite and non-zero.  Init s, prefill ms, decode tokens/s, step ms,
   peak memory.  Then gemma3-12b at one 6-layer pattern group against the
   CPU (an 1100-token prompt, 6 tokens teacher-forced, phase 4's bound);
   qwen2-vl-7b at 1 layer, one f32 step against the CPU with distinct
   M-RoPE ids (phase 7's bound); gemma3-12b's 6 layers through the
   continuous engine (4 slots, 8 requests of 9-1100 tokens): churn parity
   bit for bit against each request alone, and unchanged tokens with NaN
   planted in each reused slot's rows before its admit.  Last, K2's split
   mode against its plain version at every lone wide tile (9216, 9472,
   12800, 15360, 18944, 25600) at 8 and 2048 rows, held as phase 5 holds
   K2, timed beside the dense backward's two products, and at 2048 rows
   with an int8 x; then K1-K4 at every distinct shape the five archs'
   main path gives them (``arch_kernel_cases``: each linear's widths and
   run plan at the training step's 2048 rows, the prefills' 1024 and 5120
   and decode's 4), held as phases 2 and 5 hold them, the FFN's and
   musicgen-medium's q/k/v also timed.  The phase has 200 s
   (``ARCH_BUDGET_S``).
23. **MoE, Mamba2 and the shared block** (``run_slice_phase``):
   qwen3-moe-30b-a3b (128 experts, top-8), llama4-scout-17b-a16e (16
   experts, top-1, a shared expert), mamba2-370m and zamba2-1.2b (a Mamba2
   backbone, the shared attention + FFN block before every 6th layer),
   each at full width from seed 0, cut to ``SLICE_LAYERS`` (12) layers
   (qwen3-moe at full depth is phase 24's):
   ``ServeEngine.generate`` of 4 rows, prompt 256, 32 greedy tokens (the
   SSM stacks prefill by decode replay), and two training steps of 4 x
   512 through
   ``launch.train.train`` (bf16; aux finite, positive for MoE); every
   K1-K4 launch count (K1's and K2's expert mode and K2's split mode
   counted apart, one expert launch a run for all experts) equal to the
   plan (``slice_serve_launches``, ``slice_train_launches``).  Init s,
   prefill ms, decode tokens/s, step ms, peak memory.  Then qwen3-moe at
   2 layers against the CPU in f32 (routing compared first: logits within
   phase 7's f32 bound where it agrees, a flipped token only at a
   near-tie of its router), and zamba2 at one 6-layer group (its chunked
   forward within the f32 bound, its replayed prefill within 2e-3 of the
   chunked forward).  Then K1 and K2 in the expert mode at every shape of
   the path (each MoE arch's gate/up and down experts at the training
   step's, the prefill's and decode's rows a expert; K1 bit for bit,
   K2's g_x bit for bit and its grads within gamma_rows; timed at the
   training rows beside ``torch.bmm``), and K1-K4 at every other shape
   the four archs' path gives them (``slice_kernel_cases``; Mamba2's
   in_proj at 2048 rows timed).  The phase has 200 s
   (``SLICE_BUDGET_S``).
24. **The MoE archs under the reference's operator knobs**
   (``run_modes_phase``): full-width qwen3-moe-30b-a3b from seed 0, bf16,
   through two ``launch.train --quantize`` steps of 4 x 512 (int8
   activations and tables in the experts' expert mode, per expert),
   quantized serving of 4 rows, prompt 256, 32 tokens, two steps of
   ``with_feature_sharding(cfg, 4)`` on a 4-shard mesh on the card
   (windowed expert runs) and two of
   ``with_overlap_executor(with_quantized_io(with_feature_sharding(cfg,
   4)))`` (K5/K6 over the expert axis, int8 tables); every launch count
   (expert, int8, int8-I/O, windowed and pair launches apart) equal to the
   plan (``modes_train_plan``, ``modes_serve_plan``); a sharded run whose
   peak passes ``MODES_PEAK_GIB`` reruns at ``MODES_CUT_LAYERS`` layers.
   Then the card against the CPU at ``MODES_PARITY_LAYERS`` layer, f32,
   routing compared first (``run_modes_parity``: one forward, backward
   and first AdamW update a side, each on its own device; the int8 model
   with the CPU replaying the card's codes, phase 10's criterion; the
   step-serial and overlap sharded models, phases 14's and 18's; launch
   counts, finiteness and codes held even where a near-tie routes a token
   otherwise).  Then each new mode
   against its plain version at every shape of the path
   (``modes_kernel_cases``: K1/K2 expert int8 at qwen3-moe's training,
   prefill and decode rows and llama4's training rows; K1/K2 expert
   ``col_base`` at every shard of the 512- and 2048-lane windows; K5/K6
   over qwen3-moe's experts; K1 and K5 bit for bit, K2's and K6's g_x bit
   for bit, grads within gamma_rows), timed at the training rows beside
   ``torch.bmm`` and, at the headline shapes, the plain version (called
   once).  The phase has 150 s (``MODES_BUDGET_S``).

25. **A data-parallel pod** (``run_pod_phase``): ``launch.train.train``
   with ``--pod-dp 2`` over two ranks on the one card (gloo: NCCL takes
   one rank a card; this process is rank 0, ``launch.mesh.run_ranks``
   spawns rank 1), full-width ``qwen3-1.7b`` from seed 0, global batch 8 x
   512 (4 rows a rank), one spawn for two runs: the plain mean (3
   steps) and ``--compress-pod-grads`` (4 steps, ``nan@2``, a step-3
   checkpoint with ``opt.ef`` (2, ...) on disk, preempted after the last
   step, which the restart replays from the checkpoint).  Held: both ranks' params, moments and
   count bit for bit equal after every step; at step 0 of each mode the
   collective's grads bit for bit a one-process recomputation on the card
   from both members' local grads (``(g0 + g1) * 0.5``;
   ``member_sum_compressed_ef``), the new residual rows too; the poisoned
   step skipped on both ranks, state and residual unchanged; the replayed
   last step ending bit for bit where the uninterrupted run ended; K1-K4
   launches a rank a step
   equal to the plan at 4 rows.  Step ms, the reduction's wall ms and
   bytes, each rank's peak.  The phase has 120 s (``POD_BUDGET_S``).
26. **The feature-sharded executor with one shard a rank**
   (``run_ranks_phase``): four ranks on the one card over gloo, shard j on
   rank j (``launch.mesh.make_feature_rank_mesh``).  (a) K5's and K6's
   rank mode (the send kernel stores the rank's block into the partner
   rank's receive slot through CUDA IPC, the stream waits on the
   partner's signal, then the mix or K6's consume kernel) at q/k/v/o's
   pair (k = 1; k = 2 with d_out and bias folded; an int8 table) and
   gate/up's windowed first read, 4096 rows in 4 row blocks: y and g_x
   bit for bit their plain versions (the per-block exchange over the
   group) and the one-card K5/K6's columns, the grads within gamma_rows,
   the transport drained; timed (send, wait and mix apart).  (b)
   Full-width qwen3-1.7b at ``RANKS_LAYERS`` layers, 4 x 512 rows every
   rank: ``RANKS_STEPS`` step-serial steps bit for bit the one-card
   sharded steps, then as many on the overlap schedule (K5/K6 rank mode;
   its first step's loss and g_x-made grads bit for bit the one-card
   overlap step's, the rest within phase 18's bound); the ranks bitwise
   equal after every step; launches equal to ``rank_train_plan``; the
   ranks' peaks under ``RANKS_PEAK_GIB`` together.  Step ms, the
   exchange's wall ms and bytes.  The phase has 110 s
   (``RANKS_BUDGET_S``); the spawn is killed past ``RANKS_LIMIT_S``.
27. **Abstract specs** (``run_specs_phase``): ``launch/specs``'s
   ``abstract_params`` of qwen3-1.7b (on ``meta``) leaf for leaf (names,
   shapes, dtypes) against the parameters phase 6 trained on the card,
   ``model_param_count`` against the sum of their ``numel``, and
   ``abstract_cache`` at phase 3's batch and length against the cache
   its ``LM.prefill`` (the serve engine's) made on the card.  The phase
   has 10 s (``SPECS_BUDGET_S``).

Depths: phases 4 (its teacher-forced part), 7, 10, 11 (its
teacher-forced part), 14 and 18 hold the card to the CPU on the first
``PARITY_LAYERS`` = 8 of the 28 layers at full width, and phase 4
replays one served row (two before): they were the script's slowest CPU
sides.  On an NVIDIA H100 80GB HBM3 at 700 W the
whole script took 766.1 s with the build 227.0 s and phase 21 116.2 s,
phases 4, 10, 11 and 14 41.9, 20.0, 41.6 and 23.3 s (56.0, 39.7, 81.0 and
46.0 at full depth and two replayed rows, on another host).

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

    def __call__(self, fn, reps: int = TIMED, warm=None) -> float:
        torch = self.torch
        for _ in range(min(3, reps) if warm is None else warm):
            fn()
        pairs = []
        for _ in range(reps):
            torch.cuda._sleep(2_000_000)       # about 1 ms of spinning
            self.flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps


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


def run_kernel_phase(torch, K, ops, timer, k1=None, k3=None, dtypes=None,
                     k3_shape=None):
    """Phase 2 over ``k1_cases()`` and ``k3_cases()`` in bf16 and f32, or
    over the given cases and dtypes (phases 20, 22), K3 on ``k3_shape`` =
    (n, strides), default the 2048-wide 11-stage q/k/v; ``timer`` None
    holds the cases without timing them.  K1 is held bit for bit:
    its kernel rounds every product and sum on its own
    (``__fmul_rn``/``__fadd_rn``), as the plain version's eager ops do, and
    sums nothing else.  K3 is held within two ulps of the I/O
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

    for dt in dtypes or (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        for label, n, strides, rows, in_w, out_w in (k1_cases() if k1 is None
                                                     else k1):
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
            ms = plain_ms = lib_ms = None
            if timer is not None:
                ms = timer(lambda: chain(K.spm_stack_kernel_call))
                plain_ms = timer(lambda: chain(K.spm_stack_plain))
                # yardstick: one dense product computing the same linear map
                eye = torch.eye(in_w, device=DEVICE)
                dense = chain(K.spm_stack_plain, x=eye,
                              launches=[dict(kw, bias=None)
                                        for kw in launches]).to(dt)
                del eye
                lib_ms = timer(lambda: torch.matmul(x, dense))
                del dense
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
                f"err={err:.3e} tol=0 max|y|={scale:.3f} ms={fmt_ms(ms)} "
                f"(before {fmt_ms(prev)}) "
                f"plain_ms={fmt_ms(plain_ms)} bound_ms={bms:.4f} ({bby}) "
                f"plan_bound_ms={plan_bms:.4f} "
                f"library_ms={fmt_ms(lib_ms)} "
                f"plans={[plan_str(q) for q in plans]} resident clusters="
                f"{held} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"K1 {label} {dname} rows={rows}")

        n, strides = k3_shape or (2048, tuple(1 << i for i in range(11)))
        L1 = len(strides)
        for label, rows, out_w, act, two in (k3_cases() if k3 is None
                                             else k3):
            kw = dict(coeffs1=mix(L1, n), d_in1=vec(n),
                      d_out1=vec(n), bias1=0.1 * rnd(n), gamma=vec(n),
                      strides1=strides, in_width=n, out_width=out_w,
                      mid_width=out_w)
            if two:
                kw.update(coeffs2=mix(L1, n),
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
            L_tot = L1 * (2 if two else 1)
            t32 = k3_f32_term(n, L_tot, scale)
            limit = 2 * ulp(plain, dname) + t32
            worst = (diff / limit).max().item()
            rerr = ((rstd_k - rstd_p).abs() / rstd_p).max().item()
            rtol = 8 * (math.sqrt(n) + 4) * EPS["float32"]
            ms = plain_ms = lib_ms = None
            if timer is not None:
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
            if not two and timer is not None:
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
                f"ms={fmt_ms(ms)} (before {fmt_ms(prev)}) "
                f"plain_ms={fmt_ms(plain_ms)} "
                f"bound_ms={bms:.4f} ({bby}) library_ms={fmt_ms(lib_ms)} "
                f"plan={plan_str(fplan)} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"K3 {label} {dname} rows={rows}")
    return rows_out, failures


# ---------------------------------------------------------------------------
# phase 3: serving full-width qwen3-1.7b through the kernels
# ---------------------------------------------------------------------------

def qkv_fused(cfg) -> bool:
    """Whether a layer's q/k/v run as fused K3 launches, as
    ``layers/attention.attention_apply`` decides it."""
    from repro_torch.layers.attention import qkv_block_fused
    return qkv_block_fused(cfg.attn_cfg(cfg.layers[0]))


def k1_linears(cfg):
    """(name, LinearConfig) of a layer's linears that run on K1: o, gate,
    up and down, and q, k and v where they do not fuse (``qkv_fused``)."""
    acfg, fcfg = cfg.attn_cfg(cfg.layers[0]), cfg.ffn_cfg()
    lins = [("o", acfg.o_proj), ("gate", fcfg.gate), ("up", fcfg.up),
            ("down", fcfg.down)]
    if not qkv_fused(cfg):
        lins += [("q", acfg.q_proj), ("k", acfg.kv_proj),
                 ("v", acfg.kv_proj)]
    return lins


def planned_launches(cfg, ops, rows: int):
    """(K1, K3) launches of one forward over ``rows`` flattened rows, from
    the port's own run plan: per layer three fused q/k/v (K3), and the runs
    of every ``k1_linears`` (K1)."""
    k1 = 0
    for _, lin in k1_linears(cfg):
        scfg = lin.spm_config()
        k1 += len(ops.plan_runs_for_rows(scfg.n, scfg.pairing.strides(),
                                         rows))
    return cfg.n_layers * k1, cfg.n_layers * (3 if qkv_fused(cfg) else 0)


def planned_split_launches(cfg, ops, K, rows: int) -> int:
    """K2 launches of one training step over ``rows`` rows in its split
    mode (a lone stage wider than one cluster, ``bwd_plan``'s ``split``):
    one per such run of every linear of every layer."""
    n_split = 0
    for _, lin in k1_linears(cfg):
        scfg = lin.spm_config()
        n = scfg.n
        for rs, nt in ops.plan_runs_for_rows(n, scfg.pairing.strides(),
                                             rows):
            n_split += bool(K.bwd_plan(rows, nt, rs, n // nt, 2).split)
    return cfg.n_layers * n_split


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
    t = time.perf_counter()
    tokens, flags = eng.generate(prompts, max_new_tokens=new,
                                 return_flags=True)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t
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
    tn = min(counted_s, wall(new))      # the counted run is the first rep
    from repro_torch.models import causal_lm as LM
    with torch.inference_mode():       # the cache the engine's prefill makes
        _, cache = LM.prefill(params, cfg, max_len=eng.max_len,
                              tokens=prompts[:, :16].to(DEVICE),
                              cache_dtype=eng.cache_dtype)
    cache_sig = tensor_signature(cache)
    del cache
    res = dict(batch=batch, prompt_len=prompt_len, new_tokens=new,
               init_s=init_s, prefill_ms=t1 * 1e3,
               decode_tok_per_s=batch * (new - 1) / (tn - t1),
               generate_s=tn, peak_mem_bytes=peak,
               launches={"K1": got[0], "K3": got[1]},
               planned={"K1": want[0], "K3": want[1]},
               planned_per_forward={"prefill": pre, "decode": dec},
               max_len=eng.max_len, cache_signature=cache_sig)
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

REPLAY_ROWS = 1         # served rows replayed on the CPU
REPLAY_STEPS = 16       # served tokens checked per replayed row
MIN_DECIDED = 16        # tokens the parity phase must decide, at least
PARITY_LAYERS = 8       # depth of the card-vs-CPU models of phases 4 (its
                        # teacher-forced part), 7, 10, 11, 14 and 18 (full
                        # width, the first of 28 layers)


def cut_depth(cfg, params=None, n=PARITY_LAYERS):
    """``cfg`` cut to its first ``n`` layers at full width, and, when
    ``params`` is given, a tree sharing those layers' tensors with it."""
    cut = dataclasses.replace(cfg, n_layers=n, layers=cfg.layers[:n])
    if params is None:
        return cut
    from repro_torch.params import Params
    tree = Params({k: params[k] for k in params.keys() if k != "layers"})
    tree["layers"] = list(params["layers"][:n])
    return cut, tree


def run_parity_phase(torch, LM, cfg, params, served_prompts, served_tokens):
    """Two checks of the card against the CPU on the same weights.

    1. Teacher-forced, on the model cut to its first ``PARITY_LAYERS``
       layers at full width (the same weights): both sides decode the
       card's greedy tokens (batch 4, prompt 16, 24 steps), so each step
       compares logits of the same inputs; they must agree within the
       tolerance below, and tokens must be equal wherever the card's top-2
       gap exceeds it.
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
    tf_cfg, tf_card = cut_depth(cfg, params)
    _, tf_cpu = cut_depth(cfg, cpu_params)
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
        lg, cg = LM.prefill(tf_card, tf_cfg, max_len=max_len,
                            tokens=prompts.to(DEVICE))
        lc, cc = LM.prefill(tf_cpu, tf_cfg, max_len=max_len, tokens=prompts)
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
                lg, cg = LM.decode_step(tf_card, tf_cfg, tok.to(DEVICE), cg,
                                        plen + step)
                lc, cc = LM.decode_step(tf_cpu, tf_cfg, tok, cc, plen + step)
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
    res = dict(max_abs_err=worst, tol=t, layers=tf_cfg.n_layers,
               batch=batch, prompt_len=plen,
               steps=steps, compared=batch * steps, decided_tokens=checked,
               token_mismatches=mism, replay_rows=REPLAY_ROWS,
               replay_prompt_len=int(sp.shape[1]), replay_steps=REPLAY_STEPS,
               replay_decided=r_checked, replay_mismatches=r_mism,
               teacher_forced_s=tf_s, replay_s=replay_s)
    ok = (mism == 0 and r_mism == 0
          and checked + r_checked >= MIN_DECIDED)
    log(f"parity: logits max err {worst:.3e} (tol {t:.3e}) over "
        f"{batch}x{steps} teacher-forced steps ({tf_cfg.n_layers} layers), "
        f"{checked} tokens decided "
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


def run_bwd_kernel_phase(torch, K, ops, timer, k2=None, k4=None,
                         dtypes=None, k4_shape=None):
    """K2's g_x is held bit for bit (every per-row value rounds as the
    plain version rounds); each parameter grad within gamma_k times the sum
    of its terms' magnitudes (k the row count: the two sum the same terms
    in other orders), which also demands exact zeros wherever every term
    is zero (padded lanes, skipped tiles).  K4's g_x within 2 I/O ulps plus
    the f32 term of K3 (the norm's row mean is summed in another order,
    the activation's exp/tanh may differ by a few ulps); its parameter
    grads as K2's, plus, where an activation sits between the stacks, the
    same f32 term relative to the sum of magnitudes.  A second launch must
    give bitwise equal outputs.  ``k2``, ``k4``, ``dtypes`` and
    ``k4_shape`` = (n, strides) replace the cases, the dtypes and K4's
    2048-wide 11-stage shape (phase 22); ``timer`` None holds the cases
    without timing them."""
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
    for kern, args, kw in () if k2 is not None else (
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
    for dt in dtypes or (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        esz = torch.tensor([], dtype=dt).element_size()
        for label, n, strides, rows, in_w, out_w in (k2_cases() if k2 is None
                                                     else k2):
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
            ms = plain_ms = lib_ms = None
            if timer is not None:
                ms = timer(lambda: ops.backward_runs(
                    K.spm_stack_bwd_kernel_call, *args))
                plain_ms = timer(lambda: ops.backward_runs(
                    K.spm_stack_bwd_plain, *args))
                # yardstick: a dense linear's backward, g_x = gy W^T and
                # g_W = x^T gy, which the port never calls
                w = rnd(in_w, out_w).to(dt)
                lib_ms = timer(lambda: (torch.matmul(gy, w.T),
                                        torch.matmul(x.T, gy)))
                del w
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
                f"det={det} ms={fmt_ms(ms)} (before {fmt_ms(p15)}) "
                f"plain_ms={fmt_ms(plain_ms)} "
                f"bound_ms={bms:.4f} ({bby}) library_ms={fmt_ms(lib_ms)} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"K2 {label} {dname} rows={rows}")

        n, strides = k4_shape or (2048, tuple(1 << i for i in range(11)))
        L1 = len(strides)
        for label, rows, out_w, act, two, res in (k4_cases() if k4 is None
                                                  else k4):
            kw = dict(coeffs1=mix(L1, n), d_in1=vec(n), d_out1=vec(n),
                      bias1=0.1 * rnd(n), gamma=vec(n), strides1=strides,
                      in_width=n, out_width=out_w, mid_width=out_w)
            if two:
                kw.update(coeffs2=mix(L1, n), d_in2=vec(n), d_out2=vec(n),
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
            L_tot = L1 * (2 if two else 1)
            diff = (kern[0].float() - plain[0].float()).abs()
            t32 = k3_f32_term(n, L_tot, plain[0].float().abs().max().item())
            gx_worst = (diff / (2 * ulp(plain[0], dname) + t32)).max().item()
            rel = (8 * (4 + 3 * L_tot + 12) * EPS["float32"]
                   if act is not None else 0.0)
            worst = grads_within(kern[1:], plain[1:], mags[1:], rows, rel)
            det = all(torch.equal(u, v) for u, v in zip(kern, again))
            err = max((u.float() - v.float()).abs().max().item()
                      for u, v in zip(kern, plain))
            ms = plain_ms = lib_ms = None
            if timer is not None:
                ms = timer(lambda: K.spm_block_bwd_kernel_call(
                    x, gy, rstd=rstd, **kw))
                plain_ms = timer(lambda: K.spm_block_bwd_plain(
                    x, gy, rstd=rstd, **kw))
            n_vec = 4 + (4 if two else 0)
            nbytes = (rows * (2 * n + out_w) * x.element_size() + rows * 4
                      + 2 * L_tot * n // 2 * 16 + 2 * 4 * n * n_vec)
            flops = rows * n * (10 * L_tot + (30 if two else 12))
            bms, bby = bound(nbytes, flops)
            # yardstick: a dense backward's two products for each linear of
            # the block, g_x = gy W^T and g_W = xh^T gy
            # (xh stands in for the mid activation and its cotangent)
            if timer is not None:
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
                f"det={det} dead lanes 0={dead_zero} ms={fmt_ms(ms)} "
                f"(before {fmt_ms(prev)}) plain_ms={fmt_ms(plain_ms)} "
                f"bound_ms={bms:.4f} ({bby}) library_ms={fmt_ms(lib_ms)} "
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
    from repro_torch.train.chaos import ChaosSchedule
    args = launch_train.build_parser().parse_args(
        ["--arch", cfg.name, "--steps", str(steps), "--batch", str(batch),
         "--seq", str(seq), "--log-every", "1"]
        + (["--quantize"] if quantize else []))
    losses, skipped, secs = [], [], []
    snap, unchanged = {}, None

    signature = {}

    def on_step(s, state, metrics, dt):
        nonlocal unchanged
        if not signature:
            signature.update(param_signature(state["params"]))
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
    launch_train.train(args, chaos=ChaosSchedule.parse(f"nan@{poisoned}"),
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
               poisoned_state_unchanged=unchanged,
               param_signature=signature)
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

def parity_batch(torch, cfg, batch: int, seq: int) -> dict:
    """A training batch from seed 5: tokens and labels, or for an
    embeddings-input config unit-normal embeddings, with the M-RoPE ids of
    a synthetic 4 x 4 patch grid under ``mrope`` (three distinct rows)."""
    from repro_torch.launch.train import patch_grid_positions
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen)
    b = {"labels": toks[:, 1:]}
    if cfg.input_kind == "tokens":
        b["tokens"] = toks[:, :-1]
        return b
    b["embeds"] = torch.randn(batch, seq, cfg.d_model, generator=gen)
    if cfg.rope_kind == "mrope":
        b["positions"] = patch_grid_positions(seq, 4)[:, None, :].expand(
            3, batch, seq).contiguous()
    return b


def train_depth(cfg, seq: int) -> int:
    """Dependent roundings of one training step of ``cfg`` (forward and
    backward), counted as the CPU tests count them: per layer the norm's
    d_model, 3 per stage of each stack, the head's scores over head_dim
    and keys, the MLP's three stacks (an MoE's expert stacks, its router
    over the experts and its top-k combine) and the residual path."""
    L_attn = cfg.attn_cfg(cfg.layers[0]).q_proj.spm_config().n_stages
    ffn = cfg.moe_cfg().expert_ffn if cfg.n_experts else cfg.ffn_cfg()
    L_ffn = ffn.gate.spm_config().n_stages
    per_layer = (cfg.d_model + 3 * L_attn + 8 + cfg.head_dim + seq
                 + 3 * L_attn + 3 * (3 * L_ffn + 4) + cfg.d_model)
    if cfg.n_experts:
        per_layer += cfg.n_experts + 4 * cfg.top_k
    return 2 * (cfg.n_layers * per_layer + 2 * cfg.d_model)


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
    b = parity_batch(torch, cfg, batch, seq)
    rel = 8 * math.sqrt(train_depth(cfg, seq)) * EPS["float32"]
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
    b = parity_batch(torch, cfg, batch, seq)
    rel = 8 * math.sqrt(train_depth(cfg, seq)) * EPS["float32"]
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
    weights, cut to their first ``PARITY_LAYERS`` layers, teacher-forced
    on the card and on the CPU (batch 4, prompt 16, 32 steps), the CPU
    replaying the card's int8 codes as in phase 10, so
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
    t = time.perf_counter()
    tokens, flags = eng.generate(prompts, max_new_tokens=new,
                                 return_flags=True)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t
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
    tn = min(counted_s, wall(new))      # the counted run is the first rep
    launch_ok = got_fwd == want and got["K2"] == 0 and got["K4"] == 0
    ok_tokens = (tuple(tokens.shape) == (batch, new) and not bool(flags.any())
                 and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()))

    del eng
    cfg, params = cut_depth(cfg, params)
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
SHARDED_STEPS = 4       # phases 13 and 16 (6 before: the seconds went to
                        # phase 25)


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
                      steps=SHARDED_STEPS, poisoned=2, new=16, overlap=False,
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


# ---------------------------------------------------------------------------
# phase 20: continuous batching
# ---------------------------------------------------------------------------

CB_SLOTS = 8
CB_MAX_LEN = 576
CB_PROMPTS = (9, 37, 120, 250, 512, 64)      # cycled: buckets 16 to 512
CB_NEW = (16, 32, 64)                         # cycled max_new_tokens
# cycled (temperature, top_k, top_p): greedy, top-k, top-p, both
CB_SAMPLING = ((0.0, 0, 1.0), (0.8, 50, 1.0), (1.0, 0, 0.9),
               (0.7, 20, 0.95))
CB_REQUESTS = 24
CB_LOADS = (0.25, 2.0)                        # Poisson requests a tick
CB_SIDE_REQUESTS = 8                          # the int8 and overlap runs
CB_SIDE_LAYERS = 8                            # their depth, of 28
Q8_SERVE_LAYERS = 8                           # phase 11's served depth, of
                                              # 28 (full before; the
                                              # seconds went to phase 25)
CB_LAYERS = 8                                 # the main serve's depth, of
                                              # 28 (full before; the
                                              # seconds went to phase 25)


def cb_requests(torch, Request, vocab, n=CB_REQUESTS):
    """The phase's requests: prompts from a seeded generator, lengths,
    budgets and sampling cycled."""
    gen = torch.Generator().manual_seed(20)
    out = []
    for i in range(n):
        t, k, p = CB_SAMPLING[i % len(CB_SAMPLING)]
        plen = CB_PROMPTS[i % len(CB_PROMPTS)]
        out.append(Request(
            prompt=torch.randint(0, vocab, (plen,), generator=gen),
            max_new_tokens=CB_NEW[i % len(CB_NEW)], temperature=t,
            top_k=k, top_p=p, rid=i))
    return out


@contextlib.contextmanager
def tick_clock(torch, eng):
    """Times each of ``eng``'s ticks, from its call until the device has
    finished it (the engine reads the new tokens right after, so the
    synchronize adds no wait of its own); yields the list of ms."""
    inner, ms = eng._tick, []

    def tick():
        t = time.perf_counter()
        bad = inner()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        return bad

    eng._tick = tick
    try:
        yield ms
    finally:
        eng._tick = inner


def cb_plan(planner, eng, reqs, ticks: int) -> dict:
    """Launches the plan gives a serve: ``planner(rows)`` (a dict of one
    forward's launches) for each request's prefill of one row of its
    bucket, plus ``ticks`` ticks at ``slots`` rows."""
    total = {}
    for rows, times in [(eng._bucket(len(r.prompt)), 1) for r in reqs] \
            + [(eng.slots, ticks)]:
        for k, v in planner(rows).items():
            total[k] = total.get(k, 0) + times * v
    return total


def cb_serve(torch, K, eng, reqs, arrivals, planner, counts, vocab):
    """One serve with the launch counts set to 0 just before and read just
    after: every request exactly its ``max_new_tokens`` tokens, in range,
    unflagged; arrival <= admitted <= finished; occupancy within the pool;
    launches equal to ``cb_plan``.  Tokens/s, ms a tick, occupancy, tick
    latencies (finished - arrival; nearest rank, as
    ``benchmarks/torch_serve_bench.py``) and peak memory."""
    from repro_torch.serve.schedule import percentile_ticks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    with tick_clock(torch, eng) as ms:
        t0 = time.perf_counter()
        results, stats = eng.serve(reqs, arrival_ticks=arrivals)
        wall = time.perf_counter() - t0
    got = counts()
    plan = cb_plan(planner, eng, reqs, len(ms))
    bad = []
    for i, r in enumerate(reqs):
        res = results[r.rid]
        toks = res["tokens"]
        if (len(toks) != r.max_new_tokens or res["flagged"]
                or not all(0 <= t < vocab for t in toks)
                or not arrivals[i] <= res["admitted_tick"]
                <= res["finished_tick"]):
            bad.append(r.rid)
    lat = [results[r.rid]["finished_tick"] - arrivals[i]
           for i, r in enumerate(reqs)]
    ms_sorted = sorted(ms)
    res = dict(requests=len(reqs), ticks=stats["ticks"],
               ticks_run=len(ms), tokens=stats["tokens"], wall_s=wall,
               tokens_per_s=stats["tokens"] / wall,
               tick_ms_median=ms_sorted[len(ms) // 2] if ms else None,
               tick_ms_p90=ms_sorted[int(0.9 * (len(ms) - 1))] if ms
               else None,
               occupancy=stats["occupied_slot_ticks"]
               / max(stats["ticks"] * eng.slots, 1),
               p50_latency_ticks=percentile_ticks(lat, 0.50),
               p99_latency_ticks=percentile_ticks(lat, 0.99),
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=got, planned=plan, bad_requests=bad)
    ok = (not bad and got == plan
          and stats["occupied_slot_ticks"] <= stats["ticks"] * eng.slots)
    return res, results, ok


def cb_teacher_forced(torch, LM, cfg, params, reqs, results, tol):
    """Each greedy request at batch 1 through ``LM.prefill`` (no padding)
    and ``LM.decode_step``, fed the pool's tokens: wherever the top-2 gap
    exceeds ``tol`` the card's argmax must be the pool's token.  Teacher
    forcing keeps both sides on the same inputs, so every decided token is
    compared, past the first undecided one too.  Returns (decided,
    mismatches, the index of each request's first undecided token)."""
    decided = mism = 0
    first_tie = []
    with torch.inference_mode():
        for r in reqs:
            if r.temperature > 0:
                continue
            toks = results[r.rid]["tokens"]
            prompt = r.prompt.to(DEVICE)[None]
            n = prompt.shape[1]
            lg, cache = LM.prefill(params, cfg, max_len=n + len(toks),
                                   tokens=prompt)
            tie = len(toks)
            for j, t in enumerate(toks):
                top2, arg = torch.topk(lg.float()[0], 2)
                if (top2[0] - top2[1]).item() > tol:
                    decided += 1
                    mism += int(arg[0].item() != t)
                else:
                    tie = min(tie, j)
                if j + 1 < len(toks):
                    lg, cache = LM.decode_step(
                        params, cfg, torch.tensor([t], device=DEVICE), cache,
                        n + j)
            first_tie.append(tie)
    return decided, mism, first_tie


def cb_side_run(torch, K, T, ContinuousBatchingEngine, Request, cfg,
                planner, counts, label, ctx):
    """``CB_SIDE_REQUESTS`` of the phase's requests (arriving as at 2.0
    requests a tick) through the continuous engine on another executor,
    cut to ``CB_SIDE_LAYERS`` layers: tokens in range, unflagged, launches
    as planned.  No parity is claimed."""
    from repro_torch.serve.schedule import poisson_arrivals
    side = dataclasses.replace(cfg, n_layers=CB_SIDE_LAYERS,
                               layers=cfg.layers[:CB_SIDE_LAYERS])
    params = T.init_model(side, seed=0, device=DEVICE)
    eng = ContinuousBatchingEngine(side, params, slots=CB_SLOTS,
                                   max_len=CB_MAX_LEN,
                                   cache_dtype=torch.bfloat16, seed=0,
                                   device=DEVICE)
    reqs = cb_requests(torch, Request, cfg.vocab_size, CB_SIDE_REQUESTS)
    arrivals = poisson_arrivals(len(reqs), 2.0, 0)
    with ctx:
        eng.serve([Request(prompt=torch.zeros(8, dtype=torch.long),
                           max_new_tokens=2, rid=10**6)])
        res, _, ok = cb_serve(torch, K, eng, reqs, arrivals,
                              lambda rows: planner(side, rows), counts,
                              cfg.vocab_size)
    del eng, params
    torch.cuda.empty_cache()
    res.update(label=label, layers=CB_SIDE_LAYERS)
    log(f"continuous {label} ({CB_SIDE_LAYERS} of {cfg.n_layers} layers, "
        f"full width) on {gpu_line()}: {len(reqs)} requests, {res['tokens']} tokens in "
        f"{res['ticks']} ticks, {res['tokens_per_s']:.1f} tok/s, median "
        f"tick {res['tick_ms_median']:.1f} ms, launches {res['launches']} "
        f"(planned {res['planned']}), bad requests {res['bad_requests']} "
        f"{'ok' if ok else 'FAIL'}")
    return res, ok


def run_continuous_phase(torch, K, ops, T, LM, cfg, timer):
    """``ContinuousBatchingEngine`` on full-width ``cfg`` (cut in depth by
    the caller)
    (seed-0 weights, bf16 KV cache, ``CB_SLOTS`` slots, ``CB_MAX_LEN``):
    after a warm-up request, ``CB_REQUESTS`` requests at each load of
    ``CB_LOADS`` (Poisson arrivals from seed 0), each serve checked by
    ``cb_serve`` (launches: K1 and K3 as ``planned_launches`` gives one
    prefill row of each request's bucket and each tick at ``CB_SLOTS``
    rows).  Then churn parity: every request gives the same tokens bit for
    bit at both loads, and three (greedy, top-k, top-p) served alone
    through the same 8-slot engine give them too; each greedy request
    against the card at batch 1, teacher-forced (``cb_teacher_forced``,
    phase 4's bf16 tolerance), at least ``MIN_DECIDED`` tokens decided in
    all; K1 and K3 against their plain versions at the tick's rows and
    every bucket's prefill rows, as phase 2 holds them.  Measured: admit (prefill and
    first sample) ms per bucket, and one traced tick's device busy ms and
    idle share.  Last, ``cb_side_run`` on ``with_quantized_io`` (K1's int8
    modes) and on the 4-shard overlap executor (K5) under the mesh."""
    from repro_torch.serve.schedule import poisson_arrivals
    from repro_torch.configs import (with_feature_sharding,
                                     with_overlap_executor,
                                     with_quantized_io)
    from repro_torch.parallel import activation_sharding, make_feature_mesh
    from repro_torch.serve import ContinuousBatchingEngine, Request
    failures = []
    gpu = gpu_line()
    params = T.init_model(cfg, seed=0, device=DEVICE)
    eng = ContinuousBatchingEngine(cfg, params, slots=CB_SLOTS,
                                   max_len=CB_MAX_LEN,
                                   cache_dtype=torch.bfloat16, seed=0,
                                   device=DEVICE)
    V = cfg.vocab_size
    eng.serve([Request(prompt=torch.zeros(16, dtype=torch.long),
                       max_new_tokens=4, rid=10**6)])    # warm-up

    def planner(rows):
        return dict(zip(("K1", "K3"), planned_launches(cfg, ops, rows)))

    def counts():
        return {"K1": K.spm_stack_kernel_call.launches,
                "K3": K.spm_block_kernel_call.launches}

    loads, served = {}, {}
    for load in CB_LOADS:
        reqs = cb_requests(torch, Request, V)
        arrivals = poisson_arrivals(len(reqs), load, 0)
        res, results, ok = cb_serve(torch, K, eng, reqs, arrivals, planner,
                                    counts, V)
        res["arrivals"] = arrivals
        loads[load], served[load] = res, results
        log(f"continuous serve at {load} requests/tick on {gpu}: "
            f"{res['requests']} "
            f"requests, {res['tokens']} tokens in {res['ticks']} ticks "
            f"({res['ticks_run']} run), {res['wall_s']:.2f} s, "
            f"{res['tokens_per_s']:.1f} tok/s, median tick "
            f"{res['tick_ms_median']:.2f} ms (p90 {res['tick_ms_p90']:.2f}), "
            f"occupancy {res['occupancy']:.3f}, latency p50 "
            f"{res['p50_latency_ticks']} p99 {res['p99_latency_ticks']} "
            f"ticks, peak {res['peak_mem_bytes'] / 2**30:.2f} GiB, launches "
            f"{res['launches']} (planned {res['planned']}), bad requests "
            f"{res['bad_requests']} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"continuous serve at {load}")

    # churn parity at equal slot count
    busy_load = max(CB_LOADS)
    base = served[busy_load]
    across = [rid for rid in base
              if base[rid]["tokens"] != served[min(CB_LOADS)][rid]["tokens"]]
    alone = {}
    picks = [next(r for r in cb_requests(torch, Request, V)
                  if (r.temperature > 0, r.top_k > 0, r.top_p < 1) == kind)
             for kind in ((False, False, False), (True, True, False),
                          (True, False, True))]
    for r in picks:
        solo, _ = eng.serve([r])
        alone[r.rid] = solo[r.rid]["tokens"] == base[r.rid]["tokens"]
    parity_ok = not across and all(alone.values())
    log(f"continuous churn parity ({CB_SLOTS} slots): requests differing "
        f"between the loads {across}; alone == pool {alone} "
        f"{'ok' if parity_ok else 'FAIL'}")
    if not parity_ok:
        failures.append("continuous churn parity")

    # greedy requests at batch 1, teacher-forced, within phase 4's bound
    emb = params["embed"]
    w = emb["table"] if cfg.tie_embeddings else emb["out"].T
    h_norm = (cfg.d_model ** 0.5
              * params["final_norm"]["scale"].abs().max().item())
    tol = 2 * 2.0 ** -8 * h_norm * w.float().norm(dim=-1).max().item()
    t0 = time.perf_counter()
    decided, mism, first_tie = cb_teacher_forced(
        torch, LM, cfg, params, cb_requests(torch, Request, V), base, tol)
    tf_ok = mism == 0 and decided >= MIN_DECIDED
    log(f"continuous greedy against batch 1 (teacher-forced, tol "
        f"{tol:.3e}): {decided} tokens decided (at least {MIN_DECIDED}), "
        f"{mism} differ; first undecided token of each {first_tie} "
        f"({time.perf_counter() - t0:.1f} s) {'ok' if tf_ok else 'FAIL'}")
    if not tf_ok:
        failures.append("continuous greedy against batch 1")

    # admit (prefill of one bucket row and the first sample) ms per bucket
    admit_ms = {}
    gen = torch.Generator().manual_seed(21)
    with torch.inference_mode():
        eng._reset()
        for plen in sorted(set(CB_PROMPTS)):
            req = Request(prompt=torch.randint(0, V, (plen,), generator=gen),
                          max_new_tokens=1, rid=10**6 + plen)
            times = []
            for _ in range(4):
                res = {req.rid: {"tokens": [], "flagged": False,
                                 "admitted_tick": None,
                                 "finished_tick": None}}
                t = time.perf_counter()
                eng._admit([(0, req)], 0, res)
                times.append((time.perf_counter() - t) * 1e3)
            admit_ms[eng._bucket(plen)] = sorted(times[1:])[1]
        busy, groups = traced_device_ms(torch, eng._tick)
    med = loads[busy_load]["tick_ms_median"]
    log(f"continuous admit ms by bucket on {gpu} (prefill + first sample, "
        "median of 3): " + ", ".join(f"{b}: {v:.2f}" for b, v in admit_ms.items())
        + f"; a traced tick at {CB_SLOTS} rows: device busy {busy:.3f} ms "
        f"(idle {1 - busy / med:.1%} of the median tick {med:.2f} ms), by "
        "group " + ", ".join(f"{g} {ms:.3f} ms/{n}" for g, (n, ms) in
                             sorted(groups.items(), key=lambda kv: -kv[1][1])))
    served_rows = sorted({CB_SLOTS} | {eng._bucket(len(r.prompt)) for r in
                                       cb_requests(torch, Request, V)})
    del eng, params
    torch.cuda.empty_cache()

    # K1 and K3 at every row count the serve gave them: the tick's and each
    # bucket's prefill (the forward planner picks its walk by row count)
    qkv = tuple(1 << i for i in range(11))
    ffn = qkv + (3072,)
    k1 = [(lab, n, st, rows, iw, ow) for rows in served_rows
          for lab, n, st, iw, ow in (("o", 2048, qkv, 2048, 2048),
                                     ("up", 6144, ffn, 2048, 6144),
                                     ("down", 6144, ffn, 6144, 2048))]
    k3 = [(lab, rows, ow, None, False) for rows in served_rows
          for lab, ow in (("q", 2048), ("kv", 1024))]
    kernel_rows, kfail = run_kernel_phase(torch, K, ops, timer, k1=k1, k3=k3,
                                          dtypes=(torch.bfloat16,))
    failures += kfail

    # the other executors, full width, depth cut
    int8, int8_ok = cb_side_run(
        torch, K, T, ContinuousBatchingEngine, Request,
        with_quantized_io(cfg), lambda c, rows: dict(
            planned_q8_launches(c, ops, rows), K2=0, K4=0,
            **{"K2 int8": 0, "K2 int8 io": 0}), lambda: q8_counts(K),
        "int8 (with_quantized_io)", contextlib.nullcontext())
    scfg = with_overlap_executor(with_feature_sharding(cfg, SHARDS), True)

    def sharded_plan(c, rows):
        f = planned_sharded_launches(c, rows)
        return with_int8({"K1": f["K1"], "K1 col_base": f["K1 col_base"],
                          "K2": 0, "K2 col_base": 0, "K3": 0, "K4": 0,
                          "K5": f["K5"], "K5 col_base": f["K5 col_base"],
                          "K6": 0, "K6 col_base": 0}, False)

    overlap, overlap_ok = cb_side_run(
        torch, K, T, ContinuousBatchingEngine, Request, scfg, sharded_plan,
        lambda: sharded_counts(K), f"overlap ({SHARDS} shards)",
        activation_sharding(make_feature_mesh(SHARDS, device=DEVICE),
                            shard_feature=True))
    if not int8_ok:
        failures.append("continuous int8")
    if not overlap_ok:
        failures.append("continuous overlap")
    out = dict(gpu=gpu, slots=CB_SLOTS, max_len=CB_MAX_LEN, loads=loads,
               parity=dict(differing_between_loads=across, alone=alone),
               teacher_forced=dict(decided=decided, mismatches=mism,
                                   first_undecided=first_tie, tol=tol,
                                   min_decided=MIN_DECIDED),
               admit_ms_by_bucket=admit_ms, traced_tick_busy_ms=busy,
               traced_tick_idle_share=1 - busy / med,
               traced_tick_groups={g: {"launches": n, "ms": ms}
                                   for g, (n, ms) in groups.items()},
               kernels=kernel_rows, int8=int8, overlap=overlap)
    return out, failures


# ---------------------------------------------------------------------------
# phase 21: the training substrate (checkpoints, recovery, chaos) on the card
# ---------------------------------------------------------------------------

CHAOS_STEPS = 12
CHAOS_EVERY = 6
CHAOS_SPEC = "nan@6+5;corrupt@11:delmeta;preempt@11;slow@11:2.0"
CHAOS_EVENTS = ["skip"] * 5 + ["rollback", "slow_step", "chaos_corrupt",
                               "chaos_preempt", "restart", "quarantine"]
# three published steps, one quarantined and one in staging, of ~3.96 GB
CHAOS_FREE_BYTES = 20 * 10 ** 9
RESIDENT_SLACK = 64 << 20       # allocator slack between two lives' states
ELASTIC_ROWS, ELASTIC_STEPS, ELASTIC_EVERY = 4096, 12, 3
ELASTIC_SPEC = "nan@4+2;corrupt@8:truncate;preempt@9"
ELASTIC_EVENTS = ["rollback", "chaos_corrupt", "chaos_preempt",
                  "restart_budget_exhausted", "quarantine"]


def state_diff(torch, a, b):
    """The first leaf (as a dotted path) where two train states differ
    bit for bit, ``"structure"`` when their trees differ, else None."""
    from repro_torch.train.state import tree_leaves_with_path
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        return "structure"
    for (p, x), (_, y) in zip(la, lb):
        if x.dtype != y.dtype or not torch.equal(x, y):
            return ".".join(map(str, p))
    return None


def train_life(torch, K, launch_train, args, chaos=None, timings=None):
    """One ``launch.train.train`` call.  Returns its final state and a
    record: wall seconds, each executed step's index and seconds, the
    kernels' launches, the peak memory, and per segment (a new one starts
    where the step index goes back: a rollback or a restart) its peak and
    the bytes allocated after its last step (one state's worth plus what
    lives beside it: a dead attempt's state left behind would show)."""
    steps, secs, peaks, resident = [], [], [], []

    def on_step(s, state, metrics, dt):
        steps.append(s)
        secs.append(dt)
        peaks.append(torch.cuda.max_memory_allocated())
        resident.append(torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    state = launch_train.train(args, chaos=chaos, on_step=on_step,
                               timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cut = [0] + [i for i in range(1, len(steps)) if steps[i] <= steps[i - 1]]
    segments = [dict(first_step=steps[a], steps=b - a,
                     peak_bytes=max(peaks[a:b]),
                     resident_bytes=resident[b - 1])
                for a, b in zip(cut, cut[1:] + [len(steps)])]
    return state, dict(wall_s=wall, steps=steps, step_s=secs,
                       peak_bytes=max(peaks), segments=segments,
                       launches={k: v for k, v in q8_counts(K).items()
                                 if " " not in k})


def median(xs):
    s = sorted(xs)
    return s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1]
                                                     + s[len(s) // 2])


def run_elastic_case(torch, K, cfg, root):
    """Part (a) and (b) of the elastic contract at ``cfg``'s 2048-wide SPM
    linear (n = d_model, its stage count), ``ELASTIC_ROWS`` rows of f32,
    schedule pinned to 4 shards (``schedule_shards``), all shards on the
    card: an SPM regression with the driver's wiring
    (``tests/test_torch_substrate.py``'s job at full width).
    (a) Life 1 trains 4-way under ``ELASTIC_SPEC`` with no restart budget:
    a 2-step NaN burst rolls back to step_3, step_9 is truncated, a
    preemption kills it.  Life 2 resumes 2-way: step_9 quarantined, walked
    back to step_6.  It must end bit for bit equal to a fault-free run that
    trains 4-way for steps 0-5 and 2-way for 6-11.  (b) step_6 restored
    and differentiated on 4 shards and on 2: every grad within gamma_rows
    of the sum of its terms' magnitudes (the grads of the operator on
    absolute values of every input); whether the grads are bitwise is
    reported.  Then K1 and K2 at every local run of both widths against
    their plain versions, untimed, held as phase 12 holds them."""
    from repro_torch.core.spm import SPMConfig, init_spm, spm_apply
    from repro_torch.optim import OptimizerConfig
    from repro_torch.parallel import activation_sharding, make_feature_mesh
    from repro_torch.params import Params
    from repro_torch import train as TR
    from repro_torch.train.chaos import ChaosPreemption, ChaosSchedule
    o = cfg.attn_cfg(cfg.layers[0]).o_proj.spm_config()
    n, L, rows = o.n, o.n_stages, ELASTIC_ROWS
    meshes = {m: make_feature_mesh(m, device=DEVICE) for m in (4, 2)}

    def scfg(m):
        return SPMConfig(n=n, n_stages=L, schedule="two_level", n_shards=m,
                         schedule_shards=4, backward="custom")

    def batch(step):
        g = torch.Generator(device=DEVICE).manual_seed(9000 + step)
        return {k: torch.randn(rows, n, generator=g, device=DEVICE)
                for k in ("x", "y")}

    def forward(p, x, m):
        with activation_sharding(meshes[m], shard_feature=True):
            return spm_apply(p, x, scfg(m))

    def loss_fn(p, b, m):
        loss = torch.mean((forward(p, b["x"], m) - b["y"]) ** 2)
        return loss, {"loss": loss}

    def fresh():
        return TR.make_train_state(init_spm(
            scfg(4), torch.Generator(device=DEVICE).manual_seed(0),
            torch.device(DEVICE)))

    def run(d, m, chaos=None, event_log=None, until=ELASTIC_STEPS):
        event_log = event_log or TR.FaultEventLog()
        step_fn = TR.make_train_step(
            lambda p, b: loss_fn(p, b, m),
            OptimizerConfig(lr=1e-2, total_steps=ELASTIC_STEPS),
            chaos_guard=True)

        def try_restore():
            state = fresh()
            step = TR.latest_valid_step(d, event_log=event_log)
            if step is None:
                return state, 0
            state, extra = TR.restore_checkpoint(d, state, step=step,
                                                 event_log=event_log)
            return state, int(extra["cursor"]["step"])

        def loop(resume):
            state, s = try_restore()
            policy = TR.FaultPolicy(max_consecutive_skips=2)
            while s < until:
                poison = chaos.poison(s) if chaos else 0.0
                state, metrics = step_fn(state, batch(s), poison)
                if policy.on_metrics({"skipped": float(metrics["skipped"])}):
                    event_log.emit("rollback", step=s)
                    state, s = try_restore()
                    policy.reset()
                    continue
                s += 1
                if s % ELASTIC_EVERY == 0:
                    TR.save_checkpoint(d, s, state, extra={
                        "cursor": {"seed": 0, "step": s}})
                if chaos:
                    chaos.post_step(s - 1, d, event_log=event_log)
            return state

        return TR.run_with_recovery(loop, max_restarts=0,
                                    event_log=event_log,
                                    sleep=lambda _: None)

    t0 = time.perf_counter()
    clean, chaos_dir = (os.path.join(root, k) for k in ("clean", "chaos"))
    K.reset_launch_counts()
    run(clean, 4, until=6)
    ref = run(clean, 2)
    launches = {"K1": K.spm_stack_kernel_call.launches,
                "K2": K.spm_stack_bwd_kernel_call.launches}
    elog = TR.FaultEventLog(os.path.join(chaos_dir, "events.jsonl"))
    chaos = ChaosSchedule.parse(ELASTIC_SPEC)
    died = False
    try:
        run(chaos_dir, 4, chaos, elog)
    except ChaosPreemption:
        died = True
    resumed = run(chaos_dir, 2, event_log=elog)
    diff_a = state_diff(torch, ref, resumed)
    quarantined = [k for k in os.listdir(chaos_dir)
                   if k.startswith("corrupt.9.")]
    final = TR.verify_checkpoint(chaos_dir, ELASTIC_STEPS)
    del ref, resumed
    ok_a = (died and diff_a is None and not chaos.remaining()
            and len(quarantined) == 1 and final == []
            and elog.kinds() == ELASTIC_EVENTS and min(launches.values()) > 0)

    # (b): one step's grads of step_6 at each width
    b6 = batch(6)
    grads = {}
    for m in (4, 2):
        st, _ = TR.restore_checkpoint(clean, fresh(), step=6)
        loss, _ = loss_fn(st["params"], b6, m)
        grads[m] = torch.autograd.grad(loss, list(st["params"].parameters()))
    p = st["params"]
    with torch.no_grad():
        y = forward(p, b6["x"], 4)
        gy = 2 * (y - b6["y"]) / y.numel()
    absp = Params({k: v.detach().abs() for k, v in p.named_parameters()})
    absp.trainable()
    mags = torch.autograd.grad(forward(absp, b6["x"].abs(), 4),
                               list(absp.parameters()), gy.abs())
    worst_b = grads_within(grads[4], grads[2], mags, rows)
    bitwise_b = all(torch.equal(u, v) for u, v in zip(grads[4], grads[2]))
    names = [k for k, _ in p.named_parameters()]
    differing = [k for k, u, v in zip(names, grads[4], grads[2])
                 if not torch.equal(u, v)]
    ok_b = worst_b <= 1 and all(bool(torch.isfinite(g).all())
                                for g in grads[4])
    del grads, mags, absp, st, p

    # K1 and K2 at each width's local runs, as phase 12 holds them
    g = torch.Generator(device=DEVICE).manual_seed(1357)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=DEVICE)

    abs_sum = (lambda t: t.abs().sum(0))
    runs = []
    for m in (4, 2):
        nl, steps, plans = shard_run(scfg(m), rows)
        for plan in plans:
            for rs, nt in plan:
                th = (torch.rand(len(rs), nt // 2, generator=g,
                                 device=DEVICE) * 2 - 1) * math.pi
                c, s = torch.cos(th), torch.sin(th)
                cf = torch.stack([c, -s, s, c], dim=-1) + rnd(
                    len(rs), nt // 2, 4, scale=0.05)
                d_in, d_out, bias = 1 + 0.1 * rnd(nt), 1 + 0.1 * rnd(nt), \
                    0.1 * rnd(nt)
                x, gyr = rnd(rows, nt), rnd(rows, nt)
                kw = dict(strides=rs, n_tile=nt)
                bw = dict(kw, has_bias=True)
                y1 = K.spm_stack_kernel_call(x, cf, d_in, d_out, bias, **kw)
                y2 = K.spm_stack_kernel_call(x, cf, d_in, d_out, bias, **kw)
                yp = K.spm_stack_plain(x, cf, d_in, d_out, bias, **kw)
                ok, gx_err, worst, det = check_bwd(
                    torch,
                    lambda: K.spm_stack_bwd_kernel_call(x, cf, gyr, d_in,
                                                        d_out, **bw),
                    lambda: K.spm_stack_bwd_plain(x, cf, gyr, d_in, d_out,
                                                  **bw),
                    lambda: K.spm_stack_bwd_plain(x, cf, gyr, d_in, d_out,
                                                  col_sum=abs_sum, **bw),
                    rows)
                k1_err = (y1 - yp).abs().max().item()
                runs.append(dict(shards=m, n_local=nl, strides=list(rs),
                                 n_tile=nt, k1_max_abs_err=k1_err,
                                 k1_deterministic=torch.equal(y1, y2),
                                 k2_gx_max_abs_err=gx_err,
                                 k2_grad_over_limit=worst,
                                 k2_deterministic=det,
                                 ok=ok and k1_err == 0 and torch.equal(y1,
                                                                       y2)))
    ok_runs = all(r["ok"] for r in runs)
    res = dict(n=n, n_stages=L, rows=rows, shards=[4, 2],
               strides=list(scfg(4).pairing.strides()),
               launches=launches, died=died, state_diff=diff_a,
               events=elog.kinds(), quarantined=quarantined,
               final_verify=final, step_grad_over_limit=worst_b,
               step_grads_bitwise=bitwise_b,
               step_grads_differing=differing, runs=runs,
               seconds=time.perf_counter() - t0)
    resumed_msg = ("bit for bit the fault-free run" if diff_a is None
                   else "differs at " + diff_a)
    log(f"chaos train elastic: n={n} L={L} {rows} rows f32, 4 -> 2 shards "
        f"(schedule_shards=4): resumed state {resumed_msg}"
        f", events {elog.kinds()}, quarantined {quarantined}, launches "
        f"{launches} {'ok' if ok_a else 'FAIL'}; one step's grads 4-way vs "
        f"2-way worst {worst_b:.3f} of gamma_{rows} "
        f"({'bitwise' if bitwise_b else 'differing: ' + ', '.join(differing)}"
        f") {'ok' if ok_b else 'FAIL'}; K1/K2 at {len(runs)} local runs "
        f"{'ok' if ok_runs else 'FAIL'} ({res['seconds']:.1f} s)")
    failures = [] if ok_a else ["elastic resume"]
    failures += [] if ok_b else ["elastic step across widths"]
    failures += [] if ok_runs else ["elastic K1/K2 runs"]
    return res, failures


def run_chaos_phase(torch, K, ops, launch_train, cfg, smi):
    """``launch.train.train`` on full-width, full-depth ``cfg`` from seed 0,
    batch 8 x seq 512, ``CHAOS_STEPS`` steps, ``--ckpt-every CHAOS_EVERY``,
    ``--backoff-base 0``: two clean lives A and A' (bit for bit equal:
    every param, moment, count and step), then life B with a checkpoint
    dir under ``CHAOS_SPEC``: it saves step_6, skips 6-10 and rolls back
    to step_6 on the fifth skip, replays 6-11 (sleeping 2 s before 11),
    saves step_12, loses its meta.json, is preempted; the restart
    quarantines step_12, walks back to step_6, replays 6-11 and saves
    step_12 again.  B must equal A bit for bit, every chaos event fire,
    a ``corrupt.12.*`` dir remain and step_12 verify, and the events be
    exactly ``CHAOS_EVENTS`` (``slow_step`` at 11: the step clock starts
    before the sleep).  Launches equal the plan times the steps each life
    ran; B's allocation after its restart is no larger than before it (the
    dead attempt's state is gone).  Reported: checkpoint bytes, each save
    (device-to-host, write, hashing, publish), verify and restore, B's
    wall minus A's and the steps it replayed, step ms, each life's peak
    memory.  The checkpoint dir is under ``tempfile.mkdtemp()``, which
    must have ``CHAOS_FREE_BYTES`` free, and is removed at the end.  Then
    the elastic case (``run_elastic_case``)."""
    import shutil
    import tempfile
    from repro_torch.train import checkpoint as CK
    from repro_torch.train.chaos import ChaosSchedule
    root = tempfile.mkdtemp(prefix="spm_chaos_")
    try:
        free = shutil.disk_usage(root).free
        if free < CHAOS_FREE_BYTES:
            log(f"chaos train: {free / 1e9:.1f} GB free under {root}, "
                f"{CHAOS_FREE_BYTES / 1e9:.0f} GB needed FAIL")
            return dict(free_bytes=free), ["chaos disk space"]
        base = ["--arch", cfg.name, "--steps", str(CHAOS_STEPS), "--batch",
                "8", "--seq", "512", "--ckpt-every", str(CHAOS_EVERY),
                "--backoff-base", "0", "--log-every", str(CHAOS_EVERY)]
        parse = launch_train.build_parser().parse_args
        per_step = planned_train_launches(cfg, ops, 8 * 512)
        state_a, a = train_life(torch, K, launch_train, parse(base))
        state_a2, a2 = train_life(torch, K, launch_train, parse(base))
        diff_a = state_diff(torch, state_a, state_a2)
        del state_a2
        ck = os.path.join(root, "ckpt")
        chaos = ChaosSchedule.parse(CHAOS_SPEC)
        timings = []
        state_b, b = train_life(torch, K, launch_train,
                                parse(base + ["--ckpt-dir", ck]), chaos=chaos,
                                timings=timings)
        diff_b = state_diff(torch, state_a, state_b)
        del state_a, state_b
        final = CK.verify_checkpoint(ck, CHAOS_STEPS)
        with open(os.path.join(ck, "events.jsonl")) as f:
            events = [json.loads(line) for line in f]
        kinds = [e["kind"] for e in events]
        slow_at = [e["step"] for e in events if e["kind"] == "slow_step"]
        quarantined = sorted(k for k in os.listdir(ck)
                             if k.startswith("corrupt."))
        elastic, failures = run_elastic_case(torch, K, cfg, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    saves = [t for t in timings if t["op"] == "save"]
    verifies = [t for t in timings if t["op"] == "verify"]
    restores = [t for t in timings if t["op"] == "restore"]
    launches_ok = all(
        life["launches"] == {k: len(life["steps"]) * v
                             for k, v in per_step.items()}
        for life in (a, a2, b))
    seg = b["segments"]
    released = seg[-1]["resident_bytes"] <= seg[0]["resident_bytes"] \
        + RESIDENT_SLACK
    replayed = len(b["steps"]) - CHAOS_STEPS
    ok = (diff_a is None and diff_b is None and not chaos.remaining()
          and final == [] and kinds == CHAOS_EVENTS and slow_at == [11]
          and kinds.index("rollback") < kinds.index("restart")
          and len(quarantined) == 1
          and quarantined[0].startswith(f"corrupt.{CHAOS_STEPS}.")
          and launches_ok and released and len(saves) == 3)
    step_ms = 1e3 * median(a["step_s"][1:])
    res = dict(gpu=smi, steps=CHAOS_STEPS, ckpt_every=CHAOS_EVERY,
               spec=CHAOS_SPEC, free_bytes=free, clean_bitwise=diff_a is None,
               clean_first_diff=diff_a, chaos_bitwise=diff_b is None,
               chaos_first_diff=diff_b, events=kinds, slow_step_at=slow_at,
               quarantined=quarantined, final_verify=final,
               checkpoint_bytes=saves[0]["bytes"] if saves else None,
               saves=saves, verifies=verifies, restores=restores,
               lives={"A": a, "A'": a2, "B": b},
               wall_b_minus_a_s=b["wall_s"] - a["wall_s"],
               steps_replayed=replayed, step_ms_median=step_ms,
               planned_per_step=per_step, launches_ok=launches_ok,
               dead_attempt_released=released, elastic=elastic)

    def ms(xs, key="s"):
        return "/".join(f"{1e3 * x[key]:.0f}" for x in xs)

    log(f"chaos train ({smi}): A and A' "
        f"{'bit for bit' if diff_a is None else 'differ at ' + diff_a}, "
        f"B {'bit for bit A' if diff_b is None else 'differs at ' + diff_b}; "
        f"events {kinds}, slow_step at {slow_at}, quarantined {quarantined},"
        f" final verify {final or 'clean'}; launches as planned "
        f"{launches_ok}; dead attempt released {released} (resident "
        f"{seg[0]['resident_bytes'] / 2**30:.2f} -> "
        f"{seg[-1]['resident_bytes'] / 2**30:.2f} GiB) "
        f"{'ok' if ok else 'FAIL'}")
    log(f"chaos train ({smi}): checkpoint {res['checkpoint_bytes']} bytes; "
        f"save ms {ms(saves)} (device-to-host {ms(saves, 'd2h_s')}, write "
        f"{ms(saves, 'write_s')}, hashing {ms(saves, 'hash_s')}, publish "
        f"{ms(saves, 'publish_s')}); verify ms {ms(verifies)}; restore ms "
        f"{ms(restores)} (of it verify {ms(restores, 'verify_s')}); B wall "
        f"{b['wall_s']:.1f} s - A {a['wall_s']:.1f} s = "
        f"{res['wall_b_minus_a_s']:.1f} s, {replayed} steps replayed; step "
        f"{step_ms:.1f} ms (median of A's steps 2-{CHAOS_STEPS}); peak "
        f"A {a['peak_bytes'] / 2**30:.2f} A' {a2['peak_bytes'] / 2**30:.2f} "
        f"B {b['peak_bytes'] / 2**30:.2f} GiB (B by segment "
        f"{[round(s['peak_bytes'] / 2**30, 2) for s in seg]})")
    if not ok:
        failures = ["chaos train"] + failures
    return res, failures


# ---------------------------------------------------------------------------
# phase 22: the other dense-attention archs at full width
# ---------------------------------------------------------------------------

ARCHS = ("gemma3-12b", "qwen2-vl-7b", "musicgen-medium", "minitron-4b",
         "qwen3-32b")
ARCH_ROWS = 4           # served rows
ARCH_NEW = 16           # served tokens a row
ARCH_PROMPT = {"gemma3-12b": 1280}   # past the 1024-slot rings
ARCH_PROMPT_DEFAULT = 256
ARCH_TRAIN = (4, 512, 2)             # batch, seq, steps
ARCH_PATCH_GRID = 16    # qwen2-vl-7b's training M-RoPE ids: 16 x 16 patches
ARCH_BUDGET_S = 200
ARCH_LAYERS = {"gemma3-12b": 12, "qwen2-vl-7b": 7, "musicgen-medium": 12,
               "minitron-4b": 8, "qwen3-32b": 16}   # a quarter of each
# depth (gemma3-12b's two 5:1 local:global groups), full width
GEMMA_GROUP = 6         # one 5:1 local:global pattern group
GEMMA_PARITY_NEW = 4    # its teacher-forced tokens (16, then 6 before:
#                         the CPU's decode took the seconds phases 26 and
#                         27 needed)
QWEN2VL_PARITY_LAYERS = 1   # qwen2-vl-7b's card-vs-CPU step (2 before)
GEMMA_PROMPT = 1100     # the card-vs-CPU and continuous runs' longest
CONT_SLOTS = 4
CONT_PROMPTS = (9, 1100, 300, 37, 1024, 700, 120, 1030)
CONT_ARRIVALS = (0, 0, 1, 1, 3, 4, 6, 8)
# (label, tile, tiles, dense d_in, d_out): each lone stage wider than one
# cluster that the archs' FFNs give K2, with the linear it belongs to
LONE_CASES = (("minitron-4b gate", 9216, 1, 3072, 9216),
              ("qwen2-vl-7b gate, 4736 on 9472", 9472, 2, 3584, 18944),
              ("qwen3-32b gate, 6400 on 12800", 12800, 2, 5120, 25600),
              ("gemma3-12b gate", 15360, 1, 3840, 15360),
              ("qwen2-vl-7b gate, 9472 on 18944", 18944, 1, 3584, 18944),
              ("qwen3-32b gate, 12800 on 25600", 25600, 1, 5120, 25600))


def run_lone_k2_phase(torch, K, timer):
    """K2's split mode against its plain version at every lone wide tile
    (``LONE_CASES``), 8 and 2048 rows, bf16, the middle-run form (no
    vectors): g_x bit for bit, the table grads within gamma_rows, a second
    launch bitwise (``check_bwd``), the plan in split mode.  Timed as
    phase 5 (L2 flushed, CUDA events, mean of ``TIMED``); bound: x, gy
    and g_x moved once and the table and its grads, 16 f32 operations an
    element; yardstick: the dense backward's two products of the whole
    linear, which the port never calls.  At 2048 rows also held, untimed,
    with an int8 x (``--quantize``'s saved input, a scale each tile)."""
    from repro_torch.kernels import quant as Q
    rows_out, failures = [], []
    g = torch.Generator(device=DEVICE).manual_seed(2222)
    abs_sum = (lambda t: t.abs().sum(0))
    for label, nt, tiles, d_in, d_out in LONE_CASES:
        n = nt * tiles
        kw = dict(strides=(nt // 2,), n_tile=nt)
        for rows in (8, 2048):
            th = (torch.rand(1, n // 2, generator=g, device=DEVICE) * 2
                  - 1) * math.pi
            cf = torch.stack([torch.cos(th), -torch.sin(th), torch.sin(th),
                              torch.cos(th)], dim=-1)
            x = torch.randn(rows, n, generator=g, device=DEVICE).bfloat16()
            gy = torch.randn(rows, n, generator=g, device=DEVICE).bfloat16()
            plan = K.bwd_plan(rows, nt, kw["strides"], tiles, 2)
            ok, gx_err, worst, det = check_bwd(
                torch, lambda: K.spm_stack_bwd_kernel_call(x, cf, gy, **kw),
                lambda: K.spm_stack_bwd_plain(x, cf, gy, **kw),
                lambda: K.spm_stack_bwd_plain(x, cf, gy, col_sum=abs_sum,
                                              **kw), rows)
            ok = ok and plan.split > 0
            ms = timer(lambda: K.spm_stack_bwd_kernel_call(x, cf, gy, **kw))
            plain_ms = timer(lambda: K.spm_stack_bwd_plain(x, cf, gy, **kw))
            bms, bby = bound(3 * rows * n * 2 + 2 * n // 2 * 16,
                             16 * rows * n)
            w = torch.randn(d_in, d_out, generator=g,
                            device=DEVICE).bfloat16()
            xl = torch.randn(rows, d_in, generator=g,
                             device=DEVICE).bfloat16()
            gl = torch.randn(rows, d_out, generator=g,
                             device=DEVICE).bfloat16()
            lib_ms = timer(lambda: (torch.matmul(gl, w.T),
                                    torch.matmul(xl.T, gl)))
            rows_out.append(dict(
                kernel="K2 split", case=label, dtype="bfloat16", rows=rows,
                n=n, n_tile=nt, bwd_plan=plan._asdict(),
                gx_max_abs_err=gx_err, max_abs_err=gx_err,
                grad_err_over_limit=worst, deterministic=det, ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                library_ms=lib_ms, ok=ok))
            log(f"K2 split {label:32s} rows={rows:5d} blocks "
                f"{plan.split}x{tiles} of {plan.lanes} lanes, R "
                f"{plan.chunk_rows}, G {plan.groups}: gx_err={gx_err:.3e} "
                f"(tol 0) grad err/limit={worst:.3f} det={det} "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} "
                f"({bby}) library_ms={lib_ms:.4f} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"K2 split {label} rows={rows}")
            del xl, gl, w
            if rows == 2048:
                sr = Q.scale_block_rows([(kw["strides"], nt)], rows, 2)
                xq, xs = Q.quantize_blocks(x.float(), sr, nt)
                qkw = dict(kw, scale_rows=sr)
                ok, gx_err, worst, det = check_bwd(
                    torch,
                    lambda: K.spm_stack_bwd_kernel_call(xq, cf, gy, None,
                                                        None, xs, **qkw),
                    lambda: K.spm_stack_bwd_plain(xq, cf, gy, None, None,
                                                  xs, **qkw),
                    lambda: K.spm_stack_bwd_plain(xq, cf, gy, None, None,
                                                  xs, col_sum=abs_sum,
                                                  **qkw), rows)
                rows_out.append(dict(
                    kernel="K2 split", case=label, dtype="bfloat16",
                    mode="int8 x", rows=rows, n=n, n_tile=nt, scale_rows=sr,
                    gx_max_abs_err=gx_err, max_abs_err=gx_err,
                    grad_err_over_limit=worst, deterministic=det, ok=ok))
                log(f"K2 split {label:32s} rows={rows:5d} int8 x ({sr} rows "
                    f"a scale): gx_err={gx_err:.3e} (tol 0) grad err/limit="
                    f"{worst:.3f} det={det} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"K2 split int8 {label} rows={rows}")
                del xq, xs
            del x, gy
    return rows_out, failures


def run_arch_train(torch, K, ops, launch_train, arch, cfg):
    """``ARCH_TRAIN`` steps of ``cfg`` (full width, the depth it has)
    through ``launch.train.train`` (bf16; qwen2-vl-7b's embeddings with
    the M-RoPE ids of a ``ARCH_PATCH_GRID`` patch grid): every loss finite,
    no step skipped, grad norms finite and non-zero, K1-K4 launches equal
    to the plan and K2's split-mode launches to
    ``planned_split_launches``."""
    batch, seq, steps = ARCH_TRAIN
    argv = ["--arch", arch, "--steps", str(steps), "--batch",
            str(batch), "--seq", str(seq), "--log-every", "1"]
    if cfg.rope_kind == "mrope":
        argv += ["--patch-grid", str(ARCH_PATCH_GRID)]
    args = launch_train.build_parser().parse_args(argv)
    mets, secs = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    launch_train.train(args, on_step=lambda s, st, m, dt: (
        mets.append(m), secs.append(dt)), cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: v for k, v in q8_counts(K).items() if " " not in k}
    got["K2 split"] = K.spm_stack_bwd_kernel_call.split_launches
    per = dict(planned_train_launches(cfg, ops, batch * seq))
    per["K2 split"] = planned_split_launches(cfg, ops, K, batch * seq)
    want = {k: steps * v for k, v in per.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in mets]
    gnorms = [m["grad_norm"] for m in mets]
    ok = (len(mets) == steps and got == want
          and all(math.isfinite(v) for v in losses + gnorms)
          and all(v > 0 for v in gnorms)
          and not any(m["skipped"] for m in mets))
    res = dict(batch=batch, seq=seq, steps=steps, losses=losses,
               grad_norms=gnorms, step_s=secs, step_ms_last=secs[-1] * 1e3,
               tokens_per_s=batch * seq / secs[-1], wall_s=wall,
               peak_mem_bytes=peak, launches=got, planned=want,
               planned_per_step=per)
    log(f"{cfg.name} train: {steps} steps of {batch} x {seq} bf16, losses "
        f"{[round(v, 4) for v in losses]}, grad norms "
        f"{[round(v, 4) for v in gnorms]}, step ms "
        f"{[round(v * 1e3, 1) for v in secs]}, peak "
        f"{peak / 2**30:.2f} GiB, launches {got} (planned {want}) "
        f"{'ok' if ok else 'FAIL'}")
    return res, ok


def run_gemma_parity(torch, T, LM, cfg):
    """gemma3-12b at one ``GEMMA_GROUP``-layer pattern group, full width:
    one row with a ``GEMMA_PROMPT``-token prompt (every ring wraps) and
    ``GEMMA_PARITY_NEW`` greedy tokens on the card, replayed teacher-forced
    on the
    CPU from the same weights: the logits of each step within phase 4's
    bf16 bound, the card's token the CPU's argmax wherever the CPU's top-2
    gap exceeds it."""
    cut = cut_depth(cfg, n=GEMMA_GROUP)
    params = T.init_model(cut, seed=0, device=DEVICE)
    cpu = copy.deepcopy(params).to("cpu")
    gen = torch.Generator().manual_seed(23)
    prompt = torch.randint(0, cfg.vocab_size, (1, GEMMA_PROMPT),
                           generator=gen)
    emb = cpu["embed"]
    w = emb["table"] if cfg.tie_embeddings else emb["out"].T
    tol = (2 * 2.0 ** -8 * cfg.d_model ** 0.5
           * cpu["final_norm"]["scale"].abs().max().item()
           * w.float().norm(dim=-1).max().item())
    max_len = GEMMA_PROMPT + GEMMA_PARITY_NEW
    t0 = time.perf_counter()
    with torch.inference_mode():
        lg, cg = LM.prefill(params, cut, max_len=max_len,
                            tokens=prompt.to(DEVICE))
        card, toks = [], []
        for step in range(GEMMA_PARITY_NEW):
            card.append(lg.float().cpu())
            tok = lg.argmax(-1)
            toks.append(tok.cpu())
            if step + 1 < GEMMA_PARITY_NEW:
                lg, cg = LM.decode_step(params, cut, tok, cg,
                                        GEMMA_PROMPT + step)
        del cg
        worst, decided, mism = 0.0, 0, 0
        lc, cc = LM.prefill(cpu, cut, max_len=max_len, tokens=prompt)
        for step in range(GEMMA_PARITY_NEW):
            b = lc.float()
            worst = max(worst, (card[step] - b).abs().max().item())
            top2 = b.topk(2, dim=-1).values
            if (top2[0, 0] - top2[0, 1]).item() > tol:
                decided += 1
                mism += int(b.argmax(-1).item() != toks[step].item())
            if step + 1 < GEMMA_PARITY_NEW:
                lc, cc = LM.decode_step(cpu, cut, toks[step], cc,
                                        GEMMA_PROMPT + step)
    secs = time.perf_counter() - t0
    ok = worst <= tol and mism == 0 and decided >= GEMMA_PARITY_NEW // 2
    ring = cut.attn_cfg(cut.layers[0]).window
    res = dict(layers=GEMMA_GROUP, prompt_len=GEMMA_PROMPT,
               steps=GEMMA_PARITY_NEW,
               ring_slots=ring, max_abs_err=worst, tol=tol,
               decided_tokens=decided, token_mismatches=mism, seconds=secs)
    log(f"gemma3-12b card vs CPU ({GEMMA_GROUP} layers, full width, prompt "
        f"{GEMMA_PROMPT} over {ring}-slot rings, {GEMMA_PARITY_NEW} tokens "
        f"teacher-forced): logits max err {worst:.3e} (tol {tol:.3e}), "
        f"{decided} tokens decided, {mism} differ ({secs:.1f} s) "
        f"{'ok' if ok else 'FAIL'}")
    del params, cpu
    torch.cuda.empty_cache()
    return res, ok


def run_arch_continuous(torch, T, cfg):
    """gemma3-12b at ``GEMMA_GROUP`` layers, full width, through
    ``ContinuousBatchingEngine`` (``CONT_SLOTS`` slots, bf16 rings): the
    ``CONT_PROMPTS`` requests (9-1100 tokens, greedy and sampled) at
    ``CONT_ARRIVALS``; churn parity bit for bit against each request served
    alone at the same slot count; then NaN planted in every row of each
    slot that had a tenant, just before its next admit: every request's
    tokens unchanged and unflagged."""
    from repro_torch.serve import ContinuousBatchingEngine, Request
    cut = cut_depth(cfg, n=GEMMA_GROUP)
    params = T.init_model(cut, seed=0, device=DEVICE)
    max_len = max(CONT_PROMPTS) + ARCH_NEW
    eng = ContinuousBatchingEngine(cut, params, slots=CONT_SLOTS,
                                   max_len=max_len,
                                   cache_dtype=torch.bfloat16, seed=0,
                                   device=DEVICE)

    def reqs():
        gen = torch.Generator().manual_seed(24)
        out = []
        for i, plen in enumerate(CONT_PROMPTS):
            t, k, p = CB_SAMPLING[i % len(CB_SAMPLING)]
            out.append(Request(prompt=torch.randint(0, cfg.vocab_size,
                                                    (plen,), generator=gen),
                               max_new_tokens=ARCH_NEW - 8 * (i % 2),
                               temperature=t, top_k=k, top_p=p, rid=i))
        return out

    eng.serve([Request(prompt=torch.zeros(8, dtype=torch.long),
                       max_new_tokens=2, rid=10**6)])     # warm-up
    t0 = time.perf_counter()
    pool, stats = eng.serve(reqs(), arrival_ticks=list(CONT_ARRIVALS))
    pool_s = time.perf_counter() - t0
    alone = {r.rid: eng.serve([r])[0][r.rid]["tokens"]
             == pool[r.rid]["tokens"] for r in reqs()}
    inner, used, planted = eng._admit, set(), []

    def admit(batch, tick, results):
        for slot, req in batch:
            if slot in used:
                for c in eng._cache:
                    c["mixer"]["k"][slot].fill_(float("nan"))
                    c["mixer"]["v"][slot].fill_(float("nan"))
                planted.append((slot, req.rid))
            used.add(slot)
        return inner(batch, tick, results)

    eng._admit = admit
    try:
        poisoned, _ = eng.serve(reqs(), arrival_ticks=list(CONT_ARRIVALS))
    finally:
        eng._admit = inner
    same = {r: poisoned[r]["tokens"] == pool[r]["tokens"] for r in pool}
    flagged = [r for r in pool if pool[r]["flagged"]
               or poisoned[r]["flagged"]]
    counts_ok = all(len(pool[r.rid]["tokens"]) == r.max_new_tokens
                    for r in reqs())
    ok = (all(alone.values()) and all(same.values()) and not flagged
          and counts_ok and len(planted) > 0)
    res = dict(layers=GEMMA_GROUP, slots=CONT_SLOTS, max_len=max_len,
               prompts=list(CONT_PROMPTS), ticks=stats["ticks"],
               tokens=stats["tokens"], pool_s=pool_s,
               alone_equal=alone, planted_nan_before=planted,
               planted_equal=same, flagged=flagged)
    log(f"gemma3-12b continuous ({GEMMA_GROUP} layers, {CONT_SLOTS} slots, "
        f"prompts {list(CONT_PROMPTS)}): {stats['tokens']} tokens in "
        f"{stats['ticks']} ticks ({pool_s:.2f} s); alone == pool "
        f"{all(alone.values())}; NaN planted before admits {planted}: "
        f"tokens unchanged {all(same.values())}, flagged {flagged} "
        f"{'ok' if ok else 'FAIL'}")
    del eng, params
    torch.cuda.empty_cache()
    return res, ok


def arch_kernel_cases():
    """Every distinct shape at which phase 22's main path launches K1-K4,
    from ``k1_linears`` and the row counts it gives them: K1 at the
    training step's rows (``ARCH_TRAIN``), each arch's prefill rows
    (``ARCH_ROWS`` times its prompt) and its decode rows (``ARCH_ROWS``),
    K2 at the training rows, and for fused q/k/v K3 at those three and K4
    at the training rows.  Returns {kernel: [(timed, shape, case)]}: the
    case as ``run_kernel_phase``/``run_bwd_kernel_phase`` take it, labelled
    with every arch and linear of its shape; the shape (n, strides) for K3
    and K4, else None.  Timed: the FFN's up and down at the training rows
    (K2: gate/up only) and up at the decode rows, K3 and K4's q."""
    from repro_torch.configs import get_config
    batch, seq, _ = ARCH_TRAIN
    train = batch * seq
    seen = {"K1": {}, "K2": {}, "K3": {}, "K4": {}}

    def note(kernel, key, arch, name, timed):
        entry = seen[kernel].setdefault(key, [{}, False])
        names = entry[0].setdefault(arch, [])
        if name not in names:
            names.append(name)
        entry[1] = entry[1] or timed

    for arch in ARCHS:
        cfg = get_config(arch)
        decode = ARCH_ROWS
        rows_of = (train,
                   ARCH_ROWS * ARCH_PROMPT.get(arch, ARCH_PROMPT_DEFAULT),
                   decode)
        for name, lin in k1_linears(cfg):
            sc = lin.spm_config()
            key = (None, sc.n, sc.pairing.strides(), lin.d_in, lin.d_out)
            ffn = name in ("up", "down")
            for rows in rows_of:
                note("K1", key + (rows,), arch, name,
                     ffn and (rows == train or name == "up"
                              and rows == decode))
            note("K2", key + (train,), arch, name, name == "up")
        if qkv_fused(cfg):
            acfg = cfg.attn_cfg(cfg.layers[0])
            for name, lin in (("q", acfg.q_proj), ("k", acfg.kv_proj),
                              ("v", acfg.kv_proj)):
                sc = lin.spm_config()
                shape = (sc.n, sc.pairing.strides())
                for rows in rows_of:
                    note("K3", (shape, rows, lin.d_out), arch, name,
                         name == "q" and rows in (train, decode))
                note("K4", (shape, train, lin.d_out), arch, name,
                     name == "q")
    out = {}
    for kernel, keys in seen.items():
        out[kernel] = []
        for key, (archs, timed) in keys.items():
            label = "; ".join(f"{a} {'/'.join(ns)}" for a, ns in
                              archs.items())
            if kernel in ("K1", "K2"):
                _, n, strides, d_in, d_out, rows = key
                case = (label, n, strides, rows, d_in, d_out)
                out[kernel].append((timed, None, case))
            else:
                shape, rows, d_out = key
                case = (label, rows, d_out, None, False) + (
                    (False,) if kernel == "K4" else ())
                out[kernel].append((timed, shape, case))
    return out


def run_arch_kernel_cases(torch, K, ops, timer):
    """K1-K4 against their plain versions at every ``arch_kernel_cases``
    shape, bf16, held as phases 2 and 5 hold them (K1 and K2's g_x bit for
    bit, K2's grads within gamma_rows, K3 and K4 within their limits); the
    timed ones also timed as there."""
    cases = arch_kernel_cases()
    bf = (torch.bfloat16,)
    rows, failures = [], []
    for t in (timer, None):
        def pick(kernel, shape=None):
            return [c for timed, sh, c in cases[kernel]
                    if timed == (t is not None) and sh == shape]
        for kernel in ("K1", "K2", "K3", "K4"):
            shapes = {sh for _, sh, _ in cases[kernel]}
            for shape in shapes:
                got = pick(kernel, shape)
                if not got:
                    continue
                if kernel in ("K1", "K3"):
                    more, fails = run_kernel_phase(
                        torch, K, ops, t, k1=got if kernel == "K1" else [],
                        k3=got if kernel == "K3" else [], dtypes=bf,
                        k3_shape=shape)
                else:
                    more, fails = run_bwd_kernel_phase(
                        torch, K, ops, t, k2=got if kernel == "K2" else [],
                        k4=got if kernel == "K4" else [], dtypes=bf,
                        k4_shape=shape)
                rows += more
                failures += fails
    return rows, failures


def run_archs_phase(torch, K, ops, T, LM, ServeEngine, launch_train,
                    train_mod, adamw, timer):
    """Phase 22: each of ``ARCHS`` at full width from seed 0, cut to
    ``ARCH_LAYERS`` layers, served (``run_serve_phase``: ``ARCH_ROWS`` rows,
    ``ARCH_NEW`` tokens,
    gemma3-12b's prompt past its rings) and trained (``run_arch_train``);
    gemma3-12b against the CPU and through the continuous engine at one
    pattern group; qwen2-vl-7b's training step against the CPU at
    ``QWEN2VL_PARITY_LAYERS`` layer with distinct M-RoPE ids (phase 7's bound); K2's split mode at every
    lone wide tile (``run_lone_k2_phase``); K1-K4 at every shape of the
    main path (``run_arch_kernel_cases``).  Returns (results, kernel rows,
    failures)."""
    from repro_torch.configs import get_config
    out, failures = {"serve": {}, "train": {}}, []
    times = {}
    for arch in ARCHS:
        cfg = cut_depth(get_config(arch), n=ARCH_LAYERS[arch])
        plen = ARCH_PROMPT.get(arch, ARCH_PROMPT_DEFAULT)
        windows = {s.window for s in cfg.layers if s.window}
        if any(plen <= w for w in windows):
            failures.append(f"{arch}: prompt {plen} within a ring")
        log(f"-- {arch}: {cfg.n_layers} layers, d={cfg.d_model}, "
            f"d_ff={cfg.d_ff}, q/k/v "
            f"{'fused (K3)' if qkv_fused(cfg) else 'K1 runs'}, windows "
            f"{sorted(windows)}, input {cfg.input_kind}, rope "
            f"{cfg.rope_kind}")
        t = time.perf_counter()
        params, serve, ok, _ = run_serve_phase(
            torch, K, ops, T, ServeEngine, cfg, batch=ARCH_ROWS,
            prompt_len=plen, new=ARCH_NEW)
        del params
        torch.cuda.empty_cache()
        out["serve"][arch] = serve
        if not ok:
            failures.append(f"{arch} serve")
        train, ok = run_arch_train(torch, K, ops, launch_train, arch, cfg)
        torch.cuda.empty_cache()
        out["train"][arch] = train
        if not ok:
            failures.append(f"{arch} train")
        times[arch] = time.perf_counter() - t
    t = time.perf_counter()
    out["gemma_parity"], ok = run_gemma_parity(torch, T, LM,
                                               get_config("gemma3-12b"))
    if not ok:
        failures.append("gemma3-12b card vs CPU")
    out["qwen2_vl_train_parity"], ok, _ = run_train_parity_phase(
        torch, T, LM, train_mod, adamw,
        cut_depth(get_config("qwen2-vl-7b"), n=QWEN2VL_PARITY_LAYERS))
    if not ok:
        failures.append("qwen2-vl-7b train parity")
    times["parity"] = time.perf_counter() - t
    t = time.perf_counter()
    out["continuous"], ok = run_arch_continuous(torch, T,
                                                get_config("gemma3-12b"))
    if not ok:
        failures.append("gemma3-12b continuous")
    times["continuous"] = time.perf_counter() - t
    t = time.perf_counter()
    rows, kfail = run_lone_k2_phase(torch, K, timer)
    failures += kfail
    times["K2 split"] = time.perf_counter() - t
    t = time.perf_counter()
    more, kfail = run_arch_kernel_cases(torch, K, ops, timer)
    rows += more
    failures += kfail
    times["K1 K3 K4"] = time.perf_counter() - t
    out["seconds"] = times
    log("phase 22 parts: " + ", ".join(f"{k} {v:.1f} s"
                                       for k, v in times.items()))
    return out, rows, failures


# ---------------------------------------------------------------------------
# phase 23: MoE, Mamba2 and the shared block
# ---------------------------------------------------------------------------

SLICE_ARCHS = ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e", "mamba2-370m",
               "zamba2-1.2b")
SLICE_SERVE = (4, 256, 32)     # rows, prompt, greedy tokens
SLICE_TRAIN = (4, 512, 2)      # batch, seq, steps
SLICE_BUDGET_S = 200
SLICE_LAYERS = 12              # the served and trained depth, a quarter of
# the MoE archs' and mamba2's 48 and two of zamba2's 6-layer groups
MOE_PARITY_LAYERS = 2          # qwen3-moe's card-vs-CPU depth, of 48
ZAMBA_GROUP = 6                # zamba2's: one group, the shared block first
SLICE_PARITY = (2, 128)        # rows, tokens of the card-vs-CPU forwards


def _runs(ops, lin, rows: int):
    sc = lin.spm_config()
    return ops.plan_runs_for_rows(sc.n, sc.pairing.strides(), rows)


def slice_linears(cfg, n_tok: int):
    """(name, LinearConfig, rows, expert) of every K1 linear one forward
    over ``n_tok`` tokens runs, layer by layer: the shared block's where it
    applies (its q/k/v as K3 launches when they fuse, returned apart),
    the mixer's (attention, or Mamba2's in and out projections), the dense
    FFN's, or the MoE experts' at ``route_groups``' G * C rows (``expert``)
    and the shared expert's.  Returns (linears, K3 launches)."""
    from repro_torch.layers.attention import qkv_block_fused
    from repro_torch.layers.moe import route_groups
    out, k3 = [], 0

    def attn(tag, acfg):
        nonlocal k3
        if qkv_block_fused(acfg):
            k3 += 3
        else:
            out.extend([(tag + "q", acfg.q_proj, n_tok, False),
                        (tag + "k", acfg.kv_proj, n_tok, False),
                        (tag + "v", acfg.kv_proj, n_tok, False)])
        out.append((tag + "o", acfg.o_proj, n_tok, False))

    def ffn(tag, fcfg, rows, expert):
        out.extend([(tag + name, getattr(fcfg, name), rows, expert)
                    for name in ("gate", "up", "down")])

    for spec in cfg.layers:
        if spec.shared_block:
            attn("shared ", cfg.shared_attn_cfg())
            ffn("shared ", cfg.shared_ffn_cfg(), n_tok, False)
        if spec.mixer == "attn":
            attn("", cfg.attn_cfg(spec))
        else:
            m = cfg.mamba_cfg()
            out.extend([("in_proj", m.in_proj, n_tok, False),
                        ("out_proj", m.out_proj, n_tok, False)])
        if spec.mlp == "dense":
            ffn("", cfg.ffn_cfg(), n_tok, False)
        elif spec.mlp == "moe":
            mc = cfg.moe_cfg()
            _, G, cap = route_groups(mc, n_tok)
            ffn("expert ", mc.expert_ffn, G * cap, True)
            if mc.shared_d_ff:
                ffn("shared expert ", mc.shared_ffn, n_tok, False)
    return out, k3


def slice_forward_launches(cfg, ops, n_tok: int) -> dict:
    """K1 (all), K1 in its expert mode (one a run for all experts) and K3
    launches of one forward over ``n_tok`` tokens."""
    lins, k3 = slice_linears(cfg, n_tok)
    k1 = k1e = 0
    for _, lin, rows, expert in lins:
        r = len(_runs(ops, lin, rows))
        k1 += r
        k1e += r if expert else 0
    return {"K1": k1, "K1 expert": k1e, "K3": k3}


def slice_train_launches(cfg, ops, K, n_tok: int) -> dict:
    """One training step over ``n_tok`` tokens: the forward twice (remat;
    a layer's checkpoint covers its shared block), K2 once per K1 run and
    K4 once per K3 launch, each in the same mode; K2's split-mode
    launches."""
    f = slice_forward_launches(cfg, ops, n_tok)
    m = 2 if cfg.remat else 1
    split = 0
    for _, lin, rows, expert in slice_linears(cfg, n_tok)[0]:
        n = lin.spm_config().n
        for rs, nt in _runs(ops, lin, rows):
            split += bool(K.bwd_plan(rows, nt, rs, n // nt, 2).split)
    return {"K1": m * f["K1"], "K1 expert": m * f["K1 expert"],
            "K2": f["K1"], "K2 expert": f["K1 expert"], "K2 split": split,
            "K3": m * f["K3"], "K4": f["K3"]}


def slice_counts(K) -> dict:
    return {"K1": K.spm_stack_kernel_call.launches,
            "K1 expert": K.spm_stack_kernel_call.expert_launches,
            "K2": K.spm_stack_bwd_kernel_call.launches,
            "K2 expert": K.spm_stack_bwd_kernel_call.expert_launches,
            "K2 split": K.spm_stack_bwd_kernel_call.split_launches,
            "K3": K.spm_block_kernel_call.launches,
            "K4": K.spm_block_bwd_kernel_call.launches}


def ssm_stack(cfg) -> bool:
    return any(s.mixer != "attn" for s in cfg.layers)


def slice_serve_launches(cfg, ops, batch: int, prompt: int,
                         new: int) -> dict:
    """One ``generate``: the prefill (one chunked forward over batch x
    prompt tokens, or for an SSM stack ``prompt`` replayed decode steps)
    and ``new - 1`` decode steps of ``batch`` rows; no backward."""
    dec = slice_forward_launches(cfg, ops, batch)
    if ssm_stack(cfg):
        pre = {k: prompt * v for k, v in dec.items()}
    else:
        pre = slice_forward_launches(cfg, ops, batch * prompt)
    return {k: pre[k] + (new - 1) * dec[k] for k in pre}


def run_slice_serve(torch, K, ops, T, ServeEngine, cfg):
    """``ServeEngine.generate`` of ``SLICE_SERVE`` with ``cfg`` (full width,
    the depth it has) from seed 0, bf16 KV cache: tokens in range and
    unflagged, K1 (its expert mode counted apart) and K3 launches equal to
    ``slice_serve_launches``.  Init s, prefill ms (the measured
    generate's prefill, synchronized on both sides), decode tokens/s (the
    rest of it), peak memory."""
    from repro_torch.models import causal_lm as LM
    batch, plen, new = SLICE_SERVE
    t0 = time.perf_counter()
    params = T.init_model(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServeEngine(cfg=cfg, params=params, max_len=plen + new,
                      cache_dtype=torch.bfloat16, device=DEVICE)
    gen = torch.Generator().manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (batch, plen), generator=gen)
    eng.generate(prompts[:, :8], max_new_tokens=2)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    real, spans = LM.prefill, []

    def timed_prefill(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t)
        return out
    LM.prefill = timed_prefill
    try:
        t = time.perf_counter()
        tokens, flags = eng.generate(prompts, max_new_tokens=new,
                                     return_flags=True)
        torch.cuda.synchronize()
        tn = time.perf_counter() - t
    finally:
        LM.prefill = real
    t1 = spans[0]
    got = {k: v for k, v in slice_counts(K).items()
           if k in ("K1", "K1 expert", "K3")}
    peak = torch.cuda.max_memory_allocated()
    want = slice_serve_launches(cfg, ops, batch, plen, new)
    in_range = bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    ok = (got == want and tuple(tokens.shape) == (batch, new) and in_range
          and not bool(flags.any()))
    res = dict(batch=batch, prompt_len=plen, new_tokens=new, init_s=init_s,
               prefill_ms=t1 * 1e3,
               prefill="decode replay" if ssm_stack(cfg) else "chunked",
               decode_tok_per_s=batch * (new - 1) / (tn - t1),
               generate_s=tn, peak_mem_bytes=peak, launches=got,
               planned=want, ok=ok)
    log(f"{cfg.name} serve: init {init_s:.1f} s, prefill ({res['prefill']}) "
        f"{t1 * 1e3:.1f} ms, decode {res['decode_tok_per_s']:.1f} tok/s, "
        f"generate {tn:.2f} s, peak {peak / 2**30:.2f} GiB, launches {got} "
        f"(planned {want}), in range={in_range} flagged="
        f"{int(flags.sum())} {'ok' if ok else 'FAIL'}")
    del eng, params
    torch.cuda.empty_cache()
    return res, ok


def run_slice_train(torch, K, ops, launch_train, cfg):
    """``SLICE_TRAIN`` steps of ``cfg`` (full width, the depth it has)
    through ``launch.train.train``, bf16: losses, aux and grad norms finite
    (aux > 0 for MoE), no step skipped, every launch count equal to
    ``slice_train_launches``.  Step ms, peak memory."""
    batch, seq, steps = SLICE_TRAIN
    args = launch_train.build_parser().parse_args(
        ["--arch", cfg.name, "--steps", str(steps), "--batch", str(batch),
         "--seq", str(seq), "--log-every", "1"])
    mets, secs = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    launch_train.train(args, on_step=lambda s, st, m, dt: (
        mets.append(m), secs.append(dt)), cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = slice_counts(K)
    per = slice_train_launches(cfg, ops, K, batch * seq)
    want = {k: steps * v for k, v in per.items()}
    peak = torch.cuda.max_memory_allocated()
    vals = [m[k] for m in mets for k in ("loss", "aux", "grad_norm")]
    moe = bool(cfg.n_experts)
    ok = (len(mets) == steps and got == want
          and all(math.isfinite(v) for v in vals)
          and all(m["grad_norm"] > 0 for m in mets)
          and all((m["aux"] > 0) == moe for m in mets)
          and not any(m["skipped"] for m in mets))
    res = dict(batch=batch, seq=seq, steps=steps,
               losses=[m["loss"] for m in mets],
               aux=[m["aux"] for m in mets],
               grad_norms=[m["grad_norm"] for m in mets], step_s=secs,
               step_ms_last=secs[-1] * 1e3,
               tokens_per_s=batch * seq / secs[-1], wall_s=wall,
               peak_mem_bytes=peak, launches=got, planned=want,
               planned_per_step=per, ok=ok)
    log(f"{cfg.name} train: {steps} steps of {batch} x {seq} bf16, losses "
        f"{[round(v, 4) for v in res['losses']]}, aux "
        f"{[round(v, 4) for v in res['aux']]}, grad norms "
        f"{[round(v, 4) for v in res['grad_norms']]}, step ms "
        f"{[round(v * 1e3, 1) for v in secs]}, peak {peak / 2**30:.2f} GiB, "
        f"launches {got} (planned {want}) {'ok' if ok else 'FAIL'}")
    torch.cuda.empty_cache()
    return res, ok


def f32_depth_bound(cfg) -> float:
    """Phase 7's f32 bound of a model's logits, per unit of their scale:
    8 eps times the dependent roundings, counted generously (every linear
    three a stage, each norm and row sum d_model, attention's head_dim and
    softmax, the SSD scan's chunk, state and head sums, the router's
    d_model and experts)."""
    from repro_torch.core.pairings import default_n_stages
    total = 2 * cfg.d_model
    for name, lin, _, _ in slice_linears(cfg, 1)[0]:
        total += 3 * default_n_stages(lin.spm_config().n) + 4
    for spec in cfg.layers:
        total += 2 * cfg.d_model + cfg.head_dim + 40
        if spec.mixer == "mamba":
            m = cfg.mamba_cfg()
            total += 4 * (m.chunk + m.d_state + m.d_head) + m.d_inner
        if spec.mlp == "moe":
            total += cfg.d_model + cfg.n_experts + 4 * cfg.top_k
    return 8 * total * EPS["float32"]


def run_moe_parity(torch, T, cfg):
    """qwen3-moe at ``MOE_PARITY_LAYERS`` layers, full width, f32, the same
    weights: a teacher-forced forward of ``SLICE_PARITY`` tokens on the
    card and on the CPU, each layer's routing recorded.  Where the two
    sides route every token alike, the logits are held to the f32 bound;
    a token routed otherwise must sit on a near-tie: its router's k-th and
    (k+1)-th logits closer than the router dot's bound (the cumsum rank
    then moves the later tokens of its group, so the logits past it are
    not compared)."""
    from repro_torch.layers import moe as M
    cut = dataclasses.replace(cut_depth(cfg, n=MOE_PARITY_LAYERS),
                              dtype="float32")
    params = T.init_model(cut, seed=0, device=DEVICE)
    cpu = copy.deepcopy(params).to("cpu")
    rows, seq = SLICE_PARITY
    gen = torch.Generator().manual_seed(29)
    toks = torch.randint(0, cfg.vocab_size, (rows, seq), generator=gen)
    seen = {"cuda": [], "cpu": []}
    real = M._top_k_gating

    def record(logits, k):
        gates, mask = real(logits, k)
        seen[logits.device.type].append((logits.detach().cpu(),
                                         mask.detach().cpu()))
        return gates, mask
    M._top_k_gating = record
    try:
        with torch.inference_mode():
            card = T.forward(params, cut, tokens=toks.to(DEVICE))[0].cpu()
            host = T.forward(cpu, cut, tokens=toks)[0]
    finally:
        M._top_k_gating = real
    k = cut.top_k
    flips, worst_gap, same = 0, 0.0, True
    for layer, ((lg, mg), (lc, mc)) in enumerate(zip(seen["cuda"],
                                                     seen["cpu"])):
        diff = (mg != mc).any(-1)
        if not bool(diff.any()):
            continue
        same = False
        top = torch.sort(lc, dim=-1, descending=True).values
        gap = (top[..., k - 1] - top[..., k])[diff]
        tol = 8 * (layer + 1) * cut.d_model * EPS["float32"] * (
            lc.abs().max().item() + 1)
        flips += int(diff.sum())
        worst_gap = max(worst_gap, (gap / tol).max().item())
    rel = f32_depth_bound(cut)
    err = (card - host).abs().max().item()
    limit = rel * (host.abs().max().item() + 1)
    ok = (worst_gap <= 1 and bool(torch.isfinite(card).all())
          and (not same or err <= limit))
    res = dict(layers=MOE_PARITY_LAYERS, rows=rows, seq=seq,
               routing_identical=same, flipped_tokens=flips,
               flip_gap_over_tol=worst_gap, logits_max_abs_err=err,
               logits_tol=limit, ok=ok)
    log(f"qwen3-moe card vs CPU ({MOE_PARITY_LAYERS} layers, f32, "
        f"{rows} x {seq}): routing identical={same} (flipped {flips}, "
        f"gap/tol {worst_gap:.3f}), logits err {err:.3e} (tol {limit:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    return res, ok


def run_zamba_parity(torch, T, LM, cfg):
    """zamba2 at one ``ZAMBA_GROUP``-layer group (the shared block before
    its first layer), full width, f32: the chunked forward's logits on the
    card against the CPU's within the f32 bound, and on the card the
    decode-replay prefill's last logits against the chunked forward's
    within the reference's own contract (atol 2e-3,
    ``tests/test_layers.py``)."""
    cut = dataclasses.replace(cut_depth(cfg, n=ZAMBA_GROUP), dtype="float32")
    params = T.init_model(cut, seed=0, device=DEVICE)
    cpu = copy.deepcopy(params).to("cpu")
    rows, seq = SLICE_PARITY
    seq //= 2
    gen = torch.Generator().manual_seed(31)
    toks = torch.randint(0, cfg.vocab_size, (rows, seq), generator=gen)
    with torch.inference_mode():
        card = T.forward(params, cut, tokens=toks.to(DEVICE))[0]
        host = T.forward(cpu, cut, tokens=toks)[0]
        replay, _ = LM.prefill(params, cut, max_len=seq,
                               tokens=toks.to(DEVICE),
                               cache_dtype=torch.float32)
    card = card.cpu()
    err = (card - host).abs().max().item()
    limit = f32_depth_bound(cut) * (host.abs().max().item() + 1)
    rerr = (replay.cpu() - card[:, -1]).abs().max().item()
    ok = err <= limit and rerr <= 2e-3 and bool(torch.isfinite(card).all())
    res = dict(layers=ZAMBA_GROUP, rows=rows, seq=seq,
               logits_max_abs_err=err, logits_tol=limit,
               replay_vs_chunked_max_abs_err=rerr, replay_tol=2e-3, ok=ok)
    log(f"zamba2 card vs CPU ({ZAMBA_GROUP} layers, f32, {rows} x {seq}): "
        f"logits err {err:.3e} (tol {limit:.3e}); replay prefill vs chunked "
        f"{rerr:.3e} (tol 2e-3) {'ok' if ok else 'FAIL'}")
    return res, ok


def slice_kernel_cases(ops):
    """The distinct K1 and K2 shapes of phase 23's main path outside the
    expert mode: every linear of ``slice_linears`` at the training step's
    rows (K1 and K2), the prefill's (an attention stack's batch x prompt;
    an SSM stack's replay rows) and decode's (K1).  Returns (K1 cases, K2
    cases, timed K1, timed K2) in ``run_kernel_phase``'s form; timed: the
    Mamba2 in_proj chains of mamba2-370m at the training rows."""
    from repro_torch.configs import get_config
    batch, plen, _ = SLICE_SERVE
    tb, ts, _ = SLICE_TRAIN
    seen1, seen2 = {}, {}
    for arch in SLICE_ARCHS:
        cfg = get_config(arch)
        for rows, train in ((tb * ts, True),
                            (batch if ssm_stack(cfg) else batch * plen,
                             False), (batch, False)):
            for name, lin, r, expert in slice_linears(cfg, rows)[0]:
                if expert:
                    continue
                sc = lin.spm_config()
                key = (sc.n, sc.pairing.strides(), r, lin.d_in, lin.d_out)
                seen1.setdefault(key, []).append(f"{arch} {name}")
                if train:
                    seen2.setdefault(key, []).append(f"{arch} {name}")
    m = get_config("mamba2-370m").mamba_cfg().in_proj
    timed_key = (m.spm_config().n, m.spm_config().pairing.strides(),
                 tb * ts, m.d_in, m.d_out)

    def cases(seen, timed):
        return [("; ".join(sorted(set(v)))[:60], n, s, r, di, do)
                for (n, s, r, di, do), v in seen.items()
                if ((n, s, r, di, do) == timed_key) == timed]
    return cases(seen1, False), cases(seen2, False), cases(seen1, True), \
        cases(seen2, True)


def run_expert_kernel_cases(torch, K, ops, timer):
    """K1 and K2 in their expert mode at every shape phase 23's main path
    gives them (each MoE arch's gate/up and down experts at the training
    step's, the prefill's and decode's rows a expert), bf16: the run
    chain (one launch a run for all experts) bit for bit the per-expert
    plain versions, a second chain bitwise; K2 (training rows) g_x bit for
    bit and its grads within gamma_rows of one expert's rows.  At the
    training rows both chains are timed (L2 flushed, CUDA events, mean of
    ``TIMED``) beside the plain versions (called once), the bound (each
    expert's x and y
    moved once and its live table, 3 f32 operations an element and stage
    forward, 10 backward) and ``torch.bmm`` with dense per-expert weights
    (E, d_in, d_out) (for K2 its two products), which the port never
    calls."""
    from repro_torch.configs import get_config
    from repro_torch.layers.moe import route_groups
    rows_out, failures = [], []
    g = torch.Generator(device=DEVICE).manual_seed(2323)
    abs_sum = (lambda t: t.abs().sum(0))
    tb, ts, _ = SLICE_TRAIN
    batch, plen, _ = SLICE_SERVE
    for arch in SLICE_ARCHS[:2]:
        cfg = get_config(arch)
        mc = cfg.moe_cfg()
        E = mc.n_experts
        row_sets = []
        for n_tok, train in ((tb * ts, True), (batch * plen, False),
                             (batch, False)):
            _, G, cap = route_groups(mc, n_tok)
            row_sets.append((G * cap, train))
        for label, lin in (("gate/up", mc.expert_ffn.gate),
                           ("down", mc.expert_ffn.down)):
            sc = lin.spm_config()
            n = sc.n
            strides = sc.pairing.strides()
            widths = (None if lin.d_in == n else lin.d_in,
                      None if lin.d_out == n else lin.d_out)
            for rows, train in row_sets:
                runs = ops.plan_runs_for_rows(n, strides, rows)
                L = sum(len(rs) for rs, _ in runs)
                th = (torch.rand(E, L, n // 2, generator=g, device=DEVICE)
                      * 2 - 1) * math.pi
                cf = torch.stack([th.cos(), -th.sin(), th.sin(), th.cos()],
                                 -1) + 0.05 * torch.randn(
                    E, L, n // 2, 4, generator=g, device=DEVICE)
                del th
                d_in = 1 + 0.1 * torch.randn(E, n, generator=g,
                                             device=DEVICE)
                d_out = 1 + 0.1 * torch.randn(E, n, generator=g,
                                              device=DEVICE)
                x = torch.randn(E, rows, lin.d_in, generator=g,
                                device=DEVICE).bfloat16()
                before = K.spm_stack_kernel_call.expert_launches
                y, saved = ops.forward_runs(x, cf, runs, d_in, d_out, None,
                                            *widths)
                one_each = (K.spm_stack_kernel_call.expert_launches - before
                            == len(runs))
                again, _ = ops.forward_runs(x, cf, runs, d_in, d_out, None,
                                            *widths)

                def plain_chain():
                    z = x
                    for r, (rs, nt) in enumerate(runs):
                        off = sum(len(q) for q, _ in runs[:r])
                        last = r == len(runs) - 1
                        z = K.spm_stack_plain(
                            z, cf[:, off: off + len(rs)],
                            d_in if r == 0 else None,
                            d_out if last else None, strides=rs, n_tile=nt,
                            in_width=widths[0] if r == 0 else None,
                            out_width=widths[1] if last else None)
                    return z
                plain = plain_chain()
                torch.cuda.synchronize()
                err = (y.float() - plain.float()).abs().max().item()
                ok = (err == 0 and torch.equal(y, again) and one_each
                      and bool(torch.isfinite(y.float()).all()))
                esz = 2
                tiles_live = [(-(-(widths[1] or n) // nt)
                               if r == len(runs) - 1 else n // nt, rs, nt)
                              for r, (rs, nt) in enumerate(runs)]
                table = sum(E * len(rs) * t * nt // 2 * 16
                            for t, rs, nt in tiles_live)
                io = E * rows * (lin.d_in + lin.d_out) * esz
                flops = sum(E * rows * t * nt * (3 * len(rs) + 2)
                            for t, rs, nt in tiles_live)
                bms, bby = bound(io + table + 2 * E * n * 4, flops)
                ms = plain_ms = lib_ms = None
                if train and timer is not None:
                    ms = timer(lambda: ops.forward_runs(
                        x, cf, runs, d_in, d_out, None, *widths))
                    # a loop over the experts (0.1-0.5 s a call), called
                    # once, warm from the check above
                    plain_ms = timer(plain_chain, reps=1, warm=0)
                    w = torch.randn(E, lin.d_in, lin.d_out, generator=g,
                                    device=DEVICE).bfloat16()
                    lib_ms = timer(lambda: torch.bmm(x, w))
                    del w
                rows_out.append(dict(
                    kernel="K1 expert", case=f"{arch} {label}",
                    dtype="bfloat16", rows=rows, experts=E, n=n,
                    in_width=lin.d_in, out_width=lin.d_out,
                    runs=[[list(rs), nt] for rs, nt in runs],
                    launches_per_call=len(runs), max_abs_err=err, tol=0.0,
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                    library_ms=lib_ms, ok=ok))
                log(f"K1 expert {arch} {label:7s} E={E} rows={rows:4d} "
                    f"runs={len(runs)} err={err:.3e} (tol 0) one launch a "
                    f"run={one_each} ms={fmt_ms(ms)} plain_ms="
                    f"{fmt_ms(plain_ms)} bound_ms={bms:.4f} ({bby}) "
                    f"library_ms={fmt_ms(lib_ms)} (torch.bmm) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"K1 expert {arch} {label} rows={rows}")
                if train:
                    gy = torch.randn(E, rows, lin.d_out, generator=g,
                                     device=DEVICE).bfloat16()
                    args = (saved, cf, gy, runs, d_in, d_out, False,
                            *widths)
                    before = K.spm_stack_bwd_kernel_call.expert_launches
                    kern = ops.backward_runs(K.spm_stack_bwd_kernel_call,
                                             *args)
                    one_each = (K.spm_stack_bwd_kernel_call.expert_launches
                                - before == len(runs))
                    again = ops.backward_runs(K.spm_stack_bwd_kernel_call,
                                              *args)
                    plain = ops.backward_runs(K.spm_stack_bwd_plain, *args)
                    mags = ops.backward_runs(functools.partial(
                        K.spm_stack_bwd_plain, col_sum=abs_sum), *args)
                    torch.cuda.synchronize()
                    gx_err = max((a[0].float() - p[0].float()).abs().max()
                                 .item() for a, p in zip(kern, plain))
                    worst = max(grads_within(a[1:], p[1:], m[1:], rows)
                                for a, p, m in zip(kern, plain, mags))
                    det = all(torch.equal(u, v) for a, c in zip(kern, again)
                              for u, v in zip(a, c))
                    ok = gx_err == 0 and worst <= 1 and det and one_each
                    nbytes = E * rows * (2 * lin.d_in + lin.d_out) * esz \
                        + 2 * table + 2 * 2 * E * n * 4
                    bflops = sum(E * rows * t * nt * (10 * len(rs) + 6)
                                 for t, rs, nt in tiles_live)
                    kbms, kbby = bound(nbytes, bflops)
                    kms = kplain = klib = None
                    if timer is not None:
                        kms = timer(lambda: ops.backward_runs(
                            K.spm_stack_bwd_kernel_call, *args))
                        kplain = timer(lambda: ops.backward_runs(
                            K.spm_stack_bwd_plain, *args), reps=1, warm=0)
                        w = torch.randn(E, lin.d_in, lin.d_out, generator=g,
                                        device=DEVICE).bfloat16()
                        klib = timer(lambda: (
                            torch.bmm(gy, w.transpose(1, 2)),
                            torch.bmm(x.transpose(1, 2), gy)))
                        del w
                    rows_out.append(dict(
                        kernel="K2 expert", case=f"{arch} {label}",
                        dtype="bfloat16", rows=rows, experts=E, n=n,
                        in_width=lin.d_in, out_width=lin.d_out,
                        runs=[[list(rs), nt] for rs, nt in runs],
                        launches_per_call=len(runs), gx_max_abs_err=gx_err,
                        max_abs_err=gx_err, grad_err_over_limit=worst,
                        deterministic=det, ms=kms, plain_ms=kplain,
                        bound_ms=kbms, bound_by=kbby, library_ms=klib,
                        ok=ok))
                    log(f"K2 expert {arch} {label:7s} E={E} rows={rows:4d} "
                        f"runs={len(runs)} gx_err={gx_err:.3e} (tol 0) grad "
                        f"err/limit={worst:.3f} det={det} one launch a run="
                        f"{one_each} ms={fmt_ms(kms)} plain_ms="
                        f"{fmt_ms(kplain)} bound_ms={kbms:.4f} ({kbby}) "
                        f"library_ms={fmt_ms(klib)} (torch.bmm x2) "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        failures.append(f"K2 expert {arch} {label} "
                                        f"rows={rows}")
                    del gy, kern, again, plain, mags
                del x, cf, y, saved, d_in, d_out
                torch.cuda.empty_cache()
    return rows_out, failures


def run_slice_phase(torch, K, ops, T, LM, ServeEngine, launch_train, timer):
    """Phase 23: each of ``SLICE_ARCHS`` at full width from seed 0, cut to
    ``SLICE_LAYERS`` layers, served (``run_slice_serve``) and trained
    (``run_slice_train``);
    qwen3-moe at 2 layers and zamba2 at one group against the CPU; K1 and
    K2 in the expert mode at every shape of the main path
    (``run_expert_kernel_cases``) and in their other modes at every other
    shape it gives them (``slice_kernel_cases``).  Returns (results,
    kernel rows, failures)."""
    from repro_torch.configs import get_config
    out, failures, times = {"serve": {}, "train": {}}, [], {}
    for arch in SLICE_ARCHS:
        cfg = cut_depth(get_config(arch), n=SLICE_LAYERS)
        log(f"-- {arch}: {cfg.n_layers} layers, d={cfg.d_model}, mixers "
            f"{sorted({s.mixer for s in cfg.layers})}, mlps "
            f"{sorted({s.mlp for s in cfg.layers})}, experts "
            f"{cfg.n_experts} top-{cfg.top_k}, shared block "
            f"{cfg.has_shared_block}")
        t = time.perf_counter()
        out["serve"][arch], ok = run_slice_serve(torch, K, ops, T,
                                                 ServeEngine, cfg)
        if not ok:
            failures.append(f"{arch} serve")
        out["train"][arch], ok = run_slice_train(torch, K, ops,
                                                 launch_train, cfg)
        if not ok:
            failures.append(f"{arch} train")
        times[arch] = time.perf_counter() - t
    t = time.perf_counter()
    out["moe_parity"], ok = run_moe_parity(
        torch, T, get_config("qwen3-moe-30b-a3b"))
    if not ok:
        failures.append("qwen3-moe card vs CPU")
    out["zamba_parity"], ok = run_zamba_parity(torch, T, LM,
                                               get_config("zamba2-1.2b"))
    if not ok:
        failures.append("zamba2 card vs CPU")
    times["parity"] = time.perf_counter() - t
    t = time.perf_counter()
    rows, kfail = run_expert_kernel_cases(torch, K, ops, timer)
    failures += kfail
    times["expert kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    k1, k2, k1t, k2t = slice_kernel_cases(ops)
    bf = (torch.bfloat16,)
    # zamba2's shared q/k/v: K3 at the training, replay and decode rows,
    # K4 at the training rows (n 2048, 11 stages)
    shared = get_config("zamba2-1.2b").shared_attn_cfg().q_proj.spm_config()
    k3_shape = (shared.n, shared.pairing.strides())
    tb, ts, _ = SLICE_TRAIN
    k3 = [("zamba2 shared q/k/v", r, shared.n, None, False)
          for r in (tb * ts, SLICE_SERVE[0])]
    k4 = [("zamba2 shared q/k/v", tb * ts, shared.n, None, False, False)]
    for tm, c1, c2, c3, c4 in ((timer, k1t, k2t, [], []),
                               (None, k1, k2, k3, k4)):
        more, kf = run_kernel_phase(torch, K, ops, tm, k1=c1, k3=c3,
                                    dtypes=bf, k3_shape=k3_shape)
        rows += more
        failures += kf
        more, kf = run_bwd_kernel_phase(torch, K, ops, tm, k2=c2, k4=c4,
                                        dtypes=bf, k4_shape=k3_shape)
        rows += more
        failures += kf
    times["K1 K2"] = time.perf_counter() - t
    out["seconds"] = times
    log("phase 23 parts: " + ", ".join(f"{k} {v:.1f} s"
                                       for k, v in times.items()))
    return out, rows, failures


# ---------------------------------------------------------------------------
# phase 24: the MoE archs under --quantize and feature sharding
# ---------------------------------------------------------------------------

MODES_ARCH = "qwen3-moe-30b-a3b"
MODES_TRAIN = (4, 512, 2)      # batch, seq, steps of each training run
MODES_BUDGET_S = 150
MODES_PEAK_GIB = 75            # a sharded run whose peak passes this
MODES_CUT_LAYERS = 24          # reruns at this depth (of 48)
MODES_PARITY_LAYERS = 1        # the card-vs-CPU depth (2 before: phase 26
#                                took the seconds)


def modes_counts(K) -> dict:
    """Every launch count phase 24 holds to its plan."""
    out = {}
    for tag, fn in (("K1", K.spm_stack_kernel_call),
                    ("K2", K.spm_stack_bwd_kernel_call)):
        out.update({tag: fn.launches, f"{tag} int8": fn.int8_launches,
                    f"{tag} int8 io": fn.int8_io_launches,
                    f"{tag} col_base": fn.window_launches,
                    f"{tag} expert": fn.expert_launches,
                    f"{tag} expert int8": fn.expert_int8_launches,
                    f"{tag} expert col_base": fn.expert_window_launches})
    for tag, fn in (("K5", K.spm_overlap_kernel_call),
                    ("K6", K.spm_overlap_bwd_kernel_call)):
        out.update({tag: fn.launches, f"{tag} int8": fn.int8_launches,
                    f"{tag} col_base": fn.window_launches,
                    f"{tag} expert": fn.expert_launches})
    out["K3"] = K.spm_block_kernel_call.launches
    out["K4"] = K.spm_block_bwd_kernel_call.launches
    return out


def _zero_counts() -> dict:
    keys = []
    for tag in ("K1", "K2"):
        keys += [tag] + [f"{tag} {m}" for m in (
            "int8", "int8 io", "col_base", "expert", "expert int8",
            "expert col_base")]
    for tag in ("K5", "K6"):
        keys += [tag] + [f"{tag} {m}" for m in ("int8", "col_base",
                                                "expert")]
    return dict.fromkeys(keys + ["K3", "K4"], 0)


def modes_forward_plan(cfg, ops, n_tok: int) -> dict:
    """The launches of one forward of ``cfg`` (quantized or sharded, so no
    linear block-fuses) over ``n_tok`` tokens, the backward's own remat
    runs (``bwd remat``) beside them.  Unsharded: K1 once a planned run,
    int8 tables everywhere under ``spm_quant_coeffs``, int8 activations
    where a linear's plan allows (``quant_acts_eligible``).  Sharded:
    ``linear_plan`` of each linear (K1 a shard and run, or K5 a fused
    pair, windowed where the input is narrower than n); every launch reads
    an int8 table under ``spm_quant_coeffs`` and none moves int8
    activations.  Expert launches (one for all experts) counted apart."""
    from repro_torch.core.eligibility import quant_acts_eligible
    out = _zero_counts()
    out["K1 bwd remat"] = out["K1 expert bwd remat"] = 0
    q_cf, q_io = cfg.spm_quant_coeffs, cfg.spm_quant_acts
    for _, lin, rows, expert in slice_linears(cfg, n_tok)[0]:
        if lin.spm_config().n_shards > 1:
            p = linear_plan(lin, rows)
            k1, k1w, remat = p["K1"], p["K1 col_base"], p["K1 bwd remat"]
            k5, k5w, io = p["K5"], p["K5 col_base"], 0
        else:
            runs = _runs(ops, lin, rows)
            k1, k1w, remat, k5, k5w = len(runs), 0, 0, 0, 0
            io = k1 if q_io and quant_acts_eligible(runs) else 0
        add = {"K1": k1, "K1 int8": k1 if q_cf else 0, "K1 int8 io": io,
               "K1 col_base": k1w, "K1 bwd remat": remat, "K5": k5,
               "K5 int8": k5 if q_cf else 0, "K5 col_base": k5w}
        if expert:
            add.update({"K1 expert": k1, "K1 expert int8": add["K1 int8"],
                        "K1 expert col_base": k1w,
                        "K1 expert bwd remat": remat, "K5 expert": k5})
        for k, v in add.items():
            out[k] += v
    return out


def modes_train_plan(cfg, ops, n_tok: int) -> dict:
    """One training step: the forward twice (remat) plus the sharded
    backward's remat runs; K2 once per forward K1 launch and K6 once per
    K5, each in the same modes; no K3/K4."""
    f = modes_forward_plan(cfg, ops, n_tok)
    m = 2 if cfg.remat else 1
    out = _zero_counts()
    for k in out:
        tag, rest = k.split(" ", 1) if " " in k else (k, "")
        if tag in ("K1", "K5"):
            out[k] = m * f[k]
        elif tag == "K2":
            out[k] = f[("K1 " + rest).strip()]
        elif tag == "K6":
            out[k] = f[("K5 " + rest).strip()]
    out["K1"] += f["K1 bwd remat"]
    out["K1 int8"] += f["K1 bwd remat"] if cfg.spm_quant_coeffs else 0
    out["K1 expert"] += f["K1 expert bwd remat"]
    out["K1 expert int8"] += (f["K1 expert bwd remat"]
                              if cfg.spm_quant_coeffs else 0)
    return out


def modes_serve_plan(cfg, ops, batch: int, prompt: int, new: int) -> dict:
    """One ``generate``: the prefill's forward over batch x prompt tokens
    and ``new - 1`` decode forwards of ``batch`` rows."""
    pre = modes_forward_plan(cfg, ops, batch * prompt)
    dec = modes_forward_plan(cfg, ops, batch)
    return {k: pre[k] + (new - 1) * dec[k] for k in _zero_counts()}


def run_modes_train(torch, K, ops, T, LM, train_mod, adamw, launch_train,
                    cfg, quantize=False, shards=0, overlap=False,
                    label=""):
    """``MODES_TRAIN`` training steps of full-width ``cfg``, bf16, from
    seed 0: unsharded through ``launch.train.train`` (``quantize``: its
    ``--quantize``), or with ``shards`` as phase 13 drives them
    (``with_feature_sharding`` and ``make_train_step`` under
    ``activation_sharding`` of a mesh of that many shards on the card;
    ``overlap``: ``with_overlap_executor``; ``quantize``:
    ``with_quantized_io``; launch.train's batches, seed and optimizer).
    Losses, aux (> 0) and grad norms finite, no step skipped, every launch
    count equal to ``modes_train_plan``.  Step ms, peak memory.  A sharded
    run whose peak passes ``MODES_PEAK_GIB`` (or that runs out of memory)
    reruns at ``MODES_CUT_LAYERS`` layers."""
    from repro_torch.configs import (with_feature_sharding,
                                     with_overlap_executor,
                                     with_quantized_io)
    from repro_torch.data import DeterministicLoader, build_corpus
    from repro_torch.parallel import activation_sharding, make_feature_mesh
    batch, seq, steps = MODES_TRAIN
    args = launch_train.build_parser().parse_args(
        ["--arch", cfg.name, "--steps", str(steps), "--batch", str(batch),
         "--seq", str(seq), "--log-every", "1"]
        + (["--quantize"] if quantize else []))
    rcfg = cfg
    if shards:
        rcfg = with_feature_sharding(rcfg, shards)
    if overlap:
        rcfg = with_overlap_executor(rcfg, True)
    if quantize:
        rcfg = with_quantized_io(rcfg)
    full_peak = None
    for layers in (cfg.n_layers, MODES_CUT_LAYERS):
        run_cfg = (rcfg if layers == cfg.n_layers
                   else cut_depth(rcfg, n=layers))
        mets, secs = [], []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            if not shards:
                launch_train.train(args, on_step=lambda s, st, m, dt: (
                    mets.append(m), secs.append(dt)))
            else:
                loader = DeterministicLoader(
                    launch_train.make_batch_fn(
                        run_cfg, seq, build_corpus(200_000, seed=args.seed)),
                    batch, seed=args.seed)
                step_fn = train_mod.make_train_step(
                    lambda p, b: LM.lm_loss(p, b, run_cfg),
                    adamw.OptimizerConfig(lr=args.lr, total_steps=steps,
                                          warmup_steps=1),
                    chaos_guard=True)
                state = train_mod.make_train_state(
                    T.init_model(run_cfg, seed=args.seed, device=DEVICE))
                mesh = make_feature_mesh(shards, device=DEVICE)
                with activation_sharding(mesh, shard_feature=True):
                    for s in range(steps):
                        b = {k: v.to(DEVICE)
                             for k, v in loader.batch_at(s).items()}
                        t = time.perf_counter()
                        state, m = step_fn(state, b, 0.0)
                        mets.append(LM.train_metrics(m))
                        secs.append(time.perf_counter() - t)
                del state
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        except torch.cuda.OutOfMemoryError:
            peak = None
        if not shards or (peak is not None
                          and peak <= MODES_PEAK_GIB * 2 ** 30):
            break
        full_peak = peak
        seen = ("out of memory" if peak is None
                else f"{peak / 2**30:.2f} GiB")
        log(f"{label}: peak {seen} at {layers} layers; again at "
            f"{MODES_CUT_LAYERS}")
    wall = time.perf_counter() - t0
    got = modes_counts(K)
    per = modes_train_plan(run_cfg, ops, batch * seq)
    want = {k: steps * v for k, v in per.items()}
    vals = [m[k] for m in mets for k in ("loss", "aux", "grad_norm")]
    ok = (peak is not None and len(mets) == steps and got == want
          and all(math.isfinite(v) for v in vals)
          and all(m["grad_norm"] > 0 and m["aux"] > 0 for m in mets)
          and not any(m["skipped"] for m in mets))
    res = dict(label=label, layers=run_cfg.n_layers, shards=shards,
               overlap=overlap, quantize=quantize, batch=batch, seq=seq,
               steps=steps, losses=[m["loss"] for m in mets],
               aux=[m["aux"] for m in mets],
               grad_norms=[m["grad_norm"] for m in mets], step_s=secs,
               step_ms_last=secs[-1] * 1e3 if secs else None,
               tokens_per_s=batch * seq / secs[-1] if secs else None,
               wall_s=wall, peak_mem_bytes=peak,
               full_depth_peak_bytes=full_peak, launches=got, planned=want,
               planned_per_step=per, ok=ok)
    log(f"{label} train ({run_cfg.n_layers} layers"
        f"{f', {shards} shards' if shards else ''}): {steps} steps of "
        f"{batch} x {seq} bf16, losses {[round(v, 4) for v in res['losses']]}"
        f", aux {[round(v, 4) for v in res['aux']]}, grad norms "
        f"{[round(v, 4) for v in res['grad_norms']]}, step ms "
        f"{[round(v * 1e3, 1) for v in secs]}, peak "
        f"{(peak or 0) / 2**30:.2f} GiB, launches "
        f"{ {k: v for k, v in got.items() if v or want[k]} } (planned "
        f"{ {k: v for k, v in want.items() if v or got[k]} }) "
        f"{'ok' if ok else 'FAIL'}")
    torch.cuda.empty_cache()
    return res, ok


def run_modes_serve(torch, K, ops, T, ServeEngine, cfg):
    """``ServeEngine.generate`` of ``SLICE_SERVE`` with the quantized model
    (``with_quantized_io``) at full width and depth from seed 0, bf16 KV
    cache: tokens in range and unflagged, launches equal to
    ``modes_serve_plan`` (int8, int8-I/O and expert ones counted apart).
    Prefill ms (the measured generate's prefill, synchronized), decode
    tokens/s (the rest of it), peak memory."""
    from repro_torch.configs import with_quantized_io
    qcfg = with_quantized_io(cfg)
    batch, plen, new = SLICE_SERVE
    params = T.init_model(qcfg, seed=0, device=DEVICE)
    eng = ServeEngine(cfg=qcfg, params=params, max_len=plen + new,
                      cache_dtype=torch.bfloat16, device=DEVICE)
    gen = torch.Generator().manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (batch, plen), generator=gen)
    eng.generate(prompts[:, :8], max_new_tokens=2)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    from repro_torch.models import causal_lm as LM
    real, spans = LM.prefill, []

    def timed_prefill(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t)
        return out
    LM.prefill = timed_prefill
    try:
        t = time.perf_counter()
        tokens, flags = eng.generate(prompts, max_new_tokens=new,
                                     return_flags=True)
        torch.cuda.synchronize()
        tn = time.perf_counter() - t
    finally:
        LM.prefill = real
    t1 = spans[0]
    got = modes_counts(K)
    peak = torch.cuda.max_memory_allocated()
    want = modes_serve_plan(qcfg, ops, batch, plen, new)
    in_range = bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    ok = (got == want and tuple(tokens.shape) == (batch, new) and in_range
          and not bool(flags.any()))
    res = dict(batch=batch, prompt_len=plen, new_tokens=new,
               prefill_ms=t1 * 1e3,
               decode_tok_per_s=batch * (new - 1) / (tn - t1),
               generate_s=tn, peak_mem_bytes=peak, launches=got,
               planned=want, ok=ok)
    log(f"{cfg.name} int8 serve: prefill {t1 * 1e3:.1f} ms, decode "
        f"{res['decode_tok_per_s']:.1f} tok/s, generate {tn:.2f} s, peak "
        f"{peak / 2**30:.2f} GiB, launches "
        f"{ {k: v for k, v in got.items() if v or want[k]} } (planned "
        f"{ {k: v for k, v in want.items() if v or got[k]} }), in range="
        f"{in_range} flagged={int(flags.sum())} {'ok' if ok else 'FAIL'}")
    del eng, params
    torch.cuda.empty_cache()
    return res, ok


@contextlib.contextmanager
def routing_recorded():
    """Records every top-k routing decision, by device type: (router
    logits, mask) in call order."""
    from repro_torch.layers import moe as M
    seen = {"cuda": [], "cpu": []}
    real = M._top_k_gating

    def record(logits, k):
        gates, mask = real(logits, k)
        seen[logits.device.type].append((logits.detach().cpu(),
                                         mask.detach().cpu()))
        return gates, mask
    M._top_k_gating = record
    try:
        yield seen
    finally:
        M._top_k_gating = real


def routing_agrees(seen, cfg):
    """``run_moe_parity``'s routing check over recorded calls: (identical,
    tokens routed otherwise, the worst such token's gap between its
    router's k-th and (k+1)-th logits over the router dot's bound; <= 1
    is a near-tie)."""
    k, flips, worst, same = cfg.top_k, 0, 0.0, True
    pairs = list(zip(seen["cuda"], seen["cpu"]))
    if len(seen["cuda"]) != len(seen["cpu"]) or not pairs:
        return False, -1, math.inf
    for i, ((lg, mg), (lc, mc)) in enumerate(pairs):
        diff = (mg != mc).any(-1)
        if not bool(diff.any()):
            continue
        same = False
        top = lc.sort(dim=-1, descending=True).values
        gap = (top[..., k - 1] - top[..., k])[diff]
        tol = 8 * (i + 1) * cfg.d_model * EPS["float32"] * (
            lc.abs().max().item() + 1)
        flips += int(diff.sum())
        worst = max(worst, (gap / tol).max().item())
    return same, flips, worst


def modes_step(torch, LM, adamw, cfg, p, b, dev, shards=0, replay=None):
    """One forward and backward of ``cfg`` on ``p`` at ``dev`` (under a
    mesh of ``shards`` there, when given; the int8 chains under a
    ``CodeTape`` replaying ``replay``'s codes, when given), then the first
    AdamW update of its grads (``adamw_update``, the default config and
    fresh moments, as ``make_train_step``'s first step) on the same
    device.  Returns the loss, the grads and the updated params (on
    ``dev``), the update's norm, whether the loss and grads are finite, the
    launch counts (``modes_counts``) and the tape."""
    from repro_torch.kernels import spm_stack as K
    from repro_torch.kernels.codes import CodeTape
    from repro_torch.parallel import activation_sharding, make_feature_mesh
    ctx = (activation_sharding(make_feature_mesh(shards, device=dev),
                               shard_feature=True)
           if shards else contextlib.nullcontext())
    p.trainable()
    for q in p.parameters():
        q.grad = None
    K.reset_launch_counts()
    with ctx, CodeTape(replay=replay) as tape:
        loss, _ = LM.lm_loss(p, {k: v.to(dev) for k, v in b.items()}, cfg)
        loss.backward()
    counts = modes_counts(K)
    values = {k: q.detach() for k, q in p.named_parameters()}
    grads = {k: q.grad.detach().float() for k, q in p.named_parameters()}
    finite = math.isfinite(loss.item()) and all(
        bool(g.isfinite().all()) for g in grads.values())
    with torch.no_grad():
        p1, _, _ = adamw.adamw_update(values, grads,
                                      adamw.init_opt_state(values),
                                      adamw.OptimizerConfig())
        moved = math.sqrt(sum(float(((p1[k] - values[k]) ** 2).sum())
                              for k in p1))
    return dict(loss=loss.item(), finite=finite, counts=counts, tape=tape,
                grads=grads, p1=p1, moved=moved)


def run_modes_parity(torch, T, LM, adamw, cfg):
    """Card against CPU at ``MODES_PARITY_LAYERS`` layer of ``cfg``, full
    width, f32, no remat, from the same seed-0 weights on both sides: one
    ``modes_step`` a side of three models.  ``int8``
    (``with_quantized_io``): the CPU replays the card's codes, phase 10's
    criterion (each chain's output bit for bit, entry codes within one of
    the card's, at most ``flip_budget`` flipped).  ``sharded``
    (``with_feature_sharding(cut, SHARDS)``), phase 14's: the card runs
    windowed K1 and K2 and no K3-K6.  ``overlap``
    (``with_overlap_executor`` on top), phase 18's: the card runs K5 and K6,
    windowed (every first pair fuses), and no K3/K4, against the sharded
    case's CPU side.  The CPU launches nothing.  The loss, each grad
    (relative norm) and the updated params (each side's AdamW on its own
    device, compared on the card) are held to phase 7's f32 bound.  Routing is compared first (``routing_agrees``): where a token
    is routed otherwise at a near-tie (gap over tol <= 1) the loss, grads
    and update are not held to the bound; the launch counts, finiteness
    and the code checks are held in every case, and a flip that is no
    near-tie fails."""
    from repro_torch.configs import (with_feature_sharding,
                                     with_overlap_executor,
                                     with_quantized_io)
    # no remat: at this depth it saves nothing on the card and only
    # doubles the CPU's forward (the same function either way)
    cut = dataclasses.replace(cut_depth(cfg, n=MODES_PARITY_LAYERS),
                              remat=False, dtype="float32")
    sharded = with_feature_sharding(cut, SHARDS)
    batch, seq = 2, 16
    b = parity_batch(torch, cut, batch, seq)
    rel = 8 * math.sqrt(train_depth(cut, seq)) * EPS["float32"]
    cpu_p = T.init_model(cut, seed=0, device="cpu")
    card_p = copy.deepcopy(cpu_p).to(DEVICE)   # every model's weights
    out, ok_all, cpu_side = {}, True, None
    for name, mcfg, shards, need in (
            ("int8", with_quantized_io(cut), 0, ("K1 expert int8",
                                                 "K2 expert int8")),
            ("sharded", sharded, SHARDS, ("K1 col_base", "K2 col_base")),
            ("overlap", with_overlap_executor(sharded, True), SHARDS,
             ("K5", "K6", "K5 col_base", "K6 col_base"))):
        t0 = time.perf_counter()
        with routing_recorded() as seen:
            a = modes_step(torch, LM, adamw, mcfg, card_p, b, DEVICE,
                           shards)
            if name != "overlap":     # the overlap case reuses the sharded
                # case's CPU side (the same f32 function)
                cpu_side = modes_step(
                    torch, LM, adamw, mcfg, cpu_p, b, "cpu", shards,
                    replay=a["tape"] if name == "int8" else None)
                cpu_side["routing"] = seen["cpu"]
                # compared on the card, where the sums are quick
                for key in ("grads", "p1"):
                    cpu_side[key] = {k: v.to(DEVICE)
                                     for k, v in cpu_side[key].items()}
        seen["cpu"] = cpu_side["routing"]
        c = cpu_side
        secs = time.perf_counter() - t0
        same, flips, gap = routing_agrees(seen, cut)
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
        bound_ok = (loss_err <= rel * abs(c["loss"]) and worst <= rel
                    and diff <= rel * c["moved"])
        ac = a["counts"]
        none = ("K3", "K4") + (() if name == "overlap" else ("K5", "K6"))
        launches_ok = (all(ac[k] > 0 for k in need)
                       and all(ac[k] == 0 for k in none)
                       and not any(c["counts"].values()))
        codes = c["tape"].summary() if name == "int8" else None
        codes_ok = codes is None or (
            codes["chains"] == codes["recorded"] > 0
            and codes["out_differ"] == 0 and codes["entry_max_diff"] <= 1
            and codes["entry_flips"] <= flip_budget(rel, codes["codes"]))
        ok = (launches_ok and codes_ok and a["finite"] and c["finite"]
              and (bound_ok if same else gap <= 1))
        res = dict(batch=batch, seq=seq, layers=cut.n_layers,
                   shards=shards, loss_card=a["loss"], loss_cpu=c["loss"],
                   loss_abs_err=loss_err, worst_grad_rel_err=worst,
                   worst_grad=worst_name, params_diff_norm=diff,
                   update_norm=c["moved"], rel_tol=rel,
                   card_launches={k: v for k, v in ac.items() if v},
                   codes=codes, finite=a["finite"] and c["finite"],
                   routing_identical=same, flipped_tokens=flips,
                   flip_gap_over_tol=gap, held_to_bound=same,
                   cpu_reused=name == "overlap", seconds=secs, ok=ok)
        log(f"{name} train parity ({cut.n_layers} layers, {batch} x {seq}): "
            f"loss card {a['loss']:.6f} cpu {c['loss']:.6f} (err "
            f"{loss_err:.2e}), worst grad rel err {worst:.2e} "
            f"({worst_name}), params diff {diff:.3e} vs update "
            f"{c['moved']:.3e}; tol {rel:.2e} relative; routing identical="
            f"{same} (flipped {flips}, gap/tol {gap:.3f}); card launches "
            f"{res['card_launches']}"
            + (f"; {codes}" if codes else "")
            + f" ({secs:.1f} s"
            + (", the CPU side reused" if name == "overlap" else "")
            + f") {'ok' if ok else 'FAIL'}")
        out[name] = res
        ok_all = ok_all and ok
    return out, ok_all


def _expert_table(torch, g, lead, n):
    """Rotations plus noise, as ``init_spm`` draws them, (*lead, n/2, 4)."""
    th = (torch.rand(*lead, n // 2, generator=g, device=DEVICE) * 2 - 1) \
        * math.pi
    cf = torch.stack([th.cos(), -th.sin(), th.sin(), th.cos()], -1)
    return cf + 0.05 * torch.randn(*cf.shape, generator=g, device=DEVICE)


def modes_kernel_cases():
    """(kind, arch, label, LinearConfig, rows, train) of every new mode's
    shape on phase 24's path: the int8 expert chains (qwen3-moe's gate/up
    and down at a training step's, the prefill's and decode's rows a
    expert; llama4-scout's at a training step's with int8 tables), the
    windowed expert runs (the sharded first local run of a rectangular
    expert input: qwen3-moe's down, n_local 512; llama4's gate, 2048) and
    qwen3-moe's expert pairs (each expert linear's first {local -> cross}
    pair at 4 shards, with int8 tables).  ``train``: a training step's
    rows, where K2 and K6 are checked and the kernels timed."""
    from repro_torch.configs import get_config, with_feature_sharding
    from repro_torch.layers.moe import route_groups
    tb, ts, _ = MODES_TRAIN
    batch, plen, _ = SLICE_SERVE
    out = []
    for arch in SLICE_ARCHS[:2]:
        mc = get_config(arch).moe_cfg()
        smc = with_feature_sharding(get_config(arch), SHARDS).moe_cfg()
        toks = ((tb * ts, batch * plen, batch) if arch == MODES_ARCH
                else (tb * ts,))
        for i, n_tok in enumerate(toks):
            _, G, cap = route_groups(mc, n_tok)
            for label in ("gate/up", "down"):
                lin = getattr(mc.expert_ffn, label.split("/")[0])
                out.append(("int8", arch, label, lin, G * cap, i == 0))
        _, G, cap = route_groups(mc, tb * ts)
        for label in ("gate/up", "down"):
            lin = getattr(smc.expert_ffn, label.split("/")[0])
            if lin.d_in < lin.spm_config().n:
                out.append(("col_base", arch, label, lin, G * cap, True))
            if arch == MODES_ARCH:
                out.append(("pair", arch, label, lin, G * cap, True))
    return out


def run_modes_kernel_cases(torch, K, ops, Q, timer):
    """Each new mode against its plain version at every shape of
    ``modes_kernel_cases``, bf16, one launch a run for all experts: the
    int8 expert chains (int8 activations where one expert's plan allows:
    codes and scales bit for bit, K2's g_x bit for bit and its grads
    within gamma_rows of one expert's rows), the windowed expert runs at
    every shard with f32 and int8 tables (K1 and K2's g_x bit for bit),
    the expert pairs through K5/K6 (K5 bit for bit, K6's g_x bit for bit,
    its grads and sums within gamma_rows).  At a training step's rows the
    kernel is timed (L2 flushed, CUDA events, mean of ``TIMED``) beside
    the bound (each expert's x and y moved once and its table, 3 f32
    operations an element and stage forward, 10 backward) and
    ``torch.bmm`` over dense (E, d_in, d_out) weights (for the backward
    its two products), which the port never calls; at the headline
    shapes (qwen3-moe's gate/up, and its down's shard 0 for the windows)
    beside its plain version too, called once (a loop over the
    experts)."""
    from repro_torch.configs import get_config
    from repro_torch.core.eligibility import plan_steps, quant_acts_eligible
    rows_out, failures = [], []
    g = torch.Generator(device=DEVICE).manual_seed(2424)
    abs_sum = (lambda t: t.abs().sum(0))

    def record(kernel, case, rows, E, err, ok, ms=None, plain_ms=None,
               bms=None, bby=None, lib=None, **more):
        rows_out.append(dict(kernel=kernel, case=case, dtype="bfloat16",
                             rows=rows, experts=E, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                             library_ms=lib, ok=ok, **more))
        log(f"{kernel} {case} E={E} rows={rows} err={err:.3e} "
            + " ".join(f"{k}={v}" for k, v in more.items())
            + f" ms={fmt_ms(ms)} plain_ms={fmt_ms(plain_ms)} bound_ms="
            + (f"{bms:.4f} ({bby})" if bms is not None else "-")
            + f" library_ms={fmt_ms(lib)} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{kernel} {case} rows={rows}")

    def timed(fn, plain=False):
        # a plain version (a loop over the experts) is called once, at the
        # headline shapes only
        if not plain:
            return timer(fn)
        return timer(fn, reps=1, warm=0) if headline else None

    for kind, arch, label, lin, rows, train in modes_kernel_cases():
        headline = arch == MODES_ARCH and label == (
            "down" if kind == "col_base" else "gate/up")
        E = get_config(arch).n_experts
        sc = lin.spm_config()
        n = sc.n
        case = f"{arch} {label}"
        timing = train and timer is not None
        x = torch.randn(E, rows, lin.d_in, generator=g,
                        device=DEVICE).bfloat16()
        w = None
        if timing:
            w = torch.randn(E, lin.d_in, lin.d_out, generator=g,
                            device=DEVICE).bfloat16()
        if kind == "int8":
            runs = ops.plan_runs_for_rows(n, sc.pairing.strides(), rows)
            L = sum(len(rs) for rs, _ in runs)
            kcf, scf = Q.quantize_coeffs(_expert_table(torch, g, (E, L), n))
            d_in = 1 + 0.1 * torch.randn(E, n, generator=g, device=DEVICE)
            d_out = 1 + 0.1 * torch.randn(E, n, generator=g, device=DEVICE)
            widths = (None if lin.d_in == n else lin.d_in,
                      None if lin.d_out == n else lin.d_out)
            q_io = quant_acts_eligible(runs)
            sr = Q.scale_block_rows(runs, rows, 2) if q_io else None
            z = (Q.quantize_blocks(ops._pad_rows(x, sr), sr, runs[0][1])
                 if q_io else x)
            rows_p = z[0].shape[1] if q_io else rows

            def chain():
                return ops.forward_runs(z, kcf, runs, d_in, d_out, None,
                                        *widths, coeff_scale=scf,
                                        scale_rows=sr)

            def plain_chain():
                p = z
                for r, (rs, nt) in enumerate(runs):
                    off = sum(len(q) for q, _ in runs[:r])
                    last = r == len(runs) - 1
                    xq, xs = p if q_io else (p, None)
                    p = K.spm_stack_plain(
                        xq, kcf[:, off: off + len(rs)],
                        d_in if r == 0 else None, d_out if last else None,
                        None, xs, scf[:, off: off + len(rs)].contiguous(),
                        strides=rs, n_tile=nt,
                        in_width=widths[0] if r == 0 else None,
                        out_width=widths[1] if last else None,
                        quant_out=q_io, scale_rows=sr)
                return p
            before = K.spm_stack_kernel_call.expert_int8_launches
            y, saved = chain()
            one_each = (K.spm_stack_kernel_call.expert_int8_launches - before
                        == len(runs))
            again, _ = chain()
            want = plain_chain()
            torch.cuda.synchronize()
            ys = y if q_io else (y,)
            ws, ags = (want if q_io else (want,)), (again if q_io
                                                    else (again,))
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(ys, ws))
            ok = (err == 0 and one_each
                  and all(torch.equal(a, b) for a, b in zip(ys, ags)))
            tiles_live = [(-(-(widths[1] or n) // nt) if r == len(runs) - 1
                           else n // nt, rs, nt)
                          for r, (rs, nt) in enumerate(runs)]
            table = sum(E * len(rs) * t * nt // 2 * 4
                        for t, rs, nt in tiles_live)
            # the bound counts each expert's live rows; its padded rows
            # (zeros the function does not need) are moved and computed
            # by the kernel alone
            esz = 1 if q_io else 2
            io = E * rows * (lin.d_in + lin.d_out) * esz
            flops = sum(E * rows * t * nt * (3 * len(rs) + 2)
                        for t, rs, nt in tiles_live)
            bms, bby = bound(io + table + 2 * E * n * 4, flops)
            ms = pms = lib = None
            if timing:
                ms = timed(chain)
                pms = timed(plain_chain, plain=True)
                lib = timed(lambda: torch.bmm(x, w))
            record("K1 expert int8", case, rows, E, err, ok, ms, pms, bms,
                   bby, lib, int8_io=q_io, scale_rows=sr,
                   runs=len(runs))
            if train:
                gy = torch.randn(E, rows_p, lin.d_out, generator=g,
                                 device=DEVICE).bfloat16()
                args = (saved, kcf, gy, runs, d_in, d_out, False, *widths)
                kw = dict(coeff_scale=scf, scale_rows=sr)
                before = K.spm_stack_bwd_kernel_call.expert_int8_launches
                kern = ops.backward_runs(K.spm_stack_bwd_kernel_call, *args,
                                         **kw)
                one_each = (K.spm_stack_bwd_kernel_call.expert_int8_launches
                            - before == len(runs))
                again = ops.backward_runs(K.spm_stack_bwd_kernel_call, *args,
                                          **kw)
                plain = ops.backward_runs(K.spm_stack_bwd_plain, *args, **kw)
                mags = ops.backward_runs(functools.partial(
                    K.spm_stack_bwd_plain, col_sum=abs_sum), *args, **kw)
                torch.cuda.synchronize()
                gx_err = max((a[0].float() - p[0].float()).abs().max().item()
                             for a, p in zip(kern, plain))
                worst = max(grads_within(a[1:], p[1:], m[1:], rows_p)
                            for a, p, m in zip(kern, plain, mags))
                det = all(torch.equal(u, v) for a, c in zip(kern, again)
                          for u, v in zip(a, c))
                ok = gx_err == 0 and worst <= 1 and det and one_each
                nbytes = (E * rows * lin.d_in * esz
                          + E * rows * (lin.d_in + lin.d_out) * 2
                          + table + table * 4 + 2 * 2 * E * n * 4)
                bflops = sum(E * rows * t * nt * (10 * len(rs) + 6)
                             for t, rs, nt in tiles_live)
                kbms, kbby = bound(nbytes, bflops)
                kms = kp = kl = None
                if timing:
                    kms = timed(lambda: ops.backward_runs(
                        K.spm_stack_bwd_kernel_call, *args, **kw))
                    kp = timed(lambda: ops.backward_runs(
                        K.spm_stack_bwd_plain, *args, **kw), plain=True)
                    gyr = gy[:, :rows]
                    kl = timed(lambda: (torch.bmm(gyr, w.transpose(1, 2)),
                                        torch.bmm(x.transpose(1, 2), gyr)))
                record("K2 expert int8", case, rows, E, gx_err, ok, kms, kp,
                       kbms, kbby, kl, grad_err_over_limit=round(worst, 4),
                       deterministic=det)
                del gy, kern, again, plain, mags
            del kcf, scf, z, y, saved, want
        elif kind == "col_base":
            nl = n // SHARDS
            steps = plan_steps(n, sc.pairing.strides(), SHARDS)
            (rs, nt), *_ = ops.plan_runs_for_rows(nl, steps[0][2], rows)
            for shard in range(SHARDS):
                # the path's f32 tables (int8 ones: the GPU tests,
                # ``test_expert_window_matches_plain``)
                cf = _expert_table(torch, g, (E, len(rs)), nl)
                d_in = 1 + 0.1 * torch.randn(E, nl, generator=g,
                                             device=DEVICE)
                kw = dict(strides=rs, n_tile=nt, in_width=lin.d_in,
                          col_base=shard * nl // nt)
                before = (K.spm_stack_kernel_call.expert_window_launches,
                          K.spm_stack_bwd_kernel_call
                          .expert_window_launches)
                y = K.spm_stack_kernel_call(x, cf, d_in, **kw)
                gy = torch.randn(E, rows, nl, generator=g,
                                 device=DEVICE).bfloat16()
                got = K.spm_stack_bwd_kernel_call(x, cf, gy, d_in, **kw)
                one_each = (
                    K.spm_stack_kernel_call.expert_window_launches
                    - before[0] == 1 == K.spm_stack_bwd_kernel_call
                    .expert_window_launches - before[1])
                want = K.spm_stack_plain(x, cf, d_in, **kw)
                ref = K.spm_stack_bwd_plain(x, cf, gy, d_in, **kw)
                mags = K.spm_stack_bwd_plain(x, cf, gy, d_in,
                                             col_sum=abs_sum, **kw)
                torch.cuda.synchronize()
                err = (y.float() - want.float()).abs().max().item()
                gx_err = (got[0].float() - ref[0].float()).abs().max() \
                    .item()
                worst = grads_within(got[1:], ref[1:], mags[1:], rows)
                ok1 = err == 0 and one_each
                ok2 = gx_err == 0 and worst <= 1 and one_each
                tabb = E * len(rs) * nl // 2 * 16
                live = max(0, min(nl, lin.d_in - shard * nl))
                fb = E * rows * (live + nl) * 2 + tabb + E * nl * 4
                ff = E * rows * nl * (3 * len(rs) + 1)
                bms, bby = bound(fb, ff)
                kbms, kbby = bound(fb + E * rows * nl * 2 + tabb * 4,
                                   E * rows * nl * (10 * len(rs) + 2))
                ms = pms = lib = kms = kp = kl = None
                if timing and shard == 0:
                    xw = x[..., :nl].contiguous()
                    ww = w[:, :nl, :nl].contiguous()
                    ms = timed(lambda: K.spm_stack_kernel_call(
                        x, cf, d_in, **kw))
                    pms = timed(lambda: K.spm_stack_plain(
                        x, cf, d_in, **kw), plain=True)
                    lib = timed(lambda: torch.bmm(xw, ww))
                    kms = timed(lambda: K.spm_stack_bwd_kernel_call(
                        x, cf, gy, d_in, **kw))
                    kp = timed(lambda: K.spm_stack_bwd_plain(
                        x, cf, gy, d_in, **kw), plain=True)
                    kl = timed(lambda: (
                        torch.bmm(gy, ww.transpose(1, 2)),
                        torch.bmm(xw.transpose(1, 2), gy)))
                record("K1 expert col_base", f"{case} shard {shard}",
                       rows, E, err, ok1, ms, pms, bms, bby, lib,
                       n_local=nl)
                record("K2 expert col_base", f"{case} shard {shard}",
                       rows, E, gx_err, ok2, kms, kp, kbms, kbby, kl,
                       grad_err_over_limit=round(worst, 4))
                del cf, y, gy, got, want, ref, mags
        else:   # the expert pair, K5 and K6, int8 tables
            S, nl = SHARDS, n // SHARDS
            steps = plan_steps(n, sc.pairing.strides(), S)
            (rs, nt), = ops.plan_runs(nl, steps[0][2])
            k = steps[1][2]
            in_w = lin.d_in if lin.d_in < n else None
            cf, scf = Q.quantize_coeffs(_expert_table(
                torch, g, (S, E, len(rs)), nl))
            ma, mb, u, v, d_in = (1 + 0.1 * torch.randn(
                E, n, generator=g, device=DEVICE) for _ in range(5))
            xp = torch.randn(E, rows, in_w or n, generator=g,
                             device=DEVICE).bfloat16()
            gy = torch.randn(E, rows, n, generator=g,
                             device=DEVICE).bfloat16()
            kw = dict(strides=rs, n_tile=nt, k=k, in_width=in_w)
            before = (K.spm_overlap_kernel_call.expert_launches,
                      K.spm_overlap_bwd_kernel_call.expert_launches)
            y = K.spm_overlap_kernel_call(xp, cf, ma, mb, d_in, None, None,
                                          scf, **kw)
            got = K.spm_overlap_bwd_kernel_call(xp, cf, gy, u, v, d_in,
                                                None, scf, **kw)
            one_each = (K.spm_overlap_kernel_call.expert_launches
                        - before[0] == 1 == K.spm_overlap_bwd_kernel_call
                        .expert_launches - before[1])
            again = K.spm_overlap_kernel_call(xp, cf, ma, mb, d_in, None,
                                              None, scf, **kw)
            want = K.spm_overlap_plain(xp, cf, ma, mb, d_in, None, None, scf,
                                       **kw)
            ref = K.spm_overlap_bwd_plain(xp, cf, gy, u, v, d_in, None, scf,
                                          **kw)
            mags = K.spm_overlap_bwd_plain(xp, cf, gy, u, v, d_in, None, scf,
                                           col_sum=abs_sum, **kw)
            torch.cuda.synchronize()
            err = (y.float() - want.float()).abs().max().item()
            gx_err = (got[0].float() - ref[0].float()).abs().max().item()
            worst = grads_within(got[1:], ref[1:], mags[1:], rows)
            ok5 = err == 0 and one_each and torch.equal(y, again)
            ok6 = gx_err == 0 and worst <= 1 and one_each
            tabb = S * E * len(rs) * nl // 2 * 4
            fb = E * rows * ((in_w or n) + n) * 2 + tabb + 3 * E * n * 4
            bms, bby = bound(fb, E * rows * n * (3 * len(rs) + 3))
            kbms, kbby = bound(fb + E * rows * n * 2 + tabb * 4
                               + 4 * E * n * 4,
                               E * rows * n * (10 * len(rs) + 8))
            ms = pms = lib = kms = kp = kl = None
            if timing:
                wp = torch.randn(E, in_w or n, n, generator=g,
                                 device=DEVICE).bfloat16()
                ms = timed(lambda: K.spm_overlap_kernel_call(
                    xp, cf, ma, mb, d_in, None, None, scf, **kw))
                pms = timed(lambda: K.spm_overlap_plain(
                    xp, cf, ma, mb, d_in, None, None, scf, **kw),
                    plain=True)
                lib = timed(lambda: torch.bmm(xp, wp))
                kms = timed(lambda: K.spm_overlap_bwd_kernel_call(
                    xp, cf, gy, u, v, d_in, None, scf, **kw))
                kp = timed(lambda: K.spm_overlap_bwd_plain(
                    xp, cf, gy, u, v, d_in, None, scf, **kw), plain=True)
                kl = timed(lambda: (torch.bmm(gy, wp.transpose(1, 2)),
                                    torch.bmm(xp.transpose(1, 2), gy)))
                del wp
            record("K5 expert", case + " int8 table", rows, E, err, ok5, ms,
                   pms, bms, bby, lib, n_local=nl, k=k,
                   window=in_w is not None)
            record("K6 expert", case + " int8 table", rows, E, gx_err, ok6,
                   kms, kp, kbms, kbby, kl,
                   grad_err_over_limit=round(worst, 4))
            del cf, scf, xp, gy, y, got, again, want, ref, mags
        del x, w
        torch.cuda.empty_cache()
    return rows_out, failures


def run_modes_phase(torch, K, ops, Q, T, LM, ServeEngine, train_mod, adamw,
                    launch_train, timer):
    """Phase 24: ``MODES_ARCH`` at full width and depth from seed 0 under
    the reference's operator knobs: two ``launch.train --quantize``
    steps, quantized serving, two steps of ``with_feature_sharding(cfg,
    4)`` on a 4-shard mesh on the card, and two of
    ``with_overlap_executor(with_quantized_io(with_feature_sharding(cfg,
    4)))`` (K5/K6 over the expert axis, int8 tables); then the card
    against the CPU at ``MODES_PARITY_LAYERS`` layer
    (``run_modes_parity``), and every new mode against its plain version
    (``run_modes_kernel_cases``).  Returns (results, kernel rows,
    failures)."""
    from repro_torch.configs import get_config
    cfg = get_config(MODES_ARCH)
    out, failures, times = {}, [], {}
    common = (torch, K, ops, T, LM, train_mod, adamw, launch_train, cfg)
    for name, kw in (("int8 train", dict(quantize=True)),
                     ("sharded train", dict(shards=SHARDS)),
                     ("int8 overlap train", dict(shards=SHARDS, overlap=True,
                                                 quantize=True))):
        t = time.perf_counter()
        out[name], ok = run_modes_train(*common, label=name, **kw)
        times[name] = time.perf_counter() - t
        if not ok:
            failures.append(f"phase 24 {name}")
        if name == "int8 train":
            t = time.perf_counter()
            out["int8 serve"], ok = run_modes_serve(torch, K, ops, T,
                                                    ServeEngine, cfg)
            times["int8 serve"] = time.perf_counter() - t
            if not ok:
                failures.append("phase 24 int8 serve")
    t = time.perf_counter()
    out["parity"], ok = run_modes_parity(torch, T, LM, adamw, cfg)
    times["parity"] = time.perf_counter() - t
    if not ok:
        failures.append("phase 24 card vs CPU")
    t = time.perf_counter()
    with torch.inference_mode():     # no autograd around the kernel checks
        rows, kfail = run_modes_kernel_cases(torch, K, ops, Q, timer)
    failures += kfail
    times["kernels"] = time.perf_counter() - t
    out["seconds"] = times
    log("phase 24 parts: " + ", ".join(f"{k} {v:.1f} s"
                                       for k, v in times.items()))
    return out, rows, failures


# ---------------------------------------------------------------------------
# phase 25: a data-parallel pod of two ranks on the card
# ---------------------------------------------------------------------------

POD_BUDGET_S = 120      # phase 25's seconds, at most
POD_RANKS = 2
POD_BATCH, POD_SEQ = 8, 512            # global: 4 rows a rank
POD_MEAN_STEPS = 3
POD_STEPS = 4                          # compressed: nan@2, a checkpoint
POD_POISONED = 2                       # after step 2 (step_3), preempted
POD_CKPT_EVERY = 3                     # after step 3, which the restart
POD_PREEMPT = POD_STEPS - 1            # replays from step_3


def _flat_cat(torch, tree: dict):
    return torch.cat([t.detach().float().reshape(-1) for t in tree.values()])


def pod_on_reduce(mode, step, local, residual, reduced, new_ef, seconds):
    """Phase 25's reduction hook, on each rank: the reduction's seconds
    and bytes every step; at step 0 of a mode, rank 0 gathers both
    members' local grads (on the host) and recomputes the reduction on
    the card in one process (``(g0 + g1) * 0.5``, or
    ``member_sum_compressed_ef`` over the stacked members), held bit for
    bit to the collective's grads and, compressed, to each rank's new
    residual (by digest)."""
    import torch
    from repro_torch.parallel.ctx import bound_axis
    from repro_torch.models.transformer import stack_key
    from repro_torch.optim import compression as C
    from repro_torch.train import state_digest
    from repro_torch.configs import get_config
    mesh = bound_axis("pod")
    key = stack_key(get_config("qwen3-1.7b"))
    n = sum(t.numel() for t in local.values())
    scales = len({key(k) for k in local}) if new_ef is not None else 0
    rec = dict(kind="reduce", mode=mode, step=step, ms=seconds * 1e3,
               bytes=4 * n + 4 * scales)       # int32 or f32, f32 scales
    if step != 0:
        return rec
    rows = mesh.gather_to_root(_flat_cat(torch, local).cpu())
    own = state_digest(new_ef) if new_ef is not None else None
    ef_digests = mesh.all_gather_object(own)
    if mesh.rank != 0:
        return rec
    dev = next(iter(reduced.values())).device
    stacked = torch.stack(rows).to(dev)
    del rows
    got = _flat_cat(torch, reduced)
    if new_ef is None:
        plain = (stacked[0] + stacked[1]) * torch.tensor(0.5, device=dev)
        rec["bitwise"] = bool(torch.equal(plain, got))
    else:
        shapes = {k: t.shape for k, t in local.items()}
        g, lo = {}, 0
        for k, shp in shapes.items():
            m = shp.numel()
            g[k] = stacked[:, lo: lo + m].view(len(stacked), *shp)
            lo += m
        r = {k: torch.zeros_like(v) for k, v in g.items()}
        plain, news = C.member_sum_compressed_ef(
            g, r, groups=[key(k) for k in g])
        rec["bitwise"] = bool(torch.equal(_flat_cat(torch, plain), got))
        rec["ef_bitwise"] = [state_digest({k: v[i] for k, v in news.items()})
                             == ef_digests[i] for i in range(len(stacked))]
    return rec


def pod_on_step(mode, s, state, metrics, dt):
    """Phase 25's step hook, on each rank: the step's seconds, skip flag
    and loss, the digest of what the pod replicates (params, moments,
    count) and of this rank's residual row, K1-K4's launches since the
    last step (then set to 0) and this rank's peak memory."""
    import torch
    from repro_torch.kernels import spm_stack as K
    from repro_torch.train import state_digest
    opt = state["opt"]
    launches = {k: v for k, v in q8_counts(K).items() if " " not in k}
    K.reset_launch_counts()
    return dict(kind="step", mode=mode, s=s, dt=dt,
                skipped=metrics["skipped"], loss=metrics["loss"],
                digest=state_digest({"params": state["params"],
                                     "mu": opt["mu"], "nu": opt["nu"],
                                     "count": opt["count"]}),
                ef=state_digest(opt["ef"]) if "ef" in opt else None,
                launches=launches,
                peak=torch.cuda.max_memory_allocated(
                    next(state["params"].parameters()).device))


def pod_rank(mesh, root: str):
    """One rank of phase 25: two ``launch.train.train`` runs that join the
    pod (``--pod-dp 2``): the plain mean, and the compressed reduction
    with ``nan@2``, a checkpoint at step 3 and a preemption after the
    last step, so that the restart replays it from the checkpoint.
    Returns each run's records and rank 0's event kinds."""
    import functools as ft

    import torch
    from repro_torch.kernels import spm_stack as K
    from repro_torch.launch import train as LT
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    base = ["--arch", "qwen3-1.7b", "--batch", str(POD_BATCH), "--seq",
            str(POD_SEQ), "--pod-dp", str(POD_RANKS), "--log-every", "1",
            "--backoff-base", "0"]
    ckpt = os.path.join(root, "ckpt")
    runs = {"mean": ["--steps", str(POD_MEAN_STEPS)],
            "compressed": ["--steps", str(POD_STEPS), "--compress-pod-grads",
                           "--chaos-spec",
                           f"nan@{POD_POISONED};preempt@{POD_PREEMPT}",
                           "--ckpt-dir", ckpt, "--ckpt-every",
                           str(POD_CKPT_EVERY)]}
    out = {}
    for mode, extra in runs.items():
        recs, timings = [], []
        t0 = time.perf_counter()
        LT.train(LT.build_parser().parse_args(base + extra),
                 on_step=ft.partial(pod_on_step, mode),
                 on_reduce=ft.partial(pod_on_reduce, mode), records=recs,
                 timings=timings)
        out[mode] = dict(records=recs[0], wall_s=time.perf_counter() - t0,
                         timings=timings)
    if mesh.rank == 0:
        with open(os.path.join(ckpt, "events.jsonl")) as f:
            out["events"] = [json.loads(line)["kind"] for line in f]
        out["ef_shape"] = pod_ckpt_ef_shape(ckpt)
    return out


def pod_ckpt_ef_shape(ckpt: str):
    """The shape on disk of the newest checkpoint's first ``opt.ef``
    array: a1 in the flatten order (opt's keys sorted: count, ef, mu, nu;
    then params, step)."""
    from repro_torch.train import checkpoint as CK
    step = CK.latest_step(ckpt)
    with open(os.path.join(ckpt, f"step_{step}", "meta.json")) as f:
        return json.load(f)["manifest"]["a1"]["shape"]


def run_pod_phase(torch, K, ops, cfg, smi):
    """``launch.train.train`` over a pod of ``POD_RANKS`` ranks on the one
    card (gloo, both ranks on ``cuda:0``; ``launch.mesh.run_ranks``:
    this process is rank 0), full-width ``cfg`` from seed 0, global batch
    8 x 512 (4 rows a rank), one spawn for two runs: the plain mean
    (``POD_MEAN_STEPS`` steps) and the int8 error-feedback reduction
    (``--compress-pod-grads``, ``POD_STEPS`` steps, ``nan@2``, a
    checkpoint at step 3 with ``opt.ef`` of shape (2, ...) on disk, then
    preempted after the last step: the restart restores step_3 and runs
    the last step again).  Held: (a) after every step both ranks' params,
    moments and count bit for bit equal (digests); (b) at step 0 of each
    mode the collective's grads bit for bit a recomputation on the card
    in one process from both members' local grads, and the new residual
    rows too; (c) the poisoned step skipped on both ranks with params,
    moments and residual unchanged; (d) the last step run again after the
    restore ending bit for bit where the uninterrupted run ended; (e)
    K1-K4's launches a rank a step equal to ``planned_train_launches`` at
    4 rows.  Logged
    beside the card's name and power limit: each mode's step ms, the
    reduction's wall ms (gloo's staging through the host included),
    bytes reduced a step, each rank's peak GiB, the backend.  The
    checkpoints live in a temporary directory, removed after."""
    import shutil
    import tempfile
    from repro_torch.launch.mesh import pod_backend, run_ranks
    failures = []
    root = tempfile.mkdtemp(prefix="spm_pod_")
    try:
        torch.cuda.empty_cache()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        ranks = run_ranks(POD_RANKS, pod_rank, (root,), device="cuda")
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    backend = pod_backend(POD_RANKS, "cuda")
    per_step = planned_train_launches(cfg, ops, POD_BATCH // POD_RANKS
                                      * POD_SEQ)
    res = dict(ranks=POD_RANKS, batch=POD_BATCH, seq=POD_SEQ,
               backend=backend[0], backend_rule=backend[1], wall_s=wall,
               planned_per_step=per_step, gpu=smi, modes={})

    def steps(r, mode):
        return [x for x in ranks[r][mode]["records"] if x["kind"] == "step"]

    def reduces(r, mode):
        return [x for x in ranks[r][mode]["records"]
                if x["kind"] == "reduce"]

    # (a) replication and (e) launches, every run and step
    repl = all(a["digest"] == b["digest"] for mode in ("mean", "compressed")
               for a, b in zip(steps(0, mode), steps(1, mode)))
    launches_ok = all(x["launches"] == per_step for r in range(POD_RANKS)
                      for mode in ("mean", "compressed")
                      for x in steps(r, mode))
    # (b) the reductions at step 0
    b_mean = reduces(0, "mean")[0].get("bitwise")
    b_comp = reduces(0, "compressed")[0].get("bitwise")
    b_ef = reduces(0, "compressed")[0].get("ef_bitwise")
    # (c) the poisoned step
    poison_ok = True
    for r in range(POD_RANKS):
        st = steps(r, "compressed")
        poison_ok &= [x["skipped"] for x in st] == [
            float(i == POD_POISONED) for i in range(POD_STEPS + 1)]
        poison_ok &= (st[POD_POISONED]["digest"]
                      == st[POD_POISONED - 1]["digest"]
                      and st[POD_POISONED]["ef"]
                      == st[POD_POISONED - 1]["ef"])
    # (d) resume: the last step, before the preemption and replayed
    resume_ok = True
    for r in range(POD_RANKS):
        last = [x for x in steps(r, "compressed") if x["s"] == POD_STEPS - 1]
        resume_ok &= (len(last) == 2 and last[0]["digest"] == last[1]["digest"]
                      and last[0]["ef"] == last[1]["ef"])
    events = ranks[0].get("events", [])
    ef_shape = ranks[0].get("ef_shape")
    resume_ok &= ("chaos_preempt" in events and "restart" in events
                  and ef_shape is not None and ef_shape[0] == POD_RANKS)
    finite = all(math.isfinite(x["loss"]) for r in range(POD_RANKS)
                 for mode in ("mean", "compressed") for x in steps(r, mode))

    def med(v):
        v = sorted(v)
        return (v[len(v) // 2] if len(v) % 2
                else 0.5 * (v[len(v) // 2 - 1] + v[len(v) // 2]))

    for mode in ("mean", "compressed"):
        st = [x for x in steps(0, mode)[1:] if not x["skipped"]]
        red = reduces(0, mode)[1:]
        if mode == "compressed":      # the restart's first step aside
            st, red = st[:-1], red[:-1]
        res["modes"][mode] = dict(
            step_ms_median=med([x["dt"] * 1e3 for x in st]),
            step_ms=[x["dt"] * 1e3 for x in steps(0, mode)],
            reduce_ms_median=med([x["ms"] for x in red]),
            reduce_ms=[x["ms"] for x in reduces(0, mode)],
            bytes_reduced=reduces(0, mode)[0]["bytes"],
            peak_gib=[steps(r, mode)[-1]["peak"] / 2**30
                      for r in range(POD_RANKS)],
            losses=[x["loss"] for x in steps(0, mode)],
            wall_s=ranks[0][mode]["wall_s"])
    res["checkpoint"] = dict(events=events, ef_shape=ef_shape,
                             timings=ranks[0]["compressed"]["timings"])
    res.update(replicated=repl, launches_ok=launches_ok,
               reduce_bitwise={"mean": b_mean, "compressed": b_comp,
                               "ef": b_ef},
               poisoned_ok=poison_ok, resume_ok=resume_ok, finite=finite)
    for mode, m in res["modes"].items():
        log(f"pod {mode} on {smi}, {POD_RANKS} ranks on one card over "
            f"{backend[0]} ({backend[1]}): step {m['step_ms_median']:.1f} ms "
            f"(median of the healthy steps after the first), reduction "
            f"{m['reduce_ms_median']:.1f} ms wall (host staging included), "
            f"{m['bytes_reduced'] / 1e9:.3f} GB reduced a step, peak "
            + ", ".join(f"rank {r} {g:.2f} GiB"
                        for r, g in enumerate(m["peak_gib"]))
            + f", losses {[round(v, 4) for v in m['losses']]}")
    ck = {t["op"]: t["s"] for t in res["checkpoint"]["timings"]}
    ok = (repl and launches_ok and b_mean and b_comp and b_ef
          and all(b_ef) and poison_ok and resume_ok and finite)
    log(f"pod checkpoint on {smi}: save {ck.get('save', 0):.1f} s, verify "
        f"{ck.get('verify', 0):.1f} s, restore {ck.get('restore', 0):.1f} s "
        f"(rank 0 writes both residual rows)")
    log(f"pod checks: (a) replicated {repl}; (b) reductions bit for bit "
        f"mean {b_mean}, compressed {b_comp}, residual rows {b_ef}; (c) "
        f"poisoned step {poison_ok}; (d) resume {resume_ok} (events "
        f"{events}, opt.ef on disk {ef_shape}); (e) launches {launches_ok} "
        f"(planned {per_step} a rank a step); wall {wall:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("pod")
    return res, failures



# ---------------------------------------------------------------------------
# phase 26: the feature-sharded executor with one shard a rank
# ---------------------------------------------------------------------------

RANKS_BUDGET_S = 110    # phase 26's seconds, at most
RANKS_LIMIT_S = 300     # past this the spawn's ranks are killed: no hang
RANKS = 4
RANKS_LAYERS = 4        # the trained depth, of 28 (each rank holds it all;
#                         8 took 81.4 s of the phase's 110 on a busy host,
#                         the exchange through the host growing with depth)
RANKS_STEPS = 3         # a mode's steps: step-serial, then overlap
RANKS_BATCH, RANKS_SEQ = 4, 512
RANK_ROWS = 4096        # the kernel cases' rows
RANKS_PEAK_GIB = 64     # the four ranks' peaks together, at most


def rank_pair_cases(cfg):
    """(label, n_local, strides, n_tile, k, in_width, fold, int8) of the
    rank-mode cases over ``RANKS`` ranks: q/k/v/o's pair (n_local 512, 9
    stages) with k = 1, then k = 2 with d_out and bias folded (its
    schedule ends on cross k = 2), with an int8 table, and gate/up's
    windowed first run (n_local 1536 of in_width 2048)."""
    from repro_torch.configs import with_feature_sharding
    from repro_torch.core.eligibility import plan_steps
    from repro_torch.kernels.ops import plan_runs
    scfg = with_feature_sharding(cfg, RANKS)
    out = []
    for lin, cases in ((scfg.attn_cfg(cfg.layers[0]).o_proj,
                        (("qkvo k=1", 1, False, False),
                         ("qkvo k=2 end", 2, True, False),
                         ("int8 table", 1, False, True))),
                       (scfg.ffn_cfg().up, (("gate/up window", 1, False,
                                             False),))):
        spm = lin.spm_config()
        nl = spm.n // RANKS
        steps = plan_steps(spm.n, spm.pairing.strides(), RANKS)
        (rs, nt), = plan_runs(nl, steps[0][2])
        in_w = lin.d_in if lin.d_in < spm.n else None
        for label, k, fold, q8 in cases:
            out.append((label, nl, tuple(rs), nt, k, in_w, fold, q8))
    return out


def _sum_events(torch, events) -> dict:
    """Device ms by kind of a rank-mode call's ``events``: the send
    kernels, the stream waits (data and credits) and the consume kernels
    (the mix, or K6's rest)."""
    torch.cuda.synchronize()
    out = {"send": 0.0, "wait": 0.0, "consume": 0.0}
    for kind, a, b in events:
        key = "wait" if kind.endswith("wait") else kind
        if key in out:
            out[key] += a.elapsed_time(b)
    return out


def rank_pair_job(pod, cases, rows: int, timed: bool):
    """One rank of phase 26 (a): for each case (``rank_pair_cases``) the
    same seeded operands on every rank; K5's and K6's rank mode on this
    rank's shard, held to their plain versions (the per-block exchange
    over the group) and to the one-card K5/K6 over every shard (this
    rank's columns): y and g_x bit for bit, the table and vector grads
    within gamma_rows of the sum of their terms' magnitudes; a second call
    bit for bit.  Timed (``timed``) with the L2 flushed, every rank in
    step: the rank-mode calls, their send, wait and consume parts apart,
    the plain versions; on rank 0 alone the one-card K5/K6 and the library
    products of the same rows.  Returns the rows of the report."""
    import torch
    from repro_torch.kernels import quant as Q
    from repro_torch.kernels import spm_stack as K
    from repro_torch.launch.mesh import make_feature_rank_mesh
    from repro_torch.parallel import spm_shard as SH
    mesh = make_feature_rank_mesh(pod.size, "cuda")
    S, j = pod.size, pod.rank
    timer = Timer(torch) if timed else None
    abs_sum = (lambda t: t.abs().sum(0))
    out = []
    for ci, (label, nl, strides, nt, k, in_w, fold, q8) in enumerate(cases):
        g = torch.Generator(device=DEVICE).manual_seed(2600 + ci)
        n, L = S * nl, len(strides)

        def rnd(*shape, scale=1.0):
            return scale * torch.randn(*shape, generator=g, device=DEVICE)
        th = (torch.rand(S, L, nl // 2, generator=g, device=DEVICE) * 2
              - 1) * math.pi
        cf = (torch.stack([th.cos(), -th.sin(), th.sin(), th.cos()], -1)
              + rnd(S, L, nl // 2, 4, scale=0.05)).contiguous()
        scale, cf_bytes = None, L * nl // 2 * 16
        if q8:
            qc, sc = Q.quantize_coeffs(cf.reshape(S * L, nl // 2, 4))
            cf, scale = qc.reshape(S, L, nl // 2, 4), sc.reshape(S, L)
            cf_bytes = L * (nl // 2 * 4 + 4)
        ma, mb, u, v, d_in = (1 + 0.1 * rnd(n) for _ in range(5))
        d_out = 1 + 0.1 * rnd(n) if fold else None
        bias = 0.1 * rnd(n) if fold else None
        dt = torch.bfloat16
        x = rnd(rows, in_w or n).to(dt)
        gy = rnd(rows, n).to(dt)
        sl = slice(j * nl, (j + 1) * nl)

        def mine(t):
            return None if t is None else t[sl].contiguous()
        xr = x if in_w else x[:, sl].contiguous()
        blocks = SH._overlap_row_blocks((("local", 0, strides),), nl, rows,
                                        2, True)
        rkw = dict(strides=strides, n_tile=nt, k=k, mesh=mesh, blocks=blocks,
                   col_base=j * nl if in_w else 0, in_width=in_w)
        fwd = (xr, cf[j], mine(ma), mine(mb), mine(d_in), mine(d_out),
               mine(bias), None if scale is None else scale[j])
        bwd = (xr, cf[j], gy[:, sl].contiguous(), mine(u), mine(v),
               mine(d_in), mine(d_out), None if scale is None else scale[j])
        K.reset_launch_counts()
        y = K.spm_overlap_rank_call(*fwd, **rkw)
        gr = K.spm_overlap_bwd_rank_call(*bwd, **rkw)
        launches = {"K5 rank": K.spm_overlap_rank_call.launches,
                    "K5 rank mix": K.spm_overlap_rank_call.mix_launches,
                    "K6 rank": K.spm_overlap_bwd_rank_call.launches,
                    "K6 rank send":
                        K.spm_overlap_bwd_rank_call.send_launches}
        y2 = K.spm_overlap_rank_call(*fwd, **rkw)
        gr2 = K.spm_overlap_bwd_rank_call(*bwd, **rkw)
        yp = K.spm_overlap_rank_plain(*fwd, **rkw)
        gp = K.spm_overlap_bwd_rank_plain(*bwd, **rkw)
        gm = K.spm_overlap_bwd_rank_plain(*bwd, col_sum=abs_sum, **rkw)
        okw = dict(strides=strides, n_tile=nt, k=k, in_width=in_w)
        y1 = K.spm_overlap_kernel_call(x, cf, ma, mb, d_in, d_out, bias,
                                       scale, **okw)
        g1 = K.spm_overlap_bwd_kernel_call(x, cf, gy, u, v, d_in, d_out,
                                           scale, **okw)
        torch.cuda.synchronize()
        # the drain: every channel's data and credit words at its last
        # number, every block consumed when the calls end
        # (read with every rank here: a partner that went on to its next
        # call would already have signalled this rank's data word again)
        pod.barrier()
        words = [(ch.seq, ch.words()) for ch in mesh.channels.values()]
        pod.barrier()
        drained = all(w[:2] == w[2:] and max(w) == seq for seq, w in words)
        one = (g1[1][j],) + tuple(t[sl] for t in g1[2:])
        res = dict(
            case=label, rank=j, rows=rows, blocks=list(blocks), n_local=nl,
            stages=L, k=k, in_width=in_w, folds_d_out=fold, int8_table=q8,
            launches=launches, drained=drained,
            k5_err=(y.float() - yp.float()).abs().max().item(),
            k5_one_card=torch.equal(y, y1[:, sl]),
            gx_err=(gr[0].float() - gp[0].float()).abs().max().item(),
            gx_one_card=torch.equal(gr[0], g1[0][:, sl]),
            grad_err_over_limit=grads_within(gr[1:], gp[1:], gm[1:], rows),
            one_card_grad_err_over_limit=grads_within(gr[1:], one, gm[1:],
                                                      rows),
            deterministic=torch.equal(y, y2) and all(
                torch.equal(a, b) for a, b in zip(gr, gr2)),
            finite=bool(torch.isfinite(y.float()).all()) and all(
                bool(torch.isfinite(t.float()).all()) for t in gr))
        res["ok"] = (res["k5_err"] == 0 and res["k5_one_card"]
                     and res["gx_err"] == 0 and res["gx_one_card"]
                     and res["grad_err_over_limit"] <= 1
                     and res["one_card_grad_err_over_limit"] <= 1
                     and res["deterministic"] and res["finite"]
                     and res["drained"]
                     and launches["K5 rank"] == len(blocks)
                     and launches["K6 rank"] == len(blocks))
        if timed:
            res["k5_ms"] = timer(lambda: K.spm_overlap_rank_call(*fwd,
                                                                 **rkw))
            res["k6_ms"] = timer(lambda: K.spm_overlap_bwd_rank_call(
                *bwd, **rkw))
            ev5, ev6 = [], []
            K.spm_overlap_rank_call(*fwd, events=ev5, **rkw)
            K.spm_overlap_bwd_rank_call(*bwd, events=ev6, **rkw)
            res["k5_parts_ms"] = _sum_events(torch, ev5)
            res["k6_parts_ms"] = _sum_events(torch, ev6)
            res["k5_plain_ms"] = timer(
                lambda: K.spm_overlap_rank_plain(*fwd, **rkw), reps=3,
                warm=1)
            res["k6_plain_ms"] = timer(
                lambda: K.spm_overlap_bwd_rank_plain(*bwd, **rkw), reps=3,
                warm=1)
            if j == 0:
                # one rank's dense pair step: (rows, 2 n_local) @ (2 n_local,
                # n_local), and its two backward products
                xb = rnd(rows, 2 * nl).to(dt)
                w = rnd(2 * nl, nl).to(dt)
                gb = rnd(rows, nl).to(dt)
                res["k5_one_card_ms"] = timer(
                    lambda: K.spm_overlap_kernel_call(
                        x, cf, ma, mb, d_in, d_out, bias, scale, **okw))
                res["k6_one_card_ms"] = timer(
                    lambda: K.spm_overlap_bwd_kernel_call(
                        x, cf, gy, u, v, d_in, d_out, scale, **okw))
                res["k5_library_ms"] = timer(lambda: torch.matmul(xb, w))
                res["k6_library_ms"] = timer(lambda: (
                    torch.matmul(gb, w.T), torch.matmul(xb.T, gb)))
            pod.barrier()
        # the bound of one rank's pair: x's live columns, the partner's
        # slab (K6: its package) and the operands read once, y (K6: g_x,
        # the table's grads and the sums) written once
        live = min(nl, max(0, (in_w or n) - j * nl))
        vec = 4 * nl
        res["k5_bound_ms"], res["k5_bound_by"] = bound(
            rows * (live + 2 * nl) * 2 + cf_bytes + (3 + 2 * fold) * vec,
            rows * nl * (3 * L + 4 + 2 * fold))
        res["k6_bound_ms"], res["k6_bound_by"] = bound(
            rows * (live + 4 * nl) * 2 + cf_bytes + L * nl // 2 * 16
            + (3 + fold) * vec + (3 + 2 * fold) * vec,
            rows * nl * (10 * L + 14))
        out.append(res)
    return out


def _rank_cfg(cfg, overlap: bool):
    from repro_torch.configs import with_feature_sharding
    from repro_torch.configs.base import with_overlap_executor
    scfg = cut_depth(with_feature_sharding(cfg, RANKS), n=RANKS_LAYERS)
    return with_overlap_executor(scfg) if overlap else scfg


def rank_train_plan(scfg, rows: int, overlap: bool) -> dict:
    """One rank's K1/K2 and K5/K6 rank-mode launches a training step of
    ``scfg`` over ``rows`` rows: a linear's local steps run for the
    rank's shard alone, per planned run (``plan_runs_for_rows``), K2 once
    per forward run and the backward's own remats; on the overlap schedule
    every step runs per row block (``_overlap_row_blocks``) and each fused
    pair is one send and one consume kernel a block forward (K5) and
    backward (K6); the forward runs twice (remat)."""
    from repro_torch.core.eligibility import (overlap_segments, plan_steps,
                                              resolve_overlap)
    from repro_torch.kernels import ops
    from repro_torch.parallel import spm_shard as SH
    spec = scfg.layers[0]
    acfg, fcfg = scfg.attn_cfg(spec), scfg.ffn_cfg()
    f = dict.fromkeys(("K1", "K1 col_base", "K1 bwd remat", "K5 rank"), 0)
    for lin in (acfg.q_proj, acfg.kv_proj, acfg.kv_proj, acfg.o_proj,
                fcfg.gate, fcfg.up, fcfg.down):
        spm = lin.spm_config()
        nl = spm.n // RANKS
        steps = plan_steps(spm.n, spm.pairing.strides(), RANKS)
        win = lin.d_in < spm.n and steps[0][0] == "local"
        ov = overlap and resolve_overlap(spm, steps)   # needs a cross step
        blocks = (SH._overlap_row_blocks(steps, nl, rows, 2, True)
                  if ov else (rows,))
        fused = SH._rdma_cross_indices(steps, nl) if ov else ()
        i = 0
        for seg in (overlap_segments(steps) if ov
                    else tuple(("one", st) for st in steps)):
            if seg[0] == "pair" and i + 1 in fused:
                f["K5 rank"] += len(blocks)
                i += 2
                continue
            for st in seg[1:]:
                if st[0] == "local":
                    for b in blocks:
                        runs = ops.plan_runs_for_rows(nl, st[2], b)
                        f["K1"] += len(runs)
                        f["K1 bwd remat"] += len(runs) - 1
                        f["K1 col_base"] += int(i == 0 and win)
                i += 1
    m = 2 if scfg.remat else 1
    L = scfg.n_layers
    return {"K1": L * (m * f["K1"] + f["K1 bwd remat"]),
            "K1 col_base": L * m * f["K1 col_base"], "K2": L * f["K1"],
            "K2 col_base": L * f["K1 col_base"],
            "K5 rank": L * m * f["K5 rank"], "K6 rank": L * f["K5 rank"],
            "K3": 0, "K4": 0, "K5": 0, "K6": 0}


def rank_counts(K) -> dict:
    return {"K1": K.spm_stack_kernel_call.launches,
            "K1 col_base": K.spm_stack_kernel_call.window_launches,
            "K2": K.spm_stack_bwd_kernel_call.launches,
            "K2 col_base": K.spm_stack_bwd_kernel_call.window_launches,
            "K5 rank": K.spm_overlap_rank_call.launches,
            "K6 rank": K.spm_overlap_bwd_rank_call.launches,
            "K3": K.spm_block_kernel_call.launches,
            "K4": K.spm_block_bwd_kernel_call.launches,
            "K5": K.spm_overlap_kernel_call.launches,
            "K6": K.spm_overlap_bwd_kernel_call.launches}


def _spm_leaf(name: str) -> bool:
    """A leaf of an SPM operator (its grads sum rows in per-block groups
    on the overlap schedule across ranks), by its state-dict name."""
    return name.rsplit(".", 1)[-1] in ("mix", "d_in", "d_out", "bias",
                                       "theta")


def rank_train_steps(mesh, cfg, on_step=None, steps=None):
    """``steps["serial"]`` steps of ``_rank_cfg(cfg, False)`` then
    ``steps["overlap"]`` of ``_rank_cfg(cfg, True)`` (``RANKS_STEPS``
    each by default) under ``mesh``, each mode from the seed-0 weights,
    through ``make_train_step`` on the batches of seed 5
    (``parity_batch``).  Per step: loss, skip flag, seconds, the digest of
    params, moments and count, the exchange's wall seconds and bytes, the
    launches (``rank_counts``, set to 0 before each step); before the
    overlap mode's step 0, one forward and backward for its loss, the
    digest of its non-SPM grads (which g_x alone makes) and its SPM grads
    (on the host).  ``on_step(mode, s, state)`` sees each step's state."""
    import torch
    from repro_torch import train as train_mod
    from repro_torch.models import causal_lm as LM
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.kernels import spm_stack as K
    from repro_torch.parallel import activation_sharding
    out = {}
    steps = steps or {"serial": RANKS_STEPS, "overlap": RANKS_STEPS}
    for mode, overlap in (("serial", False), ("overlap", True)):
        scfg = _rank_cfg(cfg, overlap)
        params = T.init_model(scfg, seed=0, device=DEVICE)
        state = train_mod.make_train_state(params)
        step = train_mod.make_train_step(
            lambda p, b, c=scfg: LM.lm_loss(p, b, c),
            adamw.OptimizerConfig(lr=3e-4, total_steps=RANKS_STEPS,
                                  warmup_steps=1))
        recs = []
        for s in range(steps[mode]):
            b = {k_: t.to(DEVICE) for k_, t in parity_batch(
                torch, scfg, RANKS_BATCH, RANKS_SEQ).items()}
            if mesh.ranked:
                st0 = dict(mesh.stats)
            first = {}
            with activation_sharding(mesh, shard_feature=True):
                if s == 0 and overlap:
                    loss, _ = LM.lm_loss(state["params"], b, scfg)
                    loss.backward()
                    named = [(k_, p) for k_, p in
                             state["params"].named_parameters()
                             if p.grad is not None]
                    first = dict(
                        loss0=float(loss.detach()),
                        grads_digest=train_mod.state_digest(
                            {k_: p.grad for k_, p in named
                             if not _spm_leaf(k_)}),
                        spm_grads={k_: p.grad.detach().float().cpu()
                                   for k_, p in named if _spm_leaf(k_)})
                    del loss, named
                    for p in state["params"].parameters():
                        p.grad = None
                K.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, b, 0.0)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            opt = state["opt"]
            rec = dict(s=s, loss=float(m["loss"]), skipped=float(
                m["skipped"]), dt=dt, launches=rank_counts(K),
                digest=train_mod.state_digest(
                    {"params": state["params"], "mu": opt["mu"],
                     "nu": opt["nu"], "count": opt["count"]}))
            if mesh.ranked:
                rec["exchange_s"] = mesh.stats["seconds"] - st0["seconds"]
                rec["exchange_bytes"] = mesh.stats["bytes"] - st0["bytes"]
                rec["exchange_calls"] = mesh.stats["calls"] - st0["calls"]
            rec.update(first)
            recs.append(rec)
            if on_step is not None:
                on_step(mode, s, state)
        out[mode] = recs
        del state, params, step
        torch.cuda.empty_cache()
    return out


def rank_train_job(pod, cfg, one=None):
    """One rank of phase 26 (b): ``rank_train_steps`` on its rank mesh;
    rank 0 also holds each overlap step's params to the one-card run's
    (``one``, kept on the host), and every rank reports its peak."""
    import torch
    from repro_torch.launch.mesh import make_feature_rank_mesh
    mesh = make_feature_rank_mesh(pod.size, "cuda")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()     # what earlier work left here
    diffs = []

    def on_step(mode, s, state):
        if one is None or mode != "overlap" or s >= len(
                one["overlap_params"]):
            return
        ref, init = one["overlap_params"][s], one["init_params"]
        d2 = u2 = 0.0
        for k_, p in state["params"].state_dict().items():
            got = p.detach().float().cpu()
            d2 += float(((got - ref[k_]) ** 2).sum())
            u2 += float(((ref[k_] - init[k_]) ** 2).sum())
        diffs.append((d2 ** .5, u2 ** .5))

    recs = rank_train_steps(mesh, cfg, on_step)
    if pod.rank != 0:
        recs["overlap"][0].pop("spm_grads", None)
    return dict(records=recs, param_diffs=diffs, backend=mesh.backend,
                peak=torch.cuda.max_memory_allocated(), base=base)


def rank_phase_job(pod, cfg, cases, one=None):
    """A rank of phase 26: the kernel cases, then the training steps."""
    return dict(kernels=rank_pair_job(pod, cases, RANK_ROWS, True),
                train=rank_train_job(pod, cfg, one))


@contextlib.contextmanager
def _spawn_limit(seconds: float, what: str):
    """Past ``seconds`` inside the block, kill every process this one has
    started and end the script with code 1: a rank that waits on a dead
    partner (a stream wait never satisfied) would hold it for good."""
    import multiprocessing
    import threading

    def fire():
        log(f"{what}: over its {seconds:.0f} s limit, killing every rank")
        for p in multiprocessing.active_children():
            p.kill()
        sys.stdout.flush()
        os._exit(1)
    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()
    try:
        yield
    finally:
        t.cancel()


def run_ranks_phase(torch, K, cfg, smi):
    """Phase 26: ``RANKS`` ranks on the one card over gloo
    (``launch.mesh.run_ranks``, this process rank 0), each holding shard
    j = its rank of the feature mesh.  (a) ``rank_pair_cases`` through K5
    and K6 rank mode, against their plain versions and the one-card
    kernels (``rank_pair_job``), timed.  (b) Full-width qwen3-1.7b at
    ``RANKS_LAYERS`` layers, seed 0, 4 x 512 rows on every rank:
    ``RANKS_STEPS`` step-serial steps, then as many on the overlap
    schedule (K5/K6 rank mode), held: the ranks' params, moments and count
    bit for bit equal after every step; the step-serial steps' loss and
    state bit for bit the one-card sharded steps at the same depth (run
    here first); on the overlap schedule step 0's loss and its non-SPM
    grads (from g_x alone) bit for bit the one-card overlap step's, its
    SPM grads (relative norm) and the params after it (against the
    update) within phase 18's bound (the rows' sums group by block; the
    later steps start from params that differ there, and bf16 activations
    carry that on, so they are held to each other, not to the card's
    one-process run);
    K1/K2 and K5/K6 rank-mode launches a rank a step equal to
    ``rank_train_plan``; the ranks' peaks together under
    ``RANKS_PEAK_GIB``.  The spawn has ``RANKS_LIMIT_S`` of its own."""
    from repro_torch.launch.mesh import pod_backend, run_ranks
    from repro_torch.parallel import make_feature_mesh
    failures = []
    t_one = time.perf_counter()
    one_mesh = make_feature_mesh(RANKS)
    init = {}

    def keep(mode, s, state):
        if mode == "overlap":
            one["overlap_params"].append(
                {k_: p.detach().float().cpu()
                 for k_, p in state["params"].state_dict().items()})

    one = {"overlap_params": []}
    from repro_torch.models import transformer as T
    init_cfg = _rank_cfg(cfg, True)
    p0 = T.init_model(init_cfg, seed=0, device=DEVICE)
    init = {k_: p.detach().float().cpu() for k_, p in p0.state_dict().items()}
    del p0
    one["init_params"] = init
    one_recs = rank_train_steps(one_mesh, cfg, keep,
                                {"serial": RANKS_STEPS, "overlap": 1})
    one_s = time.perf_counter() - t_one
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    cases = rank_pair_cases(cfg)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with _spawn_limit(RANKS_LIMIT_S, "phase 26"):
        ranks = run_ranks(RANKS, rank_phase_job, (cfg, cases),
                          device="cuda", local=dict(one=one))
    wall = time.perf_counter() - t0
    backend = pod_backend(RANKS, "cuda")
    rows = RANKS_BATCH * RANKS_SEQ
    plan = {m: rank_train_plan(_rank_cfg(cfg, m == "overlap"), rows,
                               m == "overlap") for m in ("serial",
                                                         "overlap")}
    # (a) the kernel cases
    kern = [r for rk in ranks for r in rk["kernels"]]
    kern_ok = all(r["ok"] for r in kern)
    for r in ranks[0]["kernels"]:
        p5, p6 = r["k5_parts_ms"], r["k6_parts_ms"]
        case_ok = all(x["ok"] for x in kern if x["case"] == r["case"])
        log(f"rank pair {r['case']:14s} rank 0 of {RANKS} rows={r['rows']} "
            f"blocks={r['blocks']} | K5 rank err={r['k5_err']:.1e} "
            f"one-card={r['k5_one_card']} ms={fmt_ms(r['k5_ms'])} (send "
            f"{p5['send']:.4f}, wait {p5['wait']:.4f}, mix "
            f"{p5['consume']:.4f}) plain_ms={fmt_ms(r['k5_plain_ms'])} "
            f"one-card K5 {fmt_ms(r['k5_one_card_ms'])} bound_ms="
            f"{r['k5_bound_ms']:.4f} ({r['k5_bound_by']}) library_ms="
            f"{fmt_ms(r['k5_library_ms'])} | K6 rank gx_err="
            f"{r['gx_err']:.1e} one-card={r['gx_one_card']} grad err/limit "
            f"{r['grad_err_over_limit']:.3f} (one-card "
            f"{r['one_card_grad_err_over_limit']:.3f}) ms="
            f"{fmt_ms(r['k6_ms'])} (send {p6['send']:.4f}, wait "
            f"{p6['wait']:.4f}, consume {p6['consume']:.4f}) plain_ms="
            f"{fmt_ms(r['k6_plain_ms'])} one-card K6 "
            f"{fmt_ms(r['k6_one_card_ms'])} bound_ms={r['k6_bound_ms']:.4f} "
            f"({r['k6_bound_by']}) library_ms={fmt_ms(r['k6_library_ms'])} "
            f"det={r['deterministic']} launches {r['launches']} "
            f"{'ok' if case_ok else 'FAIL'}")
    if not kern_ok:
        failures.append("rank pair kernels")
    # (b) training
    recs = [rk["train"]["records"] for rk in ranks]
    repl = all(a["digest"] == b["digest"] for rr in recs[1:]
               for mode in ("serial", "overlap")
               for a, b in zip(recs[0][mode], rr[mode]))
    serial_one = all(a["digest"] == b["digest"] and a["loss"] == b["loss"]
                     for a, b in zip(recs[0]["serial"], one_recs["serial"]))
    o_r, o_1 = recs[0]["overlap"][0], one_recs["overlap"][0]
    overlap_loss = o_r["loss0"] == o_1["loss0"] and o_r["loss"] == o_1["loss"]
    overlap_gx = o_r["grads_digest"] == o_1["grads_digest"]
    # the SPM grads (relative norm) and the params: phase 18's bound, the
    # rows' sums grouped by block in place of one group
    rel = 8 * math.sqrt(train_depth(_rank_cfg(cfg, True), RANKS_SEQ)) \
        * EPS["float32"]
    worst = 0.0
    for k_, g1 in o_1["spm_grads"].items():
        d = (o_r["spm_grads"][k_] - g1).norm().item()
        worst = max(worst, d / max(g1.norm().item(), 1e-30))
    diffs = ranks[0]["train"]["param_diffs"]
    params_ok = len(diffs) == 1 and all(d <= rel * u for d, u in diffs)
    launches_ok = all(x["launches"] == plan[mode] for rr in recs
                      for mode in ("serial", "overlap") for x in rr[mode])
    finite = all(math.isfinite(x["loss"]) and x["skipped"] == 0
                 for rr in recs for mode in rr.values() for x in mode)
    # each rank's training peak above what it held when it began (rank 0,
    # this process, still holds what earlier phases left)
    peaks = [(rk["train"]["peak"] - rk["train"]["base"]) / 2 ** 30
             for rk in ranks]
    held = [rk["train"]["base"] / 2 ** 30 for rk in ranks]
    peak_ok = sum(peaks) < RANKS_PEAK_GIB

    def med(v):
        v = sorted(v)
        return v[len(v) // 2]

    res = dict(ranks=RANKS, layers=RANKS_LAYERS, batch=RANKS_BATCH,
               seq=RANKS_SEQ, backend=backend[0], backend_rule=backend[1],
               gpu=smi, wall_s=wall, one_card_s=one_s, planned=plan,
               kernels=kern, modes={})
    for mode in ("serial", "overlap"):
        st = recs[0][mode]
        res["modes"][mode] = dict(
            step_ms=[x["dt"] * 1e3 for x in st],
            step_ms_median=med([x["dt"] * 1e3 for x in st[1:]]),
            one_card_step_ms=[x["dt"] * 1e3 for x in one_recs[mode]],
            exchange_ms=[x["exchange_s"] * 1e3 for x in st],
            exchange_bytes=st[-1]["exchange_bytes"],
            exchange_calls=st[-1]["exchange_calls"],
            losses=[x["loss"] for x in st],
            launches=st[-1]["launches"],
            launches_total={k_: sum(x["launches"][k_] for x in st)
                            for k_ in st[-1]["launches"]})
        m = res["modes"][mode]
        log(f"ranks {mode} on {smi}, {RANKS} ranks on one card over "
            f"{backend[0]} ({backend[1]}; the pairs through CUDA IPC slots)"
            f": qwen3-1.7b {RANKS_LAYERS} layers, {RANKS_BATCH} x "
            f"{RANKS_SEQ} rows every rank: step {m['step_ms_median']:.1f} ms"
            f" (median after the first; one card, one process: "
            f"{[round(v, 1) for v in m['one_card_step_ms']]}), exchange "
            f"{[round(v, 1) for v in m['exchange_ms']]} ms wall a step, "
            f"{m['exchange_bytes'] / 1e6:.1f} MB sent a rank a step in "
            f"{m['exchange_calls']} collectives, losses "
            f"{[round(v, 4) for v in m['losses']]}, launches a rank "
            f"{m['launches']} (planned {plan[mode]})")
    res.update(replicated=repl, serial_one_card=serial_one,
               overlap_loss=overlap_loss, overlap_gx=overlap_gx,
               overlap_spm_grad_rel_err=worst, rel_tol=rel,
               param_diffs=diffs,
               params_ok=params_ok, launches_ok=launches_ok, finite=finite,
               peak_gib=peaks, held_before_gib=held, peak_ok=peak_ok)
    ok = (kern_ok and repl and serial_one and overlap_loss and overlap_gx
          and worst <= rel and params_ok and launches_ok and finite
          and peak_ok)
    log(f"ranks checks: (a) kernels {kern_ok}; (b) replicated {repl}, "
        f"step-serial bit for bit the one-card steps {serial_one}, overlap "
        f"loss {overlap_loss} and g_x grads {overlap_gx} bit for bit, SPM "
        f"grads rel err {worst:.2e}, params diff/update "
        f"{[f'{d / u:.2e}' for d, u in diffs]} (tol {rel:.2e}), launches "
        f"{launches_ok}, "
        f"finite {finite}; peaks "
        + ", ".join(f"rank {r} {g:.2f} GiB" for r, g in enumerate(peaks))
        + f", sum {sum(peaks):.2f} GiB (< {RANKS_PEAK_GIB}; held before "
        f"{[round(v, 2) for v in held]} GiB); one-card side "
        f"{one_s:.1f} s, spawn {wall:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("ranks")
    return res, failures


# ---------------------------------------------------------------------------
# phase 27: the abstract specs against what the card holds
# ---------------------------------------------------------------------------

SPECS_BUDGET_S = 10     # phase 27's seconds, at most


def tensor_signature(tree) -> list:
    """``[path, shape, dtype]`` of every tensor of ``tree`` in the
    reference's flatten order (``train.state.tree_leaves_with_path``)."""
    from repro_torch.train.state import tree_leaves_with_path
    return [[".".join(str(p) for p in path), list(t.shape), str(t.dtype)]
            for path, t in tree_leaves_with_path(tree)]


def param_signature(params) -> dict:
    """``{name: (shape, dtype, numel)}`` of a parameter tree."""
    return {k: (list(p.shape), str(p.dtype), p.numel())
            for k, p in params.named_parameters()}


def run_specs_phase(cfg, train, serve):
    """``launch/specs``'s stand-ins of ``cfg`` on ``meta`` against what the
    card held: ``abstract_params`` leaf for leaf (names, shapes, dtypes)
    against phase 6's trained params, ``model_param_count`` against the
    sum of their ``numel``, ``abstract_cache`` at phase 3's batch and
    length against the cache the engine's prefill made there."""
    import torch
    from repro_torch.launch.specs import abstract_cache, abstract_params
    from repro_torch.models.transformer import model_param_count
    params = abstract_params(cfg)
    on_meta = all(p.device.type == "meta" for p in params.parameters())
    held = train["param_signature"]
    spec = {k: v[:2] for k, v in param_signature(params).items()}
    params_ok = bool(held) and spec == {k: v[:2] for k, v in held.items()}
    count = model_param_count(params)
    count_ok = count == sum(v[2] for v in held.values())
    cache = abstract_cache(cfg, serve["batch"], serve["max_len"],
                           dtype=torch.bfloat16)
    cache_ok = tensor_signature(cache) == serve["cache_signature"]
    ok = on_meta and params_ok and count_ok and cache_ok
    res = dict(leaves=len(spec), param_count=count, params_ok=params_ok,
               count_ok=count_ok, cache_leaves=len(serve["cache_signature"]),
               cache_ok=cache_ok, on_meta=on_meta)
    log(f"specs: abstract_params {len(spec)} leaves on meta={on_meta} "
        f"against the trained params {params_ok}, model_param_count "
        f"{count} {count_ok}, abstract_cache ({serve['batch']} x "
        f"{serve['max_len']}, {res['cache_leaves']} leaves) against the "
        f"engine's {cache_ok} {'ok' if ok else 'FAIL'}")
    return res, ok


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
                                   LM, train_mod, adamw, cut_depth(cfg))
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
        cut_depth(qcfg))
    q8_serve, q8_serve_ok = phase("11", run_q8_serve_phase, torch, K, ops,
                                  T, LM, ServeEngine,
                                  cut_depth(qcfg, n=Q8_SERVE_LAYERS))
    win_rows, win_failures = phase("12", run_window_kernel_phase, torch, K,
                                   timer, with_feature_sharding(cfg, SHARDS))
    kernel_rows += win_rows
    failures += win_failures
    sharded, sharded_ok = phase(
        "13", run_sharded_phase, torch, K, T, LM, train_mod, adamw,
        ServeEngine, launch_train, cfg, dict(train, label="unsharded"))
    sparity, sparity_ok, sharded_cpu = phase(
        "14", run_train_parity_phase, torch, T, LM, train_mod, adamw,
        cut_depth(cfg), shards=SHARDS)
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
        "18", run_train_parity_phase, torch, T, LM, train_mod, adamw,
        cut_depth(cfg), shards=SHARDS, overlap=True, cpu_side=sharded_cpu)
    del sharded_cpu
    paper, paper_failures = phase("19 paper", run_paper_phase, torch, K,
                                  timer)
    failures += paper_failures
    if phase_s["19 paper"] > PAPER_BUDGET_S:
        failures.append(f"phase 19 took {phase_s['19 paper']:.1f} s of "
                        f"its {PAPER_BUDGET_S} s")
    cont, cont_failures = phase("20", run_continuous_phase, torch, K, ops,
                                T, LM, cut_depth(cfg, n=CB_LAYERS), timer)
    kernel_rows += cont["kernels"]
    failures += cont_failures
    chaos, chaos_failures = phase("21", run_chaos_phase, torch, K, ops,
                                  launch_train, cfg, smi)
    failures += chaos_failures
    archs, split_rows, arch_failures = phase(
        "22", run_archs_phase, torch, K, ops, T, LM, ServeEngine,
        launch_train, train_mod, adamw, timer)
    kernel_rows += split_rows
    failures += arch_failures
    if phase_s["22"] > ARCH_BUDGET_S:
        failures.append(f"phase 22 took {phase_s['22']:.1f} s of its "
                        f"{ARCH_BUDGET_S} s")
    slice_out, slice_rows, slice_failures = phase(
        "23", run_slice_phase, torch, K, ops, T, LM, ServeEngine,
        launch_train, timer)
    kernel_rows += slice_rows
    failures += slice_failures
    if phase_s["23"] > SLICE_BUDGET_S:
        failures.append(f"phase 23 took {phase_s['23']:.1f} s of its "
                        f"{SLICE_BUDGET_S} s")
    modes, modes_rows, modes_failures = phase(
        "24", run_modes_phase, torch, K, ops, Q, T, LM, ServeEngine,
        train_mod, adamw, launch_train, timer)
    kernel_rows += modes_rows
    failures += modes_failures
    if phase_s["24"] > MODES_BUDGET_S:
        failures.append(f"phase 24 took {phase_s['24']:.1f} s of its "
                        f"{MODES_BUDGET_S} s")
    pod, pod_failures = phase("25", run_pod_phase, torch, K, ops, cfg, smi)
    failures += pod_failures
    if phase_s["25"] > POD_BUDGET_S:
        failures.append(f"phase 25 took {phase_s['25']:.1f} s of its "
                        f"{POD_BUDGET_S} s")
    ranks_out, ranks_failures = phase("26", run_ranks_phase, torch, K, cfg,
                                      smi)
    failures += ranks_failures
    if phase_s["26"] > RANKS_BUDGET_S:
        failures.append(f"phase 26 took {phase_s['26']:.1f} s of its "
                        f"{RANKS_BUDGET_S} s")
    specs, specs_ok = phase("27", run_specs_phase, cfg, train, serve)
    if not specs_ok:
        failures.append("abstract specs")
    if phase_s["27"] > SPECS_BUDGET_S:
        failures.append(f"phase 27 took {phase_s['27']:.1f} s of its "
                        f"{SPECS_BUDGET_S} s")

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
    # K2's split mode: launches from phase 22's training steps (all five
    # archs), times at gemma3-12b's 15360 tile at 2048 rows
    k2s = head("K2 split", "gemma3-12b gate", "bfloat16", 2048)
    entries.append(dict(
        name="K2 split spm_stack_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/spm_stack_bwd.cu",
        replaces="src/repro/kernels/spm_stack.py:523",
        launches=sum(t["launches"]["K2 split"]
                     for t in archs["train"].values()),
        max_abs_err=max(x["max_abs_err"] for x in kernel_rows
                        if x["kernel"] == "K2 split"),
        ms=k2s["ms"], plain_ms=k2s["plain_ms"], bound_ms=k2s["bound_ms"],
        bound_by=k2s["bound_by"], library_ms=k2s["library_ms"]))
    # K1's and K2's expert mode: launches from phase 23's serve runs (K1)
    # and training steps (K2) of the two MoE archs; times at qwen3-moe's
    # gate/up experts at a training step's rows a expert
    from repro_torch.layers.moe import route_groups
    moe = get_config("qwen3-moe-30b-a3b")
    _, G, cap = route_groups(moe.moe_cfg(), SLICE_TRAIN[0] * SLICE_TRAIN[1])
    for name, key, src, by in (
            ("K1 expert spm_stack_fwd", "K1 expert",
             "src/repro_torch/kernels/csrc/spm_stack.cu", "serve"),
            ("K2 expert spm_stack_bwd", "K2 expert",
             "src/repro_torch/kernels/csrc/spm_stack_bwd.cu", "train")):
        r = head(key, "qwen3-moe-30b-a3b gate/up", "bfloat16", G * cap)
        entries.append(dict(
            name=name, route="cuda", source=src,
            replaces="src/repro/kernels/spm_stack.py:"
                     + ("157" if key == "K1 expert" else "523"),
            launches=sum(v["launches"][key]
                         for v in slice_out[by].values()),
            train_launches=sum(v["launches"][key]
                               for v in slice_out["train"].values()),
            max_abs_err=max(x["max_abs_err"] for x in kernel_rows
                            if x["kernel"] == key),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    # the new expert modes of phase 24: launches from its runs (the int8
    # ones from the --quantize steps and the quantized serve, the windowed
    # ones from the step-serial sharded steps, K5/K6 from the int8 overlap
    # steps); times at qwen3-moe's training rows a expert
    _, G, cap = route_groups(moe.moe_cfg(), MODES_TRAIN[0] * MODES_TRAIN[1])
    runs24 = {"int8": ("int8 train", "int8 serve"),
              "col_base": ("sharded train",),
              "pair": ("int8 overlap train",)}
    for name, key, src, rep_, kind, case in (
            ("K1 expert int8 spm_stack_fwd", "K1 expert int8",
             "src/repro_torch/kernels/csrc/spm_stack.cu", "157", "int8",
             f"{MODES_ARCH} gate/up"),
            ("K2 expert int8 spm_stack_bwd", "K2 expert int8",
             "src/repro_torch/kernels/csrc/spm_stack_bwd.cu", "523", "int8",
             f"{MODES_ARCH} gate/up"),
            ("K1 expert col_base spm_stack_fwd", "K1 expert col_base",
             "src/repro_torch/kernels/csrc/spm_stack.cu", "393", "col_base",
             f"{MODES_ARCH} down shard 0"),
            ("K2 expert col_base spm_stack_bwd", "K2 expert col_base",
             "src/repro_torch/kernels/csrc/spm_stack_bwd.cu", "664",
             "col_base", f"{MODES_ARCH} down shard 0"),
            ("K5 expert spm_overlap_fwd", "K5 expert",
             "src/repro_torch/kernels/csrc/spm_overlap.cu", "1319", "pair",
             f"{MODES_ARCH} gate/up int8 table"),
            ("K6 expert spm_overlap_bwd", "K6 expert",
             "src/repro_torch/kernels/csrc/spm_overlap_bwd.cu", "1479",
             "pair", f"{MODES_ARCH} gate/up int8 table")):
        r = head(key, case, "bfloat16", G * cap)
        entries.append(dict(
            name=name, route="cuda", source=src,
            replaces=f"src/repro/kernels/spm_stack.py:{rep_}",
            launches=sum(modes[run]["launches"][key]
                         for run in runs24[kind]),
            max_abs_err=max(x["max_abs_err"] for x in kernel_rows
                            if x["kernel"] == key),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    # K5's and K6's rank mode: launches from phase 26's overlap steps (rank
    # 0's, each rank's are the same), times at q/k/v/o's pair (k = 1) on
    # rank 0 of 4, the four ranks sharing the card
    r26 = next(r for r in ranks_out["kernels"]
               if r["case"] == "qkvo k=1" and r["rank"] == 0)
    for name, key, src, rep_ in (
            ("K5 rank spm_overlap_fwd", "k5",
             "src/repro_torch/kernels/csrc/spm_overlap.cu", "1319"),
            ("K6 rank spm_overlap_bwd", "k6",
             "src/repro_torch/kernels/csrc/spm_overlap_bwd.cu", "1479")):
        err = "k5_err" if key == "k5" else "gx_err"
        entries.append(dict(
            name=name, route="cuda", source=src,
            replaces=f"src/repro/kernels/spm_stack.py:{rep_}",
            launches=ranks_out["modes"]["overlap"]["launches_total"][
                "K5 rank" if key == "k5" else "K6 rank"],
            max_abs_err=max(r[err] for r in ranks_out["kernels"]),
            ms=r26[f"{key}_ms"], plain_ms=r26[f"{key}_plain_ms"],
            bound_ms=r26[f"{key}_bound_ms"],
            bound_by=r26[f"{key}_bound_by"],
            library_ms=r26[f"{key}_library_ms"]))
    # the continuous engine's launches (phase 20, the serve at the busiest
    # load; the int8 and overlap runs at their cut depth)
    busiest = cont["loads"][max(CB_LOADS)]["launches"]
    for e in entries:
        key = e["name"].rsplit(" ", 1)[0]
        if key in ("K1", "K3"):
            e["continuous_launches"] = busiest[key]
        elif key in ("K1 int8", "K5"):
            side = cont["int8" if key == "K1 int8" else "overlap"]
            e["continuous_launches"] = side["launches"][key]
    report = dict(gpu=smi, kernels=kernel_rows, ragged=ragged_rows,
                  fwd_ragged=fragged_rows,
                  serve=serve, parity=parity,
                  train=train, train_parity=tparity, int8_nonfinite=nonfinite,
                  int8_train=q8_train,
                  int8_train_parity=q8_tparity, int8_serve=q8_serve,
                  sharded=sharded, sharded_train_parity=sparity,
                  overlap=overlap, int8_overlap=q8_overlap,
                  overlap_train_parity=oparity,
                  paper=paper, continuous=cont, chaos=chaos, archs=archs,
                  moe_ssm=slice_out, moe_modes=modes, pod=pod,
                  ranks=ranks_out, specs=specs,
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
                                   "K2 col_base int8": "the same",
                                   "K2 split": "gemma3-12b's lone stage "
                                               "7680 on a 15360 tile, bf16, "
                                               "2048 rows",
                                   "K1 expert": "qwen3-moe-30b-a3b's "
                                                "gate/up experts (128, n "
                                                "2048, 11 stages, out 768), "
                                                "bf16, 160 rows a expert",
                                   "K2 expert": "the same",
                                   "K1 expert int8": "qwen3-moe-30b-a3b's "
                                                     "gate/up experts, int8 "
                                                     "activations and "
                                                     "tables, 160 rows a "
                                                     "expert",
                                   "K2 expert int8": "the same",
                                   "K1 expert col_base": "qwen3-moe-30b-a3b's "
                                                         "down experts, shard "
                                                         "0 of 4 (n_local 512"
                                                         " of in_width 768), "
                                                         "bf16, 160 rows a "
                                                         "expert",
                                   "K2 expert col_base": "the same",
                                   "K5 expert": "qwen3-moe-30b-a3b's "
                                                "gate/up experts' first pair "
                                                "over 4 shards (n_local 512,"
                                                " 9 stages, k=1), int8 "
                                                "tables, bf16, 160 rows a "
                                                "expert",
                                   "K6 expert": "the same",
                                   "K5 rank": "q/k/v/o's pair on rank 0 "
                                              "of 4 ranks sharing the card "
                                              "(n_local 512, 9 stages, "
                                              "k=1), bf16, 4096 rows in 4 "
                                              "row blocks",
                                   "K6 rank": "the same"})
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
