"""Where a training step of the PyTorch port spends its device time.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        [--steps 3] [--batch 8] [--seq 512] [--quantize] [--out profile.json]

Trains full-width ``qwen3-1.7b`` (weights from seed 0) on one GPU through
``repro_torch.launch.train.train``: one warm-up step, ``--steps`` steps
timed without a profiler, then ``--steps`` steps under ``torch.profiler``
tracing the device alone (no host activity, whose per-op cost would
stretch the step).  Prints the card's name and power limit, the median
step time of each window, the device's busy time a step (the union of
kernel intervals over the traced window), its idle share against the
untraced step, and the device time by kernel, grouped into the port's SPM
kernels (K1-K4, K1's int8 activation mode apart) and the rest, as one JSON
object; ``--out`` also writes it with the 40 costliest kernels.
``--quantize`` profiles the int8 step (``launch.train --quantize``).  A
kernel group the step launches (K1-K4; K1, its int8 mode and K2 under
``--quantize``) that reads no device time means a kernel's name no longer
matches ``GROUPS``: the run prints it and exits 1.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

# K1's int8 store is its int8_t instantiation: demangled or mangled
GROUPS = (("K1 int8 spm_stack_fwd", "spm_stack_fwd_kernel<signed char"),
          ("K1 int8 spm_stack_fwd", "spm_stack_fwd_kernelIa"),
          ("K1 spm_stack_fwd", "spm_stack_fwd_kernel"),
          ("K2 spm_stack_bwd", "spm_stack_bwd_kernel"),
          ("K3 spm_block_fwd", "spm_block_fwd_kernel"),
          ("K4 spm_block_bwd", "spm_block_bwd_kernel"),
          ("K5 spm_overlap_fwd", "spm_overlap_fwd_kernel"),
          ("K6 spm_overlap_bwd", "spm_overlap_bwd_kernel"),
          ("K2/K4/K6 partial sums", "spm_sum_partials"),
          ("matmul (gemm)", "gemm"), ("matmul (gemm)", "sm90_xmma"),
          ("matmul (gemm)", "cutlass"), ("softmax", "softmax"),
          ("reduce", "reduce_kernel"), ("elementwise", "elementwise"),
          ("index / scatter", "index"), ("index / scatter", "scatter"))


def group_of(name: str) -> str:
    low = name.lower()
    for label, key in GROUPS:
        if key.lower() in low:
            return label
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train as launch_train

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    S = args.steps
    targs = launch_train.build_parser().parse_args(
        ["--steps", str(1 + 2 * S), "--batch", str(args.batch),
         "--seq", str(args.seq), "--log-every", "1000"]
        + (["--quantize"] if args.quantize else []))
    prof = profile(activities=[ProfilerActivity.CUDA])
    dts = {"untraced": [], "traced": []}
    marks = {}

    def on_step(s, state, metrics, dt):
        if s > 0:                        # step 0 is the warm-up
            dts["untraced" if s <= S else "traced"].append(dt)
        if s == S:
            torch.cuda.synchronize()
            prof.__enter__()
            marks["t0"] = time.perf_counter()
        elif s == 2 * S:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            prof.__exit__(None, None, None)

    launch_train.train(targs, on_step=on_step)
    wall_us = (marks["t1"] - marks["t0"]) * 1e6
    by_kernel, intervals = {}, []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = ev.time_range.elapsed_us()
        intervals.append((ev.time_range.start, ev.time_range.end))
        k = by_kernel.setdefault(ev.name, [0, 0.0])
        k[0] += 1
        k[1] += dur
    groups = {}
    for name, (n, us) in by_kernel.items():
        g = groups.setdefault(group_of(name), [0, 0.0])
        g[0] += n
        g[1] += us
    per_step = lambda us: us / S / 1e3               # noqa: E731  ms a step
    step_ms = statistics.median(dts["untraced"]) * 1e3
    busy_ms = per_step(busy_us(intervals))
    out = dict(gpu=smi, batch=args.batch, seq=args.seq, steps=S,
               quantize=args.quantize,
               step_ms=step_ms,
               traced_step_ms=statistics.median(dts["traced"]) * 1e3,
               device_busy_ms=busy_ms,
               device_idle_share=1.0 - busy_ms / step_ms,
               traced_busy_share=busy_ms / per_step(wall_us),
               groups_ms={g: per_step(us) for g, (n, us) in
                          sorted(groups.items(), key=lambda kv: -kv[1][1])},
               group_launches_per_step={g: n // S for g, (n, _) in
                                        groups.items()})
    want = ("K1 spm_stack_fwd", "K2 spm_stack_bwd") + (
        ("K1 int8 spm_stack_fwd",) if args.quantize
        else ("K3 spm_block_fwd", "K4 spm_block_bwd"))
    out["groups_without_time"] = [g for g in want
                                  if out["groups_ms"].get(g, 0.0) <= 0.0]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:40]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(out, top_kernels=[dict(name=k, launches=n,
                                                  ms_per_step=per_step(us))
                                             for k, (n, us) in top]), f,
                      indent=1)
    for k, (n, us) in top[:20]:
        print(f"{per_step(us):9.3f} ms/step {n // S:6d}x  {k[:100]}")
    print(smi)
    print(json.dumps(out))
    if out["groups_without_time"]:
        print(f"profile_train: no device time in "
              f"{out['groups_without_time']}: GROUPS does not match their "
              f"kernels' names", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
