"""Where a decode step of the PyTorch port's serving spends its time.

    python benchmarks/torch_serve_profile.py [--root DIR] [--out FILE]

Serves full-width ``qwen3-1.7b`` (weights from seed 0) on one GPU through
``ServeEngine.generate`` as ``chip_smoke.py``'s serve phase does (batch 8,
prompt 512, bf16 KV cache): one warm-up generate, then the 63 decode steps
of a 64-token generate timed on the host (the prefill's time, from a
1-token generate, taken off), then the same generate under
``torch.profiler`` tracing the device alone.  Prints the card's name and
power limit, the host's ms a decode step, the device's busy ms a decode
step (the union of kernel intervals in the traced decode window) and its
idle share against the untraced step, and the device ms a step by kernel
group (``launch.profile_train``'s groups), and the wall time of one
fused q projection (K3, 8 rows) among 500 issued back to back, host and
device overlapped, as one JSON object.  ``--root``
profiles the checkout at DIR (its ``src/``), so one command can profile a
parent commit beside this one.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def k3_call_us(torch, K, calls=500):
    """Wall microseconds a fused q projection at decode rows (8 x 2048, bf16,
    11 stages, the norm) takes among ``calls`` issued back to back."""
    n = 2048
    g = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(coeffs1=torch.randn(11, n // 2, 4, generator=g, device="cuda"),
              d_in1=torch.ones(n, device="cuda"),
              d_out1=torch.ones(n, device="cuda"),
              gamma=torch.ones(n, device="cuda"),
              strides1=tuple(1 << i for i in range(11)), in_width=n,
              mid_width=n, out_width=n)
    x = torch.randn(8, n, generator=g, device="cuda").bfloat16()
    for _ in range(20):
        K.spm_block_kernel_call(x, **kw)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        K.spm_block_kernel_call(x, **kw)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import spm_stack as K
    from repro_torch.launch.profile_train import busy_us, group_of
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine

    build.load_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cfg = get_config("qwen3-1.7b")
    batch, plen, new = 8, 512, 64
    params = T.init_model(cfg, seed=0, device="cuda")
    eng = ServeEngine(cfg=cfg, params=params, max_len=plen + new,
                      cache_dtype=torch.bfloat16, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (batch, plen),
                            generator=torch.Generator().manual_seed(7))
    eng.generate(prompts, max_new_tokens=new)       # warm-up

    def wall(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.generate(prompts, max_new_tokens=n)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    t1 = min(wall(1) for _ in range(2))
    tn = min(wall(new) for _ in range(2))
    step_ms = (tn - t1) / (new - 1) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
    events = sorted((ev for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda ev: ev.time_range.start)
    # the decode window: every kernel after the prefill's sample (its
    # argmax reduction)
    first_decode = next(i for i, ev in enumerate(events)
                        if "argmax" in ev.name.lower()) + 1
    dec = events[first_decode:]
    groups = {}
    for ev in dec:
        g = groups.setdefault(group_of(ev.name), [0, 0.0])
        g[0] += 1
        g[1] += ev.time_range.elapsed_us()
    per_step = (lambda us: us / (new - 1) / 1e3)       # noqa: E731
    busy_ms = per_step(busy_us([(ev.time_range.start, ev.time_range.end)
                                for ev in dec]))
    out = dict(gpu=smi, root=str(Path(args.root).resolve()), batch=batch,
               prompt_len=plen, new_tokens=new,
               decode_step_ms=step_ms,
               decode_tokens_per_s=batch / step_ms * 1e3,
               prefill_ms=t1 * 1e3,
               decode_busy_ms_per_step=busy_ms,
               decode_idle_share=1.0 - busy_ms / step_ms,
               decode_groups_ms_per_step={
                   g: per_step(us) for g, (n, us) in
                   sorted(groups.items(), key=lambda kv: -kv[1][1])},
               decode_group_launches_per_step={
                   g: n // (new - 1) for g, (n, _) in groups.items()},
               k3_decode_call_us=k3_call_us(torch, K))
    print(smi)
    print(json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
