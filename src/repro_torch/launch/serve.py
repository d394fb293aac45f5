"""Batched serving on the card (port of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --batch 8 --prompt-len 512 --new-tokens 64

``--continuous`` switches to the continuous-batching engine: the same
requests run through an admit/evict pool of ``--slots`` batch rows, one
arriving every ``--arrival-every`` ticks, and the run prints tokens/s, slot
occupancy and per-request latency in ticks.  Runs on ``cuda`` unless
``--device cpu`` is given; ``--smoke`` takes the smoke-size config.
Weights and prompts are random, made from ``--seed``.  An
embeddings-input arch (``qwen2-vl-7b``, ``musicgen-medium``) serves from a
token prompt and decodes its own codebook, as the reference does.  An SSM
arch (``mamba2-370m``, ``zamba2-1.2b``) prefills by decode replay; the
continuous engine refuses it, and ``--continuous`` reports that refusal.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke, with_overrides
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve import ContinuousBatchingEngine, Request, ServeEngine


def main() -> None:
    """Parse arguments, build the model and print the generated tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--linear-impl", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache-dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine: admit/evict the "
                         "requests through a fixed-slot decode tick")
    ap.add_argument("--slots", type=int, default=4,
                    help="batch slots (continuous mode)")
    ap.add_argument("--arrival-every", type=int, default=2,
                    help="ticks between request arrivals (continuous mode)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.linear_impl:
        cfg = with_overrides(cfg, linear_impl=args.linear_impl)
    if cfg.input_kind != "tokens":
        print(f"note: {cfg.name} is embeddings-input; serving decodes its "
              f"token codebook after a token prompt")
    params = T.init_model(cfg, seed=args.seed, device=device)
    gen = torch.Generator().manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen)
    if args.continuous:
        serve_continuous(args, cfg, params, prompts, device)
        return
    engine = ServeEngine(cfg=cfg, params=params,
                         max_len=args.prompt_len + args.new_tokens,
                         cache_dtype=getattr(torch, args.cache_dtype),
                         device=device)
    sample_gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=args.new_tokens,
                          temperature=args.temperature, generator=sample_gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.new_tokens
    print(f"generated {tuple(out.shape)} on {device} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s batch-aggregate)")
    print(out.cpu())


def serve_continuous(args, cfg, params, prompts, device) -> None:
    """Serve ``prompts`` as requests through the continuous engine and
    print the reference's summary line and each request's tokens."""
    try:
        eng = ContinuousBatchingEngine(
            cfg, params, slots=args.slots,
            max_len=args.prompt_len + args.new_tokens,
            cache_dtype=getattr(torch, args.cache_dtype),
            seed=args.seed + 2, device=device)
    except ValueError as e:
        raise SystemExit(f"--continuous: {e}")
    reqs = [Request(prompt=prompts[i], max_new_tokens=args.new_tokens,
                    temperature=args.temperature, rid=i)
            for i in range(args.batch)]
    arrivals = [i * args.arrival_every for i in range(args.batch)]
    t0 = time.perf_counter()
    results, stats = eng.serve(reqs, arrival_ticks=arrivals)
    dt = time.perf_counter() - t0
    occ = stats["occupied_slot_ticks"] / max(stats["ticks"] * args.slots, 1)
    lat = [results[r.rid]["finished_tick"] - results[r.rid]["admitted_tick"]
           for r in reqs]
    print(f"served {len(reqs)} requests / {stats['tokens']} tokens in "
          f"{stats['ticks']} ticks on {device}, {dt:.2f}s "
          f"({stats['tokens'] / dt:.1f} tok/s, occupancy {occ:.2f}, "
          f"latency {min(lat)}-{max(lat)} ticks)")
    for r in reqs:
        print(r.rid, results[r.rid]["tokens"])


if __name__ == "__main__":
    main()
