"""Continuous-batching serving benchmark of the PyTorch port (the torch twin
of ``benchmarks/serve_bench.py``) -> ``out/torch_serve_bench.json``.

Drives ``repro_torch.serve.ContinuousBatchingEngine`` with the same seeded
Poisson arrivals at the same offered loads (requests per decode tick) and
the same prompt lengths, and reports per load the same fields: decode
ticks, tokens, slot occupancy, nearest-rank p50/p99 latency in ticks
(arrival to final token), and wall-clock tokens/s.  The schedule numbers
depend only on the arrivals and the evict-on-count policy, never on the
weights or the sampled tokens, so at ``--smoke`` they equal
``BENCH_serve.json``'s.  In place of the reference's ``tick_compiles`` it
reports ``tick_op_sequences``: how many distinct aten operation sequences
(ops, shapes, dtypes, scalar arguments) the decode tick issued over every
load after warm-up (``--record-loads``: those loads), recorded in a second,
untimed pass (1: one tick serves all churn, ready for capture).

  PYTHONPATH=src:. python benchmarks/torch_serve_bench.py --smoke --device cpu
  python3 benchmarks/torch_serve_bench.py             # full width, on the card
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from benchmarks.torch_common import setup_device  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine, Request  # noqa: E402
from repro_torch.serve.schedule import (TickRecorder,  # noqa: E402
                                        percentile_ticks, poisson_arrivals)

DEFAULT_LOADS = (0.2, 0.5, 2.0)   # requests per decode tick
PROMPT_LENS = (5, 12, 24, 7)      # cycled per request: mixes buckets
SCHEMA = "torch_serve_bench/v1"


def make_requests(n: int, vocab: int, seed: int, max_new: int) -> list:
    gen = torch.Generator().manual_seed(seed)
    return [Request(prompt=torch.randint(0, vocab,
                                         (PROMPT_LENS[i % len(PROMPT_LENS)],),
                                         generator=gen),
                    max_new_tokens=max_new, rid=i) for i in range(n)]


def run_load(eng, load: float, n_requests: int, max_new: int, vocab: int,
             seed: int) -> dict:
    reqs = make_requests(n_requests, vocab, seed, max_new)
    arrivals = poisson_arrivals(n_requests, load, seed)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, stats = eng.serve(reqs, arrival_ticks=arrivals)
    wall = time.perf_counter() - t0
    lat = [results[i]["finished_tick"] - arrivals[i]
           for i in range(n_requests)]
    occ = stats["occupied_slot_ticks"] * 1000 \
        // max(stats["ticks"] * eng.slots, 1)
    return {"offered_load": load, "ticks": stats["ticks"],
            "tokens": stats["tokens"], "occupancy_milli": int(occ),
            "p50_latency_ticks": percentile_ticks(lat, 0.50),
            "p99_latency_ticks": percentile_ticks(lat, 0.99),
            # wall-clock: reported, the host's speed varies between runs
            "wall_s": wall, "tokens_per_s": stats["tokens"] / wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke-size config (BENCH_serve.json's scale)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loads", type=float, nargs="+",
                    default=list(DEFAULT_LOADS))
    ap.add_argument("--record-loads", type=float, nargs="+", default=None,
                    help="loads whose ticks the untimed pass records "
                         "(default: every load)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(ROOT, "out",
                                                  "torch_serve_bench.json"))
    args = ap.parse_args(argv)

    device, info = setup_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    params = T.init_model(cfg, seed=args.seed, device=device)
    eng = ContinuousBatchingEngine(cfg, params, slots=args.slots,
                                   max_len=args.max_len, seed=args.seed,
                                   device=device)
    # warm the tick and a prefill bucket on a throwaway request, so the
    # loads measure the steady state
    eng.serve([Request(prompt=torch.zeros(4, dtype=torch.long),
                       max_new_tokens=2, rid=10**9)])
    loads = [run_load(eng, load, args.requests, args.max_new,
                      cfg.vocab_size, args.seed)
             for load in sorted(args.loads)]
    rec = TickRecorder()
    timed_tick = eng._tick
    eng._tick = rec.wrap(timed_tick)
    for load in sorted(args.loads if args.record_loads is None
                       else args.record_loads):
        run_load(eng, load, args.requests, args.max_new, cfg.vocab_size,
                 args.seed)
    eng._tick = timed_tick
    payload = {"schema": SCHEMA, "arch": cfg.name, **info,
               "slots": args.slots, "requests": args.requests,
               "max_new": args.max_new, "max_len": args.max_len,
               "tick_op_sequences": rec.sequences(),
               "recorded_ticks": len(rec.ticks),
               "recorded_loads": args.record_loads or sorted(args.loads),
               "loads": loads}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")
    for row in loads:
        print(f"load={row['offered_load']:<4} ticks={row['ticks']:<4} "
              f"occ={row['occupancy_milli'] / 10:.0f}% "
              f"p50={row['p50_latency_ticks']} "
              f"p99={row['p99_latency_ticks']} "
              f"({row['tokens_per_s']:.1f} tok/s wall)")
    print(f"tick operation sequences after warm-up: {rec.sequences()} "
          f"over {len(rec.ticks)} ticks -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
