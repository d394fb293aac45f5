"""The training entry point on the card (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --steps 6 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 2 [--quantize]

Runs on ``cuda`` unless ``--device cpu`` is given; ``--smoke`` takes the
smoke-size config.  Weights are random, made from ``--seed``; batches are
windows of the synthetic char corpus (``data/char_corpus.py``).  Each step
is the forward, the closed-form backward through the SPM kernels and
AdamW, with the non-finite guard and the chaos port always on, as in the
reference.  ``--quantize`` trains through the int8 modes of K1 and K2
(``configs.with_quantized_io``: int8 activation I/O where a linear's runs
share one tile, int8 coefficient tables everywhere), as the reference's
flag does.  Checkpoints, the fault policy, chaos plans and pods are later
slices: their flags raise ``NotImplementedError``.

Tests and ``chip_smoke.py`` call ``train(args)``, which returns the final
state.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import (ARCH_IDS, get_config, get_smoke,
                                 with_overrides, with_quantized_io)
from repro_torch.data.char_corpus import build_corpus
from repro_torch.data.loader import DeterministicLoader
from repro_torch.device import resolve_device
from repro_torch.models import causal_lm as LM
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train import make_train_state, make_train_step

__all__ = ["make_batch_fn", "build_parser", "train", "main"]

_LATER = {
    "ckpt_dir": "checkpoints come with the substrate (ROADMAP.md §1, "
                "item 7)",
    "chaos_spec": "chaos plans come with the substrate (ROADMAP.md §1, "
                  "item 7)",
    "pod_dp": "data-parallel pods are the multi-device slice (ROADMAP.md "
              "§1, item 6)",
    "compress_pod_grads": "compressed pod grads are the multi-device slice "
                          "(ROADMAP.md §1, item 6)",
}


def make_batch_fn(cfg: T.ModelConfig, seq_len: int, corpus: np.ndarray):
    """``batch_fn(rng, global_batch)``: random corpus windows as
    ``{"tokens", "labels"}`` int64 tensors, tokens modulo the vocab."""
    n = len(corpus) - seq_len - 1

    def batch_fn(rng: np.random.Generator, global_batch: int) -> dict:
        starts = rng.integers(0, n, size=global_batch)
        idx = starts[:, None] + np.arange(seq_len + 1)[None, :]
        chunk = corpus[idx].astype(np.int64) % cfg.vocab_size
        return {"tokens": torch.from_numpy(chunk[:, :-1].copy()),
                "labels": torch.from_numpy(chunk[:, 1:].copy())}

    return batch_fn


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags that this slice reads or refuses, plus
    ``--device``; the recovery loop's flags come with the substrate."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--linear-impl", default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quantize", action="store_true",
                    help="int8 SPM modes: activation I/O where a linear's "
                         "runs share one tile, per-stage coefficient tables "
                         "(configs.with_quantized_io)")
    ap.add_argument("--pod-dp", type=int, default=0)
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--chaos-spec", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap


def train(args: argparse.Namespace,
          poison: Optional[Callable[[int], float]] = None,
          on_step: Optional[Callable] = None) -> dict:
    """Train as ``args`` says and return the final state.  ``poison(s)``
    is the chaos port's value at step s (nonzero poisons that step's
    grads; the reference takes it from a chaos plan).  ``on_step(s, state,
    metrics, seconds)`` sees every step after it ran, with float metrics
    and the step's wall seconds (synchronized)."""
    for flag, why in _LATER.items():
        value = getattr(args, flag)
        if value > 1 if flag == "pod_dp" else bool(value):
            raise NotImplementedError(f"--{flag.replace('_', '-')}: {why}")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.linear_impl:
        cfg = with_overrides(cfg, linear_impl=args.linear_impl)
    if args.quantize:
        cfg = with_quantized_io(cfg)
    print(f"arch={cfg.name} impl={cfg.linear_impl} quantize={args.quantize} "
          f"steps={args.steps} "
          f"B={args.batch} T={args.seq} device={device}")
    corpus = build_corpus(200_000, seed=args.seed)
    loader = DeterministicLoader(make_batch_fn(cfg, args.seq, corpus),
                                 args.batch, seed=args.seed)
    opt_cfg = OptimizerConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(args.steps // 20, 1))
    step_fn = make_train_step(lambda p, b: LM.lm_loss(p, b, cfg), opt_cfg,
                              accum_steps=args.accum, chaos_guard=True)
    params = T.init_model(cfg, seed=args.seed, device=device)
    state = make_train_state(params)
    print(f"params: {sum(p.numel() for p in params.parameters()):,}")
    t0 = time.perf_counter()
    skips = 0
    for s in range(args.steps):
        batch = {k: v.to(device) for k, v in loader.batch_at(s).items()}
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch,
                                 poison(s) if poison is not None else 0.0)
        metrics = LM.train_metrics(metrics)       # syncs the device
        dt = time.perf_counter() - t_step
        skips += int(metrics["skipped"])
        if on_step is not None:
            on_step(s, state, metrics, dt)
        if (s + 1) % args.log_every == 0:
            print(f"step {s + 1:5d} loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f} "
                  f"lr={metrics['lr']:.2e} {dt * 1e3:.0f} ms/step")
    print(f"done in {time.perf_counter() - t0:.1f}s (skips={skips})")
    return state


def main() -> None:
    """Parse the command line and train."""
    train(build_parser().parse_args())


if __name__ == "__main__":
    main()
