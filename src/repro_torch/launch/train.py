"""The training entry point on the card, with recovery orchestration (port
of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --steps 6 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --steps 24 --batch 8 --seq 512 --ckpt-dir /tmp/run1 --ckpt-every 6 \
      --chaos-spec 'nan@13+5;corrupt@17:bitflip;preempt@18'
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 2 [--quantize]

Runs on ``cuda`` unless ``--device cpu`` is given; ``--smoke`` takes the
smoke-size config.  Weights are random, made from ``--seed``; batches are
windows of the synthetic char corpus (``data/char_corpus.py``), a pure
function of (seed, step); an embeddings-input arch gets them hashed into
embeddings by a fixed table, with (3, B, T) M-RoPE ids under ``mrope``
(``--patch-grid``: a synthetic patch grid's).  Each step is the forward,
the closed-form backward through the SPM kernels and AdamW, with the
non-finite guard and the chaos port always on, as in the reference.
``--quantize`` trains through the int8 modes of K1 and K2
(``configs.with_quantized_io``); with an MoE arch it is refused at parsing
(the kernels' expert mode has no int8 operands yet: ``ROADMAP.md`` §1).
The logged metrics include ``aux``, the MoE load-balancing term.

Around the step, as in the reference: atomic keep-N checkpoints every
``--ckpt-every`` steps into ``--ckpt-dir`` with the data cursor in their
extra (``train/checkpoint.py``); a rollback to the newest valid checkpoint
after ``FaultPolicy``'s run of skipped steps, which rewinds the state, the
loop counter and the cursor together (the LR schedule follows the restored
``opt["count"]``); ``run_with_recovery`` restarts around the whole loop
(``--max-restarts``, ``--backoff-base``); the fault events go to
``--event-log`` (default ``<ckpt-dir>/events.jsonl``) with the schema of
``docs/fault.md``; ``--chaos-spec`` arms ``train/chaos.py``.  A step's
clock starts before the chaos plan's ``pre_step``, so a ``slow@`` event is
flagged by the straggler watchdog as ``docs/fault.md`` says (the
reference's clock starts after the sleep).  Data-parallel pods are a later
slice: their flags raise ``NotImplementedError``.

Tests and ``chip_smoke.py`` call ``train(args)``, which returns the final
state.
"""

from __future__ import annotations

import argparse
import functools
import os
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
from repro_torch.train import (RESUME_LATEST, FaultEventLog, FaultPolicy,
                               StragglerDetector, latest_valid_step,
                               make_train_state, make_train_step,
                               restore_checkpoint, run_with_recovery,
                               save_checkpoint)
from repro_torch.train.chaos import ChaosSchedule

__all__ = ["make_batch_fn", "patch_grid_positions", "build_parser", "train",
           "main"]

_LATER = {
    "pod_dp": "data-parallel pods are the multi-device slice (ROADMAP.md "
              "§1, item 6)",
    "compress_pod_grads": "compressed pod grads are the multi-device slice "
                          "(ROADMAP.md §1, item 6)",
}


@functools.lru_cache(maxsize=4)
def _corpus(seed: int) -> np.ndarray:
    """The synthetic char corpus of ``seed`` (pure, so built once; never
    written to)."""
    return build_corpus(200_000, seed=seed)


@functools.lru_cache(maxsize=2)
def _frontend_table(vocab: int, d_model: int) -> torch.Tensor:
    """The modality-frontend stub's fixed (vocab, d_model) f32 table, unit
    normal from a seeded generator (the reference draws its own from
    ``jax.random.PRNGKey(1)``); built once, never written to."""
    gen = torch.Generator().manual_seed(1)
    return torch.randn(vocab, d_model, generator=gen)


def patch_grid_positions(seq_len: int, grid: int) -> torch.Tensor:
    """(3, seq_len) M-RoPE ids of a synthetic video of ``grid`` x ``grid``
    patches a frame, in raster order: temporal ``i // grid^2``, height
    ``(i // grid) % grid``, width ``i % grid``."""
    i = torch.arange(seq_len)
    return torch.stack([i // (grid * grid), (i // grid) % grid, i % grid])


def make_batch_fn(cfg: T.ModelConfig, seq_len: int, corpus: np.ndarray,
                  patch_grid: int = 0):
    """``batch_fn(rng, global_batch)``: random corpus windows as
    ``{"tokens", "labels"}`` int64 tensors, tokens modulo the vocab.  An
    ``input_kind == "embeddings"`` config gets ``"embeds"`` in place of
    ``"tokens"``: the frontend stub hashes tokens into embeddings through
    ``_frontend_table``; under ``mrope`` it adds (3, B, T) ``"positions"``:
    the three ids equal to the token index, as the reference's, or with
    ``patch_grid`` > 0 those of ``patch_grid_positions``."""
    n = len(corpus) - seq_len - 1

    def batch_fn(rng: np.random.Generator, global_batch: int) -> dict:
        starts = rng.integers(0, n, size=global_batch)
        idx = starts[:, None] + np.arange(seq_len + 1)[None, :]
        chunk = corpus[idx].astype(np.int64) % cfg.vocab_size
        toks = torch.from_numpy(chunk[:, :-1].copy())
        batch = {"labels": torch.from_numpy(chunk[:, 1:].copy())}
        if cfg.input_kind == "tokens":
            batch["tokens"] = toks
            return batch
        batch["embeds"] = _frontend_table(cfg.vocab_size, cfg.d_model)[toks]
        if cfg.rope_kind == "mrope":
            ids = (patch_grid_positions(seq_len, patch_grid) if patch_grid
                   else torch.arange(seq_len).expand(3, seq_len))
            batch["positions"] = ids[:, None, :].expand(
                3, global_batch, seq_len).contiguous()
        return batch

    return batch_fn


class _Parser(argparse.ArgumentParser):
    """Refuses ``--quantize`` for an MoE arch when the arguments are
    parsed."""

    def parse_args(self, args=None, namespace=None):
        ns = super().parse_args(args, namespace)
        cfg = get_smoke(ns.arch) if ns.smoke else get_config(ns.arch)
        if ns.quantize and any(s.mlp == "moe" for s in cfg.layers):
            self.error(f"--quantize: {ns.arch} is an MoE arch, and the "
                       "expert mode of K1 and K2 takes no int8 operands "
                       "yet (ROADMAP.md §1)")
        return ns


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags, plus ``--device``."""
    ap = _Parser()
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
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quantize", action="store_true",
                    help="int8 SPM modes: activation I/O where a linear's "
                         "runs share one tile, per-stage coefficient tables "
                         "(configs.with_quantized_io)")
    ap.add_argument("--pod-dp", type=int, default=0)
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--chaos-spec", default="",
                    help="deterministic fault-injection plan, e.g. "
                         "'nan@13+5;corrupt@18:bitflip;preempt@19' "
                         "(see train/chaos.py)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--event-log", default="",
                    help="fault-event JSONL path (default: "
                         "<ckpt-dir>/events.jsonl when --ckpt-dir is set)")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="restart budget for run_with_recovery")
    ap.add_argument("--backoff-base", type=float, default=0.5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--patch-grid", type=int, default=0,
                    help="M-RoPE archs: position ids of a synthetic video "
                         "of this many patches a side (0: the three ids "
                         "equal, as the reference's)")
    return ap


def train(args: argparse.Namespace,
          event_log: Optional[FaultEventLog] = None,
          chaos: Optional[ChaosSchedule] = None,
          on_step: Optional[Callable] = None,
          timings: Optional[list] = None) -> dict:
    """Train as ``args`` says and return the final state.  The inner
    ``loop(resume)`` holds the steps, saves and rollbacks;
    ``run_with_recovery`` restarts it on failure.

    ``event_log`` and ``chaos`` replace the ones built from ``args`` (a
    test passes one schedule to two ``train`` calls, so that what fired
    stays fired across a simulated process death).  ``on_step(s, state,
    metrics, seconds)`` sees every step after it ran, replays included,
    with float metrics and the step's wall seconds (synchronized, from
    after the batch reached the device and before the chaos plan's
    ``pre_step``).  ``timings``, when given, receives each checkpoint
    save, verify and restore's wall times (``train/checkpoint.py``)."""
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

    if event_log is None:
        path = args.event_log or (os.path.join(args.ckpt_dir,
                                               "events.jsonl")
                                  if args.ckpt_dir else None)
        event_log = FaultEventLog(path)
    if chaos is None and args.chaos_spec:
        chaos = ChaosSchedule.parse(args.chaos_spec, seed=args.chaos_seed)

    corpus = _corpus(args.seed)

    def fresh_loader() -> DeterministicLoader:
        return DeterministicLoader(
            make_batch_fn(cfg, args.seq, corpus, args.patch_grid),
            args.batch, seed=args.seed)

    opt_cfg = OptimizerConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(args.steps // 20, 1))
    step_fn = make_train_step(lambda p, b: LM.lm_loss(p, b, cfg), opt_cfg,
                              accum_steps=args.accum, chaos_guard=True)

    def init_state() -> dict:
        params = T.init_model(cfg, seed=args.seed, device=device)
        print(f"params: {sum(p.numel() for p in params.parameters()):,}")
        return make_train_state(params)

    def try_restore(state: dict, loader: DeterministicLoader,
                    required: bool):
        """Restore the newest valid checkpoint into ``state`` (a fresh
        one), or start fresh.  Returns (state, start step, loader).
        ``required`` marks a rollback or restart, where finding nothing is
        an event."""
        step = (latest_valid_step(args.ckpt_dir, event_log=event_log,
                                  timings=timings)
                if args.ckpt_dir else None)
        if step is None:
            if required:
                print("!! no valid checkpoint to resume from; "
                      "restarting from scratch")
                event_log.emit("resume_fallback_fresh")
            return state, 0, loader
        state, extra = restore_checkpoint(
            args.ckpt_dir, state, step=step, event_log=event_log,
            timings=timings)
        # the LR schedule follows the restored opt["count"]; the loop
        # counter and the data cursor rewind here
        if not loader.resume(extra.get("cursor")):
            event_log.emit("cursor_missing", step=step)
        start = int(extra.get("cursor", {}).get("step", step))
        print(f"resumed from step {start}")
        return state, start, loader

    def loop(resume: Optional[int]) -> dict:
        """One attempt: ``None`` cold-starts (resuming when checkpoints
        exist), ``RESUME_LATEST`` restores after a failure."""
        state, s, loader = try_restore(init_state(), fresh_loader(),
                                       required=resume == RESUME_LATEST)
        start = s
        policy = FaultPolicy()
        straggler = StragglerDetector(event_log=event_log)
        t0 = time.perf_counter()
        while s < args.steps:
            batch = {k: v.to(device) for k, v in loader.batch_at(s).items()}
            t_step = time.perf_counter()
            if chaos is not None:
                chaos.pre_step(s)
            poison = chaos.poison(s) if chaos is not None else 0.0
            state, metrics = step_fn(state, batch, poison)
            metrics = LM.train_metrics(metrics)       # syncs the device
            dt = time.perf_counter() - t_step
            straggler.observe(s, dt)
            if on_step is not None:
                on_step(s, state, metrics, dt)
            if metrics["skipped"]:
                event_log.emit("skip", step=s, cause="non-finite grads")
            if policy.on_metrics(metrics):
                print("!! rollback: too many consecutive skipped steps")
                event_log.emit("rollback", step=s,
                               cause=f"{policy.consecutive_skips} "
                                     "consecutive skips")
                state, s, loader = try_restore(init_state(), fresh_loader(),
                                               required=True)
                policy.reset()
                continue
            s += 1
            if s % args.log_every == 0:
                print(f"step {s:5d} loss={metrics['loss']:.4f} "
                      f"aux={metrics['aux']:.4f} "
                      f"gnorm={metrics['grad_norm']:.3f} "
                      f"lr={metrics['lr']:.2e} {dt * 1e3:.0f} ms/step")
            if args.ckpt_dir and s % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, s, state,
                                extra={"cursor": {"seed": args.seed,
                                                  "step": s}},
                                timings=timings)
            if chaos is not None:
                chaos.post_step(s - 1, args.ckpt_dir or None,
                                event_log=event_log)
        print(f"done in {time.perf_counter() - t0:.1f}s from step {start} "
              f"(skips={policy.total_skips})")
        return state

    return run_with_recovery(loop, max_restarts=args.max_restarts,
                             backoff_base=args.backoff_base,
                             event_log=event_log)


def main() -> None:
    """Parse the command line and train."""
    train(build_parser().parse_args())


if __name__ == "__main__":
    main()
