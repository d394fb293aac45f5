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
(``configs.with_quantized_io``), the MoE archs' experts through their
expert mode, per expert as under the reference's ``jax.vmap``.
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
reference's clock starts after the sleep).

``--pod-dp N`` (N > 1) trains data-parallel over N ranks, one
``torch.distributed`` rank a pod member (``launch/mesh.py``): this process
is rank 0 and starts the others (or, under ``torchrun``, each process is
its own rank); ``--compress-pod-grads`` reduces the grads through the int8
error-feedback all-reduce (``optim/compression.py``), alone it changes
nothing, as in the reference.  Every rank makes the params from
``--seed`` (their digests are compared before the first step), builds
each step's global batch from (seed, step) and takes its own rows
(``parallel/sharding.member_rows``), and follows the same chaos plan:
``nan@`` poisons every rank after the reduction, ``slow@`` sleeps every
rank, ``preempt@`` raises on every rank and each rank's recovery loop
restores; ``corrupt@`` touches the files on rank 0 only.  Any other
exception on a rank ends the pod (``launch/mesh.py``): its peers may be
waiting in a collective, so no rank restarts alone.  Rank 0 alone writes
the checkpoints (with every rank's residual row) and the event log.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 4 --batch 4 --seq 16 --pod-dp 2 --compress-pod-grads

Tests and ``chip_smoke.py`` call ``train(args)``, which returns the final
state (rank 0's under a pod, where the others' are bitwise equal but for
the residual rows).
"""

from __future__ import annotations

import argparse
import functools
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, get_config, get_smoke,
                                 with_compressed_pod_grads, with_overrides,
                                 with_quantized_io)
from repro_torch.data.char_corpus import build_corpus
from repro_torch.data.loader import DeterministicLoader
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_pod_mesh, run_ranks
from repro_torch.models import causal_lm as LM
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.parallel.sharding import member_rows
from repro_torch.train import (RESUME_LATEST, FaultEventLog, FaultPolicy,
                               StragglerDetector, latest_valid_step,
                               make_pod_train_step, make_train_state,
                               make_train_step, pod_residual,
                               restore_checkpoint, run_with_recovery,
                               save_checkpoint, state_digest)
from repro_torch.train.chaos import ChaosPreemption, ChaosSchedule

__all__ = ["make_batch_fn", "patch_grid_positions", "build_parser", "train",
           "main"]


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


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags, plus ``--device``."""
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
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quantize", action="store_true",
                    help="int8 SPM modes: activation I/O where a linear's "
                         "runs share one tile, per-stage coefficient tables "
                         "(configs.with_quantized_io)")
    ap.add_argument("--pod-dp", type=int, default=0,
                    help="data-parallel pod size: >1 trains over that many "
                         "torch.distributed ranks (batch must divide by "
                         "it)")
    ap.add_argument("--compress-pod-grads", action="store_true",
                    help="with --pod-dp: reduce the grads through the int8 "
                         "error-feedback all-reduce instead of a plain mean "
                         "(optim/compression.py)")
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
          timings: Optional[list] = None,
          cfg: Optional[T.ModelConfig] = None,
          on_reduce: Optional[Callable] = None,
          records: Optional[list] = None) -> dict:
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
    save, verify and restore's wall times (``train/checkpoint.py``).
    ``cfg``, when given, is trained in place of ``args.arch``'s registered
    config (a registered arch cut in depth); ``--linear-impl`` and
    ``--quantize`` still apply to it.

    Under ``--pod-dp``, ``on_step`` and ``on_reduce`` (``train/step.py``)
    run on every rank, in the rank's process, so they must pickle; what
    they return (when not None) is appended to ``records[rank]``, the one
    thing besides rank 0's state that crosses back.  ``event_log`` and
    ``timings`` are rank 0's; the other ranks log in memory."""
    n_pod = max(args.pod_dp, 0)
    if cfg is None:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.linear_impl:
        cfg = with_overrides(cfg, linear_impl=args.linear_impl)
    if args.quantize:
        cfg = with_quantized_io(cfg)
    if args.compress_pod_grads:
        cfg = with_compressed_pod_grads(cfg)
    if n_pod > 1 and args.batch % n_pod:
        raise ValueError(f"--batch {args.batch} must divide by --pod-dp "
                         f"{n_pod}")
    device = resolve_device(args.device)
    print(f"arch={cfg.name} impl={cfg.linear_impl} quantize={args.quantize} "
          f"steps={args.steps} B={args.batch} T={args.seq} device={device}"
          + (f" pod={n_pod}"
             f"{' (compressed grads)' if cfg.compress_pod_grads else ''}"
             if n_pod > 1 else ""))
    if event_log is None:
        path = args.event_log or (os.path.join(args.ckpt_dir,
                                               "events.jsonl")
                                  if args.ckpt_dir else None)
        rank = (dist.get_rank() if dist.is_initialized()
                else int(os.environ.get("RANK", "0")))
        if n_pod > 1 and rank != 0:
            path = None                  # rank 0 writes the file
        event_log = FaultEventLog(path)
    if chaos is None and args.chaos_spec:
        chaos = ChaosSchedule.parse(args.chaos_spec, seed=args.chaos_seed)
    hooks = (args, cfg, chaos, on_step, on_reduce)
    if n_pod <= 1:
        state, recs = _member(None, *hooks, event_log=event_log,
                              timings=timings)
        out = [(state, recs)]
    elif dist.is_initialized() or "WORLD_SIZE" in os.environ:
        mesh = make_pod_mesh(n_pod, args.device)
        try:
            out = [_member(mesh, *hooks, event_log=event_log,
                           timings=timings)]
        finally:
            mesh.close()
    else:
        if device.type == "cuda":
            # built here, once, before any rank starts
            from repro_torch.kernels import build
            build.load_all()
        out = run_ranks(n_pod, _spawned_member, hooks, device=device.type,
                        local=dict(event_log=event_log, timings=timings),
                        threads=(max(1, torch.get_num_threads() // n_pod)
                                 if device.type == "cpu" else None))
    if records is not None:
        records.extend(recs for _, recs in out)
    return out[0][0]


def _spawned_member(mesh, *hooks, **local):
    """``_member`` on a rank that ``run_ranks`` started: only rank 0's
    state stays (in the caller's process); the others send their records
    alone."""
    state, recs = _member(mesh, *hooks, **local)
    return (state if mesh.rank == 0 else None), recs


def _member(mesh, args: argparse.Namespace, cfg: T.ModelConfig,
            chaos: Optional[ChaosSchedule], on_step: Optional[Callable],
            on_reduce: Optional[Callable],
            event_log: Optional[FaultEventLog] = None,
            timings: Optional[list] = None):
    """One process's training run: the whole job, or one pod rank's
    (``mesh``).  Returns ``(state, records)``."""
    rank = mesh.rank if mesh is not None else 0
    root = rank == 0
    device = mesh.device if mesh is not None else resolve_device(
        args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    if event_log is None:
        event_log = FaultEventLog()
    say = print if root else (lambda *a, **k: None)
    recs: list = []
    corpus = _corpus(args.seed)

    def fresh_loader() -> DeterministicLoader:
        return DeterministicLoader(
            make_batch_fn(cfg, args.seq, corpus, args.patch_grid),
            args.batch, seed=args.seed)

    opt_cfg = OptimizerConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(args.steps // 20, 1))
    loss_fn = lambda p, b: LM.lm_loss(p, b, cfg)     # noqa: E731
    compress = mesh is not None and cfg.compress_pod_grads

    def reduce_hook(*seen):
        rec = on_reduce(*seen)
        if rec is not None:
            recs.append(rec)

    if mesh is not None:
        step_fn = make_pod_train_step(
            loss_fn, opt_cfg, mesh, compress=compress,
            accum_steps=args.accum, chaos_guard=True,
            on_reduce=reduce_hook if on_reduce is not None else None,
            scale_key=T.stack_key(cfg))
    else:
        step_fn = make_train_step(loss_fn, opt_cfg, accum_steps=args.accum,
                                  chaos_guard=True)

    def init_state() -> dict:
        params = T.init_model(cfg, seed=args.seed, device=device)
        say(f"params: {sum(p.numel() for p in params.parameters()):,}")
        state = make_train_state(params)
        if mesh is not None:
            digests = mesh.all_gather_object(state_digest(params))
            if len(set(digests)) > 1:
                raise RuntimeError(f"--seed {args.seed} made other params "
                                   f"on other ranks: digests {digests}")
            if compress:
                state["opt"]["ef"] = pod_residual(params, 1)
        return state

    def try_restore(state: dict, loader: DeterministicLoader,
                    required: bool):
        """Restore the newest valid checkpoint into ``state`` (a fresh
        one), or start fresh.  Returns (state, start step, loader).
        ``required`` marks a rollback or restart, where finding nothing is
        an event."""
        verified: dict = {}
        step = (latest_valid_step(args.ckpt_dir, event_log=event_log,
                                  timings=timings, mesh=mesh, keep=verified)
                if args.ckpt_dir else None)
        if step is None:
            if required:
                say("!! no valid checkpoint to resume from; "
                    "restarting from scratch")
                event_log.emit("resume_fallback_fresh")
            return state, 0, loader
        # the arrays that verified are the ones copied (read once)
        state, extra = restore_checkpoint(
            args.ckpt_dir, state, step=step, verified=verified,
            event_log=event_log, timings=timings, mesh=mesh)
        # the LR schedule follows the restored opt["count"]; the loop
        # counter and the data cursor rewind here
        if not loader.resume(extra.get("cursor")):
            event_log.emit("cursor_missing", step=step)
        start = int(extra.get("cursor", {}).get("step", step))
        say(f"resumed from step {start}")
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
            batch = loader.batch_at(s)
            if mesh is not None:
                batch = member_rows(batch, mesh)
            batch = {k: v.to(device) for k, v in batch.items()}
            t_step = time.perf_counter()
            if chaos is not None:
                chaos.pre_step(s)
            poison = chaos.poison(s) if chaos is not None else 0.0
            state, metrics = step_fn(state, batch, poison)
            metrics = LM.train_metrics(metrics)       # syncs the device
            dt = time.perf_counter() - t_step
            straggler.observe(s, dt)
            if on_step is not None:
                rec = on_step(s, state, metrics, dt)
                if rec is not None:
                    recs.append(rec)
            if metrics["skipped"]:
                event_log.emit("skip", step=s, cause="non-finite grads")
            if policy.on_metrics(metrics):
                say("!! rollback: too many consecutive skipped steps")
                event_log.emit("rollback", step=s,
                               cause=f"{policy.consecutive_skips} "
                                     "consecutive skips")
                state, s, loader = try_restore(init_state(), fresh_loader(),
                                               required=True)
                policy.reset()
                continue
            s += 1
            if s % args.log_every == 0:
                say(f"step {s:5d} loss={metrics['loss']:.4f} "
                    f"aux={metrics['aux']:.4f} "
                    f"gnorm={metrics['grad_norm']:.3f} "
                    f"lr={metrics['lr']:.2e} {dt * 1e3:.0f} ms/step")
            if args.ckpt_dir and s % args.ckpt_every == 0:
                save_checkpoint(args.ckpt_dir, s, state,
                                extra={"cursor": {"seed": args.seed,
                                                  "step": s}},
                                timings=timings, mesh=mesh)
            if chaos is not None:
                chaos.post_step(s - 1, args.ckpt_dir or None,
                                event_log=event_log, files=root)
        say(f"done in {time.perf_counter() - t0:.1f}s from step {start} "
            f"(skips={policy.total_skips})")
        return state

    # a pod restarts only on what every rank raises at the same point (the
    # chaos plan's preemption, after the step's collectives); any other
    # fault ends the pod, since its peers may wait in a collective
    state = run_with_recovery(loop, max_restarts=args.max_restarts,
                              backoff_base=args.backoff_base,
                              event_log=event_log,
                              restart_on=((ChaosPreemption,) if mesh
                                          else (Exception,)))
    return state, recs


def main() -> None:
    """Parse the command line and train."""
    train(build_parser().parse_args())


if __name__ == "__main__":
    main()
