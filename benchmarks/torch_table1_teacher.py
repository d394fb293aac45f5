"""Paper Table 1 on the PyTorch port: compositional teacher, Dense vs SPM
students (port of ``benchmarks/table1_teacher.py``).

    PYTHONPATH=src:. python benchmarks/torch_table1_teacher.py [--full] \
        [--device cpu]

Sweeps width; reports test accuracy and ms a step for both students under
one recipe (AdamW lr 3e-3 with the cosine schedule, the same batches, paper
§9.1): the step is timed (median of 5 after 2 warm-up steps, on a copy of
the fresh state), then the student trains for ``steps`` steps and is
evaluated on the batches of steps 10,000-10,004.  Quick mode: widths 128,
256 and 512, 300 steps, batch 128; ``--full``: the paper's widths 256-2048,
1200 steps, batch 256.  On the card the SPM mix runs K1 forward and K2
backward, the teacher's labels K1, and TF32 is off for every f32 product.
Prints CSV lines and writes ``out/torch_table1.json``.
"""

from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from benchmarks.torch_common import emit, setup_device, time_step, write_record
from repro_torch.configs.paper import T1_BATCH, T1_CLASSES, student_cfg
from repro_torch.data import (DeterministicLoader, TeacherConfig,
                              make_teacher, teacher_batch)
from repro_torch.models import init_mlp, mlp_loss
from repro_torch.optim import OptimizerConfig
from repro_torch.train import make_train_state, make_train_step

SEED = 0


def train_student(cfg, loader, steps: int, device) -> dict:
    """Time a step of the student ``cfg``, train it for ``steps`` steps on
    ``loader``'s batches and return its accuracy on steps 10,000-10,004 and
    its ms a step (Tables 1 and 2 share this recipe)."""
    state = make_train_state(
        init_mlp(torch.Generator().manual_seed(SEED), cfg, device))
    step = make_train_step(lambda p, b: mlp_loss(p, b, cfg),
                           OptimizerConfig(lr=3e-3, total_steps=steps))
    ms = time_step(step, copy.deepcopy(state), loader.batch_at(0)) * 1e3
    for s in range(steps):
        state, _ = step(state, loader.batch_at(s))
    accs = []
    with torch.no_grad():
        for s in range(10_000, 10_005):
            _, m = mlp_loss(state["params"], loader.batch_at(s), cfg)
            accs.append(float(m["acc"]))
    return {"acc": float(np.mean(accs)), "ms_per_step": ms}


def run_one(width: int, impl: str, steps: int, batch: int, device) -> dict:
    tc = TeacherConfig(width=width, n_classes=T1_CLASSES)
    teacher = make_teacher(tc, device)
    loader = DeterministicLoader(
        lambda rng, n: teacher_batch(teacher, tc, rng, n), batch, seed=0)
    return train_student(student_cfg(width, T1_CLASSES, impl), loader,
                         steps, device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the paper's widths and steps")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev, info = setup_device(args.device)
    widths = (256, 512, 1024, 2048) if args.full else (128, 256, 512)
    steps = 1200 if args.full else 300
    batch = T1_BATCH if args.full else 128

    print(f"# Table 1 repro: compositional teacher (hard labels) on {info}")
    print("width,dense_acc,spm_acc,delta_acc,dense_ms,spm_ms,speedup")
    rows = []
    for w in widths:
        d = run_one(w, "dense", steps, batch, dev)
        s = run_one(w, "spm_general", steps, batch, dev)
        speed = d["ms_per_step"] / max(s["ms_per_step"], 1e-9)
        print(f"{w},{d['acc']:.4f},{s['acc']:.4f},"
              f"{s['acc']-d['acc']:+.4f},{d['ms_per_step']:.3f},"
              f"{s['ms_per_step']:.3f},{speed:.2f}x")
        emit(f"table1/width{w}/dense", d["ms_per_step"] * 1e3,
             f"acc={d['acc']:.4f}")
        emit(f"table1/width{w}/spm", s["ms_per_step"] * 1e3,
             f"acc={s['acc']:.4f}")
        rows.append({"width": w, "dense": d, "spm": s, "speedup": speed})
    write_record("torch_table1.json", {
        **info, "full": args.full, "steps": steps, "batch": batch,
        "rows": rows})


if __name__ == "__main__":
    main()
