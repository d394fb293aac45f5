"""Paper Table 2 on the PyTorch port: hashed-sparse text classification, the
AG News proxy (port of ``benchmarks/table2_agnews.py``).

    PYTHONPATH=src:. python benchmarks/torch_table2_agnews.py [--full] \
        [--device cpu]

Dense vs SPM at fixed stage depth L=12, width sweep, under Table 1's recipe
(``torch_table1_teacher.train_student``).  The corpus is SIMULATED
(class-conditional hashed features, ``repro_torch/data/hashed_text.py``);
the tested claim is the paper's: at large width SPM trains several times
faster a step while matching or beating dense accuracy.  Quick mode:
widths 512 and 1024, 200 steps, batch 128; ``--full``: widths 2048 and
4096, 800 steps, batch 256.  On the card the SPM mix runs K1 forward and
K2 backward (two runs each at 4096), and TF32 is off for every f32
product.  Prints CSV lines and writes ``out/torch_table2.json``.
"""

from __future__ import annotations

import argparse

from benchmarks.torch_common import emit, setup_device, write_record
from benchmarks.torch_table1_teacher import train_student
from repro_torch.configs.paper import AGNEWS_CLASSES, AGNEWS_L, student_cfg
from repro_torch.data import DeterministicLoader
from repro_torch.data.hashed_text import HashedTextConfig, hashed_text_batch


def run_one(width: int, impl: str, steps: int, batch: int, device) -> dict:
    hc = HashedTextConfig(width=width, n_classes=AGNEWS_CLASSES)
    loader = DeterministicLoader(
        lambda rng, n: hashed_text_batch(hc, rng, n, device), batch, seed=0)
    cfg = student_cfg(width, AGNEWS_CLASSES, impl, n_stages=AGNEWS_L)
    return train_student(cfg, loader, steps, device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev, info = setup_device(args.device)
    widths = (2048, 4096) if args.full else (512, 1024)
    steps = 800 if args.full else 200
    batch = 256 if args.full else 128

    print(f"# Table 2 repro: hashed sparse text (L={AGNEWS_L}, SIMULATED) "
          f"on {info}")
    print("width,dense_acc,spm_acc,delta_acc,dense_ms,spm_ms,speedup")
    rows = []
    for w in widths:
        d = run_one(w, "dense", steps, batch, dev)
        s = run_one(w, "spm_general", steps, batch, dev)
        speed = d["ms_per_step"] / max(s["ms_per_step"], 1e-9)
        print(f"{w},{d['acc']:.4f},{s['acc']:.4f},"
              f"{s['acc']-d['acc']:+.4f},{d['ms_per_step']:.3f},"
              f"{s['ms_per_step']:.3f},{speed:.2f}x")
        emit(f"table2/width{w}/dense", d["ms_per_step"] * 1e3,
             f"acc={d['acc']:.4f}")
        emit(f"table2/width{w}/spm", s["ms_per_step"] * 1e3,
             f"acc={s['acc']:.4f}")
        rows.append({"width": w, "dense": d, "spm": s, "speedup": speed})
    write_record("torch_table2.json", {
        **info, "full": args.full, "steps": steps, "batch": batch,
        "n_stages": AGNEWS_L, "rows": rows})


if __name__ == "__main__":
    main()
