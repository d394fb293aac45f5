"""Paper Tables 3–4 on the PyTorch port: a char-level LM with one wide
projection (port of ``benchmarks/table34_charlm.py``).

    PYTHONPATH=src:. python benchmarks/torch_table34_charlm.py [--full] \
        [--steps N] [--device cpu]

The model is the paper's §9.3 setup, kept in this runner as the
reference keeps it in its own: token embedding -> ONE wide linear
projection of dimension d (dense, or SPM butterfly L=12 with the
closed-form backward) -> ReLU -> the tied head; AdamW at lr 1e-3 with no
warm-up.  The corpus is the synthesized Bard proxy
(``repro_torch/data/char_corpus.py``, SIMULATED), batches drawn with the
reference's numpy generator, so both runners see the same characters.
Quick mode: d=1024, 60 steps, B=16, T=64, a 200k-character corpus;
``--full``: d=4096, B=32, T=128, 800 steps, 1.1M characters.  On the card
the SPM projection runs K1 and K2 (two runs each at d=4096), and TF32 is
off for every f32 product.  Reports the NLL/BPC trajectory and ms a step
(the mean over the steps so far, each step synchronized) as CSV lines and
writes ``out/torch_table34.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from benchmarks.torch_common import emit, setup_device, sync, write_record
from repro_torch.configs.paper import (CHARLM_B, CHARLM_D, CHARLM_L,
                                       CHARLM_LR, CHARLM_T)
from repro_torch.core.linear import LinearConfig, init_linear, linear_apply
from repro_torch.data import build_corpus
from repro_torch.device import resolve_device
from repro_torch.optim import OptimizerConfig
from repro_torch.params import Params
from repro_torch.train import make_train_state, make_train_step

SEED = 0
VOCAB = 256


@dataclasses.dataclass(frozen=True)
class CharLMCfg:
    """The projection's width and linear, and its stage depth."""

    d: int
    impl: str
    n_stages: int = CHARLM_L

    @property
    def proj(self) -> LinearConfig:
        """The wide d x d projection."""
        return LinearConfig(d_in=self.d, d_out=self.d, impl=self.impl,
                            n_stages=self.n_stages, schedule="butterfly",
                            backward="custom")


def init_charlm(cfg: CharLMCfg, device=None) -> Params:
    """``{"embed": (VOCAB, d) 0.02 N(0, 1), "proj"}`` drawn on the CPU from
    ``SEED`` (the same weights whatever the device), then moved to
    ``device`` (``cuda`` unless the caller asks for the CPU)."""
    gen = torch.Generator().manual_seed(SEED)
    cpu = torch.device("cpu")
    embed = 0.02 * torch.randn(VOCAB, cfg.d, generator=gen)
    return Params({"embed": embed,
                   "proj": init_linear(cfg.proj, gen, cpu)}
                  ).to(resolve_device(device))


def charlm_loss(params, batch: dict, cfg: CharLMCfg):
    """Mean next-character NLL through embed -> proj -> ReLU -> tied head,
    and bits per character."""
    h = params["embed"][batch["tokens"]]
    h = torch.relu(linear_apply(params["proj"], h, cfg.proj))
    logits = h @ params["embed"].T
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    loss = nll.mean()
    return loss, {"loss": loss, "nll": loss, "bpc": loss / math.log(2.0)}


def run_one(d: int, impl: str, steps: int, eval_every: int,
            corpus: np.ndarray, batch: int, seq: int, device):
    cfg = CharLMCfg(d=d, impl=impl)
    state = make_train_state(init_charlm(cfg, device))
    step = make_train_step(
        lambda p, b: charlm_loss(p, b, cfg),
        OptimizerConfig(lr=CHARLM_LR, total_steps=steps, warmup_steps=0))
    rng = np.random.default_rng(0)
    split = int(0.9 * len(corpus))
    train_c, valid_c = corpus[:split], corpus[split:]

    def draw(c):
        starts = rng.integers(0, len(c) - seq - 1, size=batch)
        idx = starts[:, None] + np.arange(seq + 1)[None, :]
        ch = torch.from_numpy(c[idx].astype(np.int64)).to(device)
        return {"tokens": ch[:, :-1], "labels": ch[:, 1:]}

    rows, t_total = [], 0.0
    for s in range(1, steps + 1):
        b = draw(train_c)
        sync()
        t0 = time.perf_counter()
        state, m = step(state, b)
        loss = float(m["loss"])
        t_total += time.perf_counter() - t0
        if s == 1 or s % eval_every == 0:
            with torch.no_grad():
                vl = np.mean([float(charlm_loss(state["params"],
                                                draw(valid_c), cfg)[0])
                              for _ in range(3)])
            rows.append((s, loss, float(vl), float(vl / np.log(2)),
                         t_total / s * 1e3))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help=f"paper scale d={CHARLM_D}")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev, info = setup_device(args.device)
    d = CHARLM_D if args.full else 1024
    steps = args.steps or (800 if args.full else 60)
    eval_every = max(steps // 5, 1)
    batch, seq = (CHARLM_B, CHARLM_T) if args.full else (16, 64)
    corpus = build_corpus(1_100_000 if args.full else 200_000)

    print(f"# Tables 3-4 repro: char-LM d={d} L={CHARLM_L} (SIMULATED "
          f"corpus) on {info}")
    record = {**info, "full": args.full, "d": d, "steps": steps,
              "batch": batch, "seq": seq, "runs": {}}
    for impl in ("dense", "spm_general"):
        rows = run_one(d, impl, steps, eval_every, corpus, batch, seq, dev)
        print(f"## {impl}")
        print("step,train_nll,valid_nll,valid_bpc,ms_per_step")
        for r in rows:
            print(f"{r[0]},{r[1]:.3f},{r[2]:.3f},{r[3]:.3f},{r[4]:.1f}")
        emit(f"table34/{impl}/d{d}", rows[-1][4] * 1e3,
             f"valid_bpc={rows[-1][3]:.3f}")
        record["runs"][impl] = [dict(zip(("step", "train_nll", "valid_nll",
                                          "valid_bpc", "ms_per_step"), r))
                                for r in rows]
    write_record("torch_table34.json", record)


if __name__ == "__main__":
    main()
