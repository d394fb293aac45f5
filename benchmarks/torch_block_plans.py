"""K4's launch shapes against each other on the card: where the block's
tables go.

    python benchmarks/torch_block_plans.py [--out FILE]

K4 (``csrc/spm_block_bwd.cu``) keeps each stack's table and pair-grad sums
on chip for a row group's range.  The two-stack block at full width (2048
lanes, 11 + 11 stages) holds both only when its lanes split over 8 blocks;
the alternative is fewer blocks with one or both stacks' tables streamed
from a device-memory slab (the plan's ``streamed``).  This times the
two-stack block (relu, the residual, mid width 1536, bf16, 256 and 4096
rows) and the q form (one stack, 4096 rows) under the planner's shape and
under each forced alternative, in one process, CUDA events around 30
launches each with the L2 flushed (``chip_smoke.Timer``), and prints the
card's name and power limit beside them as one JSON object.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_block_plans: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import spm_stack as K

    build.load_all()
    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    n = 2048
    qkv = tuple(1 << i for i in range(11))

    def vec():
        return 1 + 0.1 * torch.randn(n, generator=g, device="cuda")

    def table():
        th = (torch.rand(11, n // 2, generator=g, device="cuda") * 2 - 1) \
            * math.pi
        return torch.stack([th.cos(), -th.sin(), th.sin(), th.cos()], -1)

    planner = K.bwd_plan
    out = []
    for label, rows, two in (("two-stack", 256, True),
                             ("two-stack", 4096, True),
                             ("q", 4096, False)):
        kw = dict(coeffs1=table(), d_in1=vec(), d_out1=vec(),
                  bias1=0.1 * vec(), gamma=vec(), strides1=qkv,
                  in_width=n, out_width=n, mid_width=n)
        if two:
            kw.update(coeffs2=table(), d_in2=vec(), d_out2=vec(),
                      bias2=0.1 * vec(), strides2=qkv, activation="relu",
                      residual=True, mid_width=1536)
        x = torch.randn(rows, n, generator=g, device="cuda").bfloat16()
        gy = torch.randn(rows, n, generator=g, device="cuda").bfloat16()
        _, rstd = K.spm_block_kernel_call(x, **kw)
        base = planner(rows, n, qkv, 1, 2, block=True,
                       strides2=qkv if two else None, norm=True)
        shapes = [("planner", base)]
        for C, streamed in ((8, 0), (8, 1), (4, 1), (4, 2), (2, 2)) if two \
                else ((8, 0), (2, 0)):
            if (C, streamed) == (base.lane_blocks, base.streamed):
                continue
            w = n // C
            rs = K.bwd_row_slices(w // 2)
            R = 0
            while K.bwd_block_smem_bytes(n, C, R + 1, qkv,
                                         qkv if two else None, 2, True,
                                         streamed) <= K.SMEM_BYTES \
                    and R < rows:
                R += 1
            if R == 0:
                continue
            G = min(-(-rows // R), K.CLUSTERS_RESIDENT[C])
            shapes.append((f"C{C} streamed {streamed}", base._replace(
                lane_blocks=C, lanes=w, pair_slots=w // 2, row_slices=rs,
                threads=w // 2 * rs, chunk_rows=R, groups=G, cluster=C,
                streamed=streamed)))
        for name, plan in shapes:
            K.bwd_plan = (lambda *a, _p=plan, **k: _p)
            try:
                ms = timer(lambda: K.spm_block_bwd_kernel_call(
                    x, gy, rstd=rstd, **kw))
            finally:
                K.bwd_plan = planner
            out.append(dict(form=label, rows=rows, shape=name,
                            lane_blocks=plan.lane_blocks,
                            chunk_rows=plan.chunk_rows, groups=plan.groups,
                            streamed=plan.streamed, ms=ms))
            print(f"K4 {label:9s} rows={rows:5d} {name:18s} C{plan.lane_blocks}"
                  f" R{plan.chunk_rows} G{plan.groups} streamed "
                  f"{plan.streamed}: {ms:.4f} ms")
    res = dict(gpu=cs.gpu_line(), dtype="bfloat16", cases=out)
    print(cs.gpu_line())
    print(json.dumps(res))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
