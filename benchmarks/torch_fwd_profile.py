"""Where a block of K1, K3 or K5 spends its time on the card.

    python benchmarks/torch_fwd_profile.py [--kernel K1|K3|K5] [--root DIR]
        [--out FILE]

Builds, beside the kernels' own build, a copy of ``csrc/spm_stack.cu``
(``csrc/spm_block.cu``, ``csrc/spm_overlap.cu``) and its headers whose
kernel reads ``clock64()`` at its phase boundaries (block 0, thread 0,
summed in shared memory over the launch), runs K1 on the o projection's
run (n 2048, strides 1..1024, bf16, 4096 rows, d_in, d_out and a bias), K3
on the fused q projection (the same run after the RMS norm, gamma, 4096
rows) or K5 on the q/k/v/o pair (4 shards of 512, 9 stages, bf16, 4096
rows, d_in), each in the wrapper's launch shape, and prints the
microseconds that block spends in each phase a chunk of rows: the wait for
its x, K3's norm prologue (the rows' sums of squares and their barrier),
the stage passes (work and barrier apart), the stores (K5: the exchange and
mix), and once a launch the set-up.  Microseconds are cycles over the SM clock read with
``nvidia-smi`` after the run.  A mark costs a shared-memory
read-modify-write, so the phases sum to a little more than the
uninstrumented block, whose time (the kernel's CUDA-event time) is printed
beside them.

``--root`` profiles the checkout at DIR (its ``src/``, Python and CUDA),
so one command can profile a parent commit's K1 beside this one's: the
engine's marks (``csrc/spm_fwd_engine.cuh``) where the checkout has it,
else the marks of the first design (one block an 8-row tile, one stage a
pass).  K3's and K5's marks are the engine's: a checkout whose K3 does not
walk there stops at a missing anchor.  Needs a GPU and ``nvcc``; the
instrumented copy is built into
``<root>/src/repro_torch/kernels/_build/profile_fwd/``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

# the clock marks, inserted into the copy of spm_common.cuh: block 0,
# thread 0 adds the cycles since the previous mark to slot i (0 restarts
# the clock without counting); PROF_FLUSH copies the slots out
MARK = '''
__device__ long long spm_prof[16];
__device__ __forceinline__ long long* spm_prof_slots() {
  __shared__ long long slots[16];
  return slots;
}
__device__ __forceinline__ bool spm_prof_thread() {
  return blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
         threadIdx.x == 0;
}
__device__ __forceinline__ void spm_prof_init() {
  if (!spm_prof_thread()) return;
  long long* p = spm_prof_slots();
  for (int i = 0; i < 16; ++i) p[i] = 0;
  p[15] = clock64();
}
__device__ __forceinline__ void spm_prof_mark(int i) {
  if (!spm_prof_thread()) return;
  long long* p = spm_prof_slots();
  const long long t = clock64();
  if (i > 0) p[i] += t - p[15];
  p[15] = t;
}
__device__ __forceinline__ void spm_prof_flush() {
  if (!spm_prof_thread()) return;
  for (int i = 0; i < 16; ++i) spm_prof[i] = spm_prof_slots()[i];
}
extern "C" int spm_prof_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, spm_prof, sizeof(long long) * 16);
}
#define PROF_INIT() spm_prof_init()
#define PROF_MARK(i) spm_prof_mark(i)
#define PROF_FLUSH() spm_prof_flush()
'''

COMMON_EDITS = [("#define SPM_MAX_STAGES 32\n",
                 "#define SPM_MAX_STAGES 32\n" + MARK)]

# the first design: one block an 8-row tile, one stage a pass
LEGACY = dict(
    phases={1: "load x tile", 2: "barrier after the load",
            3: "stage passes: work", 4: "stage passes: barrier",
            5: "epilogue and stores"},
    common=[("""    __syncthreads();
  }
}

enum SpmAct""", """    PROF_MARK(3);
    __syncthreads();
    PROF_MARK(4);
  }
}

enum SpmAct""")],
    engine=[],
    kernel=[("  extern __shared__ float z[];\n",
             "  extern __shared__ float z[];\n  PROF_INIT();\n"),
            ("  __syncthreads();\n  spm_apply_stages(",
             "  PROF_MARK(1);\n  __syncthreads();\n  PROF_MARK(2);\n"
             "  spm_apply_stages("),
            ("  } else {\n    __shared__ float warp_max[16];",
             "    PROF_MARK(5);\n    PROF_FLUSH();\n"
             "  } else {\n    __shared__ float warp_max[16];")])


def _edit(text: str, edits, what: str) -> str:
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"torch_fwd_profile: anchor not found in "
                             f"{what}: {old[:60]!r}")
        text = text.replace(old, new, 1)
    return text


def build_profiled(build, design, kernel) -> ctypes.CDLL:
    """Compile the instrumented K1 or K5 and return its library."""
    csrc = Path(build.CSRC)
    out = Path(build.BUILD_DIR) / "profile_fwd"
    out.mkdir(parents=True, exist_ok=True)
    for name in os.listdir(csrc):
        if name.endswith(".cuh"):
            text = (csrc / name).read_text()
            if name == "spm_common.cuh":
                text = _edit(text, COMMON_EDITS + design["common"], name)
            if name == "spm_fwd_engine.cuh":
                text = _edit(text, design["engine"]
                             + (K3_ENGINE if kernel == "K3" else []), name)
            (out / name).write_text(text)
    name, edits = {"K1": ("spm_stack", design["kernel"]),
                   "K3": ("spm_block", design.get("k3", [])),
                   "K5": ("spm_overlap", design.get("k5", []))}[kernel]
    src = out / f"{name}_profiled.cu"
    src.write_text(_edit((csrc / f"{name}.cu").read_text(), edits,
                         f"{name}.cu"))
    lib = out / f"lib{name}_profiled.so"
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(out),
                        "-o", str(lib), str(src)], capture_output=True,
                       text=True)
    if r.returncode:
        raise SystemExit(f"torch_fwd_profile: nvcc failed\n{r.stdout}")
    return ctypes.CDLL(str(lib))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="K1", choices=("K1", "K3", "K5"))
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("torch_fwd_profile: no CUDA device", file=sys.stderr)
        return 2
    build = importlib.import_module("repro_torch.kernels.build")
    K = importlib.import_module("repro_torch.kernels.spm_stack")
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    engine = (Path(build.CSRC) / "spm_fwd_engine.cuh").exists()
    design = ENGINE if engine else LEGACY
    if args.kernel != "K1" and not engine:
        raise SystemExit(f"torch_fwd_profile: {args.kernel}'s marks are "
                         f"the engine's")
    build.load_all()
    lib = build_profiled(build, design, args.kernel)
    rows = 4096
    g = torch.Generator(device="cuda").manual_seed(0)

    def rotations(*lead):
        th = (torch.rand(*lead, generator=g, device="cuda") * 2 - 1) * \
            math.pi
        return torch.stack([th.cos(), -th.sin(), th.sin(), th.cos()],
                           -1).contiguous()

    if args.kernel in ("K1", "K3"):
        n = nt = 2048
        strides = tuple(1 << i for i in range(11))
        cf = rotations(len(strides), n // 2)
        vecs = [1 + 0.1 * torch.randn(n, generator=g, device="cuda"),
                1 + 0.1 * torch.randn(n, generator=g, device="cuda"),
                0.1 * torch.randn(n, generator=g, device="cuda")]
        x = torch.randn(rows, n, generator=g, device="cuda").bfloat16()
        gamma = 1 + 0.1 * torch.randn(n, generator=g, device="cuda")
        lib_name, shape_timed = {
            "K1": ("spm_stack", "K1 o run: n 2048, strides 1..1024, bf16, "
                                "4096 rows, d_in, d_out, bias"),
            "K3": ("spm_block", "K3 q projection: RMS norm (gamma), then "
                                "the o run's shape, bf16, 4096 rows")}[
            args.kernel]

        def call():
            if args.kernel == "K3":
                return K.spm_block_kernel_call(
                    x, cf, *vecs, gamma=gamma, strides1=strides, in_width=n,
                    mid_width=n, out_width=n)[0]
            return K.spm_stack_kernel_call(x, cf, *vecs, strides=strides,
                                           n_tile=nt)
    else:
        S, nt = 4, 512
        strides = tuple(1 << i for i in range(9))
        cf = rotations(S, len(strides), nt // 2)
        vecs = [1 + 0.1 * torch.randn(S * nt, generator=g, device="cuda")
                for _ in range(3)]
        x = torch.randn(rows, S * nt, generator=g, device="cuda").bfloat16()
        lib_name, shape_timed = "spm_overlap", (
            "K5 q/k/v/o pair: 4 shards of 512, 9 stages, k=1, bf16, 4096 "
            "rows, d_in")

        def call():
            return K.spm_overlap_kernel_call(x, cf, *vecs, strides=strides,
                                             n_tile=nt, k=1)

    ms = cs.Timer(torch)(call)            # the kernels' own build
    built = build._libs[lib_name]
    build._libs[lib_name] = lib
    K._fn.cache_clear()
    try:
        y = call()
        torch.cuda.synchronize()
        prof = (ctypes.c_longlong * 16)()
        lib.spm_prof_read(prof)
    finally:
        build._libs[lib_name] = built
        K._fn.cache_clear()
    same = torch.equal(y, call())
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    if engine:
        plan = {"K1": lambda: K.fwd_plan(rows, nt, strides, 1, 2),
                "K3": lambda: K.fwd_plan(rows, nt, strides, 1, 2,
                                         block=True, norm=True),
                "K5": lambda: K.fwd_plan(rows, nt, strides, S // 2, 2,
                                         sides=2)}[args.kernel]()
        chunks = len([c for c in K.fwd_row_chunks(rows, plan)
                      if c[0] == 0])
        shape = dict(plan=plan._asdict(), passes=K.fwd_passes(
            nt, plan.lane_blocks, strides))
    else:
        br = K.pick_block_rows(rows, nt)
        chunks = 1
        shape = dict(block_rows=br, blocks=-(-rows // br), passes=[
            (i, 1) for i in range(len(strides))])
    phases = dict(design["phases"])
    if args.kernel == "K3":
        phases[10] = "norm prologue: sums of squares, barrier"
    per_chunk = {name: prof[i] / (1 if i == 9 else chunks) / clock
                 for i, name in phases.items()}
    total = sum(per_chunk.values())
    res = dict(gpu=cs.gpu_line(), sm_clock_mhz=clock, root=str(root),
               kernel=args.kernel,
               design="engine" if engine else "first design",
               shape_timed=shape_timed,
               chunks_per_block=chunks, kernel_ms=ms,
               chunk_us_by_phase=per_chunk, chunk_us_marked=total,
               instrumented_output_bitwise=same, **shape)
    print(cs.gpu_line())
    for name, us in per_chunk.items():
        print(f"  {name:36s} {us:7.3f} us a chunk")
    print(f"  {'sum (instrumented, set-up once)':36s} {total:7.3f}; "
          f"kernel {ms:.4f} ms, {chunks} chunks a block")
    print(json.dumps(res))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


# the forward engine (spm_fwd_engine.cuh): persistent row groups, fused
# passes, x staged one chunk ahead
ENGINE = dict(
    phases={9: "set-up, table copy, first x issued (once)",
            1: "wait for x and the chunk barrier",
            2: "pass 0 from the staging", 3: "barrier after pass 0",
            4: "issue the next chunk's x", 5: "middle passes: work",
            6: "middle passes: barrier", 7: "last pass and stores",
            8: "chunk finish"},
    common=[],
    engine=[("""  for (int k = 0; chunk(k, &r0, &rows, &scale); ++k) {
    spm_bwd::cp_wait_all();
    spm_bwd::sync(cluster);  // x landed; the last chunk's tile read
""", """  PROF_MARK(9);
  for (int k = 0; chunk(k, &r0, &rows, &scale); ++k) {
    spm_bwd::cp_wait_all();
    spm_bwd::sync(cluster);  // x landed; the last chunk's tile read
    PROF_MARK(1);
"""), ("""      if (p == 0) {
        spm_bwd::sync(np > 1 && ps[1].cross);
""", """      PROF_MARK(p == 0 ? 2 : p < np - 1 ? 5 : 7);
      if (p == 0) {
        spm_bwd::sync(np > 1 && ps[1].cross);
        PROF_MARK(3);
"""), ("""          spm_bwd::stage_rows(xs, x, x_ld, n0, nr, w, x_col, x_lim);
      } else if (p < np - 1) {
        spm_bwd::sync(ps[p + 1].cross);
      }
""", """          spm_bwd::stage_rows(xs, x, x_ld, n0, nr, w, x_col, x_lim);
        PROF_MARK(4);
      } else if (p < np - 1) {
        spm_bwd::sync(ps[p + 1].cross);
        PROF_MARK(6);
      }
"""), ("""    finish(k, r0, rows);
  }
""", """    finish(k, r0, rows);
    PROF_MARK(8);
  }
""")],
    kernel=[("""  extern __shared__ __align__(16) unsigned char smem[];
  const int C = sh.C, w = nt / C, np = pl.np;
""", """  extern __shared__ __align__(16) unsigned char smem[];
  PROF_INIT();
  const int C = sh.C, w = nt / C, np = pl.np;
"""), ("""d_in, c0 + lane0, chunk, sink, finish);
}

// Int8 activation I/O""", """d_in, c0 + lane0, chunk, sink, finish);
  PROF_FLUSH();
}

// Int8 activation I/O""")],
    k3=[("""  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, half = n >> 1;
""", """  extern __shared__ __align__(16) unsigned char smem[];
  PROF_INIT();
  const int g = blockIdx.x, half = n >> 1;
"""), ("""#undef K3_WALK
}
""", """#undef K3_WALK
  PROF_FLUSH();
}
""")],
    k5=[("""  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
""", """  extern __shared__ __align__(16) unsigned char smem[];
  PROF_INIT();
  cg::cluster_group cluster = cg::this_cluster();
"""), ("""  cluster.sync();  // the partner has read this block's last slot""",
       """  PROF_FLUSH();
  cluster.sync();  // the partner has read this block's last slot""")])

# K3's norm prologue: the walk's `pre` hook, its own phase
K3_ENGINE = [("""    pre(k, r0, rows);
""", """    pre(k, r0, rows);
    PROF_MARK(10);
""")]

if __name__ == "__main__":
    sys.exit(main())
