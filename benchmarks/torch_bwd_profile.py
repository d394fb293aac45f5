"""Where a chunk of the backward engine (K2, K4) spends its time on the card.

    python benchmarks/torch_bwd_profile.py [--kernel K2|K4]
        [--out out/bwd_profile.json]

Builds, beside the kernels' own build, a copy of ``csrc/spm_stack_bwd.cu``
(``csrc/spm_block_bwd.cu``) and ``csrc/spm_bwd_engine.cuh`` whose kernel
reads ``clock64()`` at its phase boundaries (block (0, 0), thread 0,
summed in shared memory over the launch), runs K2 on the o projection's
run (n 2048, strides 1..1024, bf16, 4096 rows, d_in, d_out and a bias), or
K4 on the fused q projection (the same run after the RMS norm, gamma,
rstd from K3), in the planner's launch shape, and prints the microseconds
a chunk spends in each phase: the chunk's wait for its copies, issuing the
next x, z_0, the stage passes of the remat and the reverse walk (work and
barrier apart, passes within one block apart from passes storing into or
loading from other blocks), the epilogue from gy, issuing the next gy,
g_din and g_x (K4: g_din1, g_gamma and gxh; the row mean's block sums;
its cluster barrier and the blocks' sum; g_x), the g_x stores.  Microseconds are
cycles over the SM clock read with ``nvidia-smi`` after the run.  A mark
costs about a tenth of a microsecond (a shared-memory read-modify-write),
so the phases sum to a little more than the uninstrumented chunk, whose
time (the kernel's CUDA-event time over the chunks a cluster walks) is
printed beside them.  Needs a GPU and ``nvcc``; the instrumented copy is
built into ``src/repro_torch/kernels/_build/profile/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# phase marks: index -> name (0 restarts the clock without counting)
PHASES = {1: "wait for copies", 2: "issue next x", 3: "z_0 and barrier",
          4: "epilogue from gy", 5: "barrier after epilogue",
          6: "issue next gy", 7: "g_din and g_x", 8: "barrier after g_x",
          9: "store g_x", 10: "local passes: work", 11: "local passes: barrier",
          12: "passes across blocks: work",
          13: "passes across blocks: barrier"}

MARK = '''namespace spm_bwd {
__device__ __forceinline__ void prof_mark(int i) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    long long* p = reinterpret_cast<long long*>(smem + PROF_OFF);
    const long long t = clock64();
    if (i > 0) p[i] += t - p[15];
    p[15] = t;
  }
}
}
#define PROF_MARK(i) spm_bwd::prof_mark(i)
namespace spm_bwd {
'''

# K4's phases where they are not K2's: the norm's reductions apart
K4_PHASES = dict(PHASES)
K4_PHASES.update({3: "z_0 (x rstd gamma d_in1) and barrier",
                  7: "g_din1, g_gamma, gxh",
                  8: "row mean: the block's sums",
                  14: "row mean: cluster barrier, the blocks' sum",
                  9: "g_x, barrier, store g_x"})

K4_EDITS = [
    ('#include "spm_bwd_engine.cuh"', '''#define PROF_OFF (232448 - 256)
#include "spm_bwd_engine.cuh"
__device__ long long spm_prof[16];
extern "C" int spm_prof_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, spm_prof, sizeof(long long) * 16);
}'''),
    ("  eng::setup(st1, w, C, c, two ? eng::kLayA : -1, s1.stg, s1.ps);",
     """  if (threadIdx.x < 16)
    reinterpret_cast<long long*>(smem + PROF_OFF)[threadIdx.x] = 0;
  eng::setup(st1, w, C, c, two ? eng::kLayA : -1, s1.stg, s1.ps);"""),
    ("  for (int k = 0; r0 < B; r0 += step, ++k) {",
     "  for (int k = 0; r0 < B; r0 += step, ++k) {\n    PROF_MARK(0);"),
    ("    eng::cp_wait_all();\n    eng::sync(s1.head_b);",
     "    eng::cp_wait_all();\n    eng::sync(s1.head_b);\n    PROF_MARK(1);"),
    ("    // remat: t1 = ((x rstd) gamma) d_in1",
     "    PROF_MARK(2);\n    // remat: t1 = ((x rstd) gamma) d_in1"),
    ("    eng::sync(s1.head_b || s1.ps[0].remf);\n",
     "    eng::sync(s1.head_b || s1.ps[0].remf);\n    PROF_MARK(3);\n"),
    ("    eng::sync(sy.ps[sy.np - 1].remb);\n",
     "    PROF_MARK(4);\n    eng::sync(sy.ps[sy.np - 1].remb);\n"
     "    PROF_MARK(5);\n"),
    ("    float* dl = eng::walk_back(sy.geo",
     "    PROF_MARK(6);\n    float* dl = eng::walk_back(sy.geo"),
    ("    if (norm) {\n      // the row mean of gxh xh",
     "    PROF_MARK(7);\n    if (norm) {\n      // the row mean of gxh xh"),
    ("      eng::sync(C > 1);  // every block's row sums written",
     "      PROF_MARK(8);\n"
     "      eng::sync(C > 1);  // every block's row sums written"),
    ("      // g_x = rstd (gxh - xh mean) [+ gy]",
     "      PROF_MARK(14);\n      // g_x = rstd (gxh - xh mean) [+ gy]"),
    ("    eng::store_rows(gx, in_w, r0, rows, w, lane0, in_w, dl);\n  }",
     "    eng::store_rows(gx, in_w, r0, rows, w, lane0, in_w, dl);\n"
     "    PROF_MARK(9);\n  }"),
    ("  eng::store_table_grads(s1.geo,",
     "  if (blockIdx.x == 0 && threadIdx.x < 16)\n"
     "    spm_prof[threadIdx.x] =\n"
     "        reinterpret_cast<long long*>(smem + PROF_OFF)[threadIdx.x];\n"
     "  eng::store_table_grads(s1.geo,"),
    # the marks' 128 bytes at the top of shared memory: take all of it
    ("  static size_t smem_set[2] = {0, 0};",
     "  if (smem > 232448 - 256) return cudaErrorInvalidValue;\n"
     "  smem = 232448;\n  static size_t smem_set[2] = {0, 0};"),
]

# (anchor, replacement) in the engine, then in K2; each must be present
ENGINE_EDITS = [
    ("namespace spm_bwd {\n", MARK),
    ("""    const Pass P = ps[k];
    float* tin = tiles + k * ts;
    if (P.n == 2) {
      if (!quad_thread)""", """    const Pass P = ps[k];
    PROF_MARK(0);
    float* tin = tiles + k * ts;
    if (P.n == 2) {
      if (!quad_thread)"""),
    ("""    sync(P.remf || (k + 1 < np ? ps[k + 1].remf : tail_remote));""",
     """    PROF_MARK(P.remf ? 12 : 10);
    sync(P.remf || (k + 1 < np ? ps[k + 1].remf : tail_remote));
    PROF_MARK(P.remf ? 13 : 11);"""),
    ("""    const Pass P = ps[k];
    float* tin = tiles + k * ts;
    float* dout""", """    const Pass P = ps[k];
    PROF_MARK(0);
    float* tin = tiles + k * ts;
    float* dout"""),
    ("""    dcur = dout;
    sync(P.remb || (k > 0 && ps[k - 1].remb));""", """    dcur = dout;
    PROF_MARK(P.remb ? 12 : 10);
    sync(P.remb || (k > 0 && ps[k - 1].remb));
    PROF_MARK(P.remb ? 13 : 11);"""),
]
K2_EDITS = [
    ('#include "spm_bwd_engine.cuh"', '''#define PROF_OFF (232448 - 256)
#include "spm_bwd_engine.cuh"
__device__ long long spm_prof[16];
extern "C" int spm_prof_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, spm_prof, sizeof(long long) * 16);
}'''),
    ("  eng::setup(st, w, sh.C, c, -1, stg, ps);", """  if (threadIdx.x < 16)
    reinterpret_cast<long long*>(smem + PROF_OFF)[threadIdx.x] = 0;
  eng::setup(st, w, sh.C, c, -1, stg, ps);"""),
    ("  for (int k = 0; r0 < B; r0 += step, ++k) {",
     "  for (int k = 0; r0 < B; r0 += step, ++k) {\n    PROF_MARK(0);"),
    ("    eng::cp_wait_all();\n    eng::sync(head_b);",
     "    eng::cp_wait_all();\n    eng::sync(head_b);\n    PROF_MARK(1);"),
    ("    // remat: z_0 = [D_in] x, masked to in_w, in pass 0's layout.",
     "    PROF_MARK(2);\n"
     "    // remat: z_0 = [D_in] x, masked to in_w, in pass 0's layout."),
    ("    eng::sync(L > 0 && (head_b || ps[0].remf));\n",
     "    eng::sync(L > 0 && (head_b || ps[0].remf));\n    PROF_MARK(3);\n"),
    ("    eng::sync(L > 0 && ps[np - 1].remb);\n",
     "    PROF_MARK(4);\n    eng::sync(L > 0 && ps[np - 1].remb);\n"
     "    PROF_MARK(5);\n"),
    ("    float* dl0 =\n        eng::walk_back(",
     "    PROF_MARK(6);\n    float* dl0 =\n        eng::walk_back("),
    ("    __syncthreads();\n"
     "    eng::store_rows(gx, gx_w, r0, rows, w, lane0, gx_w, dl0);",
     "    PROF_MARK(7);\n    __syncthreads();\n    PROF_MARK(8);\n"
     "    eng::store_rows(gx, gx_w, r0, rows, w, lane0, gx_w, dl0);\n"
     "    PROF_MARK(9);"),
    ("  eng::store_table_grads(geo, stg, acc,",
     "  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x < 16)\n"
     "    spm_prof[threadIdx.x] =\n"
     "        reinterpret_cast<long long*>(smem + PROF_OFF)[threadIdx.x];\n"
     "  eng::store_table_grads(geo, stg, acc,"),
    # the marks' 128 bytes at the top of shared memory: take all of it
    ("""  const size_t smem =
      eng::layout_of(st.n, sh, kVecs, sizeof(TX), sizeof(T), false).total;
  if (smem > 232448) return cudaErrorInvalidValue;""", """  size_t smem =
      eng::layout_of(st.n, sh, kVecs, sizeof(TX), sizeof(T), false).total;
  if (smem > 232448 - 256) return cudaErrorInvalidValue;
  smem = 232448;"""),
]


def _edit(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"torch_bwd_profile: anchor not found in the "
                             f"sources: {old[:60]!r}")
        text = text.replace(old, new, 1)
    return text


def build_profiled(build, kernel) -> ctypes.CDLL:
    """Compile the instrumented K2 or K4 and return its library."""
    csrc = Path(build.CSRC)
    out = Path(build.BUILD_DIR) / "profile"
    out.mkdir(parents=True, exist_ok=True)
    for name in os.listdir(csrc):
        if name.endswith(".cuh"):
            text = (csrc / name).read_text()
            if name == "spm_bwd_engine.cuh":
                text = _edit(text, ENGINE_EDITS)
            (out / name).write_text(text)
    name, edits = (("spm_stack_bwd", K2_EDITS) if kernel == "K2"
                   else ("spm_block_bwd", K4_EDITS))
    src = out / f"{name}_profiled.cu"
    src.write_text(_edit((csrc / f"{name}.cu").read_text(), edits))
    lib = out / f"lib{name}_profiled.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(out), "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="K2", choices=("K2", "K4"))
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_bwd_profile: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import spm_stack as K
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    build.load_all()
    lib = build_profiled(build, args.kernel)
    n, rows = 2048, 4096
    strides = tuple(1 << i for i in range(11))
    g = torch.Generator(device="cuda").manual_seed(0)
    th = (torch.rand(len(strides), n // 2, generator=g, device="cuda")
          * 2 - 1) * math.pi
    cf = torch.stack([th.cos(), -th.sin(), th.sin(), th.cos()], -1)
    d_in = 1 + 0.1 * torch.randn(n, generator=g, device="cuda")
    d_out = 1 + 0.1 * torch.randn(n, generator=g, device="cuda")
    x = torch.randn(rows, n, generator=g, device="cuda").bfloat16()
    gy = torch.randn(rows, n, generator=g, device="cuda").bfloat16()

    gamma = 1 + 0.1 * torch.randn(n, generator=g, device="cuda")
    bias = 0.1 * torch.randn(n, generator=g, device="cuda")
    blk = dict(strides1=strides, in_width=n, mid_width=n, out_width=n)
    _, rstd = K.spm_block_kernel_call(x, cf, d_in, d_out, bias, gamma, **blk)

    def call():
        if args.kernel == "K4":
            return K.spm_block_bwd_kernel_call(x, gy, cf, d_in, d_out, bias,
                                               gamma, rstd, **blk)
        return K.spm_stack_bwd_kernel_call(x, cf, gy, d_in, d_out,
                                           strides=strides, n_tile=n,
                                           has_bias=True)

    lib_name = "spm_stack_bwd" if args.kernel == "K2" else "spm_block_bwd"
    ms = cs.Timer(torch)(call)            # the kernels' own build
    built = build._libs[lib_name]
    build._libs[lib_name] = lib
    K._fn.cache_clear()
    try:
        call()
        torch.cuda.synchronize()
        prof = (ctypes.c_longlong * 16)()
        lib.spm_prof_read(prof)
    finally:
        build._libs[lib_name] = built
        K._fn.cache_clear()
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    if args.kernel == "K4":
        plan = K.bwd_plan(rows, n, strides, 1, 2, block=True, norm=True)
        phases, shape = K4_PHASES, ("K4 q projection: the o run's shape "
                                    "after the RMS norm, bf16, 4096 rows")
    else:
        plan = K.bwd_plan(rows, n, strides, 1, 2, 2)
        phases, shape = PHASES, ("K2 o run: n 2048, strides 1..1024, bf16, "
                                 "4096 rows")
    chunks = len([c for c in K.bwd_row_chunks(rows, plan.chunk_rows,
                                              plan.groups) if c[0] == 0])
    per_chunk = {name: prof[i] / chunks / clock for i, name in phases.items()}
    res = dict(gpu=cs.gpu_line(), sm_clock_mhz=clock, kernel=args.kernel,
               shape=shape,
               plan=plan._asdict(),
               passes=K.bwd_passes(n, plan.lane_blocks, strides),
               chunks_per_group=chunks, kernel_ms=ms,
               chunk_us_uninstrumented=1000 * ms / chunks,
               chunk_us_by_phase=per_chunk,
               chunk_us_marked=sum(per_chunk.values()))
    print(cs.gpu_line())
    for name, us in per_chunk.items():
        print(f"  {name:32s} {us:7.2f} us a chunk")
    print(f"  {'sum (instrumented)':32s} {res['chunk_us_marked']:7.2f}; "
          f"uninstrumented {res['chunk_us_uninstrumented']:.2f} "
          f"({chunks} chunks a cluster, {ms:.4f} ms)")
    print(json.dumps(res))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
