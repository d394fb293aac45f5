// K3: the residual-block forward — RMS prologue, SPM stack 1 [, mask,
// activation, SPM stack 2] [, residual add] — on the forward engine, one
// block a tile of n <= 2048 lanes.
//
// Replaces the TPU kernel `_block_kernel` / `spm_block_kernel_call` of
// src/repro/kernels/spm_stack.py (:873 / :1028):
//
//   1. x masked to in_w;  rstd = rsqrt(sum(x^2) / in_w + eps)  (with gamma)
//   2. z = ((x rstd) gamma) d_in1;  stack 1;  d_out1 [, bias1]
//   3. with a second stack (or an activation): mask to mid_w BEFORE the
//      activation (relu, silu, tanh-gelu), so dead lanes stay exact zeros
//   4. stack 2: d_in2, stages, d_out2 [, bias2]
//   5. [+ masked raw x], store to out_w;  rstd (B, 1) f32 is stored too
//
// Without a second stack this is the norm-prologue-only form that the
// fused q/k/v projections use: K1's run (spm_stack.cu) with a norm before
// pass 0.
//
// On the forward engine (spm_fwd_engine.cuh, which has the design): row
// groups walk chunks of R rows staged a chunk ahead by cp.async, stages
// fused up to three a pass in registers, each group's coefficients held
// over the chunk's rows.  K3 adds
//
//  * the norm prologue (the walk's `pre` hook): once a chunk's x has
//    landed, one warp a row sums the squares of the staged row (each lane
//    its 16-byte runs in order, then the warp's tree), writes the row's
//    rstd to shared memory and to rstd_out, and one barrier publishes it.
//    A tile is one block's (lane_blocks = 1 at every row count: the
//    planner never splits K3's lanes over a cluster), so the sum needs no
//    cross-block reduction;
//  * pass 0's source applies ((x rstd) gamma) d_in1, each product rounded;
//  * the second stack: stack 1's last pass stores u = z d_out1 [+ bias1],
//    masked to mid_w, act(u) d_in2 into the f32 tile, and `finish` walks
//    stack 2's passes over that tile, its table read from L2 (only stack
//    1's table is ever resident);
//  * the residual is read again from device memory (L2: the chunk's x was
//    staged a few microseconds before) by the last pass's store, since the
//    staging buffer already holds the next chunk's x by then.
//
// Numerics: every product and sum rounds on its own, in the plain
// version's order, so given the kernel's rstd, y is bit for bit a plain
// composition of ((x rstd) gamma) d_in1, spm_stack_plain and the
// epilogues; only the row's sum of squares is in another order (and the
// activation's expf/tanhf are CUDA's).

#include <cooperative_groups.h>

#include "spm_fwd_engine.cuh"

namespace eng = spm_fwd;

// Pass 0's source: the staged x, times its row's rstd (rs, shared memory)
// and gamma when the norm is on, times d_in1: ((x rstd) gamma) d_in1.
template <typename X>
struct FromStageNorm : eng::FromStage<X> {  // the base: raw x, no d_in
  const float* rs;
  const float* gamma;
  const float* d_in1;
  template <int N>
  struct Regs : eng::FromStage<X>::template Regs<N> {
    float gam[N], din1[N];
  };
  template <int N>
  __device__ __forceinline__ void group(const int* L, Regs<N>& g) const {
    eng::FromStage<X>::template group<N>(L, g);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      g.gam[j] = gamma ? __ldg(gamma + L[j]) : 1.f;
      g.din1[j] = __ldg(d_in1 + L[j]);
    }
  }
  template <int N, bool kC>
  __device__ __forceinline__ void load(int r, const Regs<N>& g,
                                       float* v) const {
    eng::FromStage<X>::template load<N, kC>(r, g, v);
    const float q = gamma ? rs[r] : 1.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (gamma) v[j] = __fmul_rn(__fmul_rn(v[j], q), g.gam[j]);
      v[j] = __fmul_rn(v[j], g.din1[j]);
    }
  }
};

// Stack 1's last pass with a second stack: u = z d_out1 [+ bias1], masked
// to mid_w before the activation, then act(u) d_in2 into the tile.
struct ToTileMid : eng::Epi {
  eng::Tile tile;
  const float* d_in2;
  int mid_w, act;
  template <int N>
  struct Regs : eng::EpiRegs<N> {
    typename eng::Tile::template Regs<N> t;
    float din2[N];
  };
  template <int N>
  __device__ __forceinline__ void group(const int* L, Regs<N>& g) const {
    eng::Epi::group<N>(L, g);
    tile.group<N>(L, g.t);
#pragma unroll
    for (int j = 0; j < N; ++j) g.din2[j] = __ldg(d_in2 + L[j]);
  }
  template <int N, bool kC>
  __device__ __forceinline__ void store(int r, const Regs<N>& g,
                                        float* v) const {
    this->template apply<N>(g, v);
#pragma unroll
    for (int j = 0; j < N; ++j)
      v[j] = __fmul_rn(spm_act(g.col[j] < mid_w ? v[j] : 0.f, act),
                       g.din2[j]);
    tile.store<N, kC>(r, g.t, v);
  }
};

// The block's store with an activation or the residual (the q/k/v form
// stores through the engine's ToOut): the epilogue (d_out, bias), then,
// without a second stack but with an activation, the mid_w mask and act,
// then [+ x, read from device memory, zero past in_w], y (rows from row0,
// pitch out_w) with columns from out_w on dropped.  A contiguous group
// inside out_w on an aligned address is one vector store.
template <typename T>
struct ToBlockOut : eng::Epi {
  T* y;
  const T* x;
  long row0;
  int out_w, in_w, mid_w, act;
  bool acted, residual;
  template <int N>
  using Regs = eng::EpiRegs<N>;
  template <int N, bool kC>
  __device__ __forceinline__ void store(int r, const Regs<N>& g,
                                        float* v) const {
    this->template apply<N>(g, v);
    const long row = row0 + r;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = g.col[j];
      if (acted) v[j] = spm_act(c < mid_w ? v[j] : 0.f, act);
      if (residual && c < in_w) v[j] = __fadd_rn(v[j], spm_ld(x + row * in_w + c));
    }
    T* yr = y + row * out_w;
    bool done = false;
    if constexpr (kC && N >= 4) {
      if (g.col[0] + N <= out_w && (row * out_w + g.col[0]) % N == 0) {
        eng::st_vec<N>(yr + g.col[0], v);
        done = true;
      }
    }
    if (!done) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (g.col[j] < out_w) spm_st(yr + g.col[j], v[j]);
    }
  }
};

// The norm prologue of a chunk: one warp a row of the staged x (R x w of
// X, zero past in_w), each lane summing the squares of its 16-byte runs
// (or single elements when a row is not 16-byte aligned) in order, then the
// warp's tree; rstd = rsqrt(sum / in_w + eps) to rs[r] and rstd_out.
template <typename X>
__device__ __forceinline__ void row_rstd(const X* xs, int w, int rows,
                                         int in_w, float eps, float* rs,
                                         float* rstd_out) {
  constexpr int V = 16 / (int)sizeof(X);
  const int lane = threadIdx.x & 31;
  const unsigned base = eng::saddr(xs);
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    const unsigned rb = base + (unsigned)(r * w) * (unsigned)sizeof(X);
    float acc = 0.f;
    if (w % V == 0) {
      for (int c = lane * V; c < w; c += 32 * V) {
        float v[V];
        eng::lds_run<V, X>(rb + c * (unsigned)sizeof(X), v);
#pragma unroll
        for (int j = 0; j < V; ++j) acc = __fadd_rn(acc, __fmul_rn(v[j], v[j]));
      }
    } else {
      for (int c = lane; c < w; c += 32) {
        const float v = eng::lds_elem(rb + c * (unsigned)sizeof(X),
                                      static_cast<X*>(nullptr));
        acc = __fadd_rn(acc, __fmul_rn(v, v));
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (lane == 0) {
      const float q = rsqrtf(__fadd_rn(__fdiv_rn(acc, (float)in_w), eps));
      rs[r] = q;
      rstd_out[r] = q;
    }
  }
  __syncthreads();
}

// T the I/O type; kRes keeps stack 1's table in shared memory; kTwo: a
// second stack.  Grid: G row groups, one block each (a tile is one block).
template <typename T, bool kRes, bool kTwo>
__global__ void __launch_bounds__(256, 1) spm_block_fwd_kernel(
    const T* __restrict__ x, T* __restrict__ y, float* __restrict__ rstd_out,
    const float* __restrict__ gamma, const float4* __restrict__ cf1,
    const float* __restrict__ din1, const float* __restrict__ dout1,
    const float* __restrict__ bias1, const float4* __restrict__ cf2,
    const float* __restrict__ din2, const float* __restrict__ dout2,
    const float* __restrict__ bias2, int B, int n, int in_w, int mid_w,
    int out_w, int act, int residual, float eps, eng::Shape sh,
    const __grid_constant__ eng::Plan pl1,
    const __grid_constant__ eng::Plan pl2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, half = n >> 1;
  const eng::Layout lay = eng::layout(pl1.L, n, sh.R, sizeof(T), 16, kRes,
                                      pl1.np > 1 || kTwo, 0, gamma != nullptr);
  float4* tbl = reinterpret_cast<float4*>(smem + lay.tbl);
  if (kRes) eng::load_table((const float4*)cf1, half, pl1.L, half, tbl);
  T* xs = reinterpret_cast<T*>(smem + lay.xst);
  float* z = reinterpret_cast<float*>(smem + lay.tile);
  float* rs = reinterpret_cast<float*>(smem + lay.stats);
  auto chunk = [&](int k, int* r0, int* rows, float* scale) {
    *r0 = (g + k * sh.G) * sh.R;
    *rows = min(sh.R, B - *r0);
    *scale = 1.f;
    return *r0 < B;
  };
  auto pre = [&](int, int r0, int rows) {
    if (gamma) row_rstd(xs, n, rows, in_w, eps, rs, rstd_out + r0);
  };
  auto src0 = [&](float) {
    FromStageNorm<T> s;
    s.s = xs;
    s.w = n;
    s.scale = 1.f;
    s.d_in = nullptr;
    s.col0 = 0;
    s.rs = rs;
    s.gamma = gamma;
    s.d_in1 = din1;
    return s;
  };
  // the store of y: stack 2's epilogue, or stack 1's (with the activation
  // when there is one and no second stack)
  auto out = [&](int r0) {
    ToBlockOut<T> o;
    o.d_out = kTwo ? dout2 : dout1;
    o.bias = kTwo ? bias2 : bias1;
    o.col0 = 0;
    o.y = y;
    o.x = x;
    o.row0 = r0;
    o.out_w = out_w;
    o.in_w = in_w;
    o.mid_w = mid_w;
    o.act = act;
    o.acted = !kTwo && act != ACT_NONE;
    o.residual = residual != 0;
    return o;
  };
  const eng::TableGlobal<const float4*> tab1g{cf1, half};
  const eng::Tile tile(z, n);
// stack 1's walk into `sink`, its table resident or read from L2
#define K3_WALK(sink, finish)                                               \
  do {                                                                      \
    if (kRes)                                                               \
      eng::walk_hooked(pl1.stg, pl1.ps, pl1.np,                             \
                       eng::TablePairs<const float4*>{tbl, half, 0, cf1},   \
                       tab1g, xs, z, n, 0, 0, false, x, in_w, 0, in_w,      \
                       chunk, pre, src0, sink, finish);                     \
    else                                                                    \
      eng::walk_hooked(pl1.stg, pl1.ps, pl1.np, tab1g, tab1g, xs, z, n, 0,  \
                       0, false, x, in_w, 0, in_w, chunk, pre, src0, sink,  \
                       finish);                                             \
  } while (0)
  if constexpr (kTwo) {
    auto mid = [&](const eng::Pass&, int) {
      return ToTileMid{eng::Epi{dout1, bias1, 0}, tile, din2, mid_w, act};
    };
    const eng::TableGlobal<const float4*> tab2{cf2, half};
    auto finish = [&](int, int r0, int rows) {  // stack 2 over the tile
      __syncthreads();
      for (int p = 0; p < pl2.np; ++p) {
        const eng::Pass P = pl2.ps[p];
        if (p < pl2.np - 1) {
          eng::run(P, pl2.stg, rows, 0, 0, tab2, tile, tile);
          __syncthreads();
        } else {
          eng::run(P, pl2.stg, rows, 0, 0, tab2, tile, out(r0));
        }
      }
    };
    K3_WALK(mid, finish);
  } else if (act == ACT_NONE && !residual) {
    // the q/k/v form stores as K1 does: no activation or residual code in
    // the last pass's loop
    auto sink = [&](const eng::Pass&, int r0) {
      eng::ToOut<T> o;
      o.d_out = dout1;
      o.bias = bias1;
      o.col0 = 0;
      o.y = y;
      o.row0 = r0;
      o.ld = out_w;
      o.lim = out_w;
      return o;
    };
    auto finish = [](int, int, int) {};
    K3_WALK(sink, finish);
  } else {
    auto sink = [&](const eng::Pass&, int r0) { return out(r0); };
    auto finish = [](int, int, int) {};
    K3_WALK(sink, finish);
  }
#undef K3_WALK
}

// The plans and shared memory of a launch shape (host side); false when
// the shape does not fit or a stack cannot be planned.
static bool plan(const SpmStrides& st1, const SpmStrides& st2, bool two,
                 int n, int io_bytes, bool norm, const eng::Shape& sh,
                 eng::Plan* pl1, eng::Plan* pl2, size_t* smem) {
  if (sh.C != 1 || sh.Cr != 1 || sh.T < 32 || sh.T > eng::kMaxThreads ||
      sh.T % 32 || sh.R < 1 || sh.G < 1 || st1.n < 1 || (two && st2.n < 1))
    return false;
  if (!eng::make_plan(st1, n, 1, sh.T, pl1)) return false;
  pl2->L = pl2->np = 0;
  if (two && !eng::make_plan(st2, n, 1, sh.T, pl2)) return false;
  *smem = eng::layout(st1.n, n, sh.R, io_bytes, 16, sh.resident,
                      pl1->np > 1 || two, 0, norm)
              .total;
  return *smem <= 232448;
}

template <typename T, bool kRes, bool kTwo>
static cudaError_t launch_block(const void* x, void* y, void* rstd,
                                const void* gamma, const void* cf1,
                                const void* din1, const void* dout1,
                                const void* bias1, const void* cf2,
                                const void* din2, const void* dout2,
                                const void* bias2, int B, int n, int in_w,
                                int mid_w, int out_w, int act, int residual,
                                float eps, const eng::Shape& sh,
                                const eng::Plan& pl1, const eng::Plan& pl2,
                                size_t smem, cudaStream_t stream) {
  static size_t smem_set = 0;  // largest dynamic shared memory opted into
  auto kernel = spm_block_fwd_kernel<T, kRes, kTwo>;
  cudaError_t e = spm_allow_smem(kernel, smem, &smem_set);
  if (e != cudaSuccess) return e;
  return eng::launch(kernel, dim3(sh.G), sh.T, smem, 1, stream, (const T*)x,
                     (T*)y, (float*)rstd, (const float*)gamma,
                     (const float4*)cf1, (const float*)din1,
                     (const float*)dout1, (const float*)bias1,
                     (const float4*)cf2, (const float*)din2,
                     (const float*)dout2, (const float*)bias2, B, n, in_w,
                     mid_w, out_w, act, residual, eps, sh, pl1, pl2);
}

template <typename T>
static cudaError_t dispatch(bool two, const void* x, void* y, void* rstd,
                            const void* gamma, const void* cf1,
                            const void* din1, const void* dout1,
                            const void* bias1, const void* cf2,
                            const void* din2, const void* dout2,
                            const void* bias2, int B, int n, int in_w,
                            int mid_w, int out_w, int act, int residual,
                            float eps, const eng::Shape& sh,
                            const eng::Plan& pl1, const eng::Plan& pl2,
                            size_t smem, cudaStream_t s) {
#define SPM_BLOCK_LAUNCH(RES, TWO)                                        \
  return launch_block<T, RES, TWO>(x, y, rstd, gamma, cf1, din1, dout1,  \
                                   bias1, cf2, din2, dout2, bias2, B, n,  \
                                   in_w, mid_w, out_w, act, residual, eps, \
                                   sh, pl1, pl2, smem, s)
  if (sh.resident && two) SPM_BLOCK_LAUNCH(true, true);
  if (sh.resident) SPM_BLOCK_LAUNCH(true, false);
  if (two) SPM_BLOCK_LAUNCH(false, true);
  SPM_BLOCK_LAUNCH(false, false);
#undef SPM_BLOCK_LAUNCH
}

// C interface (loaded with ctypes).  gamma/rstd, bias1, and the whole
// second stack (cf2, din2, dout2, bias2) may be null; d_in1 and d_out1 may
// not.  The launch shape (T threads, R rows a chunk, G row groups, stack
// 1's table resident) is the planner's, kernels/spm_stack.py `fwd_plan`
// with its block form.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int spm_block_fwd(int io_type, const void* x, void* y, void* rstd,
                             const void* gamma, const void* cf1,
                             const void* din1, const void* dout1,
                             const void* bias1, const void* cf2,
                             const void* din2, const void* dout2,
                             const void* bias2, int B, int n, int in_w,
                             int mid_w, int out_w, int act, int residual,
                             float eps, int T, int R, int G, int resident,
                             const int* strides1, int L1,
                             const int* strides2, int L2, void* stream) {
  SpmStrides st1, st2;
  const bool two = cf2 != nullptr;
  const eng::Shape sh{1, 1, T, R, G, resident};
  eng::Plan pl1, pl2;
  size_t smem;
  if (!spm_copy_strides(&st1, strides1, L1) ||
      !spm_copy_strides(&st2, strides2, two ? L2 : 0) || B <= 0 ||
      (gamma != nullptr) != (rstd != nullptr) || !din1 || !dout1 ||
      (two && (!din2 || !dout2)) || io_type < SPM_IO_F32 ||
      io_type > SPM_IO_BF16 ||
      !plan(st1, st2, two, n, io_type == SPM_IO_F32 ? 4 : 2,
            gamma != nullptr, sh, &pl1, &pl2, &smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (io_type == SPM_IO_F32)
    return (int)dispatch<float>(two, x, y, rstd, gamma, cf1, din1, dout1,
                                bias1, cf2, din2, dout2, bias2, B, n, in_w,
                                mid_w, out_w, act, residual, eps, sh, pl1,
                                pl2, smem, s);
  return (int)dispatch<__nv_bfloat16>(two, x, y, rstd, gamma, cf1, din1,
                                      dout1, bias1, cf2, din2, dout2, bias2,
                                      B, n, in_w, mid_w, out_w, act,
                                      residual, eps, sh, pl1, pl2, smem, s);
}
