// K1: the fused SPM stage-stack forward, one planned run.
//
// Replaces the TPU kernel `_kernel` / `spm_stack_kernel_call` of
// src/repro/kernels/spm_stack.py (:157 / :338), with `_apply_stages_fwd`
// (:130):
//
//     y = [D_out] (B_l ... B_1) [D_in] x [+ bias]
//
// on feature tiles of n_tile lanes, with x zero-filled past `in_w` and the
// store masked to `out_w`.  Compute is f32; I/O is f32 or bf16, or int8
// (below).  The coefficient table is f32, or int8 with one scale a stage
// (spm_common.cuh).
//
// What bounds it on an H100: not bytes (the o tile's 4096 rows move 33.5
// MB in bf16, 0.010 ms) but the stage walk on chip: 3 rounded f32 ops a
// stage and element, issued as 6 instructions a pair, and each stage's
// read and write of the row through shared memory.  The first design ran
// one stage a pass with a block barrier each, 8 rows a block, and read the
// table from L2 at every stage of every block (about 90 MB of L2 reads at
// the o tile); a pass cost about 1 us whatever its rows.  This one runs on
// the forward engine (spm_fwd_engine.cuh): fused passes in registers (4 at
// the o tile, not 11), each group's coefficients held in registers over a
// 16-row chunk (or the table resident in shared memory where it fits),
// persistent row groups with the next chunk's x in flight by cp.async, and
// the lanes split over a cluster at decode rows.
//
// Grid: (G x C, tiles, E): row group g = blockIdx.x / C walks chunks g, g +
// G, ...; lane block c = its cluster rank; tile j = blockIdx.y.  The row
// tail and the output edge are masked here: no padded copies.
//
// Expert mode (E > 1, f32 / bf16 I/O): one launch runs the same run of E
// independent operators, expert e = blockIdx.z, as the reference's
// `jax.vmap` of the run over the MoE expert axis adds a grid axis.  x is
// (E, B, in_w) and y (E, B, out_w); expert e's table starts cf_es pairs
// after expert e-1's (the run's stages of an (E, L, n/2, 4) table) and its
// d_in / d_out / bias n floats on.  The plan is one expert's B rows;
// everything else (widths, masks, the walk) is per expert unchanged.
//
// Windowed read (the reference's `col_base`, :393-454, the feature-sharded
// executor's first local run): x is the whole (B, in_w) operand shared by
// the shards, in_w the global width, and tile j reads x's columns
// x_off + j*nt + c, zero from in_w on; the table, d_in / d_out / bias, y
// and the grid (n / nt tiles, out_w = n) are the shard's own.  Only x's
// column and its mask move by x_off, so a shard whose window lies wholly
// past in_w reads no x at all and stores exactly bias (or zero).
//
// Int8 activation I/O (the reference's `x_scale` and `quant_out`, which
// the fused path uses together): x is int8 with one f32 scale for each
// (scale_rows, n_tile) block, dequantized on load, and the result is
// requantized on the store with its own block scale absmax / 127 + 1e-12.
// A chunk is one scale block (64 x 2048 f32 at the training shapes, 512
// KiB), split over a cluster of Cr row blocks (at most 8): each block's
// last pass leaves its rows in its tile and folds their magnitudes into a
// running absmax, the block reduces it, one cluster barrier later every
// warp reads the cluster's block maxima through distributed shared memory
// (double-buffered, so a block may not reuse its slot before its peers
// have read it), and each block codes its rows from the tile with 16-byte
// stores; rank 0 stores the scale.  The absmax covers all n_tile lanes,
// the ones past out_w that the store drops included, as the reference
// takes it before its masked store.  Max is order-free, so the scale is
// exact whatever the order.  A NaN or Inf in the block reaches the scale
// (spm_max_nan), so the block dequantizes to NaN, as the plain version's
// torch.amax gives.  The register budget does not hold a chunk's values
// across the cluster barrier, so the codes take a second read of the tile.

#include <cooperative_groups.h>

#include "spm_fwd_engine.cuh"

namespace cg = cooperative_groups;
namespace eng = spm_fwd;

// f32 / bf16 I/O: T is the activation type; x is read x_off columns on
// (the windowed read; 0 otherwise); kRes keeps the table in shared memory.
template <typename T, typename CF, bool kRes>
__global__ void __launch_bounds__(256, 1) spm_stack_fwd_kernel(
    const T* __restrict__ x, T* __restrict__ y, CF cf,
    const float* __restrict__ d_in, const float* __restrict__ d_out,
    const float* __restrict__ bias, int B, int n, int nt, int in_w,
    int out_w, int x_off, long cf_es, eng::Shape sh,
    const __grid_constant__ eng::Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = sh.C, w = nt / C, np = pl.np;
  // expert mode: expert blockIdx.z's rows, table (cf_es pairs on) and
  // (n,) vectors; blockIdx.z = 0 otherwise
  {
    const long e = blockIdx.z;
    x += e * B * in_w;
    y += e * B * out_w;
    cf = cf + e * cf_es;
    if (d_in) d_in += e * n;
    if (d_out) d_out += e * n;
    if (bias) bias += e * n;
  }
  const int c = C == 1 ? 0 : (int)cg::this_cluster().block_rank();
  const int g = blockIdx.x / C;
  const int c0 = blockIdx.y * nt, lane0 = c * w;
  const eng::Layout lay =
      eng::layout(pl.L, w, sh.R, sizeof(T), sizeof(typename eng::Raw<CF>::T),
                  kRes, np > 1, 0);
  const eng::Stage* stg = pl.stg;
  const eng::Pass* ps = pl.ps;
  auto* tbl = reinterpret_cast<typename eng::Raw<CF>::T*>(smem + lay.tbl);
  const CF cft = cf + (long)blockIdx.y * (nt >> 1);
  if (kRes) {
    eng::load_table(cft + (long)lane0 / 2, n >> 1, pl.L, w >> 1, tbl);
  }
  auto chunk = [&](int k, int* r0, int* rows, float* scale) {
    *r0 = (g + k * sh.G) * sh.R;
    *rows = min(sh.R, B - *r0);
    *scale = 1.f;
    return *r0 < B;
  };
  auto sink = [&](const eng::Pass& P, int r0) {
    eng::ToOut<T> o;
    o.d_out = d_out;
    o.bias = bias;
    o.col0 = c0 + (P.cross ? 0 : lane0);
    o.y = y;
    o.row0 = r0;
    o.ld = out_w;
    o.lim = out_w;
    return o;
  };
  auto finish = [](int, int, int) {};
  T* xs = reinterpret_cast<T*>(smem + lay.xst);
  float* z = reinterpret_cast<float*>(smem + lay.tile);
  const long x_col = (long)x_off + c0 + lane0;
  if (kRes)
    eng::walk(stg, ps, np, eng::TablePairs<CF>{tbl, w >> 1, lane0 >> 1, cft},
              eng::TableGlobal<CF>{cft, n >> 1}, xs, z, w, lane0, c, C > 1, x,
              in_w, x_col, in_w, d_in, c0 + lane0, chunk, sink, finish);
  else
    eng::walk(stg, ps, np, eng::TableGlobal<CF>{cft, n >> 1},
              eng::TableGlobal<CF>{cft, n >> 1}, xs, z, w, lane0, c, C > 1, x,
              in_w, x_col, in_w, d_in, c0 + lane0, chunk, sink, finish);
}

// Int8 activation I/O: x int8, dequantized on load with its block's scale
// from xs (B / scale_rows, ceil(in_w / nt)); a chunk is one scale block,
// its rows split over a cluster of Cr row blocks along x (B a multiple of
// scale_rows: the caller pads rows); the store requantizes with the
// cluster's scale, written to ys (B / scale_rows, gridDim.y).
template <typename CF, bool kRes>
__global__ void __launch_bounds__(256, 1) spm_stack_fwd_q8_kernel(
    const int8_t* __restrict__ x, const float* __restrict__ xs_scale,
    int8_t* __restrict__ y, float* __restrict__ ys, CF cf,
    const float* __restrict__ d_in, const float* __restrict__ d_out,
    const float* __restrict__ bias, int B, int n, int nt, int in_w,
    int out_w, int scale_rows, eng::Shape sh,
    const __grid_constant__ eng::Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float warp_max[32];
  __shared__ float block_max[2];  // by chunk parity
  cg::cluster_group cluster = cg::this_cluster();
  const int rho = (int)cluster.block_rank(), Cr = sh.Cr;
  const int g = blockIdx.x / Cr;
  const int j = blockIdx.y, c0 = j * nt;
  const int np = pl.np;
  const eng::Layout lay = eng::layout(
      pl.L, nt, sh.R, 1, sizeof(typename eng::Raw<CF>::T), kRes, true, 0);
  const eng::Stage* stg = pl.stg;
  const eng::Pass* ps = pl.ps;
  auto* tbl = reinterpret_cast<typename eng::Raw<CF>::T*>(smem + lay.tbl);
  float* z = reinterpret_cast<float*>(smem + lay.tile);
  const CF cft = cf + (long)j * (nt >> 1);
  if (kRes) {
    eng::load_table(cft, n >> 1, pl.L, nt >> 1, tbl);
  }
  const int blocks = B / scale_rows;
  const int xcols = (in_w + nt - 1) / nt;
  float amax = 0.f;
  auto chunk = [&](int k, int* r0, int* rows, float* scale) {
    const int sb = g + k * sh.G;
    *r0 = sb * scale_rows + rho * sh.R;
    *rows = sh.R;
    // tiles wholly past in_w read no x and so no scale (no column)
    *scale = sb < blocks && c0 < in_w ? xs_scale[(long)sb * xcols + j] : 1.f;
    return sb < blocks;
  };
  auto sink = [&](const eng::Pass&, int) {
    eng::ToTileMax o{eng::Epi{d_out, bias, c0}, eng::Tile(z, nt), &amax};
    return o;
  };
  const int vecs = nt >> 4;  // 16-lane codes a row
  const unsigned magv = eng::magic((unsigned)vecs);
  auto finish = [&](int k, int r0, int rows) {
    // the block's absmax, then the cluster's from every block's slot
    float m = amax;
    for (int o = 16; o > 0; o >>= 1)
      m = spm_max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      float b = 0.f;
      for (int wi = 0; wi < (int)(blockDim.x >> 5); ++wi)
        b = spm_max_nan(b, warp_max[wi]);
      block_max[k & 1] = b;
    }
    cluster.sync();
    const int lane = threadIdx.x & 31;
    float a = lane < Cr ? *cluster.map_shared_rank(&block_max[k & 1], lane)
                        : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      a = spm_max_nan(a, __shfl_xor_sync(0xffffffffu, a, o));
    const float sy = spm_scale(a);
    const int sb = g + k * sh.G;
    if (rho == 0 && threadIdx.x == 0) ys[(long)sb * gridDim.y + j] = sy;
    // the codes, 16 lanes a store
    const eng::Tile tile(z, nt);
    for (int e = threadIdx.x; e < rows * vecs; e += blockDim.x) {
      const int r = spm_bwd::divm(e, vecs, magv);
      const int i = (e - r * vecs) << 4;
      float v[16];
#pragma unroll
      for (int h = 0; h < 4; ++h)
        eng::ld_vec<4>(tile.z + (long)r * nt + eng::swz(i + 4 * h, tile.mask),
                       v + 4 * h);
      int8_t* yr = y + (long)(r0 + r) * out_w + c0 + i;
      if (c0 + i + 16 <= out_w && ((long)(r0 + r) * out_w + c0 + i) % 16 == 0) {
        uint32_t wd[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          wd[q] = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            wd[q] |= (uint32_t)(uint8_t)spm_code(v[4 * q + b], sy) << (8 * b);
        }
        *reinterpret_cast<uint4*>(yr) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      } else {
        for (int q = 0; q < 16; ++q)
          if (c0 + i + q < out_w) yr[q] = spm_code(v[q], sy);
      }
    }
    amax = 0.f;
  };
  int8_t* xst = reinterpret_cast<int8_t*>(smem + lay.xst);
  if (kRes)
    eng::walk(stg, ps, np, eng::TablePairs<CF>{tbl, nt >> 1, 0, cft},
              eng::TableGlobal<CF>{cft, n >> 1}, xst, z, nt, 0, 0, false, x,
              in_w, c0, in_w, d_in, c0, chunk, sink, finish);
  else
    eng::walk(stg, ps, np, eng::TableGlobal<CF>{cft, n >> 1},
              eng::TableGlobal<CF>{cft, n >> 1}, xst, z, nt, 0, 0, false, x,
              in_w, c0, in_w, d_in, c0, chunk, sink, finish);
  cluster.sync();  // no block leaves while a peer may read its block_max
}

static inline int io_bytes(int io_type) {
  return io_type == SPM_IO_F32 ? 4 : io_type == SPM_IO_BF16 ? 2 : 1;
}

// The passes and shared memory of a launch shape (host side); false when
// the shape does not fit or its lanes cannot be split so.
static bool plan(const SpmStrides& st, int nt, int io_type, int cf_bytes,
                 const eng::Shape& sh, eng::Plan* pl, size_t* smem) {
  const bool q8 = io_type == SPM_IO_INT8;
  if (sh.C < 1 || sh.C > 8 || nt % sh.C || sh.Cr < 1 || sh.Cr > 8 ||
      sh.C * sh.Cr > 8 || (q8 && sh.C != 1) || (!q8 && sh.Cr != 1) ||
      sh.T < 32 || sh.T > eng::kMaxThreads || sh.T % 32 || sh.R < 1 ||
      sh.G < 1)
    return false;
  if (!eng::make_plan(st, nt, sh.C, sh.T, pl)) return false;
  *smem = eng::layout(st.n, nt / sh.C, sh.R, io_bytes(io_type), cf_bytes,
                      sh.resident, pl->np > 1 || q8, 0)
              .total;
  const size_t static_smem = q8 ? 34 * sizeof(float) : 0;
  return *smem + static_smem <= 232448;
}

template <typename T, typename CF, bool kRes>
static cudaError_t launch_stack(const void* x, void* y, CF cf,
                                const void* d_in, const void* d_out,
                                const void* bias, int B, int n, int nt,
                                int in_w, int out_w, int x_off, int E,
                                long cf_es, const eng::Shape& sh,
                                const SpmStrides& st, cudaStream_t stream) {
  eng::Plan pl;
  size_t smem;
  if (!plan(st, nt, sizeof(T) == 4 ? SPM_IO_F32 : SPM_IO_BF16,
            sizeof(typename eng::Raw<CF>::T), sh, &pl, &smem))
    return cudaErrorInvalidValue;
  static size_t smem_set = 0;  // largest dynamic shared memory opted into
  auto kernel = spm_stack_fwd_kernel<T, CF, kRes>;
  cudaError_t e = spm_allow_smem(kernel, smem, &smem_set);
  if (e != cudaSuccess) return e;
  return eng::launch(kernel, dim3(sh.G * sh.C, (out_w + nt - 1) / nt, E),
                     sh.T, smem, sh.C, stream, (const T*)x, (T*)y, cf,
                     (const float*)d_in, (const float*)d_out,
                     (const float*)bias, B, n, nt, in_w, out_w, x_off, cf_es,
                     sh, pl);
}

template <typename CF, bool kRes>
static cudaError_t launch_stack_q8(const void* x, const void* xs, void* y,
                                   void* ys, CF cf, const void* d_in,
                                   const void* d_out, const void* bias,
                                   int B, int n, int nt, int in_w,
                                   int out_w, int scale_rows,
                                   const eng::Shape& sh, const SpmStrides& st,
                                   cudaStream_t stream) {
  eng::Plan pl;
  size_t smem;
  if (!plan(st, nt, SPM_IO_INT8, sizeof(typename eng::Raw<CF>::T), sh, &pl,
            &smem) ||
      scale_rows <= 0 ||
      B % scale_rows || sh.R * sh.Cr != scale_rows || nt % 16)
    return cudaErrorInvalidValue;
  static size_t smem_set = 0;
  auto kernel = spm_stack_fwd_q8_kernel<CF, kRes>;
  cudaError_t e = spm_allow_smem(kernel, smem, &smem_set);
  if (e != cudaSuccess) return e;
  return eng::launch(kernel, dim3(sh.G * sh.Cr, (out_w + nt - 1) / nt), sh.T,
                     smem, sh.Cr, stream, (const int8_t*)x, (const float*)xs,
                     (int8_t*)y, (float*)ys, cf, (const float*)d_in,
                     (const float*)d_out, (const float*)bias, B, n, nt, in_w,
                     out_w, scale_rows, sh, pl);
}

template <typename CF, bool kRes>
static cudaError_t dispatch(int io_type, const void* x, const void* xs,
                            void* y, void* ys, CF cf, const void* d_in,
                            const void* d_out, const void* bias, int B,
                            int n, int nt, int in_w, int out_w, int x_off,
                            int scale_rows, int E, long cf_es,
                            const eng::Shape& sh, const SpmStrides& st,
                            cudaStream_t s) {
  if (io_type == SPM_IO_F32)
    return launch_stack<float, CF, kRes>(x, y, cf, d_in, d_out, bias, B, n,
                                         nt, in_w, out_w, x_off, E, cf_es,
                                         sh, st, s);
  if (io_type == SPM_IO_BF16)
    return launch_stack<__nv_bfloat16, CF, kRes>(x, y, cf, d_in, d_out,
                                                 bias, B, n, nt, in_w, out_w,
                                                 x_off, E, cf_es, sh, st, s);
  if (io_type == SPM_IO_INT8 && x_off == 0 && E == 1)
    return launch_stack_q8<CF, kRes>(x, xs, y, ys, cf, d_in, d_out, bias, B,
                                     n, nt, in_w, out_w, scale_rows, sh, st,
                                     s);
  return cudaErrorInvalidValue;
}

template <typename CF>
static cudaError_t dispatch_res(int io_type, const void* x, const void* xs,
                                void* y, void* ys, CF cf, const void* d_in,
                                const void* d_out, const void* bias, int B,
                                int n, int nt, int in_w, int out_w,
                                int x_off, int scale_rows, int E,
                                long cf_es, const eng::Shape& sh,
                                const SpmStrides& st, cudaStream_t s) {
  if (sh.resident)
    return dispatch<CF, true>(io_type, x, xs, y, ys, cf, d_in, d_out, bias,
                              B, n, nt, in_w, out_w, x_off, scale_rows, E,
                              cf_es, sh, st, s);
  return dispatch<CF, false>(io_type, x, xs, y, ys, cf, d_in, d_out, bias, B,
                             n, nt, in_w, out_w, x_off, scale_rows, E, cf_es,
                             sh, st, s);
}

// C interface (loaded with ctypes).  io_type SPM_IO_INT8 is the int8
// activation mode: x int8 with scales xs, y int8 with scales ys (both
// ignored otherwise).  cf_scale non-null marks an int8 coefficient table
// with one f32 scale a stage.  d_in / d_out / bias may be null.  x_off > 0
// is the windowed read (f32 / bf16 only): x (B, in_w) is read x_off
// columns on.  The launch shape (C lane blocks, Cr row blocks, T threads,
// R rows a chunk, G row groups, the table resident) is the planner's,
// kernels/spm_stack.py `fwd_plan`.  E > 1 is the expert mode (f32 / bf16
// I/O, f32 table, no window): x (E, B, in_w), y (E, B, out_w), expert e's
// table cf_es pairs after expert e-1's, its vectors n floats on.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int spm_stack_fwd(int io_type, const void* x, const void* xs,
                             void* y, void* ys, const void* cf,
                             const void* cf_scale, const void* d_in,
                             const void* d_out, const void* bias, int B,
                             int n, int nt, int in_w, int out_w, int x_off,
                             int scale_rows, int C, int Cr, int T, int R,
                             int G, int resident, const int* strides, int L,
                             int E, long cf_es, void* stream) {
  SpmStrides st;
  if (!spm_copy_strides(&st, strides, L) || B <= 0 || nt <= 0 || n % nt ||
      x_off < 0 || L < 1 || E < 1 || E > 65535 ||
      (E > 1 && (cf_scale || x_off || cf_es < (long)L * (n / 2))))
    return (int)cudaErrorInvalidValue;
  const eng::Shape sh{C, Cr, T, R, G, resident};
  cudaStream_t s = (cudaStream_t)stream;
  if (cf_scale)
    return (int)dispatch_res(
        io_type, x, xs, y, ys,
        SpmQCoeffs{(const char4*)cf, (const float*)cf_scale}, d_in, d_out,
        bias, B, n, nt, in_w, out_w, x_off, scale_rows, E, cf_es, sh, st, s);
  return (int)dispatch_res(io_type, x, xs, y, ys, (const float4*)cf, d_in,
                           d_out, bias, B, n, nt, in_w, out_w, x_off,
                           scale_rows, E, cf_es, sh, st, s);
}

// How many clusters of a launch shape the card holds at once
// (cudaOccupancyMaxActiveClusters; f32 table), 0 when the shape is refused.
extern "C" int spm_stack_fwd_clusters(int io_type, const int* strides, int L,
                                      int nt, int C, int Cr, int T, int R,
                                      int resident) {
  SpmStrides st;
  eng::Plan pl;
  size_t smem;
  const eng::Shape sh{C, Cr, T, R, 1, resident};
  if (!spm_copy_strides(&st, strides, L) ||
      !plan(st, nt, io_type, 16, sh, &pl, &smem))
    return 0;
  auto count = [&](auto kernel, int cluster) {
    return eng::clusters(kernel, T, smem, cluster);
  };
  if (io_type == SPM_IO_INT8)
    return resident ? count(spm_stack_fwd_q8_kernel<const float4*, true>, Cr)
                    : count(spm_stack_fwd_q8_kernel<const float4*, false>,
                            Cr);
  if (io_type == SPM_IO_F32)
    return resident ? count(spm_stack_fwd_kernel<float, const float4*, true>,
                            C)
                    : count(spm_stack_fwd_kernel<float, const float4*, false>,
                            C);
  return resident
             ? count(spm_stack_fwd_kernel<__nv_bfloat16, const float4*, true>,
                     C)
             : count(spm_stack_fwd_kernel<__nv_bfloat16, const float4*, false>,
                     C);
}
