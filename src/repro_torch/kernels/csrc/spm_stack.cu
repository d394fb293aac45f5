// K1: the fused SPM stage-stack forward, one planned run.
//
// Replaces the TPU kernel `_kernel` / `spm_stack_kernel_call` of
// src/repro/kernels/spm_stack.py (:157 / :338), with `_apply_stages_fwd`
// (:130):
//
//     y = [D_out] (B_l ... B_1) [D_in] x [+ bias]
//
// on (block_rows, n_tile) tiles, with x zero-filled past `in_w` and the
// store masked to `out_w`.  Compute is f32; I/O is f32 or bf16, or int8
// (below).  The coefficient table is f32, or int8 with one scale a stage,
// dequantized on load (spm_common.cuh).
//
// What bounds it on an H100: memory.  A stage costs 3 flops per element
// against 1-4 bytes of activation I/O per element for the whole run, so
// the run is bound by (x bytes + y bytes + coefficient bytes) / 3.35 TB/s.
// The design keeps the whole tile in shared memory as f32 for all stages
// of the run (one read and one write of the activation per run, as on the
// TPU), and gives each thread one pair for every row of the tile so a
// coefficient is read once per block.  At decode rows the coefficient
// table dominates the bytes; this first version does not split it across
// SMs (see PERF.md).
//
// Grid: (ceil(B / block_rows), ceil(out_w / n_tile)).  The row tail and the
// output edge are masked here: no padded copies.
//
// Windowed read (the reference's `col_base`, :393-454, the feature-sharded
// executor's first local run): x is the whole (B, in_w) operand shared by
// the shards, in_w the global width, and tile j reads x's columns
// x_off + j*nt + c, zero from in_w on; the table, d_in / d_out / bias, y
// and the grid (n / nt tiles, out_w = n) are the shard's own.  Only x's
// column and its mask move by x_off, so a shard whose window lies wholly
// past in_w reads no x at all and stores exactly bias (or zero).  The TPU
// kernel clamps a block past the operand's edge onto the last valid one
// and masks it; here the load itself is under the mask.
//
// Int8 activation I/O (the reference's `x_scale` and `quant_out`, which
// the fused path uses together): x is int8 with one f32 scale for each
// (scale_rows, n_tile) block, dequantized on load, and the result is
// requantized on the store with its own block scale absmax / 127 + 1e-12.
// A scale block (64 x 2048 f32 at the training shapes, 512 KiB) outgrows
// one block's shared memory, so it is shared by a thread-block cluster of
// scale_rows / block_rows blocks (at most 8, the portable size): each
// block reduces its tile's absmax in shared memory, the blocks exchange
// these through distributed shared memory, and every block codes its own
// rows with the cluster's scale; the cluster's first block stores the
// scale.  The absmax covers all n_tile lanes, the ones past out_w that the
// store drops included, as the reference takes it before its masked store.
// Max is order-free, so the scale is exact whatever the order.  A NaN or
// Inf in the block reaches the scale (spm_max_nan), so the block
// dequantizes to NaN, as the plain version's torch.amax gives.

#include <cooperative_groups.h>

#include "spm_common.cuh"

namespace cg = cooperative_groups;

// One kernel for both stores.  Q8 = false: T is f32 or bf16, the store is
// masked to out_w, and x is read x_off columns on (the windowed read; 0
// otherwise).  Q8 = true: T is int8, x is dequantized on load with
// its block's scale from xs (B / scale_rows, ceil(in_w / nt)), the launch
// is in clusters of scale_rows / block_rows blocks along x, B is a
// multiple of scale_rows (the caller pads rows), and the store requantizes
// with the cluster's scale, written to ys (B / scale_rows, gridDim.y).
template <typename T, typename CF, bool Q8>
__global__ void __launch_bounds__(512) spm_stack_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ xs, T* __restrict__ y,
    float* __restrict__ ys, CF cf, const float* __restrict__ d_in,
    const float* __restrict__ d_out, const float* __restrict__ bias, int B,
    int n, int nt, int in_w, int out_w, int x_off, int block_rows,
    int scale_rows, SpmStrides st) {
  extern __shared__ float z[];
  const int row0 = blockIdx.x * block_rows;
  const int rows = min(block_rows, B - row0);
  const int j = blockIdx.y;
  const int c0 = j * nt;
  const long sblk = Q8 ? row0 / scale_rows : 0;
  float sx = 1.f;  // the x block's scale (int8 x only)
  // tiles wholly past in_w read no x and so no scale (it has no column)
  if (Q8 && c0 < in_w) sx = xs[sblk * ((in_w + nt - 1) / nt) + j];
  for (int r = 0; r < rows; ++r) {
    const T* xr = x + (long)(row0 + r) * in_w;
    float* zr = z + (long)r * nt;
    for (int c = threadIdx.x; c < nt; c += blockDim.x) {
      const int gc = c0 + c;
      const int xc = x_off + gc;  // x's own column (global when windowed)
      float v = xc < in_w ? spm_ldq(xr + xc, sx) : 0.f;
      if (d_in) v = __fmul_rn(v, d_in[gc]);
      zr[c] = v;
    }
  }
  __syncthreads();
  spm_apply_stages(z, rows, nt, cf + (long)j * (nt >> 1), n >> 1, st);
  const int c_end = min(nt, out_w - c0);
  if constexpr (!Q8) {
    for (int r = 0; r < rows; ++r) {
      T* yr = y + (long)(row0 + r) * out_w;
      const float* zr = z + (long)r * nt;
      for (int c = threadIdx.x; c < c_end; c += blockDim.x) {
        const int gc = c0 + c;
        float v = zr[c];
        if (d_out) v = __fmul_rn(v, d_out[gc]);
        if (bias) v = __fadd_rn(v, bias[gc]);
        spm_st(yr + gc, v);
      }
    }
  } else {
    __shared__ float warp_max[16];
    __shared__ float block_max;
    __shared__ float scale;
    cg::cluster_group cluster = cg::this_cluster();
    // epilogue on every lane of the tile, and this block's absmax
    float m = 0.f;
    for (int r = 0; r < rows; ++r) {
      float* zr = z + (long)r * nt;
      for (int c = threadIdx.x; c < nt; c += blockDim.x) {
        const int gc = c0 + c;
        float v = zr[c];
        if (d_out) v = __fmul_rn(v, d_out[gc]);
        if (bias) v = __fadd_rn(v, bias[gc]);
        zr[c] = v;
        m = spm_max_nan(m, fabsf(v));
      }
    }
    for (int o = 16; o > 0; o >>= 1)
      m = spm_max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      float b = 0.f;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
        b = spm_max_nan(b, warp_max[w]);
      block_max = b;
    }
    // the cluster's absmax from every block's shared memory
    cluster.sync();
    if (threadIdx.x == 0) {
      float a = 0.f;
      for (unsigned k = 0; k < cluster.num_blocks(); ++k)
        a = spm_max_nan(a, *cluster.map_shared_rank(&block_max, k));
      scale = spm_scale(a);
      if (cluster.block_rank() == 0) ys[sblk * gridDim.y + j] = scale;
    }
    // no block leaves (or reuses block_max) while a peer may still read it
    cluster.sync();
    const float sy = scale;
    for (int r = 0; r < rows; ++r) {
      T* yr = y + (long)(row0 + r) * out_w;
      const float* zr = z + (long)r * nt;
      for (int c = threadIdx.x; c < c_end; c += blockDim.x)
        yr[c0 + c] = spm_code(zr[c], sy);
    }
  }
}

template <typename T, typename CF>
static cudaError_t launch_stack(const void* x, void* y, CF cf,
                                const void* d_in, const void* d_out,
                                const void* bias, int B, int n, int nt,
                                int in_w, int out_w, int x_off,
                                int block_rows, const SpmStrides& st,
                                cudaStream_t stream) {
  static size_t smem_set = 0;  // largest dynamic shared memory opted into
  const size_t smem = (size_t)block_rows * nt * sizeof(float);
  cudaError_t e = spm_allow_smem(spm_stack_fwd_kernel<T, CF, false>, smem,
                                 &smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((B + block_rows - 1) / block_rows, (out_w + nt - 1) / nt);
  spm_stack_fwd_kernel<T, CF, false>
      <<<grid, spm_threads(nt), smem, stream>>>(
          (const T*)x, nullptr, (T*)y, nullptr, cf, (const float*)d_in,
          (const float*)d_out, (const float*)bias, B, n, nt, in_w, out_w,
          x_off, block_rows, 0, st);
  return cudaGetLastError();
}

template <typename CF>
static cudaError_t launch_stack_q8(const void* x, const void* xs, void* y,
                                   void* ys, CF cf, const void* d_in,
                                   const void* d_out, const void* bias,
                                   int B, int n, int nt, int in_w,
                                   int out_w, int block_rows, int scale_rows,
                                   const SpmStrides& st,
                                   cudaStream_t stream) {
  const int csize = scale_rows / block_rows;
  if (scale_rows % block_rows || csize < 1 || csize > 8 || B % scale_rows)
    return cudaErrorInvalidValue;
  static size_t smem_set = 0;
  const size_t smem = (size_t)block_rows * nt * sizeof(float);
  cudaError_t e = spm_allow_smem(spm_stack_fwd_kernel<int8_t, CF, true>,
                                 smem, &smem_set);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B / block_rows, (out_w + nt - 1) / nt);
  cfg.blockDim = dim3(spm_threads(nt));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, spm_stack_fwd_kernel<int8_t, CF, true>,
                         (const int8_t*)x, (const float*)xs, (int8_t*)y,
                         (float*)ys, cf, (const float*)d_in,
                         (const float*)d_out, (const float*)bias, B, n, nt,
                         in_w, out_w, 0, block_rows, scale_rows, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename CF>
static cudaError_t dispatch(int io_type, const void* x, const void* xs,
                            void* y, void* ys, CF cf, const void* d_in,
                            const void* d_out, const void* bias, int B,
                            int n, int nt, int in_w, int out_w, int x_off,
                            int block_rows, int scale_rows,
                            const SpmStrides& st, cudaStream_t s) {
  if (io_type == SPM_IO_F32)
    return launch_stack<float>(x, y, cf, d_in, d_out, bias, B, n, nt, in_w,
                               out_w, x_off, block_rows, st, s);
  if (io_type == SPM_IO_BF16)
    return launch_stack<__nv_bfloat16>(x, y, cf, d_in, d_out, bias, B, n,
                                       nt, in_w, out_w, x_off, block_rows,
                                       st, s);
  if (io_type == SPM_IO_INT8 && x_off == 0)
    return launch_stack_q8(x, xs, y, ys, cf, d_in, d_out, bias, B, n, nt,
                           in_w, out_w, block_rows, scale_rows, st, s);
  return cudaErrorInvalidValue;
}

// C interface (loaded with ctypes).  io_type SPM_IO_INT8 is the int8
// activation mode: x int8 with scales xs, y int8 with scales ys (both
// ignored otherwise).  cf_scale non-null marks an int8 coefficient table
// with one f32 scale a stage.  d_in / d_out / bias may be null.  x_off > 0
// is the windowed read (f32 / bf16 only): x (B, in_w) is read x_off
// columns on.  Returns the cudaError_t of the launch (0 on success).
extern "C" int spm_stack_fwd(int io_type, const void* x, const void* xs,
                             void* y, void* ys, const void* cf,
                             const void* cf_scale, const void* d_in,
                             const void* d_out, const void* bias, int B,
                             int n, int nt, int in_w, int out_w, int x_off,
                             int block_rows, int scale_rows,
                             const int* strides, int L, void* stream) {
  SpmStrides st;
  if (!spm_copy_strides(&st, strides, L) || B <= 0 || block_rows <= 0 ||
      nt <= 0 || n % nt || x_off < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cf_scale)
    return (int)dispatch(io_type, x, xs, y, ys,
                         SpmQCoeffs{(const char4*)cf, (const float*)cf_scale},
                         d_in, d_out, bias, B, n, nt, in_w, out_w, x_off,
                         block_rows, scale_rows, st, s);
  return (int)dispatch(io_type, x, xs, y, ys, (const float4*)cf, d_in, d_out,
                       bias, B, n, nt, in_w, out_w, x_off, block_rows,
                       scale_rows, st, s);
}
