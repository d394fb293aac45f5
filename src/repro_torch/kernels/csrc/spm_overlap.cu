// K5: one {shard-local run -> cross stage} pair of the feature-sharded
// executor, over every shard of a mesh on one device.
//
// Replaces the TPU kernel `_overlap_kernel` / `spm_overlap_kernel_call` of
// src/repro/kernels/spm_stack.py (:1319 / :1382).  For shard j and its
// partner p = j ^ k:
//
//     z_j = (B_l ... B_1) [D_in] x_j          (x_j: j's lanes of x, f32)
//     y_j = mix_a_j * io(z_j) + mix_b_j * io(z_p)  [* d_out_j] [+ bias_j]
//
// io() is the rounding to the I/O type (the slab a shard sends), the mix
// is f32 with d_out applied after the add (the reference's scale-on-store
// order, :1353-1367), and y is rounded once on the store.  mix_a / mix_b
// are the role-resolved cross coefficients the caller passes ((a, b) on
// the low partner, (d, c) on the high), so the kernel is role-free.
//
// The exchange.  The TPU kernel sends each row block to the partner chip
// over ICI with double-buffered slots, credits and a drain.  Here every
// shard is on this device, and the two partners of a pair are the two
// blocks of a thread-block cluster: cluster m along grid x holds shards
// with bit log2(k) equal to its rank and the other bits m's, so the
// cluster's blocks are j and j ^ k on the same rows and feature tile.
// Each block runs its shard's stages on an f32 tile in shared memory,
// rounds the result into a send slot in shared memory, and after a
// cluster barrier reads the partner's slot through distributed shared
// memory for the mix.  A second barrier keeps a block resident until its
// partner has read its slot.  The local result never reaches device
// memory; nothing is sent that the TPU kernel would not send.
//
// x is the global (B, in_w) operand: shard j's lane c of feature tile t is
// column j * n_local + t * nt + c, read as zero from in_w on (the windowed
// read of a rectangular first run is the same read).  y is the global
// (B, n) output; the (n,) vectors are read at the same global column.  The
// tables are stacked per shard, (S, L, n_local/2, 4), f32 or int8 with
// (S, L) stage scales (spm_common.cuh).
//
// What bounds it on an H100: memory, as K1 (x read once, y written once,
// the tables read once per block; the stages are 3 flops per element).  The
// partner's slab moves over the SM-to-SM network inside a GPC, never
// through device memory.  Grid: (S, ceil(B / block_rows), n_local / nt),
// clusters of 2 along x.

#include <cooperative_groups.h>

#include "spm_common.cuh"

namespace cg = cooperative_groups;

template <typename T, typename CF>
__global__ void __launch_bounds__(512) spm_overlap_fwd_kernel(
    const T* __restrict__ x, T* __restrict__ y, CF cf,
    const float* __restrict__ mix_a, const float* __restrict__ mix_b,
    const float* __restrict__ d_in, const float* __restrict__ d_out,
    const float* __restrict__ bias, int B, int n_local, int nt, int in_w,
    int n, int kbit, int block_rows, SpmStrides st) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int shard = spm_pair_shard(blockIdx.x >> 1, (int)rank, kbit);
  const int row0 = blockIdx.y * block_rows;
  const int rows = min(block_rows, B - row0);
  const int c0 = shard * n_local + blockIdx.z * nt;  // lane 0's column
  const long half = n_local >> 1;
  float* z = smem;
  T* slot = reinterpret_cast<T*>(smem + (long)block_rows * nt);

  for (int r = 0; r < rows; ++r) {
    const T* xr = x + (long)(row0 + r) * in_w;
    float* zr = z + (long)r * nt;
    for (int c = threadIdx.x; c < nt; c += blockDim.x) {
      const int gc = c0 + c;
      float v = gc < in_w ? spm_ld(xr + gc) : 0.f;
      if (d_in) v = __fmul_rn(v, d_in[gc]);
      zr[c] = v;
    }
  }
  __syncthreads();
  spm_apply_stages(z, rows, nt,
                   spm_cf_shard(cf, shard, st.n, half) +
                       (long)blockIdx.z * (nt >> 1),
                   half, st);
  // the slab this shard sends, rounded to the I/O type
  for (int i = threadIdx.x; i < rows * nt; i += blockDim.x)
    spm_st(slot + i, z[i]);
  cluster.sync();  // both slots written
  const T* peer = cluster.map_shared_rank(slot, rank ^ 1u);
  for (int r = 0; r < rows; ++r) {
    T* yr = y + (long)(row0 + r) * n;
    for (int c = threadIdx.x; c < nt; c += blockDim.x) {
      const int gc = c0 + c;
      const long i = (long)r * nt + c;
      float v = __fadd_rn(__fmul_rn(mix_a[gc], spm_ld(slot + i)),
                          __fmul_rn(mix_b[gc], spm_ld(peer + i)));
      if (d_out) v = __fmul_rn(v, d_out[gc]);
      if (bias) v = __fadd_rn(v, bias[gc]);
      spm_st(yr + gc, v);
    }
  }
  cluster.sync();  // the partner has read this block's slot
}

template <typename T, typename CF>
static cudaError_t launch_overlap(const void* x, void* y, CF cf,
                                  const void* mix_a, const void* mix_b,
                                  const void* d_in, const void* d_out,
                                  const void* bias, int B, int S,
                                  int n_local, int nt, int in_w, int kbit,
                                  int block_rows, const SpmStrides& st,
                                  cudaStream_t stream) {
  static size_t smem_set = 0;
  const size_t smem = (size_t)block_rows * nt * (sizeof(float) + sizeof(T));
  cudaError_t e =
      spm_allow_smem(spm_overlap_fwd_kernel<T, CF>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, (B + block_rows - 1) / block_rows, n_local / nt);
  cfg.blockDim = dim3(spm_threads(nt));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, spm_overlap_fwd_kernel<T, CF>, (const T*)x,
                         (T*)y, cf, (const float*)mix_a,
                         (const float*)mix_b, (const float*)d_in,
                         (const float*)d_out, (const float*)bias, B, n_local,
                         nt, in_w, S * n_local, kbit, block_rows, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename CF>
static cudaError_t dispatch(int io_type, const void* x, void* y, CF cf,
                            const void* mix_a, const void* mix_b,
                            const void* d_in, const void* d_out,
                            const void* bias, int B, int S, int n_local,
                            int nt, int in_w, int kbit, int block_rows,
                            const SpmStrides& st, cudaStream_t s) {
  if (io_type == SPM_IO_F32)
    return launch_overlap<float>(x, y, cf, mix_a, mix_b, d_in, d_out, bias,
                                 B, S, n_local, nt, in_w, kbit, block_rows,
                                 st, s);
  if (io_type == SPM_IO_BF16)
    return launch_overlap<__nv_bfloat16>(x, y, cf, mix_a, mix_b, d_in,
                                         d_out, bias, B, S, n_local, nt,
                                         in_w, kbit, block_rows, st, s);
  return cudaErrorInvalidValue;
}

// C interface (loaded with ctypes).  x (B, in_w) and y (B, S * n_local) of
// type io_type (f32 or bf16); cf the stacked tables (S, L, n_local/2, 4),
// f32, or int8 when cf_scale (S, L) f32 is given; mix_a and mix_b (n,) f32;
// d_in / d_out / bias (n,) f32 or null.  Shard j pairs with j ^ (1 <<
// kbit).  Returns the cudaError_t of the launch (0 on success).
extern "C" int spm_overlap_fwd(int io_type, const void* x, void* y,
                               const void* cf, const void* cf_scale,
                               const void* mix_a, const void* mix_b,
                               const void* d_in, const void* d_out,
                               const void* bias, int B, int S, int n_local,
                               int nt, int in_w, int kbit, int block_rows,
                               const int* strides, int L, void* stream) {
  SpmStrides st;
  if (!spm_copy_strides(&st, strides, L) || B <= 0 || block_rows <= 0 ||
      nt <= 0 || n_local % nt || S < 2 || kbit < 0 ||
      S % (2 << kbit) || in_w <= 0 || in_w > S * n_local || !mix_a ||
      !mix_b)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cf_scale)
    return (int)dispatch(io_type, x, y,
                         SpmQCoeffs{(const char4*)cf, (const float*)cf_scale},
                         mix_a, mix_b, d_in, d_out, bias, B, S, n_local, nt,
                         in_w, kbit, block_rows, st, s);
  return (int)dispatch(io_type, x, y, (const float4*)cf, mix_a, mix_b, d_in,
                       d_out, bias, B, S, n_local, nt, in_w, kbit,
                       block_rows, st, s);
}
