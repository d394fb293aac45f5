// K1: the fused SPM stage-stack forward, one planned run.
//
// Replaces the TPU kernel `_kernel` / `spm_stack_kernel_call` of
// src/repro/kernels/spm_stack.py (:157 / :338):
//
//     y = [D_out] (B_l ... B_1) [D_in] x [+ bias]
//
// on (block_rows, n_tile) tiles, with x zero-filled past `in_w` and the
// store masked to `out_w`.  Compute is f32; I/O is f32 or bf16.
//
// What bounds it on an H100: memory.  A stage costs 3 flops per element
// against 2-4 bytes of activation I/O per element for the whole run, so
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

#include "spm_common.cuh"

template <typename T>
__global__ void __launch_bounds__(512) spm_stack_fwd_kernel(
    const T* __restrict__ x, T* __restrict__ y,
    const float4* __restrict__ cf, const float* __restrict__ d_in,
    const float* __restrict__ d_out, const float* __restrict__ bias,
    int B, int n, int nt, int in_w, int out_w, int block_rows,
    SpmStrides st) {
  extern __shared__ float z[];
  const int row0 = blockIdx.x * block_rows;
  const int rows = min(block_rows, B - row0);
  const int c0 = blockIdx.y * nt;
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
  spm_apply_stages(z, rows, nt, cf + (long)blockIdx.y * (nt >> 1), n >> 1,
                   st);
  const int c_end = min(nt, out_w - c0);
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
}

template <typename T>
static cudaError_t launch_stack(const void* x, void* y, const void* cf,
                                const void* d_in, const void* d_out,
                                const void* bias, int B, int n, int nt,
                                int in_w, int out_w, int block_rows,
                                const SpmStrides& st, cudaStream_t stream) {
  static size_t smem_set = 0;  // largest dynamic shared memory opted into
  const size_t smem = (size_t)block_rows * nt * sizeof(float);
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        spm_stack_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  dim3 grid((B + block_rows - 1) / block_rows, (out_w + nt - 1) / nt);
  spm_stack_fwd_kernel<T><<<grid, spm_threads(nt), smem, stream>>>(
      (const T*)x, (T*)y, (const float4*)cf, (const float*)d_in,
      (const float*)d_out, (const float*)bias, B, n, nt, in_w, out_w,
      block_rows, st);
  return cudaGetLastError();
}

// C interface (loaded with ctypes).  Pointers d_in / d_out / bias may be
// null.  Returns the cudaError_t of the launch (0 on success).
extern "C" int spm_stack_fwd(int io_type, const void* x, void* y,
                             const void* cf, const void* d_in,
                             const void* d_out, const void* bias, int B,
                             int n, int nt, int in_w, int out_w,
                             int block_rows, const int* strides, int L,
                             void* stream) {
  SpmStrides st;
  if (!spm_copy_strides(&st, strides, L) || B <= 0 || block_rows <= 0 ||
      nt <= 0 || n % nt)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (io_type == SPM_IO_F32)
    return (int)launch_stack<float>(x, y, cf, d_in, d_out, bias, B, n, nt,
                                    in_w, out_w, block_rows, st, s);
  if (io_type == SPM_IO_BF16)
    return (int)launch_stack<__nv_bfloat16>(x, y, cf, d_in, d_out, bias, B,
                                            n, nt, in_w, out_w, block_rows,
                                            st, s);
  return (int)cudaErrorInvalidValue;
}
