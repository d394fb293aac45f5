// K3: the residual-block forward — RMS prologue, SPM stack 1, activation,
// SPM stack 2, residual add — for one block of rows at full width n <= 2048.
//
// Replaces the TPU kernel `_block_kernel` / `spm_block_kernel_call` of
// src/repro/kernels/spm_stack.py (:873 / :1028):
//
//   1. x masked to in_w;  rstd = rsqrt(sum(x^2) / in_w + eps)  (with gamma)
//   2. z = x * rstd * gamma;  stack 1: d_in1, stages, d_out1 [, bias1]
//   3. with a second stack (or an activation): mask to mid_w BEFORE the
//      activation (relu, silu, tanh-gelu), so dead lanes stay exact zeros
//   4. stack 2: d_in2, stages, d_out2 [, bias2]
//   5. [+ masked raw x], store to out_w;  rstd (B, 1) f32 is stored too
//
// Without a second stack this is the norm-prologue-only form that the
// fused q/k/v projections use.
//
// What bounds it on an H100: memory, as for K1 (a few flops per element
// and stage against 2-4 bytes of I/O per element).  The whole row block
// stays in shared memory as f32 from the load to the store, so x is read
// once (once more for the residual, from L2) and y written once; each
// thread owns one pair for every row of the block, so coefficients are
// read once per block.  The row statistics are a warp reduction per row.

#include "spm_common.cuh"

template <typename T>
__global__ void __launch_bounds__(512) spm_block_fwd_kernel(
    const T* __restrict__ x, T* __restrict__ y, float* __restrict__ rstd_out,
    const float* __restrict__ gamma, const float4* __restrict__ cf1,
    const float* __restrict__ din1, const float* __restrict__ dout1,
    const float* __restrict__ bias1, const float4* __restrict__ cf2,
    const float* __restrict__ din2, const float* __restrict__ dout2,
    const float* __restrict__ bias2, int B, int n, int in_w, int mid_w,
    int out_w, int block_rows, int act, int residual, float eps,
    SpmStrides st1, SpmStrides st2) {
  extern __shared__ float smem[];
  float* rs = smem;                                  // per-row rstd
  float* z = smem + ((block_rows + 3) & ~3);         // rows x n tile
  const int row0 = blockIdx.x * block_rows;
  const int rows = min(block_rows, B - row0);
  const bool two = cf2 != nullptr;

  for (int r = 0; r < rows; ++r) {
    const T* xr = x + (long)(row0 + r) * in_w;
    float* zr = z + (long)r * n;
    for (int c = threadIdx.x; c < n; c += blockDim.x)
      zr[c] = c < in_w ? spm_ld(xr + c) : 0.f;
  }
  __syncthreads();

  if (gamma) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    for (int r = warp; r < rows; r += n_warps) {
      const float* zr = z + (long)r * n;
      float acc = 0.f;
      for (int c = lane; c < in_w; c += 32)
        acc = __fadd_rn(acc, __fmul_rn(zr[c], zr[c]));
      for (int off = 16; off > 0; off >>= 1)
        acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
      if (lane == 0) {
        const float rsd = rsqrtf(__fadd_rn(__fdiv_rn(acc, (float)in_w), eps));
        rs[r] = rsd;
        rstd_out[row0 + r] = rsd;
      }
    }
    __syncthreads();
  }

  for (int r = 0; r < rows; ++r) {
    float* zr = z + (long)r * n;
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      float v = zr[c];
      if (gamma) v = __fmul_rn(__fmul_rn(v, rs[r]), gamma[c]);
      zr[c] = __fmul_rn(v, din1[c]);
    }
  }
  __syncthreads();
  spm_apply_stages(z, rows, n, cf1, n >> 1, st1);

  for (int r = 0; r < rows; ++r) {
    float* zr = z + (long)r * n;
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      float v = __fmul_rn(zr[c], dout1[c]);
      if (bias1) v = __fadd_rn(v, bias1[c]);
      if (two || act != ACT_NONE) v = spm_act(c < mid_w ? v : 0.f, act);
      if (two) v = __fmul_rn(v, din2[c]);
      zr[c] = v;
    }
  }
  __syncthreads();
  if (two) spm_apply_stages(z, rows, n, cf2, n >> 1, st2);

  for (int r = 0; r < rows; ++r) {
    const T* xr = x + (long)(row0 + r) * in_w;
    T* yr = y + (long)(row0 + r) * out_w;
    const float* zr = z + (long)r * n;
    for (int c = threadIdx.x; c < out_w; c += blockDim.x) {
      float v = zr[c];
      if (two) {
        v = __fmul_rn(v, dout2[c]);
        if (bias2) v = __fadd_rn(v, bias2[c]);
      }
      if (residual && c < in_w) v = __fadd_rn(v, spm_ld(xr + c));
      spm_st(yr + c, v);
    }
  }
}

template <typename T>
static cudaError_t launch_block(const void* x, void* y, void* rstd,
                                const void* gamma, const void* cf1,
                                const void* din1, const void* dout1,
                                const void* bias1, const void* cf2,
                                const void* din2, const void* dout2,
                                const void* bias2, int B, int n, int in_w,
                                int mid_w, int out_w, int block_rows, int act,
                                int residual, float eps,
                                const SpmStrides& st1, const SpmStrides& st2,
                                cudaStream_t stream) {
  static size_t smem_set = 0;  // largest dynamic shared memory opted into
  const size_t smem =
      ((size_t)((block_rows + 3) & ~3) + (size_t)block_rows * n) *
      sizeof(float);
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        spm_block_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  dim3 grid((B + block_rows - 1) / block_rows);
  spm_block_fwd_kernel<T><<<grid, spm_threads(n), smem, stream>>>(
      (const T*)x, (T*)y, (float*)rstd, (const float*)gamma,
      (const float4*)cf1, (const float*)din1, (const float*)dout1,
      (const float*)bias1, (const float4*)cf2, (const float*)din2,
      (const float*)dout2, (const float*)bias2, B, n, in_w, mid_w, out_w,
      block_rows, act, residual, eps, st1, st2);
  return cudaGetLastError();
}

// C interface (loaded with ctypes).  gamma/rstd, bias1, and the whole
// second stack (cf2, din2, dout2, bias2) may be null.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int spm_block_fwd(int io_type, const void* x, void* y, void* rstd,
                             const void* gamma, const void* cf1,
                             const void* din1, const void* dout1,
                             const void* bias1, const void* cf2,
                             const void* din2, const void* dout2,
                             const void* bias2, int B, int n, int in_w,
                             int mid_w, int out_w, int block_rows, int act,
                             int residual, float eps, const int* strides1,
                             int L1, const int* strides2, int L2,
                             void* stream) {
  SpmStrides st1, st2;
  if (!spm_copy_strides(&st1, strides1, L1) ||
      !spm_copy_strides(&st2, strides2, cf2 ? L2 : 0) || B <= 0 ||
      block_rows <= 0 || (gamma != nullptr) != (rstd != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (io_type == SPM_IO_F32)
    return (int)launch_block<float>(x, y, rstd, gamma, cf1, din1, dout1,
                                    bias1, cf2, din2, dout2, bias2, B, n,
                                    in_w, mid_w, out_w, block_rows, act,
                                    residual, eps, st1, st2, s);
  if (io_type == SPM_IO_BF16)
    return (int)launch_block<__nv_bfloat16>(
        x, y, rstd, gamma, cf1, din1, dout1, bias1, cf2, din2, dout2, bias2,
        B, n, in_w, mid_w, out_w, block_rows, act, residual, eps, st1, st2,
        s);
  return (int)cudaErrorInvalidValue;
}
