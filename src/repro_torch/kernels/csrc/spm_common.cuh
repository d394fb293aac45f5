// Shared device code of the hand-written SPM kernels (K1 spm_stack.cu, K3
// spm_block.cu): I/O conversions and the in-shared-memory stage walk.
//
// Numerics: every product and sum of the stage walk and of the diagonal /
// bias epilogues is rounded on its own (__fmul_rn / __fadd_rn), so nvcc
// forms no fused multiply-add.  The kernels then round exactly where the
// plain PyTorch versions beside their wrappers round, which keeps the
// kernel-versus-plain comparison tight.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define SPM_MAX_STAGES 32

// Per-stage strides, passed by value as a kernel argument.
struct SpmStrides {
  int s[SPM_MAX_STAGES];
  int n;
};

enum SpmIoType { SPM_IO_F32 = 0, SPM_IO_BF16 = 1 };

__device__ __forceinline__ float spm_ld(const float* p) { return *p; }
__device__ __forceinline__ float spm_ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void spm_st(float* p, float v) { *p = v; }
__device__ __forceinline__ void spm_st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Apply the stages of `st` in place to the f32 tile `z` (rows x nt,
// row-major, in shared memory).  `cf` points at this tile's first pair in
// stage 0's coefficient slab; stage l's slab is `pair_stride` float4s
// further.  Pair p of a stride-s stage mixes lanes i0 = (p/s)*2s + p%s and
// i1 = i0 + s with (a, b, c, d) = cf[p]:  y0 = a x0 + b x1,  y1 = c x0 + d x1.
// One thread owns a pair for every row of the tile, so each coefficient is
// read once per block and reused across its rows.
__device__ __forceinline__ void spm_apply_stages(
    float* z, int rows, int nt, const float4* __restrict__ cf,
    long pair_stride, const SpmStrides& st) {
  const int half = nt >> 1;
  for (int l = 0; l < st.n; ++l) {
    const int s = st.s[l];
    const float4* cfl = cf + (long)l * pair_stride;
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      const float4 c = __ldg(cfl + p);
      const int g = p / s;
      const int i0 = g * 2 * s + (p - g * s);
      const int i1 = i0 + s;
      for (int r = 0; r < rows; ++r) {
        float* zr = z + (long)r * nt;
        const float x0 = zr[i0];
        const float x1 = zr[i1];
        zr[i0] = __fadd_rn(__fmul_rn(c.x, x0), __fmul_rn(c.y, x1));
        zr[i1] = __fadd_rn(__fmul_rn(c.z, x0), __fmul_rn(c.w, x1));
      }
    }
    __syncthreads();
  }
}

// Threads per block: one per pair up to 512, a whole number of warps.
static inline int spm_threads(int nt) {
  int t = ((nt / 2 + 31) / 32) * 32;
  if (t < 32) t = 32;
  return t > 512 ? 512 : t;
}

static inline bool spm_copy_strides(SpmStrides* st, const int* s, int L) {
  if (L < 0 || L > SPM_MAX_STAGES) return false;
  st->n = L;
  for (int i = 0; i < L; ++i) st->s[i] = s[i];
  return true;
}
