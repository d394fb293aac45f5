// Shared device code of the hand-written SPM kernels (K1 spm_stack.cu, K2
// spm_stack_bwd.cu, K3 spm_block.cu, K4 spm_block_bwd.cu, K5
// spm_overlap.cu, K6 spm_overlap_bwd.cu): I/O conversions, the coefficient
// tables (f32, or int8 with per-stage scales), the block kernels'
// activation and its derivative, and the ordered sum of per-block
// partials.  The stage walks themselves are the engines'
// (spm_fwd_engine.cuh: K1, K3, K5; spm_bwd_engine.cuh: K2, K4, K6).
//
// Numerics: every product and sum of the stage walk and of the diagonal /
// bias epilogues is rounded on its own (__fmul_rn / __fadd_rn), so nvcc
// forms no fused multiply-add.  The kernels then round exactly where the
// plain PyTorch versions beside their wrappers round, which keeps the
// kernel-versus-plain comparison tight.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SPM_MAX_STAGES 32

// Per-stage strides, passed by value as a kernel argument.
struct SpmStrides {
  int s[SPM_MAX_STAGES];
  int n;
};

// SPM_IO_INT8: int8 activations with per-block scales (K1, K2).
enum SpmIoType { SPM_IO_F32 = 0, SPM_IO_BF16 = 1, SPM_IO_INT8 = 2 };

__device__ __forceinline__ float spm_ld(const float* p) { return *p; }
__device__ __forceinline__ float spm_ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void spm_st(float* p, float v) { *p = v; }
__device__ __forceinline__ void spm_st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// An int8 activation: its code times its block's scale, one rounding, as
// kernels/quant.py dequantizes.  Other types ignore the scale.
__device__ __forceinline__ float spm_ldq(const int8_t* p, float scale) {
  return __fmul_rn((float)*p, scale);
}
template <typename T>
__device__ __forceinline__ float spm_ldq(const T* p, float) {
  return spm_ld(p);
}

// The int8 code of v in a block of scale `scale`: round half to even of the
// IEEE quotient, clipped to +-127, and 0 where the quotient is NaN (a NaN or
// infinite block), as kernels/quant.py and the reference's cast give.
__device__ __forceinline__ int8_t spm_code(float v, float scale) {
  const float q = rintf(__fdiv_rn(v, scale));
  if (q != q) return 0;
  return (int8_t)fminf(fmaxf(q, -127.f), 127.f);
}

// The larger of two magnitudes, NaN if either is NaN, as torch.amax and
// jnp.max reduce (fmaxf would drop the NaN).  A block's absmax folds
// fabsf of every lane through it, so a NaN or Inf in the block reaches
// the scale and poisons the block's dequantized values.
__device__ __forceinline__ float spm_max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// The scale of a block whose largest magnitude is `absmax`.
__device__ __forceinline__ float spm_scale(float absmax) {
  return __fadd_rn(__fdiv_rn(absmax, 127.f), 1e-12f);
}

// Coefficient tables.  An f32 table is a `const float4*` of (a, b, c, d)
// per pair.  An int8 table is a SpmQCoeffs: char4 codes per pair and one
// f32 scale per stage, dequantized on load with one rounded multiply per
// coefficient, which is kernels/quant.py's dequantize_coeffs.  Both are
// read through spm_cf(table, stage, pair index) and moved to a tile's first
// pair with `+`.
struct SpmQCoeffs {
  const char4* q;
  const float* scale;  // (L,) of the run
  __host__ __device__ SpmQCoeffs operator+(long pairs) const {
    return SpmQCoeffs{q + pairs, scale};
  }
};

// Shard `j`'s table in a stack of per-shard tables (S, L, pairs, 4), each
// shard's L stages `pairs` apart (K5, K6): an int8 stack also moves to the
// shard's row of the (S, L) scales.
__device__ __forceinline__ const float4* spm_cf_shard(const float4* cf,
                                                      int j, int L,
                                                      long pairs) {
  return cf + (long)j * L * pairs;
}
__device__ __forceinline__ SpmQCoeffs spm_cf_shard(const SpmQCoeffs& cf,
                                                   int j, int L,
                                                   long pairs) {
  return SpmQCoeffs{cf.q + (long)j * L * pairs, cf.scale + (long)j * L};
}

// The shard of cluster rank r in cluster m for the partner distance
// 2^kbit: bit kbit of the shard index is r, the bits below and above it
// are m's.  The two ranks of a cluster are partners.
__device__ __forceinline__ int spm_pair_shard(int m, int r, int kbit) {
  const int low = m & ((1 << kbit) - 1);
  return ((m >> kbit) << (kbit + 1)) | (r << kbit) | low;
}

__device__ __forceinline__ float4 spm_cf(const float4* cf, int, long i) {
  return __ldg(cf + i);
}
__device__ __forceinline__ float4 spm_cf(const SpmQCoeffs& cf, int l,
                                         long i) {
  const char4 v = __ldg(cf.q + i);
  const float s = __ldg(cf.scale + l);
  return make_float4(__fmul_rn((float)v.x, s), __fmul_rn((float)v.y, s),
                     __fmul_rn((float)v.z, s), __fmul_rn((float)v.w, s));
}

enum SpmAct { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

// The block kernels' activation (K3's epilogue, K4's remat), with 0 -> 0,
// which the dead-lane masking relies on; gelu is the tanh approximation,
// as jax.nn.gelu's default.
__device__ __forceinline__ float spm_act(float u, int act) {
  if (act == ACT_RELU) return fmaxf(u, 0.f);
  if (act == ACT_SILU) return __fmul_rn(u, 1.f / (1.f + expf(-u)));
  if (act == ACT_GELU) {
    const float k = 0.7978845608028654f;
    const float inner = k * (u + 0.044715f * u * u * u);
    return 0.5f * u * (1.f + tanhf(inner));
  }
  return u;
}

// Its derivative (K4), as the reference's `_act_grad` writes it.
__device__ __forceinline__ float spm_act_grad(float u, int act) {
  if (act == ACT_RELU) return u > 0.f ? 1.f : 0.f;
  if (act == ACT_SILU) {
    const float sg = 1.f / (1.f + expf(-u));
    return sg * (1.f + u * (1.f - sg));
  }
  if (act == ACT_GELU) {
    const float k = 0.7978845608028654f;
    const float t = tanhf(k * (u + 0.044715f * u * u * u));
    return 0.5f * (1.f + t) +
           0.5f * u * (1.f - t * t) * k * (1.f + 3.f * 0.044715f * u * u);
  }
  return 1.f;
}

// The deterministic finish of a cross-block sum: out[o][e] = sum over
// g = 0 .. G-1, in that order, of part[g][o][e] for e < live, and exactly
// 0 for e >= live (feature tiles no block visited).  part is (G, outer,
// inner) f32, out (outer, inner); with `batches` > 1 (K2's expert mode)
// part is (batches, G, outer, inner) and out (batches, outer, inner), each
// batch summed on its own.  No atomics: two launches on the same partials
// give bitwise equal sums.
static __global__ void spm_sum_partials(const float* __restrict__ part,
                                        float* __restrict__ out, int G,
                                        int outer, long inner, long live,
                                        int batches) {
  const long total = (long)outer * inner;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
       i < total * batches; i += (long)gridDim.x * blockDim.x) {
    const long b = i / total, t = i - b * total;
    const long e = t % inner;
    const float* pb = part + b * G * total + t;
    float acc = 0.f;
    if (e < live)
      for (int g = 0; g < G; ++g) acc = __fadd_rn(acc, pb[g * total]);
    out[i] = acc;
  }
}

static inline cudaError_t spm_launch_sum(const float* part, float* out,
                                         int G, int outer, long inner,
                                         long live, cudaStream_t stream,
                                         int batches = 1) {
  const long total = (long)outer * inner * batches;
  long blocks = (total + 255) / 256;
  if (blocks > 4 * 132) blocks = 4 * 132;
  if (blocks < 1) blocks = 1;
  spm_sum_partials<<<(int)blocks, 256, 0, stream>>>(part, out, G, outer,
                                                    inner, live, batches);
  return cudaGetLastError();
}

// Opt a kernel into `smem` bytes of dynamic shared memory (once per size).
template <typename K>
static inline cudaError_t spm_allow_smem(K kernel, size_t smem,
                                         size_t* smem_set) {
  if (smem <= *smem_set) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) *smem_set = smem;
  return e;
}

static inline bool spm_copy_strides(SpmStrides* st, const int* s, int L) {
  if (L < 0 || L > SPM_MAX_STAGES) return false;
  st->n = L;
  for (int i = 0; i < L; ++i) st->s[i] = s[i];
  return true;
}
