// K2: the fused SPM stage-stack backward, one planned run.
//
// Replaces the TPU kernel `_bwd_kernel` / `spm_stack_bwd_kernel_call` of
// src/repro/kernels/spm_stack.py (:523 / :608), with its helpers
// `_mask_cols` (:120), `_apply_stages_fwd` (:130) and `_stage_walk_bwd`
// (:486).  For the run's forward y = [D_out] B_L..B_1 [D_in] x [+ bias]:
//
//   remat z_0 = [D_in] x (x zero-filled past in_w), z_l = B_l z_{l-1}
//   g_bias = sum_rows gy;  g_dout = sum_rows gy * z_L;  delta = gy [* d_out]
//   for l = L..1: g_coeffs[l] (eq. 14, summed over rows); delta = B_l^T delta
//   g_din = sum_rows delta * x;  g_x = delta [* d_in]
//
// gy is read zero past its width gy_w (out_width on the last run), so the
// sliced-away outputs carry no cotangent.  Feature tiles from `vis` on are
// dead (their masked cotangent is all zero, and tile-local pairing keeps
// every grad they would make an exact zero): no block walks them, their
// g_x columns are stored as zeros and their parameter grads come out of the
// final sum as zeros.
//
// Remat storage (what the TPU keeps in VMEM): the L stage inputs plus one
// tile for z_L, which the cotangent then overwrites, L+1 f32 tiles of
// (rows x n_tile).  They stay in shared memory when one row's L+1 tiles
// fit a block's 232,448 B; otherwise (the one-run 6144-wide tiny-row plan,
// 13 x 24 KiB a row) they go to a global scratch slab, one per block,
// through the same generic pointer.  The design holds at any plan K1 runs.
//
// Cross-block sums: a block (g, j) walks row chunks g, g+G, g+2G, ... of
// feature tile j and accumulates its pair and column grads into its own
// slice of a partial buffer (written on its first chunk, added after; one
// writer per entry).  `spm_sum_partials` then sums the G slices in order.
// No float atomics, so two launches give bitwise equal grads.
//
// What bounds it on an H100: memory, as for K1 (a few flops per element and
// stage against the activations read and written once: x, gy, g_x).  This
// first version spends its time in the shared-memory stage passes (L
// forward, L backward) and the partial read-modify-writes (L2-resident);
// PERF.md has its time against the bound.

#include "spm_common.cuh"

template <typename T>
__global__ void __launch_bounds__(512) spm_stack_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ gy, T* __restrict__ gx,
    const float4* __restrict__ cf, const float* __restrict__ d_in,
    const float* __restrict__ d_out, float4* __restrict__ part_cf,
    float* __restrict__ part_vec, float* __restrict__ scratch, int B, int n,
    int nt, int in_w, int gy_w, int gx_w, int vis, int cr, int G,
    int has_bias, SpmStrides st) {
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const int j = blockIdx.y;
  const int c0 = j * nt;
  const int L = st.n;
  const long tile = (long)cr * nt;

  if (j >= vis) {  // dead tile: exact zeros where g_x has columns
    const int c_end = min(nt, gx_w - c0);
    for (int r0 = g * cr; r0 < B; r0 += G * cr) {
      const int rows = min(cr, B - r0);
      for (int r = 0; r < rows; ++r)
        for (int c = threadIdx.x; c < c_end; c += blockDim.x)
          spm_st(gx + (long)(r0 + r) * gx_w + c0 + c, 0.f);
    }
    return;
  }

  float* buf = scratch ? scratch + (long)(j * G + g) * (L + 1) * tile : smem;
  float* delta = buf + (long)L * tile;             // z_L, then the cotangent
  const int half_n = n >> 1;
  float4* pcf = part_cf + (long)g * L * half_n + (long)j * (nt >> 1);
  float* pdin = part_vec + (long)g * 3 * n + c0;
  float* pdout = pdin + n;
  float* pbias = pdin + 2 * n;
  const float4* cfj = cf + (long)j * (nt >> 1);

  bool first = true;
  for (int r0 = g * cr; r0 < B; r0 += G * cr) {
    const int rows = min(cr, B - r0);
    // remat: z_0 = [D_in] x, masked to in_w
    for (int r = 0; r < rows; ++r) {
      const T* xr = x + (long)(r0 + r) * in_w;
      float* zr = buf + (long)r * nt;
      for (int c = threadIdx.x; c < nt; c += blockDim.x) {
        const int gc = c0 + c;
        float v = gc < in_w ? spm_ld(xr + gc) : 0.f;
        if (d_in) v = __fmul_rn(v, d_in[gc]);
        zr[c] = v;
      }
    }
    __syncthreads();
    spm_remat_stages(buf, tile, rows, nt, cfj, half_n, st);

    // epilogue grads from gy; delta = gy [* d_out] replaces z_L
    for (int c = threadIdx.x; c < nt; c += blockDim.x) {
      const int gc = c0 + c;
      float sb = 0.f, sd = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float gv =
            gc < gy_w ? spm_ld(gy + (long)(r0 + r) * gy_w + gc) : 0.f;
        float* dz = delta + (long)r * nt + c;
        sb = __fadd_rn(sb, gv);
        if (d_out) {
          sd = __fadd_rn(sd, __fmul_rn(gv, *dz));
          *dz = __fmul_rn(gv, d_out[gc]);
        } else {
          *dz = gv;
        }
      }
      if (has_bias) spm_part_acc(pbias + c, sb, first);
      if (d_out) spm_part_acc(pdout + c, sd, first);
    }
    __syncthreads();

    spm_walk_stages_bwd(buf, tile, delta, rows, nt, cfj, half_n, st, pcf,
                        first);

    // g_din and g_x
    for (int c = threadIdx.x; c < nt; c += blockDim.x) {
      const int gc = c0 + c;
      float si = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float dl = delta[(long)r * nt + c];
        float out = dl;
        if (d_in) {
          const float xv =
              gc < in_w ? spm_ld(x + (long)(r0 + r) * in_w + gc) : 0.f;
          si = __fadd_rn(si, __fmul_rn(dl, xv));
          out = __fmul_rn(dl, d_in[gc]);
        }
        if (gc < gx_w) spm_st(gx + (long)(r0 + r) * gx_w + gc, out);
      }
      if (d_in) spm_part_acc(pdin + c, si, first);
    }
    __syncthreads();
    first = false;
  }
}

template <typename T>
static cudaError_t launch_stack_bwd(
    const void* x, const void* gy, void* gx, const void* cf,
    const void* d_in, const void* d_out, void* g_cf, void* g_vec,
    void* part_cf, void* part_vec, void* scratch, int B, int n, int nt,
    int in_w, int gy_w, int gx_w, int vis, int cr, int G, int has_bias,
    const SpmStrides& st, cudaStream_t stream) {
  static size_t smem_set = 0;
  const size_t smem =
      scratch ? 0 : (size_t)(st.n + 1) * cr * nt * sizeof(float);
  cudaError_t e = spm_allow_smem(spm_stack_bwd_kernel<T>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const int gx_tiles = (gx_w + nt - 1) / nt;
  dim3 grid(G, gx_tiles > vis ? gx_tiles : vis);
  spm_stack_bwd_kernel<T><<<grid, spm_threads(nt), smem, stream>>>(
      (const T*)x, (const T*)gy, (T*)gx, (const float4*)cf,
      (const float*)d_in, (const float*)d_out, (float4*)part_cf,
      (float*)part_vec, (float*)scratch, B, n, nt, in_w, gy_w, gx_w, vis,
      cr, G, has_bias, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long live = (long)vis * nt;
  e = spm_launch_sum((const float*)part_cf, (float*)g_cf, G, st.n,
                     (long)(n / 2) * 4, live * 2, stream);
  if (e != cudaSuccess) return e;
  return spm_launch_sum((const float*)part_vec, (float*)g_vec, G, 3, n, live,
                        stream);
}

// C interface (loaded with ctypes).  d_in / d_out / scratch may be null
// (scratch null: the remat tiles live in shared memory).  g_cf is
// (L, n/2, 4) f32; g_vec (3, n) f32 holds g_din, g_dout, g_bias (rows of
// absent operands are left meaningless).  part_cf (G, L, n/2, 4) and
// part_vec (G, 3, n) are the partial buffers.  Returns the cudaError_t of
// the launches (0 on success).
extern "C" int spm_stack_bwd(int io_type, const void* x, const void* gy,
                             void* gx, const void* cf, const void* d_in,
                             const void* d_out, void* g_cf, void* g_vec,
                             void* part_cf, void* part_vec, void* scratch,
                             int B, int n, int nt, int in_w, int gy_w,
                             int gx_w, int vis, int cr, int G, int has_bias,
                             const int* strides, int L, void* stream) {
  SpmStrides st;
  if (!spm_copy_strides(&st, strides, L) || B <= 0 || cr <= 0 || G <= 0 ||
      nt <= 0 || n % nt || vis <= 0 || vis * nt > n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (io_type == SPM_IO_F32)
    return (int)launch_stack_bwd<float>(
        x, gy, gx, cf, d_in, d_out, g_cf, g_vec, part_cf, part_vec, scratch,
        B, n, nt, in_w, gy_w, gx_w, vis, cr, G, has_bias, st, s);
  if (io_type == SPM_IO_BF16)
    return (int)launch_stack_bwd<__nv_bfloat16>(
        x, gy, gx, cf, d_in, d_out, g_cf, g_vec, part_cf, part_vec, scratch,
        B, n, nt, in_w, gy_w, gx_w, vis, cr, G, has_bias, st, s);
  return (int)cudaErrorInvalidValue;
}
