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
// Int8 modes (the reference's `x_scale` and `coeff_scale`): a saved int8 x
// is dequantized on load with the scale of its (scale_rows, n_tile) block,
// in the remat and in g_din alike, so the remat replays exactly the
// activations the quantized forward produced; gy and g_x stay f32 or bf16.
// An int8 table is dequantized per stage in the remat and in the reverse
// walk (spm_common.cuh), so g_coeffs is the grad of the dequantized table.
// The partials and the ordered sums are those of the f32 modes.
//
// What bounds it on an H100: memory, as for K1 (a few flops per element and
// stage against the activations read and written once: x, gy, g_x).  This
// first version spends its time in the shared-memory stage passes (L
// forward, L backward) and the partial read-modify-writes (L2-resident);
// PERF.md has its time against the bound.

#include "spm_common.cuh"

// The scale of row `row` of an int8 x in tile j (1 for f32/bf16 x, and for
// a tile wholly past in_w, which reads no x).
__device__ __forceinline__ float spm_row_scale(const float* xs, int row,
                                               int j, int c0, int in_w,
                                               int nt, int scale_rows) {
  if (!xs || c0 >= in_w) return 1.f;
  return xs[(long)(row / scale_rows) * ((in_w + nt - 1) / nt) + j];
}

template <typename T, typename TX, typename CF>
__global__ void __launch_bounds__(512) spm_stack_bwd_kernel(
    const TX* __restrict__ x, const float* __restrict__ xs,
    const T* __restrict__ gy, T* __restrict__ gx, CF cf,
    const float* __restrict__ d_in, const float* __restrict__ d_out,
    float4* __restrict__ part_cf, float* __restrict__ part_vec,
    float* __restrict__ scratch, int B, int n, int nt, int in_w, int gy_w,
    int gx_w, int vis, int cr, int G, int has_bias, int scale_rows,
    SpmStrides st) {
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
  const CF cfj = cf + (long)j * (nt >> 1);

  bool first = true;
  for (int r0 = g * cr; r0 < B; r0 += G * cr) {
    const int rows = min(cr, B - r0);
    // remat: z_0 = [D_in] x, masked to in_w
    for (int r = 0; r < rows; ++r) {
      const TX* xr = x + (long)(r0 + r) * in_w;
      const float sx =
          spm_row_scale(xs, r0 + r, j, c0, in_w, nt, scale_rows);
      float* zr = buf + (long)r * nt;
      for (int c = threadIdx.x; c < nt; c += blockDim.x) {
        const int gc = c0 + c;
        float v = gc < in_w ? spm_ldq(xr + gc, sx) : 0.f;
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
              gc < in_w
                  ? spm_ldq(x + (long)(r0 + r) * in_w + gc,
                            spm_row_scale(xs, r0 + r, j, c0, in_w, nt,
                                          scale_rows))
                  : 0.f;
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

template <typename T, typename TX, typename CF>
static cudaError_t launch_stack_bwd(
    const void* x, const void* xs, const void* gy, void* gx, CF cf,
    const void* d_in, const void* d_out, void* g_cf, void* g_vec,
    void* part_cf, void* part_vec, void* scratch, int B, int n, int nt,
    int in_w, int gy_w, int gx_w, int vis, int cr, int G, int has_bias,
    int scale_rows, const SpmStrides& st, cudaStream_t stream) {
  static size_t smem_set = 0;
  const size_t smem =
      scratch ? 0 : (size_t)(st.n + 1) * cr * nt * sizeof(float);
  cudaError_t e =
      spm_allow_smem(spm_stack_bwd_kernel<T, TX, CF>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const int gx_tiles = (gx_w + nt - 1) / nt;
  dim3 grid(G, gx_tiles > vis ? gx_tiles : vis);
  spm_stack_bwd_kernel<T, TX, CF><<<grid, spm_threads(nt), smem, stream>>>(
      (const TX*)x, (const float*)xs, (const T*)gy, (T*)gx, cf,
      (const float*)d_in, (const float*)d_out, (float4*)part_cf,
      (float*)part_vec, (float*)scratch, B, n, nt, in_w, gy_w, gx_w, vis,
      cr, G, has_bias, scale_rows, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long live = (long)vis * nt;
  e = spm_launch_sum((const float*)part_cf, (float*)g_cf, G, st.n,
                     (long)(n / 2) * 4, live * 2, stream);
  if (e != cudaSuccess) return e;
  return spm_launch_sum((const float*)part_vec, (float*)g_vec, G, 3, n, live,
                        stream);
}

// The cotangent type T, then whether x is int8 (xs non-null).
template <typename T, typename CF>
static cudaError_t dispatch_x(const void* x, const void* xs, const void* gy,
                              void* gx, CF cf, const void* d_in,
                              const void* d_out, void* g_cf, void* g_vec,
                              void* part_cf, void* part_vec, void* scratch,
                              int B, int n, int nt, int in_w, int gy_w,
                              int gx_w, int vis, int cr, int G, int has_bias,
                              int scale_rows, const SpmStrides& st,
                              cudaStream_t s) {
  if (xs) {
    if (scale_rows <= 0 || B % scale_rows) return cudaErrorInvalidValue;
    return launch_stack_bwd<T, int8_t>(
        x, xs, gy, gx, cf, d_in, d_out, g_cf, g_vec, part_cf, part_vec,
        scratch, B, n, nt, in_w, gy_w, gx_w, vis, cr, G, has_bias,
        scale_rows, st, s);
  }
  return launch_stack_bwd<T, T>(x, xs, gy, gx, cf, d_in, d_out, g_cf, g_vec,
                                part_cf, part_vec, scratch, B, n, nt, in_w,
                                gy_w, gx_w, vis, cr, G, has_bias, scale_rows,
                                st, s);
}

template <typename CF>
static cudaError_t dispatch(int io_type, const void* x, const void* xs,
                            const void* gy, void* gx, CF cf,
                            const void* d_in, const void* d_out, void* g_cf,
                            void* g_vec, void* part_cf, void* part_vec,
                            void* scratch, int B, int n, int nt, int in_w,
                            int gy_w, int gx_w, int vis, int cr, int G,
                            int has_bias, int scale_rows,
                            const SpmStrides& st, cudaStream_t s) {
  if (io_type == SPM_IO_F32)
    return dispatch_x<float>(x, xs, gy, gx, cf, d_in, d_out, g_cf, g_vec,
                             part_cf, part_vec, scratch, B, n, nt, in_w,
                             gy_w, gx_w, vis, cr, G, has_bias, scale_rows,
                             st, s);
  if (io_type == SPM_IO_BF16)
    return dispatch_x<__nv_bfloat16>(
        x, xs, gy, gx, cf, d_in, d_out, g_cf, g_vec, part_cf, part_vec,
        scratch, B, n, nt, in_w, gy_w, gx_w, vis, cr, G, has_bias,
        scale_rows, st, s);
  return cudaErrorInvalidValue;
}

// C interface (loaded with ctypes).  io_type is the type of gy and g_x
// (f32 or bf16); x is of that type too, or int8 when its block scales xs
// (B / scale_rows, ceil(in_w / nt)) are given.  cf_scale non-null marks an
// int8 coefficient table with one f32 scale a stage.  d_in / d_out /
// scratch may be null (scratch null: the remat tiles live in shared
// memory).  g_cf is (L, n/2, 4) f32; g_vec (3, n) f32 holds g_din, g_dout,
// g_bias (rows of absent operands are left meaningless).  part_cf
// (G, L, n/2, 4) and part_vec (G, 3, n) are the partial buffers.  Returns
// the cudaError_t of the launches (0 on success).
extern "C" int spm_stack_bwd(int io_type, const void* x, const void* xs,
                             const void* gy, void* gx, const void* cf,
                             const void* cf_scale, const void* d_in,
                             const void* d_out, void* g_cf, void* g_vec,
                             void* part_cf, void* part_vec, void* scratch,
                             int B, int n, int nt, int in_w, int gy_w,
                             int gx_w, int vis, int cr, int G, int has_bias,
                             int scale_rows, const int* strides, int L,
                             void* stream) {
  SpmStrides st;
  if (!spm_copy_strides(&st, strides, L) || B <= 0 || cr <= 0 || G <= 0 ||
      nt <= 0 || n % nt || vis <= 0 || vis * nt > n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cf_scale)
    return (int)dispatch(
        io_type, x, xs, gy, gx,
        SpmQCoeffs{(const char4*)cf, (const float*)cf_scale}, d_in, d_out,
        g_cf, g_vec, part_cf, part_vec, scratch, B, n, nt, in_w, gy_w, gx_w,
        vis, cr, G, has_bias, scale_rows, st, s);
  return (int)dispatch(io_type, x, xs, gy, gx, (const float4*)cf, d_in,
                       d_out, g_cf, g_vec, part_cf, part_vec, scratch, B, n,
                       nt, in_w, gy_w, gx_w, vis, cr, G, has_bias,
                       scale_rows, st, s);
}
