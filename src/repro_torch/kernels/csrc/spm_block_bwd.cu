// K4: the residual-block backward — from the saved x and rstd, remat the
// block forward, walk both stacks back, and emit every grad closed-form —
// for row chunks at full width n <= 2048.
//
// Replaces the TPU kernel `_block_bwd_kernel` / `spm_block_bwd_kernel_call`
// of src/repro/kernels/spm_stack.py (:925 / :1117), with `_act_grad`
// (:855).  For the forward of K3 (spm_block.cu):
//
//   remat  xh = x rstd;  z0 = xh gamma (or x);  t1 = z0 d_in1;  stack 1
//          u = z1 d_out1 [+ b1], masked to mid_w;  h = act(u);  t2 = h d_in2
//          stack 2 -> z2
//   walk   g_b2 = sum gy;  g_dout2 = sum gy z2;  delta = gy d_out2;  stack 2
//          back;  g_din2 = sum delta h;  dh = mask_mid(delta d_in2);
//          du = dh act'(u)  (or gy act'(u), or gy);  g_b1 = sum du;
//          g_dout1 = sum du z1;  delta = du d_out1;  stack 1 back;
//          g_din1 = sum delta z0;  dz0 = mask_in(delta d_in1)
//   norm   g_gamma = sum dz0 xh;  gxh = dz0 gamma;
//          g_x = rstd (gxh - xh mean_row(gxh xh))  [+ gy]
//
// gy is read zero past out_w; every grad of a padded lane is an exact zero.
//
// Remat storage: stack 1's L1 stage inputs and its output, and stack 2's
// L2 stage inputs and output (L1 + 1 + L2 + 1 f32 tiles of rows x n); each
// stack's output tile then holds its cotangent.  u and h are recomputed
// from stack 1's output and z0 from x and rstd, bitwise as the forward made
// them.  The tiles stay in shared memory when one row's fit a block's
// 232,448 B (the q/k/v form at n=2048, L=11: 12 x 8 KiB; the two-stack form
// with 12 + 12 stages: 26 x 8 KiB); otherwise in a global scratch slab per
// block, through the same generic pointer, so K4 takes every shape K3 does.
//
// Cross-block sums as in K2: per-block partial slices in a fixed row-chunk
// order, then the ordered `spm_sum_partials`; no float atomics.
//
// What bounds it on an H100: memory (x, gy, g_x once each, a few flops per
// element and stage); this first version spends its time in the
// shared-memory stage passes and the partial read-modify-writes.

#include "spm_common.cuh"

enum { V_GAMMA, V_DIN1, V_DOUT1, V_B1, V_DIN2, V_DOUT2, V_B2, N_VEC };

template <typename T>
__global__ void __launch_bounds__(512) spm_block_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ gy, T* __restrict__ gx,
    const float* __restrict__ rstd, const float* __restrict__ gamma,
    const float4* __restrict__ cf1, const float* __restrict__ din1,
    const float* __restrict__ dout1, const float* __restrict__ bias1,
    const float4* __restrict__ cf2, const float* __restrict__ din2,
    const float* __restrict__ dout2, const float* __restrict__ bias2,
    float4* __restrict__ part_cf1, float4* __restrict__ part_cf2,
    float* __restrict__ part_vec, float* __restrict__ scratch, int B, int n,
    int in_w, int mid_w, int out_w, int cr, int G, int act, int residual,
    SpmStrides st1, SpmStrides st2) {
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const bool two = cf2 != nullptr;
  const int L1 = st1.n, L2 = two ? st2.n : 0;
  const long tile = (long)cr * n;
  const int n_tiles = L1 + 1 + (two ? L2 + 1 : 0);
  const int half = n >> 1;
  float* mean = smem;                               // per-row mean, cr
  float* buf = scratch ? scratch + (long)g * n_tiles * tile
                       : smem + ((cr + 3) & ~3);
  float* A = buf;                                   // stack 1: L1 + 1 tiles
  float* A_out = A + (long)L1 * tile;               // z1, then its delta
  float* Bz = A + (long)(L1 + 1) * tile;            // stack 2: L2 + 1 tiles
  float* B_out = Bz + (long)L2 * tile;              // z2, then its delta
  float* pv = part_vec + (long)g * N_VEC * n;
  float4* p1 = part_cf1 + (long)g * L1 * half;
  float4* p2 = two ? part_cf2 + (long)g * L2 * half : nullptr;

  bool first = true;
  for (int r0 = g * cr; r0 < B; r0 += G * cr) {
    const int rows = min(cr, B - r0);
    // ---- remat: t1 = [x rstd gamma] d_in1, stack 1 ----
    for (int r = 0; r < rows; ++r) {
      const T* xr = x + (long)(r0 + r) * in_w;
      float* zr = A + (long)r * n;
      for (int c = threadIdx.x; c < n; c += blockDim.x) {
        float v = c < in_w ? spm_ld(xr + c) : 0.f;
        if (gamma) v = __fmul_rn(__fmul_rn(v, rstd[r0 + r]), gamma[c]);
        zr[c] = __fmul_rn(v, din1[c]);
      }
    }
    __syncthreads();
    spm_remat_stages(A, tile, rows, n, cf1, half, st1);
    // ---- remat: t2 = act(mask(u)) d_in2, stack 2 ----
    if (two) {
      for (int r = 0; r < rows; ++r)
        for (int c = threadIdx.x; c < n; c += blockDim.x) {
          float u = __fmul_rn(A_out[(long)r * n + c], dout1[c]);
          if (bias1) u = __fadd_rn(u, bias1[c]);
          Bz[(long)r * n + c] =
              __fmul_rn(spm_act(c < mid_w ? u : 0.f, act), din2[c]);
        }
      __syncthreads();
      spm_remat_stages(Bz, tile, rows, n, cf2, half, st2);
    }

    // ---- stack 2's epilogue and walk ----
    if (two) {
      for (int c = threadIdx.x; c < n; c += blockDim.x) {
        float sb = 0.f, sd = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float gv =
              c < out_w ? spm_ld(gy + (long)(r0 + r) * out_w + c) : 0.f;
          float* dz = B_out + (long)r * n + c;
          sb = __fadd_rn(sb, gv);
          sd = __fadd_rn(sd, __fmul_rn(gv, *dz));
          *dz = __fmul_rn(gv, dout2[c]);
        }
        if (bias2) spm_part_acc(pv + V_B2 * n + c, sb, first);
        spm_part_acc(pv + V_DOUT2 * n + c, sd, first);
      }
      __syncthreads();
      spm_walk_stages_bwd(Bz, tile, B_out, rows, n, cf2, half, st2, p2,
                          first);
    }

    // ---- through the activation to stack 1's output ----
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      float s_din2 = 0.f, s_b1 = 0.f, s_dout1 = 0.f;
      for (int r = 0; r < rows; ++r) {
        float* z1 = A_out + (long)r * n + c;
        float du;
        if (two || act != ACT_NONE) {
          float u = __fmul_rn(*z1, dout1[c]);
          if (bias1) u = __fadd_rn(u, bias1[c]);
          if (c >= mid_w) u = 0.f;
          if (two) {
            const float dl = B_out[(long)r * n + c];
            s_din2 = __fadd_rn(s_din2, __fmul_rn(dl, spm_act(u, act)));
            const float dh = c < mid_w ? __fmul_rn(dl, din2[c]) : 0.f;
            du = __fmul_rn(dh, spm_act_grad(u, act));
          } else {
            const float gv =
                c < out_w ? spm_ld(gy + (long)(r0 + r) * out_w + c) : 0.f;
            du = __fmul_rn(gv, spm_act_grad(u, act));
          }
        } else {
          du = c < out_w ? spm_ld(gy + (long)(r0 + r) * out_w + c) : 0.f;
        }
        s_b1 = __fadd_rn(s_b1, du);
        s_dout1 = __fadd_rn(s_dout1, __fmul_rn(du, *z1));
        *z1 = __fmul_rn(du, dout1[c]);
      }
      if (two) spm_part_acc(pv + V_DIN2 * n + c, s_din2, first);
      if (bias1) spm_part_acc(pv + V_B1 * n + c, s_b1, first);
      spm_part_acc(pv + V_DOUT1 * n + c, s_dout1, first);
    }
    __syncthreads();
    spm_walk_stages_bwd(A, tile, A_out, rows, n, cf1, half, st1, p1, first);

    // ---- d_in1, the norm, and g_x ----
    // tile 0 of A (stage 1's input, no longer needed) keeps xh per element
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      float s_din1 = 0.f, s_gam = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float xv =
            c < in_w ? spm_ld(x + (long)(r0 + r) * in_w + c) : 0.f;
        float* dl = A_out + (long)r * n + c;
        float xh = xv, z0 = xv;
        if (gamma) {
          xh = __fmul_rn(xv, rstd[r0 + r]);
          z0 = __fmul_rn(xh, gamma[c]);
        }
        s_din1 = __fadd_rn(s_din1, __fmul_rn(*dl, z0));
        const float dz0 = c < in_w ? __fmul_rn(*dl, din1[c]) : 0.f;
        if (gamma) {
          s_gam = __fadd_rn(s_gam, __fmul_rn(dz0, xh));
          *dl = __fmul_rn(dz0, gamma[c]);            // gxh
          A[(long)r * n + c] = xh;
        } else {
          *dl = dz0;
        }
      }
      spm_part_acc(pv + V_DIN1 * n + c, s_din1, first);
      if (gamma) spm_part_acc(pv + V_GAMMA * n + c, s_gam, first);
    }
    __syncthreads();
    if (gamma) {  // mean_row(gxh xh): one warp per row, lanes in order
      const int lane = threadIdx.x & 31;
      const int warp = threadIdx.x >> 5;
      for (int r = warp; r < rows; r += (blockDim.x >> 5)) {
        const float* gr = A_out + (long)r * n;
        const float* hr = A + (long)r * n;
        float acc = 0.f;
        for (int c = lane; c < in_w; c += 32)
          acc = __fadd_rn(acc, __fmul_rn(gr[c], hr[c]));
        for (int off = 16; off > 0; off >>= 1)
          acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
        if (lane == 0) mean[r] = __fdiv_rn(acc, (float)in_w);
      }
      __syncthreads();
    }
    for (int r = 0; r < rows; ++r) {
      T* gr = gx + (long)(r0 + r) * in_w;
      for (int c = threadIdx.x; c < in_w; c += blockDim.x) {
        float v = A_out[(long)r * n + c];
        if (gamma)
          v = __fmul_rn(rstd[r0 + r],
                        __fsub_rn(v, __fmul_rn(A[(long)r * n + c], mean[r])));
        if (residual && c < out_w)
          v = __fadd_rn(v, spm_ld(gy + (long)(r0 + r) * out_w + c));
        spm_st(gr + c, v);
      }
    }
    __syncthreads();
    first = false;
  }
}

template <typename T>
static cudaError_t launch_block_bwd(
    const void* x, const void* gy, void* gx, const void* rstd,
    const void* gamma, const void* cf1, const void* din1, const void* dout1,
    const void* bias1, const void* cf2, const void* din2, const void* dout2,
    const void* bias2, void* g_cf1, void* g_cf2, void* g_vec, void* part_cf1,
    void* part_cf2, void* part_vec, void* scratch, int B, int n, int in_w,
    int mid_w, int out_w, int cr, int G, int act, int residual,
    const SpmStrides& st1, const SpmStrides& st2, cudaStream_t stream) {
  static size_t smem_set = 0;
  const int n_tiles = st1.n + 1 + (cf2 ? st2.n + 1 : 0);
  const size_t smem =
      ((size_t)((cr + 3) & ~3) + (scratch ? 0 : (size_t)n_tiles * cr * n)) *
      sizeof(float);
  cudaError_t e = spm_allow_smem(spm_block_bwd_kernel<T>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  spm_block_bwd_kernel<T><<<G, spm_threads(n), smem, stream>>>(
      (const T*)x, (const T*)gy, (T*)gx, (const float*)rstd,
      (const float*)gamma, (const float4*)cf1, (const float*)din1,
      (const float*)dout1, (const float*)bias1, (const float4*)cf2,
      (const float*)din2, (const float*)dout2, (const float*)bias2,
      (float4*)part_cf1, (float4*)part_cf2, (float*)part_vec,
      (float*)scratch, B, n, in_w, mid_w, out_w, cr, G, act, residual, st1,
      st2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = spm_launch_sum((const float*)part_cf1, (float*)g_cf1, G, st1.n,
                     (long)(n / 2) * 4, (long)(n / 2) * 4, stream);
  if (e != cudaSuccess) return e;
  if (cf2) {
    e = spm_launch_sum((const float*)part_cf2, (float*)g_cf2, G, st2.n,
                       (long)(n / 2) * 4, (long)(n / 2) * 4, stream);
    if (e != cudaSuccess) return e;
  }
  return spm_launch_sum((const float*)part_vec, (float*)g_vec, G, N_VEC, n,
                        n, stream);
}

// C interface (loaded with ctypes).  gamma/rstd, bias1, and the whole
// second stack (cf2, din2, dout2, bias2, g_cf2, part_cf2) may be null, and
// so may scratch (the remat tiles then live in shared memory).  g_vec is
// (7, n) f32: g_gamma, g_din1, g_dout1, g_bias1, g_din2, g_dout2, g_bias2
// (rows of absent operands are left meaningless).  part_cf1 (G, L1, n/2,
// 4), part_cf2 (G, L2, n/2, 4) and part_vec (G, 7, n) are the partial
// buffers.  Returns the cudaError_t of the launches (0 on success).
extern "C" int spm_block_bwd(
    int io_type, const void* x, const void* gy, void* gx, const void* rstd,
    const void* gamma, const void* cf1, const void* din1, const void* dout1,
    const void* bias1, const void* cf2, const void* din2, const void* dout2,
    const void* bias2, void* g_cf1, void* g_cf2, void* g_vec, void* part_cf1,
    void* part_cf2, void* part_vec, void* scratch, int B, int n, int in_w,
    int mid_w, int out_w, int cr, int G, int act, int residual,
    const int* strides1, int L1, const int* strides2, int L2, void* stream) {
  SpmStrides st1, st2;
  if (!spm_copy_strides(&st1, strides1, L1) ||
      !spm_copy_strides(&st2, strides2, cf2 ? L2 : 0) || B <= 0 || cr <= 0 ||
      G <= 0 || (gamma != nullptr) != (rstd != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (io_type == SPM_IO_F32)
    return (int)launch_block_bwd<float>(
        x, gy, gx, rstd, gamma, cf1, din1, dout1, bias1, cf2, din2, dout2,
        bias2, g_cf1, g_cf2, g_vec, part_cf1, part_cf2, part_vec, scratch, B,
        n, in_w, mid_w, out_w, cr, G, act, residual, st1, st2, s);
  if (io_type == SPM_IO_BF16)
    return (int)launch_block_bwd<__nv_bfloat16>(
        x, gy, gx, rstd, gamma, cf1, din1, dout1, bias1, cf2, din2, dout2,
        bias2, g_cf1, g_cf2, g_vec, part_cf1, part_cf2, part_vec, scratch, B,
        n, in_w, mid_w, out_w, cr, G, act, residual, st1, st2, s);
  return (int)cudaErrorInvalidValue;
}
