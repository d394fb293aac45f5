// K6: the backward of one K5 pair ({shard-local run -> cross stage}), over
// every shard of a mesh on one device, from the local run's input.
//
// Replaces the TPU kernel `_overlap_bwd_kernel` /
// `spm_overlap_bwd_kernel_call` of src/repro/kernels/spm_stack.py (:1479 /
// :1590).  For shard j, its partner p = j ^ k and the cotangent gy of K5's
// output:
//
//   remat  z_0 = [D_in] x_j, z_l = B_l z_{l-1} (f32), z_out = z_L
//   send   delta = io(gy_j [* d_out_j]),  z = io(z_out)   (the package)
//   sums   s_own = sum delta * z,  s_swp = sum delta * z_p
//          [t_own = sum gy_j * z,  t_swp = sum gy_j * z_p]   (with d_out)
//   mix    delta_mid = u_j * delta + v_j * delta_p          (f32)
//   walk   the local stages in reverse over the f32 remat (eq. 14 grads)
//   out    g_din = sum delta_0 * x_j,  g_x = delta_0 [* d_in]
//
// io() rounds to the I/O type, as the TPU kernel's send slot does (:1528-
// 1541): the own delta and z_out are read back rounded, the raw gy of the
// t sums is not, and the walk's remat stays f32 (:1568).  u / v are the
// role-resolved transpose mix ((a, c) low, (d, b) high); the caller places
// s_own / s_swp into the role's coefficient slots and forms g_dout =
// mix_a * t_own + mix_b * t_swp.
//
// The exchange is K5's: the two blocks of a cluster are partners j and
// j ^ k on the same rows and feature tile, each writes its package to
// shared memory and reads the partner's through distributed shared memory
// between two cluster barriers.  Rows: a block (shard j, row group g, tile
// t) walks row chunks g, g + G, ... as K2 does, its partner the same
// chunks.  The L+1 remat tiles live in shared memory when one chunk's fit
// (else in a global scratch slab, one per block, through the same pointer;
// the package always stays in shared memory).  Sums over rows go to
// per-block partials (one writer per entry) and an ordered sum
// (spm_sum_partials): no float atomics, two launches agree bit for bit.
//
// What bounds it on an H100: memory, as K2 (x and gy read once, g_x
// written once, the tables read and their grads written); this first
// version spends its time in the 2L shared-memory stage passes.

#include <cooperative_groups.h>

#include "spm_common.cuh"

namespace cg = cooperative_groups;

template <typename T, typename CF>
__global__ void __launch_bounds__(512) spm_overlap_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ gy, T* __restrict__ gx,
    CF cf, const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ d_in, const float* __restrict__ d_out,
    float4* __restrict__ part_cf, float* __restrict__ part_vec,
    float* __restrict__ scratch, int B, int S, int n_local, int nt,
    int in_w, int kbit, int cr, int G, SpmStrides st) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int shard = spm_pair_shard(blockIdx.x >> 1, (int)rank, kbit);
  const int g = blockIdx.y;
  const int t = blockIdx.z;
  const int n = S * n_local;
  const int L = st.n;
  const long tile = (long)cr * nt;
  const long half = n_local >> 1;
  const int c0 = shard * n_local + t * nt;  // lane 0's column

  float* buf = scratch ? scratch + ((long)(shard * gridDim.z + t) * G + g) *
                                       (L + 1) * tile
                       : smem;
  T* pkg = reinterpret_cast<T*>(scratch ? smem : smem + (L + 1) * tile);
  float* delta = buf + (long)L * tile;  // z_out, then the cotangent
  const CF cfj = spm_cf_shard(cf, shard, L, half) + (long)t * (nt >> 1);
  float4* pcf = part_cf + ((long)g * S + shard) * L * half + (long)t * (nt >> 1);
  // partial rows n apart: s_own, s_swp, t_own, t_swp, g_din
  float* pv = part_vec + (long)g * 5 * n + c0;

  bool first = true;
  for (int r0 = g * cr; r0 < B; r0 += G * cr) {
    const int rows = min(cr, B - r0);
    for (int r = 0; r < rows; ++r) {
      const T* xr = x + (long)(r0 + r) * in_w;
      float* zr = buf + (long)r * nt;
      for (int c = threadIdx.x; c < nt; c += blockDim.x) {
        const int gc = c0 + c;
        float xv = gc < in_w ? spm_ld(xr + gc) : 0.f;
        if (d_in) xv = __fmul_rn(xv, d_in[gc]);
        zr[c] = xv;
      }
    }
    __syncthreads();
    spm_remat_stages(buf, tile, rows, nt, cfj, half, st);

    // the package: the cotangent [* d_out] and z_out, in the I/O type
    for (int r = 0; r < rows; ++r) {
      const T* gr = gy + (long)(r0 + r) * n;
      for (int c = threadIdx.x; c < nt; c += blockDim.x) {
        const int gc = c0 + c;
        const long i = (long)r * nt + c;
        const float gv = spm_ld(gr + gc);
        spm_st(pkg + i, d_out ? __fmul_rn(gv, d_out[gc]) : gv);
        spm_st(pkg + tile + i, delta[i]);
      }
    }
    cluster.sync();  // both packages written
    const T* peer = cluster.map_shared_rank(pkg, rank ^ 1u);
    for (int c = threadIdx.x; c < nt; c += blockDim.x) {
      const int gc = c0 + c;
      const float uc = u[gc], vc = v[gc];
      float so = 0.f, sw = 0.f, to = 0.f, tw = 0.f;
      for (int r = 0; r < rows; ++r) {
        const long i = (long)r * nt + c;
        const float dl = spm_ld(pkg + i);
        const float zo = spm_ld(pkg + tile + i);
        const float dp = spm_ld(peer + i);
        const float zp = spm_ld(peer + tile + i);
        so = __fadd_rn(so, __fmul_rn(dl, zo));
        sw = __fadd_rn(sw, __fmul_rn(dl, zp));
        if (d_out) {
          const float graw = spm_ld(gy + (long)(r0 + r) * n + gc);
          to = __fadd_rn(to, __fmul_rn(graw, zo));
          tw = __fadd_rn(tw, __fmul_rn(graw, zp));
        }
        delta[i] = __fadd_rn(__fmul_rn(uc, dl), __fmul_rn(vc, dp));
      }
      spm_part_acc(pv + c, so, first);
      spm_part_acc(pv + n + c, sw, first);
      if (d_out) {
        spm_part_acc(pv + 2 * n + c, to, first);
        spm_part_acc(pv + 3 * n + c, tw, first);
      }
    }
    // the partner has read this package; every delta lane is written
    cluster.sync();

    spm_walk_stages_bwd(buf, tile, delta, rows, nt, cfj, half, st, pcf,
                        first);

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
        spm_st(gx + (long)(r0 + r) * n + gc, out);
      }
      if (d_in) spm_part_acc(pv + 4 * n + c, si, first);
    }
    __syncthreads();
    first = false;
  }
}

template <typename T, typename CF>
static cudaError_t launch_overlap_bwd(
    const void* x, const void* gy, void* gx, CF cf, const void* u,
    const void* v, const void* d_in, const void* d_out, void* g_cf,
    void* g_vec, void* part_cf, void* part_vec, void* scratch, int B, int S,
    int n_local, int nt, int in_w, int kbit, int cr, int G,
    const SpmStrides& st, cudaStream_t stream) {
  static size_t smem_set = 0;
  const size_t pkg = (size_t)2 * cr * nt * sizeof(T);
  const size_t smem =
      pkg + (scratch ? 0 : (size_t)(st.n + 1) * cr * nt * sizeof(float));
  cudaError_t e =
      spm_allow_smem(spm_overlap_bwd_kernel<T, CF>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, G, n_local / nt);
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
  e = cudaLaunchKernelEx(&cfg, spm_overlap_bwd_kernel<T, CF>, (const T*)x,
                         (const T*)gy, (T*)gx, cf, (const float*)u,
                         (const float*)v, (const float*)d_in,
                         (const float*)d_out, (float4*)part_cf,
                         (float*)part_vec, (float*)scratch, B, S, n_local,
                         nt, in_w, kbit, cr, G, st);
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long cf_len = (long)S * st.n * (n_local / 2) * 4;
  e = spm_launch_sum((const float*)part_cf, (float*)g_cf, G, 1, cf_len,
                     cf_len, stream);
  if (e != cudaSuccess) return e;
  const long n = (long)S * n_local;
  return spm_launch_sum((const float*)part_vec, (float*)g_vec, G, 5, n, n,
                        stream);
}

template <typename CF>
static cudaError_t dispatch(int io_type, const void* x, const void* gy,
                            void* gx, CF cf, const void* u, const void* v,
                            const void* d_in, const void* d_out, void* g_cf,
                            void* g_vec, void* part_cf, void* part_vec,
                            void* scratch, int B, int S, int n_local, int nt,
                            int in_w, int kbit, int cr, int G,
                            const SpmStrides& st, cudaStream_t s) {
  if (io_type == SPM_IO_F32)
    return launch_overlap_bwd<float>(x, gy, gx, cf, u, v, d_in, d_out, g_cf,
                                     g_vec, part_cf, part_vec, scratch, B, S,
                                     n_local, nt, in_w, kbit, cr, G, st, s);
  if (io_type == SPM_IO_BF16)
    return launch_overlap_bwd<__nv_bfloat16>(
        x, gy, gx, cf, u, v, d_in, d_out, g_cf, g_vec, part_cf, part_vec,
        scratch, B, S, n_local, nt, in_w, kbit, cr, G, st, s);
  return cudaErrorInvalidValue;
}

// C interface (loaded with ctypes).  x (B, in_w), gy and gx (B, S *
// n_local), all of type io_type (f32 or bf16); cf the stacked tables (S, L,
// n_local/2, 4), f32, or int8 when cf_scale (S, L) f32 is given; u, v (n,)
// f32; d_in / d_out (n,) f32 or null; scratch null when the remat tiles
// live in shared memory.  g_cf (S, L, n_local/2, 4) f32 and g_vec (5, n)
// f32 (s_own, s_swp, t_own, t_swp, g_din; the rows of absent operands are
// left meaningless); part_cf (G, S, L, n_local/2, 4) and part_vec (G, 5, n)
// the partials.  Returns the cudaError_t of the launches (0 on success).
extern "C" int spm_overlap_bwd(int io_type, const void* x, const void* gy,
                               void* gx, const void* cf,
                               const void* cf_scale, const void* u,
                               const void* v, const void* d_in,
                               const void* d_out, void* g_cf, void* g_vec,
                               void* part_cf, void* part_vec, void* scratch,
                               int B, int S, int n_local, int nt, int in_w,
                               int kbit, int cr, int G, const int* strides,
                               int L, void* stream) {
  SpmStrides st;
  if (!spm_copy_strides(&st, strides, L) || B <= 0 || cr <= 0 || G <= 0 ||
      nt <= 0 || n_local % nt || S < 2 || kbit < 0 || S % (2 << kbit) ||
      in_w <= 0 || in_w > S * n_local || !u || !v)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cf_scale)
    return (int)dispatch(
        io_type, x, gy, gx,
        SpmQCoeffs{(const char4*)cf, (const float*)cf_scale}, u, v, d_in,
        d_out, g_cf, g_vec, part_cf, part_vec, scratch, B, S, n_local, nt,
        in_w, kbit, cr, G, st, s);
  return (int)dispatch(io_type, x, gy, gx, (const float4*)cf, u, v, d_in,
                       d_out, g_cf, g_vec, part_cf, part_vec, scratch, B, S,
                       n_local, nt, in_w, kbit, cr, G, st, s);
}
