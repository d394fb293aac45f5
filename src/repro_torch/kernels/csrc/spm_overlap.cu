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
// cluster's blocks are j and j ^ k on the same rows and feature tile.  Each
// block walks its shard's stages on the forward engine (spm_fwd_engine.cuh)
// for chunks of rows; its last pass rounds the result straight into a send
// slot in shared memory, one cluster barrier later it reads the partner's
// slot through distributed shared memory for the mix and stores y, 16
// bytes at a time.  The slots are double-buffered by chunk parity, so one
// barrier a chunk suffices: a block rewrites a slot two chunks on, after a
// barrier its partner reaches only once it has read the slot.  A final
// barrier keeps each block resident until its partner has read its last
// slot.  The local result never reaches device memory; nothing is sent
// that the TPU kernel would not send.
//
// x is the global (B, in_w) operand: shard j's lane c of feature tile t is
// column j * n_local + t * nt + c, read as zero from in_w on (the windowed
// read of a rectangular first run is the same read).  y is the global
// (B, n) output; the (n,) vectors are read at the same global column.  The
// tables are stacked per shard, (S, L, n_local/2, 4), f32 or int8 with
// (S, L) stage scales (spm_common.cuh).
//
// What bounds it on an H100: as K1, the stage walk on chip, not bytes (x
// read once, y written once: 0.010 ms at the q/k/v/o pair).  The first
// design ran one stage a pass over 16-row blocks, read the tables from L2
// at every stage, and took two cluster barriers a block.  On the engine the
// 9-stage shard run walks in 3 fused passes, the 36 KiB shard table stays
// in shared memory for the block's whole row range (dequantized once when
// int8), a chunk holds 32 rows, the next chunk's x is in flight while one
// walks, and one cluster barrier a chunk hands the slots over.  The
// partner's slab moves over the SM-to-SM network inside a GPC, never
// through device memory.  Grid: (S, G, n_local / nt), clusters of 2 along
// x; row group g = blockIdx.y walks chunks g, g + G, ....

#include <cooperative_groups.h>

#include "spm_fwd_engine.cuh"

namespace cg = cooperative_groups;
namespace eng = spm_fwd;

template <typename T, typename CF, bool kRes>
__global__ void __launch_bounds__(256, 1) spm_overlap_fwd_kernel(
    const T* __restrict__ x, T* __restrict__ y, CF cf,
    const float* __restrict__ mix_a, const float* __restrict__ mix_b,
    const float* __restrict__ d_in, const float* __restrict__ d_out,
    const float* __restrict__ bias, int B, int n_local, int nt, int in_w,
    int n, int kbit, eng::Shape sh, const __grid_constant__ eng::Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int shard = spm_pair_shard(blockIdx.x >> 1, (int)rank, kbit);
  const int g = blockIdx.y;
  const long c0 = (long)shard * n_local + blockIdx.z * nt;  // lane 0's column
  const long half = n_local >> 1;
  const int np = pl.np;
  const eng::Layout lay =
      eng::layout(pl.L, nt, sh.R, sizeof(T), sizeof(typename eng::Raw<CF>::T),
                  kRes, np > 1, sizeof(T));
  const eng::Stage* stg = pl.stg;
  const eng::Pass* ps = pl.ps;
  auto* tbl = reinterpret_cast<typename eng::Raw<CF>::T*>(smem + lay.tbl);
  float* z = reinterpret_cast<float*>(smem + lay.tile);
  T* xs = reinterpret_cast<T*>(smem + lay.xst);
  const CF cft = spm_cf_shard(cf, shard, pl.L, half) +
                 (long)blockIdx.z * (nt >> 1);
  if (kRes) {
    eng::load_table(cft, half, pl.L, nt >> 1, tbl);
  }
  auto slot = [&](int k) {
    return reinterpret_cast<T*>(smem + lay.slot + (k & 1) * lay.slot_stride);
  };
  int parity = 0;
  auto chunk = [&](int k, int* r0, int* rows, float* scale) {
    *r0 = (g + k * sh.G) * sh.R;
    *rows = min(sh.R, B - *r0);
    *scale = 1.f;
    return *r0 < B;
  };
  auto sink = [&](const eng::Pass&, int) {
    return eng::ToSlot<T>{slot(parity), nt};
  };
  // the mix, V lanes (16 bytes) a step where rows and columns align: a
  // thread keeps one V-lane column of the tile (its mix and epilogue
  // vectors loaded once a chunk) and walks rows t / vecs, + T / vecs, ...
  constexpr int V = 16 / sizeof(T);
  const int vecs = nt / V;
  auto al16 = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const bool vec = nt % V == 0 && (n * sizeof(T)) % 16 == 0 &&
                   (c0 * sizeof(T)) % 16 == 0 && blockDim.x % vecs == 0 &&
                   al16(y) && al16(mix_a) && al16(mix_b) &&
                   (!d_out || al16(d_out)) && (!bias || al16(bias));
  const unsigned magn = eng::magic((unsigned)nt);
  auto finish = [&](int k, int r0, int rows) {
    cluster.sync();  // both slots of this chunk written
    const T* own = slot(k);
    const T* peer = cluster.map_shared_rank(own, rank ^ 1u);
    if (vec) {
      const int i = (threadIdx.x % vecs) * V;
      const long gc = c0 + i;
      float ma[V], mb[V], dout[V], b[V];
      eng::ld_vec<V>(mix_a + gc, ma);
      eng::ld_vec<V>(mix_b + gc, mb);
      if (d_out) eng::ld_vec<V>(d_out + gc, dout);
      if (bias) eng::ld_vec<V>(bias + gc, b);
      // two rows at a time: both rows' slot loads (the partner's through
      // distributed shared memory) in flight before either store
      const int step = blockDim.x / vecs;
      for (int r = threadIdx.x / vecs; r < rows; r += 2 * step) {
        const bool two = r + step < rows;
        float a[2][V], p[2][V];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long o = (long)(two ? r + h * step : r) * nt + i;
          eng::ld_vec<V>(own + o, a[h]);
          eng::ld_vec<V>(peer + o, p[h]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int q = 0; q < V; ++q) {
            float v = __fadd_rn(__fmul_rn(ma[q], a[h][q]),
                                __fmul_rn(mb[q], p[h][q]));
            if (d_out) v = __fmul_rn(v, dout[q]);
            if (bias) v = __fadd_rn(v, b[q]);
            a[h][q] = v;
          }
          if (h == 0 || two)
            eng::st_vec<V>(y + (long)(r0 + r + h * step) * n + gc, a[h]);
        }
      }
    } else {
      for (int e = threadIdx.x; e < rows * nt; e += blockDim.x) {
        const int r = spm_bwd::divm(e, nt, magn);
        const int i = e - r * nt;
        const long gc = c0 + i;
        const long o = (long)r * nt + i;
        float v = __fadd_rn(__fmul_rn(__ldg(mix_a + gc), spm_ld(own + o)),
                            __fmul_rn(__ldg(mix_b + gc), spm_ld(peer + o)));
        if (d_out) v = __fmul_rn(v, __ldg(d_out + gc));
        if (bias) v = __fadd_rn(v, __ldg(bias + gc));
        spm_st(y + (long)(r0 + r) * n + gc, v);
      }
    }
    parity ^= 1;
  };
  if (kRes)
    eng::walk(stg, ps, np, eng::TablePairs<CF>{tbl, nt >> 1, 0, cft},
              eng::TableGlobal<CF>{cft, half}, xs, z, nt, 0, 0, false, x, in_w,
              c0, in_w, d_in, c0, chunk, sink, finish);
  else
    eng::walk(stg, ps, np, eng::TableGlobal<CF>{cft, half},
              eng::TableGlobal<CF>{cft, half}, xs, z, nt, 0, 0, false, x, in_w,
              c0, in_w, d_in, c0, chunk, sink, finish);
  cluster.sync();  // the partner has read this block's last slot
}

// The passes and shared memory of a launch shape (host side); false when
// the shape does not fit.
static bool plan(const SpmStrides& st, int nt, int io_bytes, int cf_bytes,
                 const eng::Shape& sh, eng::Plan* pl, size_t* smem) {
  if (sh.C != 1 || sh.Cr != 1 || sh.T < 32 || sh.T > eng::kMaxThreads ||
      sh.T % 32 || sh.R < 1 || sh.G < 1)
    return false;
  if (!eng::make_plan(st, nt, 1, sh.T, pl)) return false;
  *smem = eng::layout(st.n, nt, sh.R, io_bytes, cf_bytes, sh.resident,
                      pl->np > 1, io_bytes)
              .total;
  return *smem <= 232448;
}

template <typename T, typename CF, bool kRes>
static cudaError_t launch_overlap(const void* x, void* y, CF cf,
                                  const void* mix_a, const void* mix_b,
                                  const void* d_in, const void* d_out,
                                  const void* bias, int B, int S,
                                  int n_local, int nt, int in_w, int kbit,
                                  const eng::Shape& sh, const SpmStrides& st,
                                  cudaStream_t stream) {
  eng::Plan pl;
  size_t smem;
  if (!plan(st, nt, sizeof(T), sizeof(typename eng::Raw<CF>::T), sh, &pl,
            &smem))
    return cudaErrorInvalidValue;
  static size_t smem_set = 0;
  auto kernel = spm_overlap_fwd_kernel<T, CF, kRes>;
  cudaError_t e = spm_allow_smem(kernel, smem, &smem_set);
  if (e != cudaSuccess) return e;
  return eng::launch(kernel, dim3(S, sh.G, n_local / nt), sh.T, smem, 2,
                     stream, (const T*)x, (T*)y, cf, (const float*)mix_a,
                     (const float*)mix_b, (const float*)d_in,
                     (const float*)d_out, (const float*)bias, B, n_local, nt,
                     in_w, S * n_local, kbit, sh, pl);
}

template <typename CF, bool kRes>
static cudaError_t dispatch(int io_type, const void* x, void* y, CF cf,
                            const void* mix_a, const void* mix_b,
                            const void* d_in, const void* d_out,
                            const void* bias, int B, int S, int n_local,
                            int nt, int in_w, int kbit, const eng::Shape& sh,
                            const SpmStrides& st, cudaStream_t s) {
  if (io_type == SPM_IO_F32)
    return launch_overlap<float, CF, kRes>(x, y, cf, mix_a, mix_b, d_in,
                                           d_out, bias, B, S, n_local, nt,
                                           in_w, kbit, sh, st, s);
  if (io_type == SPM_IO_BF16)
    return launch_overlap<__nv_bfloat16, CF, kRes>(
        x, y, cf, mix_a, mix_b, d_in, d_out, bias, B, S, n_local, nt, in_w,
        kbit, sh, st, s);
  return cudaErrorInvalidValue;
}

template <typename CF>
static cudaError_t dispatch_res(int io_type, const void* x, void* y, CF cf,
                                const void* mix_a, const void* mix_b,
                                const void* d_in, const void* d_out,
                                const void* bias, int B, int S, int n_local,
                                int nt, int in_w, int kbit,
                                const eng::Shape& sh, const SpmStrides& st,
                                cudaStream_t s) {
  if (sh.resident)
    return dispatch<CF, true>(io_type, x, y, cf, mix_a, mix_b, d_in, d_out,
                              bias, B, S, n_local, nt, in_w, kbit, sh, st, s);
  return dispatch<CF, false>(io_type, x, y, cf, mix_a, mix_b, d_in, d_out,
                             bias, B, S, n_local, nt, in_w, kbit, sh, st, s);
}

// C interface (loaded with ctypes).  x (B, in_w) and y (B, S * n_local) of
// type io_type (f32 or bf16); cf the stacked tables (S, L, n_local/2, 4),
// f32, or int8 when cf_scale (S, L) f32 is given; mix_a and mix_b (n,) f32;
// d_in / d_out / bias (n,) f32 or null.  Shard j pairs with j ^ (1 <<
// kbit).  The launch shape (T threads, R rows a chunk, G row groups, the
// table resident) is the planner's, kernels/spm_stack.py `fwd_plan`.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int spm_overlap_fwd(int io_type, const void* x, void* y,
                               const void* cf, const void* cf_scale,
                               const void* mix_a, const void* mix_b,
                               const void* d_in, const void* d_out,
                               const void* bias, int B, int S, int n_local,
                               int nt, int in_w, int kbit, int T, int R,
                               int G, int resident, const int* strides,
                               int L, void* stream) {
  SpmStrides st;
  if (!spm_copy_strides(&st, strides, L) || B <= 0 || L < 1 || nt <= 0 ||
      n_local % nt || S < 2 || kbit < 0 || S % (2 << kbit) || in_w <= 0 ||
      in_w > S * n_local || !mix_a || !mix_b)
    return (int)cudaErrorInvalidValue;
  const eng::Shape sh{1, 1, T, R, G, resident};
  cudaStream_t s = (cudaStream_t)stream;
  if (cf_scale)
    return (int)dispatch_res(
        io_type, x, y, SpmQCoeffs{(const char4*)cf, (const float*)cf_scale},
        mix_a, mix_b, d_in, d_out, bias, B, S, n_local, nt, in_w, kbit, sh,
        st, s);
  return (int)dispatch_res(io_type, x, y, (const float4*)cf, mix_a, mix_b,
                           d_in, d_out, bias, B, S, n_local, nt, in_w, kbit,
                           sh, st, s);
}

// How many clusters of a launch shape the card holds at once
// (cudaOccupancyMaxActiveClusters; f32 table), 0 when the shape is refused.
extern "C" int spm_overlap_fwd_clusters(int io_type, const int* strides,
                                        int L, int nt, int T, int R,
                                        int resident) {
  SpmStrides st;
  eng::Plan pl;
  size_t smem;
  const eng::Shape sh{1, 1, T, R, 1, resident};
  const int io = io_type == SPM_IO_F32 ? 4 : 2;
  if (!spm_copy_strides(&st, strides, L) ||
      !plan(st, nt, io, 16, sh, &pl, &smem))
    return 0;
  auto count = [&](auto kernel) { return eng::clusters(kernel, T, smem, 2); };
  if (io_type == SPM_IO_F32)
    return resident
               ? count(spm_overlap_fwd_kernel<float, const float4*, true>)
               : count(spm_overlap_fwd_kernel<float, const float4*, false>);
  return resident
             ? count(spm_overlap_fwd_kernel<__nv_bfloat16, const float4*, true>)
             : count(
                   spm_overlap_fwd_kernel<__nv_bfloat16, const float4*, false>);
}
