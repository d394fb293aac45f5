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
// through device memory.  Grid: (S, G x E, n_local / nt), clusters of 2
// along x; row group g = blockIdx.y % G walks chunks g, g + G, ....
//
// Expert mode (E > 1, the reference's `jax.vmap` of the pair over the MoE
// expert axis): expert e = blockIdx.y / G runs the same pair on its own
// operands, x (E, B, in_w) and y (E, B, n) offset by its rows, its tables
// the (shard, e) entries of an (S, E, L, n_local/2, 4) stack ((S, E, L)
// scales), its mix and epilogue vectors n floats on.  The expert shares
// grid.y with the row groups because grid.z is the tiles; the plan is one
// expert's rows, and a cluster (two partners) never spans two experts.

// Rank mode (K5's and K6's send kernel between ranks).  The partner is
// another rank, each rank's own launch covers only its shard, and the
// exchange goes through device memory: the TPU kernel's remote copy of a
// row block into the partner's receive slot (:1284) becomes this kernel's
// store, through the partner's IPC-mapped pointer (kernels/peer.py), of
// the block it walked, rounded once to T, beside the same store into its
// own send slot; K6's send also stores the package's cotangent, io(gy
// [* d_out]).  The stream signals the partner after the launch, and the
// mix (spm_pair_mix below) or K6's consume kernel runs once the partner's
// block is in.  x is the rank's (B, in_w) input, its lane 0 at column
// x_col0 (the windowed read of a rectangular first run), the slots and gy
// (B, n_local), the vectors the rank's (n_local,) slices.
template <typename T>
struct RankSend {
  T* own;           // own send slot (B, n_local)
  T* peer;          // the partner's receive slot (B, n_local)
  const T* gy;      // K6: the cotangent (B, n_local), or null
  T* own_d;         // K6: the package's cotangent, own send slot
  T* peer_d;        // K6: and the partner's receive slot
  long x_col0;
};

#include <cooperative_groups.h>

#include "spm_fwd_engine.cuh"

namespace cg = cooperative_groups;
namespace eng = spm_fwd;

// Copy rows x nt values of T from the block's slot (pitch nt) to dst (pitch
// ld, from column c0): 16 bytes a thread where the rows align.
template <typename T>
__device__ __forceinline__ void slot_out(const T* slot, T* dst, long ld,
                                         long c0, int rows, int nt) {
  constexpr int V = 16 / sizeof(T);
  if (nt % V == 0 && (ld * sizeof(T)) % 16 == 0 &&
      (c0 * sizeof(T)) % 16 == 0 && (uintptr_t)dst % 16 == 0) {
    const int vecs = nt / V;
    for (int e = threadIdx.x; e < rows * vecs; e += blockDim.x) {
      const int r = e / vecs, i = (e - r * vecs) * V;
      *reinterpret_cast<uint4*>(dst + r * ld + c0 + i) =
          *reinterpret_cast<const uint4*>(slot + (long)r * nt + i);
    }
  } else {
    for (int e = threadIdx.x; e < rows * nt; e += blockDim.x) {
      const int r = e / nt, i = e - r * nt;
      dst[r * ld + c0 + i] = slot[(long)r * nt + i];
    }
  }
}

template <typename T, typename CF, bool kRes, bool kRank>
__global__ void __launch_bounds__(256, 1) spm_overlap_fwd_kernel(
    const T* __restrict__ x, T* __restrict__ y, CF cf,
    const float* __restrict__ mix_a, const float* __restrict__ mix_b,
    const float* __restrict__ d_in, const float* __restrict__ d_out,
    const float* __restrict__ bias, int B, int n_local, int nt, int in_w,
    int n, int kbit, eng::Shape sh, const __grid_constant__ eng::Plan pl,
    const RankSend<T> rs) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int shard =
      kRank ? 0 : spm_pair_shard(blockIdx.x >> 1, (int)rank, kbit);
  const int E = gridDim.y / sh.G;
  const int ex = blockIdx.y / sh.G;
  const int g = blockIdx.y - ex * sh.G;
  if (E > 1) {
    const long e = ex;
    x += e * B * in_w;
    y += e * B * n;
    mix_a += e * n;
    mix_b += e * n;
    if (d_in) d_in += e * n;
    if (d_out) d_out += e * n;
    if (bias) bias += e * n;
  }
  const long c0 = (long)shard * n_local + blockIdx.z * nt;  // lane 0's column
  const long xc0 = kRank ? rs.x_col0 + c0 : c0;             // its x column
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
  const CF cft = spm_cf_shard(cf, shard * E + ex, pl.L, half) +
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
  auto send = [&](int k, int r0, int rows) {
    __syncthreads();  // the chunk's slot written
    const long o = (long)r0 * n_local;
    slot_out(slot(k), rs.own + o, n_local, c0, rows, nt);
    slot_out(slot(k), rs.peer + o, n_local, c0, rows, nt);
    if (rs.gy) {  // K6: the package's cotangent, io(gy [* d_out])
      for (int e = threadIdx.x; e < rows * nt; e += blockDim.x) {
        const int r = spm_bwd::divm(e, nt, magn);
        const long g = o + (long)r * n_local + c0 + (e - r * nt);
        float v = spm_ld(rs.gy + g);
        if (d_out) v = __fmul_rn(v, __ldg(d_out + c0 + (e - r * nt)));
        spm_st(rs.own_d + g, v);
        spm_st(rs.peer_d + g, v);
      }
    }
    __syncthreads();  // the slot is free for the chunk after next
    parity ^= 1;
  };
  auto finish = [&](int k, int r0, int rows) {
    if constexpr (kRank) {
      send(k, r0, rows);
      return;
    }
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
              xc0, in_w, d_in, c0, chunk, sink, finish);
  else
    eng::walk(stg, ps, np, eng::TableGlobal<CF>{cft, half},
              eng::TableGlobal<CF>{cft, half}, xs, z, nt, 0, 0, false, x, in_w,
              xc0, in_w, d_in, c0, chunk, sink, finish);
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

template <typename T, typename CF, bool kRes, bool kRank = false>
static cudaError_t launch_overlap(const void* x, void* y, CF cf,
                                  const void* mix_a, const void* mix_b,
                                  const void* d_in, const void* d_out,
                                  const void* bias, int B, int S,
                                  int n_local, int nt, int in_w, int kbit,
                                  int E, const eng::Shape& sh,
                                  const SpmStrides& st, cudaStream_t stream,
                                  const RankSend<T>& rs = RankSend<T>{}) {
  eng::Plan pl;
  size_t smem;
  if (!plan(st, nt, sizeof(T), sizeof(typename eng::Raw<CF>::T), sh, &pl,
            &smem))
    return cudaErrorInvalidValue;
  static size_t smem_set = 0;
  auto kernel = spm_overlap_fwd_kernel<T, CF, kRes, kRank>;
  cudaError_t e = spm_allow_smem(kernel, smem, &smem_set);
  if (e != cudaSuccess) return e;
  // one-card: a cluster holds the two partners; rank mode: one shard
  return eng::launch(kernel, dim3(S, sh.G * E, n_local / nt), sh.T, smem,
                     kRank ? 1 : 2, stream, (const T*)x, (T*)y, cf,
                     (const float*)mix_a, (const float*)mix_b,
                     (const float*)d_in, (const float*)d_out,
                     (const float*)bias, B, n_local, nt, in_w, S * n_local,
                     kbit, sh, pl, rs);
}

template <typename CF, bool kRes>
static cudaError_t dispatch(int io_type, const void* x, void* y, CF cf,
                            const void* mix_a, const void* mix_b,
                            const void* d_in, const void* d_out,
                            const void* bias, int B, int S, int n_local,
                            int nt, int in_w, int kbit, int E,
                            const eng::Shape& sh, const SpmStrides& st,
                            cudaStream_t s) {
  if (io_type == SPM_IO_F32)
    return launch_overlap<float, CF, kRes>(x, y, cf, mix_a, mix_b, d_in,
                                           d_out, bias, B, S, n_local, nt,
                                           in_w, kbit, E, sh, st, s);
  if (io_type == SPM_IO_BF16)
    return launch_overlap<__nv_bfloat16, CF, kRes>(
        x, y, cf, mix_a, mix_b, d_in, d_out, bias, B, S, n_local, nt, in_w,
        kbit, E, sh, st, s);
  return cudaErrorInvalidValue;
}

template <typename CF>
static cudaError_t dispatch_res(int io_type, const void* x, void* y, CF cf,
                                const void* mix_a, const void* mix_b,
                                const void* d_in, const void* d_out,
                                const void* bias, int B, int S, int n_local,
                                int nt, int in_w, int kbit, int E,
                                const eng::Shape& sh, const SpmStrides& st,
                                cudaStream_t s) {
  if (sh.resident)
    return dispatch<CF, true>(io_type, x, y, cf, mix_a, mix_b, d_in, d_out,
                              bias, B, S, n_local, nt, in_w, kbit, E, sh, st,
                              s);
  return dispatch<CF, false>(io_type, x, y, cf, mix_a, mix_b, d_in, d_out,
                             bias, B, S, n_local, nt, in_w, kbit, E, sh, st,
                             s);
}

// C interface (loaded with ctypes).  x (B, in_w) and y (B, S * n_local) of
// type io_type (f32 or bf16); cf the stacked tables (S, L, n_local/2, 4),
// f32, or int8 when cf_scale (S, L) f32 is given; mix_a and mix_b (n,) f32;
// d_in / d_out / bias (n,) f32 or null.  Shard j pairs with j ^ (1 <<
// kbit).  The launch shape (T threads, R rows a chunk, G row groups, the
// table resident) is the planner's, kernels/spm_stack.py `fwd_plan`.
// E > 1 is the expert mode: x (E, B, in_w), y (E, B, S * n_local), cf
// (S, E, L, n_local/2, 4) with scales (S, E, L), the vectors (E, n).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int spm_overlap_fwd(int io_type, const void* x, void* y,
                               const void* cf, const void* cf_scale,
                               const void* mix_a, const void* mix_b,
                               const void* d_in, const void* d_out,
                               const void* bias, int B, int S, int n_local,
                               int nt, int in_w, int kbit, int T, int R,
                               int G, int resident, const int* strides,
                               int L, int E, void* stream) {
  SpmStrides st;
  if (!spm_copy_strides(&st, strides, L) || B <= 0 || L < 1 || nt <= 0 ||
      n_local % nt || S < 2 || kbit < 0 || S % (2 << kbit) || in_w <= 0 ||
      in_w > S * n_local || !mix_a || !mix_b || E < 1 || G < 1 ||
      (long)G * E > 65535)
    return (int)cudaErrorInvalidValue;
  const eng::Shape sh{1, 1, T, R, G, resident};
  cudaStream_t s = (cudaStream_t)stream;
  if (cf_scale)
    return (int)dispatch_res(
        io_type, x, y, SpmQCoeffs{(const char4*)cf, (const float*)cf_scale},
        mix_a, mix_b, d_in, d_out, bias, B, S, n_local, nt, in_w, kbit, E,
        sh, st, s);
  return (int)dispatch_res(io_type, x, y, (const float4*)cf, mix_a, mix_b,
                           d_in, d_out, bias, B, S, n_local, nt, in_w, kbit,
                           E, sh, st, s);
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
  using F4 = const float4*;
  if (io_type == SPM_IO_F32)
    return resident ? count(spm_overlap_fwd_kernel<float, F4, true, false>)
                    : count(spm_overlap_fwd_kernel<float, F4, false, false>);
  return resident ? count(spm_overlap_fwd_kernel<__nv_bfloat16, const float4*,
                                                 true, false>)
                  : count(spm_overlap_fwd_kernel<__nv_bfloat16, const float4*,
                                                 false, false>);
}

// ---------------------------------------------------------------------------
// rank mode
// ---------------------------------------------------------------------------

template <typename T, typename CF>
static cudaError_t send_io(const void* x, CF cf, const void* d_in,
                           const void* d_out, int B, int n_local, int nt,
                           int in_w, const eng::Shape& sh,
                           const SpmStrides& st, cudaStream_t s,
                           const RankSend<T>& rs) {
  if (sh.resident)
    return launch_overlap<T, CF, true, true>(x, nullptr, cf, nullptr, nullptr,
                                             d_in, d_out, nullptr, B, 1,
                                             n_local, nt, in_w, 0, 1, sh, st,
                                             s, rs);
  return launch_overlap<T, CF, false, true>(x, nullptr, cf, nullptr, nullptr,
                                            d_in, d_out, nullptr, B, 1,
                                            n_local, nt, in_w, 0, 1, sh, st, s,
                                            rs);
}

template <typename T>
static cudaError_t send_cf(const void* x, const void* cf, const void* cf_scale,
                           const void* d_in, const void* d_out, int B,
                           int n_local, int nt, int in_w, const eng::Shape& sh,
                           const SpmStrides& st, cudaStream_t s,
                           const RankSend<T>& rs) {
  if (cf_scale)
    return send_io<T>(x, SpmQCoeffs{(const char4*)cf, (const float*)cf_scale},
                      d_in, d_out, B, n_local, nt, in_w, sh, st, s, rs);
  return send_io<T>(x, (const float4*)cf, d_in, d_out, B, n_local, nt, in_w,
                    sh, st, s, rs);
}

// C interface of the send kernel (K5's and K6's rank mode).  x (B, in_w) of
// io_type with the rank's lane 0 at column x_col0, zero from in_w on; cf
// the rank's table (L, n_local/2, 4) f32, or int8 with (L,) scales; d_in
// (n_local,) f32 or null.  Stores io((B_l ... B_1) [D_in] x) into own and
// peer ((B, n_local) each, the rank's send slot and the partner's receive
// slot); with gy (B, n_local), also io(gy [* d_out]) into own_d and
// peer_d.  The launch shape is the planner's (`fwd_plan`, one shard).
extern "C" int spm_overlap_send(int io_type, const void* x, const void* cf,
                                const void* cf_scale, const void* d_in,
                                const void* d_out, void* own, void* peer,
                                const void* gy, void* own_d, void* peer_d,
                                long x_col0, int B, int n_local, int nt,
                                int in_w, int T, int R, int G, int resident,
                                const int* strides, int L, void* stream) {
  SpmStrides st;
  if (!spm_copy_strides(&st, strides, L) || B <= 0 || L < 1 || nt <= 0 ||
      n_local % nt || in_w <= 0 || x_col0 < 0 || !own || !peer || G < 1 ||
      G > 65535 || (gy && (!own_d || !peer_d)))
    return (int)cudaErrorInvalidValue;
  const eng::Shape sh{1, 1, T, R, G, resident};
  cudaStream_t s = (cudaStream_t)stream;
  if (io_type == SPM_IO_F32)
    return (int)send_cf<float>(
        x, cf, cf_scale, d_in, d_out, B, n_local, nt, in_w, sh, st, s,
        RankSend<float>{(float*)own, (float*)peer, (const float*)gy,
                        (float*)own_d, (float*)peer_d, x_col0});
  if (io_type == SPM_IO_BF16)
    return (int)send_cf<__nv_bfloat16>(
        x, cf, cf_scale, d_in, d_out, B, n_local, nt, in_w, sh, st, s,
        RankSend<__nv_bfloat16>{(__nv_bfloat16*)own, (__nv_bfloat16*)peer,
                                (const __nv_bfloat16*)gy,
                                (__nv_bfloat16*)own_d, (__nv_bfloat16*)peer_d,
                                x_col0});
  return (int)cudaErrorInvalidValue;
}

// K5's rank-mode mix, once the partner's block is in the receive slot:
// y = mix_a * own + mix_b * recv in f32, * d_out after the add, + bias,
// one rounding on the store: the one-card K5's epilogue, op for op.
template <typename T>
__global__ void __launch_bounds__(256) spm_pair_mix_kernel(
    const T* __restrict__ own, const T* __restrict__ recv, T* __restrict__ y,
    const float* __restrict__ mix_a, const float* __restrict__ mix_b,
    const float* __restrict__ d_out, const float* __restrict__ bias,
    long count, int n_local) {
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += (long)gridDim.x * blockDim.x) {
    const int c = (int)(e % n_local);
    float v = __fadd_rn(__fmul_rn(__ldg(mix_a + c), spm_ld(own + e)),
                        __fmul_rn(__ldg(mix_b + c), spm_ld(recv + e)));
    if (d_out) v = __fmul_rn(v, __ldg(d_out + c));
    if (bias) v = __fadd_rn(v, __ldg(bias + c));
    spm_st(y + e, v);
  }
}

// C interface of the mix: own and recv the rank's send and receive slots,
// y its (B, n_local) output block, all of io_type; the vectors (n_local,)
// f32 (d_out, bias may be null).
extern "C" int spm_overlap_mix(int io_type, const void* own, const void* recv,
                               void* y, const void* mix_a, const void* mix_b,
                               const void* d_out, const void* bias, int B,
                               int n_local, void* stream) {
  if (B <= 0 || n_local <= 0 || !mix_a || !mix_b)
    return (int)cudaErrorInvalidValue;
  const long count = (long)B * n_local;
  const long blocks = (count + 255) / 256;
  const int grid = (int)(blocks < 132L * 16 ? blocks : 132L * 16);
  cudaStream_t s = (cudaStream_t)stream;
  if (io_type == SPM_IO_F32)
    spm_pair_mix_kernel<float><<<grid, 256, 0, s>>>(
        (const float*)own, (const float*)recv, (float*)y,
        (const float*)mix_a, (const float*)mix_b, (const float*)d_out,
        (const float*)bias, count, n_local);
  else if (io_type == SPM_IO_BF16)
    spm_pair_mix_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        (const __nv_bfloat16*)own, (const __nv_bfloat16*)recv,
        (__nv_bfloat16*)y, (const float*)mix_a, (const float*)mix_b,
        (const float*)d_out, (const float*)bias, count, n_local);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
