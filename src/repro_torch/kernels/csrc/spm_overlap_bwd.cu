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
// The exchange is K5's, on the engine's lane split (spm_bwd_engine.cuh):
// a cluster holds the two partner shards j and j ^ k of one row group and
// feature tile, each split over C lane blocks (cluster rank = side * C +
// lane block, side the shard's bit log2 k), 2C <= 8 blocks.  Lane block c
// of one side exchanges its package with lane block c of the other: each
// writes its package to shared memory and reads the partner's through
// distributed shared memory between two cluster barriers.  As K2, a
// cluster walks row chunks g, g + G, ... of R rows with the table and the
// pair-grad sums on chip for the whole range, x (double-buffered) and gy
// one chunk ahead by cp.async, g_x out in 16-byte stores; the per-lane
// sums (s_own, s_swp, t_own, t_swp, g_din) stay on chip too.  Each block
// stores its grads once into its slice of the partial buffers and an
// ordered sum (spm_sum_partials) finishes them: no float atomics, two
// launches agree bit for bit.
//
// Expert mode (E > 1, as K5's): expert e = blockIdx.y / G runs the same
// pair's backward on its own rows of x (E, B, in_w), gy and g_x (E, B, n),
// its (shard, e) tables of an (S, E, L, n_local/2, 4) stack, its vectors n
// floats on; the table partials are (G, S, E, L, n_local/2, 4), summed
// over G into g_cf (S, E, ...), the vector partials (E, G, 5, n), summed
// per expert into (E, 5, n): each expert's sums run over its own rows.
//
// What bounds it on an H100: by bytes, memory, as K2 (x and gy read once,
// g_x written once, the tables read and their grads written); in fact, as
// K2, the engine's passes over R rows (at 4 shards of 512 lanes every
// stage is local to one block: a cluster is just the two partners), then
// the package exchange and its two cluster barriers; PERF.md has its time
// against the bound.

// Rank mode (the consume kernel of K6 between ranks).  The partner is
// another rank and each rank's launch covers only its shard (S = 1 here:
// its table, its (B, n_local) gy and g_x, its (n_local,) vectors).  The
// package was stored by the send kernel (spm_overlap.cu, rank mode): the
// rank's own (delta, z) in its send slot, the partner's in its receive
// slot, read here from device memory in place of the cluster partner's
// shared memory once the stream has waited for the partner's signal; the
// rest (the sums, the transpose mix, the reverse walk over the remat,
// g_din, g_x) is the one-card kernel's, op for op.  x is the rank's
// (B, in_w) input with its lane 0 at column x_col0 (the windowed read).
template <typename T>
struct RankPkg {
  const T* own_d;   // the own package (B, n_local) each
  const T* own_z;
  const T* peer_d;  // the partner's, in the receive slot
  const T* peer_z;
  long x_col0;
};

#include "spm_bwd_engine.cuh"

namespace eng = spm_bwd;

constexpr int kVecs = 5;  // s_own, s_swp, t_own, t_swp, g_din

template <typename T, typename CF, bool kRank>
__global__ void __launch_bounds__(512, 1) spm_overlap_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ gy, T* __restrict__ gx,
    CF cf, const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ d_in, const float* __restrict__ d_out,
    float4* __restrict__ part_cf, float* __restrict__ part_vec, int B, int S,
    int n_local, int nt, int in_w, int kbit, eng::Shape sh, SpmStrides st,
    const RankPkg<T> rp) {
  extern __shared__ __align__(16) unsigned char smem[];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int side = kRank ? 0 : rank / sh.C;
  const int c = rank - side * sh.C;
  const int shard =
      kRank ? 0 : spm_pair_shard(blockIdx.x / (2 * sh.C), side, kbit);
  const int E = gridDim.y / sh.G;
  const int ex = blockIdx.y / sh.G;
  const int g = blockIdx.y - ex * sh.G;
  const int t = blockIdx.z;
  const int n = S * n_local;
  if (E > 1) {
    const long e = ex;
    x += e * B * in_w;
    gy += e * B * n;
    gx += e * B * n;
    u += e * n;
    v += e * n;
    if (d_in) d_in += e * n;
    if (d_out) d_out += e * n;
    part_vec += e * sh.G * (long)kVecs * n;
  }
  const int L = st.n;
  const int w = sh.w;
  const long half = n_local >> 1;
  const int lane0 = shard * n_local + t * nt + c * w;  // first column
  const long lanex = kRank ? rp.x_col0 + lane0 : lane0;  // its x column
  const long step = (long)sh.G * sh.R;

  const eng::Geo geo{L,    w, sh.pb, sh.rs,           sh.R,
                     c,    side * sh.C, sh.C, __ffs(sh.C) - 1,
                     eng::magic((unsigned)w)};
  const eng::Layout lay =
      eng::layout_of(L, sh, kVecs, sizeof(T), sizeof(T), true);
  float4* tbl = reinterpret_cast<float4*>(smem + lay.tbl);
  float4* acc = reinterpret_cast<float4*>(smem + lay.acc);
  float4* part = reinterpret_cast<float4*>(smem + lay.part);
  eng::Stage* stg = reinterpret_cast<eng::Stage*>(smem + lay.stg);
  eng::Pass* ps = reinterpret_cast<eng::Pass*>(smem + lay.pas);
  const int np = sh.np;
  float* vacc = reinterpret_cast<float*>(smem + lay.vacc);
  float* tiles = reinterpret_cast<float*>(smem + lay.tiles);
  float* zL = tiles + (long)np * sh.R * w;  // z_out, then the cotangent
  float* spare = zL + (long)sh.R * w;      // the cotangent in layout B
  T* gst = reinterpret_cast<T*>(smem + lay.gst);
  T* pkg_d = reinterpret_cast<T*>(smem + lay.pkg);
  T* pkg_z = reinterpret_cast<T*>(smem + lay.pkg + lay.pkg_stride);
  const T* peer_d =
      kRank ? nullptr : cluster.map_shared_rank(pkg_d, (1 - side) * sh.C + c);
  const T* peer_z =
      kRank ? nullptr : cluster.map_shared_rank(pkg_z, (1 - side) * sh.C + c);
  // the package's pitch: the block's own columns on chip, a slot row here
  const long pp = kRank ? n : w;

  // z_out in layout A: the package is the block's own columns
  eng::setup(st, w, sh.C, c, eng::kLayA, stg, ps);
  __syncthreads();
  eng::load_table(geo, stg,
                  spm_cf_shard(cf, shard * E + ex, L, half) +
                      (long)t * (nt >> 1),
                  half, tbl, acc, vacc, kVecs);
  const bool head_b = L > 0 && ps[0].lin == eng::kLayB;
  const bool tail_b = L > 0 && ps[np - 1].lin == eng::kLayB;
  long r0 = (long)g * sh.R;
  if (r0 < B) {
    const int rows = (int)min((long)sh.R, B - r0);
    eng::stage_rows(reinterpret_cast<T*>(smem + lay.xst), x, in_w, r0, rows,
                    w, lanex, in_w);
    eng::stage_rows(gst, gy, n, r0, rows, w, lane0, n);
  }
  for (int k = 0; r0 < B; r0 += step, ++k) {
    const int rows = (int)min((long)sh.R, B - r0);
    const T* xcur =
        reinterpret_cast<const T*>(smem + lay.xst + (k & 1) * lay.xst_stride);
    eng::cp_wait_all();
    eng::sync(head_b);
    const long r1 = r0 + step;
    if (r1 < B) {
      T* xnext = reinterpret_cast<T*>(smem + lay.xst +
                                      ((k + 1) & 1) * lay.xst_stride);
      eng::stage_rows(xnext, x, in_w, r1, (int)min((long)sh.R, B - r1), w,
                      lanex, in_w);
    }

    // remat: z_0 = [D_in] x_j, masked to in_w.  The per-lane passes give a
    // thread lanes (i, i+1), four rows at a time, loads first.
    if (threadIdx.x < sh.pb) {
      const int i = 2 * threadIdx.x;
      const int gc = lane0 + i;
      const bool l0 = lanex + i < in_w, l1 = lanex + i + 1 < in_w;
      const float2 din = eng::vec2(d_in, gc);
      for (int r = 0; r < rows; r += 4) {
        const int nr = min(4, rows - r);
        float2 xv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < nr) {
            xv[k] = eng::ld2(xcur + (long)(r + k) * w + i);
            xv[k] = make_float2(l0 ? xv[k].x : 0.f, l1 ? xv[k].y : 0.f);
          }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < nr) {
            const float2 z = d_in ? eng::mul2(xv[k], din) : xv[k];
            if (head_b) {
              eng::put(tiles, geo, eng::kLayB, r + k, i, z.x);
              eng::put(tiles, geo, eng::kLayB, r + k, i + 1, z.y);
            } else {
              eng::st2(tiles + (long)(r + k) * w + i, z);
            }
          }
      }
    }
    eng::sync(L > 0 && (head_b || ps[0].remf));
    eng::remat(geo, stg, ps, np, rows, tbl, tiles, false);

    // the package: the cotangent [* d_out] and z_out, in the I/O type (in
    // rank mode the send kernel stored it)
    if (!kRank && threadIdx.x < sh.pb) {
      const int i = 2 * threadIdx.x;
      const float2 dout = eng::vec2(d_out, lane0 + i);
      for (int r = 0; r < rows; r += 4) {
        const int nr = min(4, rows - r);
        float2 gv[4], z[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < nr) {
            gv[k] = eng::ld2(gst + (long)(r + k) * w + i);
            z[k] = eng::ld2(zL + (long)(r + k) * w + i);
          }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < nr) {
            const long e = (long)(r + k) * w + i;
            eng::st2(pkg_d + e, d_out ? eng::mul2(gv[k], dout) : gv[k]);
            eng::st2(pkg_z + e, z[k]);
          }
      }
    }
    cluster.sync();  // both packages written
    const long po = kRank ? r0 * n + lane0 : 0;  // the chunk's package
    const T* od = kRank ? rp.own_d + po : pkg_d;
    const T* oz = kRank ? rp.own_z + po : pkg_z;
    const T* qd = kRank ? rp.peer_d + po : peer_d;
    const T* qz = kRank ? rp.peer_z + po : peer_z;
    if (threadIdx.x < sh.pb) {
      const int i = 2 * threadIdx.x;
      const float2 uc = eng::vec2(u, lane0 + i), vc = eng::vec2(v, lane0 + i);
      float2 so = make_float2(0.f, 0.f), sw = so, to = so, tw = so;
      for (int r = 0; r < rows; r += 2) {
        const int nr = min(2, rows - r);
        float2 dl[2], zo[2], dp[2], zp[2], gr[2];
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (k < nr) {
            const long e = (long)(r + k) * pp + i;
            dl[k] = eng::ld2(od + e);
            zo[k] = eng::ld2(oz + e);
            dp[k] = eng::ld2(qd + e);
            zp[k] = eng::ld2(qz + e);
            if (d_out) gr[k] = eng::ld2(gst + (long)(r + k) * w + i);
          }
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (k < nr) {
            so = eng::add2(so, eng::mul2(dl[k], zo[k]));
            sw = eng::add2(sw, eng::mul2(dl[k], zp[k]));
            if (d_out) {
              to = eng::add2(to, eng::mul2(gr[k], zo[k]));
              tw = eng::add2(tw, eng::mul2(gr[k], zp[k]));
            }
            const float2 dm =
                eng::add2(eng::mul2(uc, dl[k]), eng::mul2(vc, dp[k]));
            if (tail_b) {
              eng::put(spare, geo, eng::kLayB, r + k, i, dm.x);
              eng::put(spare, geo, eng::kLayB, r + k, i + 1, dm.y);
            } else {
              eng::st2(zL + (long)(r + k) * w + i, dm);
            }
          }
      }
      eng::st2(vacc + i, eng::add2(eng::ld2(vacc + i), so));
      eng::st2(vacc + w + i, eng::add2(eng::ld2(vacc + w + i), sw));
      if (d_out) {
        eng::st2(vacc + 2 * w + i, eng::add2(eng::ld2(vacc + 2 * w + i), to));
        eng::st2(vacc + 3 * w + i, eng::add2(eng::ld2(vacc + 3 * w + i), tw));
      }
    }
    // the partner has read this package; every delta lane is written
    cluster.sync();
    if (r1 < B)
      eng::stage_rows(gst, gy, n, r1, (int)min((long)sh.R, B - r1), w, lane0,
                      n);

    float* dl0 = eng::walk_back(geo, stg, ps, np, rows, tbl, acc, part,
                                tiles, tail_b ? spare : zL);

    // g_din, and g_x in place of delta
    if (d_in && threadIdx.x < sh.pb) {
      const int i = 2 * threadIdx.x;
      const int gc = lane0 + i;
      const bool l0 = lanex + i < in_w, l1 = lanex + i + 1 < in_w;
      const float2 din = eng::vec2(d_in, gc);
      float2 si = make_float2(0.f, 0.f);
      for (int r = 0; r < rows; r += 4) {
        const int nr = min(4, rows - r);
        float2 xv[4], d[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < nr) {
            xv[k] = eng::ld2(xcur + (long)(r + k) * w + i);
            xv[k] = make_float2(l0 ? xv[k].x : 0.f, l1 ? xv[k].y : 0.f);
            d[k] = eng::ld2(dl0 + (long)(r + k) * w + i);
          }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < nr) {
            si = eng::add2(si, eng::mul2(d[k], xv[k]));
            eng::st2(dl0 + (long)(r + k) * w + i, eng::mul2(d[k], din));
          }
      }
      eng::st2(vacc + 4 * w + i, eng::add2(eng::ld2(vacc + 4 * w + i), si));
    }
    __syncthreads();
    eng::store_rows(gx, n, r0, rows, w, lane0, n, dl0);
  }

  eng::store_table_grads(
      geo, stg, acc,
      part_cf + (((long)g * S + shard) * E + ex) * L * half +
          (long)t * (nt >> 1),
      half);
  float* pv = part_vec + (long)g * kVecs * n + lane0;
  for (int e = threadIdx.x; e < kVecs * w; e += blockDim.x) {
    const int vv = e / w;
    pv[(long)vv * n + (e - vv * w)] = vacc[e];
  }
  cluster.sync();
}

template <typename T, typename CF, bool kRank = false>
static cudaError_t launch_overlap_bwd(
    const void* x, const void* gy, void* gx, CF cf, const void* u,
    const void* v, const void* d_in, const void* d_out, void* g_cf,
    void* g_vec, void* part_cf, void* part_vec, int B, int S, int n_local,
    int nt, int in_w, int kbit, int E, const eng::Shape& sh,
    const SpmStrides& st, cudaStream_t stream,
    const RankPkg<T>& rp = RankPkg<T>{}) {
  static size_t smem_set = 0;
  const size_t smem =
      eng::layout_of(st.n, sh, kVecs, sizeof(T), sizeof(T), true).total;
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = spm_overlap_bwd_kernel<T, CF, kRank>;
  cudaError_t e = spm_allow_smem(kernel, smem, &smem_set);
  if (e != cudaSuccess) return e;
  // one-card: a cluster holds the partners' lane blocks; rank mode: one
  // shard's
  e = eng::launch(kernel, dim3(S * sh.C, sh.G * E, n_local / nt),
                  sh.pb * sh.rs, smem, (kRank ? 1 : 2) * sh.C, stream,
                  (const T*)x, (const T*)gy, (T*)gx, cf, (const float*)u,
                  (const float*)v, (const float*)d_in, (const float*)d_out,
                  (float4*)part_cf, (float*)part_vec, B, S, n_local, nt, in_w,
                  kbit, sh, st, rp);
  if (e != cudaSuccess) return e;
  const long cf_len = (long)S * E * st.n * (n_local / 2) * 4;
  e = spm_launch_sum((const float*)part_cf, (float*)g_cf, sh.G, 1, cf_len,
                     cf_len, stream);
  if (e != cudaSuccess) return e;
  const long n = (long)S * n_local;
  return spm_launch_sum((const float*)part_vec, (float*)g_vec, sh.G, kVecs,
                        n, n, stream, E);
}

template <typename CF>
static cudaError_t dispatch(int io_type, const void* x, const void* gy,
                            void* gx, CF cf, const void* u, const void* v,
                            const void* d_in, const void* d_out, void* g_cf,
                            void* g_vec, void* part_cf, void* part_vec, int B,
                            int S, int n_local, int nt, int in_w, int kbit,
                            int E, const eng::Shape& sh, const SpmStrides& st,
                            cudaStream_t s) {
  if (io_type == SPM_IO_F32)
    return launch_overlap_bwd<float>(x, gy, gx, cf, u, v, d_in, d_out, g_cf,
                                     g_vec, part_cf, part_vec, B, S, n_local,
                                     nt, in_w, kbit, E, sh, st, s);
  if (io_type == SPM_IO_BF16)
    return launch_overlap_bwd<__nv_bfloat16>(
        x, gy, gx, cf, u, v, d_in, d_out, g_cf, g_vec, part_cf, part_vec, B,
        S, n_local, nt, in_w, kbit, E, sh, st, s);
  return cudaErrorInvalidValue;
}

// C interface (loaded with ctypes).  x (B, in_w), gy and gx (B, S *
// n_local), all of type io_type (f32 or bf16); cf the stacked tables (S, L,
// n_local/2, 4), f32, or int8 when cf_scale (S, L) f32 is given; u, v (n,)
// f32; d_in / d_out (n,) f32 or null.  g_cf (S, L, n_local/2, 4) f32 and
// g_vec (5, n) f32 (s_own, s_swp, t_own, t_swp, g_din; the rows of absent
// operands are left meaningless); part_cf (G, S, L, n_local/2, 4) and
// part_vec (G, 5, n) the partials.  The launch shape (C lane blocks a
// shard tile, w, pb, rs, R, G) is the planner's (`bwd_plan`), 2C <= 8.
// E > 1 is the expert mode: x (E, B, in_w), gy and gx (E, B, n), cf and
// g_cf (S, E, L, n_local/2, 4) (scales (S, E, L)), u / v / d_in / d_out
// (E, n), g_vec (E, 5, n), part_cf (G, S, E, L, n_local/2, 4) and
// part_vec (E, G, 5, n).  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int spm_overlap_bwd(int io_type, const void* x, const void* gy,
                               void* gx, const void* cf,
                               const void* cf_scale, const void* u,
                               const void* v, const void* d_in,
                               const void* d_out, void* g_cf, void* g_vec,
                               void* part_cf, void* part_vec, int B, int S,
                               int n_local, int nt, int in_w, int kbit, int C,
                               int w, int pb, int rs, int R, int G,
                               const int* strides, int L, int E,
                               void* stream) {
  SpmStrides st;
  eng::Shape sh{C, w, pb, rs, R, G, 0, 0, 0};
  if (!spm_copy_strides(&st, strides, L) || B <= 0 || nt <= 0 ||
      n_local % nt || S < 2 || kbit < 0 || S % (2 << kbit) || in_w <= 0 ||
      in_w > S * n_local || !u || !v || !eng::valid_shape(sh, nt) || C > 4 ||
      E < 1 || (long)G * E > 65535)
    return (int)cudaErrorInvalidValue;
  eng::set_passes(st, eng::kLayA, &sh);
  cudaStream_t s = (cudaStream_t)stream;
  if (cf_scale)
    return (int)dispatch(
        io_type, x, gy, gx,
        SpmQCoeffs{(const char4*)cf, (const float*)cf_scale}, u, v, d_in,
        d_out, g_cf, g_vec, part_cf, part_vec, B, S, n_local, nt, in_w, kbit,
        E, sh, st, s);
  return (int)dispatch(io_type, x, gy, gx, (const float4*)cf, u, v, d_in,
                       d_out, g_cf, g_vec, part_cf, part_vec, B, S, n_local,
                       nt, in_w, kbit, E, sh, st, s);
}

// How many clusters of a launch shape (2C blocks each) the card holds at
// once (cudaOccupancyMaxActiveClusters; an f32 table), for the on-card
// reports; 0 on error.
extern "C" int spm_overlap_bwd_clusters(int io_type, const int* strides,
                                        int L, int C, int w, int pb, int rs,
                                        int R) {
  SpmStrides st;
  eng::Shape sh{C, w, pb, rs, R, 1, 0, 0, 0};
  if (!spm_copy_strides(&st, strides, L)) return 0;
  eng::set_passes(st, eng::kLayA, &sh);
  const int esz = io_type == SPM_IO_F32 ? 4 : 2;
  const size_t smem = eng::layout_of(L, sh, kVecs, esz, esz, true).total;
  if (io_type == SPM_IO_F32) {
    static size_t set = 0;
    auto kernel = spm_overlap_bwd_kernel<float, const float4*, false>;
    if (spm_allow_smem(kernel, smem, &set) != cudaSuccess) return 0;
    return eng::max_clusters(kernel, pb * rs, smem, 2 * C);
  }
  static size_t set = 0;
  auto kernel = spm_overlap_bwd_kernel<__nv_bfloat16, const float4*, false>;
  if (spm_allow_smem(kernel, smem, &set) != cudaSuccess) return 0;
  return eng::max_clusters(kernel, pb * rs, smem, 2 * C);
}

// ---------------------------------------------------------------------------
// rank mode
// ---------------------------------------------------------------------------

template <typename T, typename CF>
static cudaError_t consume(const void* x, const void* gy, void* gx, CF cf,
                           const void* u, const void* v, const void* d_in,
                           const void* d_out, void* g_cf, void* g_vec,
                           void* part_cf, void* part_vec, int B, int n_local,
                           int nt, int in_w, const eng::Shape& sh,
                           const SpmStrides& st, cudaStream_t s,
                           const RankPkg<T>& rp) {
  return launch_overlap_bwd<T, CF, true>(x, gy, gx, cf, u, v, d_in, d_out,
                                         g_cf, g_vec, part_cf, part_vec, B, 1,
                                         n_local, nt, in_w, 0, 1, sh, st, s,
                                         rp);
}

template <typename T>
static cudaError_t consume_cf(const void* x, const void* gy, void* gx,
                              const void* cf, const void* cf_scale,
                              const void* u, const void* v, const void* d_in,
                              const void* d_out, void* g_cf, void* g_vec,
                              void* part_cf, void* part_vec, int B,
                              int n_local, int nt, int in_w,
                              const eng::Shape& sh, const SpmStrides& st,
                              cudaStream_t s, const RankPkg<T>& rp) {
  if (cf_scale)
    return consume<T>(x, gy, gx,
                      SpmQCoeffs{(const char4*)cf, (const float*)cf_scale}, u,
                      v, d_in, d_out, g_cf, g_vec, part_cf, part_vec, B,
                      n_local, nt, in_w, sh, st, s, rp);
  return consume<T>(x, gy, gx, (const float4*)cf, u, v, d_in, d_out, g_cf,
                    g_vec, part_cf, part_vec, B, n_local, nt, in_w, sh, st, s,
                    rp);
}

// C interface of K6's rank-mode consume kernel: one row block of the rank's
// shard.  x (B, in_w) of io_type with the rank's lane 0 at column x_col0,
// zero from in_w on; gy and gx (B, n_local); cf the rank's table (L,
// n_local/2, 4) f32, or int8 with (L,) scales; u, v, d_in, d_out
// (n_local,) f32 (d_in, d_out may be null); own_d / own_z the rank's send
// slot and peer_d / peer_z its receive slot ((B, n_local) each: the
// package); g_cf (L, n_local/2, 4) and g_vec (5, n_local) f32, part_cf
// (G, L, n_local/2, 4) and part_vec (G, 5, n_local) the partials.  The
// launch shape (C lane blocks, w, pb, rs, R, G) is the planner's
// (`bwd_plan`, one side).
extern "C" int spm_overlap_bwd_rank(
    int io_type, const void* x, const void* gy, void* gx, const void* cf,
    const void* cf_scale, const void* u, const void* v, const void* d_in,
    const void* d_out, const void* own_d, const void* own_z,
    const void* peer_d, const void* peer_z, void* g_cf, void* g_vec,
    void* part_cf, void* part_vec, long x_col0, int B, int n_local, int nt,
    int in_w, int C, int w, int pb, int rs, int R, int G, const int* strides,
    int L, void* stream) {
  SpmStrides st;
  eng::Shape sh{C, w, pb, rs, R, G, 0, 0, 0};
  if (!spm_copy_strides(&st, strides, L) || B <= 0 || nt <= 0 ||
      n_local % nt || in_w <= 0 || x_col0 < 0 || !u || !v || !own_d ||
      !own_z || !peer_d || !peer_z || !eng::valid_shape(sh, nt) || C > 8 ||
      G > 65535)
    return (int)cudaErrorInvalidValue;
  eng::set_passes(st, eng::kLayA, &sh);
  cudaStream_t s = (cudaStream_t)stream;
  if (io_type == SPM_IO_F32)
    return (int)consume_cf<float>(
        x, gy, gx, cf, cf_scale, u, v, d_in, d_out, g_cf, g_vec, part_cf,
        part_vec, B, n_local, nt, in_w, sh, st, s,
        RankPkg<float>{(const float*)own_d, (const float*)own_z,
                       (const float*)peer_d, (const float*)peer_z, x_col0});
  if (io_type == SPM_IO_BF16)
    return (int)consume_cf<__nv_bfloat16>(
        x, gy, gx, cf, cf_scale, u, v, d_in, d_out, g_cf, g_vec, part_cf,
        part_vec, B, n_local, nt, in_w, sh, st, s,
        RankPkg<__nv_bfloat16>{
            (const __nv_bfloat16*)own_d, (const __nv_bfloat16*)own_z,
            (const __nv_bfloat16*)peer_d, (const __nv_bfloat16*)peer_z,
            x_col0});
  return (int)cudaErrorInvalidValue;
}
