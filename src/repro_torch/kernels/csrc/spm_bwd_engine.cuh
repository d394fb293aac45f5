// The backward engine of K2 (spm_stack_bwd.cu), K4 (spm_block_bwd.cu) and
// K6 (spm_overlap_bwd.cu):
// the remat of a run's stage inputs, the reverse walk with the eq. 14 pair
// grads, and the loads and stores around them, for a thread-block cluster
// that holds one feature tile of a row range on chip.
//
// Design.  A feature tile of nt lanes is split over a cluster of C lane
// blocks (C = 1, 2, 4 or 8), w = nt / C lanes each.  A cluster walks row
// chunks g, g + G, g + 2G, ... of R rows (G row groups, one cluster each,
// about as many as the card holds at once), and for the whole range:
//
//  * the table stays on chip.  At the start each block copies the
//    coefficients of the pairs it processes (w/2 a stage, every stage) into
//    shared memory, an int8 table dequantized there once with spm_cf's
//    single rounded multiply.  No pass reads the table from L2.
//  * the pair grads stay on chip.  Each pass sums its rows of the chunk in
//    registers, in row order, and adds the chunk's sums to the block's
//    accumulators in shared memory (a pass with row slices: slice 0 adds
//    its own, the later slices' go through `part` and are added in slice
//    order after the barrier).  The block stores its accumulators once, at
//    the end, into its own slice of the (G, ...) partial buffer, and
//    spm_sum_partials sums the G slices in order: no float atomics, two
//    launches agree bit for bit, and the buffer is G slices deep, not one
//    a block of the old grid.
//  * fewer passes, more rows.  Two consecutive stages local to one layout
//    whose strides nest (the larger a multiple of twice the smaller) run
//    as one pass: a thread holds a quad of lanes through both stages.  A
//    pass keeps only its input tile; the reverse pass recomputes the
//    middle stage from it (the same rounded products, bit for bit).  At
//    the 2048-wide 11-stage tile the walk takes 6 passes a way and 6 + 1
//    (+1) tiles a row, not 11 and 12.
//  * loads in flight.  x (double-buffered) and gy come in by cp.async one
//    chunk ahead (16-byte copies, zero-filled past their widths; 4-byte
//    words for gy read in layout B), while the current chunk walks; g_x
//    goes out in 16-byte stores.  Rows that are not 16-byte aligned take
//    plain loads and stores.
//
// Lane layouts.  A tile's lanes sit in the blocks in one of two layouts:
// A, block c owning lanes [c w, (c+1) w) (offset i - c w), or B, block c
// owning the lanes i = c (mod C) (offset i / C).  A stride-s stage is local
// in A when w % 2s == 0 and in B when C divides s (a stride-s/C butterfly
// on the offsets).  A stage runs in A if it can; a run of two or more that
// cannot, all of strides C divides, runs in B; any other stage runs in A
// reaching across blocks through distributed shared memory
// (cluster.map_shared_rank; one lane of each pair local when the stride is
// a multiple of w).  Each pass's input tile is kept in its layout, z_L in
// the last pass's (K6: in A, for the package), and a change of layout is
// made by the pass before it storing its outputs straight into the other
// blocks' tiles (the cotangent into a spare tile on the way back).  A pass
// that touches another block's tiles is bracketed by cluster barriers;
// every other pass by __syncthreads alone.  The kernel's last barrier
// keeps each block resident while its partners may still write to it.
// Strides need only be what the stage walk needs (nt % 2s == 0), in any
// order; the planner (kernels/spm_stack.py `bwd_plan`, `bwd_stage_modes`,
// `bwd_passes`, `bwd_slot_pairs`, `bwd_quad_lanes`) mirrors plan_walk and
// the slot maps, and its CPU tests check them.
//
// What bounds it on an H100: not bytes (the o tile's run moves 50 MB,
// 0.015 ms) and not the shared memory's bandwidth, but the passes' fixed
// costs: a pass within a block takes about 1 us whatever its rows (setup,
// dependent loads, its barrier), a pass changing layout about 2.2 us with
// its cluster barrier (benchmarks/torch_bwd_profile.py; PERF.md has the
// breakdown).  The shared memory a row of remat takes bounds R (6 at the o
// tile over 4 blocks), and a pass across blocks costs more than the rows
// more blocks would add, so the planner takes the fewest lane blocks that
// hold BWD_MIN_ROWS rows.
//
// Numerics.  The remat rounds exactly as the forward engine's walk (K1)
// does and the cotangent walk as the plain version's (kernels/ref.py
// `stage_vjp`), every product and sum on its own (__fmul_rn / __fadd_rn),
// so g_x stays bit for bit the plain version's.  Only the order of the
// sums over rows is new: per thread in row order, over row slices, chunks
// and groups in order; any order of k terms stays within gamma_k of the
// sum of their magnitudes.
//
// Shared-memory budget (bytes, `layout`): table and accumulators 2 x L x
// w/2 x 16; the later row slices' sums of two passes 4 (rs-1) w/2 x 16;
// stage and pass set-up L x (24 + 28); per-lane sums nvec x w x 4; remat
// (passes + 1, + 1 with layout B) x R x w x 4; x staging 2 x R x w x |x|;
// gy staging R x w x |io| (4 in layout B); K6's package 2 x R x w x |io|.
// At K2's o tile (nt 2048, 11 stages, bf16) over 4 blocks of 512 lanes:
// 90 KiB of table and grads, 20 KiB a row, R = 6.  Registers: a pass holds
// its coefficients (four float4 in a fused pass), its grad sums and one or
// two rows; __launch_bounds__(512, 1) leaves 128 a thread, no spills.
//
// K4 (spm_block_bwd.cu) walks here too: its remat prologue and the norm's
// backward around the walk, a second stack's tables beside the first, and
// the norm's row mean summed across the cluster's blocks.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "spm_common.cuh"

namespace spm_bwd {

namespace cg = cooperative_groups;

// The planner's launch shape: C lane blocks a tile, w lanes a block, pb =
// w/2 pair slots, rs row slices (pb * rs threads), R rows a chunk, G row
// groups.
struct Shape {
  int C, w, pb, rs, R, G;
  // host-set: passes, whether the spare tile is kept, whether z_L (and the
  // staged gy) is in layout B
  int np, spare, tailb;
};

__host__ __device__ __forceinline__ long align16(long b) {
  return (b + 15) & ~15L;
}

// One stage's walk, set up once per block: its stride, mode, slot divisor
// d with the magic numbers of d and 2d, and for kPaired whether this block
// is the high one of its pair.
enum { kLocalA = 0, kLocalB = 1, kCross = 2, kPaired = 3 };
enum { kLayA = 0, kLayB = 1 };
struct Stage {
  int s, mode, d;
  unsigned mag, mag2;
  int high;
};

// A pass of the walk: stage l alone (n = 1), or stages l and l+1 over
// quads of lanes (n = 2, both local to one layout, their strides nested);
// its layout; the layouts its forward output and its reverse output take
// (the next and the previous pass's, z_L's or g_x's); whether either
// touches other blocks' tiles.
struct Pass {
  int l, n, lin, lof, lob, remf, remb;
};

// The modes of the stages (C lane blocks of w lanes; host or device): a
// stage local to layout A runs there; a run of two or more stages that are
// not, all of strides C divides, runs in layout B (its two changes of layout
// pay for themselves); any other stage reaches across blocks in layout A,
// kPaired when its stride is a multiple of w (one lane of each pair in the
// processing block: blocks c and c ^ s/w split their pairs), else kCross
// (both lanes wherever they are).  Then the passes: two consecutive stages
// local to one layout whose strides (in that layout's offsets) nest, the
// larger a multiple of twice the smaller, fuse; z_L is kept in `tail` (-1:
// the last pass's layout). Returns the pass count.  The planner's
// `bwd_stage_modes` and `bwd_passes` mirror it.
__host__ __device__ inline int plan_walk(const SpmStrides& st, int w, int C,
                                         int tail, int* mode, Pass* ps) {
  const int L = st.n;
  for (int l = 0; l < L;) {
    int e = l;
    while (e < L && w % (2 * st.s[e]) && st.s[e] % C == 0) ++e;
    const int end = e - l >= 2 ? e : l + 1;
    for (int k = l; k < end; ++k) {
      const int s = st.s[k];
      mode[k] = w % (2 * s) == 0 ? kLocalA
                : e - l >= 2     ? kLocalB
                : s % w == 0     ? kPaired
                                 : kCross;
    }
    l = end;
  }
  int np = 0;
  for (int l = 0; l < L;) {
    int n = 1;
    if (l + 1 < L && mode[l] == mode[l + 1] &&
        (mode[l] == kLocalA || mode[l] == kLocalB)) {
      const int f = mode[l] == kLocalB ? C : 1;
      const int s0 = st.s[l], s1 = st.s[l + 1];
      const int da = (s0 < s1 ? s0 : s1) / f, db = (s0 < s1 ? s1 : s0) / f;
      if (db % (2 * da) == 0) n = 2;
    }
    ps[np].l = l;
    ps[np].n = n;
    ps[np].lin = mode[l] == kLocalB ? kLayB : kLayA;
    ++np;
    l += n;
  }
  for (int k = 0; k < np; ++k) {
    Pass& p = ps[k];
    p.lof = k + 1 < np ? ps[k + 1].lin : (tail < 0 ? p.lin : tail);
    p.lob = k > 0 ? ps[k - 1].lin : kLayA;
    const bool x = mode[p.l] == kCross || mode[p.l] == kPaired;
    p.remf = x || p.lin != p.lof;
    p.remb = x || p.lin != p.lob;
  }
  return np;
}

// The pass count, whether any stage runs in layout B and whether z_L is
// kept in it (host side; tail as in plan_walk).
__host__ inline int count_passes(const SpmStrides& st, int w, int C,
                                 int tail, bool* uses_b, bool* tail_b) {
  int mode[SPM_MAX_STAGES];
  Pass ps[SPM_MAX_STAGES];
  const int np = plan_walk(st, w, C, tail, mode, ps);
  *uses_b = false;
  for (int l = 0; l < st.n; ++l) *uses_b = *uses_b || mode[l] == kLocalB;
  *tail_b = np > 0 && ps[np - 1].lof == kLayB;
  return np;
}

// Byte offsets of one block's shared memory (kernels/spm_stack.py
// `bwd_smem_bytes` computes the same total).
struct Layout {
  long tbl, acc, part, stg, pas, vacc, tiles, xst, xst_stride, gst, pkg,
      pkg_stride, total;
};

__host__ __device__ inline Layout layout(int L, int np, int w, int R, int rs,
                                         int nvec, int x_bytes, int io_bytes,
                                         bool package, bool spare) {
  Layout o;
  long at = 0;
  const long pb = w / 2;
  o.tbl = at;
  at += align16(L * pb * 16);
  o.acc = at;
  at += align16(L * pb * 16);
  o.part = at;  // two passes' grad sums of row slices 1 .. rs-1
  at += align16(2 * 2 * (rs - 1) * pb * 16);
  o.stg = at;
  at += align16((long)L * sizeof(Stage));
  o.pas = at;
  at += align16((long)np * sizeof(Pass));
  o.vacc = at;
  at += align16((long)nvec * w * 4);
  o.tiles = at;  // the passes' inputs, z_L [, the spare]
  at += align16((long)(np + 1 + spare) * R * w * 4);
  o.xst = at;
  o.xst_stride = align16((long)R * w * x_bytes);
  at += 2 * o.xst_stride;
  o.gst = at;  // gy: io_bytes a lane, or its 4-byte word in layout B
  at += align16((long)R * w * io_bytes);
  o.pkg = at;
  o.pkg_stride = align16((long)R * w * io_bytes);
  if (package) at += 2 * o.pkg_stride;
  o.total = at;
  return o;
}

// Set a shape's pass count, spare tile and z_L layout from its strides
// (host side; tail as in plan_walk).
__host__ inline void set_passes(const SpmStrides& st, int tail, Shape* sh) {
  bool b, t;
  sh->np = count_passes(st, sh->w, sh->C, tail, &b, &t);
  sh->spare = b;
  sh->tailb = t;
}

__host__ __device__ inline Layout layout_of(int L, const Shape& sh, int nvec,
                                            int x_bytes, int io_bytes,
                                            bool package) {
  return layout(L, sh.np, sh.w, sh.R, sh.rs, nvec, x_bytes,
                sh.tailb ? 4 : io_bytes, package, sh.spare);
}

// q / d for q, d < 2^16 by one multiply-high (mag = 2^32 / d rounded up;
// 0 for d = 1).
__device__ __forceinline__ unsigned magic(unsigned d) {
  return d == 1 ? 0u : 0xFFFFFFFFu / d + 1u;
}
__device__ __forceinline__ int divm(int q, int d, unsigned mag) {
  return d == 1 ? q : (int)__umulhi((unsigned)q, mag);
}

// Where a block is in its cluster: lane block c (of C, w lanes each, log2
// C = logC) of the tile whose lane block 0 is cluster rank rank0; magw
// divides by w.
struct Geo {
  int L, w, pb, rs, R, c, rank0, C, logC;
  unsigned magw;
};

__device__ __forceinline__ void sync(bool cluster_wide) {
  if (cluster_wide)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// The low lane of slot q's pair in a stage (single-stage passes).
__device__ __forceinline__ int slot_lane0(const Stage& sg, const Geo& g,
                                          int q) {
  if (sg.mode == kLocalB) {
    const int qd = divm(q, sg.d, sg.mag);
    return (qd * 2 * sg.d + (q - qd * sg.d)) * g.C + g.c;
  }
  if (sg.mode == kPaired)
    return sg.high ? g.c * g.w + g.pb + q - sg.s : g.c * g.w + q;
  const int p = g.c * g.pb + q;
  const int pd = divm(p, sg.d, sg.mag);
  return pd * 2 * sg.d + (p - pd * sg.d);
}

// The slot of the pair whose low lane sits at offset m of a block in a
// stage local to its layout (offset stride d): slot_lane0's inverse.
__device__ __forceinline__ int slot_of(const Stage& sg, int m) {
  const int t = divm(m, 2 * sg.d, sg.mag2);
  return t * sg.d + (m - 2 * t * sg.d);
}

// Set up the stages and passes of lane block c (one thread; tail as in
// plan_walk; the host's set_passes counted the passes); the caller
// synchronises.
__device__ __forceinline__ void setup(const SpmStrides& st, int w, int C,
                                      int c, int tail, Stage* stg,
                                      Pass* ps) {
  if (threadIdx.x) return;
  int mode[SPM_MAX_STAGES];
  plan_walk(st, w, C, tail, mode, ps);
  for (int l = 0; l < st.n; ++l) {
    Stage sg;
    sg.s = st.s[l];
    sg.mode = mode[l];
    sg.d = sg.mode == kLocalB ? sg.s / C : sg.s;
    sg.mag = magic((unsigned)sg.d);
    sg.mag2 = magic((unsigned)(2 * sg.d));
    sg.high = sg.mode == kPaired ? (c / (sg.s / w)) & 1 : 0;
    stg[l] = sg;
  }
}

// Lane `lane`'s element of row 0 of `base` (this block's copy of a tile)
// under layout lay: in this block's tile (kRemote false: the caller knows
// the lane is this block's), or in the owner's through distributed shared
// memory.
template <bool kRemote>
__device__ __forceinline__ float* at(float* base, const Geo& g, int lane,
                                     int lay) {
  if (!kRemote)
    return base + (lay == kLayB ? lane >> g.logC : lane - g.c * g.w);
  int o, off;
  if (lay == kLayB) {
    o = lane & (g.C - 1);
    off = lane >> g.logC;
  } else {
    o = g.C == 1 ? 0 : (int)__umulhi((unsigned)lane, g.magw);
    off = lane - o * g.w;
  }
  if (o == g.c) return base + off;
  return cg::this_cluster().map_shared_rank(base + off, g.rank0 + o);
}

// 16-byte asynchronous copies into shared memory; bytes past `src_bytes`
// are zero-filled.
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [row0, row0 + rows) of the global (., ld) operand `src`, columns
// [col0, col0 + w), zero from column `lim` on, into dst (rows x w, rows
// `dld` apart, default w): 16-byte cp.async when every row's segment is
// 16-byte aligned on both sides, else plain loads.  The copies are one
// commit group.
template <typename U>
__device__ __forceinline__ void stage_rows(U* dst, const U* src, long ld,
                                           long row0, int rows, int w,
                                           long col0, long lim,
                                           int dld = 0) {
  constexpr int per = 16 / (int)sizeof(U);
  if (!dld) dld = w;
  const bool vec = ((uintptr_t)src % 16 == 0) &&
                   (ld * (long)sizeof(U)) % 16 == 0 &&
                   (col0 * (long)sizeof(U)) % 16 == 0 && w % per == 0 &&
                   ((uintptr_t)dst % 16 == 0) &&
                   ((long)dld * (long)sizeof(U)) % 16 == 0;
  if (vec) {
    const int groups = w / per;
    for (int gi = threadIdx.x % groups, r = threadIdx.x / groups; r < rows;
         gi += blockDim.x % groups, r += blockDim.x / groups) {
      if (gi >= groups) {
        gi -= groups;
        ++r;
        if (r >= rows) break;
      }
      const long col = col0 + (long)gi * per;
      long valid = lim - col;
      valid = valid < 0 ? 0 : (valid > per ? per : valid);
      const U* s = src + (row0 + r) * ld + (valid > 0 ? col : 0);
      cp16(dst + (long)r * dld + gi * per, s, (int)(valid * sizeof(U)));
    }
  } else {
    for (int e = threadIdx.x; e < rows * w; e += blockDim.x) {
      const int r = e / w;
      const int i = e - r * w;
      const long col = col0 + i;
      dst[(long)r * dld + i] = col < lim ? src[(row0 + r) * ld + col] : U{};
    }
  }
  cp_commit();
}

// 4-byte asynchronous copy into shared memory (src_bytes of it read, the
// rest zero-filled).
__device__ __forceinline__ void cp4(void* dst, const void* src,
                                    int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Rows [row0, row0 + rows) of the global (., ld) operand `src` of `total`
// elements at the columns col0 + m C + c (layout B: m < w), zero from
// column `lim` on, into dst (rows x w 4-byte words): each element comes
// with the 4-byte word holding it (a 2-byte element in its low or high
// half, word_half says which).  One commit group.
template <typename U>
__device__ __forceinline__ void stage_rows_b(uint32_t* dst, const U* src,
                                             long ld, long total, long row0,
                                             int rows, int w, int C, int c,
                                             long col0, long lim) {
  for (int m = threadIdx.x; m < w; m += blockDim.x)
  for (int r = 0; r < rows; ++r) {
    const int e = r * w + m;
    const long col = col0 + (long)m * C + c;
    const long idx = (row0 + r) * ld + col;
    if (col >= lim)
      cp4(dst + e, src, 0);
    else if (sizeof(U) == 4 || !(idx & 1))
      cp4(dst + e, src + idx, sizeof(U) == 4 || idx + 1 < total ? 4 : 2);
    else
      cp4(dst + e, src + idx - 1, 4);
  }
  cp_commit();
}
template <typename U>
__device__ __forceinline__ float word_half(uint32_t v, long idx);
template <>
__device__ __forceinline__ float word_half<float>(uint32_t v, long) {
  return __uint_as_float(v);
}
template <>
__device__ __forceinline__ float word_half<__nv_bfloat16>(uint32_t v,
                                                          long idx) {
  return __uint_as_float((idx & 1 ? v >> 16 : v & 0xFFFFu) << 16);
}

// 16 bytes of f32 rows (v 16-byte aligned) in the type of dst.
__device__ __forceinline__ void store16(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(v);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
  const float4 a = *reinterpret_cast<const float4*>(v);
  const float4 b = *reinterpret_cast<const float4*>(v + 4);
  __nv_bfloat162 h[4] = {
      __floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
      __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
}

// Two adjacent lanes (2k, 2k+1) of a row in shared memory or of an (n,)
// vector, as f32 (exact conversions), and back.
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const int8_t* p) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  return make_float2((float)v.x, (float)v.y);
}
__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}
// A vector's two lanes, (1, 1) where it is absent.
__device__ __forceinline__ float2 vec2(const float* v, int i) {
  if (!v) return make_float2(1.f, 1.f);
  if ((uintptr_t)(v + i) % 8)
    return make_float2(__ldg(v + i), __ldg(v + i + 1));
  return __ldg(reinterpret_cast<const float2*>(v + i));
}
__device__ __forceinline__ float2 mul2(float2 a, float2 b) {
  return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
}
__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

// The f32 rows `src` (rows x w, rows `sld` apart, default w) into columns
// [col0, col0 + w) of rows [row0, row0 + rows) of the global (., ld)
// `dst`, in its type, columns from `lim` on dropped: 16-byte stores where
// aligned, else plain ones.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, long ld, long row0,
                                           int rows, int w, long col0,
                                           long lim, const float* src,
                                           int sld = 0) {
  constexpr int per = 16 / (int)sizeof(T);
  if (!sld) sld = w;
  const bool vec = ((uintptr_t)dst % 16 == 0) &&
                   (ld * (long)sizeof(T)) % 16 == 0 &&
                   (col0 * (long)sizeof(T)) % 16 == 0 && w % per == 0 &&
                   ((uintptr_t)src % 16 == 0) && sld % 4 == 0;
  if (vec) {
    const int groups = w / per;
    for (int gi = threadIdx.x % groups, r = threadIdx.x / groups; r < rows;
         gi += blockDim.x % groups, r += blockDim.x / groups) {
      if (gi >= groups) {
        gi -= groups;
        ++r;
        if (r >= rows) break;
      }
      const long col = col0 + (long)gi * per;
      const float* v = src + (long)r * sld + gi * per;
      T* d = dst + (row0 + r) * ld + col;
      if (col + per <= lim) {
        store16(d, v);
      } else {
        for (int k = 0; k < per; ++k)
          if (col + k < lim) spm_st(d + k, v[k]);
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * w; e += blockDim.x) {
      const int r = e / w;
      const int i = e - r * w;
      if (col0 + i < lim)
        spm_st(dst + (row0 + r) * ld + col0 + i, src[(long)r * sld + i]);
    }
  }
}

// Copy the coefficients of this block's pair slots into `tbl` (L x pb,
// an int8 table dequantized once) and zero the accumulators.  `cf` points
// at the tile's first pair of stage 0; stage l is `pair_stride` pairs on.
// The stages are set up (and synchronised) already.
template <typename CF>
__device__ __forceinline__ void load_table(const Geo& g, const Stage* stg,
                                           const CF& cf, long pair_stride,
                                           float4* tbl, float4* acc,
                                           float* vacc, int nvec) {
  for (int e = threadIdx.x; e < g.L * g.pb; e += blockDim.x) {
    const int l = e / g.pb;
    const int s = stg[l].s;
    const int i0 = slot_lane0(stg[l], g, e - l * g.pb);
    const int p = (i0 / (2 * s)) * s + i0 % (2 * s);
    tbl[e] = spm_cf(cf, l, (long)l * pair_stride + p);
    acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int e = threadIdx.x; e < nvec * g.w; e += blockDim.x) vacc[e] = 0.f;
}

// Each slot's accumulated pair grads into the partial slice `part` (the
// tile's first pair of stage 0; stage l `pair_stride` float4s on).  Every
// pair of the tile has one slot in the cluster, so one writer.
__device__ __forceinline__ void store_table_grads(const Geo& g,
                                                  const Stage* stg,
                                                  const float4* acc,
                                                  float4* part,
                                                  long pair_stride) {
  for (int e = threadIdx.x; e < g.L * g.pb; e += blockDim.x) {
    const int l = e / g.pb;
    const int s = stg[l].s;
    const int i0 = slot_lane0(stg[l], g, e - l * g.pb);
    part[(long)l * pair_stride + (i0 / (2 * s)) * s + i0 % (2 * s)] = acc[e];
  }
}

// Stage l forward: tile l (layout lay_in) -> tile l+1 (layout lay_out),
// rows [0, rows) of the chunk.
template <bool kRemote>
__device__ __forceinline__ void fwd_pass(const Geo& g, const Stage& sg,
                                         int lay_in, int lay_out, int rows,
                                         float4 c, int q, int r0, float* tin,
                                         float* tout) {
  constexpr int kB = kRemote ? 4 : 2;  // rows in flight
  const int i0 = slot_lane0(sg, g, q);
  const float* a0 = at<kRemote>(tin, g, i0, lay_in);
  const float* a1 = at<kRemote>(tin, g, i0 + sg.s, lay_in);
  float* b0 = at<kRemote>(tout, g, i0, lay_out);
  float* b1 = at<kRemote>(tout, g, i0 + sg.s, lay_out);
  const long step = (long)g.rs * g.w;
  int r = r0;
  for (; r + (kB - 1) * g.rs < rows; r += kB * g.rs) {
    const long o = (long)r * g.w;
    float x0[kB], x1[kB];
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      x0[k] = a0[o + k * step];
      x1[k] = a1[o + k * step];
    }
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      b0[o + k * step] =
          __fadd_rn(__fmul_rn(c.x, x0[k]), __fmul_rn(c.y, x1[k]));
      b1[o + k * step] =
          __fadd_rn(__fmul_rn(c.z, x0[k]), __fmul_rn(c.w, x1[k]));
    }
  }
  for (; r < rows; r += g.rs) {
    const long o = (long)r * g.w;
    const float x0 = a0[o], x1 = a1[o];
    b0[o] = __fadd_rn(__fmul_rn(c.x, x0), __fmul_rn(c.y, x1));
    b1[o] = __fadd_rn(__fmul_rn(c.z, x0), __fmul_rn(c.w, x1));
  }
}

// Stage l backward: the cotangent `dcur` (layout lay_in) <- B_l^T into
// `dout` (layout lay_out; dcur itself when the layouts agree); returns the
// pair grads of this thread's rows (rows r0, r0 + rs, ...), in row order.
template <bool kRemote>
__device__ __forceinline__ float4 bwd_pass(const Geo& g, const Stage& sg,
                                           int lay_in, int lay_out, int rows,
                                           float4 c, int q, int r0,
                                           float* tin, float* dcur,
                                           float* dout) {
  constexpr int kB = kRemote ? 4 : 2;
  const int i0 = slot_lane0(sg, g, q);
  const int i1 = i0 + sg.s;
  const float* a0 = at<kRemote>(tin, g, i0, lay_in);
  const float* a1 = at<kRemote>(tin, g, i1, lay_in);
  const float* d0p = at<kRemote>(dcur, g, i0, lay_in);
  const float* d1p = at<kRemote>(dcur, g, i1, lay_in);
  float* e0p = at<kRemote>(dout, g, i0, lay_out);
  float* e1p = at<kRemote>(dout, g, i1, lay_out);
  const long step = (long)g.rs * g.w;
  float ga = 0.f, gb = 0.f, gc = 0.f, gd = 0.f;
  int r = r0;
  for (; r + (kB - 1) * g.rs < rows; r += kB * g.rs) {
    const long o = (long)r * g.w;
    float x0[kB], x1[kB], d0[kB], d1[kB];
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      x0[k] = a0[o + k * step];
      x1[k] = a1[o + k * step];
      d0[k] = d0p[o + k * step];
      d1[k] = d1p[o + k * step];
    }
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      ga = __fadd_rn(ga, __fmul_rn(d0[k], x0[k]));
      gb = __fadd_rn(gb, __fmul_rn(d0[k], x1[k]));
      gc = __fadd_rn(gc, __fmul_rn(d1[k], x0[k]));
      gd = __fadd_rn(gd, __fmul_rn(d1[k], x1[k]));
      e0p[o + k * step] =
          __fadd_rn(__fmul_rn(c.x, d0[k]), __fmul_rn(c.z, d1[k]));
      e1p[o + k * step] =
          __fadd_rn(__fmul_rn(c.y, d0[k]), __fmul_rn(c.w, d1[k]));
    }
  }
  for (; r < rows; r += g.rs) {
    const long o = (long)r * g.w;
    const float x0 = a0[o], x1 = a1[o];
    const float d0 = d0p[o], d1 = d1p[o];
    ga = __fadd_rn(ga, __fmul_rn(d0, x0));
    gb = __fadd_rn(gb, __fmul_rn(d0, x1));
    gc = __fadd_rn(gc, __fmul_rn(d1, x0));
    gd = __fadd_rn(gd, __fmul_rn(d1, x1));
    e0p[o] = __fadd_rn(__fmul_rn(c.x, d0), __fmul_rn(c.z, d1));
    e1p[o] = __fadd_rn(__fmul_rn(c.y, d0), __fmul_rn(c.w, d1));
  }
  return make_float4(ga, gb, gc, gd);
}

__device__ __forceinline__ void add4(float4* a, float4 v) {
  const float4 o = *a;
  *a = make_float4(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y),
                   __fadd_rn(o.z, v.z), __fadd_rn(o.w, v.w));
}

// A quad of two fused stages (strides d1 of stage l, d2 of l+1, offsets of
// the pass's layout): quad u's base offset m0 (zero at both strides'
// bits) and the slots of its four pairs, (m0, m0+d1) and (m0+d2,
// m0+d1+d2) in stage l, (m0, m0+d2) and (m0+d1, m0+d1+d2) in stage l+1.
struct Quad {
  int m0, qa, qb, qc, qd;
};
__device__ __forceinline__ Quad quad(const Stage& s1, const Stage& s2,
                                     int u) {
  const Stage& a = s1.d < s2.d ? s1 : s2;  // the smaller stride
  const Stage& b = s1.d < s2.d ? s2 : s1;   // a multiple of twice a's
  Quad q;
  const int ub = divm(2 * u, b.d, b.mag);  // u / (db/2)
  const int rb = u - ub * (b.d >> 1);
  const int ua = divm(rb, a.d, a.mag);
  q.m0 = ub * 2 * b.d + ua * 2 * a.d + (rb - ua * a.d);
  q.qa = slot_of(s1, q.m0);
  q.qb = slot_of(s1, q.m0 + s2.d);
  q.qc = slot_of(s2, q.m0);
  q.qd = slot_of(s2, q.m0 + s1.d);
  return q;
}

// The lane (of the tile) at offset m of this block under layout lay.
__device__ __forceinline__ int lane_at(const Geo& g, int m, int lay) {
  return lay == kLayB ? m * g.C + g.c : g.c * g.w + m;
}

__device__ __forceinline__ float2 mix2(float4 c, float x0, float x1) {
  return make_float2(__fadd_rn(__fmul_rn(c.x, x0), __fmul_rn(c.y, x1)),
                     __fadd_rn(__fmul_rn(c.z, x0), __fmul_rn(c.w, x1)));
}
// B^T: (a d0 + c d1, b d0 + d d1)
__device__ __forceinline__ float2 mixt(float4 c, float d0, float d1) {
  return make_float2(__fadd_rn(__fmul_rn(c.x, d0), __fmul_rn(c.z, d1)),
                     __fadd_rn(__fmul_rn(c.y, d0), __fmul_rn(c.w, d1)));
}
__device__ __forceinline__ void grad4(float4& g, float d0, float d1,
                                      float x0, float x1) {
  g = make_float4(__fadd_rn(g.x, __fmul_rn(d0, x0)),
                  __fadd_rn(g.y, __fmul_rn(d0, x1)),
                  __fadd_rn(g.z, __fmul_rn(d1, x0)),
                  __fadd_rn(g.w, __fmul_rn(d1, x1)));
}

// Two fused stages forward: tile (layout P.lin, this block's) -> the next
// tile (layout P.lof), the middle stage kept in registers.
template <bool kRemote>
__device__ __forceinline__ void fwd_quad(const Geo& g, const Pass& P,
                                         const Stage& s1, const Stage& s2,
                                         const float4* tbl, int rows, int u,
                                         int r0, int slices, const float* tin,
                                         float* tout) {
  const Quad q = quad(s1, s2, u);
  const float4 ca = tbl[P.l * g.pb + q.qa], cb = tbl[P.l * g.pb + q.qb];
  const float4 cc = tbl[(P.l + 1) * g.pb + q.qc];
  const float4 cd = tbl[(P.l + 1) * g.pb + q.qd];
  const int m[4] = {q.m0, q.m0 + s1.d, q.m0 + s2.d, q.m0 + s1.d + s2.d};
  float* o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o[k] = at<kRemote>(tout, g, lane_at(g, m[k], P.lin), P.lof);
  for (int r = r0; r < rows; r += slices) {
    const long off = (long)r * g.w;
    const float x00 = tin[off + m[0]], x10 = tin[off + m[1]];
    const float x01 = tin[off + m[2]], x11 = tin[off + m[3]];
    const float2 ya = mix2(ca, x00, x10);  // stage l: (00, 10), (01, 11)
    const float2 yb = mix2(cb, x01, x11);
    const float2 zc = mix2(cc, ya.x, yb.x);  // stage l+1: (00, 01), (10, 11)
    const float2 zd = mix2(cd, ya.y, yb.y);
    o[0][off] = zc.x;
    o[2][off] = zc.y;
    o[1][off] = zd.x;
    o[3][off] = zd.y;
  }
}

// Two fused stages backward from the cotangent `dcur` of their output
// (layout P.lin) into `dout` (layout P.lob): stage l's output recomputed
// from the tile (bitwise the forward's); the grads of the four pairs of
// this thread's rows returned in row order (stage l: ga, gb; l+1: gc, gd).
template <bool kRemote>
__device__ __forceinline__ void bwd_quad(const Geo& g, const Pass& P,
                                         const Stage& s1, const Stage& s2,
                                         const float4* tbl, int rows, int u,
                                         int r0, int slices, const float* tin,
                                         const float* dcur, float* dout,
                                         Quad* qout, float4* gs) {
  const Quad q = quad(s1, s2, u);
  *qout = q;
  const float4 ca = tbl[P.l * g.pb + q.qa], cb = tbl[P.l * g.pb + q.qb];
  const float4 cc = tbl[(P.l + 1) * g.pb + q.qc];
  const float4 cd = tbl[(P.l + 1) * g.pb + q.qd];
  const int m[4] = {q.m0, q.m0 + s1.d, q.m0 + s2.d, q.m0 + s1.d + s2.d};
  float* o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o[k] = at<kRemote>(dout, g, lane_at(g, m[k], P.lin), P.lob);
  float4 ga = make_float4(0.f, 0.f, 0.f, 0.f), gb = ga, gc = ga, gd = ga;
  for (int r = r0; r < rows; r += slices) {
    const long off = (long)r * g.w;
    const float x00 = tin[off + m[0]], x10 = tin[off + m[1]];
    const float x01 = tin[off + m[2]], x11 = tin[off + m[3]];
    const float d00 = dcur[off + m[0]], d10 = dcur[off + m[1]];
    const float d01 = dcur[off + m[2]], d11 = dcur[off + m[3]];
    const float2 ya = mix2(ca, x00, x10);
    const float2 yb = mix2(cb, x01, x11);
    grad4(gc, d00, d01, ya.x, yb.x);  // stage l+1, pair (00, 01)
    grad4(gd, d10, d11, ya.y, yb.y);  // pair (10, 11)
    const float2 ec = mixt(cc, d00, d01);
    const float2 ed = mixt(cd, d10, d11);
    grad4(ga, ec.x, ed.x, x00, x10);  // stage l, pair (00, 10)
    grad4(gb, ec.y, ed.y, x01, x11);  // pair (01, 11)
    const float2 fa = mixt(ca, ec.x, ed.x);
    const float2 fb = mixt(cb, ec.y, ed.y);
    o[0][off] = fa.x;
    o[1][off] = fa.y;
    o[2][off] = fb.x;
    o[3][off] = fb.y;
  }
  gs[0] = ga;
  gs[1] = gb;
  gs[2] = gc;
  gs[3] = gd;
}

// The remat of a chunk: tile 0 (written in pass 0's layout, and
// synchronised) through every pass, so tile k holds pass k's input and
// tile np the run's output (layout P.lof of the last pass).
// `tail_remote`: whether the pass after the last one touches other
// blocks' tiles (the barrier before it is then the cluster's).
__device__ __forceinline__ void remat(const Geo& g, const Stage* stg,
                                      const Pass* ps, int np, int rows,
                                      const float4* tbl, float* tiles,
                                      bool tail_remote) {
  const int q = threadIdx.x % g.pb;  // a warp: consecutive slots of a slice
  const int r0 = threadIdx.x / g.pb;
  // quads: one thread each (half the slots), the same slices, the rest idle
  const int nq = g.pb >> 1;
  const int u = q % nq;
  const bool quad_thread = q < nq;
  const long ts = (long)g.R * g.w;
  for (int k = 0; k < np; ++k) {
    const Pass P = ps[k];
    float* tin = tiles + k * ts;
    if (P.n == 2) {
      if (!quad_thread)
        ;
      else if (P.remf)
        fwd_quad<true>(g, P, stg[P.l], stg[P.l + 1], tbl, rows, u, r0, g.rs,
                       tin, tin + ts);
      else
        fwd_quad<false>(g, P, stg[P.l], stg[P.l + 1], tbl, rows, u, r0,
                        g.rs, tin, tin + ts);
    } else {
      const Stage sg = stg[P.l];
      const float4 c = tbl[P.l * g.pb + q];
      if (P.remf)
        fwd_pass<true>(g, sg, P.lin, P.lof, rows, c, q, r0, tin, tin + ts);
      else
        fwd_pass<false>(g, sg, P.lin, P.lof, rows, c, q, r0, tin, tin + ts);
    }
    sync(P.remf || (k + 1 < np ? ps[k + 1].remf : tail_remote));
  }
}

// Fold the row slices 1 .. rs-1 of a pass's grad sums (left in `part`
// before the barrier) into the accumulators, in slice order.
__device__ __forceinline__ void fold(const Geo& g, const Pass& P, int k,
                                     float4* acc, const float4* part) {
  if (g.rs == 1 || threadIdx.x >= g.pb) return;
  const int t = threadIdx.x;
  for (int j = 0; j < P.n; ++j)
    for (int sl = 1; sl < g.rs; ++sl)
      add4(acc + (P.l + j) * g.pb + t,
           part[(((k & 1) * 2 + j) * (g.rs - 1) + sl - 1) * g.pb + t]);
}

// The reverse walk of a chunk from the cotangent `dcur` of z_L (tile np,
// or the spare tile, in the last pass's layout; synchronised); returns
// where the cotangent of tile 0 ends up (layout A), synchronised for
// per-lane reads.  Each pass's row slice 0 adds its sums to the
// accumulators, the later slices' go through `part` and are folded in
// slice order once every slice has passed the barrier.
__device__ __forceinline__ float* walk_back(const Geo& g, const Stage* stg,
                                            const Pass* ps, int np, int rows,
                                            const float4* tbl, float4* acc,
                                            float4* part, float* tiles,
                                            float* dcur) {
  const int q = threadIdx.x % g.pb;
  const int r0 = threadIdx.x / g.pb;
  const int nq = g.pb >> 1;
  const int u = q % nq;
  const bool quad_thread = q < nq;
  const long ts = (long)g.R * g.w;
  float* tL = tiles + np * ts;
  for (int k = np - 1; k >= 0; --k) {
    const Pass P = ps[k];
    float* tin = tiles + k * ts;
    float* dout = P.lin == P.lob ? dcur : (dcur == tL ? tL + ts : tL);
    const int stride = g.rs - 1;
    if (P.n == 2) {
      if (quad_thread) {
        Quad qd;
        float4 gs[4];
        if (P.remb)
          bwd_quad<true>(g, P, stg[P.l], stg[P.l + 1], tbl, rows, u, r0,
                         g.rs, tin, dcur, dout, &qd, gs);
        else
          bwd_quad<false>(g, P, stg[P.l], stg[P.l + 1], tbl, rows, u, r0,
                          g.rs, tin, dcur, dout, &qd, gs);
        const int slot[4] = {qd.qa, qd.qb, qd.qc, qd.qd};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e >> 1;  // stage l or l+1
          if (r0 == 0)
            add4(acc + (P.l + j) * g.pb + slot[e], gs[e]);
          else
            part[(((k & 1) * 2 + j) * stride + r0 - 1) * g.pb + slot[e]] =
                gs[e];
        }
      }
    } else {
      const Stage sg = stg[P.l];
      const float4 c = tbl[P.l * g.pb + q];
      const float4 gs =
          P.remb ? bwd_pass<true>(g, sg, P.lin, P.lob, rows, c, q, r0, tin,
                                  dcur, dout)
                 : bwd_pass<false>(g, sg, P.lin, P.lob, rows, c, q, r0, tin,
                                   dcur, dout);
      if (r0 == 0)
        add4(acc + P.l * g.pb + q, gs);
      else
        part[(((k & 1) * 2) * stride + r0 - 1) * g.pb + q] = gs;
    }
    dcur = dout;
    sync(P.remb || (k > 0 && ps[k - 1].remb));
    fold(g, P, k, acc, part);
  }
  return dcur;
}

// Store v at lane `lane` (this block's under layout A, at offset i) of row
// r of a tile kept in layout lay: here, or in the owner's copy.
__device__ __forceinline__ void put(float* base, const Geo& g, int lay,
                                    int r, int i, float v) {
  if (lay == kLayA) {
    base[(long)r * g.w + i] = v;
  } else {
    at<true>(base, g, g.c * g.w + i, kLayB)[(long)r * g.w] = v;
  }
}

// Launch a cluster kernel with `cluster` blocks along x.
template <typename K, typename... Args>
static inline cudaError_t launch(K kernel, dim3 grid, int threads,
                                 size_t smem, int cluster,
                                 cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// How many clusters of `cluster` blocks of this kernel fit the card at once
// (cudaOccupancyMaxActiveClusters), 0 on error.
template <typename K>
static inline int max_clusters(K kernel, int threads, size_t smem,
                               int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
    return 0;
  return n;
}

static inline bool valid_shape(const Shape& sh, int nt) {
  return (sh.C == 1 || sh.C == 2 || sh.C == 4 || sh.C == 8) &&
         sh.w * sh.C == nt && sh.w % 2 == 0 &&
         sh.pb * 2 == sh.w && sh.rs >= 1 && sh.rs <= 32 &&
         (sh.rs & (sh.rs - 1)) == 0 && sh.R >= 1 && sh.G >= 1 &&
         sh.pb * sh.rs <= 512 && (sh.rs == 1 || (sh.pb * sh.rs) % 32 == 0);
}

}  // namespace spm_bwd
