// The forward engine of K1 (spm_stack.cu), K3 (spm_block.cu) and K5
// (spm_overlap.cu): the stage walk of one planned run over a block's chunk
// of rows, the loads that feed it and the stores that drain it.
//
// Design.  A block holds one feature tile (w = nt lanes), or at decode rows
// one lane block of it (w = nt / C, a cluster of C), for chunks of R rows:
// G row groups walk chunks g, g + G, ... (persistent: G about as many
// blocks as the card holds at once).  A chunk's x comes in by cp.async one
// chunk ahead, in its own type, into a staging buffer; the stages then run
// in passes over an f32 tile in shared memory, and the last pass stores y
// from registers.  The walk (stages, passes, their magic numbers) is
// planned on the host and passed as a __grid_constant__ parameter
// (make_plan): no thread plans or divides on the device.
//
//  * Fewer passes.  Consecutive stages whose strides ascend and nest (each
//    a multiple of twice the one before) fuse, up to kMaxFuse = 3: a thread
//    holds a group of 2^m lanes of a row in registers (lanes m0 + sum of a
//    subset of the m strides, as in a radix-2^m FFT pass) and applies all m
//    stages there; one barrier closes the pass.  The 11-stage o tile walks
//    in 4 passes (1 2 4 | 8 16 32 | 64 128 256 | 512 1024), K5's 9-stage
//    shard run in 3; strides that do not nest (3072 after 1024, the shard
//    runs' 1 2 | 3 | 4 | 6 | ...) take a pass each.  Pass 0 reads the
//    staged x (dequantized, masked, times d_in) and the last pass applies
//    d_out and bias and stores y, so a chunk makes P - 1 round trips
//    through the tile for P passes, and takes P barriers (2 when P = 1).
//  * Coefficients reused over rows.  A thread keeps its group's pass
//    coefficients in registers (at most 3 x 4 float4) for every row of the
//    chunk it walks (R / slices rows, the slices being the threads sharing
//    a group).  Where a tile's table fits beside a chunk (K5's 36 KiB
//    shard table, the 768-lane shard runs, the 3072 stage, an int8 o
//    table), the block copies it into shared memory once per launch
//    (cp.async, overlapping the first chunk's x; an int8 table as codes,
//    dequantized with spm_cf's single rounded multiply when a group loads
//    them); otherwise (the 176 KiB f32 o table) each pass reads its group's
//    coefficients from L2 once a chunk.  Splitting the o tile's lanes over
//    a cluster to keep its table resident was measured slower: its cross
//    pass through distributed shared memory cost more than the L2 reads.
//  * More rows a barrier.  The f32 tile and the staging are the whole of a
//    chunk's shared memory: R = 16 at the 2048-lane o tile in bf16, 32 at
//    K5's 512 lanes (the planner, kernels/spm_stack.py `fwd_plan`, takes
//    the most that fit, then evens the chunks over the groups).  Groups of
//    2 or 4 lanes walk 4 or 2 rows at a time, their loads issued before
//    their stores, so a thread keeps several shared-memory loads in flight.
//  * Copies in flight, few instructions an access.  The next chunk's x is
//    issued after pass 0's barrier (16-byte cp.async, zero-filled past the
//    x width; plain loads where a row is not 16-byte aligned) and lands
//    while the other passes run.  A group's shared-memory addresses are
//    computed once a group (32-bit shared-space addresses); a row adds its
//    offset, one add an access.  A group whose lanes are contiguous
//    (strides 1, 2 [, 4]; a compile-time case) moves as one vector: 16
//    bytes of staged bf16, float4s of the tile, one vector store of y;
//    other groups' lanes are each warp's consecutive addresses, so their
//    scalar stores still fill whole 32-byte sectors.  Divisions are by
//    magic numbers, once per group and pass, never per row.
//  * Bank conflicts.  The tile is stored with bits 2-4 of a lane XORed by
//    its bits 5-7 (swz): the strided groups of every power-of-two pass and
//    the float4s of the contiguous ones fall on distinct banks.
//  * Decode rows.  At 16 rows or fewer each row is a group of its own, its
//    block's share of the table copied into shared memory at once (one
//    latency, not one a pass), and where that leaves fewer than 8 blocks or
//    blocks of more than 2048 lanes the planner splits a tile's lanes over
//    a cluster of C blocks (layout A: block c owns lanes [c w, (c+1) w)):
//    the stages local to w run as above on the block's share of the table;
//    the trailing stages that are not (at most 3, nested) run as one last
//    pass whose groups the blocks share, reading their lanes from the
//    owners' tiles through distributed shared memory between two cluster
//    barriers, and their coefficients from L2.  So a one-row call reads
//    each coefficient once on one of C SMs.
//
// Shared-memory budget (bytes, `layout`; kernels/spm_stack.py
// `fwd_smem_bytes` computes the same): the resident table L x w/2 x 16 (4
// for int8 codes), the f32 tile R x w x 4 (when P > 1, the store
// requantizes or K3 has a second stack), staging R x w x |x|, K5's two send
// slots 2 x R x w x |io|, K3's row statistics R x 4.
// o tile, bf16: 8 + 4 KiB a row; K5 at 512 lanes: 36 KiB of table and 5
// KiB a row.  Registers: a pass holds 2^m values, m x 2^(m-1) float4
// coefficients, 2^m addresses, and for its first or last pass the group's
// d_in or d_out and bias: up to 255 a thread under __launch_bounds__(256,
// 1), no spills; 8 warps an SM, each thread walking more rows of a group
// (its coefficients reused over all of them) than 16 warps would (512
// threads left 128 registers, spilled, and measured no faster).
//
// Numerics: every product and sum rounds on its own (__fmul_rn /
// __fadd_rn), in the stage order of the plain versions, so K1 and K5 stay
// bit for bit their plain versions; fusing stages only keeps values in
// registers between them.
//
// K3 (spm_block.cu) walks here too, one block a tile: its norm prologue
// (walk's `pre` hook) sums each staged row's squares before pass 0, pass 0
// reads its own source (`src0`: the norm and d_in1 applied to the staged
// x), and its second stack runs in `finish` over the same tile.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "spm_bwd_engine.cuh"  // cp.async staging, magic division, launch
#include "spm_common.cuh"

namespace spm_fwd {

namespace cg = cooperative_groups;
using spm_bwd::align16;
using spm_bwd::divm;
using spm_bwd::magic;

constexpr int kMaxFuse = 3;   // stages a pass fuses: 8 lanes a group
constexpr int kMaxThreads = 256;

// A stage: its stride and the magic number of 2s.
struct Stage {
  int s;
  unsigned mag2;
};

// A pass: stages [l, l + n) over groups of 2^n lanes; `cross` when its
// lanes lie across the cluster's lane blocks (the last pass only); its
// groups (this block's), the row slices sharing a group (threads / groups
// when fewer groups than threads, else 1), whether a group's lanes are
// contiguous (strides 1, 2 [, 4]); the radices of a group index's digits
// (rad[0] = s_l, rad[k] = s_(l+k) / 2 s_(l+k-1)) and their magic numbers.
struct Pass {
  int l, n, cross, groups, slices, contig;
  int rad[kMaxFuse];
  unsigned mrad[kMaxFuse];
};

// The planner's launch shape: C lane blocks, Cr row blocks (the int8 scale
// block's cluster), T threads, R rows a chunk, G row groups, whether the
// table is resident in shared memory.
struct Shape {
  int C, Cr, T, R, G, resident;
};

// The passes of a run over a tile of nt lanes split over C lane blocks (T
// threads a block; host side): the stages local to w = nt / C (w % 2s
// == 0) fuse greedily, up to kMaxFuse consecutive ascending nested strides;
// any stages after the first one that is not local must form one such
// group, run across the lane blocks.  Returns the pass count, or -1 when
// the run cannot be split so.  kernels/spm_stack.py `fwd_passes` mirrors
// it.
__host__ inline int plan_passes(const SpmStrides& st, int nt, int C, int T,
                                Pass* ps) {
  const int L = st.n, w = nt / C;
  int e = 0;
  while (e < L && w % (2 * st.s[e]) == 0) ++e;
  if (e < L) {
    if (C == 1 || e == 0 || L - e > kMaxFuse) return -1;
    for (int k = e + 1; k < L; ++k)
      if (st.s[k] % (2 * st.s[k - 1])) return -1;
    if ((nt >> (L - e)) % C) return -1;
  }
  int np = 0;
  for (int l = 0; l < L;) {
    const int end = l < e ? e : L;
    int n = 1;
    while (n < kMaxFuse && l + n < end &&
           st.s[l + n] % (2 * st.s[l + n - 1]) == 0)
      ++n;
    Pass& p = ps[np++];
    p.l = l;
    p.n = n;
    p.cross = l >= e;
    p.groups = p.cross ? (nt >> n) / C : w >> n;
    p.slices = p.groups >= T ? 1 : T / p.groups;
    p.contig = n >= 2;
    for (int k = 0; k < kMaxFuse; ++k) {
      p.rad[k] = 1;
      if (k < n) {
        p.rad[k] = k == 0 ? st.s[l] : st.s[l + k] / (2 * st.s[l + k - 1]);
        if (st.s[l + k] != 1 << k) p.contig = 0;
      }
      p.mrad[k] = p.rad[k] == 1 ? 0u : 0xFFFFFFFFu / p.rad[k] + 1u;
    }
    l += n;
  }
  return np;
}

// A launch's walk, planned on the host and passed as a __grid_constant__
// kernel parameter: every thread reads it from the constant bank, and no
// thread computes it (its divisions included) on the device.
struct Plan {
  Stage stg[SPM_MAX_STAGES];
  Pass ps[SPM_MAX_STAGES];
  int L, np;
};

// The plan of a run over a tile of nt lanes split over C lane blocks, T
// threads a block (host side); false when the lanes cannot be split so.
__host__ inline bool make_plan(const SpmStrides& st, int nt, int C, int T,
                               Plan* pl) {
  pl->L = st.n;
  pl->np = plan_passes(st, nt, C, T, pl->ps);
  for (int l = 0; l < st.n; ++l) {
    const unsigned d = 2u * st.s[l];
    pl->stg[l] = Stage{st.s[l], d == 1 ? 0u : 0xFFFFFFFFu / d + 1u};
  }
  return pl->np >= 1;
}

// Byte offsets of a block's shared memory.
struct Layout {
  long tbl, tile, xst, slot, slot_stride, stats, total;
};

__host__ __device__ inline Layout layout(int L, int w, int R, int x_bytes,
                                         int cf_bytes, bool resident,
                                         bool tile, int slot_bytes,
                                         bool stats = false) {
  Layout o;
  long at = 0;
  o.tbl = at;
  if (resident) at += align16((long)L * (w / 2) * cf_bytes);
  o.tile = at;
  if (tile) at += align16((long)R * w * 4);
  o.xst = at;
  at += align16((long)R * w * x_bytes);
  o.slot = at;
  o.slot_stride = align16((long)R * w * slot_bytes);
  at += 2 * o.slot_stride;
  o.stats = at;  // K3: a row's rstd
  if (stats) at += align16((long)R * 4);
  o.total = at;
  return o;
}

// The tile's bank swizzle: bits 2-4 of a lane XORed by its bits 5-7 (mask
// 0x1C), or none (mask 0) when w is not a multiple of 32.
__device__ __forceinline__ int swz(int i, int mask) {
  return i ^ ((i >> 3) & mask);
}

// The base lane of group u of a pass (its digits in the pass's radices,
// each pair of a stage's lanes apart by that stage's stride).
__device__ __forceinline__ int group_base(const Pass& P, const Stage* stg,
                                          int u) {
  int q = u, m0 = 0;
#pragma unroll
  for (int k = 0; k < kMaxFuse; ++k) {
    if (k < P.n) {
      const int qq = divm(q, P.rad[k], P.mrad[k]);
      const int a = q - qq * P.rad[k];
      m0 += k == 0 ? a : 2 * stg[P.l + k - 1].s * a;
      q = qq;
    }
  }
  return m0 + 2 * stg[P.l + P.n - 1].s * q;
}

// Pair index of the pair whose low lane is i in stage sg: (i / 2s) s + i
// mod 2s.
__device__ __forceinline__ int pair_of(const Stage& sg, int i) {
  return i - divm(i, 2 * sg.s, sg.mag2) * sg.s;
}

// A table's entry as stored (a float4, or an int8 table's char4 codes),
// read from device memory, and as f32: an int8 code times its stage's
// scale, one rounded multiply each, as spm_cf dequantizes.
template <typename CF>
struct Raw;
template <>
struct Raw<const float4*> {
  using T = float4;
};
template <>
struct Raw<SpmQCoeffs> {
  using T = char4;
};
__device__ __forceinline__ float4 raw_at(const float4* cf, long i) {
  return __ldg(cf + i);
}
__device__ __forceinline__ char4 raw_at(const SpmQCoeffs& cf, long i) {
  return __ldg(cf.q + i);
}
__device__ __forceinline__ float4 deq(float4 v, const float4*, int) {
  return v;
}
__device__ __forceinline__ float4 deq(char4 v, const SpmQCoeffs& cf, int l) {
  const float s = __ldg(cf.scale + l);
  return make_float4(__fmul_rn((float)v.x, s), __fmul_rn((float)v.y, s),
                     __fmul_rn((float)v.z, s), __fmul_rn((float)v.w, s));
}

// Coefficient sources.  get(l, sg, lane): stage l's coefficients of the
// pair whose low lane is tile lane `lane`.  TableGlobal reads the tile's
// table in device memory (cf at its first pair, stage l pair_stride pairs
// on); TablePairs reads the block's resident copy of its share in shared
// memory (stage l's pairs `half` entries on, from pair `off` of the tile:
// a lane block's pairs of a local stage are [off, off + half)), an int8
// table's codes dequantized there with their stage's scale.
template <typename CF>
struct TableGlobal {
  CF cf;
  long pair_stride;
  __device__ __forceinline__ float4 get(int l, const Stage& sg,
                                        int lane) const {
    return deq(raw_at(cf, (long)l * pair_stride + pair_of(sg, lane)), cf, l);
  }
};
template <typename CF>
struct TablePairs {
  const typename Raw<CF>::T* t;
  int half, off;
  CF cf;
  __device__ __forceinline__ float4 get(int l, const Stage& sg,
                                        int lane) const {
    return deq(t[l * half + pair_of(sg, lane) - off], cf, l);
  }
};

// One entry from device memory into shared memory by cp.async (16 bytes
// of f32 coefficients, 4 of int8 codes).
__device__ __forceinline__ void cp_entry(float4* dst, const float4* cf,
                                         long i) {
  spm_bwd::cp16(dst, cf + i, 16);
}
__device__ __forceinline__ void cp_entry(char4* dst, const SpmQCoeffs& cf,
                                         long i) {
  spm_bwd::cp4(dst, cf.q + i, 4);
}

// Copy the tile's table (cf at its first pair, stage l pair_stride pairs
// on; L stages of `half` pairs) into shared memory t by cp.async, all the
// copies in flight at once, one commit group: the first chunk's wait
// covers them.
template <typename CF>
__device__ __forceinline__ void load_table(const CF& cf, long pair_stride,
                                           int L, int half,
                                           typename Raw<CF>::T* t) {
  for (int l = 0; l < L; ++l)
    for (int p = threadIdx.x; p < half; p += blockDim.x)
      cp_entry(t + l * half + p, cf, (long)l * pair_stride + p);
  spm_bwd::cp_commit();
}

// N consecutive elements (N = 4 or 8; 16-byte aligned runs of 4 or 8
// bytes or more) as f32 and back, through generic pointers (device memory,
// or a peer's shared memory).
template <int N>
__device__ __forceinline__ void ld_vec(const float* p, float* v) {
#pragma unroll
  for (int h = 0; h < N / 4; ++h) {
    const float4 a = reinterpret_cast<const float4*>(p)[h];
    v[4 * h] = a.x;
    v[4 * h + 1] = a.y;
    v[4 * h + 2] = a.z;
    v[4 * h + 3] = a.w;
  }
}
template <int N>
__device__ __forceinline__ void ld_vec(const __nv_bfloat16* p, float* v) {
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  } else {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    w[0] = a.x, w[1] = a.y;
  }
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}
template <int N>
__device__ __forceinline__ void st_vec(float* p, const float* v) {
#pragma unroll
  for (int h = 0; h < N / 4; ++h)
    reinterpret_cast<float4*>(p)[h] =
        make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
}
// bf16 pairs, rounded to nearest even (as __float2bfloat16)
template <int N>
__device__ __forceinline__ void pack_bf16(const float* v, uint32_t* w) {
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
}
template <int N>
__device__ __forceinline__ void st_vec(__nv_bfloat16* p, const float* v) {
  uint32_t w[N / 2];
  pack_bf16<N>(v, w);
  if constexpr (N == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// Shared memory by 32-bit shared-space address: the hot loops add a row's
// byte offset to a group's addresses, one add an access.  Ordered among
// themselves (volatile), so a row's loads stay ahead of its stores.
__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ float lds(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void lds4(unsigned a, float* v) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(a));
}
__device__ __forceinline__ void sts(unsigned a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}
__device__ __forceinline__ void sts4(unsigned a, const float* v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(a),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}
// 4, 8 or 16 bytes as 32-bit words
template <int B>
__device__ __forceinline__ void lds_words(unsigned a, uint32_t* w) {
  if constexpr (B == 16)
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                 : "r"(a));
  else if constexpr (B == 8)
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                 : "=r"(w[0]), "=r"(w[1])
                 : "r"(a));
  else
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(w[0]) : "r"(a));
}
template <int B>
__device__ __forceinline__ void sts_words(unsigned a, const uint32_t* w) {
  if constexpr (B == 16)
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(a),
                 "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                 : "memory");
  else
    asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(a), "r"(w[0]),
                 "r"(w[1])
                 : "memory");
}
// One staged element as f32 (an int8 code as its integer value)
__device__ __forceinline__ float lds_elem(unsigned a, float*) {
  return lds(a);
}
__device__ __forceinline__ float lds_elem(unsigned a, __nv_bfloat16*) {
  uint32_t w;
  asm volatile("ld.shared.u16 %0, [%1];" : "=r"(w) : "r"(a));
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float lds_elem(unsigned a, int8_t*) {
  int w;
  asm volatile("ld.shared.s8 %0, [%1];" : "=r"(w) : "r"(a));
  return (float)w;
}
// N consecutive staged elements of type X (N x |X| bytes, aligned) as f32
template <int N, typename X>
__device__ __forceinline__ void lds_run(unsigned a, float* v) {
  constexpr int B = N * (int)sizeof(X);
  if constexpr (sizeof(X) == 4) {
#pragma unroll
    for (int h = 0; h < N / 4; ++h) lds4(a + 16 * h, v + 4 * h);
  } else {
    uint32_t w[B / 4];
    lds_words<B>(a, w);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if constexpr (sizeof(X) == 2)
        v[k] = __uint_as_float(k & 1 ? w[k / 2] & 0xFFFF0000u
                                     : w[k / 2] << 16);
      else
        v[k] = (float)(int8_t)((w[k / 4] >> (8 * (k & 3))) & 0xFF);
    }
  }
}

// Sources and sinks of a pass.  Each has per-group registers Regs<N>,
// filled once per group by group<N>(L, regs) (the lanes L[] of the group),
// and moves one row of the group: a source by load<N, kC>(r, regs, v), a
// sink by store<N, kC>(r, regs, v), kC when the group's lanes are
// contiguous (one vector a row).
// Pass 0's source: the staged chunk (R x w of X, row-major), an int8 code
// times the x block's scale (one rounding), then times d_in at column
// col0 + lane.
template <typename X>
struct FromStage {
  const X* s;
  int w;
  float scale;
  const float* d_in;
  long col0;
  template <int N>
  struct Regs {
    float din[N];
    unsigned a[N];  // row 0's shared addresses
  };
  template <int N>
  __device__ __forceinline__ void group(const int* L, Regs<N>& g) const {
    const unsigned base = saddr(s);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      g.din[j] = d_in ? __ldg(d_in + col0 + L[j]) : 1.f;
      g.a[j] = base + L[j] * (unsigned)sizeof(X);
    }
  }
  template <int N, bool kC>
  __device__ __forceinline__ void load(int r, const Regs<N>& g,
                                       float* v) const {
    const unsigned rb = (unsigned)(r * w) * (unsigned)sizeof(X);
    if constexpr (kC) {
      lds_run<N, X>(g.a[0] + rb, v);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        v[j] = lds_elem(g.a[j] + rb, static_cast<X*>(nullptr));
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (sizeof(X) == 1) v[j] = __fmul_rn(v[j], scale);
      if (d_in) v[j] = __fmul_rn(v[j], g.din[j]);
    }
  }
};

// The f32 tile (R x w, swizzled) of this block: a later pass's source and
// an earlier pass's sink.
struct Tile {
  float* z;
  int w, mask;
  __device__ __forceinline__ Tile(float* z_, int w_)
      : z(z_), w(w_), mask(w_ % 32 ? 0 : 0x1C) {}
  template <int N>
  struct Regs {
    unsigned a[N];  // row 0's shared addresses (a float4's first lane)
  };
  template <int N>
  __device__ __forceinline__ void group(const int* L, Regs<N>& g) const {
    const unsigned base = saddr(z);
#pragma unroll
    for (int j = 0; j < N; ++j) g.a[j] = base + 4u * swz(L[j], mask);
  }
  template <int N, bool kC>
  __device__ __forceinline__ void load(int r, const Regs<N>& g,
                                       float* v) const {
    const unsigned rb = (unsigned)(r * w) * 4u;
    if constexpr (kC) {
#pragma unroll
      for (int h = 0; h < N / 4; ++h) lds4(g.a[4 * h] + rb, v + 4 * h);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = lds(g.a[j] + rb);
    }
  }
  template <int N, bool kC>
  __device__ __forceinline__ void store(int r, const Regs<N>& g,
                                        const float* v) const {
    const unsigned rb = (unsigned)(r * w) * 4u;
    if constexpr (kC) {
#pragma unroll
      for (int h = 0; h < N / 4; ++h) sts4(g.a[4 * h] + rb, v + 4 * h);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) sts(g.a[j] + rb, v[j]);
    }
  }
};

// A cross pass's source: tile lane L of the tile split over C lane blocks
// of w lanes, read from its owner's tile (cluster rank rank0 + L / w)
// through distributed shared memory.
struct FromCluster {
  float* z;
  int w, mask, rank0;
  unsigned magw;
  template <int N>
  struct Regs {
    const float* p[N];
  };
  template <int N>
  __device__ __forceinline__ void group(const int* L, Regs<N>& g) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int o = divm(L[j], w, magw);
      g.p[j] = cg::this_cluster().map_shared_rank(
          z + swz(L[j] - o * w, mask), rank0 + o);
    }
  }
  template <int N, bool>
  __device__ __forceinline__ void load(int r, const Regs<N>& g,
                                       float* v) const {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = g.p[j][(long)r * w];
  }
};

// The epilogue vectors of a group's lanes: d_out and bias at column col0 +
// lane; its lanes' columns.
template <int N>
struct EpiRegs {
  float dout[N], b[N];
  int col[N];
};
struct Epi {
  const float* d_out;
  const float* bias;
  long col0;
  template <int N>
  __device__ __forceinline__ void group(const int* L, EpiRegs<N>& g) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      g.dout[j] = d_out ? __ldg(d_out + col0 + L[j]) : 1.f;
      g.b[j] = bias ? __ldg(bias + col0 + L[j]) : 0.f;
      g.col[j] = L[j];
    }
  }
  template <int N>
  __device__ __forceinline__ void apply(const EpiRegs<N>& g,
                                        float* v) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (d_out) v[j] = __fmul_rn(v[j], g.dout[j]);
      if (bias) v[j] = __fadd_rn(v[j], g.b[j]);
    }
  }
};

// The last pass's sink: the epilogue, then y (rows from row0, pitch ld, of
// T) at column col0 + lane, columns from lim on dropped.  A contiguous
// group inside lim on an aligned address is one vector store.
template <typename T>
struct ToOut : Epi {
  T* y;
  long row0, ld, lim;
  template <int N>
  using Regs = EpiRegs<N>;
  template <int N, bool kC>
  __device__ __forceinline__ void store(int r, const Regs<N>& g,
                                        float* v) const {
    this->template apply<N>(g, v);
    const long c = col0 + g.col[0];
    T* yr = y + (row0 + r) * ld + col0;
    bool done = false;
    if constexpr (kC && N >= 4) {
      if (c + N <= lim && ((row0 + r) * ld + c) % N == 0) {
        st_vec<N>(yr + g.col[0], v);
        done = true;
      }
    }
    if (!done) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (col0 + g.col[j] < lim) spm_st(yr + g.col[j], v[j]);
    }
  }
};

// The last pass's sink when the store requantizes: the epilogue, back into
// the tile, the magnitudes folded into *amax (spm_max_nan).
struct ToTileMax : Epi {
  Tile tile;
  float* amax;
  template <int N>
  struct Regs : EpiRegs<N> {
    typename Tile::template Regs<N> t;
  };
  template <int N>
  __device__ __forceinline__ void group(const int* L, Regs<N>& g) const {
    Epi::group<N>(L, g);
    tile.group<N>(L, g.t);
  }
  template <int N, bool kC>
  __device__ __forceinline__ void store(int r, const Regs<N>& g,
                                        float* v) const {
    this->template apply<N>(g, v);
    float m = *amax;
#pragma unroll
    for (int j = 0; j < N; ++j) m = spm_max_nan(m, fabsf(v[j]));
    *amax = m;
    tile.store<N, kC>(r, g.t, v);
  }
};

// K5's last local pass: the slab a shard sends, rounded to T, into the send
// slot (R x w of T, row-major).
template <typename T>
struct ToSlot {
  T* slot;
  int w;
  template <int N>
  struct Regs {
    unsigned a[N];
  };
  template <int N>
  __device__ __forceinline__ void group(const int* L, Regs<N>& g) const {
    const unsigned base = saddr(slot);
#pragma unroll
    for (int j = 0; j < N; ++j) g.a[j] = base + L[j] * (unsigned)sizeof(T);
  }
  template <int N, bool kC>
  __device__ __forceinline__ void store(int r, const Regs<N>& g,
                                        const float* v) const {
    const unsigned rb = (unsigned)(r * w) * (unsigned)sizeof(T);
    if constexpr (kC && sizeof(T) == 4) {
#pragma unroll
      for (int h = 0; h < N / 4; ++h) sts4(g.a[4 * h] + rb, v + 4 * h);
    } else if constexpr (kC) {
      uint32_t wd[N / 2];
      pack_bf16<N>(v, wd);
      sts_words<N * 2>(g.a[0] + rb, wd);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if constexpr (sizeof(T) == 4) {
          sts(g.a[j] + rb, v[j]);
        } else {
          const __nv_bfloat16 h = __float2bfloat16(v[j]);
          asm volatile("st.shared.u16 [%0], %1;" ::"r"(g.a[j] + rb),
                       "h"(*reinterpret_cast<const unsigned short*>(&h))
                       : "memory");
        }
      }
    }
  }
};

// The register walk of a pass's stages over a group: stage k pairs lanes j
// and j + 2^k of the group (j's bit k clear) with coefficient cs[k][j with
// bit k removed].
template <int M>
__device__ __forceinline__ void apply(const float4 (&cs)[M][1 << (M - 1)],
                                      float* v) {
#pragma unroll
  for (int k = 0; k < M; ++k) {
#pragma unroll
    for (int j = 0; j < (1 << M); ++j) {
      if (j & (1 << k)) continue;
      const int i = (j & ((1 << k) - 1)) | ((j >> (k + 1)) << k);
      const float4 c = cs[k][i];
      const float x0 = v[j], x1 = v[j | (1 << k)];
      v[j] = __fadd_rn(__fmul_rn(c.x, x0), __fmul_rn(c.y, x1));
      v[j | (1 << k)] = __fadd_rn(__fmul_rn(c.z, x0), __fmul_rn(c.w, x1));
    }
  }
}

// One pass over the chunk's rows [0, rows): each thread takes group u
// (of P.groups, this block's, the first being group g0 of the pass) for
// rows r0, r0 + slices, ...; `lane0` is the tile lane of the block's lane
// 0 (0 for a cross pass, whose groups are the tile's).  The lanes L[] a
// source and a sink see are block lanes (tile lanes for a cross pass);
// kC: the group's lanes are contiguous.
template <int M, bool kC, typename Tab, typename Src, typename Dst>
__device__ __forceinline__ void run_pass(const Pass& P, const Stage* stg,
                                         int rows, int lane0, int g0,
                                         const Tab& tab, const Src& src,
                                         const Dst& dst) {
  constexpr int N = 1 << M;
  const int t = threadIdx.x;
  int u = t, ustep = blockDim.x, r0 = 0, rstep = 1;
  if (P.slices > 1) {
    r0 = t / P.groups;
    if (r0 >= P.slices) return;
    u = t - r0 * P.groups;
    ustep = P.groups;
    rstep = P.slices;
  }
  for (; u < P.groups; u += ustep) {
    const int m0 = group_base(P, stg, g0 + u);
    int L[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      int off = 0;
#pragma unroll
      for (int k = 0; k < M; ++k)
        if (j & (1 << k)) off += stg[P.l + k].s;
      L[j] = m0 + off;
    }
    float4 cs[M][N / 2];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const Stage sg = stg[P.l + k];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j & (1 << k)) continue;
        const int i = (j & ((1 << k) - 1)) | ((j >> (k + 1)) << k);
        cs[k][i] = tab.get(P.l + k, sg, lane0 + L[j]);
      }
    }
    typename Src::template Regs<N> sr;
    typename Dst::template Regs<N> dr;
    src.template group<N>(L, sr);
    dst.template group<N>(L, dr);
    // small groups walk kB rows at a time, their loads issued before any
    // of their stores (a row's stores may alias the next row's loads for
    // the compiler), so one thread keeps several loads in flight
    constexpr int kB = N >= 8 ? 1 : 8 / N;
    int r = r0;
    for (; r + (kB - 1) * rstep < rows; r += kB * rstep) {
      float v[kB][N];
#pragma unroll
      for (int b = 0; b < kB; ++b)
        src.template load<N, kC>(r + b * rstep, sr, v[b]);
#pragma unroll
      for (int b = 0; b < kB; ++b) apply<M>(cs, v[b]);
#pragma unroll
      for (int b = 0; b < kB; ++b)
        dst.template store<N, kC>(r + b * rstep, dr, v[b]);
    }
    for (; r < rows; r += rstep) {
      float v[N];
      src.template load<N, kC>(r, sr, v);
      apply<M>(cs, v);
      dst.template store<N, kC>(r, dr, v);
    }
  }
}

// run_pass for the pass's stage count and contiguity.
template <typename Tab, typename Src, typename Dst>
__device__ __forceinline__ void run(const Pass& P, const Stage* stg,
                                    int rows, int lane0, int g0,
                                    const Tab& tab, const Src& src,
                                    const Dst& dst) {
  if (P.n == 3 && P.contig)
    run_pass<3, true>(P, stg, rows, lane0, g0, tab, src, dst);
  else if (P.n == 3)
    run_pass<3, false>(P, stg, rows, lane0, g0, tab, src, dst);
  else if (P.n == 2 && P.contig)
    run_pass<2, true>(P, stg, rows, lane0, g0, tab, src, dst);
  else if (P.n == 2)
    run_pass<2, false>(P, stg, rows, lane0, g0, tab, src, dst);
  else
    run_pass<1, false>(P, stg, rows, lane0, g0, tab, src, dst);
}

// The row-chunk loop of a block.  chunk(k, &r0, &rows, &scale) gives chunk
// k of this block (false past its last): its rows are staged one chunk
// ahead by cp.async (x rows r0 .., columns x_col .., zero from column x_lim
// on, pitch x_ld; `scale` the x block's scale of an int8 x), pre(k, r0,
// rows) runs once they have landed, the passes walk them (pass 0 from
// src0(scale), a source over the staging; the last pass into sink(P, r0)),
// then finish(k, r0, rows) runs.  Lane block c of a tile split over a
// cluster (`cluster`): a cross pass reads the peers' tiles, so the barrier
// before it and each chunk's first are the cluster's, and the block stays
// resident until its peers are done.  The local passes read their
// coefficients from tab, a cross pass from xtab.
template <typename X, typename Tab, typename XTab, typename Chunk,
          typename Pre, typename Src0, typename Sink, typename Finish>
__device__ __forceinline__ void walk_hooked(
    const Stage* stg, const Pass* ps, int np, const Tab& tab,
    const XTab& xtab, X* xs, float* z, int w, int lane0, int c, bool cluster,
    const X* x, long x_ld, long x_col, long x_lim, const Chunk& chunk,
    const Pre& pre, const Src0& src0, const Sink& sink,
    const Finish& finish) {
  int r0, rows;
  float scale;
  if (chunk(0, &r0, &rows, &scale))
    spm_bwd::stage_rows(xs, x, x_ld, r0, rows, w, x_col, x_lim);
  for (int k = 0; chunk(k, &r0, &rows, &scale); ++k) {
    spm_bwd::cp_wait_all();
    spm_bwd::sync(cluster);  // x landed; the last chunk's tile read
    pre(k, r0, rows);
    const auto src = src0(scale);
    const Tile tile(z, w);
    for (int p = 0; p < np; ++p) {
      const Pass P = ps[p];
      const int l0 = P.cross ? 0 : lane0, g0 = P.cross ? c * P.groups : 0;
      if (p == 0 && np == 1)
        run(P, stg, rows, l0, g0, tab, src, sink(P, r0));
      else if (p == 0)
        run(P, stg, rows, l0, g0, tab, src, tile);
      else if (p < np - 1)
        run(P, stg, rows, l0, g0, tab, tile, tile);
      else if (P.cross)
        run(P, stg, rows, l0, g0, xtab,
            FromCluster{z, w, tile.mask, 0, magic((unsigned)w)},
            sink(P, r0));
      else
        run(P, stg, rows, l0, g0, tab, tile, sink(P, r0));
      if (p == 0) {
        spm_bwd::sync(np > 1 && ps[1].cross);
        int n0, nr;
        float ns;
        if (chunk(k + 1, &n0, &nr, &ns))  // the staging is free again
          spm_bwd::stage_rows(xs, x, x_ld, n0, nr, w, x_col, x_lim);
      } else if (p < np - 1) {
        spm_bwd::sync(ps[p + 1].cross);
      }
    }
    finish(k, r0, rows);
  }
  if (cluster) cg::this_cluster().sync();  // peers done with this tile
}

// walk_hooked with no prologue and pass 0 reading the staged x (an int8
// code times the block's scale) times d_in at column din_col + lane: K1's
// and K5's walk.
template <typename X, typename Tab, typename XTab, typename Chunk,
          typename Sink, typename Finish>
__device__ __forceinline__ void walk(const Stage* stg, const Pass* ps, int np,
                                     const Tab& tab, const XTab& xtab,
                                     X* xs, float* z, int w,
                                     int lane0, int c, bool cluster,
                                     const X* x, long x_ld, long x_col,
                                     long x_lim, const float* d_in,
                                     long din_col, const Chunk& chunk,
                                     const Sink& sink, const Finish& finish) {
  walk_hooked(
      stg, ps, np, tab, xtab, xs, z, w, lane0, c, cluster, x, x_ld, x_col,
      x_lim, chunk, [](int, int, int) {},
      [&](float scale) { return FromStage<X>{xs, w, scale, d_in, din_col}; },
      sink, finish);
}

// The cluster launch, the backward engine's.
using spm_bwd::launch;

// How many clusters of `cluster` blocks of T threads and `smem` bytes of
// dynamic shared memory the card holds at once
// (cudaOccupancyMaxActiveClusters), 0 on error.  The kernel is opted into
// all the dynamic shared memory a block may have, so a launch that opted
// into less than that before is never left below what it set; a failed
// query leaves no error behind for the next launch to report.
template <typename K>
static inline int clusters(K kernel, int T, size_t smem, int cluster) {
  cudaFuncAttributes a;
  int n = 0;
  if (cudaFuncGetAttributes(&a, kernel) == cudaSuccess &&
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           232448 - (int)a.sharedSizeBytes) == cudaSuccess)
    n = spm_bwd::max_clusters(kernel, T, smem, cluster);
  cudaGetLastError();
  return n;
}

}  // namespace spm_fwd
