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
// Windowed reads (the reference's `col_base`, :664-699, the feature-sharded
// executor's first local run): x is read x_off columns on and gy gy_off
// columns on, each masked at its own (global) width in_w / gy_w, while the
// table, the vectors, g_x (the shard's full (B, n) slab, gx_w = n) and the
// grid are the shard's own; every tile is visited (vis = n / nt), as the
// reference keeps its sharded grid uniform.  Lanes of x past in_w remat as
// zeros, so g_din and the pair grads there are exact zeros.
//
// The engine (spm_bwd_engine.cuh): a cluster of C lane blocks holds one
// feature tile for a row group's whole range, the table and the pair-grad
// sums on chip, a remat tile of R rows for each pass's input (tile 0 =
// [D_in] x) and one for z_L, which the cotangent then overwrites in the
// last pass's layout.  A block (group g, tile j, lane block c) walks row
// chunks g, g+G, ... of its lanes.  Per chunk: wait for x and gy, issue the
// next chunk's x, z_0 from x, the remat, the epilogue sums from gy and
// delta, issue the next chunk's gy, the reverse walk, g_din and g_x in
// place of delta, g_x stored.  Each block's grads go once into its slice of
// the (G, ...) partial buffers, `spm_sum_partials` sums the G slices in
// order: no float atomics, two launches give bitwise equal grads.  Every
// plan K1 runs fits: the one-run 6144-wide tiny-row plan (12 stages) takes
// 8 lane blocks of 768 lanes, a row at a time.
//
// Split mode (seg > 0), a plan mode for a lone stage on a tile too wide
// for one cluster (a tile of 2 seg lanes, stride seg, wider than 8 blocks
// of 512 pair slots: the FFN's super-strides at n = 9216 ... 25600).  The
// stage's pairs (p, p + seg) are independent of one another and no stage
// follows inside the run, so the tile's pairs split into blocks of P =
// nt / 2 pairs that need no cluster: block j (tile t = j / (seg / P),
// piece ci) runs the engine on a tile of 2P lanes with stride P whose lane
// m < P is tile column ci P + m and lane P + m is column seg + ci P + m.
// Pair q of block j is pair t seg + ci P + q of the table, which is j P +
// q, so the table, its grads and the dead-tile bound keep their indexing
// at tile width 2P; only the columns of x, gy, g_x and the (n,) vectors
// jump by seg - P at lane P, and an int8 x's scale is that of tile t.
// C = 1, layout A; no window.
//
// Expert mode (E > 1): one launch runs the backward of the same run of E
// independent operators, expert e = blockIdx.z, as the reference's
// `jax.vmap` over the MoE expert axis adds a grid axis to this kernel.
// Expert e's x, gy and g_x rows, its table (an int8 one's (E, L) stage
// scales too), an int8 x's (E, B / scale_rows, tiles) block scales, its
// vectors, and its slice of (E, G, ...) partial buffers are offset from
// expert 0's; the ordered sums run per expert (`spm_sum_partials`'s
// batches), so each expert's grads are summed over its own rows only.
// The plan is one expert's rows; dead tiles, split mode and the windows
// (x_off / gy_off inside each expert's own rows) work per expert
// unchanged.
//
// Int8 modes (the reference's `x_scale` and `coeff_scale`): a saved int8 x
// is staged as codes and dequantized with the scale of its (scale_rows,
// n_tile) block by the block that stages it, in the remat and in g_din
// alike, so the remat replays exactly the activations the quantized forward
// produced; gy and g_x stay f32 or bf16.  An int8 table is dequantized once,
// as the block copies it on chip, so g_coeffs is the grad of the
// dequantized table.  The partials and the ordered sums are those of the
// f32 modes.
//
// What bounds it on an H100: by bytes, memory, as for K1 (a few flops per
// element and stage against x, gy and g_x read or written once); in fact
// the engine's passes, each with a fixed cost of setup, dependent shared-
// memory loads and a barrier, and the passes that store into other
// blocks' tiles (spm_bwd_engine.cuh has the numbers; PERF.md the times
// against the bound).

#include "spm_bwd_engine.cuh"

namespace eng = spm_bwd;

// The scale of row `row` of an int8 x in tile j (1 for f32/bf16 x, and for
// a tile wholly past in_w, which reads no x).
__device__ __forceinline__ float spm_row_scale(const float* xs, int row,
                                               int j, int c0, int in_w,
                                               int nt, int scale_rows) {
  if (!xs || c0 >= in_w) return 1.f;
  return xs[(long)(row / scale_rows) * ((in_w + nt - 1) / nt) + j];
}

// Lanes (i, i+1) of a staged row of x as f32: an int8 code times its
// block's scale (one rounding), zero from in_w on (live0 / live1).
template <typename TX>
__device__ __forceinline__ float2 x_lanes(const TX* p, const float* xs,
                                          int row, int j, int c0, int in_w,
                                          int nt, int scale_rows, bool live0,
                                          bool live1) {
  float2 v = spm_bwd::ld2(p);
  if (xs) {
    const float sx = spm_row_scale(xs, row, j, c0, in_w, nt, scale_rows);
    v = make_float2(__fmul_rn(v.x, sx), __fmul_rn(v.y, sx));
  }
  return make_float2(live0 ? v.x : 0.f, live1 ? v.y : 0.f);
}

constexpr int kVecs = 3;  // g_din, g_dout, g_bias

// Rows of `src` into dst (rows x w) from the block's lanes: columns [col0,
// col0 + w), or in split mode (gap > 0) the two segments [col0, col0 +
// w/2) and [col0 + w/2 + gap, ...).
template <typename U>
__device__ __forceinline__ void stage_seg(U* dst, const U* src, long ld,
                                          long row0, int rows, int w,
                                          long col0, long lim, int gap) {
  if (!gap) {
    eng::stage_rows(dst, src, ld, row0, rows, w, col0, lim);
    return;
  }
  const int h = w / 2;
  eng::stage_rows(dst, src, ld, row0, rows, h, col0, lim, w);
  eng::stage_rows(dst + h, src, ld, row0, rows, h, col0 + h + gap, lim, w);
}

// The f32 rows `src` (rows x w) out to the block's lanes, as stage_seg
// reads them.
template <typename T>
__device__ __forceinline__ void store_seg(T* dst, long ld, long row0,
                                          int rows, int w, long col0,
                                          long lim, const float* src,
                                          int gap) {
  if (!gap) {
    eng::store_rows(dst, ld, row0, rows, w, col0, lim, src);
    return;
  }
  const int h = w / 2;
  eng::store_rows(dst, ld, row0, rows, h, col0, lim, src, w);
  eng::store_rows(dst, ld, row0, rows, h, col0 + h + gap, lim, src + h, w);
}

// kExp: the expert mode, a separate instantiation so that the one-operator
// kernel keeps its pointers as kernel parameters (offsetting them by
// blockIdx.z would hold them in registers, which the bf16 build, at its
// 128-register cap, pays for in spills: 27% on the o run).
template <typename T, typename TX, typename CF, bool kExp>
__global__ void __launch_bounds__(512, 1) spm_stack_bwd_kernel(
    const TX* __restrict__ x, const float* __restrict__ xs,
    const T* __restrict__ gy, T* __restrict__ gx, CF cf,
    const float* __restrict__ d_in, const float* __restrict__ d_out,
    float4* __restrict__ part_cf, float* __restrict__ part_vec, int B, int n,
    int nt, int in_w, int gy_w, int gx_w, int x_off, int gy_off, int vis,
    int has_bias, int scale_rows, int seg, long cf_es, eng::Shape sh,
    SpmStrides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  // expert mode: expert blockIdx.z's rows, table (cf_es pairs on), (n,)
  // vectors and slices of the partial buffers
  if (kExp) {
    const long e = blockIdx.z;
    x += e * B * in_w;
    gy += e * B * gy_w;
    gx += e * B * gx_w;
    cf = spm_cf_expert(cf, e, cf_es, st.n);
    if (xs) {  // the scale grid's tile: the whole tile in split mode
      const int xw = seg ? 2 * seg : nt;
      xs += e * (long)(B / scale_rows) * ((in_w + xw - 1) / xw);
    }
    if (d_in) d_in += e * n;
    if (d_out) d_out += e * n;
    part_cf += e * sh.G * st.n * (long)(n >> 1);
    part_vec += e * sh.G * (long)kVecs * n;
  }
  const int c = (int)cooperative_groups::this_cluster().block_rank();
  const int g = blockIdx.x / sh.C;
  const int j = blockIdx.y;
  // the tile's first column (split mode: the block's), and the jump of
  // the block's columns at lane pb (split mode only)
  int c0 = j * nt, gap = 0;
  // the tile of the int8 x scale: its index, width and first column
  int xj = j, xnt = nt, xc0 = c0;
  if (seg) {
    const int per = seg / sh.pb;
    const int t = j / per;
    c0 = t * 2 * seg + (j - t * per) * sh.pb;
    gap = seg - sh.pb;
    xj = t;
    xnt = 2 * seg;
    xc0 = t * xnt;
  }
  const int lane0 = c0 + c * sh.w;  // the block's first column
  const int L = st.n;
  const int w = sh.w;
  const long step = (long)sh.G * sh.R;
  // the column of the block's lane i (lanes i, i + 1 of an even i share
  // a segment)
  auto col = [&](int i) { return lane0 + i + (i >= sh.pb ? gap : 0); };

  if (j >= vis) {  // dead tile: exact zeros where g_x has columns
    for (long r0 = (long)g * sh.R; r0 < B; r0 += step) {
      const int rows = (int)min((long)sh.R, B - r0);
      for (int e = threadIdx.x; e < rows * w; e += blockDim.x) {
        const int r = e / w;
        const int gc = col(e - r * w);
        if (gc < gx_w) spm_st(gx + (r0 + r) * gx_w + gc, 0.f);
      }
    }
    return;
  }

  const eng::Geo geo{L,    w, sh.pb, sh.rs, sh.R, c, 0, sh.C, __ffs(sh.C) - 1,
                     eng::magic((unsigned)w)};
  const eng::Layout lay =
      eng::layout_of(L, sh, kVecs, sizeof(TX), sizeof(T), false);
  float4* tbl = reinterpret_cast<float4*>(smem + lay.tbl);
  float4* acc = reinterpret_cast<float4*>(smem + lay.acc);
  float4* part = reinterpret_cast<float4*>(smem + lay.part);
  eng::Stage* stg = reinterpret_cast<eng::Stage*>(smem + lay.stg);
  eng::Pass* ps = reinterpret_cast<eng::Pass*>(smem + lay.pas);
  float* vacc = reinterpret_cast<float*>(smem + lay.vacc);
  float* tiles = reinterpret_cast<float*>(smem + lay.tiles);
  const int np = sh.np;
  float* zL = tiles + (long)np * sh.R * w;  // z_L, then the cotangent
  T* gst = reinterpret_cast<T*>(smem + lay.gst);
  const int half_n = n >> 1;

  // z_L stays in the last pass's layout: the epilogue reads gy there
  eng::setup(st, w, sh.C, c, -1, stg, ps);
  __syncthreads();
  eng::load_table(geo, stg, cf + (long)j * (nt >> 1), half_n, tbl, acc, vacc,
                  kVecs);
  const bool head_b = L > 0 && ps[0].lin == eng::kLayB;
  const bool tail_b = sh.tailb;
  uint32_t* gsw = reinterpret_cast<uint32_t*>(smem + lay.gst);
  const long gy_total = (long)B * gy_w;
  long r0 = (long)g * sh.R;
  if (r0 < B) {
    const int rows = (int)min((long)sh.R, B - r0);
    stage_seg(reinterpret_cast<TX*>(smem + lay.xst), x, in_w, r0, rows, w,
              (long)x_off + lane0, in_w, gap);
    if (tail_b)
      eng::stage_rows_b(gsw, gy, gy_w, gy_total, r0, rows, w, sh.C, c,
                        (long)gy_off + c0, gy_w);
    else
      stage_seg(gst, gy, gy_w, r0, rows, w, (long)gy_off + lane0, gy_w, gap);
  }
  for (int k = 0; r0 < B; r0 += step, ++k) {
    const int rows = (int)min((long)sh.R, B - r0);
    const TX* xcur =
        reinterpret_cast<const TX*>(smem + lay.xst + (k & 1) * lay.xst_stride);
    eng::cp_wait_all();
    eng::sync(head_b);
    const long r1 = r0 + step;
    if (r1 < B) {
      TX* xnext = reinterpret_cast<TX*>(smem + lay.xst +
                                        ((k + 1) & 1) * lay.xst_stride);
      stage_seg(xnext, x, in_w, r1, (int)min((long)sh.R, B - r1), w,
                (long)x_off + lane0, in_w, gap);
    }

    // remat: z_0 = [D_in] x, masked to in_w, in pass 0's layout.  The
    // per-lane passes give a thread lanes (i, i+1), four rows at a time,
    // loads first.
    if (threadIdx.x < sh.pb) {
      const int i = 2 * threadIdx.x;
      const int gc = col(i);
      const bool l0 = x_off + gc < in_w, l1 = x_off + gc + 1 < in_w;
      const float2 din = eng::vec2(d_in, gc);
      for (int r = 0; r < rows; r += 4) {
        const int nr = min(4, rows - r);
        float2 v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < nr) v[k] = x_lanes(xcur + (long)(r + k) * w + i, xs,
                                     (int)(r0 + r + k), xj, xc0, in_w, xnt,
                                     scale_rows, l0, l1);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < nr) {
            const float2 z = d_in ? eng::mul2(v[k], din) : v[k];
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

    // epilogue grads from gy; delta = gy [* d_out] replaces z_L, in z_L's
    // layout: A, the block's own columns; B, the lanes m C + c, each staged
    // with the 4-byte word holding it
    if (tail_b) {
      for (int m = threadIdx.x; m < w; m += blockDim.x) {
        const int gc = c0 + m * sh.C + c;
        const float dout = d_out ? __ldg(d_out + gc) : 1.f;
        float sb = 0.f, sd = 0.f;
        for (int r = 0; r < rows; r += 4) {
          const int nr = min(4, rows - r);
          float gv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            gv[k] = k < nr ? eng::word_half<T>(
                                 gsw[(long)(r + k) * w + m],
                                 (r0 + r + k) * gy_w + gy_off + gc)
                           : 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k < nr) {
              float* dz = zL + (long)(r + k) * w + m;
              sb = __fadd_rn(sb, gv[k]);
              if (d_out) {
                sd = __fadd_rn(sd, __fmul_rn(gv[k], *dz));
                *dz = __fmul_rn(gv[k], dout);
              } else {
                *dz = gv[k];
              }
            }
        }
        if (d_out) vacc[w + m] = __fadd_rn(vacc[w + m], sd);
        if (has_bias) vacc[2 * w + m] = __fadd_rn(vacc[2 * w + m], sb);
      }
    } else if (threadIdx.x < sh.pb) {
      const int i = 2 * threadIdx.x;
      const int gc = col(i);
      const bool l0 = gy_off + gc < gy_w, l1 = gy_off + gc + 1 < gy_w;
      const float2 dout = eng::vec2(d_out, gc);
      float2 sb = make_float2(0.f, 0.f), sd = sb;
      for (int r = 0; r < rows; r += 4) {
        const int nr = min(4, rows - r);
        float2 gv[4], z[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < nr) {
            gv[k] = eng::ld2(gst + (long)(r + k) * w + i);
            gv[k] = make_float2(l0 ? gv[k].x : 0.f, l1 ? gv[k].y : 0.f);
            z[k] = eng::ld2(zL + (long)(r + k) * w + i);
          }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < nr) {
            sb = eng::add2(sb, gv[k]);
            if (d_out) sd = eng::add2(sd, eng::mul2(gv[k], z[k]));
            eng::st2(zL + (long)(r + k) * w + i,
                     d_out ? eng::mul2(gv[k], dout) : gv[k]);
          }
      }
      if (d_out) eng::st2(vacc + w + i, eng::add2(eng::ld2(vacc + w + i), sd));
      if (has_bias)
        eng::st2(vacc + 2 * w + i, eng::add2(eng::ld2(vacc + 2 * w + i), sb));
    }
    eng::sync(L > 0 && ps[np - 1].remb);
    if (r1 < B && tail_b)
      eng::stage_rows_b(gsw, gy, gy_w, gy_total, r1,
                        (int)min((long)sh.R, B - r1), w, sh.C, c,
                        (long)gy_off + c0, gy_w);
    else if (r1 < B)
      stage_seg(gst, gy, gy_w, r1, (int)min((long)sh.R, B - r1), w,
                (long)gy_off + lane0, gy_w, gap);

    float* dl0 =
        eng::walk_back(geo, stg, ps, np, rows, tbl, acc, part, tiles, zL);

    // g_din, and g_x in place of delta
    if (d_in && threadIdx.x < sh.pb) {
      const int i = 2 * threadIdx.x;
      const int gc = col(i);
      const bool l0 = x_off + gc < in_w, l1 = x_off + gc + 1 < in_w;
      const float2 din = eng::vec2(d_in, gc);
      float2 si = make_float2(0.f, 0.f);
      for (int r = 0; r < rows; r += 4) {
        const int nr = min(4, rows - r);
        float2 xv[4], d[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < nr) {
            xv[k] = x_lanes(xcur + (long)(r + k) * w + i, xs,
                            (int)(r0 + r + k), xj, xc0, in_w, xnt,
                            scale_rows, l0, l1);
            d[k] = eng::ld2(dl0 + (long)(r + k) * w + i);
          }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < nr) {
            si = eng::add2(si, eng::mul2(d[k], xv[k]));
            eng::st2(dl0 + (long)(r + k) * w + i, eng::mul2(d[k], din));
          }
      }
      eng::st2(vacc + i, eng::add2(eng::ld2(vacc + i), si));
    }
    __syncthreads();
    store_seg(gx, gx_w, r0, rows, w, lane0, gx_w, dl0, gap);
  }

  eng::store_table_grads(geo, stg, acc,
                         part_cf + (long)g * L * half_n + (long)j * (nt >> 1),
                         half_n);
  // g_din by layout A offsets, g_dout and g_bias by z_L's
  float* pv = part_vec + (long)g * kVecs * n;
  for (int e = threadIdx.x; e < kVecs * w; e += blockDim.x) {
    const int v = e / w;
    const int m = e - v * w;
    const int lane = v > 0 && tail_b ? c0 + m * sh.C + c : col(m);
    pv[(long)v * n + lane] = vacc[e];
  }
  cooperative_groups::this_cluster().sync();
}

template <typename T, typename TX, typename CF, bool kExp>
static cudaError_t launch_stack_bwd(
    const void* x, const void* xs, const void* gy, void* gx, CF cf,
    const void* d_in, const void* d_out, void* g_cf, void* g_vec,
    void* part_cf, void* part_vec, int B, int n, int nt, int in_w, int gy_w,
    int gx_w, int x_off, int gy_off, int vis, int has_bias, int scale_rows,
    int split, int E, long cf_es, const eng::Shape& sh, const SpmStrides& st,
    cudaStream_t stream) {
  static size_t smem_set = 0;
  const size_t smem =
      eng::layout_of(st.n, sh, kVecs, sizeof(TX), sizeof(T), false).total;
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = spm_stack_bwd_kernel<T, TX, CF, kExp>;
  cudaError_t e = spm_allow_smem(kernel, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const int gx_tiles = (gx_w + nt - 1) / nt;
  // split mode: `split` blocks of nt / split lanes a tile, stride nt / 2
  const int per = split ? split : 1;
  const int seg = split ? nt / 2 : 0;
  e = eng::launch(kernel,
                  dim3(sh.G * sh.C, per * (gx_tiles > vis ? gx_tiles : vis),
                       E),
                  sh.pb * sh.rs, smem, sh.C, stream, (const TX*)x,
                  (const float*)xs, (const T*)gy, (T*)gx, cf,
                  (const float*)d_in, (const float*)d_out, (float4*)part_cf,
                  (float*)part_vec, B, n, nt / per, in_w, gy_w, gx_w, x_off,
                  gy_off, vis * per, has_bias, scale_rows, seg, cf_es, sh,
                  st);
  if (e != cudaSuccess) return e;
  const long live = (long)vis * nt;
  e = spm_launch_sum((const float*)part_cf, (float*)g_cf, sh.G, st.n,
                     (long)(n / 2) * 4, live * 2, stream, E);
  if (e != cudaSuccess) return e;
  return spm_launch_sum((const float*)part_vec, (float*)g_vec, sh.G, kVecs,
                        n, live, stream, E);
}

// The cotangent type T, then whether x is int8 (xs non-null).
template <typename T, typename CF>
static cudaError_t dispatch_x(const void* x, const void* xs, const void* gy,
                              void* gx, CF cf, const void* d_in,
                              const void* d_out, void* g_cf, void* g_vec,
                              void* part_cf, void* part_vec, int B, int n,
                              int nt, int in_w, int gy_w, int gx_w, int x_off,
                              int gy_off, int vis, int has_bias,
                              int scale_rows, int split, int E, long cf_es,
                              const eng::Shape& sh, const SpmStrides& st,
                              cudaStream_t s) {
  if (xs) {
    if (scale_rows <= 0 || B % scale_rows || x_off || gy_off)
      return cudaErrorInvalidValue;
    if (E > 1)
      return launch_stack_bwd<T, int8_t, CF, true>(
          x, xs, gy, gx, cf, d_in, d_out, g_cf, g_vec, part_cf, part_vec, B,
          n, nt, in_w, gy_w, gx_w, 0, 0, vis, has_bias, scale_rows, split, E,
          cf_es, sh, st, s);
    return launch_stack_bwd<T, int8_t, CF, false>(
        x, xs, gy, gx, cf, d_in, d_out, g_cf, g_vec, part_cf, part_vec, B,
        n, nt, in_w, gy_w, gx_w, 0, 0, vis, has_bias, scale_rows, split, 1,
        cf_es, sh, st, s);
  }
  if (E > 1)
    return launch_stack_bwd<T, T, CF, true>(
        x, xs, gy, gx, cf, d_in, d_out, g_cf, g_vec, part_cf, part_vec, B, n,
        nt, in_w, gy_w, gx_w, x_off, gy_off, vis, has_bias, scale_rows,
        split, E, cf_es, sh, st, s);
  return launch_stack_bwd<T, T, CF, false>(
      x, xs, gy, gx, cf, d_in, d_out, g_cf, g_vec, part_cf, part_vec, B, n,
      nt, in_w, gy_w, gx_w, x_off, gy_off, vis, has_bias, scale_rows, split,
      1, cf_es, sh, st, s);
}

template <typename CF>
static cudaError_t dispatch(int io_type, const void* x, const void* xs,
                            const void* gy, void* gx, CF cf,
                            const void* d_in, const void* d_out, void* g_cf,
                            void* g_vec, void* part_cf, void* part_vec, int B,
                            int n, int nt, int in_w, int gy_w, int gx_w,
                            int x_off, int gy_off, int vis, int has_bias,
                            int scale_rows, int split, int E, long cf_es,
                            const eng::Shape& sh, const SpmStrides& st,
                            cudaStream_t s) {
  if (io_type == SPM_IO_F32)
    return dispatch_x<float>(x, xs, gy, gx, cf, d_in, d_out, g_cf, g_vec,
                             part_cf, part_vec, B, n, nt, in_w, gy_w, gx_w,
                             x_off, gy_off, vis, has_bias, scale_rows, split,
                             E, cf_es, sh, st, s);
  if (io_type == SPM_IO_BF16)
    return dispatch_x<__nv_bfloat16>(
        x, xs, gy, gx, cf, d_in, d_out, g_cf, g_vec, part_cf, part_vec, B, n,
        nt, in_w, gy_w, gx_w, x_off, gy_off, vis, has_bias, scale_rows, split,
        E, cf_es, sh, st, s);
  return cudaErrorInvalidValue;
}

// C interface (loaded with ctypes).  io_type is the type of gy and g_x
// (f32 or bf16); x is of that type too, or int8 when its block scales xs
// (B / scale_rows, ceil(in_w / nt)) are given.  cf_scale non-null marks an
// int8 coefficient table with one f32 scale a stage.  d_in / d_out may be
// null.  g_cf is (L, n/2, 4) f32; g_vec (3, n) f32 holds g_din, g_dout,
// g_bias (rows of absent operands are left meaningless).  part_cf
// (G, L, n/2, 4) and part_vec (G, 3, n) are the partial buffers.  x_off /
// gy_off > 0 are the windowed reads of x / gy (f32 / bf16 x only).  The
// launch shape (C, w, pb, rs, R, G, split) is the planner's (`bwd_plan`):
// split > 0 is split mode, one stage of stride nt / 2 over `split` blocks
// of w = nt / split lanes a tile (C = 1; no window).  E > 1 is the expert
// mode, in every mode above: x, gy and g_x (E, B, width), expert e's table
// cf_es pairs after expert e-1's (an int8 table's scales (E, L),
// contiguous) and its d_in / d_out n floats on, an int8 x's scales (E,
// B / scale_rows, tiles), g_cf (E, L, n/2, 4), g_vec (E, 3, n), the
// partial buffers (E, G, ...), each expert's grads summed over its own
// rows.  Returns the cudaError_t of the launches (0 on success).
extern "C" int spm_stack_bwd(int io_type, const void* x, const void* xs,
                             const void* gy, void* gx, const void* cf,
                             const void* cf_scale, const void* d_in,
                             const void* d_out, void* g_cf, void* g_vec,
                             void* part_cf, void* part_vec, int B, int n,
                             int nt, int in_w, int gy_w, int gx_w, int x_off,
                             int gy_off, int vis, int has_bias,
                             int scale_rows, int C, int w, int pb, int rs,
                             int R, int G, int split, const int* strides,
                             int L, int E, long cf_es, void* stream) {
  SpmStrides st;
  eng::Shape sh{C, w, pb, rs, R, G, 0, 0, 0};
  const int ntb = split ? (split > 0 && nt % split == 0 ? nt / split : 0)
                        : nt;
  if (!spm_copy_strides(&st, strides, L) || B <= 0 || nt <= 0 || n % nt ||
      vis <= 0 || vis * nt > n || x_off < 0 || gy_off < 0 || ntb <= 0 ||
      !eng::valid_shape(sh, ntb) || E < 1 || E > 65535 ||
      (E > 1 && cf_es < (long)L * (n / 2)))
    return (int)cudaErrorInvalidValue;
  if (split) {
    // one stage of stride nt / 2, run as stride pb on the block's 2 pb
    // lanes, pb >= 4 so that a lane pair never straddles the jump
    if (L != 1 || st.s[0] * 2 != nt || C != 1 || pb < 4 || x_off || gy_off)
      return (int)cudaErrorInvalidValue;
    st.s[0] = pb;
  }
  eng::set_passes(st, -1, &sh);
  cudaStream_t s = (cudaStream_t)stream;
  if (cf_scale)
    return (int)dispatch(
        io_type, x, xs, gy, gx,
        SpmQCoeffs{(const char4*)cf, (const float*)cf_scale}, d_in, d_out,
        g_cf, g_vec, part_cf, part_vec, B, n, nt, in_w, gy_w, gx_w, x_off,
        gy_off, vis, has_bias, scale_rows, split, E, cf_es, sh, st, s);
  return (int)dispatch(io_type, x, xs, gy, gx, (const float4*)cf, d_in,
                       d_out, g_cf, g_vec, part_cf, part_vec, B, n, nt, in_w,
                       gy_w, gx_w, x_off, gy_off, vis, has_bias, scale_rows,
                       split, E, cf_es, sh, st, s);
}

// How many clusters of a launch shape the card holds at once
// (cudaOccupancyMaxActiveClusters; f32 or bf16 x and an f32 table), for
// the on-card reports; 0 on error.
extern "C" int spm_stack_bwd_clusters(int io_type, const int* strides,
                                      int L, int C, int w, int pb, int rs,
                                      int R) {
  SpmStrides st;
  eng::Shape sh{C, w, pb, rs, R, 1, 0, 0, 0};
  if (!spm_copy_strides(&st, strides, L)) return 0;
  eng::set_passes(st, -1, &sh);
  if (io_type == SPM_IO_F32) {
    const size_t smem = eng::layout_of(L, sh, kVecs, 4, 4, false).total;
    static size_t set = 0;
    auto kernel = spm_stack_bwd_kernel<float, float, const float4*, false>;
    if (spm_allow_smem(kernel, smem, &set) != cudaSuccess) return 0;
    return eng::max_clusters(kernel, pb * rs, smem, C);
  }
  const size_t smem = eng::layout_of(L, sh, kVecs, 2, 2, false).total;
  static size_t set = 0;
  auto kernel =
      spm_stack_bwd_kernel<__nv_bfloat16, __nv_bfloat16, const float4*,
                           false>;
  if (spm_allow_smem(kernel, smem, &set) != cudaSuccess) return 0;
  return eng::max_clusters(kernel, pb * rs, smem, C);
}
