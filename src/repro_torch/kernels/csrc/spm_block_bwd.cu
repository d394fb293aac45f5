// K4: the residual-block backward — from the saved x and rstd, remat the
// block forward, walk both stacks back, and emit every grad closed-form —
// on the backward engine, a cluster of lane blocks a tile of n <= 2048.
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
// On the backward engine (spm_bwd_engine.cuh, which has the design): a
// cluster of C lane blocks holds the tile for a row group's whole range,
// each stack's table and pair-grad sums on chip, x (double-buffered) and gy
// staged a chunk ahead by cp.async, two stages a pass.  The q/k/v form is
// K2's run with the norm around it; K4 adds
//
//  * the remat prologue: z0 = (x rstd) gamma, rounded in that order, the
//    chunk's rstd read once a row into shared memory;
//  * the norm's backward after the walk: g_gamma is one more per-lane sum;
//    the row mean of gxh xh needs every lane of the row, which lie in C
//    blocks: each thread sums its two lanes' products a row, the block sums
//    its threads' in a fixed order (32 strided partials, then those in
//    order), and after one cluster barrier each block adds the C blocks'
//    row sums in rank order through distributed shared memory (the row
//    sums double-buffered by chunk parity, so no second barrier), so two
//    launches agree bit for bit;
//  * the two-stack form: stack 1's z_L is kept in layout A (the mid step
//    is per lane), u and h recomputed from it bit for bit as the forward
//    made them; stack 2's remat, epilogue from gy and walk back; then
//    through the activation into stack 1's cotangent (in layout B through
//    the spare tile when stack 1's last pass runs there) and stack 1's
//    walk back.  Both tables and their grad sums take 2 x 2 x L x w/2 x 16
//    bytes, 180 KiB for 11 + 11 stages on 4 blocks of 512 lanes: more than
//    fits beside a chunk.  Where up to 4 lane blocks cannot hold a block's
//    tables, the planner streams stack 1's, then both stacks', table and
//    grad sums from a per-block slab of device memory (`streamed`, a named
//    mode of the plan: the same code, through generic pointers, L2 behind
//    it) before it takes 8 blocks: for 11 + 11 stages both streamed over
//    4 blocks measured faster than both on chip over 8
//    (benchmarks/torch_block_plans.py), whose cross-block passes and
//    8-block barriers cost more than the L2 reads.
//
// Cross-block sums as in K2: each block stores its grads once into its
// slice of the (G, ...) partial buffers and spm_sum_partials sums the G
// slices in order; no float atomics.

#include <cooperative_groups.h>

#include "spm_bwd_engine.cuh"

namespace cg = cooperative_groups;
namespace eng = spm_bwd;

enum { V_GAMMA, V_DIN1, V_DOUT1, V_B1, V_DIN2, V_DOUT2, V_B2, N_VEC };

// Byte offsets of a block's shared memory (kernels/spm_stack.py
// `bwd_block_smem_bytes` computes the same total): for each stack (stack 2
// when present), its table and grad sums (unless streamed), stage and pass
// set-up, and its tiles (passes + 1 [+ the spare]); then the row slices'
// sums of two passes, the per-lane sums, x staged twice, gy once (its
// 4-byte word when z_L is in layout B), and with the norm the row
// statistics (rstd, mean, the row sums by chunk parity, 32 partials a row).
struct BlockLayout {
  long tbl[2], acc[2], stg[2], pas[2], tiles[2];
  long part, vacc, xst, xst_stride, gst, stats, total;
};

__host__ __device__ inline BlockLayout block_layout(
    const int* L, const eng::Shape* sh, int streamed, int nvec, int x_bytes,
    int gy_bytes, bool norm) {
  BlockLayout o;
  long at = 0;
  const long pb = sh[0].w / 2, tile = (long)sh[0].R * sh[0].w * 4;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    o.tbl[s] = o.acc[s] = at;
    if (L[s] > 0 && s >= streamed) {
      at += eng::align16(L[s] * pb * 16);
      o.acc[s] = at;
      at += eng::align16(L[s] * pb * 16);
    }
    o.stg[s] = at;
    if (L[s] > 0) at += eng::align16((long)L[s] * sizeof(eng::Stage));
    o.pas[s] = at;
    if (L[s] > 0) at += eng::align16((long)sh[s].np * sizeof(eng::Pass));
    o.tiles[s] = at;
    if (L[s] > 0) at += eng::align16((sh[s].np + 1 + sh[s].spare) * tile);
  }
  o.part = at;
  at += eng::align16(2 * 2 * (sh[0].rs - 1) * pb * 16);
  o.vacc = at;
  at += eng::align16((long)nvec * sh[0].w * 4);
  o.xst = at;
  o.xst_stride = eng::align16((long)sh[0].R * sh[0].w * x_bytes);
  at += 2 * o.xst_stride;
  o.gst = at;
  at += eng::align16((long)sh[0].R * sh[0].w * gy_bytes);
  o.stats = at;
  if (norm) at += eng::align16(36L * sh[0].R * 4);
  o.total = at;
  return o;
}

// One stack's walk in a block: where it is (geometry, stages, passes,
// table and grad sums, tiles), whether pass 0 reads layout B, whether the
// last pass runs in it, and whether z_L is kept in it.
struct Stack {
  eng::Geo geo;
  eng::Stage* stg;
  eng::Pass* ps;
  float4* tbl;
  float4* acc;
  float* tiles;
  float* zL;
  float* spare;
  int np;
  bool head_b, last_b, tail_b;
};

// Lanes (i, i+1) of a staged row of x, zero from in_w on.
template <typename T>
__device__ __forceinline__ float2 x_lanes(const T* p, bool live0,
                                          bool live1) {
  const float2 v = eng::ld2(p);
  return make_float2(live0 ? v.x : 0.f, live1 ? v.y : 0.f);
}

// The epilogue from gy on the stack gy meets (z_L in its layout; with
// `acted`, one stack with an activation: the cotangent goes through act'(u),
// u = z d_out1 [+ bias1] masked to mid_w): e = gy [act'(u)], the sums of e
// and e z into the per-lane sums vb and vd (vb null: no bias), and the
// cotangent e d_out in place of z_L.  Layout A: lanes (i, i+1) a thread;
// layout B: lane m C + c, gy staged with the 4-byte word holding it.
template <typename T>
__device__ __forceinline__ void gy_epilogue(
    const Stack& s, const T* gst, const uint32_t* gsw, long gy_base, int rows,
    int lane0, int out_w, const float* dout, const float* bias, int mid_w,
    int act, bool acted, float* vd, float* vb) {
  const eng::Geo& geo = s.geo;
  const int w = geo.w;
  auto cot = [&](float gv, float z, int gc) {
    if (!acted) return gv;
    float u = __fmul_rn(z, __ldg(dout + gc));
    if (bias) u = __fadd_rn(u, __ldg(bias + gc));
    return __fmul_rn(gv, spm_act_grad(gc < mid_w ? u : 0.f, act));
  };
  if (s.tail_b) {
    for (int m = threadIdx.x; m < w; m += blockDim.x) {
      const int gc = m * geo.C + geo.c;
      const float dv = __ldg(dout + gc);
      float sb = 0.f, sd = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float gv = gc < out_w
                             ? eng::word_half<T>(gsw[(long)r * w + m],
                                                 gy_base + (long)r * out_w + gc)
                             : 0.f;
        float* dz = s.zL + (long)r * w + m;
        const float e = cot(gv, *dz, gc);
        sb = __fadd_rn(sb, e);
        sd = __fadd_rn(sd, __fmul_rn(e, *dz));
        *dz = __fmul_rn(e, dv);
      }
      vd[m] = __fadd_rn(vd[m], sd);
      if (vb) vb[m] = __fadd_rn(vb[m], sb);
    }
  } else if (threadIdx.x < geo.pb) {
    const int i = 2 * threadIdx.x;
    const int gc = lane0 + i;
    const bool l0 = gc < out_w, l1 = gc + 1 < out_w;
    const float2 dv = eng::vec2(dout, gc);
    float2 sb = make_float2(0.f, 0.f), sd = sb;
    for (int r = 0; r < rows; r += 4) {
      const int nr = min(4, rows - r);
      float2 gv[4], z[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < nr) {
          gv[k] = eng::ld2(gst + (long)(r + k) * w + i);
          gv[k] = make_float2(l0 ? gv[k].x : 0.f, l1 ? gv[k].y : 0.f);
          z[k] = eng::ld2(s.zL + (long)(r + k) * w + i);
        }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < nr) {
          const float2 e = make_float2(cot(gv[k].x, z[k].x, gc),
                                       cot(gv[k].y, z[k].y, gc + 1));
          sb = eng::add2(sb, e);
          sd = eng::add2(sd, eng::mul2(e, z[k]));
          eng::st2(s.zL + (long)(r + k) * w + i, eng::mul2(e, dv));
        }
    }
    eng::st2(vd + i, eng::add2(eng::ld2(vd + i), sd));
    if (vb) eng::st2(vb + i, eng::add2(eng::ld2(vb + i), sb));
  }
}

// One stack's walk state: stack s (0 or 1) of lane block c, its table and
// grad sums in shared memory or in `slab` (streamed), the stages and
// passes set up already.
__device__ __forceinline__ Stack make_stack(unsigned char* smem,
                                            const BlockLayout& lay, int s,
                                            int L, const eng::Shape& sh,
                                            int c, bool streamed,
                                            float4* slab) {
  Stack k;
  k.geo = eng::Geo{L,    sh.w, sh.pb, sh.rs, sh.R, c, 0, sh.C,
                   __ffs(sh.C) - 1, eng::magic((unsigned)sh.w)};
  k.stg = reinterpret_cast<eng::Stage*>(smem + lay.stg[s]);
  k.ps = reinterpret_cast<eng::Pass*>(smem + lay.pas[s]);
  if (streamed) {
    k.tbl = slab;
    k.acc = slab + (long)L * sh.pb;
  } else {
    k.tbl = reinterpret_cast<float4*>(smem + lay.tbl[s]);
    k.acc = reinterpret_cast<float4*>(smem + lay.acc[s]);
  }
  k.tiles = reinterpret_cast<float*>(smem + lay.tiles[s]);
  k.np = sh.np;
  k.zL = k.tiles + (long)k.np * sh.R * sh.w;
  k.spare = k.zL + (long)sh.R * sh.w;
  k.tail_b = sh.tailb;
  k.head_b = k.last_b = false;
  return k;
}

// kTwo: a second stack.
template <typename T, bool kTwo>
__global__ void __launch_bounds__(512, 1) spm_block_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ gy, T* __restrict__ gx,
    const float* __restrict__ rstd, const float* __restrict__ gamma,
    const float4* __restrict__ cf1, const float* __restrict__ din1,
    const float* __restrict__ dout1, const float* __restrict__ bias1,
    const float4* __restrict__ cf2, const float* __restrict__ din2,
    const float* __restrict__ dout2, const float* __restrict__ bias2,
    float4* __restrict__ part_cf1, float4* __restrict__ part_cf2,
    float* __restrict__ part_vec, float4* __restrict__ slabs, int B, int n,
    int in_w, int mid_w, int out_w, int act, int residual, int streamed,
    eng::Shape sh1, eng::Shape sh2, SpmStrides st1, SpmStrides st2) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int C = sh1.C, w = sh1.w, pb = sh1.pb, R = sh1.R;
  const int g = blockIdx.x / C;
  const int lane0 = c * w;
  constexpr bool two = kTwo;
  const bool norm = gamma != nullptr;
  const int half = n >> 1;
  const int nvec = two ? N_VEC : V_DIN2;
  const long step = (long)sh1.G * R;
  const int L[2] = {st1.n, two ? st2.n : 0};
  const eng::Shape shs[2] = {sh1, sh2};
  const bool gy_b = two ? sh2.tailb : sh1.tailb;  // z_L that gy meets in B
  const BlockLayout lay = block_layout(L, shs, streamed, nvec, sizeof(T),
                                       gy_b ? 4 : sizeof(T), norm);

  // this block's slab of the streamed tables: stack 1's, then stack 2's
  float4* slab = slabs ? slabs + (long)blockIdx.x * 2 * pb *
                                     (L[0] + (streamed > 1 ? L[1] : 0))
                       : nullptr;
  Stack s1 = make_stack(smem, lay, 0, L[0], sh1, c, streamed > 0, slab);
  Stack s2;
  if constexpr (kTwo)
    s2 = make_stack(smem, lay, 1, L[1], sh2, c, streamed > 1,
                    slab ? slab + 2L * L[0] * pb : nullptr);
  Stack& sy = two ? s2 : s1;  // the stack gy meets
  float4* part = reinterpret_cast<float4*>(smem + lay.part);
  float* vacc = reinterpret_cast<float*>(smem + lay.vacc);
  T* gst = reinterpret_cast<T*>(smem + lay.gst);
  uint32_t* gsw = reinterpret_cast<uint32_t*>(smem + lay.gst);
  float* rsd = reinterpret_cast<float*>(smem + lay.stats);  // a chunk's rstd
  float* mean = rsd + R;
  float* rowp = mean + R;  // this block's row sums, by chunk parity
  float* red = rowp + 2 * R;  // 32 partials a row

  // stack 1's z_L stays in layout A with a second stack (the mid step is
  // per lane); the stack gy meets keeps it in its last pass's layout
  eng::setup(st1, w, C, c, two ? eng::kLayA : -1, s1.stg, s1.ps);
  if constexpr (kTwo) eng::setup(st2, w, C, c, -1, s2.stg, s2.ps);
  __syncthreads();
  eng::load_table(s1.geo, s1.stg, cf1, half, s1.tbl, s1.acc, vacc, nvec);
  s1.head_b = s1.ps[0].lin == eng::kLayB;
  s1.last_b = s1.ps[s1.np - 1].lin == eng::kLayB;
  if constexpr (kTwo) {
    eng::load_table(s2.geo, s2.stg, cf2, half, s2.tbl, s2.acc, vacc, nvec);
    s2.head_b = s2.ps[0].lin == eng::kLayB;
    s2.last_b = s2.ps[s2.np - 1].lin == eng::kLayB;
  }
  const long gy_total = (long)B * out_w;
  long r0 = (long)g * R;
  if (r0 < B) {
    const int rows = (int)min((long)R, B - r0);
    eng::stage_rows(reinterpret_cast<T*>(smem + lay.xst), x, in_w, r0, rows,
                    w, lane0, in_w);
    if (gy_b)
      eng::stage_rows_b(gsw, gy, out_w, gy_total, r0, rows, w, C, c, 0,
                        out_w);
    else
      eng::stage_rows(gst, gy, out_w, r0, rows, w, lane0, out_w);
  }
  for (int k = 0; r0 < B; r0 += step, ++k) {
    const int rows = (int)min((long)R, B - r0);
    const T* xcur =
        reinterpret_cast<const T*>(smem + lay.xst + (k & 1) * lay.xst_stride);
    if (norm)
      for (int r = threadIdx.x; r < rows; r += blockDim.x)
        rsd[r] = __ldg(rstd + r0 + r);
    eng::cp_wait_all();
    eng::sync(s1.head_b);
    const long r1 = r0 + step;
    if (r1 < B) {
      T* xnext = reinterpret_cast<T*>(smem + lay.xst +
                                      ((k + 1) & 1) * lay.xst_stride);
      eng::stage_rows(xnext, x, in_w, r1, (int)min((long)R, B - r1), w,
                      lane0, in_w);
    }

    // remat: t1 = ((x rstd) gamma) d_in1, x masked to in_w, in stack 1's
    // pass 0 layout; lanes (i, i+1) a thread, four rows at a time
    if (threadIdx.x < pb) {
      const int i = 2 * threadIdx.x;
      const int gc = lane0 + i;
      const bool l0 = gc < in_w, l1 = gc + 1 < in_w;
      const float2 din = eng::vec2(din1, gc), gam = eng::vec2(gamma, gc);
      for (int r = 0; r < rows; r += 4) {
        const int nr = min(4, rows - r);
        float2 v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < nr) v[q] = x_lanes(xcur + (long)(r + q) * w + i, l0, l1);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < nr) {
            float2 z = v[q];
            if (norm) {
              const float rq = rsd[r + q];
              z = eng::mul2(make_float2(__fmul_rn(z.x, rq),
                                        __fmul_rn(z.y, rq)), gam);
            }
            z = eng::mul2(z, din);
            if (s1.head_b) {
              eng::put(s1.tiles, s1.geo, eng::kLayB, r + q, i, z.x);
              eng::put(s1.tiles, s1.geo, eng::kLayB, r + q, i + 1, z.y);
            } else {
              eng::st2(s1.tiles + (long)(r + q) * w + i, z);
            }
          }
      }
    }
    eng::sync(s1.head_b || s1.ps[0].remf);
    // with a second stack whose pass 0 reads layout B, the mid step writes
    // the peers' tiles: the barrier after stack 1's remat is the cluster's
    eng::remat(s1.geo, s1.stg, s1.ps, s1.np, rows, s1.tbl, s1.tiles,
               two && s2.head_b);

    if constexpr (kTwo) {
      // t2 = act(mask_mid(z1 d_out1 [+ b1])) d_in2 into stack 2's tile 0
      if (threadIdx.x < pb) {
        const int i = 2 * threadIdx.x;
        const int gc = lane0 + i;
        const float2 dv = eng::vec2(dout1, gc), d2 = eng::vec2(din2, gc);
        const float2 b1 = bias1 ? eng::vec2(bias1, gc) : make_float2(0.f, 0.f);
        for (int r = 0; r < rows; ++r) {
          const float2 z1 = eng::ld2(s1.zL + (long)r * w + i);
          float2 u = eng::mul2(z1, dv);
          if (bias1) u = eng::add2(u, b1);
          const float2 t = make_float2(
              __fmul_rn(spm_act(gc < mid_w ? u.x : 0.f, act), d2.x),
              __fmul_rn(spm_act(gc + 1 < mid_w ? u.y : 0.f, act), d2.y));
          if (s2.head_b) {
            eng::put(s2.tiles, s2.geo, eng::kLayB, r, i, t.x);
            eng::put(s2.tiles, s2.geo, eng::kLayB, r, i + 1, t.y);
          } else {
            eng::st2(s2.tiles + (long)r * w + i, t);
          }
        }
      }
      eng::sync(s2.head_b || s2.ps[0].remf);
      eng::remat(s2.geo, s2.stg, s2.ps, s2.np, rows, s2.tbl, s2.tiles,
                 false);
    }

    // the epilogue from gy: stack 2's (g_b2, g_dout2), or stack 1's
    // (through the activation when there is one)
    gy_epilogue(sy, gst, gsw, r0 * out_w, rows, lane0, out_w,
                two ? dout2 : dout1, two ? bias2 : bias1, mid_w, act,
                !two && act != ACT_NONE, vacc + (two ? V_DOUT2 : V_DOUT1) * w,
                (two ? bias2 : bias1)
                    ? vacc + (two ? V_B2 : V_B1) * w
                    : nullptr);
    eng::sync(sy.ps[sy.np - 1].remb);
    if (r1 < B && gy_b)
      eng::stage_rows_b(gsw, gy, out_w, gy_total, r1,
                        (int)min((long)R, B - r1), w, C, c, 0, out_w);
    else if (r1 < B)
      eng::stage_rows(gst, gy, out_w, r1, (int)min((long)R, B - r1), w,
                      lane0, out_w);

    float* dl = eng::walk_back(sy.geo, sy.stg, sy.ps, sy.np, rows, sy.tbl,
                               sy.acc, part, sy.tiles, sy.zL);
    if constexpr (kTwo) {
      // through the activation: g_din2, g_b1, g_dout1, and stack 1's
      // cotangent du d_out1 (layout A in place of z1, or B in the spare)
      if (threadIdx.x < pb) {
        const int i = 2 * threadIdx.x;
        const float2 dv = eng::vec2(dout1, lane0 + i);
        const float2 d2 = eng::vec2(din2, lane0 + i);
        const float2 b1 =
            bias1 ? eng::vec2(bias1, lane0 + i) : make_float2(0.f, 0.f);
        float s_din2[2] = {0.f, 0.f}, s_b1[2] = {0.f, 0.f},
              s_dout1[2] = {0.f, 0.f};
        for (int r = 0; r < rows; ++r) {
          const float2 z1 = eng::ld2(s1.zL + (long)r * w + i);
          const float2 d = eng::ld2(dl + (long)r * w + i);
          float e[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gc = lane0 + i + h;
            const float zz = h ? z1.y : z1.x, dd = h ? d.y : d.x;
            float u = __fmul_rn(zz, h ? dv.y : dv.x);
            if (bias1) u = __fadd_rn(u, h ? b1.y : b1.x);
            if (gc >= mid_w) u = 0.f;
            s_din2[h] = __fadd_rn(s_din2[h], __fmul_rn(dd, spm_act(u, act)));
            const float dh = gc < mid_w ? __fmul_rn(dd, h ? d2.y : d2.x) : 0.f;
            const float du = __fmul_rn(dh, spm_act_grad(u, act));
            s_b1[h] = __fadd_rn(s_b1[h], du);
            s_dout1[h] = __fadd_rn(s_dout1[h], __fmul_rn(du, zz));
            e[h] = __fmul_rn(du, h ? dv.y : dv.x);
          }
          if (s1.last_b) {
            eng::put(s1.spare, s1.geo, eng::kLayB, r, i, e[0]);
            eng::put(s1.spare, s1.geo, eng::kLayB, r, i + 1, e[1]);
          } else {
            eng::st2(s1.zL + (long)r * w + i, make_float2(e[0], e[1]));
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* v = vacc + i + h;
          v[V_DIN2 * w] = __fadd_rn(v[V_DIN2 * w], s_din2[h]);
          if (bias1) v[V_B1 * w] = __fadd_rn(v[V_B1 * w], s_b1[h]);
          v[V_DOUT1 * w] = __fadd_rn(v[V_DOUT1 * w], s_dout1[h]);
        }
      }
      eng::sync(s1.last_b || s1.ps[s1.np - 1].remb);
      dl = eng::walk_back(s1.geo, s1.stg, s1.ps, s1.np, rows, s1.tbl,
                          s1.acc, part, s1.tiles,
                          s1.last_b ? s1.spare : s1.zL);
    }

    // g_din1, g_gamma, and gxh (or g_x without the norm) in place of delta;
    // each thread's row sums of gxh xh into stack 1's tile 0, free now
    float* prod = s1.tiles;
    if (threadIdx.x < pb) {
      const int i = 2 * threadIdx.x;
      const int gc = lane0 + i;
      const bool l0 = gc < in_w, l1 = gc + 1 < in_w;
      const float2 din = eng::vec2(din1, gc), gam = eng::vec2(gamma, gc);
      float2 si = make_float2(0.f, 0.f), sg = si;
      for (int r = 0; r < rows; ++r) {
        const float2 xv = x_lanes(xcur + (long)r * w + i, l0, l1);
        const float2 d = eng::ld2(dl + (long)r * w + i);
        float2 xh = xv, z0 = xv;
        if (norm) {
          xh = make_float2(__fmul_rn(xv.x, rsd[r]), __fmul_rn(xv.y, rsd[r]));
          z0 = eng::mul2(xh, gam);
        }
        si = eng::add2(si, eng::mul2(d, z0));
        const float2 dz0 = make_float2(l0 ? __fmul_rn(d.x, din.x) : 0.f,
                                       l1 ? __fmul_rn(d.y, din.y) : 0.f);
        float2 v = dz0;
        if (norm) {
          sg = eng::add2(sg, eng::mul2(dz0, xh));
          v = eng::mul2(dz0, gam);  // gxh
          prod[(long)r * pb + threadIdx.x] =
              __fadd_rn(__fmul_rn(v.x, xh.x), __fmul_rn(v.y, xh.y));
        } else if (residual) {
          const T* gr = gy + (r0 + r) * out_w;
          if (gc < out_w) v.x = __fadd_rn(v.x, spm_ld(gr + gc));
          if (gc + 1 < out_w) v.y = __fadd_rn(v.y, spm_ld(gr + gc + 1));
        }
        eng::st2(dl + (long)r * w + i, v);
      }
      eng::st2(vacc + V_DIN1 * w + i,
               eng::add2(eng::ld2(vacc + V_DIN1 * w + i), si));
      if (norm)
        eng::st2(vacc + V_GAMMA * w + i,
                 eng::add2(eng::ld2(vacc + V_GAMMA * w + i), sg));
    }
    if (norm) {
      // the row mean of gxh xh: 32 strided partials of the threads' sums a
      // row, those in order, then the C blocks' in rank order
      __syncthreads();
      for (int e = threadIdx.x; e < rows * 32; e += blockDim.x) {
        const int r = e >> 5;
        float a = 0.f;
        for (int t = e & 31; t < pb; t += 32)
          a = __fadd_rn(a, prod[(long)r * pb + t]);
        red[e] = a;
      }
      __syncthreads();
      float* rp = rowp + (k & 1) * R;
      for (int r = threadIdx.x; r < rows; r += blockDim.x) {
        float a = 0.f;
        for (int j = 0; j < 32; ++j) a = __fadd_rn(a, red[r * 32 + j]);
        rp[r] = a;
      }
      eng::sync(C > 1);  // every block's row sums written
      for (int r = threadIdx.x; r < rows; r += blockDim.x) {
        float a = 0.f;
        for (int o = 0; o < C; ++o)
          a = __fadd_rn(a, o == c ? rp[r] : *cluster.map_shared_rank(rp + r, o));
        mean[r] = __fdiv_rn(a, (float)in_w);
      }
      __syncthreads();
      // g_x = rstd (gxh - xh mean) [+ gy]
      if (threadIdx.x < pb) {
        const int i = 2 * threadIdx.x;
        const int gc = lane0 + i;
        const bool l0 = gc < in_w, l1 = gc + 1 < in_w;
        for (int r = 0; r < rows; ++r) {
          const float2 xv = x_lanes(xcur + (long)r * w + i, l0, l1);
          const float q = rsd[r], m = mean[r];
          const float2 gxh = eng::ld2(dl + (long)r * w + i);
          float2 v = make_float2(
              __fmul_rn(q, __fsub_rn(gxh.x, __fmul_rn(__fmul_rn(xv.x, q), m))),
              __fmul_rn(q, __fsub_rn(gxh.y, __fmul_rn(__fmul_rn(xv.y, q), m))));
          if (residual) {
            const T* gr = gy + (r0 + r) * out_w;
            if (gc < out_w) v.x = __fadd_rn(v.x, spm_ld(gr + gc));
            if (gc + 1 < out_w) v.y = __fadd_rn(v.y, spm_ld(gr + gc + 1));
          }
          eng::st2(dl + (long)r * w + i, v);
        }
      }
    }
    __syncthreads();
    eng::store_rows(gx, in_w, r0, rows, w, lane0, in_w, dl);
  }

  eng::store_table_grads(s1.geo, s1.stg, s1.acc, part_cf1 + (long)g * L[0] * half,
                         half);
  if constexpr (kTwo)
    eng::store_table_grads(s2.geo, s2.stg, s2.acc,
                           part_cf2 + (long)g * L[1] * half, half);
  // the sums of the stack gy meets by its z_L's layout, the rest by A's
  float* pv = part_vec + (long)g * nvec * n;
  const int vd = two ? V_DOUT2 : V_DOUT1, vb = two ? V_B2 : V_B1;
  for (int e = threadIdx.x; e < nvec * w; e += blockDim.x) {
    const int v = e / w;
    const int m = e - v * w;
    const int lane = gy_b && (v == vd || v == vb) ? m * C + c : lane0 + m;
    pv[(long)v * n + lane] = vacc[e];
  }
  cluster.sync();
}

// The passes of both stacks and the shared memory of a launch shape (host
// side); false when it does not fit.
static bool plan(const SpmStrides& st1, const SpmStrides& st2, bool two,
                 int n, int io_bytes, bool norm, int streamed,
                 eng::Shape* sh1, eng::Shape* sh2, size_t* smem) {
  if (!eng::valid_shape(*sh1, n) || st1.n < 1 || (two && st2.n < 1) ||
      streamed < 0 || streamed > (two ? 2 : 1))
    return false;
  eng::set_passes(st1, two ? eng::kLayA : -1, sh1);
  *sh2 = *sh1;
  sh2->np = sh2->spare = sh2->tailb = 0;
  if (two) eng::set_passes(st2, -1, sh2);
  const int L[2] = {st1.n, two ? st2.n : 0};
  const eng::Shape shs[2] = {*sh1, *sh2};
  const bool gy_b = two ? sh2->tailb : sh1->tailb;
  *smem = block_layout(L, shs, streamed, two ? N_VEC : V_DIN2, io_bytes,
                       gy_b ? 4 : io_bytes, norm)
              .total;
  return *smem <= 232448;
}

template <typename T>
static cudaError_t launch_block_bwd(
    const void* x, const void* gy, void* gx, const void* rstd,
    const void* gamma, const void* cf1, const void* din1, const void* dout1,
    const void* bias1, const void* cf2, const void* din2, const void* dout2,
    const void* bias2, void* g_cf1, void* g_cf2, void* g_vec, void* part_cf1,
    void* part_cf2, void* part_vec, void* slabs, int B, int n, int in_w,
    int mid_w, int out_w, int act, int residual, int streamed,
    const eng::Shape& sh1, const eng::Shape& sh2, size_t smem,
    const SpmStrides& st1, const SpmStrides& st2, cudaStream_t stream) {
  static size_t smem_set[2] = {0, 0};
  auto kernel = cf2 ? spm_block_bwd_kernel<T, true>
                    : spm_block_bwd_kernel<T, false>;
  cudaError_t e = spm_allow_smem(kernel, smem, &smem_set[cf2 != nullptr]);
  if (e != cudaSuccess) return e;
  e = eng::launch(kernel, dim3(sh1.G * sh1.C), sh1.pb * sh1.rs, smem, sh1.C,
                  stream, (const T*)x, (const T*)gy, (T*)gx,
                  (const float*)rstd, (const float*)gamma, (const float4*)cf1,
                  (const float*)din1, (const float*)dout1,
                  (const float*)bias1, (const float4*)cf2,
                  (const float*)din2, (const float*)dout2,
                  (const float*)bias2, (float4*)part_cf1, (float4*)part_cf2,
                  (float*)part_vec, (float4*)slabs, B, n, in_w, mid_w, out_w,
                  act, residual, streamed, sh1, sh2, st1, st2);
  if (e != cudaSuccess) return e;
  const long half4 = (long)(n / 2) * 4;
  e = spm_launch_sum((const float*)part_cf1, (float*)g_cf1, sh1.G, st1.n,
                     half4, half4, stream);
  if (e != cudaSuccess) return e;
  if (cf2) {
    e = spm_launch_sum((const float*)part_cf2, (float*)g_cf2, sh1.G, st2.n,
                       half4, half4, stream);
    if (e != cudaSuccess) return e;
  }
  const int nvec = cf2 ? N_VEC : V_DIN2;
  return spm_launch_sum((const float*)part_vec, (float*)g_vec, sh1.G, nvec, n,
                        n, stream);
}

// C interface (loaded with ctypes).  gamma/rstd, bias1, and the whole
// second stack (cf2, din2, dout2, bias2, g_cf2, part_cf2) may be null.
// g_vec is (7, n) f32: g_gamma, g_din1, g_dout1, g_bias1, g_din2, g_dout2,
// g_bias2 (the first 4 rows without a second stack; rows of absent
// operands are left meaningless).  part_cf1 (G, L1, n/2, 4), part_cf2 (G,
// L2, n/2, 4) and part_vec (G, 4 or 7, n) are the partial buffers; slabs
// (G C, 2 (L1 [+ L2]), n/(2C)) float4 the streamed tables' (null when
// streamed is 0).  The launch shape (C lane blocks, w, pb, rs, R, G,
// streamed stacks) is the planner's, kernels/spm_stack.py `bwd_plan` with
// its block form.  Returns the cudaError_t of the launches (0 on success).
extern "C" int spm_block_bwd(
    int io_type, const void* x, const void* gy, void* gx, const void* rstd,
    const void* gamma, const void* cf1, const void* din1, const void* dout1,
    const void* bias1, const void* cf2, const void* din2, const void* dout2,
    const void* bias2, void* g_cf1, void* g_cf2, void* g_vec, void* part_cf1,
    void* part_cf2, void* part_vec, void* slabs, int B, int n, int in_w,
    int mid_w, int out_w, int act, int residual, int C, int w, int pb, int rs,
    int R, int G, int streamed, const int* strides1, int L1,
    const int* strides2, int L2, void* stream) {
  SpmStrides st1, st2;
  const bool two = cf2 != nullptr;
  eng::Shape sh1{C, w, pb, rs, R, G, 0, 0, 0}, sh2;
  size_t smem;
  if (!spm_copy_strides(&st1, strides1, L1) ||
      !spm_copy_strides(&st2, strides2, two ? L2 : 0) || B <= 0 ||
      (gamma != nullptr) != (rstd != nullptr) || !din1 || !dout1 ||
      (two && (!din2 || !dout2)) || (streamed > 0) != (slabs != nullptr) ||
      io_type < SPM_IO_F32 || io_type > SPM_IO_BF16 ||
      !plan(st1, st2, two, n, io_type == SPM_IO_F32 ? 4 : 2,
            gamma != nullptr, streamed, &sh1, &sh2, &smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (io_type == SPM_IO_F32)
    return (int)launch_block_bwd<float>(
        x, gy, gx, rstd, gamma, cf1, din1, dout1, bias1, cf2, din2, dout2,
        bias2, g_cf1, g_cf2, g_vec, part_cf1, part_cf2, part_vec, slabs, B,
        n, in_w, mid_w, out_w, act, residual, streamed, sh1, sh2, smem, st1,
        st2, s);
  return (int)launch_block_bwd<__nv_bfloat16>(
      x, gy, gx, rstd, gamma, cf1, din1, dout1, bias1, cf2, din2, dout2,
      bias2, g_cf1, g_cf2, g_vec, part_cf1, part_cf2, part_vec, slabs, B, n,
      in_w, mid_w, out_w, act, residual, streamed, sh1, sh2, smem, st1, st2,
      s);
}
