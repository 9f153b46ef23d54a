// The big-N dense engine's bounce, in two kernels: K4 (box-culled free
// flight, albedo and NEE set-up) and K5 (the NEE shadow ray's
// transmittance and Li).
//
// Replace gvr_tpu/kernels/pathtrace_big.py:374 _big_call, its stage 1
// (pallas_call :384, body _make_kernel :98 with _chunk_quants_dir :329) and
// its NEE stage (pallas_call :409, body _make_nee_kernel :283).  The table
// is pack_table's [Np, 16] rows (Np a multiple of 256, at most 96 chunks of
// 256 Morton-sorted Gaussians), read as four float4 a row through the
// read-only cache; the boxes are chunk_boxes' [Np / 256, 9, 8] rows (a
// chunk's box, then its eight groups'), each read as two float4 (min xyz
// pad, max xyz pad).
//
// What bounds them on this card: arithmetic and the special-function
// units, not memory.  A pair test is about 95 flops with two IEEE
// divisions and a sqrtf (the pre-test 56 flops), and each pair a ray
// crosses adds two erff and an expf in every pass.  The table (64 B a
// Gaussian, 640 KB at 10k) stays in L2.
//
// Design.  The TPU kernel compacts the chunks a 64- or 128-ray block hits
// into nine [blk, cap*256] VMEM arrays and runs the Newton passes over
// them; a block of that would need megabytes, far beyond a block's shared
// memory.  Here one warp traces one ray, and a 32-row group of the table is
// one row a lane:
// - Boxes.  Each 256-row chunk has a box, and so has each of its eight
//   32-row groups: the union of their Gaussians' 3-sigma AABBs, widened by
//   a margin against float32 rounding.  Lane l runs the slab test of the
//   ray (K4 over [0, inf), K5 over [0, tmax]) against chunk boxes l, l + 32
//   and l + 64, then against the group boxes of the admitted chunks, four
//   chunks (32 boxes) a step; a ballot gives the admitted groups in row
//   order.  The warp walks only its own ray's groups: with one thread a ray
//   a warp walked the union of 32 rays' groups (139 where a bounced ray
//   admits 14.6; PERF.md), and a launch held 16 warps an SM at most.
// - Rows.  In an admitted group lane l takes row g0 + l: the
//   division-free pre-test (may_cross, bounce.cuh) rejects the pairs whose
//   line passes well outside the ellipsoid before interval() does its two
//   divisions and sqrtf.  These skips are exact: a Gaussian's 3-sigma
//   ellipsoid lies in its AABB, and the pre-test passes every pair that
//   interval() finds ok, so a skipped pair is one that adds 0.
// - Sums in row order.  t_lo and t_hi are a warp's min and max.  Each sum
//   (tau_tot, a Newton pass's tau and extinction, the albedo's two, K5's
//   tau) is taken term by term in row order by ordered_fma over the lanes
//   that hold a term, on every lane alike, with the operation the sum had
//   with one thread a ray (a product added in one rounding where the
//   compiler contracted it): the same bits as a sweep over every row.
// - K4's crossed-pair list.  The first pass keeps each ok pair, up to
//   BIG_MAX_HITS, in the warp's slice of shared memory (pair k in lane
//   k % 32's column), and marks the groups that held one (lane w holds
//   the bits of groups 32w to 32w + 31).  The solver_iters Newton passes
//   and the albedo pass read the listed pairs, one a lane; a ray with more
//   than the list holds recomputes the rows of its marked groups, 32 at a
//   time, and adds one to the optional overflow counter.
// The mask holds every group (plan() refuses scenes above 96 chunks), so
// the TPU kernel's overflow branch (tau_over, output column 7) is dead
// there and has no counterpart here.  The sizes are measured (PERF.md):
// blocks of 2 and 4 rays took the same time and 8 up to 17 % more; K4 at
// 8 blocks an SM (64 registers, 32 warps) took 3-13 % less than at its
// free 72 registers (28 warps); a list of 64 pairs gained nothing, as no
// ray of the 10k cell crosses more than 32.
//
// K5 is the shadow-ray pass of K2 (tau_nee's pair loop, bounce.cuh
// tau_nee_row, with its term and its sum apart in nee_term) over the
// stored NEE rays, in the groups its box tests admit.
//
// K4's Newton step is its own, not illinois_update: the falsi point is
// clipped to a 5 % inset of the bracket and a Newton point is taken
// without a finite test (pathtrace_big.py:174-198); it has no erfinv
// finisher.
#pragma once

#include <math.h>

#include "bounce.cuh"
#include "common.cuh"

namespace gvr {

constexpr int BIG_G = 256;          // Gaussians a chunk
constexpr int BIG_GROUP = 32;       // Gaussians a group: a row a lane
constexpr int BIG_GROUPS = BIG_G / BIG_GROUP;
constexpr int BIG_BOXES = 1 + BIG_GROUPS;  // boxes a chunk
constexpr int BIG_MAX_CHUNKS = 96;  // plan()'s ceiling
constexpr int BIG_MAX_HITS = 32;    // K4's crossed-pair list, a pair a lane
constexpr int BIG_WARPS = 4;        // rays (warps) a block of K4 and of K5
constexpr int BIG_K4_BLOCKS = 8;    // K4's blocks an SM: 64 registers
static_assert(BIG_GROUP == 32, "a group is one row a lane");
static_assert(BIG_MAX_CHUNKS * BIG_GROUPS <= 32 * 32,
              "the group mask is a word a lane");

// Stage-1 output rows ([16, b], one column a ray); K5 reads rows 4-15.
enum BigRow {
  kTsc = 0, kScattered = 1, kAlbedo = 2, kTauTot = 3, kPx = 4, kWx = 7,
  kTmax = 10, kIsEnv = 11, kRad = 12, kInvD2 = 15, kBigRows = 16
};

// pathtrace_big.py:174-198, line for line.
__device__ __forceinline__ void illinois_update_inset(float& lo, float& hi,
                                                      float& flo, float& fhi,
                                                      float& t, float f,
                                                      float sig) {
  const bool neg = f < 0.0f;
  flo = neg ? f : flo * 0.5f;
  fhi = neg ? fhi * 0.5f : f;
  lo = neg ? t : lo;
  hi = neg ? hi : t;
  const float t_n = t - f / fmaxf(sig, 1e-30f);
  const bool good = t_n > lo && t_n < hi;
  const float denom = fhi - flo;
  float t_f = hi - fhi * (hi - lo) / (fabsf(denom) > 1e-30f ? denom : 1e-30f);
  t_f = fminf(fmaxf(t_f, lo + 0.05f * (hi - lo)), hi - 0.05f * (hi - lo));
  t = good ? t_n : t_f;
}

// A ray set up for slab tests: 1/d on each axis the ray moves along;
// |d| < 1e-30 counts as not moving (flat).
struct BoxRay {
  float o[3], inv[3];
  bool flat[3];
};

__device__ __forceinline__ BoxRay box_ray(const Ray& r) {
  BoxRay br;
  const float o[3] = {r.ox, r.oy, r.oz}, d[3] = {r.dx, r.dy, r.dz};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    br.o[k] = o[k];
    br.flat[k] = fabsf(d[k]) < 1e-30f;
    br.inv[k] = 1.0f / (br.flat[k] ? 1.0f : d[k]);
  }
  return br;
}

// Does the segment [0, tmax] of the ray meet box k?  Per axis the slab's
// entry and exit times (lo - o) * inv and (hi - o) * inv, ordered by the
// sign of inv; a flat axis admits all t if the origin lies in the slab and
// none otherwise.  An empty box (min > max) is missed by every ray.  No
// operation here contracts into an FMA, so chunk_box_hits_reference's
// torch ops give the same answer bit for bit.
__device__ __forceinline__ bool box_admits(const float4* __restrict__ boxes,
                                           int k, const BoxRay& br,
                                           float tmax) {
  const float4 lo4 = __ldg(boxes + 2 * k), hi4 = __ldg(boxes + 2 * k + 1);
  const float lo[3] = {lo4.x, lo4.y, lo4.z}, hi[3] = {hi4.x, hi4.y, hi4.z};
  float t_near = 0.0f, t_far = tmax;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (br.flat[a]) {
      t_far = br.o[a] >= lo[a] && br.o[a] <= hi[a] ? t_far : -BIG;
    } else {
      const float ta = (lo[a] - br.o[a]) * br.inv[a];
      const float tb = (hi[a] - br.o[a]) * br.inv[a];
      t_near = fmaxf(t_near, br.inv[a] >= 0.0f ? ta : tb);
      t_far = fminf(t_far, br.inv[a] >= 0.0f ? tb : ta);
    }
  }
  return t_near <= t_far;
}

// acc = fmaf(x_k, y_k, acc) for each lane k of m in ascending order, on
// every lane alike (m is the same on all): a sum of the lanes' terms in
// row order.  A term added in its own rounding is (term, 1).
__device__ __forceinline__ float ordered_fma(uint32_t m, float x, float y,
                                             float acc) {
  for (; m != 0u; m &= m - 1u) {
    const int k = __ffs(m) - 1;
    acc = fmaf(__shfl_sync(FULL_WARP, x, k), __shfl_sync(FULL_WARP, y, k),
               acc);
  }
  return acc;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL_WARP, v, s));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_WARP, v, s));
  return v;
}

// Takes the lowest chunk out of the 96-bit mask (m0, m1, m2), not empty.
__device__ __forceinline__ int pop_chunk(uint32_t& m0, uint32_t& m1,
                                         uint32_t& m2) {
  if (m0 != 0u) {
    const int c = __ffs(m0) - 1;
    m0 &= m0 - 1u;
    return c;
  }
  if (m1 != 0u) {
    const int c = __ffs(m1) - 1;
    m1 &= m1 - 1u;
    return 32 + c;
  }
  const int c = __ffs(m2) - 1;
  m2 &= m2 - 1u;
  return 64 + c;
}

// Calls group(q) on every lane for each 32-row group q (rows 32q to
// 32q + 31) that the box tests of the ray's segment [0, tmax] admit, in
// row order, and counts the chunks and the groups admitted.  Lane l tests
// chunk boxes l, l + 32 and l + 64, then, four admitted chunks a step,
// lane l the group box l % 8 of the step's chunk l / 8.
template <class Group>
__device__ __forceinline__ void walk_groups(const float4* __restrict__ boxes,
                                            int n_chunks, const BoxRay& br,
                                            float tmax, int lane,
                                            int& n_admit, int& n_groups,
                                            Group&& group) {
  uint32_t m[3];
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    const int c = 32 * w + lane;
    m[w] = __ballot_sync(FULL_WARP, c < n_chunks &&
                                        box_admits(boxes, BIG_BOXES * c, br,
                                                   tmax));
  }
  n_admit = __popc(m[0]) + __popc(m[1]) + __popc(m[2]);
  n_groups = 0;
  for (int left = n_admit; left > 0; left -= 4) {
    uint32_t four = 0u;  // the step's chunks, a byte each
    for (int n = 0; n < 4 && n < left; ++n)
      four |= static_cast<uint32_t>(pop_chunk(m[0], m[1], m[2])) << (8 * n);
    const int s = lane >> 3;
    const int c = static_cast<int>((four >> (8 * s)) & 0xffu);
    uint32_t in = __ballot_sync(
        FULL_WARP,
        s < left && box_admits(boxes, BIG_BOXES * c + 1 + (lane & 7), br,
                               tmax));
    n_groups += __popc(in);
    for (; in != 0u; in &= in - 1u) {
      const int j = __ffs(in) - 1;
      group(BIG_GROUPS * static_cast<int>((four >> (8 * (j >> 3))) & 0xffu) +
            (j & 7));
    }
  }
}

// K4's test of row g: the pre-test, then the pair (make_pair's, with the
// erf difference d_erf that its tau_i is pref times).
__device__ __forceinline__ bool crossed_pair(const float4* __restrict__ tab,
                                             int g, const Ray& r, Pair& p,
                                             float& d_erf) {
  float a_s, b, t0, t1, m2, dens_norm;
  if (!may_cross(tab, g, r) ||
      !interval(tab, g, r, a_s, b, t0, t1, m2, dens_norm, p.albedo))
    return false;
  d_erf = pair_over(a_s, b, m2, dens_norm, t0, t1, p);
  return true;
}

// A warp's crossed-pair list in shared memory: a Pair with d_erf in
// place of tau_i (pref * d_erf), field f of pair k at
// v[f * BIG_MAX_HITS + k], so lane k % 32 writes and reads pair k on a
// bank of its own.
struct PairList {
  float* v;

  __device__ __forceinline__ void put(int k, const Pair& p,
                                      float d_erf) const {
    const float f[PAIR_FIELDS] = {p.sa, p.zoff, p.peak, p.pref, p.erf_lo,
                                  d_erf, p.t0, p.t1, p.albedo};
#pragma unroll
    for (int j = 0; j < PAIR_FIELDS; ++j) v[j * BIG_MAX_HITS + k] = f[j];
  }

  __device__ __forceinline__ Pair get(int k, float& d_erf) const {
    const float* q = v + k;
    d_erf = q[5 * BIG_MAX_HITS];
    return {q[0], q[BIG_MAX_HITS], q[2 * BIG_MAX_HITS], q[3 * BIG_MAX_HITS],
            q[4 * BIG_MAX_HITS], q[3 * BIG_MAX_HITS] * d_erf,
            q[6 * BIG_MAX_HITS], q[7 * BIG_MAX_HITS], q[8 * BIG_MAX_HITS]};
  }
};

// Calls f(p, d_erf, ok) on every lane for the ray's crossed pairs in row
// order, 32 a call, lane k with the call's k-th pair (ok false past the
// last): from the list, or, where the ray crossed more than BIG_MAX_HITS,
// from the rows of each group in held (lane w the bits of groups 32w to
// 32w + 31; n_words words), recomputed.
template <class F>
__device__ __forceinline__ void for_each_crossed(
    const float4* __restrict__ tab, const Ray& r, const PairList& list,
    int n_ok, uint32_t held, int n_words, int lane, F&& f) {
  if (n_ok <= BIG_MAX_HITS) {
    for (int k0 = 0; k0 < n_ok; k0 += 32) {
      const bool ok = k0 + lane < n_ok;
      Pair p = {};
      float d_erf = 0.0f;
      if (ok) p = list.get(k0 + lane, d_erf);
      f(p, d_erf, ok);
    }
    return;
  }
  for (int w = 0; w < n_words; ++w) {
    for (uint32_t m = __shfl_sync(FULL_WARP, held, w); m != 0u;
         m &= m - 1u) {
      Pair p = {};
      float d_erf = 0.0f;
      const bool ok = crossed_pair(
          tab, BIG_GROUP * (32 * w + __ffs(m) - 1) + lane, r, p, d_erf);
      f(p, d_erf, ok);
    }
  }
}

// K4: one warp per ray, rays 0 .. n_rays - 1 (or 0 .. *count - 1 where
// count is not null: a live list's count on the card, n_rays >= it sizing
// the grid).
// o, d [b, 3]; xi [b, 5] uniforms (target, NEE choice, light index, env
// direction x2); out [16, b] (BigRow); admitted [2, b] (or null): the
// chunks and the groups the ray's box tests admitted; overflow (or null):
// a count, to which each ray with more crossed pairs than BIG_MAX_HITS
// adds one.
__global__ void __launch_bounds__(32 * BIG_WARPS, BIG_K4_BLOCKS)
    big_stage1_kernel(int n_rays, const int* __restrict__ count,
                      const float4* __restrict__ tab, int np,
                      const float4* __restrict__ boxes,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ xi, int b,
                      const float* __restrict__ light_rows, int n_lights,
                      int solver_iters, float* __restrict__ out,
                      int* __restrict__ admitted, int* __restrict__ overflow) {
  __shared__ float lists[BIG_WARPS][PAIR_FIELDS * BIG_MAX_HITS];
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * BIG_WARPS + (threadIdx.x >> 5);
  if (i >= (count ? min(*count, n_rays) : n_rays)) return;  // the warp
  const PairList list = {lists[threadIdx.x >> 5]};
  const Ray r = {o[3 * i], o[3 * i + 1], o[3 * i + 2],
                 d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  const int n_chunks = np / BIG_G;

  // --- first pass over the admitted rows: tau_tot, the bracket, the
  // crossed-pair list and the groups that held a pair ---
  uint32_t held = 0u;
  int n_ok = 0, n_admit, n_groups;
  float tau_tot = 0.0f, t_lo = BIG, t_hi = 0.0f;
  walk_groups(boxes, n_chunks, box_ray(r), INFINITY, lane, n_admit,
              n_groups, [&](int q) {
                Pair p = {};
                float d_erf = 0.0f;
                const bool ok = crossed_pair(tab, BIG_GROUP * q + lane, r, p,
                                             d_erf);
                const uint32_t m = __ballot_sync(FULL_WARP, ok);
                if (m == 0u) return;
                tau_tot = ordered_fma(m, p.pref, d_erf, tau_tot);
                if (ok) {
                  t_lo = fminf(t_lo, p.t0);
                  t_hi = fmaxf(t_hi, p.t1);
                  const int k = n_ok + __popc(m & ((1u << lane) - 1u));
                  if (k < BIG_MAX_HITS) list.put(k, p, d_erf);
                }
                if (lane == q >> 5) held |= 1u << (q & 31);
                n_ok += __popc(m);
              });
  __syncwarp();
  t_hi = warp_max(t_hi);
  t_lo = fminf(warp_min(t_lo), t_hi);
  if (lane == 0) {
    if (admitted) {
      admitted[i] = n_admit;
      admitted[b + i] = n_groups;
    }
    if (overflow && n_ok > BIG_MAX_HITS) atomicAdd(overflow, 1);
  }
  const int n_words = (n_chunks * BIG_GROUPS + 31) / 32;
  const auto crossed = [&](auto&& f) {
    for_each_crossed(tab, r, list, n_ok, held, n_words, lane, f);
  };

  const float* x = xi + 5 * i;
  const float target = -logf(fmaxf(1.0f - x[0], 1e-12f));
  const bool scattered = tau_tot > target;
  const float tgt = fminf(target, tau_tot * 0.999999f);

  // --- solver_iters Newton + inset-Illinois steps over the crossed pairs:
  // tau_sig_at's terms, each lane its pair's ---
  float lo = t_lo, hi = t_hi, flo = -tgt;
  float fhi = fmaxf(tau_tot - tgt, 1e-12f);
  float t = 0.5f * (t_lo + t_hi);
  for (int it = 0; it < solver_iters; ++it) {
    float tau = 0.0f, sig = 0.0f;
    crossed([&](const Pair& p, float d_erf, bool ok) {
      const float z = p.sa * t + p.zoff;
      const bool on_tau = ok && t > p.t0;
      const bool on_sig = ok && t >= p.t0 && t <= p.t1;
      // pref * (t >= t1 ? d_erf : erf(z) - erf_lo) in one rounding, as the
      // compiler contracted tau_sig_at (its tau_i = pref * d_erf)
      float dz = 0.0f, e = 0.0f;
      if (on_tau)
        dz = t >= p.t1 ? d_erf : erff(z * SQRT_HALF) - p.erf_lo;
      if (on_sig) e = expf(-0.5f * z * z);
      tau = ordered_fma(__ballot_sync(FULL_WARP, on_tau), p.pref, dz, tau);
      sig = ordered_fma(__ballot_sync(FULL_WARP, on_sig), p.peak, e, sig);
    });
    illinois_update_inset(lo, hi, flo, fhi, t, tau - tgt, sig);
  }
  const float t_sc = fminf(fmaxf(t, t_lo), t_hi);

  // --- mixture albedo at the scatter point (gmm.h:128-143; albedo_at's
  // terms) ---
  float s_sum = 0.0f, sa_sum = 0.0f;
  crossed([&](const Pair& p, float, bool ok) {
    const bool on = ok && t_sc >= p.t0 && t_sc <= p.t1;
    float rho = 0.0f;
    if (on) {
      const float z = p.sa * t_sc + p.zoff;
      rho = p.peak * expf(-0.5f * z * z);
    }
    const uint32_t m = __ballot_sync(FULL_WARP, on);
    s_sum = ordered_fma(m, rho, 1.0f, s_sum);
    sa_sum = ordered_fma(m, rho, p.albedo, sa_sum);
  });

  if (lane != 0) return;
  const NeeRay n = nee_ray(r, t_sc, x[1], x[2], x[3], x[4], light_rows,
                           n_lights);
  const float row[kBigRows] = {
      t_sc, scattered ? 1.0f : 0.0f, mixture_albedo(s_sum, sa_sum), tau_tot,
      n.s.ox, n.s.oy, n.s.oz, n.s.dx, n.s.dy, n.s.dz, n.tmax,
      n.is_env ? 1.0f : 0.0f, n.rad[0], n.rad[1], n.rad[2], n.inv_d2};
  for (int k = 0; k < kBigRows; ++k)
    out[static_cast<size_t>(k) * b + i] = row[k];
}

// tau_nee_row's term for row g (bounce.cuh, the same operations): true
// with tau += pref * diff where the segment [0, tmax] crosses the pair.
__device__ __forceinline__ bool nee_term(const float4* __restrict__ tab,
                                         int g, const Ray& r, float tmax,
                                         float& pref, float& diff) {
  float a_s, b, t0, t1, m2, dens_norm, albedo;
  if (!may_cross(tab, g, r) ||
      !interval(tab, g, r, a_s, b, t0, t1, m2, dens_norm, albedo))
    return false;
  const float hi = fminf(t1, tmax);
  if (!(hi > t0)) return false;
  const float sa = sqrtf(a_s);
  const float zoff = b * (0.5f / sa);
  pref = dens_norm * expf(-0.5f * m2) * sqrtf(PI_F / (2.0f * a_s));
  diff = erff((sa * hi + zoff) * SQRT_HALF) -
         erff((sa * t0 + zoff) * SQRT_HALF);
  return true;
}

// K5: one warp per NEE ray of stage 1's rows [16, b], rays as K4's
// (n_rays, count); out [3, b] Li; admitted [2, b] (or null): the chunks
// and the groups the segment's box tests admitted.
__global__ void __launch_bounds__(32 * BIG_WARPS)
    big_nee_kernel(int n_rays, const int* __restrict__ count,
                   const float4* __restrict__ tab, int np,
                   const float4* __restrict__ boxes,
                   const float* __restrict__ s1, int b,
                   const float* __restrict__ env, float* __restrict__ out,
                   int* __restrict__ admitted) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * BIG_WARPS + (threadIdx.x >> 5);
  if (i >= (count ? min(*count, n_rays) : n_rays)) return;  // the warp
  const auto at = [&](int k) { return s1[static_cast<size_t>(k) * b + i]; };
  const Ray s = {at(kPx), at(kPx + 1), at(kPx + 2),
                 at(kWx), at(kWx + 1), at(kWx + 2)};
  const float tmax = at(kTmax);
  float tau = 0.0f;
  int n_admit, n_groups;
  walk_groups(boxes, np / BIG_G, box_ray(s), tmax, lane, n_admit, n_groups,
              [&](int q) {
                float pref = 0.0f, diff = 0.0f;
                const bool on = nee_term(tab, BIG_GROUP * q + lane, s, tmax,
                                         pref, diff);
                tau = ordered_fma(__ballot_sync(FULL_WARP, on), pref, diff,
                                  tau);
              });
  if (lane == 0 && admitted) {
    admitted[i] = n_admit;
    admitted[b + i] = n_groups;
  }
  if (lane >= 3) return;
  const float tr = expf(-tau);
  out[static_cast<size_t>(lane) * b + i] =
      at(kIsEnv) > 0.5f ? tr * (__ldg(env + lane) * FOUR_PI_F)
                        : tr * at(kRad + lane) * at(kInvD2);
}

}  // namespace gvr
