// The big-N dense engine's bounce, in two kernels: K4 (box-culled free
// flight, albedo and NEE set-up) and K5 (the NEE shadow ray's
// transmittance and Li).
//
// Replace gvr_tpu/kernels/pathtrace_big.py:374 _big_call, its stage 1
// (pallas_call :384, body _make_kernel :98 with _chunk_quants_dir :329) and
// its NEE stage (pallas_call :409, body _make_nee_kernel :283).  The table
// is pack_table's [Np, 16] rows (Np a multiple of 256, at most 96 chunks of
// 256 Morton-sorted Gaussians), read as four float4 a row through the
// read-only cache, as K2 reads it; the boxes are chunk_boxes'
// [Np / 256, 9, 8] rows (a chunk's box, then its eight groups'), each read
// as two float4 (min xyz pad, max xyz pad).
//
// What bounds them on this card: arithmetic and the special-function
// units, not memory.  A pair test is about 95 flops with two IEEE
// divisions and a sqrtf (the pre-test 56 flops), and each pair a ray
// crosses adds two erff and an expf in every pass.  The table (64 B a
// Gaussian, 640 KB at 10k) stays in L2 and every thread of a warp reads
// the same row at once.
//
// Design.  The TPU kernel compacts the chunks a 64- or 128-ray block hits
// into nine [blk, cap*256] VMEM arrays and runs the Newton passes over
// them; a block of that would need megabytes, far beyond a block's shared
// memory.  Here one thread owns one ray and recomputes each pair from its
// row in every pass (as K2 and K7 do), and both kernels cull by geometry:
// - Boxes.  Each 256-row chunk has a box, and so has each of its eight
//   32-row groups: the union of their Gaussians' 3-sigma AABBs, widened by
//   a margin against float32 rounding.  A thread runs a slab test of its
//   ray (K4 over [0, inf), K5 over [0, tmax]) against each chunk's box and,
//   inside an admitted chunk, each group's; the warp walks a chunk's
//   groups, and a group's rows, only if some lane's test admits it
//   (__any_sync), and the lanes whose test failed skip the pair math.  On
//   each row the division-free pre-test (may_cross, bounce.cuh) rejects
//   the pairs whose line passes well outside the ellipsoid before
//   interval() does its two divisions and sqrtf.  These skips are exact: a
//   Gaussian's 3-sigma ellipsoid lies in its AABB, and the pre-test passes
//   every pair that interval() finds ok, so a skipped pair is one that adds
//   0, and the surviving pairs are summed in the same row order as a sweep
//   over every row.  (Groups: the warps of bounced and NEE rays, which fan
//   out, walked 22-30 chunks where each ray admits 7; PERF.md.)
// - K4's crossed-pair list.  The first pass records the rows of the ray's
//   ok pairs (BIG_MAX_HITS of them, K2's hit list) and the chunks that
//   held them (a 96-bit mask).  The solver_iters Newton passes and the
//   albedo pass recompute only the listed pairs; a ray with more ok pairs
//   than the list holds walks the rows of its masked chunks instead
//   (without the pre-test, which passes most pairs there).
// Nothing is shared between the threads of a block, so the block size is
// free (chosen by measurement).  The mask holds every chunk (plan()
// refuses scenes above 96), so the TPU kernel's overflow branch (tau_over,
// output column 7) is dead there and has no counterpart here.
//
// K5 is the shadow-ray pass of K2 (tau_nee's pair loop, bounce.cuh
// tau_nee_row) over the stored NEE rays, in the groups its box tests admit.
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
constexpr int BIG_GROUP = 32;       // Gaussians a group
constexpr int BIG_GROUPS = BIG_G / BIG_GROUP;
constexpr int BIG_BOXES = 1 + BIG_GROUPS;  // boxes a chunk
constexpr int BIG_MAX_CHUNKS = 96;  // plan()'s ceiling
constexpr int BIG_MAX_HITS = 32;    // K4's crossed-pair list
constexpr int BIG_BLOCK = 128;      // rays a block of K4 and of K5

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

// Calls row(g) for each row g of the groups the segment [0, tmax]'s box
// tests admit, in row order, and chunk(c) after each chunk c that some
// lane of the warp admits; counts the chunks and groups this lane's tests
// admit.  The warp votes on each box and skips it where no lane's test
// admits it.  Every lane of the warp must call it, an inactive one with
// active false.
template <class Row, class Chunk>
__device__ __forceinline__ void walk_admitted(
    const float4* __restrict__ boxes, int n_chunks, const BoxRay& br,
    float tmax, bool active, int& n_admit, int& n_groups, Row&& row,
    Chunk&& chunk) {
  for (int c = 0; c < n_chunks; ++c) {
    const bool admit = active && box_admits(boxes, BIG_BOXES * c, br, tmax);
    if (!__any_sync(FULL_WARP, admit)) continue;
    n_admit += admit;
    for (int q = 0; q < BIG_GROUPS; ++q) {
      const bool in_group =
          admit && box_admits(boxes, BIG_BOXES * c + 1 + q, br, tmax);
      if (!__any_sync(FULL_WARP, in_group)) continue;
      if (in_group) {
        ++n_groups;
        const int g0 = c * BIG_G + q * BIG_GROUP;
        for (int g = g0; g < g0 + BIG_GROUP; ++g) row(g);
      }
    }
    chunk(c);
  }
}

// Calls f(pair) for every ok pair of the ray, in row order: the listed
// rows, or, when the ray crossed more than BIG_MAX_HITS Gaussians, every
// row of the chunks in its mask.
template <class F>
__device__ __forceinline__ void for_each_crossed(
    const float4* __restrict__ tab, const Ray& r, const uint16_t* hits,
    int n_ok, const uint32_t (&mask)[3], F&& f) {
  if (n_ok <= BIG_MAX_HITS) {
    for (int j = 0; j < n_ok; ++j) {
      Pair p;
      if (make_pair(tab, hits[j], r, p)) f(p);
    }
    return;
  }
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    for (uint32_t m = mask[w]; m != 0u; m &= m - 1u) {
      const int c = 32 * w + __ffs(m) - 1;
      for (int g = c * BIG_G; g < (c + 1) * BIG_G; ++g) {
        Pair p;
        if (make_pair(tab, g, r, p)) f(p);
      }
    }
  }
}

// K4: one thread per ray.  xi [b, 5] uniforms (target, NEE choice, light
// index, env direction x2); out [16, b] (BigRow); admitted [2, b] (or
// null): the chunks and the groups the ray's box tests admitted.
__global__ void __launch_bounds__(BIG_BLOCK)
    big_stage1_kernel(const float4* __restrict__ tab, int np,
                      const float4* __restrict__ boxes,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ xi, int b,
                      const float* __restrict__ light_rows, int n_lights,
                      int solver_iters, float* __restrict__ out,
                      int* __restrict__ admitted) {
  const int i = blockIdx.x * BIG_BLOCK + threadIdx.x;
  const bool active = i < b;
  Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  if (active)
    r = {o[3 * i], o[3 * i + 1], o[3 * i + 2],
         d[3 * i], d[3 * i + 1], d[3 * i + 2]};

  // --- first pass over the admitted rows: tau_tot, the bracket, the
  // crossed-pair list and the chunk mask ---
  uint16_t hits[BIG_MAX_HITS];
  uint32_t mask[3] = {0u, 0u, 0u};
  int n_ok = 0, n_before = 0, n_admit = 0, n_groups = 0;
  float tau_tot = 0.0f, t_lo = BIG, t_hi = 0.0f;
  walk_admitted(
      boxes, np / BIG_G, box_ray(r), INFINITY, active, n_admit, n_groups,
      [&](int g) {
        Pair p;
        if (!may_cross(tab, g, r) || !make_pair(tab, g, r, p)) return;
        tau_tot += p.tau_i;
        t_lo = fminf(t_lo, p.t0);
        t_hi = fmaxf(t_hi, p.t1);
        if (n_ok < BIG_MAX_HITS) hits[n_ok] = static_cast<uint16_t>(g);
        ++n_ok;
      },
      [&](int c) {
        // constant indices keep the mask in registers
        const uint32_t bit = n_ok > n_before ? 1u << (c & 31) : 0u;
        mask[0] |= c < 32 ? bit : 0u;
        mask[1] |= c >= 32 && c < 64 ? bit : 0u;
        mask[2] |= c >= 64 ? bit : 0u;
        n_before = n_ok;
      });
  if (!active) return;
  if (admitted) {
    admitted[i] = n_admit;
    admitted[b + i] = n_groups;
  }
  t_lo = fminf(t_lo, t_hi);

  const float* x = xi + 5 * i;
  const float target = -logf(fmaxf(1.0f - x[0], 1e-12f));
  const bool scattered = tau_tot > target;
  const float tgt = fminf(target, tau_tot * 0.999999f);

  // --- solver_iters Newton + inset-Illinois steps over the crossed pairs
  float lo = t_lo, hi = t_hi, flo = -tgt;
  float fhi = fmaxf(tau_tot - tgt, 1e-12f);
  float t = 0.5f * (t_lo + t_hi);
  for (int it = 0; it < solver_iters; ++it) {
    float tau = 0.0f, sig = 0.0f;
    for_each_crossed(tab, r, hits, n_ok, mask,
                     [&](const Pair& p) { tau_sig_at(p, t, tau, sig); });
    illinois_update_inset(lo, hi, flo, fhi, t, tau - tgt, sig);
  }
  const float t_sc = fminf(fmaxf(t, t_lo), t_hi);

  // --- mixture albedo at the scatter point (gmm.h:128-143) ---
  float s_sum = 0.0f, sa_sum = 0.0f;
  for_each_crossed(tab, r, hits, n_ok, mask, [&](const Pair& p) {
    albedo_at(p, t_sc, s_sum, sa_sum);
  });

  const NeeRay n = nee_ray(r, t_sc, x[1], x[2], x[3], x[4], light_rows,
                           n_lights);
  const float row[kBigRows] = {
      t_sc, scattered ? 1.0f : 0.0f, mixture_albedo(s_sum, sa_sum), tau_tot,
      n.s.ox, n.s.oy, n.s.oz, n.s.dx, n.s.dy, n.s.dz, n.tmax,
      n.is_env ? 1.0f : 0.0f, n.rad[0], n.rad[1], n.rad[2], n.inv_d2};
  for (int k = 0; k < kBigRows; ++k)
    out[static_cast<size_t>(k) * b + i] = row[k];
}

// K5: one thread per NEE ray of stage 1's rows; out [3, b] Li; admitted
// [2, b] (or null): the chunks and the groups the segment's box tests
// admitted.
__global__ void __launch_bounds__(BIG_BLOCK)
    big_nee_kernel(const float4* __restrict__ tab, int np,
                   const float4* __restrict__ boxes,
                   const float* __restrict__ s1, int b,
                   const float* __restrict__ env, float* __restrict__ out,
                   int* __restrict__ admitted) {
  const int i = blockIdx.x * BIG_BLOCK + threadIdx.x;
  const bool active = i < b;
  const auto at = [&](int k) { return s1[static_cast<size_t>(k) * b + i]; };
  Ray s = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  float tmax = 0.0f;
  if (active) {
    s = {at(kPx), at(kPx + 1), at(kPx + 2), at(kWx), at(kWx + 1), at(kWx + 2)};
    tmax = at(kTmax);
  }
  float tau = 0.0f;
  int n_admit = 0, n_groups = 0;
  walk_admitted(
      boxes, np / BIG_G, box_ray(s), tmax, active, n_admit, n_groups,
      [&](int g) { tau_nee_row(tab, g, s, tmax, tau); }, [](int) {});
  if (!active) return;
  if (admitted) {
    admitted[i] = n_admit;
    admitted[b + i] = n_groups;
  }
  const float tr = expf(-tau);
  const bool is_env = at(kIsEnv) > 0.5f;
  for (int c = 0; c < 3; ++c)
    out[static_cast<size_t>(c) * b + i] =
        is_env ? tr * (__ldg(env + c) * FOUR_PI_F)
               : tr * at(kRad + c) * at(kInvD2);
}

}  // namespace gvr
