// Grid regular tracking for one (ray, cell): the device functions of the
// span-tau kernel (K6) and the cell-solve kernel (K7).
//
// Replace gvr_tpu/kernels/gridtrace.py:217 span_tau_pass (body
// _make_span_tau_kernel :93) and :425 solve_pass (body _make_solve_kernel
// :261).  A cell's entries are rows [first, first + count) of the
// cell-sorted table (accel/grid.py), 64 bytes each, read as four float4
// through the read-only cache.  A pair is computed from its row
// (interval + pair_over of bounce.cuh) with its interval clipped to the
// cell crossing, so erf_lo is taken at the clipped lower end, as the TPU
// kernels' _quants does; the TPU kernel's nine [s_cap*32, 128] VMEM
// arrays have no counterpart in a thread's registers.  Both walks run the
// division-free pre-test (may_cross) ahead of interval(): a cell of the
// 10k grid holds ~120 entries and a ray crosses ~2 of them (PERF.md).  One
// thread walks a cell for a slot (K6) or a ray (K7), and the threads of a
// warp take neighbouring rays, which mostly share the cell: a row load is
// then one broadcast to the warp.  K6 walks the cell once.  K7 walks it
// once for the cell's tau and bracket and keeps the offsets of the entries
// its ray crosses; its solver_iters Newton passes, the finisher and the
// albedo pass recompute only those, and a ray that crosses more than
// MAX_HITS walks the whole cell in every pass.
#pragma once

#include "bounce.cuh"
#include "common.cuh"

namespace gvr {

// The grid's shape: cell (ix, iy, iz) has id (ix * sy + iy) * sz + iz and
// box lo + (ix, iy, iz) * cell.
struct GridGeom {
  int sx, sy, sz;
  float lo[3];
  float cell[3];
};

// K7's walk: calls f(pair, offset) for the entries first + hits[k], k <
// n_hits (first + k where hits is null) whose 3-sigma interval meets
// [t_in, t_out], with the interval clipped to it, behind the pre-test
// where `pretest` (the first pass).
template <class F>
__device__ __forceinline__ void for_each_listed_pair(
    const float4* __restrict__ tab, int first, const uint16_t* hits,
    int n_hits, bool pretest, const Ray& r, float t_in, float t_out,
    F&& f) {
  for (int k = 0; k < n_hits; ++k) {
    const int g = first + (hits ? hits[k] : k);
    float a_s, b, t0, t1, m2, dens_norm;
    Pair p;
    if ((pretest && !may_cross(tab, g, r)) ||
        !interval(tab, g, r, a_s, b, t0, t1, m2, dens_norm, p.albedo))
      continue;
    const float lo = fmaxf(t0, t_in), hi = fminf(t1, t_out);
    if (!(hi > lo)) continue;
    pair_over(a_s, b, m2, dens_norm, lo, hi, p);
    f(p, g - first);
  }
}

__device__ __forceinline__ float safe_inv(float v) {
  const float eps = 1e-12f;
  return 1.0f / (fabsf(v) > eps ? v : (v >= 0.0f ? eps : -eps));
}

// ray ∩ cell box ∩ [0, tmax] as [t_lo, t_hi] (empty where !(t_hi > t_lo)),
// the box recomputed from the cell id in the float32 steps of
// gridtrace.py:176-198.
__device__ __forceinline__ void cell_clip(const GridGeom& g, int cell,
                                          const Ray& r, float tmax,
                                          float& t_lo, float& t_hi) {
  const int iz = cell % g.sz;
  const int iy = (cell / g.sz) % g.sy;
  const int ix = cell / (g.sy * g.sz);
  const float ix_f[3] = {static_cast<float>(ix), static_cast<float>(iy),
                         static_cast<float>(iz)};
  const float o[3] = {r.ox, r.oy, r.oz}, d[3] = {r.dx, r.dy, r.dz};
  t_lo = -BIG;
  t_hi = BIG;
  for (int ax = 0; ax < 3; ++ax) {
    const float inv = safe_inv(d[ax]);
    const float b0 = g.lo[ax] + ix_f[ax] * g.cell[ax];
    const float ta = (b0 - o[ax]) * inv;
    const float tb = ta + g.cell[ax] * inv;
    t_lo = fmaxf(t_lo, fminf(ta, tb));
    t_hi = fminf(t_hi, fmaxf(ta, tb));
  }
  t_lo = fmaxf(t_lo, 0.0f);
  t_hi = fminf(t_hi, tmax);
}

// Rows a K6 thread pre-tests before it computes any pair of them: their
// loads go out together, so a walk waits on one round trip for them.
constexpr int K6_UNROLL = 2;

// K6 for one slot: the optical depth of the cell's entries [first, first
// + count) over ray ∩ cell box ∩ [0, tmax], behind the pre-test.  The
// pairs and their sum are those of a plain walk of every entry (tau +=
// pref * (erf_hi - erf_lo), which the compiler contracts to one FMA), in
// entry order, so the pre-test, which passes every pair that interval()
// finds ok, changes no bit.
__device__ __forceinline__ float cell_span_tau(
    const float4* __restrict__ tab, int first, int count,
    const GridGeom& g, int cell, const Ray& r, float tmax) {
  float t_lo, t_hi;
  cell_clip(g, cell, r, tmax, t_lo, t_hi);
  float tau = 0.0f;
  if (!(t_hi > t_lo)) return tau;
  const int end = first + count;
  for (int e0 = first; e0 < end; e0 += K6_UNROLL) {
    bool pass[K6_UNROLL];
#pragma unroll
    for (int u = 0; u < K6_UNROLL; ++u)
      pass[u] = may_cross(tab, min(e0 + u, end - 1), r) && e0 + u < end;
#pragma unroll
    for (int u = 0; u < K6_UNROLL; ++u) {
      float a_s, b, t0, t1, m2, dens_norm;
      Pair p;
      if (!pass[u] || !interval(tab, e0 + u, r, a_s, b, t0, t1, m2,
                                dens_norm, p.albedo))
        continue;
      const float lo = fmaxf(t0, t_lo), hi = fminf(t1, t_hi);
      if (!(hi > lo)) continue;
      pair_over(a_s, b, m2, dens_norm, lo, hi, p);
      tau += p.tau_i;
    }
  }
  return tau;
}

// K7 for one scattered ray (gridtrace.py:295-413): over its critical
// cell's entries clipped to the DDA interval [t_in, t_out], the cell's tau
// and bracket, solver_iters Newton + Illinois steps toward
// tgt = min(resid, 0.999999 tau_cell), the erfinv finisher (always on),
// and the mixture albedo at the root.  The first pass lists the offsets
// (from first) of the entries the ray crosses; the later passes walk the
// list, in the same order and with the same arithmetic as a walk of the
// whole cell, or the whole cell where the list overflowed.
__device__ __forceinline__ void cell_solve(const float4* __restrict__ tab,
                                           int first, int count,
                                           const Ray& r, float t_in,
                                           float t_out, float resid,
                                           int solver_iters, float& t_sc,
                                           float& albedo) {
  uint16_t hits[MAX_HITS];
  int n_ok = 0;
  float tau_cell = 0.0f, t_lo = BIG, t_hi = 0.0f;
  for_each_listed_pair(tab, first, nullptr, count, true, r, t_in, t_out,
                       [&](const Pair& p, int j) {
                         tau_cell += p.tau_i;
                         t_lo = fminf(t_lo, p.t0);
                         t_hi = fmaxf(t_hi, p.t1);
                         if (n_ok < MAX_HITS)
                           hits[n_ok] = static_cast<uint16_t>(j);
                         ++n_ok;
                       });
  // the later passes: the listed entries, or the whole cell if the list
  // overflowed
  const auto each = [&](auto&& f) {
    const auto g = [&](const Pair& p, int) { f(p); };
    if (n_ok > MAX_HITS)
      for_each_listed_pair(tab, first, nullptr, count, false, r, t_in,
                           t_out, g);
    else
      for_each_listed_pair(tab, first, hits, n_ok, false, r, t_in, t_out,
                           g);
  };
  const float tgt = fminf(resid, tau_cell * 0.999999f);
  t_lo = fminf(t_lo, t_out);
  t_hi = fmaxf(t_hi, t_lo);

  float lo = t_lo, hi = t_hi, flo = -tgt;
  float fhi = fmaxf(tau_cell - tgt, 1e-12f);
  float t = 0.5f * (t_lo + t_hi);
  for (int it = 0; it < solver_iters; ++it) {
    float tau = 0.0f, sig = 0.0f;
    each([&](const Pair& p) { tau_sig_at(p, t, tau, sig); });
    illinois_update(lo, hi, flo, fhi, t, tau - tgt, sig);
  }
  t = fminf(fmaxf(t, t_lo), t_hi);

  Finisher f;
  each([&](const Pair& p) { f.add(p, t); });
  float t_a;
  if (f.root(tgt, t_a)) t = t_a;
  t = fminf(fmaxf(t, t_lo), t_hi);

  float s_sum = 0.0f, sa_sum = 0.0f;
  each([&](const Pair& p) { albedo_at(p, t, s_sum, sa_sum); });
  t_sc = t;
  albedo = mixture_albedo(s_sum, sa_sum);
}

}  // namespace gvr
