// One fused path-tracing bounce for one ray: the device function shared by
// the bounce kernel (K2) and the megakernel (K1).  Its pair math, Newton
// step, finisher and albedo are device functions that the grid kernels
// (grid.cuh, K6/K7) share.
//
// Replaces gvr_tpu/kernels/pathtrace.py:272 _bounce_core (with _coeffs :149,
// _interval :195, _tau_nee :229, _finisher_root :254) and mirrors its steps
// in order: quadratic coefficients, the 3-sigma clipped interval, the
// closed-form erf optical depth, the scatter test, solver_iters steps of
// Newton + Illinois, the optional erfinv finisher, the mixture albedo and
// NEE with one shadow-ray optical depth.  CUDA's erff/erfinvf take the
// place of the A&S erf and Giles erfinv that Pallas needed.
//
// Design: the TPU kernel keeps ~10 [N, rays] arrays resident in VMEM across
// the Newton loop; a GPU thread cannot.  Here one thread owns one ray and
// RECOMPUTES the per-pair quantities from the table in every pass, skipping
// pairs whose interval is empty (!ok) early.  The first pass over all N
// records the indices of the ok pairs (at most MAX_HITS; a ray with more
// falls back to scanning all N), so the Newton, finisher and albedo passes
// touch only the Gaussians the ray actually crosses.  The table is read
// through the read-only data cache (64 B per Gaussian, 16 KB at N = 250):
// in the first and the NEE pass every thread of a warp reads the same row.
#pragma once

#include "common.cuh"

namespace gvr {

constexpr int MAX_HITS = 32;

// Per-(Gaussian, ray) quantities of an ok pair (pathtrace.py:290-300).
struct Pair {
  float sa, zoff, peak, pref, erf_lo, tau_i, t0, t1, albedo;
};

__device__ __forceinline__ float bil(float ux, float uy, float uz, float vx,
                                     float vy, float vz, float4 c0,
                                     float4 c1) {
  return ux * vx * c0.x + uy * vy * c0.y + uz * vz * c0.z +
         (ux * vy + uy * vx) * c0.w + (ux * vz + uz * vx) * c1.x +
         (uy * vz + uz * vy) * c1.y;
}

// _coeffs + _interval for row g: returns ok and the geometry of the pair.
__device__ __forceinline__ bool interval(const float4* __restrict__ tab,
                                         int g, const Ray& r, float& a_s,
                                         float& b, float& t0, float& t1,
                                         float& m2, float& dens_norm,
                                         float& albedo) {
  const float4 c0 = __ldg(tab + 4 * g);      // ic00 ic11 ic22 ic01
  const float4 c1 = __ldg(tab + 4 * g + 1);  // ic02 ic12 qx qy
  const float4 c2 = __ldg(tab + 4 * g + 2);  // qz c0 dens_norm albedo
  const float4 c3 = __ldg(tab + 4 * g + 3);  // valid mx my mz
  const float a = bil(r.dx, r.dy, r.dz, r.dx, r.dy, r.dz, c0, c1);
  const float d_q = r.dx * c1.z + r.dy * c1.w + r.dz * c2.x;
  b = 2.0f * (bil(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, c0, c1) - d_q);
  a_s = fmaxf(a, 1e-30f);
  const float t_star = -b / (2.0f * a_s);
  const float vx = r.ox - c3.y + t_star * r.dx;
  const float vy = r.oy - c3.z + t_star * r.dy;
  const float vz = r.oz - c3.w + t_star * r.dz;
  m2 = vx * vx * c0.x + vy * vy * c0.y + vz * vz * c0.z +
       2.0f * (vx * vy * c0.w + vx * vz * c1.x + vy * vz * c1.y);
  m2 = fmaxf(m2, 0.0f);
  const float gap = (R_CUT * R_CUT - m2) / a_s;
  const float half = sqrtf(gap > 0.0f ? gap : 0.0f);
  t1 = t_star + half;
  t0 = fmaxf(t_star - half, 0.0f);
  dens_norm = c2.z;
  albedo = c2.w;
  return gap > 0.0f && t1 >= 0.0f && c3.x > 0.0f;
}

// The pair's quantities over [lo, hi] (an ok pair, lo < hi): erf_lo is
// taken at lo, so a caller that clips the interval (the grid kernels)
// gets the clipped pair.
__device__ __forceinline__ void pair_over(float a_s, float b, float m2,
                                          float dens_norm, float lo,
                                          float hi, Pair& p) {
  p.sa = sqrtf(a_s);
  p.zoff = b * (0.5f / p.sa);
  p.peak = dens_norm * expf(-0.5f * m2);
  p.pref = p.peak * sqrtf(PI_F / (2.0f * a_s));
  p.erf_lo = erff((p.sa * lo + p.zoff) * SQRT_HALF);
  const float erf_hi = erff((p.sa * hi + p.zoff) * SQRT_HALF);
  p.tau_i = p.pref * (erf_hi - p.erf_lo);
  p.t0 = lo;
  p.t1 = hi;
}

__device__ __forceinline__ bool make_pair(const float4* __restrict__ tab,
                                          int g, const Ray& r, Pair& p) {
  float a_s, b, t0, t1, m2, dens_norm;
  if (!interval(tab, g, r, a_s, b, t0, t1, m2, dens_norm, p.albedo))
    return false;
  pair_over(a_s, b, m2, dens_norm, t0, t1, p);
  return true;
}

// Adds the pair's optical depth up to t and its extinction at t: one
// pair's share of a Newton step.
__device__ __forceinline__ void tau_sig_at(const Pair& p, float t,
                                           float& tau, float& sig) {
  const float z = p.sa * t + p.zoff;
  if (t > p.t0)
    tau += t >= p.t1 ? p.tau_i : p.pref * (erff(z * SQRT_HALF) - p.erf_lo);
  if (t >= p.t0 && t <= p.t1) sig += p.peak * expf(-0.5f * z * z);
}

// The analytic erfinv finisher (pathtrace.py:254 _finisher_root): add()
// every ok pair at the iterated root t_sc, then root() gives the
// closed-form root where it is exact (exactly one interval active, the
// erf argument in range, no interval opening or closing in between).
struct Finisher {
  float n_act = 0.0f, tau_done = 0.0f, nxt = BIG, prv = 0.0f;
  float sa1 = 0.0f, zoff1 = 0.0f, pref1 = 0.0f, erflo1 = 0.0f;
  float t0_1 = 0.0f, t1_1 = 0.0f;

  __device__ __forceinline__ void add(const Pair& p, float t_sc) {
    if (t_sc > p.t0 && t_sc < p.t1) {
      n_act += 1.0f;
      sa1 += p.sa;
      zoff1 += p.zoff;
      pref1 += p.pref;
      erflo1 += p.erf_lo;
      t0_1 += p.t0;
      t1_1 += p.t1;
    }
    if (p.t1 <= t_sc) {
      tau_done += p.tau_i;
      prv = fmaxf(prv, p.t1);
    }
    if (p.t0 > t_sc) nxt = fminf(nxt, p.t0);
  }

  __device__ __forceinline__ bool root(float tgt, float& t_a) const {
    const float arg = (tgt - tau_done) / fmaxf(pref1, 1e-30f) + erflo1;
    const float one_eps = 0.999999f;
    t_a = (erfinvf(fminf(fmaxf(arg, -one_eps), one_eps)) / SQRT_HALF -
           zoff1) / fmaxf(sa1, 1e-30f);
    return n_act == 1.0f && arg > -one_eps && arg < one_eps &&
           t_a >= fmaxf(t0_1, prv) && t_a <= fminf(t1_1, nxt);
  }
};

// Adds the pair's extinction and albedo-weighted extinction at t
// (gmm.h:128-143).
__device__ __forceinline__ void albedo_at(const Pair& p, float t,
                                          float& s_sum, float& sa_sum) {
  if (t >= p.t0 && t <= p.t1) {
    const float z = p.sa * t + p.zoff;
    const float rho = p.peak * expf(-0.5f * z * z);
    s_sum += rho;
    sa_sum += rho * p.albedo;
  }
}

__device__ __forceinline__ float mixture_albedo(float s_sum, float sa_sum) {
  return fminf(fmaxf(s_sum > 1e-25f ? sa_sum / s_sum : 0.0f, 0.0f), 1.0f);
}

// Calls f(pair) for every ok pair of the ray: the listed hits, or all rows
// when the ray crossed more than MAX_HITS Gaussians.
template <class F>
__device__ __forceinline__ void for_each_hit(const float4* __restrict__ tab,
                                             int np, const Ray& r,
                                             const uint16_t* hits, int n_ok,
                                             F&& f) {
  const bool listed = n_ok <= MAX_HITS;
  const int count = listed ? n_ok : np;
  for (int j = 0; j < count; ++j) {
    Pair p;
    if (make_pair(tab, listed ? hits[j] : j, r, p)) f(p);
  }
}

// gvr_tpu/ops/solvers.py:63 illinois_update, line for line.
__device__ __forceinline__ void illinois_update(float& lo, float& hi,
                                                float& flo, float& fhi,
                                                float& t, float f,
                                                float sig) {
  const bool neg = f < 0.0f;
  flo = neg ? f : flo * 0.5f;
  fhi = neg ? fhi * 0.5f : f;
  lo = neg ? t : lo;
  hi = neg ? hi : t;
  const float t_n = t - f / fmaxf(sig, 1e-30f);
  const bool good = t_n > lo && t_n < hi && isfinite(t_n);
  const float denom = fhi - flo;
  float t_f = hi - fhi * (hi - lo) / (fabsf(denom) > 1e-30f ? denom : 1e-30f);
  t_f = fminf(fmaxf(t_f, lo), hi);
  t = good ? t_n : t_f;
}

// Optical depth along (p, w) up to tmax over all rows (_tau_nee).
__device__ __forceinline__ float tau_nee(const float4* __restrict__ tab,
                                         int np, const Ray& r, float tmax) {
  float tau = 0.0f;
  for (int g = 0; g < np; ++g) {
    float a_s, b, t0, t1, m2, dens_norm, albedo;
    if (!interval(tab, g, r, a_s, b, t0, t1, m2, dens_norm, albedo))
      continue;
    const float hi = fminf(t1, tmax);
    if (!(hi > t0)) continue;
    const float sa = sqrtf(a_s);
    const float zoff = b * (0.5f / sa);
    const float pref = dens_norm * expf(-0.5f * m2) *
                       sqrtf(PI_F / (2.0f * a_s));
    tau += pref * (erff((sa * hi + zoff) * SQRT_HALF) -
                   erff((sa * t0 + zoff) * SQRT_HALF));
  }
  return tau;
}

// The NEE ray from o + t_sc d (integrator.h:657-683): the env with
// probability 1/(L+1) along a uniform direction, else light
// floor(u_light L) with its radiance and 1/d^2.  Li = exp(-tau(s, tmax)) *
// (4 pi env if is_env else rad / d^2).
struct NeeRay {
  Ray s;
  float tmax;
  bool is_env;
  float rad[3];
  float inv_d2;
};

__device__ __forceinline__ NeeRay nee_ray(const Ray& r, float t_sc,
                                          float u_nee, float u_light,
                                          float u_env1, float u_env2,
                                          const float* __restrict__ rows,
                                          int n_lights) {
  NeeRay n;
  n.s.ox = r.ox + t_sc * r.dx;
  n.s.oy = r.oy + t_sc * r.dy;
  n.s.oz = r.oz + t_sc * r.dz;
  const float theta = TWO_PI_F * u_env1;
  const float cphi = 1.0f - 2.0f * u_env2;
  const float sphi = sqrtf(fmaxf(1.0f - cphi * cphi, 0.0f));
  n.s.dx = sphi * cosf(theta);
  n.s.dy = sphi * sinf(theta);
  n.s.dz = cphi;
  n.is_env = true;
  n.tmax = 1e8f;
  n.rad[0] = n.rad[1] = n.rad[2] = 0.0f;
  n.inv_d2 = 0.0f;
  if (n_lights > 0) {
    n.is_env = u_nee < 1.0f / static_cast<float>(n_lights + 1);
    if (!n.is_env) {
      int l = static_cast<int>(u_light * static_cast<float>(n_lights));
      l = min(max(l, 0), n_lights - 1);
      const float* row = rows + 6 * l;
      const float tox = __ldg(row) - n.s.ox, toy = __ldg(row + 1) - n.s.oy,
                  toz = __ldg(row + 2) - n.s.oz;
      const float dist =
          sqrtf(fmaxf(tox * tox + toy * toy + toz * toz, 1e-24f));
      const float inv_dist = 1.0f / dist;
      n.s.dx = tox * inv_dist;
      n.s.dy = toy * inv_dist;
      n.s.dz = toz * inv_dist;
      n.tmax = dist;
      n.inv_d2 = inv_dist * inv_dist;
      for (int c = 0; c < 3; ++c) n.rad[c] = __ldg(row + 3 + c);
    }
  }
  return n;
}

struct BounceOut {
  float t_sc;
  bool scattered;
  float albedo;
  float li[3];
  float tau_tot;
  bool fin;
};

// kAlways: also compute albedo and NEE for rays that escape (the bounce
// kernel reports them for every ray; the megakernel never reads them).
template <bool kAlways>
__device__ BounceOut bounce_core(const float4* __restrict__ tab, int np,
                                 const Ray& r, float u_tau, float u_nee,
                                 float u_light, float u_env1, float u_env2,
                                 const Lights& lights, int solver_iters,
                                 bool finisher) {
  BounceOut out;
  uint16_t hits[MAX_HITS];
  int n_ok = 0;
  float tau_tot = 0.0f, t_lo = BIG, t_hi = 0.0f;
  for (int g = 0; g < np; ++g) {
    Pair p;
    if (!make_pair(tab, g, r, p)) continue;
    tau_tot += p.tau_i;
    t_lo = fminf(t_lo, p.t0);
    t_hi = fmaxf(t_hi, p.t1);
    if (n_ok < MAX_HITS) hits[n_ok] = static_cast<uint16_t>(g);
    ++n_ok;
  }
  t_lo = fminf(t_lo, t_hi);
  out.tau_tot = tau_tot;
  const float target = -logf(fmaxf(1.0f - u_tau, 1e-12f));
  out.scattered = tau_tot > target;
  out.fin = false;
  out.albedo = 0.0f;
  out.li[0] = out.li[1] = out.li[2] = 0.0f;
  const float tgt = fminf(target, tau_tot * 0.999999f);

  // --- bracketed Newton + Illinois on the clipped-interval tau.  With no
  // ok pair the TPU kernel's iteration stays at t = 0; skip it. ---
  float t_sc = 0.0f;
  if (n_ok > 0) {
    float lo = t_lo, hi = t_hi, flo = -tgt;
    float fhi = fmaxf(tau_tot - tgt, 1e-12f);
    float t = 0.5f * (t_lo + t_hi);
    for (int it = 0; it < solver_iters; ++it) {
      float tau = 0.0f, sig = 0.0f;
      for_each_hit(tab, np, r, hits, n_ok,
                   [&](const Pair& p) { tau_sig_at(p, t, tau, sig); });
      illinois_update(lo, hi, flo, fhi, t, tau - tgt, sig);
    }
    t_sc = fminf(fmaxf(t, t_lo), t_hi);
  }

  // --- analytic erfinv finisher (_finisher_root) ---
  if (finisher && n_ok > 0) {
    Finisher f;
    for_each_hit(tab, np, r, hits, n_ok,
                 [&](const Pair& p) { f.add(p, t_sc); });
    float t_a;
    out.fin = f.root(tgt, t_a);
    if (out.fin) t_sc = t_a;
  }
  out.t_sc = t_sc;
  if (!kAlways && !out.scattered) return out;

  // --- mixture albedo at the scatter point (gmm.h:128-143) ---
  float s_sum = 0.0f, sa_sum = 0.0f;
  for_each_hit(tab, np, r, hits, n_ok,
               [&](const Pair& p) { albedo_at(p, t_sc, s_sum, sa_sum); });
  out.albedo = mixture_albedo(s_sum, sa_sum);

  // --- NEE: the env or one light, and the shadow ray's transmittance ---
  const NeeRay n = nee_ray(r, t_sc, u_nee, u_light, u_env1, u_env2,
                           lights.rows, lights.n);
  const float tr = expf(-tau_nee(tab, np, n.s, n.tmax));
  for (int c = 0; c < 3; ++c)
    out.li[c] = n.is_env ? tr * (lights.env[c] * FOUR_PI_F)
                         : tr * n.rad[c] * n.inv_d2;
  return out;
}

}  // namespace gvr
