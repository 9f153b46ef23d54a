// One fused path-tracing bounce for one ray: the device functions shared by
// the bounce kernel (K2) and the megakernel (K1).  Its pair math, pre-test,
// Newton step, finisher and albedo are device functions that the grid
// kernels (grid.cuh, K6/K7) and the big-N kernels (big.cuh, K4/K5) share.
// bounce_core, the whole bounce, runs only in K2 (kernels.cu
// bounce_kernel), which the step wavefront launches once an iteration over
// its live lanes (integrators/multiscatter.py wavefront_pixels_step, under
// RenderConfig(wavefront='step')); K1 runs sweep_pairs, solve_bounce and
// tau_nee in its own loop.
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
// the Newton loop; a GPU thread cannot.  Here one thread owns one ray.  Its
// first pass (sweep_pairs) runs over all N rows: a division-free pre-test
// (may_cross) rejects most rows before interval() pays its two divisions and
// sqrtf, and the pairs the ray crosses are kept in the block's shared memory
// (HitSlots): the first PAIR_CACHE of them whole, the rows of the next ones
// up to MAX_HITS.  The Newton, finisher and albedo passes read the cached
// pairs back and recompute only the listed rest; a ray with more than
// MAX_HITS crossed pairs walks all N rows in those passes.  The cached
// floats are the ones a recompute gives, so caching changes no result.  The
// table is read through the read-only data cache (64 B per Gaussian, 16 KB
// at N = 250): in the sweeps every thread of a warp reads the same row.
#pragma once

#include "common.cuh"

namespace gvr {

constexpr int MAX_HITS = 32;      // crossed pairs a ray's passes walk by list
constexpr int PAIR_CACHE = 2;     // of them kept whole in shared memory
constexpr int PAIR_FIELDS = 9;    // floats of a Pair
constexpr unsigned FULL_WARP = 0xffffffffu;

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

// A division-free pre-test of the pair (g, ray): false only where the
// ray's line misses the Gaussian's R_CUT ellipsoid by a margin.  With
// w = o - mu, a = d'Ad, bh = w'Ad and c = w'Aw, the closest approach is
// m2 = c - bh^2 / a, so the line crosses only where a c - bh^2 < R^2 a.
// PRE_REL (a c + bh^2) covers the float32 rounding of this form and of
// interval(): on camera rays, rays from inside the medium and far rays of
// three scenes, the ok pairs of interval() reached at most 8e-8 (a c +
// bh^2) beyond R^2 a (CPU, float32).  So every pair that interval() finds
// ok passes, and goes through it unchanged.
constexpr float PRE_REL = 1e-5f;

__device__ __forceinline__ bool may_cross(const float4* __restrict__ tab,
                                          int g, const Ray& r) {
  const float4 c0 = __ldg(tab + 4 * g);      // ic00 ic11 ic22 ic01
  const float4 c1 = __ldg(tab + 4 * g + 1);  // ic02 ic12 qx qy
  const float4 c3 = __ldg(tab + 4 * g + 3);  // valid mx my mz
  const float wx = r.ox - c3.y, wy = r.oy - c3.z, wz = r.oz - c3.w;
  const float ax = c0.x * r.dx + c0.w * r.dy + c1.x * r.dz;
  const float ay = c0.w * r.dx + c0.y * r.dy + c1.y * r.dz;
  const float az = c1.x * r.dx + c1.y * r.dy + c0.z * r.dz;
  const float a = r.dx * ax + r.dy * ay + r.dz * az;
  const float bh = wx * ax + wy * ay + wz * az;
  const float c = wx * (c0.x * wx + c0.w * wy + c1.x * wz) +
                  wy * (c0.w * wx + c0.y * wy + c1.y * wz) +
                  wz * (c1.x * wx + c1.y * wy + c0.z * wz);
  const float ac = a * c, b2 = bh * bh;
  return ac - b2 - R_CUT * R_CUT * a <= PRE_REL * (ac + b2);
}

// The pair's quantities over [lo, hi] (an ok pair, lo < hi): erf_lo is
// taken at lo, so a caller that clips the interval (the grid kernels)
// gets the clipped pair.  Returns erf_hi - erf_lo, of which tau_i is pref
// times.
__device__ __forceinline__ float pair_over(float a_s, float b, float m2,
                                           float dens_norm, float lo,
                                           float hi, Pair& p) {
  p.sa = sqrtf(a_s);
  p.zoff = b * (0.5f / p.sa);
  p.peak = dens_norm * expf(-0.5f * m2);
  p.pref = p.peak * sqrtf(PI_F / (2.0f * a_s));
  p.erf_lo = erff((p.sa * lo + p.zoff) * SQRT_HALF);
  const float d_erf = erff((p.sa * hi + p.zoff) * SQRT_HALF) - p.erf_lo;
  p.tau_i = p.pref * d_erf;
  p.t0 = lo;
  p.t1 = hi;
  return d_erf;
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

// One thread's crossed pairs in its block's shared memory: pair k <
// PAIR_CACHE whole (field f at pairs[(k * PAIR_FIELDS + f) * stride]), the
// row of pair j in [PAIR_CACHE, MAX_HITS) at rows[(j - PAIR_CACHE) *
// stride].  Consecutive threads hold consecutive words, so a warp's reads
// and writes fall on distinct banks.
struct HitSlots {
  float* pairs;
  uint16_t* rows;
  int stride;

  __device__ __forceinline__ void put(int k, const Pair& p) const {
    float* q = pairs + k * PAIR_FIELDS * stride;
    const float v[PAIR_FIELDS] = {p.sa, p.zoff, p.peak, p.pref, p.erf_lo,
                                  p.tau_i, p.t0, p.t1, p.albedo};
#pragma unroll
    for (int f = 0; f < PAIR_FIELDS; ++f) q[f * stride] = v[f];
  }

  __device__ __forceinline__ Pair get(int k) const {
    const float* q = pairs + k * PAIR_FIELDS * stride;
    return {q[0], q[stride], q[2 * stride], q[3 * stride], q[4 * stride],
            q[5 * stride], q[6 * stride], q[7 * stride], q[8 * stride]};
  }

  __device__ __forceinline__ int row(int j) const {
    return rows[(j - PAIR_CACHE) * stride];
  }

  __device__ __forceinline__ void set_row(int j, int g) const {
    rows[(j - PAIR_CACHE) * stride] = static_cast<uint16_t>(g);
  }
};

// The shared memory behind a block's HitSlots.
template <int kThreads>
struct HitStore {
  float pairs[PAIR_CACHE * PAIR_FIELDS * kThreads];
  uint16_t rows[(MAX_HITS - PAIR_CACHE) * kThreads];

  __device__ __forceinline__ HitSlots slots(int tid) {
    return {pairs + tid, rows + tid, kThreads};
  }
};

// The first pass over all rows: the ray's total optical depth, the bracket
// [t_lo, t_hi] of its crossed pairs, their count, and the pairs in slots.
struct Sweep {
  float tau_tot, t_lo, t_hi;
  int n_ok;
};

__device__ __forceinline__ Sweep sweep_pairs(const float4* __restrict__ tab,
                                             int np, const Ray& r,
                                             const HitSlots& s) {
  Sweep w = {0.0f, BIG, 0.0f, 0};
  for (int g = 0; g < np; ++g) {
    float a_s, b, t0, t1, m2, dens_norm;
    Pair p;
    if (!may_cross(tab, g, r) ||
        !interval(tab, g, r, a_s, b, t0, t1, m2, dens_norm, p.albedo))
      continue;
    const float d_erf = pair_over(a_s, b, m2, dens_norm, t0, t1, p);
    // tau_tot + pref * d_erf in one rounding: the contraction the compiler
    // picks where the product has no other use, written out so that
    // keeping the pair (a second use) leaves tau_tot's bits as they are
    w.tau_tot = fmaf(p.pref, d_erf, w.tau_tot);
    w.t_lo = fminf(w.t_lo, p.t0);
    w.t_hi = fmaxf(w.t_hi, p.t1);
    if (w.n_ok < PAIR_CACHE)
      s.put(w.n_ok, p);
    else if (w.n_ok < MAX_HITS)
      s.set_row(w.n_ok, g);
    ++w.n_ok;
  }
  w.t_lo = fminf(w.t_lo, w.t_hi);
  return w;
}

// Calls f(pair) for every ok pair of the ray in row order: the cached and
// the listed pairs, or, when the ray crossed more than MAX_HITS, every row
// that make_pair finds ok.
template <class F>
__device__ __forceinline__ void for_each_hit(const float4* __restrict__ tab,
                                             int np, const Ray& r,
                                             const HitSlots& s, int n_ok,
                                             F&& f) {
  if (n_ok > MAX_HITS) {
    for (int g = 0; g < np; ++g) {
      Pair p;
      if (make_pair(tab, g, r, p)) f(p);
    }
    return;
  }
  const int cached = min(n_ok, PAIR_CACHE);
  for (int k = 0; k < cached; ++k) f(s.get(k));
  for (int j = PAIR_CACHE; j < n_ok; ++j) {
    Pair p;
    if (make_pair(tab, s.row(j), r, p)) f(p);
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

// tau_nee's pair loop for row g (the shadow ray's segment [0, tmax]),
// added to tau.
__device__ __forceinline__ void tau_nee_row(const float4* __restrict__ tab,
                                            int g, const Ray& r, float tmax,
                                            float& tau) {
  float a_s, b, t0, t1, m2, dens_norm, albedo;
  if (!may_cross(tab, g, r) ||
      !interval(tab, g, r, a_s, b, t0, t1, m2, dens_norm, albedo))
    return;
  const float hi = fminf(t1, tmax);
  if (!(hi > t0)) return;
  const float sa = sqrtf(a_s);
  const float zoff = b * (0.5f / sa);
  const float pref = dens_norm * expf(-0.5f * m2) *
                     sqrtf(PI_F / (2.0f * a_s));
  tau += pref * (erff((sa * hi + zoff) * SQRT_HALF) -
                 erff((sa * t0 + zoff) * SQRT_HALF));
}

// Optical depth along (p, w) up to tmax over all rows (_tau_nee).
__device__ __forceinline__ float tau_nee(const float4* __restrict__ tab,
                                         int np, const Ray& r, float tmax) {
  float tau = 0.0f;
  for (int g = 0; g < np; ++g) tau_nee_row(tab, g, r, tmax, tau);
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

// After the sweep: the scatter test, then the root (Newton + Illinois and
// the optional finisher) and the mixture albedo at it.  kAlways: solve
// every ray (the bounce kernel reports t_sc and albedo for all); without
// it (the megakernel) a ray that does not scatter stops after the test,
// with t_sc and albedo 0, which the megakernel never reads.
template <bool kAlways>
__device__ __forceinline__ BounceOut solve_bounce(
    const float4* __restrict__ tab, int np, const Ray& r, const Sweep& w,
    float u_tau, int solver_iters, bool finisher, const HitSlots& s) {
  BounceOut out;
  out.tau_tot = w.tau_tot;
  const float target = -logf(fmaxf(1.0f - u_tau, 1e-12f));
  out.scattered = w.tau_tot > target;
  out.fin = false;
  out.t_sc = 0.0f;
  out.albedo = 0.0f;
  out.li[0] = out.li[1] = out.li[2] = 0.0f;
  if (!kAlways && !out.scattered) return out;
  const float tgt = fminf(target, w.tau_tot * 0.999999f);

  // --- bracketed Newton + Illinois on the clipped-interval tau.  With no
  // ok pair the TPU kernel's iteration stays at t = 0; skip it. ---
  float t_sc = 0.0f;
  if (w.n_ok > 0) {
    float lo = w.t_lo, hi = w.t_hi, flo = -tgt;
    float fhi = fmaxf(w.tau_tot - tgt, 1e-12f);
    float t = 0.5f * (w.t_lo + w.t_hi);
    for (int it = 0; it < solver_iters; ++it) {
      float tau = 0.0f, sig = 0.0f;
      for_each_hit(tab, np, r, s, w.n_ok,
                   [&](const Pair& p) { tau_sig_at(p, t, tau, sig); });
      illinois_update(lo, hi, flo, fhi, t, tau - tgt, sig);
    }
    t_sc = fminf(fmaxf(t, w.t_lo), w.t_hi);
  }

  // --- analytic erfinv finisher (_finisher_root) ---
  if (finisher && w.n_ok > 0) {
    Finisher f;
    for_each_hit(tab, np, r, s, w.n_ok,
                 [&](const Pair& p) { f.add(p, t_sc); });
    float t_a;
    out.fin = f.root(tgt, t_a);
    if (out.fin) t_sc = t_a;
  }
  out.t_sc = t_sc;

  // --- mixture albedo at the scatter point (gmm.h:128-143) ---
  float s_sum = 0.0f, sa_sum = 0.0f;
  for_each_hit(tab, np, r, s, w.n_ok,
               [&](const Pair& p) { albedo_at(p, t_sc, s_sum, sa_sum); });
  out.albedo = mixture_albedo(s_sum, sa_sum);
  return out;
}

// The whole bounce of the bounce kernel: sweep, solve and albedo for every
// ray, then NEE with its shadow ray's transmittance.
__device__ __forceinline__ BounceOut bounce_core(
    const float4* __restrict__ tab, int np, const Ray& r, float u_tau,
    float u_nee, float u_light, float u_env1, float u_env2,
    const Lights& lights, int solver_iters, bool finisher,
    const HitSlots& s) {
  BounceOut out = solve_bounce<true>(tab, np, r, sweep_pairs(tab, np, r, s),
                                     u_tau, solver_iters, finisher, s);
  const NeeRay n = nee_ray(r, out.t_sc, u_nee, u_light, u_env1, u_env2,
                           lights.rows, lights.n);
  const float tr = expf(-tau_nee(tab, np, n.s, n.tmax));
  for (int c = 0; c < 3; ++c)
    out.li[c] = n.is_env ? tr * (lights.env[c] * FOUR_PI_F)
                         : tr * n.rad[c] * n.inv_d2;
  return out;
}

}  // namespace gvr
