// The big-N dense engine's bounce, in two kernels: K4 (chunk-culled free
// flight, albedo and NEE set-up) and K5 (the NEE shadow ray's
// transmittance and Li).
//
// Replace gvr_tpu/kernels/pathtrace_big.py:374 _big_call, its stage 1
// (pallas_call :384, body _make_kernel :98 with _chunk_quants_dir :329) and
// its NEE stage (pallas_call :409, body _make_nee_kernel :283).  The table
// is pack_table's [Np, 16] rows (Np a multiple of 256, at most 96 chunks of
// 256 Morton-sorted Gaussians), read as four float4 a row through the
// read-only cache, as K2 reads it.
//
// What bounds them on this card: arithmetic and the special-function
// units, not memory.  K4's first pass is N x B pair tests (about 95 flops
// each, plus two erff and an expf for each pair a ray crosses), and each of
// its solver_iters + 1 Newton and albedo passes repeats the pair test over
// the chunks its block hit, with erff/expf for the crossed pairs.  K5 is
// one pass of N x B pair tests.  The table (64 B a Gaussian, 640 KB at 10k)
// stays in L2 and every thread of a warp reads the same row at once.
//
// Design.  The TPU kernel compacts the chunks a 64- or 128-ray block hits
// into nine [blk, cap*256] VMEM arrays and runs the Newton passes over
// them; a 64-ray block of that would need ~6 MB, far beyond a block's
// shared memory.  Here one thread owns one ray and recomputes each pair
// from its row in every pass (as K2 and K7 do).  The first pass walks all
// chunks; after each, the block votes (__syncthreads_or) and, where any ray
// of the block crossed a Gaussian of the chunk, appends the chunk to a
// shared list: the TPU's any_hit + compaction.  The Newton passes and the
// albedo walk only the listed chunks.  That skip is exact: every pair of
// an unlisted chunk is !ok for every ray of the block and adds 0.  The
// list holds every chunk (plan() refuses scenes above 96), so the TPU
// kernel's overflow branch (tau_over, output column 7) is dead there and
// has no counterpart here.  Blocks are 64 rays of consecutive lanes, half
// of a 16x8 screen tile in the wavefront's tile order, so the block's rays
// are coherent and hit few chunks.
//
// K5 needs no vote: a thread tests every pair once anyway, and a pair that
// is !ok skips its erff (the TPU kernel's lanes could not).  It is the
// shadow-ray pass of K2 (tau_nee) over the stored NEE rays.
//
// K4's Newton step is its own, not illinois_update: the falsi point is
// clipped to a 5 % inset of the bracket and a Newton point is taken
// without a finite test (pathtrace_big.py:174-198); it has no erfinv
// finisher.
#pragma once

#include "bounce.cuh"
#include "common.cuh"

namespace gvr {

constexpr int BIG_G = 256;          // Gaussians a chunk
constexpr int BIG_MAX_CHUNKS = 96;  // plan()'s ceiling
constexpr int BIG_BLOCK = 64;       // rays a block of K4

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

// Calls f(pair) for every ok pair of the ray in the block's listed chunks.
template <class F>
__device__ __forceinline__ void for_each_listed(const float4* __restrict__ tab,
                                                const int* list, int n_list,
                                                const Ray& r, F&& f) {
  for (int k = 0; k < n_list; ++k) {
    const int base = list[k] * BIG_G;
    for (int j = 0; j < BIG_G; ++j) {
      Pair p;
      if (make_pair(tab, base + j, r, p)) f(p);
    }
  }
}

// K4: one thread per ray.  xi [b, 5] uniforms (target, NEE choice, light
// index, env direction x2); out [16, b] (BigRow).
__global__ void __launch_bounds__(BIG_BLOCK)
    big_stage1_kernel(const float4* __restrict__ tab, int np,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ xi, int b,
                      const float* __restrict__ light_rows, int n_lights,
                      int solver_iters, float* __restrict__ out) {
  __shared__ int list[BIG_MAX_CHUNKS];
  const int i = blockIdx.x * BIG_BLOCK + threadIdx.x;
  const bool active = i < b;
  Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  if (active)
    r = {o[3 * i], o[3 * i + 1], o[3 * i + 2],
         d[3 * i], d[3 * i + 1], d[3 * i + 2]};

  // --- first pass over every chunk, and the block's vote on each ---
  float tau_tot = 0.0f, t_lo = BIG, t_hi = 0.0f;
  int n_list = 0;
  for (int c = 0; c < np / BIG_G; ++c) {
    bool hit = false;
    if (active) {
      for (int j = 0; j < BIG_G; ++j) {
        Pair p;
        if (!make_pair(tab, c * BIG_G + j, r, p)) continue;
        tau_tot += p.tau_i;
        t_lo = fminf(t_lo, p.t0);
        t_hi = fmaxf(t_hi, p.t1);
        hit = true;
      }
    }
    if (__syncthreads_or(hit)) {
      if (threadIdx.x == 0) list[n_list] = c;
      ++n_list;
    }
  }
  __syncthreads();
  if (!active) return;
  t_lo = fminf(t_lo, t_hi);

  const float* x = xi + 5 * i;
  const float target = -logf(fmaxf(1.0f - x[0], 1e-12f));
  const bool scattered = tau_tot > target;
  const float tgt = fminf(target, tau_tot * 0.999999f);

  // --- solver_iters Newton + inset-Illinois steps over the listed chunks
  float lo = t_lo, hi = t_hi, flo = -tgt;
  float fhi = fmaxf(tau_tot - tgt, 1e-12f);
  float t = 0.5f * (t_lo + t_hi);
  for (int it = 0; it < solver_iters; ++it) {
    float tau = 0.0f, sig = 0.0f;
    for_each_listed(tab, list, n_list, r,
                    [&](const Pair& p) { tau_sig_at(p, t, tau, sig); });
    illinois_update_inset(lo, hi, flo, fhi, t, tau - tgt, sig);
  }
  const float t_sc = fminf(fmaxf(t, t_lo), t_hi);

  // --- mixture albedo at the scatter point (gmm.h:128-143) ---
  float s_sum = 0.0f, sa_sum = 0.0f;
  for_each_listed(tab, list, n_list, r, [&](const Pair& p) {
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

// K5: one thread per NEE ray of stage 1's rows; out [3, b] Li.
__global__ void big_nee_kernel(const float4* __restrict__ tab, int np,
                               const float* __restrict__ s1, int b,
                               const float* __restrict__ env,
                               float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const auto at = [&](int k) { return s1[static_cast<size_t>(k) * b + i]; };
  const Ray s = {at(kPx), at(kPx + 1), at(kPx + 2),
                 at(kWx), at(kWx + 1), at(kWx + 2)};
  const float tr = expf(-tau_nee(tab, np, s, at(kTmax)));
  const bool is_env = at(kIsEnv) > 0.5f;
  for (int c = 0; c < 3; ++c)
    out[static_cast<size_t>(c) * b + i] =
        is_env ? tr * (__ldg(env + c) * FOUR_PI_F)
               : tr * at(kRad + c) * at(kInvD2);
}

}  // namespace gvr
