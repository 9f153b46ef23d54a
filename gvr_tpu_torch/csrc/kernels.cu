// The CUDA kernels of the multiscatter engines and their C entry points
// (loaded with ctypes by gvr_tpu_torch/kernels/_build.py).  Each entry
// point launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported.
//
//   gvr_uniforms    K3  counter-hash RNG     (gvr_tpu/kernels/rng.py:86)
//   gvr_wave_uniforms   K3 for a wavefront iteration: jitter pair + bounce
//   gvr_bounce      K2  one fused bounce     (gvr_tpu/kernels/pathtrace.py:465)
//   gvr_mega        K1  pooled path loop     (gvr_tpu/kernels/megatrace.py:501)
//   gvr_mega_resident   K1's blocks per SM and the SM count
//   gvr_span_tau    K6  tau per crossing     (gvr_tpu/kernels/gridtrace.py:217)
//   gvr_grid_solve  K7  in-cell solve        (gvr_tpu/kernels/gridtrace.py:425)
//   gvr_big_stage1  K4  box-culled bounce    (gvr_tpu/kernels/pathtrace_big.py:384)
//   gvr_big_nee     K5  box-culled NEE       (gvr_tpu/kernels/pathtrace_big.py:409)

#include "big.cuh"
#include "bounce.cuh"
#include "common.cuh"
#include "grid.cuh"
#include "rng.cuh"

namespace gvr {

__global__ void uniforms_kernel(const int* __restrict__ pid,
                                const int* __restrict__ sample,
                                const int* __restrict__ bounce,
                                uint32_t static_bounce, int count, int n,
                                uint32_t seed_mix, uint32_t seed_raw,
                                float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const uint32_t b = bounce ? static_cast<uint32_t>(bounce[i]) : static_bounce;
  const BounceKey k = bounce_key(
      path_key(static_cast<uint32_t>(pid[i]), static_cast<uint32_t>(sample[i]),
               seed_mix, seed_raw),
      b);
  for (int j = 0; j < n; ++j) out[static_cast<size_t>(j) * count + i] = draw(k, j);
}

// K3 for a wavefront iteration: one thread a lane computes its path key
// once and writes the jitter pair (bounce tag JITTER_TAG) to planes 0-1 and
// n draws of its bounce to planes 2 .. n + 1.  out [2 + n, count].
__global__ void wave_uniforms_kernel(const int* __restrict__ pid,
                                     const int* __restrict__ sample,
                                     const int* __restrict__ bounce,
                                     int count, int n, uint32_t seed_mix,
                                     uint32_t seed_raw,
                                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const PathKey pk =
      path_key(static_cast<uint32_t>(pid[i]),
               static_cast<uint32_t>(sample[i]), seed_mix, seed_raw);
  const BounceKey kj = bounce_key(pk, JITTER_TAG);
  out[i] = draw(kj, 0);
  out[count + i] = draw(kj, 1);
  const BounceKey kb = bounce_key(pk, static_cast<uint32_t>(bounce[i]));
  for (int j = 0; j < n; ++j)
    out[static_cast<size_t>(j + 2) * count + i] = draw(kb, j);
}

__device__ __forceinline__ Lights make_lights(const float* rows, int n,
                                              const float* env) {
  Lights l;
  l.rows = rows;
  l.n = n;
  for (int c = 0; c < 3; ++c) l.env[c] = __ldg(env + c);
  return l;
}

constexpr int BOUNCE_BLOCK = 128;  // threads of a bounce-kernel block

// out [8, b]: t_sc, scattered, albedo, Li rgb, tau_tot, fin.
__global__ void __launch_bounds__(BOUNCE_BLOCK)
    bounce_kernel(const float4* __restrict__ tab, int np,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ xi, int b,
                  const float* __restrict__ light_rows, int n_lights,
                  const float* __restrict__ env, int solver_iters,
                  bool finisher, float* __restrict__ out) {
  __shared__ HitStore<BOUNCE_BLOCK> store;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const Lights lights = make_lights(light_rows, n_lights, env);
  const Ray r = {o[3 * i], o[3 * i + 1], o[3 * i + 2],
                 d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  const float* x = xi + 5 * i;
  const BounceOut res =
      bounce_core(tab, np, r, x[0], x[1], x[2], x[3], x[4], lights,
                  solver_iters, finisher, store.slots(threadIdx.x));
  out[i] = res.t_sc;
  out[b + i] = res.scattered ? 1.0f : 0.0f;
  out[2 * b + i] = res.albedo;
  out[3 * b + i] = res.li[0];
  out[4 * b + i] = res.li[1];
  out[5 * b + i] = res.li[2];
  out[6 * b + i] = res.tau_tot;
  out[7 * b + i] = res.fin ? 1.0f : 0.0f;
}

struct MegaParams {
  int w, h, spp, n_strat;
  uint32_t seed_mix, seed_raw;
  int solver_iters;
  bool finisher;
  int min_scatter;
  float rr_cap;
  int rr_tail_after;
  float rr_cap_tail;
  int max_bounces;
  bool pinhole;
  float nee_w;  // (L + 1) / (4 pi): NEE weight of one light or the env
  int pix;      // pixels of one block's pool, at most MEGA_MAX_PIX
};

constexpr int MEGA_BLOCK = 128;  // threads of a megakernel block
constexpr int MEGA_WARPS = MEGA_BLOCK / 32;
constexpr int MEGA_MAX_PIX = 128;  // most pixels a block's pool holds
// Path subtotals a block holds at once: a pool of more paths runs in rounds
// of this many (pixel-major) slots.
constexpr int MEGA_ROUND = 512;
// A warp's queue, a ring: up to 31 entries left from the last drain and 32
// new.
constexpr int NEE_QCAP = 64;
// The float fields of a queued entry: origin, direction, tmax, weight.  An
// escape entry (a path's last term) has tmax kEscape and no ray.
enum NeeField { kQo = 0, kQd = 3, kQtmax = 6, kQw = 7, kQFields = 10 };
constexpr float kEscape = -1.0f;
// Phases of the instrumented megakernel: the extension sweep, the solve
// (Newton, finisher, albedo), the NEE sweep, and the rest (slot claims,
// camera rays, uniforms, queue pushes, Russian roulette, the loop, the
// rounds' folds).  The counters are [kMegaPhases][3] int64: clock64()
// cycles summed over warps, warp-steps (rows for a sweep, one a solve or a
// loop iteration), and active lanes summed over those steps.
enum MegaPhase { kPhSweep = 0, kPhSolve, kPhNee, kPhOther, kMegaPhases };

// Stratified camera ray for (pixel x, y; sample s) from the 16-float camera
// vector (position, right, up, view_dir, focal): the same math as
// megatrace.make_ray, with integer strata and true division.
__device__ __forceinline__ Ray camera_ray(const float* cam,
                                          const MegaParams& P, int x, int y,
                                          int s, float j0, float j1) {
  const int sx = s % P.n_strat;
  const int sy = (s / P.n_strat) % P.n_strat;
  const float n = static_cast<float>(P.n_strat);
  const float u01 =
      (static_cast<float>(x) + (static_cast<float>(sx) + j0) / n) /
      static_cast<float>(P.w);
  const float v01 =
      (static_cast<float>(y) + (static_cast<float>(sy) + j1) / n) /
      static_cast<float>(P.h);
  float u, v;
  if (P.pinhole) {
    u = 1.0f - u01 * 2.0f;  // x-flip (camera.h:47)
    v = v01 * 2.0f - 1.0f;
  } else {
    u = u01 * 2.0f - 1.0f;
    v = 1.0f - v01 * 2.0f;  // y-flip (camera.h:67)
  }
  Ray r;
  r.ox = cam[0] + u * cam[3] + v * cam[6];
  r.oy = cam[1] + u * cam[4] + v * cam[7];
  r.oz = cam[2] + u * cam[5] + v * cam[8];
  if (P.pinhole) {
    const float ddx = cam[0] + cam[12] * cam[9] - r.ox;
    const float ddy = cam[1] + cam[12] * cam[10] - r.oy;
    const float ddz = cam[2] + cam[12] * cam[11] - r.oz;
    const float nrm = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
    r.dx = ddx / nrm;
    r.dy = ddy / nrm;
    r.dz = ddz / nrm;
  } else {
    r.dx = cam[9];
    r.dy = cam[10];
    r.dz = cam[11];
  }
  return r;
}

// A warp's drain of `count` (1..32) queued entries, the oldest first: lane
// k takes entry first + k of the ring.  A shadow ray's lane sweeps its
// optical depth over all rows (the warp's sweeping lanes the same rows)
// and its term is weight * exp(-tau); an escape entry's term is its weight.
// Each term is added into its path's subtotal sub[.][slot], the lanes that
// hold one slot one after another in lane order, which is queue order, so
// a subtotal takes a path's terms in the order it pushed them.  Every lane
// calls it; returns the lanes that swept.
__device__ __forceinline__ int nee_drain(const float* q, const int* q_slot,
                                         int first, int count,
                                         const float4* __restrict__ tab,
                                         int np,
                                         float (*sub)[MEGA_ROUND]) {
  const int lane = threadIdx.x & 31;
  const bool has = lane < count;
  const int e = (first + lane) & (NEE_QCAP - 1);
  Ray s = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  float tmax = 0.0f, term[3] = {0.0f, 0.0f, 0.0f};
  int slot = 0;
  if (has) {
    s = {q[(kQo + 0) * NEE_QCAP + e], q[(kQo + 1) * NEE_QCAP + e],
         q[(kQo + 2) * NEE_QCAP + e], q[(kQd + 0) * NEE_QCAP + e],
         q[(kQd + 1) * NEE_QCAP + e], q[(kQd + 2) * NEE_QCAP + e]};
    tmax = q[kQtmax * NEE_QCAP + e];
    for (int c = 0; c < 3; ++c) term[c] = q[(kQw + c) * NEE_QCAP + e];
    slot = q_slot[e];
  }
  __syncwarp();  // every entry read before a later push reuses its place
  const bool sweeps = has && tmax != kEscape;
  if (sweeps) {
    const float tr = expf(-tau_nee(tab, np, s, tmax));
    for (int c = 0; c < 3; ++c) term[c] *= tr;
  }
  // lanes of one slot add in lane order: rank k adds in pass k
  const unsigned peers = __match_any_sync(FULL_WARP, has ? slot : -1 - lane);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int passes = __reduce_max_sync(FULL_WARP, has ? rank : 0);
  for (int k = 0; k <= passes; ++k) {
    if (has && rank == k)
      for (int c = 0; c < 3; ++c)
        sub[c][slot] += term[c];
    __syncwarp();
  }
  return __popc(__ballot_sync(FULL_WARP, sweeps));
}

// One block owns P.pix consecutive ids of the chunk, and their (pixel,
// sample) slots form its pool (slot g = pixel g / spp, sample g % spp); the
// launcher picks P.pix so that the chunk makes enough blocks to fill the
// card several times over, and the hardware's block scheduler balances
// them.  The pool runs in rounds of MEGA_ROUND slots (one round unless spp
// > MEGA_ROUND or a pool was forced larger).  A warp's lanes without a live
// path claim the round's next slots together (one shared atomicAdd a
// warp), trace their paths bounce by bounce, and claim again; the warp
// leaves the round when no lane holds a path and the round is empty.  A
// bounce sweeps the table for the extension ray (every live lane the same
// rows); only a ray that scatters solves for its root and albedo, from the
// pairs its sweep kept in shared memory (HitSlots).
//
// Each path owns one subtotal sub[.][g - round start], zeroed when it is
// claimed, and every term of its radiance reaches it through the warp's
// FIFO queue, in order: a shadow ray (throughput x albedo x nee_w x (4 pi
// env or rad / d^2), with the ray) for each scatter, then the escape term
// (throughput x env) if the path escapes.  The lane does not sweep its
// shadow ray: whenever the queue holds 32 entries, and once more when the
// round is done, the warp drains the 32 oldest (or the rest) with every
// lane active; an escape entry's lane only adds its term.  (Adding an
// escape at once where none of its path's entries waits measured 2-4 %
// faster, but which route a path takes depends on the race, so the two
// routes would have to round alike; PERF.md §6.)  At the round's end the
// block folds each pixel's subtotals into out_rad in sample order, so a
// pixel's sum is ((s_0 + s_1) + s_2) + ... whichever warp traced which
// path, and the image does not depend on the pools, the chunk or the card.
// out_rad [b, 3] radiance sums over the spp samples; out_count [b] bounce
// evaluations (integer sums); prof (kProf only) the phase counters.  Six
// blocks an SM (34.8 KB of shared memory each, the registers capped at 80);
// at 30.2 KB, six measured faster than five at 96 registers with a 4-pair
// cache, and than seven with 72 (PERF.md).
template <bool kProf>
__global__ void __launch_bounds__(MEGA_BLOCK, 6)
    mega_kernel(const float* __restrict__ cam_g,
                const float4* __restrict__ tab, int np,
                const int* __restrict__ ids, int b,
                const float* __restrict__ light_rows, int n_lights,
                const float* __restrict__ env, MegaParams P,
                float* __restrict__ out_rad, int* __restrict__ out_count,
                long long* __restrict__ prof) {
  __shared__ int next_slot;
  __shared__ float sub[3][MEGA_ROUND];
  __shared__ int cnt[MEGA_MAX_PIX];
  __shared__ HitStore<MEGA_BLOCK> store;
  __shared__ float nee_q[MEGA_WARPS][kQFields * NEE_QCAP];
  __shared__ int nee_slot[MEGA_WARPS][NEE_QCAP];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int base = blockIdx.x * P.pix;
  const int npix = min(P.pix, b - base);
  const int pool = npix * P.spp;
  for (int k = tid; k < MEGA_MAX_PIX; k += MEGA_BLOCK) cnt[k] = 0;

  float cam[13];
  for (int k = 0; k < 13; ++k) cam[k] = __ldg(cam_g + k);
  const Lights lights = make_lights(light_rows, n_lights, env);
  const HitSlots slots = store.slots(tid);
  float* q = nee_q[warp];
  int* q_slot = nee_slot[warp];

  long long ph[kMegaPhases][3] = {};
  long long t_mark = kProf ? clock64() : 0;
  // kProf: the time since the last mark goes to phase k, with `lanes`
  // active over `steps` warp-steps.
  const auto mark = [&](int k, int lanes, int steps) {
    if (kProf) {
      __syncwarp();
      const long long now = clock64();
      ph[k][0] += now - t_mark;
      ph[k][1] += steps;
      ph[k][2] += static_cast<long long>(lanes) * steps;
      t_mark = now;
    }
  };

  // the warp's queue holds its entries [head, tail), counted from the
  // kernel's start; entry e sits at e mod NEE_QCAP
  int head = 0, tail = 0;
  for (int r0 = 0; r0 < pool; r0 += MEGA_ROUND) {
    const int r1 = min(r0 + MEGA_ROUND, pool);
    if (tid == 0) next_slot = r0;
    __syncthreads();  // also: the last round's fold is done with sub
    bool alive = false, exhausted = false;
    int g = 0, bounce = 0, evals = 0;  // g: the path's pool slot
    PathKey key = {0u, 0u};
    Ray r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    float thr[3] = {1.0f, 1.0f, 1.0f};
    while (true) {
      // --- lanes without a path claim the round's next slots ---
      if (!exhausted) {
        const unsigned need = __ballot_sync(FULL_WARP, !alive);
        if (need) {
          const int leader = __ffs(need) - 1;
          int first = 0;
          if (lane == leader) first = atomicAdd(&next_slot, __popc(need));
          first = __shfl_sync(FULL_WARP, first, leader);
          exhausted = first + __popc(need) >= r1;
          const int claim = first + __popc(need & below);
          if (!alive && claim < r1) {
            g = claim;
            const int pix = g / P.spp;
            const int s = g - pix * P.spp;
            const int pid = ids[base + pix];
            key = path_key(static_cast<uint32_t>(pid),
                           static_cast<uint32_t>(s), P.seed_mix, P.seed_raw);
            float jit[2];
            uniforms<2>(key, JITTER_TAG, jit);
            r = camera_ray(cam, P, pid % P.w, pid / P.w, s, jit[0], jit[1]);
            for (int c = 0; c < 3; ++c) {
              thr[c] = 1.0f;
              sub[c][g - r0] = 0.0f;
            }
            bounce = 0;
            evals = 0;
            alive = true;
          }
        }
      }
      const unsigned live = __ballot_sync(FULL_WARP, alive);
      if (!live) break;
      float xi[9];
      if (alive) uniforms<9>(key, static_cast<uint32_t>(bounce), xi);
      mark(kPhOther, __popc(live), 1);

      // --- the extension ray: sweep, then the solve if it scatters ---
      Sweep w = {0.0f, BIG, 0.0f, 0};
      if (alive) w = sweep_pairs(tab, np, r, slots);
      mark(kPhSweep, __popc(live), np);
      BounceOut res;
      res.scattered = false;
      if (alive)
        res = solve_bounce<false>(tab, np, r, w, xi[0], P.solver_iters,
                                  P.finisher, slots);
      const unsigned scat = __ballot_sync(FULL_WARP, res.scattered);
      mark(kPhSolve, __popc(scat), 1);

      // --- queue the shadow ray of a lane that scatters, or the escape
      // term of one whose path escapes ---
      if (alive) {
        const int e = (tail + __popc(live & below)) & (NEE_QCAP - 1);
        if (res.scattered) {
          const NeeRay n = nee_ray(r, res.t_sc, xi[1], xi[2], xi[3], xi[4],
                                   lights.rows, lights.n);
          const float o3[3] = {n.s.ox, n.s.oy, n.s.oz};
          const float d3[3] = {n.s.dx, n.s.dy, n.s.dz};
          const float wgt = res.albedo * P.nee_w;
          for (int c = 0; c < 3; ++c) {
            q[(kQo + c) * NEE_QCAP + e] = o3[c];
            q[(kQd + c) * NEE_QCAP + e] = d3[c];
            q[(kQw + c) * NEE_QCAP + e] =
                thr[c] * wgt * (n.is_env ? lights.env[c] * FOUR_PI_F
                                         : n.rad[c] * n.inv_d2);
          }
          q[kQtmax * NEE_QCAP + e] = n.tmax;
        } else {
          for (int c = 0; c < 3; ++c)
            q[(kQw + c) * NEE_QCAP + e] = thr[c] * lights.env[c];
          q[kQtmax * NEE_QCAP + e] = kEscape;
        }
        q_slot[e] = g - r0;
      }
      tail += __popc(live);
      __syncwarp();  // the pushed entries visible to the whole warp
      mark(kPhOther, __popc(live), 1);
      if (tail - head >= 32) {
        const int swept = nee_drain(q, q_slot, head, 32, tab, np, sub);
        head += 32;
        mark(kPhNee, swept, np);
      }

      // --- escape, or Russian roulette and the next direction ---
      if (alive) {
        ++evals;
        if (!res.scattered) {
          alive = false;
        } else {
          float tn[3];
          for (int c = 0; c < 3; ++c) tn[c] = thr[c] * res.albedo;
          // Russian roulette (integrator.h:688-695) with the tail cap
          const bool do_rr = bounce >= P.min_scatter;
          const float cap =
              bounce >= P.rr_tail_after ? P.rr_cap_tail : P.rr_cap;
          const float rr = fminf(fmaxf(fmaxf(tn[0], tn[1]), tn[2]), cap);
          const bool killed = do_rr && xi[5] > rr;
          if (do_rr && !killed)
            for (int c = 0; c < 3; ++c) tn[c] = tn[c] / fmaxf(rr, 1e-12f);
          alive = !killed && bounce + 1 < P.max_bounces;
          if (alive) {
            // isotropic phase: new direction from xi[6:8]
            const float theta = TWO_PI_F * xi[6];
            const float cphi = 1.0f - 2.0f * xi[7];
            const float sphi = sqrtf(fmaxf(1.0f - cphi * cphi, 0.0f));
            r.ox = r.ox + res.t_sc * r.dx;
            r.oy = r.oy + res.t_sc * r.dy;
            r.oz = r.oz + res.t_sc * r.dz;
            r.dx = sphi * cosf(theta);
            r.dy = sphi * sinf(theta);
            r.dz = cphi;
            for (int c = 0; c < 3; ++c) thr[c] = tn[c];
          }
        }
        ++bounce;
        if (!alive) atomicAdd(&cnt[g / P.spp], evals);
      }
      mark(kPhOther, __popc(live), 1);
    }
    if (tail > head) {
      const int swept = nee_drain(q, q_slot, head, tail - head, tab, np, sub);
      mark(kPhNee, swept, np);
      head = tail;
    }
    __syncthreads();
    // --- fold the round: each pixel's subtotals in sample order, after
    // its sum so far when an earlier round held its first samples ---
    const int p_hi = (r1 - 1) / P.spp;
    for (int p = r0 / P.spp + tid; p <= p_hi; p += MEGA_BLOCK) {
      const int g0 = max(p * P.spp, r0), g1 = min((p + 1) * P.spp, r1);
      float* out = out_rad + 3 * (base + p);
      float acc[3] = {0.0f, 0.0f, 0.0f};
      if (g0 > p * P.spp)
        for (int c = 0; c < 3; ++c) acc[c] = out[c];
      for (int k = g0 - r0; k < g1 - r0; ++k)
        for (int c = 0; c < 3; ++c) acc[c] += sub[c][k];
      for (int c = 0; c < 3; ++c) out[c] = acc[c];
    }
    mark(kPhOther, 0, 0);
  }
  if (kProf && lane == 0)
    for (int k = 0; k < kMegaPhases; ++k)
      for (int j = 0; j < 3; ++j)
        atomicAdd(reinterpret_cast<unsigned long long*>(prof + 3 * k + j),
                  static_cast<unsigned long long>(ph[k][j]));
  __syncthreads();
  if (tid < npix) out_count[base + tid] = cnt[tid];
}

// K6: a block takes K6_BLOCK consecutive (ray, crossing) items of cells
// [n_rays, c_max], item i being crossing k = i / n_rays of ray i % n_rays,
// so neighbouring threads take neighbouring rays, which mostly share a
// cell.  An item whose cell is -1 or empty writes 0; the block lists the
// others in item order in shared memory, and its first threads walk them,
// one a thread (cell_span_tau), so the lanes of a walking warp hold no
// empty slot (about half of a wavefront iteration's).  out [n_rays, c_max].
constexpr int K6_BLOCK = 128;

__global__ void __launch_bounds__(K6_BLOCK)
    span_tau_kernel(const float4* __restrict__ tab,
                    const int* __restrict__ cell_first,
                    const int* __restrict__ cell_count, GridGeom geom,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmax,
                    const int* __restrict__ cells, int n_rays, int c_max,
                    float* __restrict__ out) {
  __shared__ int live_item[K6_BLOCK];
  __shared__ int warp_live[K6_BLOCK / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * K6_BLOCK;
  const auto slot_of = [&](int64_t i) {
    const int k = static_cast<int>(i / n_rays);
    const int ray = static_cast<int>(i - static_cast<int64_t>(k) * n_rays);
    return static_cast<int64_t>(ray) * c_max + k;
  };
  bool live = false;
  if (base + threadIdx.x < static_cast<int64_t>(n_rays) * c_max) {
    const int64_t slot = slot_of(base + threadIdx.x);
    const int cell = cells[slot];
    live = cell >= 0 && cell_count[cell] > 0;
    if (!live) out[slot] = 0.0f;
  }
  const unsigned vote = __ballot_sync(FULL_WARP, live);
  if (lane == 0) warp_live[warp] = __popc(vote);
  __syncthreads();
  int at = __popc(vote & ((1u << lane) - 1u)), n_live = 0;
  for (int w = 0; w < K6_BLOCK / 32; ++w) {
    at += w < warp ? warp_live[w] : 0;
    n_live += warp_live[w];
  }
  if (live) live_item[at] = threadIdx.x;
  __syncthreads();
  if (threadIdx.x < n_live) {
    const int64_t slot = slot_of(base + live_item[threadIdx.x]);
    const int ray = static_cast<int>(slot / c_max);
    const int cell = cells[slot];
    const Ray r = {o[3 * ray], o[3 * ray + 1], o[3 * ray + 2],
                   d[3 * ray], d[3 * ray + 1], d[3 * ray + 2]};
    out[slot] = cell_span_tau(tab, cell_first[cell], cell_count[cell], geom,
                              cell, r, tmax[ray]);
  }
}

// K7: one thread per ray; rays without a live cell (cell -1 or an empty
// cell) give (0, 0).  out [2, n]: t_sc, albedo.
__global__ void grid_solve_kernel(const float4* __restrict__ tab,
                                  const int* __restrict__ cell_first,
                                  const int* __restrict__ cell_count,
                                  const float* __restrict__ o,
                                  const float* __restrict__ d,
                                  const float* __restrict__ t_in,
                                  const float* __restrict__ t_out,
                                  const float* __restrict__ resid,
                                  const int* __restrict__ cells, int n,
                                  int solver_iters, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int cell = cells[i];
  float t_sc = 0.0f, albedo = 0.0f;
  if (cell >= 0) {
    const int count = cell_count[cell];
    if (count > 0) {
      const Ray r = {o[3 * i], o[3 * i + 1], o[3 * i + 2],
                     d[3 * i], d[3 * i + 1], d[3 * i + 2]};
      cell_solve(tab, cell_first[cell], count, r, t_in[i], t_out[i],
                 resid[i], solver_iters, t_sc, albedo);
    }
  }
  out[i] = t_sc;
  out[n + i] = albedo;
}

}  // namespace gvr

extern "C" {

const char* gvr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gvr_uniforms(const int* pid, const int* sample, const int* bounce,
                 uint32_t static_bounce, int count, int n, uint32_t seed_mix,
                 uint32_t seed_raw, float* out, void* stream) {
  if (count > 0) {
    const int threads = 256;
    gvr::uniforms_kernel<<<(count + threads - 1) / threads, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        pid, sample, bounce, static_bounce, count, n, seed_mix, seed_raw, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int gvr_wave_uniforms(const int* pid, const int* sample, const int* bounce,
                      int count, int n, uint32_t seed_mix, uint32_t seed_raw,
                      float* out, void* stream) {
  if (count > 0) {
    const int threads = 256;
    gvr::wave_uniforms_kernel<<<(count + threads - 1) / threads, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        pid, sample, bounce, count, n, seed_mix, seed_raw, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int gvr_bounce(const float* tab, int np, const float* o, const float* d,
               const float* xi, int b, const float* light_rows, int n_lights,
               const float* env, int solver_iters, int finisher, float* out,
               void* stream) {
  if (b > 0) {
    const int threads = gvr::BOUNCE_BLOCK;
    gvr::bounce_kernel<<<(b + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(tab), np, o, d, xi, b, light_rows,
        n_lights, env, solver_iters, finisher != 0, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int gvr_mega(const float* cam, const float* tab, int np, const int* ids,
             int b, const float* light_rows, int n_lights, const float* env,
             float nee_w, int w, int h, int spp, int n_strat,
             uint32_t seed_mix, uint32_t seed_raw, int solver_iters,
             int finisher, int min_scatter, float rr_cap, int rr_tail_after,
             float rr_cap_tail, int max_bounces, int pinhole, int pix,
             float* out_rad, int* out_count, long long* prof, void* stream) {
  if (pix < 1 || pix > gvr::MEGA_MAX_PIX)
    return static_cast<int>(cudaErrorInvalidValue);
  gvr::MegaParams P;
  P.w = w;
  P.h = h;
  P.spp = spp;
  P.n_strat = n_strat;
  P.seed_mix = seed_mix;
  P.seed_raw = seed_raw;
  P.solver_iters = solver_iters;
  P.finisher = finisher != 0;
  P.min_scatter = min_scatter;
  P.rr_cap = rr_cap;
  P.rr_tail_after = rr_tail_after;
  P.rr_cap_tail = rr_cap_tail;
  P.max_bounces = max_bounces;
  P.pinhole = pinhole != 0;
  P.nee_w = nee_w;
  P.pix = pix;
  if (b > 0) {
    const int blocks = (b + pix - 1) / pix;
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* t4 = reinterpret_cast<const float4*>(tab);
    const auto kernel =
        prof ? gvr::mega_kernel<true> : gvr::mega_kernel<false>;
    kernel<<<blocks, gvr::MEGA_BLOCK, 0, s>>>(cam, t4, np, ids, b,
                                               light_rows, n_lights, env, P,
                                               out_rad, out_count, prof);
  }
  return static_cast<int>(cudaGetLastError());
}

// The megakernel's residency on the current device: blocks of it that one
// SM holds at once, and the SM count.
int gvr_mega_resident(int* blocks_per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, gvr::mega_kernel<false>, gvr::MEGA_BLOCK, 0);
  return static_cast<int>(err);
}

int gvr_span_tau(const float* tab, const int* cell_first,
                 const int* cell_count, int sx, int sy, int sz, float lox,
                 float loy, float loz, float clx, float cly, float clz,
                 const float* o, const float* d, const float* tmax,
                 const int* cells, int n_rays, int c_max, float* out,
                 void* stream) {
  const gvr::GridGeom geom = {sx, sy, sz, {lox, loy, loz}, {clx, cly, clz}};
  const int64_t total = static_cast<int64_t>(n_rays) * c_max;
  if (total > 0) {
    const int threads = gvr::K6_BLOCK;
    gvr::span_tau_kernel<<<static_cast<unsigned>((total + threads - 1) /
                                                  threads),
                           threads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(tab), cell_first, cell_count, geom,
        o, d, tmax, cells, n_rays, c_max, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int gvr_grid_solve(const float* tab, const int* cell_first,
                   const int* cell_count, const float* o, const float* d,
                   const float* t_in, const float* t_out, const float* resid,
                   const int* cells, int n, int solver_iters, float* out,
                   void* stream) {
  if (n > 0) {
    const int threads = 128;
    gvr::grid_solve_kernel<<<(n + threads - 1) / threads, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(tab), cell_first, cell_count, o, d,
        t_in, t_out, resid, cells, n, solver_iters, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int gvr_big_stage1(const float* tab, int np, const float* boxes,
                   const float* o, const float* d, const float* xi, int b,
                   const float* light_rows, int n_lights, int solver_iters,
                   float* out, int* admitted, void* stream) {
  if (b > 0) {
    gvr::big_stage1_kernel<<<(b + gvr::BIG_BLOCK - 1) / gvr::BIG_BLOCK,
                             gvr::BIG_BLOCK, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(tab), np,
        reinterpret_cast<const float4*>(boxes), o, d, xi, b, light_rows,
        n_lights, solver_iters, out, admitted);
  }
  return static_cast<int>(cudaGetLastError());
}

int gvr_big_nee(const float* tab, int np, const float* boxes,
                const float* stage1, int b, const float* env, float* out,
                int* admitted, void* stream) {
  if (b > 0) {
    gvr::big_nee_kernel<<<(b + gvr::BIG_BLOCK - 1) / gvr::BIG_BLOCK,
                          gvr::BIG_BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(tab), np,
        reinterpret_cast<const float4*>(boxes), stage1, b, env, out,
        admitted);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
