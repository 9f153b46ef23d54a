// K8, the dense wavefront's per-lane glue (integrators/multiscatter.py
// _wavefront and _big_wavefront; wrappers and plain versions in
// kernels/wavefront.py).
//
// It replaces no TPU kernel.  The JAX package leaves this glue to XLA,
// which fuses it into a few programs; in eager PyTorch it was about 115
// small launches an iteration (regeneration, strata, camera, gathers,
// scatters, escape and NEE sums, roulette, the next direction), which the
// host took longer to enqueue than the card took to trace the bounce, so
// the card waited for K4/K5's inputs.  K8 is two launches around the
// bounce:
//
//   wave_pre_kernel   one thread a live lane (a live list's entry):
//                     regeneration, the lane's (pixel, sample) key and
//                     K3's draws inline (rng.cuh), the camera ray of a new
//                     sample (path.cuh camera_ray), the state written back
//                     and the bounce's inputs gathered: o, d [n, 3], the
//                     draws 0-4 lane-major [n, 5] (K2's and K4's layout),
//                     the draws 5-8 in planes [4, stride]; and the lane's
//                     place in that batch (slot).
//   wave_post_kernel  after the bounce, a live lane reads its bounce's
//                     results at its slot and adds its escape and NEE
//                     terms, plays Russian roulette, moves to the scatter
//                     point and turns (path.cuh).  Host mode: one thread a
//                     lane of the chunk; every lane counts its bounce and
//                     writes whether it has a path to trace, the mask of
//                     the host's next live read (torch.nonzero).  List
//                     mode: one thread a live list's entry; each lane with
//                     a path to trace appends itself to the next live list
//                     and its count, both on the card.
//
// Live lists.  The step and XLA loops read the live lanes on the host
// (host mode: a list of n entries, n known to the host).  The big-N loop
// keeps them on the card (list mode): a list of capacity B with its count
// in device memory, which pre, K4, K5 and post read; a launch's grid is
// sized by an upper bound the host read earlier (the live set only
// shrinks), and threads at or past the count return at once.  Post
// appends with a block-aggregated atomic (a ballot a warp, one atomicAdd a
// block), so a block's lanes stay neighbours, in the order they had; the
// lists' order changes no lane's result, as no lane reads another's
// state.  A
// lane outside the list has no path left (!alive, sample >= spp) and
// nothing of it is read again, so list mode leaves it as it is.
//
// Bound: bytes of lane state, each read and written once.  Pre reads 45 B
// a live lane (21 B for one that starts a sample, which reads no ray) and
// writes 65 B (the gathered ray and draws, slot, flag), 44 B more for a
// new sample (ray, throughput, sample, bounce).  Post reads 9 B a lane and
// 85 B more a live one (slot, ray, throughput, sum, results, 3 draws) and
// writes 5 B a lane, 13 B more a live one and 36 B more a survivor (list
// mode: the live lanes alone, and 8 B a survivor's list entry).  At
// 65,536 lanes that is ~8 MB a launch, ~2.5 us at 3.35 TB/s; the integer
// hash (~200 integer ops a lane) and the camera ray are far below the
// card's rates.  Design: one thread a lane over structure-of-arrays
// state, so a warp's accesses to a field are contiguous where its lanes
// are neighbours; the draws are computed, not read, and only for live
// lanes; nothing is staged, as no lane reads another's state.
//
// Every float operation is EagerMath's (path.cuh): the eager loop's
// roundings in its order, so the wavefront's image is the eager loop's,
// bit for bit (tests/test_torch_cuda.py holds it so).
#pragma once

#include "bounce.cuh"
#include "path.cuh"
#include "rng.cuh"

namespace gvr {

constexpr int WAVE_BLOCK = 256;  // threads of a K8 block

// A chunk's lanes in device memory (kernels/wavefront.py Lanes): float
// [B, 3] rows and [B] lanes.
struct WaveLanes {
  float* o;
  float* d;
  float* thr;
  float* acc;
  bool* alive;
  int* sample;  // samples started
  int* bounce;
  int* slot;    // a live lane's place in the bounce's batch
};

// The bounce's results of live lane k: t_sc, albedo [n], the scatter flag
// (scattered [n], or, where that is null, scattered_f [n] > 0.5: K4's row)
// and Li at li[k * li_lane + c * li_chan].
struct WaveResults {
  const float* t_sc;
  const bool* scattered;
  const float* scattered_f;
  const float* albedo;
  const float* li;
  int li_lane, li_chan;

  __device__ __forceinline__ bool scattered_at(int k) const {
    return scattered ? scattered[k] : scattered_f[k] > 0.5f;
  }
};

// What the post-bounce step needs besides the lane: the environment, the
// NEE weight w_ne, 1 / (4 pi) as PyTorch rounds it, roulette and the path
// length.
struct WaveParams {
  const float* env;  // [3]
  float inv_4pi;
  float w_ne;
  Roulette rr;
  int max_bounces;
  int spp;
};

// One live lane after its bounce (the eager loop from the escape term to
// the new throughput): adds the escape term thr * env or the NEE term
// thr * (albedo / (4 pi) * w_ne) * Li into acc, then, on a scatter,
// roulette on thr * albedo; a lane that lives on moves to o + t_sc d, turns
// to iso_dir(u_dir0, u_dir1) and keeps the new throughput.  Returns
// whether it lives on.  The grid's wavefront (gridscatter) plays the same
// roulette (its plain loop calls kernels/wavefront.py roulette) and turn,
// so a glue kernel of its own can take them from path.cuh as K8 does.
__device__ __forceinline__ bool wave_post_lane(
    float o[3], float d[3], float thr[3], float acc[3], int bounce,
    float t_sc, bool scattered, float albedo, const float li[3],
    const WaveParams& P, float u_rr, float u_dir0, float u_dir1) {
  using M = EagerMath;
  for (int c = 0; c < 3; ++c)
    acc[c] = M::add(acc[c],
                    scattered ? 0.0f : M::mul(thr[c], __ldg(P.env + c)));
  float pos[3];
  for (int c = 0; c < 3; ++c) pos[c] = M::add(o[c], M::mul(t_sc, d[c]));
  const float wgt = M::mul(M::mul(albedo, P.inv_4pi), P.w_ne);
  for (int c = 0; c < 3; ++c)
    acc[c] = M::add(acc[c],
                    scattered ? M::mul(M::mul(thr[c], wgt), li[c]) : 0.0f);
  float tn[3];
  for (int c = 0; c < 3; ++c) tn[c] = M::mul(thr[c], albedo);
  const bool killed = roulette(tn, bounce, P.rr, u_rr);
  const bool alive = scattered && !killed && bounce + 1 < P.max_bounces;
  if (alive) {
    iso_dir<M>(u_dir0, u_dir1, d[0], d[1], d[2]);
    for (int c = 0; c < 3; ++c) {
      o[c] = pos[c];
      thr[c] = tn[c];
    }
  }
  return alive;
}

// K8 pre-bounce, thread k for lane live[k] of n (of *count where count
// is not null: a live list on the card, n an upper bound that sizes the
// grid): a lane whose path ended with samples left starts its next one
// (bounce 0, a new camera ray, throughput 1); then its draws of (pixel,
// current sample, bounce).  xr's planes are stride apart.
__global__ void __launch_bounds__(WAVE_BLOCK)
    wave_pre_kernel(const long long* __restrict__ live, int n,
                    const int* __restrict__ count, int stride,
                    const int* __restrict__ ids,
                    const float* __restrict__ cam_g, Film film, int spp,
                    uint32_t seed_mix, uint32_t seed_raw, WaveLanes L,
                    float* __restrict__ o_c, float* __restrict__ d_c,
                    float* __restrict__ xi5, float* __restrict__ xr) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (count ? min(*count, n) : n)) return;
  const int i = static_cast<int>(live[k]);
  const int pid = ids[i];
  int sample = L.sample[i], bounce = L.bounce[i];
  const bool alive = L.alive[i];
  const bool regen = !alive && sample < spp;
  if (regen) {
    bounce = 0;
    ++sample;
  }
  const int s_cur = max(sample, 1) - 1;
  const PathKey key = path_key(static_cast<uint32_t>(pid),
                               static_cast<uint32_t>(s_cur), seed_mix,
                               seed_raw);
  float o[3], d[3];
  if (regen) {
    float jit[2], cam[13];
    uniforms<2>(key, JITTER_TAG, jit);
    for (int c = 0; c < 13; ++c) cam[c] = __ldg(cam_g + c);
    const Ray r = camera_ray<EagerMath>(cam, film, pid % film.w,
                                        pid / film.w, s_cur, jit[0], jit[1]);
    o[0] = r.ox;
    o[1] = r.oy;
    o[2] = r.oz;
    d[0] = r.dx;
    d[1] = r.dy;
    d[2] = r.dz;
    for (int c = 0; c < 3; ++c) {
      L.o[3 * i + c] = o[c];
      L.d[3 * i + c] = d[c];
      L.thr[3 * i + c] = 1.0f;
    }
    L.sample[i] = sample;
    L.bounce[i] = 0;
  } else {
    for (int c = 0; c < 3; ++c) {
      o[c] = L.o[3 * i + c];
      d[c] = L.d[3 * i + c];
    }
  }
  L.alive[i] = alive || regen;
  L.slot[i] = k;
  float xi[9];
  uniforms<9>(key, static_cast<uint32_t>(bounce), xi);
  for (int c = 0; c < 3; ++c) {
    o_c[3 * k + c] = o[c];
    d_c[3 * k + c] = d[c];
  }
  for (int j = 0; j < 5; ++j) xi5[5 * k + j] = xi[j];
  for (int j = 0; j < 4; ++j)
    xr[static_cast<size_t>(j) * stride + k] = xi[5 + j];
}

// K8 post-bounce for live lane i, whose results are at slot k: takes
// them and its draws 5-7 from xr [4, stride], and writes back the lane's
// state.  Returns whether the lane has a path to trace in the next
// iteration.
__device__ __forceinline__ bool wave_post_live(int i, int k,
                                               const WaveLanes& L,
                                               const WaveResults& R,
                                               const float* __restrict__ xr,
                                               int stride,
                                               const WaveParams& P) {
  const int bounce = L.bounce[i];
  float o[3], d[3], thr[3], acc[3], li[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = L.o[3 * i + c];
    d[c] = L.d[3 * i + c];
    thr[c] = L.thr[3 * i + c];
    acc[c] = L.acc[3 * i + c];
    li[c] = R.li[static_cast<size_t>(k) * R.li_lane +
                 static_cast<size_t>(c) * R.li_chan];
  }
  const bool alive = wave_post_lane(
      o, d, thr, acc, bounce, R.t_sc[k], R.scattered_at(k), R.albedo[k], li,
      P, xr[k], xr[static_cast<size_t>(stride) + k],
      xr[2 * static_cast<size_t>(stride) + k]);
  for (int c = 0; c < 3; ++c) L.acc[3 * i + c] = acc[c];
  if (alive)
    for (int c = 0; c < 3; ++c) {
      L.o[3 * i + c] = o[c];
      L.d[3 * i + c] = d[c];
      L.thr[3 * i + c] = thr[c];
    }
  L.alive[i] = alive;
  L.bounce[i] = bounce + 1;
  return alive || L.sample[i] < P.spp;
}

// K8 post-bounce, host mode: thread i for lane i of b.  A live lane (alive
// after the pre-bounce step) takes its results at slot[i]; every lane
// counts the bounce, and want[i] says whether lane i has a path to trace
// in the next iteration.
__global__ void __launch_bounds__(WAVE_BLOCK)
    wave_post_kernel(int b, WaveLanes L, WaveResults R,
                     const float* __restrict__ xr, int stride, WaveParams P,
                     bool* __restrict__ want) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  if (L.alive[i]) {
    want[i] = wave_post_live(i, L.slot[i], L, R, xr, stride, P);
  } else {
    L.bounce[i] += 1;
    want[i] = L.sample[i] < P.spp;
  }
}

// K8 post-bounce, list mode: thread k for entry k of the live list live
// [*count] (n >= *count sizes the grid), its results at slot k; every lane
// of the list is alive after the pre-bounce step.  Each lane with a path
// to trace appends itself to next, counted in *next_count (0 before the
// launch): a block's lanes take consecutive entries, in their order, by
// one atomicAdd.
__global__ void __launch_bounds__(WAVE_BLOCK)
    wave_post_list_kernel(const long long* __restrict__ live, int n,
                          const int* __restrict__ count, WaveLanes L,
                          WaveResults R, const float* __restrict__ xr,
                          int stride, WaveParams P,
                          long long* __restrict__ next,
                          int* __restrict__ next_count) {
  __shared__ int warp_base[WAVE_BLOCK / 32 + 1];
  const int m = min(*count, n);
  if (static_cast<int>(blockIdx.x * blockDim.x) >= m) return;  // the block
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  int i = 0;
  bool want = false;
  if (k < m) {
    i = static_cast<int>(live[k]);
    want = wave_post_live(i, k, L, R, xr, stride, P);
  }
  const uint32_t ballot = __ballot_sync(FULL_WARP, want);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < WAVE_BLOCK / 32; ++w) {
      const int c = warp_base[w];
      warp_base[w] = sum;
      sum += c;
    }
    warp_base[WAVE_BLOCK / 32] = sum > 0 ? atomicAdd(next_count, sum) : 0;
  }
  __syncthreads();
  if (want)
    next[warp_base[WAVE_BLOCK / 32] + warp_base[warp] +
         __popc(ballot & ((1u << lane) - 1u))] = i;
}

}  // namespace gvr
