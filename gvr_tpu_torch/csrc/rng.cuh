// Counter-hash RNG, bit-exact with gvr_tpu/ops/sampling.path_uniforms and
// gvr_tpu/kernels/rng.py:_uniform_cols: a splitmix32 chain keyed by
// (pixel, sample, bounce, seed), each draw the 23 high bits of a 32-bit
// hash times 2^-23.  The (pixel, sample) half of the chain is computed once
// per path (PathKey); each bounce adds two mixes plus one per draw.
#pragma once

#include "common.cuh"

namespace gvr {

constexpr uint32_t JITTER_TAG = 0x7FFF0000u;  // bounce tag of the jitter draw

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x += 0x9E3779B9u;
  x = (x ^ (x >> 16)) * 0x21F0AAADu;
  x = (x ^ (x >> 15)) * 0x735A2D97u;
  return x ^ (x >> 15);
}

__device__ __forceinline__ float to_unit(uint32_t x) {
  return static_cast<float>(x >> 9) * 1.1920928955078125e-7f;  // 2^-23
}

struct PathKey {
  uint32_t h1, h2;
};

// seed_mix = mix32(seed) and seed_raw = seed, both computed on the host.
__device__ __forceinline__ PathKey path_key(uint32_t pid, uint32_t s,
                                            uint32_t seed_mix,
                                            uint32_t seed_raw) {
  PathKey k;
  k.h1 = mix32(pid * 0x85EBCA6Bu ^ (s * 0xC2B2AE35u) ^ seed_mix);
  k.h2 = mix32((pid ^ 0xDEADBEEFu) * 0x9E3779B1u + s * 0x6C078965u +
               seed_raw);
  return k;
}

struct BounceKey {
  uint32_t b1, b2;
};

__device__ __forceinline__ BounceKey bounce_key(PathKey k, uint32_t b) {
  return {mix32(k.h1 ^ (b * 0x27D4EB2Fu)), mix32(k.h2 + b * 0x41C64E6Du)};
}

// Draw i (0-based) of a bounce's stream.
__device__ __forceinline__ float draw(BounceKey k, int i) {
  return to_unit(
      mix32((k.b1 ^ (0x165667B1u * static_cast<uint32_t>(i + 1))) + k.b2));
}

template <int N>
__device__ __forceinline__ void uniforms(PathKey k, uint32_t b, float* out) {
  const BounceKey bk = bounce_key(k, b);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = draw(bk, i);
}

}  // namespace gvr
