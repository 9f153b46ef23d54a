// Shared constants and small types of the gvr_tpu_torch CUDA kernels.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, and no
// --use_fast_math (kernels/_build.py): the stratum math and the root solve
// rely on IEEE division, sqrtf, expf, erff and erfinvf.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gvr {

constexpr float R_CUT = 3.0f;        // support radius in sigma (gaussian.h:36)
constexpr float BIG = 1e30f;
constexpr float SQRT_HALF = 0.70710678118654752f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr float FOUR_PI_F = 12.5663706143591729539f;

// The packed Gaussian table is [Np, 16] float32, one 64-byte row per
// Gaussian, read as four float4:
//   0-5 icpack (ic00 ic11 ic22 ic01 ic02 ic12), 6-8 q = inv_cov @ mean,
//   9 c0, 10 density * norm, 11 albedo, 12 valid, 13-15 mean.
constexpr int TAB_COLS = 16;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Point lights ([n, 6] rows: position xyz, intensity rgb) and env radiance.
struct Lights {
  const float* __restrict__ rows;
  int n;
  float env[3];
};

}  // namespace gvr
