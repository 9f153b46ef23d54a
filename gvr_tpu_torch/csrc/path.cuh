// Per-path math that the megakernel (K1) and the wavefront glue (K8,
// wave.cuh) share: the stratified camera ray, the isotropic direction and
// Russian roulette, each written once.
//
// The two callers round differently, so the camera ray and the direction
// take their float arithmetic as a policy:
//
//   FusedMath   K1's: plain C++ operators, which the compiler contracts
//               (a * b + c into one fma) and true division by an integer.
//   EagerMath   K8's: every operation rounded on its own, as PyTorch's
//               elementwise CUDA ops round the eager loop that K8 replaces
//               (integrators/multiscatter.py _wavefront, kernels/wavefront.py
//               wave_pre_reference): __fmul_rn / __fadd_rn / __fsub_rn;
//               a division by a host integer as a product with its float32
//               reciprocal (PyTorch's div by a CPU scalar); the vector norm
//               in the order of torch.linalg.vector_norm's reduction over a
//               3-wide row.  Its image is the eager loop's, bit for bit.
//
// Russian roulette has no product-sum and no division by a host scalar,
// so both round it alike and it takes no policy.
#pragma once

#include "common.cuh"

namespace gvr {

struct FusedMath {
  static __device__ __forceinline__ float mul(float a, float b) {
    return a * b;
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return a + b;
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return a - b;
  }
  // a / n for an integer-valued n
  static __device__ __forceinline__ float over(float a, float n) {
    return a / n;
  }
  static __device__ __forceinline__ float norm3(float x, float y, float z) {
    return sqrtf(x * x + y * y + z * z);
  }
};

struct EagerMath {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  // tensor / int on the card: a times float32(1 / n)
  static __device__ __forceinline__ float over(float a, float n) {
    return __fmul_rn(a, __frcp_rn(n));
  }
  // vector_norm(dim=-1) of a row (x, y, z): two threads reduce it, one
  // adding x^2 and z^2, then the other's y^2
  static __device__ __forceinline__ float norm3(float x, float y, float z) {
    return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(z, z)),
                           __fmul_rn(y, y)));
  }
};

// The image a camera ray samples: its size, the stratification side and
// the camera's kind.
struct Film {
  int w, h, n_strat;
  bool pinhole;
};

// Stratified camera ray for (pixel x, y; sample s) with jitter (j0, j1)
// from the 16-float camera vector (position, right, up, view_dir, focal;
// megatrace.camera_vector): integrator.h:557-570 with the frame and flips
// of cameras.camera_rays, in the order of megatrace.strat_uv and
// camera_rays.
template <class M>
__device__ __forceinline__ Ray camera_ray(const float* cam, const Film& f,
                                          int x, int y, int s, float j0,
                                          float j1) {
  const int sx = s % f.n_strat;
  const int sy = (s / f.n_strat) % f.n_strat;
  const float n = static_cast<float>(f.n_strat);
  const float u01 = M::over(
      M::add(static_cast<float>(x),
             M::over(M::add(static_cast<float>(sx), j0), n)),
      static_cast<float>(f.w));
  const float v01 = M::over(
      M::add(static_cast<float>(y),
             M::over(M::add(static_cast<float>(sy), j1), n)),
      static_cast<float>(f.h));
  float u, v;
  if (f.pinhole) {
    u = M::sub(1.0f, M::mul(u01, 2.0f));  // x-flip (camera.h:47)
    v = M::sub(M::mul(v01, 2.0f), 1.0f);
  } else {
    u = M::sub(M::mul(u01, 2.0f), 1.0f);
    v = M::sub(1.0f, M::mul(v01, 2.0f));  // y-flip (camera.h:67)
  }
  Ray r;
  r.ox = M::add(M::add(cam[0], M::mul(u, cam[3])), M::mul(v, cam[6]));
  r.oy = M::add(M::add(cam[1], M::mul(u, cam[4])), M::mul(v, cam[7]));
  r.oz = M::add(M::add(cam[2], M::mul(u, cam[5])), M::mul(v, cam[8]));
  if (f.pinhole) {
    const float ddx = M::sub(M::add(cam[0], M::mul(cam[12], cam[9])), r.ox);
    const float ddy = M::sub(M::add(cam[1], M::mul(cam[12], cam[10])), r.oy);
    const float ddz = M::sub(M::add(cam[2], M::mul(cam[12], cam[11])), r.oz);
    const float nrm = M::norm3(ddx, ddy, ddz);
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

// Uniform direction on the sphere from two uniforms (integrator.h:32-44,
// ops/sampling.dir_from_xi): theta = 2 pi u0, cos phi = 1 - 2 u1.
template <class M>
__device__ __forceinline__ void iso_dir(float u0, float u1, float& dx,
                                        float& dy, float& dz) {
  const float theta = M::mul(TWO_PI_F, u0);
  const float cphi = M::sub(1.0f, M::mul(2.0f, u1));
  const float sphi = sqrtf(fmaxf(M::sub(1.0f, M::mul(cphi, cphi)), 0.0f));
  dx = M::mul(sphi, cosf(theta));
  dy = M::mul(sphi, sinf(theta));
  dz = cphi;
}

// Russian roulette's settings (RenderConfig): from bounce min_scatter on,
// survival min(max(throughput), cap), the cap cap_tail from bounce
// tail_after on.
struct Roulette {
  int min_scatter;
  float cap;
  int tail_after;
  float cap_tail;
};

// Russian roulette (integrator.h:688-695) at `bounce` on the throughput
// tn after the albedo, with the uniform u: a survivor's throughput is
// divided by its survival probability.  Returns whether the path is
// killed.  The plain version is kernels/wavefront.py roulette.
__device__ __forceinline__ bool roulette(float tn[3], int bounce,
                                         const Roulette& R, float u) {
  const bool do_rr = bounce >= R.min_scatter;
  const float cap = bounce >= R.tail_after ? R.cap_tail : R.cap;
  const float rr = fminf(fmaxf(fmaxf(tn[0], tn[1]), tn[2]), cap);
  const bool killed = do_rr && u > rr;
  if (do_rr && !killed)
    for (int c = 0; c < 3; ++c) tn[c] = tn[c] / fmaxf(rr, 1e-12f);
  return killed;
}

}  // namespace gvr
