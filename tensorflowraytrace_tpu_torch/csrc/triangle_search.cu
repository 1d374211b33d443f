// Nearest ray-triangle hit search (brute force, K1), float32 and float64,
// for sm_90a.
//
// Replaces: tensorflowraytrace_tpu/ops/pallas_kernels.py, _triangle_kernel
// (launched through _nearest_hit_triangles_impl / nearest_hit_triangles_pallas
// with cull=False).
//
// What it computes, per ray: the smallest valid Moller-Trumbore ray
// parameter u over every triangle and the index of the FIRST triangle that
// gives it (strict < in triangle order); u = 3e38 (the _BIG sentinel of the
// TPU kernel) and idx 0 on a miss.  The pair arithmetic
// (tsearch::TrianglePair, triangle_search_common.cuh, shared with K3 and
// K4) is the plain version's (ops/triangle_kernels.py) in the same order,
// built with --fmad=false, so valid, idx and u equal the plain version's
// bit for bit.  No gradient: the engine differentiates through the O(N)
// refine of the winning triangle instead.
//
// What bounds it: FP32 issue slots.  Without FMAs every operation is an
// instruction: 24 for a pair the reject test refuses on tu, K1's 46 and
// the IEEE division's eight or so for a pair that passes it.  Bytes hardly
// count: a block reads each triangle's 36 bytes once and uses them for all
// of its rays.
//
// The design:
// - The pair test is reject_test.cuh's, as in K3: P, det, T, tu's
//   numerator and an approximate reciprocal (no division) decide whether
//   tu can be in range; only a pair that passes forms Q and tests tv, tu +
//   tv and u, and only a pair that passes that too pays the division and
//   the exact compares.  The test refuses only pairs the exact arithmetic
//   refuses.
// - kRays rays a thread, as K5 and K6: one shared load of a triangle serves
//   kRays pairs, the rays' state stays in registers, and there is one
//   branch a triangle (taken when some ray's pair passes tu's test), not
//   one a pair.  A block of kThreads threads takes kThreads x kRays
//   consecutive rays, ray k of a thread at offset k kThreads, so loads and
//   stores stay coalesced.  The launch takes 4 rays a thread when that
//   still gives at least two blocks an SM (ops/triangle_kernels.py
//   brute_rays_per_thread), else 1: the flagship's 1024 rays would
//   otherwise fill one block on one SM of 132.
// - The triangle loop is unrolled by two, and at 4 rays a thread the launch
//   bound holds the kernel to 85 registers, three blocks an SM: the
//   H100 sweep (PERF.md) put both ahead of the plain loop, whose 86
//   registers left two blocks an SM.
// - Tiles of kTile triangles in shared memory, three rows of float4 as K3's
//   tile and K4's table: (v0x, v0y, v0z, E1x), (E1y, E1z, E2x, E2y), (E2z,
//   -, -, -), the edges computed once while staging; every thread reads the
//   same triangle at once (a broadcast).  The ragged last tile is masked by
//   its count (the TPU kernel's zero padding does not carry over).
//
// FMA: built with --fmad=false.  nvcc would otherwise contract a*b - c*d into
// fused multiply-adds, which rounds differently from the plain PyTorch
// version (each PyTorch elementwise op rounds on its own; an FMA build moved
// u by up to 1.5% on the H100).  Without contraction every operation here
// is one correctly rounded IEEE float32 operation in the plain version's
// order, so the validity tests at the s_eps / r_eps edges can never
// disagree between the two.
//
// The float64 instance (triangle_search_launch_f64; the JAX package's
// Pallas kernel computes in its inputs' dtype, and its reference is
// float64) keeps the launch, the rays a thread and the ray layout, and
// stages five rows of double2 a triangle (tsearch::f64::stage_triangles).
// It has no reject test: each pair runs the plain version's float64
// arithmetic (tsearch::f64::fold_triangle), ending early only where an
// exact compare refuses it.  What bounds it: FP64 issue slots, at half
// the FP32 rate on the H100; every pair that passes |det| >= i_eps pays
// the IEEE float64 division.

#include <cuda_runtime.h>

#include "triangle_search_common.cuh"

namespace {

constexpr int kThreads = 256;   // threads a block
constexpr int kTile = 1024;     // triangles a tile: 48 KB of shared memory

template <int kRays>
__global__ void __launch_bounds__(kThreads, kRays == 4 ? 3 : 1)
triangle_search_kernel(const float* __restrict__ p0,
                       const float* __restrict__ p1,
                       const float* __restrict__ vp,
                       const float* __restrict__ v1,
                       const float* __restrict__ v2, int n, int m,
                       const reject::Limits lim,
                       float* __restrict__ u_out, int* __restrict__ idx_out) {
  __shared__ float4 tile[3 * kTile];

  const int first = blockIdx.x * (kThreads * kRays) + threadIdx.x;
  tsearch::Ray r[kRays];
  reject::Best best[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int ray = first + k * kThreads;
    r[k] = tsearch::load_ray_direction(p0, p1, ray, ray < n);
    best[k].set(tsearch::kBig, 0, lim);
  }

  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < count; t += kThreads) {
      const int g = 3 * (base + t);
      const float ax = vp[g + 0], ay = vp[g + 1], az = vp[g + 2];
      tile[t] = make_float4(ax, ay, az, v1[g + 0] - ax);
      tile[kTile + t] = make_float4(v1[g + 1] - ay, v1[g + 2] - az,
                                    v2[g + 0] - ax, v2[g + 1] - ay);
      tile[2 * kTile + t] = make_float4(v2[g + 2] - az, 0.f, 0.f, 0.f);
    }
    __syncthreads();
#pragma unroll 2
    for (int t = 0; t < count; ++t) {
      const float4 t0 = tile[t], t1 = tile[kTile + t];
      const float e2z = tile[2 * kTile + t].x;
      tsearch::TrianglePair pair[kRays];
      bool maybe[kRays], any = false;
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        pair[k] = tsearch::TrianglePair(t0.x, t0.y, t0.z, t0.w, t1.x, t1.y,
                                        t1.z, t1.w, e2z, r[k], lim);
        maybe[k] = pair[k].maybe(lim);
        any |= maybe[k];
      }
      if (any) {  // one branch a triangle, not one a pair
#pragma unroll
        for (int k = 0; k < kRays; ++k)
          if (maybe[k])
            pair[k].fold(t0.w, t1.x, t1.y, t1.z, t1.w, e2z, base + t, r[k],
                         lim, best[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int ray = first + k * kThreads;
    if (ray < n) {
      u_out[ray] = best[k].u;
      idx_out[ray] = best[k].idx;
    }
  }
}

template <int kRays>
cudaError_t launch(const float* p0, const float* p1, const float* vp,
                   const float* v1, const float* v2, int n, int m,
                   const reject::Limits& lim, float* u_out, int* idx_out,
                   cudaStream_t stream) {
  const int blocks = (n + kThreads * kRays - 1) / (kThreads * kRays);
  triangle_search_kernel<kRays><<<blocks, kThreads, 0, stream>>>(
      p0, p1, vp, v1, v2, n, m, lim, u_out, idx_out);
  return cudaGetLastError();
}

template <int kRays>
__global__ void __launch_bounds__(kThreads)
triangle_search_f64_kernel(const double* __restrict__ p0,
                           const double* __restrict__ p1,
                           const double* __restrict__ vp,
                           const double* __restrict__ v1,
                           const double* __restrict__ v2, int n, int m,
                           const tsearch::f64::Limits lim,
                           double* __restrict__ u_out,
                           int* __restrict__ idx_out) {
  constexpr int kTile64 = 512;  // triangles a tile: 40 KB of shared memory
  __shared__ double2 tile[5 * kTile64];

  const int first = blockIdx.x * (kThreads * kRays) + threadIdx.x;
  tsearch::f64::Ray r[kRays];
  double best_u[kRays];
  int best_idx[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int ray = first + k * kThreads;
    r[k] = tsearch::f64::load_ray(p0, p1, ray, ray < n);
    best_u[k] = tsearch::f64::kBig;
    best_idx[k] = 0;
  }

  for (int base = 0; base < m; base += kTile64) {
    const int count = min(kTile64, m - base);
    __syncthreads();  // the previous tile is no longer read
    tsearch::f64::stage_triangles<kTile64>(tile, base, count, vp, v1, v2);
    __syncthreads();
    for (int t = 0; t < count; ++t) {
      const tsearch::f64::Triangle g =
          tsearch::f64::load_triangle<kTile64>(tile, t);
#pragma unroll
      for (int k = 0; k < kRays; ++k)
        tsearch::f64::fold_triangle(g, base + t, r[k], lim, best_u[k],
                                    best_idx[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int ray = first + k * kThreads;
    if (ray < n) {
      u_out[ray] = best_u[k];
      idx_out[ray] = best_idx[k];
    }
  }
}

}  // namespace

// p0, p1: (n, 3) float32 row-major; vp, v1, v2: (m, 3) float32 row-major.
// u_out: (n,) float32, idx_out: (n,) int32.  s_lo = -s_eps and
// s_hi = 1 + s_eps arrive precomputed (in double, then rounded to float) so
// the thresholds are the very float32 values the plain version compares
// with.  rays_per_thread is 1 or 4 (else the launch returns
// cudaErrorInvalidValue).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int triangle_search_launch(const float* p0, const float* p1,
                                      const float* vp, const float* v1,
                                      const float* v2, int n, int m,
                                      float i_eps, float s_lo, float s_hi,
                                      float r_eps, int rays_per_thread,
                                      float* u_out, int* idx_out,
                                      void* stream) {
  const reject::Limits lim = reject::limits(i_eps, s_lo, s_hi, r_eps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rays_per_thread == 4)
    return static_cast<int>(
        launch<4>(p0, p1, vp, v1, v2, n, m, lim, u_out, idx_out, s));
  if (rays_per_thread == 1)
    return static_cast<int>(
        launch<1>(p0, p1, vp, v1, v2, n, m, lim, u_out, idx_out, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The float64 instance: every pointer float64 but idx_out (int32), the
// thresholds the float64 values the plain version compares with;
// rays_per_thread 1 or 4 as above.
extern "C" int triangle_search_launch_f64(const double* p0, const double* p1,
                                          const double* vp, const double* v1,
                                          const double* v2, int n, int m,
                                          double i_eps, double s_lo,
                                          double s_hi, double r_eps,
                                          int rays_per_thread, double* u_out,
                                          int* idx_out, void* stream) {
  const tsearch::f64::Limits lim{i_eps, s_lo, s_hi, r_eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rays_per_thread != 1 && rays_per_thread != 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rays = kThreads * rays_per_thread;
  const int blocks = (n + rays - 1) / rays;
  if (rays_per_thread == 4)
    triangle_search_f64_kernel<4><<<blocks, kThreads, 0, s>>>(
        p0, p1, vp, v1, v2, n, m, lim, u_out, idx_out);
  else
    triangle_search_f64_kernel<1><<<blocks, kThreads, 0, s>>>(
        p0, p1, vp, v1, v2, n, m, lim, u_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
