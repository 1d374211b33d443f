// Nearest ray-segment hit search (brute force, K5), float32 and float64,
// for sm_90a.
//
// Replaces: tensorflowraytrace_tpu/ops/pallas_kernels.py, _segment_kernel
// (launched through _nearest_hit_segments_impl / nearest_hit_segments_pallas
// with cull=False).
//
// What it computes, per ray: the smallest valid ray parameter u over every
// segment and the index of the first segment that gives it; u = 3e38 and
// idx 0 on a miss.  The pair arithmetic (search2d::segment_pair in
// search2d_common.cuh) is the plain version's (ops/segment_kernels.py) in
// the same order, built with --fmad=false, so both agree bit for bit.
//
// What bounds it: FP32 issue slots.  A pair needs 14 operations (T 2, the
// denominator 3, the two numerators 6, a reciprocal 1, two products 2),
// and without FMAs each is an instruction; the IEEE division, which only
// a pair the reject test keeps pays, issues about eight more (a MUFU.RCP,
// a Newton step, a range check).  Bytes hardly count: a block reads each
// segment's 16 bytes once and uses them for all of its rays.
//
// The design:
// - The reject test (reject_test.cuh): the pair's exact numerators and
//   denominator (11 operations), an approximate reciprocal and two
//   products, and four compares against thresholds widened by the
//   reciprocal's worst error.  Only a pair it cannot reject runs the
//   division and the exact compares, in today's order.  A ray's line
//   crosses few of the segments, so a warp rarely takes that path.
// - One 128-bit shared load a segment: the tile holds (x, y, dx, dy) as
//   one float4 per segment, the direction computed once while staging, and
//   every thread reads the same segment at once (a broadcast).
// - kRays rays a thread: each load serves kRays pairs, and the rays'
//   state stays in registers.  A block of kThreads threads takes kThreads
//   x kRays consecutive rays, ray k of a thread at offset k kThreads, so
//   loads and stores stay coalesced; 2^20 rays make 1024 blocks.
// - Tiles of kSegTile segments (16 KB) in shared memory, the ragged last
//   one masked by its count.
//
// The float64 instance (segment_search_launch_f64) keeps the launch, the
// rays a thread and the tiles (two rows of double2 a segment: start,
// direction; 32 KB) and has no reject test: every pair runs the plain
// version's float64 arithmetic (search2d::f64::fold_segment), so every
// pair with |den| >= i_eps pays the IEEE float64 division.  What bounds
// it: FP64 issue slots, at half the FP32 rate on the H100.

#include <cuda_runtime.h>

#include "search2d_common.cuh"

namespace {

using search2d::kThreads;
constexpr int kRays = 4;         // rays a thread
constexpr int kSegTile = 1024;   // segments a shared-memory tile

__global__ void __launch_bounds__(kThreads)
segment_search_kernel(const float* __restrict__ p0,
                      const float* __restrict__ p1,
                      const float* __restrict__ sp0,
                      const float* __restrict__ sp1, int n, int m,
                      const reject::Limits lim,
                      float* __restrict__ u_out, int* __restrict__ idx_out) {
  __shared__ float4 tile[kSegTile];

  const int first = blockIdx.x * (kThreads * kRays) + threadIdx.x;
  search2d::Ray r[kRays];
  reject::Best best[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int ray = first + k * kThreads;
    r[k] = search2d::load_ray(p0, p1, ray, ray < n);
    best[k].set(search2d::kBig, 0, lim);
  }

  for (int base = 0; base < m; base += kSegTile) {
    const int count = min(kSegTile, m - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < count; t += kThreads) {
      const int g = 2 * (base + t);
      const float x = sp0[g + 0], y = sp0[g + 1];
      tile[t] = make_float4(x, y, sp1[g + 0] - x, sp1[g + 1] - y);
    }
    __syncthreads();
    for (int t = 0; t < count; ++t) {
      const float4 s = tile[t];
      search2d::SegmentPair pair[kRays];
      bool maybe[kRays], any = false;
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        pair[k] = search2d::SegmentPair(s.x, s.y, s.z, s.w, r[k]);
        maybe[k] = pair[k].maybe(lim, best[k]);
        any |= maybe[k];
      }
      if (any) {  // rarely: one branch a segment, not one a pair
#pragma unroll
        for (int k = 0; k < kRays; ++k)
          if (maybe[k]) pair[k].fold(base + t, lim, best[k]);
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

__global__ void __launch_bounds__(kThreads)
segment_search_f64_kernel(const double* __restrict__ p0,
                          const double* __restrict__ p1,
                          const double* __restrict__ sp0,
                          const double* __restrict__ sp1, int n, int m,
                          const search2d::f64::Limits lim,
                          double* __restrict__ u_out,
                          int* __restrict__ idx_out) {
  __shared__ double2 start[kSegTile], dir[kSegTile];

  const int first = blockIdx.x * (kThreads * kRays) + threadIdx.x;
  search2d::f64::Ray r[kRays];
  double best_u[kRays];
  int best_idx[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int ray = first + k * kThreads;
    r[k] = search2d::f64::load_ray(p0, p1, ray, ray < n);
    best_u[k] = search2d::f64::kBig;
    best_idx[k] = 0;
  }

  for (int base = 0; base < m; base += kSegTile) {
    const int count = min(kSegTile, m - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < count; t += kThreads) {
      const int g = 2 * (base + t);
      const double x = sp0[g + 0], y = sp0[g + 1];
      start[t] = make_double2(x, y);
      dir[t] = make_double2(sp1[g + 0] - x, sp1[g + 1] - y);
    }
    __syncthreads();
    for (int t = 0; t < count; ++t) {
      const double2 a = start[t], d = dir[t];
#pragma unroll
      for (int k = 0; k < kRays; ++k)
        search2d::f64::fold_segment(a, d, base + t, r[k], lim, best_u[k],
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

// p0, p1: (n, 2) float32 row-major; sp0, sp1: (m, 2) float32 row-major.
// u_out: (n,) float32, idx_out: (n,) int32.  The thresholds (s_lo = -s_eps,
// s_hi = 1 + s_eps) arrive as the float32 values the plain version compares
// with.  Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int segment_search_launch(const float* p0, const float* p1,
                                     const float* sp0, const float* sp1,
                                     int n, int m, float i_eps, float s_lo,
                                     float s_hi, float r_eps, float* u_out,
                                     int* idx_out, void* stream) {
  const int blocks = (n + kThreads * kRays - 1) / (kThreads * kRays);
  segment_search_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      p0, p1, sp0, sp1, n, m, reject::limits(i_eps, s_lo, s_hi, r_eps), u_out,
      idx_out);
  return static_cast<int>(cudaGetLastError());
}

// The float64 instance: every pointer float64 but idx_out (int32), the
// thresholds the float64 values the plain version compares with.
extern "C" int segment_search_launch_f64(const double* p0, const double* p1,
                                         const double* sp0, const double* sp1,
                                         int n, int m, double i_eps,
                                         double s_lo, double s_hi,
                                         double r_eps, double* u_out,
                                         int* idx_out, void* stream) {
  const int blocks = (n + kThreads * kRays - 1) / (kThreads * kRays);
  segment_search_f64_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      p0, p1, sp0, sp1, n, m, search2d::f64::Limits{i_eps, s_lo, s_hi, r_eps},
      u_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
