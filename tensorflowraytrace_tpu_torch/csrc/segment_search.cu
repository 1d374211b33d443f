// Nearest ray-segment hit search (brute force, K5), float32, for sm_90a.
//
// Replaces: tensorflowraytrace_tpu/ops/pallas_kernels.py, _segment_kernel
// (launched through _nearest_hit_segments_impl / nearest_hit_segments_pallas
// with cull=False).
//
// What it computes, per ray: the smallest valid ray parameter u over every
// segment and the index of the first segment that gives it; u = 3e38 and
// idx 0 on a miss.  The pair arithmetic (search2d::search_segments in
// search2d_common.cuh) is the plain version's (ops/segment_kernels.py) in
// the same order, built with --fmad=false, so both agree bit for bit.
//
// What bounds it: FP32 arithmetic, 16 operations per ray-segment pair (the
// denominator 3, its reciprocal 1, ray_u 6, seg_u 6) and the compares, with
// almost no bytes once a tile of segments sits in shared memory: a block of
// 256 rays reads each segment's 16 bytes once and uses them 256 times.
//
// The design: one thread per ray with its running best in registers;
// tiles of 256 segments staged as (start, direction) structure-of-arrays in
// shared memory, the direction computed once per segment; every thread of
// a warp reads the same segment at once, a broadcast.  The ragged last tile
// is masked by its count (the TPU kernel's zero padding and its (8, M)
// packing do not carry over).

#include <cuda_runtime.h>

#include "search2d_common.cuh"

namespace {

using search2d::kThreads;
using search2d::kTile;

__global__ void __launch_bounds__(kThreads)
segment_search_kernel(const float* __restrict__ p0,
                      const float* __restrict__ p1,
                      const float* __restrict__ sp0,
                      const float* __restrict__ sp1, int n, int m,
                      float i_eps, float s_lo, float s_hi, float r_eps,
                      float* __restrict__ u_out, int* __restrict__ idx_out) {
  __shared__ float tile[4][kTile];

  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray < n;
  const search2d::Ray r = search2d::load_ray(p0, p1, ray, live);

  float best_u = search2d::kBig;
  int best_idx = 0;
  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();  // the previous tile is no longer read
    search2d::stage_segments(tile, sp0, sp1, base, count);
    __syncthreads();
    search2d::search_segments(tile, count, base, r, i_eps, s_lo, s_hi, r_eps,
                              best_u, best_idx);
  }
  if (live) {
    u_out[ray] = best_u;
    idx_out[ray] = best_idx;
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
  const int blocks = (n + kThreads - 1) / kThreads;
  segment_search_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      p0, p1, sp0, sp1, n, m, i_eps, s_lo, s_hi, r_eps, u_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
