// Nearest ray-arc hit search (brute force, K6), float32 and float64, for
// sm_90a.
//
// Replaces: tensorflowraytrace_tpu/ops/pallas_kernels.py, _arc_kernel
// (launched through _nearest_hit_arcs_impl / nearest_hit_arcs_pallas with
// cull=False).
//
// What it computes, per ray: the smallest valid ray parameter u over both
// quadratic branches of every arc, the index of the first arc that gives
// it, and whether that arc's minus branch gave it; u = 3e38, idx 0 and
// branch 0 on a miss.  The window test is the TPU kernel's cross-product
// form against precomputed edge vectors (the table of
// ops/arc_kernels.arc_table), not the XLA path's atan2 test.  The pair
// arithmetic (search2d::search_arcs in search2d_common.cuh) is the plain
// version's in the same order, built with --fmad=false, so both agree bit
// for bit.
//
// The branch rule.  The TPU kernel sets the flag per tile as
// min(u_minus) < min(u_plus) over the tile; here each arc carries its own
// choice (u_minus < u_plus) into the running best.  The two differ only
// when two arcs tie exactly, and the rule here does not depend on the tile.
//
// The discriminant is b^2 - 4 a c rewritten without its cancellation, so
// that rays far from small arcs keep their hits on the arc (the note in
// search2d_common.cuh).
//
// What bounds it: FP32 issue slots.  Every pair pays the reject test, 15
// operations (the scaled coordinates 6, a 3, the cross term 3, the
// discriminant 3) and its snap and compares; a pair that passes it pays 35
// more (b 4, 2a and its reciprocal 2, the square root 1, the two roots 4,
// the window test of each root 12 + 12), and the IEEE division and square
// root issue about eight instructions each.  Bytes hardly count: an arc is
// 32 bytes read once per block.
//
// The design:
// - The exact reject (search2d::ArcPair): a pair whose discriminant is
//   negative after the plain version's snap, or whose |a| is below i_eps,
//   gives u = 3e38 on both branches, so skipping it is exact; its test
//   reads only the centre and 1 / r and costs no division or square root.
//   A ray's line meets the circles of few arcs (on the 2D guide one or two
//   of the 512 lenslets), so a warp rarely takes the exact path.
// - One 128-bit shared load an arc for the test (centre, 1 / r, flags), a
//   second only on the exact path (the window edges); 1 / r is computed
//   once per arc while staging.
// - kRays rays a thread, as K5: each load serves kRays pairs, one branch
//   an arc covers the thread's rays, and the rays' state stays in
//   registers.  A block of kThreads
//   threads takes kThreads x kRays consecutive rays, ray k of a thread at
//   offset k kThreads, so loads and stores stay coalesced.
// - Tiles of kTile = 256 arcs (8 KB), the ragged last one masked by its
//   count (the TPU kernel's "dead" padding column does not carry over).
//
// The float64 instance (arc_search_launch_f64) keeps the launch, the rays
// a thread and the exact reject, and reads the float64 arc table
// (arc_kernels.arc_table in the arcs' dtype, its flags float values),
// staged as search2d::f64::ArcTile (15 KB): centre and 1 / r, the flags
// as ints, the edge vectors.  Each pair runs the plain version's float64
// arithmetic (search2d::f64::fold_arc), which ends at the exact reject
// for most pairs.  What bounds it: FP64 issue slots.

#include <cuda_runtime.h>

#include "search2d_common.cuh"

namespace {

using search2d::kThreads;
using search2d::kTile;
constexpr int kRays = 4;  // rays a thread

__global__ void __launch_bounds__(kThreads)
arc_search_kernel(const float* __restrict__ p0, const float* __restrict__ p1,
                  const float* __restrict__ table, int n, int m, float i_eps,
                  float r_eps, float* __restrict__ u_out,
                  int* __restrict__ idx_out,
                  unsigned char* __restrict__ branch_out) {
  __shared__ search2d::ArcTile tile;

  const int first = blockIdx.x * (kThreads * kRays) + threadIdx.x;
  search2d::Ray r[kRays];
  search2d::ArcBest best[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int ray = first + k * kThreads;
    r[k] = search2d::load_ray(p0, p1, ray, ray < n);
    best[k] = search2d::ArcBest{search2d::kBig, 0, false};
  }
  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();  // the previous tile is no longer read
    search2d::stage_arcs(tile, table, base, count);
    __syncthreads();
    search2d::search_arcs(tile, count, base, r, i_eps, r_eps, best);
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int ray = first + k * kThreads;
    if (ray < n) {
      u_out[ray] = best[k].u;
      idx_out[ray] = best[k].idx;
      branch_out[ray] = best[k].minus ? 1 : 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
arc_search_f64_kernel(const double* __restrict__ p0,
                      const double* __restrict__ p1,
                      const double* __restrict__ table, int n, int m,
                      const search2d::f64::Limits lim,
                      double* __restrict__ u_out, int* __restrict__ idx_out,
                      unsigned char* __restrict__ branch_out) {
  __shared__ search2d::f64::ArcTile tile;

  const int first = blockIdx.x * (kThreads * kRays) + threadIdx.x;
  search2d::f64::Ray r[kRays];
  double best_u[kRays];
  int best_idx[kRays];
  bool best_minus[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int ray = first + k * kThreads;
    r[k] = search2d::f64::load_ray(p0, p1, ray, ray < n);
    best_u[k] = search2d::f64::kBig;
    best_idx[k] = 0;
    best_minus[k] = false;
  }
  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();  // the previous tile is no longer read
    search2d::f64::stage_arcs(tile, table, base, count);
    __syncthreads();
    for (int t = 0; t < count; ++t) {
#pragma unroll
      for (int k = 0; k < kRays; ++k)
        search2d::f64::fold_arc(tile, t, base + t, r[k], lim, best_u[k],
                                best_idx[k], best_minus[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int ray = first + k * kThreads;
    if (ray < n) {
      u_out[ray] = best_u[k];
      idx_out[ray] = best_idx[k];
      branch_out[ray] = best_minus[k] ? 1 : 0;
    }
  }
}

}  // namespace

// p0, p1: (n, 2) float32 row-major; table: (m, 8) float32 row-major (see
// search2d_common.cuh).  u_out: (n,) float32, idx_out: (n,) int32,
// branch_out: (n,) bool (one byte each).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int arc_search_launch(const float* p0, const float* p1,
                                 const float* table, int n, int m,
                                 float i_eps, float r_eps, float* u_out,
                                 int* idx_out, unsigned char* branch_out,
                                 void* stream) {
  const int blocks = (n + kThreads * kRays - 1) / (kThreads * kRays);
  arc_search_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      p0, p1, table, n, m, i_eps, r_eps, u_out, idx_out, branch_out);
  return static_cast<int>(cudaGetLastError());
}

// The float64 instance: p0, p1, table and u_out float64 (the table as
// arc_kernels.arc_table builds it in float64), i_eps and r_eps the float64
// values the plain version compares with.
extern "C" int arc_search_launch_f64(const double* p0, const double* p1,
                                     const double* table, int n, int m,
                                     double i_eps, double r_eps,
                                     double* u_out, int* idx_out,
                                     unsigned char* branch_out,
                                     void* stream) {
  const int blocks = (n + kThreads * kRays - 1) / (kThreads * kRays);
  arc_search_f64_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      p0, p1, table, n, m, search2d::f64::Limits{i_eps, 0.0, 0.0, r_eps},
      u_out, idx_out, branch_out);
  return static_cast<int>(cudaGetLastError());
}
