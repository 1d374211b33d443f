// Nearest ray-arc hit search (brute force, K6), float32, for sm_90a.
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
// What bounds it: FP32 arithmetic, 50 operations per ray-arc pair (the
// scaled coordinates 6, a 3, b 4, the discriminant 6, 2a and its
// reciprocal 2, the square root 1, the two roots 4, the window test of each
// root 12 + 12) and the compares; an arc is 32 bytes read once per block of
// 256 rays.
//
// The design: one thread per ray with its running best in registers;
// tiles of 256 arcs staged in shared memory (1 / r computed once per arc),
// read as broadcasts.  The ragged last tile is masked by its count (the TPU
// kernel's "dead" padding column does not carry over).

#include <cuda_runtime.h>

#include "search2d_common.cuh"

namespace {

using search2d::kThreads;
using search2d::kTile;

__global__ void __launch_bounds__(kThreads)
arc_search_kernel(const float* __restrict__ p0, const float* __restrict__ p1,
                  const float* __restrict__ table, int n, int m, float i_eps,
                  float r_eps, float* __restrict__ u_out,
                  int* __restrict__ idx_out,
                  unsigned char* __restrict__ branch_out) {
  __shared__ search2d::ArcTile tile;

  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray < n;
  const search2d::Ray r = search2d::load_ray(p0, p1, ray, live);

  float best_u = search2d::kBig;
  int best_idx = 0;
  bool best_minus = false;
  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();  // the previous tile is no longer read
    search2d::stage_arcs(tile, table, base, count);
    __syncthreads();
    search2d::search_arcs(tile, count, base, r, i_eps, r_eps, best_u,
                          best_idx, best_minus);
  }
  if (live) {
    u_out[ray] = best_u;
    idx_out[ray] = best_idx;
    branch_out[ray] = best_minus ? 1 : 0;
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
  const int blocks = (n + kThreads - 1) / kThreads;
  arc_search_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      p0, p1, table, n, m, i_eps, r_eps, u_out, idx_out, branch_out);
  return static_cast<int>(cudaGetLastError());
}
