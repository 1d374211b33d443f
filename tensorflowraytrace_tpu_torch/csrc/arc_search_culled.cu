// Nearest ray-arc hit search with chunk culling (K8), float32, sm_90a.
//
// Replaces: tensorflowraytrace_tpu/ops/pallas_kernels.py, _arc_kernel_culled
// (launched through _nearest_hit_arcs_culled_impl / nearest_hit_arcs_pallas
// with cull=True).
//
// What it computes: exactly what arc_search.cu (K6) computes, with K6's
// tile search (search2d::search_arcs), so valid, idx, u and branch equal
// K6's bit for bit.  It only skips pairs that cannot give a nearer hit.
//
// The gate is K7's (segment_search_culled.cu) on window-aware boxes: each
// chunk of kTile arcs has the box of its arcs' boxes
// (models/acceleration.py chunk_aabbs_arcs, widened by K7's rounding
// margin, (C, 4): min xy, max xy), each arc's box holding its endpoints and
// the axis extremes inside its window.
// A block stages a tile only if some ray passes the slab gate
// (__syncthreads_or), a warp computes it only if one of its rays does
// (__any_sync); the plain version (ops/arc_kernels.py) gates groups of 32
// rays as the warp vote does.  Parked rays fail every slab test.
//
// What bounds it: FP32 arithmetic on the admitted pairs (50 operations
// each, as in K6), plus one 14-operation slab test per ray and tile.

#include <cuda_runtime.h>

#include "search2d_common.cuh"

namespace {

using search2d::kThreads;
using search2d::kTile;

__global__ void __launch_bounds__(kThreads)
arc_search_culled_kernel(const float* __restrict__ p0,
                         const float* __restrict__ p1,
                         const float* __restrict__ table,
                         const float* __restrict__ aabb, int n, int m,
                         float i_eps, float r_eps, float slack_hi,
                         float slack_lo, float slack,
                         float* __restrict__ u_out, int* __restrict__ idx_out,
                         unsigned char* __restrict__ branch_out) {
  __shared__ search2d::ArcTile tile;

  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray < n;
  const search2d::Ray r = search2d::load_ray(p0, p1, ray, live);

  float best_u = search2d::kBig;
  int best_idx = 0;
  bool best_minus = false;
  for (int base = 0, chunk = 0; base < m; base += kTile, ++chunk) {
    const bool need = live && search2d::slab_gate(aabb + 4 * chunk, r, r_eps,
                                                  slack_hi, slack_lo, slack,
                                                  best_u);
    const bool warp_need = __any_sync(0xffffffffu, need);
    // also the barrier after which the previous tile is no longer read
    if (!__syncthreads_or(need)) continue;
    const int count = min(kTile, m - base);
    search2d::stage_arcs(tile, table, base, count);
    __syncthreads();
    if (!warp_need) continue;
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

// K6's arguments plus aabb: (ceil(m / chunk), 4) float32, where chunk must
// be the kernel's tile of 256 arcs (else the launch returns
// cudaErrorInvalidValue), and the gate's slack (1 + 1e-6, 1 - 1e-6, 1e-6)
// as the float32 values the plain version uses.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int arc_search_culled_launch(
    const float* p0, const float* p1, const float* table, const float* aabb,
    int n, int m, int chunk, float i_eps, float r_eps, float slack_hi,
    float slack_lo, float slack, float* u_out, int* idx_out,
    unsigned char* branch_out, void* stream) {
  if (chunk != kTile) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  arc_search_culled_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      p0, p1, table, aabb, n, m, i_eps, r_eps, slack_hi, slack_lo, slack,
      u_out, idx_out, branch_out);
  return static_cast<int>(cudaGetLastError());
}
