// Nearest ray-segment hit search with chunk culling (K7), float32, sm_90a.
//
// Replaces: tensorflowraytrace_tpu/ops/pallas_kernels.py,
// _segment_kernel_culled (launched through
// _nearest_hit_segments_culled_impl / nearest_hit_segments_pallas with
// cull=True).
//
// What it computes: exactly what segment_search.cu (K5) computes, with K5's
// pair test (search2d::segment_pair), so valid, idx and u equal K5's
// bit for bit.  It only skips pairs that cannot give a nearer hit.
//
// The gate.  The segments are cut into chunks of kTile rows (the shared-
// memory tile), each with its axis-aligned box (models/acceleration.py
// chunk_aabbs_2d, widened by a rounding margin of ~64 float32 ulps of its
// coordinates by ops/segment_kernels.gate_boxes, passed in as (C, 4): min
// xy, max xy; the margin covers hits the float32 arithmetic accepts a few
// ulps outside the exact surface, which the slab test's slack does not far
// from the origin).  Before a tile is
// staged, each thread slab-tests its own ray against the tile's box
// (search2d::slab_gate: can the ray hit the box at t >= r_eps, no farther
// than its best, with slack 1 +- 1e-6).  __syncthreads_or decides whether
// the block stages the tile at all, a warp vote (__any_sync) whether a warp
// computes it: the TPU kernel gates whole ray blocks, a warp is the finer
// gate.  The plain version (ops/segment_kernels.py) gates groups of 32
// rays as the warp vote does.  Parked rays (p0 = 1e30, engine.project_2d)
// fail every slab test, and a block whose rays are all parked stages no
// tile.
//
// What bounds it: FP32 arithmetic on the admitted pairs (14 operations
// each, as in K5), plus one 14-operation slab test per ray and tile.  After
// the first bounce most rays have a near best hit or are parked, so most
// (warp, tile) pairs are skipped; on a Morton-sorted scene a tile is a
// compact stretch of wall, so its box is small.

#include <cuda_runtime.h>

#include "search2d_common.cuh"

namespace {

using search2d::kThreads;
using search2d::kTile;

__global__ void __launch_bounds__(kThreads)
segment_search_culled_kernel(const float* __restrict__ p0,
                             const float* __restrict__ p1,
                             const float* __restrict__ sp0,
                             const float* __restrict__ sp1,
                             const float* __restrict__ aabb, int n, int m,
                             const reject::Limits lim,
                             float slack_hi, float slack_lo, float slack,
                             float* __restrict__ u_out,
                             int* __restrict__ idx_out) {
  __shared__ float tile[4][kTile];

  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray < n;
  const search2d::Ray r = search2d::load_ray(p0, p1, ray, live);

  reject::Best best;
  best.set(search2d::kBig, 0, lim);
  for (int base = 0, chunk = 0; base < m; base += kTile, ++chunk) {
    const bool need =
        live && search2d::slab_gate(aabb + 4 * chunk, r, lim.r_eps, slack_hi,
                                    slack_lo, slack, best.u);
    const bool warp_need = __any_sync(0xffffffffu, need);
    // also the barrier after which the previous tile is no longer read
    if (!__syncthreads_or(need)) continue;
    const int count = min(kTile, m - base);
    search2d::stage_segments(tile, sp0, sp1, base, count);
    __syncthreads();
    if (!warp_need) continue;
    search2d::search_segments(tile, count, base, r, lim, best);
  }
  if (live) {
    u_out[ray] = best.u;
    idx_out[ray] = best.idx;
  }
}

}  // namespace

// K5's arguments plus aabb: (ceil(m / chunk), 4) float32, where chunk must
// be the kernel's tile of 256 segments (else the launch returns
// cudaErrorInvalidValue), and the gate's slack (1 + 1e-6, 1 - 1e-6, 1e-6)
// as the float32 values the plain version uses.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int segment_search_culled_launch(
    const float* p0, const float* p1, const float* sp0, const float* sp1,
    const float* aabb, int n, int m, int chunk, float i_eps, float s_lo,
    float s_hi, float r_eps, float slack_hi, float slack_lo, float slack,
    float* u_out, int* idx_out, void* stream) {
  if (chunk != kTile) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  segment_search_culled_kernel<<<blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      p0, p1, sp0, sp1, aabb, n, m, reject::limits(i_eps, s_lo, s_hi, r_eps),
      slack_hi,
      slack_lo, slack, u_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
