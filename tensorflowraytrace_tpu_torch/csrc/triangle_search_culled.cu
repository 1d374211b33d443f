// Nearest ray-triangle hit search with chunk culling (K3), float32, sm_90a.
//
// Replaces: tensorflowraytrace_tpu/ops/pallas_kernels.py,
// _triangle_kernel_culled (launched through
// _nearest_hit_triangles_culled_impl / nearest_hit_triangles_pallas with
// cull=True).
//
// What it computes: exactly what csrc/triangle_search.cu (K1) computes --
// per ray the smallest valid Moller-Trumbore u and the index of the first
// triangle that gives it, u = 3e38 and idx 0 on a miss -- with the same
// float32 operations in the same order (built with --fmad=false, see K1's
// note), so valid, idx and u equal K1's bit for bit.  It only skips pairs
// that cannot give a nearer hit.
//
// The gate.  The triangles are cut into chunks of kTile rows (the shared-
// memory tile), each with its axis-aligned box (models/acceleration.py
// chunk_aabbs, passed in as (C, 6): min xyz, max xyz).  Before a tile is
// staged, each thread slab-tests its own ray against the tile's box
// (tsearch::slab_gate, triangle_search_common.cuh: can the ray hit the box
// at t >= r_eps, no farther than its best, with slack 1 +- 1e-6); a ray
// that fails cannot find a nearer hit in the tile.  The per-tile search is
// tsearch::search_tile, K1's arithmetic.  __syncthreads_or decides whether
// the block stages the tile at all, and a warp vote (__any_sync) whether a warp computes it: the
// TPU kernel gates whole 512-ray blocks, a warp is the finer gate the TPU
// could not have.  Results are set by the warp vote, so the plain version
// (ops/triangle_kernels.py) gates groups of 32 rays.  Parked rays
// (p0 = 1e30, engine.project_3d) fail every slab test, and a block whose
// rays are all parked stages no tile.
//
// What bounds it: FP32 arithmetic on the admitted pairs (about 46 flops
// each, as in K1), plus one 20-flop slab test per ray and tile.  What the
// gate does about it: after the first bounce most rays have a near best
// hit or are parked, so most (warp, tile) pairs are skipped; on a
// Morton-sorted scene a tile is a compact patch, so its box is small.
//
// One thread per ray, kThreads rays per block; tiles of kTile triangles
// staged as (v0, E1, E2) structure-of-arrays in shared memory, read as
// broadcasts; the running best in registers.

#include <cuda_runtime.h>

#include "triangle_search_common.cuh"

namespace {

constexpr int kThreads = 256;   // rays per block, one per thread
constexpr int kTile = 256;      // triangles per tile = culling chunk

__global__ void __launch_bounds__(kThreads)
triangle_search_culled_kernel(const float* __restrict__ p0,
                              const float* __restrict__ p1,
                              const float* __restrict__ vp,
                              const float* __restrict__ v1,
                              const float* __restrict__ v2,
                              const float* __restrict__ aabb,
                              int n, int m,
                              float i_eps, float s_lo, float s_hi, float r_eps,
                              float slack_hi, float slack_lo, float slack,
                              float* __restrict__ u_out,
                              int* __restrict__ idx_out) {
  // structure-of-arrays tile: v0x v0y v0z e1x e1y e1z e2x e2y e2z
  __shared__ float tile[9][kTile];

  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray < n;
  const tsearch::Ray r = tsearch::load_ray(p0, p1, ray, live);

  float best_u = tsearch::kBig;
  int best_idx = 0;

  for (int base = 0, chunk = 0; base < m; base += kTile, ++chunk) {
    const bool need = live && tsearch::slab_gate(aabb + 6 * chunk, r, r_eps,
                                                 slack_hi, slack_lo, slack,
                                                 best_u);
    const bool warp_need = __any_sync(0xffffffffu, need);
    // also the barrier after which the previous tile is no longer read
    if (!__syncthreads_or(need)) continue;

    const int count = min(kTile, m - base);
    for (int t = threadIdx.x; t < count; t += kThreads) {
      const int g = 3 * (base + t);
      const float ax = vp[g + 0], ay = vp[g + 1], az = vp[g + 2];
      tile[0][t] = ax;
      tile[1][t] = ay;
      tile[2][t] = az;
      tile[3][t] = v1[g + 0] - ax;
      tile[4][t] = v1[g + 1] - ay;
      tile[5][t] = v1[g + 2] - az;
      tile[6][t] = v2[g + 0] - ax;
      tile[7][t] = v2[g + 1] - ay;
      tile[8][t] = v2[g + 2] - az;
    }
    __syncthreads();
    if (!warp_need) continue;
    tsearch::search_tile<kTile>(tile, count, base, r, i_eps, s_lo, s_hi,
                                r_eps, best_u, best_idx);
  }

  if (live) {
    u_out[ray] = best_u;
    idx_out[ray] = best_idx;
  }
}

}  // namespace

// p0, p1: (n, 3) float32 row-major; vp, v1, v2: (m, 3) float32 row-major;
// aabb: (ceil(m / chunk), 6) float32, where chunk must be the kernel's tile
// of 256 triangles (else the launch returns cudaErrorInvalidValue).  u_out:
// (n,) float32, idx_out: (n,) int32.  The thresholds (s_lo = -s_eps,
// s_hi = 1 + s_eps) and the gate's slack (1 + 1e-6, 1 - 1e-6, 1e-6) arrive
// as the float32 values the plain version compares with.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int triangle_search_culled_launch(
    const float* p0, const float* p1, const float* vp, const float* v1,
    const float* v2, const float* aabb, int n, int m, int chunk, float i_eps,
    float s_lo, float s_hi, float r_eps, float slack_hi, float slack_lo,
    float slack, float* u_out, int* idx_out, void* stream) {
  if (chunk != kTile) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  triangle_search_culled_kernel<<<blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      p0, p1, vp, v1, v2, aabb, n, m, i_eps, s_lo, s_hi, r_eps, slack_hi,
      slack_lo, slack, u_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
