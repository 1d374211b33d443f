// Nearest ray-triangle hit search with chunk culling (K3), float32 and
// float64, sm_90a.
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
// chunk_aabbs, widened by ops/triangle_kernels.culled_boxes so that it
// holds every point Moller-Trumbore accepts, s_eps of an edge beyond a
// triangle and a float32 rounding margin; passed in as (C, 6): min xyz, max
// xyz).  For each tile every ray slab-tests its own box (tsearch::slab_gate,
// triangle_search_common.cuh: can it hit the box at t >= r_eps, no farther
// than its best, with slack 1 +- 1e-6); a ray that fails cannot find a
// nearer hit in the tile.  Each ray's own gate decides, so the plain
// version (ops/triangle_kernels.py) gates ray by ray.  Parked rays
// (p0 = 1e30, engine.project_3d) fail every slab test, and a block whose
// rays all fail stages no tile.
//
// What bounds it: FP32 issue slots on the admitted pairs, each an
// instruction without FMAs: 24 operations for a pair the reject test
// refuses on tu (most of them), K1's 46 and the IEEE division's eight or
// so for the rest, plus one slab test a ray and tile.  After the first
// bounce most rays have a near best hit or are parked, so a tile is needed
// by few rays of a block, and by different ones from tile to tile.
//
// The design:
// - Compaction inside the block (compaction::compact, compaction.cuh, and
//   tsearch::fold_listed, triangle_search_common.cuh, which K4 shares).  The block's kBlock rays
//   (one a thread) keep their origin, direction and running best in shared
//   memory.  For each tile every thread gates its own ray; a ballot and a
//   scan of the warps' counts list the rays that need the tile, and the
//   whole block computes them, `group` threads a listed ray, each folding
//   every group-th triangle, then a shuffle takes the group's smallest
//   (u, idx), the in-order fold's result.  A tile then costs in proportion
//   to the rays that need it, not to the warps that hold one.
// - The pair test (tsearch::triangle_pair, reject_test.cuh): the exact
//   numerators, an approximate reciprocal, tu's widened range before Q is
//   formed, then tv's, tu + tv's and u's; the division and the exact
//   compares only for a pair the test cannot reject.
// - The tile holds (v0, E1, E2) as three rows of float4, the edges
//   computed once while staging: three 128-bit shared loads a triangle,
//   consecutive triangles at consecutive addresses for a group's threads,
//   the same triangle for the groups (a broadcast).
// - kBlock is 256 rays: the H100 sweep of 128, 256, 512 and 1024 (PERF.md)
//   put 128 within 1.3% of 256 and both ahead of 512 and 1024.  The shared
//   memory (12 KB of tile and 36 bytes a ray) is one dynamic array: the
//   same arrays declared static ran slower on the H100 (PERF.md).
//
// The float64 instance (triangle_search_culled_launch_f64), simpler: no
// compaction and no reject test.  Each thread keeps its ray and running
// best in registers and gates its own ray on the chunk's float64 box
// (tsearch::f64::slab_gate); a block stages the chunk (five rows of
// double2 a triangle) when one of its rays passes (__syncthreads_or), and
// each ray that passed folds the whole chunk with K1's float64 pair
// (tsearch::f64::fold_triangle), the plain version's arithmetic.  The
// boxes are culled_boxes in float64, widened by float32's rounding margin
// GATE_PAD, far more than float64's rounding needs, so they still hold
// every point the float64 pair test accepts, and K3 returns K1's hits bit
// for bit.  What bounds it: FP64 issue slots on the admitted pairs and
// the warps' idle lanes (a warp runs a chunk for all 32 of its rays when
// one needs it).

#include <cuda_runtime.h>

#include "triangle_search_common.cuh"

namespace {

constexpr int kTile = 256;      // triangles per tile = culling chunk
constexpr int kBlock = 256;     // rays per block, one a thread
// the tile, two float4 a ray, the list, the warps' counts
constexpr size_t kShared = sizeof(float4) * (3 * kTile + 2 * kBlock) +
                           sizeof(int) * kBlock + sizeof(int) * 32;

__global__ void __launch_bounds__(kBlock)
triangle_search_culled_kernel(const float* __restrict__ p0,
                              const float* __restrict__ p1,
                              const float* __restrict__ vp,
                              const float* __restrict__ v1,
                              const float* __restrict__ v2,
                              const float* __restrict__ aabb,
                              int n, int m,
                              const reject::Limits lim,
                              float slack_hi, float slack_lo, float slack,
                              float* __restrict__ u_out,
                              int* __restrict__ idx_out) {
  extern __shared__ float4 smem[];
  float4* tile = smem;                      // 3 rows of kTile float4
  float4* ray_a = tile + 3 * kTile;         // ox oy oz dx
  float4* ray_b = ray_a + kBlock;           // dy dz best_u best_idx (bits)
  int* list = reinterpret_cast<int*>(ray_b + kBlock);
  int* warp_count = list + kBlock;

  const int me = threadIdx.x;
  const int ray = blockIdx.x * kBlock + me;
  const bool live = ray < n;
  const tsearch::Ray r = tsearch::load_ray(p0, p1, ray, live);
  tsearch::put_ray(ray_a, ray_b, r);

  for (int base = 0, chunk = 0; base < m; base += kTile, ++chunk) {
    // the previous tile's bests are written; the tile and list are free
    __syncthreads();
    const bool need = live && tsearch::slab_gate(aabb + 6 * chunk, r, lim.r_eps,
                                                 slack_hi, slack_lo, slack,
                                                 ray_b[me].z);
    const int total = compaction::compact(need, list, warp_count);
    if (total == 0) continue;  // the same in every thread

    const int count = min(kTile, m - base);
    for (int t = me; t < count; t += kBlock) {
      const int g = 3 * (base + t);
      const float ax = vp[g + 0], ay = vp[g + 1], az = vp[g + 2];
      tile[t] = make_float4(ax, ay, az, v1[g + 0] - ax);
      tile[kTile + t] = make_float4(v1[g + 1] - ay, v1[g + 2] - az,
                                    v2[g + 0] - ax, v2[g + 1] - ay);
      tile[2 * kTile + t] = make_float4(v2[g + 2] - az, 0.f, 0.f, 0.f);
    }
    __syncthreads();  // the tile and the list are written
    tsearch::fold_listed<kTile>(tile, count, base, total, list, ray_a, ray_b,
                                lim);
  }

  __syncthreads();
  if (live) {
    u_out[ray] = ray_b[me].z;
    idx_out[ray] = __float_as_int(ray_b[me].w);
  }
}

__global__ void __launch_bounds__(kBlock)
triangle_search_culled_f64_kernel(const double* __restrict__ p0,
                                  const double* __restrict__ p1,
                                  const double* __restrict__ vp,
                                  const double* __restrict__ v1,
                                  const double* __restrict__ v2,
                                  const double* __restrict__ aabb, int n,
                                  int m, const tsearch::f64::Limits lim,
                                  double slack_hi, double slack_lo,
                                  double slack, double* __restrict__ u_out,
                                  int* __restrict__ idx_out) {
  __shared__ double2 tile[5 * kTile];  // 20 KB

  const int ray = blockIdx.x * kBlock + threadIdx.x;
  const bool live = ray < n;
  const tsearch::f64::Ray r = tsearch::f64::load_ray(p0, p1, ray, live);
  double best_u = tsearch::f64::kBig;
  int best_idx = 0;

  for (int base = 0, chunk = 0; base < m; base += kTile, ++chunk) {
    const bool need = live && tsearch::f64::slab_gate(aabb + 6 * chunk, r,
                                                      lim.r_eps, slack_hi,
                                                      slack_lo, slack, best_u);
    // also the barrier after the previous tile's last read
    if (!__syncthreads_or(need)) continue;  // the same in every thread
    const int count = min(kTile, m - base);
    tsearch::f64::stage_triangles<kTile>(tile, base, count, vp, v1, v2);
    __syncthreads();
    if (need) {
      for (int t = 0; t < count; ++t)
        tsearch::f64::fold_triangle(
            tsearch::f64::load_triangle<kTile>(tile, t), base + t, r, lim,
            best_u, best_idx);
    }
  }
  if (live) {
    u_out[ray] = best_u;
    idx_out[ray] = best_idx;
  }
}

}  // namespace

// p0, p1: (n, 3) float32 row-major; vp, v1, v2: (m, 3) float32 row-major;
// aabb: (ceil(m / chunk), 6) float32, where chunk must be the kernel's tile
// of 256 triangles (else the launch returns cudaErrorInvalidValue).
// u_out: (n,) float32, idx_out: (n,) int32.  The thresholds (s_lo = -s_eps,
// s_hi = 1 + s_eps) and the gate's slack (1 + 1e-6, 1 - 1e-6, 1e-6) arrive
// as the float32 values the plain version compares with.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int triangle_search_culled_launch(
    const float* p0, const float* p1, const float* vp, const float* v1,
    const float* v2, const float* aabb, int n, int m, int chunk, float i_eps,
    float s_lo, float s_hi, float r_eps, float slack_hi, float slack_lo,
    float slack, float* u_out, int* idx_out, void* stream) {
  if (chunk != kTile) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kBlock - 1) / kBlock;
  triangle_search_culled_kernel<<<blocks, kBlock, kShared,
                                  static_cast<cudaStream_t>(stream)>>>(
      p0, p1, vp, v1, v2, aabb, n, m, reject::limits(i_eps, s_lo, s_hi, r_eps),
      slack_hi, slack_lo, slack, u_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}

// The float64 instance: every pointer float64 but idx_out (int32), the
// thresholds and slack as the float64 values the plain version compares
// with; chunk as above.
extern "C" int triangle_search_culled_launch_f64(
    const double* p0, const double* p1, const double* vp, const double* v1,
    const double* v2, const double* aabb, int n, int m, int chunk,
    double i_eps, double s_lo, double s_hi, double r_eps, double slack_hi,
    double slack_lo, double slack, double* u_out, int* idx_out,
    void* stream) {
  if (chunk != kTile) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kBlock - 1) / kBlock;
  triangle_search_culled_f64_kernel<<<blocks, kBlock, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      p0, p1, vp, v1, v2, aabb, n, m,
      tsearch::f64::Limits{i_eps, s_lo, s_hi, r_eps}, slack_hi, slack_lo,
      slack, u_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
