// Nearest ray-arc hit search with chunk culling (K8), float32, sm_90a.
//
// Replaces: tensorflowraytrace_tpu/ops/pallas_kernels.py, _arc_kernel_culled
// (launched through _nearest_hit_arcs_culled_impl / nearest_hit_arcs_pallas
// with cull=True).
//
// What it computes: exactly what arc_search.cu (K6) computes, with K6's
// pair test (search2d::ArcPair), so valid, idx, u and branch equal K6's
// bit for bit.  It only skips pairs that cannot give a nearer hit.
//
// The design: K7's walk (segment_search_culled.cu) with K10's arc fold
// (arc_search_twolevel.cu), so that K8 and K10 differ only in which chunks
// a block visits, as K7 and K9 do:
// - One block per ray block (ray_block rays, one a thread), chunks of
//   search2d::kTile = 256 arcs, swept in order (search2d::walk_listed, no
//   candidate list).
// - The gate: before computing chunk k each thread slab-tests its own ray
//   against the chunk's box and its running best (search2d::slab_gate);
//   compaction.cuh lists the rays that pass, and the whole block computes
//   only those, `group` threads a listed ray, each running K6's exact
//   reject on every group-th arc and the exact arithmetic only past it
//   (search2d::fold_listed_arcs; the group's shuffle reduces (u, 2 idx +
//   minus branch), so the branch travels with its arc).  A chunk costs in
//   proportion to the rays that need it, and a chunk no ray needs costs
//   one gate and one barrier.  The TPU kernel gated whole ray blocks; the
//   plain version (ops/arc_kernels.py) gates ray by ray to match.  Parked
//   rays (p0 = 1e30) fail every gate.
// - The boxes: a ray's own gate decides, so a box must hold every point the
//   pair test accepts, a tangent pair's snapped point included: the chunks'
//   boxes over the arcs' window-aware boxes, widened by 0.14 of the chunk's
//   largest |r| and the rounding margin (ops/arc_kernels.twolevel_boxes,
//   K10's boxes; the derivation is in arc_search_twolevel.cu).
// - Staging: each chunk is read from the (m, 8) arc table K6 reads, so the
//   wrapper prepares nothing per bounce but the table and the boxes.  Each
//   thread loads its arcs of chunk k + 1 into registers (ArcStage), in
//   search2d::ArcTile's layout (stage_arcs' conversion: 1 / r, the flags as
//   int32 bits), while chunk k is computed, and writes them into the one
//   shared ArcTile at step k + 1, after the barrier that ends step k.
//
// What bounds it: FP32 arithmetic on the admitted pairs (K6's pair test:
// 15 operations for a pair its exact reject refuses, 50 for the rest),
// plus one slab test per ray and chunk.  On the 2D guide's 512 lenslets a
// block walks 2 chunks, and a per-ray gate admits under 1% of the pairs,
// so the reads of the rays and the block's fixed cost are most of it.

#include <cstdint>

#include <cuda_runtime.h>

#include "search2d_common.cuh"

namespace {

using search2d::kTile;

// The most rays a block.  The launch bound asks for no second block an SM:
// ptxas takes 54-56 registers for the walk and the arc fold; held to 32
// (two blocks of 1024 an SM, K7's bound) it spills 128-228 bytes, and a
// trial build of that ran no faster on the H100.
constexpr int kMaxThreads = 1024;
// the fewest rays a block: ArcStage holds up to 2 arcs a thread (1 at
// kTile rays a block and more)
constexpr int kMinThreads = kTile / 2;
constexpr int kVecs = sizeof(search2d::ArcTile) / sizeof(float4);  // 512

// shared memory: one ArcTile, a float4 and a float2 a ray, the list, two
// arrays of the warps' counts (36.25 KB at kMaxThreads rays)
size_t shared_bytes(int ray_block) {
  return sizeof(float4) * (kVecs + ray_block) + sizeof(float2) * ray_block +
         sizeof(int) * (ray_block + 2 * 32);
}

// walk_listed's stage for arcs read from the (m, 8) arc table (two float4
// a row): thread i holds arcs i, i + blockDim.x, ... (kPer of them) of the
// next chunk as ArcTile rows, zero past m.  One buffer is enough: land(k)
// writes it after the barrier that ends step k - 1, the last to read it.
template <int kPer>
struct ArcStage {
  search2d::ArcTile* tile;
  const float4* __restrict__ rows;
  int m;
  float4 head[kPer], edge[kPer];

  __device__ __forceinline__ void start(int c) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = threadIdx.x + i * blockDim.x;
      const int s = c * kTile + t;
      head[i] = edge[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < kTile && s < m)
        search2d::tile_row(rows[2 * s], rows[2 * s + 1], head[i], edge[i]);
    }
  }
  __device__ __forceinline__ const float4* land(int, int next) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = threadIdx.x + i * blockDim.x;
      if (t < kTile) {
        tile->head[t] = head[i];
        tile->edge[t] = edge[i];
      }
    }
    if (next >= 0) start(next);
    return reinterpret_cast<const float4*>(tile);
  }
};

template <int kPer>
__global__ void __launch_bounds__(kMaxThreads)
arc_search_culled_kernel(const float* __restrict__ p0,
                         const float* __restrict__ p1,
                         const float4* __restrict__ table,
                         const float* __restrict__ aabb, int n, int m,
                         float i_eps, float r_eps, float slack_hi,
                         float slack_lo, float slack,
                         float* __restrict__ u_out, int* __restrict__ idx_out,
                         unsigned char* __restrict__ branch_out) {
  extern __shared__ float4 smem[];
  auto* tile = reinterpret_cast<search2d::ArcTile*>(smem);   // 1 chunk
  float4* ray_a = smem + kVecs;                              // ox oy dx dy
  float2* ray_b = reinterpret_cast<float2*>(ray_a + blockDim.x);  // u, key
  int* list = reinterpret_cast<int*>(ray_b + blockDim.x);
  int* warp_count = list + blockDim.x;                       // 2 x 32

  const int me = threadIdx.x;
  const int ray = blockIdx.x * blockDim.x + me;
  const bool live = ray < n;
  const search2d::Ray r = search2d::load_ray(p0, p1, ray, live);
  search2d::put_ray(ray_a, ray_b, r);

  ArcStage<kPer> stage{tile, table, m};
  search2d::walk_listed(
      (m + kTile - 1) / kTile, [](int k) { return k; }, stage, aabb, r, live,
      r_eps, slack_hi, slack_lo, slack, ray_b[me].x, list, warp_count,
      [&](const float4*, int c, int total) {
        const int base = c * kTile;
        search2d::fold_listed_arcs(*tile, min(kTile, m - base), base, total,
                                   list, ray_a, ray_b, i_eps, r_eps);
      });

  // every best was written before a barrier this thread has passed
  if (live) {
    const int key = __float_as_int(ray_b[me].y);
    u_out[ray] = ray_b[me].x;
    idx_out[ray] = key >> 1;
    branch_out[ray] = key & 1;
  }
}

}  // namespace

// K6's arguments plus aabb: (ceil(m / chunk), 4) float32, where chunk must
// be the kernel's tile of 256 arcs, ray_block, a multiple of 32 in [128,
// 1024], and the table 16-byte aligned (else the launch returns
// cudaErrorInvalidValue); the gate's slack (1 + 1e-6, 1 - 1e-6, 1e-6) as
// the float32 values the plain version uses.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int arc_search_culled_launch(
    const float* p0, const float* p1, const float* table, const float* aabb,
    int n, int m, int chunk, int ray_block, float i_eps, float r_eps,
    float slack_hi, float slack_lo, float slack, float* u_out, int* idx_out,
    unsigned char* branch_out, void* stream) {
  if (chunk != kTile || ray_block % 32 != 0 || ray_block < kMinThreads ||
      ray_block > kMaxThreads || reinterpret_cast<uintptr_t>(table) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + ray_block - 1) / ray_block;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* rows = reinterpret_cast<const float4*>(table);
  if (ray_block >= kTile)
    arc_search_culled_kernel<1><<<blocks, ray_block, shared_bytes(ray_block),
                                  s>>>(p0, p1, rows, aabb, n, m, i_eps, r_eps,
                                       slack_hi, slack_lo, slack, u_out,
                                       idx_out, branch_out);
  else
    arc_search_culled_kernel<2><<<blocks, ray_block, shared_bytes(ray_block),
                                  s>>>(p0, p1, rows, aabb, n, m, i_eps, r_eps,
                                       slack_hi, slack_lo, slack, u_out,
                                       idx_out, branch_out);
  return static_cast<int>(cudaGetLastError());
}
