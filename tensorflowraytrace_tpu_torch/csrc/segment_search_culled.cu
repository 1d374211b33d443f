// Nearest ray-segment hit search with chunk culling (K7), float32 and
// float64, sm_90a.
//
// Replaces: tensorflowraytrace_tpu/ops/pallas_kernels.py,
// _segment_kernel_culled (launched through
// _nearest_hit_segments_culled_impl / nearest_hit_segments_pallas with
// cull=True).
//
// What it computes: exactly what segment_search.cu (K5) computes, with K5's
// pair test (search2d::SegmentPair), so valid, idx and u equal K5's bit
// for bit.  It only skips pairs that cannot give a nearer hit.
//
// The design: K9's walk (segment_search_twolevel.cu) over every chunk in
// order, with no candidate list (search2d::walk_listed):
// - One block per ray block (ray_block rays, one a thread), chunks of
//   search2d::kTile = 256 segments, each with its box (the chunk's box,
//   widened by ops/segment_kernels.twolevel_boxes, passed in as (C, 4): min
//   xy, max xy).
// - The gate: before computing chunk k each thread slab-tests its own ray
//   against the chunk's box and its running best (search2d::slab_gate:
//   can the ray hit the box at t >= r_eps, no farther than its best, with
//   slack 1 +- 1e-6); compaction.cuh lists the rays that pass, and the
//   whole block computes only those, `group` threads a listed ray
//   (search2d::fold_listed_segments).  A chunk costs in proportion to the
//   rays that need it, not to the warps that hold one, and a chunk no ray
//   needs costs one gate and one barrier.  The TPU kernel gated whole ray
//   blocks; the plain version (ops/segment_kernels.py) gates ray by ray to
//   match.  Parked rays (p0 = 1e30, engine.project_2d) fail every gate.
// - The boxes: a ray's own gate decides, so a box must hold every point
//   the pair test accepts: seg_u from -size_eps to 1 + size_eps puts a hit
//   up to size_eps of a segment's extent outside its box, so the boxes are
//   widened by size_eps of their widest side, plus the rounding margin of
//   ops/triangle_kernels.GATE_PAD (K9's boxes).
// - Staging: each chunk is read from sp0 and sp1 as they are, so the
//   wrapper prepares nothing but the boxes.  Each thread loads its
//   segments of chunk k + 1 into registers (SegmentStage) while chunk k is
//   computed, and writes them into the one shared buffer as K9's float4
//   (x, y, dx = x1 - x0, dy = y1 - y0) at step k + 1, after the barrier
//   that ends step k.  The float32 subtraction is the one the plain
//   version and K9's table make, bit for bit.
//
// What bounds it: FP32 arithmetic on the admitted pairs (14 operations
// each, as in K5), plus one slab test per ray and chunk.  After the first
// bounce most rays have a near best hit or are parked, so most (ray,
// chunk) pairs are skipped; on a Morton-sorted scene a chunk is a compact
// stretch of wall, so its box is small.
//
// The float64 instance (segment_search_culled_launch_f64), simpler: K3's
// float64 design (search2d::f64::walk).  Each thread keeps its ray and
// running best in registers (no ray slots, so the best's index needs no
// packing into a float) and gates its own ray on the chunk's float64 box
// (twolevel_boxes in float64, GATE_PAD kept); the block stages the chunk
// from sp0 and sp1 (start and direction as double2, 8 KB) when one of its
// rays passes, and each ray that passed folds the whole chunk with K5's
// float64 pair (search2d::f64::fold_segment), so K7 equals K5's float64
// instance bit for bit.  What bounds it: FP64 issue slots on the admitted
// pairs and the warps' idle lanes.

#include <cuda_runtime.h>

#include "search2d_common.cuh"

namespace {

using search2d::kTile;

constexpr int kMaxThreads = 1024;
// two blocks of kMaxThreads an SM: 32 registers a thread, so that a full
// SM of 2048 threads fits at every ray block.  Left free, ptxas takes 45-49
// for the listed walk and the fold, which leaves 5 of 8 blocks of 256 an SM
// and cost K7 and K9 5% on the H100; the bound spills 4-44 bytes.
constexpr int kMinBlocks = 2;
// the fewest rays a block: SegmentStage holds kPer segments a thread
constexpr int kPer = 2;
constexpr int kMinThreads = kTile / kPer;

// shared memory: one chunk buffer, a float4 and a float2 a ray, the list,
// two arrays of the warps' counts (under 48 KB up to kMaxThreads rays)
size_t shared_bytes(int ray_block) {
  return sizeof(float4) * (kTile + ray_block) + sizeof(float2) * ray_block +
         sizeof(int) * (ray_block + 2 * 32);
}

// walk_listed's stage for segments read from sp0 and sp1 ((m, 2) float32
// row-major): thread i holds segments i and i + blockDim.x of the next
// chunk, zero past m.  One buffer is enough: land(k) writes it after the
// barrier that ends step k - 1, the last to read it.
struct SegmentStage {
  float4* buf;
  const float* __restrict__ sp0;
  const float* __restrict__ sp1;
  int m;
  float2 a[kPer], b[kPer];

  __device__ __forceinline__ void start(int c) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = c * kTile + threadIdx.x + i * blockDim.x;
      const bool in = threadIdx.x + i * blockDim.x < kTile && s < m;
      a[i] = b[i] = make_float2(0.f, 0.f);
      if (in) {
        a[i] = make_float2(sp0[2 * s], sp0[2 * s + 1]);
        b[i] = make_float2(sp1[2 * s], sp1[2 * s + 1]);
      }
    }
  }
  __device__ __forceinline__ const float4* land(int, int next) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = threadIdx.x + i * blockDim.x;
      if (t < kTile)
        buf[t] = make_float4(a[i].x, a[i].y, b[i].x - a[i].x, b[i].y - a[i].y);
    }
    if (next >= 0) start(next);
    return buf;
  }
};

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
segment_search_culled_kernel(const float* __restrict__ p0,
                             const float* __restrict__ p1,
                             const float* __restrict__ sp0,
                             const float* __restrict__ sp1,
                             const float* __restrict__ aabb, int n, int m,
                             const reject::Limits lim,
                             float slack_hi, float slack_lo, float slack,
                             float* __restrict__ u_out,
                             int* __restrict__ idx_out) {
  extern __shared__ float4 smem[];
  float4* buf = smem;                                        // 1 chunk
  float4* ray_a = buf + kTile;                               // ox oy dx dy
  float2* ray_b = reinterpret_cast<float2*>(ray_a + blockDim.x);  // u, idx
  int* list = reinterpret_cast<int*>(ray_b + blockDim.x);
  int* warp_count = list + blockDim.x;                       // 2 x 32

  const int me = threadIdx.x;
  const int ray = blockIdx.x * blockDim.x + me;
  const bool live = ray < n;
  const search2d::Ray r = search2d::load_ray(p0, p1, ray, live);
  search2d::put_ray(ray_a, ray_b, r);

  SegmentStage stage{buf, sp0, sp1, m};
  search2d::walk_listed(
      (m + kTile - 1) / kTile, [](int k) { return k; }, stage, aabb, r, live,
      lim.r_eps, slack_hi, slack_lo, slack, ray_b[me].x, list, warp_count,
      [&](const float4* tile, int c, int total) {
        const int base = c * kTile;
        search2d::fold_listed_segments(tile, min(kTile, m - base), base,
                                       total, list, ray_a, ray_b, lim);
      });

  // every best was written before a barrier this thread has passed
  if (live) {
    u_out[ray] = ray_b[me].x;
    idx_out[ray] = __float_as_int(ray_b[me].y);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
segment_search_culled_f64_kernel(const double* __restrict__ p0,
                                 const double* __restrict__ p1,
                                 const double* __restrict__ sp0,
                                 const double* __restrict__ sp1,
                                 const double* __restrict__ aabb, int n,
                                 int m, const search2d::f64::Limits lim,
                                 double slack_hi, double slack_lo,
                                 double slack, double* __restrict__ u_out,
                                 int* __restrict__ idx_out) {
  __shared__ double2 start[kTile], dir[kTile];  // 8 KB

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = ray < n;
  const search2d::f64::Ray r = search2d::f64::load_ray(p0, p1, ray, live);
  double best_u = search2d::f64::kBig;
  int best_idx = 0;

  search2d::f64::walk(
      (m + kTile - 1) / kTile, [](int k) { return k; }, aabb, r, live,
      lim.r_eps, slack_hi, slack_lo, slack, best_u,
      [&](int c) {
        const int base = c * kTile, count = min(kTile, m - base);
        for (int t = threadIdx.x; t < count; t += blockDim.x) {
          const int g = 2 * (base + t);
          const double x = sp0[g + 0], y = sp0[g + 1];
          start[t] = make_double2(x, y);
          dir[t] = make_double2(sp1[g + 0] - x, sp1[g + 1] - y);
        }
      },
      [&](int c) {
        const int base = c * kTile, count = min(kTile, m - base);
        for (int t = 0; t < count; ++t)
          search2d::f64::fold_segment(start[t], dir[t], base + t, r, lim,
                                      best_u, best_idx);
      });
  if (live) {
    u_out[ray] = best_u;
    idx_out[ray] = best_idx;
  }
}

}  // namespace

// K5's arguments plus aabb: (ceil(m / chunk), 4) float32, where chunk must
// be the kernel's tile of 256 segments, and ray_block, a multiple of 32 in
// [128, 1024] (else the launch returns cudaErrorInvalidValue); the gate's
// slack (1 + 1e-6, 1 - 1e-6, 1e-6) as the float32 values the plain version
// uses.  Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
extern "C" int segment_search_culled_launch(
    const float* p0, const float* p1, const float* sp0, const float* sp1,
    const float* aabb, int n, int m, int chunk, int ray_block, float i_eps,
    float s_lo, float s_hi, float r_eps, float slack_hi, float slack_lo,
    float slack, float* u_out, int* idx_out, void* stream) {
  if (chunk != kTile || ray_block % 32 != 0 || ray_block < kMinThreads ||
      ray_block > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + ray_block - 1) / ray_block;
  segment_search_culled_kernel<<<blocks, ray_block, shared_bytes(ray_block),
                                 static_cast<cudaStream_t>(stream)>>>(
      p0, p1, sp0, sp1, aabb, n, m, reject::limits(i_eps, s_lo, s_hi, r_eps),
      slack_hi, slack_lo, slack, u_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}

// The float64 instance: every pointer float64 but idx_out (int32), the
// thresholds and slack as the float64 values the plain version compares
// with; chunk and ray_block as above.
extern "C" int segment_search_culled_launch_f64(
    const double* p0, const double* p1, const double* sp0, const double* sp1,
    const double* aabb, int n, int m, int chunk, int ray_block, double i_eps,
    double s_lo, double s_hi, double r_eps, double slack_hi, double slack_lo,
    double slack, double* u_out, int* idx_out, void* stream) {
  if (chunk != kTile || ray_block % 32 != 0 || ray_block < kMinThreads ||
      ray_block > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + ray_block - 1) / ray_block;
  segment_search_culled_f64_kernel<<<blocks, ray_block, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      p0, p1, sp0, sp1, aabb, n, m,
      search2d::f64::Limits{i_eps, s_lo, s_hi, r_eps}, slack_hi, slack_lo,
      slack, u_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
