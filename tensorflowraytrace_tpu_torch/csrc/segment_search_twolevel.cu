// Two-level nearest ray-segment hit search (K9), float32 and float64, for
// sm_90a.
//
// Replaces: tensorflowraytrace_tpu/ops/pallas_kernels.py,
// _twolevel_segment_kernel (launched through
// _nearest_hit_segments_twolevel_impl / nearest_hit_segments_pallas with
// cull="grid").
//
// What it computes: exactly what segment_search.cu (K5) computes, with K5's
// pair test (search2d::SegmentPair), so valid, idx and u equal K5's
// bit for bit.  It only skips pairs that cannot give a nearer hit.
//
// The design, K4's (triangle_search_twolevel.cu) for segments:
// - The grid: one block per ray block (blockDim.x rays, one a thread), each
//   walking its own candidate list of fine chunks, or every chunk when its
//   list overflowed the cap (search2d::twolevel_walk_listed).  The fine
//   chunk is the 2D kernels' tile (search2d::kTile = 256 segments, also the
//   JAX package's FINE_CHUNK).
// - Staging: chunk k + 1 is copied with cp.async into the second of two
//   shared buffers while chunk k is computed.  A segment is one float4 (x,
//   y, dx, dy), so a pair costs one 128-bit shared load.
// - K3's compaction (compaction.cuh): before computing chunk k each thread
//   slab-tests its own ray against the chunk's box and its running best
//   (K7's test, search2d::slab_gate); a ballot and a scan list the rays
//   that pass, and the whole block computes only those, `group` threads a
//   listed ray, each folding every group-th segment with K5's pair test
//   (search2d::SegmentPair), then a shuffle takes the group's smallest (u,
//   idx), the smaller idx at equal u (search2d::fold_listed_segments).  A
//   chunk then costs in proportion to the rays that need it, not to the
//   warps that hold one, and a chunk no ray needs costs one gate and one
//   barrier.  The plain version gates ray by ray to match.
// - The ragged last chunk is computed for its real segments only.
//
// Inputs, prepared by the wrapper (ops/segment_kernels.py) on the card:
// - the segment table chunk-major, (C, 256, 4) float32: chunk c holds
//   segments 256 c .. 256 c + 255 as float4 (start x, start y, direction x,
//   direction y = sp1 - sp0), zero past m;
// - the chunk boxes, (C, 4) float32 (models/acceleration.py chunk_aabbs_2d,
//   widened by ops/segment_kernels.twolevel_boxes: each ray's own gate
//   decides, so each box must hold every point the pair test accepts,
//   size_eps of a side beyond a segment's box, and the gate boxes' rounding
//   margin);
// - counts (nb,) int32 and cand (nb * max_cand,) int32 from
//   twolevel_candidates on those same boxes: a chunk is a candidate of a
//   block when some ray of the block can hit its box at all.  Parked rays
//   (p0 = 1e30) can hit no box, so a block of parked rays has no candidate
//   and writes u = 3e38.
//
// Left out from the TPU kernel: the ray-axis slabbing that kept the
// candidate table inside SMEM (_slab_ray_axis), its 1024-ray blocks and the
// (8, N) / (8, M) layouts.
//
// What bounds it: FP32 arithmetic on the admitted pairs (14 operations each,
// as in K5; the bound K7 has, at the same 256-segment chunks), plus one
// slab test per ray and candidate chunk and the candidate precompute
// outside the kernel.
//
// The float64 instance (segment_search_twolevel_launch_f64): the same
// candidate lists (twolevel_candidates on the float64 boxes), walked as
// K7's float64 instance walks every chunk (search2d::f64::twolevel_walk:
// a thread a ray, its best in registers, a chunk staged when one of the
// block's rays passes, no compaction), each chunk staged from the float64
// table (C, 256, 4) as start and direction double2 (8 KB) and folded with
// K5's float64 pair, so K9 equals K5's float64 instance bit for bit.

#include <cuda_runtime.h>

#include "search2d_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
// two blocks of kMaxThreads an SM: 32 registers a thread, so that a full
// SM of 2048 threads fits at every ray block.  Left free, ptxas takes 45-49
// for the listed walk and the fold, which leaves 5 of 8 blocks of 256 an SM
// and cost K7 and K9 5% on the H100; the bound spills 4-44 bytes.
constexpr int kMinBlocks = 2;

// shared memory: two chunk buffers, a float4 and a float2 a ray, the list,
// two arrays of the warps' counts (under 48 KB up to kMaxThreads rays)
size_t shared_bytes(int ray_block) {
  return sizeof(float4) * (2 * search2d::kTile + ray_block) +
         sizeof(float2) * ray_block + sizeof(int) * (ray_block + 2 * 32);
}

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
segment_search_twolevel_kernel(const float* __restrict__ p0,
                               const float* __restrict__ p1,
                               const float4* __restrict__ table,
                               const float* __restrict__ aabb,
                               const int* __restrict__ counts,
                               const int* __restrict__ cand, int n, int m,
                               int n_chunks, int max_cand,
                               const reject::Limits lim,
                               float slack_hi, float slack_lo, float slack,
                               float* __restrict__ u_out,
                               int* __restrict__ idx_out) {
  constexpr int kVecs = search2d::kTile;  // float4 of one chunk
  extern __shared__ float4 smem[];
  float4* buf = smem;                                        // 2 chunks
  float4* ray_a = buf + 2 * kVecs;                           // ox oy dx dy
  float2* ray_b = reinterpret_cast<float2*>(ray_a + blockDim.x);  // u, idx
  int* list = reinterpret_cast<int*>(ray_b + blockDim.x);
  int* warp_count = list + blockDim.x;                       // 2 x 32

  const int me = threadIdx.x;
  const int ray = blockIdx.x * blockDim.x + me;
  const bool live = ray < n;
  const search2d::Ray r = search2d::load_ray(p0, p1, ray, live);
  search2d::put_ray(ray_a, ray_b, r);

  search2d::CopyStage<kVecs> stage{buf, table};
  search2d::twolevel_walk_listed(
      stage, aabb, counts, cand, n_chunks, max_cand, r, live, lim.r_eps,
      slack_hi, slack_lo, slack, ray_b[me].x, list, warp_count,
      [&](const float4* tile, int c, int total) {
        const int base = c * search2d::kTile;
        search2d::fold_listed_segments(tile, min(search2d::kTile, m - base),
                                       base, total, list, ray_a, ray_b, lim);
      });

  // every best was written before a barrier this thread has passed
  if (live) {
    u_out[ray] = ray_b[me].x;
    idx_out[ray] = __float_as_int(ray_b[me].y);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
segment_search_twolevel_f64_kernel(const double* __restrict__ p0,
                                   const double* __restrict__ p1,
                                   const double* __restrict__ table,
                                   const double* __restrict__ aabb,
                                   const int* __restrict__ counts,
                                   const int* __restrict__ cand, int n,
                                   int m, int n_chunks, int max_cand,
                                   const search2d::f64::Limits lim,
                                   double slack_hi, double slack_lo,
                                   double slack, double* __restrict__ u_out,
                                   int* __restrict__ idx_out) {
  constexpr int kTile = search2d::kTile;
  __shared__ double2 start[kTile], dir[kTile];  // 8 KB

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = ray < n;
  const search2d::f64::Ray r = search2d::f64::load_ray(p0, p1, ray, live);
  double best_u = search2d::f64::kBig;
  int best_idx = 0;

  search2d::f64::twolevel_walk(
      aabb, counts, cand, n_chunks, max_cand, r, live, lim.r_eps, slack_hi,
      slack_lo, slack, best_u,
      [&](int c) {
        const double* rows = table + static_cast<size_t>(c) * kTile * 4;
        for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
          start[t] = make_double2(rows[4 * t + 0], rows[4 * t + 1]);
          dir[t] = make_double2(rows[4 * t + 2], rows[4 * t + 3]);
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

// p0, p1: (n, 2) float32; table: (n_chunks, fine, 4) float32, 16-byte
// aligned, where fine must be the kernel's tile of 256 (else the launch
// returns cudaErrorInvalidValue); aabb: (n_chunks, 4) float32; counts:
// (ceil(n / ray_block),) int32; cand: (blocks * max_cand,) int32; ray_block
// a multiple of 32 in [32, 1024] (else cudaErrorInvalidValue).  Thresholds
// and slack as in segment_search_culled_launch.  u_out: (n,) float32,
// idx_out: (n,) int32.  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int segment_search_twolevel_launch(
    const float* p0, const float* p1, const float* table, const float* aabb,
    const int* counts, const int* cand, int n, int m, int n_chunks, int fine,
    int ray_block, int max_cand, float i_eps, float s_lo, float s_hi,
    float r_eps, float slack_hi, float slack_lo, float slack, float* u_out,
    int* idx_out, void* stream) {
  if (fine != search2d::kTile || ray_block % 32 != 0 || ray_block < 32 ||
      ray_block > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + ray_block - 1) / ray_block;
  segment_search_twolevel_kernel<<<blocks, ray_block, shared_bytes(ray_block),
                                   static_cast<cudaStream_t>(stream)>>>(
      p0, p1, reinterpret_cast<const float4*>(table), aabb, counts, cand, n,
      m, n_chunks, max_cand, reject::limits(i_eps, s_lo, s_hi, r_eps),
      slack_hi, slack_lo, slack, u_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}

// The float64 instance: p0, p1, table, aabb and u_out float64 (the table
// and boxes as segment_kernels.twolevel_prepare makes them in float64),
// the thresholds and slack the float64 values the plain version compares
// with; counts, cand, fine and ray_block as above.
extern "C" int segment_search_twolevel_launch_f64(
    const double* p0, const double* p1, const double* table,
    const double* aabb, const int* counts, const int* cand, int n, int m,
    int n_chunks, int fine, int ray_block, int max_cand, double i_eps,
    double s_lo, double s_hi, double r_eps, double slack_hi, double slack_lo,
    double slack, double* u_out, int* idx_out, void* stream) {
  if (fine != search2d::kTile || ray_block % 32 != 0 || ray_block < 32 ||
      ray_block > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + ray_block - 1) / ray_block;
  segment_search_twolevel_f64_kernel<<<blocks, ray_block, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      p0, p1, table, aabb, counts, cand, n, m, n_chunks, max_cand,
      search2d::f64::Limits{i_eps, s_lo, s_hi, r_eps}, slack_hi, slack_lo,
      slack, u_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
