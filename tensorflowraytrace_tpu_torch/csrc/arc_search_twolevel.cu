// Two-level nearest ray-arc hit search (K10), float32 and float64, for
// sm_90a.
//
// Replaces: tensorflowraytrace_tpu/ops/pallas_kernels.py,
// _twolevel_arc_kernel (launched through _nearest_hit_arcs_twolevel_impl /
// nearest_hit_arcs_pallas with cull="grid").
//
// What it computes: exactly what arc_search.cu (K6) computes, with K6's
// pair test (search2d::ArcPair), so valid, idx, u and branch equal K6's
// bit for bit.  Two departures from the TPU kernel follow from that, as
// in K6 and K8: the discriminant is evaluated as 4 (a - (x_r x d_r)^2),
// not b^2 - 4 a c, which is float32 noise for rays thousands of radii from
// the 2D guide's lenslets (the note in search2d_common.cuh); and each arc
// carries its own branch choice into the running best, where the TPU kernel
// took the branch of the tile's minima (they differ only at exact ties).
//
// The design, K9's (segment_search_twolevel.cu) for arcs:
// - One block per ray block (blockDim.x rays, one a thread), each walking
//   its own candidate list of chunks of search2d::kTile = 256 arcs, or
//   every chunk when its list overflowed the cap
//   (search2d::twolevel_walk_listed); chunk k + 1 is copied with cp.async
//   into the second of two shared buffers while chunk k is computed
//   (search2d::CopyStage, one search2d::ArcTile, 8 KB, a chunk).
// - K9's compaction (compaction.cuh): each thread slab-tests its own ray
//   against the chunk's box and its running best, the rays that pass are
//   listed, and the whole block computes only those, `group` threads a
//   listed ray, each running K6's reject on every group-th arc and the
//   exact arithmetic only past it (search2d::fold_listed_arcs).  The
//   group's shuffle reduces (u, 2 idx + minus branch), so the smaller idx
//   wins at equal u and its branch travels with it.  The plain version
//   gates ray by ray to match.
// - The ragged last chunk is computed for its real arcs only.
//
// The boxes.  A ray's own gate decides, so each chunk's box must hold
// every point the pair test accepts.  An accepted point lies on the ray at
// the root u the pair computes, inside the arc's window (in_window tests
// the point itself), at a distance from the centre that two effects can
// move off |r|:
// - The tangent snap: a discriminant |disc| < i_eps is taken as 0, and
//   the root is then the line's closest point to the centre, at distance
//   D.  With a = |d|^2 / r^2, disc = 4 a (1 - D^2 / r^2), so a snapped
//   pair has |1 - D^2 / r^2| < i_eps / (4 a) <= 1 / 4, since a pair needs
//   a >= i_eps: the point lies up to |r| (1 - sqrt(3 / 4)) = 0.134 |r|
//   inside the circle or |r| (sqrt(5 / 4) - 1) = 0.118 |r| outside it,
//   whatever i_eps.  Short rays (|d| near sqrt(i_eps) |r|) reach that; the
//   2D guide's (a ~ 1e5) do not.  A point of the window's sector within
//   0.134 |r| of the circle is within 0.134 |r| of the arc's window-aware
//   box along each axis.  Without the snap the roots lie on the circle up
//   to rounding (below 1e-6 |r| radially, also near the tangent).
// - Float32 rounding of the root and of the point: a few units in the last
//   place of the coordinates, which the rounding margin (2^-17 of the
//   box's largest coordinate magnitude, ops/triangle_kernels.GATE_PAD) and
//   the gate's slack (1e-6 of the ray parameter) cover: on the full-width
//   guide a ray from the exit face hit a lenslet 3.6e-7 outside its
//   chunk's raw box.
// So the boxes are the chunks' boxes over the arcs' window-aware boxes
// (models/acceleration.py chunk_aabbs_arcs) widened by 0.14 of the
// chunk's largest |r| (ops/arc_kernels.SNAP_REACH) and the rounding margin
// (ops/arc_kernels.twolevel_boxes).
// The lists are built on the same boxes.
//
// Inputs, prepared by the wrapper (ops/arc_kernels.py) on the card:
// - the arc table chunk-major, (C, 2, 256, 4) 4-byte words, one
//   search2d::ArcTile per chunk: 256 rows of (centre x, centre y,
//   1 / radius, the window flags as int32 bits), then 256 rows of (cos and
//   sin of the window's start and end), zero past m;
// - the boxes above, (C, 4) float32;
// - counts and cand from twolevel_candidates on those boxes.  A block of
//   parked rays has no candidate.
//
// Left out from the TPU kernel: the ray-axis slabbing (_slab_ray_axis), its
// 1024-ray blocks, the (16, M) layout and its dead padding column.
//
// What bounds it: FP32 arithmetic on the admitted pairs (K6's pair test,
// 15 operations for a pair its exact reject refuses, 50 for the rest; the
// bound K8 has, at the same 256-arc chunks), plus one slab test per ray and
// candidate chunk and the candidate precompute outside the kernel.
//
// The float64 instance (arc_search_twolevel_launch_f64): K9's float64 walk
// (search2d::f64::twolevel_walk: a thread a ray, its best in registers, a
// chunk staged when one of the block's rays passes) over the same lists on
// the float64 boxes.  Its table is the float64 chunk-major table of the
// same layout, (C, 2, 256, 4) doubles, the flags as int64 bits in their
// float64 slot (arc_kernels.twolevel_table); each chunk is staged into
// search2d::f64::ArcTile (15 KB; the rays stay in registers, so the
// shared memory does not grow with the ray block, and the ray block keeps
// the float32 instance's limit) and folded with K6's float64 pair
// (search2d::f64::fold_arc), so K10 equals K6's float64 instance bit for
// bit, branch included.

#include <cuda_runtime.h>

#include "search2d_common.cuh"

namespace {

// The most rays a block may hold: its shared memory stays under 48 KB.
constexpr int kMaxThreads = 512;
constexpr int kVecs = sizeof(search2d::ArcTile) / sizeof(float4);  // 512

// shared memory: two chunk buffers, a float4 and a float2 a ray, the list,
// two arrays of the warps' counts
size_t shared_bytes(int ray_block) {
  return sizeof(float4) * (2 * kVecs + ray_block) +
         sizeof(float2) * ray_block + sizeof(int) * (ray_block + 2 * 32);
}

__global__ void __launch_bounds__(kMaxThreads)
arc_search_twolevel_kernel(const float* __restrict__ p0,
                           const float* __restrict__ p1,
                           const float4* __restrict__ table,
                           const float* __restrict__ aabb,
                           const int* __restrict__ counts,
                           const int* __restrict__ cand, int n, int m,
                           int n_chunks, int max_cand, float i_eps,
                           float r_eps, float slack_hi, float slack_lo,
                           float slack, float* __restrict__ u_out,
                           int* __restrict__ idx_out,
                           unsigned char* __restrict__ branch_out) {
  extern __shared__ float4 smem[];
  float4* buf = smem;                                        // 2 chunks
  float4* ray_a = buf + 2 * kVecs;                           // ox oy dx dy
  float2* ray_b = reinterpret_cast<float2*>(ray_a + blockDim.x);  // u, key
  int* list = reinterpret_cast<int*>(ray_b + blockDim.x);
  int* warp_count = list + blockDim.x;                       // 2 x 32

  const int me = threadIdx.x;
  const int ray = blockIdx.x * blockDim.x + me;
  const bool live = ray < n;
  const search2d::Ray r = search2d::load_ray(p0, p1, ray, live);
  search2d::put_ray(ray_a, ray_b, r);

  search2d::CopyStage<kVecs> stage{buf, table};
  search2d::twolevel_walk_listed(
      stage, aabb, counts, cand, n_chunks, max_cand, r, live, r_eps,
      slack_hi, slack_lo, slack, ray_b[me].x, list, warp_count,
      [&](const float4* tile, int c, int total) {
        const int base = c * search2d::kTile;
        search2d::fold_listed_arcs(
            *reinterpret_cast<const search2d::ArcTile*>(tile),
            min(search2d::kTile, m - base), base, total, list, ray_a, ray_b,
            i_eps, r_eps);
      });

  // every best was written before a barrier this thread has passed
  if (live) {
    const int key = __float_as_int(ray_b[me].y);
    u_out[ray] = ray_b[me].x;
    idx_out[ray] = key >> 1;
    branch_out[ray] = key & 1;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
arc_search_twolevel_f64_kernel(const double* __restrict__ p0,
                               const double* __restrict__ p1,
                               const double* __restrict__ table,
                               const double* __restrict__ aabb,
                               const int* __restrict__ counts,
                               const int* __restrict__ cand, int n, int m,
                               int n_chunks, int max_cand,
                               const search2d::f64::Limits lim,
                               double slack_hi, double slack_lo, double slack,
                               double* __restrict__ u_out,
                               int* __restrict__ idx_out,
                               unsigned char* __restrict__ branch_out) {
  constexpr int kTile = search2d::kTile;
  __shared__ search2d::f64::ArcTile tile;  // 15 KB

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = ray < n;
  const search2d::f64::Ray r = search2d::f64::load_ray(p0, p1, ray, live);
  double best_u = search2d::f64::kBig;
  int best_idx = 0;
  bool best_minus = false;

  search2d::f64::twolevel_walk(
      aabb, counts, cand, n_chunks, max_cand, r, live, lim.r_eps, slack_hi,
      slack_lo, slack, best_u,
      [&](int c) {
        const double* head = table + static_cast<size_t>(c) * 2 * kTile * 4;
        const double* edge = head + kTile * 4;
        for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
          tile.centre[t] = make_double2(head[4 * t + 0], head[4 * t + 1]);
          tile.inv_r[t] = head[4 * t + 2];
          tile.flags[t] =
              static_cast<int>(__double_as_longlong(head[4 * t + 3]));
          tile.start[t] = make_double2(edge[4 * t + 0], edge[4 * t + 1]);
          tile.end[t] = make_double2(edge[4 * t + 2], edge[4 * t + 3]);
        }
      },
      [&](int c) {
        const int base = c * kTile, count = min(kTile, m - base);
        for (int t = 0; t < count; ++t)
          search2d::f64::fold_arc(tile, t, base + t, r, lim, best_u, best_idx,
                                  best_minus);
      });
  if (live) {
    u_out[ray] = best_u;
    idx_out[ray] = best_idx;
    branch_out[ray] = best_minus ? 1 : 0;
  }
}

}  // namespace

// p0, p1: (n, 2) float32; table: (n_chunks, 2, fine, 4) 4-byte words, 16-byte
// aligned, where fine must be the kernel's tile of 256 (else the launch
// returns cudaErrorInvalidValue); aabb: (n_chunks, 4) float32; counts,
// cand and ray_block as in segment_search_twolevel_launch; thresholds and
// slack as in arc_search_culled_launch.  u_out: (n,) float32, idx_out: (n,)
// int32, branch_out: (n,) bool.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int arc_search_twolevel_launch(
    const float* p0, const float* p1, const float* table, const float* aabb,
    const int* counts, const int* cand, int n, int m, int n_chunks, int fine,
    int ray_block, int max_cand, float i_eps, float r_eps, float slack_hi,
    float slack_lo, float slack, float* u_out, int* idx_out,
    unsigned char* branch_out, void* stream) {
  if (fine != search2d::kTile || ray_block % 32 != 0 || ray_block < 32 ||
      ray_block > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + ray_block - 1) / ray_block;
  arc_search_twolevel_kernel<<<blocks, ray_block, shared_bytes(ray_block),
                               static_cast<cudaStream_t>(stream)>>>(
      p0, p1, reinterpret_cast<const float4*>(table), aabb, counts, cand, n,
      m, n_chunks, max_cand, i_eps, r_eps, slack_hi, slack_lo, slack, u_out,
      idx_out, branch_out);
  return static_cast<int>(cudaGetLastError());
}

// The float64 instance: p0, p1, table ((n_chunks, 2, fine, 4) doubles, the
// flags as int64 bits), aabb and u_out float64, i_eps, r_eps and the slack
// the float64 values the plain version compares with; counts, cand, fine
// and ray_block as above.
extern "C" int arc_search_twolevel_launch_f64(
    const double* p0, const double* p1, const double* table,
    const double* aabb, const int* counts, const int* cand, int n, int m,
    int n_chunks, int fine, int ray_block, int max_cand, double i_eps,
    double r_eps, double slack_hi, double slack_lo, double slack,
    double* u_out, int* idx_out, unsigned char* branch_out, void* stream) {
  if (fine != search2d::kTile || ray_block % 32 != 0 || ray_block < 32 ||
      ray_block > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + ray_block - 1) / ray_block;
  arc_search_twolevel_f64_kernel<<<blocks, ray_block, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      p0, p1, table, aabb, counts, cand, n, m, n_chunks, max_cand,
      search2d::f64::Limits{i_eps, 0.0, 0.0, r_eps}, slack_hi, slack_lo,
      slack, u_out, idx_out, branch_out);
  return static_cast<int>(cudaGetLastError());
}
