// What the 2D nearest-hit searches share: the ray load, the 2D slab gate,
// the staging and per-tile search of segments (K5 segment_search.cu, K7
// segment_search_culled.cu, K9 segment_search_twolevel.cu) and of arcs (K6
// arc_search.cu, K8 arc_search_culled.cu, K10 arc_search_twolevel.cu), and
// the two-level walk of K9 and K10.
//
// Every kernel runs one thread per ray, kThreads rays per block, and walks
// the surfaces in tiles of kTile staged in shared memory as
// structure-of-arrays rows, read as broadcasts.  A surface replaces the
// ray's running best only under strict <, so a tie keeps the first index.
// The arithmetic is the plain versions' (ops/segment_kernels.py,
// ops/arc_kernels.py): the same float32 operations in the same order, built
// with --fmad=false and without fast math, so that sqrtf and every division
// are IEEE and kernel and plain version agree bit for bit.  The culled
// kernels run the brute kernels' tile search and only skip tiles, so they
// return the brute kernels' hits bit for bit.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace search2d {

constexpr int kThreads = 256;     // rays per block, one per thread
constexpr int kTile = 256;        // surfaces per tile = culling chunk
constexpr float kBig = 3.0e38f;   // no-hit sentinel (u < 1.5e38 means a hit)
constexpr float kTiny = 1.0e-30f;

// One ray: origin, direction p1 - p0 and the slab test's inverse direction
// (|d| < 1e-30 replaced by +-1e-30).  Rays past n stay zero.
struct Ray {
  float ox, oy, dx, dy, ix, iy;
};

__device__ __forceinline__ float safe_inverse(float d) {
  return 1.0f / (fabsf(d) < kTiny ? (d < 0.0f ? -kTiny : kTiny) : d);
}

// p0, p1: (n, 2) float32 row-major
__device__ __forceinline__ Ray load_ray(const float* __restrict__ p0,
                                        const float* __restrict__ p1,
                                        int ray, bool live) {
  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    r.ox = p0[2 * ray + 0];
    r.oy = p0[2 * ray + 1];
    r.dx = p1[2 * ray + 0] - r.ox;
    r.dy = p1[2 * ray + 1] - r.oy;
  }
  r.ix = safe_inverse(r.dx);
  r.iy = safe_inverse(r.dy);
  return r;
}

// The slab test of one ray against one chunk box (min xy, max xy): with
// t1 = (lo - o) inv, t2 = (hi - o) inv, tmin = max over axes of
// min(t1, t2) and tmax = min over axes of max(t1, t2), the ray needs the
// chunk iff
//   tmax (1 + 1e-6) + 1e-6 >= max(tmin, r_eps)   (it can hit the box) and
//   tmin (1 - 1e-6) - 1e-6 <= best_u             (no farther than its best).
// The box holds every surface of the chunk, so a ray that fails cannot find
// a nearer hit there.  Parked rays (p0 = 1e30) fail it.
__device__ __forceinline__ bool slab_gate(const float* __restrict__ box,
                                          const Ray& r, float r_eps,
                                          float slack_hi, float slack_lo,
                                          float slack, float best_u) {
  float t1 = (box[0] - r.ox) * r.ix, t2 = (box[2] - r.ox) * r.ix;
  float tmin = fminf(t1, t2), tmax = fmaxf(t1, t2);
  t1 = (box[1] - r.oy) * r.iy;
  t2 = (box[3] - r.oy) * r.iy;
  tmin = fmaxf(tmin, fminf(t1, t2));
  tmax = fminf(tmax, fmaxf(t1, t2));
  return (tmax * slack_hi + slack >= fmaxf(tmin, r_eps)) &&
         (tmin * slack_lo - slack <= best_u);
}

// ---------------------------------------------------------------- segments

// One tile of segments as K9 stages it whole from its chunk-major table
// (ops/segment_kernels.segment_chunk_table): the rows of stage_segments.
struct SegmentTile {
  float row[4][kTile];
};

// Segments base .. base + count - 1 of sp0, sp1 ((m, 2) float32 row-major)
// into the tile's rows: start x, start y, direction x, direction y.
__device__ __forceinline__ void stage_segments(float (*tile)[kTile],
                                               const float* __restrict__ sp0,
                                               const float* __restrict__ sp1,
                                               int base, int count) {
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int g = 2 * (base + t);
    const float x = sp0[g + 0], y = sp0[g + 1];
    tile[0][t] = x;
    tile[1][t] = y;
    tile[2][t] = sp1[g + 0] - x;
    tile[3][t] = sp1[g + 1] - y;
  }
}

// The nearest valid segment of a staged tile, folded into the running best:
//   den = dx1 dy2 - dy1 dx2, valid only when |den| >= i_eps,
//   inv = 1 / (ok ? den : 1),
//   ray_u = (dx2 (y1 - y2) - dy2 (x1 - x2)) inv,
//   seg_u = (dy1 (x2 - x1) - dx1 (y2 - y1)) inv,
//   valid when s_lo <= seg_u <= s_hi and ray_u >= r_eps.
__device__ __forceinline__ void search_segments(const float (*tile)[kTile],
                                                int count, int base,
                                                const Ray& r, float i_eps,
                                                float s_lo, float s_hi,
                                                float r_eps, float& best_u,
                                                int& best_idx) {
  for (int t = 0; t < count; ++t) {
    const float x2 = tile[0][t], y2 = tile[1][t];
    const float dx2 = tile[2][t], dy2 = tile[3][t];
    const float den = r.dx * dy2 - r.dy * dx2;
    bool ok = fabsf(den) >= i_eps;
    const float inv = 1.0f / (ok ? den : 1.0f);
    const float u = (dx2 * (r.oy - y2) - dy2 * (r.ox - x2)) * inv;
    const float s = (r.dy * (x2 - r.ox) - r.dx * (y2 - r.oy)) * inv;
    ok = ok && (s >= s_lo) && (s <= s_hi) && (u >= r_eps);
    if (ok && u < best_u) {
      best_u = u;
      best_idx = base + t;
    }
  }
}

// -------------------------------------------------------------------- arcs

// The arc table: (m, 8) float32 row-major, one row per arc, built by
// ops/arc_kernels.arc_table: centre x, centre y, radius, cos and sin of the
// window's start, cos and sin of its end, flags (1: the window spans more
// than pi, 2: a full circle).
constexpr int kArcCols = 8;

// K10 stages an ArcTile whole from its chunk-major table
// (ops/arc_kernels.arc_chunk_table), whose eighth row holds the flags' int32
// bits: the layout is 8 rows of kTile 4-byte words.
struct ArcTile {
  float xc[kTile], yc[kTile], inv_r[kTile];
  float sx[kTile], sy[kTile], ex[kTile], ey[kTile];
  int flags[kTile];
};

__device__ __forceinline__ void stage_arcs(ArcTile& tile,
                                           const float* __restrict__ table,
                                           int base, int count) {
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const float* row = table + kArcCols * (base + t);
    tile.xc[t] = row[0];
    tile.yc[t] = row[1];
    tile.inv_r[t] = 1.0f / row[2];
    tile.sx[t] = row[3];
    tile.sy[t] = row[4];
    tile.ex[t] = row[5];
    tile.ey[t] = row[6];
    tile.flags[t] = static_cast<int>(row[7]);
  }
}

// Is the hit at ray parameter u a valid hit of arc t?  The window test is
// the TPU kernel's cross-product form: with p the hit relative to the
// centre, c1 = cross(start edge, p) and c2 = cross(p, end edge); a window
// of at most pi needs c1 >= 0 and c2 >= 0, a wider one only not both < 0,
// a full circle nothing.
__device__ __forceinline__ bool arc_branch_valid(const ArcTile& tile, int t,
                                                 const Ray& r, float u,
                                                 bool ok, float r_eps) {
  const float px = (r.ox + r.dx * u) - tile.xc[t];
  const float py = (r.oy + r.dy * u) - tile.yc[t];
  const float c1 = tile.sx[t] * py - tile.sy[t] * px;
  const float c2 = px * tile.ey[t] - py * tile.ex[t];
  const int flags = tile.flags[t];
  const bool in_window =
      (flags & 2) ||
      ((flags & 1) ? !(c1 < 0.0f && c2 < 0.0f) : (c1 >= 0.0f && c2 >= 0.0f));
  return ok && (u >= r_eps) && in_window;
}

// The nearest valid arc of a staged tile, folded into the running best.
// The quadratic is normalised by the radius (x_r = (o - c) / r,
// d_r = d / r): a = |d_r|^2, b = 2 (x_r . d_r), and the discriminant
// b^2 - 4 a (|x_r|^2 - 1) evaluated as 4 (a - (x_r x d_r)^2), the same
// quantity without its cancellation (see below); it is snapped to 0 when
// |disc| < i_eps; the pair is valid only when disc >= 0 and |a| >= i_eps;
// u+- = (-b +- sqrt(disc)) / (2 a).  Of the arc's two branches the smaller
// valid u counts, and the branch flag is set when the minus branch's is
// strictly smaller; an arc replaces the best only under strict <, carrying
// its own branch.
//
// The discriminant.  The TPU kernel computes b^2 - 4 a c, two terms of
// size (|o - c| |d| / r^2)^2 whose difference is 4 (|d| / r)^2 at most: a
// ray starting D radii from the centre loses ~2 log10(D) digits.  The light
// guide's exit lenslets have r = 0.003 and rays start up to 40 away
// (D ~ 13000), where float32 b^2 - 4 a c is noise and puts hits up to ~0.03
// off the arc, outside the culling boxes.  The cross-product form loses no
// more than the ray's own coordinates do.
__device__ __forceinline__ void search_arcs(const ArcTile& tile, int count,
                                            int base, const Ray& r,
                                            float i_eps, float r_eps,
                                            float& best_u, int& best_idx,
                                            bool& best_minus) {
  for (int t = 0; t < count; ++t) {
    const float inv_r = tile.inv_r[t];
    const float xr = (r.ox - tile.xc[t]) * inv_r;
    const float yr = (r.oy - tile.yc[t]) * inv_r;
    const float xd = r.dx * inv_r;
    const float yd = r.dy * inv_r;

    const float a = xd * xd + yd * yd;
    const float b = 2.0f * (xr * xd + yr * yd);
    const float cross = xr * yd - yr * xd;
    float disc = 4.0f * (a - cross * cross);
    disc = fabsf(disc) < i_eps ? 0.0f : disc;

    const bool a_ok = fabsf(a) >= i_eps;
    const bool ok = (disc >= 0.0f) && a_ok;
    const float inv2a = 1.0f / (a_ok ? 2.0f * a : 1.0f);
    const float sq = sqrtf(disc >= 0.0f ? disc : 0.0f);
    const float u_plus = (-b + sq) * inv2a;
    const float u_minus = (-b - sq) * inv2a;

    const float up =
        arc_branch_valid(tile, t, r, u_plus, ok, r_eps) ? u_plus : kBig;
    const float um =
        arc_branch_valid(tile, t, r, u_minus, ok, r_eps) ? u_minus : kBig;
    const float u = fminf(um, up);
    if (u < best_u) {
      best_u = u;
      best_idx = base + t;
      best_minus = um < up;
    }
  }
}

// ------------------------------------------------------- the two-level walk

// The walk of K9 and K10: one CUDA block per ray block (one thread per
// ray), fine chunks of kTile surfaces.
// - The block reads its own candidate count and list from global memory
//   (ops/triangle_kernels.twolevel_candidates): it walks cand[b * max_cand
//   ...] for counts[b] steps, or every chunk 0 .. n_chunks - 1 in order when
//   counts[b] == n_chunks (its list overflowed the cap).
// - Chunk k + 1 is copied with cp.async (16 bytes a thread) from the
//   chunk-major table (one Tile per chunk, zero past m) into the second of
//   the two shared buffers while chunk k is searched.
// - Chunk k is gated by slab_gate against each ray's running best: a block
//   vote (__syncthreads_or) skips a chunk no ray of the block needs, a warp
//   vote (__any_sync) the arithmetic of warps none of whose rays need it.
// - The ragged last chunk is searched for its real surfaces only.
// `search(tile, count, base)` folds a staged tile into the thread's running
// best, whose ray parameter `best_u` it updates.
template <typename Tile, typename Search>
__device__ __forceinline__ void twolevel_walk(
    Tile (&buf)[2], const float* __restrict__ table,
    const float* __restrict__ aabb, const int* __restrict__ counts,
    const int* __restrict__ cand, int n_chunks, int max_cand, int m,
    const Ray& r, bool live, float r_eps, float slack_hi, float slack_lo,
    float slack, const float& best_u, Search search) {
  static_assert(sizeof(Tile) % sizeof(float4) == 0, "whole float4 copies");
  constexpr int kVecs = sizeof(Tile) / sizeof(float4);
  const int cnt = counts[blockIdx.x];
  const bool sweep = cnt == n_chunks;
  const int* list = cand + static_cast<size_t>(blockIdx.x) * max_cand;
  auto chunk_id = [&](int k) { return sweep ? k : list[min(k, max_cand - 1)]; };
  auto stage = [&](int c, int slot) {
    const float4* src =
        reinterpret_cast<const float4*>(table) + static_cast<size_t>(c) * kVecs;
    float4* dst = reinterpret_cast<float4*>(&buf[slot]);
    for (int i = threadIdx.x; i < kVecs; i += blockDim.x)
      __pipeline_memcpy_async(dst + i, src + i, sizeof(float4));
    __pipeline_commit();
  };

  if (cnt > 0) stage(chunk_id(0), 0);
  for (int k = 0; k < cnt; ++k) {
    const int c = chunk_id(k);
    if (k + 1 < cnt) {
      stage(chunk_id(k + 1), (k + 1) & 1);
      __pipeline_wait_prior(1);  // this thread's copies of chunk k landed
    } else {
      __pipeline_wait_prior(0);
    }
    const bool need = live && slab_gate(aabb + 4 * c, r, r_eps, slack_hi,
                                        slack_lo, slack, best_u);
    const bool warp_need = __any_sync(0xffffffffu, need);
    // the barrier after which every thread's copies of chunk k are visible
    if (__syncthreads_or(need) && warp_need) {
      const int base = c * kTile;
      search(buf[k & 1], min(kTile, m - base), base);
    }
    __syncthreads();  // buffer k & 1 is no longer read: step k+1 refills it
  }
}

}  // namespace search2d
