// What the 2D nearest-hit searches share: the ray load, the 2D slab gate,
// the pair tests of segments (K5 segment_search.cu, K7
// segment_search_culled.cu, K9 segment_search_twolevel.cu) and of arcs (K6
// arc_search.cu, K8 arc_search_culled.cu, K10 arc_search_twolevel.cu), the
// arcs' tile and its search, and the listed walk with its folds.
//
// K5 and K6 run several rays a thread over tiles staged in shared memory,
// every thread reading the same surface at once (a broadcast).  K7-K10
// walk chunks of kTile surfaces with compaction.cuh's ray compaction
// (walk_listed): each ray passes its own gate, and the block computes a
// chunk for the listed rays only, several threads a ray
// (fold_listed_segments for K7 and K9, fold_listed_arcs for K8 and K10);
// K7 and K8 sweep every chunk, K9 and K10 their candidate lists.  A surface replaces the ray's running best
// only under strict <, so a tie keeps the first index.  The arithmetic is
// the plain versions' (ops/segment_kernels.py, ops/arc_kernels.py): the
// same float32 operations in the same order, built with --fmad=false and
// without fast math, so that sqrtf and every division are IEEE and kernel
// and plain version agree bit for bit.  The segment kernels share one pair
// test (SegmentPair) and the arc kernels another (ArcPair), each of which
// skips only pairs the exact arithmetic rejects, and the culled and
// two-level kernels only skip chunks whose box a ray cannot reach no
// farther than its best, so they return the brute kernels' hits bit for
// bit.  The float64 instances of K5-K10 share the float64 ray load, pairs,
// gate and walk at the end (namespace search2d::f64).

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "compaction.cuh"
#include "reject_test.cuh"

namespace search2d {

constexpr int kThreads = 256;     // K5, K6: threads a block
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

// One ray-segment pair, the plain version's arithmetic:
//   den = dx1 dy2 - dy1 dx2, valid only when |den| >= i_eps,
//   inv = 1 / (ok ? den : 1),
//   ray_u = (dx2 (y1 - y2) - dy2 (x1 - x2)) inv,
//   seg_u = (dy1 (x2 - x1) - dx1 (y2 - y1)) inv,
//   valid when s_lo <= seg_u <= s_hi and ray_u >= r_eps; it replaces the
//   running best only under strict <.
// seg_u's numerator is formed as dx1 (y1 - y2) - dy1 (x1 - x2): IEEE
// rounding is symmetric, so negating both differences negates both products
// and gives the same difference, bit for bit (a zero's sign aside, which no
// comparison sees).  A search forms the exact numerators (SegmentPair),
// runs reject_test.cuh's test on them (maybe), and only for a pair the test
// cannot reject the division and the exact compares (fold), so its result
// is the plain version's bit for bit.
struct SegmentPair {
  float den, nu, ns;

  SegmentPair() = default;

  __device__ __forceinline__ SegmentPair(float x2, float y2, float dx2,
                                         float dy2, const Ray& r) {
    const float tx = r.ox - x2, ty = r.oy - y2;
    den = r.dx * dy2 - r.dy * dx2;
    nu = dx2 * ty - dy2 * tx;
    ns = r.dx * ty - r.dy * tx;
  }

  // False only where the exact arithmetic rejects the pair; no branch.
  __device__ __forceinline__ bool maybe(const reject::Limits& L,
                                        const reject::Best& best) const {
    const float ad = fabsf(den);
    const float a = reject::approx_rcp(den);
    const bool near = reject::inside(ns * a, L.s_win) &
                      reject::inside(nu * a, best.win);
    return (ad >= L.i_eps) & (reject::out_of_range(ad, L) | near);
  }

  // The exact arithmetic, for a pair with |den| >= i_eps (so 1 / den is the
  // plain version's 1 / (ok ? den : 1)), folded into the running best.
  __device__ __forceinline__ void fold(int idx, const reject::Limits& L,
                                       reject::Best& best) const {
    const float inv = 1.0f / den;
    const float u = nu * inv;
    const float s = ns * inv;
    if ((s >= L.s_lo) && (s <= L.s_hi) && (u >= L.r_eps) && u < best.u)
      best.set(u, idx, L);
  }
};

// -------------------------------------------------------------------- arcs

// The arc table: (m, 8) float32 row-major, one row per arc, built by
// ops/arc_kernels.arc_table: centre x, centre y, radius, cos and sin of the
// window's start, cos and sin of its end, flags (1: the window spans more
// than pi, 2: a full circle).
constexpr int kArcCols = 8;

// A tile of arcs in shared memory, two 128-bit rows an arc:
// - head: centre x, centre y, 1 / radius and the flags' int32 bits, all that
//   the reject test (ArcPair) reads;
// - edge: cos and sin of the window's start, cos and sin of its end, read
//   only for a pair that passes it.
// K10 stages an ArcTile whole from its chunk-major table
// (ops/arc_kernels.arc_chunk_table, (C, 2, kTile, 4) 4-byte words), K8
// row by row from the arc table through registers (arc_search_culled.cu).
struct ArcTile {
  float4 head[kTile];
  float4 edge[kTile];
};

// One row of the arc table, its columns 0-3 in `a` and 4-7 in `b`, as an
// ArcTile's head and edge rows: the radius replaced by its reciprocal, the
// flags by their int32 bits.
__device__ __forceinline__ void tile_row(const float4& a, const float4& b,
                                         float4& head, float4& edge) {
  head = make_float4(a.x, a.y, 1.0f / a.z,
                     __int_as_float(static_cast<int>(b.w)));
  edge = make_float4(a.w, b.x, b.y, b.z);
}

__device__ __forceinline__ void stage_arcs(ArcTile& tile,
                                           const float* __restrict__ table,
                                           int base, int count) {
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const float* row = table + kArcCols * (base + t);
    tile_row(make_float4(row[0], row[1], row[2], row[3]),
             make_float4(row[4], row[5], row[6], row[7]), tile.head[t],
             tile.edge[t]);
  }
}

// A ray's running best among arcs: ray parameter, arc, and whether the
// arc's minus branch gave it.
struct ArcBest {
  float u;
  int idx;
  bool minus;
};

// One ray-arc pair, the plain version's arithmetic (ops/arc_kernels.py
// _arc_pairs).  The quadratic is normalised by the radius (x_r = (o - c) /
// r, d_r = d / r): a = |d_r|^2, b = 2 (x_r . d_r), and the discriminant
// b^2 - 4 a (|x_r|^2 - 1) evaluated as 4 (a - (x_r x d_r)^2), the same
// quantity without its cancellation (see below); it is snapped to 0 when
// |disc| < i_eps; the pair is valid only when disc >= 0 and |a| >= i_eps
// (`ok`); u+- = (-b +- sqrt(disc)) / (2 a).  Of the arc's two branches the
// smaller valid u counts, and the branch flag is set when the minus
// branch's is strictly smaller; an arc replaces the best only under strict
// <, carrying its own branch.
//
// The reject.  A pair without `ok` gives u = 3e38 on both branches, which
// never replaces a best under strict <, so a search may skip it exactly.
// The constructor forms `ok` from the centre and 1 / r alone, with the
// plain version's operations up to the discriminant (15: the scaled
// coordinates 6, a 3, the cross term 3, disc 3) and its snap, so `ok` has
// the plain version's bits and needs no margin; it is branch-free (&, not
// &&).  Only a pair with `ok` pays fold: b, the square root, the IEEE
// 1 / (2 a), both roots and the two window tests, unchanged.
//
// The discriminant.  The TPU kernel computes b^2 - 4 a c, two terms of
// size (|o - c| |d| / r^2)^2 whose difference is 4 (|d| / r)^2 at most: a
// ray starting D radii from the centre loses ~2 log10(D) digits.  The light
// guide's exit lenslets have r = 0.003 and rays start up to 40 away
// (D ~ 13000), where float32 b^2 - 4 a c is noise and puts hits up to ~0.03
// off the arc, outside the culling boxes.  The cross-product form loses no
// more than the ray's own coordinates do.
struct ArcPair {
  float xr, yr, xd, yd, a, disc;
  bool ok;

  ArcPair() = default;

  __device__ __forceinline__ ArcPair(const float4& head, const Ray& r,
                                     float i_eps) {
    const float inv_r = head.z;
    xr = (r.ox - head.x) * inv_r;
    yr = (r.oy - head.y) * inv_r;
    xd = r.dx * inv_r;
    yd = r.dy * inv_r;
    a = xd * xd + yd * yd;
    const float cross = xr * yd - yr * xd;
    const float d = 4.0f * (a - cross * cross);
    disc = fabsf(d) < i_eps ? 0.0f : d;
    ok = (disc >= 0.0f) & (fabsf(a) >= i_eps);
  }

  // Is the hit at ray parameter u inside arc's window?  The TPU kernel's
  // cross-product form: with p the hit relative to the centre, c1 =
  // cross(start edge, p) and c2 = cross(p, end edge); a window of at most pi
  // needs c1 >= 0 and c2 >= 0, a wider one only not both < 0, a full circle
  // nothing.
  __device__ __forceinline__ static bool in_window(const float4& head,
                                                   const float4& edge,
                                                   const Ray& r, float u) {
    const float px = (r.ox + r.dx * u) - head.x;
    const float py = (r.oy + r.dy * u) - head.y;
    const float c1 = edge.x * py - edge.y * px;
    const float c2 = px * edge.w - py * edge.z;
    const int flags = __float_as_int(head.w);
    const bool wide = !((c1 < 0.0f) & (c2 < 0.0f));
    const bool narrow = (c1 >= 0.0f) & (c2 >= 0.0f);
    return ((flags & 2) != 0) | ((flags & 1) ? wide : narrow);
  }

  // The exact arithmetic, for a pair with `ok` (so 1 / (2 a) and the square
  // root are the plain version's 1 / (a_ok ? 2 a : 1) and sqrt(max(disc,
  // 0))), folded into the running best as arc `idx`.
  __device__ __forceinline__ void fold(const float4& head, const float4& edge,
                                       const Ray& r, float r_eps, int idx,
                                       ArcBest& best) const {
    const float b = 2.0f * (xr * xd + yr * yd);
    const float inv2a = 1.0f / (2.0f * a);
    const float sq = sqrtf(disc);
    const float u_plus = (-b + sq) * inv2a;
    const float u_minus = (-b - sq) * inv2a;
    const bool plus_ok = (u_plus >= r_eps) & in_window(head, edge, r, u_plus);
    const bool minus_ok =
        (u_minus >= r_eps) & in_window(head, edge, r, u_minus);
    const float up = plus_ok ? u_plus : kBig;
    const float um = minus_ok ? u_minus : kBig;
    const float u = fminf(um, up);
    if (u < best.u) {
      best.u = u;
      best.idx = idx;
      best.minus = um < up;
    }
  }
};

// The nearest valid arc of a staged tile for each of a thread's kRays rays,
// folded into their running bests in index order: one 128-bit load and
// kRays reject tests an arc, and one branch an arc (taken when some ray's
// pair passes), not one a pair.
template <int kRays>
__device__ __forceinline__ void search_arcs(const ArcTile& tile, int count,
                                            int base, const Ray (&r)[kRays],
                                            float i_eps, float r_eps,
                                            ArcBest (&best)[kRays]) {
  for (int t = 0; t < count; ++t) {
    const float4 head = tile.head[t];
    ArcPair pair[kRays];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      pair[k] = ArcPair(head, r[k], i_eps);
      any |= pair[k].ok;
    }
    if (any) {  // rarely: a ray's line meets few of the circles
      const float4 edge = tile.edge[t];
#pragma unroll
      for (int k = 0; k < kRays; ++k)
        if (pair[k].ok) pair[k].fold(head, edge, r[k], r_eps, base + t, best[k]);
    }
  }
}


// ------------------------------------- the listed walk (K7 to K10)
//
// One CUDA block per ray block (one thread a ray), chunks of kTile
// surfaces.  The block's rays keep (ox, oy, dx, dy) in ray_a and (best u,
// best key as int32 bits) in ray_b, in shared memory.  The key is the best
// surface's idx for segments and arc_key(idx, minus) for arcs: at equal u
// the smaller key is the smaller idx, so compaction::group_min reduces
// either, and an arc's branch travels with its idx.

// This thread's ray into the block's shared arrays, with no best yet (u =
// kBig, key 0: idx 0 and the plus branch, the brute searches' miss).
__device__ __forceinline__ void put_ray(float4* ray_a, float2* ray_b,
                                        const Ray& r) {
  ray_a[threadIdx.x] = make_float4(r.ox, r.oy, r.dx, r.dy);
  ray_b[threadIdx.x] = make_float2(kBig, __int_as_float(0));
}

__device__ __forceinline__ int arc_key(int idx, bool minus) {
  return (idx << 1) | (minus ? 1 : 0);
}

// Fold the first `count` segments of a staged chunk (one float4 (x, y, dx,
// dy) a segment; row t is segment base + t) into the bests of the `total`
// listed rays, `group` threads a ray (compaction::group_size), and write
// each back to ray_b.  Every thread of the block calls it.
__device__ __forceinline__ void fold_listed_segments(
    const float4* tile, int count, int base, int total, const int* list,
    const float4* ray_a, float2* ray_b, const reject::Limits& L) {
  const int me = threadIdx.x, warp = me >> 5;
  const int group = compaction::group_size(total);
  const int j = me / group, part = me % group;
  if (warp * 32 >= total * group) return;  // the same in the whole warp
  reject::Best best;
  int slot = 0;
  if (j < total) {
    slot = list[j];
    const float4 a = ray_a[slot];
    const float2 b = ray_b[slot];
    const Ray q{a.x, a.y, a.z, a.w, 0.f, 0.f};
    best.set(b.x, __float_as_int(b.y), L);
    for (int t = part; t < count; t += group) {
      const float4 s = tile[t];
      const SegmentPair pair(s.x, s.y, s.z, s.w, q);
      if (pair.maybe(L, best)) pair.fold(base + t, L, best);
    }
  } else {
    best.u = kBig;
    best.idx = 0;
  }
  compaction::group_min(best.u, best.idx, group);
  if (j < total && part == 0)
    ray_b[slot] = make_float2(best.u, __int_as_float(best.idx));
}

// fold_listed_segments for arcs: the first `count` arcs of a staged
// ArcTile, each thread running the reject test (ArcPair) on every
// group-th arc's head and reading the edge row only for a pair that passes
// (search_arcs' structure).  A thread folds its arcs in index order under
// strict <, each carrying its own branch; the group's smallest (u, key) is
// then the in-order fold of the whole chunk, the branch with its arc.
__device__ __forceinline__ void fold_listed_arcs(
    const ArcTile& tile, int count, int base, int total, const int* list,
    const float4* ray_a, float2* ray_b, float i_eps, float r_eps) {
  const int me = threadIdx.x, warp = me >> 5;
  const int group = compaction::group_size(total);
  const int j = me / group, part = me % group;
  if (warp * 32 >= total * group) return;  // the same in the whole warp
  ArcBest best{kBig, 0, false};
  int slot = 0;
  if (j < total) {
    slot = list[j];
    const float4 a = ray_a[slot];
    const float2 b = ray_b[slot];
    const Ray q{a.x, a.y, a.z, a.w, 0.f, 0.f};
    const int key = __float_as_int(b.y);
    best = ArcBest{b.x, key >> 1, (key & 1) != 0};
    for (int t = part; t < count; t += group) {
      const float4 head = tile.head[t];
      const ArcPair pair(head, q, i_eps);
      if (pair.ok) pair.fold(head, tile.edge[t], q, r_eps, base + t, best);
    }
  }
  int key = arc_key(best.idx, best.minus);
  compaction::group_min(best.u, key, group);
  if (j < total && part == 0)
    ray_b[slot] = make_float2(best.u, __int_as_float(key));
}

// How K9 and K10 stage a chunk: cp.async (16 bytes a thread) from a
// chunk-major table of kVecs float4 a chunk into two buffers `buf` (2 x
// kVecs float4), chunk k + 1 into the second while chunk k is computed.
// The walk calls start(c) for its first chunk, then at each step k
// land(k, next), which returns chunk k's buffer (this thread's copies
// landed; the walk's next barrier makes every thread's visible) and starts
// the copy of chunk `next` for step k + 1 (-1: none) into the buffer
// step k - 1 computed, which that step's last barrier freed.
template <int kVecs>
struct CopyStage {
  float4* buf;
  const float4* __restrict__ table;

  __device__ __forceinline__ void copy(int c, int slot) {
    const float4* src = table + static_cast<size_t>(c) * kVecs;
    float4* dst = buf + slot * kVecs;
    for (int i = threadIdx.x; i < kVecs; i += blockDim.x)
      __pipeline_memcpy_async(dst + i, src + i, sizeof(float4));
    __pipeline_commit();
  }
  __device__ __forceinline__ void start(int c) { copy(c, 0); }
  __device__ __forceinline__ const float4* land(int k, int next) {
    if (next >= 0) {
      copy(next, (k + 1) & 1);
      __pipeline_wait_prior(1);  // this thread's copies of chunk k landed
    } else {
      __pipeline_wait_prior(0);
    }
    return buf + (k & 1) * kVecs;
  }
};

// The walk: `steps` chunks, chunk_of(k) at step k, brought in by `stage`
// (CopyStage's interface).  At step k every thread gates its own ray on
// slab_gate against chunk k's box in `aabb` and its running best (`best_u`,
// its own slot of ray_b); compaction::compact lists the rays that pass;
// `fold(tile, chunk, total)` computes the chunk for the listed rays.  A
// chunk no ray needs costs one gate and one barrier: the warps' counts
// (`warp_count`, 2 x 32 ints) are double-buffered, so no second barrier
// guards them.  Chunks must come in ascending order, so that every earlier
// best's key lies below the chunk's, as compaction::group_min needs.
template <typename ChunkOf, typename Stage, typename Fold>
__device__ __forceinline__ void walk_listed(
    int steps, ChunkOf chunk_of, Stage& stage, const float* __restrict__ aabb,
    const Ray& r, bool live, float r_eps, float slack_hi, float slack_lo,
    float slack, const float& best_u, int* list, int* warp_count,
    Fold fold) {
  if (steps > 0) stage.start(chunk_of(0));
  for (int k = 0; k < steps; ++k) {
    const int c = chunk_of(k);
    const float4* tile = stage.land(k, k + 1 < steps ? chunk_of(k + 1) : -1);
    const bool need = live && slab_gate(aabb + 4 * c, r, r_eps, slack_hi,
                                        slack_lo, slack, best_u);
    // its barrier also makes every thread's part of chunk k visible
    const int total =
        compaction::compact(need, list, warp_count + 32 * (k & 1));
    if (total == 0) continue;  // the same in every thread
    __syncthreads();  // the list is written
    fold(tile, c, total);
    __syncthreads();  // the bests are written; the buffer and list are free
  }
}

// The walk of K9 and K10 over the block's own candidate list
// (ops/triangle_kernels.twolevel_candidates): cand[b * max_cand ...] for
// counts[b] steps, or every chunk 0 .. n_chunks - 1 in order when counts[b]
// == n_chunks (its list overflowed the cap).  Lists are ascending.
template <typename Stage, typename Fold>
__device__ __forceinline__ void twolevel_walk_listed(
    Stage& stage, const float* __restrict__ aabb,
    const int* __restrict__ counts, const int* __restrict__ cand,
    int n_chunks, int max_cand, const Ray& r, bool live, float r_eps,
    float slack_hi, float slack_lo, float slack, const float& best_u,
    int* list, int* warp_count, Fold fold) {
  const int cnt = counts[blockIdx.x];
  const bool sweep = cnt == n_chunks;
  const int* cands = cand + static_cast<size_t>(blockIdx.x) * max_cand;
  walk_listed(
      cnt,
      [&](int k) { return sweep ? k : cands[min(k, max_cand - 1)]; }, stage,
      aabb, r, live, r_eps, slack_hi, slack_lo, slack, best_u, list,
      warp_count, fold);
}

// ------------------------------------------------------------ float64
//
// The float64 instances of K5 and K6: the plain versions' float64
// operations in their order.  K5's pair has no reject test
// (reject_test.cuh's margins are float32's): every pair with |den| >=
// i_eps pays the division.  K6's exact reject (ArcPair's `ok`) carries
// over as written.  A pair ends early only where an exact compare of the
// plain version refuses it, so the results are the plain versions' bit
// for bit.

namespace f64 {

constexpr double kBig = 3.0e38;   // the plain versions' BIG, in float64

struct Ray {
  double ox, oy, dx, dy;
};

// The thresholds as the plain versions compare with them (Python floats).
struct Limits {
  double i_eps, s_lo, s_hi, r_eps;
};

// p0, p1: (n, 2) float64 row-major; rays past n stay zero.
__device__ __forceinline__ Ray load_ray(const double* __restrict__ p0,
                                        const double* __restrict__ p1,
                                        int ray, bool live) {
  Ray r{0.0, 0.0, 0.0, 0.0};
  if (live) {
    r.ox = p0[2 * ray + 0];
    r.oy = p0[2 * ray + 1];
    r.dx = p1[2 * ray + 0] - r.ox;
    r.dy = p1[2 * ray + 1] - r.oy;
  }
  return r;
}

// One ray-segment pair (start x2, y2, direction dx2, dy2) folded into the
// ray's running best (u, idx) as segment idx: SegmentPair's formulas
// without its reject test; a segment replaces the best only under strict
// <.
__device__ __forceinline__ void fold_segment(const double2& start,
                                             const double2& dir, int idx,
                                             const Ray& r, const Limits& L,
                                             double& best_u, int& best_idx) {
  const double den = r.dx * dir.y - r.dy * dir.x;
  if (!(fabs(den) >= L.i_eps)) return;
  const double inv = 1.0 / den;  // 1 / (ok ? den : 1)
  const double tx = r.ox - start.x, ty = r.oy - start.y;
  const double u = (dir.x * ty - dir.y * tx) * inv;
  const double s = (r.dx * ty - r.dy * tx) * inv;
  if ((s >= L.s_lo) && (s <= L.s_hi) && (u >= L.r_eps) && u < best_u) {
    best_u = u;
    best_idx = idx;
  }
}

// A tile of arcs in shared memory: what ArcPair's test reads (centre, 1 /
// radius) apart from what only a pair that passes it reads (the flags as
// an int, the window's edge vectors).
struct ArcTile {
  double2 centre[kTile];
  double inv_r[kTile];
  int flags[kTile];
  double2 start[kTile];  // cos, sin of the window's start
  double2 end[kTile];    // cos, sin of its end
};

// Arcs base .. base + count - 1 of the (m, 8) float64 arc table into the
// tile, the radius replaced by its reciprocal.  Every thread of the block
// calls it.
__device__ __forceinline__ void stage_arcs(ArcTile& tile,
                                           const double* __restrict__ table,
                                           int base, int count) {
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const double* row = table + kArcCols * (base + t);
    tile.centre[t] = make_double2(row[0], row[1]);
    tile.inv_r[t] = 1.0 / row[2];
    tile.start[t] = make_double2(row[3], row[4]);
    tile.end[t] = make_double2(row[5], row[6]);
    tile.flags[t] = static_cast<int>(row[7]);
  }
}

// Arc t of a staged tile folded into the ray's running best as arc idx:
// ArcPair's arithmetic in float64, its exact reject first.
__device__ __forceinline__ void fold_arc(const ArcTile& tile, int t, int idx,
                                         const Ray& r, const Limits& L,
                                         double& best_u, int& best_idx,
                                         bool& best_minus) {
  const double2 c = tile.centre[t];
  const double inv_r = tile.inv_r[t];
  const double xr = (r.ox - c.x) * inv_r;
  const double yr = (r.oy - c.y) * inv_r;
  const double xd = r.dx * inv_r;
  const double yd = r.dy * inv_r;
  const double a = xd * xd + yd * yd;
  const double cross = xr * yd - yr * xd;
  const double d = 4.0 * (a - cross * cross);
  const double disc = fabs(d) < L.i_eps ? 0.0 : d;
  if (!((disc >= 0.0) & (fabs(a) >= L.i_eps))) return;  // no valid branch

  const double b = 2.0 * (xr * xd + yr * yd);
  const double inv2a = 1.0 / (2.0 * a);
  const double sq = sqrt(disc);
  const double u_plus = (-b + sq) * inv2a;
  const double u_minus = (-b - sq) * inv2a;
  const double2 e0 = tile.start[t], e1 = tile.end[t];
  const int flags = tile.flags[t];
  // ArcPair::in_window in float64
  auto in_window = [&](double u) {
    const double px = (r.ox + r.dx * u) - c.x;
    const double py = (r.oy + r.dy * u) - c.y;
    const double c1 = e0.x * py - e0.y * px;
    const double c2 = px * e1.y - py * e1.x;
    const bool wide = !((c1 < 0.0) & (c2 < 0.0));
    const bool narrow = (c1 >= 0.0) & (c2 >= 0.0);
    return ((flags & 2) != 0) | ((flags & 1) ? wide : narrow);
  };
  const double up = (u_plus >= L.r_eps) & in_window(u_plus) ? u_plus : kBig;
  const double um = (u_minus >= L.r_eps) & in_window(u_minus) ? u_minus : kBig;
  const double u = fmin(um, up);
  if (u < best_u) {
    best_u = u;
    best_idx = idx;
    best_minus = um < up;
  }
}

// ----------------------------------------- the float64 walk (K7 to K10)
//
// The float64 instances of K7-K10 keep each ray (one a thread) and its
// running best in registers, with no compaction and no shared ray slots:
// at each step every thread gates its own ray on the chunk's float64 box
// (slab_gate), the block stages the chunk when one of its rays passes
// (__syncthreads_or), and each ray that passed folds the whole chunk in
// index order with the brute instances' pair (fold_segment, fold_arc).  A
// warp runs a chunk for all its rays when one needs it.

// The slab gate's inverse direction of a ray: 1 / d with |d| < 1e-30
// replaced by +-1e-30 (search2d::safe_inverse in float64).
struct Inverse {
  double ix, iy;
};

__device__ __forceinline__ double safe_inverse(double d) {
  return 1.0 / (fabs(d) < 1.0e-30 ? (d < 0.0 ? -1.0e-30 : 1.0e-30) : d);
}

__device__ __forceinline__ Inverse inverse(const Ray& r) {
  return Inverse{safe_inverse(r.dx), safe_inverse(r.dy)};
}

// search2d::slab_gate in float64, on (C, 4) float64 boxes.
__device__ __forceinline__ bool slab_gate(const double* __restrict__ box,
                                          const Ray& r, const Inverse& inv,
                                          double r_eps, double slack_hi,
                                          double slack_lo, double slack,
                                          double best_u) {
  double t1 = (box[0] - r.ox) * inv.ix, t2 = (box[2] - r.ox) * inv.ix;
  double tmin = fmin(t1, t2), tmax = fmax(t1, t2);
  t1 = (box[1] - r.oy) * inv.iy;
  t2 = (box[3] - r.oy) * inv.iy;
  tmin = fmax(tmin, fmin(t1, t2));
  tmax = fmin(tmax, fmax(t1, t2));
  return (tmax * slack_hi + slack >= fmax(tmin, r_eps)) &&
         (tmin * slack_lo - slack <= best_u);
}

// The walk: `steps` chunks, chunk_of(k) at step k.  stage(c) brings chunk c
// into shared memory (every thread of the block calls it); fold(c) folds it
// into this thread's best.  Chunks must come in ascending order, so that a
// tie keeps the first index, as in the plain versions.
template <typename ChunkOf, typename Stage, typename Fold>
__device__ __forceinline__ void walk(int steps, ChunkOf chunk_of,
                                     const double* __restrict__ aabb,
                                     const Ray& r, bool live, double r_eps,
                                     double slack_hi, double slack_lo,
                                     double slack, const double& best_u,
                                     Stage stage, Fold fold) {
  const Inverse inv = inverse(r);
  for (int k = 0; k < steps; ++k) {
    const int c = chunk_of(k);
    const bool need = live && slab_gate(aabb + 4 * c, r, inv, r_eps,
                                        slack_hi, slack_lo, slack, best_u);
    // also the barrier after the previous chunk's last read
    if (!__syncthreads_or(need)) continue;  // the same in every thread
    stage(c);
    __syncthreads();
    if (need) fold(c);
  }
}

// The walk of K9 and K10 over the block's own candidate list, as
// search2d::twolevel_walk_listed reads it (every chunk in order when the
// list overflowed).
template <typename Stage, typename Fold>
__device__ __forceinline__ void twolevel_walk(
    const double* __restrict__ aabb, const int* __restrict__ counts,
    const int* __restrict__ cand, int n_chunks, int max_cand, const Ray& r,
    bool live, double r_eps, double slack_hi, double slack_lo, double slack,
    const double& best_u, Stage stage, Fold fold) {
  const int cnt = counts[blockIdx.x];
  const bool sweep = cnt == n_chunks;
  const int* cands = cand + static_cast<size_t>(blockIdx.x) * max_cand;
  walk(cnt, [&](int k) { return sweep ? k : cands[min(k, max_cand - 1)]; },
       aabb, r, live, r_eps, slack_hi, slack_lo, slack, best_u, stage, fold);
}

}  // namespace f64

}  // namespace search2d
