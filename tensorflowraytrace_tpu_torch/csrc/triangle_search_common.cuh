// What the triangle searches share: the ray load, the slab gate of the
// culled (K3, triangle_search_culled.cu) and two-level (K4,
// triangle_search_twolevel.cu) searches, the per-pair Moller-Trumbore test
// of all three and K1 (triangle_search.cu), and the group fold that K3 and
// K4 run on the rays compaction.cuh lists.
//
// The arithmetic is the plain version's (ops/triangle_kernels.py): the same
// float32 operations in the same order, built with --fmad=false, behind
// reject_test.cuh's test, so that every kernel returns the plain version's
// valid, idx and u bit for bit.  The float64 instances of K1 and K3 share
// the float64 ray load, slab gate, tile and pair at the end (namespace
// tsearch::f64).

#pragma once

#include <cuda_runtime.h>

#include "compaction.cuh"
#include "reject_test.cuh"

namespace tsearch {

constexpr float kBig = 3.0e38f;   // no-hit sentinel (u < 1.5e38 means a hit)
constexpr float kTiny = 1.0e-30f;

// One ray: origin, direction p1 - p0 and the slab test's inverse direction
// (|d| < 1e-30 replaced by +-1e-30).  Rays past n stay zero.
struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float safe_inverse(float d) {
  return 1.0f / (fabsf(d) < kTiny ? (d < 0.0f ? -kTiny : kTiny) : d);
}

// The ray's origin and direction only, its inverse direction left zero:
// K1 has no slab test.
__device__ __forceinline__ Ray load_ray_direction(const float* __restrict__ p0,
                                                  const float* __restrict__ p1,
                                                  int ray, bool live) {
  Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    r.ox = p0[3 * ray + 0];
    r.oy = p0[3 * ray + 1];
    r.oz = p0[3 * ray + 2];
    r.dx = p1[3 * ray + 0] - r.ox;
    r.dy = p1[3 * ray + 1] - r.oy;
    r.dz = p1[3 * ray + 2] - r.oz;
  }
  return r;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ p0,
                                        const float* __restrict__ p1,
                                        int ray, bool live) {
  Ray r = load_ray_direction(p0, p1, ray, live);
  r.ix = safe_inverse(r.dx);
  r.iy = safe_inverse(r.dy);
  r.iz = safe_inverse(r.dz);
  return r;
}

// The slab test of one ray against one chunk box (min xyz, max xyz): with
// t1 = (lo - o) inv, t2 = (hi - o) inv, tmin = max over axes of
// min(t1, t2) and tmax = min over axes of max(t1, t2), the ray needs the
// chunk iff
//   tmax (1 + 1e-6) + 1e-6 >= max(tmin, r_eps)   (it can hit the box) and
//   tmin (1 - 1e-6) - 1e-6 <= best_u             (no farther than its best).
// The box holds every triangle of the chunk, so a ray that fails cannot find
// a nearer hit there.  Parked rays (p0 = 1e30) fail it.
__device__ __forceinline__ bool slab_gate(const float* __restrict__ box,
                                          const Ray& r, float r_eps,
                                          float slack_hi, float slack_lo,
                                          float slack, float best_u) {
  float t1 = (box[0] - r.ox) * r.ix, t2 = (box[3] - r.ox) * r.ix;
  float tmin = fminf(t1, t2), tmax = fmaxf(t1, t2);
  t1 = (box[1] - r.oy) * r.iy;
  t2 = (box[4] - r.oy) * r.iy;
  tmin = fmaxf(tmin, fminf(t1, t2));
  tmax = fminf(tmax, fmaxf(t1, t2));
  t1 = (box[2] - r.oz) * r.iz;
  t2 = (box[5] - r.oz) * r.iz;
  tmin = fmaxf(tmin, fminf(t1, t2));
  tmax = fminf(tmax, fmaxf(t1, t2));
  return (tmax * slack_hi + slack >= fmaxf(tmin, r_eps)) &&
         (tmin * slack_lo - slack <= best_u);
}

// One ray-triangle pair (vertex v0, edges E1 = v1 - v0, E2 = v2 - v0),
// the plain version's arithmetic:
//   P = D x E2, det = E1 . P; the pair is invalid when |det| < i_eps;
//   T = o - v0, Q = T x E1, inv = 1 / det,
//   tu = (T . P) inv, tv = (D . Q) inv, u = (E2 . Q) inv,
//   valid when tu >= s_lo, tv >= s_lo, tu + tv <= s_hi, u >= r_eps;
// it replaces the running best only under strict <.  reject_test.cuh's
// test runs on the exact numerators, tu's first: the constructor forms P,
// det, T, tu's numerator and the approximate reciprocal (24 operations, all
// that a pair refused on tu costs), maybe() tests them without a branch,
// and fold() forms Q and tests tv's, tu + tv's and u's numerators; the
// division and the exact compares run only for a pair neither test can
// reject.
struct TrianglePair {
  float det, tx, ty, tz, ntu, a, wtu;
  bool wide;

  TrianglePair() = default;

  __device__ __forceinline__ TrianglePair(float v0x, float v0y, float v0z,
                                          float e1x, float e1y, float e1z,
                                          float e2x, float e2y, float e2z,
                                          const Ray& r,
                                          const reject::Limits& L) {
    // P = D x E2
    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    det = e1x * px + e1y * py + e1z * pz;
    tx = r.ox - v0x;
    ty = r.oy - v0y;
    tz = r.oz - v0z;
    ntu = tx * px + ty * py + tz * pz;
    a = reject::approx_rcp(det);
    wide = reject::out_of_range(fabsf(det), L);
    wtu = ntu * a;
  }

  // False only where the exact arithmetic rejects the pair on |det| or tu.
  __device__ __forceinline__ bool maybe(const reject::Limits& L) const {
    return (fabsf(det) >= L.i_eps) & (wide | reject::inside(wtu, L.tu_win));
  }

  // The rest, for a pair maybe() keeps, folded into the running best as
  // triangle idx.
  __device__ __forceinline__ void fold(float e1x, float e1y, float e1z,
                                       float e2x, float e2y, float e2z,
                                       int idx, const Ray& r,
                                       const reject::Limits& L,
                                       reject::Best& best) const {
    // Q = T x E1
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float ntv = r.dx * qx + r.dy * qy + r.dz * qz;
    const float nu = e2x * qx + e2y * qy + e2z * qz;
    const float wtv = ntv * a;
    if (!(wide | ((wtv >= L.s_lo_w) & (wtu + wtv <= L.sum_hi_w) &
                  reject::inside(nu * a, best.win))))
      return;

    const float inv = 1.0f / det;  // |det| >= i_eps: 1 / (ok ? det : 1)
    const float tu = ntu * inv;
    const float tv = ntv * inv;
    const float u = nu * inv;
    if ((tu >= L.s_lo) && (tv >= L.s_lo) && (tu + tv <= L.s_hi) &&
        (u >= L.r_eps) && u < best.u)
      best.set(u, idx, L);
  }
};

// One pair folded into the running best, one branch after tu's test.
__device__ __forceinline__ void triangle_pair(
    float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, int idx, const Ray& r,
    const reject::Limits& L, reject::Best& best) {
  const TrianglePair pair(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, r, L);
  if (pair.maybe(L)) pair.fold(e1x, e1y, e1z, e2x, e2y, e2z, idx, r, L, best);
}

// ------------------------------------------------------------- the fold
//
// K3 and K4 compute a tile only for the rays of a block whose own gate
// passes (compaction.cuh).  The block's rays keep two float4 a ray in
// shared memory: ray_a (ox, oy, oz, dx) and ray_b (dy, dz, best u, best idx
// as int32 bits).

// This thread's ray into the block's shared arrays, with no best yet.
__device__ __forceinline__ void put_ray(float4* ray_a, float4* ray_b,
                                        const Ray& r) {
  ray_a[threadIdx.x] = make_float4(r.ox, r.oy, r.oz, r.dx);
  ray_b[threadIdx.x] = make_float4(r.dy, r.dz, kBig, __int_as_float(0));
}

// Fold the first `count` triangles of a tile (three rows of kRow float4:
// (v0x, v0y, v0z, E1x), (E1y, E1z, E2x, E2y), (E2z, -, -, -); column t is
// triangle base + t) into the bests of the `total` listed rays, and write
// each back to ray_b.  Every thread of the block calls it.
template <int kRow>
__device__ __forceinline__ void fold_listed(const float4* tile, int count,
                                            int base, int total,
                                            const int* list,
                                            const float4* ray_a,
                                            float4* ray_b,
                                            const reject::Limits& L) {
  const int me = threadIdx.x, warp = me >> 5;
  const int group = compaction::group_size(total);
  const int j = me / group, part = me % group;
  if (warp * 32 >= total * group) return;  // the same in the whole warp
  reject::Best best;
  int slot = 0;
  float4 b = make_float4(0.f, 0.f, kBig, __int_as_float(0));
  if (j < total) {
    slot = list[j];
    const float4 a = ray_a[slot];
    b = ray_b[slot];
    const Ray q{a.x, a.y, a.z, a.w, b.x, b.y, 0.f, 0.f, 0.f};
    best.set(b.z, __float_as_int(b.w), L);
    for (int t = part; t < count; t += group) {
      const float4 t0 = tile[t], t1 = tile[kRow + t], t2 = tile[2 * kRow + t];
      triangle_pair(t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w, t2.x,
                    base + t, q, L, best);
    }
  } else {
    best.u = kBig;
    best.idx = 0;
  }
  compaction::group_min(best.u, best.idx, group);
  if (j < total && part == 0)
    ray_b[slot] = make_float4(b.x, b.y, best.u, __int_as_float(best.idx));
}

// ------------------------------------------------------------ float64
//
// The float64 instances of K1 and K3: the plain version's float64
// operations in its order, with no reject test (reject_test.cuh's margins
// are float32's).  A pair ends early only where an exact compare of the
// plain version refuses it (|det| < i_eps, or tu < s_lo before Q is
// formed), so the result is the plain version's bit for bit.

namespace f64 {

constexpr double kBig = 3.0e38;   // the plain version's BIG, in float64
constexpr double kTiny = 1.0e-30;

struct Ray {
  double ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// The thresholds as the plain version compares with them: Python floats,
// so float64.
struct Limits {
  double i_eps, s_lo, s_hi, r_eps;
};

__device__ __forceinline__ double safe_inverse(double d) {
  return 1.0 / (fabs(d) < kTiny ? (d < 0.0 ? -kTiny : kTiny) : d);
}

// One ray with its inverse direction (K1 leaves it unread); rays past n
// stay zero.
__device__ __forceinline__ Ray load_ray(const double* __restrict__ p0,
                                        const double* __restrict__ p1,
                                        int ray, bool live) {
  Ray r{0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (live) {
    r.ox = p0[3 * ray + 0];
    r.oy = p0[3 * ray + 1];
    r.oz = p0[3 * ray + 2];
    r.dx = p1[3 * ray + 0] - r.ox;
    r.dy = p1[3 * ray + 1] - r.oy;
    r.dz = p1[3 * ray + 2] - r.oz;
  }
  r.ix = safe_inverse(r.dx);
  r.iy = safe_inverse(r.dy);
  r.iz = safe_inverse(r.dz);
  return r;
}

// tsearch::slab_gate in float64, on (C, 6) float64 boxes.
__device__ __forceinline__ bool slab_gate(const double* __restrict__ box,
                                          const Ray& r, double r_eps,
                                          double slack_hi, double slack_lo,
                                          double slack, double best_u) {
  double t1 = (box[0] - r.ox) * r.ix, t2 = (box[3] - r.ox) * r.ix;
  double tmin = fmin(t1, t2), tmax = fmax(t1, t2);
  t1 = (box[1] - r.oy) * r.iy;
  t2 = (box[4] - r.oy) * r.iy;
  tmin = fmax(tmin, fmin(t1, t2));
  tmax = fmin(tmax, fmax(t1, t2));
  t1 = (box[2] - r.oz) * r.iz;
  t2 = (box[5] - r.oz) * r.iz;
  tmin = fmax(tmin, fmin(t1, t2));
  tmax = fmin(tmax, fmax(t1, t2));
  return (tmax * slack_hi + slack >= fmax(tmin, r_eps)) &&
         (tmin * slack_lo - slack <= best_u);
}

// A tile of triangles in shared memory, five rows of kRow double2:
// (v0x, v0y), (v0z, E1x), (E1y, E1z), (E2x, E2y), (E2z, -); the edges
// computed once while staging.  Every thread of the block calls it.
template <int kRow>
__device__ __forceinline__ void stage_triangles(
    double2* tile, int base, int count, const double* __restrict__ vp,
    const double* __restrict__ v1, const double* __restrict__ v2) {
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int g = 3 * (base + t);
    const double ax = vp[g + 0], ay = vp[g + 1], az = vp[g + 2];
    tile[t] = make_double2(ax, ay);
    tile[kRow + t] = make_double2(az, v1[g + 0] - ax);
    tile[2 * kRow + t] = make_double2(v1[g + 1] - ay, v1[g + 2] - az);
    tile[3 * kRow + t] = make_double2(v2[g + 0] - ax, v2[g + 1] - ay);
    tile[4 * kRow + t] = make_double2(v2[g + 2] - az, 0.0);
  }
}

// A triangle's vertex v0 and edges E1, E2.
struct Triangle {
  double v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// Triangle t of a tile staged by stage_triangles.
template <int kRow>
__device__ __forceinline__ Triangle load_triangle(const double2* tile, int t) {
  const double2 a = tile[t], b = tile[kRow + t], c = tile[2 * kRow + t],
                d = tile[3 * kRow + t];
  return Triangle{a.x, a.y, b.x, b.y, c.x, c.y, d.x, d.y,
                  tile[4 * kRow + t].x};
}

// One ray-triangle pair folded into the ray's running best (u, idx) as
// triangle idx: the plain version's arithmetic (TrianglePair's formulas
// without its reject test); it replaces the best only under strict <.
__device__ __forceinline__ void fold_triangle(const Triangle& g, int idx,
                                              const Ray& r, const Limits& L,
                                              double& best_u, int& best_idx) {
  // P = D x E2
  const double px = r.dy * g.e2z - r.dz * g.e2y;
  const double py = r.dz * g.e2x - r.dx * g.e2z;
  const double pz = r.dx * g.e2y - r.dy * g.e2x;
  const double det = g.e1x * px + g.e1y * py + g.e1z * pz;
  if (!(fabs(det) >= L.i_eps)) return;
  const double inv = 1.0 / det;  // 1 / (ok ? det : 1)
  const double tx = r.ox - g.v0x, ty = r.oy - g.v0y, tz = r.oz - g.v0z;
  const double tu = (tx * px + ty * py + tz * pz) * inv;
  if (!(tu >= L.s_lo)) return;
  // Q = T x E1
  const double qx = ty * g.e1z - tz * g.e1y;
  const double qy = tz * g.e1x - tx * g.e1z;
  const double qz = tx * g.e1y - ty * g.e1x;
  const double tv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  const double u = (g.e2x * qx + g.e2y * qy + g.e2z * qz) * inv;
  if ((tv >= L.s_lo) && (tu + tv <= L.s_hi) && (u >= L.r_eps) && u < best_u) {
    best_u = u;
    best_idx = idx;
  }
}

}  // namespace f64

}  // namespace tsearch
