// The slab gate and the per-tile Moller-Trumbore search shared by the
// culled (K3, triangle_search_culled.cu) and two-level (K4,
// triangle_search_twolevel.cu) triangle searches.
//
// The arithmetic is K1's (triangle_search.cu): the same float32 operations
// in the same order, built with --fmad=false, so that both kernels return
// K1's valid, idx and u bit for bit.  K1 keeps its own copy, unchanged.

#pragma once

#include <cuda_runtime.h>

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

__device__ __forceinline__ Ray load_ray(const float* __restrict__ p0,
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

// Fold the first `count` triangles of a shared-memory tile, stored as nine
// rows of kRow floats (v0 xyz, E1 xyz, E2 xyz), into the ray's running best;
// column t is triangle base + t.  A triangle replaces the best only under
// strict <, so a tie keeps the first index.
template <int kRow>
__device__ __forceinline__ void search_tile(const float (*tile)[kRow],
                                            int count, int base, const Ray& r,
                                            float i_eps, float s_lo,
                                            float s_hi, float r_eps,
                                            float& best_u, int& best_idx) {
  for (int t = 0; t < count; ++t) {
    const float e1x = tile[3][t], e1y = tile[4][t], e1z = tile[5][t];
    const float e2x = tile[6][t], e2y = tile[7][t], e2z = tile[8][t];

    // P = D x E2
    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;

    bool ok = fabsf(det) >= i_eps;
    const float inv = 1.0f / (ok ? det : 1.0f);

    const float tx = r.ox - tile[0][t];
    const float ty = r.oy - tile[1][t];
    const float tz = r.oz - tile[2][t];
    const float tu = (tx * px + ty * py + tz * pz) * inv;

    // Q = T x E1
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float tv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
    const float u = (e2x * qx + e2y * qy + e2z * qz) * inv;

    ok = ok && (tu >= s_lo) && (tv >= s_lo) && (tu + tv <= s_hi) &&
         (u >= r_eps);
    if (ok && u < best_u) {
      best_u = u;
      best_idx = base + t;
    }
  }
}

}  // namespace tsearch
