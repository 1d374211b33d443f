// The reject test of the nearest-hit searches: decide cheaply, without a
// division, that a ray-surface pair cannot pass its validity tests, and run
// the exact arithmetic only for the pairs that might.
//
// The exact arithmetic of a pair (K5's and K1's, and their plain versions')
// forms numerators n_k and a denominator den, inv = 1 / den (IEEE), and
// compares each value v_k = n_k * inv with a threshold t (u >= r_eps,
// s_lo <= s <= s_hi, u < best_u).  The test computes the same numerators
// and den, bit for bit, then a = rcp.approx(den) (no division: one
// MUFU.RCP) and w_k = n_k * a, and compares w_k with t widened by
// below(t) / above(t); a range [lo, hi] is one Window, so a value costs one
// FADD and one compare.  A pair is sent to the exact arithmetic unless some
// w_k fails its widened threshold (or |den| < i_eps, which both sides test
// exactly), so the test only ever skips pairs the exact arithmetic
// rejects, and a kernel that uses it returns the exact arithmetic's u and
// idx bit for bit.
//
// The margin.  With q = n / den the exact quotient:
// - v = fl(n * fl(1 / den)): fl(1 / den) is within 2^-24 of 1 / den
//   relatively and the product rounds once more, so |v - q| <= (2^-23 +
//   2^-48) |q|, plus 2^-150 where the product is subnormal (no flush: the
//   kernels are built without -ftz, and every operand here is normal).
// - w = fl(n * a): rcp.approx.ftz.f32 is within 1 ulp of 1 / den (2^-23
//   relatively, PTX ISA) as long as neither den nor 1 / den is subnormal,
//   which out_of_range checks (|den| in [2^-125, 2^126]; den outside it goes
//   to the exact arithmetic); so |w - q| <= (2^-23 + 2^-24 + 2^-46) |q| +
//   2^-150.
// - So |w - v| <= 2^-21.4 |v| + 2^-148.  v >= t then gives w >= t -
//   2^-21.4 |t| - 2^-148 for either sign of t and v, and v <= t gives w <=
//   t + 2^-21.4 |t| + 2^-148.  below(t) = t - 2^-18 |t| - 2^-126 and
//   above(t) = t + 2^-18 |t| + 2^-126 cover that with room for their own
//   float32 rounding (2^-24 |t|).  The absolute part matters only when t
//   is near 0, as s_lo = -s_eps may be: it is absorbed, harmlessly, when
//   |t| is large.
// - The triangle's tests tu >= s_lo, tv >= s_lo, tu + tv <= s_hi: when
//   they pass exactly, tu and tv lie in [s_lo, s_hi - s_lo] (up to a
//   rounding), so the test may also reject tu > above(s_hi - s_lo), and
//   the errors of the two w's in the sum stay below 2^-20.4 (|s_hi| +
//   |s_lo|) + 2^-147; sum_hi = s_hi + 2^-17 (|s_hi| + |s_lo|) + 2^-126
//   covers them and the sums' own rounding.
// - NaN fails every comparison on both sides; an overflow to inf of w
//   where v is finite cannot happen below best_u <= 3e38.

#pragma once

#include <cuda_runtime.h>

namespace reject {

constexpr float kRel = 0x1p-18f;      // relative margin
constexpr float kAbs = 0x1p-126f;     // absolute margin
constexpr float kDenLo = 0x1p-125f;   // approx_rcp's range: |den| in
constexpr float kDenHi = 0x1p126f;    // [kDenLo, kDenHi]

__device__ __forceinline__ float approx_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ __forceinline__ float below(float t) {
  return t - fabsf(t) * kRel - kAbs;
}

__host__ __device__ __forceinline__ float above(float t) {
  return t + fabsf(t) * kRel + kAbs;
}

// [mid - half, mid + half], a closed interval that holds [lo, hi]: one
// FADD and one compare of |w - mid| <= half test both ends (rounding is
// monotone and half is a float, so |w - mid| <= half holds for every float
// w in [lo, hi]).  hi <= 3.1e38 keeps both finite.
struct Window {
  float mid, half;
};

__host__ __device__ __forceinline__ Window window(float lo, float hi) {
  const float mid = 0.5f * lo + 0.5f * hi;
  const float half = fmaxf(hi - mid, mid - lo);
  return Window{mid, half + half * 0x1p-20f + kAbs};
}

__host__ __device__ __forceinline__ bool inside(float w, const Window& win) {
  return fabsf(w - win.mid) <= win.half;
}

// The thresholds of one search: the exact ones and their widened forms.
// A launcher computes them on the host and passes them by value, so the
// kernels read them from the parameter bank, not registers.
struct Limits {
  float i_eps, s_lo, s_hi, r_eps;   // exact
  float den_hi;                     // kDenHi; -1 when i_eps < kDenLo
  float r_eps_w;                    // below(r_eps)
  Window s_win;                     // [below(s_lo), above(s_hi)]
  float s_lo_w, sum_hi_w;           // the triangles': below(s_lo), the
  Window tu_win;                    // bound of tu + tv, [below(s_lo),
                                    // above(s_hi - s_lo)]
};

__host__ __device__ __forceinline__ Limits limits(float i_eps, float s_lo,
                                                  float s_hi, float r_eps) {
  return Limits{i_eps,
                s_lo,
                s_hi,
                r_eps,
                i_eps >= kDenLo ? kDenHi : -1.0f,
                below(r_eps),
                window(below(s_lo), above(s_hi)),
                below(s_lo),
                s_hi + (fabsf(s_hi) + fabsf(s_lo)) * 0x1p-17f + kAbs,
                window(below(s_lo), above(s_hi - s_lo))};
}

// |den| >= i_eps outside approx_rcp's range: the pair goes to the exact
// arithmetic.  With i_eps >= kDenLo (1e-6 in float32) only the upper end
// needs a compare; below that every pair goes (den_hi = -1).
__device__ __forceinline__ bool out_of_range(float abs_den, const Limits& L) {
  return abs_den > L.den_hi;
}

// A ray's running best: ray parameter u, surface idx, and the window of
// ray parameters a pair must reach to replace it, [below(r_eps), above(u)].
struct Best {
  float u;
  int idx;
  Window win;

  __device__ __forceinline__ void set(float new_u, int new_idx,
                                      const Limits& L) {
    u = new_u;
    idx = new_idx;
    win = window(L.r_eps_w, above(new_u));
  }
};

}  // namespace reject
