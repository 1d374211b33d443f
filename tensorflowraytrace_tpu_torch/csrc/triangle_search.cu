// Nearest ray-triangle hit search (brute force), float32, for sm_90a.
//
// Replaces: tensorflowraytrace_tpu/ops/pallas_kernels.py, _triangle_kernel
// (launched through _nearest_hit_triangles_impl / nearest_hit_triangles_pallas
// with cull=False).
//
// What it computes, per ray (Moller-Trumbore, the same algebra and the same
// order of operations as the plain PyTorch version in
// ops/triangle_kernels.py):
//   D = p1 - p0, E1 = v1 - vp, E2 = v2 - vp
//   P = D x E2, det = E1 . P; the pair is invalid when |det| < i_eps, and
//   inv = 1 / (ok ? det : 1), so nothing ever divides by zero
//   T = p0 - vp, Q = T x E1
//   tu = (T . P) inv, tv = (D . Q) inv, u = (E2 . Q) inv
//   valid when tu >= -s_eps, tv >= -s_eps, tu + tv <= 1 + s_eps, u >= r_eps
// and keeps the smallest valid u with the index of the FIRST triangle that
// gives it (strict < in triangle order).  A ray with no hit gets u = 3e38
// (the _BIG sentinel of the TPU kernel) and idx 0.  No gradient: the engine
// differentiates through the O(N) refine of the winning triangle instead.
//
// What bounds it: FP32 arithmetic.  Each ray-triangle pair costs about 40
// flops (two cross products, four dot products, one division, five
// compares) and, once a tile of triangles sits in shared memory, almost no
// bytes: a block of 256 rays reads each triangle's 36 bytes once from
// global memory and then uses it 256 times.  The N x M pair matrix never
// exists anywhere; the running best lives in registers.
//
// What the design does about it: one thread per ray, 256 threads per block.
// The block stages tiles of 256 triangles as (v0, E1, E2) -- nine floats,
// edges precomputed once per tile instead of once per pair -- in shared
// memory laid out structure-of-arrays.  Every thread of a warp reads the same
// triangle at the same time, so each shared-memory load is a broadcast with
// no bank conflicts.  The ragged last tile is masked by its count (the TPU
// kernel's zero padding of the triangle table does not carry over).  Speed
// work (several rays per thread, early-out on blocks with no ray alive,
// culling) is for later; this version is simple and right first.
//
// FMA: built with --fmad=false.  nvcc would otherwise contract a*b - c*d into
// fused multiply-adds, which rounds differently from the plain PyTorch
// version (each PyTorch elementwise op rounds on its own).  Without
// contraction every operation here is one correctly rounded IEEE float32
// operation in the plain version's order, so the kernel reproduces the plain
// version bit for bit and the validity tests at the s_eps / r_eps edges can
// never disagree between the two.  The cost is the FMA throughput this
// arithmetic-bound kernel gives up.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // rays per block, one per thread
constexpr int kTile = 256;      // triangles staged in shared memory per pass
constexpr float kBig = 3.0e38f; // no-hit sentinel (u < 1.5e38 means a hit)

__global__ void __launch_bounds__(kThreads)
triangle_search_kernel(const float* __restrict__ p0,
                       const float* __restrict__ p1,
                       const float* __restrict__ vp,
                       const float* __restrict__ v1,
                       const float* __restrict__ v2,
                       int n, int m,
                       float i_eps, float s_lo, float s_hi, float r_eps,
                       float* __restrict__ u_out, int* __restrict__ idx_out) {
  // structure-of-arrays tile: v0x v0y v0z e1x e1y e1z e2x e2y e2z
  __shared__ float tile[9][kTile];

  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (live) {
    ox = p0[3 * ray + 0];
    oy = p0[3 * ray + 1];
    oz = p0[3 * ray + 2];
    dx = p1[3 * ray + 0] - ox;
    dy = p1[3 * ray + 1] - oy;
    dz = p1[3 * ray + 2] - oz;
  }

  float best_u = kBig;
  int best_idx = 0;

  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < count; t += kThreads) {
      const int g = 3 * (base + t);
      const float ax = vp[g + 0], ay = vp[g + 1], az = vp[g + 2];
      tile[0][t] = ax;
      tile[1][t] = ay;
      tile[2][t] = az;
      tile[3][t] = v1[g + 0] - ax;
      tile[4][t] = v1[g + 1] - ay;
      tile[5][t] = v1[g + 2] - az;
      tile[6][t] = v2[g + 0] - ax;
      tile[7][t] = v2[g + 1] - ay;
      tile[8][t] = v2[g + 2] - az;
    }
    __syncthreads();

    for (int t = 0; t < count; ++t) {
      const float e1x = tile[3][t], e1y = tile[4][t], e1z = tile[5][t];
      const float e2x = tile[6][t], e2y = tile[7][t], e2z = tile[8][t];

      // P = D x E2
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;

      bool ok = fabsf(det) >= i_eps;
      const float inv = 1.0f / (ok ? det : 1.0f);

      const float tx = ox - tile[0][t];
      const float ty = oy - tile[1][t];
      const float tz = oz - tile[2][t];
      const float tu = (tx * px + ty * py + tz * pz) * inv;

      // Q = T x E1
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float tv = (dx * qx + dy * qy + dz * qz) * inv;
      const float u = (e2x * qx + e2y * qy + e2z * qz) * inv;

      ok = ok && (tu >= s_lo) && (tv >= s_lo) && (tu + tv <= s_hi) && (u >= r_eps);
      if (ok && u < best_u) {
        best_u = u;
        best_idx = base + t;
      }
    }
  }

  if (live) {
    u_out[ray] = best_u;
    idx_out[ray] = best_idx;
  }
}

}  // namespace

// p0, p1: (n, 3) float32 row-major; vp, v1, v2: (m, 3) float32 row-major.
// u_out: (n,) float32, idx_out: (n,) int32.  s_lo = -s_eps and
// s_hi = 1 + s_eps arrive precomputed (in double, then rounded to float) so
// the thresholds are the very float32 values the plain version compares
// with.  Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int triangle_search_launch(const float* p0, const float* p1,
                                      const float* vp, const float* v1,
                                      const float* v2, int n, int m,
                                      float i_eps, float s_lo, float s_hi,
                                      float r_eps, float* u_out, int* idx_out,
                                      void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  triangle_search_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      p0, p1, vp, v1, v2, n, m, i_eps, s_lo, s_hi, r_eps, u_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
