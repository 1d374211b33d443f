// Two-level nearest ray-triangle hit search (K4), float32 and float64, for
// sm_90a.
//
// Replaces: tensorflowraytrace_tpu/ops/pallas_kernels.py,
// _twolevel_triangle_kernel (launched through
// _nearest_hit_triangles_twolevel_impl / nearest_hit_triangles_pallas with
// cull="grid").
//
// What it computes: exactly what csrc/triangle_search.cu (K1) computes --
// per ray the smallest valid Moller-Trumbore u and the index of the first
// triangle that gives it, u = 3e38 and idx 0 on a miss -- with the same
// float32 operations in the same order (built with --fmad=false, see K1's
// note), so valid, idx and u equal K1's bit for bit.
//
// Inputs, prepared by the wrapper (ops/triangle_kernels.py) on the card:
// - the triangle table chunk-major, (C, 3, F, 4) in the rays' dtype: fine
//   chunk c holds triangles c*F .. c*F+F-1 as three rows of F 4-vectors,
//   (v0x, v0y, v0z, E1x), (E1y, E1z, E2x, E2y), (E2z, 0, 0, 0) -- K3's
//   tile -- zero past m;
// - the chunk boxes, (C, 6) in that dtype (models/acceleration.py
//   chunk_aabbs at F triangles, widened as K3's by
//   ops/triangle_kernels.culled_boxes: each ray's own gate decides, so each
//   box must hold every point Moller-Trumbore accepts);
// - counts (nb,) int32 and cand (nb * max_cand,) int32 from
//   twolevel_candidates on those boxes: block b walks cand[b*max_cand ...]
//   for counts[b] steps, or every chunk 0 .. C-1 in order when counts[b] ==
//   C (its list overflowed the cap).  A chunk is a candidate of a block
//   when some ray of the block can hit its box at all.
//
// The design, against the TPU kernel's:
// - The grid: one block per ray block (blockDim.x rays, one per thread).
//   The block reads its own count and candidate ids from global memory;
//   this takes the place of the TPU's scalar prefetch into SMEM (so the
//   TPU's SMEM-driven slabbing of the ray axis, _slab_ray_axis, has no
//   counterpart).
// - Staging: candidate k+1 is copied into the second of two shared-memory
//   buffers with cp.async (16 bytes a thread) while candidate k is
//   computed; this takes the place of make_async_copy and the two DMA
//   semaphores.
// - K3's compaction (compaction::compact in compaction.cuh,
//   tsearch::fold_listed in triangle_search_common.cuh): before computing candidate k each thread
//   slab-tests its own ray against the chunk's box and its running best
//   (tsearch::slab_gate: can it hit the box at t >= r_eps, no farther than
//   best_u, with slack 1 +- 1e-6); a ballot and a scan list the rays that
//   pass, and the whole block computes only those, `group` threads a listed
//   ray.  A candidate no ray needs costs one gate and one barrier (the
//   warps' counts are double-buffered, so no second barrier guards them).
//   The plain version gates ray by ray to match.
// - The ragged last chunk is masked by its count of real triangles.
// - The fine chunk is a constant, kFine = 512 (FINE_CHUNK in Python; a
//   256-triangle chunk halves K4's time alone but doubles the dense
//   candidate precompute, and lost the trace on the H100, see PERF.md): the
//   tile rows sit at constant offsets.  Two buffers of 512 triangles are
//   48 KB and the rays 36 bytes each, above the 48 KB of static shared
//   memory, so the block's shared memory is one dynamic array, its limit
//   raised with cudaFuncSetAttribute.
//
// What bounds it: FP32 arithmetic on the admitted pairs (24 operations for
// one refused on tu, 46 for the rest, as in K3), plus the per-step slab
// tests and the candidate precompute outside the kernel.  The candidate
// lists and the gate keep the admitted pairs near the pairs a ray can
// improve on; cp.async keeps the copies off the critical path.
//
// The float64 instance (triangle_search_twolevel_launch_f64), K3's float64
// design over the same candidate lists: no compaction, no reject test, no
// cp.async.  Each thread keeps its ray and running best in registers and
// gates its own ray on the chunk's float64 box (tsearch::f64::slab_gate);
// the block stages the chunk when one of its rays passes
// (__syncthreads_or), from the float64 table (96 bytes a triangle) into
// one buffer of K3's float64 tile, five rows of double2 a triangle (40 KB
// at F = 512, under the 48 KB of static shared memory, so no second
// buffer and no raised limit), and each ray that passed folds the chunk
// with K1's float64 pair (tsearch::f64::fold_triangle).  So K4 equals K1's
// float64 instance bit for bit.  What bounds it: FP64 issue slots on the
// admitted pairs and the warps' idle lanes.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "triangle_search_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kFine = 512;  // triangles per fine chunk

// shared memory: two chunk buffers, two float4 a ray, the list, two arrays
// of the warps' counts
size_t shared_bytes(int ray_block) {
  return sizeof(float4) * (2 * 3 * kFine + 2 * ray_block) +
         sizeof(int) * (ray_block + 2 * 32);
}

__global__ void __launch_bounds__(kMaxThreads)
triangle_search_twolevel_kernel(const float* __restrict__ p0,
                                const float* __restrict__ p1,
                                const float4* __restrict__ table,
                                const float* __restrict__ aabb,
                                const int* __restrict__ counts,
                                const int* __restrict__ cand,
                                int n, int m, int n_chunks,
                                int max_cand, const reject::Limits lim,
                                float slack_hi, float slack_lo, float slack,
                                float* __restrict__ u_out,
                                int* __restrict__ idx_out) {
  constexpr int kChunkVecs = 3 * kFine;  // float4 of one chunk
  extern __shared__ float4 smem[];
  float4* buf = smem;                             // 2 chunks
  float4* ray_a = buf + 2 * kChunkVecs;           // ox oy oz dx
  float4* ray_b = ray_a + blockDim.x;             // dy dz best_u best_idx
  int* list = reinterpret_cast<int*>(ray_b + blockDim.x);
  int* warp_count = list + blockDim.x;            // 2 x 32

  const int b = blockIdx.x, me = threadIdx.x;
  const int ray = b * blockDim.x + me;
  const bool live = ray < n;
  const tsearch::Ray r = tsearch::load_ray(p0, p1, ray, live);
  tsearch::put_ray(ray_a, ray_b, r);

  const int cnt = counts[b];
  const bool sweep = cnt == n_chunks;
  const int* cands = cand + static_cast<size_t>(b) * max_cand;
  auto chunk_id = [&](int k) {
    return sweep ? k : cands[min(k, max_cand - 1)];
  };
  auto stage = [&](int c, int slot) {
    const float4* src = table + static_cast<size_t>(c) * kChunkVecs;
    float4* dst = buf + slot * kChunkVecs;
    for (int i = me; i < kChunkVecs; i += blockDim.x)
      __pipeline_memcpy_async(dst + i, src + i, sizeof(float4));
    __pipeline_commit();
  };

  if (cnt > 0) stage(chunk_id(0), 0);
  for (int k = 0; k < cnt; ++k) {
    const int c = chunk_id(k);
    if (k + 1 < cnt) {
      // buffer (k + 1) & 1 was last read at step k - 1, before its barrier
      stage(chunk_id(k + 1), (k + 1) & 1);
      __pipeline_wait_prior(1);  // this thread's copies of chunk k landed
    } else {
      __pipeline_wait_prior(0);
    }
    const bool need = live && tsearch::slab_gate(aabb + 6 * c, r, lim.r_eps,
                                                 slack_hi, slack_lo, slack,
                                                 ray_b[me].z);
    // its barrier also makes every thread's copies of chunk k visible
    const int total =
        compaction::compact(need, list, warp_count + 32 * (k & 1));
    if (total == 0) continue;  // the same in every thread
    __syncthreads();  // the list is written
    const int base = c * kFine;
    tsearch::fold_listed<kFine>(buf + (k & 1) * kChunkVecs,
                                min(kFine, m - base), base, total, list,
                                ray_a, ray_b, lim);
    __syncthreads();  // the bests are written; the buffer and list are free
  }

  // every best was written before a barrier this thread has passed
  if (live) {
    u_out[ray] = ray_b[me].z;
    idx_out[ray] = __float_as_int(ray_b[me].w);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
triangle_search_twolevel_f64_kernel(const double* __restrict__ p0,
                                    const double* __restrict__ p1,
                                    const double* __restrict__ table,
                                    const double* __restrict__ aabb,
                                    const int* __restrict__ counts,
                                    const int* __restrict__ cand, int n,
                                    int m, int n_chunks, int max_cand,
                                    const tsearch::f64::Limits lim,
                                    double slack_hi, double slack_lo,
                                    double slack, double* __restrict__ u_out,
                                    int* __restrict__ idx_out) {
  __shared__ double2 tile[5 * kFine];  // 40 KB

  const int b = blockIdx.x;
  const int ray = b * blockDim.x + threadIdx.x;
  const bool live = ray < n;
  const tsearch::f64::Ray r = tsearch::f64::load_ray(p0, p1, ray, live);
  double best_u = tsearch::f64::kBig;
  int best_idx = 0;

  const int cnt = counts[b];
  const bool sweep = cnt == n_chunks;
  const int* cands = cand + static_cast<size_t>(b) * max_cand;
  for (int k = 0; k < cnt; ++k) {
    const int c = sweep ? k : cands[min(k, max_cand - 1)];
    const bool need = live && tsearch::f64::slab_gate(aabb + 6 * c, r,
                                                      lim.r_eps, slack_hi,
                                                      slack_lo, slack, best_u);
    // also the barrier after the previous chunk's last read
    if (!__syncthreads_or(need)) continue;  // the same in every thread
    // the chunk's three rows of F 4-vectors into the five rows of double2
    // that tsearch::f64::load_triangle reads
    const double* rows = table + static_cast<size_t>(c) * 3 * kFine * 4;
    for (int t = threadIdx.x; t < kFine; t += blockDim.x) {
      const double* a = rows + 4 * t;
      const double* e = a + 4 * kFine;
      tile[t] = make_double2(a[0], a[1]);
      tile[kFine + t] = make_double2(a[2], a[3]);
      tile[2 * kFine + t] = make_double2(e[0], e[1]);
      tile[3 * kFine + t] = make_double2(e[2], e[3]);
      tile[4 * kFine + t] = make_double2(e[4 * kFine], 0.0);
    }
    __syncthreads();
    if (need) {
      const int base = c * kFine, count = min(kFine, m - base);
      for (int t = 0; t < count; ++t)
        tsearch::f64::fold_triangle(
            tsearch::f64::load_triangle<kFine>(tile, t), base + t, r, lim,
            best_u, best_idx);
    }
  }
  if (live) {
    u_out[ray] = best_u;
    idx_out[ray] = best_idx;
  }
}

}  // namespace

// p0, p1: (n, 3) float32; table: (n_chunks, 3, fine, 4) float32, 16-byte
// aligned, where fine must be 512 (else the launch returns
// cudaErrorInvalidValue); aabb: (n_chunks, 6) float32; counts:
// (ceil(n / ray_block),) int32; cand: (blocks * max_cand,) int32.  u_out:
// (n,) float32, idx_out: (n,) int32.  ray_block is the block size (a
// multiple of 32, at most 1024).  Thresholds and slack as in
// triangle_search_culled_launch.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int triangle_search_twolevel_launch(
    const float* p0, const float* p1, const float* table, const float* aabb,
    const int* counts, const int* cand, int n, int m, int n_chunks, int fine,
    int ray_block, int max_cand, float i_eps, float s_lo, float s_hi,
    float r_eps, float slack_hi, float slack_lo, float slack, float* u_out,
    int* idx_out, void* stream) {
  if (fine != kFine || ray_block % 32 != 0 || ray_block < 32 ||
      ray_block > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = shared_bytes(ray_block);
  const cudaError_t err = cudaFuncSetAttribute(
      triangle_search_twolevel_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + ray_block - 1) / ray_block;
  triangle_search_twolevel_kernel<<<blocks, ray_block, bytes,
                                    static_cast<cudaStream_t>(stream)>>>(
      p0, p1, reinterpret_cast<const float4*>(table), aabb, counts, cand, n,
      m, n_chunks, max_cand, reject::limits(i_eps, s_lo, s_hi, r_eps),
      slack_hi, slack_lo, slack, u_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}

// The float64 instance: p0, p1, table ((n_chunks, 3, fine, 4) doubles),
// aabb and u_out float64 (as triangle_kernels.twolevel_prepare makes them
// in float64), the thresholds and slack the float64 values the plain
// version compares with; counts, cand, fine and ray_block as above.
extern "C" int triangle_search_twolevel_launch_f64(
    const double* p0, const double* p1, const double* table,
    const double* aabb, const int* counts, const int* cand, int n, int m,
    int n_chunks, int fine, int ray_block, int max_cand, double i_eps,
    double s_lo, double s_hi, double r_eps, double slack_hi, double slack_lo,
    double slack, double* u_out, int* idx_out, void* stream) {
  if (fine != kFine || ray_block % 32 != 0 || ray_block < 32 ||
      ray_block > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + ray_block - 1) / ray_block;
  triangle_search_twolevel_f64_kernel<<<blocks, ray_block, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
      p0, p1, table, aabb, counts, cand, n, m, n_chunks, max_cand,
      tsearch::f64::Limits{i_eps, s_lo, s_hi, r_eps}, slack_hi, slack_lo,
      slack, u_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
