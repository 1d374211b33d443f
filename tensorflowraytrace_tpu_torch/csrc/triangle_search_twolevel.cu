// Two-level nearest ray-triangle hit search (K4), float32, for sm_90a.
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
// - the triangle table chunk-major, (C, 9, F) float32: fine chunk c holds
//   rows c*F .. c*F+F-1 as (v0, E1, E2) structure-of-arrays, zero past m;
// - the chunk boxes, (C, 6) float32 (models/acceleration.py chunk_aabbs);
// - counts (nb,) int32 and cand (nb * max_cand,) int32 from
//   twolevel_candidates: block b walks cand[b*max_cand ...] for counts[b]
//   steps, or every chunk 0 .. C-1 in order when counts[b] == C (its list
//   overflowed the cap).  A chunk is a candidate of a block when some ray
//   of the block can hit its box at all.
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
// - The improving gate: before computing candidate k each thread slab-tests
//   its ray against the chunk's box and its running best (K3's test,
//   tsearch::slab_gate in triangle_search_common.cuh: can it hit the box
//   at t >= r_eps, no farther than best_u, with slack 1 +- 1e-6).  A
//   block vote (__syncthreads_or) skips chunks no ray of the block needs,
//   and a warp vote (__any_sync) skips the arithmetic of warps none of
//   whose rays need it.  The plain version gates groups of 32 rays to
//   match.
// - The ragged last chunk is masked by its count of real triangles.
// - The fine chunk is fixed at compile time (kFine = 512, chosen on the
//   H100, see PERF.md): the tile rows sit at constant offsets.
//
// What bounds it: FP32 arithmetic on the admitted pairs (about 46 flops
// each), plus the per-step slab tests and the candidate precompute outside
// the kernel.  The candidate lists and the gate keep the admitted pairs near
// the pairs a ray can improve on; cp.async keeps the copies off the
// critical path.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "triangle_search_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kFine = 512;  // triangles per fine chunk; FINE_CHUNK in Python

__global__ void __launch_bounds__(kMaxThreads)
triangle_search_twolevel_kernel(const float* __restrict__ p0,
                                const float* __restrict__ p1,
                                const float* __restrict__ table,
                                const float* __restrict__ aabb,
                                const int* __restrict__ counts,
                                const int* __restrict__ cand,
                                int n, int m, int n_chunks,
                                int max_cand, float i_eps, float s_lo,
                                float s_hi, float r_eps, float slack_hi,
                                float slack_lo, float slack,
                                float* __restrict__ u_out,
                                int* __restrict__ idx_out) {
  // two buffers of one chunk each: 9 rows of kFine floats
  __shared__ __align__(16) float smem[2][9][kFine];
  constexpr int chunk_floats = 9 * kFine;

  const int b = blockIdx.x;
  const int ray = b * blockDim.x + threadIdx.x;
  const bool live = ray < n;
  const tsearch::Ray r = tsearch::load_ray(p0, p1, ray, live);

  const int cnt = counts[b];
  const bool sweep = cnt == n_chunks;
  const int* list = cand + static_cast<size_t>(b) * max_cand;
  auto chunk_id = [&](int k) { return sweep ? k : list[min(k, max_cand - 1)]; };

  auto stage = [&](int c, int slot) {
    const float4* src = reinterpret_cast<const float4*>(
        table + static_cast<size_t>(c) * chunk_floats);
    float4* dst = reinterpret_cast<float4*>(&smem[slot][0][0]);
    for (int i = threadIdx.x; i < chunk_floats / 4; i += blockDim.x)
      __pipeline_memcpy_async(dst + i, src + i, sizeof(float4));
    __pipeline_commit();
  };

  float best_u = tsearch::kBig;
  int best_idx = 0;

  if (cnt > 0) stage(chunk_id(0), 0);
  for (int k = 0; k < cnt; ++k) {
    const int c = chunk_id(k);
    if (k + 1 < cnt) {
      stage(chunk_id(k + 1), (k + 1) & 1);
      __pipeline_wait_prior(1);  // this thread's copies of chunk k landed
    } else {
      __pipeline_wait_prior(0);
    }

    const bool need = live && tsearch::slab_gate(aabb + 6 * c, r, r_eps,
                                                 slack_hi, slack_lo, slack,
                                                 best_u);
    const bool warp_need = __any_sync(0xffffffffu, need);
    // the barrier after which every thread's copies of chunk k are visible
    if (__syncthreads_or(need) && warp_need) {
      const int base = c * kFine;
      tsearch::search_tile<kFine>(smem[k & 1], min(kFine, m - base), base, r,
                                  i_eps, s_lo, s_hi, r_eps, best_u, best_idx);
    }
    __syncthreads();  // buffer k & 1 is no longer read: step k+1 refills it
  }

  if (live) {
    u_out[ray] = best_u;
    idx_out[ray] = best_idx;
  }
}

}  // namespace

// p0, p1: (n, 3) float32; table: (n_chunks, 9, fine) float32, 16-byte
// aligned, where fine must be the kernel's 512 (else the launch returns
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
  if (fine != kFine) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + ray_block - 1) / ray_block;
  triangle_search_twolevel_kernel<<<blocks, ray_block, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      p0, p1, table, aabb, counts, cand, n, m, n_chunks, max_cand, i_eps,
      s_lo, s_hi, r_eps, slack_hi, slack_lo, slack, u_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
