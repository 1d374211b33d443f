// Two-level nearest ray-segment hit search (K9), float32, for sm_90a.
//
// Replaces: tensorflowraytrace_tpu/ops/pallas_kernels.py,
// _twolevel_segment_kernel (launched through
// _nearest_hit_segments_twolevel_impl / nearest_hit_segments_pallas with
// cull="grid").
//
// What it computes: exactly what segment_search.cu (K5) computes, with K5's
// tile search (search2d::search_segments), so valid, idx and u equal K5's
// bit for bit.  It only skips pairs that cannot give a nearer hit.
//
// The design is K4's (triangle_search_twolevel.cu), written once for K9 and
// K10 as search2d::twolevel_walk: one block per ray block, each walking its
// own candidate list of fine chunks (or every chunk when its list overflowed
// the cap), chunk k + 1 staged with cp.async while chunk k is searched,
// every chunk gated by a block vote and a warp vote on K7's slab test
// against each ray's running best.  The fine chunk is the 2D kernels' tile
// (search2d::kTile = 256 segments, also the JAX package's FINE_CHUNK).
//
// Inputs, prepared by the wrapper (ops/segment_kernels.py) on the card:
// - the segment table chunk-major, (C, 4, 256) float32: chunk c holds
//   segments 256 c .. 256 c + 255 as rows start x, start y, direction x,
//   direction y (sp1 - sp0), zero past m;
// - the chunk boxes, (C, 4) float32 (models/acceleration.py chunk_aabbs_2d
//   widened by ops/segment_kernels.gate_boxes' rounding margin, as K7's);
// - counts (nb,) int32 and cand (nb * max_cand,) int32 from
//   twolevel_candidates on those same widened boxes: a chunk is a
//   candidate of a block when some ray of the block can hit its box at all.
//   Parked rays (p0 = 1e30) can hit no box, so a block of parked rays has
//   no candidate and writes u = 3e38.
//
// Left out from the TPU kernel: the ray-axis slabbing that kept the
// candidate table inside SMEM (_slab_ray_axis), its 1024-ray blocks and the
// (8, N) / (8, M) layouts.
//
// What bounds it: FP32 arithmetic on the admitted pairs (16 operations each,
// as in K5; the bound K7 has, at the same 256-segment chunks), plus one
// slab test per ray and candidate chunk and the candidate precompute
// outside the kernel.  The candidate lists skip the chunks no ray of a block
// can reach, the gate the chunks behind each warp's running best; cp.async
// keeps the copies off the critical path.

#include <cuda_runtime.h>

#include "search2d_common.cuh"

namespace {

// The most rays a block may hold: the launch bound keeps up to 128
// registers a thread.
constexpr int kMaxThreads = 512;

__global__ void __launch_bounds__(kMaxThreads)
segment_search_twolevel_kernel(const float* __restrict__ p0,
                               const float* __restrict__ p1,
                               const float* __restrict__ table,
                               const float* __restrict__ aabb,
                               const int* __restrict__ counts,
                               const int* __restrict__ cand, int n, int m,
                               int n_chunks, int max_cand, float i_eps,
                               float s_lo, float s_hi, float r_eps,
                               float slack_hi, float slack_lo, float slack,
                               float* __restrict__ u_out,
                               int* __restrict__ idx_out) {
  __shared__ __align__(16) search2d::SegmentTile buf[2];

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = ray < n;
  const search2d::Ray r = search2d::load_ray(p0, p1, ray, live);

  float best_u = search2d::kBig;
  int best_idx = 0;
  search2d::twolevel_walk(
      buf, table, aabb, counts, cand, n_chunks, max_cand, m, r, live, r_eps,
      slack_hi, slack_lo, slack, best_u,
      [&](const search2d::SegmentTile& tile, int count, int base) {
        search2d::search_segments(tile.row, count, base, r, i_eps, s_lo, s_hi,
                                  r_eps, best_u, best_idx);
      });
  if (live) {
    u_out[ray] = best_u;
    idx_out[ray] = best_idx;
  }
}

}  // namespace

// p0, p1: (n, 2) float32; table: (n_chunks, 4, fine) float32, 16-byte
// aligned, where fine must be the kernel's tile of 256 (else the launch
// returns cudaErrorInvalidValue); aabb: (n_chunks, 4) float32; counts:
// (ceil(n / ray_block),) int32; cand: (blocks * max_cand,) int32; ray_block
// a multiple of 32 in [32, 512] (else cudaErrorInvalidValue).  Thresholds and
// slack as in segment_search_culled_launch.  u_out: (n,) float32, idx_out:
// (n,) int32.  Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
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
  segment_search_twolevel_kernel<<<blocks, ray_block, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      p0, p1, table, aabb, counts, cand, n, m, n_chunks, max_cand, i_eps, s_lo,
      s_hi, r_eps, slack_hi, slack_lo, slack, u_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
