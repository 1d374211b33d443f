// Two-level nearest ray-arc hit search (K10), float32, for sm_90a.
//
// Replaces: tensorflowraytrace_tpu/ops/pallas_kernels.py,
// _twolevel_arc_kernel (launched through _nearest_hit_arcs_twolevel_impl /
// nearest_hit_arcs_pallas with cull="grid").
//
// What it computes: exactly what arc_search.cu (K6) computes, with K6's
// tile search (search2d::search_arcs), so valid, idx, u and branch equal
// K6's bit for bit.  Two departures from the TPU kernel follow from that,
// as in K6 and K8: the discriminant is evaluated as 4 (a - (x_r x d_r)^2),
// not b^2 - 4 a c, which is float32 noise for rays thousands of radii from
// the 2D guide's lenslets (the note in search2d_common.cuh); and each arc
// carries its own branch choice into the running best, where the TPU kernel
// took the branch of the tile's minima (they differ only at exact ties).
//
// The design is K9's (segment_search_twolevel.cu): search2d::twolevel_walk
// over fine chunks of search2d::kTile = 256 arcs.  Its inputs, prepared by
// the wrapper (ops/arc_kernels.py) on the card:
// - the arc table chunk-major, (C, 8, 256) 4-byte words, one
//   search2d::ArcTile per chunk: centre x, centre y, 1 / radius, cos and
//   sin of the window's start and end (float32), and the window flags as
//   int32 bits, zero past m;
// - the chunk boxes over the arcs' window-aware boxes, (C, 4) float32
//   (models/acceleration.py chunk_aabbs_arcs widened by
//   ops/segment_kernels.gate_boxes, as K8's);
// - counts and cand from twolevel_candidates on those widened boxes, as
//   K9's.  A block of parked rays has no candidate.
//
// Left out from the TPU kernel: the ray-axis slabbing (_slab_ray_axis), its
// 1024-ray blocks, the (16, M) layout and its dead padding column (the
// ragged chunk is searched for its real arcs only).
//
// What bounds it: FP32 arithmetic on the admitted pairs (50 operations each,
// as in K6; the bound K8 has, at the same 256-arc chunks), plus one slab
// test per ray and candidate chunk and the candidate precompute outside the
// kernel.

#include <cuda_runtime.h>

#include "search2d_common.cuh"

namespace {

// The most rays a block may hold: the launch bound keeps up to 128
// registers a thread.
constexpr int kMaxThreads = 512;

__global__ void __launch_bounds__(kMaxThreads)
arc_search_twolevel_kernel(const float* __restrict__ p0,
                           const float* __restrict__ p1,
                           const float* __restrict__ table,
                           const float* __restrict__ aabb,
                           const int* __restrict__ counts,
                           const int* __restrict__ cand, int n, int m,
                           int n_chunks, int max_cand, float i_eps,
                           float r_eps, float slack_hi, float slack_lo,
                           float slack, float* __restrict__ u_out,
                           int* __restrict__ idx_out,
                           unsigned char* __restrict__ branch_out) {
  __shared__ __align__(16) search2d::ArcTile buf[2];

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = ray < n;
  const search2d::Ray r = search2d::load_ray(p0, p1, ray, live);

  float best_u = search2d::kBig;
  int best_idx = 0;
  bool best_minus = false;
  search2d::twolevel_walk(
      buf, table, aabb, counts, cand, n_chunks, max_cand, m, r, live, r_eps,
      slack_hi, slack_lo, slack, best_u,
      [&](const search2d::ArcTile& tile, int count, int base) {
        search2d::search_arcs(tile, count, base, r, i_eps, r_eps, best_u,
                              best_idx, best_minus);
      });
  if (live) {
    u_out[ray] = best_u;
    idx_out[ray] = best_idx;
    branch_out[ray] = best_minus ? 1 : 0;
  }
}

}  // namespace

// p0, p1: (n, 2) float32; table: (n_chunks, 8, fine) 4-byte words, 16-byte
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
  arc_search_twolevel_kernel<<<blocks, ray_block, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      p0, p1, table, aabb, counts, cand, n, m, n_chunks, max_cand, i_eps,
      r_eps, slack_hi, slack_lo, slack, u_out, idx_out, branch_out);
  return static_cast<int>(cudaGetLastError());
}
