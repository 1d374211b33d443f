// The compaction of a block's rays that need a tile, and the group fold's
// reduction, shared by the culled and two-level searches that compute a
// tile only for the rays whose own gate passes: K3 and K4
// (triangle_search_common.cuh) and K7-K10 (search2d_common.cuh).
//
// After the first bounce about a tenth of a block's rays need a given tile,
// and different ones from tile to tile, so a warp vote would compute most
// tiles for 32 rays to serve three.  Instead:
// - The block's rays (one a thread) keep their origin, direction and
//   running best in shared memory.
// - compact: every thread gates its own ray; a ballot and a scan of the
//   warps' counts write the slots of the k rays that need the tile into a
//   list.  A tile then costs in proportion to the rays that need it.
// - The whole block computes the listed rays, `group` threads a ray
//   (group_size), each folding every group-th surface of the tile into its
//   own copy of the ray's best; group_min takes the group's smallest (u,
//   idx), which is what the fold of the whole tile in index order under
//   strict < gives.  One thread a listed ray would leave nine tenths of the
//   threads idle and the SM short of warps to hide latency.

#pragma once

#include <cuda_runtime.h>

namespace compaction {

constexpr unsigned kFull = 0xffffffffu;

// The rays of the block that need a tile: every thread passes its own
// `need`; the slots (thread ids) of those that need it go to list[0 ..
// total - 1] in thread order, and total is returned, the same in every
// thread.  `warp_count` (32 ints) is written before one __syncthreads
// inside and read after it, so a caller that compacts again with no barrier
// in between passes another array.  The list is written after that
// barrier: a caller reads it only after a barrier of its own.
__device__ __forceinline__ int compact(bool need, int* list, int* warp_count) {
  const int me = threadIdx.x, lane = me & 31, warp = me >> 5;
  const unsigned vote = __ballot_sync(kFull, need);
  if (lane == 0) warp_count[warp] = __popc(vote);
  __syncthreads();
  // inclusive scan of the warps' counts, in every warp
  int c = lane < static_cast<int>(blockDim.x >> 5) ? warp_count[lane] : 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, c, d);
    if (lane >= d) c += up;
  }
  const int total = __shfl_sync(kFull, c, 31);
  const int before = __shfl_sync(kFull, c, warp) - __popc(vote);
  if (need) list[before + __popc(vote & ((1u << lane) - 1u))] = me;
  return total;
}

// Threads a listed ray: the largest power of two up to 32 with group *
// total <= the block's threads.  Thread me computes listed ray me / group,
// part me % group of it; a warp whose first thread is past total * group
// has no ray.
__device__ __forceinline__ int group_size(int total) {
  int group = 32;
  while (group * total > static_cast<int>(blockDim.x)) group >>= 1;
  return group;
}

// The smallest (u, idx) over the `group` threads of a group (aligned lanes
// of one warp, a power of two), the smaller idx at equal u: every thread of
// the warp calls it, and each ends with its group's result.  idx may be any
// key that orders as the surfaces' indices do (K10's carries the branch).
// A thread folded its surfaces in index order under strict <, starting from
// the ray's best of earlier tiles, whose idx is below every idx of this
// tile, so this is the in-order fold of the whole tile.
__device__ __forceinline__ void group_min(float& u, int& idx, int group) {
  for (int d = 1; d < group; d <<= 1) {
    const float other_u = __shfl_xor_sync(kFull, u, d);
    const int other_idx = __shfl_xor_sync(kFull, idx, d);
    if (other_u < u || (other_u == u && other_idx < idx)) {
      u = other_u;
      idx = other_idx;
    }
  }
}

}  // namespace compaction
