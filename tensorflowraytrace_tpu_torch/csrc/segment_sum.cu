// Segment sum (the backward of the engine's per-surface row gather), float32,
// for sm_90a.
//
// Replaces: tensorflowraytrace_tpu/ops/pallas_kernels.py, _segsum_kernel
// (launched through segment_sum_pallas from engine._gather_rows_t_bwd).
//
// What it computes: out[j][c] = sum over i with idx[i] == j of ct[c][i], for
// ct (k, n) float32 row-major (the cotangent of the gathered, transposed
// rows), idx (n,) int32 and out (m, k) float32, which the caller zeroes.  An
// idx outside [0, m) adds nothing (as the scatter of the JAX package drops
// it).  Zero cotangents are skipped: adding +0 or -0 to a sum that starts at
// +0 never changes it, and NaN is not zero, so NaN still propagates.
//
// The TPU kernel turns the scatter into one-hot matrix products on the MXU,
// gated by each ray block's idx range, because the TPU serialises scatters.
// Hopper has atomics in shared memory and warp-wide matching instead, so
// the design is:
//
//   the adds (add_rays, add_group): a warp takes 32 Rays consecutive rays
//   a step, Rays a lane, and issues all their loads of idx and of kCols
//   columns of ct before any add (the loads of ct do not wait for idx).  A
//   lane whose cotangents are all zero, or whose idx is out of range, adds
//   nothing.  In a warp in which two neighbouring lanes add into the same
//   row (one shuffle and one __ballot_sync, so that random rows, which
//   match rarely, pay no match), each group of lanes on one row
//   (__match_any_sync) sums every column by shuffles (a suffix sum in lane
//   order, by pointer jumping: log2 of the largest group steps,
//   __reduce_max_sync), and only its lowest lane adds the sums: 32 rays on
//   one row cost one atomic a column, not 32 that collide.  Hopper has no
//   float atomic add in shared memory: atomicAdd on a shared float is a
//   compare-and-swap loop, which lanes on one word repeat one after
//   another.
//
//   shared branch (the m x k table fits in a block's shared memory, up to the
//   227 KB opt-in): each block of one wave of resident blocks zeroes a
//   private copy of the table, walks its share of the rays (a grid-stride
//   loop of whole warps) adding into it, and then adds every nonzero entry
//   into `out` with one global atomic.  Those atomics add in L2 without a
//   round trip; on the H100 a flush through a thread-block cluster's
//   distributed shared memory and one in two passes were both slower
//   (PERF.md).  Its rays a lane and the blocks an SM its launch bound asks
//   for follow the table's shape (shared_launch).  The flagship's 770 x 13
//   table is 40 KB, the 4096-triangle soup's 213 KB.
//
//   global branch (larger tables, e.g. 16386 rows): every group's sums go
//   straight to `out` with global atomics.
//
// What bounds it: bytes, 4 k n of ct and 4 n of idx read once and 4 m k of
// out written; the adds are k n flops, far below the FP32 peak.  The reads
// are coalesced: lane i reads ct[c][i], so a warp reads 128 contiguous
// bytes a column.  On random rows the compare-and-swap loops, not the
// bytes, set the pace.
//
// Atomics add in an order that changes from run to run, so the result is not
// bitwise reproducible; it equals the exact sum to float32 rounding of the
// partial sums.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSharedThreads = 1024;
constexpr int kGlobalThreads = 256;
constexpr int kGlobalRays = 2;  // the global branch's rays a lane
constexpr int kCols = 8;  // cotangent columns loaded ahead of their adds

// Adds one ray a lane into `table` (row-major m x k, shared or global
// memory): columns c0 .. c0 + kCols - 1 (those below k) of ray row j, held
// in v, where `ok` (a ray in [0, n) with j in [0, m)).  Every lane of the
// warp calls it.
__device__ __forceinline__ void add_group(float (&v)[kCols], int j, bool ok,
                                          int c0, int k, float* table) {
  const int lane = threadIdx.x & 31;
  bool live = false;
#pragma unroll
  for (int c = 0; c < kCols; ++c) live |= v[c] != 0.f;
  live = live && ok;
  const int key = live ? j : -1;  // lanes that add nothing: -1
  // match only where two neighbouring lanes share a row
  const int beside = __shfl_xor_sync(kFull, key, 1);
  if (__ballot_sync(kFull, key >= 0 && key == beside)) {
    // the lanes that add into the same row
    const unsigned peers = __match_any_sync(kFull, key);
    const int longest = __reduce_max_sync(
        kFull, live ? static_cast<unsigned>(__popc(peers)) : 1u);
    // `next`: the lane d places above this one in its group (32: none).
    // After the step of d each lane holds the sum over the 2 d lanes from
    // itself up, so the group's lowest lane ends with the group's sum.
    const unsigned above = peers & ~((2u << lane) - 1u);
    int next = above ? __ffs(above) - 1 : 32;
    for (int d = 1; d < longest; d <<= 1) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c0 + c < k) {  // the same in the whole warp
          const float other = __shfl_sync(kFull, v[c], next & 31);
          if (next < 32) v[c] += other;
        }
      }
      const int further = __shfl_sync(kFull, next, next & 31);
      next = next < 32 ? further : 32;
    }
    live = live && (peers & ((1u << lane) - 1u)) == 0;  // the lowest lane
  }
  if (!live) return;
  float* row = table + static_cast<size_t>(j) * k + c0;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (c0 + c < k && v[c] != 0.f) atomicAdd(row + c, v[c]);
  }
}

// The grid-stride loop over whole warps of rays: a warp takes 32 Rays
// consecutive rays a step, Rays a lane (lane + 32 r), loads all their
// rows and kCols of their cotangents (the loads of ct do not wait for
// idx), then adds them 32 at a time (add_group).
template <int Rays>
__device__ __forceinline__ void add_rays(const float* __restrict__ ct,
                                         const int* __restrict__ idx, int n,
                                         int m, int k, float* table) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  const int warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  for (int base = warp * 32 * Rays; base < n; base += warps * 32 * Rays) {
    int j[Rays];
    bool in[Rays];
#pragma unroll
    for (int r = 0; r < Rays; ++r) {
      const int i = base + 32 * r + lane;
      in[r] = i < n;
      j[r] = in[r] ? idx[i] : -1;
    }
    for (int c0 = 0; c0 < k; c0 += kCols) {
      float v[Rays][kCols];
#pragma unroll
      for (int r = 0; r < Rays; ++r) {
        const float* col = ct + base + 32 * r + lane;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          v[r][c] = (in[r] && c0 + c < k)
                        ? col[static_cast<size_t>(c0 + c) * n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < Rays; ++r)
        add_group(v[r], j[r],
                  static_cast<unsigned>(j[r]) < static_cast<unsigned>(m), c0,
                  k, table);
    }
  }
}

// MinBlocks 2 holds it to 32 registers, so that two blocks fit an SM.
template <int Rays, int MinBlocks>
__global__ void __launch_bounds__(kSharedThreads, MinBlocks)
segment_sum_shared(const float* __restrict__ ct, const int* __restrict__ idx,
                   int n, int m, int k, float* __restrict__ out) {
  extern __shared__ float table[];  // m x k, row-major like `out`
  const int entries = m * k;
  for (int t = threadIdx.x; t < entries; t += blockDim.x) table[t] = 0.f;
  __syncthreads();

  add_rays<Rays>(ct, idx, n, m, k, table);
  __syncthreads();

  for (int t = threadIdx.x; t < entries; t += blockDim.x) {
    const float v = table[t];
    if (v != 0.f) atomicAdd(out + t, v);
  }
}

__global__ void __launch_bounds__(kGlobalThreads)
segment_sum_global(const float* __restrict__ ct, const int* __restrict__ idx,
                   int n, int m, int k, float* __restrict__ out) {
  add_rays<kGlobalRays>(ct, idx, n, m, k, out);
}

int shared_limit(int device) {
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  return bytes;
}

struct Launch {
  int rays, min_blocks;
};

// The shared branch's rays a lane and launch bound for a k-column table of
// which `fit` blocks of 32 registers a thread fit an SM, from the H100's
// times (PERF.md): one ray a lane where two blocks fit and k takes two
// column passes (the flagship's 770 x 13), two where one pass holds k
// (the 2D guide's 512 x 4); where one block fits (the soup's 4096 x 13),
// two rays a lane and the registers a single block may take.
Launch shared_launch(int k, int fit) {
  if (fit < 2) return {2, 1};
  return k > kCols ? Launch{1, 2} : Launch{2, 2};
}

// Launches the shared branch at Rays a lane and MinBlocks: one wave of
// resident blocks, no more than the rays need.  MinBlocks 2 holds a thread
// to the 32 registers of segment_sum_shared<1, 2>, so `fit` blocks (that
// kernel's) fit an SM; MinBlocks 1 lets a thread take more, and one block
// an SM is counted.
template <int Rays, int MinBlocks>
cudaError_t launch_shared(const float* ct, const int* idx, int n, int m,
                          int k, float* out, cudaStream_t s, int fit,
                          int sms) {
  const auto kernel = segment_sum_shared<Rays, MinBlocks>;
  const int bytes = m * k * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int per_sm = MinBlocks == 1 ? 1 : max(fit, 1);
  const int wanted = (n + kSharedThreads * Rays - 1) / (kSharedThreads * Rays);
  const int blocks = min(wanted, per_sm * sms);
  kernel<<<blocks, kSharedThreads, bytes, s>>>(ct, idx, n, m, k, out);
  return cudaGetLastError();
}

}  // namespace

// 0 when an (m, k) table takes the shared branch on the current device,
// 1 when it takes the global one.
extern "C" int segment_sum_branch(int m, int k) {
  int device = 0;
  cudaGetDevice(&device);
  const size_t bytes = static_cast<size_t>(m) * k * sizeof(float);
  return bytes <= static_cast<size_t>(shared_limit(device)) ? 0 : 1;
}

// ct: (k, n) float32 row-major; idx: (n,) int32; out: (m, k) float32, zeroed
// by the caller.  Needs n >= 1, m >= 1, 1 <= k and m * k < 2^31.  Launches on
// `stream` and returns the CUDA error code (0 = launched).
extern "C" int segment_sum_launch(const float* ct, const int* idx, int n,
                                  int m, int k, float* out, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  if (segment_sum_branch(m, k) == 0) {
    // how many blocks of 32 registers a thread fit an SM
    const auto probe = segment_sum_shared<1, 2>;
    const int bytes = m * k * static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(
        probe, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int fit = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, probe,
                                                        kSharedThreads, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Launch l = shared_launch(k, fit);
    if (l.rays == 1) {
      err = l.min_blocks == 1
                ? launch_shared<1, 1>(ct, idx, n, m, k, out, s, fit, sms)
                : launch_shared<1, 2>(ct, idx, n, m, k, out, s, fit, sms);
    } else {
      err = l.min_blocks == 1
                ? launch_shared<2, 1>(ct, idx, n, m, k, out, s, fit, sms)
                : launch_shared<2, 2>(ct, idx, n, m, k, out, s, fit, sms);
    }
    return static_cast<int>(err);
  }
  const int wanted =
      (n + kGlobalThreads * kGlobalRays - 1) / (kGlobalThreads * kGlobalRays);
  const int blocks = min(wanted, 16 * sms);
  segment_sum_global<<<blocks, kGlobalThreads, 0, s>>>(ct, idx, n, m, k, out);
  return static_cast<int>(cudaGetLastError());
}
