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
// Hopper has fast atomics in shared memory instead, so the design is:
//
//   shared branch (the m x k table fits in a block's shared memory, up to the
//   227 KB opt-in): each block zeroes a private copy of the table, walks its
//   share of the rays in a grid-stride loop, adds every nonzero cotangent
//   into its copy with a shared-memory atomicAdd, and at the end adds each
//   nonzero entry of its copy into `out` with one global atomicAdd.  The
//   flagship's 770 x 13 table is 40 KB, the 4096-triangle soup's 213 KB.
//   The grid is one wave of resident blocks, so the flush costs at most
//   (resident blocks) x m x k global atomics.
//
//   global branch (larger tables, e.g. 16386 rows): every nonzero cotangent
//   goes straight to `out` with a global atomicAdd.
//
// What bounds it: bytes.  It reads ct (4 k n bytes) and idx (4 n) once and
// writes out (4 m k); the adds are k n flops, far below the FP32 peak.  The
// reads are coalesced: thread i reads ct[c][i] for each c, so a warp reads
// 128 contiguous bytes per column.  Contention is the risk: rays that land on
// one row serialise their atomics on it.  A warp-level pre-reduction of equal
// idx (__match_any_sync) is the remedy if that case proves slow.
//
// Atomics add in an order that changes from run to run, so the result is not
// bitwise reproducible; it equals the exact sum to float32 rounding of the
// partial sums.

#include <cuda_runtime.h>

namespace {

constexpr int kSharedThreads = 1024;
constexpr int kGlobalThreads = 256;
constexpr int kCols = 16;  // cotangent columns loaded ahead of their atomics

// Adds ray i's k cotangents into row j of `table` (shared or global memory).
// The loads of a chunk of columns are issued before its atomics so they are
// in flight together.
__device__ __forceinline__ void add_ray(const float* __restrict__ ct, int n,
                                        int k, int i, float* row) {
  for (int c0 = 0; c0 < k; c0 += kCols) {
    float v[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      v[c] = (c0 + c < k) ? ct[static_cast<size_t>(c0 + c) * n + i] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (v[c] != 0.f) atomicAdd(row + c0 + c, v[c]);
    }
  }
}

__global__ void __launch_bounds__(kSharedThreads)
segment_sum_shared(const float* __restrict__ ct, const int* __restrict__ idx,
                   int n, int m, int k, float* __restrict__ out) {
  extern __shared__ float table[];  // m x k, row-major like `out`
  const int entries = m * k;
  for (int t = threadIdx.x; t < entries; t += blockDim.x) table[t] = 0.f;
  __syncthreads();

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int j = idx[i];
    if (static_cast<unsigned>(j) < static_cast<unsigned>(m)) {
      add_ray(ct, n, k, i, table + j * k);
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < entries; t += blockDim.x) {
    const float v = table[t];
    if (v != 0.f) atomicAdd(out + t, v);
  }
}

__global__ void __launch_bounds__(kGlobalThreads)
segment_sum_global(const float* __restrict__ ct, const int* __restrict__ idx,
                   int n, int m, int k, float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int j = idx[i];
    if (static_cast<unsigned>(j) < static_cast<unsigned>(m)) {
      add_ray(ct, n, k, i, out + static_cast<size_t>(j) * k);
    }
  }
}

int shared_limit(int device) {
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  return bytes;
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
    const int bytes = m * k * static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(segment_sum_shared,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segment_sum_shared, kSharedThreads, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int wanted = (n + kSharedThreads - 1) / kSharedThreads;
    const int blocks = min(wanted, max(per_sm, 1) * sms);
    segment_sum_shared<<<blocks, kSharedThreads, bytes, s>>>(ct, idx, n, m, k,
                                                              out);
  } else {
    const int wanted = (n + kGlobalThreads - 1) / kGlobalThreads;
    const int blocks = min(wanted, 16 * sms);
    segment_sum_global<<<blocks, kGlobalThreads, 0, s>>>(ct, idx, n, m, k,
                                                         out);
  }
  return static_cast<int>(cudaGetLastError());
}
