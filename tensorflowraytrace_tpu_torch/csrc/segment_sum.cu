// Segment sum (the backward of the engine's per-surface row gather, and the
// histograms' binning), float32 and float64, for sm_90a, added in a fixed
// order.
//
// Replaces: tensorflowraytrace_tpu/ops/pallas_kernels.py, _segsum_kernel
// (launched through segment_sum_pallas from engine._gather_rows_t_bwd).
//
// What it computes: out[j][c] = sum over i with idx[i] == j of ct[c][i], for
// ct (k, n) row-major (the cotangent of the gathered, transposed rows, or a
// histogram's weights with k = 1), idx (n,) int32 and out (m, k), ct and out
// both float32 or both float64 (one instance each of the two passes that
// touch them).  An idx outside [0, m) adds nothing (as the scatter of the
// JAX package drops it).
//
// The order of the adds is a function of (ct, idx, m) alone, and it is that
// of segsum_kernels.segment_sum_plain: the rays are cut into tiles of kTile
// consecutive rays (the Pallas kernel's ray block, SEGSUM_RAY_BLOCK); within
// a tile each row's contributions are added in ascending ray order from +0;
// then each row's tile sums are added in ascending tile order from +0.  So
// the result is the same bits from run to run, on any card, and equal to
// the plain version's.  No float atomic is used; integer atomics only mark
// which tiles hold a row, and their result is exact.
//
// The TPU kernel adds one-hot matrix products of each ray block into the
// output over a sequential grid.  Blocks on Hopper run in no order, so the
// sequential grid becomes a second pass over a table of tile sums:
//
//   segment_sum_clear: zeroes the tile masks.
//
//   segment_sum_tiles (pass 1, one block per tile): issues the loads of the
//   tile's cotangents (kStageCols columns at a time, coalesced), and while
//   they fly loads the tile's rows as 64-bit keys (row, ray) into shared
//   memory and orders them with a bitonic sort (skipped where the rows
//   already ascend; an idx out of range sorts last and is dropped); stores
//   the cotangents in shared memory in key order, so that each run of one
//   row lies side by side; then one thread per (run, column) adds its run
//   in ray order from +0, its loads issued kUnroll ahead of the dependent
//   adds.  It writes one record a run, the row and k sums at slot
//   tile * kTile + run, and sets the tile's bit in the row's mask word of
//   its group of 32 tiles (integer atomicOr).
//
//   segment_sum_count (one thread a row): the number of records of each
//   row before each group of 32 tiles, and the row's count.  The masks are
//   laid out group by group, so that a tile's rows, which ascend, and a
//   warp's rows read side by side.  Each block also scans its rows' counts
//   (the row's place among its block's records) and writes its total.
//
//   segment_sum_scan: the exclusive scan of the blocks' totals (one block),
//   and segment_sum_start: each row's list starts at its block's start
//   plus its place in the block.
//
//   segment_sum_place: each record's id to its place in its row's list: the
//   row's start, its records in earlier groups, and the bits below the
//   tile's in its group's mask.  So each list runs in tile order.
//
//   segment_sum_rows (pass 2, one block per row): stages the records' sums
//   in list order in shared memory, and adds them in tile order from +0,
//   one thread a column.  Where the table has kWarpRowsMin rows or more
//   (a histogram's bins: many short rows), segment_sum_rows_warp does the
//   same with one warp a row: its lanes load 32 records at a time, and the
//   fold takes them in list order (for k = 1 through warp shuffles).
//
// The float64 instance stages half as many columns and terms at a time
// (the same shared memory and registers), which changes no order.
//
// The masks and counts take 8 bytes a row for each group of 32 tiles, m n /
// 4096 bytes in all: 256 MiB for a 512 x 512 image of 2^22 rays.  So the
// launch cuts the rays into chunks of whole groups that keep them within
// kChunkMaskBytes (one chunk at every shape the port runs) and runs the
// passes chunk by chunk, each chunk's row pass continuing every row's sum
// from the chunks before: the same left fold over the tiles, so the same
// bits.  The workspace is then at most kChunkMaskBytes, plus (e k + 8)
// bytes a ray of a chunk and 12 bytes a row.
//
// What bounds it: bytes, e k n of ct (e = 4 or 8 bytes an element) and 4 n
// of idx read once and e m k of out written; the adds are k n flops, far
// below the peak.  The design moves more: the tile sums (up to e k n bytes
// written and read again, fewer where a tile's rays share rows), the masks
// and counts (2 m n / 8192 bytes) and, past one chunk, out read again a
// chunk; and it waits on its two sequential folds: a tile's longest run
// and a row's count of tiles.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileBits = 10;
constexpr int kTile = 1 << kTileBits;   // rays a tile
constexpr int kTileThreads = 512;       // pass 1: two keys a thread
constexpr int kTileMinBlocks = 2;       // pass 1: blocks an SM, at least
constexpr int kKeys = kTile / kTileThreads;
constexpr int kStageCols = 16;          // pass 1: columns staged at a time
constexpr int kStageStride = kTile + 1; // a staged column, padded
constexpr int kGroupTiles = 32;         // tiles a mask word covers
constexpr int kCountThreads = 256;      // rows a block of the count
constexpr int kRowThreads = 256;        // pass 2
constexpr int kRowStage = 8192;         // pass 2: floats staged at a time
constexpr int kRowIds = 2048;           // pass 2: ids staged at a time
constexpr int kWarpRowsMin = 8192;      // pass 2 a warp a row from here
constexpr int kWarpRowBlock = 256;      // pass 2 a warp a row: its threads
constexpr int kRowLoads = 16;           // pass 2: loads issued at once
constexpr int kUnroll = 8;              // loads issued ahead of their adds
constexpr uint64_t kDroppedRow = 0xffffffffull << 32;  // sorts last
constexpr long long kChunkMaskBytes = 1LL << 28;  // a chunk's masks, counts

// The columns pass 1 stages at a time and the terms pass 2 stages at a
// time, in elements of T: the same bytes for float and double.
template <typename T>
struct Staging {
  static constexpr int kCols = kStageCols * 4 / static_cast<int>(sizeof(T));
  static constexpr int kRow = kRowStage * 4 / static_cast<int>(sizeof(T));
};

// Sequential sum of terms[0], terms[stride], ..., terms[(count - 1) stride]
// onto s: the loads of kUnroll terms are issued before their adds.
template <typename T>
__device__ __forceinline__ T fold(const T* terms, int count, int stride = 1,
                                  T s = T(0)) {
  int i = 0;
  for (; i + kUnroll <= count; i += kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = terms[(i + u) * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s += v[u];
  }
  for (; i < count; ++i) s += terms[i * stride];
  return s;
}

// The exclusive scan of one int a thread over the block (blockDim.x a
// multiple of 32, at most 1024); `warp_sums` holds 32 ints.  Returns the
// thread's prefix and sets *total.
__device__ __forceinline__ int block_exclusive_scan(int value, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int x = value;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;  // inclusive
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - value;
  *total = warp_sums[warps - 1];
  __syncthreads();  // warp_sums may be reused
  return before;
}

__global__ void segment_sum_clear(unsigned* words, long long count) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < count; i += static_cast<long long>(gridDim.x) * blockDim.x)
    words[i] = 0u;
}

// The cotangents of columns c0 .. c0 + cols - 1 at the tile's rays p =
// threadIdx.x + q kTileThreads (0 past the rays), coalesced; a column is
// ld elements long.
template <typename T>
__device__ __forceinline__ void load_columns(
    const T* __restrict__ ct, int ld, int t0, int rays, int c0, int cols,
    T (&v)[kKeys][Staging<T>::kCols]) {
#pragma unroll
  for (int q = 0; q < kKeys; ++q) {
    const int p = threadIdx.x + q * kTileThreads;
#pragma unroll
    for (int c = 0; c < Staging<T>::kCols; ++c)
      v[q][c] = (c < cols && p < rays)
                    ? ct[static_cast<size_t>(c0 + c) * ld + t0 + p] : T(0);
  }
}

// Pass 1 over the n rays of a chunk (columns of ct ld long).  Dynamic
// shared memory: min(k, Staging<T>::kCols) staged columns.
template <typename T>
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
segment_sum_tiles(const T* __restrict__ ct, int ld,
                  const int* __restrict__ idx, int n, int m, int k,
                  T* __restrict__ rec_sum,
                  int* __restrict__ rec_row, int* __restrict__ tile_runs,
                  unsigned* __restrict__ mask) {
  constexpr int kCols = Staging<T>::kCols;
  __shared__ uint64_t keys[kTile];
  __shared__ int run_begin[kTile + 1];
  __shared__ int sorted_at[kTile];  // a ray's place in key order
  __shared__ int warp_sums[32];
  // [column][kStageStride], key order
  extern __shared__ __align__(8) unsigned char stage_bytes[];
  T* stage = reinterpret_cast<T*>(stage_bytes);

  const int tile = blockIdx.x;
  const int t0 = tile * kTile;
  const int rays = min(kTile, n - t0);
  const int group = min(k, kCols);
  // the first columns' loads fly while the keys are sorted
  T v[kKeys][kCols];
  load_columns(ct, ld, t0, rays, 0, group, v);

  for (int p = threadIdx.x; p < kTile; p += kTileThreads) {
    const int j = p < rays ? idx[t0 + p] : -1;
    const uint64_t row = (j >= 0 && j < m) ? static_cast<uint64_t>(j) << 32
                                           : kDroppedRow;
    keys[p] = row | static_cast<unsigned>(p);
  }
  __syncthreads();
  // bitonic sort of the kTile keys, ascending: by row, then by ray (skipped
  // where the rows already ascend, as on coherent rays)
  bool ascending_rows = true;
  for (int p = threadIdx.x; p + 1 < kTile; p += kTileThreads)
    ascending_rows = ascending_rows && keys[p] <= keys[p + 1];
  if (!__syncthreads_and(ascending_rows)) {
    // a stride of 32 or less pairs keys within the 64 a warp holds, so
    // such a stage waits for its warp alone
    int last = kTile;
    for (int size = 2; size <= kTile; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        if (stride > 32 || last > 32) {
          __syncthreads();
        } else {
          __syncwarp();
        }
        last = stride;
        const int t = threadIdx.x;
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool ascending = (lo & size) == 0;
        const uint64_t a = keys[lo], b = keys[hi];
        if ((a > b) == ascending) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
    }
  }
  __syncthreads();

  // the runs: a key starts one where its row differs from the key before;
  // the dropped keys sort last, so the valid ones are a prefix
  int starts = 0, kept = 0;
  bool start[kKeys];
#pragma unroll
  for (int q = 0; q < kKeys; ++q) {
    const int p = threadIdx.x * kKeys + q;
    const uint64_t key = keys[p];
    const bool valid = (key & kDroppedRow) != kDroppedRow;
    start[q] = valid && (p == 0 || (keys[p - 1] >> 32) != (key >> 32));
    starts += start[q];
    kept += valid;
    sorted_at[static_cast<int>(key & 0xffffffffu)] = p;
  }
  int runs = 0, valid = 0;
  int r = block_exclusive_scan(starts, warp_sums, &runs);
  block_exclusive_scan(kept, warp_sums, &valid);
#pragma unroll
  for (int q = 0; q < kKeys; ++q)
    if (start[q]) run_begin[r++] = threadIdx.x * kKeys + q;
  if (threadIdx.x == 0) {
    run_begin[runs] = valid;
    tile_runs[tile] = runs;
  }
  __syncthreads();

  const int word = tile / kGroupTiles;
  const unsigned bit = 1u << (tile % kGroupTiles);
  for (int q = threadIdx.x; q < runs; q += kTileThreads) {
    const int row = static_cast<int>(keys[run_begin[q]] >> 32);
    rec_row[t0 + q] = row;
    atomicOr(&mask[static_cast<size_t>(word) * m + row], bit);
  }

  for (int c0 = 0; c0 < k; c0 += group) {
    const int cols = min(group, k - c0);
    if (c0 > 0) load_columns(ct, ld, t0, rays, c0, cols, v);
    // into key order (the dropped rays' places lie past `valid`)
#pragma unroll
    for (int q = 0; q < kKeys; ++q) {
      const int at = sorted_at[threadIdx.x + q * kTileThreads];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (c < cols) stage[c * kStageStride + at] = v[q][c];
    }
    __syncthreads();
    for (int q = threadIdx.x; q < runs * cols; q += kTileThreads) {
      const int run = q / cols, c = q - run * cols;
      const int b = run_begin[run];
      const T s = fold(stage + c * kStageStride + b, run_begin[run + 1] - b);
      rec_sum[static_cast<size_t>(t0 + run) * k + c0 + c] = s;
    }
    __syncthreads();
  }
}

// For each row j: before[g][j] = its records in the groups below g, and
// local[j] = the records of the rows before it in its block of
// kCountThreads rows, whose total goes to block_total.  A thread a row: a
// warp reads 32 rows of a group side by side, kUnroll groups at a time.
__global__ void __launch_bounds__(kCountThreads)
segment_sum_count(const unsigned* __restrict__ mask, int m, int groups,
                  int* __restrict__ before, int* __restrict__ local,
                  int* __restrict__ block_total) {
  __shared__ int warp_sums[32];
  const int j = blockIdx.x * kCountThreads + threadIdx.x;
  int s = 0;
  if (j < m) {
    for (int g0 = 0; g0 < groups; g0 += kUnroll) {
      int bits[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        bits[u] = g0 + u < groups
                      ? __popc(mask[static_cast<size_t>(g0 + u) * m + j]) : 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (g0 + u < groups) before[static_cast<size_t>(g0 + u) * m + j] = s;
        s += bits[u];
      }
    }
  }
  int total = 0;
  const int place = block_exclusive_scan(s, warp_sums, &total);
  if (j < m) local[j] = place;
  if (threadIdx.x == 0) block_total[blockIdx.x] = total;
}

// The exclusive scan of block_total[0 .. blocks) into block_start, 1024 at
// a time, and every record's count into start[m]; one block.
__global__ void __launch_bounds__(1024)
segment_sum_scan(const int* __restrict__ block_total, int blocks, int m,
                 int* __restrict__ block_start, int* __restrict__ start) {
  __shared__ int warp_sums[32];
  int carry = 0;
  for (int b0 = 0; b0 < blocks; b0 += blockDim.x) {
    const int b = b0 + static_cast<int>(threadIdx.x);
    int total = 0;
    const int before = block_exclusive_scan(b < blocks ? block_total[b] : 0,
                                            warp_sums, &total);
    if (b < blocks) block_start[b] = carry + before;
    carry += total;
  }
  if (threadIdx.x == 0) start[m] = carry;
}

// start[j] = its block's start + its place in the block.
__global__ void segment_sum_start(const int* __restrict__ local,
                                  const int* __restrict__ block_start, int m,
                                  int* __restrict__ start) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < m) start[j] = block_start[j / kCountThreads] + local[j];
}

// Each record's id (tile * kTile + run) to its place in its row's list, in
// tile order.
__global__ void segment_sum_place(const int* __restrict__ tile_runs,
                                  const int* __restrict__ rec_row,
                                  const unsigned* __restrict__ mask,
                                  const int* __restrict__ before,
                                  const int* __restrict__ start, int m,
                                  unsigned* __restrict__ list) {
  const int tile = blockIdx.x;
  const int runs = tile_runs[tile];
  const int word = tile / kGroupTiles;
  const unsigned below = (1u << (tile % kGroupTiles)) - 1u;
  for (int q = threadIdx.x; q < runs; q += blockDim.x) {
    const unsigned id = static_cast<unsigned>(tile) * kTile + q;
    const int row = rec_row[id];
    const size_t at = static_cast<size_t>(word) * m + row;
    list[start[row] + before[at] + __popc(mask[at] & below)] = id;
  }
}

// Pass 2: row j's records, which its list holds in tile order, added from
// +0 (onto out's row where `onto`, a later chunk), kRowThreads columns at
// a time.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
segment_sum_rows(const int* __restrict__ start,
                 const unsigned* __restrict__ list,
                 const T* __restrict__ rec_sum, int k, bool onto,
                 T* __restrict__ out) {
  constexpr int kStage = Staging<T>::kRow;
  __shared__ T stage[kStage];
  __shared__ unsigned ids[kRowIds];

  const int j = blockIdx.x;
  const int base = start[j];
  const int count = start[j + 1] - base;
  T* row_out = out + static_cast<size_t>(j) * k;
  for (int c0 = 0; c0 < k; c0 += kRowThreads) {
    const int cols = min(kRowThreads, k - c0);
    const int per_round = min(kRowIds, max(1, kStage / cols));
    T s = onto && static_cast<int>(threadIdx.x) < cols
              ? row_out[c0 + threadIdx.x] : T(0);
    for (int i0 = 0; i0 < count; i0 += per_round) {
      const int terms = min(per_round, count - i0);
      for (int i = threadIdx.x; i < terms; i += kRowThreads)
        ids[i] = list[base + i0 + i];
      __syncthreads();
      // kRowLoads loads a thread at once, then their stores
      const int entries = terms * cols;
      for (int q0 = 0; q0 < entries; q0 += kRowLoads * kRowThreads) {
        T v[kRowLoads];
#pragma unroll
        for (int u = 0; u < kRowLoads; ++u) {
          const int q = q0 + u * kRowThreads + threadIdx.x;
          const int i = q / cols, c = q - i * cols;
          v[u] = q < entries
                     ? rec_sum[static_cast<size_t>(ids[i]) * k + c0 + c]
                     : T(0);
        }
#pragma unroll
        for (int u = 0; u < kRowLoads; ++u) {
          const int q = q0 + u * kRowThreads + threadIdx.x;
          if (q < entries) stage[q] = v[u];
        }
      }
      __syncthreads();
      // continues the sum of the rounds before: the same left fold
      if (static_cast<int>(threadIdx.x) < cols)
        s = fold(stage + threadIdx.x, terms, cols, s);
      __syncthreads();
    }
    if (static_cast<int>(threadIdx.x) < cols) row_out[c0 + threadIdx.x] = s;
  }
}

// Pass 2 for tables of many rows: one warp a row, the same order (onto
// out's row where `onto`).  The lanes load the ids of 32 records at a
// time; for k = 1 each lane loads one record's sum and the fold takes lane
// 0's, lane 1's, ... through shuffles (every lane holds the same sum),
// else lane c folds column c0 + c over the 32 records in order.
template <typename T>
__global__ void __launch_bounds__(kWarpRowBlock)
segment_sum_rows_warp(const int* __restrict__ start,
                      const unsigned* __restrict__ list,
                      const T* __restrict__ rec_sum, int m, int k, bool onto,
                      T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int j = (blockIdx.x * kWarpRowBlock + threadIdx.x) >> 5;
  if (j >= m) return;
  const int base = start[j];
  const int count = start[j + 1] - base;
  T* row_out = out + static_cast<size_t>(j) * k;
  for (int c0 = 0; c0 < k; c0 += 32) {
    const int c = c0 + lane;
    T s = onto && c < k ? row_out[c] : T(0);
    for (int i0 = 0; i0 < count; i0 += 32) {
      const int terms = min(32, count - i0);
      const unsigned id = lane < terms ? list[base + i0 + lane] : 0u;
      if (k == 1) {
        const T v = lane < terms ? rec_sum[id] : T(0);
        for (int t = 0; t < terms; ++t) s += __shfl_sync(kFull, v, t);
      } else {
        T v[32];
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          const unsigned at = __shfl_sync(kFull, id, t);
          v[t] = (t < terms && c < k)
                     ? rec_sum[static_cast<size_t>(at) * k + c] : T(0);
        }
#pragma unroll
        for (int t = 0; t < 32; ++t)
          if (t < terms) s += v[t];
      }
    }
    if (c < k && (k > 1 || lane == 0)) row_out[c] = s;
  }
}

struct Workspace {
  void* rec_sum;       // [slots][k] of T: the records' sums
  unsigned* mask;      // [groups][m]: the tiles holding each row
  int* before;         // [groups][m]: a row's records in earlier groups
  int* local;          // [m]: a row's place among its block's records
  int* block_total;    // [count blocks]
  int* block_start;    // [count blocks]
  int* start;          // [m + 1]
  int* tile_runs;      // [tiles]
  int* rec_row;        // [slots]
  unsigned* list;      // [slots]: each row's record ids, in tile order
  long long bytes;
};

// The rays of a chunk: whole groups of kGroupTiles tiles, as many as keep
// the masks and counts (8 m bytes a group) within kChunkMaskBytes, and one
// group at least; all n where they fit.
int chunk_rays(int n, int m) {
  const long long groups = max(1LL, kChunkMaskBytes / (8LL * m));
  return static_cast<int>(
      min(static_cast<long long>(n), groups * kGroupTiles * kTile));
}

// The workspace's parts from its base address `base` (0 to size it), for a
// chunk of the n rays, and elements of `elem_bytes` (4 or 8) bytes.
Workspace carve(uintptr_t base, int n, int m, int k, int elem_bytes) {
  const long long tiles = (chunk_rays(n, m) + kTile - 1LL) / kTile;
  const long long slots = tiles * kTile;
  const long long groups = (tiles + kGroupTiles - 1) / kGroupTiles;
  long long offset = 0;
  const auto take = [&](long long ints) {
    const uintptr_t at = base + static_cast<uintptr_t>(offset);
    offset += 4 * ints;
    return at;
  };
  Workspace w;
  // first, so that the float64 sums lie on the base's 8-byte alignment
  w.rec_sum = reinterpret_cast<void*>(take(slots * k * (elem_bytes / 4)));
  w.mask = reinterpret_cast<unsigned*>(take(m * groups));
  w.before = reinterpret_cast<int*>(take(m * groups));
  const long long count_blocks = (m + kCountThreads - 1LL) / kCountThreads;
  w.local = reinterpret_cast<int*>(take(m));
  w.block_total = reinterpret_cast<int*>(take(count_blocks));
  w.block_start = reinterpret_cast<int*>(take(count_blocks));
  w.start = reinterpret_cast<int*>(take(m + 1LL));
  w.tile_runs = reinterpret_cast<int*>(take(tiles));
  w.rec_row = reinterpret_cast<int*>(take(slots));
  w.list = reinterpret_cast<unsigned*>(take(slots));
  w.bytes = offset;
  return w;
}

// The passes over the chunk of n rays at ct (columns ld long) and idx,
// into out, from +0 or, where `onto`, onto out.
template <typename T>
int launch_chunk(const T* ct, int ld, const int* idx, int n, int m, int k,
                 bool onto, T* out, const Workspace& w, cudaStream_t s) {
  const int tiles = (n + kTile - 1) / kTile;
  const int groups = (tiles + kGroupTiles - 1) / kGroupTiles;
  T* rec_sum = static_cast<T*>(w.rec_sum);
  const long long words = static_cast<long long>(m) * groups;

  const int clear_blocks = static_cast<int>(min(1024LL, (words + 255) / 256));
  segment_sum_clear<<<clear_blocks, 256, 0, s>>>(w.mask, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int stage_bytes = min(k, Staging<T>::kCols) * kStageStride *
                          static_cast<int>(sizeof(T));
  err = cudaFuncSetAttribute(segment_sum_tiles<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             stage_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_sum_tiles<T><<<tiles, kTileThreads, stage_bytes, s>>>(
      ct, ld, idx, n, m, k, rec_sum, w.rec_row, w.tile_runs, w.mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int count_blocks = (m + kCountThreads - 1) / kCountThreads;
  segment_sum_count<<<count_blocks, kCountThreads, 0, s>>>(
      w.mask, m, groups, w.before, w.local, w.block_total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  segment_sum_scan<<<1, 1024, 0, s>>>(w.block_total, count_blocks, m,
                                      w.block_start, w.start);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  segment_sum_start<<<count_blocks, kCountThreads, 0, s>>>(
      w.local, w.block_start, m, w.start);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  segment_sum_place<<<tiles, 256, 0, s>>>(w.tile_runs, w.rec_row, w.mask,
                                          w.before, w.start, m, w.list);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (m >= kWarpRowsMin) {
    const long long threads = 32LL * m;
    segment_sum_rows_warp<T><<<static_cast<int>(
        (threads + kWarpRowBlock - 1) / kWarpRowBlock), kWarpRowBlock, 0,
        s>>>(w.start, w.list, rec_sum, m, k, onto, out);
  } else {
    segment_sum_rows<T><<<m, kRowThreads, 0, s>>>(w.start, w.list, rec_sum,
                                                  k, onto, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* ct, const int* idx, int n, int m, int k, int tile,
           T* out, void* work, void* stream) {
  if (tile != kTile) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Workspace w = carve(reinterpret_cast<uintptr_t>(work), n, m, k,
                            static_cast<int>(sizeof(T)));
  const int chunk = chunk_rays(n, m);
  for (long long r0 = 0; r0 < n; r0 += chunk) {
    const int err = launch_chunk(
        ct + r0, n, idx + r0, static_cast<int>(min(1LL * chunk, n - r0)), m,
        k, r0 > 0, out, w, s);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// The workspace segment_sum_launch (elem_bytes 4) or segment_sum_launch_f64
// (elem_bytes 8) needs for n rays over m rows of k columns, in bytes.
extern "C" long long segment_sum_workspace(int n, int m, int k,
                                           int elem_bytes) {
  return carve(0, n, m, k, elem_bytes).bytes;
}

// ct: (k, n) float32 row-major; idx: (n,) int32; out: (m, k) float32 (every
// entry written); work: segment_sum_workspace(n, m, k, 4) bytes, 8-byte
// aligned.  `tile` must be kTile, the caller's tile: else nothing runs and
// cudaErrorInvalidValue is returned.  Needs n >= 1, m >= 1, 1 <= k and
// m * k < 2^31.  Launches on `stream` and returns the CUDA error code (0 =
// launched).
extern "C" int segment_sum_launch(const float* ct, const int* idx, int n,
                                  int m, int k, int tile, float* out,
                                  void* work, void* stream) {
  return launch<float>(ct, idx, n, m, k, tile, out, work, stream);
}

// segment_sum_launch in float64: ct and out double, work
// segment_sum_workspace(n, m, k, 8) bytes; the same order of the adds.
extern "C" int segment_sum_launch_f64(const double* ct, const int* idx, int n,
                                      int m, int k, int tile, double* out,
                                      void* work, void* stream) {
  return launch<double>(ct, idx, n, m, k, tile, out, work, stream);
}
