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
// both float32 or both float64 (one instance each of the passes that touch
// them).  An idx outside [0, m) adds nothing (as the scatter of the JAX
// package drops it).
//
// The order of the adds is a function of (ct, idx, m) alone, and it is that
// of segsum_kernels.segment_sum_plain: the rays are cut into tiles of kTile
// consecutive rays (the Pallas kernel's ray block, SEGSUM_RAY_BLOCK); within
// a tile each row's contributions are added in ascending ray order from +0;
// then each row's tile sums are added in ascending tile order from +0.  So
// the result is the same bits from run to run, on any card, and equal to
// the plain version's.  No float atomic is used; integer atomics only count
// and place records, and the row pass sorts what they place.
//
// The TPU kernel adds one-hot matrix products of each ray block into the
// output over a sequential grid.  Blocks on Hopper run in no order, so the
// sequential grid becomes a table of tile sums (one record for each row a
// tile holds, at slot tile * kTile + run) brought into row order, and a
// second fold.  A chunk takes four launches:
//
//   segment_sum_zero: the row counts and pass 2's grid barrier set to 0
//   (4 m + 4 bytes, in 16-byte stores).
//
//   segment_sum_tiles (one block of 256 threads a tile): starts the copy of
//   the tile's first columns into shared memory (cp.async, in ray order,
//   each column padded by 16 bytes) and meanwhile sorts the tile's 1024
//   (row, ray) keys (32-bit below kNarrowRows = 2^22 rows, 64-bit above;
//   64-bit keys everywhere made the pass 7-31% slower where it sorts, on an
//   H100) as a bitonic network: four keys a thread in registers, the
//   strides within a warp by shuffles, only the strides across warps (six
//   of 55 stages) through shared memory; skipped where the rows already
//   ascend.  An idx out of range sorts last and is dropped.  One thread per
//   (run, column) then adds its run's rays in ray order from +0, reading
//   the staged columns through the sorted keys (directly where the rows
//   ascended), its loads issued kUnroll ahead of the dependent adds.  It
//   writes each run's k sums and the offset of its first ray (16 bits) at
//   the run's slot, the tile's run count, and adds one to its row's count
//   (integer atomicAdd, exact).  Bound by the sort's instructions and the
//   staged columns' shared memory: three tiles an SM at kStageCols float
//   (or half as many double) columns.
//
//   segment_sum_order (one cooperative launch, kOrderBlocksPerSm blocks an
//   SM, half as many below kOrderHalfRows rows, where the whole grid was
//   6-28% slower on an H100; two grid barriers): scans the counts into each
//   row's start (each block its own span of rows, then the totals of the
//   blocks before it) and places each record's slot in its row's list at a
//   cursor taken by integer atomicAdd.  A row's list then holds its records
//   in no fixed order.  Bound by the returning atomics, one a record, and
//   the scattered writes of the list.
//
//   segment_sum_rows / segment_sum_rows_warp / segment_sum_bins: each row's
//   list ranked by slot (so by tile: a row holds at most one record a tile)
//   and folded in that order from +0 (onto out's row for a later
//   chunk).  Below kWarpRowsMin rows (few long rows) a block takes a row: a
//   bitmap of the chunk's tiles (integer atomicOr in shared memory) and the
//   prefix of its words' popcounts rank the records, the sorted records'
//   sums are staged kRowLoads loads a thread at a time, and one thread a
//   column folds them.  From kWarpRowsMin rows (shorter rows: the soup's
//   table, a histogram's bins), for k > 1 a warp takes a row (up to
//   kWarpIds records, ranked by the same bitmap; more by the whole block),
//   and for k = 1 a block takes 256 consecutive rows, whose lists lie side
//   by side: it stages up to kBinIds of their records at a time, ranks each
//   among its row's by comparing slots, and one thread a row folds its
//   sums.  Bound by the latency of the folds (a row's records one after
//   another) and, for many short rows, of the gathered sums.
//
// The float64 instance stages half as many columns and terms at a time
// and issues half as many loads at once (the same bytes), which changes
// no order.
//
// Workspace, O(records + m): (e k + 6) bytes a ray of a chunk (the
// records' sums at e = 4 or 8 bytes an element, the list, the first-ray
// offsets), 4 bytes a tile, 8 bytes a row (counts and starts) and 16 KiB:
// 42 MiB in float32 and 58 MiB in float64 for a 512 x 512 image of 2^22
// rays.  The row pass's bitmap and sorted list cover the tiles of a
// chunk, at most kChunkTiles (2^23 rays): longer calls run chunk by
// chunk, each chunk's row pass continuing every row's sum from the chunks
// before, the same left fold over the tiles, so the same bits.
//
// What bounds the whole: bytes, e k n of ct and 4 n of idx read once and
// e m k of out written; the adds are k n flops, far below the peak.  The
// design moves more (the records' sums, up to e k n bytes written and
// read again, fewer where a tile's rays share rows, and some 20 bytes a
// record of counting and placing, mostly in the L2) and waits on the
// passes' bounds above.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileBits = 10;
constexpr int kTile = 1 << kTileBits;   // rays a tile
constexpr int kTileThreads = 256;       // pass 1: four keys a thread
constexpr int kTileMinBlocks = 3;       // pass 1: blocks an SM (its stage)
constexpr int kKeys = kTile / kTileThreads;
constexpr int kWarpKeys = 32 * kKeys;   // the keys a warp holds
constexpr int kKeyRow = kTile + 4;      // pass 1: a buffer of keys, padded
constexpr int kStageCols = 16;          // pass 1: float columns at a time
constexpr int kOrderThreads = 256;      // pass 2
constexpr int kPlaces = kTile / kOrderThreads;  // pass 2: records a thread
constexpr int kOrderBlocksPerSm = 4;    // pass 2: at most
constexpr int kMaxOrderBlocks = 4096;   // pass 2: its grid, at most
constexpr int kOrderHalfRows = 65536;   // pass 2 on half its grid below
constexpr int kRowThreads = 256;        // pass 3
constexpr int kRowMinBlocks = 6;        // pass 3 a block a row: an SM
constexpr int kRowMinBlocks64 = 3;      // the same in float64
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowStage = 8192;         // pass 3: floats staged at a time
constexpr int kRowLoads = 16;           // pass 3: float loads at once
constexpr int kWarpRowsMin = 4096;      // pass 3 a warp a row from here
constexpr int kWarpIds = 256;           // pass 3: a warp's row, at most
constexpr int kBinIds = 2048;           // pass 3, k = 1: records staged
constexpr int kUnroll = 8;              // loads issued ahead of their adds
constexpr int kChunkTiles = 8192;       // tiles a chunk, at most
constexpr int kChunkWords = (kChunkTiles + 31) / 32;
constexpr int kMaxDevices = 64;
constexpr int kNarrowRows = 4194304;    // 32-bit keys below (2^22 rows)
constexpr int kZeroThreads = 256;
static_assert(kNarrowRows <= 1 << (32 - kTileBits),
              "a 32-bit key holds the row shifted by kTileBits");
static_assert(kKeys == 4, "the sort holds four keys a thread");
static_assert(kWarpKeys == 128, "the shared stages are the strides >= 128");

// The columns pass 1 stages at a time, each padded by 16 bytes (so that
// the threads folding long runs of several columns read other banks), and
// the terms pass 3 stages at a time and loads at once, in elements of T:
// the same bytes for float and double.
template <typename T>
struct Staging {
  static constexpr int kCols = kStageCols * 4 / static_cast<int>(sizeof(T));
  static constexpr int kStride = kTile + 16 / static_cast<int>(sizeof(T));
  static constexpr int kRow = kRowStage * 4 / static_cast<int>(sizeof(T));
  static constexpr int kLoads = kRowLoads * 4 / static_cast<int>(sizeof(T));
};

// Pass 3's dynamic shared memory for a chunk's bitmap of `words` words: a
// block's row (bitmap, word prefixes, the sorted ids, then the staged
// terms) and a warp's row (bitmap, word prefixes, kWarpIds sorted ids).
__host__ __device__ constexpr int row_stage_offset(int words) {
  return (34 * words * 4 + 15) / 16 * 16;
}
__host__ __device__ constexpr int row_block_bytes(int words) {
  return row_stage_offset(words) + kRowStage * 4;
}
__host__ __device__ constexpr int row_warp_ints(int words) {
  return 2 * words + kWarpIds;
}
__host__ __device__ constexpr int larger(int a, int b) {
  return a > b ? a : b;
}
__host__ __device__ constexpr int row_warp_bytes(int words) {
  return larger(kRowWarps * row_warp_ints(words) * 4, row_block_bytes(words));
}
// and the k = 1 pass's: kBinIds ids, sums and sorted sums, and a byte a
// record (its row in the block)
template <typename T>
__host__ __device__ constexpr int row_bin_bytes(int words) {
  return larger(kBinIds * (4 + 2 * static_cast<int>(sizeof(T)) + 1),
                row_block_bytes(words));
}

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

// The same from +0 over col[ray] for the rays of `count` sorted keys.
template <typename T, typename K>
__device__ __forceinline__ T fold_rays(const T* col, const K* keys,
                                       int count) {
  T s = T(0);
  int i = 0;
  for (; i + kUnroll <= count; i += kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = col[static_cast<int>(keys[i + u] & (kTile - 1))];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s += v[u];
  }
  for (; i < count; ++i) s += col[static_cast<int>(keys[i] & (kTile - 1))];
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

// ---- pass 0 ---------------------------------------------------------------

// The row counts and pass 2's grid barrier set to 0: `quads` 16-byte words
// from `at`.
__global__ void __launch_bounds__(kZeroThreads)
segment_sum_zero(int4* __restrict__ at, long long quads) {
  const long long step = static_cast<long long>(gridDim.x) * kZeroThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kZeroThreads) +
                     threadIdx.x;
       i < quads; i += step)
    at[i] = make_int4(0, 0, 0, 0);
}

// ---- pass 1 ---------------------------------------------------------------

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(at), "l"(src) : "memory");
  } else if constexpr (kBytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(at), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(at), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copies of columns c0 .. c0 + cols - 1 of the tile's `rays`
// rays into stage[column][Staging<T>::kStride], in ray order; a column of
// ct is ld elements long.  16 bytes a copy where the column's start allows it.
template <typename T>
__device__ __forceinline__ void copy_columns(const T* __restrict__ ct, int ld,
                                             int t0, int rays, int c0,
                                             int cols, T* stage) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  for (int c = 0; c < cols; ++c) {
    const T* src = ct + static_cast<size_t>(c0 + c) * ld + t0;
    T* dst = stage + c * Staging<T>::kStride;
    if (rays == kTile && (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
      for (int p = threadIdx.x * kVec; p < kTile; p += kTileThreads * kVec)
        cp_async<16>(dst + p, src + p);
    } else {
      for (int p = threadIdx.x; p < rays; p += kTileThreads)
        cp_async<static_cast<int>(sizeof(T))>(dst + p, src + p);
    }
  }
}

template <typename K>
__device__ __forceinline__ void store_keys(K* dst, const K (&key)[kKeys]) {
  if constexpr (sizeof(K) == 4) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(key[0], key[1], key[2],
                                                key[3]);
  } else {
    reinterpret_cast<ulonglong2*>(dst)[0] = make_ulonglong2(key[0], key[1]);
    reinterpret_cast<ulonglong2*>(dst)[1] = make_ulonglong2(key[2], key[3]);
  }
}

template <typename K>
__device__ __forceinline__ void load_keys(const K* src, K (&key)[kKeys]) {
  if constexpr (sizeof(K) == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    key[0] = v.x, key[1] = v.y, key[2] = v.z, key[3] = v.w;
  } else {
    const ulonglong2 a = reinterpret_cast<const ulonglong2*>(src)[0];
    const ulonglong2 b = reinterpret_cast<const ulonglong2*>(src)[1];
    key[0] = a.x, key[1] = a.y, key[2] = b.x, key[3] = b.y;
  }
}

// a becomes min(a, b) where keep_min, else max(a, b)
template <typename K>
__device__ __forceinline__ void keep(K& a, K b, bool keep_min) {
  a = ((a < b) == keep_min) ? a : b;
}

// Bitonic sort, ascending, of the kTile keys the block holds in registers,
// thread t the places t * kKeys .. t * kKeys + 3: the strides below kKeys
// within the thread, below kWarpKeys by shuffles, the rest through
// buf[0] / buf[1] in turns (one barrier a stage).
template <typename K>
__device__ __forceinline__ void bitonic_sort(K (&key)[kKeys],
                                             K (*buf)[kKeyRow]) {
  const int t = threadIdx.x;
  int turn = 0;
#pragma unroll
  for (int size = 2; size <= kTile; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= kWarpKeys) {
        K* b = buf[turn];
        turn ^= 1;
        store_keys(b + t * kKeys, key);
        __syncthreads();
        K other[kKeys];
        load_keys(b + (t ^ (stride / kKeys)) * kKeys, other);
#pragma unroll
        for (int q = 0; q < kKeys; ++q) {
          const int p = t * kKeys + q;
          keep(key[q], other[q], ((p & size) == 0) == ((p & stride) == 0));
        }
      } else if (stride >= kKeys) {
#pragma unroll
        for (int q = 0; q < kKeys; ++q) {
          const int p = t * kKeys + q;
          const K other = __shfl_xor_sync(kFull, key[q], stride / kKeys);
          keep(key[q], other, ((p & size) == 0) == ((p & stride) == 0));
        }
      } else {
#pragma unroll
        for (int q = 0; q < kKeys; ++q) {
          if (q & stride) continue;
          const bool ascending = ((t * kKeys + q) & size) == 0;
          const K a = key[q], b = key[q | stride];
          const bool swap = (a > b) == ascending;
          key[q] = swap ? b : a;
          key[q | stride] = swap ? a : b;
        }
      }
    }
  }
}

// Pass 1 over the n rays of a chunk (columns of ct ld long), one block a
// tile, keys K (32-bit where (m << kTileBits) fits).  Dynamic shared
// memory: min(k, Staging<T>::kCols) staged columns.
template <typename T, typename K>
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
segment_sum_tiles(const T* __restrict__ ct, int ld,
                  const int* __restrict__ idx, int n, int m, int k,
                  T* __restrict__ rec_sum,
                  unsigned short* __restrict__ rec_first,
                  int* __restrict__ tile_runs, int* __restrict__ count) {
  constexpr int kCols = Staging<T>::kCols;
  // keys[1] serves the sort, then holds the runs' first places (kTile + 1
  // ints), so that three tiles fit an SM
  __shared__ __align__(16) K keys[2][kKeyRow];
  __shared__ int warp_sums[32];
  int* run_begin = reinterpret_cast<int*>(keys[1]);
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  T* stage = reinterpret_cast<T*>(stage_bytes);
  const int t = threadIdx.x;

  const int tile = blockIdx.x;
  const int t0 = tile * kTile;
  const int rays = min(kTile, n - t0);
  const int group = min(k, kCols);
  // the first columns fly while the keys are sorted
  copy_columns(ct, ld, t0, rays, 0, group, stage);

  K key[kKeys];
  int rows[kKeys];
  if (rays == kTile && (reinterpret_cast<uintptr_t>(idx + t0) & 15u) == 0) {
    const int4 v = reinterpret_cast<const int4*>(idx + t0)[t];
    rows[0] = v.x, rows[1] = v.y, rows[2] = v.z, rows[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < kKeys; ++q) {
      const int p = t * kKeys + q;
      rows[q] = p < rays ? idx[t0 + p] : -1;
    }
  }
#pragma unroll
  for (int q = 0; q < kKeys; ++q) {
    const K row = (rows[q] >= 0 && rows[q] < m) ? static_cast<K>(rows[q])
                                                : static_cast<K>(m);
    key[q] = (row << kTileBits) | static_cast<K>(t * kKeys + q);
  }
  store_keys(keys[0] + t * kKeys, key);
  __syncthreads();
  // sorted already where the rows ascend, as on coherent rays
  bool ascending = true;
#pragma unroll
  for (int q = 0; q + 1 < kKeys; ++q)
    ascending = ascending && key[q] < key[q + 1];
  if (t + 1 < kTileThreads)
    ascending = ascending && key[kKeys - 1] < keys[0][(t + 1) * kKeys];
  const bool in_order = __syncthreads_and(ascending);
  if (!in_order) {
    bitonic_sort(key, keys);
    __syncthreads();
    store_keys(keys[0] + t * kKeys, key);
    __syncthreads();
  }
  const K* sorted = keys[0];

  // the runs: a key starts one where its row differs from the key before;
  // the dropped keys sort last, so the valid ones are a prefix
  K prev = t > 0 ? sorted[t * kKeys - 1] : K(0);
  bool start[kKeys];
  int starts = 0, kept = 0;
#pragma unroll
  for (int q = 0; q < kKeys; ++q) {
    const K row = key[q] >> kTileBits;
    const bool valid = row < static_cast<K>(m);
    start[q] = valid && (t * kKeys + q == 0 || (prev >> kTileBits) != row);
    prev = key[q];
    starts += start[q];
    kept += valid;
  }
  int total = 0;
  int r = block_exclusive_scan(starts | (kept << 16), warp_sums, &total) &
          0xffff;
  const int runs = total & 0xffff;
#pragma unroll
  for (int q = 0; q < kKeys; ++q)
    if (start[q]) run_begin[r++] = t * kKeys + q;
  if (t == 0) {
    run_begin[runs] = total >> 16;
    tile_runs[tile] = runs;
  }
  __syncthreads();
  // each run's first ray, and its row's count of records (integer
  // atomicAdd: exact; a tile's runs hold distinct rows)
  for (int q = t; q < runs; q += kTileThreads) {
    const K first = sorted[run_begin[q]];
    rec_first[t0 + q] = static_cast<unsigned short>(first & (kTile - 1));
    atomicAdd(count + static_cast<size_t>(first >> kTileBits), 1);
  }

  for (int c0 = 0; c0 < k; c0 += group) {
    const int cols = min(group, k - c0);
    if (c0 > 0) {
      __syncthreads();  // the columns before are folded
      copy_columns(ct, ld, t0, rays, c0, cols, stage);
    }
    cp_async_wait_all();
    __syncthreads();
    // thread t folds (run, column) pairs t, t + kTileThreads, ...
    const int run_step = kTileThreads / cols;
    const int col_step = kTileThreads - run_step * cols;
    int run = t / cols, c = t - run * cols;
    while (run < runs) {
      const int b = run_begin[run];
      const T* col = stage + c * Staging<T>::kStride;
      // where the rows ascended, key order is ray order
      const T s = in_order ? fold(col + b, run_begin[run + 1] - b)
                           : fold_rays(col, sorted + b,
                                       run_begin[run + 1] - b);
      rec_sum[static_cast<size_t>(t0 + run) * k + c0 + c] = s;
      run += run_step;
      c += col_step;
      if (c >= cols) {
        c -= cols;
        ++run;
      }
    }
  }
}

// ---- pass 2 ---------------------------------------------------------------

// All blocks of the cooperative grid wait here; *barrier counts arrivals
// (zeroed with the counts before pass 1), `target` is gridDim.x times the
// barrier's number.
__device__ __forceinline__ void grid_barrier(unsigned* barrier,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(barrier, 1u);
    for (;;) {
      unsigned seen;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(barrier) : "memory");
      if (seen >= target) break;
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Pass 2: each row's start from the counts of pass 1, then each record's
// slot into its row's list at a cursor (the count's place, set to the
// start) taken by integer atomicAdd.  What other blocks wrote in this
// launch is read past the L1 (__ldcg).
__global__ void __launch_bounds__(kOrderThreads)
segment_sum_order(const int* __restrict__ idx,
                  const unsigned short* __restrict__ rec_first,
                  const int* __restrict__ tile_runs, int tiles, int m,
                  int* count, int* start, int* block_total,
                  unsigned* __restrict__ list, unsigned* barrier) {
  __shared__ int warp_sums[32];
  const int blocks = gridDim.x, b = blockIdx.x, t = threadIdx.x;

  // the rows [j0, j1) of this block: each one's records before it among
  // the block's, and the block's total
  const long long per = (static_cast<long long>(m) + blocks - 1) / blocks;
  const int j0 = static_cast<int>(min(static_cast<long long>(m), b * per));
  const int j1 = static_cast<int>(min(static_cast<long long>(m), j0 + per));
  int carry = 0;
  for (int base = j0; base < j1; base += kOrderThreads) {
    const int j = base + t;
    int total = 0;
    const int before = block_exclusive_scan(j < j1 ? count[j] : 0, warp_sums,
                                            &total);
    if (j < j1) start[j] = carry + before;
    carry += total;
  }
  if (t == 0) block_total[b] = carry;
  grid_barrier(barrier, blocks);

  // plus the records of the blocks before; the cursors start there
  int s = 0;
  for (int i = t; i < b; i += kOrderThreads) s += __ldcg(block_total + i);
  int prefix = 0;
  block_exclusive_scan(s, warp_sums, &prefix);
  for (int j = j0 + t; j < j1; j += kOrderThreads) {
    const int at = start[j] + prefix;
    start[j] = at;
    count[j] = at;
  }
  if (b == blocks - 1 && t == 0) start[m] = prefix + carry;
  grid_barrier(barrier, 2u * blocks);

  // each record's slot to its place in its row's list, in no fixed order;
  // a thread takes its kPlaces records of a tile at once, each step's
  // loads (first ray, row) and atomics issued together
  for (int tile = b; tile < tiles; tile += blocks) {
    const int runs = tile_runs[tile];
    const int base = tile * kTile;
    int got[kPlaces];
#pragma unroll
    for (int q = 0; q < kPlaces; ++q) {
      const int r = t + q * kOrderThreads;
      got[q] = r < runs ? rec_first[base + r] : 0;
    }
#pragma unroll
    for (int q = 0; q < kPlaces; ++q)
      if (t + q * kOrderThreads < runs) got[q] = idx[base + got[q]];
#pragma unroll
    for (int q = 0; q < kPlaces; ++q)
      if (t + q * kOrderThreads < runs) got[q] = atomicAdd(count + got[q], 1);
#pragma unroll
    for (int q = 0; q < kPlaces; ++q) {
      const int r = t + q * kOrderThreads;
      if (r < runs) list[got[q]] = static_cast<unsigned>(base + r);
    }
  }
}

// ---- pass 3 ---------------------------------------------------------------

// A record's place in its row's list by tile: the bits of the tiles below
// its own in the row's bitmap (pre: each word's exclusive prefix).
__device__ __forceinline__ int tile_rank(const unsigned* bits,
                                         const unsigned* pre, unsigned id) {
  const unsigned tile = id >> kTileBits;
  const unsigned w = tile >> 5;
  return static_cast<int>(pre[w]) +
         __popc(bits[w] & ((1u << (tile & 31u)) - 1u));
}

// pre[w] = the set bits of words[0 .. w), by the warp.
__device__ __forceinline__ void warp_word_prefix(const unsigned* bits,
                                                 unsigned* pre, int words) {
  const int lane = threadIdx.x & 31;
  const int span = (words + 31) >> 5;
  const int w0 = min(words, lane * span), w1 = min(words, w0 + span);
  int local = 0;
  for (int w = w0; w < w1; ++w) local += __popc(bits[w]);
  int x = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  int run = x - local;
  for (int w = w0; w < w1; ++w) {
    pre[w] = static_cast<unsigned>(run);
    run += __popc(bits[w]);
  }
}

// Row j by the whole block: its list sorted by tile into shared memory,
// then kRowThreads columns at a time, the sorted records' sums staged
// kRowLoads loads a thread at a time and folded from +0 (or onto out's
// row) by one thread a column.  Every thread calls it.
template <typename T>
__device__ void block_row(int j, const int* __restrict__ start,
                          const unsigned* __restrict__ list,
                          const T* __restrict__ rec_sum, int k, int words,
                          bool onto, T* __restrict__ out,
                          unsigned char* smem) {
  constexpr int kStage = Staging<T>::kRow;
  constexpr int kLoads = Staging<T>::kLoads;
  unsigned* bits = reinterpret_cast<unsigned*>(smem);
  unsigned* pre = bits + words;
  unsigned* sorted = pre + words;
  T* stage = reinterpret_cast<T*>(smem + row_stage_offset(words));
  const int t = threadIdx.x;
  const int base = start[j];
  const int count = start[j + 1] - base;
  if (count > 0) {
    for (int w = t; w < words; w += kRowThreads) bits[w] = 0u;
    __syncthreads();
    for (int i = t; i < count; i += kRowThreads) {
      const unsigned tile = list[base + i] >> kTileBits;
      atomicOr(bits + (tile >> 5), 1u << (tile & 31u));
    }
    __syncthreads();
    if (t < 32) warp_word_prefix(bits, pre, words);
    __syncthreads();
    for (int i = t; i < count; i += kRowThreads) {
      const unsigned id = list[base + i];
      sorted[tile_rank(bits, pre, id)] = id;
    }
    __syncthreads();
  }
  T* row_out = out + static_cast<size_t>(j) * k;
  for (int c0 = 0; c0 < k; c0 += kRowThreads) {
    const int cols = min(kRowThreads, k - c0);
    const int per_round = max(1, kStage / cols);
    T s = onto && t < cols ? row_out[c0 + t] : T(0);
    for (int i0 = 0; i0 < count; i0 += per_round) {
      const int terms = min(per_round, count - i0);
      const int entries = terms * cols;
      for (int q0 = 0; q0 < entries; q0 += kLoads * kRowThreads) {
        T v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int q = q0 + u * kRowThreads + t;
          const int i = q / cols, c = q - i * cols;
          v[u] = q < entries
                     ? rec_sum[static_cast<size_t>(sorted[i0 + i]) * k + c0 +
                               c]
                     : T(0);
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int q = q0 + u * kRowThreads + t;
          if (q < entries) stage[q] = v[u];
        }
      }
      __syncthreads();
      // continues the sum of the rounds before: the same left fold
      if (t < cols) s = fold(stage + t, terms, cols, s);
      __syncthreads();
    }
    if (t < cols) row_out[c0 + t] = s;
  }
}

// Row j (base, count of its list; count <= kWarpIds; k > 1) by one warp,
// in its own `mine` of shared memory (row_warp_ints(words) ints): the
// records ranked by the row's bitmap of the chunk's tiles, then lane c
// folds column c0 + c over 32 records at a time, their loads issued first.
template <typename T>
__device__ void warp_row(int j, int base, int count,
                         const unsigned* __restrict__ list,
                         const T* __restrict__ rec_sum, int k, int words,
                         bool onto, T* __restrict__ out, unsigned* mine) {
  const int lane = threadIdx.x & 31;
  unsigned* bits = mine;
  unsigned* pre = bits + words;
  unsigned* sorted = pre + words;
  T* row_out = out + static_cast<size_t>(j) * k;
  for (int w = lane; w < words; w += 32) bits[w] = 0u;
  __syncwarp();
  for (int i = lane; i < count; i += 32) {
    const unsigned tile = list[base + i] >> kTileBits;
    atomicOr(bits + (tile >> 5), 1u << (tile & 31u));
  }
  __syncwarp();
  warp_word_prefix(bits, pre, words);
  __syncwarp();
  for (int i = lane; i < count; i += 32) {
    const unsigned id = list[base + i];
    sorted[tile_rank(bits, pre, id)] = id;
  }
  __syncwarp();
  for (int c0 = 0; c0 < k; c0 += 32) {
    const int c = c0 + lane;
    T s = onto && c < k ? row_out[c] : T(0);
    for (int i0 = 0; i0 < count; i0 += 32) {
      const int terms = min(32, count - i0);
      T v[32];
#pragma unroll
      for (int u = 0; u < 32; ++u)
        v[u] = (u < terms && c < k)
                   ? rec_sum[static_cast<size_t>(sorted[i0 + u]) * k + c]
                   : T(0);
#pragma unroll
      for (int u = 0; u < 32; ++u)
        if (u < terms) s += v[u];
    }
    if (c < k) row_out[c] = s;
  }
  __syncwarp();
}

// Pass 3 below kWarpRowsMin rows (few long rows): a block a row.
template <typename T>
__global__ void __launch_bounds__(kRowThreads, sizeof(T) == 4
                                                  ? kRowMinBlocks
                                                  : kRowMinBlocks64)
segment_sum_rows(const int* __restrict__ start,
                 const unsigned* __restrict__ list,
                 const T* __restrict__ rec_sum, int k, int words, bool onto,
                 T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  block_row(static_cast<int>(blockIdx.x), start, list, rec_sum, k, words,
            onto, out, smem);
}

// Pass 3 from kWarpRowsMin rows, k > 1: a warp a row, kRowWarps rows a
// block; a row of more than kWarpIds records by the whole block after the
// warps' rows.  `words`: the chunk's tiles / 32, rounded up.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
segment_sum_rows_warp(const int* __restrict__ start,
                      const unsigned* __restrict__ list,
                      const T* __restrict__ rec_sum, int m, int k, int words,
                      bool onto, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int long_rows[kRowWarps];
  const int j0 = blockIdx.x * kRowWarps;
  const int warp = threadIdx.x >> 5;
  const int j = j0 + warp;
  int base = 0, count = 0;
  if (j < m) {
    base = start[j];
    count = start[j + 1] - base;
  }
  const bool is_long = count > kWarpIds;
  if ((threadIdx.x & 31) == 0) long_rows[warp] = is_long;
  if (j < m && !is_long)
    warp_row(j, base, count, list, rec_sum, k, words, onto, out,
             reinterpret_cast<unsigned*>(smem) + warp * row_warp_ints(words));
  __syncthreads();
  for (int w = 0; w < kRowWarps; ++w)
    if (long_rows[w])
      block_row(j0 + w, start, list, rec_sum, k, words, onto, out, smem);
}

// Pass 3 from kWarpRowsMin rows at k = 1 (a histogram's bins): a block
// takes kRowThreads consecutive rows, whose lists lie side by side, as
// many at a time as hold at most kBinIds records.  It stages their ids
// and gathers their sums, ranks each record among its row's by slot (one
// thread a record, comparing with the row's others), puts the sums in
// rank order, and one thread a row folds them from +0 (or onto out).  A
// row of more than kBinIds records is left to the whole block.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
segment_sum_bins(const int* __restrict__ start,
                 const unsigned* __restrict__ list,
                 const T* __restrict__ rec_sum, int m, int words, bool onto,
                 T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int seg[kRowThreads + 1];  // the rows' starts
  unsigned* ids = reinterpret_cast<unsigned*>(smem);
  T* sums = reinterpret_cast<T*>(ids + kBinIds);
  T* ranked = sums + kBinIds;
  unsigned char* of_row = reinterpret_cast<unsigned char*>(ranked + kBinIds);
  const int t = threadIdx.x;
  const int j0 = blockIdx.x * kRowThreads;
  const int rows = min(kRowThreads, m - j0);
  for (int r = t; r <= rows; r += kRowThreads) seg[r] = start[j0 + r];
  __syncthreads();
  for (int r0 = 0; r0 < rows;) {
    // rows [r0, r1): the most that hold kBinIds records, one at least
    int r1 = r0 + 1;
    for (int hi = rows; r1 < hi;) {
      const int mid = (r1 + hi + 1) >> 1;
      if (seg[mid] - seg[r0] <= kBinIds) {
        r1 = mid;
      } else {
        hi = mid - 1;
      }
    }
    const int e0 = seg[r0], count = seg[r1] - e0;
    if (count > kBinIds) {
      block_row(j0 + r0, start, list, rec_sum, 1, words, onto, out, smem);
      __syncthreads();
      r0 = r1;
      continue;
    }
    for (int i = t; i < count; i += kRowThreads) {
      const unsigned id = list[e0 + i];
      ids[i] = id;
      sums[i] = rec_sum[id];
    }
    for (int r = r0 + t; r < r1; r += kRowThreads)
      for (int e = seg[r]; e < seg[r + 1]; ++e)
        of_row[e - e0] = static_cast<unsigned char>(r - r0);
    __syncthreads();
    for (int i = t; i < count; i += kRowThreads) {
      const int r = r0 + of_row[i];
      const int lo = seg[r] - e0, hi = seg[r + 1] - e0;
      const unsigned id = ids[i];
      int rank = 0;
      for (int e = lo; e < hi; ++e) rank += ids[e] < id;
      ranked[lo + rank] = sums[i];
    }
    __syncthreads();
    for (int r = r0 + t; r < r1; r += kRowThreads) {
      T* at = out + j0 + r;
      *at = fold(ranked + (seg[r] - e0), seg[r + 1] - seg[r], 1,
                 onto ? *at : T(0));
    }
    __syncthreads();
    r0 = r1;
  }
}

// ---- host -----------------------------------------------------------------

struct Workspace {
  void* rec_sum;              // [slots][k] of T: the records' sums
  unsigned* list;             // [slots]: each row's record slots
  unsigned short* rec_first;  // [slots]: a record's first ray in its tile
  int* tile_runs;             // [tiles]: the records of each tile
  int* count;                 // [m]: counts, then cursors
  int* start;                 // [m + 1]
  int* block_total;           // [kMaxOrderBlocks]
  unsigned* barrier;          // pass 2's grid barrier, after the counts
  long long zeroed;           // bytes from count to the barrier's end (x 16)
  long long bytes;
};

// The rays of a chunk: all n where they span kChunkTiles tiles or fewer.
int chunk_rays(int n) {
  return static_cast<int>(min(static_cast<long long>(n),
                              static_cast<long long>(kChunkTiles) * kTile));
}

// The workspace's parts from its base address `base` (0 to size it), for a
// chunk of the n rays, and elements of `elem_bytes` (4 or 8) bytes; each
// part on 16 bytes.
Workspace carve(uintptr_t base, int n, int m, int k, int elem_bytes) {
  const long long tiles = (chunk_rays(n) + kTile - 1LL) / kTile;
  const long long slots = tiles * kTile;
  long long offset = 0;
  const auto take = [&](long long bytes) {
    const uintptr_t at = base + static_cast<uintptr_t>(offset);
    offset += (bytes + 15) / 16 * 16;
    return at;
  };
  Workspace w;
  w.rec_sum = reinterpret_cast<void*>(take(slots * k * elem_bytes));
  w.list = reinterpret_cast<unsigned*>(take(slots * 4));
  w.rec_first = reinterpret_cast<unsigned short*>(take(slots * 2));
  w.tile_runs = reinterpret_cast<int*>(take(tiles * 4));
  w.start = reinterpret_cast<int*>(take(4LL * (m + 1LL)));
  w.block_total = reinterpret_cast<int*>(take(4LL * kMaxOrderBlocks));
  w.count = reinterpret_cast<int*>(take(4LL * m));
  w.barrier = reinterpret_cast<unsigned*>(take(4));
  w.zeroed = offset - static_cast<long long>(
      reinterpret_cast<uintptr_t>(w.count) - base);
  w.bytes = offset;
  return w;
}

std::mutex g_lock;
int g_order_blocks[kMaxDevices];  // 0 until the device is prepared

// Sets the dynamic shared memory `fn` may take.
cudaError_t allow(const void* fn, int bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T>
constexpr int tile_stage_bytes(int cols) {
  return cols * Staging<T>::kStride * static_cast<int>(sizeof(T));
}

// Once a process and device: the dynamic shared memory the tile and row
// passes may take (every instance at its largest), and pass 2's grid, as
// many blocks as can be resident together.
cudaError_t prepare(int* order_blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(g_lock);
  if (g_order_blocks[dev] == 0) {
    const int f = tile_stage_bytes<float>(Staging<float>::kCols);
    const int d = tile_stage_bytes<double>(Staging<double>::kCols);
    const int rows = row_block_bytes(kChunkWords);
    const int warps = row_warp_bytes(kChunkWords);
    const struct {
      const void* fn;
      int bytes;
    } limits[] = {
        {reinterpret_cast<const void*>(&segment_sum_tiles<float, unsigned>),
         f},
        {reinterpret_cast<const void*>(
             &segment_sum_tiles<float, unsigned long long>), f},
        {reinterpret_cast<const void*>(&segment_sum_tiles<double, unsigned>),
         d},
        {reinterpret_cast<const void*>(
             &segment_sum_tiles<double, unsigned long long>), d},
        {reinterpret_cast<const void*>(&segment_sum_rows<float>), rows},
        {reinterpret_cast<const void*>(&segment_sum_rows<double>), rows},
        {reinterpret_cast<const void*>(&segment_sum_rows_warp<float>), warps},
        {reinterpret_cast<const void*>(&segment_sum_rows_warp<double>),
         warps},
        {reinterpret_cast<const void*>(&segment_sum_bins<float>),
         row_bin_bytes<float>(kChunkWords)},
        {reinterpret_cast<const void*>(&segment_sum_bins<double>),
         row_bin_bytes<double>(kChunkWords)}};
    for (const auto& limit : limits) {
      err = allow(limit.fn, limit.bytes);
      if (err != cudaSuccess) return err;
    }
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segment_sum_order, kOrderThreads, 0);
    if (err != cudaSuccess) return err;
    const int blocks = min(kMaxOrderBlocks, sms * min(per_sm,
                                                      kOrderBlocksPerSm));
    if (blocks < 1) return cudaErrorLaunchOutOfResources;
    g_order_blocks[dev] = blocks;
  }
  *order_blocks = g_order_blocks[dev];
  return cudaSuccess;
}

// The counts zeroed (pass 0) and the three passes over the chunk of n
// rays at ct (columns ld long) and idx, into out, from +0 or, where
// `onto`, onto out.
template <typename T, typename K>
int launch_chunk(const T* ct, int ld, const int* idx, int n, int m, int k,
                 bool onto, T* out, const Workspace& w, int order_blocks,
                 cudaStream_t s) {
  int tiles = (n + kTile - 1) / kTile;
  T* rec_sum = static_cast<T*>(w.rec_sum);
  const long long quads = w.zeroed / 16;
  segment_sum_zero<<<static_cast<int>(min(
                         (quads + kZeroThreads - 1) / kZeroThreads, 1024LL)),
                     kZeroThreads, 0, s>>>(reinterpret_cast<int4*>(w.count),
                                           quads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  segment_sum_tiles<T, K><<<tiles, kTileThreads,
                            tile_stage_bytes<T>(min(k, Staging<T>::kCols)),
                            s>>>(
      ct, ld, idx, n, m, k, rec_sum, w.rec_first, w.tile_runs, w.count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int* a_idx = idx;
  const unsigned short* a_first = w.rec_first;
  const int* a_runs = w.tile_runs;
  int a_m = m;
  int* a_count = w.count;
  int* a_start = w.start;
  int* a_total = w.block_total;
  unsigned* a_list = w.list;
  unsigned* a_barrier = w.barrier;
  void* args[] = {&a_idx, &a_first, &a_runs, &tiles, &a_m, &a_count,
                  &a_start, &a_total, &a_list, &a_barrier};
  // fewer blocks wait at the barriers where the records are fewer
  const int grid = m < kOrderHalfRows ? max(1, order_blocks / 2)
                                      : order_blocks;
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&segment_sum_order), dim3(grid),
      dim3(kOrderThreads), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int words = (tiles + 31) / 32;
  if (m < kWarpRowsMin) {
    segment_sum_rows<T><<<m, kRowThreads, row_block_bytes(words), s>>>(
        w.start, w.list, rec_sum, k, words, onto, out);
  } else if (k == 1) {
    segment_sum_bins<T><<<(m + kRowThreads - 1) / kRowThreads, kRowThreads,
                          row_bin_bytes<T>(words), s>>>(
        w.start, w.list, rec_sum, m, words, onto, out);
  } else {
    segment_sum_rows_warp<T><<<(m + kRowWarps - 1) / kRowWarps, kRowThreads,
                               row_warp_bytes(words), s>>>(
        w.start, w.list, rec_sum, m, k, words, onto, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* ct, const int* idx, int n, int m, int k, int tile,
           T* out, void* work, void* stream) {
  if (tile != kTile) return static_cast<int>(cudaErrorInvalidValue);
  int order_blocks = 0;
  const cudaError_t err = prepare(&order_blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Workspace w = carve(reinterpret_cast<uintptr_t>(work), n, m, k,
                            static_cast<int>(sizeof(T)));
  const int chunk = chunk_rays(n);
  const bool narrow = m < kNarrowRows;
  for (long long r0 = 0; r0 < n; r0 += chunk) {
    const int rays = static_cast<int>(min(1LL * chunk, n - r0));
    const int e = narrow
        ? launch_chunk<T, unsigned>(ct + r0, n, idx + r0, rays, m, k, r0 > 0,
                                    out, w, order_blocks, s)
        : launch_chunk<T, unsigned long long>(ct + r0, n, idx + r0, rays, m,
                                              k, r0 > 0, out, w,
                                              order_blocks, s);
    if (e != 0) return e;
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
// entry written); work: segment_sum_workspace(n, m, k, 4) bytes, 16-byte
// aligned.  `tile` must be kTile, the caller's tile: else nothing runs and
// cudaErrorInvalidValue is returned.  Needs n >= 1, m >= 1, 1 <= k and
// m * k < 2^31.  Launches on `stream` (four kernels a chunk of 2^23 rays,
// the third cooperative) and returns the CUDA error code (0 = launched).
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
