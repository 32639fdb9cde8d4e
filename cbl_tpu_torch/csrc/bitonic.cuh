// The bitonic compare-exchange network over rows of one to three int64 key
// columns, shared by kernel B6 (csrc/bitonic_sort.cu, a full sort: the
// tile, the fuse width, the padded slots, the direction rule) and kernel
// B7 (csrc/bitonic_merge.cu, the merge of two sorted runs: one tile in
// shared memory a block, `shared_steps`).
//
// Rows compare lexicographically, column 0 major; equal rows are identical,
// so the result of either kernel equals a stable library sort.  A network
// step with stride j exchanges row i (bit j clear) with row i | j: the
// smaller row ends at i when the pair's direction is ascending, at i | j
// when it is descending.  In stage k of a sort the direction of row i is
// ascending iff bit k of i is clear (`dir_bit` = log2 k below); a merge pins
// every pair ascending (`dir_bit` < 0).  Inside a stage the direction bit
// lies above every stride, so any 2^m rows that differ only in m chosen
// index bits are closed under the steps with those m strides.
//
// What bounds the network on the H100: passes over device memory and
// barriers between shared-memory steps.  Both are cut by carrying many
// steps through one load: a thread holds 2^kRoundLog rows of the shared
// tile that differ in kRoundLog consecutive stride bits and runs those
// steps without a barrier (`shared_round`); the block meets once per
// kRoundLog steps.  The shared rows are padded by one every eight
// (`phys`), so that such a thread's rows and its neighbours' fall into
// different banks.  B6 carries the same rounds on (column 0, tile row)
// pairs and runs up to kFuseLog strides at or above the tile in one pass
// over device memory (csrc/bitonic_sort.cu).  The TPU kernels' [H, 128]
// layout, their roll-based exchanges, their mask select and their
// scalar-prefetched parameters are not copied.

#pragma once

#include <cuda_runtime.h>

namespace cbl {
namespace {

constexpr int kBitonicThreads = 512;
constexpr int kRoundLog = 3;  // strides a thread runs in registers at once
constexpr long long kBitonicPad = 0x7fffffffffffffffLL;  // sorts last

// B6's tile: 2^13 rows of one column, 2^12 rows of two or three.
// = ops/bitonic.py TILES
template <int C>
constexpr int kTileLog = C == 1 ? 13 : 12;
template <int C>
constexpr int kTileRows = 1 << kTileLog<C>;
// the most strides one cross pass fuses: slices keep 2^4 rows
template <int C>
constexpr int kFuseLog = kTileLog<C> - 4;  // = ops/bitonic.py fuse_log

template <int C>
struct Keys {
  const long long* p[C];
};

template <int C>
struct MutKeys {
  long long* p[C];
};

template <int C>
__host__ __device__ __forceinline__ Keys<C> as_const(const MutKeys<C>& x) {
  Keys<C> r;
#pragma unroll
  for (int c = 0; c < C; ++c) r.p[c] = x.p[c];
  return r;
}

// Where row i of the tile lies in a shared column: one unused slot after
// every eight rows.
__device__ __forceinline__ int phys(int i) { return i + (i >> 3); }

// Slots of one padded shared column of B6's tile.  B6's tiles exceed the
// 48 KB a kernel gets without asking (`allow_tile_smem`).
template <int C>
constexpr int kColSlots = kTileRows<C> + kTileRows<C> / 8;

template <class Kernel>
cudaError_t allow_tile_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// x > y, lexicographic over the C columns.
template <int C>
__device__ __forceinline__ bool row_gt(const long long (&x)[C],
                                       const long long (&y)[C]) {
#pragma unroll
  for (int c = 0; c < C - 1; ++c) {
    if (x[c] != y[c]) return x[c] > y[c];
  }
  return x[C - 1] > y[C - 1];
}

// Ascending iff bit `dir_bit` of the global row index is clear; a negative
// `dir_bit` pins the direction ascending.
__device__ __forceinline__ bool ascending(long long row, int dir_bit) {
  return dir_bit < 0 || ((row >> dir_bit) & 1) == 0;
}

// The R consecutive steps with strides 2^(s+R-1) ... 2^s over the first
// `rows` rows of the shared tile (a power of two >= 2^R), whose columns
// are S slots apart, by a block of N threads.  Group g is the 2^R rows
// whose index is g with R zero bits inserted at bit s, plus q << s for
// q < 2^R; a thread loads a group into registers, runs the R steps there
// and stores it.  The group's direction is that of global row `row0` + its
// first row.  No barrier inside.
template <int C, int R, int N = kBitonicThreads, int S = kColSlots<C>>
__device__ __forceinline__ void shared_round(long long* s_tile, int rows,
                                             int s, long long row0,
                                             int dir_bit) {
  constexpr int G = 1 << R;
  for (int g = threadIdx.x; g < (rows >> R); g += N) {
    const int first = ((g >> s) << (s + R)) | (g & ((1 << s) - 1));
    const bool asc = ascending(row0 + first, dir_bit);
    long long v[G][C];
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c)
        v[q][c] = s_tile[c * S + phys(first + (q << s))];
#pragma unroll
    for (int b = R - 1; b >= 0; --b) {
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if ((q >> b) & 1) continue;
        // out of order when the larger row sits where the smaller belongs;
        // a descending pair of equal rows swaps too, which changes nothing
        const bool swap = row_gt<C>(v[q], v[q | (1 << b)]) == asc;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const long long x = v[q][c], y = v[q | (1 << b)][c];
          v[q][c] = swap ? y : x;
          v[q | (1 << b)][c] = swap ? x : y;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c)
        s_tile[c * S + phys(first + (q << s))] = v[q][c];
  }
}

// The steps with strides 2^hi_log ... 2^lo_log over the first `rows` rows of
// the shared tile (`shared_round`'s N and S), kRoundLog strides a round; a
// shorter round comes first, so that the last round ends on stride
// 2^lo_log.  A barrier after every round.
template <int C, int N = kBitonicThreads, int S = kColSlots<C>>
__device__ __forceinline__ void shared_steps(long long* s_tile, int rows,
                                             int hi_log, int lo_log,
                                             long long row0, int dir_bit) {
  static_assert(kRoundLog == 3, "the short rounds below are written for 3");
  const int first = (hi_log - lo_log + 1) % kRoundLog;
  if (first == 1) {
    shared_round<C, 1, N, S>(s_tile, rows, hi_log, row0, dir_bit);
    __syncthreads();
  } else if (first == 2) {
    shared_round<C, 2, N, S>(s_tile, rows, hi_log - 1, row0, dir_bit);
    __syncthreads();
  }
  for (int s = hi_log - first - (kRoundLog - 1); s >= lo_log; s -= kRoundLog) {
    shared_round<C, kRoundLog, N, S>(s_tile, rows, s, row0, dir_bit);
    __syncthreads();
  }
}

}  // namespace
}  // namespace cbl
