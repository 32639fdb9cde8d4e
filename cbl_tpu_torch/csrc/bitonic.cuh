// The bitonic compare-exchange network over rows of one or two int64 key
// columns, shared by kernel B6 (csrc/bitonic_sort.cu, a full sort) and
// kernel B7 (csrc/bitonic_merge.cu, the merge of two sorted runs).
//
// Rows compare lexicographically, column 0 major; equal rows are identical,
// so the result of either kernel equals a stable library sort.  A network
// step with stride j exchanges row i (bit j clear) with row i | j: the
// smaller row ends at i when the pair's direction is ascending, at i | j
// when it is descending.  In stage k of a sort the direction of row i is
// ascending iff bit k of i is clear (`dir_bit` = log2 k below); a merge pins
// every pair ascending (`dir_bit` < 0).
//
// The network runs over a work buffer of P rows, P a power of two and a
// multiple of the tile of kBitonicTile rows:
//   `cross_pass`   one step with a stride j >= kBitonicTile, in device
//                  memory: one thread owns the pair (i, i | j), reads both
//                  rows and writes them back in place only when they swap.
//                  No other thread touches either row in that launch, which
//                  is what makes the update in place safe.
//   `intile_pass`  the steps j = kBitonicTile / 2 ... 1 of one stage, one
//                  block per tile in shared memory, with a barrier between
//                  steps; the direction is constant inside a tile.  It reads
//                  the work buffer and writes either back in place or, in a
//                  network's last pass, the first `n_dst` rows to the output.
// The TPU kernels' [H, 128] layout, their roll-based exchanges, their mask
// select and their scalar-prefetched parameters are not copied.
//
// What bounds the network on the H100: every cross pass moves all P rows
// through device memory once for one step, so a sort makes about
// log2(P / tile)^2 / 2 passes and a merge log2(P / tile); the in-tile
// passes are bound by shared memory (bank conflicts at small strides).
// Both are left as they are: the kernels are simple and exact first.

#pragma once

#include <cuda_runtime.h>

namespace cbl {
namespace {

constexpr int kBitonicThreads = 512;
constexpr int kBitonicTileLog = 12;
constexpr int kBitonicTile = 1 << kBitonicTileLog;  // = ops/bitonic.py TILE
constexpr int kCrossThreads = 256;
constexpr long long kBitonicPad = 0x7fffffffffffffffLL;  // sorts last

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

// Dynamic shared memory of the tile kernels: column c of the tile at
// [c * kBitonicTile, (c + 1) * kBitonicTile).  Two columns take 64 KB, above
// the 48 KB a kernel gets without asking (`allow_tile_smem`).
template <int C>
constexpr int tile_smem_bytes() {
  return C * kBitonicTile * (int)sizeof(long long);
}

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

// Row index of pair t at stride j: t with a zero bit inserted at bit j.
__device__ __forceinline__ long long pair_low(long long t, long long j) {
  return ((t & ~(j - 1)) << 1) | (t & (j - 1));
}

// One compare-exchange of the shared tile's rows lo and hi.
template <int C>
__device__ __forceinline__ void exchange_shared(long long* s, int lo, int hi,
                                                bool asc) {
  long long x[C], y[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    x[c] = s[c * kBitonicTile + lo];
    y[c] = s[c * kBitonicTile + hi];
  }
  // out of order when the larger row sits where the smaller belongs
  const bool swap = asc ? row_gt<C>(x, y) : row_gt<C>(y, x);
  if (swap) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      s[c * kBitonicTile + lo] = y[c];
      s[c * kBitonicTile + hi] = x[c];
    }
  }
}

// The steps j0, j0 / 2, ..., 1 over the first `rows` rows of the shared
// tile (a power of two), every pair in direction `asc`.  Ends on a barrier.
template <int C>
__device__ __forceinline__ void shared_steps(long long* s, int rows, int j0,
                                             bool asc) {
  for (int j = j0; j > 0; j >>= 1) {
    for (int t = threadIdx.x; t < rows / 2; t += kBitonicThreads) {
      const int lo = (int)pair_low(t, j);
      exchange_shared<C>(s, lo, lo | j, asc);
    }
    __syncthreads();
  }
}

// Tile `blockIdx.x` of `src` into shared memory; rows at or beyond n_src
// become pad rows.  Ends on a barrier.
template <int C>
__device__ __forceinline__ void load_tile(long long* s, const Keys<C>& src,
                                          long long n_src) {
  const long long base = (long long)blockIdx.x * kBitonicTile;
#pragma unroll
  for (int c = 0; c < C; ++c)
    for (int r = threadIdx.x; r < kBitonicTile; r += kBitonicThreads)
      s[c * kBitonicTile + r] =
          base + r < n_src ? src.p[c][base + r] : kBitonicPad;
  __syncthreads();
}

// The shared tile back to tile `blockIdx.x` of `dst`, rows below n_dst.
template <int C>
__device__ __forceinline__ void store_tile(const long long* s,
                                           const MutKeys<C>& dst,
                                           long long n_dst) {
  const long long base = (long long)blockIdx.x * kBitonicTile;
#pragma unroll
  for (int c = 0; c < C; ++c)
    for (int r = threadIdx.x; r < kBitonicTile; r += kBitonicThreads)
      if (base + r < n_dst) dst.p[c][base + r] = s[c * kBitonicTile + r];
}

// One step with stride j >= kBitonicTile over the `pairs` pairs of the work
// buffer, in place.
template <int C>
__global__ void cross_pass(MutKeys<C> w, long long pairs, long long j,
                           int dir_bit) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const long long lo = pair_low(t, j);
  const long long hi = lo | j;
  long long x[C], y[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    x[c] = w.p[c][lo];
    y[c] = w.p[c][hi];
  }
  const bool swap = ascending(lo, dir_bit) ? row_gt<C>(x, y) : row_gt<C>(y, x);
  if (swap) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      w.p[c][lo] = y[c];
      w.p[c][hi] = x[c];
    }
  }
}

// The steps kBitonicTile / 2 ... 1 of one stage, one block per tile of
// `src` (P rows, all present); rows below n_dst go to `dst`, which may be
// `src` itself (each block reads and writes its own tile only).
template <int C>
__global__ void intile_pass(Keys<C> src, long long n_src, MutKeys<C> dst,
                            long long n_dst, int dir_bit) {
  extern __shared__ long long tile_s[];
  load_tile<C>(tile_s, src, n_src);
  const bool asc = ascending((long long)blockIdx.x * kBitonicTile, dir_bit);
  shared_steps<C>(tile_s, kBitonicTile, kBitonicTile / 2, asc);
  store_tile<C>(tile_s, dst, n_dst);
}

template <int C>
cudaError_t launch_cross(const MutKeys<C>& w, long long rows, long long j,
                         int dir_bit, cudaStream_t s) {
  const long long pairs = rows / 2;
  const long long blocks = (pairs + kCrossThreads - 1) / kCrossThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cross_pass<C><<<(unsigned)blocks, kCrossThreads, 0, s>>>(w, pairs, j,
                                                           dir_bit);
  return cudaGetLastError();
}

// `tiles` blocks of `intile_pass` from the work buffer of `rows` rows.
template <int C>
cudaError_t launch_intile(const MutKeys<C>& w, long long rows,
                          const MutKeys<C>& dst, long long n_dst,
                          long long tiles, int dir_bit, cudaStream_t s) {
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = allow_tile_smem(intile_pass<C>, tile_smem_bytes<C>());
  if (err != cudaSuccess) return err;
  intile_pass<C><<<(unsigned)tiles, kBitonicThreads, tile_smem_bytes<C>(),
                   s>>>(as_const<C>(w), rows, dst, n_dst, dir_bit);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cbl
