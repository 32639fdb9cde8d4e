// The bitonic compare-exchange network over rows of one to three int64 key
// columns, shared by kernel B6 (csrc/bitonic_sort.cu, a full sort, every
// piece below) and kernel B7 (csrc/bitonic_merge.cu, the merge of two
// sorted runs: one tile in shared memory a block, `shared_steps`).
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
// steps through one load:
//   registers   a thread holds 2^kRoundLog rows of the shared tile that
//               differ in kRoundLog consecutive stride bits and runs those
//               steps without a barrier (`shared_round`); the block meets
//               once per kRoundLog steps, and the last strides 4, 2, 1 are
//               a thread's own eight contiguous rows.  The shared rows are
//               padded by one every eight (`phys`), so that such a thread's
//               rows and its neighbours' fall into different banks.
//   `tile_network`  every stage k <= tile over one tile in shared memory.
//   `intile_pass`   the strides tile / 2 ... 1 of one stage, one block per
//               tile; it reads the work buffer and writes either back in
//               place or, in a network's last pass, the first `n_dst` rows
//               to the output.
//   `cross_fused`   up to kFuseLog consecutive strides 2^(a+f-1) ... 2^a, all
//               >= tile, of one stage in ONE pass: a block owns 2^f slices
//               of 2^c contiguous rows, 2^a rows apart, 2^(f+c) = tile
//               (c >= 4: 128 contiguous bytes a slice and column, 16-byte
//               loads), runs the f steps in shared memory (their strides
//               there are 2^(c+f-1) ... 2^c), one direction for the whole
//               block, and writes the slices back in place.  The block owns
//               every row it touches, which is what makes that safe.
// A stage with d strides at or above the tile so takes ceil(d / kFuseLog)
// + 1 passes over device memory, not d + 1.  The TPU kernels' [H, 128]
// layout, their roll-based exchanges, their mask select and their
// scalar-prefetched parameters are not copied.

#pragma once

#include <cuda_runtime.h>

namespace cbl {
namespace {

constexpr int kBitonicThreads = 512;
constexpr int kRoundLog = 3;  // strides a thread runs in registers at once
constexpr long long kBitonicPad = 0x7fffffffffffffffLL;  // sorts last

// The tile: 2^13 rows of one column or 2^12 rows of two, 72 KB of padded
// shared memory either way (three blocks an SM); 2^12 rows of three, 108 KB
// (two blocks an SM at most).  = ops/bitonic.py TILES
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

// Slots of one shared column, and the dynamic shared memory of the tile
// kernels: column c at [c * kColSlots, (c + 1) * kColSlots).  Above the 48 KB
// a kernel gets without asking (`allow_tile_smem`).
template <int C>
constexpr int kColSlots = kTileRows<C> + kTileRows<C> / 8;

template <int C>
constexpr int tile_smem_bytes() {
  return C * kColSlots<C> * (int)sizeof(long long);
}
// three columns: 2^12 rows, 108 KB, of the 227 KB a block may ask for
static_assert(tile_smem_bytes<3>() <= 232448, "a B6 tile exceeds 227 KB");

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

// Every stage k = 2 ... tile over the shared tile whose first row is global
// row `row0` (a multiple of the tile); the last stage's direction is the
// tile's own bit of the global index, so tiles come out ascending and
// descending in turn.  The stages 2, 4, 8 run in one round on a thread's
// eight contiguous rows.
template <int C>
__device__ __forceinline__ void tile_network(long long* s_tile,
                                             long long row0) {
  constexpr int T = kTileRows<C>;
  for (int g = threadIdx.x; g < T / 8; g += kBitonicThreads) {
    long long v[8][C];
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c)
        v[q][c] = s_tile[c * kColSlots<C> + phys(8 * g + q)];
#pragma unroll
    for (int k_log = 1; k_log <= 3; ++k_log) {
#pragma unroll
      for (int b = k_log - 1; b >= 0; --b) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if ((q >> b) & 1) continue;
          const bool asc = (((8 * g + q) >> k_log) & 1) == 0;
          const bool swap = row_gt<C>(v[q], v[q | (1 << b)]) == asc;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const long long x = v[q][c], y = v[q | (1 << b)][c];
            v[q][c] = swap ? y : x;
            v[q | (1 << b)][c] = swap ? x : y;
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c)
        s_tile[c * kColSlots<C> + phys(8 * g + q)] = v[q][c];
  }
  __syncthreads();
  for (int k_log = 4; k_log <= kTileLog<C>; ++k_log)
    shared_steps<C>(s_tile, T, k_log - 1, 0, row0, k_log);
}

// Tile `blockIdx.x` of `src` into shared memory; rows at or beyond n_src
// become pad rows.  Ends on a barrier.
template <int C>
__device__ __forceinline__ void load_tile(long long* s_tile,
                                          const Keys<C>& src,
                                          long long n_src) {
  const long long base = (long long)blockIdx.x * kTileRows<C>;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll 4
    for (int r = threadIdx.x; r < kTileRows<C>; r += kBitonicThreads)
      s_tile[c * kColSlots<C> + phys(r)] =
          base + r < n_src ? src.p[c][base + r] : kBitonicPad;
  __syncthreads();
}

// The shared tile back to tile `blockIdx.x` of `dst`, rows below n_dst.
template <int C>
__device__ __forceinline__ void store_tile(const long long* s_tile,
                                           const MutKeys<C>& dst,
                                           long long n_dst) {
  const long long base = (long long)blockIdx.x * kTileRows<C>;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll 4
    for (int r = threadIdx.x; r < kTileRows<C>; r += kBitonicThreads)
      if (base + r < n_dst)
        dst.p[c][base + r] = s_tile[c * kColSlots<C> + phys(r)];
}

// The f steps with strides 2^(a_log+f-1) ... 2^a_log (all >= the tile) over
// the work buffer, in place.  Block b owns the 2^f slices of 2^c rows,
// c = kTileLog - f, that start at rows first + (q << a_log), q < 2^f, with
// first = (hi << (a_log + f)) | (mid << c) for b = (hi << (a_log - c)) | mid:
// every row whose bits [c, a_log) are mid and whose bits above a_log + f are
// hi.  Slice q lies at [q << c, (q + 1) << c) of the shared tile.
template <int C>
__global__ void __launch_bounds__(kBitonicThreads)
cross_fused(MutKeys<C> w, int a_log, int f, int dir_bit) {
  extern __shared__ long long tile_s[];
  constexpr int T = kTileRows<C>;
  const int c_log = kTileLog<C> - f;
  const long long b = blockIdx.x;
  const long long mid = b & ((1LL << (a_log - c_log)) - 1);
  const long long hi = b >> (a_log - c_log);
  const long long first = (hi << (a_log + f)) | (mid << c_log);
  // two rows (16 bytes) a thread and load; c >= 4 keeps both in one slice
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll 4
    for (int u = threadIdx.x; u < T / 2; u += kBitonicThreads) {
      const int r = 2 * u;
      const long long row = first + ((long long)(r >> c_log) << a_log) +
                            (r & ((1 << c_log) - 1));
      const longlong2 x = *reinterpret_cast<const longlong2*>(w.p[c] + row);
      tile_s[c * kColSlots<C> + phys(r)] = x.x;
      tile_s[c * kColSlots<C> + phys(r + 1)] = x.y;
    }
  }
  __syncthreads();
  // one direction for the block: `dir_bit` lies above a_log + f
  shared_steps<C>(tile_s, T, kTileLog<C> - 1, c_log, first, dir_bit);
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll 4
    for (int u = threadIdx.x; u < T / 2; u += kBitonicThreads) {
      const int r = 2 * u;
      const long long row = first + ((long long)(r >> c_log) << a_log) +
                            (r & ((1 << c_log) - 1));
      longlong2 x;
      x.x = tile_s[c * kColSlots<C> + phys(r)];
      x.y = tile_s[c * kColSlots<C> + phys(r + 1)];
      *reinterpret_cast<longlong2*>(w.p[c] + row) = x;
    }
  }
}

// The steps tile / 2 ... 1 of one stage, one block per tile of `src` (P
// rows, all present); rows below n_dst go to `dst`, which may be `src`
// itself (each block reads and writes its own tile only).
template <int C>
__global__ void __launch_bounds__(kBitonicThreads)
intile_pass(Keys<C> src, long long n_src, MutKeys<C> dst, long long n_dst,
            int dir_bit) {
  extern __shared__ long long tile_s[];
  load_tile<C>(tile_s, src, n_src);
  shared_steps<C>(tile_s, kTileRows<C>, kTileLog<C> - 1, 0,
                  (long long)blockIdx.x * kTileRows<C>, dir_bit);
  store_tile<C>(tile_s, dst, n_dst);
}

// The steps with strides 2^hi_log ... 2^kTileLog of one stage over the work
// buffer of `rows` rows (a power of two, > 2^hi_log), kFuseLog strides a
// launch; a shorter launch comes first.  Adds its launches to `*passes`.
template <int C>
cudaError_t launch_cross(const MutKeys<C>& w, long long rows, int hi_log,
                         int dir_bit, cudaStream_t s, int* passes) {
  const long long blocks = rows >> kTileLog<C>;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = allow_tile_smem(cross_fused<C>, tile_smem_bytes<C>());
  if (err != cudaSuccess) return err;
  int left = hi_log - kTileLog<C> + 1;
  while (left > 0) {
    const int f = left % kFuseLog<C> ? left % kFuseLog<C> : kFuseLog<C>;
    cross_fused<C><<<(unsigned)blocks, kBitonicThreads, tile_smem_bytes<C>(),
                     s>>>(w, kTileLog<C> + left - f, f, dir_bit);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*passes;
    left -= f;
  }
  return cudaSuccess;
}

// `tiles` blocks of `intile_pass` from the work buffer of `rows` rows.
template <int C>
cudaError_t launch_intile(const MutKeys<C>& w, long long rows,
                          const MutKeys<C>& dst, long long n_dst,
                          long long tiles, int dir_bit, cudaStream_t s,
                          int* passes) {
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = allow_tile_smem(intile_pass<C>, tile_smem_bytes<C>());
  if (err != cudaSuccess) return err;
  intile_pass<C><<<(unsigned)tiles, kBitonicThreads, tile_smem_bytes<C>(),
                   s>>>(as_const<C>(w), rows, dst, n_dst, dir_bit);
  ++*passes;
  return cudaGetLastError();
}

}  // namespace
}  // namespace cbl
