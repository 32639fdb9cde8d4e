// Kernel B7: merge of two sorted runs of int64 key rows by the bitonic
// network, in one pass over device memory.
//
// Replaces the TPU kernel cbl_tpu/ops/sort_pallas.py `merge_cols_pallas`,
// with the tiling of cbl_tpu/ops/merge_pallas.py `merge_sorted_cols`
// (`_coranks`, `_merge_call`).  A (na rows) and B (nb rows), each sorted
// ascending (lexicographic, column 0 major), become one sorted run of
// na + nb rows, equal to a sort of their concatenation.
//
// The output is cut into tiles of T = kMergeRows rows; tile g holds the
// outputs [g T, min((g + 1) T, na + nb)).  The co-rank i(d) of a tile edge
// d is the smallest i with A[i] > B[d - i - 1] (`corank`, merge_path.cuh,
// the rule of kernel B3: A before B on ties), and tile g's rows are exactly
// A[i(d0), i(d1)) and B[d0 - i(d0), d1 - i(d1)): after the strides of a
// bitonic merge that cross tiles, each tile holds precisely the rows of its
// rank range, and the co-ranks find that set without moving it through
// memory.  Rows that compare equal are equal in every column, so which run
// supplies them changes no bit of the output.
//   1. `tile_coranks`: one thread a tile edge, all binary searches in
//      flight at once (a chain of ~log2(na) dependent loads each).
//   2. `merge_tile`: block g loads A's slice ascending to the front of its
//      shared tile and B's slice reversed to the back, 16 bytes a load
//      where the address allows, with INT64_MAX pad rows between (they
//      sort behind every output, and fill the last tile): one bitonic
//      sequence of T rows.  The strides T / 2 ... 1, every pair ascending,
//      run in shared memory and registers (`shared_steps`, bitonic.cuh,
//      three strides a round), and the tile's outputs are stored, 16 bytes
//      a store.
// No padded, reversed or concatenated copy is ever made in device memory,
// and nothing is padded beyond one tile.  A and B are only read.
//
// What bounds it on the H100: device memory, one read and one write of
// every row; the co-rank launch reads O(tiles log n) rows more, but its
// searches are chains of dependent loads.  The network, T / 2 log2 T
// compare-exchanges a tile (1.8e8 at 2^25 one-column rows), runs in
// shared memory between the load and the store.  A block cannot overlap
// its own load, network and store, so many small blocks an SM do it for
// each other: tiles of 2^11 rows and 128 threads measured 1.24x faster
// than tiles of 2^13 rows and 512 threads, which their registers held to
// two blocks an SM (NVIDIA H100 80GB HBM3, 700 W).

#include <stdint.h>

#include "bitonic.cuh"
#include "merge_path.cuh"

namespace cbl {
namespace {

constexpr int kEdgeThreads = 256;

// The output tile and its block: 2^11 rows of one column or 2^10 of two
// (18 KB of padded shared memory) or of three (27 KB), 128 threads.
// = ops/bitonic.py MERGE_TILES
constexpr int kMergeThreads = 128;
template <int C>
constexpr int kMergeTileLog = C == 1 ? 11 : 10;
template <int C>
constexpr int kMergeRows = 1 << kMergeTileLog<C>;
template <int C>
constexpr int kMergeSlots = kMergeRows<C> + kMergeRows<C> / 8;
// static shared memory, below the 48 KB a kernel gets without asking (three
// columns: 27 KB)
static_assert(3 * kMergeSlots<3> * 8 <= 48 * 1024, "B7 tile above 48 KB");

// coranks[g] = the co-rank of tile edge min(g T, na + nb), g <= tiles.
template <int C>
__global__ void tile_coranks(Cols<C> a, long long na, Cols<C> b,
                             long long nb, long long tiles,
                             long long* __restrict__ coranks) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g > tiles) return;
  const long long n = na + nb;
  const long long d = g * kMergeRows<C> < n ? g * kMergeRows<C> : n;
  coranks[g] = corank<C>(a, na, b, nb, d);
}

// f(j, src[j]) for every j < len, strided over the block: two rows (16
// bytes) a load, after one lone row where src is not 16-byte aligned and
// before one where the rest is odd.
template <class F>
__device__ __forceinline__ void load_run(const long long* src, int len,
                                         F f) {
  const int head = len > 0 && (reinterpret_cast<uintptr_t>(src) & 8) ? 1 : 0;
  const int pairs = (len - head) >> 1;
  const longlong2* p = reinterpret_cast<const longlong2*>(src + head);
#pragma unroll 4
  for (int u = threadIdx.x; u < pairs; u += kMergeThreads) {
    const longlong2 x = p[u];
    f(head + 2 * u, x.x);
    f(head + 2 * u + 1, x.y);
  }
  if (threadIdx.x == 0 && head) f(0, src[0]);
  if (threadIdx.x == kMergeThreads - 1 && ((len - head) & 1))
    f(len - 1, src[len - 1]);
}

// dst[j] = row(j) for every j < len, 16 bytes a store as `load_run` reads.
template <class G>
__device__ __forceinline__ void store_run(long long* dst, int len, G row) {
  const int head = len > 0 && (reinterpret_cast<uintptr_t>(dst) & 8) ? 1 : 0;
  const int pairs = (len - head) >> 1;
  longlong2* p = reinterpret_cast<longlong2*>(dst + head);
#pragma unroll 4
  for (int u = threadIdx.x; u < pairs; u += kMergeThreads)
    p[u] = make_longlong2(row(head + 2 * u), row(head + 2 * u + 1));
  if (threadIdx.x == 0 && head) dst[0] = row(0);
  if (threadIdx.x == kMergeThreads - 1 && ((len - head) & 1))
    dst[len - 1] = row(len - 1);
}

// Output tile `blockIdx.x`: its slices of A and B as one bitonic sequence
// of T rows in shared memory, [A's slice, pads, B's slice reversed], the
// merge network over it, its rows to `out`.
template <int C>
__global__ void __launch_bounds__(kMergeThreads)
merge_tile(Cols<C> a, long long na, Cols<C> b, long long nb,
           const long long* __restrict__ coranks, MutCols<C> out) {
  constexpr int T = kMergeRows<C>;
  constexpr int S = kMergeSlots<C>;
  __shared__ long long tile_s[C * S];
  const long long d0 = (long long)blockIdx.x * T;
  const long long left = na + nb - d0;
  const int total = left < T ? (int)left : T;
  const long long a0 = coranks[blockIdx.x];
  const long long b0 = d0 - a0;
  const int la = (int)(coranks[blockIdx.x + 1] - a0);
  const int lb = total - la;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    long long* col = tile_s + c * S;
    load_run(a.p[c] + a0, la,
             [&](int j, long long v) { col[phys(j)] = v; });
    load_run(b.p[c] + b0, lb,
             [&](int j, long long v) { col[phys(T - 1 - j)] = v; });
    for (int r = la + threadIdx.x; r < T - lb; r += kMergeThreads)
      col[phys(r)] = kBitonicPad;
  }
  __syncthreads();
  shared_steps<C, kMergeThreads, S>(tile_s, T, kMergeTileLog<C> - 1, 0, 0,
                                    -1);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const long long* col = tile_s + c * S;
    store_run(out.p[c] + d0, total, [&](int j) { return col[phys(j)]; });
  }
}

template <int C>
int bitonic_merge(const void* const* a_in, long long na,
                  const void* const* b_in, long long nb, void* const* out,
                  long long* coranks, cudaStream_t s, int* passes) {
  Cols<C> a, b;
  MutCols<C> dst;
  for (int c = 0; c < C; ++c) {
    a.p[c] = (const long long*)a_in[c];
    b.p[c] = (const long long*)b_in[c];
    dst.p[c] = (long long*)out[c];
  }
  const long long tiles = (na + nb + kMergeRows<C> - 1) / kMergeRows<C>;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long blocks = (tiles + kEdgeThreads) / kEdgeThreads;
  tile_coranks<C><<<(unsigned)blocks, kEdgeThreads, 0, s>>>(a, na, b, nb,
                                                            tiles, coranks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_tile<C><<<(unsigned)tiles, kMergeThreads, 0, s>>>(a, na, b, nb,
                                                          coranks, dst);
  *passes = 1;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cbl

// a, b and out are C-element arrays of column pointers (C = 1 to 3).
// na + nb >= 1.  `coranks` is scratch for one int64 a tile edge:
// ceil((na + nb) / tile) + 1 values.  `*passes` receives the number of
// kernels launched that read and write every row (one).
extern "C" int cbl_bitonic_merge(const void* const* a, long long na,
                                 const void* const* b, long long nb,
                                 void* const* out, int C, void* coranks,
                                 int* passes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (na < 0 || nb < 0 || na + nb < 1) return (int)cudaErrorInvalidValue;
  long long* cr = (long long*)coranks;
  switch (C) {
    case 1:
      return cbl::bitonic_merge<1>(a, na, b, nb, out, cr, s, passes);
    case 2:
      return cbl::bitonic_merge<2>(a, na, b, nb, out, cr, s, passes);
    case 3:
      return cbl::bitonic_merge<3>(a, na, b, nb, out, cr, s, passes);
  }
  return (int)cudaErrorInvalidValue;
}
