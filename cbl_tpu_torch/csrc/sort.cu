// Kernel B5: full sort of int64 key rows, a tile sort and merge-path passes.
//
// Replaces the TPU kernel cbl_tpu/ops/merge_pallas.py `sort_cols_mergepath`
// (`_tilesort_call(alternating=False)`, `_coranks_runs`, `_merge_call`).
// Rows of one to three int64 columns are sorted ascending,
// lexicographically with column 0 major; the result equals a stable library
// sort, since equal rows are identical.
//
// What bounds it on the H100: device memory.  The least traffic is one read
// and one write of every row; this design moves
// 1 + ceil(ceil(log2(n / sort tile)) / 2) times that: one tile sort, then
// one pass per FOUR-fold growth of the run length (7 passes at 2^25
// one-column keys, where a pass per doubling over tiles of 2048 rows made
// 15).
//   1. `tile_sort`: each block loads one sort tile (2^13 rows of one
//      column, 2^12 of two or three; a short last tile is padded with INT64_MAX
//      rows, which sort last and are not written back) into shared memory;
//      each thread sorts its own eight rows in registers with a fixed
//      network of 19 exchanges, then the block merges the threads' runs in
//      shared memory, doubling the run each round, by the same co-rank
//      rule and the same step as the merge passes (merge_path.cuh), and
//      writes the tile back ascending.  The TPU kernel's [H, 128] vector
//      layout, its roll-based compare-exchange and its bitmask select are
//      not copied; nor is its bitonic network, which kernel B6's tile sort
//      runs over the same tile in 1.04 ms for 2^25 keys where this one
//      takes 0.88 (0.50 against 0.25 ms for 2^22 + 2^21 two-column rows;
//      NVIDIA H100 80GB HBM3, 700 W).
//   2. With L = ceil(log2(number of sort tiles)) levels of the merge tree
//      to go: if L is odd, one two-way merge-path pass (merge_path.cuh,
//      shared with kernel B3) merges every pair of neighbouring runs; then
//      L / 2 four-way passes (`quad_pass`) each merge every four
//      neighbouring runs, two levels a pass.  Every co-rank is searched
//      inside its own pair or quad, ties in run order, as `_coranks_runs`
//      does; a short or missing last run needs no padding.
// The input is only read; the passes ping-pong between `out` and `tmp`,
// starting so that the last pass writes `out`.

#include "merge_path.cuh"

namespace cbl {
namespace {

constexpr long long kPadRow = 0x7fffffffffffffffLL;  // sorts last

// The sort tile: a block of kSortRows / kItems threads, eight rows a
// thread.  = ops/merge.py SORT_TILES
template <int C>
constexpr int kSortRows = C == 1 ? 1 << 13 : 1 << 12;
template <int C>
constexpr int kSortThreads = kSortRows<C> / kItems;
// padded as `merge_quads` pads its tile, and one slot more
template <int C>
constexpr int kSortSlots = kSortRows<C> + kSortRows<C> / 8 + 1;
template <int C>
constexpr int kSortSmemBytes = C * kSortSlots<C> * (int)sizeof(long long);
// three columns: 110.6 KB, of the 227 KB a block may ask for
static_assert(kSortSmemBytes<3> <= 232448, "a sort tile exceeds 227 KB");

// Order two rows held in registers.
template <int C>
__device__ __forceinline__ void exchange(long long (&x)[C],
                                         long long (&y)[C]) {
  const bool swap = !le_rows<C>(x, y);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const long long lo = swap ? y[c] : x[c];
    y[c] = swap ? x[c] : y[c];
    x[c] = lo;
  }
}

template <int C>
__global__ void __launch_bounds__(kSortThreads<C>)
tile_sort(Cols<C> in, long long n, MutCols<C> out) {
  extern __shared__ long long sort_smem[];
  constexpr int T = kSortRows<C>;
  long long(*tile_s)[kSortSlots<C>] =
      reinterpret_cast<long long(*)[kSortSlots<C>]>(sort_smem);
  const long long base = (long long)blockIdx.x * T;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int r = threadIdx.x + k * kSortThreads<C>;
      tile_s[c][slot<true>(r)] = base + r < n ? in.p[c][base + r] : kPadRow;
    }
  __syncthreads();
  // this thread's rows [di, di + kItems), by Batcher's network for eight
  static_assert(kItems == 8, "the network below sorts eight rows");
  const int di = threadIdx.x * kItems;
  long long v[kItems][C];
#pragma unroll
  for (int k = 0; k < kItems; ++k) load_row<C, true>(tile_s, di + k, v[k]);
  constexpr int kNet[19][2] = {
      {0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2}, {1, 3}, {4, 6}, {5, 7}, {1, 2},
      {5, 6}, {0, 4}, {1, 5}, {2, 6}, {3, 7}, {2, 4}, {3, 5}, {1, 2}, {3, 4},
      {5, 6}};
#pragma unroll
  for (int e = 0; e < 19; ++e) exchange<C>(v[kNet[e][0]], v[kNet[e][1]]);
  // (no barrier before the store: a thread reads and writes its own rows)
  for (int run = kItems;; run <<= 1) {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
#pragma unroll
      for (int c = 0; c < C; ++c) tile_s[c][slot<true>(di + k)] = v[k][c];
    __syncthreads();
    if (run == T) break;
    // merge the runs [first, first + run) and [first + run, first + 2 run)
    const int first = di & ~(2 * run - 1);
    int pa = first, pb = first + run;
    const int ea = pb, eb = pb + run;
    const int ia = corank_shared<C, true>(tile_s, pa, run, pb, run,
                                          di - first);
    pb += di - first - ia;
    pa += ia;
    long long xa[C], xb[C];
    load_row<C, true>(tile_s, pa, xa);
    load_row<C, true>(tile_s, pb, xb);
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      merge_step<C, true>(tile_s, pa, ea, pb, eb, xa, xb, v[k]);
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int r = threadIdx.x + k * kSortThreads<C>;
      if (base + r < n) out.p[c][base + r] = tile_s[c][slot<true>(r)];
    }
}

template <int C>
int sort_keys(const void* const* in, void* const* out, void* const* tmp,
              long long n, void* scratch, cudaStream_t s, int* passes) {
  constexpr long long kSortTile = kSortRows<C>;
  static_assert(kSortTile % kTile == 0, "runs are whole merge tiles");
  const long long n_tiles = (n + kTile - 1) / kTile;
  const long long sort_tiles = (n + kSortTile - 1) / kSortTile;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int levels = 0;
  while ((kSortTile << levels) < n) ++levels;
  const int merges = (levels + 1) / 2;
  Cols<C> src;
  MutCols<C> cur, other;
  for (int c = 0; c < C; ++c) {
    src.p[c] = (const long long*)in[c];
    cur.p[c] = (long long*)(merges % 2 == 0 ? out[c] : tmp[c]);
    other.p[c] = (long long*)(merges % 2 == 0 ? tmp[c] : out[c]);
  }
  cudaError_t err = cudaFuncSetAttribute(
      tile_sort<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSortSmemBytes<C>);
  if (err != cudaSuccess) return (int)err;
  tile_sort<C><<<(unsigned)sort_tiles, kSortThreads<C>, kSortSmemBytes<C>,
                 s>>>(src, n, cur);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *passes = 1;
  long long run = kSortTile;
  while (run < n) {
    Cols<C> a;
    for (int c = 0; c < C; ++c) a.p[c] = cur.p[c];
    if (levels % 2 == 1 && run == kSortTile) {
      const Pairs ps{run, n, 0, 0};
      err = merge_pass<C>(a, offset<C>(a, run), ps, n_tiles,
                          (long long*)scratch, other, s);
      run *= 2;
    } else {
      err = quad_pass<C>(a, run, n, n_tiles, (long long*)scratch, other, s);
      run *= 4;
    }
    if (err != cudaSuccess) return (int)err;
    ++*passes;
    const MutCols<C> done = other;
    other = cur;
    cur = done;
  }
  return (int)cudaSuccess;
}

}  // namespace
}  // namespace cbl

// in, out and tmp are C-element arrays of column pointers (C = 1 to 3).
// n >= 1.  `tmp` is scratch of the input's size (unused, and may hold
// nulls, when n fits one sort tile), `scratch` holds four int64 per 2048
// rows.  `*passes` receives the number of kernels launched that read and
// write every row (the partition kernels do not).
extern "C" int cbl_sort_keys(const void* const* in, void* const* out,
                             void* const* tmp, int C, long long n,
                             void* scratch, int* passes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1:
      return cbl::sort_keys<1>(in, out, tmp, n, scratch, s, passes);
    case 2:
      return cbl::sort_keys<2>(in, out, tmp, n, scratch, s, passes);
    case 3:
      return cbl::sort_keys<3>(in, out, tmp, n, scratch, s, passes);
  }
  return (int)cudaErrorInvalidValue;
}
