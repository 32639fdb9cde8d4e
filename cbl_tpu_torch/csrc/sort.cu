// Kernel B5: full sort of int64 key rows, a tile sort and merge-path passes.
//
// Replaces the TPU kernel cbl_tpu/ops/merge_pallas.py `sort_cols_mergepath`
// (`_tilesort_call(alternating=False)`, `_coranks_runs`, `_merge_call`).
// Rows of one or two int64 columns are sorted ascending, lexicographically
// with column 0 major; the result equals a stable library sort, since equal
// rows are identical.
//
// What bounds it on the H100: device memory.  The least traffic is one read
// and one write of every row; this design moves 1 + ceil(log2(n / kTile))
// times that (one tile sort, then one pass per doubling of the run
// length), so it is a simple, exact sort and not yet a fast one.
//   1. `tile_sort`: each block loads kTile rows into shared memory (a
//      short last tile is padded with INT64_MAX rows, which sort last and
//      are not written back), sorts them with a bitonic network and
//      writes the tile back ascending.  The TPU kernel's [H, 128] vector
//      layout, its roll-based compare-exchange and its bitmask select are
//      not copied: one thread owns one compare-exchange of a stage.
//   2. For run = kTile, 2 kTile, ... while run < n: one merge-path pass
//      (merge_path.cuh, shared with kernel B3) merges every pair of
//      neighbouring runs from one buffer into the other.  The co-rank of
//      every output tile is searched inside its own pair, with A before B
//      on ties, as `_coranks_runs` does; a short or missing last run needs
//      no padding.
// The input is only read; the passes ping-pong between `out` and `tmp`,
// starting so that the last pass writes `out`.

#include "merge_path.cuh"

namespace {

using cbl::kThreads;
using cbl::kTile;

constexpr long long kPad = 0x7fffffffffffffffLL;

// s[i] > s[j], lexicographic over the C columns of the shared tile.
template <int C>
__device__ __forceinline__ bool gt(long long (*s)[kTile], int i, int j) {
#pragma unroll
  for (int c = 0; c < C - 1; ++c) {
    const long long x = s[c][i], y = s[c][j];
    if (x != y) return x > y;
  }
  return s[C - 1][i] > s[C - 1][j];
}

template <int C>
__global__ void tile_sort(cbl::Cols<C> in, cbl::MutCols<C> out, long long n) {
  __shared__ long long s[C][kTile];
  const long long base = (long long)blockIdx.x * kTile;
  const int cnt = (int)(n - base < kTile ? n - base : kTile);
#pragma unroll
  for (int c = 0; c < C; ++c)
    for (int j = threadIdx.x; j < kTile; j += kThreads)
      s[c][j] = j < cnt ? in.p[c][base + j] : kPad;
  __syncthreads();
  for (int k = 2; k <= kTile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < kTile / 2; t += kThreads) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = lo | j;
        const bool ascending = (lo & k) == 0;
        // the pair is out of order when its larger row sits on the side
        // that should hold the smaller one
        const bool swap = ascending ? gt<C>(s, lo, hi) : gt<C>(s, hi, lo);
        if (swap) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const long long x = s[c][lo];
            s[c][lo] = s[c][hi];
            s[c][hi] = x;
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    for (int j = threadIdx.x; j < cnt; j += kThreads)
      out.p[c][base + j] = s[c][j];
}

template <int C>
int sort_keys(const void* const* in, void* const* out, void* const* tmp,
              long long n, void* coranks, cudaStream_t s) {
  const long long n_tiles = (n + kTile - 1) / kTile;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int passes = 0;
  for (long long run = kTile; run < n; run *= 2) ++passes;
  cbl::Cols<C> src;
  cbl::MutCols<C> cur, other;
  for (int c = 0; c < C; ++c) {
    src.p[c] = (const long long*)in[c];
    cur.p[c] = (long long*)(passes % 2 == 0 ? out[c] : tmp[c]);
    other.p[c] = (long long*)(passes % 2 == 0 ? tmp[c] : out[c]);
  }
  tile_sort<C><<<(unsigned)n_tiles, kThreads, 0, s>>>(src, cur, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (long long run = kTile; run < n; run *= 2) {
    cbl::Cols<C> a, b;
    for (int c = 0; c < C; ++c) {
      a.p[c] = cur.p[c];
      b.p[c] = cur.p[c] + run;
    }
    const cbl::Pairs ps{run, n, 0, 0};
    err = cbl::merge_pass<C>(a, b, ps, n_tiles, (long long*)coranks, other, s);
    if (err != cudaSuccess) return (int)err;
    const cbl::MutCols<C> done = other;
    other = cur;
    cur = done;
  }
  return (int)cudaSuccess;
}

}  // namespace

// in0/out0/tmp0 are column 0; in1/out1/tmp1 column 1, or all three null
// for one-column rows.  n >= 1.  `tmp` is scratch of the input's size
// (unused when n <= 2048), `coranks` scratch for one int64 per 2048 rows.
extern "C" int cbl_sort_keys(const void* in0, const void* in1, void* out0,
                             void* out1, void* tmp0, void* tmp1, long long n,
                             void* coranks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* in[2] = {in0, in1};
  void* out[2] = {out0, out1};
  void* tmp[2] = {tmp0, tmp1};
  if (out1 == nullptr) return sort_keys<1>(in, out, tmp, n, coranks, s);
  return sort_keys<2>(in, out, tmp, n, coranks, s);
}
