// Merge path over rows of one or two int64 key columns, shared by kernel
// B3 (csrc/merge.cu, one pair of sorted runs) and kernel B5 (csrc/sort.cu,
// every pair of sorted runs of one buffer, once per pass).
//
// Rows compare lexicographically, column 0 major.  A "pair" is two sorted
// runs A (la rows) and B (lb rows) and their merged output of la + lb
// rows; output tile t of a pair holds its outputs [t * kTile, (t + 1) *
// kTile).  The co-rank of diagonal d is how many of the pair's first d
// outputs come from A, with A before B on ties:
// pred(i) = A[i] <= B[d - i - 1] (the rule of cbl_tpu's
// merge_pallas._coranks and _coranks_runs).
//   1. `partition` binary-searches the co-rank of every tile's first
//      diagonal in device memory.
//   2. `merge_tiles`: each block loads its A and B segments (kTile rows
//      together) into shared memory with coalesced loads; each thread
//      finds the co-rank of its own kItems outputs in shared memory with
//      the same rule and merges them in order into registers; the block
//      then writes the tile back through shared memory with coalesced
//      stores.  A tile's A segment ends at the next tile's co-rank, or at
//      la when the tile holds the pair's last output.
// Empty or short runs, runs of equal rows across tile, thread or run
// boundaries and INT64_MAX sentinel rows need no special case: the co-rank
// rule alone decides where every row goes, and both searches use the same
// `le`.

#pragma once

#include <cuda_runtime.h>

// The anonymous namespace gives every source that includes this header its
// own copy of the kernels (the sources are compiled one by one, without
// relocatable device code).
namespace cbl {
namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048, = ops/merge.py MERGE_TILE

// C column base pointers (device or shared memory).
template <int C>
struct Cols {
  const long long* p[C];
};

template <int C>
struct MutCols {
  long long* p[C];
};

template <int C>
__device__ __forceinline__ Cols<C> offset(const Cols<C>& x, long long by) {
  Cols<C> r;
#pragma unroll
  for (int c = 0; c < C; ++c) r.p[c] = x.p[c] + by;
  return r;
}

// a[i] <= b[j], lexicographic over the C columns.
template <int C>
__device__ __forceinline__ bool le(const Cols<C>& a, long long i,
                                   const Cols<C>& b, long long j) {
#pragma unroll
  for (int c = 0; c < C - 1; ++c) {
    const long long x = a.p[c][i], y = b.p[c][j];
    if (x != y) return x < y;
  }
  return a.p[C - 1][i] <= b.p[C - 1][j];
}

// Smallest i in [max(0, d - nb), min(d, na)] with a[i] > b[d - i - 1]
// (or the upper end when there is none).
template <int C>
__device__ __forceinline__ long long corank(const Cols<C>& a, long long na,
                                            const Cols<C>& b, long long nb,
                                            long long d) {
  long long lo = d - nb > 0 ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (le<C>(a, mid, b, d - mid - 1))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Where the pairs of a launch lie.  run == 0: ONE pair, A = a[0, na) and
// B = b[0, nb) (kernel B3).  run > 0: the rows [0, n) of one buffer hold
// sorted runs of `run` rows (a multiple of kTile; the last run may be
// short or missing); pair p is A = [2 p run, +run), B = [(2 p + 1) run,
// +run), both cut at n, and the caller passes b = a + run (kernel B5).
struct Pairs {
  long long run;
  long long n;   // run > 0: rows of the buffer
  long long na;  // run == 0
  long long nb;  // run == 0
};

// Output tile g of the launch -> its pair's first row `base` (of a, of b
// and of the output), the pair's run lengths and the tile's first
// diagonal d0 inside the pair.
__device__ __forceinline__ void tile_pair(const Pairs& ps, long long g,
                                          long long* base, long long* la,
                                          long long* lb, long long* d0) {
  if (ps.run == 0) {
    *base = 0;
    *la = ps.na;
    *lb = ps.nb;
    *d0 = g * kTile;
    return;
  }
  const long long tiles_per_pair = 2 * ps.run / kTile;
  const long long pair = g / tiles_per_pair;
  *base = pair * 2 * ps.run;
  const long long left = ps.n - *base;
  *la = left < ps.run ? left : ps.run;
  const long long rest = left - *la;
  *lb = rest < ps.run ? rest : ps.run;
  *d0 = (g - pair * tiles_per_pair) * kTile;
}

template <int C>
__global__ void partition(Cols<C> a, Cols<C> b, Pairs ps,
                          long long* __restrict__ coranks, long long n_tiles) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_tiles) return;
  long long base, la, lb, d0;
  tile_pair(ps, g, &base, &la, &lb, &d0);
  coranks[g] = corank<C>(offset<C>(a, base), la, offset<C>(b, base), lb, d0);
}

// f(j) for every row j < total of a tile, strided over the block's
// threads.  One column: the kItems steps are unrolled, so a thread's loads
// are all in flight at once (0.58 -> 0.51 ms for 2^25 + 2^25 keys on an
// NVIDIA H100 80GB HBM3, 700 W).  Two columns ran slower that way (59
// registers; 1.50 against 1.06 ms for the 12 passes over 6.3M rows on the
// same card) and keep the plain loop.
template <int C, class F>
__device__ __forceinline__ void for_tile_rows(int total, F f) {
  if constexpr (C == 1) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = threadIdx.x + k * kThreads;
      if (j < total) f(j);
    }
  } else {
    for (int j = threadIdx.x; j < total; j += kThreads) f(j);
  }
}

template <int C>
__global__ void merge_tiles(Cols<C> a, Cols<C> b, Pairs ps,
                            const long long* __restrict__ coranks,
                            MutCols<C> out) {
  __shared__ long long tile_s[C][kTile];
  long long base, na, nb, d0;
  tile_pair(ps, blockIdx.x, &base, &na, &nb, &d0);
  const long long d1 = d0 + kTile < na + nb ? d0 + kTile : na + nb;
  const long long a0 = coranks[blockIdx.x];
  const long long a1 = d1 == na + nb ? na : coranks[blockIdx.x + 1];
  const long long b0 = d0 - a0;
  const int la = (int)(a1 - a0);
  const int total = (int)(d1 - d0);
  const int lb = total - la;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const long long* ga = a.p[c] + base + a0;
    const long long* gb = b.p[c] + base + b0;
    for_tile_rows<C>(total, [&](int j) {
      tile_s[c][j] = j < la ? ga[j] : gb[j - la];
    });
  }
  __syncthreads();
  Cols<C> sa, sb;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    sa.p[c] = tile_s[c];
    sb.p[c] = tile_s[c] + la;
  }
  const int di = min((int)threadIdx.x * kItems, total);
  int ia = (int)corank<C>(sa, la, sb, lb, di);
  int ib = di - ia;
  long long merged[kItems][C];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (di + k < total) {
      const bool take_a = ib >= lb || (ia < la && le<C>(sa, ia, sb, ib));
#pragma unroll
      for (int c = 0; c < C; ++c)
        merged[k][c] = take_a ? sa.p[c][ia] : sb.p[c][ib];
      if (take_a)
        ++ia;
      else
        ++ib;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (di + k < total) {
#pragma unroll
      for (int c = 0; c < C; ++c) tile_s[c][di + k] = merged[k][c];
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    long long* go = out.p[c] + base + d0;
    for_tile_rows<C>(total, [&](int j) { go[j] = tile_s[c][j]; });
  }
}

// Launch `partition` and `merge_tiles` over n_tiles output tiles.
// `coranks` holds n_tiles values.
template <int C>
cudaError_t merge_pass(const Cols<C>& a, const Cols<C>& b, const Pairs& ps,
                       long long n_tiles, long long* coranks,
                       const MutCols<C>& out, cudaStream_t s) {
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long pblocks = (n_tiles + kThreads - 1) / kThreads;
  partition<C><<<(unsigned)pblocks, kThreads, 0, s>>>(a, b, ps, coranks,
                                                      n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_tiles<C><<<(unsigned)n_tiles, kThreads, 0, s>>>(a, b, ps, coranks,
                                                        out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cbl
