// Merge path over rows of one to three int64 key columns, shared by kernel
// B3 (csrc/merge.cu, one pair of sorted runs) and kernel B5 (csrc/sort.cu:
// its tile sort, and through csrc/multiway.cuh the steps of its merge
// passes).
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
//      stores (`merge_shared`).  A tile's A segment ends at the next tile's
//      co-rank, or at la when the tile holds the pair's last output.
// Empty or short runs, runs of equal rows across tile, thread or run
// boundaries and INT64_MAX sentinel rows need no special case: the co-rank
// rule alone decides where every row goes, and every search uses the same
// `le`.
//
// What bounds it on the H100: device memory, one read and one write of
// every row; `merge_tiles` reaches about 70 % of that rate (NVIDIA H100
// 80GB HBM3, 700 W).

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
__host__ __device__ __forceinline__ Cols<C> offset(const Cols<C>& x,
                                                   long long by) {
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

// The shared tile of the merge kernels: row i of column c at
// tile_s[c][slot<kPad>(i)], and one slot more, which a run that ends with
// the tile reads and never uses.  With kPad there is one unused slot after
// every eight rows: a thread writes its kItems = 8 merged rows side by side
// and threads walk their runs a few rows apart, which unpadded piles
// several threads of a half-warp onto one bank pair.  Merges of several
// levels a tile (a four-way pass, multiway.cuh's `merge_multi`) are
// bound by shared-memory wavefronts and run faster padded (1.3x for the
// four-way pass); `merge_tiles` ran 1.13x slower padded (0.523 against
// 0.464 ms for 2^25 + 2^25 keys on an NVIDIA H100 80GB HBM3, 700 W) and
// stays unpadded.
template <bool kPad>
constexpr int kTileSlots = kTile + (kPad ? kTile / 8 : 0) + 1;

template <bool kPad>
__device__ __forceinline__ int slot(int i) {
  return kPad ? i + (i >> 3) : i;
}

// The shared tile of C columns is dynamic shared memory: three columns (49
// KB unpadded, 55 KB padded) exceed the 48 KB a kernel gets without asking,
// so `merge_pass` asks for it with `cudaFuncSetAttribute`.
template <int C, bool kPad>
constexpr int kTileBytes = C * kTileSlots<kPad> * (int)sizeof(long long);
static_assert(kTileBytes<3, true> <= 232448, "a merge tile exceeds 227 KB");

// The tile of a merge kernel over the block's dynamic shared memory.
template <bool kPad>
__device__ __forceinline__ auto shared_tile()
    -> long long (*)[kTileSlots<kPad>] {
  extern __shared__ long long merge_tile_s[];
  return reinterpret_cast<long long(*)[kTileSlots<kPad>]>(merge_tile_s);
}

// x <= y, lexicographic over the C columns (rows held in registers).
template <int C>
__device__ __forceinline__ bool le_rows(const long long (&x)[C],
                                        const long long (&y)[C]) {
#pragma unroll
  for (int c = 0; c < C - 1; ++c) {
    if (x[c] != y[c]) return x[c] < y[c];
  }
  return x[C - 1] <= y[C - 1];
}

// Row i of a shared tile of S slots a column.
template <int C, bool kPad, int S>
__device__ __forceinline__ void load_row(const long long (*tile_s)[S], int i,
                                         long long (&row)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) row[c] = tile_s[c][slot<kPad>(i)];
}

// `corank` over two runs of the shared tile: A = rows [a0, a0 + la),
// B = rows [b0, b0 + lb).
template <int C, bool kPad, int S>
__device__ __forceinline__ int corank_shared(const long long (*tile_s)[S],
                                             int a0, int la, int b0, int lb,
                                             int d) {
  int lo = d - lb > 0 ? d - lb : 0;
  int hi = d < la ? d : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    long long x[C], y[C];
    load_row<C, kPad>(tile_s, a0 + mid, x);
    load_row<C, kPad>(tile_s, b0 + d - mid - 1, y);
    if (le_rows<C>(x, y))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The next output of the merge of A = rows [pa, ea) and B = rows [pb, eb) of
// a shared tile, whose heads xa = row pa and xb = row pb are held in
// registers: A's head on ties; the run that gave it advances and reloads its
// head (one shared load an output; a head beyond its run's end is never
// taken).
template <int C, bool kPad, int S>
__device__ __forceinline__ void merge_step(const long long (*tile_s)[S],
                                           int& pa, int ea, int& pb, int eb,
                                           long long (&xa)[C],
                                           long long (&xb)[C],
                                           long long (&out)[C]) {
  const bool take_a = pb >= eb || (pa < ea && le_rows<C>(xa, xb));
  long long next[C];
  load_row<C, kPad>(tile_s, take_a ? ++pa : ++pb, next);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    out[c] = take_a ? xa[c] : xb[c];
    xa[c] = take_a ? next[c] : xa[c];
    xb[c] = take_a ? xb[c] : next[c];
  }
}

// Merge the sorted rows [0, b1) with [b1, b2) of the shared tile and, with
// kDual, [b2, b3) with [b3, total) (else b2 == total), each pair into its own
// place.  Thread t produces the outputs [t * kItems, (t + 1) * kItems): it
// finds their co-rank inside their pair and merges them in order into
// registers, the two runs' heads held in registers (one shared load an
// output); one that starts in the first pair crosses into the second at
// output b2, where the second pair's co-rank is (0, 0).  Ends on a barrier.
template <int C, bool kDual, bool kPad>
__device__ __forceinline__ void merge_shared(
    long long (*tile_s)[kTileSlots<kPad>], int b1, int b2, int b3,
    int total) {
  const int di = min((int)threadIdx.x * kItems, total);
  // the pair of output di: A = [pa, ea), B = [pb, eb)
  bool second = kDual && di >= b2;
  int pa = second ? b2 : 0, ea = second ? b3 : b1;
  int pb = ea, eb = second ? total : b2;
  {
    const int ia = corank_shared<C, kPad>(tile_s, pa, ea - pa, pb, eb - pb,
                                          di - pa);
    pb += di - pa - ia;
    pa += ia;
  }
  long long xa[C], xb[C];
  load_row<C, kPad>(tile_s, pa, xa);
  load_row<C, kPad>(tile_s, pb, xb);
  long long merged[kItems][C];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (di + k < total) {
      if (kDual && !second && di + k == b2) {
        second = true;
        pa = b2;
        ea = pb = b3;
        eb = total;
        load_row<C, kPad>(tile_s, pa, xa);
        load_row<C, kPad>(tile_s, pb, xb);
      }
      merge_step<C, kPad>(tile_s, pa, ea, pb, eb, xa, xb, merged[k]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (di + k < total) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        tile_s[c][slot<kPad>(di + k)] = merged[k][c];
    }
  }
  __syncthreads();
}

template <int C>
__global__ void merge_tiles(Cols<C> a, Cols<C> b, Pairs ps,
                            const long long* __restrict__ coranks,
                            MutCols<C> out) {
  long long(*tile_s)[kTileSlots<false>] = shared_tile<false>();
  long long base, na, nb, d0;
  tile_pair(ps, blockIdx.x, &base, &na, &nb, &d0);
  const long long d1 = d0 + kTile < na + nb ? d0 + kTile : na + nb;
  const long long a0 = coranks[blockIdx.x];
  const long long a1 = d1 == na + nb ? na : coranks[blockIdx.x + 1];
  const long long b0 = d0 - a0;
  const int la = (int)(a1 - a0);
  const int total = (int)(d1 - d0);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const long long* ga = a.p[c] + base + a0;
    const long long* gb = b.p[c] + base + b0;
    for_tile_rows<C>(total, [&](int j) {
      tile_s[c][j] = j < la ? ga[j] : gb[j - la];
    });
  }
  __syncthreads();
  merge_shared<C, false, false>(tile_s, la, total, total, total);
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
  constexpr int smem = kTileBytes<C, false>;
  err = cudaFuncSetAttribute(merge_tiles<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  merge_tiles<C><<<(unsigned)n_tiles, kThreads, smem, s>>>(a, b, ps, coranks,
                                                           out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cbl
