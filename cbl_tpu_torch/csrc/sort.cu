// Kernel B5: full sort of int64 key rows, a tile sort and multiway merge
// passes.
//
// Replaces the TPU kernel cbl_tpu/ops/merge_pallas.py `sort_cols_mergepath`
// (`_tilesort_call(alternating=False)`, `_coranks_runs`, `_merge_call`).
// Rows of one to three int64 columns are sorted ascending,
// lexicographically with column 0 major; the result equals a stable library
// sort, since equal rows are identical.
//
// What bounds it on the H100: device memory.  The least traffic is one read
// and one write of every row; this design moves
// 1 + ceil(ceil(log2(n / sort tile)) / 4) times that: one tile sort, then
// one pass per SIXTEEN-fold growth of the run length (4 passes at 2^25
// one-column keys, where four-way passes made 7 and two-way
// passes over tiles of 2048 rows 15).
//   1. The tile sort: each block loads one sort tile (2^13 rows of one
//      column, 2^12 of two or three; a short last tile is padded with
//      INT64_MAX rows, which sort last and are not written back) into shared
//      memory; each thread sorts its own eight rows in registers with a
//      fixed network of 19 exchanges, then the block merges the threads'
//      runs in shared memory, doubling the run each round, by the co-rank
//      rule and the step of the merge passes (merge_path.cuh), and writes
//      the tile back ascending.  At one and two columns whole rows move
//      (`tile_sort`); at three the tile is keyed (`tile_sort_keyed`:
//      column 0 and the rows' places move, columns 1 and 2 stay until the
//      store).  The TPU kernel's [H, 128] vector layout, its roll-based
//      compare-exchange and its bitmask select are not copied; nor is its
//      bitonic network, which kernel B6's tile sort runs over the same tile
//      in 1.04 ms for 2^25 keys where this one takes 0.88 (0.50 against
//      0.25 ms for 2^22 + 2^21 two-column rows; NVIDIA H100 80GB HBM3,
//      700 W).
//   2. With L = ceil(log2(number of sort tiles)) levels of the merge tree
//      to go: multiway passes (multiway.cuh) that each merge every kMaxFan
//      = 16 neighbouring runs, four levels of the merge tree a pass, after
//      one pass of 2, 4 or 8 runs where L is no multiple of four.  Every
//      split is searched inside its own group, ties in run order, as
//      `_coranks_runs` does; a short or missing last run needs no padding.
// The input is only read; the passes ping-pong between `out` and `tmp`,
// starting so that the last pass writes `out`.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W), two- and four-way passes in
// brackets: 2^25 one-column keys 2.8 ms (3.8), 2^26 + 2^21 keys with 75 %
// sentinels 5.7 (6.7), 2^22 + 2^21 two-column rows 0.95 (1.34); at three
// columns 5.6 against 11.75 at 2^25 rows of the K=59 sort-join's
// queries.  At 2^25 one-column keys: the tile sort 0.88 ms, three splits
// 0.44 and three merge passes 1.44 (0.48 a pass where the bytes take
// 0.16).

#include "merge_path.cuh"
#include "multiway.cuh"

namespace cbl {
namespace {

constexpr long long kPadRow = 0x7fffffffffffffffLL;  // sorts last

// The sort tile: a block of kSortRows / kItems threads, eight rows a
// thread.  = ops/merge.py SORT_TILES
template <int C>
constexpr int kSortRows = C == 1 ? 1 << 13 : 1 << 12;
template <int C>
constexpr int kSortThreads = kSortRows<C> / kItems;
// padded as `slot<true>` pads, and one slot more
template <int C>
constexpr int kSortSlots = kSortRows<C> + kSortRows<C> / 8 + 1;
template <int C>
constexpr int kSortSmemBytes = C * kSortSlots<C> * (int)sizeof(long long);
static_assert(kSortSmemBytes<2> <= 232448, "a sort tile exceeds 227 KB");

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

// The sort of `tile_sort` on a keyed tile (multiway.cuh `MultiTile`:
// column 0 and the rows' places move, the other columns stay until the
// store), held to 64 registers a thread, so that two blocks share an SM
// (109 KB of shared memory each at three columns) and one's loads overlap
// the other's merges.  The unkeyed `tile_sort<3>`, 74 registers and one block
// an SM, took 1.96 ms for 2^25 rows, the same at 64 registers 1.67 (NVIDIA
// H100 80GB HBM3, 700 W).
template <int C>
constexpr int kKeyedSortSmem =
    keyed_tile_bytes<C>(kSortRows<C>, kSortSlots<C>);
static_assert(kKeyedSortSmem<3> <= 232448 / 2, "two keyed sort tiles an SM");
// Which tile sort a number of columns takes: keyed at three.  At two the
// keyed tile sort measured even with `tile_sort<2>` (0.94 ms for 2^22 +
// 2^21 rows either way; NVIDIA H100 80GB HBM3, 700 W), which stays.
template <int C>
constexpr bool kKeyedSort = C == 3;
// log2 of the most runs a merge pass merges.  = ops/merge.py SORT_WAYS.
// Eight-run passes measured even at one column (2.76 ms for 2^25 keys in
// five passes, against 2.79 in four) and slower at two (0.975 against
// 0.945 for 2^22 + 2^21 rows; same card).
template <int C>
constexpr int kWaysLog = 4;
static_assert((1 << kWaysLog<1>) <= kMaxFan && (1 << kWaysLog<2>) <= kMaxFan,
              "a pass merges at most kMaxFan runs");

// `multi_corank` on the sort's tile (its own slot count).
template <int C>
__device__ __forceinline__ int sort_corank(const MultiTile<C>& t, int a0,
                                           int la, int b0, int lb, int d) {
  int lo = d - lb > 0 ? d - lb : 0;
  int hi = d < la ? d : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int si = slot<true>(a0 + mid), sj = slot<true>(b0 + d - mid - 1);
    if (multi_le<C>(t, t.key[si], t.idx[si], t.key[sj], t.idx[sj]))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <int C>
__global__ void __launch_bounds__(kSortThreads<C>, 2)
tile_sort_keyed(Cols<C> in, long long n, MutCols<C> out) {
  static_assert(C > 1, "one column has nothing to key");
  constexpr int T = kSortRows<C>;
  const MultiTile<C> t = multi_tile<C, T, kSortSlots<C>>();
  const long long base = (long long)blockIdx.x * T;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int r = threadIdx.x + k * kSortThreads<C>;
    const bool here = base + r < n;
    t.key[slot<true>(r)] = here ? in.p[0][base + r] : kPadRow;
#pragma unroll
    for (int c = 1; c < C; ++c)
      t.rest[c - 1][r] = here ? in.p[c][base + r] : kPadRow;
    t.idx[slot<true>(r)] = (unsigned short)r;
  }
  __syncthreads();
  // this thread's rows [di, di + kItems), by Batcher's network for eight
  const int di = threadIdx.x * kItems;
  long long vk[kItems];
  int vi[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    vk[k] = t.key[slot<true>(di + k)];
    vi[k] = t.idx[slot<true>(di + k)];
  }
  constexpr int kNet[19][2] = {
      {0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2}, {1, 3}, {4, 6}, {5, 7}, {1, 2},
      {5, 6}, {0, 4}, {1, 5}, {2, 6}, {3, 7}, {2, 4}, {3, 5}, {1, 2}, {3, 4},
      {5, 6}};
#pragma unroll
  for (int e = 0; e < 19; ++e) {
    const int a = kNet[e][0], b = kNet[e][1];
    const bool swap = !multi_le<C>(t, vk[a], vi[a], vk[b], vi[b]);
    const long long k = swap ? vk[b] : vk[a];
    vk[b] = swap ? vk[a] : vk[b];
    vk[a] = k;
    const int i = swap ? vi[b] : vi[a];
    vi[b] = swap ? vi[a] : vi[b];
    vi[a] = i;
  }
  for (int run = kItems;; run <<= 1) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      t.key[slot<true>(di + k)] = vk[k];
      t.idx[slot<true>(di + k)] = (unsigned short)vi[k];
    }
    __syncthreads();
    if (run == T) break;
    // merge the runs [first, first + run) and [first + run, first + 2 run)
    const int first = di & ~(2 * run - 1);
    int pa = first, pb = first + run;
    const int ea = pb, eb = pb + run;
    const int ia = sort_corank<C>(t, pa, run, pb, run, di - first);
    pb += di - first - ia;
    pa += ia;
    long long ka = t.key[slot<true>(pa)], kb = t.key[slot<true>(pb)];
    int xa = t.idx[slot<true>(pa)], xb = t.idx[slot<true>(pb)];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool take_a =
          pb >= eb || (pa < ea && multi_le<C>(t, ka, xa, kb, xb));
      vk[k] = take_a ? ka : kb;
      vi[k] = take_a ? xa : xb;
      const int nx = slot<true>(take_a ? ++pa : ++pb);
      const long long kn = t.key[nx];
      const int in_ = t.idx[nx];
      ka = take_a ? kn : ka;
      xa = take_a ? in_ : xa;
      kb = take_a ? kb : kn;
      xb = take_a ? xb : in_;
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int r = threadIdx.x + k * kSortThreads<C>;
    if (base + r < n) {
      const int i = t.idx[slot<true>(r)];
      out.p[0][base + r] = t.key[slot<true>(r)];
#pragma unroll
      for (int c = 1; c < C; ++c) out.p[c][base + r] = t.rest[c - 1][i];
    }
  }
}

// The tile sort of every sort tile of `in` into `out`.
template <int C>
cudaError_t launch_tile_sort(const Cols<C>& in, long long n,
                             const MutCols<C>& out, long long sort_tiles,
                             cudaStream_t s) {
  if constexpr (kKeyedSort<C>) {
    cudaError_t err = cudaFuncSetAttribute(
        tile_sort_keyed<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kKeyedSortSmem<C>);
    if (err != cudaSuccess) return err;
    tile_sort_keyed<C><<<(unsigned)sort_tiles, kSortThreads<C>,
                         kKeyedSortSmem<C>, s>>>(in, n, out);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        tile_sort<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSortSmemBytes<C>);
    if (err != cudaSuccess) return err;
    tile_sort<C><<<(unsigned)sort_tiles, kSortThreads<C>, kSortSmemBytes<C>,
                   s>>>(in, n, out);
  }
  return cudaGetLastError();
}

// The tile sort, then `multiway_pass`es.  = ops/merge.py
// `mergepath_passes(n, SORT_TILES[C], SORT_WAYS[C])`
template <int C>
int sort_keys(const void* const* in, void* const* out, void* const* tmp,
              long long n, void* scratch, cudaStream_t s, int* passes) {
  constexpr long long kSortTile = kSortRows<C>;
  constexpr long long T = kMultiRows<C>;
  static_assert(kSortTile % T == 0, "runs are whole output tiles");
  const long long n_tiles = (n + T - 1) / T;
  const long long sort_tiles = (n + kSortTile - 1) / kSortTile;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int W = kWaysLog<C>;
  int levels = 0;
  while ((kSortTile << levels) < n) ++levels;
  const int merges = (levels + W - 1) / W;
  Cols<C> src;
  MutCols<C> cur, other;
  for (int c = 0; c < C; ++c) {
    src.p[c] = (const long long*)in[c];
    cur.p[c] = (long long*)(merges % 2 == 0 ? out[c] : tmp[c]);
    other.p[c] = (long long*)(merges % 2 == 0 ? tmp[c] : out[c]);
  }
  cudaError_t err = launch_tile_sort<C>(src, n, cur, sort_tiles, s);
  if (err != cudaSuccess) return (int)err;
  *passes = 1;
  long long run = kSortTile;
  int left = levels;
  while (left > 0) {
    // the pass of fewer runs first, then 2^W runs a pass
    const int step = left % W ? left % W : W;
    Cols<C> a;
    for (int c = 0; c < C; ++c) a.p[c] = cur.p[c];
    err = multiway_pass<C>(a, run, 1 << step, n, n_tiles,
                           (long long*)scratch, other, s);
    if (err != cudaSuccess) return (int)err;
    ++*passes;
    run <<= step;
    left -= step;
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
// nulls, when n fits one sort tile), `scratch` holds sixteen int64 per 2048
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
