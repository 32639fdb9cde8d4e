// Merge path over rows of one or two int64 key columns, shared by kernel
// B3 (csrc/merge.cu, one pair of sorted runs) and kernel B5 (csrc/sort.cu,
// every pair, or every four, of the sorted runs of one buffer, once per
// pass).
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
// A "quad" is four neighbouring runs A, B, C, D of one buffer and their
// merged output: the merge of AB = merge(A, B) with CD = merge(C, D), so one
// pass over device memory does two levels of the merge tree (kernel B5).
// Ties go A before B before C before D, by the same `le` everywhere.
//   3. `partition_quads` finds, for every output tile's first diagonal d,
//      how many of the quad's first d outputs come from AB (the co-rank of d
//      in (AB, CD), where AB[i] is itself found by a co-rank in (A, B)), and
//      from there how many come from A and from C.  AB and CD are never
//      written: `partition` first gives the co-ranks of their own tile
//      diagonals, which make AB[t * kTile] and CD[t * kTile - 1] two loads
//      (the coarse search runs on these alone) and confine every nested
//      search to one tile's window.  Four or eight lanes a tile search
//      together, a probe each a round, since each probe is a chain of
//      dependent loads.
//   4. `merge_quads`: each block loads its four segments (together kTile
//      rows) into shared memory, merges A with B and C with D there, then
//      the two results, and stores the tile coalesced.  A tile's segment
//      ends are the next tile's starts, so neighbouring tiles cannot
//      disagree, whatever the duplicates.
// Empty or short runs, runs of equal rows across tile, thread or run
// boundaries and INT64_MAX sentinel rows need no special case: the co-rank
// rule alone decides where every row goes, and every search uses the same
// `le`.
//
// What bounds it on the H100: a two-way pass, device memory (one read and
// one write of every row; `merge_tiles` reaches about 70 % of that rate); a
// four-way pass, the shared-memory work of its two merge levels and the
// dependent loads of its partition (0.29 + 0.13 ms for 2^25 keys where the
// memory alone would take 0.16; NVIDIA H100 80GB HBM3, 700 W).  Two levels
// for one pass still win: a sort of 2^25 keys makes 6 such passes in 2.7 ms
// where 12 two-way passes took 3.1.

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
// several threads of a half-warp onto one bank pair.  `merge_quads`, with
// its two merge levels a tile, is bound by shared-memory wavefronts and runs
// 1.3x faster padded; `merge_tiles` ran 1.13x slower padded (0.523 against
// 0.464 ms for 2^25 + 2^25 keys on an NVIDIA H100 80GB HBM3, 700 W) and
// stays unpadded.
template <bool kPad>
constexpr int kTileSlots = kTile + (kPad ? kTile / 8 : 0) + 1;

template <bool kPad>
__device__ __forceinline__ int slot(int i) {
  return kPad ? i + (i >> 3) : i;
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
  __shared__ long long tile_s[C][kTileSlots<false>];
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
  merge_tiles<C><<<(unsigned)n_tiles, kThreads, 0, s>>>(a, b, ps, coranks,
                                                        out);
  return cudaGetLastError();
}

// --- quads: four runs a pass (kernel B5) ----------------------------------

// The rows [0, n) of one buffer hold sorted runs of `run` rows (a multiple
// of kTile; the last run may be short or missing); quad q is the runs
// [4 q run, +run), ... , [(4 q + 3) run, +run), all cut at n.
struct Quads {
  long long run;
  long long n;
};

// Output tile g of the launch -> its quad's first row `base`, the four run
// lengths and the tile's first diagonal d0 inside the quad.
__device__ __forceinline__ void tile_quad(const Quads& qs, long long g,
                                          long long* base, long long (&len)[4],
                                          long long* d0) {
  const long long tiles_per_quad = 4 * qs.run / kTile;
  const long long quad = g / tiles_per_quad;
  *base = quad * 4 * qs.run;
  long long left = qs.n - *base;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    len[r] = left < qs.run ? left : qs.run;
    left -= len[r];
  }
  *d0 = (g - quad * tiles_per_quad) * kTile;
}

// One pair of a quad: A = buf[at, at + la), B = buf[at + run, at + run + lb),
// and `table`, the co-ranks `partition` found for the pair's tile diagonals
// (entry t for diagonal t * kTile < la + lb).
struct PairAt {
  long long at;
  long long run;
  long long la;
  long long lb;
  const long long* table;
};

// Where the co-rank of diagonal i < la + lb of a pair can lie: between the
// co-ranks of the tile diagonals around i.
struct Window {
  long long lo;
  long long hi;
};

__device__ __forceinline__ Window corank_window(const PairAt& p,
                                                long long i) {
  const long long total = p.la + p.lb;
  const long long t = i / kTile;
  const long long a_lo = p.table[t];
  const long long d_hi = (t + 1) * kTile < total ? (t + 1) * kTile : total;
  const long long a_hi = d_hi == total ? p.la : p.table[t + 1];
  const long long b_lo = t * kTile - a_lo, b_hi = d_hi - a_hi;
  Window w;
  w.lo = a_lo > i - b_hi ? a_lo : i - b_hi;
  w.hi = a_hi < i - b_lo ? a_hi : i - b_lo;
  return w;
}

// The co-ranks of diagonal i of pair p and of diagonal j of pair q
// (i <= p.la + p.lb, j <= q.la + q.lb), each searched inside its window,
// the two searches side by side so that their loads overlap.
template <int C>
__device__ __forceinline__ void corank_near2(const Cols<C>& buf,
                                             const PairAt& p, long long i,
                                             const PairAt& q, long long j,
                                             long long* ip, long long* jq) {
  Window u{p.la, p.la}, v{q.la, q.la};  // a diagonal at the end: all of A
  if (i < p.la + p.lb) u = corank_window(p, i);
  if (j < q.la + q.lb) v = corank_window(q, j);
  const Cols<C> pa = offset<C>(buf, p.at), pb = offset<C>(buf, p.at + p.run);
  const Cols<C> qa = offset<C>(buf, q.at), qb = offset<C>(buf, q.at + q.run);
  while (u.lo < u.hi || v.lo < v.hi) {
    const bool on_u = u.lo < u.hi, on_v = v.lo < v.hi;
    const long long mu = (u.lo + u.hi) >> 1, mv = (v.lo + v.hi) >> 1;
    const bool le_u = on_u && le<C>(pa, mu, pb, i - mu - 1);
    const bool le_v = on_v && le<C>(qa, mv, qb, j - mv - 1);
    if (on_u) {
      if (le_u)
        u.lo = mu + 1;
      else
        u.hi = mu;
    }
    if (on_v) {
      if (le_v)
        v.lo = mv + 1;
      else
        v.hi = mv;
    }
  }
  *ip = u.lo;
  *jq = v.lo;
}

// The row of `buf` that holds output i < la + lb of the pair's merge, given
// the co-rank ia of diagonal i.
template <int C>
__device__ __forceinline__ long long merged_row(const Cols<C>& buf,
                                                const PairAt& p, long long i,
                                                long long ia) {
  const long long ib = i - ia;
  const long long ra = p.at + ia, rb = p.at + p.run + ib;
  const bool take_a = ib >= p.lb || (ia < p.la && le<C>(buf, ra, buf, rb));
  return take_a ? ra : rb;
}

// The row of `buf` that holds the last of the pair's first d outputs, d >= 1,
// given the co-rank ia of diagonal d: the larger of A[ia - 1] and B[ib - 1].
template <int C>
__device__ __forceinline__ long long last_row(const Cols<C>& buf,
                                              const PairAt& p, long long d,
                                              long long ia) {
  const long long ib = d - ia;
  const long long ra = p.at + ia - 1, rb = p.at + p.run + ib - 1;
  if (ia == 0) return rb;
  if (ib == 0) return ra;
  return le<C>(buf, ra, buf, rb) ? rb : ra;
}

// The smallest i in [lo, hi) with pred(i) false, or hi, for a pred that is
// true up to some i and false from there on; G neighbouring lanes (a power
// of two <= 32) search together, one probe each a round (a binary search
// would make 11 dependent rounds over a tile's window, eight lanes make 4).
// Every lane of the group gets the result.
template <int G, class Pred>
__device__ __forceinline__ long long group_search(long long lo, long long hi,
                                                  Pred pred) {
  const int lane = threadIdx.x & 31, sub = lane & (G - 1);
  const unsigned group = (0xffffffffu >> (32 - G)) << (lane - sub);
  while (lo < hi) {
    const long long step = (hi - lo + G - 1) / G;
    const long long at = lo + sub * step;
    const int held = __popc(__ballot_sync(group, at < hi && pred(at)));
    if (held == 0) {
      hi = lo;
    } else {
      const long long next = lo + held * step;
      lo = next - step + 1;
      hi = next < hi ? next : hi;
    }
  }
  return lo;
}

// splits[3 g ...] = (rows of A, rows of C, rows of AB) among the first d0
// outputs of tile g's quad.  G lanes a tile.
template <int C, int G>
__global__ void partition_quads(Cols<C> buf, Quads qs,
                                const long long* __restrict__ coranks,
                                long long* __restrict__ splits,
                                long long n_tiles) {
  const long long g =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (g >= n_tiles) return;  // a whole group leaves together
  long long base, len[4], d;
  tile_quad(qs, g, &base, len, &d);
  const PairAt ab{base, qs.run, len[0], len[1], coranks + base / kTile};
  const PairAt cd{base + 2 * qs.run, qs.run, len[2], len[3],
                  coranks + (base + 2 * qs.run) / kTile};
  const long long nab = len[0] + len[1], ncd = len[2] + len[3];
  // the co-rank of d in (AB, CD): the smallest i in [lo, hi] with
  // AB[i] > CD[d - i - 1], or hi
  long long lo = d - ncd > 0 ? d - ncd : 0;
  long long hi = d < nab ? d : nab;
  // coarse, over the tile diagonals i = t * kTile in [lo, hi): d - i is one
  // of CD's, so both rows come from the tables without a search
  const long long t_first = (lo + kTile - 1) / kTile;
  const long long t_end = (hi + kTile - 1) / kTile;
  const long long t = group_search<G>(t_first, t_end, [&](long long t) {
    const long long i = t * kTile, j = d - i;  // kTile <= j <= ncd
    const long long ic = j >= ncd ? cd.la : cd.table[j / kTile];
    return le<C>(buf, merged_row<C>(buf, ab, i, ab.table[t]), buf,
                 last_row<C>(buf, cd, j, ic));
  });
  if (t > t_first) lo = (t - 1) * kTile + 1;
  if (t < t_end) hi = t * kTile;
  // fine, inside one tile of AB and of CD
  const long long i_ab = group_search<G>(lo, hi, [&](long long i) {
    const long long j = d - i - 1;
    long long ia, jc;
    corank_near2<C>(buf, ab, i, cd, j, &ia, &jc);
    return le<C>(buf, merged_row<C>(buf, ab, i, ia), buf,
                 merged_row<C>(buf, cd, j, jc));
  });
  if ((threadIdx.x & (G - 1)) != 0) return;
  long long ia, ic;
  corank_near2<C>(buf, ab, i_ab, cd, d - i_ab, &ia, &ic);
  splits[3 * g] = ia;
  splits[3 * g + 1] = ic;
  splits[3 * g + 2] = i_ab;
}

template <int C>
__global__ void merge_quads(Cols<C> buf, Quads qs,
                            const long long* __restrict__ splits,
                            MutCols<C> out) {
  __shared__ long long tile_s[C][kTileSlots<true>];
  long long base, len[4], d0;
  tile_quad(qs, blockIdx.x, &base, len, &d0);
  const long long nab = len[0] + len[1], all = nab + len[2] + len[3];
  const long long d1 = d0 + kTile < all ? d0 + kTile : all;
  const long long* s0 = splits + 3 * (long long)blockIdx.x;
  const bool last = d1 == all;
  const long long a0 = s0[0], c0 = s0[1], ab0 = s0[2];
  const long long a1 = last ? len[0] : s0[3], c1 = last ? len[2] : s0[4];
  const long long ab1 = last ? nab : s0[5];
  const long long b0 = ab0 - a0, e0 = d0 - ab0 - c0;  // e: run D
  const int na = (int)(a1 - a0), nb = (int)(ab1 - ab0) - na;
  const int nc = (int)(c1 - c0), total = (int)(d1 - d0);
  const int b1 = na, b2 = na + nb, b3 = b2 + nc;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const long long* ga = buf.p[c] + base + a0;
    const long long* gb = buf.p[c] + base + qs.run + b0;
    const long long* gc = buf.p[c] + base + 2 * qs.run + c0;
    const long long* gd = buf.p[c] + base + 3 * qs.run + e0;
    for_tile_rows<C>(total, [&](int j) {
      tile_s[c][slot<true>(j)] = j < b2 ? (j < b1 ? ga[j] : gb[j - b1])
                                  : (j < b3 ? gc[j - b2] : gd[j - b3]);
    });
  }
  __syncthreads();
  merge_shared<C, true, true>(tile_s, b1, b2, b3, total);
  merge_shared<C, false, true>(tile_s, b2, total, total, total);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    long long* go = out.p[c] + base + d0;
    for_tile_rows<C>(total,
                     [&](int j) { go[j] = tile_s[c][slot<true>(j)]; });
  }
}

// One pass over the runs of `buf` (n rows, runs of `run` rows), four runs
// into one: `partition` for the pairs' tables, `partition_quads`,
// `merge_quads`.  `scratch` holds 4 * n_tiles values.
template <int C>
cudaError_t quad_pass(const Cols<C>& buf, long long run, long long n,
                      long long n_tiles, long long* scratch,
                      const MutCols<C>& out, cudaStream_t s) {
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long pblocks = (n_tiles + kThreads - 1) / kThreads;
  const Pairs ps{run, n, 0, 0};
  long long* splits = scratch + n_tiles;
  partition<C><<<(unsigned)pblocks, kThreads, 0, s>>>(
      buf, offset<C>(buf, run), ps, scratch, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Quads qs{run, n};
  // few tiles: the searches wait on their chains of loads, and eight lanes a
  // tile shorten them; many tiles: the loads themselves are the limit, and
  // four lanes make fewer
  const int lanes = n_tiles < (1 << 13) ? 8 : 4;
  const long long qblocks = (n_tiles * lanes + kThreads - 1) / kThreads;
  if (qblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (lanes == 8)
    partition_quads<C, 8><<<(unsigned)qblocks, kThreads, 0, s>>>(
        buf, qs, scratch, splits, n_tiles);
  else
    partition_quads<C, 4><<<(unsigned)qblocks, kThreads, 0, s>>>(
        buf, qs, scratch, splits, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_quads<C><<<(unsigned)n_tiles, kThreads, 0, s>>>(buf, qs, splits, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cbl
