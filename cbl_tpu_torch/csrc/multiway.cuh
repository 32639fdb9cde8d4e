// Multiway merge passes of kernel B5 (csrc/sort.cu): every F neighbouring
// sorted runs of one buffer (F a power of two up to kMaxFan) merged into one
// run in ONE pass over device memory, so that a sort of 2^25 rows makes a
// tile sort and four merge passes at three columns (two- and four-way
// passes made eight) and a tile sort and three at one column (four-way
// passes: six).
//
// Rows compare lexicographically, column 0 major.  A "group" is F
// neighbouring runs R_0 ... R_{F-1} of `run` rows (the last ones cut at n);
// output tile g of a group holds its outputs [t T, (t + 1) T), T =
// kMultiRows.  Ties go by run, then by row: the order is (row, r, j) for row
// j of run r, a strict total order, and the first d outputs of the group
// are its d smallest rows in that order.  Since equal rows are equal in
// every column, the output is a plain sort of the group's rows.
//   1. `multiway_partition`: for the first diagonal d of every output tile,
//      how many of the group's first d outputs come from each run (the
//      split), found by F lanes together, lane r on run r.  The search
//      walks down the levels l = run, run / 2, ..., 1: the level-l samples
//      of a run are its rows k l - 1, and at each level the lanes hold the
//      t_l smallest samples of the group (a prefix of every run: taken
//      samples precede all others).  Going to level l / 2, the taken
//      samples stay taken and a run's one new sample between its last
//      taken and its first untaken one is taken iff it precedes the
//      largest taken sample, which keeps the set a prefix in every run;
//      then the set grows by the smallest untaken sample of the group, or
//      shrinks by its largest taken one, one at a time, to t_{l/2}.  At
//      l = 1 the target is d and the taken rows are the d smallest.  Any
//      intermediate target is correct; t_l = d / l - F / 2 keeps the moves
//      a level few (each move is one load by one lane and one reduction
//      over the lanes by shuffles), and a lane loads one new row a level
//      besides them.  No search table, no nested co-rank.
//   2. `merge_multi`: block g loads its F segments (between its split and
//      the next tile's, or the runs' ends) into shared memory with
//      asynchronous 8-byte copies (`cp.async`; all of a thread's copies in
//      flight at once, no register staging), then merges them pairwise in
//      log2(F) levels in shared memory (`merge_level`: the co-rank rule and
//      the register-held run heads of merge_path.cuh's `merge_shared`,
//      pairs of any length, a thread's outputs crossing pair ends), and
//      stores the tile coalesced.  At two and three columns the levels move
//      (column 0, loaded row) pairs and read the other columns only where
//      columns 0 tie (`MultiTile`); the store takes them in the merged
//      order.  At one column the levels move the keys themselves.  A tile's
//      segments end where the next tile's begin, so neighbouring tiles
//      cannot disagree.
// Empty or short runs, runs of equal rows across tiles and runs, and
// INT64_MAX sentinel rows need no special case.
//
// What bounds it on the H100: a pass reads and writes every row once (0.48
// ms for 2^25 rows of three columns at 3.35 TB/s, 0.16 of one); the merge
// levels in shared memory and the partition's chains of dependent loads
// come on top.  At 2^25 rows of the K=59 sort-join's queries (NVIDIA H100
// 80GB HBM3, 700 W) the four merge passes took 2.79 ms in `merge_multi`
// (3.73 with whole rows moved at every level) and 1.37 ms in
// `multiway_partition`; a four-way pass alone spent 1.31 ms a pass in
// `merge_quads`, its loads one at a time a thread.

#pragma once

#include "merge_path.cuh"

namespace cbl {
namespace {

constexpr int kMaxFan = 16;  // = ops/merge.py SORT_WAYS

// Output rows of a block of `merge_multi`, kItems a thread; at least kTile,
// by which ops/merge.py `_scratch` sizes the splits.  At one column 4096
// rows, 512 threads: half as many splits as 2048 (2.82 against 3.02 ms for
// 2^25 keys; two columns ran 0.975 against 0.945 for 2^22 + 2^21 rows;
// NVIDIA H100 80GB HBM3, 700 W).
template <int C>
constexpr int kMultiRows = C == 1 ? 2 * kTile : kTile;
static_assert(kMultiRows<1> >= kTile && kMultiRows<2> >= kTile &&
                  kMultiRows<3> >= kTile,
              "the splits' scratch is sized by kTile");
template <int C>
constexpr int kMultiThreads = kMultiRows<C> / kItems;
template <int C>
constexpr int kMultiSlots = kMultiRows<C> + kMultiRows<C> / 8 + 1;

// The rows [0, n) of one buffer hold sorted runs of `run` rows (a multiple
// of the output tile); group q is the runs [F q run, +run), ...,
// [(F q + F - 1) run, +run), all cut at n.
struct Groups {
  long long run;
  long long n;
  int fan;
};

__device__ __forceinline__ long long run_length(const Groups& gs,
                                                long long base, int r) {
  const long long left = gs.n - base - (long long)r * gs.run;
  return left <= 0 ? 0 : (left < gs.run ? left : gs.run);
}

// Output tile g of T rows -> its group's first row, the tile's first
// diagonal d0 in the group and the group's rows.
template <int T>
__device__ __forceinline__ void tile_in_group(const Groups& gs, long long g,
                                              long long* base, long long* d0,
                                              long long* rows) {
  const long long full = (long long)gs.fan * gs.run;
  const long long per_group = full / T;
  const long long q = g / per_group;
  *base = q * full;
  const long long left = gs.n - *base;
  *rows = left < full ? left : full;
  *d0 = (g - q * per_group) * T;
}

// A row of a run as the split sees it: its values, its run and its index.
template <int C>
struct Cand {
  long long x[C];
  long long j;
  int r;
  int ok;  // 0: no such row
};

// a before b in the order (row, run, index).
template <int C>
__device__ __forceinline__ bool precedes(const Cand<C>& a, const Cand<C>& b) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (a.x[c] != b.x[c]) return a.x[c] < b.x[c];
  }
  if (a.r != b.r) return a.r < b.r;
  return a.j < b.j;
}

template <int C>
__device__ __forceinline__ void load_cand(const Cols<C>& run, Cand<C>& a) {
  if (!a.ok) return;
#pragma unroll
  for (int c = 0; c < C; ++c) a.x[c] = run.p[c][a.j];
}

// The first (kMin) or the last row that the F lanes of the group hold
// (rows that are not there left out); every lane gets it.
template <int C, bool kMin>
__device__ __forceinline__ Cand<C> group_pick(unsigned mask, int F,
                                              Cand<C> a) {
  for (int off = F >> 1; off > 0; off >>= 1) {
    Cand<C> b;
#pragma unroll
    for (int c = 0; c < C; ++c) b.x[c] = __shfl_xor_sync(mask, a.x[c], off);
    b.j = __shfl_xor_sync(mask, a.j, off);
    b.r = __shfl_xor_sync(mask, a.r, off);
    b.ok = __shfl_xor_sync(mask, a.ok, off);
    const bool take =
        b.ok && (!a.ok || (kMin ? precedes<C>(b, a) : precedes<C>(a, b)));
    if (take) a = b;
  }
  return a;
}

__device__ __forceinline__ long long group_sum(unsigned mask, int F,
                                               long long v) {
  for (int off = F >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

// How many of the group's first d outputs come from this lane's run (`len`
// rows at `run`, runs of `run_rows` rows, a power of two), lane `sub` of
// the F lanes in `mask`.  = ops/merge.py `multiway_split_plain`
template <int C>
__device__ long long multiway_split(const Cols<C>& run, long long len,
                                   long long run_rows, int sub, int F,
                                   unsigned mask, long long d) {
  // at level l: b taken samples; `last` = row b l - 1, `next` = row
  // (b + 1) l - 1, where they exist
  long long l = run_rows, b = 0;
  Cand<C> last, next;
  last.r = next.r = sub;
  last.j = -1;
  last.ok = 0;
  next.j = l - 1;
  next.ok = len >= l;
  load_cand<C>(run, next);
  for (;;) {
    const long long cnt = len / l;
    const long long samples = group_sum(mask, F, cnt);
    long long t = d / l;
    if (l > 1) t = t > F / 2 ? t - F / 2 : 0;
    if (t > samples) t = samples;
    long long count = group_sum(mask, F, b);
    while (count < t) {  // take the group's smallest untaken sample
      const Cand<C> m = group_pick<C, true>(mask, F, next);
      if (m.r == sub) {
        last = next;
        ++b;
        next.j = (b + 1) * l - 1;
        next.ok = b + 1 <= cnt;
        load_cand<C>(run, next);
      }
      ++count;
    }
    while (count > t) {  // drop the group's largest taken sample
      const Cand<C> m = group_pick<C, false>(mask, F, last);
      if (m.r == sub) {
        next = last;
        --b;
        last.j = b * l - 1;
        last.ok = b >= 1;
        load_cand<C>(run, last);
      }
      --count;
    }
    if (l == 1) return b;
    // level l / 2: the taken samples are its even ones; the odd one after
    // them is taken iff it precedes the largest taken sample (its load
    // goes out before the reduction that finds that sample)
    l >>= 1;
    b *= 2;
    Cand<C> odd;
    odd.r = sub;
    odd.j = (b + 1) * l - 1;
    odd.ok = b + 1 <= len / l;
    load_cand<C>(run, odd);
    const Cand<C> top = group_pick<C, false>(mask, F, last);
    if (odd.ok && top.ok && precedes<C>(odd, top)) {
      last = odd;  // `next` is row (b + 2) l - 1 already
      ++b;
    } else {
      next = odd;
    }
  }
}

// splits[g F + r] = how many of the first d0 outputs of tile g's group come
// from run r.  F lanes a tile (F divides 32).
template <int C>
__global__ void __launch_bounds__(kThreads, 4)
multiway_partition(Cols<C> buf, Groups gs, long long* __restrict__ splits,
                   long long n_tiles) {
  const int F = gs.fan;
  const long long g = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / F;
  if (g >= n_tiles) return;  // a whole group leaves together
  const int lane = threadIdx.x & 31, sub = lane & (F - 1);
  const unsigned mask = ((1u << F) - 1u) << (lane - sub);
  long long base, d0, rows;
  tile_in_group<kMultiRows<C>>(gs, g, &base, &d0, &rows);
  long long s = 0;
  if (d0 > 0)
    s = multiway_split<C>(offset<C>(buf, base + (long long)sub * gs.run),
                          run_length(gs, base, sub), gs.run, sub, F, mask,
                          d0);
  splits[g * F + sub] = s;
}

__device__ __forceinline__ void cp_async8(long long* dst,
                                          const long long* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

// A keyed shared tile (`merge_multi`, sort.cu's `tile_sort_keyed`): column
// 0 padded as `slot<true>` pads, which the merges move; at two and three
// columns also the rows' places in the tile as loaded (16-bit, padded),
// which move with column 0, and the other columns as loaded, which stay
// where they are until the store.  A merge step then moves 10 bytes a row,
// not 16 or 24.
template <int C>
struct MultiTile {
  long long* key;
  long long* rest[C > 1 ? C - 1 : 1];
  unsigned short* idx;  // C > 1
};

// The bytes of a keyed tile of `rows` rows and `slots` padded slots.
template <int C>
__host__ __device__ constexpr int keyed_tile_bytes(int rows, int slots) {
  return slots * (int)sizeof(long long) +
         (C > 1 ? slots * (int)sizeof(unsigned short) +
                      (C - 1) * rows * (int)sizeof(long long)
                : 0);
}

// `merge_multi`'s tile: 36 KB at one column, 37 KB at two, 55.8 KB at three.
template <int C>
constexpr int kMultiSmem = keyed_tile_bytes<C>(kMultiRows<C>, kMultiSlots<C>);

template <int C, int kRows, int kSlots>
__device__ __forceinline__ MultiTile<C> multi_tile() {
  extern __shared__ long long multi_s[];
  MultiTile<C> t;
  t.key = multi_s;
  long long* p = multi_s + kSlots;
#pragma unroll
  for (int c = 0; c < C - 1; ++c, p += kRows) t.rest[c] = p;
  t.idx = reinterpret_cast<unsigned short*>(p);
  return t;
}

// Row (kx, loaded as row ix) <= row (ky, iy): column 0, then the others,
// read only where column 0 ties.
template <int C>
__device__ __forceinline__ bool multi_le(const MultiTile<C>& t, long long kx,
                                         int ix, long long ky, int iy) {
  if (kx != ky || C == 1) return kx <= ky;
#pragma unroll
  for (int c = 0; c < C - 2; ++c) {
    const long long x = t.rest[c][ix], y = t.rest[c][iy];
    if (x != y) return x < y;
  }
  return t.rest[C > 1 ? C - 2 : 0][ix] <= t.rest[C > 1 ? C - 2 : 0][iy];
}

// The tile row loaded into slot `sl` (C > 1; 0 at one column, unused).
template <int C>
__device__ __forceinline__ int multi_idx(const MultiTile<C>& t, int sl) {
  if constexpr (C > 1)
    return t.idx[sl];
  else
    return 0;
}

template <int C>
__device__ __forceinline__ bool multi_le_at(const MultiTile<C>& t, int i,
                                            int j) {
  const int si = slot<true>(i), sj = slot<true>(j);
  return multi_le<C>(t, t.key[si], multi_idx<C>(t, si), t.key[sj],
                     multi_idx<C>(t, sj));
}

// `corank_shared` over the tile's (column 0, row) pairs.
template <int C>
__device__ __forceinline__ int multi_corank(const MultiTile<C>& t, int a0,
                                            int la, int b0, int lb, int d) {
  int lo = d - lb > 0 ? d - lb : 0;
  int hi = d < la ? d : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (multi_le_at<C>(t, a0 + mid, b0 + d - mid - 1))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One level of the merge tree over the tile's F segments (starts seg[0 ..
// F], seg[F] = total): pair p merges the segments [2 p w, 2 p w + w) with
// [2 p w + w, 2 p w + 2 w), each already merged, into its own place.
// Thread t produces the outputs [t kItems, (t + 1) kItems), crossing into
// the next pair (past empty ones) where its pair ends; the runs' heads are
// held in registers (`merge_step`'s rule, A's head on ties).  Ends on a
// barrier.
template <int C>
__device__ __forceinline__ void merge_level(const MultiTile<C>& t,
                                            const int* seg, int F, int w,
                                            int total) {
  const int di = min((int)threadIdx.x * kItems, total);
  const int pairs = F / (2 * w);
  int p = 0;
  while (p + 1 < pairs && seg[(p + 1) * 2 * w] <= di) ++p;
  int s = seg[p * 2 * w];
  int ea = seg[p * 2 * w + w], eb = seg[(p + 1) * 2 * w];
  int pa = s, pb = ea;
  {
    const int ia = multi_corank<C>(t, s, ea - s, ea, eb - ea, di - s);
    pb += di - s - ia;
    pa += ia;
  }
  long long ka = t.key[slot<true>(pa)], kb = t.key[slot<true>(pb)];
  int ia = multi_idx<C>(t, slot<true>(pa));
  int ib = multi_idx<C>(t, slot<true>(pb));
  long long mk[kItems];
  int mi[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (di + k < total) {
      if (di + k == eb) {
        do {
          ++p;
          s = eb;
          ea = seg[p * 2 * w + w];
          eb = seg[(p + 1) * 2 * w];
        } while (eb == s);
        pa = s;
        pb = ea;
        ka = t.key[slot<true>(pa)];
        kb = t.key[slot<true>(pb)];
        ia = multi_idx<C>(t, slot<true>(pa));
        ib = multi_idx<C>(t, slot<true>(pb));
      }
      const bool take_a =
          pb >= eb || (pa < ea && multi_le<C>(t, ka, ia, kb, ib));
      mk[k] = take_a ? ka : kb;
      mi[k] = take_a ? ia : ib;
      const int nx = slot<true>(take_a ? ++pa : ++pb);
      const long long kn = t.key[nx];
      const int in = multi_idx<C>(t, nx);
      ka = take_a ? kn : ka;
      ia = take_a ? in : ia;
      kb = take_a ? kb : kn;
      ib = take_a ? ib : in;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (di + k < total) {
      t.key[slot<true>(di + k)] = mk[k];
      if constexpr (C > 1) t.idx[slot<true>(di + k)] = (unsigned short)mi[k];
    }
  }
  __syncthreads();
}

template <int C>
__global__ void __launch_bounds__(kMultiThreads<C>)
merge_multi(Cols<C> buf, Groups gs, const long long* __restrict__ splits,
            MutCols<C> out) {
  constexpr int T = kMultiRows<C>, N = kMultiThreads<C>;
  const MultiTile<C> t = multi_tile<C, T, kMultiSlots<C>>();
  __shared__ int seg[kMaxFan + 1];
  __shared__ long long from[kMaxFan];
  const int F = gs.fan;
  long long base, d0, rows;
  tile_in_group<T>(gs, blockIdx.x, &base, &d0, &rows);
  const long long d1 = d0 + T < rows ? d0 + T : rows;
  const int total = (int)(d1 - d0);
  if (threadIdx.x < 32) {
    const int r = threadIdx.x;
    int len = 0;
    if (r < F) {
      const long long s0 = splits[(long long)blockIdx.x * F + r];
      const long long s1 =
          d1 == rows ? run_length(gs, base, r)
                     : splits[((long long)blockIdx.x + 1) * F + r];
      len = (int)(s1 - s0);
      from[r] = base + (long long)r * gs.run + s0;
    }
    int incl = len;  // inclusive scan over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (r >= off) incl += v;
    }
    if (r < F) seg[r] = incl - len;
    if (r == 0) seg[F] = total;
  }
  __syncthreads();
  for (int r = 0; r < F; ++r) {
    const int s = seg[r], len = seg[r + 1] - s;
    const long long at = from[r];
    for (int j = threadIdx.x; j < len; j += N) {
      cp_async8(&t.key[slot<true>(s + j)], buf.p[0] + at + j);
#pragma unroll
      for (int c = 1; c < C; ++c)
        cp_async8(&t.rest[c - 1][s + j], buf.p[c] + at + j);
      if constexpr (C > 1) t.idx[slot<true>(s + j)] = (unsigned short)(s + j);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  for (int w = 1; w < F; w <<= 1) merge_level<C>(t, seg, F, w, total);
  const long long o = base + d0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = threadIdx.x + k * N;
    if (j < total) {
      out.p[0][o + j] = t.key[slot<true>(j)];
      if constexpr (C > 1) {
        const int i = t.idx[slot<true>(j)];
#pragma unroll
        for (int c = 1; c < C; ++c) out.p[c][o + j] = t.rest[c - 1][i];
      }
    }
  }
}

// One pass over the runs of `buf` (n rows, runs of `run` rows), `fan` runs
// into one: `multiway_partition`, then `merge_multi`, over n_tiles output
// tiles of kMultiRows rows.  `splits` holds fan * n_tiles values.
template <int C>
cudaError_t multiway_pass(const Cols<C>& buf, long long run, int fan,
                          long long n, long long n_tiles, long long* splits,
                          const MutCols<C>& out, cudaStream_t s) {
  if (fan < 2 || fan > kMaxFan || (fan & (fan - 1)) != 0)
    return cudaErrorInvalidValue;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Groups gs{run, n, fan};
  const long long pblocks = (n_tiles * fan + kThreads - 1) / kThreads;
  multiway_partition<C><<<(unsigned)pblocks, kThreads, 0, s>>>(buf, gs, splits,
                                                              n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(merge_multi<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMultiSmem<C>);
  if (err != cudaSuccess) return err;
  merge_multi<C><<<(unsigned)n_tiles, kMultiThreads<C>, kMultiSmem<C>, s>>>(
      buf, gs, splits, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cbl
