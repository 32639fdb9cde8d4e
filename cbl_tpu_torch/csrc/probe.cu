// Kernel B8: the probe join, hits of query rows in a sorted index much
// larger than the batch, found by search instead of a merge.
//
// No TPU kernel of cbl_tpu answers this: its queries merge with the whole
// index (kernel B3), which moves every index row for every batch.  CBL
// itself finds a k-mer's bucket through a rank over its prefix and reads
// that bucket alone; a prefix directory over necklace words is skewed
// (they begin with long runs of zeros), so the port's layout is a sorted
// sample of the index instead: every 2^s-th row (`ops/probe.py`
// `search_layout`, built once when the index changes).  A row counts as
// a hit when any index row equals it (the index may hold duplicates, a
// bulk build's state); SENTINEL query rows (INT64_MAX in column 0) never
// hit.  Rows are one or two int64 columns, compared lexicographically,
// column 0 major; every row count and index is 64-bit (the index of a
// human genome holds 3.1e9 rows).
//
// One thread a query row, 256 sorted rows a block.  Warps 0 and 1 find
// where the block's first and last rows fall in the sample (a 33-way
// search: 32 lanes compare a row each, a ballot keeps the part between
// the last row at or below the query and the first above it); every row
// of the block then falls between the two, so each thread's binary search
// of the sample covers only that window (about 1,500 entries of a human
// genome's sample at 256 queries a block), which the block's threads read
// together.  Then a lower-bound search of the 2^s - 1 index rows after its
// sample entry: s = 5 (`ops/probe.py` STRIDE_LOG), 256 bytes of one
// column, three dependent sectors.  The queries must be sorted.  A block
// counts its hits with `__syncthreads_count` and adds them with one
// atomicAdd; the C entry point clears the counter first on the call's
// stream.
//
// What bounds it on the H100: the dependent sector reads of the index,
// about three a row, and the sample read about once a batch.

#include <cuda_runtime.h>

namespace cbl {
namespace {

constexpr int kThreads = 256;
constexpr long long kSentinel = 0x7fffffffffffffffLL;

template <int C>
struct Rows {
  const long long* p[C];
};

// Compare index row i with the row q held in registers: < 0, 0 or > 0.
template <int C>
__device__ __forceinline__ int cmp(const Rows<C>& a, long long i,
                                   const long long (&q)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const long long x = __ldg(a.p[c] + i);
    if (x != q[c]) return x < q[c] ? -1 : 1;
  }
  return 0;
}

// The number of sample rows at or below q (the first row above it),
// known to lie in [lo, hi]; every lane of the warp holds the same q.
template <int C>
__device__ __forceinline__ long long warp_upper_bound(
    const Rows<C>& a, long long lo, long long hi, const long long (&q)[C]) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long span = hi - lo;
    const bool le = cmp<C>(a, lo + span * (lane + 1) / 33, q) <= 0;
    const int c = __popc(__ballot_sync(0xffffffffu, le));
    const long long new_lo = c > 0 ? lo + span * c / 33 + 1 : lo;
    hi = c < 32 ? lo + span * (c + 1) / 33 : hi;
    lo = new_lo;
  }
  const bool le = lo + lane < hi && cmp<C>(a, lo + lane, q) <= 0;
  return lo + __popc(__ballot_sync(0xffffffffu, le));
}

template <int C>
__global__ void probe_hits(Rows<C> data, long long n, Rows<C> sample,
                           long long m, int stride_log, Rows<C> queries,
                           long long nq,
                           unsigned long long* __restrict__ hits) {
  __shared__ long long window[2];
  const long long first = (long long)blockIdx.x * kThreads;
  const long long i = first + threadIdx.x;
  if (threadIdx.x < 64) {  // warp 0: the block's first row, warp 1 its last
    const long long row = threadIdx.x < 32
                              ? first
                              : (first + kThreads < nq ? first + kThreads
                                                       : nq) - 1;
    long long b[C];
#pragma unroll
    for (int c = 0; c < C; ++c) b[c] = __ldg(queries.p[c] + row);
    const long long ub = warp_upper_bound<C>(sample, 0, m, b);
    if ((threadIdx.x & 31) == 0) window[threadIdx.x >> 5] = ub;
  }
  __syncthreads();
  int hit = 0;
  long long q[C];
  if (i < nq) {
#pragma unroll
    for (int c = 0; c < C; ++c) q[c] = __ldg(queries.p[c] + i);
  }
  if (i < nq && q[0] != kSentinel) {
    // how many sample entries are at or below q, between the block's ends
    long long lo = window[0], hi = window[1];
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (cmp<C>(sample, mid, q) <= 0)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo > 0) {
      const long long j = lo - 1;  // sample[j] <= q < sample[j + 1]
      if (cmp<C>(sample, j, q) == 0) {
        hit = 1;
      } else {
        // rows equal to q lie after row j << s and before the next
        // sample's row: lower bound of q there
        long long a = (j << stride_log) + 1;
        const long long next = (j + 1) << stride_log;
        const long long end = next < n ? next : n;
        long long b = end;
        while (a < b) {
          const long long mid = (a + b) >> 1;
          if (cmp<C>(data, mid, q) < 0)
            a = mid + 1;
          else
            b = mid;
        }
        hit = a < end && cmp<C>(data, a, q) == 0;
      }
    }
  }
  const int block_hits = __syncthreads_count(hit);
  if (threadIdx.x == 0 && block_hits)
    atomicAdd(hits, (unsigned long long)block_hits);
}

template <int C>
int probe(const void* const* data, long long n, const void* const* sample,
          long long m, int stride_log, const void* const* queries,
          long long nq, unsigned long long* hits, cudaStream_t s) {
  Rows<C> d, smp, qs;
  for (int c = 0; c < C; ++c) {
    d.p[c] = (const long long*)data[c];
    smp.p[c] = (const long long*)sample[c];
    qs.p[c] = (const long long*)queries[c];
  }
  cudaError_t err = cudaMemsetAsync(hits, 0, sizeof(*hits), s);
  if (err != cudaSuccess || nq == 0 || m == 0) return (int)err;
  const long long blocks = (nq + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  probe_hits<C><<<(unsigned)blocks, kThreads, 0, s>>>(
      d, n, smp, m, stride_log, qs, nq, hits);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cbl

// data, sample and queries are C-element arrays of column pointers (C = 1
// or 2); `sample` holds rows 0, 2^stride_log, 2 * 2^stride_log, ... of
// `data`; the queries are sorted; `hits` one int64, overwritten with the
// count.
extern "C" int cbl_probe_hits(const void* const* data, long long n,
                              const void* const* sample, long long m,
                              int stride_log, const void* const* queries,
                              long long nq, int C, void* hits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* h = (unsigned long long*)hits;
  switch (C) {
    case 1:
      return cbl::probe<1>(data, n, sample, m, stride_log, queries, nq, h, s);
    case 2:
      return cbl::probe<2>(data, n, sample, m, stride_log, queries, nq, h, s);
  }
  return (int)cudaErrorInvalidValue;
}
