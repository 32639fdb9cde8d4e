// Kernel B7: merge of two sorted runs of int64 key rows by the bitonic
// network.
//
// Replaces the TPU kernel cbl_tpu/ops/sort_pallas.py `merge_cols_pallas`.
// A (na rows) and B (nb rows), each sorted ascending (lexicographic, column
// 0 major), become one sorted run of na + nb rows, equal to a sort of
// their concatenation.
//
// With M = the next power of two of max(na, nb), the 2 M rows
// [A, pads to M | B reversed, pads in front] form one bitonic sequence;
// the steps M, M / 2, ..., 1, every pair ascending, sort it, and the pads
// (INT64_MAX rows) end behind the na + nb real rows.  No padded, reversed
// or concatenated copy is made: the first step reads row i < M as A[i] and
// row i >= M as B[2 M - 1 - i], or as a pad where that index lies outside
// its run.
//   2 M <= tile: `merge_small`, one block, every step in shared memory.
//   otherwise:   `first_pass` (the step M) writes the work buffer of 2 M
//                rows, one `cross_pass` per stride M / 2 ... tile follows in
//                place, and one `intile_pass` writes the first na + nb rows
//                to the output, skipping the tiles that hold only pads.
// A and B are only read.
//
// What bounds it on the H100: device memory traffic, 1 + log2(2 M / tile)
// passes over 2 M rows where one read and one write of na + nb rows is the
// least (the merge-path kernel B3 makes that one pass), see bitonic.cuh.

#include "bitonic.cuh"

namespace cbl {
namespace {

// Row i of the bitonic sequence, read from A or B.
template <int C>
__device__ __forceinline__ void sequence_row(const Keys<C>& a, long long na,
                                             const Keys<C>& b, long long nb,
                                             long long M, long long i,
                                             long long (&row)[C]) {
  const bool from_a = i < M;
  const long long at = from_a ? i : 2 * M - 1 - i;
  const bool real = at < (from_a ? na : nb);
#pragma unroll
  for (int c = 0; c < C; ++c)
    row[c] = real ? (from_a ? a.p[c][at] : b.p[c][at]) : kBitonicPad;
}

template <int C>
__global__ void merge_small(Keys<C> a, long long na, Keys<C> b, long long nb,
                            int M, MutKeys<C> out) {
  extern __shared__ long long tile_s[];
  for (int r = threadIdx.x; r < 2 * M; r += kBitonicThreads) {
    long long row[C];
    sequence_row<C>(a, na, b, nb, M, r, row);
#pragma unroll
    for (int c = 0; c < C; ++c) tile_s[c * kBitonicTile + r] = row[c];
  }
  __syncthreads();
  shared_steps<C>(tile_s, 2 * M, M, true);
  store_tile<C>(tile_s, out, na + nb);
}

// The step M: pair (t, t + M) for t < M, into the work buffer.
template <int C>
__global__ void first_pass(Keys<C> a, long long na, Keys<C> b, long long nb,
                           long long M, MutKeys<C> w) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= M) return;
  long long x[C], y[C];
  sequence_row<C>(a, na, b, nb, M, t, x);
  sequence_row<C>(a, na, b, nb, M, t + M, y);
  const bool swap = row_gt<C>(x, y);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    w.p[c][t] = swap ? y[c] : x[c];
    w.p[c][t + M] = swap ? x[c] : y[c];
  }
}

template <int C>
int bitonic_merge(const void* const* a_in, long long na,
                  const void* const* b_in, long long nb, void* const* out,
                  void* const* work, long long work_rows, cudaStream_t s) {
  Keys<C> a, b;
  MutKeys<C> dst, w;
  for (int c = 0; c < C; ++c) {
    a.p[c] = (const long long*)a_in[c];
    b.p[c] = (const long long*)b_in[c];
    dst.p[c] = (long long*)out[c];
    w.p[c] = (long long*)work[c];
  }
  const long long longer = na > nb ? na : nb;
  int m_log = 0;
  while ((1LL << m_log) < longer) ++m_log;
  const long long M = 1LL << m_log;
  if (2 * M <= kBitonicTile) {
    cudaError_t err = allow_tile_smem(merge_small<C>, tile_smem_bytes<C>());
    if (err != cudaSuccess) return (int)err;
    merge_small<C><<<1, kBitonicThreads, tile_smem_bytes<C>(), s>>>(
        a, na, b, nb, (int)M, dst);
    return (int)cudaGetLastError();
  }
  if (work_rows < 2 * M) return (int)cudaErrorInvalidValue;
  const long long blocks = (M + kCrossThreads - 1) / kCrossThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  first_pass<C><<<(unsigned)blocks, kCrossThreads, 0, s>>>(a, na, b, nb, M, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int j_log = m_log - 1; j_log >= kBitonicTileLog; --j_log) {
    err = launch_cross<C>(w, 2 * M, 1LL << j_log, -1, s);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n = na + nb;
  const long long out_tiles = (n + kBitonicTile - 1) / kBitonicTile;
  return (int)launch_intile<C>(w, 2 * M, dst, n, out_tiles, -1, s);
}

}  // namespace
}  // namespace cbl

// a0/b0/out0/work0 are column 0; a1/b1/out1/work1 column 1, or all four
// null for one-column rows.  na + nb >= 1.  `work` is scratch of
// `work_rows` rows a column, at least twice the next power of two of
// max(na, nb) when that exceeds 4096 (else unused).
extern "C" int cbl_bitonic_merge(const void* a0, const void* a1, long long na,
                                 const void* b0, const void* b1, long long nb,
                                 void* out0, void* out1, void* work0,
                                 void* work1, long long work_rows,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* a[2] = {a0, a1};
  const void* b[2] = {b0, b1};
  void* out[2] = {out0, out1};
  void* work[2] = {work0, work1};
  if (na < 0 || nb < 0 || na + nb < 1) return (int)cudaErrorInvalidValue;
  if (out1 == nullptr)
    return cbl::bitonic_merge<1>(a, na, b, nb, out, work, work_rows, s);
  return cbl::bitonic_merge<2>(a, na, b, nb, out, work, work_rows, s);
}
