// Kernel B6: full sort of int64 key rows by the bitonic network.
//
// Replaces the TPU kernel cbl_tpu/ops/sort_pallas.py `sort_cols_pallas`
// (`_tilesort_call`, `_cross_call`, `_intile_call`).  Rows of one or two
// int64 columns are sorted ascending, lexicographically with column 0 major;
// the result equals a stable library sort, since equal rows are identical.
//
// The n input rows are padded to P rows, P = max(tile, next power of two),
// with INT64_MAX rows that live only in the work buffer (the descending
// halves of the network carry pads to the front of their blocks, so they
// cannot be left out of it, and no pass but the very last may skip a block
// of pads) and are never written to the output:
//   1. `tile_sort`: each block loads one tile into shared memory and runs
//      all stages k <= tile there (`tile_network`); the last of them takes
//      its direction from the tile's global index, so tiles come out
//      ascending and descending in turn.  One tile (n <= tile) goes straight
//      to the output.
//   2. for each stage k = 2 tile ... P, with d = log2(k / tile) strides at or
//      above the tile: ceil(d / kFuseLog) `cross_fused` passes, then one
//      `intile_pass` for the strides below.  The last stage is ascending
//      everywhere; its in-tile pass writes the first n rows to the output
//      and skips the tiles that hold only pads.
// The input is only read.
//
// What bounds it on the H100: the network itself.  The least traffic is one
// read and one write of every row; this schedule makes
// 1 + sum_{d=1}^{log2(P / tile)} (ceil(d / kFuseLog) + 1) passes over all P
// rows (28 at P = 2^25 with one column: tile 2^13, nine strides a cross
// pass), each carrying 9 to 13 steps through shared memory and registers
// (bitonic.cuh).  The n / 2 * p (p + 1) / 2 compare-exchanges of the
// network (5.45e9 at 2^25 keys) remain, which a radix sort does not pay.

#include "bitonic.cuh"

namespace cbl {
namespace {

template <int C>
__global__ void __launch_bounds__(kBitonicThreads)
tile_sort(Keys<C> in, long long n, MutKeys<C> out, long long n_out) {
  extern __shared__ long long tile_s[];
  load_tile<C>(tile_s, in, n);
  tile_network<C>(tile_s, (long long)blockIdx.x * kTileRows<C>);
  store_tile<C>(tile_s, out, n_out);
}

template <int C>
int bitonic_sort(const void* const* in, void* const* out, void* const* work,
                 long long work_rows, long long n, cudaStream_t s,
                 int* passes) {
  constexpr int T = kTileRows<C>;
  Keys<C> src;
  MutKeys<C> dst, w;
  for (int c = 0; c < C; ++c) {
    src.p[c] = (const long long*)in[c];
    dst.p[c] = (long long*)out[c];
    w.p[c] = (long long*)work[c];
  }
  int p_log = kTileLog<C>;
  while ((1LL << p_log) < n) ++p_log;
  const long long P = 1LL << p_log;
  cudaError_t err = allow_tile_smem(tile_sort<C>, tile_smem_bytes<C>());
  if (err != cudaSuccess) return (int)err;
  *passes = 1;
  if (P == T) {
    tile_sort<C><<<1, kBitonicThreads, tile_smem_bytes<C>(), s>>>(src, n, dst,
                                                                 n);
    return (int)cudaGetLastError();
  }
  if (work_rows < P) return (int)cudaErrorInvalidValue;
  const long long tiles = P / T;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tile_sort<C><<<(unsigned)tiles, kBitonicThreads, tile_smem_bytes<C>(), s>>>(
      src, n, w, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int k_log = kTileLog<C> + 1; k_log <= p_log; ++k_log) {
    err = launch_cross<C>(w, P, k_log - 1, k_log, s, passes);
    if (err != cudaSuccess) return (int)err;
    if (k_log < p_log) {
      err = launch_intile<C>(w, P, w, P, tiles, k_log, s, passes);
    } else {
      const long long out_tiles = (n + T - 1) / T;
      err = launch_intile<C>(w, P, dst, n, out_tiles, k_log, s, passes);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace
}  // namespace cbl

// in0/out0/work0 are column 0; in1/out1/work1 column 1, or all three null
// for one-column rows.  n >= 1.  `work` is scratch of `work_rows` rows a
// column, at least the next power of two of n when n exceeds one tile (else
// unused).  `*passes` receives the number of kernels launched that read and
// write every row.
extern "C" int cbl_bitonic_sort(const void* in0, const void* in1, void* out0,
                                void* out1, void* work0, void* work1,
                                long long work_rows, long long n,
                                int* passes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* in[2] = {in0, in1};
  void* out[2] = {out0, out1};
  void* work[2] = {work0, work1};
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (out1 == nullptr)
    return cbl::bitonic_sort<1>(in, out, work, work_rows, n, s, passes);
  return cbl::bitonic_sort<2>(in, out, work, work_rows, n, s, passes);
}
