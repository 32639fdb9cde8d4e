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
// cannot be left out of it) and are never written to the output:
//   1. `tile_sort`: each block loads one tile into shared memory and runs
//      all stages k <= tile there; the last of them takes its direction from
//      the tile's global index, so tiles come out ascending and descending
//      in turn.  One tile (n <= tile) goes straight to the output.
//   2. for each stage k = 2 tile ... P: one `cross_pass` per stride
//      j = k / 2 ... tile, then one `intile_pass` for the strides below.
//      The last stage is ascending everywhere; its in-tile pass writes the
//      first n rows to the output and skips the tiles that hold only pads.
// The input is only read.
//
// What bounds it on the H100: device memory traffic.  The least is one read
// and one write of every row; this network makes about
// 1 + sum_{d=1}^{log2(P / tile)} (d + 1) passes over all P rows (105 at
// P = 2^25), see bitonic.cuh.

#include "bitonic.cuh"

namespace cbl {
namespace {

template <int C>
__global__ void tile_sort(Keys<C> in, long long n, MutKeys<C> out,
                          long long n_out) {
  extern __shared__ long long tile_s[];
  load_tile<C>(tile_s, in, n);
  for (int k_log = 1; k_log < kBitonicTileLog; ++k_log) {
    const int k = 1 << k_log;
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < kBitonicTile / 2; t += kBitonicThreads) {
        const int lo = (int)pair_low(t, j);
        exchange_shared<C>(tile_s, lo, lo | j, (lo & k) == 0);
      }
      __syncthreads();
    }
  }
  // stage k = tile: bit kBitonicTileLog of the global index
  shared_steps<C>(tile_s, kBitonicTile, kBitonicTile / 2,
                  (blockIdx.x & 1) == 0);
  store_tile<C>(tile_s, out, n_out);
}

template <int C>
int bitonic_sort(const void* const* in, void* const* out, void* const* work,
                 long long work_rows, long long n, cudaStream_t s) {
  Keys<C> src;
  MutKeys<C> dst, w;
  for (int c = 0; c < C; ++c) {
    src.p[c] = (const long long*)in[c];
    dst.p[c] = (long long*)out[c];
    w.p[c] = (long long*)work[c];
  }
  int p_log = kBitonicTileLog;
  while ((1LL << p_log) < n) ++p_log;
  const long long P = 1LL << p_log;
  cudaError_t err = allow_tile_smem(tile_sort<C>, tile_smem_bytes<C>());
  if (err != cudaSuccess) return (int)err;
  if (P == kBitonicTile) {
    tile_sort<C><<<1, kBitonicThreads, tile_smem_bytes<C>(), s>>>(src, n, dst,
                                                                 n);
    return (int)cudaGetLastError();
  }
  if (work_rows < P) return (int)cudaErrorInvalidValue;
  const long long tiles = P / kBitonicTile;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tile_sort<C><<<(unsigned)tiles, kBitonicThreads, tile_smem_bytes<C>(), s>>>(
      src, n, w, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int k_log = kBitonicTileLog + 1; k_log <= p_log; ++k_log) {
    for (int j_log = k_log - 1; j_log >= kBitonicTileLog; --j_log) {
      err = launch_cross<C>(w, P, 1LL << j_log, k_log, s);
      if (err != cudaSuccess) return (int)err;
    }
    if (k_log < p_log) {
      err = launch_intile<C>(w, P, w, P, tiles, k_log, s);
    } else {
      const long long out_tiles = (n + kBitonicTile - 1) / kBitonicTile;
      err = launch_intile<C>(w, P, dst, n, out_tiles, k_log, s);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace
}  // namespace cbl

// in0/out0/work0 are column 0; in1/out1/work1 column 1, or all three null
// for one-column rows.  n >= 1.  `work` is scratch of `work_rows` rows a
// column, at least the next power of two of n when n > 4096 (else unused).
extern "C" int cbl_bitonic_sort(const void* in0, const void* in1, void* out0,
                                void* out1, void* work0, void* work1,
                                long long work_rows, long long n,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* in[2] = {in0, in1};
  void* out[2] = {out0, out1};
  void* work[2] = {work0, work1};
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (out1 == nullptr)
    return cbl::bitonic_sort<1>(in, out, work, work_rows, n, s);
  return cbl::bitonic_sort<2>(in, out, work, work_rows, n, s);
}
