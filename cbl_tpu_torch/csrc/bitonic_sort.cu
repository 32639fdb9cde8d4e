// Kernel B6: full sort of int64 key rows by the bitonic network.
//
// Replaces the TPU kernel cbl_tpu/ops/sort_pallas.py `sort_cols_pallas`
// (`_tilesort_call`, `_cross_call`, `_intile_call`).  Rows of one to three
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
// Three columns (PR 17), `bitonic_sort_keyed`, the same network and the
// same compare-exchanges, in two ways cheaper:
//   - the steps move each row as (column 0, its row in the tile): an
//     exchange moves three 32-bit words instead of six, a round of steps
//     loads and stores 10 bytes a row instead of 24.  Columns 1 and 2 stay
//     where the load put them in shared memory; where two columns 0 tie
//     the exchange reads them there, and the store writes them in the
//     order the tile rows name.  At most 64 registers a thread, two blocks
//     an SM (109 KB of shared memory each); PR 10's form took 90-97, one
//     block an SM, so no block's loads overlapped another's network.
//   - the passes run chunk by chunk where they can (`kChunkLog`): every
//     stage up to 2^20 rows (24 MB of three columns), and in each later
//     stage the strides below 2^20, for one chunk after another, all of a
//     chunk's passes before its next; only the strides at or above 2^20 go
//     through device memory as whole-array passes.  At 2^25 rows: 11 passes
//     through device memory (32 before), as the C entry point counts them:
//     one for each run of chunk passes, one for each whole-array pass.  A
//     chunk's launch fills the card in one wave, so its blocks load,
//     exchange and store in step; kChunkStreams chunks run at once on side
//     streams, forked from and joined back to the caller's stream, so that
//     one chunk's loads overlap another's network.
// Measured at 2^25 rows of the K=59 sort-join's queries (NVIDIA H100 80GB
// HBM3, 700 W): PR 10's form 32.2 ms; keyed with columns 1 and 2 read from
// global memory on ties and gathered at the store 25.2; with them in shared
// memory 22.3; with two side streams 20.3 (2^19-row chunks and two streams,
// 13 passes through device memory, 21.8); three streams 19.7.  Three stable
// torch.sort passes take 18.1: this form still loses to them.  Rounds of
// four strides on 256-thread blocks ran 22.4.
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

// --- three columns: the network on (column 0, tile row) pairs -------------

constexpr int kKeyedT = kTileRows<3>;  // 4096 rows, as at one and two columns
constexpr int kKeyedLog = kTileLog<3>;
constexpr int kKeyedFuse = kFuseLog<3>;  // 8
// Rows of a chunk: its passes run one chunk after another, kChunkStreams
// chunks at a time on streams of their own.  = ops/bitonic.py CHUNKS[3]
constexpr int kChunkLog = 20;
constexpr int kChunkStreams = 3;
static_assert(kKeyedT <= 65536, "tile rows are 16-bit");

// The block's shared memory: column 0 padded as `phys` pads; columns 1 and
// 2 by tile row, as loaded; the tile rows as 16-bit indices, padded.
// 109 KB, two blocks an SM.
struct KeyedTile {
  long long* key;
  long long* rest1;
  long long* rest2;
  unsigned short* idx;
};
constexpr int kKeyedSmem =
    kColSlots<3> * (int)(sizeof(long long) + sizeof(unsigned short)) +
    2 * kKeyedT * (int)sizeof(long long);

__device__ __forceinline__ KeyedTile keyed_tile() {
  extern __shared__ long long tile_s[];
  KeyedTile t;
  t.key = tile_s;
  t.rest1 = tile_s + kColSlots<3>;
  t.rest2 = t.rest1 + kKeyedT;
  t.idx = reinterpret_cast<unsigned short*>(t.rest2 + kKeyedT);
  return t;
}

// Where tile row i of a block lies in the pass's source: global row
// first + ((i >> c_log) << a_log) + (i & (2^c_log - 1)).  A contiguous tile
// has c_log = kKeyedLog.
struct TileMap {
  long long first;
  int c_log;
  int a_log;
};

__device__ __forceinline__ long long map_row(const TileMap& m, int i) {
  return m.first + ((long long)(i >> m.c_log) << m.a_log) +
         (i & ((1 << m.c_log) - 1));
}

// Row (kx, tile row ix) > row (ky, iy): column 0, then columns 1 and 2.
__device__ __forceinline__ bool keyed_gt(long long kx, int ix, long long ky,
                                         int iy, const KeyedTile& t) {
  if (kx != ky) return kx > ky;
  const long long x1 = t.rest1[ix], y1 = t.rest1[iy];
  if (x1 != y1) return x1 > y1;
  return t.rest2[ix] > t.rest2[iy];
}

// Order the pair (q, o) of a group held in registers.
__device__ __forceinline__ void keyed_exchange(long long& kq, int& iq,
                                               long long& ko, int& io,
                                               bool asc, const KeyedTile& t) {
  // a descending pair of equal rows swaps too, which changes no value
  const bool swap = keyed_gt(kq, iq, ko, io, t) == asc;
  const long long k = swap ? ko : kq;
  ko = swap ? kq : ko;
  kq = k;
  const int i = swap ? io : iq;
  io = swap ? iq : io;
  iq = i;
}

// `shared_round` on (column 0, tile row) pairs.
template <int R>
__device__ __forceinline__ void keyed_round(const KeyedTile& t, int s,
                                            long long row0, int dir_bit) {
  constexpr int G = 1 << R;
  for (int g = threadIdx.x; g < (kKeyedT >> R); g += kBitonicThreads) {
    const int first = ((g >> s) << (s + R)) | (g & ((1 << s) - 1));
    const bool asc = ascending(row0 + first, dir_bit);
    long long k[G];
    int ix[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int p = phys(first + (q << s));
      k[q] = t.key[p];
      ix[q] = t.idx[p];
    }
#pragma unroll
    for (int b = R - 1; b >= 0; --b) {
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if ((q >> b) & 1) continue;
        const int o = q | (1 << b);
        keyed_exchange(k[q], ix[q], k[o], ix[o], asc, t);
      }
    }
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int p = phys(first + (q << s));
      t.key[p] = k[q];
      t.idx[p] = (unsigned short)ix[q];
    }
  }
}

// `shared_steps` on (column 0, tile row) pairs over the whole tile.
__device__ __forceinline__ void keyed_steps(const KeyedTile& t, int hi_log,
                                            int lo_log, long long row0,
                                            int dir_bit) {
  static_assert(kRoundLog == 3, "the short rounds below are written for 3");
  const int first = (hi_log - lo_log + 1) % kRoundLog;
  if (first == 1) {
    keyed_round<1>(t, hi_log, row0, dir_bit);
    __syncthreads();
  } else if (first == 2) {
    keyed_round<2>(t, hi_log - 1, row0, dir_bit);
    __syncthreads();
  }
  for (int s = hi_log - first - (kRoundLog - 1); s >= lo_log; s -= kRoundLog) {
    keyed_round<kRoundLog>(t, s, row0, dir_bit);
    __syncthreads();
  }
}

// Tile rows [0, T) from rows map(r) of the pass's source (pads at or beyond
// n) into shared memory.  Ends on a barrier.
__device__ __forceinline__ void keyed_load(const KeyedTile& t,
                                           const Keys<3>& src,
                                           const TileMap& m, long long n) {
#pragma unroll 4
  for (int r = threadIdx.x; r < kKeyedT; r += kBitonicThreads) {
    const long long row = map_row(m, r);
    const bool in = row < n;
    t.key[phys(r)] = in ? src.p[0][row] : kBitonicPad;
    t.rest1[r] = in ? src.p[1][row] : kBitonicPad;
    t.rest2[r] = in ? src.p[2][row] : kBitonicPad;
    t.idx[phys(r)] = (unsigned short)r;
  }
  __syncthreads();
}

// The tile back to rows map(r) of dst below n_dst: column 0 as it stands,
// columns 1 and 2 of the tile rows it names.  Every source row was read at
// the load, so dst may be the source.
__device__ __forceinline__ void keyed_store(const KeyedTile& t,
                                            const TileMap& m,
                                            const MutKeys<3>& dst,
                                            long long n_dst) {
#pragma unroll 4
  for (int r = threadIdx.x; r < kKeyedT; r += kBitonicThreads) {
    const long long row = map_row(m, r);
    if (row < n_dst) {
      const int i = t.idx[phys(r)];
      dst.p[0][row] = t.key[phys(r)];
      dst.p[1][row] = t.rest1[i];
      dst.p[2][row] = t.rest2[i];
    }
  }
}

// `tile_sort` at three columns: tile tile0 + blockIdx.x of `in`, every
// stage k <= T.
__global__ void __launch_bounds__(kBitonicThreads, 2)
keyed_tile_sort(Keys<3> in, long long n, MutKeys<3> out, long long n_out,
                long long tile0) {
  const KeyedTile t = keyed_tile();
  const long long base = (tile0 + blockIdx.x) * kKeyedT;
  const TileMap m{base, kKeyedLog, 0};
  keyed_load(t, in, m, n);
  // stages 2, 4, 8 on a thread's eight contiguous rows, in registers
  for (int g = threadIdx.x; g < kKeyedT / 8; g += kBitonicThreads) {
    long long k[8];
    int ix[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      k[q] = t.key[phys(8 * g + q)];
      ix[q] = t.idx[phys(8 * g + q)];
    }
#pragma unroll
    for (int k_log = 1; k_log <= 3; ++k_log) {
#pragma unroll
      for (int b = k_log - 1; b >= 0; --b) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if ((q >> b) & 1) continue;
          const bool asc = (((8 * g + q) >> k_log) & 1) == 0;
          keyed_exchange(k[q], ix[q], k[q | (1 << b)], ix[q | (1 << b)], asc,
                         t);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      t.key[phys(8 * g + q)] = k[q];
      t.idx[phys(8 * g + q)] = (unsigned short)ix[q];
    }
  }
  __syncthreads();
  for (int k_log = 4; k_log <= kKeyedLog; ++k_log)
    keyed_steps(t, k_log - 1, 0, base, k_log);
  keyed_store(t, m, out, n_out);
}

// `intile_pass` at three columns: tile tile0 + blockIdx.x of `src` (n_src
// rows present), the strides T / 2 ... 1; rows below n_dst go to `dst`,
// which may be `src`.
__global__ void __launch_bounds__(kBitonicThreads, 2)
keyed_intile(Keys<3> src, long long n_src, MutKeys<3> dst, long long n_dst,
             int dir_bit, long long tile0) {
  const KeyedTile t = keyed_tile();
  const long long base = (tile0 + blockIdx.x) * kKeyedT;
  const TileMap m{base, kKeyedLog, 0};
  keyed_load(t, src, m, n_src);
  keyed_steps(t, kKeyedLog - 1, 0, base, dir_bit);
  keyed_store(t, m, dst, n_dst);
}

// `cross_fused` at three columns: block block0 + blockIdx.x of the work
// buffer, the f strides 2^(a_log+f-1) ... 2^a_log, in place (the rows of
// the block as `cross_fused` maps them).
__global__ void __launch_bounds__(kBitonicThreads, 2)
keyed_cross(MutKeys<3> w, int a_log, int f, int dir_bit, long long block0) {
  const KeyedTile t = keyed_tile();
  const int c_log = kKeyedLog - f;
  const long long b = block0 + blockIdx.x;
  const long long mid = b & ((1LL << (a_log - c_log)) - 1);
  const long long hi = b >> (a_log - c_log);
  const long long first = (hi << (a_log + f)) | (mid << c_log);
  const long long all = 0x7fffffffffffffffLL;  // every row is present
  const TileMap m{first, c_log, a_log};
  keyed_load(t, as_const<3>(w), m, all);
  // one direction for the block: `dir_bit` lies above a_log + f
  keyed_steps(t, kKeyedLog - 1, c_log, first, dir_bit);
  keyed_store(t, m, w, all);
}

// The steps with strides 2^hi_log ... 2^lo_log (all >= the tile) of the
// stage with `dir_bit` over `blocks` blocks from block0, kKeyedFuse strides
// a launch, a shorter launch first.
cudaError_t keyed_cross_launches(const MutKeys<3>& w, long long block0,
                                 long long blocks, int hi_log, int lo_log,
                                 int dir_bit, cudaStream_t s) {
  int left = hi_log - lo_log + 1;
  while (left > 0) {
    const int f = left % kKeyedFuse ? left % kKeyedFuse : kKeyedFuse;
    keyed_cross<<<(unsigned)blocks, kBitonicThreads, kKeyedSmem, s>>>(
        w, lo_log + left - f, f, dir_bit, block0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    left -= f;
  }
  return cudaSuccess;
}

// The side streams of the chunk passes on the current device, and the
// events that fork them from, and join them back to, the caller's stream;
// made at first use.
struct ChunkStreams {
  cudaStream_t side[kChunkStreams];
  cudaEvent_t fork;
  cudaEvent_t join[kChunkStreams];
};

cudaError_t chunk_streams(ChunkStreams** out) {
  constexpr int kDevices = 64;
  static ChunkStreams all[kDevices];
  static bool made[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
  ChunkStreams& cs = all[dev];
  if (!made[dev]) {
    for (int i = 0; i < kChunkStreams && err == cudaSuccess; ++i)
      err = cudaStreamCreateWithFlags(&cs.side[i], cudaStreamNonBlocking);
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&cs.fork, cudaEventDisableTiming);
    for (int i = 0; i < kChunkStreams && err == cudaSuccess; ++i)
      err = cudaEventCreateWithFlags(&cs.join[i], cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
    made[dev] = true;
  }
  *out = &cs;
  return cudaSuccess;
}

// Every side stream waits for the work enqueued so far on s.
cudaError_t fork_chunks(ChunkStreams& cs, cudaStream_t s) {
  cudaError_t err = cudaEventRecord(cs.fork, s);
  for (int i = 0; i < kChunkStreams && err == cudaSuccess; ++i)
    err = cudaStreamWaitEvent(cs.side[i], cs.fork, 0);
  return err;
}

// s waits for the work enqueued so far on every side stream.
cudaError_t join_chunks(ChunkStreams& cs, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < kChunkStreams && err == cudaSuccess; ++i) {
    err = cudaEventRecord(cs.join[i], cs.side[i]);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(s, cs.join[i], 0);
  }
  return err;
}

// Three columns.  = ops/bitonic.py `network_passes(P, 4096, 8, 2^20)`
int bitonic_sort_keyed(const void* const* in, void* const* out,
                       void* const* work, long long work_rows, long long n,
                       cudaStream_t s, int* passes) {
  Keys<3> src;
  MutKeys<3> dst, w;
  for (int c = 0; c < 3; ++c) {
    src.p[c] = (const long long*)in[c];
    dst.p[c] = (long long*)out[c];
    w.p[c] = (long long*)work[c];
  }
  int p_log = kKeyedLog;
  while ((1LL << p_log) < n) ++p_log;
  const long long P = 1LL << p_log;
  cudaError_t err = allow_tile_smem(keyed_tile_sort, kKeyedSmem);
  if (err == cudaSuccess) err = allow_tile_smem(keyed_intile, kKeyedSmem);
  if (err == cudaSuccess) err = allow_tile_smem(keyed_cross, kKeyedSmem);
  if (err != cudaSuccess) return (int)err;
  *passes = 1;
  if (P == kKeyedT) {
    keyed_tile_sort<<<1, kBitonicThreads, kKeyedSmem, s>>>(src, n, dst, n, 0);
    return (int)cudaGetLastError();
  }
  if (work_rows < P) return (int)cudaErrorInvalidValue;
  if ((P >> kKeyedLog) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int chunk_log = p_log < kChunkLog ? p_log : kChunkLog;
  const long long chunk_tiles = 1LL << (chunk_log - kKeyedLog);
  const long long chunks = P >> chunk_log;
  const Keys<3> wk = as_const<3>(w);
  ChunkStreams* cs = nullptr;
  err = chunk_streams(&cs);
  if (err != cudaSuccess) return (int)err;
  // the in-tile pass of stage k_log over chunk q on stream cs; the last
  // stage writes the output
  auto intile = [&](int k_log, long long q, cudaStream_t cq) {
    const bool last = k_log == p_log;
    keyed_intile<<<(unsigned)chunk_tiles, kBitonicThreads, kKeyedSmem, cq>>>(
        wk, P, last ? dst : w, last ? n : P, k_log, q * chunk_tiles);
    return cudaGetLastError();
  };
  // every stage up to the chunk, chunk by chunk
  err = fork_chunks(*cs, s);
  if (err != cudaSuccess) return (int)err;
  for (long long q = 0; q < chunks; ++q) {
    const cudaStream_t cq = cs->side[q % kChunkStreams];
    keyed_tile_sort<<<(unsigned)chunk_tiles, kBitonicThreads, kKeyedSmem,
                      cq>>>(src, n, w, P, q * chunk_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int k_log = kKeyedLog + 1; k_log <= chunk_log; ++k_log) {
      err = keyed_cross_launches(w, q * chunk_tiles, chunk_tiles, k_log - 1,
                                 kKeyedLog, k_log, cq);
      if (err == cudaSuccess) err = intile(k_log, q, cq);
      if (err != cudaSuccess) return (int)err;
    }
  }
  err = join_chunks(*cs, s);
  if (err != cudaSuccess) return (int)err;
  // each later stage: the strides >= the chunk over the whole array, then
  // the rest chunk by chunk
  for (int k_log = chunk_log + 1; k_log <= p_log; ++k_log) {
    int left = k_log - chunk_log;
    while (left > 0) {  // as `keyed_cross_launches`, one pass a launch
      const int f = left % kKeyedFuse ? left % kKeyedFuse : kKeyedFuse;
      keyed_cross<<<(unsigned)(P >> kKeyedLog), kBitonicThreads, kKeyedSmem,
                    s>>>(w, chunk_log + left - f, f, k_log, 0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      ++*passes;
      left -= f;
    }
    err = fork_chunks(*cs, s);
    if (err != cudaSuccess) return (int)err;
    for (long long q = 0; q < chunks; ++q) {
      const cudaStream_t cq = cs->side[q % kChunkStreams];
      err = keyed_cross_launches(w, q * chunk_tiles, chunk_tiles,
                                 chunk_log - 1, kKeyedLog, k_log, cq);
      if (err == cudaSuccess) err = intile(k_log, q, cq);
      if (err != cudaSuccess) return (int)err;
    }
    err = join_chunks(*cs, s);
    if (err != cudaSuccess) return (int)err;
    ++*passes;
  }
  return (int)cudaSuccess;
}

}  // namespace
}  // namespace cbl

// in, out and work are C-element arrays of column pointers (C = 1 to 3).
// n >= 1.  `work` is scratch of `work_rows` rows a column, at least the
// next power of two of n when n exceeds one tile (else unused, and may hold
// nulls).  `*passes` receives the number of kernels launched that read and
// write every row.
extern "C" int cbl_bitonic_sort(const void* const* in, void* const* out,
                                void* const* work, int C, long long work_rows,
                                long long n, int* passes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 1:
      return cbl::bitonic_sort<1>(in, out, work, work_rows, n, s, passes);
    case 2:
      return cbl::bitonic_sort<2>(in, out, work, work_rows, n, s, passes);
    case 3:
      return cbl::bitonic_sort_keyed(in, out, work, work_rows, n, s, passes);
  }
  return (int)cudaErrorInvalidValue;
}
