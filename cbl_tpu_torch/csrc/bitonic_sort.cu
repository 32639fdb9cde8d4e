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
// cannot be left out of it) and are never written to the output.  The
// network (bitonic.cuh) runs in three kinds of launch:
//   - `keyed_tile_sort`: each block loads one tile (2^13 rows of one
//     column, 2^12 of two or three) into shared memory and runs all stages
//     k <= tile there; the last of them takes its direction from the tile's
//     global index, so tiles come out ascending and descending in turn.
//     One tile (n <= tile) goes straight to the output.
//   - `keyed_cross`: up to kFuseLog consecutive strides 2^(a+f-1) ... 2^a,
//     all >= the tile, of one stage in ONE pass: a block owns 2^f slices of
//     2^c contiguous rows, 2^a rows apart, 2^(f+c) = tile (c >= 4), runs
//     the f steps in shared memory, one direction for the whole block, and
//     writes the slices back in place.  The block owns every row it
//     touches, which is what makes that safe.
//   - `keyed_intile`: the strides tile / 2 ... 1 of one stage, one block a
//     tile; the last stage writes the first n rows to the output and skips
//     the tiles that hold only pads.
// Every block runs its steps in rounds of kRoundLog strides held in
// registers, a barrier between rounds (`keyed_round`).
//
// Two things set it apart from the earlier form that ran every pass over
// the whole array, a launch each:
//   - the steps move each row as (column 0, its row in the tile): at two
//     columns an exchange moves a 64- and a 16-bit word instead of two
//     64-bit ones, a round loads and stores 10 bytes a row instead of 16
//     (24 at three).  The other columns stay where the load put them in
//     shared memory; where two columns 0 tie the exchange reads them
//     there, and the store writes them in the order the tile rows name.
//     At one column the key is the row and nothing else moves.
//   - the passes run chunk by chunk where they can (kChunkLog: 2^21 rows
//     of one column, 2^20 of two or three, 16-24 MB): every stage up to
//     the chunk, and in each later stage the strides below the chunk, for
//     one chunk after another, all of a chunk's passes before its next; only
//     the strides at or above the chunk go through device memory as
//     whole-array passes.  The C entry point counts one pass through device
//     memory for each run of chunk passes and one for each whole-array
//     pass: at 2^25 rows 9 at one column (28 with every pass over the
//     whole array), 11 at two and three (32).  A chunk's launch fills the
//     card in one wave; kStreams chunks run at once on side streams,
//     forked from and joined back to the caller's stream, so that one
//     chunk's loads overlap another's network.
// Measured (NVIDIA H100 80GB HBM3, 700 W), the whole-array form in
// brackets: 2^25 one-column keys 7.0 ms (6.9), 2^22 + 2^21 two-column rows
// 3.3 (4.1), the sort-join's 2^25 two-column rows 14.8 (18.8); at three
// columns, 2^25 rows of the K=59 sort-join's queries, 19.7-19.9 (32.2;
// keyed with columns 1 and 2 read from global memory on ties 25.2, in
// shared memory 22.3, two side streams 20.3, three 19.7).
// Every form still loses to the library: one stable torch.sort a column
// takes 4.2, 2.0, 9.4 and (three) 18.1 ms.  Tried at one and two columns
// and dropped: every chunk's passes in one cooperative launch with a grid
// barrier between passes (8.6-9.7 ms at one column), tiles of 2^11 and 2^12
// rows on 128 and 256 threads (8.2, 7.9), chunks of 2^20 and 2^22 rows
// (8.8, 7.2), one, three or four streams (8.9, 7.5, 7.3), 16-byte loads of
// row pairs (no gain; at three columns 4 % slower).
//
// What bounds it on the H100: the network itself.  The least traffic is one
// read and one write of every row; the n / 2 * p (p + 1) / 2
// compare-exchanges of the network (5.45e9 at 2^25 keys, p = 25) remain,
// each a 64-bit compare and two selects, which a radix sort does not pay,
// and so do the barriers of its rounds in shared memory.  At one column a
// pass is bound by these, not by device memory (whole-array passes
// took 0.22 ms each, against 0.16 for the bytes), so chunks held in the L2
// cache save little there; its ~400 chunk launches of one wave each, whose
// blocks load, exchange and store in step, cost what the memory saved.

#include "bitonic.cuh"

namespace cbl {
namespace {

template <int C>
constexpr int kKeyedLog = kTileLog<C>;  // 13 at one column, 12 at two, three
template <int C>
constexpr int kKeyedT = 1 << kKeyedLog<C>;
template <int C>
constexpr int kKeyedFuse = kFuseLog<C>;  // 9 at one column, 8 at two, three
// Rows of a chunk: its passes run one chunk after another, kStreams
// chunks at a time on streams of their own.  = ops/bitonic.py CHUNKS
template <int C>
constexpr int kChunkLog = C == 1 ? 21 : 20;
constexpr int kChunkStreams = 3;  // side streams made
// Side streams the chunks of C columns take turns on: two at one and two
// columns (7.02 against 7.45 ms with three for 2^25 keys; NVIDIA H100 80GB
// HBM3, 700 W), three at three.
template <int C>
constexpr int kStreams = C == 3 ? 3 : 2;
static_assert(kStreams<1> <= kChunkStreams && kStreams<2> <= kChunkStreams &&
                  kStreams<3> <= kChunkStreams,
              "more streams than made");
// Blocks an SM: registers (64 a thread) and shared memory are held to two.
// Three at one column (40 registers) spilled and ran 8.1 against 7.4 ms
// for 2^25 keys; rounds of four strides 8.1 (NVIDIA H100 80GB HBM3, 700 W).
constexpr int kKeyedBlocks = 2;
static_assert(kKeyedT<2> <= 65536 && kKeyedT<3> <= 65536,
              "tile rows are 16-bit");

// The block's shared memory: column 0 padded as `phys` pads; the other
// columns by tile row, as loaded; the tile rows as 16-bit indices, padded.
// 72 KB at one column, 77 KB at two, 109 KB at three.
template <int C>
struct KeyedTile {
  long long* key;
  long long* rest[C > 1 ? C - 1 : 1];
  unsigned short* idx;  // C > 1
};

template <int C>
constexpr int kKeyedSmem =
    kColSlots<C> * (int)sizeof(long long) +
    (C > 1 ? kColSlots<C> * (int)sizeof(unsigned short) +
                 (C - 1) * kKeyedT<C> * (int)sizeof(long long)
           : 0);
static_assert(kKeyedBlocks * kKeyedSmem<3> <= 232448,
              "the blocks of an SM exceed its shared memory");

template <int C>
__device__ __forceinline__ KeyedTile<C> keyed_tile() {
  extern __shared__ long long tile_s[];
  KeyedTile<C> t;
  t.key = tile_s;
  long long* p = tile_s + kColSlots<C>;
#pragma unroll
  for (int c = 0; c < C - 1; ++c, p += kKeyedT<C>) t.rest[c] = p;
  t.idx = reinterpret_cast<unsigned short*>(p);
  return t;
}

// Where tile row i of a block lies in the pass's source: global row
// first + ((i >> c_log) << a_log) + (i & (2^c_log - 1)).  A contiguous tile
// has c_log = the tile's log.
struct TileMap {
  long long first;
  int c_log;
  int a_log;
};

__device__ __forceinline__ long long map_row(const TileMap& m, int i) {
  return m.first + ((long long)(i >> m.c_log) << m.a_log) +
         (i & ((1 << m.c_log) - 1));
}

// Row (kx, tile row ix) > row (ky, iy): column 0, then the others.
template <int C>
__device__ __forceinline__ bool keyed_gt(long long kx, int ix, long long ky,
                                         int iy, const KeyedTile<C>& t) {
  if (kx != ky || C == 1) return kx > ky;
#pragma unroll
  for (int c = 0; c < C - 2; ++c) {
    const long long x = t.rest[c][ix], y = t.rest[c][iy];
    if (x != y) return x > y;
  }
  return t.rest[C > 1 ? C - 2 : 0][ix] > t.rest[C > 1 ? C - 2 : 0][iy];
}

// Order the pair (q, o) of a group held in registers.
template <int C>
__device__ __forceinline__ void keyed_exchange(long long& kq, int& iq,
                                               long long& ko, int& io,
                                               bool asc,
                                               const KeyedTile<C>& t) {
  // a descending pair of equal rows swaps too, which changes no value
  const bool swap = keyed_gt<C>(kq, iq, ko, io, t) == asc;
  const long long k = swap ? ko : kq;
  ko = swap ? kq : ko;
  kq = k;
  if constexpr (C > 1) {
    const int i = swap ? io : iq;
    io = swap ? iq : io;
    iq = i;
  }
}

// `shared_round` (bitonic.cuh) on (column 0, tile row) pairs: the R steps
// with strides 2^(s+R-1) ... 2^s over the whole tile.
template <int C, int R>
__device__ __forceinline__ void keyed_round(const KeyedTile<C>& t, int s,
                                            long long row0, int dir_bit) {
  constexpr int G = 1 << R;
  for (int g = threadIdx.x; g < (kKeyedT<C> >> R); g += kBitonicThreads) {
    const int first = ((g >> s) << (s + R)) | (g & ((1 << s) - 1));
    const bool asc = ascending(row0 + first, dir_bit);
    long long k[G];
    int ix[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int p = phys(first + (q << s));
      k[q] = t.key[p];
      ix[q] = C > 1 ? t.idx[p] : 0;
    }
#pragma unroll
    for (int b = R - 1; b >= 0; --b) {
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if ((q >> b) & 1) continue;
        const int o = q | (1 << b);
        keyed_exchange<C>(k[q], ix[q], k[o], ix[o], asc, t);
      }
    }
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int p = phys(first + (q << s));
      t.key[p] = k[q];
      if constexpr (C > 1) t.idx[p] = (unsigned short)ix[q];
    }
  }
}

// The round of `m` < R strides that opens `keyed_steps`, from stride
// 2^hi_log down.
template <int C, int M>
__device__ __forceinline__ void keyed_short_round(const KeyedTile<C>& t,
                                                  int m, int hi_log,
                                                  long long row0,
                                                  int dir_bit) {
  if constexpr (M >= 1) {
    if (m == M)
      keyed_round<C, M>(t, hi_log - M + 1, row0, dir_bit);
    else
      keyed_short_round<C, M - 1>(t, m, hi_log, row0, dir_bit);
  }
}

// `shared_steps` on (column 0, tile row) pairs over the whole tile: the
// strides 2^hi_log ... 2^lo_log, kRoundLog a round, a shorter round
// first.
template <int C>
__device__ __forceinline__ void keyed_steps(const KeyedTile<C>& t, int hi_log,
                                            int lo_log, long long row0,
                                            int dir_bit) {
  constexpr int R = kRoundLog;
  const int first = (hi_log - lo_log + 1) % R;
  if (first) {
    keyed_short_round<C, R - 1>(t, first, hi_log, row0, dir_bit);
    __syncthreads();
  }
  for (int s = hi_log - first - (R - 1); s >= lo_log; s -= R) {
    keyed_round<C, R>(t, s, row0, dir_bit);
    __syncthreads();
  }
}

// Tile rows [0, T) from rows map(r) of the pass's source (pads at or beyond
// n) into shared memory.  Ends on a barrier.
template <int C>
__device__ __forceinline__ void keyed_load(const KeyedTile<C>& t,
                                           const Keys<C>& src,
                                           const TileMap& m, long long n) {
#pragma unroll 4
  for (int r = threadIdx.x; r < kKeyedT<C>; r += kBitonicThreads) {
    const long long row = map_row(m, r);
    const bool in = row < n;
    t.key[phys(r)] = in ? src.p[0][row] : kBitonicPad;
#pragma unroll
    for (int c = 1; c < C; ++c)
      t.rest[c - 1][r] = in ? src.p[c][row] : kBitonicPad;
    if constexpr (C > 1) t.idx[phys(r)] = (unsigned short)r;
  }
  __syncthreads();
}

// The tile back to rows map(r) of dst below n_dst: column 0 as it stands,
// the other columns of the tile rows it names.  Every source row was read at
// the load, so dst may be the source.
template <int C>
__device__ __forceinline__ void keyed_store(const KeyedTile<C>& t,
                                            const TileMap& m,
                                            const MutKeys<C>& dst,
                                            long long n_dst) {
#pragma unroll 4
  for (int r = threadIdx.x; r < kKeyedT<C>; r += kBitonicThreads) {
    const long long row = map_row(m, r);
    if (row < n_dst) {
      dst.p[0][row] = t.key[phys(r)];
      if constexpr (C > 1) {
        const int i = t.idx[phys(r)];
#pragma unroll
        for (int c = 1; c < C; ++c) dst.p[c][row] = t.rest[c - 1][i];
      }
    }
  }
}

// Tile tile0 + blockIdx.x of `in`, every stage k <= T.
template <int C>
__global__ void __launch_bounds__(kBitonicThreads, kKeyedBlocks)
keyed_tile_sort(Keys<C> in, long long n, MutKeys<C> out, long long n_out,
                long long tile0) {
  const KeyedTile<C> t = keyed_tile<C>();
  const long long base = (tile0 + blockIdx.x) * kKeyedT<C>;
  const TileMap m{base, kKeyedLog<C>, 0};
  keyed_load<C>(t, in, m, n);
  // stages 2, 4, 8 on a thread's eight contiguous rows, in registers
  for (int g = threadIdx.x; g < kKeyedT<C> / 8; g += kBitonicThreads) {
    long long k[8];
    int ix[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      k[q] = t.key[phys(8 * g + q)];
      ix[q] = C > 1 ? t.idx[phys(8 * g + q)] : 0;
    }
#pragma unroll
    for (int k_log = 1; k_log <= 3; ++k_log) {
#pragma unroll
      for (int b = k_log - 1; b >= 0; --b) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if ((q >> b) & 1) continue;
          const bool asc = (((8 * g + q) >> k_log) & 1) == 0;
          keyed_exchange<C>(k[q], ix[q], k[q | (1 << b)], ix[q | (1 << b)],
                            asc, t);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      t.key[phys(8 * g + q)] = k[q];
      if constexpr (C > 1) t.idx[phys(8 * g + q)] = (unsigned short)ix[q];
    }
  }
  __syncthreads();
  for (int k_log = 4; k_log <= kKeyedLog<C>; ++k_log)
    keyed_steps<C>(t, k_log - 1, 0, base, k_log);
  keyed_store<C>(t, m, out, n_out);
}

// Tile tile0 + blockIdx.x of `src` (n_src rows present), the strides
// T / 2 ... 1; rows below n_dst go to `dst`, which may be `src`.
template <int C>
__global__ void __launch_bounds__(kBitonicThreads, kKeyedBlocks)
keyed_intile(Keys<C> src, long long n_src, MutKeys<C> dst, long long n_dst,
             int dir_bit, long long tile0) {
  const KeyedTile<C> t = keyed_tile<C>();
  const long long base = (tile0 + blockIdx.x) * kKeyedT<C>;
  const TileMap m{base, kKeyedLog<C>, 0};
  keyed_load<C>(t, src, m, n_src);
  keyed_steps<C>(t, kKeyedLog<C> - 1, 0, base, dir_bit);
  keyed_store<C>(t, m, dst, n_dst);
}

// Block block0 + blockIdx.x of the work buffer, the f strides
// 2^(a_log+f-1) ... 2^a_log, in place.  Block b = (hi << (a_log - c)) | mid,
// c = the tile's log - f, owns the 2^f slices of 2^c rows that start at
// rows first + (q << a_log), q < 2^f, first = (hi << (a_log + f)) |
// (mid << c): every row whose bits [c, a_log) are mid and whose bits above
// a_log + f are hi.  Slice q lies at [q << c, (q + 1) << c) of the tile.
template <int C>
__global__ void __launch_bounds__(kBitonicThreads, kKeyedBlocks)
keyed_cross(MutKeys<C> w, int a_log, int f, int dir_bit, long long block0) {
  const KeyedTile<C> t = keyed_tile<C>();
  const int c_log = kKeyedLog<C> - f;
  const long long b = block0 + blockIdx.x;
  const long long mid = b & ((1LL << (a_log - c_log)) - 1);
  const long long hi = b >> (a_log - c_log);
  const long long first = (hi << (a_log + f)) | (mid << c_log);
  const long long all = 0x7fffffffffffffffLL;  // every row is present
  const TileMap m{first, c_log, a_log};
  keyed_load<C>(t, as_const<C>(w), m, all);
  // one direction for the block: `dir_bit` lies above a_log + f
  keyed_steps<C>(t, kKeyedLog<C> - 1, c_log, first, dir_bit);
  keyed_store<C>(t, m, w, all);
}

// The steps with strides 2^hi_log ... 2^lo_log (all >= the tile) of the
// stage with `dir_bit` over `blocks` blocks from block0, kFuseLog strides
// a launch, a shorter launch first.
template <int C>
cudaError_t keyed_cross_launches(const MutKeys<C>& w, long long block0,
                                 long long blocks, int hi_log, int lo_log,
                                 int dir_bit, cudaStream_t s) {
  int left = hi_log - lo_log + 1;
  while (left > 0) {
    const int f = left % kKeyedFuse<C> ? left % kKeyedFuse<C> : kKeyedFuse<C>;
    keyed_cross<C><<<(unsigned)blocks, kBitonicThreads, kKeyedSmem<C>, s>>>(
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

// The first `streams` side streams wait for the work enqueued so far on s.
cudaError_t fork_chunks(ChunkStreams& cs, int streams, cudaStream_t s) {
  cudaError_t err = cudaEventRecord(cs.fork, s);
  for (int i = 0; i < streams && err == cudaSuccess; ++i)
    err = cudaStreamWaitEvent(cs.side[i], cs.fork, 0);
  return err;
}

// s waits for the work enqueued so far on the first `streams` side streams.
cudaError_t join_chunks(ChunkStreams& cs, int streams, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < streams && err == cudaSuccess; ++i) {
    err = cudaEventRecord(cs.join[i], cs.side[i]);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(s, cs.join[i], 0);
  }
  return err;
}

// The strides 2^(k_log-1) ... 2^chunk_log of stage k_log over the whole
// work buffer, kFuseLog a pass, a shorter pass first; one pass through
// device memory a launch.
template <int C>
cudaError_t whole_cross(const MutKeys<C>& w, long long P, int chunk_log,
                        int k_log, cudaStream_t s, int* passes) {
  int left = k_log - chunk_log;
  while (left > 0) {
    const int f = left % kKeyedFuse<C> ? left % kKeyedFuse<C> : kKeyedFuse<C>;
    keyed_cross<C><<<(unsigned)(P >> kKeyedLog<C>), kBitonicThreads,
                     kKeyedSmem<C>, s>>>(w, chunk_log + left - f, f, k_log,
                                         0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*passes;
    left -= f;
  }
  return cudaSuccess;
}

// = ops/bitonic.py `network_passes(P, TILES[C], fuse_log, CHUNKS[C])`
template <int C>
int bitonic_sort_keyed(const void* const* in, void* const* out,
                       void* const* work, long long work_rows, long long n,
                       cudaStream_t s, int* passes) {
  constexpr int T_LOG = kKeyedLog<C>;
  constexpr int SMEM = kKeyedSmem<C>;
  Keys<C> src;
  MutKeys<C> dst, w;
  for (int c = 0; c < C; ++c) {
    src.p[c] = (const long long*)in[c];
    dst.p[c] = (long long*)out[c];
    w.p[c] = (long long*)work[c];
  }
  int p_log = T_LOG;
  while ((1LL << p_log) < n) ++p_log;
  const long long P = 1LL << p_log;
  cudaError_t err = allow_tile_smem(keyed_tile_sort<C>, SMEM);
  if (err == cudaSuccess) err = allow_tile_smem(keyed_intile<C>, SMEM);
  if (err == cudaSuccess) err = allow_tile_smem(keyed_cross<C>, SMEM);
  if (err != cudaSuccess) return (int)err;
  *passes = 1;
  if (P == kKeyedT<C>) {
    keyed_tile_sort<C><<<1, kBitonicThreads, SMEM, s>>>(src, n, dst, n, 0);
    return (int)cudaGetLastError();
  }
  if (work_rows < P) return (int)cudaErrorInvalidValue;
  if ((P >> T_LOG) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int chunk_log = p_log < kChunkLog<C> ? p_log : kChunkLog<C>;
  const long long chunk_tiles = 1LL << (chunk_log - T_LOG);
  const long long chunks = P >> chunk_log;
  const Keys<C> wk = as_const<C>(w);
  ChunkStreams* cs = nullptr;
  err = chunk_streams(&cs);
  if (err != cudaSuccess) return (int)err;
  // the in-tile pass of stage k_log over chunk q on stream cq; the last
  // stage writes the output
  auto intile = [&](int k_log, long long q, cudaStream_t cq) {
    const bool last = k_log == p_log;
    keyed_intile<C><<<(unsigned)chunk_tiles, kBitonicThreads, SMEM, cq>>>(
        wk, P, last ? dst : w, last ? n : P, k_log, q * chunk_tiles);
    return cudaGetLastError();
  };
  // every stage up to the chunk, chunk by chunk
  err = fork_chunks(*cs, kStreams<C>, s);
  if (err != cudaSuccess) return (int)err;
  for (long long q = 0; q < chunks; ++q) {
    const cudaStream_t cq = cs->side[q % kStreams<C>];
    keyed_tile_sort<C><<<(unsigned)chunk_tiles, kBitonicThreads, SMEM,
                         cq>>>(src, n, w, P, q * chunk_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int k_log = T_LOG + 1; k_log <= chunk_log; ++k_log) {
      err = keyed_cross_launches<C>(w, q * chunk_tiles, chunk_tiles,
                                    k_log - 1, T_LOG, k_log, cq);
      if (err == cudaSuccess) err = intile(k_log, q, cq);
      if (err != cudaSuccess) return (int)err;
    }
  }
  err = join_chunks(*cs, kStreams<C>, s);
  if (err != cudaSuccess) return (int)err;
  // each later stage: the strides >= the chunk over the whole array, then
  // the rest chunk by chunk
  for (int k_log = chunk_log + 1; k_log <= p_log; ++k_log) {
    err = whole_cross<C>(w, P, chunk_log, k_log, s, passes);
    if (err == cudaSuccess) err = fork_chunks(*cs, kStreams<C>, s);
    if (err != cudaSuccess) return (int)err;
    for (long long q = 0; q < chunks; ++q) {
      const cudaStream_t cq = cs->side[q % kStreams<C>];
      err = keyed_cross_launches<C>(w, q * chunk_tiles, chunk_tiles,
                                    chunk_log - 1, T_LOG, k_log, cq);
      if (err == cudaSuccess) err = intile(k_log, q, cq);
      if (err != cudaSuccess) return (int)err;
    }
    err = join_chunks(*cs, kStreams<C>, s);
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
// nulls).  `*passes` receives the number of passes through device memory:
// one for each run of chunk passes, one for each whole-array pass.
extern "C" int cbl_bitonic_sort(const void* const* in, void* const* out,
                                void* const* work, int C, long long work_rows,
                                long long n, int* passes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 1:
      return cbl::bitonic_sort_keyed<1>(in, out, work, work_rows, n, s,
                                        passes);
    case 2:
      return cbl::bitonic_sort_keyed<2>(in, out, work, work_rows, n, s,
                                        passes);
    case 3:
      return cbl::bitonic_sort_keyed<3>(in, out, work, work_rows, n, s,
                                        passes);
  }
  return (int)cudaErrorInvalidValue;
}
