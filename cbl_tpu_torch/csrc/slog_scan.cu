// Kernel B4: the liveness scan of a sorted log -> (hits, live).
//
// Replaces the TPU kernel cbl_tpu/ops/scan_pallas.py:202
// `slog_scan_counts_pallas` (`_scan_call`).  The input is the port's slog:
// int64 keys sorted ascending, `key >> 8` a word's run, `key & 0xFF` the
// row's tag (seq << 2) | typ (1 insert, 2 query, 3 remove), sentinel rows
// INT64_MAX.  Every run start or entry row (typ 1 or 3, tag != 0xFF, not a
// sentinel) carries the marker (i << 2) | (entry ? 2 | insert : 0), every
// other row -1; a row is live when the running max of the markers has both
// low bits set.  Outputs, added with 64-bit atomics (exact in any order):
//   out[0] hits = live non-sentinel rows whose tag == qtag;
//   out[1] live = live non-sentinel rows that end their run.
//
// What bounds it on the H100: device memory, 8 bytes read a row (the slog
// reaches ~84M rows in a full dynamic workload).  The TPU kernel ran its
// grid in order and carried the running max between steps in SMEM.  Blocks
// on the H100 run in no order, and the version before this one carried
// the max in three launches (tile maxima, one block of 1024 threads
// scanning them, a rescan): every row was read twice.  This one is ONE
// launch that reads every row once; the carry crosses tiles by decoupled
// look-back (Merrill and Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016):
// - markers grow strictly with the row index, so the running max at a row
//   is the marker of the last marked row at or before it, and a row is
//   live when that row is an insert entry.  One bit crosses tiles: the
//   liveness left by the last marker before the tile;
// - a block takes its tile from an atomic ticket, so it only ever waits on
//   tiles that started before it;
// - a tile that holds a marker knows its inclusive state at once (its
//   last marker's) and publishes it before anything else; a tile without
//   one publishes "no marker";
// - a tile whose first row is no marker (its first run began earlier)
//   looks back: warp 0 reads the status words of the 32 tiles before it,
//   nearest first, waits while any is unpublished, passes over "no
//   marker" tiles and takes the nearest inclusive state, 32 tiles a step.
//   A tile without a marker then publishes that state as its own;
// - a tile whose first row is a sentinel holds only sentinels (the keys
//   are sorted), counts nothing and is never looked back at: it stops
//   after that one load (so a bound on a log with a sentinel tail counts
//   one row of each such tile, chip_smoke.py's `slog_bound`).
// A status is one 32-bit word read or written in one access (release
// stores, acquire loads).  The C entry point clears the statuses, the
// ticket and the counters with one memset on the call's stream, so no call
// reads a status that another left.  Tiles go through padded shared
// memory with 16-byte loads, each thread scans 16 consecutive rows into
// four bit masks, and the counts are per-block sums with one atomicAdd
// each.  A look-back of 128 statuses a step (four loads a lane) measured
// 1.04x slower here at 2^26 rows (and 1.3x for B2, csrc/scan.cu).
//
// The tag-column form (`slog_tag_lookback`; the TPU kernel's pack=False,
// NCOL = L + 1 with the tag in refs[L]) scans a log of C = 2 or 3 int64
// columns: the word's one or two columns, then the tag.  A run is grouped
// by every word column, a row is a sentinel when word column 0 is
// INT64_MAX, and a tag of INT64_MAX (a join query's or a sentinel's, the
// TPU's 0xFFFFFFFF) is never an entry.  It reads 8 * C bytes a row.  The
// C columns of a tile go through padded shared memory together (34.8 KB a
// column: 69.6 KB at C = 2, 104.4 KB at C = 3, dynamic shared memory asked
// for with cudaFuncSetAttribute), and each thread scans its 16 rows in one
// pass, as the packed form does; from the rows' bit masks on, both forms
// share `count_tile`.

#include <climits>
#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace cbl {
namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 4096, = ops/scan.py SLOG_TILE
constexpr int kWarps = kThreads / 32;
constexpr long long kSentinel = LLONG_MAX;
// status words: 0 = not published yet
constexpr unsigned kNoMarker = 1;   // look further back
constexpr unsigned kInclusive = 2;  // | the live bit at the tile's end

// one pad slot per 16 int64: a warp reading rows t * 16 + k hits distinct
// banks
__host__ __device__ constexpr int pad(int i) { return i + (i >> 4); }

using StatusRef = cuda::atomic_ref<unsigned, cuda::thread_scope_device>;

__device__ __forceinline__ void store_status(unsigned* p, unsigned v) {
  StatusRef(*p).store(v, cuda::std::memory_order_release);
}

// The live bit left by the last marker before tile t >= 1, by warp 0.
__device__ unsigned look_back(unsigned* status, int t) {
  const int lane = threadIdx.x & 31;
  for (int hi = t - 1;; hi -= 32) {
    const int i = hi - lane;
    unsigned s;
    do {
      // tile 0 always holds a marker (row 0 starts a run): i < 0 is past it
      s = i >= 0 ? StatusRef(status[i]).load(cuda::std::memory_order_acquire)
                 : kInclusive;
    } while (__any_sync(0xffffffffu, s == 0));
    const unsigned incl = __ballot_sync(0xffffffffu, s >= kInclusive);
    if (incl) return __shfl_sync(0xffffffffu, s, __ffs(incl) - 1) & 1u;
  }
}

// Rows base .. base + rows - 1 of `src` into slots pad(0 ..) of `tile`,
// the slots past `rows` as sentinels; 16-byte loads for a whole, aligned
// tile.
__device__ __forceinline__ void load_tile(const long long* __restrict__ src,
                                          long long base, long long rows,
                                          long long* tile) {
  if (rows == kTile && (reinterpret_cast<uintptr_t>(src + base) & 15) == 0) {
    const longlong2* v2 = reinterpret_cast<const longlong2*>(src + base);
#pragma unroll
    for (int k = 0; k < kItems / 2; ++k) {
      const int p = k * kThreads + threadIdx.x;
      const longlong2 v = v2[p];
      tile[pad(2 * p)] = v.x;
      tile[pad(2 * p + 1)] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = k * kThreads + threadIdx.x;
      tile[pad(j)] = j < rows ? src[base + j] : kSentinel;
    }
  }
}

// Counts tile t from its rows' bit masks (bit k of a thread's masks
// describes row base + threadIdx.x * kItems + k): M a marker, E an insert
// entry, H a hit if live, R a run end if live.  Publishes the tile's
// status, looks back when its first row is no marker, and adds the
// block's counts to out.
__device__ __forceinline__ void count_tile(unsigned M, unsigned E, unsigned H,
                                           unsigned R, int t,
                                           unsigned long long* __restrict__ out,
                                           unsigned* __restrict__ status) {
  __shared__ int s_need, s_warp[kWarps], s_hits[kWarps], s_live[kWarps];
  __shared__ unsigned s_carry;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  // exclusive scan of "the live bit of the last marker" over the block's
  // threads; -1 = no marker yet
  const int own = M ? (int)((E >> (31 - __clz(M))) & 1u) : -1;
  int incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o && incl < 0) incl = u;
  }
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = -1;
  if (lane == 31) s_warp[wid] = incl;
  if (threadIdx.x == 0) {
    s_need = !(M & 1u);
    s_carry = 0;
  }
  __syncthreads();
  int before = -1, tile_state = -1;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = s_warp[w];
    if (v >= 0) {
      tile_state = v;
      if (w < wid) before = v;
    }
  }
  if (excl < 0) excl = before;
  if (threadIdx.x == 0)
    store_status(status + t, tile_state >= 0 ? kInclusive | tile_state
                                             : kNoMarker);
  if (s_need && wid == 0) {  // then t >= 1: row 0 is always a marker
    const unsigned c = look_back(status, t);
    if (lane == 0) {
      s_carry = c;
      if (tile_state < 0) store_status(status + t, kInclusive | c);
    }
  }
  __syncthreads();

  unsigned cur = excl >= 0 ? (unsigned)excl : s_carry;
  int hits = 0, live = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if ((M >> k) & 1u) cur = (E >> k) & 1u;
    hits += cur & (H >> k);
    live += cur & (R >> k);
  }
  hits = __reduce_add_sync(0xffffffffu, hits);
  live = __reduce_add_sync(0xffffffffu, live);
  if (lane == 0) {
    s_hits[wid] = hits;
    s_live[wid] = live;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long h = 0, l = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      h += s_hits[w];
      l += s_live[w];
    }
    if (h) atomicAdd(&out[0], (unsigned long long)h);
    if (l) atomicAdd(&out[1], (unsigned long long)l);
  }
}

__global__ void __launch_bounds__(kThreads)
    slog_lookback(const long long* __restrict__ keys, long long n, int qtag,
                  unsigned long long* __restrict__ out,
                  unsigned* __restrict__ ticket,
                  unsigned* __restrict__ status) {
  // slot pad(j) holds row base + j
  __shared__ long long tile[pad(kTile - 1) + 1];
  __shared__ long long s_prev, s_next;
  __shared__ int s_t;
  if (threadIdx.x == 0) {
    const int t = (int)atomicAdd(ticket, 1u);
    const long long base = (long long)t * kTile;
    s_t = t;
    if (base < n) {
      s_prev = base > 0 ? keys[base - 1] : 0;
      tile[pad(0)] = keys[base];
      s_next = base + kTile < n ? keys[base + kTile] : kSentinel;
    }
  }
  __syncthreads();
  const int t = s_t;
  const long long base = (long long)t * kTile;
  if (base >= n || tile[pad(0)] == kSentinel) return;

  const long long rows = n - base < kTile ? n - base : kTile;
  load_tile(keys, base, rows, tile);
  __syncthreads();

  const int j0 = threadIdx.x * kItems;
  unsigned M = 0, E = 0, H = 0, R = 0;
  long long prev = j0 > 0 ? tile[pad(j0 - 1)] : s_prev;
  long long key = tile[pad(j0)];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long next = j0 + k + 1 < kTile ? tile[pad(j0 + k + 1)] : s_next;
    const long long i = base + j0 + k;
    if (i < n) {
      const bool sent = key == kSentinel;
      const bool run_start =
          i == 0 || ((unsigned long long)(key ^ prev) >> 8) != 0;
      const bool run_end =
          i == n - 1 || ((unsigned long long)(key ^ next) >> 8) != 0;
      const int tag = (int)(key & 0xFF);
      const bool entry = (tag & 1) && tag != 0xFF && !sent;  // typ 1 or 3
      M |= (unsigned)(run_start || entry) << k;
      E |= (unsigned)(entry && (tag & 3) == 1) << k;
      H |= (unsigned)(!sent && tag == qtag) << k;
      R |= (unsigned)(!sent && run_end) << k;
    }
    prev = key;
    key = next;
  }
  count_tile(M, E, H, R, t, out, status);
}

template <int C>
struct SlogCols {
  const long long* p[C];
};

// Slots of one column's padded tile.
constexpr int kSlots = pad(kTile - 1) + 1;

// The tag-column form: cols.p[0 .. C - 2] the word, cols.p[C - 1] the tag;
// the C column tiles live in dynamic shared memory, slot pad(j) of tile c
// at tiles[c * kSlots + pad(j)].
template <int C>
__global__ void __launch_bounds__(kThreads)
    slog_tag_lookback(SlogCols<C> cols, long long n, long long qtag,
                      unsigned long long* __restrict__ out,
                      unsigned* __restrict__ ticket,
                      unsigned* __restrict__ status) {
  extern __shared__ long long tiles[];
  __shared__ long long s_prev[C], s_next[C];
  __shared__ int s_t, s_skip;
  if (threadIdx.x == 0) {
    const int t = (int)atomicAdd(ticket, 1u);
    const long long base = (long long)t * kTile;
    s_t = t;
    s_skip = base >= n || cols.p[0][base] == kSentinel;
    if (!s_skip) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s_prev[c] = base > 0 ? cols.p[c][base - 1] : 0;
        s_next[c] = base + kTile < n ? cols.p[c][base + kTile] : kSentinel;
      }
    }
  }
  __syncthreads();
  if (s_skip) return;
  const int t = s_t;
  const long long base = (long long)t * kTile;
  const long long rows = n - base < kTile ? n - base : kTile;
#pragma unroll
  for (int c = 0; c < C; ++c)
    load_tile(cols.p[c], base, rows, tiles + c * kSlots);
  __syncthreads();

  const int j0 = threadIdx.x * kItems;
  long long prev[C - 1];
#pragma unroll
  for (int c = 0; c < C - 1; ++c)
    prev[c] = j0 > 0 ? tiles[c * kSlots + pad(j0 - 1)] : s_prev[c];
  unsigned M = 0, E = 0, H = 0, R = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + j0 + k;
    // a run is grouped by every word column
    bool run_start = i == 0, run_end = i == n - 1;
#pragma unroll
    for (int c = 0; c < C - 1; ++c) {
      const long long v = tiles[c * kSlots + pad(j0 + k)];
      const long long next = j0 + k + 1 < kTile
                                 ? tiles[c * kSlots + pad(j0 + k + 1)]
                                 : s_next[c];
      run_start |= v != prev[c];
      run_end |= v != next;
      prev[c] = v;
    }
    if (i < n) {
      const bool sent = tiles[pad(j0 + k)] == kSentinel;
      const long long tag = tiles[(C - 1) * kSlots + pad(j0 + k)];
      // typ 1 or 3; INT64_MAX & 3 == 3, so the join / sentinel tag needs
      // its own test
      const bool entry = (tag & 1) && tag != kSentinel && !sent;
      M |= (unsigned)(run_start || entry) << k;
      E |= (unsigned)(entry && (tag & 3) == 1) << k;
      H |= (unsigned)(!sent && tag == qtag) << k;
      R |= (unsigned)(!sent && run_end) << k;
    }
  }
  count_tile(M, E, H, R, t, out, status);
}

// Clears the counters, the ticket and one status word a tile on stream s.
cudaError_t clear_scratch(void* scratch, long long n_tiles, cudaStream_t s) {
  return cudaMemsetAsync(scratch, 0, 24 + 4 * n_tiles, s);
}

template <int C>
cudaError_t launch_tag(const void* const* cols, long long n, long long qtag,
                       unsigned long long* out, long long n_tiles,
                       cudaStream_t s) {
  SlogCols<C> c;
  for (int i = 0; i < C; ++i) c.p[i] = (const long long*)cols[i];
  unsigned* ticket = (unsigned*)(out + 2);
  // 69.6 KB at C = 2, 104.4 KB at C = 3: past the 48 KB a kernel gets
  // without asking
  const int smem = C * kSlots * (int)sizeof(long long);
  cudaError_t err = cudaFuncSetAttribute(
      slog_tag_lookback<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  slog_tag_lookback<C><<<(unsigned)(n_tiles > 0 ? n_tiles : 1), kThreads,
                         smem, s>>>(c, n, qtag, out, ticket, ticket + 2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cbl

// scratch: 8-byte aligned, 24 + 4 * ceil(n / 4096) bytes: (hits, live)
// as two int64, the tile ticket, then one 32-bit status word a tile; all
// of it is cleared here.  `*launches` receives the number of kernels
// launched: one, for any n (a single block that exits at once for n == 0).
extern "C" int cbl_slog_scan_counts(const void* keys, long long n, int qtag,
                                    void* scratch, int* launches,
                                    void* stream) {
  *launches = 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_tiles = (n + cbl::kTile - 1) / cbl::kTile;
  if (n < 0 || n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  unsigned long long* out = (unsigned long long*)scratch;
  unsigned* ticket = (unsigned*)(out + 2);
  cudaError_t err = cbl::clear_scratch(scratch, n_tiles, s);
  if (err != cudaSuccess) return (int)err;
  cbl::slog_lookback<<<(unsigned)(n_tiles > 0 ? n_tiles : 1), cbl::kThreads,
                       0, s>>>((const long long*)keys, n, qtag, out, ticket,
                               ticket + 2);
  ++*launches;
  return (int)cudaGetLastError();
}

// The tag-column form: `cols` is a C-element array of column pointers (C =
// 2 or 3: the word's columns, then the tag), `qtag` an int64 tag; scratch
// and launches as above.
extern "C" int cbl_slog_scan_tag_counts(const void* const* cols, int C,
                                        long long n, long long qtag,
                                        void* scratch, int* launches,
                                        void* stream) {
  *launches = 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_tiles = (n + cbl::kTile - 1) / cbl::kTile;
  if (n < 0 || n_tiles > 0x7fffffffLL || C < 2 || C > 3)
    return (int)cudaErrorInvalidValue;
  unsigned long long* out = (unsigned long long*)scratch;
  cudaError_t err = cbl::clear_scratch(scratch, n_tiles, s);
  if (err != cudaSuccess) return (int)err;
  err = C == 2 ? cbl::launch_tag<2>(cols, n, qtag, out, n_tiles, s)
               : cbl::launch_tag<3>(cols, n, qtag, out, n_tiles, s);
  ++*launches;
  return (int)err;
}
