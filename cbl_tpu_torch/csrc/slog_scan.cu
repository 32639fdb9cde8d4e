// Kernel B4: the liveness scan of a sorted log -> (hits, live).
//
// Replaces the TPU kernel cbl_tpu/ops/scan_pallas.py
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
// What bounds it on the H100: device memory, 8 bytes read per row twice
// (the slog reaches ~84M rows in a full dynamic workload).  The TPU kernel
// ran its grid in order and carried the running max, the previous word
// and the last row's liveness between steps in SMEM; blocks on the H100
// run in no order.  A block reads row i - 1 and row i + 1 straight from
// device memory, so only the running max crosses tiles, in three launches
// on one stream (the shape of kernel B2 in scan.cu):
//   1. slog_tile_max: each block takes the max marker of its tile;
//   2. slog_scan_tiles: one block turns those into exclusive prefix maxima
//      in place, and zeroes the two counters;
//   3. slog_count: each block rescans its tile from its prefix and adds
//      its hits and live rows to the counters.
// Tiles go through padded shared memory so global loads stay coalesced
// while each thread scans 16 consecutive rows.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 4096, = ops/scan.py SCAN_TILE
constexpr int kScanThreads = 1024;
constexpr long long kSentinel = LLONG_MAX;
constexpr long long kNone = LLONG_MIN;  // identity of max; never live

// one pad slot per 16 int64: a warp reading rows t * 16 + k hits distinct
// banks
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ long long row_marker(long long key, long long prev,
                                                bool first, long long i) {
  const bool run_start = first || (key >> 8) != (prev >> 8);
  const int tag = (int)(key & 0xFF);
  const int typ = tag & 3;
  const bool entry =
      (typ == 1 || typ == 3) && tag != 0xFF && key != kSentinel;
  if (!(run_start || entry)) return -1;
  return (i << 2) | (entry ? (2 | (typ == 1 ? 1 : 0)) : 0);
}

__device__ __forceinline__ long long lmax(long long a, long long b) {
  return a > b ? a : b;
}

// Exclusive block-wide max of one value per thread (kNone for thread 0).
template <int NT>
__device__ long long block_exclusive_max(long long v) {
  __shared__ long long warp_max[NT / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  long long incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    long long t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = lmax(incl, t);
  }
  long long before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = kNone;
  if (lane == 31) warp_max[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    long long w = lane < NT / 32 ? warp_max[lane] : kNone;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      long long t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = lmax(w, t);
    }
    if (lane < NT / 32) warp_max[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const long long out = lmax(wid > 0 ? warp_max[wid - 1] : kNone, before);
  __syncthreads();  // the shared slots may be reused by the caller
  return out;
}

// Block-wide sum to thread 0 (other threads get garbage).
template <int NT>
__device__ long long block_sum(long long v) {
  __shared__ long long warp_sum[NT / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sum[wid] = v;
  __syncthreads();
  v = 0;
  if (wid == 0) {
    v = lane < NT / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();
  return v;
}

__global__ void slog_tile_max(const long long* __restrict__ keys,
                              long long* __restrict__ tile_max, long long n) {
  const long long base = (long long)blockIdx.x * kTile;
  long long m = kNone;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    if (i < n) {
      const long long prev = i > 0 ? keys[i - 1] : 0;
      m = lmax(m, row_marker(keys[i], prev, i == 0, i));
    }
  }
  // the inclusive max of the last thread is the tile's max
  m = lmax(m, block_exclusive_max<kThreads>(m));
  __shared__ long long tile_m;
  if (threadIdx.x == kThreads - 1) tile_m = m;
  __syncthreads();
  if (threadIdx.x == 0) tile_max[blockIdx.x] = tile_m;
}

__global__ void slog_scan_tiles(long long* __restrict__ tile_max, int n_tiles,
                                unsigned long long* __restrict__ out) {
  if (threadIdx.x == 0) {
    out[0] = 0;
    out[1] = 0;
  }
  const int chunk = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = threadIdx.x * chunk;
  const int hi = min(lo + chunk, n_tiles);
  long long m = kNone;
  for (int i = lo; i < hi; ++i) m = lmax(m, tile_max[i]);
  long long run = block_exclusive_max<kScanThreads>(m);
  for (int i = lo; i < hi; ++i) {
    const long long v = tile_max[i];
    tile_max[i] = run;
    run = lmax(run, v);
  }
}

__global__ void slog_count(const long long* __restrict__ keys,
                           const long long* __restrict__ prefix, long long n,
                           int qtag, unsigned long long* __restrict__ out) {
  // slot pad(j + 1) holds row base + j, for j in [-1, kTile]
  __shared__ long long tile[kTile + 2 + (kTile + 2) / 16 + 1];
  const long long base = (long long)blockIdx.x * kTile;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + threadIdx.x;
    const long long i = base + j;
    tile[pad(j + 1)] = i < n ? keys[i] : kSentinel;
  }
  if (threadIdx.x == 0) tile[pad(0)] = base > 0 ? keys[base - 1] : 0;
  if (threadIdx.x == 1) {
    const long long i = base + kTile;
    tile[pad(kTile + 1)] = i < n ? keys[i] : kSentinel;
  }
  __syncthreads();
  const int j0 = threadIdx.x * kItems;
  long long mk[kItems];
  long long local = kNone;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + j0 + k;
    mk[k] = i < n ? row_marker(tile[pad(j0 + k + 1)], tile[pad(j0 + k)],
                               i == 0, i)
                  : kNone;
    local = lmax(local, mk[k]);
  }
  long long run =
      lmax(prefix[blockIdx.x], block_exclusive_max<kThreads>(local));
  long long hits = 0, live = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + j0 + k;
    if (i < n) {
      run = lmax(run, mk[k]);
      const long long key = tile[pad(j0 + k + 1)];
      const long long next = tile[pad(j0 + k + 2)];
      const bool live_here = (run & 3) == 3 && key != kSentinel;
      const bool run_end = i == n - 1 || (next >> 8) != (key >> 8);
      hits += live_here && (int)(key & 0xFF) == qtag;
      live += live_here && run_end;
    }
  }
  hits = block_sum<kThreads>(hits);
  live = block_sum<kThreads>(live);
  if (threadIdx.x == 0) {
    if (hits) atomicAdd(&out[0], (unsigned long long)hits);
    if (live) atomicAdd(&out[1], (unsigned long long)live);
  }
}

}  // namespace

extern "C" int cbl_slog_scan_counts(const void* keys, long long n, int qtag,
                                    void* out, void* tile_scratch,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_tiles = (n + kTile - 1) / kTile;
  if (n < 0 || n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
    slog_tile_max<<<(unsigned)n_tiles, kThreads, 0, s>>>(
        (const long long*)keys, (long long*)tile_scratch, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // always launched: it zeroes the counters, also for n == 0
  slog_scan_tiles<<<1, kScanThreads, 0, s>>>(
      (long long*)tile_scratch, (int)n_tiles, (unsigned long long*)out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_tiles == 0) return (int)err;
  slog_count<<<(unsigned)n_tiles, kThreads, 0, s>>>(
      (const long long*)keys, (const long long*)tile_scratch, n, qtag,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}
