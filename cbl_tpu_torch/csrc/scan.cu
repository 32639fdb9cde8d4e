// Kernel B2: record-boundary blanking as an exact int32 running sum.
//
// Replaces the TPU kernel cbl_tpu/ops/scan_pallas.py:293
// `blank_mask_pallas` (`_blank_call`, `_prefix_sum_flat`).  From int32
// interval deltas it writes mask[i] = (delta[0] + ... + delta[i] > 0) as
// int32 and the count of rows whose mask is 0.
//
// What bounds it on the H100: device memory, 4 bytes read and 4 written a
// row (8 B).  The TPU kernel ran its grid in order and carried the running
// sum from one block to the next in SMEM.  Blocks on the H100 run in no
// order, and the version before this one carried the sum in three launches
// (tile sums, one block of 1024 threads scanning them, a rescan): every
// delta was read twice, and at a dynamic round's 2^22 rows the three
// launches' fixed costs took 0.033 ms where memory allows 0.010.  This one
// is ONE launch that reads every delta once; the carry crosses tiles by
// decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016):
// - a block takes its tile from an atomic ticket, so it only ever waits on
//   tiles that started before it;
// - each warp scans 1024 consecutive rows straight from registers: a lane
//   holds eight 16-byte loads, each the lane's 4 rows of a 128-row chunk,
//   so loads and stores stay coalesced and need no shared tile.  8192
//   rows a tile (64 registers, four blocks an SM) measured 1.1x faster
//   than 4096 at 2^25 rows and 1.2x at 2^22: the look-back below waits
//   on fewer, larger tiles;
// - as soon as the tile's sum (its aggregate) is known, the tile
//   publishes it (tile 0 publishes it as its inclusive prefix);
// - then warp 0 looks back: it reads the status words of the 32 tiles
//   before it, nearest first, waits while any is unpublished, adds the
//   aggregates up to the nearest inclusive prefix and that prefix, 32
//   tiles a step, and publishes the tile's own inclusive prefix.  128
//   tiles a step (four loads a lane) measured 1.3x slower at 2^25 rows:
//   more spinning loads on the statuses' cache lines, no shorter waits;
// - every row's sum is then the tile's prefix plus the rows before it in
//   the tile; the mask goes out in 16-byte stores, and the unblanked count
//   is a per-block sum added with one atomicAdd (exact in any order).
// A status is one 64-bit word, flag and value read or written in one
// access (release stores, acquire loads).  The C entry point clears the
// statuses, the ticket and the count with one memset on the call's
// stream, so no call reads a status that another left.

#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace cbl {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;     // rows of one 16-byte load
constexpr int kChunks = 8;  // 16-byte loads a lane
constexpr int kWarpRows = 32 * kVec * kChunks;  // 1024
constexpr int kTile = kWarps * kWarpRows;  // 8192, = ops/scan.py BLANK_TILE
// status words: flag << 32 | the int32 value; flag 0 = not published yet,
// 1 the tile's aggregate, 2 its inclusive prefix
constexpr unsigned long long kInclusive = 2ull << 32;

using StatusRef =
    cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

__device__ __forceinline__ void store_status(unsigned long long* p, int flag,
                                             int v) {
  StatusRef(*p).store((unsigned long long)flag << 32 | (unsigned)v,
                      cuda::std::memory_order_release);
}

// The sum of every delta before tile t >= 1, by warp 0.
__device__ int look_back(unsigned long long* status, int t) {
  const int lane = threadIdx.x & 31;
  int sum = 0;
  for (int hi = t - 1;; hi -= 32) {
    const int i = hi - lane;
    unsigned long long s;
    do {
      // tile 0 publishes its inclusive prefix at once: i < 0 is past it
      s = i >= 0 ? StatusRef(status[i]).load(cuda::std::memory_order_acquire)
                 : kInclusive;
    } while (__any_sync(0xffffffffu, (s >> 32) == 0));
    const unsigned incl = __ballot_sync(0xffffffffu, s >= kInclusive);
    const int nearest = incl ? __ffs(incl) - 1 : 32;
    sum += __reduce_add_sync(0xffffffffu,
                             lane <= nearest ? (int)(unsigned)s : 0);
    if (incl) return sum;
  }
}

__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    blank_lookback(const int* __restrict__ delta, int* __restrict__ mask,
                   long long n, int* __restrict__ n_valid,
                   unsigned* __restrict__ ticket,
                   unsigned long long* __restrict__ status) {
  __shared__ int s_t, s_prefix, s_warp[kWarps], s_valid[kWarps];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_t = (int)atomicAdd(ticket, 1u);
    s_prefix = 0;
  }
  __syncthreads();
  const int t = s_t;
  const long long base = (long long)t * kTile;
  // row of v[c][e]: base + wid * 1024 + c * 128 + lane * 4 + e
  const long long first = base + wid * kWarpRows + lane * kVec;
  const bool vec = base + kTile <= n &&
                   ((reinterpret_cast<uintptr_t>(delta) |
                     reinterpret_cast<uintptr_t>(mask)) & 15) == 0;
  int v[kChunks][kVec];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const long long r = first + c * 32 * kVec;
    if (vec) {
      const int4 x = *reinterpret_cast<const int4*>(delta + r);
      v[c][0] = x.x;
      v[c][1] = x.y;
      v[c][2] = x.z;
      v[c][3] = x.w;
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[c][e] = r + e < n ? delta[r + e] : 0;
    }
  }
  // pre[c]: the sum of the warp's rows before this lane's rows of chunk c
  int pre[kChunks];
  int warp_sum = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int own = v[c][0] + v[c][1] + v[c][2] + v[c][3];
    const int incl = warp_inclusive_sum(own);
    pre[c] = warp_sum + incl - own;
    warp_sum += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) s_warp[wid] = warp_sum;
  __syncthreads();
  int before = 0, aggregate = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = s_warp[w];
    if (w < wid) before += x;
    aggregate += x;
  }
  if (threadIdx.x == 0)
    store_status(status + t, t == 0 ? 2 : 1, aggregate);
  if (t > 0 && wid == 0) {
    const int prefix = look_back(status, t);
    if (lane == 0) {
      s_prefix = prefix;
      store_status(status + t, 2, prefix + aggregate);
    }
  }
  __syncthreads();

  const int run0 = s_prefix + before;
  int unblanked = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const long long r = first + c * 32 * kVec;
    int run = run0 + pre[c];
    int m[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      run += v[c][e];
      m[e] = run > 0;
      if (vec || r + e < n) unblanked += 1 - m[e];
    }
    if (vec) {
      *reinterpret_cast<int4*>(mask + r) = make_int4(m[0], m[1], m[2], m[3]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (r + e < n) mask[r + e] = m[e];
    }
  }
  unblanked = __reduce_add_sync(0xffffffffu, unblanked);
  if (lane == 0) s_valid[wid] = unblanked;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_valid[w];
    if (total) atomicAdd(n_valid, total);
  }
}

}  // namespace
}  // namespace cbl

// scratch: 8-byte aligned, 16 + 8 * ceil(n / 8192) bytes: n_valid (the
// int32 at byte 0), the tile ticket (at byte 8), then one 64-bit status
// word a tile; all of it is cleared here.  n >= 1.  `*launches` receives
// the number of kernels launched: one.
extern "C" int cbl_blank_mask(const void* delta, void* mask, long long n,
                              void* scratch, int* launches, void* stream) {
  *launches = 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_tiles = (n + cbl::kTile - 1) / cbl::kTile;
  if (n < 1 || n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  unsigned long long* words = (unsigned long long*)scratch;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 16 + 8 * n_tiles, s);
  if (err != cudaSuccess) return (int)err;
  cbl::blank_lookback<<<(unsigned)n_tiles, cbl::kThreads, 0, s>>>(
      (const int*)delta, (int*)mask, n, (int*)scratch, (unsigned*)(words + 1),
      words + 2);
  ++*launches;
  return (int)cudaGetLastError();
}
