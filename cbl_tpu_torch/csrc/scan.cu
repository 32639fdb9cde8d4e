// Kernel B2: record-boundary blanking as an exact int32 running sum.
//
// Replaces the TPU kernel cbl_tpu/ops/scan_pallas.py `blank_mask_pallas`
// (`_blank_call`, `_prefix_sum_flat`).  From int32 interval deltas it
// writes mask[i] = (delta[0] + ... + delta[i] > 0) as int32 and the count
// of rows whose mask is 0.
//
// What bounds it on the H100: device memory, 4 bytes read and 4 written
// per row (plus a second 4-byte read, see below).  The TPU kernel ran its
// grid in order and carried the running sum from one block to the next in
// SMEM; blocks on the H100 run in no order, so the carry becomes three
// launches on one stream:
//   1. tile_sums: each block sums its tile of SCAN_TILE deltas;
//   2. scan_tile_sums: one block turns those sums into exclusive
//      prefixes in place (and zeroes the valid counter);
//   3. apply: each block rescans its tile from its prefix, writes the
//      mask and adds its unblanked count to the total with atomicAdd
//      (integer addition, so the total is exact in any order).
// Tiles go through shared memory (padded against bank conflicts) so that
// global loads and stores stay coalesced while each thread scans 16
// consecutive rows.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 4096, = ops/scan.py SCAN_TILE
constexpr int kScanThreads = 1024;

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Exclusive block-wide scan of one int per thread; *total gets the sum.
template <int NT>
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[NT / 32];
  __shared__ int sum_all;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sums[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int ws = lane < NT / 32 ? warp_sums[lane] : 0;
    int wi = ws;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int t = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < NT / 32) warp_sums[lane] = wi - ws;
    if (lane == 31) sum_all = wi;
  }
  __syncthreads();
  const int out = warp_sums[wid] + incl - v;
  *total = sum_all;
  __syncthreads();  // the shared slots may be reused by the caller
  return out;
}

__global__ void tile_sums(const int* __restrict__ delta,
                          int* __restrict__ sums, long long n) {
  const long long base = (long long)blockIdx.x * kTile;
  int s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    long long i = base + k * kThreads + threadIdx.x;
    if (i < n) s += delta[i];
  }
  int total;
  block_exclusive_scan<kThreads>(s, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void scan_tile_sums(int* __restrict__ sums, int n_tiles,
                               int* __restrict__ n_valid) {
  if (threadIdx.x == 0) *n_valid = 0;
  const int chunk = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = threadIdx.x * chunk;
  const int hi = min(lo + chunk, n_tiles);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += sums[i];
  int total;
  int run = block_exclusive_scan<kScanThreads>(s, &total);
  for (int i = lo; i < hi; ++i) {
    int v = sums[i];
    sums[i] = run;
    run += v;
  }
}

__global__ void apply(const int* __restrict__ delta, int* __restrict__ mask,
                      const int* __restrict__ prefix,
                      int* __restrict__ n_valid, long long n) {
  __shared__ int tile[kTile + kTile / 32];
  const long long base = (long long)blockIdx.x * kTile;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    int j = k * kThreads + threadIdx.x;
    long long i = base + j;
    tile[pad(j)] = i < n ? delta[i] : 0;
  }
  __syncthreads();
  const int j0 = threadIdx.x * kItems;
  int v[kItems];
  int s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    v[k] = tile[pad(j0 + k)];
    s += v[k];
  }
  int total;
  int run = prefix[blockIdx.x] + block_exclusive_scan<kThreads>(s, &total);
  int unblanked = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    run += v[k];
    const int m = run > 0;
    tile[pad(j0 + k)] = m;
    if (base + j0 + k < n) unblanked += 1 - m;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    int j = k * kThreads + threadIdx.x;
    long long i = base + j;
    if (i < n) mask[i] = tile[pad(j)];
  }
  int block_unblanked;
  block_exclusive_scan<kThreads>(unblanked, &block_unblanked);
  if (threadIdx.x == 0) atomicAdd(n_valid, block_unblanked);
}

}  // namespace

extern "C" int cbl_blank_mask(const void* delta, void* mask, void* n_valid,
                              void* tile_scratch, long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_tiles = (n + kTile - 1) / kTile;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tile_sums<<<(unsigned)n_tiles, kThreads, 0, s>>>(
      (const int*)delta, (int*)tile_scratch, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_tile_sums<<<1, kScanThreads, 0, s>>>((int*)tile_scratch, (int)n_tiles,
                                            (int*)n_valid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply<<<(unsigned)n_tiles, kThreads, 0, s>>>(
      (const int*)delta, (int*)mask, (const int*)tile_scratch, (int*)n_valid,
      n);
  return (int)cudaGetLastError();
}
