// Kernel B3: merge of two sorted int64 key runs (merge path).
//
// Replaces the TPU kernel cbl_tpu/ops/merge_pallas.py `merge_sorted_cols`
// (`_coranks`, `_merge_params`, `_merge_call`, `_flip_pad_cols`).  Given a
// and b, each sorted ascending, it writes their merge, equal to
// sort(concat(a, b)).
//
// What bounds it on the H100: device memory, 8 bytes read and 8 written
// per output key.  The design follows the TPU kernel's co-rank partition
// but not its frame: the TPU merged each tile with a bitonic network over
// a flipped copy of b, a workaround for its vector unit; here each thread
// merges its items one by one.
//   1. partition: for every tile boundary d = t * kTile, a binary search
//      on the merge-path diagonal finds the co-rank ai (how many of the
//      first d outputs come from a), with a before b on ties:
//      pred(i) = a[i] <= b[d - i - 1] (the rule of merge_pallas._coranks).
//   2. merge: each block loads its a and b segments (kTile keys together)
//      into shared memory with coalesced loads, each thread finds the
//      co-rank of its own kItems outputs in shared memory with the same
//      rule, merges them in order, and the block stores its tile with
//      coalesced writes.
// Empty sides, unequal lengths, runs of equal keys across tile or thread
// boundaries and INT64_MAX sentinels need no special case: the co-rank
// rule alone decides where every key goes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048, = ops/merge.py MERGE_TILE

// Smallest i in [max(0, d - nb), min(d, na)] with a[i] > b[d - i - 1]
// (or the upper end when there is none).
__device__ __forceinline__ long long corank(const long long* a, long long na,
                                            const long long* b, long long nb,
                                            long long d) {
  long long lo = d - nb > 0 ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - mid - 1])
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void partition(const long long* __restrict__ a, long long na,
                          const long long* __restrict__ b, long long nb,
                          long long* __restrict__ coranks, long long n_tiles) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > n_tiles) return;
  long long d = t * kTile;
  if (d > na + nb) d = na + nb;
  coranks[t] = corank(a, na, b, nb, d);
}

__global__ void merge_tiles(const long long* __restrict__ a, long long na,
                            const long long* __restrict__ b, long long nb,
                            const long long* __restrict__ coranks,
                            long long* __restrict__ out) {
  __shared__ long long in_s[kTile];
  __shared__ long long out_s[kTile];
  const long long n = na + nb;
  const long long d0 = (long long)blockIdx.x * kTile;
  const long long d1 = d0 + kTile < n ? d0 + kTile : n;
  const long long a0 = coranks[blockIdx.x], a1 = coranks[blockIdx.x + 1];
  const long long b0 = d0 - a0;
  const int la = (int)(a1 - a0);
  const int total = (int)(d1 - d0);
  const int lb = total - la;
  for (int j = threadIdx.x; j < total; j += kThreads)
    in_s[j] = j < la ? a[a0 + j] : b[b0 + (j - la)];
  __syncthreads();
  const long long* sa = in_s;
  const long long* sb = in_s + la;
  const int di = min((int)threadIdx.x * kItems, total);
  int ia = (int)corank(sa, la, sb, lb, di);
  int ib = di - ia;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (di + k >= total) break;
    const bool take_a = ib >= lb || (ia < la && sa[ia] <= sb[ib]);
    out_s[di + k] = take_a ? sa[ia++] : sb[ib++];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < total; j += kThreads) out[d0 + j] = out_s[j];
}

}  // namespace

extern "C" int cbl_merge_sorted(const void* a, long long na, const void* b,
                                long long nb, void* out, void* coranks,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = na + nb;
  const long long n_tiles = (n + kTile - 1) / kTile;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long pblocks = (n_tiles + 1 + kThreads - 1) / kThreads;
  partition<<<(unsigned)pblocks, kThreads, 0, s>>>(
      (const long long*)a, na, (const long long*)b, nb, (long long*)coranks,
      n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_tiles<<<(unsigned)n_tiles, kThreads, 0, s>>>(
      (const long long*)a, na, (const long long*)b, nb,
      (const long long*)coranks, (long long*)out);
  return (int)cudaGetLastError();
}
