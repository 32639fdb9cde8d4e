// Kernel B1: batched necklace (minimum bit rotation) of k-mer values.
//
// Replaces the TPU kernel cbl_tpu/ops/necklace_pallas.py
// `necklace_pos_pallas` (`_kernel_fn`).  For each W-bit value (W = 2K) it
// writes the minimum over all W left rotations (int64) and the smallest
// rotation amount that reaches it (int32), the tie rule of
// cbl_tpu.necklace.py_necklace_pos.
//
// What bounds it on the H100: integer instruction throughput, not memory.
// Each k-mer is 8 bytes read and 12 bytes written, but W - 1 rotation
// steps of 64-bit shift / or / and / compare / select, each several 32-bit
// instructions.
// The TPU kernel tiled k-mers as [BR, 128] vregs to keep its carry out of
// HBM; here the carry (rot, best, pos) simply lives in registers, one
// thread per k-mer, so device memory is touched once per k-mer.  Any N
// works (the TPU kernel needed N % 1024 == 0).

#include <cuda_runtime.h>

namespace {

__global__ void necklace_pos_kernel(const long long* __restrict__ in,
                                    long long* __restrict__ neck,
                                    int* __restrict__ pos, long long n,
                                    int W) {
  const unsigned long long mask = (1ull << W) - 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long x = (unsigned long long)in[i];
    unsigned long long rot = x, best = x;
    int best_pos = 0;
    for (int p = 1; p < W; ++p) {
      rot = ((rot << 1) | (rot >> (W - 1))) & mask;
      if (rot < best) {
        best = rot;
        best_pos = p;
      }
    }
    neck[i] = (long long)best;
    pos[i] = best_pos;
  }
}

}  // namespace

extern "C" int cbl_necklace_pos(const void* in, void* neck, void* pos,
                                long long n, int W, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;  // grid-stride loop covers the rest
  necklace_pos_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
      (const long long*)in, (long long*)neck, (int*)pos, n, W);
  return (int)cudaGetLastError();
}
