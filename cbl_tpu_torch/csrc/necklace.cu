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
// works (the TPU kernel needed N % 1024 == 0).  The TPU kernel took k-mers
// of up to four uint32 limbs (W <= 118); here a k-mer of W <= 62 bits is
// one int64 (`necklace_pos_kernel`) and a wider one two int64 columns
// (`necklace_pos_wide_kernel`, 16 bytes read and 20 written a k-mer).

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

// Two int64 columns a k-mer, column 1 the low 63 bits (W from 64 to 118,
// K >= 33): the value is held as two 64-bit halves h:l in registers, l the
// low 64 bits, and each of the W - 1 one-bit rotations shifts the pair with
// a carry from l into h and the value's top bit (bit W - 65 of h) into l.
// The comparison is lexicographic over (h, l); ties keep the smallest
// position.  Bound by integer instructions: each step is a 64-bit shift
// pair with carries, a 128-bit compare and four selects, about 2.5x the
// one-column step.
__global__ void necklace_pos_wide_kernel(const long long* __restrict__ in_hi,
                                         const long long* __restrict__ in_lo,
                                         long long* __restrict__ neck_hi,
                                         long long* __restrict__ neck_lo,
                                         int* __restrict__ pos, long long n,
                                         int W) {
  const int top = W - 65;  // the value's top bit, inside h
  const unsigned long long hmask = (1ull << (W - 64)) - 1;
  const unsigned long long low63 = 0x7fffffffffffffffull;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long c0 = (unsigned long long)in_hi[i];
    const unsigned long long c1 = (unsigned long long)in_lo[i];
    unsigned long long h = c0 >> 1, l = c1 | (c0 << 63);
    unsigned long long bh = h, bl = l;
    int best_pos = 0;
    for (int p = 1; p < W; ++p) {
      const unsigned long long msb = (h >> top) & 1;
      h = ((h << 1) | (l >> 63)) & hmask;
      l = (l << 1) | msb;
      if (h < bh || (h == bh && l < bl)) {
        bh = h;
        bl = l;
        best_pos = p;
      }
    }
    neck_hi[i] = (long long)((bh << 1) | (bl >> 63));
    neck_lo[i] = (long long)(bl & low63);
    pos[i] = best_pos;
  }
}

long long grid_blocks(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  return blocks > 65535 ? 65535 : blocks;  // grid-stride loop covers the rest
}

}  // namespace

extern "C" int cbl_necklace_pos(const void* in, void* neck, void* pos,
                                long long n, int W, void* stream) {
  const int threads = 256;
  necklace_pos_kernel<<<(unsigned)grid_blocks(n, threads), threads, 0,
                        (cudaStream_t)stream>>>(
      (const long long*)in, (long long*)neck, (int*)pos, n, W);
  return (int)cudaGetLastError();
}

// in_hi/in_lo and neck_hi/neck_lo: columns 0 and 1 of the k-mers and of
// the necklaces; 64 < W <= 118.
extern "C" int cbl_necklace_pos_wide(const void* in_hi, const void* in_lo,
                                     void* neck_hi, void* neck_lo, void* pos,
                                     long long n, int W, void* stream) {
  if (W <= 64 || W > 118) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  necklace_pos_wide_kernel<<<(unsigned)grid_blocks(n, threads), threads, 0,
                             (cudaStream_t)stream>>>(
      (const long long*)in_hi, (const long long*)in_lo, (long long*)neck_hi,
      (long long*)neck_lo, (int*)pos, n, W);
  return (int)cudaGetLastError();
}
