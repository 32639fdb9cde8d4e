// Kernel B1: batched necklace (minimum bit rotation) of k-mer values.
//
// Replaces the TPU kernel cbl_tpu/ops/necklace_pallas.py
// `necklace_pos_pallas` (`_kernel_fn`).  For each W-bit value (W = 2K) it
// finds the minimum over all W left rotations and the smallest rotation
// amount that reaches it (the tie rule of cbl_tpu.necklace.py_necklace_pos).
//
// Two forms, one rotation loop (`necklace1`, `necklace2`):
// - from values (`cbl_necklace_pos`, `cbl_necklace_pos_wide`): k-mers in,
//   the necklace (int64) and the position (int32) out;
// - from the packed stream (`cbl_stream_words`), the word pipeline's one
//   kernel: each thread builds its k-mer from the stream words it covers
//   (what cbl_tpu_torch.kmer.extract_kmers does for one phase; words past
//   the stream's end read as 0), takes the even-popcount one of it and its
//   reverse complement when the index is canonical (kmer.canonicalize),
//   rotates, and writes the packed word (necklace << pos_bits) | pos in the
//   key layout of necklace.pack_word; a row that B2's mask blanks is
//   written as SENTINEL without the loop.  Neither the k-mers nor the
//   necklaces and positions pass through device memory.
//
// What bounds it on the H100: integer instruction throughput, not memory.
// The stream form reads 0.5 bytes of stream and 4 of mask a k-mer and
// writes 8 (16 for a two-column word), but each k-mer takes W - 1 rotation
// steps of 64-bit shift / or / and / compare / select, each several 32-bit
// instructions.  The TPU kernel tiled k-mers as [BR, 128] vregs to keep its
// carry out of HBM; here the carry (rot, best, pos) lives in registers, one
// thread per k-mer, grid-stride.  Neighbouring threads share stream words
// (16 k-mer starts a word), read through L1.  A k-mer of W <= 62 bits is
// one 64-bit register (`necklace_pos_kernel`); a wider one (W up to 118)
// is two (`necklace_pos_wide_kernel`).  At K=59 the record halos blank 58
// of every 150 rows, so whole warps skip the loop.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr u64 kLow63 = 0x7fffffffffffffffull;
constexpr u64 kComplement = 0xaaaaaaaaaaaaaaaaull;  // 0b10 in every base
constexpr long long kSentinel = 0x7fffffffffffffffll;

struct Args {
  // the value form: k-mers (column 0 and, at W > 62, column 1, the low 63
  // bits); outputs: the necklace's columns in out0 / out1, positions in pos
  const long long* in0;
  const long long* in1;
  int* pos;
  // the stream form: int64 holding uint32 words, 16 bases each, the first
  // base most significant; B2's int32 mask (1 = blanked) or null; outputs:
  // the word's columns in out0 and, for a two-column word, out1
  const long long* stream;
  long long n_stream;
  const int* blank;
  int pos_bits;
  int canonical;
  long long* out0;
  long long* out1;
  long long n;
  int W;
};

__device__ __forceinline__ u64 stream_word(const Args& a, long long j) {
  return j < a.n_stream ? (u64)__ldg(a.stream + j) & 0xffffffffull : 0ull;
}

// Reverse the 32 bases (2-bit groups) of a 64-bit register.
__device__ __forceinline__ u64 reverse_bases(u64 x) {
  const u64 r = __brevll(x);
  return ((r >> 1) & 0x5555555555555555ull) |
         ((r & 0x5555555555555555ull) << 1);
}

__device__ __forceinline__ u64 necklace1(u64 x, int W, int* best_pos) {
  const u64 mask = (1ull << W) - 1;
  u64 rot = x, best = x;
  int bp = 0;
  for (int p = 1; p < W; ++p) {
    rot = ((rot << 1) | (rot >> (W - 1))) & mask;
    if (rot < best) {
      best = rot;
      bp = p;
    }
  }
  *best_pos = bp;
  return best;
}

// The value as two 64-bit halves h:l, l the low 64 bits (W from 66 to
// 118): each of the W - 1 one-bit rotations shifts the pair with a carry
// from l into h and the value's top bit (bit W - 65 of h) into l.  The
// comparison is lexicographic over (h, l); ties keep the smallest position.
// About 2.5x the one-column step.
__device__ __forceinline__ void necklace2(u64& h, u64& l, int W,
                                          int* best_pos) {
  const int top = W - 65;  // the value's top bit, inside h
  const u64 hmask = (1ull << (W - 64)) - 1;
  u64 bh = h, bl = l;
  int bp = 0;
  for (int p = 1; p < W; ++p) {
    const u64 msb = (h >> top) & 1;
    h = ((h << 1) | (l >> 63)) & hmask;
    l = (l << 1) | msb;
    if (h < bh || (h == bh && l < bl)) {
      bh = h;
      bl = l;
      bp = p;
    }
  }
  h = bh;
  l = bl;
  *best_pos = bp;
}

// The stream form's end: (necklace h:l << pos_bits) | pos in one column
// (n_bits <= 60) or as (value >> 63, value & low 63 bits).
__device__ __forceinline__ void store_word(const Args& a, long long i, u64 h,
                                           u64 l, int pos) {
  const u64 wl = (l << a.pos_bits) | (u64)pos;
  if (a.out1 == nullptr) {
    a.out0[i] = (long long)wl;
    return;
  }
  const u64 wh = (h << a.pos_bits) | (l >> (64 - a.pos_bits));
  a.out0[i] = (long long)((wh << 1) | (wl >> 63));
  a.out1[i] = (long long)(wl & kLow63);
}

__device__ __forceinline__ bool blanked(const Args& a, long long i) {
  if (a.blank == nullptr || __ldg(a.blank + i) == 0) return false;
  a.out0[i] = kSentinel;
  if (a.out1 != nullptr) a.out1[i] = kSentinel;
  return true;
}

// W <= 62.  k-mer i = 16 j + p covers bits [2i, 2i + W) of the stream:
// bits [2p, 2p + W) of words j .. j+2.
template <bool kStream>
__global__ void necklace_pos_kernel(const Args a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.n; i += stride) {
    u64 x;
    if (kStream) {
      if (blanked(a, i)) continue;
      const long long j = i >> 4;
      const int sh = 2 * (int)(i & 15);
      const u64 t = (stream_word(a, j) << 32) | stream_word(a, j + 1);
      const u64 u = (t << sh) | (stream_word(a, j + 2) >> (32 - sh));
      x = u >> (64 - a.W);
      if (a.canonical && (__popcll(x) & 1))
        x = (reverse_bases(x) ^ kComplement) >> (64 - a.W);
    } else {
      x = (u64)a.in0[i];
    }
    int pos;
    const u64 best = necklace1(x, a.W, &pos);
    if (kStream) {
      store_word(a, i, 0, best, pos);
    } else {
      a.out0[i] = (long long)best;
      a.pos[i] = pos;
    }
  }
}

// 64 < W <= 118: bits [2p, 2p + W) of words j .. j+4.
template <bool kStream>
__global__ void necklace_pos_wide_kernel(const Args a) {
  const int s = 128 - a.W;  // 10 .. 62: the value's shift in 128 bits
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.n; i += stride) {
    u64 h, l;
    if (kStream) {
      if (blanked(a, i)) continue;
      const long long j = i >> 4;
      const int sh = 2 * (int)(i & 15);
      const u64 w0 = (stream_word(a, j) << 32) | stream_word(a, j + 1);
      const u64 w1 = (stream_word(a, j + 2) << 32) | stream_word(a, j + 3);
      const u64 hi = sh ? (w0 << sh) | (w1 >> (64 - sh)) : w0;
      const u64 lo = (w1 << sh) | (stream_word(a, j + 4) >> (32 - sh));
      h = hi >> s;
      l = (lo >> s) | (hi << (64 - s));
      if (a.canonical && ((__popcll(h) + __popcll(l)) & 1)) {
        const u64 rh = reverse_bases(l), rl = reverse_bases(h);
        h = (rh >> s) ^ (kComplement >> s);
        l = ((rl >> s) | (rh << (64 - s))) ^ kComplement;
      }
    } else {
      const u64 c0 = (u64)a.in0[i], c1 = (u64)a.in1[i];
      h = c0 >> 1;
      l = c1 | (c0 << 63);
    }
    int pos;
    necklace2(h, l, a.W, &pos);
    if (kStream) {
      store_word(a, i, h, l, pos);
    } else {
      a.out0[i] = (long long)((h << 1) | (l >> 63));
      a.out1[i] = (long long)(l & kLow63);
      a.pos[i] = pos;
    }
  }
}

long long grid_blocks(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  return blocks > 65535 ? 65535 : blocks;  // grid-stride loop covers the rest
}

int launch(const Args& a, bool from_stream, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)grid_blocks(a.n, threads);
  if (a.W > 62) {
    if (from_stream)
      necklace_pos_wide_kernel<true><<<blocks, threads, 0, stream>>>(a);
    else
      necklace_pos_wide_kernel<false><<<blocks, threads, 0, stream>>>(a);
  } else {
    if (from_stream)
      necklace_pos_kernel<true><<<blocks, threads, 0, stream>>>(a);
    else
      necklace_pos_kernel<false><<<blocks, threads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cbl_necklace_pos(const void* in, void* neck, void* pos,
                                long long n, int W, void* stream) {
  if (W < 1 || W > 62) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.in0 = (const long long*)in;
  a.out0 = (long long*)neck;
  a.pos = (int*)pos;
  a.n = n;
  a.W = W;
  return launch(a, false, (cudaStream_t)stream);
}

// in_hi/in_lo and neck_hi/neck_lo: columns 0 and 1 of the k-mers and of
// the necklaces; 64 < W <= 118.
extern "C" int cbl_necklace_pos_wide(const void* in_hi, const void* in_lo,
                                     void* neck_hi, void* neck_lo, void* pos,
                                     long long n, int W, void* stream) {
  if (W <= 64 || W > 118) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.in0 = (const long long*)in_hi;
  a.in1 = (const long long*)in_lo;
  a.out0 = (long long*)neck_hi;
  a.out1 = (long long*)neck_lo;
  a.pos = (int*)pos;
  a.n = n;
  a.W = W;
  return launch(a, false, (cudaStream_t)stream);
}

// The words of k-mer starts 0 .. n-1 of a packed stream of n_stream words:
// one column (word1 null; W + pos_bits <= 60) or two (W + pos_bits <= 125);
// W even, 2 <= W <= 118, W != 64; blank: n int32 or null.
extern "C" int cbl_stream_words(const void* words, long long n_stream,
                                const void* blank, void* word0, void* word1,
                                long long n, int W, int pos_bits,
                                int canonical, void* stream) {
  if (W < 2 || W > 118 || W == 64 || (W & 1) || pos_bits < 1 ||
      pos_bits > 7 || W + pos_bits > (word1 == nullptr ? 60 : 125) ||
      (W > 62 && word1 == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.stream = (const long long*)words;
  a.n_stream = n_stream;
  a.blank = (const int*)blank;
  a.pos_bits = pos_bits;
  a.canonical = canonical;
  a.out0 = (long long*)word0;
  a.out1 = (long long*)word1;
  a.n = n;
  a.W = W;
  return launch(a, true, (cudaStream_t)stream);
}
