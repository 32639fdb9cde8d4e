"""2-bit k-mer encoding and batched extraction on int64 keys.

Counterpart of `cbl_tpu/kmer.py`.  Base encoding A=0b00, C=0b01, T=0b10,
G=0b11, so complement is XOR 0b10; a k-mer is canonical iff its packed
value has even popcount (K is odd).  Host helpers are numpy; device code
is plain tensor arithmetic on int64 values that stay below 2^63.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CBLConfig
from .limbs import low_mask

BASES_PER_WORD = 16

# ASCII -> 2-bit code; 255 = invalid (skipped).
NUC_LOOKUP = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACTG"):
    NUC_LOOKUP[_c] = _i
    NUC_LOOKUP[_c + 32] = _i  # lowercase


def encode_seq(seq) -> np.ndarray:
    """ASCII sequence -> [M] uint8 base codes with invalid bytes removed."""
    if isinstance(seq, str):
        seq = seq.encode()
    raw = np.frombuffer(bytes(seq), dtype=np.uint8)
    codes = NUC_LOOKUP[raw]
    return codes[codes != 255]


def np_pack_stream(codes: np.ndarray) -> np.ndarray:
    """[S] uint8 codes (S % 16 == 0) -> [S/16] uint32, base s at bits
    [30 - 2*(s%16), 32 - 2*(s%16)) of word s//16 (big-endian bases)."""
    c = codes.reshape(-1, BASES_PER_WORD).astype(np.uint32)
    word = np.zeros(c.shape[0], dtype=np.uint32)
    for j in range(BASES_PER_WORD):
        word = (word << np.uint32(2)) | c[:, j]
    return word


def extract_kmers(stream: torch.Tensor, n_kmers: int, cfg: CBLConfig):
    """Every k-mer of a packed base stream as [n_kmers] int64 values.

    stream: [S/16] int64 holding uint32 words (16 bases each, first base
    most significant).  K-mer i covers stream bits [2i, 2i + W), W = 2K.
    K-mers whose start has the same phase p = i % 16 read the same bit
    offset of words j, j+1, j+2 (i = 16j + p; 2p + W <= 84 bits), so each
    phase is three strided views and constant shifts; the 16 phases are
    then interleaved.  The tail is padded with L + 8 zero words, as
    `cbl_tpu.kmer.extract_kmers` pads it.
    """
    W = cfg.kmer_bits
    L = cfg.word_limbs
    n_words = (n_kmers + BASES_PER_WORD - 1) // BASES_PER_WORD
    s = torch.cat([stream, stream.new_zeros(L + 8)])
    phases = []
    for p in range(BASES_PER_WORD):
        sh = 96 - 2 * p - W  # right shift of the 96-bit window j..j+2
        val = None
        for t in range(3):
            w = s[t : t + n_words]
            a = 64 - 32 * t - sh  # where the word's LSB lands
            if a >= W:
                continue
            if a >= 0:
                part = (w & low_mask(W - a)) << a
            elif -a >= 32:
                continue
            else:
                part = w >> -a
            val = part if val is None else val | part
        phases.append(val & low_mask(W))
    return torch.stack(phases, dim=1).reshape(-1)[:n_kmers]


def _reverse_bases32(x):
    """Reverse the 16 bases (2-bit groups) of values in [0, 2^32)."""
    x = (
        ((x >> 24) & 0xFF)
        | ((x >> 8) & 0xFF00)
        | ((x << 8) & 0xFF0000)
        | ((x << 24) & 0xFF000000)
    )
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    return ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)


def revcomp(kmers, cfg: CBLConfig):
    """Reverse complement of W-bit k-mer values: reverse the base order of
    the 64-bit register (two 32-bit halves, swapped), realign to W bits,
    complement every base by XOR 0b10."""
    W = cfg.kmer_bits
    lo = _reverse_bases32(kmers & 0xFFFFFFFF)
    if W > 32:
        hi = _reverse_bases32(kmers >> 32)
        rev = (lo << (W - 32)) | (hi >> (64 - W))
    else:
        rev = lo >> (32 - W)
    return rev ^ (low_mask(W) & 0xAAAAAAAAAAAAAAAA)


def popcount_parity(x):
    """Parity (0/1) of the popcount of non-negative int64 values, by XOR
    folding."""
    for s in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def is_canonical(kmers):
    """True where the popcount is even."""
    return popcount_parity(kmers) == 0


def canonicalize(kmers, cfg: CBLConfig):
    """Per-k-mer canonical form (the even-popcount one of x and its reverse
    complement) and the is-canonical mask."""
    canon = is_canonical(kmers)
    return torch.where(canon, kmers, revcomp(kmers, cfg)), canon
