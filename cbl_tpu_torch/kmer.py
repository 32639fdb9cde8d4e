"""2-bit k-mer encoding and batched extraction on int64 values.

Counterpart of `cbl_tpu/kmer.py`.  Base encoding A=0b00, C=0b01, T=0b10,
G=0b11, so complement is XOR 0b10; a k-mer is canonical iff its packed
value has even popcount (K is odd).  A k-mer is one int64 for 2K <= 62
and two columns above (`limbs`).  Host helpers are numpy; device code is
plain tensor arithmetic on int64 values that stay below 2^63.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CBLConfig
from .limbs import (
    LOW_BITS,
    MAX_KMER_BITS,
    chunks32,
    column_ranges,
    from_chunks,
    low_mask,
    place,
    shift_right,
    stack,
)

BASES_PER_WORD = 16

# ASCII -> 2-bit code; 255 = invalid (skipped).
NUC_LOOKUP = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACTG"):
    NUC_LOOKUP[_c] = _i
    NUC_LOOKUP[_c + 32] = _i  # lowercase
BASE_LOOKUP = np.frombuffer(b"ACTG", dtype=np.uint8)


def encode_seq(seq) -> np.ndarray:
    """ASCII sequence -> [M] uint8 base codes with invalid bytes removed."""
    if isinstance(seq, str):
        seq = seq.encode()
    raw = np.frombuffer(bytes(seq), dtype=np.uint8)
    codes = NUC_LOOKUP[raw]
    return codes[codes != 255]


def decode_codes(codes: np.ndarray) -> bytes:
    """[..., K] uint8 base codes -> ASCII."""
    return BASE_LOOKUP[np.asarray(codes)].tobytes()


def np_pack_stream(codes: np.ndarray) -> np.ndarray:
    """[S] uint8 codes (S % 16 == 0) -> [S/16] uint32, base s at bits
    [30 - 2*(s%16), 32 - 2*(s%16)) of word s//16 (big-endian bases).
    The native packer (`io.pack_stream_native`) first, numpy where it is
    unavailable."""
    from . import io as _io

    out = _io.pack_stream_native(codes)
    if out is not None:
        return out
    c = codes.reshape(-1, BASES_PER_WORD).astype(np.uint32)
    word = np.zeros(c.shape[0], dtype=np.uint32)
    for j in range(BASES_PER_WORD):
        word = (word << np.uint32(2)) | c[:, j]
    return word


def pack_stream(codes: torch.Tensor) -> torch.Tensor:
    """[S] uint8 base codes 0-3 (S % 16 == 0) on any device -> [S/16]
    int64 holding the uint32 words `np_pack_stream` gives, the dtype
    `extract_kmers` reads: a [S/16, 16] view shifted by 30, 28, ..., 0
    and summed (the bit fields are disjoint)."""
    if codes.dtype != torch.uint8 or codes.dim() != 1:
        raise ValueError(f"expected [S] uint8 codes, got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    if codes.shape[0] % BASES_PER_WORD:
        raise ValueError(f"{codes.shape[0]} codes are not a multiple of "
                         f"{BASES_PER_WORD}")
    shifts = torch.arange(2 * BASES_PER_WORD - 2, -1, -2, dtype=torch.int64,
                          device=codes.device)
    c = codes.reshape(-1, BASES_PER_WORD).to(torch.int64)
    return (c << shifts).sum(dim=1)


def extract_kmers(stream: torch.Tensor, n_kmers: int, cfg: CBLConfig):
    """Every k-mer of a packed base stream: [n_kmers] int64 values, or
    [2, n_kmers] for W > 62 (`limbs.kmer_cols`).

    stream: [S/16] int64 holding uint32 words (16 bases each, first base
    most significant).  K-mer i covers stream bits [2i, 2i + W), W = 2K.
    K-mers whose start has the same phase p = i % 16 read the same bit
    offset of words j .. j+4 (i = 16j + p; 2p + W <= 148 bits), so each
    phase and column is a few strided views and constant shifts
    (`limbs.place`); the 16 phases are then interleaved.  At W <= 62 only
    words j .. j+2 reach the value.  The tail is padded with L + 8 zero
    words, as `cbl_tpu.kmer.extract_kmers` pads it.
    """
    W = cfg.kmer_bits
    L = cfg.word_limbs
    n_words = (n_kmers + BASES_PER_WORD - 1) // BASES_PER_WORD
    s = torch.cat([stream, stream.new_zeros(L + 8)])
    out = []
    for lo, width in column_ranges(W):
        phases = []
        for p in range(BASES_PER_WORD):
            sh = 160 - 2 * p - W  # right shift of the 160-bit window j..j+4
            val = None
            for t in range(5):
                a = 128 - 32 * t - sh  # where the word's LSB lands
                if a - lo >= width or a - lo <= -32:
                    continue
                part = place(s[t : t + n_words], a, lo, width)
                val = part if val is None else val | part
            phases.append(val & low_mask(width))
        out.append(torch.stack(phases, dim=1).reshape(-1)[:n_kmers])
    return stack(out)


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


_COMPLEMENT = int("AA" * 16, 16)  # 0b10 in every base of 128 bits


def revcomp(kmers, cfg: CBLConfig):
    """Reverse complement of W-bit k-mer values: reverse the base order of
    the 64-bit register (two 32-bit halves, swapped) or, at W > 62, of
    the 128-bit one (four pieces, `limbs.chunks32`), realign to W bits,
    complement every base by XOR 0b10."""
    W = cfg.kmer_bits
    comp = low_mask(W) & _COMPLEMENT
    if W > MAX_KMER_BITS:
        pieces = [_reverse_bases32(c) for c in reversed(chunks32(kmers))]
        rev = from_chunks(pieces, 128 - W, W)
        return rev ^ torch.tensor([[comp >> LOW_BITS], [comp & low_mask(
            LOW_BITS)]], dtype=torch.int64, device=kmers.device)
    lo = _reverse_bases32(kmers & 0xFFFFFFFF)
    if W > 32:
        hi = _reverse_bases32(kmers >> 32)
        rev = (lo << (W - 32)) | (hi >> (64 - W))
    else:
        rev = lo >> (32 - W)
    return rev ^ comp


def popcount_parity(x):
    """Parity (0/1) of the popcount of non-negative int64 values, by XOR
    folding."""
    for s in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def is_canonical(kmers):
    """True where the popcount is even (over both columns of a wide
    k-mer)."""
    if kmers.dim() == 2:
        kmers = kmers[0] ^ kmers[1]
    return popcount_parity(kmers) == 0


def canonicalize(kmers, cfg: CBLConfig):
    """Per-k-mer canonical form (the even-popcount one of x and its reverse
    complement) and the is-canonical mask."""
    canon = is_canonical(kmers)
    return torch.where(canon, kmers, revcomp(kmers, cfg)), canon


def unpack_bases(kmers: torch.Tensor, cfg: CBLConfig) -> torch.Tensor:
    """[N] (or [2, N]) int64 k-mers -> [N, K] uint8 base codes (first
    base first)."""
    if kmers.dim() == 2:
        bases = [shift_right(kmers, cfg.kmer_bits - 2 - 2 * j, 1) & 3
                 for j in range(cfg.k)]
        return torch.stack(bases, dim=1).to(torch.uint8)
    shifts = torch.arange(cfg.kmer_bits - 2, -1, -2, dtype=torch.int64,
                          device=kmers.device)
    return ((kmers[:, None] >> shifts) & 3).to(torch.uint8)


def np_unpack_bases(kmers: np.ndarray, cfg: CBLConfig) -> np.ndarray:
    """[N, L] uint32 k-mer limbs -> [N, K] uint8 base codes (first base
    first), as `cbl_tpu.kmer.np_unpack_bases`."""
    W = cfg.kmer_bits
    L = kmers.shape[-1]
    cols = []
    for j in range(cfg.k):
        lo = W - 2 - 2 * j  # LSB index of base j; always even
        limb = L - 1 - lo // 32
        off = lo % 32
        cols.append(((kmers[..., limb] >> np.uint32(off)) & np.uint32(3)
                     ).astype(np.uint8))
    return np.stack(cols, axis=-1)


# --- k-mer neighbourhood of packed Python ints ---


def extend_kmer(v: int, base: int) -> int:
    """Append a base without dropping the first."""
    return (v << 2) | base


def append_kmer(v: int, base: int, k: int) -> int:
    """Append a base, dropping the first."""
    return ((v << 2) | base) & ((1 << (2 * k)) - 1)


def prepend_kmer(v: int, base: int, k: int) -> int:
    """Prepend a base, dropping the last."""
    return (v >> 2) | (base << (2 * (k - 1)))


def successors(v: int, k: int) -> list[int]:
    """The 4 k-mers reachable by appending a base."""
    return [append_kmer(v, b, k) for b in range(4)]


def predecessors(v: int, k: int) -> list[int]:
    """The 4 k-mers reachable by prepending a base."""
    return [prepend_kmer(v, b, k) for b in range(4)]


# --- host-side oracle helpers (tests, small inputs) ---


def kmer_to_int(codes) -> int:
    v = 0
    for c in codes:
        v = (v << 2) | int(c)
    return v


def int_to_codes(v: int, k: int) -> np.ndarray:
    return np.array([(v >> (2 * (k - 1 - j))) & 3 for j in range(k)],
                    dtype=np.uint8)


def py_revcomp(v: int, k: int) -> int:
    out = 0
    for _ in range(k):
        out = (out << 2) | ((v & 3) ^ 0b10)
        v >>= 2
    return out


def py_is_canonical(v: int) -> bool:
    return bin(v).count("1") % 2 == 0
