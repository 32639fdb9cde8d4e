"""Batched necklace computation and the packed word layout.

Counterpart of `cbl_tpu/necklace.py`.  The necklace of a 2K-bit k-mer is
its minimum over all 2K bit rotations; `pos` is the smallest left-rotation
amount reaching it.  The packed word is `(necklace << POS_BITS) | pos`,
held as one int64 key for n_bits <= 60 and as two int64 columns above;
a k-mer and its necklace are one int64 for 2K <= 62 and two columns
above (see `limbs`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kmer as kmod
from .config import CBLConfig
from .limbs import (
    SENTINEL,
    from_limbs,
    key_cols,
    kmer_cols,
    low_mask,
    rotate_right_var,
    shift_left,
    shift_right,
    to_limbs,
)
from .ops import necklace as _kernel


def necklace_pos(kmers: torch.Tensor, cfg: CBLConfig):
    """[N] (or [2, N]) int64 k-mers -> (necklace of the same shape, pos
    [N] int32), the plain tensor version (an unrolled loop over the 2K - 1
    rotations)."""
    return _kernel.necklace_pos_plain(kmers, cfg.kmer_bits)


def necklace_pos_auto(kmers: torch.Tensor, cfg: CBLConfig):
    """Device dispatch: kernel B1 for a CUDA tensor, the plain version for
    a CPU one.  Both equal `py_necklace_pos`."""
    return _kernel.necklace_pos(kmers, cfg.kmer_bits)


def stream_words_plain(stream: torch.Tensor, n: int, cfg: CBLConfig,
                       canonical: bool, blank=None) -> torch.Tensor:
    """The word pipeline as plain tensor steps: `kmer.extract_kmers`,
    (`kmer.canonicalize`), `necklace_pos`, `pack_word`, then `SENTINEL`
    where `blank` (an [n] int32 mask) is non-zero."""
    kmers = kmod.extract_kmers(stream, n, cfg)
    if canonical:
        kmers, _ = kmod.canonicalize(kmers, cfg)
    words = pack_word(*necklace_pos(kmers, cfg), cfg)
    return words if blank is None else torch.where(blank.bool(), SENTINEL,
                                                   words)


def stream_words(stream: torch.Tensor, n: int, cfg: CBLConfig,
                 canonical: bool, blank=None) -> torch.Tensor:
    """Packed stream -> [n] (or [2, n]) int64 words of its first n k-mer
    starts, `SENTINEL` where `blank` is non-zero: `stream_words_plain`
    for a CPU stream, kernel B1 from the stream (one launch) for a CUDA
    one."""
    if stream.device.type == "cpu":
        return stream_words_plain(stream, n, cfg, canonical, blank)
    return _kernel.stream_words(stream, n, cfg.kmer_bits, cfg.pos_bits,
                                key_cols(cfg), canonical, blank)


def pack_word(necklace: torch.Tensor, pos: torch.Tensor, cfg: CBLConfig):
    """word = (necklace << POS_BITS) | pos, in `key_cols` columns."""
    if key_cols(cfg) == 1:
        return (necklace << cfg.pos_bits) | pos.to(torch.int64)
    word = shift_left(necklace, cfg.pos_bits, 2)
    word[1] |= pos.to(torch.int64)
    return word


def unpack_word(word: torch.Tensor, cfg: CBLConfig):
    """word -> (necklace int64 in `kmer_cols` columns, pos int32)."""
    low = word if word.dim() == 1 else word[1]
    pos = (low & low_mask(cfg.pos_bits)).to(torch.int32)
    return shift_right(word, cfg.pos_bits, kmer_cols(cfg)), pos


def revert_necklace_pos(necklace: torch.Tensor, pos: torch.Tensor,
                        cfg: CBLConfig) -> torch.Tensor:
    """Rotate each necklace right by its pos: the k-mer it came from."""
    W = cfg.kmer_bits
    p = pos.to(torch.int64)
    if necklace.dim() == 2:
        return rotate_right_var(necklace, p, W)
    return ((necklace >> p) | (necklace << ((W - p) % W))) & low_mask(W)


def word_to_kmer(word: torch.Tensor, cfg: CBLConfig) -> torch.Tensor:
    """[N] (or [2, N]) int64 words -> k-mers in `kmer_cols` columns."""
    necklace, pos = unpack_word(word, cfg)
    return revert_necklace_pos(necklace, pos, cfg)


def word_prefix(word: torch.Tensor, cfg: CBLConfig) -> torch.Tensor:
    """prefix = word >> SUFFIX_BITS, as one int64 column (below 2^32; at
    K=59 and prefix 28 it reads column 0 alone)."""
    if word.dim() == 1:
        return word >> cfg.suffix_bits
    return shift_right(word, cfg.suffix_bits, 1)


def np_word_to_kmer(words: np.ndarray, cfg: CBLConfig) -> np.ndarray:
    """Host decode of exported words: [N, L] uint32 word limbs -> [N, L]
    uint32 k-mer limbs, as `cbl_tpu.necklace.np_word_to_kmer`."""
    words = np.asarray(words, dtype=np.uint32)
    if key_cols(cfg) == 2:
        keys = torch.from_numpy(from_limbs(words, 2))
        return to_limbs(word_to_kmer(keys, cfg).numpy(), words.shape[1])
    W = cfg.kmer_bits
    u = words.astype(np.uint64)
    key = u[:, 0]
    for l in range(1, u.shape[1]):
        key = (key << np.uint64(32)) | u[:, l]
    pos = key & np.uint64(low_mask(cfg.pos_bits))
    neck = key >> np.uint64(cfg.pos_bits)
    left = (np.uint64(W) - pos) % np.uint64(W)
    kmer = ((neck >> pos) | (neck << left)) & np.uint64(low_mask(W))
    return to_limbs(kmer.astype(np.int64), u.shape[1])


def py_necklace_pos(word: int, bits: int) -> tuple[int, int]:
    """Pure-python transcription of the necklace definition (test oracle)."""
    best = word
    pos = 0
    mask = (1 << bits) - 1
    for p in range(1, bits):
        rot = ((word << p) & mask) | (word >> (bits - p))
        if rot < best:
            best = rot
            pos = p
    return best, pos
