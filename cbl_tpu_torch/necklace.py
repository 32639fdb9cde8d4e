"""Batched necklace computation and the packed word layout.

Counterpart of `cbl_tpu/necklace.py`.  The necklace of a 2K-bit k-mer is
its minimum over all 2K bit rotations; `pos` is the smallest left-rotation
amount reaching it.  The packed word is `(necklace << POS_BITS) | pos`,
held as one int64 key (see `limbs`).
"""

from __future__ import annotations

import torch

from .config import CBLConfig
from .limbs import low_mask
from .ops import necklace as _kernel


def necklace_pos(kmers: torch.Tensor, cfg: CBLConfig):
    """[N] int64 k-mers -> (necklace [N] int64, pos [N] int32), the plain
    tensor version (an unrolled loop over the 2K - 1 rotations)."""
    return _kernel.necklace_pos_plain(kmers, cfg.kmer_bits)


def necklace_pos_auto(kmers: torch.Tensor, cfg: CBLConfig):
    """Device dispatch: kernel B1 for a CUDA tensor, the plain version for
    a CPU one.  Both equal `py_necklace_pos`."""
    return _kernel.necklace_pos(kmers, cfg.kmer_bits)


def pack_word(necklace: torch.Tensor, pos: torch.Tensor, cfg: CBLConfig):
    """word = (necklace << POS_BITS) | pos."""
    return (necklace << cfg.pos_bits) | pos.to(torch.int64)


def unpack_word(word: torch.Tensor, cfg: CBLConfig):
    """word -> (necklace int64, pos int32)."""
    pos = (word & low_mask(cfg.pos_bits)).to(torch.int32)
    return word >> cfg.pos_bits, pos


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
