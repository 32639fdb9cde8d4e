"""Kernel B1: the batched necklace (minimum rotation) of k-mer values.

Replaces `cbl_tpu/ops/necklace_pallas.py` `necklace_pos_pallas`.  For each
W-bit value (W = 2K) it returns the minimum over all W left rotations and
the smallest rotation amount that reaches it (ties go to the smallest
position, as `cbl_tpu.necklace.py_necklace_pos`).  A value of W <= 62
bits is one int64 ([N] tensor); a wider one (W from 64 to 118) is two
int64 columns, column 1 the low 63 bits (a [2, N] tensor, `limbs`).

`necklace_pos` takes the plain version for a CPU tensor and launches the
CUDA kernel (`csrc/necklace.cu`: `cbl_necklace_pos` for one column,
`cbl_necklace_pos_wide` for two) for a CUDA tensor.

`stream_words` is the word pipeline's form of the same kernel (CUDA only;
`necklace.stream_words` dispatches, with the plain chain on the CPU): it
reads the packed stream, builds each k-mer, canonicalizes it when asked,
rotates and writes the packed word, `SENTINEL` where B2's mask blanks the
row, in one launch.
"""

from __future__ import annotations

import ctypes

import torch

from ..limbs import LOW_BITS, MAX_KEY_BITS, MAX_KMER_BITS, low_mask
from . import _build


def necklace_pos_plain(kmers: torch.Tensor, W: int):
    """[N] int64 W-bit values -> (necklace [N] int64, pos [N] int32): an
    unrolled loop over the W - 1 one-bit rotations.  [2, N] values of
    W > 62 bits go to `necklace_pos_plain_wide`."""
    if kmers.dim() == 2:
        return necklace_pos_plain_wide(kmers, W)
    mask = low_mask(W)
    rot = best = kmers
    pos = torch.zeros(kmers.shape, dtype=torch.int32, device=kmers.device)
    for p in range(1, W):
        rot = ((rot << 1) | (rot >> (W - 1))) & mask
        better = rot < best
        best = torch.where(better, rot, best)
        pos = torch.where(better, p, pos)
    return best, pos


def necklace_pos_plain_wide(kmers: torch.Tensor, W: int):
    """[2, N] int64 values of W bits (63 < W <= 126), column 1 the low 63
    -> (necklace [2, N], pos [N] int32): the W - 1 one-bit rotations of
    the (column 0, column 1) pair, the comparison lexicographic."""
    hmask, low = low_mask(W - LOW_BITS), low_mask(LOW_BITS)
    top = W - 1 - LOW_BITS  # the value's top bit, in column 0
    rh = bh = kmers[0]
    rl = bl = kmers[1]
    pos = torch.zeros(rl.shape, dtype=torch.int32, device=kmers.device)
    for p in range(1, W):
        msb = (rh >> top) & 1
        rh = ((rh << 1) | (rl >> (LOW_BITS - 1))) & hmask
        rl = ((rl << 1) & low) | msb
        better = (rh < bh) | ((rh == bh) & (rl < bl))
        bh = torch.where(better, rh, bh)
        bl = torch.where(better, rl, bl)
        pos = torch.where(better, p, pos)
    return torch.stack([bh, bl]), pos


def necklace_pos(kmers: torch.Tensor, W: int):
    """`necklace_pos_plain` on the CPU; on CUDA, kernel B1 (one column for
    W <= 62, two columns for W from 64 to 118)."""
    wide = W > MAX_KMER_BITS
    if kmers.dtype != torch.int64 or kmers.dim() != (2 if wide else 1) or (
            wide and kmers.shape[0] != 2):
        raise ValueError(
            f"expected {'[2, N]' if wide else '[N]'} int64 values for W={W},"
            f" got {kmers.dtype} {tuple(kmers.shape)}"
        )
    if not 1 <= W <= 118:
        raise ValueError(f"rotation width {W} outside [1, 118]")
    if kmers.device.type == "cpu":
        return necklace_pos_plain(kmers, W)
    cols = tuple(kmers) if wide else (kmers,)
    _build.check_cuda(*cols)
    n = kmers.shape[-1]
    neck = torch.empty_like(kmers)
    pos = torch.empty(n, dtype=torch.int32, device=kmers.device)
    if n == 0:
        return neck, pos
    lib = _build.library()
    stream = _build.stream_handle(kmers.device)
    if wide:
        err = lib.cbl_necklace_pos_wide(
            ctypes.c_void_p(cols[0].data_ptr()),
            ctypes.c_void_p(cols[1].data_ptr()),
            ctypes.c_void_p(neck[0].data_ptr()),
            ctypes.c_void_p(neck[1].data_ptr()),
            ctypes.c_void_p(pos.data_ptr()),
            ctypes.c_longlong(n), ctypes.c_int(W), stream,
        )
        _build.check_error(err, "necklace_wide")
        _build.LAUNCHES["necklace_wide"] += 1
        return neck, pos
    err = lib.cbl_necklace_pos(
        ctypes.c_void_p(kmers.data_ptr()),
        ctypes.c_void_p(neck.data_ptr()),
        ctypes.c_void_p(pos.data_ptr()),
        ctypes.c_longlong(n),
        ctypes.c_int(W),
        stream,
    )
    _build.check_error(err, "necklace")
    _build.LAUNCHES["necklace"] += 1
    return neck, pos


def stream_words(stream: torch.Tensor, n: int, W: int, pos_bits: int,
                 n_cols: int, canonical: bool, blank=None) -> torch.Tensor:
    """Kernel B1 from a packed stream (CUDA tensors): the packed words
    (necklace << pos_bits) | pos of k-mer starts 0 .. n-1, [n] int64 for
    n_cols = 1 and [2, n] (column 1 the low 63 bits) for 2, canonical
    k-mers when `canonical`, `SENTINEL` where `blank` (B2's [n] int32
    mask) is non-zero.  stream: [S/16] int64 holding uint32 words, as
    `kmer.extract_kmers` reads it; words past its end read as 0."""
    if stream.dtype != torch.int64 or stream.dim() != 1:
        raise ValueError(f"expected a [S/16] int64 stream, got "
                         f"{stream.dtype} {tuple(stream.shape)}")
    if blank is not None and (blank.dtype != torch.int32 or
                              tuple(blank.shape) != (n,)):
        raise ValueError(f"expected a [{n}] int32 mask, got {blank.dtype} "
                         f"{tuple(blank.shape)}")
    if not 2 <= W <= 118 or W % 2 or W == 64:
        raise ValueError(f"k-mer width {W} is not 2K for an odd K <= 59")
    if n_cols not in (1, 2) or W + pos_bits > (
            MAX_KEY_BITS if n_cols == 1 else LOW_BITS + 62) or (
            W > MAX_KMER_BITS and n_cols == 1):
        raise ValueError(f"{W + pos_bits}-bit words do not fit {n_cols} "
                         f"int64 column(s)")
    _build.check_cuda(stream, *(() if blank is None else (blank,)))
    shape = (n,) if n_cols == 1 else (2, n)
    out = torch.empty(shape, dtype=torch.int64, device=stream.device)
    if n == 0:
        return out
    err = _build.library().cbl_stream_words(
        ctypes.c_void_p(stream.data_ptr()),
        ctypes.c_longlong(stream.shape[0]),
        ctypes.c_void_p(None if blank is None else blank.data_ptr()),
        ctypes.c_void_p(out.data_ptr() if n_cols == 1 else out[0].data_ptr()),
        ctypes.c_void_p(None if n_cols == 1 else out[1].data_ptr()),
        ctypes.c_longlong(n), ctypes.c_int(W), ctypes.c_int(pos_bits),
        ctypes.c_int(int(canonical)), _build.stream_handle(stream.device),
    )
    key = "necklace_wide" if W > MAX_KMER_BITS else "necklace"
    _build.check_error(err, key)
    _build.LAUNCHES[key] += 1
    return out
