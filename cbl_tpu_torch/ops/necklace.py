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
"""

from __future__ import annotations

import ctypes

import torch

from ..limbs import LOW_BITS, MAX_KMER_BITS, low_mask
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
