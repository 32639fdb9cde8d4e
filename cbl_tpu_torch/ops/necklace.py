"""Kernel B1: the batched necklace (minimum rotation) of k-mer values.

Replaces `cbl_tpu/ops/necklace_pallas.py` `necklace_pos_pallas`.  For each
W-bit value (W = 2K) it returns the minimum over all W left rotations and
the smallest rotation amount that reaches it (ties go to the smallest
position, as `cbl_tpu.necklace.py_necklace_pos`).

`necklace_pos` takes the plain version for a CPU tensor and launches the
CUDA kernel (`csrc/necklace.cu`) for a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

from ..limbs import low_mask
from . import _build


def necklace_pos_plain(kmers: torch.Tensor, W: int):
    """[N] int64 W-bit values -> (necklace [N] int64, pos [N] int32): an
    unrolled loop over the W - 1 one-bit rotations."""
    mask = low_mask(W)
    rot = best = kmers
    pos = torch.zeros(kmers.shape, dtype=torch.int32, device=kmers.device)
    for p in range(1, W):
        rot = ((rot << 1) | (rot >> (W - 1))) & mask
        better = rot < best
        best = torch.where(better, rot, best)
        pos = torch.where(better, p, pos)
    return best, pos


def necklace_pos(kmers: torch.Tensor, W: int):
    """`necklace_pos_plain` on the CPU; on CUDA, kernel B1."""
    if kmers.dtype != torch.int64 or kmers.dim() != 1:
        raise ValueError(
            f"expected a 1-D int64 tensor, got {kmers.dtype} {tuple(kmers.shape)}"
        )
    if not 1 <= W <= 62:
        raise ValueError(f"rotation width {W} outside [1, 62]")
    if kmers.device.type == "cpu":
        return necklace_pos_plain(kmers, W)
    _build.check_cuda(kmers)
    n = kmers.shape[0]
    neck = torch.empty_like(kmers)
    pos = torch.empty(n, dtype=torch.int32, device=kmers.device)
    if n == 0:
        return neck, pos
    lib = _build.library()
    err = lib.cbl_necklace_pos(
        ctypes.c_void_p(kmers.data_ptr()),
        ctypes.c_void_p(neck.data_ptr()),
        ctypes.c_void_p(pos.data_ptr()),
        ctypes.c_longlong(n),
        ctypes.c_int(W),
        _build.stream_handle(kmers.device),
    )
    _build.check_error(err, "necklace")
    _build.LAUNCHES["necklace"] += 1
    return neck, pos
