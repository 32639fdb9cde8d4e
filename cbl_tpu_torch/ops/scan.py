"""Kernel B2: record-boundary blanking as a running sum.

Replaces `cbl_tpu/ops/scan_pallas.py` `blank_mask_pallas`.  From int32
interval deltas (+1 at each blanked interval's start, -1 at its end) it
returns the int32 mask `mask[i] = cumsum(delta)[i] > 0` (1 = blanked) and
the count of rows that are not blanked, as an int32 0-d tensor.

`blank_mask` takes the plain version for a CPU tensor and launches the
CUDA kernel (`csrc/scan.cu`) for a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

SCAN_TILE = 4096  # elements per block of csrc/scan.cu (256 threads x 16)


def blank_mask_plain(delta: torch.Tensor):
    """(mask [n] int32, n_valid int32 0-d) by `cumsum(delta) > 0`."""
    blanked = torch.cumsum(delta, 0) > 0
    return blanked.to(torch.int32), (~blanked).sum().to(torch.int32)


def blank_mask(delta: torch.Tensor):
    """`blank_mask_plain` on the CPU; on CUDA, kernel B2."""
    if delta.dtype != torch.int32 or delta.dim() != 1:
        raise ValueError(
            f"expected a 1-D int32 tensor, got {delta.dtype} {tuple(delta.shape)}"
        )
    if delta.device.type == "cpu":
        return blank_mask_plain(delta)
    _build.check_cuda(delta)
    n = delta.shape[0]
    mask = torch.empty_like(delta)
    n_valid = torch.empty((), dtype=torch.int32, device=delta.device)
    if n == 0:
        n_valid.zero_()
        return mask, n_valid
    n_blocks = (n + SCAN_TILE - 1) // SCAN_TILE
    block_sums = torch.empty(n_blocks, dtype=torch.int32, device=delta.device)
    lib = _build.library()
    err = lib.cbl_blank_mask(
        ctypes.c_void_p(delta.data_ptr()),
        ctypes.c_void_p(mask.data_ptr()),
        ctypes.c_void_p(n_valid.data_ptr()),
        ctypes.c_void_p(block_sums.data_ptr()),
        ctypes.c_longlong(n),
        _build.stream_handle(delta.device),
    )
    _build.check_error(err, "blank")
    _build.LAUNCHES["blank"] += 1
    return mask, n_valid
