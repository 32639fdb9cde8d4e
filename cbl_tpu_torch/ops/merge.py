"""Kernel B3: merge of two sorted int64 key runs.

Replaces `cbl_tpu/ops/merge_pallas.py` `merge_sorted_cols` (the merge-path
co-rank merge).  Given `a` and `b`, each sorted ascending, it returns
their merge, equal to `torch.sort(torch.cat([a, b])).values`.

`merge_sorted` takes the plain version for CPU tensors and launches the
CUDA kernel (`csrc/merge.cu`) for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MERGE_TILE = 2048  # outputs per block of csrc/merge.cu (256 threads x 8)


def merge_sorted_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sort(torch.cat([a, b])).values


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`merge_sorted_plain` on the CPU; on CUDA, kernel B3."""
    for t in (a, b):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(
                f"expected 1-D int64 tensors, got {t.dtype} {tuple(t.shape)}"
            )
    if a.device.type == "cpu" and b.device.type == "cpu":
        return merge_sorted_plain(a, b)
    _build.check_cuda(a, b)
    na, nb = a.shape[0], b.shape[0]
    out = torch.empty(na + nb, dtype=torch.int64, device=a.device)
    if na + nb == 0:
        return out
    n_tiles = (na + nb + MERGE_TILE - 1) // MERGE_TILE
    coranks = torch.empty(n_tiles + 1, dtype=torch.int64, device=a.device)
    lib = _build.library()
    err = lib.cbl_merge_sorted(
        ctypes.c_void_p(a.data_ptr()),
        ctypes.c_longlong(na),
        ctypes.c_void_p(b.data_ptr()),
        ctypes.c_longlong(nb),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(coranks.data_ptr()),
        _build.stream_handle(a.device),
    )
    _build.check_error(err, "merge")
    _build.LAUNCHES["merge"] += 1
    return out
