"""Kernels B2 and B4: the two running scans of the port.

B2 replaces `cbl_tpu/ops/scan_pallas.py` `blank_mask_pallas`.  From int32
interval deltas (+1 at each blanked interval's start, -1 at its end) it
returns the int32 mask `mask[i] = cumsum(delta)[i] > 0` (1 = blanked) and
the count of rows that are not blanked, as an int32 0-d tensor.

B4 replaces `slog_scan_counts_pallas`, the liveness scan of a sorted log
(`wordset` slog keys: `key >> 8` groups a word's run, `key & 0xFF` is the
row's tag `(seq << 2) | typ`, typ 1 insert, 2 query, 3 remove; 0xFF and
`SENTINEL` rows are never entries).  It returns `(hits, live)`: the rows
tagged `qtag` whose word is live at their position, and the distinct
live words.

`blank_mask` and `slog_scan_counts` take the plain version for a CPU
tensor and launch their CUDA kernel (`csrc/scan.cu`, `csrc/slog_scan.cu`)
for a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..limbs import SENTINEL

SCAN_TILE = 4096  # rows per block of csrc/scan.cu and slog_scan.cu (256 x 16)
SLOG_TAG_MAX = 0xFF  # the query / sentinel tag of a slog key


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


def slog_rows(keys: torch.Tensor):
    """(run_start, sentinel, is_entry, is_insert) [n] bool over sorted
    slog keys.  An entry is an insert or remove row (typ 1 or 3) that is
    neither a 0xFF join query nor a sentinel."""
    n = keys.shape[0]
    run_start = torch.ones(n, dtype=torch.bool, device=keys.device)
    word = keys >> 8
    run_start[1:] = word[1:] != word[:-1]
    sentinel = keys == SENTINEL
    tag = keys & SLOG_TAG_MAX
    typ = tag & 3
    is_entry = ((typ == 1) | (typ == 3)) & (tag != SLOG_TAG_MAX) & ~sentinel
    return run_start, sentinel, is_entry, typ == 1


def slog_scan_counts_plain(keys: torch.Tensor, qtag: int):
    """(hits, live) int64 0-d over sorted slog keys by the formula of
    `cbl_tpu.wordset._slog_scan`: hits = rows tagged `qtag` that are live
    at their position; live = run-end rows that are live (distinct live
    words).  Sentinel rows never count.

    A row is live when the latest insert or remove entry at or before it
    in its word run is an insert.  One running max says so: every run
    start or entry row carries the marker (i << 2) | (entry ? 2 | insert
    : 0), every other row -1; the running max is the later of {latest run
    start, latest entry}, so its bit 1 says "an entry exists in my run"
    and bit 0 its kind."""
    run_start, sentinel, is_entry, is_insert = slog_rows(keys)
    idx = torch.arange(keys.shape[0], dtype=torch.int64, device=keys.device)
    bits = torch.where(is_entry, 2 | is_insert.to(torch.int64), 0)
    marker = torch.where(run_start | is_entry, (idx << 2) | bits, -1)
    live_here = (torch.cummax(marker, 0).values & 3) == 3
    real_live = live_here & ~sentinel
    hits = (real_live & ((keys & SLOG_TAG_MAX) == qtag)).sum()
    run_end = torch.ones_like(run_start)
    run_end[:-1] = run_start[1:]
    return hits, (real_live & run_end).sum()


def slog_scan_counts(keys: torch.Tensor, qtag: int):
    """`slog_scan_counts_plain` on the CPU; on CUDA, kernel B4 (every
    call launches it, whatever n)."""
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError(
            f"expected a 1-D int64 tensor, got {keys.dtype} {tuple(keys.shape)}"
        )
    if not 0 <= qtag <= SLOG_TAG_MAX:
        raise ValueError(f"qtag {qtag} is not an 8-bit slog tag")
    if keys.device.type == "cpu":
        return slog_scan_counts_plain(keys, qtag)
    _build.check_cuda(keys)
    n = keys.shape[0]
    out = torch.empty(2, dtype=torch.int64, device=keys.device)
    n_tiles = (n + SCAN_TILE - 1) // SCAN_TILE
    tile_max = torch.empty(max(n_tiles, 1), dtype=torch.int64,
                           device=keys.device)
    lib = _build.library()
    err = lib.cbl_slog_scan_counts(
        ctypes.c_void_p(keys.data_ptr()),
        ctypes.c_longlong(n),
        ctypes.c_int(qtag),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(tile_max.data_ptr()),
        _build.stream_handle(keys.device),
    )
    _build.check_error(err, "slog_scan")
    _build.LAUNCHES["slog_scan"] += 1
    return out[0], out[1]
