"""Kernels B3 and B5: the merge-path merge and the merge-path sort.

Rows are int64 keys of one column (a 1-D tensor) or two (a tuple of two
1-D tensors of one length), ordered lexicographically with column 0
major, as `cbl_tpu`'s kernels order their uint32 limb columns.  Every
function returns what it was given: a tensor for a tensor, a tuple for a
tuple.

B3 replaces `cbl_tpu/ops/merge_pallas.py` `merge_sorted_cols` (the
merge-path co-rank merge).  Given `a` and `b`, each sorted ascending, it
returns their merge, equal to a sort of their concatenation.

B5 replaces `cbl_tpu/ops/merge_pallas.py` `sort_cols_mergepath`: a sort
of every tile of `MERGE_TILE` rows, then one merge-path pass per doubling
of the run length.  It equals `torch.sort` (equal rows are identical).
Its plain version walks the same passes with `torch.sort` per tile and
per run pair.

`merge_sorted` and `sort_mergepath` take the plain version for CPU
tensors and launch the CUDA kernel (`csrc/merge.cu`, `csrc/sort.cu`, both
on `csrc/merge_path.cuh`) for CUDA tensors, whatever the size.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MERGE_TILE = 2048  # rows per block of csrc/merge_path.cuh (256 threads x 8)
_PAD = (1 << 63) - 1  # INT64_MAX in every column sorts last


def as_cols(keys) -> tuple:
    """The columns of `keys` (a tensor or a tuple of one or two tensors),
    checked: 1-D int64, one length, one device."""
    cols = (keys,) if isinstance(keys, torch.Tensor) else tuple(keys)
    if not 1 <= len(cols) <= 2:
        raise ValueError(f"expected one or two key columns, got {len(cols)}")
    for t in cols:
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(
                f"expected 1-D int64 tensors, got {t.dtype} {tuple(t.shape)}"
            )
        if t.shape != cols[0].shape or t.device != cols[0].device:
            raise ValueError("key columns differ in length or device")
    return cols


def _like(keys, cols):
    return cols[0] if isinstance(keys, torch.Tensor) else tuple(cols)


def sort_cols_plain(cols: tuple, dim: int = 0) -> tuple:
    """Lexicographic sort of one or two columns along `dim` with
    `torch.sort`: for two columns a stable sort by the minor column, then
    a stable sort by the major one."""
    if len(cols) == 1:
        return (torch.sort(cols[0], dim=dim).values,)
    major, minor = cols
    minor, order = torch.sort(minor, dim=dim, stable=True)
    major, order = torch.sort(major.gather(dim, order), dim=dim, stable=True)
    return major, minor.gather(dim, order)


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _col_ptrs(cols) -> list:
    """Column 0's pointer and column 1's (null for one-column rows)."""
    return [_ptr(cols[0]), _ptr(cols[1] if len(cols) == 2 else None)]


def _scratch(n_rows: int, device) -> torch.Tensor:
    """Co-rank scratch: one int64 per output tile."""
    n_tiles = (n_rows + MERGE_TILE - 1) // MERGE_TILE
    return torch.empty(max(n_tiles, 1), dtype=torch.int64, device=device)


# --- B3 ----------------------------------------------------------------------


def merge_sorted_plain(a, b):
    cols = sort_cols_plain(tuple(
        torch.cat([x, y]) for x, y in zip(as_cols(a), as_cols(b), strict=True)
    ))
    return _like(a, cols)


def merge_sorted(a, b):
    """`merge_sorted_plain` on the CPU; on CUDA, kernel B3."""
    ca, cb = as_cols(a), as_cols(b)
    if len(ca) != len(cb):
        raise ValueError("the two runs differ in their number of columns")
    if ca[0].device.type == "cpu" and cb[0].device.type == "cpu":
        return merge_sorted_plain(a, b)
    _build.check_cuda(*ca, *cb)
    na, nb = ca[0].shape[0], cb[0].shape[0]
    dev = ca[0].device
    out = tuple(torch.empty(na + nb, dtype=torch.int64, device=dev)
                for _ in ca)
    if na + nb == 0:
        return _like(a, out)
    coranks = _scratch(na + nb, dev)
    lib = _build.library()
    err = lib.cbl_merge_sorted(
        *_col_ptrs(ca), ctypes.c_longlong(na),
        *_col_ptrs(cb), ctypes.c_longlong(nb),
        *_col_ptrs(out), _ptr(coranks), _build.stream_handle(dev),
    )
    _build.check_error(err, "merge")
    _build.LAUNCHES["merge"] += 1
    return _like(a, out)


# --- B5 ----------------------------------------------------------------------


def sort_mergepath_plain(keys, tile: int = MERGE_TILE):
    """B5's passes in plain tensor code: pad with INT64_MAX rows to `tile`
    times a power of two, sort every tile of the [n / tile, tile] view,
    then for run = tile, 2 tile, ... merge every pair of runs (the plain
    merge, a sort of the pair) until one run is left; the pads sort last
    and are cut."""
    cols = as_cols(keys)
    n = cols[0].shape[0]
    if n <= 1:
        return _like(keys, tuple(c.clone() for c in cols))
    n_tiles = -(-n // tile)
    padded = tile * (1 << (n_tiles - 1).bit_length())
    if padded != n:
        pad = cols[0].new_full((padded - n,), _PAD)
        cols = tuple(torch.cat([c, pad]) for c in cols)
    run = tile
    while True:
        cols = sort_cols_plain(tuple(c.view(-1, run) for c in cols), dim=1)
        cols = tuple(c.reshape(-1) for c in cols)
        if run >= padded:
            break
        run *= 2
    return _like(keys, tuple(c[:n] for c in cols))


def sort_mergepath(keys):
    """`sort_mergepath_plain` on the CPU; on CUDA, kernel B5.  Empty and
    one-row inputs return without a launch."""
    cols = as_cols(keys)
    if cols[0].device.type == "cpu":
        return sort_mergepath_plain(keys)
    _build.check_cuda(*cols)
    n = cols[0].shape[0]
    if n <= 1:
        return _like(keys, tuple(c.clone() for c in cols))
    out = tuple(torch.empty_like(c) for c in cols)
    # the passes ping-pong between `out` and `tmp`; one tile needs no pass
    tmp = tuple(torch.empty_like(c) if n > MERGE_TILE else None for c in cols)
    coranks = _scratch(n, cols[0].device)
    lib = _build.library()
    err = lib.cbl_sort_keys(
        *_col_ptrs(cols), *_col_ptrs(out), *_col_ptrs(tmp),
        ctypes.c_longlong(n), _ptr(coranks),
        _build.stream_handle(cols[0].device),
    )
    _build.check_error(err, "sort")
    _build.LAUNCHES["sort"] += 1
    return _like(keys, out)
