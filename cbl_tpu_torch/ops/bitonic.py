"""Kernels B6 and B7: the bitonic sort and the bitonic merge.

Rows are int64 keys of one column (a 1-D tensor) or two (a tuple of two
1-D tensors of one length), ordered lexicographically with column 0
major, as in `ops.merge`.  Every function returns what it was given: a
tensor for a tensor, a tuple for a tuple.

B6 replaces `cbl_tpu/ops/sort_pallas.py` `sort_cols_pallas`: a full sort
by the bitonic network, stage k = 2, 4, ..., P with the steps
j = k / 2, ..., 1, where step j exchanges row i (bit j clear) with row
i | j and the pair's direction is ascending iff bit k of i is clear.  Any
length: the rows are padded to a power of two with INT64_MAX rows, which
sort last and are cut.  It equals `torch.sort` (equal rows are identical).

B7 replaces `cbl_tpu/ops/sort_pallas.py` `merge_cols_pallas`: two sorted
runs A and B become one, equal to a sort of their concatenation.  With M
the next power of two of the longer run, [A, pads to M | B reversed, pads
in front] is one bitonic sequence of 2 M rows, and the steps M, ..., 1
with every pair ascending sort it.

`bitonic_sort` and `bitonic_merge` take the plain version (the same
network walked step by step with tensor operations, never a library sort)
for CPU tensors and launch the CUDA kernel (`csrc/bitonic_sort.cu`,
`csrc/bitonic_merge.cu`, both on `csrc/bitonic.cuh`) for CUDA tensors,
whatever the size.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .merge import _PAD, _col_ptrs, _like, as_cols

TILE = 4096  # rows per tile of csrc/bitonic.cuh (kBitonicTile)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _lex_gt(x: tuple, y: tuple) -> torch.Tensor:
    """x > y row by row, lexicographic over the columns."""
    gt = x[-1] > y[-1]
    for a, b in zip(reversed(x[:-1]), reversed(y[:-1])):
        gt = (a > b) | ((a == b) & gt)
    return gt


def _step(cols: tuple, j: int, asc) -> tuple:
    """One step of the network with stride j over columns of P rows: in
    the [P / 2j, 2, j] view, row [g, 0, r] meets row [g, 1, r].  `asc` is
    True, or a [P / 2j, 1] bool tensor with each group's direction."""
    views = [c.reshape(-1, 2, j) for c in cols]
    lo = tuple(v[:, 0, :] for v in views)
    hi = tuple(v[:, 1, :] for v in views)
    if asc is True:
        swap = _lex_gt(lo, hi)
    else:
        swap = torch.where(asc, _lex_gt(lo, hi), _lex_gt(hi, lo))
    return tuple(
        torch.stack([torch.where(swap, h, l), torch.where(swap, l, h)],
                    dim=1).reshape(-1)
        for l, h in zip(lo, hi)
    )


def _padded(cols: tuple, rows: int) -> tuple:
    n = cols[0].shape[0]
    if rows == n:
        return cols
    pad = cols[0].new_full((rows - n,), _PAD)
    return tuple(torch.cat([c, pad]) for c in cols)


# --- B6 ----------------------------------------------------------------------


def bitonic_sort_plain(keys):
    """B6's network in plain tensor code, one `_step` per (stage, stride);
    the direction of a group comes from the padded global index of its
    first row."""
    cols = as_cols(keys)
    n = cols[0].shape[0]
    if n <= 1:
        return _like(keys, tuple(c.clone() for c in cols))
    rows = _next_pow2(n)
    cols = _padded(cols, rows)
    k = 2
    while k <= rows:
        j = k // 2
        while j >= 1:
            first = torch.arange(0, rows, 2 * j, device=cols[0].device)
            cols = _step(cols, j, ((first & k) == 0).unsqueeze(1))
            j //= 2
        k *= 2
    return _like(keys, tuple(c[:n] for c in cols))


def bitonic_sort(keys):
    """`bitonic_sort_plain` on the CPU; on CUDA, kernel B6.  Empty and
    one-row inputs return without a launch; the caller's tensors are only
    read."""
    cols = as_cols(keys)
    if cols[0].device.type == "cpu":
        return bitonic_sort_plain(keys)
    _build.check_cuda(*cols)
    n = cols[0].shape[0]
    if n <= 1:
        return _like(keys, tuple(c.clone() for c in cols))
    out = tuple(torch.empty_like(c) for c in cols)
    # the network runs in a scratch of the padded length; one tile needs none
    work_rows = _next_pow2(n) if n > TILE else 0
    work = tuple(c.new_empty(work_rows) if work_rows else None for c in cols)
    lib = _build.library()
    err = lib.cbl_bitonic_sort(
        *_col_ptrs(cols), *_col_ptrs(out), *_col_ptrs(work),
        ctypes.c_longlong(work_rows), ctypes.c_longlong(n),
        _build.stream_handle(cols[0].device),
    )
    _build.check_error(err, "bitonic_sort")
    _build.LAUNCHES["bitonic_sort"] += 1
    return _like(keys, out)


# --- B7 ----------------------------------------------------------------------


def _run_pair(a, b) -> tuple:
    ca, cb = as_cols(a), as_cols(b)
    if len(ca) != len(cb):
        raise ValueError("the two runs differ in their number of columns")
    return ca, cb


def bitonic_merge_plain(a, b):
    """B7's network in plain tensor code: the bitonic sequence
    [A, pads | pads, B reversed] of 2 M rows, then one ascending `_step`
    per stride M, ..., 1; the first na + nb rows are the merge."""
    ca, cb = _run_pair(a, b)
    na, nb = ca[0].shape[0], cb[0].shape[0]
    if na + nb == 0:
        return _like(a, tuple(c.clone() for c in ca))
    m = _next_pow2(max(na, nb))
    cols = tuple(torch.cat([x, torch.flip(y, dims=(0,))])
                 for x, y in zip(_padded(ca, m), _padded(cb, m)))
    j = m
    while j >= 1:
        cols = _step(cols, j, True)
        j //= 2
    return _like(a, tuple(c[:na + nb] for c in cols))


def bitonic_merge(a, b):
    """`bitonic_merge_plain` on the CPU; on CUDA, kernel B7.  Two empty
    runs return without a launch; the caller's tensors are only read."""
    ca, cb = _run_pair(a, b)
    if ca[0].device.type == "cpu" and cb[0].device.type == "cpu":
        return bitonic_merge_plain(a, b)
    _build.check_cuda(*ca, *cb)
    na, nb = ca[0].shape[0], cb[0].shape[0]
    dev = ca[0].device
    out = tuple(torch.empty(na + nb, dtype=torch.int64, device=dev)
                for _ in ca)
    if na + nb == 0:
        return _like(a, out)
    # the steps above the tile run in a scratch of 2 M rows
    rows = 2 * _next_pow2(max(na, nb))
    work_rows = rows if rows > TILE else 0
    work = tuple(out[0].new_empty(work_rows) if work_rows else None
                 for _ in ca)
    lib = _build.library()
    err = lib.cbl_bitonic_merge(
        *_col_ptrs(ca), ctypes.c_longlong(na),
        *_col_ptrs(cb), ctypes.c_longlong(nb),
        *_col_ptrs(out), *_col_ptrs(work), ctypes.c_longlong(work_rows),
        _build.stream_handle(dev),
    )
    _build.check_error(err, "bitonic_merge")
    _build.LAUNCHES["bitonic_merge"] += 1
    return _like(a, out)
