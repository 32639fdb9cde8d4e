"""Kernels B6 and B7: the bitonic sort and the bitonic merge.

Rows are int64 keys of one column (a 1-D tensor) or of one to three (a
tuple of 1-D tensors of one length), ordered lexicographically with
column 0 major, as in `ops.merge`.  Every
function returns what it was given.

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
with every pair ascending sort it (`bitonic_merge_plain`).  The kernel
does the same work in one pass over device memory, tiled as
`cbl_tpu/ops/merge_pallas.py` `merge_sorted_cols` is: the output is cut
into tiles of `tile` rows, the co-rank of each tile edge (`tile_coranks`)
gives the tile's slices of A and B, which are exactly the rows the strides
that cross tiles would have brought there, and each tile runs the strides
tile / 2, ..., 1 on [A's slice, pads, B's slice reversed] (`merge_passes`,
`bitonic_merge_tiled_plain`).

B6 carries many steps of the network through one pass over device
memory: `network_passes` lists the passes (a tile sort, fused cross
passes of up to `fuse_log(tile)` strides, in-tile passes) and
`bitonic_sort_passes_plain` walks that list, gathering each block's rows
by the index map the kernel uses.  `bitonic_sort_plain` /
`bitonic_merge_plain` walk the networks one step at a time and are their
reference.

`bitonic_sort` and `bitonic_merge` take the plain version that walks the
kernel's structure (`bitonic_sort_passes_plain`,
`bitonic_merge_tiled_plain`: tensor operations, never a library sort) for
CPU tensors and launch the CUDA kernel (`csrc/bitonic_sort.cu`,
`csrc/bitonic_merge.cu`, both on `csrc/bitonic.cuh`) for CUDA tensors,
whatever the size.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .merge import (
    _PAD,
    _col_ptrs,
    _like,
    _new_cols,
    _ptr,
    as_cols,
    launch_key,
)

# rows per tile by number of columns: B6's (csrc/bitonic.cuh kTileRows) and
# B7's output tiles (csrc/bitonic_merge.cu kMergeRows)
TILES = {1: 8192, 2: 4096, 3: 4096}
MERGE_TILES = {1: 2048, 2: 1024, 3: 1024}


def fuse_log(tile: int) -> int:
    """The most strides one cross pass fuses for a tile (csrc/bitonic.cuh
    kFuseLog): its 2^f slices keep 2^4 contiguous rows."""
    return tile.bit_length() - 1 - 4


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


# --- the passes --------------------------------------------------------------


def network_passes(rows: int, tile: int, fuse: int) -> list:
    """The passes over device memory of B6, a sort of `rows` padded rows,
    as (kind, dir_bit, hi_log, lo_log): the steps with strides 2^hi_log
    ... 2^lo_log of the stage whose pairs are ascending iff bit `dir_bit`
    of the row index is clear.
    - "tile": every stage k <= tile inside each tile (`dir_bit` is the last
      stage's);
    - "cross": up to `fuse` strides >= tile of one stage in one pass; a
      stage's shorter pass comes first;
    - "intile": the strides tile / 2 ... 1 of one stage."""
    t_log, p_log = tile.bit_length() - 1, rows.bit_length() - 1
    assert rows == 1 << p_log and tile == 1 << t_log and fuse >= 1

    def cross(dir_bit, hi_log):
        out, left = [], hi_log - t_log + 1
        while left > 0:
            f = left % fuse or fuse
            out.append(("cross", dir_bit, t_log + left - 1,
                        t_log + left - f))
            left -= f
        return out

    assert rows >= tile
    passes = [("tile", t_log, t_log - 1, 0)]
    for k_log in range(t_log + 1, p_log + 1):
        passes += cross(k_log, k_log - 1)
        passes.append(("intile", k_log, t_log - 1, 0))
    return passes


def _directions(first: torch.Tensor, dir_bit: int):
    """`_step`'s `asc` for groups whose first rows are `first`."""
    return (((first >> dir_bit) & 1) == 0).unsqueeze(1)


def _walk_pass(cols: tuple, tile: int, pas: tuple) -> tuple:
    """One pass of `network_passes` over columns of P rows."""
    kind, dir_bit, hi_log, lo_log = pas
    rows, dev = cols[0].shape[0], cols[0].device
    t_log = tile.bit_length() - 1
    if kind != "cross":  # contiguous rows: "tile", "intile"
        stages = [(dir_bit, hi_log, lo_log)]
        if kind == "tile":
            stages = [(k_log, k_log - 1, 0) for k_log in range(1, t_log + 1)]
        for bit, hi, lo in stages:
            for j_log in range(hi, lo - 1, -1):
                first = torch.arange(0, rows, 2 << j_log, device=dev)
                cols = _step(cols, 1 << j_log, _directions(first, bit))
        return cols
    first, idx = cross_block_rows(rows, tile, lo_log, hi_log - lo_log + 1)
    first, idx = first.to(dev), idx.to(dev).reshape(-1)
    blocks = tuple(x[idx] for x in cols)
    for j_log in range(t_log - 1, t_log - (hi_log - lo_log + 1) - 1, -1):
        j = 1 << j_log  # the stride inside the tile
        asc = _directions(first.repeat_interleave(tile // (2 * j)), dir_bit)
        blocks = _step(blocks, j, asc)
    return tuple(torch.empty_like(x).index_copy_(0, idx, y)
                 for x, y in zip(cols, blocks))


def cross_block_rows(rows: int, tile: int, a_log: int, f: int) -> tuple:
    """The rows a block of `cross_fused` owns in a pass over the strides
    2^(a_log+f-1) ... 2^a_log, by the kernel's own index map: block
    b = (hi << (a_log - c)) | mid holds 2^f slices of 2^c rows, c =
    log2(tile) - f, slice q at first + (q << a_log) with first =
    (hi << (a_log + f)) | (mid << c), and row r of its tile is slice
    r >> c, offset r & (2^c - 1).  -> (first [blocks], rows [blocks, tile])"""
    t_log = tile.bit_length() - 1
    c = t_log - f
    b = torch.arange(rows >> t_log)
    mid, hi = b & ((1 << (a_log - c)) - 1), b >> (a_log - c)
    first = (hi << (a_log + f)) | (mid << c)
    r = torch.arange(tile)
    within = ((r >> c) << a_log) + (r & ((1 << c) - 1))
    return first, first.unsqueeze(1) + within.unsqueeze(0)


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


def bitonic_sort_passes_plain(keys, tile: int | None = None,
                              fuse: int | None = None):
    """Kernel B6's plain version: the network as the kernel schedules it,
    one `_walk_pass` per pass of `network_passes` over the rows padded to
    max(tile, the next power of two)."""
    cols = as_cols(keys)
    n = cols[0].shape[0]
    if n <= 1:
        return _like(keys, tuple(c.clone() for c in cols))
    tile = TILES[len(cols)] if tile is None else tile
    fuse = fuse_log(tile) if fuse is None else fuse
    rows = max(tile, _next_pow2(n))
    cols = _padded(cols, rows)
    for pas in network_passes(rows, tile, fuse):
        cols = _walk_pass(cols, tile, pas)
    return _like(keys, tuple(c[:n] for c in cols))


def bitonic_sort(keys):
    """`bitonic_sort_passes_plain` on the CPU; on CUDA, kernel B6.  Empty
    and one-row inputs return without a launch; the caller's tensors are
    only read."""
    cols = as_cols(keys)
    if cols[0].device.type == "cpu":
        return bitonic_sort_passes_plain(keys)
    _build.check_cuda(*cols)
    n = cols[0].shape[0]
    if n <= 1:
        return _like(keys, tuple(c.clone() for c in cols))
    tile = TILES[len(cols)]
    rows = max(tile, _next_pow2(n))
    planned = network_passes(rows, tile, fuse_log(tile))
    out = _new_cols(len(cols), n, cols[0].device)
    # the network runs in a scratch of the padded length; one tile needs none
    work_rows = rows if rows > tile else 0
    work = (_new_cols(len(cols), work_rows, cols[0].device) if work_rows
            else (None,) * len(cols))
    passes = ctypes.c_int(0)
    p_in, p_out, p_work = _col_ptrs(cols), _col_ptrs(out), _col_ptrs(work)
    lib = _build.library()
    err = lib.cbl_bitonic_sort(
        p_in, p_out, p_work, ctypes.c_int(len(cols)),
        ctypes.c_longlong(work_rows), ctypes.c_longlong(n),
        ctypes.byref(passes), _build.stream_handle(cols[0].device),
    )
    _build.check_error(err, "bitonic_sort")
    _build.check_passes(passes.value, planned, "bitonic_sort")
    _build.LAUNCHES[launch_key("bitonic_sort", len(cols))] += 1
    _build.PASSES["bitonic_sort"] = passes.value
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
    cols = _bitonic_sequence(ca, cb, m)
    j = m
    while j >= 1:
        cols = _step(cols, j, True)
        j //= 2
    return _like(a, tuple(c[:na + nb] for c in cols))


def _bitonic_sequence(ca: tuple, cb: tuple, m: int) -> tuple:
    """[A, pads to m | B reversed, pads in front]: 2 m rows."""
    return tuple(torch.cat([x, torch.flip(y, dims=(0,))])
                 for x, y in zip(_padded(ca, m), _padded(cb, m)))


def merge_passes(n: int, tile: int) -> list:
    """The passes over device memory of B7 for a merge of n = na + nb >= 1
    rows: one, ("tiles", tiles), over `tiles` output tiles of `tile` rows
    (pads fill the last tile's network).  (`tile_coranks`'s launch reads
    O(tiles log n) rows and is not a pass.)"""
    assert n >= 1 and tile >= 1 and tile & (tile - 1) == 0
    return [("tiles", -(-n // tile))]


def tile_coranks(a, b, tile: int) -> torch.Tensor:
    """The co-rank of every tile edge d = min(g * tile, na + nb), g <=
    tiles: the smallest i in [max(0, d - nb), min(d, na)] with A[i] >
    B[d - i - 1], else min(d, na) (A before B on ties; csrc/merge_path.cuh
    `corank`).  All edges' binary searches run together, each step a
    gather of both runs.  -> int64 [tiles + 1] on the runs' device."""
    ca, cb = _run_pair(a, b)
    na, nb = ca[0].shape[0], cb[0].shape[0]
    dev = ca[0].device
    tiles = -(-(na + nb) // tile)
    d = torch.clamp(torch.arange(tiles + 1, device=dev) * tile, max=na + nb)
    lo = torch.clamp(d - nb, min=0)
    hi = torch.clamp(d, max=na)
    if na == 0 or nb == 0:  # lo == hi at every edge
        return lo
    for _ in range(max(na, nb).bit_length() + 1):
        mid = (lo + hi) >> 1
        x = tuple(c[torch.clamp(mid, max=na - 1)] for c in ca)
        y = tuple(c[torch.clamp(d - mid - 1, 0, nb - 1)] for c in cb)
        le = ~_lex_gt(x, y)
        active = lo < hi
        lo = torch.where(active & le, mid + 1, lo)
        hi = torch.where(active & ~le, mid, hi)
    return lo


def bitonic_merge_tiled_plain(a, b, tile: int | None = None):
    """Kernel B7's plain version: the pass of `merge_passes` as the kernel
    runs it, vectorised over tiles.  The co-ranks of the tile edges
    (`tile_coranks`) give each tile its slices of A and B; a `[tiles,
    tile]` gather lays out each tile's bitonic sequence, A's slice
    ascending at the front, B's reversed at the back and pads between; the
    strides tile / 2 ... 1, every pair ascending, run as reshaped
    compare-exchanges; each tile's first rows are its outputs."""
    ca, cb = _run_pair(a, b)
    na, nb = ca[0].shape[0], cb[0].shape[0]
    n = na + nb
    if n == 0:
        return _like(a, tuple(c.clone() for c in ca))
    tile = MERGE_TILES[len(ca)] if tile is None else tile
    ((_, tiles),) = merge_passes(n, tile)
    dev = ca[0].device
    ia = tile_coranks(ca, cb, tile)
    ib = torch.clamp(torch.arange(tiles + 1, device=dev) * tile, max=n) - ia
    a0, b0 = ia[:-1].unsqueeze(1), ib[:-1].unsqueeze(1)
    la, lb = ia[1:].unsqueeze(1) - a0, ib[1:].unsqueeze(1) - b0
    r = torch.arange(tile, device=dev).unsqueeze(0)
    from_a = r < la
    # row na of A and nb of B: a pad
    at_a = torch.where(from_a, a0 + r, na)
    at_b = torch.where(r >= tile - lb, b0 + (tile - 1 - r), nb)
    pad = ca[0].new_full((1,), _PAD)
    seq = tuple(
        torch.where(from_a, torch.cat([x, pad])[at_a],
                    torch.cat([y, pad])[at_b]).reshape(-1)
        for x, y in zip(ca, cb))
    j = tile // 2
    while j >= 1:
        seq = _step(seq, j, True)
        j //= 2
    return _like(a, tuple(c[:n] for c in seq))


def bitonic_merge(a, b):
    """`bitonic_merge_tiled_plain` on the CPU; on CUDA, kernel B7.  Two
    empty runs return without a launch; the caller's tensors are only
    read."""
    ca, cb = _run_pair(a, b)
    if ca[0].device.type == "cpu" and cb[0].device.type == "cpu":
        return bitonic_merge_tiled_plain(a, b)
    _build.check_cuda(*ca, *cb)
    na, nb = ca[0].shape[0], cb[0].shape[0]
    dev = ca[0].device
    out = _new_cols(len(ca), na + nb, dev)
    if na + nb == 0:
        return _like(a, out)
    planned = merge_passes(na + nb, MERGE_TILES[len(ca)])
    coranks = torch.empty(planned[0][1] + 1, dtype=torch.int64, device=dev)
    passes = ctypes.c_int(0)
    pa, pb, po = _col_ptrs(ca), _col_ptrs(cb), _col_ptrs(out)
    lib = _build.library()
    err = lib.cbl_bitonic_merge(
        pa, ctypes.c_longlong(na), pb, ctypes.c_longlong(nb), po,
        ctypes.c_int(len(ca)), _ptr(coranks),
        ctypes.byref(passes), _build.stream_handle(dev),
    )
    _build.check_error(err, "bitonic_merge")
    _build.check_passes(passes.value, planned, "bitonic_merge")
    _build.LAUNCHES[launch_key("bitonic_merge", len(ca))] += 1
    _build.PASSES["bitonic_merge"] = passes.value
    return _like(a, out)
