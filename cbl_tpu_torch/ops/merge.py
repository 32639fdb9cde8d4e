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
of every tile of `SORT_TILES` rows, then merge-path passes that each merge
every four neighbouring runs into one (two levels of the merge tree a
pass), after one two-way pass when the number of levels is odd
(`mergepath_passes`).  It equals `torch.sort` (equal rows are identical).
Its plain version walks the same passes with `torch.sort` per tile, per
run pair and per quad; `quad_split_plain` is the four-run partition the
kernel's blocks rest on, in plain Python.

`merge_sorted` and `sort_mergepath` take the plain version for CPU
tensors and launch the CUDA kernel (`csrc/merge.cu`, `csrc/sort.cu`, both
on `csrc/merge_path.cuh`) for CUDA tensors, whatever the size.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MERGE_TILE = 2048  # rows per block of csrc/merge_path.cuh (256 threads x 8)
# rows per sort tile of B5 by number of columns (csrc/sort.cu kSortRows)
SORT_TILES = {1: 8192, 2: 4096}
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


def _scratch(n_rows: int, device, per_tile: int = 1) -> torch.Tensor:
    """Co-rank scratch: `per_tile` int64 per output tile (a two-way pass
    keeps one co-rank a tile, a four-way pass that table and three
    splits)."""
    n_tiles = (n_rows + MERGE_TILE - 1) // MERGE_TILE
    return torch.empty(max(n_tiles, 1) * per_tile, dtype=torch.int64,
                       device=device)


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


def mergepath_passes(n: int, tile: int, ways: int = 4) -> list:
    """B5's passes over device memory for n rows: ("tile_sort", tile),
    then ("merge", run, fan) passes that merge every `fan` neighbouring
    runs of `run` rows.  With ways=4 every pass is four-way but the first,
    which is two-way when the number of levels ceil(log2(n / tile)) is
    odd; with ways=2 there is one two-way pass a level."""
    if ways not in (2, 4):
        raise ValueError(f"ways={ways}: expected 2 or 4")
    passes = [("tile_sort", tile)]
    levels = (max(-(-n // tile), 1) - 1).bit_length()
    run = tile
    if ways == 2 or levels % 2 == 1:
        fans = [2] * (levels if ways == 2 else 1)
    else:
        fans = []
    fans += [4] * ((levels - len(fans)) // 2)
    for fan in fans:
        passes.append(("merge", run, fan))
        run *= fan
    return passes


def sort_mergepath_plain(keys, tile: int | None = None, ways: int = 4):
    """B5's passes (`mergepath_passes`) in plain tensor code: pad with
    INT64_MAX rows to `tile` times a power of two, sort every tile of the
    [n / tile, tile] view, then per pass merge every pair of runs (the
    plain merge, a sort of the pair) and, in a four-way pass, every pair
    of those; the pads sort last and are cut."""
    cols = as_cols(keys)
    n = cols[0].shape[0]
    if n <= 1:
        return _like(keys, tuple(c.clone() for c in cols))
    tile = SORT_TILES[len(cols)] if tile is None else tile
    passes = mergepath_passes(n, tile, ways)
    padded = tile
    for _, run, fan in passes[1:]:
        padded = run * fan
    if padded != n:
        pad = cols[0].new_full((padded - n,), _PAD)
        cols = tuple(torch.cat([c, pad]) for c in cols)

    def sort_runs(cols, run):
        cols = sort_cols_plain(tuple(c.view(-1, run) for c in cols), dim=1)
        return tuple(c.reshape(-1) for c in cols)

    cols = sort_runs(cols, tile)
    for _, run, fan in passes[1:]:
        cols = sort_runs(cols, 2 * run)
        if fan == 4:
            cols = sort_runs(cols, 4 * run)
    return _like(keys, tuple(c[:n] for c in cols))


def _rows(keys) -> list:
    """The rows of a run as Python tuples (they compare as the kernels'
    `le`: lexicographic, column 0 major)."""
    return list(zip(*(c.tolist() for c in as_cols(keys))))


def _corank_plain(a: list, b: list, d: int) -> int:
    """How many of the first d outputs of merge(a, b) come from a, a
    before b on ties: the smallest i with a[i] > b[d - i - 1]."""
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if a[mid] <= b[d - mid - 1]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _merged_at(a: list, b: list, i: int):
    """Output i of merge(a, b), found by a co-rank."""
    ia = _corank_plain(a, b, i)
    ib = i - ia
    take_a = ib >= len(b) or (ia < len(a) and a[ia] <= b[ib])
    return a[ia] if take_a else b[ib]


def quad_split_plain(runs, d: int) -> tuple:
    """How many of the first d outputs of the merge of one to four sorted
    runs A, B, C, D come from each, ties in run order: the co-rank of d in
    (AB, CD), where AB[i] is itself found by a co-rank in (A, B), then the
    co-ranks of the two halves (csrc/merge_path.cuh `partition_quads`)."""
    a, b, c, e = ([_rows(r) for r in runs] + [[]] * 3)[:4]
    nab, ncd = len(a) + len(b), len(c) + len(e)
    lo, hi = max(0, d - ncd), min(d, nab)
    while lo < hi:
        mid = (lo + hi) // 2
        if _merged_at(a, b, mid) <= _merged_at(c, e, d - mid - 1):
            lo = mid + 1
        else:
            hi = mid
    ia, ic = _corank_plain(a, b, lo), _corank_plain(c, e, d - lo)
    return ia, lo - ia, ic, d - lo - ic


def merge_quad_tile_plain(runs, d0: int, d1: int):
    """The outputs [d0, d1) of the merge of one to four sorted runs, as a
    block of `merge_quads` makes them: the four segments between the
    splits of d0 and of d1, A merged with B, C with D, then the two."""
    lo, hi = quad_split_plain(runs, d0), quad_split_plain(runs, d1)
    cols = [as_cols(r) for r in runs]
    empty = tuple(c[:0] for c in cols[0])
    segs = [tuple(c[l:h] for c in r) for r, l, h in zip(cols, lo, hi)]
    a, b, c, e = (segs + [empty] * 3)[:4]
    return _like(runs[0], merge_sorted_plain(merge_sorted_plain(a, b),
                                             merge_sorted_plain(c, e)))


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
    planned = mergepath_passes(n, SORT_TILES[len(cols)])
    out = tuple(torch.empty_like(c) for c in cols)
    # the passes ping-pong between `out` and `tmp`; one tile needs no pass
    tmp = tuple(torch.empty_like(c) if len(planned) > 1 else None
                for c in cols)
    scratch = _scratch(n, cols[0].device, per_tile=4)
    passes = ctypes.c_int(0)
    lib = _build.library()
    err = lib.cbl_sort_keys(
        *_col_ptrs(cols), *_col_ptrs(out), *_col_ptrs(tmp),
        ctypes.c_longlong(n), _ptr(scratch), ctypes.byref(passes),
        _build.stream_handle(cols[0].device),
    )
    _build.check_error(err, "sort")
    _build.check_passes(passes.value, planned, "sort")
    _build.LAUNCHES["sort"] += 1
    _build.PASSES["sort"] = passes.value
    return _like(keys, out)
