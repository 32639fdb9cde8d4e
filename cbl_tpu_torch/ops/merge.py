"""Kernels B3 and B5: the merge-path merge and the merge-path sort.

Rows are int64 keys of one column (a 1-D tensor) or of one to three (a
tuple of 1-D tensors of one length: a word's columns, and a tag, a
position or a seqtag after them), ordered lexicographically with column 0
major, as `cbl_tpu`'s kernels order their uint32 limb columns.  Every
function returns what it was given: a tensor for a tensor, a tuple for a
tuple.  (A kernel's output columns are the rows of one [C, N] tensor,
which `limbs.stack` hands back without a copy.)

B3 replaces `cbl_tpu/ops/merge_pallas.py` `merge_sorted_cols` (the
merge-path co-rank merge).  Given `a` and `b`, each sorted ascending, it
returns their merge, equal to a sort of their concatenation.

B5 replaces `cbl_tpu/ops/merge_pallas.py` `sort_cols_mergepath`: a sort
of every tile of `SORT_TILES` rows, then merge-path passes that each merge
every `SORT_WAYS` = 16 neighbouring runs into one (four levels of the
merge tree a pass, after one pass of 2, 4 or 8 runs when the number of
levels is no multiple of four; `mergepath_passes`).  It equals
`torch.sort` (equal rows are identical).  Its plain version walks the same
passes with `torch.sort` per tile and per level of each pass's merge
tree; `multiway_split_plain` is the F-run partition of the kernel's
blocks, and `merge_multi_tile_plain` a block's merge, in plain Python.

`merge_sorted` and `sort_mergepath` take the plain version for CPU
tensors and launch the CUDA kernel (`csrc/merge.cu`, `csrc/sort.cu`, both
on `csrc/merge_path.cuh`, B5 also on `csrc/multiway.cuh`) for CUDA
tensors, whatever the size.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MERGE_TILE = 2048  # rows per block of csrc/merge_path.cuh (256 threads x 8)
# rows per sort tile of B5 by number of columns (csrc/sort.cu kSortRows)
SORT_TILES = {1: 8192, 2: 4096, 3: 4096}
# the most runs a merge pass of B5 merges, by number of columns (multiway
# passes of up to csrc/multiway.cuh kMaxFan runs)
SORT_WAYS = {1: 16, 2: 16, 3: 16}
MAX_COLS = 3
_PAD = (1 << 63) - 1  # INT64_MAX in every column sorts last


def as_cols(keys) -> tuple:
    """The columns of `keys` (a tensor or a tuple of one to three
    tensors), checked: 1-D int64, one length, one device."""
    cols = (keys,) if isinstance(keys, torch.Tensor) else tuple(keys)
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"expected one to {MAX_COLS} key columns, got "
                         f"{len(cols)}")
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
    """Lexicographic sort of columns along `dim` with `torch.sort`: one
    stable sort a column, the last column first, each carrying the order
    to the next."""
    if len(cols) == 1:
        return (torch.sort(cols[0], dim=dim).values,)
    out, order = torch.sort(cols[-1], dim=dim, stable=True)
    done = [out]
    for i in range(len(cols) - 2, -1, -1):
        key, step = torch.sort(cols[i].gather(dim, order), dim=dim,
                               stable=True)
        if i:  # the next column is read in this order
            order = order.gather(dim, step)
        done = [key] + [d.gather(dim, step) for d in done]
    return tuple(done)


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _col_ptrs(cols) -> ctypes.Array:
    """The columns' pointers as a C array (null for a None column); keep
    it alive across the call."""
    return (ctypes.c_void_p * len(cols))(
        *[None if c is None else c.data_ptr() for c in cols])


def _new_cols(n_cols: int, n: int, device) -> torch.Tensor:
    """[C, n] int64 output columns."""
    return torch.empty((n_cols, n), dtype=torch.int64, device=device)


def launch_key(name: str, n_cols: int) -> str:
    """The `LAUNCHES` entry of a kernel at `n_cols` columns: three-column
    launches count apart ("<name>_3col")."""
    return name if n_cols < 3 else f"{name}_3col"


def _scratch(n_rows: int, device, per_tile: int = 1) -> torch.Tensor:
    """Co-rank scratch: `per_tile` int64 per output tile of `MERGE_TILE`
    rows (a two-way pass keeps one co-rank a tile, a multiway pass of F
    runs F splits)."""
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
    out = _new_cols(len(ca), na + nb, dev)
    if na + nb == 0:
        return _like(a, out)
    coranks = _scratch(na + nb, dev)
    pa, pb, po = _col_ptrs(ca), _col_ptrs(cb), _col_ptrs(out)
    lib = _build.library()
    err = lib.cbl_merge_sorted(
        pa, ctypes.c_longlong(na), pb, ctypes.c_longlong(nb), po,
        ctypes.c_int(len(ca)), _ptr(coranks), _build.stream_handle(dev),
    )
    _build.check_error(err, "merge")
    _build.LAUNCHES[launch_key("merge", len(ca))] += 1
    return _like(a, out)


# --- B5 ----------------------------------------------------------------------


def mergepath_passes(n: int, tile: int, ways: int = 4) -> list:
    """B5's passes over device memory for n rows: ("tile_sort", tile),
    then ("merge", run, fan) passes that merge every `fan` neighbouring
    runs of `run` rows.  Of the L = ceil(log2(n / tile)) levels of the
    merge tree a pass does log2(ways), but the first, which does L mod
    log2(ways) when that is not 0: with ways=16 (the kernel's) every pass
    merges 16 runs but the first, which merges 2, 4 or 8; with ways=4
    every pass is four-way but the first, two-way when L is odd; with
    ways=2 there is one two-way pass a level."""
    if ways not in (2, 4, 16):
        raise ValueError(f"ways={ways}: expected 2, 4 or 16")
    passes = [("tile_sort", tile)]
    levels = (max(-(-n // tile), 1) - 1).bit_length()
    per = ways.bit_length() - 1
    run = tile
    while levels > 0:
        step = levels % per or per
        passes.append(("merge", run, 1 << step))
        run <<= step
        levels -= step
    return passes


def sort_mergepath_plain(keys, tile: int | None = None,
                         ways: int | None = None):
    """B5's passes (`mergepath_passes`) in plain tensor code: pad with
    INT64_MAX rows to `tile` times a power of two, sort every tile of the
    [n / tile, tile] view, then per pass merge every pair of runs (the
    plain merge, a sort of the pair) and, for each further level of the
    pass's merge tree, every pair of those; the pads sort last and are
    cut.  `tile` and `ways` default to the kernel's (`SORT_TILES`,
    `SORT_WAYS`)."""
    cols = as_cols(keys)
    n = cols[0].shape[0]
    if n <= 1:
        return _like(keys, tuple(c.clone() for c in cols))
    tile = SORT_TILES[len(cols)] if tile is None else tile
    ways = SORT_WAYS[len(cols)] if ways is None else ways
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
        width = 2 * run
        while width <= fan * run:
            cols = sort_runs(cols, width)
            width *= 2
    return _like(keys, tuple(c[:n] for c in cols))


def _rows(keys) -> list:
    """The rows of a run as Python tuples (they compare as the kernels'
    `le`: lexicographic, column 0 major)."""
    return list(zip(*(c.tolist() for c in as_cols(keys))))


def multiway_split_plain(runs, d: int, run_rows: int | None = None) -> tuple:
    """How many of the first d outputs of the merge of the sorted `runs`
    come from each, ties in run order (the order (row, run, index)), found
    as csrc/multiway.cuh `multiway_split` finds it: walking down the levels
    l = run_rows, run_rows / 2, ..., 1 (run_rows, a power of two at least
    the longest run, defaults to the least), the level-l samples of a run
    being its rows k l - 1, holding at each level the t_l smallest samples
    (t_l = d // l - F // 2, clamped to [0, the samples]; d at l = 1) as a
    prefix of every run; going down a level a run takes its new sample
    after its taken ones iff it precedes the largest taken sample, then the
    smallest untaken or the largest taken sample of all moves, one at a
    time, until t_l are taken."""
    rows = [_rows(r) for r in runs]
    F = len(rows)
    lens = [len(r) for r in rows]
    top = max(lens + [1])
    l = run_rows if run_rows is not None else 1 << (top - 1).bit_length()
    assert l & (l - 1) == 0 and l >= top

    def key(r, j):  # the order of the split; None: no such row
        return (rows[r][j], r, j) if 0 <= j < lens[r] else None

    b = [0] * F
    while True:
        cnt = [n // l for n in lens]
        t = d // l
        if l > 1:
            t = max(t - F // 2, 0)
        t = min(t, sum(cnt))
        while sum(b) < t:
            r = min((r for r in range(F) if b[r] < cnt[r]),
                    key=lambda r: key(r, (b[r] + 1) * l - 1))
            b[r] += 1
        while sum(b) > t:
            r = max((r for r in range(F) if b[r] > 0),
                    key=lambda r: key(r, b[r] * l - 1))
            b[r] -= 1
        if l == 1:
            return tuple(b)
        tops = [key(r, b[r] * l - 1) for r in range(F) if b[r] > 0]
        l //= 2
        for r in range(F):
            b[r] *= 2
            odd = key(r, (b[r] + 1) * l - 1)
            if odd is not None and tops and odd < max(tops):
                b[r] += 1


def merge_multi_tile_plain(runs, d0: int, d1: int, run_rows=None):
    """The outputs [d0, d1) of the merge of the sorted `runs` (a power of
    two of them), as a block of csrc/multiway.cuh `merge_multi` makes
    them: the segments between the splits of d0 and of d1
    (`multiway_split_plain`), merged pairwise level by level."""
    lo = multiway_split_plain(runs, d0, run_rows)
    hi = multiway_split_plain(runs, d1, run_rows)
    segs = [tuple(c[a:b] for c in as_cols(r))
            for r, a, b in zip(runs, lo, hi)]
    while len(segs) > 1:
        segs = [merge_sorted_plain(segs[i], segs[i + 1])
                for i in range(0, len(segs), 2)]
    return _like(runs[0], segs[0])


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
    ways = SORT_WAYS[len(cols)]
    planned = mergepath_passes(n, SORT_TILES[len(cols)], ways)
    out = _new_cols(len(cols), n, cols[0].device)
    # the passes ping-pong between `out` and `tmp`; one tile needs no pass
    tmp = (_new_cols(len(cols), n, cols[0].device) if len(planned) > 1
           else (None,) * len(cols))
    # a multiway pass keeps one split a run and output tile
    scratch = _scratch(n, cols[0].device, per_tile=ways)
    passes = ctypes.c_int(0)
    p_in, p_out, p_tmp = _col_ptrs(cols), _col_ptrs(out), _col_ptrs(tmp)
    lib = _build.library()
    err = lib.cbl_sort_keys(
        p_in, p_out, p_tmp, ctypes.c_int(len(cols)), ctypes.c_longlong(n),
        _ptr(scratch), ctypes.byref(passes),
        _build.stream_handle(cols[0].device),
    )
    _build.check_error(err, "sort")
    _build.check_passes(passes.value, planned, "sort")
    _build.LAUNCHES[launch_key("sort", len(cols))] += 1
    _build.PASSES["sort"] = passes.value
    return _like(keys, out)
