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
for a CUDA tensor.  Each kernel is one launch that reads every row once
and carries the scan across tiles (`BLANK_TILE`, `SLOG_TILE` rows) by
decoupled look-back.  `blank_mask_tiled` and `slog_scan_tiled` walk the same tile
protocol in plain code, so that the CPU tests can hold it to the plain
versions with tiles of a few rows.
"""

from __future__ import annotations

import ctypes
import operator

import torch

from . import _build
from ..limbs import SENTINEL

BLANK_TILE = 8192  # rows per block of csrc/scan.cu
SLOG_TILE = 4096  # rows per block of csrc/slog_scan.cu
SLOG_TAG_MAX = 0xFF  # the query / sentinel tag of a slog key
LOOKBACK_WINDOW = 32  # status words a look-back step reads, one a lane
# flags of a tile's status (flag, value); a status is None until published
AGGREGATE, INCLUSIVE = 1, 2


def _n_tiles(n: int, tile: int) -> int:
    return (n + tile - 1) // tile


_ONE_PASS = ["look-back scan"]  # both kernels' schedule: one launch


def _check_one_launch(launches: ctypes.c_int, kernel: str) -> None:
    """The C entry point reports the kernels it launched: one, always."""
    _build.check_passes(launches.value, _ONE_PASS, kernel)
    _build.PASSES[kernel] = launches.value


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
    if n == 0:
        return mask, torch.zeros((), dtype=torch.int32, device=delta.device)
    # int32 words: n_valid, a pad, the tile ticket (8-byte aligned), a pad,
    # then a 64-bit status word a tile
    scratch = torch.empty(4 + 2 * _n_tiles(n, BLANK_TILE),
                          dtype=torch.int32, device=delta.device)
    launches = ctypes.c_int(0)
    err = _build.library().cbl_blank_mask(
        ctypes.c_void_p(delta.data_ptr()),
        ctypes.c_void_p(mask.data_ptr()),
        ctypes.c_longlong(n),
        ctypes.c_void_p(scratch.data_ptr()),
        ctypes.byref(launches),
        _build.stream_handle(delta.device),
    )
    _build.check_error(err, "blank")
    _check_one_launch(launches, "blank")
    _build.LAUNCHES["blank"] += 1
    return mask, scratch[0]


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
    # (hits, live), the tile ticket, a 32-bit status word a tile
    scratch = torch.empty(3 + (_n_tiles(n, SLOG_TILE) + 1) // 2,
                          dtype=torch.int64, device=keys.device)
    launches = ctypes.c_int(0)
    err = _build.library().cbl_slog_scan_counts(
        ctypes.c_void_p(keys.data_ptr()),
        ctypes.c_longlong(n),
        ctypes.c_int(qtag),
        ctypes.c_void_p(scratch.data_ptr()),
        ctypes.byref(launches),
        _build.stream_handle(keys.device),
    )
    _build.check_error(err, "slog_scan")
    _check_one_launch(launches, "slog_scan")
    _build.LAUNCHES["slog_scan"] += 1
    return scratch[0], scratch[1]


# --- the kernels' tile protocol in plain code (for the CPU tests) -----------


def _look_back(status: list, t: int, combine):
    """What warp 0 of tile t's block computes: the statuses of tiles t - 1,
    t - 2, ... `LOOKBACK_WINDOW` a step, nearest first, folded by
    `combine(earlier, later)` up to and including the nearest INCLUSIVE
    one.  The card's warp waits while a status it reads is unpublished;
    here every tile before t has published, or the protocol is broken."""
    acc = None
    for hi in range(t - 1, -1, -LOOKBACK_WINDOW):
        window = [status[i]
                  for i in range(hi, max(hi - LOOKBACK_WINDOW, -1), -1)]
        if any(s is None for s in window):
            raise RuntimeError(f"tile {t} looks back at an unpublished tile")
        for flag, value in window:
            acc = value if acc is None else combine(value, acc)
            if flag == INCLUSIVE:
                return acc
    raise RuntimeError(f"tile {t} found no inclusive prefix before it")


def _waves(n_tiles: int, wave: int | None):
    """The tiles in ticket order, `wave` at a time (all at once for None):
    every tile of a wave publishes before any of them looks back, and they
    look back in reverse ticket order, so the last walks the furthest."""
    wave = max(n_tiles, 1) if wave is None else wave
    for w0 in range(0, n_tiles, wave):
        yield range(w0, min(w0 + wave, n_tiles))


def blank_mask_tiled(delta: torch.Tensor, tile: int = BLANK_TILE,
                     wave: int | None = None):
    """`blank_mask_plain` by kernel B2's tile protocol (`csrc/scan.cu`):
    each tile publishes its sum (tile 0 as its INCLUSIVE prefix), looks
    back for the sum before it, publishes its own inclusive prefix and
    blanks its rows from that prefix.  Only the tile's own rows and the
    statuses of the tiles before it are read."""
    n = delta.shape[0]
    n_tiles = _n_tiles(n, tile)
    status = [None] * n_tiles
    mask = torch.empty_like(delta)
    n_valid = 0
    for tiles in _waves(n_tiles, wave):
        for t in tiles:
            agg = int(delta[t * tile : (t + 1) * tile].sum())
            status[t] = (INCLUSIVE if t == 0 else AGGREGATE, agg)
        for t in reversed(tiles):
            prefix = 0
            if t > 0:
                prefix = _look_back(status, t, operator.add)
                status[t] = (INCLUSIVE, prefix + status[t][1])
            rows = slice(t * tile, (t + 1) * tile)
            blanked = prefix + torch.cumsum(delta[rows], 0) > 0
            mask[rows] = blanked.to(torch.int32)
            n_valid += int((~blanked).sum())
    return mask, torch.tensor(n_valid, dtype=torch.int32)


def _last_known(earlier, later):
    return earlier if later is None else later


def slog_scan_tiled(keys: torch.Tensor, qtag: int, tile: int = SLOG_TILE,
                    wave: int | None = None):
    """`slog_scan_counts_plain` by kernel B4's tile protocol
    (`csrc/slog_scan.cu`).  Markers grow with the row index, so the
    running max at a row is its last marker, and the state that crosses a
    tile is one bit: whether the last marker before it is an insert entry.
    A tile whose first row is a sentinel counts nothing and publishes
    nothing (every later tile is all sentinels too).  Any other tile
    publishes its last marker's bit as INCLUSIVE, or AGGREGATE (no
    marker, value None) when it has none; when its first row is no marker
    it looks back for the bit before it, and publishes that bit as
    INCLUSIVE if it had no marker.  Only the tile's rows, rows base - 1
    and base + tile, and the statuses of the tiles before it are read."""
    n = keys.shape[0]
    n_tiles = _n_tiles(n, tile)
    status = [None] * n_tiles
    hits = live = 0
    for tiles in _waves(n_tiles, wave):
        rows = {}
        for t in tiles:
            base = t * tile
            if int(keys[base]) == SENTINEL:
                continue
            lo = max(base - 1, 0)
            ext = keys[lo : base + tile + 1]  # rows base - 1 .. base + tile
            run_start, sent, entry, insert = slog_rows(ext)
            own = slice(base - lo, base - lo + min(tile, n - base))
            run_end = torch.cat([run_start[own.start + 1 :],
                                 torch.ones(1, dtype=torch.bool)])
            marked = (run_start | entry)[own]
            rows[t] = (marked, (entry & insert)[own],
                       ~sent[own] & ((ext[own] & SLOG_TAG_MAX) == qtag),
                       ~sent[own] & run_end[: marked.shape[0]])
            at = marked.nonzero()
            status[t] = ((INCLUSIVE, int(rows[t][1][at[-1]])) if len(at)
                         else (AGGREGATE, None))
        for t in reversed(tiles):
            if t not in rows:
                continue
            marked, ins, hit, end = rows[t]
            carry = 0
            if not marked[0]:
                carry = _look_back(status, t, _last_known)
                if status[t][0] == AGGREGATE:
                    status[t] = (INCLUSIVE, carry)
            idx = torch.arange(marked.shape[0])
            last = torch.cummax(torch.where(marked, idx, -1), 0).values
            state = torch.where(last >= 0, ins[last.clamp(min=0)],
                                bool(carry))
            hits += int((state & hit).sum())
            live += int((state & end).sum())
    return torch.tensor(hits), torch.tensor(live)
