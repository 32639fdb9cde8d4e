"""Carry a word set, or a sorted log, between `cbl_tpu` and this port.

`cbl_tpu.wordset.DeviceWordSet` holds its words as an [N, L] uint32 limb
array (`np.asarray(ws.data)`) with its distinct count (`ws.count()`); this
port holds one sorted int64 key tensor ([N] keys, or [2, N] rows for
n_bits > 60, `limbs`).  Its pending log is a [P, L] limb array `pending`,
uint32 `pending_tags` and the counters `n_pending` and `_pending_rm`; the
port's is a key tensor of the same layout and int64 tags of the same
values.  During dynamic rounds `cbl_tpu`
holds a sorted log as uint32 columns (its `_slog`): L limbs of
(word << 8) | tag where the config leaves 8 spare bits
(`wordset.slog_tag_in_limbs`), else L word limbs and a tag column; this
port's `wordset.SortedLog` holds one int64 slog key a row
(`wordset.slog_key`) where `wordset.slog_packed`, else the word's columns
and an int64 tag column.
Either of `cbl_tpu`'s layouts maps to either of the port's; the join and
sentinel tag (0xFF packed, 0xFFFFFFFF in a tag column) maps to the
port's (0xFF in a key, INT64_MAX in a tag column) and back.  The
functions below convert through numpy, so neither package imports the
other.

A `cbl_tpu` `ShardedCBL` travels as a dict of numpy arrays named after
its attributes (`sharded_to_arrays` / `sharded_from_arrays`): `data`
[D, C, L] (every shard's rows, duplicates and sentinel padding
included), `boundaries` [D-1, L], `counts` [D], `dups`, `count_upper`,
`boundaries_from_data`, and while a round log is live `slog` (its
columns, each [D, S]), `slog_seq`, `slog_real` and `slog_live`.  `counts`
is None in an index that has counted nothing since its log began.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CBLConfig
from .limbs import (
    SENTINEL,
    cols,
    from_limbs,
    is_valid,
    key_cols,
    rows_lt,
    stack,
    to_limbs,
)
from .ops.merge import sort_cols_plain
from .ops.scan import slog_is_packed
from .wordset import (
    _SLOG_BIAS,
    DeviceWordSet,
    SortedLog,
    slog_packed,
    slog_tag_in_limbs,
)

_U32_MAX = 0xFFFFFFFF


def wordset_from_arrays(words_u32: np.ndarray, n_distinct: int,
                        cfg: CBLConfig, device, holes: bool = False,
                        dups: bool = True,
                        n_upper: int | None = None) -> DeviceWordSet:
    """A port word set from `cbl_tpu`'s `data` limbs [N, L], its distinct
    count and its state: `holes` and `dups` are its `_holes` and `_dups`
    flags, `n_upper` its `_n_upper` (default: the number of valid rows).

    With `holes` the rows keep their order (valid keys ascending, sentinel
    rows anywhere); without, the keys are sorted on the way in, so any
    limb array gives a contiguous index."""
    if words_u32.ndim != 2 or words_u32.shape[1] != cfg.word_limbs:
        raise ValueError(
            f"expected [N, {cfg.word_limbs}] limbs, got {words_u32.shape}"
        )
    ws = DeviceWordSet(cfg, device)
    keys = torch.from_numpy(from_limbs(words_u32, key_cols(cfg)))
    valid = keys[..., is_valid(keys)]
    if holes:
        if not bool(rows_lt(valid[..., :-1], valid[..., 1:]).all()):
            raise ValueError("an index with holes needs its valid keys "
                             "ascending and unique")
    else:
        keys = stack(sort_cols_plain(cols(keys)))
    n_valid = valid.shape[-1]
    if n_valid == 0:
        return ws
    if n_upper is None:
        n_upper = n_valid
    if not n_valid <= n_upper <= keys.shape[-1]:
        raise ValueError(f"n_upper {n_upper} does not bound the "
                         f"{n_valid} valid rows of {keys.shape[-1]}")
    ws.data = keys.to(ws.device)
    ws.capacity = keys.shape[-1]
    ws._holes, ws._dups = bool(holes), bool(dups)
    ws._n_upper = int(n_upper)
    ws._set_count(
        torch.tensor(int(n_distinct), dtype=torch.int64, device=ws.device))
    return ws


def wordset_to_arrays(ws: DeviceWordSet) -> tuple[np.ndarray, int, dict]:
    """(limbs [capacity, L] uint32 with sentinel rows all-ones, distinct
    count, state) of a port word set, in `cbl_tpu`'s layout, its logs
    folded first; `state` holds `holes`, `dups` and `n_upper`, the keyword
    arguments of `wordset_from_arrays`.  Rows keep their order, holes
    included."""
    n = ws.count()
    keys = ws.data.cpu().numpy()
    return to_limbs(keys, ws.cfg.word_limbs), n, dict(
        holes=ws._holes, dups=ws._dups, n_upper=ws._n_upper)


def _tag_max(in_limbs: bool) -> int:
    """`cbl_tpu`'s join and sentinel tag in its layout."""
    return 0xFF if in_limbs else _U32_MAX


def _shr8(cols: list) -> list:
    """`cbl_tpu`'s packed-tag limbs (word << 8) | tag -> the word's limbs
    (its `_shr8`)."""
    return [(c >> np.uint32(8))
            | (cols[l - 1] << np.uint32(24) if l else np.uint32(0))
            for l, c in enumerate(cols)]


def _shl8_or(limbs: list, tags: np.ndarray) -> list:
    """The word's limbs and 8-bit tags -> `cbl_tpu`'s packed-tag limbs
    (its `_shl8_or`)."""
    L = len(limbs)
    return [(v << np.uint32(8))
            | (limbs[l + 1] >> np.uint32(24) if l + 1 < L
               else tags.astype(np.uint32))
            for l, v in enumerate(limbs)]


def _slog_keys(cols_u32, cfg: CBLConfig) -> np.ndarray:
    """The port's slog keys ([n], or [C, n] with the tag last) of
    `cbl_tpu`'s [n] uint32 slog columns."""
    cols = [np.asarray(c, dtype=np.uint32) for c in cols_u32]
    L = cfg.word_limbs
    in_limbs = slog_tag_in_limbs(cfg)
    if len(cols) != (L if in_limbs else L + 1):
        raise ValueError(f"expected {L if in_limbs else L + 1} slog columns "
                         f"for K={cfg.k}, got {len(cols)}")
    sent = np.all(np.stack(cols[:L]) == np.uint32(_U32_MAX), axis=0)
    if in_limbs:
        limbs, tags = _shr8(cols), cols[L - 1] & np.uint32(0xFF)
    else:
        limbs, tags = cols[:L], cols[L]
    rows = np.stack(limbs, axis=1)
    rows[sent] = np.uint32(_U32_MAX)
    words = from_limbs(rows, key_cols(cfg))
    tags = tags.astype(np.int64)
    query = tags == _tag_max(in_limbs)
    if slog_packed(cfg):
        if np.any(query & ~sent):
            raise ValueError("a packed slog row holds a join query's tag")
        keys = ((words - np.int64(_SLOG_BIAS)) << np.int64(8)) | tags
        keys[sent] = SENTINEL
    else:
        tags[query | sent] = SENTINEL
        keys = np.concatenate([words.reshape(-1, len(tags)), tags[None]])
    return keys


def slog_from_arrays(cols_u32, seq: int, real: int, n_upper: int,
                     cfg: CBLConfig, device) -> DeviceWordSet:
    """A port word set holding `cbl_tpu`'s active sorted log: `cols_u32`
    are its [n] uint32 columns (its `_slog`, packed or with a tag column),
    `seq`, `real` and `n_upper` its `_slog_seq`, `_slog_real` and
    `_n_upper`."""
    ws = DeviceWordSet(cfg, device)
    keys = torch.from_numpy(_slog_keys(cols_u32, cfg)).to(ws.device)
    ws.slog = SortedLog(cfg, [keys], int(seq), int(real))
    ws._n_upper = int(n_upper)
    return ws


def _slog_cols(log: torch.Tensor, cfg: CBLConfig) -> tuple:
    """`cbl_tpu`'s [n] uint32 slog columns of one port log, sentinel rows
    all-ones."""
    keys = log.cpu().numpy()
    if slog_is_packed(log):
        sent = keys == SENTINEL
        words = (keys >> np.int64(8)) + np.int64(_SLOG_BIAS)
        words[sent] = SENTINEL
        tags = keys & np.int64(0xFF)
        query = tags == 0xFF
    else:
        words, tags = keys[:-1], keys[-1].copy()
        words = words[0] if len(words) == 1 else words
        sent = keys[0] == SENTINEL
        query = tags == SENTINEL
    L = cfg.word_limbs
    in_limbs = slog_tag_in_limbs(cfg)
    tag_max = _tag_max(in_limbs)
    if np.any(tags[~query] >= tag_max):
        raise ValueError(f"a slog tag does not fit below {tag_max:#x}")
    tags[query] = tag_max
    rows = to_limbs(words, L)
    limbs = [rows[:, l].copy() for l in range(L)]
    cols = _shl8_or(limbs, tags) if in_limbs else limbs + [
        tags.astype(np.uint32)]
    for c in cols:
        c[sent] = np.uint32(_U32_MAX)
    return tuple(cols)


def slog_to_arrays(ws: DeviceWordSet):
    """(columns, seq, real, n_upper) of a port word set's active slog in
    `cbl_tpu`'s layout for its config: a tuple of [n] uint32 arrays,
    sentinel rows all-ones."""
    if ws.slog.keys is None:
        raise ValueError("no active sorted log")
    return (_slog_cols(ws.slog.keys[0], ws.cfg), ws.slog.seq, ws.slog.real,
            ws._n_upper)


def pending_from_arrays(ws: DeviceWordSet, pending_u32: np.ndarray,
                        tags_u32: np.ndarray, n_pending: int,
                        pending_rm: bool) -> None:
    """Give the port word set `ws` `cbl_tpu`'s pending log: its `pending`
    [P, L] limbs, `pending_tags` [P], `n_pending` and `_pending_rm`.  P
    becomes the log's capacity."""
    pending_u32 = np.asarray(pending_u32, dtype=np.uint32)
    tags_u32 = np.asarray(tags_u32, dtype=np.uint32)
    if (pending_u32.ndim != 2 or pending_u32.shape[1] != ws.cfg.word_limbs
            or tags_u32.shape != pending_u32.shape[:1]):
        raise ValueError(
            f"expected [P, {ws.cfg.word_limbs}] limbs and [P] tags, got "
            f"{pending_u32.shape} and {tags_u32.shape}"
        )
    if not 0 <= n_pending <= tags_u32.shape[0]:
        raise ValueError(f"n_pending {n_pending} outside the log")
    ws.pending_cap = tags_u32.shape[0]
    ws.pending = torch.from_numpy(
        from_limbs(pending_u32, key_cols(ws.cfg))).to(ws.device)
    ws.pending_tags = torch.from_numpy(tags_u32.astype(np.int64)).to(ws.device)
    ws.n_pending = int(n_pending)
    ws._pending_rm = bool(pending_rm)


def pending_to_arrays(ws: DeviceWordSet):
    """(pending [P, L] uint32, tags [P] uint32, n_pending, pending_rm) of
    a port word set's pending log, in `cbl_tpu`'s layout."""
    pending = to_limbs(ws.pending.cpu().numpy(), ws.cfg.word_limbs)
    tags = ws.pending_tags.cpu().numpy().astype(np.uint32)
    return pending, tags, ws.n_pending, ws._pending_rm


def sharded_from_arrays(arrays: dict, cfg: CBLConfig, canonical: bool,
                        mesh, batch_per_device: int = 1 << 14):
    """A port `ShardedCBL` on `mesh` in the state of `cbl_tpu`'s, given as
    the dict of `sharded_to_arrays`; each shard's log goes through
    `_slog_keys`."""
    from .parallel import ShardedCBL

    data = np.asarray(arrays["data"], dtype=np.uint32)
    D, C, _ = data.shape
    sh = ShardedCBL(k=cfg.k, prefix_bits=cfg.prefix_bits,
                    canonical=canonical, mesh=mesh, shard_capacity=C,
                    batch_per_device=batch_per_device)
    if sh.D != D:
        raise ValueError(f"state has {D} shards; the mesh has {sh.D}")
    n_cols = key_cols(cfg)
    sh.data = [torch.from_numpy(from_limbs(data[d], n_cols)).to(dev)
               for d, dev in enumerate(sh.mesh)]
    sh.boundaries = from_limbs(np.asarray(arrays["boundaries"], np.uint32),
                               n_cols)
    sh._boundaries_from_data = bool(arrays["boundaries_from_data"])
    sh._dups = bool(arrays["dups"])
    counts = arrays["counts"]  # None: no count since a log began
    sh._counts_dev = None if counts is None else [
        torch.tensor(int(c), dtype=torch.int64, device=dev)
        for c, dev in zip(counts, sh.mesh)]
    sh._counts_host = None
    sh._count_upper = int(arrays["count_upper"])
    if arrays.get("slog") is not None:
        cols_u32 = [np.asarray(c, dtype=np.uint32) for c in arrays["slog"]]
        live = arrays.get("slog_live")
        sh.slog = SortedLog(
            cfg,
            [torch.from_numpy(_slog_keys([c[d] for c in cols_u32], cfg))
             .to(dev) for d, dev in enumerate(sh.mesh)],
            int(arrays["slog_seq"]), int(arrays["slog_real"]),
            None if live is None else torch.tensor(
                int(live), dtype=torch.int64, device=sh.mesh[0]))
    return sh


def sharded_to_arrays(sh) -> dict:
    """The state of a port `ShardedCBL` in `cbl_tpu`'s layout: the dict
    that `sharded_from_arrays` takes (counts read without the overflow
    check, so nothing in `sh` changes)."""
    L = sh.cfg.word_limbs
    counts = (sh._counts_host if sh._counts_host is not None
              else None if sh._counts_dev is None
              else torch.stack([c.cpu() for c in sh._counts_dev]).numpy())
    out = dict(
        data=np.stack([to_limbs(d.cpu().numpy(), L) for d in sh.data]),
        boundaries=sh.boundary_limbs(),
        counts=None if counts is None else np.asarray(counts, np.int64),
        dups=sh._dups, count_upper=sh._count_upper,
        boundaries_from_data=sh._boundaries_from_data,
        slog=None, slog_seq=sh.slog.seq, slog_real=sh.slog.real,
        slog_live=(None if sh.slog.live is None else int(sh.slog.live)))
    if sh.slog.keys is not None:
        per_shard = [_slog_cols(s, sh.cfg) for s in sh.slog.keys]
        out["slog"] = tuple(np.stack(c) for c in zip(*per_shard))
    return out
