"""Carry a word set, or a sorted log, between `cbl_tpu` and this port.

`cbl_tpu.wordset.DeviceWordSet` holds its words as an [N, L] uint32 limb
array (`np.asarray(ws.data)`) with its distinct count (`ws.count()`); this
port holds one sorted int64 key tensor.  During dynamic rounds `cbl_tpu`
holds a sorted log as uint32 columns (`ws._slog`): L limbs of
(word << 8) | tag where the config leaves 8 spare bits, else L word limbs
and a tag column; this port holds one int64 slog key per row
(`wordset.slog_key`).  The functions below convert through numpy, so
neither package imports the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CBLConfig
from .limbs import SENTINEL, from_limbs, to_limbs
from .wordset import _SLOG_BIAS, DeviceWordSet, slog_packed


def wordset_from_arrays(words_u32: np.ndarray, n_distinct: int,
                        cfg: CBLConfig, device) -> DeviceWordSet:
    """A port word set from `cbl_tpu` limbs [N, L] and its distinct count.

    The keys are sorted on the way in, so a limb array with sentinel rows
    between valid ones (`cbl_tpu`'s "holes" state) becomes contiguous."""
    if words_u32.ndim != 2 or words_u32.shape[1] != cfg.word_limbs:
        raise ValueError(
            f"expected [N, {cfg.word_limbs}] limbs, got {words_u32.shape}"
        )
    ws = DeviceWordSet(cfg, device)
    keys = torch.sort(torch.from_numpy(from_limbs(words_u32))).values
    n_valid = int((keys != SENTINEL).sum())
    if n_valid == 0:
        return ws
    ws.adopt_built(
        keys.to(ws.device),
        torch.tensor(int(n_distinct), dtype=torch.int64, device=ws.device),
        n_valid,
    )
    return ws


def wordset_to_arrays(ws: DeviceWordSet) -> tuple[np.ndarray, int]:
    """(limbs [capacity, L] uint32 with sentinel rows all-ones, distinct
    count) of a port word set, in `cbl_tpu`'s layout."""
    keys = ws.data.cpu().numpy()
    return to_limbs(keys, ws.cfg.word_limbs), ws.count()


def _jax_slog_packed(cfg: CBLConfig) -> bool:
    """`cbl_tpu`'s layout choice: the tag packs into the word limbs when
    they leave 8 spare bits (K=11 and 13 fill one limb and use a tag
    column there, though one int64 slog key holds them)."""
    return cfg.n_bits + 8 <= 32 * cfg.word_limbs


def _words_tags_to_keys(words: np.ndarray, tags: np.ndarray,
                        sent: np.ndarray) -> np.ndarray:
    """int64 slog keys of uint64 words and tags (sentinel rows ->
    SENTINEL)."""
    if np.any(tags[~sent] >= 0xFF):
        raise ValueError("a slog tag does not fit 8 bits below 0xFF")
    w = words.astype(np.int64) - np.int64(_SLOG_BIAS)
    keys = (w << np.int64(8)) | tags.astype(np.int64)
    keys[sent] = SENTINEL
    return keys


def slog_from_arrays(cols_u32, seq: int, real: int, n_upper: int,
                     cfg: CBLConfig, device) -> DeviceWordSet:
    """A port word set holding `cbl_tpu`'s active sorted log: `cols_u32`
    are its [n] uint32 columns (`ws._slog`, packed or with a tag column),
    `seq`, `real` and `n_upper` its `_slog_seq`, `_slog_real` and
    `_n_upper`."""
    if not slog_packed(cfg):
        raise NotImplementedError(
            f"K={cfg.k}: the port's slog key does not hold this config "
            "(ROADMAP slice 6)"
        )
    cols = [np.asarray(c, dtype=np.uint32) for c in cols_u32]
    L = cfg.word_limbs
    packed = _jax_slog_packed(cfg)
    if len(cols) != (L if packed else L + 1):
        raise ValueError(f"expected {L if packed else L + 1} slog columns "
                         f"for K={cfg.k}, got {len(cols)}")
    v = np.zeros(cols[0].shape[0], dtype=np.uint64)
    for c in cols[:L]:
        v = (v << np.uint64(32)) | c.astype(np.uint64)
    sent = np.all(np.stack(cols) == np.uint32(0xFFFFFFFF), axis=0)
    if packed:
        words, tags = v >> np.uint64(8), v & np.uint64(0xFF)
    else:
        words, tags = v, cols[L].astype(np.uint64)
    keys = _words_tags_to_keys(words, tags, sent)
    ws = DeviceWordSet(cfg, device)
    ws._slog = torch.from_numpy(keys).to(ws.device)
    ws._slog_seq = int(seq)
    ws._slog_real = int(real)
    ws._n_upper = int(n_upper)
    return ws


def slog_to_arrays(ws: DeviceWordSet):
    """(columns, seq, real, n_upper) of a port word set's active slog in
    `cbl_tpu`'s layout for its config: a tuple of [n] uint32 arrays,
    sentinel rows all-ones."""
    if ws._slog is None:
        raise ValueError("no active sorted log")
    keys = ws._slog.cpu().numpy()
    sent = keys == SENTINEL
    words = ((keys >> np.int64(8)) + np.int64(_SLOG_BIAS)).astype(np.uint64)
    tags = (keys & np.int64(0xFF)).astype(np.uint64)
    L = ws.cfg.word_limbs
    if _jax_slog_packed(ws.cfg):
        v, n_cols = (words << np.uint64(8)) | tags, L
    else:
        v, n_cols = words, L + 1
    cols = [
        ((v >> np.uint64(32 * (L - 1 - l))) & np.uint64(0xFFFFFFFF))
        .astype(np.uint32)
        for l in range(L)
    ]
    if n_cols > L:
        cols.append(tags.astype(np.uint32))
    for c in cols:
        c[sent] = np.uint32(0xFFFFFFFF)
    return tuple(cols), ws._slog_seq, ws._slog_real, ws._n_upper
