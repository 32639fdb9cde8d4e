"""Packed words as single int64 keys.

`cbl_tpu` holds a packed word as L big-endian uint32 limbs (limb 0 most
significant) because the TPU has no 64-bit integers.  PyTorch on the CPU
has no `<`, shifts, `cummax` or `searchsorted` for `uint32`, so this port
holds each word as ONE int64 key instead:

    key = sum(limb_l << 32 * (L - 1 - l))

The sentinel (an empty slot, `cbl_tpu`'s all-ones row) is `INT64_MAX`, so
it still sorts after every valid word.  Read naively as int64 the all-ones
row would be -1 and sort FIRST; `from_limbs` maps it explicitly.

The key has room for odd K <= 27: there `n_bits` <= 60, so the query
join's shifted tag bit (`wordset._shift_tag`) still fits below the sign
bit and no valid key, shifted or not, can equal the sentinel.  Wider K
needs multi-limb keys (ROADMAP slice 6) and is refused.

int64 `>>` is arithmetic; every value here stays non-negative, so it acts
as a logical shift.
"""

from __future__ import annotations

import numpy as np

from .config import CBLConfig

SENTINEL = (1 << 63) - 1
MAX_KEY_BITS = 60  # n_bits of K=27; K=29 needs 64


def check_config(cfg: CBLConfig) -> None:
    """Refuse configurations whose words do not fit one int64 key."""
    if cfg.n_bits > MAX_KEY_BITS:
        raise NotImplementedError(
            f"K={cfg.k} packs {cfg.n_bits}-bit words; cbl_tpu_torch holds "
            f"words as one int64 key and supports odd K <= 27 "
            f"(n_bits <= {MAX_KEY_BITS}). Multi-limb keys are ROADMAP "
            "slice 6 (wide K)."
        )


def low_mask(bits: int) -> int:
    """Python int with the low `bits` bits set."""
    return (1 << bits) - 1


def from_limbs(rows: np.ndarray) -> np.ndarray:
    """[N, L] uint32 big-endian limbs -> [N] int64 keys (all-ones rows ->
    SENTINEL).  Requires L <= 2 and non-sentinel values below 2^63."""
    rows = np.asarray(rows, dtype=np.uint32)
    if rows.ndim != 2 or rows.shape[1] not in (1, 2):
        raise ValueError(f"expected [N, 1 or 2] uint32 limbs, got {rows.shape}")
    L = rows.shape[1]
    key = np.zeros(rows.shape[0], dtype=np.uint64)
    for l in range(L):
        key = (key << np.uint64(32)) | rows[:, l].astype(np.uint64)
    sent = np.all(rows == np.uint32(0xFFFFFFFF), axis=1)
    if np.any(key[~sent] >= np.uint64(SENTINEL)):
        raise ValueError("a non-sentinel row does not fit below INT64_MAX")
    out = key.astype(np.int64)
    out[sent] = SENTINEL
    return out


def to_limbs(keys: np.ndarray, L: int) -> np.ndarray:
    """[N] int64 keys -> [N, L] uint32 big-endian limbs (SENTINEL ->
    all-ones rows, as `cbl_tpu` stores empty slots)."""
    keys = np.asarray(keys, dtype=np.int64)
    if L not in (1, 2):
        raise ValueError(f"L must be 1 or 2, got {L}")
    sent = keys == SENTINEL
    u = keys.astype(np.uint64)
    out = np.empty((keys.shape[0], L), dtype=np.uint32)
    for l in range(L):
        out[:, L - 1 - l] = (u >> np.uint64(32 * l)) & np.uint64(0xFFFFFFFF)
    out[sent] = np.uint32(0xFFFFFFFF)
    return out
