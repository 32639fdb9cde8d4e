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
import torch

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


def _check_limbs(L: int) -> None:
    if L not in (1, 2):
        raise ValueError(f"L must be 1 or 2, got {L}")


def keys_to_limbs(keys: torch.Tensor, L: int) -> torch.Tensor:
    """[N] int64 keys -> [N, L] int32 big-endian limbs on the keys'
    device, to be read as uint32 (`.view(np.uint32)` on the host): the
    halves of each little-endian int64, high half first for L = 2, the
    low half for L = 1.  One copy, no arithmetic.  SENTINEL becomes
    (0x7FFFFFFF, 0xFFFFFFFF) here; `to_limbs` makes it all ones."""
    _check_limbs(L)
    halves = keys.contiguous().view(torch.int32).view(-1, 2)
    return halves[:, :1].contiguous() if L == 1 else halves.flip(1)


def from_limbs(rows: np.ndarray) -> np.ndarray:
    """[N, L] uint32 big-endian limbs -> [N] int64 keys (all-ones rows ->
    SENTINEL): the rows' halves swapped (as `keys_to_limbs`, backwards)
    and read as int64 for L = 2.  Requires L <= 2 and non-sentinel values
    below 2^63 - 1."""
    rows = np.require(rows, dtype=np.uint32, requirements=["C", "W"])
    if rows.ndim != 2:
        raise ValueError(f"expected [N, 1 or 2] uint32 limbs, got {rows.shape}")
    _check_limbs(rows.shape[1])
    if rows.shape[1] == 1:
        keys = rows[:, 0].astype(np.int64)
        all_ones = 0xFFFFFFFF
    else:
        halves = torch.from_numpy(rows.view(np.int32)).flip(1)
        keys = halves.numpy().view(np.int64).reshape(-1)
        all_ones = -1
        # every other row must read as a key in [0, INT64_MAX)
        if keys.shape[0] and (keys.min() < -1 or keys.max() == SENTINEL):
            raise ValueError("a non-sentinel row does not fit below "
                             "INT64_MAX")
    keys[keys == all_ones] = SENTINEL
    return keys


def to_limbs(keys: np.ndarray, L: int) -> np.ndarray:
    """[N] int64 keys -> [N, L] uint32 big-endian limbs (SENTINEL ->
    all-ones rows, as `cbl_tpu` stores empty slots), by `keys_to_limbs`
    on the host."""
    keys = np.require(keys, dtype=np.int64, requirements=["C", "W"])
    out = keys_to_limbs(torch.from_numpy(keys), L).numpy().view(np.uint32)
    out[keys == SENTINEL] = np.uint32(0xFFFFFFFF)
    return out


def from_py_ints(values, limbs: int) -> np.ndarray:
    """[N] Python ints -> [N, L] uint32 big-endian limbs (L = 1 or 2)."""
    _check_limbs(limbs)
    v = np.asarray([int(x) for x in values], dtype=np.uint64)
    out = np.empty((len(v), limbs), dtype=np.uint32)
    out[:, limbs - 1] = (v & 0xFFFFFFFF).astype(np.uint32)
    if limbs == 2:
        out[:, 0] = (v >> np.uint64(32)).astype(np.uint32)
    return out


def to_py_ints(arr: np.ndarray) -> list[int]:
    """[N, L] uint32 limbs (L = 1 or 2; one row may come as [L]) -> [N]
    Python ints."""
    arr = np.asarray(arr, dtype=np.uint32)
    if arr.ndim == 1:
        arr = arr[None, :]
    _check_limbs(arr.shape[1])
    if arr.shape[1] == 1:
        return arr[:, 0].tolist()
    v = (arr[:, 0].astype(np.uint64) << np.uint64(32)) | arr[:, 1]
    return v.tolist()
