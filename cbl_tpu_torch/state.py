"""Carry a word set between `cbl_tpu` and this port.

`cbl_tpu.wordset.DeviceWordSet` holds its words as an [N, L] uint32 limb
array (`np.asarray(ws.data)`) with its distinct count (`ws.count()`); this
port holds one sorted int64 key tensor.  The two functions below convert
between them through numpy, so neither package imports the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CBLConfig
from .limbs import SENTINEL, from_limbs, to_limbs
from .wordset import DeviceWordSet


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
