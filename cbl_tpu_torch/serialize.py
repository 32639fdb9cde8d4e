"""Index checkpoints: `cbl_tpu`'s CBLX files.

Counterpart of `cbl_tpu/serialize.py`, file for file: an uncompressed
`.npz` with the header arrays `magic` ("CBLX"), `version` (1), `k`,
`prefix_bits` and `canonical`, and `words`, the index's sorted unique
words as [n, L] uint32 big-endian limb rows (`DeviceWordSet.words_array`).
A file written by either package loads in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .limbs import from_limbs, key_cols, sentinel_rows
from .wordset import MIN_CAP, _next_pow2

MAGIC = "CBLX"
VERSION = 1


def save(cbl, path) -> None:
    # uncompressed: packed necklace words are near-incompressible and zlib
    # costs seconds per 100 MB; the sorted array is the index's canonical
    # form.  np.savez appends ".npz" to a name without it.
    words = cbl.wordset.words_array()
    np.savez(
        path if str(path).endswith(".npz") else str(path),
        magic=np.array(MAGIC),
        version=np.array(VERSION),
        k=np.array(cbl.cfg.k),
        prefix_bits=np.array(cbl.cfg.prefix_bits),
        canonical=np.array(cbl.canonical),
        words=words,
    )


def _npz_path(path) -> str:
    """`path`, or `path` + ".npz" where only that exists."""
    p = str(path)
    if os.path.exists(p):
        return p
    if os.path.exists(p + ".npz"):
        return p + ".npz"
    return p


def load(path, device=None):
    """The index of a CBLX file on `device` (default: the card).  The
    saved rows are sorted and unique, so they are installed as the
    index directly, SENTINEL-padded to a power of two: no kernel runs."""
    from .cbl import CBL

    with np.load(_npz_path(path)) as z:
        if str(z["magic"]) != MAGIC:
            raise ValueError(f"{path}: not a cbl_tpu index file")
        version = int(z["version"])
        if version > VERSION:
            raise ValueError(f"{path}: unsupported index version {version}")
        k = int(z["k"])
        prefix_bits = int(z["prefix_bits"])
        canonical = bool(z["canonical"])
        words = z["words"]
    kw = {} if device is None else {"device": device}
    cbl = CBL(k=k, prefix_bits=prefix_bits, canonical=canonical, **kw)
    n = int(words.shape[0])
    if n:
        ws = cbl.wordset
        cap = max(_next_pow2(n), MIN_CAP)
        n_cols = key_cols(cbl.cfg)
        keys = sentinel_rows(cap, n_cols, "cpu")
        keys[..., :n] = torch.from_numpy(from_limbs(words, n_cols))
        ws.data = keys.to(ws.device)
        ws.capacity = cap
        ws._n_host = ws._n_upper = n
        ws._n_dev = torch.tensor(n, dtype=torch.int64, device=ws.device)
        ws._dups = ws._holes = False
    return cbl
