"""The plain k-mer set reference: the same operations on the same codes.

Plain PyTorch tensor arithmetic (on the card or the CPU), written from the
definitions and independent of the program under test: no necklaces, no
packed words, no sorted logs and no kernels.

- A k-mer is its 2K-bit integer, first base most significant (the 2-bit
  codes as they are generated).  K <= 31 gives one int64 column; wider K
  gives two, column 0 the first K - 31 bases and column 1 the last 31
  (62 bits).  `cols` below are such tuples of equal-length int64 tensors.
- A k-mer lies inside one record; `kmer_cols` skips those that cross a
  record boundary.
- Canonical mode keeps, of a k-mer and its reverse complement
  (complement = code XOR 2), the one of even popcount (K is odd).
- Every set is worked out by `unique_inverse`: a lexicographic sort of all
  the keys involved, so that each distinct k-mer gets one id; sets are then
  boolean tensors over those ids.
"""

from __future__ import annotations

import numpy as np
import torch

LOW_BASES = 31  # bases in the low column of a two-column k-mer


def n_cols(k: int) -> int:
    return 1 if k <= LOW_BASES else 2


def n_kmers(offsets: np.ndarray, k: int) -> int:
    """Valid k-mers of a record stream (each record's len - K + 1)."""
    return int(np.maximum(np.diff(offsets) - (k - 1), 0).sum())


def _valid_starts(offsets: np.ndarray, k: int, n_pos: int, device):
    """[n_pos] bool: True where a k-mer starting there ends in its record."""
    lens = np.diff(np.asarray(offsets, dtype=np.int64))
    rec = torch.repeat_interleave(
        torch.arange(len(lens), device=device),
        torch.as_tensor(lens, device=device))
    return rec[:n_pos] == rec[k - 1 : k - 1 + n_pos]


def _pack(codes: torch.Tensor, first: int, width: int, n_pos: int):
    """[n_pos] int64: bases first .. first + width - 1 of each k-mer."""
    acc = torch.zeros(n_pos, dtype=torch.int64, device=codes.device)
    for j in range(first, first + width):
        acc = (acc << 2) | codes[j : j + n_pos]
    return acc


def _all_cols(codes: torch.Tensor, k: int, n_pos: int) -> tuple:
    if k <= LOW_BASES:
        return (_pack(codes, 0, k, n_pos),)
    return (_pack(codes, 0, k - LOW_BASES, n_pos),
            _pack(codes, k - LOW_BASES, LOW_BASES, n_pos))


def _popcount_parity(x: torch.Tensor) -> torch.Tensor:
    for s in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def kmer_cols(codes, offsets, k: int, canonical: bool = False,
              device="cpu") -> tuple:
    """Every valid k-mer of a record stream, in stream order.

    codes: uint8 numpy array of 2-bit base codes; offsets: record bounds
    [n_records + 1].  -> tuple of n_cols(k) int64 tensors on `device`."""
    c = torch.as_tensor(np.asarray(codes), device=device).to(torch.int64)
    n_pos = max(len(c) - k + 1, 0)
    if n_pos == 0:
        return tuple(torch.zeros(0, dtype=torch.int64, device=device)
                     for _ in range(n_cols(k)))
    fwd = _all_cols(c, k, n_pos)
    if canonical:
        rc = _all_cols(torch.flip(c ^ 2, [0]), k, n_pos)
        rc = tuple(torch.flip(x, [0]) for x in rc)
        par = _popcount_parity(fwd[0] ^ fwd[-1]) if len(fwd) == 2 else \
            _popcount_parity(fwd[0])
        fwd = tuple(torch.where(par == 0, f, r) for f, r in zip(fwd, rc))
    keep = _valid_starts(offsets, k, n_pos, device)
    return tuple(x[keep] for x in fwd)


def lexsort(cols: tuple) -> torch.Tensor:
    """The permutation that sorts rows by column 0, then column 1."""
    perm = torch.argsort(cols[-1], stable=True)
    for col in reversed(cols[:-1]):
        perm = perm[torch.argsort(col[perm], stable=True)]
    return perm


def unique_inverse(cols: tuple):
    """(sorted distinct rows as a cols tuple, [N] int64 id of each row)."""
    n = cols[0].shape[0]
    if n == 0:
        return cols, torch.zeros(0, dtype=torch.int64,
                                 device=cols[0].device)
    perm = lexsort(cols)
    s = tuple(c[perm] for c in cols)
    new = torch.ones(n, dtype=torch.bool, device=cols[0].device)
    diff = torch.zeros(n - 1, dtype=torch.bool, device=cols[0].device)
    for c in s:
        diff |= c[1:] != c[:-1]
    new[1:] = diff
    ids_sorted = torch.cumsum(new.to(torch.int64), 0) - 1
    inv = torch.empty_like(ids_sorted)
    inv[perm] = ids_sorted
    return tuple(c[new] for c in s), inv


def cat_cols(parts: list) -> tuple:
    return tuple(torch.cat(cs) for cs in zip(*parts, strict=True))


class Universe:
    """Distinct ids for the k-mers of several streams at once: `ids(i)`
    is stream i's k-mers as ids, `keys` the distinct k-mers, sorted."""

    def __init__(self, parts: list):
        self.sizes = [p[0].shape[0] for p in parts]
        self.keys, inv = unique_inverse(cat_cols(parts))
        self._ids = torch.split(inv, self.sizes)

    @property
    def n(self) -> int:
        return self.keys[0].shape[0]

    def ids(self, i: int) -> torch.Tensor:
        return self._ids[i]

    def empty_set(self) -> torch.Tensor:
        return torch.zeros(self.n, dtype=torch.bool,
                           device=self.keys[0].device)


def rows_differ(a: tuple, b: tuple) -> int:
    """Rows of a that b lacks plus rows of b that a lacks, as multisets (a
    repeated row counts once per extra copy): 0 iff both hold the same
    rows."""
    if a[0].shape[0] + b[0].shape[0] == 0:
        return 0
    u = Universe([a, b])
    ca = torch.bincount(u.ids(0), minlength=u.n)
    cb = torch.bincount(u.ids(1), minlength=u.n)
    return int((ca - cb).abs().sum())


def limbs_to_cols(limbs: np.ndarray, k: int, device="cpu") -> tuple:
    """[N, L] uint32 big-endian limbs of 2K-bit k-mers -> the cols tuple."""
    a = torch.as_tensor(np.asarray(limbs, dtype=np.uint32).view(np.int32),
                        device=device).to(torch.int64) & 0xFFFFFFFF
    L = a.shape[1] if a.dim() == 2 else 0
    if a.shape[0] == 0:
        return tuple(torch.zeros(0, dtype=torch.int64, device=device)
                     for _ in range(n_cols(k)))
    if k <= 16:
        return (a[:, L - 1],)
    if k <= LOW_BASES:
        return ((a[:, L - 2] << 32) | a[:, L - 1],)
    # value = l0 << 96 | l1 << 64 | l2 << 32 | l3 (L = 4), or l0 << 64 |
    # l1 << 32 | l2 (L = 3); the low column is its low 62 bits
    l3, l2, l1 = a[:, L - 1], a[:, L - 2], a[:, L - 3]
    l0 = a[:, 0] if L == 4 else torch.zeros_like(l3)
    lo = ((l2 & 0x3FFFFFFF) << 32) | l3
    hi = (l0 << 34) | (l1 << 2) | (l2 >> 30)
    return hi, lo
