"""The plain reference against a brute-force Python set of k-mers."""

import numpy as np
import pytest
import torch

from kmerbench.reference import kmers as ref
from kmerbench.reference.control import fingerprint


def _py_kmers(codes, offsets, k, canonical):
    out = []
    for r in range(len(offsets) - 1):
        rec = [int(c) for c in codes[offsets[r]:offsets[r + 1]]]
        for i in range(len(rec) - k + 1):
            v = 0
            for c in rec[i:i + k]:
                v = (v << 2) | c
            if canonical:
                rc = 0
                for c in reversed(rec[i:i + k]):
                    rc = (rc << 2) | (c ^ 2)
                v = v if bin(v).count("1") % 2 == 0 else rc
            out.append(v)
    return out


def _as_ints(cols, k):
    if len(cols) == 1:
        return cols[0].tolist()
    return [(h << 62) | lo for h, lo in zip(cols[0].tolist(), cols[1].tolist())]


def _stream(rng, lens):
    codes = rng.integers(0, 4, size=sum(lens), dtype=np.uint8)
    return codes, np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


@pytest.mark.parametrize("k", [5, 25, 31, 33, 59])
@pytest.mark.parametrize("canonical", [False, True])
def test_kmer_cols_equal_python(k, canonical):
    rng = np.random.default_rng(k)
    codes, off = _stream(rng, [300, k - 1, k, 2 * k + 7, 1])
    got = _as_ints(ref.kmer_cols(codes, off, k, canonical), k)
    assert got == _py_kmers(codes, off, k, canonical)
    assert len(got) == ref.n_kmers(off, k)


@pytest.mark.parametrize("k", [9, 59])
def test_universe_sets_equal_python_sets(k):
    rng = np.random.default_rng(1)
    a = _stream(rng, [400, 250])
    b = _stream(rng, [500])
    b = (np.concatenate([b[0], a[0][:120]]), np.array([0, 500, 620]))
    u = ref.Universe([ref.kmer_cols(*a, k), ref.kmer_cols(*b, k)])
    sa, sb = set(_py_kmers(*a, k, False)), set(_py_kmers(*b, k, False))
    present = u.empty_set()
    present[u.ids(0)] = True
    assert u.n == len(sa | sb)
    assert set(_as_ints(tuple(c[present] for c in u.keys), k)) == sa
    hits = sum(v in sa for v in _py_kmers(*b, k, False))
    assert int(present[u.ids(1)].sum()) == hits
    keys = _as_ints(u.keys, k)
    assert keys == sorted(keys)


def test_rows_differ_counts_each_missing_extra_and_repeated_row():
    a = (torch.tensor([1, 2, 3]),)
    assert ref.rows_differ(a, a) == 0
    assert ref.rows_differ((torch.tensor([1, 2]),), a) == 1
    assert ref.rows_differ((torch.tensor([1, 2, 3, 3]),), a) == 1
    assert ref.rows_differ((torch.tensor([1, 2, 4]),), a) == 2


@pytest.mark.parametrize("k", [7, 25, 33, 59])
def test_limbs_to_cols_reads_big_endian_limbs(k):
    rng = np.random.default_rng(k)
    vals = [int(x) for x in rng.integers(0, 2**62, size=20)]
    vals = [(v << 62 | v >> 3) % (1 << 2 * k) for v in vals] + [0,
                                                                (1 << 2 * k) - 1]
    L = -(-2 * k // 32)
    limbs = np.array([[(v >> 32 * (L - 1 - j)) & 0xFFFFFFFF for j in range(L)]
                      for v in vals], dtype=np.uint32)
    assert _as_ints(ref.limbs_to_cols(limbs, k), k) == vals


def test_fingerprints_fold_every_bit_below_their_width():
    x = (torch.tensor([0, 1, 1 << 40, (1 << 62) - 1]),)
    f = fingerprint(x, 32)
    assert int(f.max()) < 2**32 and f[1] != f[2] and f[0] == 0
