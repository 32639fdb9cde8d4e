"""Kernels B1-B4 against their plain versions on a CUDA card.

Marked `gpu`: every test needs a CUDA device and `nvcc`, and skips where
`torch.cuda.is_available()` is False (decided inside the `cuda` fixture).
The file imports no JAX, so on a card without JAX run it without the
JAX test harness:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

The cases are the kernels' edges (sizes around their tiles, one-element
and empty sides, duplicates, sentinels, negative keys, a word run over
many tiles), the static slice on CUDA against the slice on the CPU, and
dynamic rounds on CUDA against a Python-set oracle.  Inputs come from
numpy.random.default_rng; every comparison is exact integer equality.
"""

import numpy as np
import pytest
import torch

from cbl_tpu_torch import CBL, LAUNCHES
from cbl_tpu_torch import wordset as tws
from cbl_tpu_torch.limbs import SENTINEL
from cbl_tpu_torch.ops import merge, necklace, scan

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("W", [2, 14, 26, 50, 54, 60])
@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
def test_necklace_kernel_matches_plain(cuda, W, n):
    rng = np.random.default_rng(W * 1000 + n)
    x = rng.integers(0, 1 << W, size=n)
    x[: min(n, 3)] = [0, (1 << W) - 1, 1][: min(n, 3)]
    x = torch.from_numpy(x).to(cuda)
    neck, pos = necklace.necklace_pos(x, W)
    want_neck, want_pos = necklace.necklace_pos_plain(x, W)
    torch.cuda.synchronize()
    assert torch.equal(neck, want_neck) and torch.equal(pos, want_pos)


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, (1 << 20) + 3])
def test_blank_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    starts = rng.integers(0, n, size=50)
    ends = np.minimum(starts + rng.integers(0, max(n // 20, 2), size=50), n)
    delta = np.zeros(n + 1, dtype=np.int32)
    np.add.at(delta, starts, 1)
    np.add.at(delta, ends, -1)
    for d in (delta[:n], np.zeros(n, dtype=np.int32)):
        t = torch.from_numpy(np.ascontiguousarray(d)).to(cuda)
        mask, n_valid = scan.blank_mask(t)
        want_mask, want_valid = scan.blank_mask_plain(t)
        torch.cuda.synchronize()
        assert torch.equal(mask, want_mask)
        assert int(n_valid) == int(want_valid)


@pytest.mark.parametrize("na,nb", [
    (0, 1), (1, 0), (1, 1), (2047, 1), (2048, 2048), (5000, 3), (3, 5000),
    (100_000, 77_777),
])
@pytest.mark.parametrize("hi", [3, 1 << 40])
def test_merge_kernel_matches_plain(cuda, na, nb, hi):
    rng = np.random.default_rng(na * 7 + nb + hi % 1000)

    def side(n):
        v = rng.integers(-hi, hi, size=n)
        v[rng.random(n) < 0.05] = SENTINEL
        return torch.sort(torch.from_numpy(v).to(cuda)).values

    a, b = side(na), side(nb)
    got = merge.merge_sorted(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, merge.merge_sorted_plain(a, b))


def test_merge_rejects_mixed_devices(cuda):
    a = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        merge.merge_sorted(a, torch.zeros(4, dtype=torch.int64))


@pytest.mark.parametrize("slab", [None, 4096])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [13, 25])
def test_slice_on_cuda_matches_cpu(cuda, monkeypatch, k, canonical, slab):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=12_000, dtype=np.uint8)
    off = np.array([0, 1_000, 1_010, 5_000, 11_990, 12_000], dtype=np.int64)
    q = np.concatenate([codes[2_000:4_500],
                        rng.integers(0, 4, size=3_000, dtype=np.uint8)])
    qoff = np.array([0, 2_500, 2_520, 5_500], dtype=np.int64)
    results = []
    for device in ("cpu", cuda):
        for name in LAUNCHES:
            monkeypatch.setitem(LAUNCHES, name, 0)
        idx = CBL(k=k, canonical=canonical, device=device)
        ps = idx.pack_stream(codes, off, slab=slab)
        idx.insert_codes_stream(ps)
        results.append((idx.count(), idx.query_codes_stream(ps),
                        idx.query_codes_stream(q, qoff)))
        launched = dict(LAUNCHES)
    assert results[0] == results[1]
    # the static path runs B1-B3; B4 belongs to the dynamic path
    assert all(launched[n] >= 1 for n in ("necklace", "blank", "merge")), \
        launched
    assert launched["slog_scan"] == 0, launched


def _slog_keys(rng, n, n_words, sent_frac=0.1):
    """Sorted slog keys over few words: insert/query/remove tags of seqs
    0-7, some 0xFF join queries and a sentinel tail."""
    words = rng.integers(0, n_words, size=n) * 977 + (1 << 40)
    typ = rng.choice([1, 1, 2, 3], size=n)
    tags = (rng.integers(0, 8, size=n) << 2) | typ
    tags[rng.random(n) < 0.05] = 0xFF
    keys = tws.slog_key(torch.from_numpy(words), torch.from_numpy(tags))
    keys[n - int(n * sent_frac):] = SENTINEL
    return torch.sort(keys).values


def _flip_run(n):
    """One word over n rows: inserted at row 0, removed at 2n/3,
    queried everywhere."""
    tags = np.full(n, (1 << 2) | 2)
    tags[0] = 1
    tags[2 * n // 3] = (1 << 2) | 3
    return tws.slog_key(torch.full((n,), 42, dtype=torch.int64),
                        torch.from_numpy(np.sort(tags)))


@pytest.mark.parametrize("case", [
    "empty", "one", "tile-1", "tile+1", "random", "flip", "all-sentinel",
])
def test_slog_scan_kernel_matches_plain(cuda, case):
    rng = np.random.default_rng(len(case))
    keys = {
        "empty": lambda: torch.empty(0, dtype=torch.int64),
        "one": lambda: _slog_keys(rng, 1, 1, sent_frac=0),
        "tile-1": lambda: _slog_keys(rng, 4095, 300),
        "tile+1": lambda: _slog_keys(rng, 4097, 30),
        "random": lambda: _slog_keys(rng, 1_000_003, 60_000),
        "flip": lambda: _flip_run(50_001),
        "all-sentinel": lambda: torch.full((9_000,), SENTINEL),
    }[case]().to(cuda)
    n0 = LAUNCHES["slog_scan"]
    for qtag in ((3 << 2) | 2, (1 << 2) | 2, 0xFF):
        got = scan.slog_scan_counts(keys, qtag)
        want = scan.slog_scan_counts_plain(keys, qtag)
        torch.cuda.synchronize()
        assert [int(x) for x in got] == [int(x) for x in want]
    assert LAUNCHES["slog_scan"] == n0 + 3


def _np_words(codes, k=25):
    """The packed necklace words of every k-mer of one record (uint64
    numpy, independent of the port): min rotation << pos_bits | pos."""
    W, pos_bits = 2 * k, 6
    mask = (1 << W) - 1
    out = []
    for s in range(len(codes) - k + 1):
        v = 0
        for c in codes[s:s + k]:
            v = (v << 2) | int(c)
        best, pos = v, 0
        for p in range(1, W):
            v = ((v << 1) | (v >> (W - 1))) & mask
            if v < best:
                best, pos = v, p
        out.append((best << pos_bits) | pos)
    return out


def test_dynamic_rounds_on_cuda_match_set_oracle(cuda, monkeypatch):
    rng = np.random.default_rng(8)
    sb = 1_500
    codes = rng.integers(0, 4, size=4 * sb, dtype=np.uint8)
    for name in LAUNCHES:
        monkeypatch.setitem(LAUNCHES, name, 0)
    idx = CBL(k=25, device=cuda)
    one = lambda c: (c, np.array([0, len(c)], dtype=np.int64))
    oracle = set()
    for r in range(4):
        seg = codes[r * sb:(r + 1) * sb]
        qry = codes[max(r - 1, 0) * sb:max(r, 1) * sb]
        rm = codes[r * sb:r * sb + sb // 2]
        oracle |= set(_np_words(seg))
        qw = _np_words(qry)
        want = (len(qw), sum(w in oracle for w in qw))
        assert idx.dynamic_round(one(seg), one(qry), one(rm)) == want
        oracle -= set(_np_words(rm))
        assert idx.count() == len(oracle)
    qw = _np_words(codes[:2 * sb])
    want = (len(qw), sum(w in oracle for w in qw))
    assert idx.query_codes_stream(*one(codes[:2 * sb])) == want
    assert LAUNCHES["slog_scan"] >= 5 and LAUNCHES["merge"] >= 2 * 4 + 3
    idx.flush()
    assert idx.count() == len(oracle)
    assert idx.query_codes_stream(*one(codes[:2 * sb])) == want
