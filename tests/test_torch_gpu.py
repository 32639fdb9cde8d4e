"""Kernels B1-B7 against their plain versions on a CUDA card.

Marked `gpu`: every test needs a CUDA device and `nvcc`, and skips where
`torch.cuda.is_available()` is False (decided inside the `cuda` fixture).
The file imports no JAX, so on a card without JAX run it without the
JAX test harness:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

The cases are the kernels' edges (sizes around their tiles, one-element
and empty sides, duplicates, sentinels, negative keys, a word run over
many tiles), the static slice on CUDA against the slice on the CPU, and
dynamic rounds, the separate insert / query / remove calls (in every
sort mode) and set algebra (in three pairs of merge and sort modes) on
CUDA against a Python-set oracle.  Inputs come from
numpy.random.default_rng; every comparison is exact integer equality.
"""

import numpy as np
import pytest
import torch

from cbl_tpu_torch import CBL, LAUNCHES
from cbl_tpu_torch import wordset as tws
from cbl_tpu_torch.limbs import SENTINEL
from cbl_tpu_torch.ops import bitonic, merge, necklace, scan, sort

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


@pytest.mark.parametrize("na,nb", [
    (0, 1), (1, 1), (2048, 2048), (5000, 3), (3, 5000), (100_000, 77_777),
])
@pytest.mark.parametrize("hi", [3, 1 << 40])
def test_two_column_merge_kernel_matches_plain(cuda, na, nb, hi):
    rng = np.random.default_rng(na * 5 + nb + hi % 999)

    def side(n):
        v = rng.integers(-hi, hi, size=n)
        v[rng.random(n) < 0.05] = SENTINEL
        cols = (torch.from_numpy(v).to(cuda),
                torch.from_numpy(rng.integers(0, 1 << 23, size=n)).to(cuda))
        return merge.sort_cols_plain(cols)

    a, b = side(na), side(nb)
    n0 = LAUNCHES["merge"]
    got = merge.merge_sorted(a, b)
    torch.cuda.synchronize()
    assert LAUNCHES["merge"] == n0 + 1
    for g, w in zip(got, merge.merge_sorted_plain(a, b), strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [
    0, 1, 2, 2047, 2048, 2049, 4096, 4097, 3 * 2048 + 5, 100_003,
    (1 << 20) - 4097,
])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("hi", [1, 3, 1 << 40])
def test_sort_kernel_matches_plain(cuda, n, two, hi):
    """B5 at sizes around its tile and run boundaries: constant keys,
    heavy duplicates, wide keys with negative values, half sentinels."""
    rng = np.random.default_rng(n + two + hi % 997)
    v = rng.integers(-hi, hi, size=n)
    v[rng.random(n) < 0.5 * (hi == 3)] = SENTINEL
    keys = torch.from_numpy(v).to(cuda)
    if two:
        keys = (keys, torch.from_numpy(
            rng.integers(0, 1 << 23, size=n)).to(cuda))
    before = [c.clone() for c in merge.as_cols(keys)]
    n0 = LAUNCHES["sort"]
    with sort.use_sort_mode("mergepath"):
        got = sort.sort_keys(keys)
    torch.cuda.synchronize()
    assert LAUNCHES["sort"] == n0 + (n > 1)  # empty and one row: no launch
    want = merge.sort_cols_plain(merge.as_cols(keys))
    for g, w, p in zip(merge.as_cols(got), want,
                       merge.as_cols(merge.sort_mergepath_plain(keys)),
                       strict=True):
        assert torch.equal(g, w) and torch.equal(p, w)
    for c, b in zip(merge.as_cols(keys), before):
        assert torch.equal(c, b)  # the caller's tensors are not written


@pytest.mark.parametrize("n", [
    0, 1, 2, 3, 4095, 4096, 4097, 8192, 3 * 4096 + 5, 100_003,
    (1 << 20) - 4097, (1 << 20) + 1,
])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("hi", [1, 3, 1 << 40])
def test_bitonic_sort_kernel_matches_plain(cuda, n, two, hi):
    """B6 at sizes around its tile and the powers of two it pads to:
    constant keys, heavy duplicates, wide keys with negative values, half
    sentinels."""
    rng = np.random.default_rng(n + two + hi % 997)
    v = rng.integers(-hi, hi, size=n)
    v[rng.random(n) < 0.5 * (hi == 3)] = SENTINEL
    keys = torch.from_numpy(v).to(cuda)
    if two:
        keys = (keys, torch.from_numpy(
            rng.integers(0, 1 << 23, size=n)).to(cuda))
    before = [c.clone() for c in merge.as_cols(keys)]
    n0 = LAUNCHES["bitonic_sort"]
    with sort.use_sort_mode("bitonic"):
        got = sort.sort_keys(keys)
    torch.cuda.synchronize()
    assert LAUNCHES["bitonic_sort"] == n0 + (n > 1)  # else no launch
    want = merge.sort_cols_plain(merge.as_cols(keys))
    for g, w, p in zip(merge.as_cols(got), want,
                       merge.as_cols(bitonic.bitonic_sort_plain(keys)),
                       strict=True):
        assert torch.equal(g, w) and torch.equal(p, w)
    for c, b in zip(merge.as_cols(keys), before):
        assert torch.equal(c, b)  # the caller's tensors are not written


@pytest.mark.parametrize("na,nb", [
    (0, 0), (0, 1), (1, 0), (1, 1), (2047, 1), (2048, 2048), (2048, 2049),
    (4096, 4096), (5000, 3), (3, 5000), (100_000, 77_777),
    ((1 << 20) + 1, 4097),
])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("hi", [3, 1 << 40])
def test_bitonic_merge_kernel_matches_plain(cuda, na, nb, two, hi):
    """B7 around the one-block size (2 M <= 4096 rows) and above it, with
    unequal, empty and one-row sides."""
    rng = np.random.default_rng(na * 7 + nb + two + hi % 1000)

    def side(n):
        v = rng.integers(-hi, hi, size=n)
        v[rng.random(n) < 0.05] = SENTINEL
        cols = (torch.from_numpy(v).to(cuda),
                torch.from_numpy(rng.integers(0, 1 << 23, size=n)).to(cuda))
        cols = merge.sort_cols_plain(cols if two else cols[:1])
        return cols if two else cols[0]

    a, b = side(na), side(nb)
    before = [c.clone() for c in merge.as_cols(a) + merge.as_cols(b)]
    n0 = LAUNCHES["bitonic_merge"]
    with sort.use_merge_mode("bitonic"):
        got = sort.merge_sorted_pair(a, b)
    torch.cuda.synchronize()
    assert LAUNCHES["bitonic_merge"] == n0 + (na + nb > 0)
    for g, w, p in zip(merge.as_cols(got),
                       merge.as_cols(merge.merge_sorted_plain(a, b)),
                       merge.as_cols(bitonic.bitonic_merge_plain(a, b)),
                       strict=True):
        assert torch.equal(g, w) and torch.equal(p, w)
    for c, x in zip(merge.as_cols(a) + merge.as_cols(b), before):
        assert torch.equal(c, x)


def test_sort_merge_mode_launches_no_merge_kernel(cuda):
    a = torch.arange(0, 10_000, 2, device=cuda)
    b = torch.arange(1, 10_000, 2, device=cuda)
    n0 = dict(LAUNCHES)
    with sort.use_merge_mode("sort"):
        got = sort.merge_sorted_pair(a, b)
    assert torch.equal(got, torch.arange(10_000, device=cuda))
    assert dict(LAUNCHES) == n0


def test_library_mode_never_launches_the_sort_kernel(cuda):
    x = torch.arange(10_000, 0, -1, device=cuda)
    n0 = LAUNCHES["sort"]
    with sort.use_sort_mode("library"):
        assert torch.equal(sort.sort_keys(x), torch.sort(x).values)
    assert LAUNCHES["sort"] == n0


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


def _np_kmers(codes, k=25):
    out = []
    for s in range(len(codes) - k + 1):
        v = 0
        for c in codes[s:s + k]:
            v = (v << 2) | int(c)
        out.append(v)
    return out


@pytest.mark.parametrize("mode", sort.SORT_MODES)
def test_separate_calls_on_cuda_match_set_oracle(cuda, monkeypatch, mode):
    """Insert / query / remove of streams and point operations against
    the pending log (a 8192-row log: inserts of 4096 rows fit it, a
    16384-row remove does not), held against a Python set of k-mers."""
    rng = np.random.default_rng(9)
    sb = 3_000
    codes = rng.integers(0, 4, size=6 * sb, dtype=np.uint8)
    for name in LAUNCHES:
        monkeypatch.setitem(LAUNCHES, name, 0)
    one = lambda c: (c, np.array([0, len(c)], dtype=np.int64))
    with sort.use_sort_mode(mode):
        idx = CBL(k=25, device=cuda, pending_cap=8192)
        oracle = set()
        for r in range(4):
            seg = codes[r * sb:(r + 1) * sb]
            qry = codes[max(r - 1, 0) * sb:(r + 1) * sb]
            rm = codes[r * sb:r * sb + sb // 2]
            idx.insert_codes_stream(*one(seg))
            oracle |= set(_np_kmers(seg))
            assert (idx.wordset.n_pending > 0) == (r > 0)
            qk = _np_kmers(qry)
            want = (len(qk), sum(v in oracle for v in qk))
            assert idx.query_codes_stream(*one(qry)) == want
            idx.remove_codes_stream(*one(rm))
            oracle -= set(_np_kmers(rm))
            assert idx.wordset.n_pending > 0
        assert idx.count() == len(oracle)
        big = codes[sb:]  # 16384 rows: removed at once; segment 0 stays
        idx.remove_codes_stream(*one(big))
        oracle -= set(_np_kmers(big))
        assert idx.wordset.n_pending == 0
        assert idx.count() == len(oracle) > 1_000
        # point operations on the log, no fold in between
        kmers = _np_kmers(codes[4 * sb:4 * sb + 600])
        idx.insert_kmers(kmers[:300])
        oracle |= set(kmers[:300])
        idx.remove_kmers(kmers[100:200])
        oracle -= set(kmers[100:200])
        probe = kmers + _np_kmers(codes[sb - 400:sb])
        assert idx.contains_kmers(probe).tolist() == [
            v in oracle for v in probe]
        assert idx.wordset.n_pending == 400
        assert idx.insert(kmers[150]) and not idx.insert(kmers[150])
        assert idx.remove(kmers[0]) and kmers[0] not in idx
        oracle = (oracle | {kmers[150]}) - {kmers[0]}
        assert idx.wordset.n_pending == 403
        assert idx.count() == len(oracle)
    assert (LAUNCHES["sort"] > 0) == (mode == "mergepath"), dict(LAUNCHES)
    assert all(LAUNCHES[n] > 0 for n in ("necklace", "blank", "merge"))
    assert LAUNCHES["slog_scan"] == 0


@pytest.mark.parametrize("merge_mode,sort_mode", [
    ("bitonic", "bitonic"), ("sort", "bitonic"), ("mergepath", "library"),
])
def test_set_algebra_on_cuda_matches_set_oracle(cuda, monkeypatch,
                                                merge_mode, sort_mode):
    """The eight operators, `merge`, `intersect` and the calls that follow
    on a result with holes, against Python sets of k-mers."""
    rng = np.random.default_rng(10)
    pool = rng.integers(0, 4, size=9_000, dtype=np.uint8)
    one = lambda c: (c, np.array([0, len(c)], dtype=np.int64))
    windows = {"a": pool[:5_000], "b": pool[3_000:8_000],
               "c": pool[2_000:6_000]}
    for name in LAUNCHES:
        monkeypatch.setitem(LAUNCHES, name, 0)
    with sort.use_merge_mode(merge_mode), sort.use_sort_mode(sort_mode):
        idx, sets = {}, {}
        for name, codes in windows.items():
            idx[name] = CBL(k=25, device=cuda, pending_cap=8192)
            idx[name].insert_codes_stream(*one(codes))
            sets[name] = set(_np_kmers(codes))
        a, b, c = (idx[n] for n in "abc")
        sa, sb, sc = (sets[n] for n in "abc")

        def same(x, want):
            assert x.count() == len(want)
            km = _np_kmers(pool)
            assert x.query_codes_stream(*one(pool)) == (
                len(km), sum(v in want for v in km))

        same(a | b, sa | sb)
        same(a & b, sa & sb)
        same(a - b, sa - sb)
        same(a ^ b, sa ^ sb)
        t, st = a | c, sa | sc
        t &= b
        t ^= a
        t -= c
        t |= b
        same(t, ((((st & sb) ^ sa) - sc) | sb))
        same(CBL.merge([a, b, c]), sa | sb | sc)
        same(CBL.intersect([a, b, c]), sa & sb & sc)
        assert (a.count(), b.count()) == (len(sa), len(sb))
        # a result (with holes under a merge kernel): log join, insert
        # over holes, fold with removes, membership
        h, sh = a ^ b, sa ^ sb
        assert h.wordset._holes == (merge_mode != "sort")
        h.insert_codes_stream(*one(pool[8_000:]))
        h.remove_codes_stream(*one(pool[:1_000]))
        sh = (sh | set(_np_kmers(pool[8_000:]))) - set(_np_kmers(pool[:1_000]))
        assert h.wordset.n_pending > 0
        same(h, sh)  # the query joins index and log; count() folds
        g, sg = a - c, sa - sc
        probe = _np_kmers(pool[:6_000])[::7]
        assert g.contains_kmers(probe).tolist() == [v in sg for v in probe]
        assert not g.wordset._holes
        g.insert_codes_stream(*one(pool[6_000:]))
        same(g, sg | set(_np_kmers(pool[6_000:])))
    launched = dict(LAUNCHES)
    assert (launched["bitonic_merge"] > 0) == (merge_mode == "bitonic")
    assert (launched["bitonic_sort"] > 0) == (sort_mode == "bitonic")
    assert (launched["merge"] > 0) == (merge_mode == "mergepath")
    assert launched["sort"] == launched["slog_scan"] == 0
