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
CUDA against a Python-set oracle, and the default sort mode (B5 on the
card) against the "library" mode at the benchmark cells' shapes.
Inputs come from numpy.random.default_rng (the cells' sort shapes from a
seeded torch generator on the card); every comparison is exact integer
equality.
"""

import contextlib

import numpy as np
import pytest
import torch

from cbl_tpu_torch import CBL, LAUNCHES
from cbl_tpu_torch import entry as tentry
from cbl_tpu_torch import kmer as tkmer
from cbl_tpu_torch.ops._build import PASSES
from cbl_tpu_torch import wordset as tws
from cbl_tpu_torch.limbs import SENTINEL
from cbl_tpu_torch.ops import bitonic, merge, necklace, scan, sort
from cbl_tpu_torch.profiling import COUNTERS

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
    (1 << 20) - 4097, 8192, 8193, 5 * 8192 + 123,
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
    (1 << 20) - 4097, (1 << 20) + 1, 8193, 3 * 8192 + 5,
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


def _edge_keys(cuda, n, two, hi, seed):
    rng = np.random.default_rng(seed)
    v = rng.integers(-hi, hi, size=n)
    v[rng.random(n) < 0.5 * (hi == 3)] = SENTINEL
    keys = torch.from_numpy(v).to(cuda)
    if two:
        keys = (keys, torch.from_numpy(
            rng.integers(0, 1 << 23, size=n)).to(cuda))
    return keys


@pytest.mark.parametrize("tiles,extra", [
    (1, 0), (1, 1), (2, 0), (2, 1), (3, 5), (4, 0), (4, 1), (8, 1),
    (15, 123), (16, 0), (16, 1), (17, 4095), (32, 1), (33, 7), (256, 3),
    (257, 1),
])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("hi", [1, 3, 1 << 40])
def test_sort_kernel_multiway(cuda, tiles, extra, two, hi):
    """B5 where a pass of 2, 4, 8 or 16 runs has a short or missing last
    run, at one and at several multiway passes: constant keys, three
    values with half sentinels, wide keys.  The kernel's count of passes
    over device memory equals the Python schedule's."""
    c = 2 if two else 1
    tile = merge.SORT_TILES[c]
    n = tiles * tile + extra
    keys = _edge_keys(cuda, n, two, hi, tiles * 100 + extra + two)
    before = [c.clone() for c in merge.as_cols(keys)]
    got = merge.sort_mergepath(keys)
    torch.cuda.synchronize()
    assert PASSES["sort"] == len(
        merge.mergepath_passes(n, tile, merge.SORT_WAYS[c]))
    want = merge.sort_cols_plain(merge.as_cols(keys))
    for g, w, p in zip(merge.as_cols(got), want,
                       merge.as_cols(merge.sort_mergepath_plain(keys)),
                       strict=True):
        assert torch.equal(g, w) and torch.equal(p, w)
    for c, b in zip(merge.as_cols(keys), before):
        assert torch.equal(c, b)


@pytest.mark.parametrize("n", [
    8191, 8192, 8193, 2 * 8192 + 1, (1 << 17) + 1, (1 << 18) - 1,
    (1 << 21) + 1, (1 << 22) - 1,
])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("hi", [3, 1 << 40])
def test_bitonic_sort_kernel_fused_passes(cuda, n, two, hi):
    """B6 just above one tile and at P / 2 + 1 and P - 1 rows, where the
    fused cross passes are one and several a stage and the chunks one and
    several; against both plain versions, with the kernel's pass count held
    to the schedule's."""
    keys = _edge_keys(cuda, n, two, hi, n + two)
    before = [c.clone() for c in merge.as_cols(keys)]
    got = bitonic.bitonic_sort(keys)
    torch.cuda.synchronize()
    tile = bitonic.TILES[2 if two else 1]
    rows = max(tile, 1 << (n - 1).bit_length())
    assert PASSES["bitonic_sort"] == len(bitonic.network_passes(
        rows, tile, bitonic.fuse_log(tile), bitonic.CHUNKS[2 if two else 1]))
    want = merge.sort_cols_plain(merge.as_cols(keys))
    plains = [bitonic.bitonic_sort_passes_plain(keys)]
    if n < (1 << 20):
        plains.append(bitonic.bitonic_sort_plain(keys))
    for p in plains:
        for g, w, q in zip(merge.as_cols(got), want, merge.as_cols(p),
                           strict=True):
            assert torch.equal(g, w) and torch.equal(q, w)
    for c, b in zip(merge.as_cols(keys), before):
        assert torch.equal(c, b)


@pytest.mark.parametrize("na,nb", [(4096, 4096), (4097, 4096),
                                   (1 << 16, 3), ((1 << 20) + 1, 1 << 19)])
@pytest.mark.parametrize("two", [False, True])
def test_bitonic_merge_kernel_pass_count(cuda, na, nb, two):
    """B7 in one pass over device memory at every size: the result, and
    the kernel's pass count (1) against the schedule's."""
    a = merge.sort_cols_plain(merge.as_cols(_edge_keys(cuda, na, two, 50, 1)))
    b = merge.sort_cols_plain(merge.as_cols(_edge_keys(cuda, nb, two, 50, 2)))
    if not two:
        a, b = a[0], b[0]
    PASSES["bitonic_merge"] = 0
    got = bitonic.bitonic_merge(a, b)
    torch.cuda.synchronize()
    tile = bitonic.MERGE_TILES[2 if two else 1]
    assert PASSES["bitonic_merge"] == len(
        bitonic.merge_passes(na + nb, tile)) == 1
    for g, w, p in zip(merge.as_cols(got),
                       merge.as_cols(merge.merge_sorted_plain(a, b)),
                       merge.as_cols(bitonic.bitonic_merge_tiled_plain(a, b)),
                       strict=True):
        assert torch.equal(g, w) and torch.equal(p, w)


@pytest.mark.parametrize("na,nb", [
    (0, 0), (0, 1), (1, 0), (1, 1), (2047, 1), (2048, 2048), (2048, 2049),
    (4096, 4096), (5000, 3), (3, 5000), (100_000, 77_777),
    ((1 << 20) + 1, 4097),
])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("hi", [3, 1 << 40])
def test_bitonic_merge_kernel_matches_plain(cuda, na, nb, two, hi):
    """B7 around the one-block size (2 M <= one tile) and above it, with
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
    for g, w, p, q in zip(
            merge.as_cols(got),
            merge.as_cols(merge.merge_sorted_plain(a, b)),
            merge.as_cols(bitonic.bitonic_merge_plain(a, b)),
            merge.as_cols(bitonic.bitonic_merge_tiled_plain(a, b)),
            strict=True):
        assert torch.equal(g, w) and torch.equal(p, w) and torch.equal(q, w)
    for c, x in zip(merge.as_cols(a) + merge.as_cols(b), before):
        assert torch.equal(c, x)


def _sorted_side(cuda, n, two, hi, seed, offset=0):
    """Sorted keys of n rows (`_edge_keys`), as a contiguous view that
    starts `offset` rows into its storage (an odd offset leaves the first
    row off a 16-byte boundary)."""
    cols = merge.sort_cols_plain(merge.as_cols(
        _edge_keys(cuda, n + offset, two, hi, seed)))
    cols = tuple(c[offset:] for c in cols) if offset else cols
    return cols if two else cols[0]


@pytest.mark.parametrize("k,delta", [(1, -1), (1, 0), (1, 1), (2, -1),
                                     (2, 0), (3, 1), (65, -1), (65, 0),
                                     (65, 1)])
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("hi", [1, 3, 1 << 40])
def test_bitonic_merge_kernel_tile_edges(cuda, k, delta, two, hi):
    """B7 with na + nb = k T - 1, k T and k T + 1 at the real tiles (T =
    `MERGE_TILES`: 2048 rows of one column, 1024 of two): keys of two
    values and of six with half sentinels (runs of equal rows across
    every tile edge and co-rank split; with two columns, column 0 ties
    across the splits and the minor column decides) and wide keys; the
    runs split a third to two thirds, A a view at an odd offset; against
    both plain versions and `torch.sort` of both runs, the inputs kept,
    one pass."""
    tile = bitonic.MERGE_TILES[2 if two else 1]
    n = k * tile + delta
    na = n // 3
    a = _sorted_side(cuda, na, two, hi, n + 1, offset=1)
    b = _sorted_side(cuda, n - na, two, hi, n + 2)
    before = [c.clone() for c in merge.as_cols(a) + merge.as_cols(b)]
    PASSES["bitonic_merge"] = 0
    got = bitonic.bitonic_merge(a, b)
    torch.cuda.synchronize()
    assert PASSES["bitonic_merge"] == 1
    want = merge.merge_sorted_plain(a, b)
    plains = [bitonic.bitonic_merge_tiled_plain(a, b),
              bitonic.bitonic_merge_tiled_plain(b, a)]
    if n < 1 << 17:
        plains.append(bitonic.bitonic_merge_plain(a, b))
    for p in [got] + plains:
        for x, w in zip(merge.as_cols(p), merge.as_cols(want), strict=True):
            assert torch.equal(x, w)
    for c, x in zip(merge.as_cols(a) + merge.as_cols(b), before):
        assert torch.equal(c, x)


@pytest.mark.parametrize("two", [False, True])
def test_bitonic_merge_kernel_on_a_side_stream(cuda, two):
    """B7 launched on a stream other than the default one (co-ranks and
    tiles in order on that stream)."""
    a = _sorted_side(cuda, 300_001, two, 3, 5)
    b = _sorted_side(cuda, 77_777, two, 3, 6)
    want = merge.merge_sorted_plain(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = bitonic.bitonic_merge(a, b)
    side.synchronize()
    for x, w in zip(merge.as_cols(got), merge.as_cols(want), strict=True):
        assert torch.equal(x, w)


def test_bitonic_merge_kernel_fold_shape(cuda):
    """B7 at the largest fold's shape: an index of 2^26 (word, seqtag)
    rows, three quarters of them the sentinel tail, every seqtag 1,
    against a sorted log of 2^21 rows; exact against both references,
    and the call allocates only its output and the tile edges' co-ranks
    (no work buffer)."""
    rng = np.random.default_rng(26)
    w = rng.integers(0, 1 << 56, size=1 << 26)
    w[1 << 24:] = SENTINEL
    words = torch.sort(torch.from_numpy(w).to(cuda)).values
    a = (words, torch.ones_like(words))
    b = merge.sort_cols_plain((
        torch.from_numpy(rng.integers(0, 1 << 56, size=1 << 21)).to(cuda),
        torch.from_numpy(rng.integers(2, 1 << 23, size=1 << 21)).to(cuda)))
    n = (1 << 26) + (1 << 21)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = bitonic.bitonic_merge(a, b)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - before
    tiles = -(-n // bitonic.MERGE_TILES[2])
    assert grown <= 2 * 8 * n + 8 * (tiles + 1) + (2 << 20), grown
    assert PASSES["bitonic_merge"] == 1
    want = merge.merge_sorted_plain(a, b)
    tiled = bitonic.bitonic_merge_tiled_plain(a, b)
    for x, w, t in zip(got, want, tiled, strict=True):
        assert torch.equal(x, w) and torch.equal(t, w)


def test_sort_merge_mode_launches_no_merge_kernel(cuda, monkeypatch):
    """The "sort" merge mode sorts both runs at once: one B5 launch (the
    card's default sort), no merge kernel."""
    monkeypatch.delenv(sort.SORT_ENV, raising=False)
    a = torch.arange(0, 10_000, 2, device=cuda)
    b = torch.arange(1, 10_000, 2, device=cuda)
    n0 = dict(LAUNCHES)
    with sort.use_merge_mode("sort"):
        got = sort.merge_sorted_pair(a, b)
    assert torch.equal(got, torch.arange(10_000, device=cuda))
    assert {n: c - n0[n] for n, c in LAUNCHES.items() if c != n0[n]} == {
        "sort": 1}


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
    # the static path runs B1, B2 and a join, B3 or (a batch much smaller
    # than the index) B8; B4 belongs to the dynamic path
    assert all(launched[n] >= 1 for n in ("necklace", "blank")), launched
    assert launched["merge"] + launched["probe"] >= 1, launched
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


T = scan.SLOG_TILE
B = scan.BLANK_TILE


def _tile_delta(rng, n, kind):
    """Interval deltas of n rows: random intervals, or intervals from one
    tile edge to another, so that the running sum returns to 0 exactly at
    tile edges."""
    delta = np.zeros(n + 1, dtype=np.int32)
    if kind == "intervals":
        starts = rng.integers(0, n, size=50)
        ends = np.minimum(starts + rng.integers(0, max(n // 20, 2), 50), n)
    else:
        edges = np.arange(0, n + 1, B)
        starts = rng.choice(edges, size=min(len(edges), 40))
        ends = np.minimum(starts + B * rng.integers(1, 4, size=len(starts)),
                          n)
    np.add.at(delta, starts, 1)
    np.add.at(delta, ends, -1)
    return delta[:n]


@pytest.mark.parametrize("kind", ["intervals", "zero at tile edges"])
@pytest.mark.parametrize("n", [1, 2 * B - 1, 2 * B, 2 * B + 1, 300 * B - 1,
                               300 * B, 300 * B + 1])
def test_blank_kernel_lookback(cuda, n, kind):
    """One launch at the edge lengths of the real tile, over chains of
    hundreds of tiles that publish their sums before their prefixes."""
    delta = torch.from_numpy(_tile_delta(np.random.default_rng(n), n,
                                         kind)).to(cuda)
    PASSES["blank"] = 0
    mask, n_valid = scan.blank_mask(delta)
    want_mask, want_valid = scan.blank_mask_plain(delta)
    torch.cuda.synchronize()
    assert torch.equal(mask, want_mask)
    assert int(n_valid) == int(want_valid)
    assert PASSES["blank"] == 1


def test_blank_kernel_repeat_and_side_stream(cuda):
    """A call never reads the statuses of the one before it (same sizes,
    so the allocator hands the second the first's scratch), and a call on
    another stream gives the same result."""
    n = 300 * B + 5
    blanked = torch.zeros(n, dtype=torch.int32, device=cuda)
    blanked[0] = 1
    zeros = torch.zeros_like(blanked)
    for delta, want_valid in ((blanked, 0), (zeros, n), (blanked, 0)):
        mask, n_valid = scan.blank_mask(delta)
        assert int(n_valid) == want_valid
        assert bool((mask == (want_valid == 0)).all())
    delta = torch.from_numpy(_tile_delta(np.random.default_rng(3), n,
                                         "intervals")).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mask, n_valid = scan.blank_mask(delta)
    side.synchronize()
    want_mask, want_valid = scan.blank_mask_plain(delta)
    assert torch.equal(mask, want_mask)
    assert int(n_valid) == int(want_valid)


def _run_keys(rng, n, run, first_typ=1, sent_from=None):
    """Sorted slog keys of n rows whose rows 0..run-1 are one word's run:
    an entry of typ `first_typ`, then queries only (typ 2 and 0xFF), so
    the run's tiles after its first hold no marker; the other rows are
    runs of ~16 rows; sentinels from row `sent_from` on."""
    words = rng.integers(0, max(n // 16, 1), size=n) * 977 + (1 << 40)
    tags = (rng.integers(0, 8, size=n) << 2) | rng.choice([1, 1, 2, 3], n)
    tags[rng.random(n) < 0.05] = 0xFF
    words[:run] = 12345
    tags[:run] = np.where(tags[:run] == 0xFF, 0xFF, (tags[:run] & ~3) | 2)
    tags[0] = first_typ
    keys = tws.slog_key(torch.from_numpy(words), torch.from_numpy(tags))
    if sent_from is not None:
        keys[sent_from:] = SENTINEL
    return torch.sort(keys).values


def _tile_runs(rng, n):
    """Each tile one word's run (every run ends exactly at a tile edge)."""
    words = (np.arange(n) // T) * 977 + (1 << 40)
    tags = np.sort((rng.integers(0, 8, size=n) << 2)
                   | rng.choice([1, 2, 2, 3], n))
    return tws.slog_key(torch.from_numpy(words), torch.from_numpy(tags))


@pytest.mark.parametrize("case", [
    "query run", "tile-edge runs", "sentinels from a tile edge",
    "k*tile-1", "k*tile", "k*tile+1", "two",
])
def test_slog_scan_kernel_lookback(cuda, case):
    """One launch at the edge lengths of the real tile; a run of queries
    over 300 tiles that hold no marker (the longest look-back)."""
    rng = np.random.default_rng(len(case))
    keys = {
        "query run": lambda: _run_keys(rng, 302 * T, 300 * T + 7),
        "tile-edge runs": lambda: _tile_runs(rng, 40 * T),
        "sentinels from a tile edge": lambda: _run_keys(
            rng, 40 * T, 10 * T, sent_from=20 * T),
        "k*tile-1": lambda: _slog_keys(rng, 37 * T - 1, 3000),
        "k*tile": lambda: _slog_keys(rng, 37 * T, 30),
        "k*tile+1": lambda: _slog_keys(rng, 37 * T + 1, 3000, sent_frac=0),
        "two": lambda: _slog_keys(rng, 2, 1, sent_frac=0),
    }[case]().to(cuda)
    for qtag in ((3 << 2) | 2, (1 << 2) | 2, 0xFF):
        PASSES["slog_scan"] = 0
        got = scan.slog_scan_counts(keys, qtag)
        want = scan.slog_scan_counts_plain(keys, qtag)
        torch.cuda.synchronize()
        assert [int(x) for x in got] == [int(x) for x in want]
        assert PASSES["slog_scan"] == 1


def test_slog_scan_kernel_repeat_and_side_stream(cuda):
    """A call never reads the statuses of the one before it: one query
    run live throughout, then the same run dead (its first entry a
    remove), same sizes; then a call on another stream."""
    rng = np.random.default_rng(11)
    n, run = 302 * T, 300 * T + 7
    live = _run_keys(rng, n, run).to(cuda)
    dead = _run_keys(np.random.default_rng(11), n, run, first_typ=3).to(cuda)
    for keys in (live, dead, live, dead):
        got = scan.slog_scan_counts(keys, 0xFF)
        want = scan.slog_scan_counts_plain(keys, 0xFF)
        assert [int(x) for x in got] == [int(x) for x in want]
    assert int(scan.slog_scan_counts(live, 0xFF)[0]) > int(
        scan.slog_scan_counts(dead, 0xFF)[0])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = scan.slog_scan_counts(live, (2 << 2) | 2)
    side.synchronize()
    want = scan.slog_scan_counts_plain(live, (2 << 2) | 2)
    assert [int(x) for x in got] == [int(x) for x in want]


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


@pytest.mark.parametrize("merge_mode", sort.MERGE_MODES)
@pytest.mark.parametrize("n_q", [(1 << 17) - 1, 1 << 17, (1 << 17) + 1])
def test_contains_sortjoin_on_cuda_matches_cpu(cuda, monkeypatch, merge_mode,
                                               n_q):
    """The sort-join of ordered membership on the card equals its CPU
    result: a contiguous index with duplicate keys (merged, and by one
    sort), an index with holes, queries with duplicates and sentinels,
    and all-sentinel queries; in every merge mode."""
    rng = np.random.default_rng(n_q)
    vocab = rng.integers(0, 1 << 56, size=200_000)
    dups = np.sort(np.concatenate([vocab[:150_000], vocab[:20_000]]))
    dups = np.concatenate([dups, np.full(1 << 17, SENTINEL)])
    holes = np.unique(vocab[:150_000])
    holes = np.insert(holes, rng.integers(0, len(holes), size=30_000),
                      SENTINEL)
    q = vocab[rng.integers(0, 200_000, size=n_q)]
    q[rng.random(n_q) < 0.05] = SENTINEL
    cases = [(dups, q, False), (dups, q, True), (holes, q, True),
             (dups, np.full(n_q, SENTINEL), False)]
    for name in LAUNCHES:
        monkeypatch.setitem(LAUNCHES, name, 0)
    with sort.use_merge_mode(merge_mode):
        for data, queries, h in cases:
            d, qq = torch.from_numpy(data), torch.from_numpy(queries)
            want = tws._contains_sortjoin_kernel(d, qq, holes=h)
            got = tws._contains_sortjoin_kernel(d.to(cuda), qq.to(cuda),
                                                holes=h)
            assert torch.equal(got.cpu(), want)
            assert got.shape == (n_q,) and got.dtype == torch.bool
    assert not bool(want.any())
    np.testing.assert_array_equal(
        tws._contains_sortjoin_kernel(torch.from_numpy(dups),
                                      torch.from_numpy(q), False).numpy(),
        np.isin(q, vocab[:150_000]) & (q != SENTINEL))
    merged = {"mergepath": "merge", "bitonic": "bitonic_merge"}
    for mode, kernel in merged.items():
        assert (LAUNCHES[kernel] == 2) == (merge_mode == mode), LAUNCHES


@pytest.mark.parametrize("canonical", [False, True])
def test_sequence_calls_on_cuda_match_cpu(cuda, monkeypatch, canonical):
    """`insert_seqs` / `remove_seqs` through the chunked pipeline (B1),
    then `contains_codes_stream` below the sort-join threshold and above
    it (B1, B2, B3), on the card and on the CPU: equal states and
    masks."""
    rng = np.random.default_rng(12)
    ascii_ = np.frombuffer(b"ACTG", dtype=np.uint8)
    pool = rng.integers(0, 4, size=160_000, dtype=np.uint8)
    seqs = [ascii_[pool[lo:hi]].tobytes()
            for lo, hi in ((0, 9_000), (9_000, 9_020), (9_020, 30_000))]
    off = np.array([0, 5_000, 5_010, 150_000, 160_000], dtype=np.int64)
    results = []
    for device in ("cpu", cuda):
        for name in LAUNCHES:
            monkeypatch.setitem(LAUNCHES, name, 0)
        idx = CBL(k=25, canonical=canonical, device=device, chunk_size=4096,
                  pending_cap=8192)
        idx.insert_seqs(seqs)
        idx.remove_seqs([seqs[0][2_000:6_000]])
        ws = idx.wordset
        logged = (ws.n_pending, ws.pending[:ws.n_pending].cpu(),
                  ws.pending_tags[:ws.n_pending].cpu())
        small = idx.contains_seqs([seqs[0], seqs[2][:3_000]])
        big = idx.contains_codes_stream(pool, off)
        results.append((logged, idx.count(), small, big, dict(LAUNCHES)))
    (lc, nc, sc, bc, _), (lg, ng, sg, bg, launched) = results
    assert lc[0] == lg[0] > 0 and torch.equal(lc[1], lg[1])
    assert torch.equal(lc[2], lg[2]) and nc == ng > 0
    for c, g in zip(sc + bc, sg + bg):
        np.testing.assert_array_equal(c, g)
    # removed: k-mers starting at 2000..5976; present: 6000..8975
    assert not bg[0][2_000:5_000 - 24].any()
    assert bg[2][6_000 - 5_010:9_000 - 24 - 5_010].all()
    assert all(launched[n] >= 1 for n in ("necklace", "blank", "merge")), \
        launched


@pytest.mark.parametrize("sort_mode", sort.SORT_MODES)
@pytest.mark.parametrize("k,canonical", [(13, False), (25, True), (27, False)])
def test_export_on_cuda_matches_cpu(cuda, monkeypatch, tmp_path, k,
                                    canonical, sort_mode):
    """Export, checkpoints, stats and `.cbl` files of a fresh build (the
    dedup sort runs on the export) on the card equal the CPU's, in every
    sort mode; a card-saved checkpoint loads on the CPU and back."""
    from cbl_tpu_torch import interop, stats

    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=60_000, dtype=np.uint8)
    off = np.array([0, 30_000, 60_000], dtype=np.int64)
    got = {}
    for device in ("cpu", cuda):
        for name in LAUNCHES:
            monkeypatch.setitem(LAUNCHES, name, 0)
        with sort.use_sort_mode(sort_mode):
            idx = CBL(k=k, prefix_bits=8, canonical=canonical, device=device)
            idx.insert_codes_stream(codes, off)
            idx.insert_kmers([1, 2, 3])
            words = idx.wordset.words_array()
        kernel = {"mergepath": "sort", "bitonic": "bitonic_sort"}.get(
            sort_mode)
        if device != "cpu" and kernel:
            assert LAUNCHES[kernel] >= 2, LAUNCHES  # build + the export's
        path = tmp_path / f"{idx.device.type}.cblx.npz"
        idx.save_to_file(path)
        interop.save_reference(idx, tmp_path / f"{idx.device.type}.cbl",
                               chunk_rows=1000)
        got[idx.device.type] = dict(
            words=words, prefixes=idx.wordset.prefixes(),
            chunks=np.concatenate(list(idx.wordset.iter_words_chunks(777))),
            kmers=idx.kmers_limbs(), ints=list(idx)[:5000],
            nucs=list(idx.iter_nucs(chunk_rows=1000))[:5000],
            stats=[getattr(idx, n)() for n in (
                "prefix_load", "buckets_sizes", "buckets_size_count",
                "buckets_load_repartition", "buckets_nodes",
                "buckets_node_count")] + [
                    stats.shard_balance(idx, 4).tolist()],
            file=np.load(path)["words"],
            cbl=(tmp_path / f"{idx.device.type}.cbl").read_bytes())
    cpu, card = got["cpu"], got["cuda"]
    for name in ("words", "prefixes", "chunks", "kmers", "file"):
        assert cpu[name].dtype == card[name].dtype, name
        assert cpu[name].tobytes() == card[name].tobytes(), name
    for name in ("ints", "nucs", "stats", "cbl"):
        assert cpu[name] == card[name], name
    assert max(n for _, n in cpu["stats"][1]) > 1024  # trie buckets
    # a card-saved checkpoint and .cbl file load on the CPU and back
    on_cpu = CBL.load_from_file(tmp_path / "cuda.cblx.npz", device="cpu")
    back = CBL.load_from_file(tmp_path / "cpu.cblx.npz")
    assert back.device.type == "cuda"
    n = len(cpu["words"])
    assert int(back.count_device()) == int(on_cpu.count_device()) == n
    assert on_cpu.wordset.words_array().tobytes() == cpu["words"].tobytes()
    assert back.wordset.words_array().tobytes() == cpu["words"].tobytes()
    q = codes[:5_000]
    q_off = np.array([0, len(q)], dtype=np.int64)
    assert back.query_codes_stream(q, q_off) == on_cpu.query_codes_stream(
        q, q_off)
    ref = interop.load_reference(tmp_path / "cuda.cbl", k=k, prefix_bits=8)
    assert ref.device.type == "cuda"
    assert ref.wordset.words_array().tobytes() == cpu["words"].tobytes()


# --- wide K: B1 on two-column k-mers, B3/B5/B6/B7 at three columns -----------


@pytest.mark.parametrize("W", [66, 70, 90, 118])
@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
def test_wide_necklace_kernel_matches_plain(cuda, W, n):
    """B1 on [2, n] k-mers of W = 2K bits (K >= 33; column 1 the low 63): random
    values, poly-A (all zeros), poly-T (all ones) and (AC)*."""
    rng = np.random.default_rng(W * 1000 + n)
    hi = rng.integers(0, 1 << (W - 63), size=n)
    lo = rng.integers(0, 1 << 63, size=n)
    ac = int("01" * (W // 2), 2)
    special = [(0, 0), ((1 << (W - 63)) - 1, (1 << 63) - 1),
               (ac >> 63, ac & ((1 << 63) - 1))]
    for i, (h, l) in enumerate(special[:n]):
        hi[i], lo[i] = h, l
    x = torch.from_numpy(np.stack([hi, lo])).to(cuda)
    neck, pos = necklace.necklace_pos(x, W)
    want_neck, want_pos = necklace.necklace_pos_plain(x, W)
    torch.cuda.synchronize()
    assert torch.equal(neck, want_neck) and torch.equal(pos, want_pos)


def _rows3(cuda, n, hi, seed, n_cols=3):
    """`n_cols` int64 columns of n rows below `hi`, 5 % sentinel rows."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, hi, size=n) for _ in range(n_cols)]
    sent = rng.random(n) < 0.05
    for c in cols:
        c[sent] = SENTINEL
    return tuple(torch.from_numpy(c).to(cuda) for c in cols)


def _skewed_rows3(cuda, n, kind, seed, n_cols=3):
    """`n_cols` int64 columns of n rows: "dups" (every column below 2, 5 %
    sentinels), "wide" (below 2^40, 5 % sentinels), "equal" (every row
    the same), "sorted", "reverse" (sorted descending) or "small0"
    (column 0 below 2^20, as necklace words are)."""
    if kind == "equal":
        return tuple(torch.full((n,), 7, dtype=torch.int64, device=cuda)
                     for _ in range(n_cols))
    x = _rows3(cuda, n, 2 if kind == "dups" else 1 << 40, seed, n_cols)
    if kind == "small0":
        rng = np.random.default_rng(seed + 1)
        x = (torch.from_numpy(rng.integers(0, 1 << 20, size=n)).to(cuda),
             ) + x[1:]
    if kind in ("sorted", "reverse"):
        x = merge.sort_cols_plain(x)
        if kind == "reverse":
            x = tuple(c.flip(0).contiguous() for c in x)
    return x


@pytest.mark.parametrize("n", [
    1, 2, 2047, 2048, 2049, 4095, 4096, 4097, 4 * 4096 + 123,
    7 * 4096 + 123,
    # B5: the first pass's doubled runs, a group of 16 runs, two groups
    2 * 4096 + 1, 16 * 4096 - 1, 16 * 4096 + 1, 32 * 4096 + 1,
    # B6: a chunk - 1, + 1, a chunk plus a tile; both: 2^21 + 3
    (1 << 20) - 1, (1 << 20) + 1, (1 << 20) + 4096, (1 << 21) + 3,
])
@pytest.mark.parametrize("kind", ["dups", "wide", "equal", "sorted",
                                  "reverse", "small0"])
def test_three_column_sorts_match_plain(cuda, n, kind):
    """B5 and B6 at three columns around their tiles (4096 rows), B5's
    groups of 16 runs and B6's chunks of 2^20 rows, on random and skewed
    rows, against `torch.sort` in three stable passes, the input kept;
    each kernel's count of passes through device memory equals its Python
    schedule's."""
    x = _skewed_rows3(cuda, n, kind, n + len(kind))
    before = [c.clone() for c in x]
    want = merge.sort_cols_plain(x)
    rows = max(bitonic.TILES[3], 1 << (n - 1).bit_length())
    for fn, key, planned in (
            (merge.sort_mergepath, "sort", merge.mergepath_passes(
                n, merge.SORT_TILES[3], merge.SORT_WAYS[3])),
            (bitonic.bitonic_sort, "bitonic_sort", bitonic.network_passes(
                rows, bitonic.TILES[3], bitonic.fuse_log(bitonic.TILES[3]),
                bitonic.CHUNKS[3]))):
        got = fn(x)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
        if n > 1:
            assert PASSES[key] == len(planned)
    assert all(torch.equal(c, b) for c, b in zip(x, before))


@pytest.mark.parametrize("n_cols,n", [
    (c, n) for c, tile, chunk in ((1, 8192, 1 << 21), (2, 4096, 1 << 20))
    for n in (1, 2, tile - 1, tile, tile + 1, 2 * tile + 1, 16 * tile - 1,
              16 * tile + 1, 32 * tile + 1, chunk - 1, chunk + 1,
              chunk + tile, 2 * chunk + 3)])
@pytest.mark.parametrize("kind", ["dups", "wide", "equal", "sorted",
                                  "reverse", "small0"])
def test_one_two_column_sorts_match_plain(cuda, n_cols, n, kind):
    """B5 and B6 at one and two columns around their tiles (8192 and 4096
    rows), B5's groups of 16 runs and B6's chunks (2^21 and 2^20 rows), on
    random and skewed rows, against `torch.sort` (one stable pass a
    column) and the plain versions, the input kept; each kernel's count of
    passes through device memory equals its Python schedule's."""
    assert merge.SORT_TILES[n_cols] == bitonic.TILES[n_cols]
    x = _skewed_rows3(cuda, n, kind, n + len(kind) + n_cols, n_cols)
    keys = x[0] if n_cols == 1 else x
    before = [c.clone() for c in x]
    want = merge.sort_cols_plain(x)
    tile = bitonic.TILES[n_cols]
    rows = max(tile, 1 << (n - 1).bit_length())
    for fn, plain, key, planned in (
            (merge.sort_mergepath, merge.sort_mergepath_plain, "sort",
             merge.mergepath_passes(n, tile, merge.SORT_WAYS[n_cols])),
            (bitonic.bitonic_sort, bitonic.bitonic_sort_passes_plain,
             "bitonic_sort", bitonic.network_passes(
                 rows, tile, bitonic.fuse_log(tile),
                 bitonic.CHUNKS[n_cols]))):
        got = merge.as_cols(fn(keys))
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
        if n > 1:
            assert PASSES[key] == len(planned)
        if n <= (1 << 20) + 1:
            assert all(torch.equal(g, w) for g, w in zip(
                merge.as_cols(plain(keys)), want, strict=True))
    assert all(torch.equal(c, b) for c, b in zip(x, before))


@pytest.mark.parametrize("na,nb", [(0, 5), (5, 0), (1023, 1), (1024, 1024),
                                   (2047, 2), (2048, 2049), (4097, 1023),
                                   ((1 << 20) + 5, 1 << 18)])
@pytest.mark.parametrize("hi", [2, 1 << 40])
def test_three_column_merges_match_plain(cuda, na, nb, hi):
    """B3 (tiles of 2048 rows, dynamic shared memory at three columns)
    and B7 (tiles of 1024) against the plain merge."""
    a = merge.sort_cols_plain(_rows3(cuda, na, hi, na + 1))
    b = merge.sort_cols_plain(_rows3(cuda, nb, hi, nb + 2))
    want = merge.merge_sorted_plain(a, b)
    gots = [merge.merge_sorted(a, b)]
    if na + nb:
        gots.append(bitonic.bitonic_merge(a, b))
    torch.cuda.synchronize()
    for got in gots:
        assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))


@pytest.mark.parametrize("k,prefix_bits", [(59, 28), (31, 24)])
@pytest.mark.parametrize("canonical", [False, True])
def test_wide_k_on_cuda_matches_cpu(cuda, monkeypatch, k, prefix_bits,
                                    canonical):
    """A wide-K build, query, contains mask, pending log and export on
    the card equal the CPU's, in each sort and merge mode pair."""
    rng = np.random.default_rng(k + canonical)
    codes = rng.integers(0, 4, size=60_000, dtype=np.uint8)
    codes[1_000:1_200] = 2  # poly-T
    codes[3_000:3_200] = 0  # poly-A
    off = np.array([0, 20_000, 20_010, 60_000], dtype=np.int64)
    q = np.concatenate([codes[5_000:30_000],
                        rng.integers(0, 4, size=25_000, dtype=np.uint8)])
    qoff = np.array([0, 25_000, 25_020, 50_000], dtype=np.int64)
    got = {}
    for mode in (("library", "mergepath"), ("mergepath", "mergepath"),
                 ("bitonic", "bitonic"), ("library", "sort")):
        with sort.use_sort_mode(mode[0]), sort.use_merge_mode(mode[1]):
            for device in ("cpu", cuda):
                idx = CBL(k=k, prefix_bits=prefix_bits, canonical=canonical,
                          device=device)
                idx.insert_codes_stream(codes, off)
                r = [idx.count(), idx.query_codes_stream(q, qoff)]
                m = idx.contains_codes_stream(q, qoff)
                idx.insert_seqs([q[:9_000]])
                idx.remove_kmers([1, 2, int(idx.kmers_limbs()[0, -1])])
                r += [idx.query_codes_stream(q, qoff),
                      idx.contains_kmers([1, 2, 3]).tolist(), idx.count()]
                got[(mode, str(device))] = (
                    r, [x.tolist() for x in m], idx.wordset.words_array(),
                    idx.kmers_limbs(), idx.buckets_nodes())
    ref = got[(("library", "mergepath"), "cpu")]
    for key, val in got.items():
        assert val[:2] == ref[:2], key
        assert np.array_equal(val[2], ref[2]) and np.array_equal(
            val[3], ref[3]), key
        assert val[4] == ref[4], key


# --- B4 on a log with a tag column --------------------------------------------


def _tag_cols(rng, n, n_cols, n_words, sent_from=None, run=0,
              first_typ=1):
    """A sorted slog with a tag column: one (C = 2) or two (C = 3) word
    columns over few words, tags (seq << 2) | typ of seqs 0-79 (above
    0xFF from seq 64), 5 % join queries (SENTINEL), sentinels from row
    `sent_from` (default: the last tenth).  With `run`, rows 0..run-1 are
    one word's run: an entry of typ `first_typ`, then queries only."""
    w = rng.integers(0, max(n_words, 1), size=n)
    tags = (rng.integers(0, 80, size=n) << 2) | rng.choice([1, 1, 2, 3], n)
    tags[rng.random(n) < 0.05] = SENTINEL
    if run:
        w[:run] = n_words  # a word of no other row
        tags[:run] = np.where(tags[:run] == SENTINEL, SENTINEL,
                              (tags[:run] & ~3) | 2)
        tags[0] = first_typ
    words = [w * 977 + 5] if n_cols == 2 else [w // 7 + 1, w % 7 * 977 + 5]
    cols = [torch.from_numpy(c) for c in (*words, tags)]
    for c in cols:
        c[n - n // 10 if sent_from is None else sent_from:] = SENTINEL
    return merge.sort_cols_plain(tuple(cols))


def _tag_flip(n, n_cols):
    """One word over n rows: inserted at row 0, removed at 2n/3 (seq 6),
    queried at seq 5 before and seq 70 after."""
    tags = np.where(np.arange(n) < 2 * n // 3, (5 << 2) | 2, (70 << 2) | 2)
    tags[0], tags[2 * n // 3] = 1, (6 << 2) | 3
    words = [np.full(n, 42)] * (n_cols - 1)
    return tuple(torch.from_numpy(c) for c in (*words, tags))


@pytest.mark.parametrize("n_cols", [2, 3])
@pytest.mark.parametrize("case", [
    "empty", "one", "tile-1", "tile+1", "random", "flip", "all-sentinel",
    "query run", "tile-edge runs", "sentinels from a tile edge",
    "k*tile-1", "k*tile", "k*tile+1",
])
def test_slog_scan_tag_kernel_matches_plain(cuda, n_cols, case):
    """B4's tag-column form: one launch at the edge lengths of the real
    tile, a query run over 300 tiles that hold no marker, runs that end
    on tile edges, tags above 0xFF and the join's SENTINEL tag."""
    rng = np.random.default_rng(len(case) + n_cols)
    cols = {
        "empty": lambda: tuple(torch.empty(0, dtype=torch.int64)
                               for _ in range(n_cols)),
        "one": lambda: _tag_cols(rng, 1, n_cols, 1, sent_from=1),
        "tile-1": lambda: _tag_cols(rng, T - 1, n_cols, 300),
        "tile+1": lambda: _tag_cols(rng, T + 1, n_cols, 30),
        "random": lambda: _tag_cols(rng, 1_000_003, n_cols, 60_000),
        "flip": lambda: _tag_flip(50_001, n_cols),
        "all-sentinel": lambda: tuple(torch.full((9_000,), SENTINEL)
                                      for _ in range(n_cols)),
        "query run": lambda: _tag_cols(rng, 302 * T, n_cols, 20_000,
                                       run=300 * T + 7),
        "tile-edge runs": lambda: tuple(torch.from_numpy(c) for c in (
            *[np.arange(40 * T) // T + 1] * (n_cols - 1),
            np.sort((rng.integers(0, 80, 40 * T) << 2)
                    | rng.choice([1, 2, 2, 3], 40 * T)))),
        "sentinels from a tile edge": lambda: _tag_cols(
            rng, 40 * T, n_cols, 3_000, sent_from=20 * T, run=10 * T),
        "k*tile-1": lambda: _tag_cols(rng, 37 * T - 1, n_cols, 3000),
        "k*tile": lambda: _tag_cols(rng, 37 * T, n_cols, 30),
        "k*tile+1": lambda: _tag_cols(rng, 37 * T + 1, n_cols, 3000,
                                      sent_from=37 * T + 1),
    }[case]()
    cols = tuple(c.to(cuda) for c in cols)
    key = "slog_scan_tag" + ("_3col" if n_cols == 3 else "")
    n0 = LAUNCHES[key]
    qtags = ((5 << 2) | 2, (70 << 2) | 2, 1, SENTINEL)
    for qtag in qtags:
        PASSES[key] = 0
        got = scan.slog_scan_tag_counts(cols, qtag)
        want = scan.slog_scan_counts_plain(cols, qtag)
        torch.cuda.synchronize()
        assert [int(x) for x in got] == [int(x) for x in want], qtag
        assert PASSES[key] == 1
    assert LAUNCHES[key] == n0 + len(qtags)
    if case == "flip":
        assert int(scan.slog_scan_tag_counts(cols, (5 << 2) | 2)[0]) > 0


def test_slog_scan_tag_kernel_repeat_strided_and_side_stream(cuda):
    """Calls never read the statuses of the one before (a live and a dead
    query run of the same size, in turns), the columns of a [C, N]
    tensor's prefix (rows of a longer stride, as a cut log's), and a
    call on another stream."""
    n, run = 302 * T, 300 * T + 7
    live = torch.stack(_tag_cols(np.random.default_rng(11), n, 3, 20_000,
                                 run=run)).to(cuda)
    dead = torch.stack(_tag_cols(np.random.default_rng(11), n, 3, 20_000,
                                 run=run, first_typ=3)).to(cuda)
    for s in (live, dead, live, dead):
        got = scan.slog_scan_tag_counts(s, SENTINEL)
        want = scan.slog_scan_counts_plain(s, SENTINEL)
        assert [int(x) for x in got] == [int(x) for x in want]
    assert int(scan.slog_scan_tag_counts(live, SENTINEL)[0]) > int(
        scan.slog_scan_tag_counts(dead, SENTINEL)[0])
    cut = live[:, :n - 3 * T - 1]  # every column a strided row
    assert not cut.is_contiguous()
    got = scan.slog_scan_tag_counts(cut, (3 << 2) | 2)
    want = scan.slog_scan_counts_plain(cut, (3 << 2) | 2)
    assert [int(x) for x in got] == [int(x) for x in want]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = scan.slog_scan_tag_counts(live, (2 << 2) | 2)
    side.synchronize()
    want = scan.slog_scan_counts_plain(live, (2 << 2) | 2)
    assert [int(x) for x in got] == [int(x) for x in want]


@pytest.mark.parametrize("k,prefix_bits,canonical", [
    (13, 20, False), (27, 24, False), (31, 24, True), (59, 28, False)])
def test_wide_rounds_on_cuda_match_cpu(cuda, monkeypatch, k, prefix_bits,
                                       canonical):
    """Dynamic rounds over the log with a tag column (C = 2 at K=13 and
    27, 3 at K=31 and 59), a query of the active log and `flush()` on
    the card equal the CPU's, in the default merge mode and under
    "bitonic"; each round and the query launch B4's tag-column kernel
    once."""
    rng = np.random.default_rng(k)
    sb = 6_000
    codes = rng.integers(0, 4, size=4 * sb, dtype=np.uint8)
    one = lambda c: (c, np.array([0, len(c)], dtype=np.int64))
    key = "slog_scan_tag" + ("_3col" if k > 27 else "")
    for merge_mode in ("mergepath", "bitonic"):
        got = {}
        with sort.use_merge_mode(merge_mode):
            for device in ("cpu", cuda):
                for name in LAUNCHES:
                    monkeypatch.setitem(LAUNCHES, name, 0)
                idx = CBL(k=k, prefix_bits=prefix_bits, canonical=canonical,
                          device=device)
                r = [idx.dynamic_round(one(codes[i * sb:(i + 1) * sb]),
                                       one(codes[max(i - 1, 0) * sb:
                                                 max(i, 1) * sb]),
                                       one(codes[i * sb:i * sb + sb // 2]))
                     for i in range(4)]
                r += [idx.count(), idx.query_codes_stream(*one(codes))]
                launched = LAUNCHES[key]
                idx.flush()
                r += [idx.count(), idx.query_codes_stream(*one(codes))]
                got[str(device)] = (r, idx.wordset.words_array(), launched)
        cpu, card = got["cpu"], got[str(cuda)]
        assert card[0] == cpu[0] and np.array_equal(card[1], cpu[1])
        # one a round and one for the query; `count()` reads the last
        # round's scan
        assert cpu[2] == 0 and card[2] == 4 + 1


def _same_tree(a, b) -> bool:
    """Equal nested lists / tuples / dicts of arrays and scalars."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same_tree, a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("k,prefix_bits", [(25, 24), (59, 28)])
def test_sharded_on_cuda_matches_cpu(cuda, monkeypatch, tmp_path, D, k,
                                     prefix_bits):
    """`parallel.ShardedCBL` on D shards of the card against D shards of
    the CPU: the state after the bulk build (every shard's rows, the
    boundaries, the counts), a query and masks of a foreign multi-record
    stream, a bulk remove, three rounds over the sharded log and the
    state they leave, a set operation and a checkpoint round trip.  The
    card runs B1, B2, B3 and B4 (B1 wide and B4's three-column form at
    K=59); the CPU launches no kernel."""
    from cbl_tpu_torch import state
    from cbl_tpu_torch.parallel import ShardedCBL

    rng = np.random.default_rng(D * 100 + k)
    codes = rng.integers(0, 4, size=60_000, dtype=np.uint8)
    other = rng.integers(0, 4, size=8_000, dtype=np.uint8)
    one = lambda c: (c, np.array([0, len(c)], dtype=np.int64))
    q = np.concatenate([codes[:6_000], other])
    q_off = np.array([0, 6_000, 9_000, len(q)], dtype=np.int64)
    sb = 6_000
    got = {}
    for device in ("cpu", cuda):
        for name in LAUNCHES:
            monkeypatch.setitem(LAUNCHES, name, 0)
        mesh = [device] * D
        x = ShardedCBL(k=k, prefix_bits=prefix_bits, mesh=mesh,
                       batch_per_device=1024)
        x.insert_codes_stream(*one(codes[:36_000]))
        r = [state.sharded_to_arrays(x), x.query_codes_stream(q, q_off),
             x.contains_codes_stream(q, q_off)]
        x.remove_codes_stream(*one(codes[:5_000]))
        r.append(x.words_array())
        segs = [x.pack_stream(*one(codes[36_000 + i * sb:
                                         36_000 + (i + 1) * sb]))
                for i in range(3)]
        r.append([x.dynamic_round(segs[i], segs[max(i - 1, 0)], segs[0])
                  for i in range(3)])
        r += [state.sharded_to_arrays(x), x.count()]
        y = ShardedCBL(k=k, prefix_bits=prefix_bits, mesh=mesh,
                       batch_per_device=1024)
        y.insert_codes_stream(*one(codes[20_000:50_000]))
        r += [(x & y).words_array(), (x | y).count()]
        x.save_to_file(tmp_path / f"{device}.npz")
        back = ShardedCBL.load_from_file(tmp_path / f"{device}.npz",
                                         mesh=mesh)
        r.append(back.words_array())
        got[str(device)] = (r, dict(LAUNCHES))
    (cpu, cpu_n), (card, card_n) = got["cpu"], got[str(cuda)]
    assert _same_tree(card, cpu)
    assert 0 < cpu[1][1] < cpu[1][0]
    assert not any(cpu_n.values())
    scan_key = "slog_scan" if k == 25 else "slog_scan_tag_3col"
    for name in ("necklace_wide" if k == 59 else "necklace", "blank",
                 "merge" if k == 25 else "merge_3col", scan_key):
        assert card_n[name] > 0, (name, card_n)
    assert card_n[scan_key] == 3 * D  # once a round a shard


@pytest.mark.parametrize("S", [0, 16, 16_416, (1 << 20) + 16])
def test_pack_stream_on_cuda_matches_cpu(cuda, S):
    codes = torch.from_numpy(
        np.random.default_rng(S).integers(0, 4, size=S, dtype=np.uint8))
    got = tkmer.pack_stream(codes.to(cuda))
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), tkmer.pack_stream(codes))


def test_entry_forward_on_cuda_matches_cpu(cuda):
    """The flagship step on the card against the step on the CPU (held to
    `cbl_tpu` by tests/test_torch_entry.py): the reference's args, then an
    index of a random half of the chunk's words and a `valid` with rows
    False; no host sync, one B1 launch a call."""
    fwd, args = tentry.entry()
    assert all(a.device.type == "cuda" for a in args)
    assert not fwd(*args).any()
    codes, valid, _ = tentry.reference_arrays()
    rng = np.random.default_rng(1)
    words = tentry.words(torch.from_numpy(codes),
                         torch.from_numpy(valid)).numpy()
    keys = np.unique(words[rng.random(tentry.CHUNK) < 0.5])
    index = np.full(tentry.INDEX_ROWS, SENTINEL, dtype=np.int64)
    index[: len(keys)] = keys
    valid = rng.random(tentry.CHUNK) >= 0.05
    valid[1000:1500] = False
    on_cpu = tuple(torch.from_numpy(a) for a in (codes, valid, index))
    want = tentry.forward(*on_cpu)
    args = tuple(a.to(cuda) for a in on_cpu)
    fwd(*args)  # warm-up
    torch.cuda.synchronize()
    before = dict(LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fwd(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    moved = {n: c - before[n] for n, c in LAUNCHES.items() if c != before[n]}
    assert moved == {"necklace": 1}
    assert torch.equal(got.cpu(), want)
    assert 0 < int(want.sum()) < tentry.CHUNK
    assert not want[torch.from_numpy(~valid)].any()


# --- the default sort mode on the card: B5 ----------------------------------


def _cell_sort_keys(shape: str, device):
    """Sort inputs at the benchmark cells' shapes, drawn on the card:
    a query batch's 2^24 K=25 words with a sentinel tail; 2^25 K=59 word
    rows (two columns, heavy duplicates in column 0); a K=25 window fold's
    2^27 rows, 75 % sentinels, keys over the whole int64 range (packed log
    keys are negative); K=59 log rows (word, word, tag), 3 x 2^22 + 2^21
    rows, words repeated so that the tag column decides."""
    g = torch.Generator(device=device).manual_seed(25)

    def draw(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device=device)

    if shape == "words_2^24":
        n, valid = 1 << 24, 14_092_848
        keys = draw(0, 1 << 56, n)
        keys[valid:] = SENTINEL
        return keys
    if shape == "rows_2^25_x2":
        n = 1 << 25
        hi, lo = draw(0, 1 << 22, n), draw(0, 1 << 62, n)
        sent = draw(0, 20, n) == 0
        return hi.masked_fill(sent, SENTINEL), lo.masked_fill(sent, SENTINEL)
    if shape == "fold_2^27":
        n = 1 << 27
        keys = draw(-(1 << 62), 1 << 62, n) * 2
        return keys.masked_fill(draw(0, 4, n) != 0, SENTINEL)
    n = 3 * (1 << 22) + (1 << 21)
    pick = draw(0, 1 << 21, n)  # 2^21 distinct words, each about 7 times
    hi, lo = (draw(0, 1 << 54, 1 << 21)[pick],
              draw(0, 1 << 62, 1 << 21)[pick])
    tag = (draw(0, 62, n) << 2) | draw(1, 4, n)
    sent = draw(0, 10, n) == 0
    return tuple(c.masked_fill(sent, SENTINEL) for c in (hi, lo, tag))


@pytest.mark.parametrize("shape", ["words_2^24", "rows_2^25_x2",
                                   "fold_2^27", "log_x3"])
def test_default_sort_mode_runs_b5_on_cuda(cuda, monkeypatch, shape):
    """With no sort mode set, `sort_keys` of CUDA keys launches B5 once
    and no library sort, and equals `torch.sort` (the "library" mode) bit
    for bit at the cells' shapes."""
    monkeypatch.delenv(sort.SORT_ENV, raising=False)
    keys = _cell_sort_keys(shape, cuda)
    n_cols = len(merge.as_cols(keys))
    key = merge.launch_key("sort", n_cols)
    routes = [f"sort.{m}" for m in sort.SORT_MODES]
    n0, c0 = LAUNCHES[key], {r: COUNTERS.get(r, 0) for r in routes}
    got = sort.sort_keys(keys)
    torch.cuda.synchronize()
    assert LAUNCHES[key] == n0 + 1
    assert {r: COUNTERS.get(r, 0) - c0[r] for r in routes} == {
        "sort.library": 0, "sort.mergepath": 1, "sort.bitonic": 0}
    with sort.use_sort_mode("library"):
        want = sort.sort_keys(keys)
    assert LAUNCHES[key] == n0 + 1
    assert COUNTERS["sort.library"] == c0["sort.library"] + 1
    for g, w in zip(merge.as_cols(got), merge.as_cols(want), strict=True):
        assert torch.equal(g, w)


def _state(idx) -> list:
    """A port index's whole state as host arrays and ints."""
    ws = idx.wordset
    out = [idx.count()]
    log = None if ws.slog.keys is None else ws.slog.keys[0]
    for t in (ws.data, log, ws.pending, ws.pending_tags):
        out.append(None if t is None else t.cpu().numpy())
    return out


def test_default_sort_mode_k59_rounds_equal_library_mode(cuda, monkeypatch):
    """Dynamic rounds at K=59 (a log with a tag column, folds forced by a
    lowered hard cap), a query of the active log and `flush()`: the
    default sort mode (B5 on the card) leaves the library mode's state
    and answers, round by round, and launches no library sort."""
    monkeypatch.delenv(sort.SORT_ENV, raising=False)
    monkeypatch.setattr(tws.SortedLog, "HARD_CAP", 1 << 17)
    rng = np.random.default_rng(59)
    sb = 40_000
    codes = rng.integers(0, 4, size=6 * sb, dtype=np.uint8)

    def stream(i, n=sb):
        c = codes[i * sb:i * sb + n]
        return c, np.array([0, n // 3, n], dtype=np.int64)

    got = {}
    for mode in (None, "library"):
        n0 = LAUNCHES["sort"] + LAUNCHES["sort_3col"]
        lib0 = COUNTERS.get("sort.library", 0)
        folds0 = COUNTERS.get("folds.slog.autofold", 0)
        mode_ctx = sort.use_sort_mode(mode) if mode else None
        with mode_ctx or contextlib.nullcontext():
            idx = CBL(k=59, prefix_bits=28, device=cuda)
            r = [idx.dynamic_round(stream(i % 6), stream((i + 5) % 6),
                                   stream((i + 2) % 6, sb // 2))
                 for i in range(10)]
            r.append(idx.query_codes_stream(*stream(0)))
            states = [_state(idx)]
            idx.flush()
            states.append(_state(idx))
            r.append(idx.query_codes_stream(*stream(3)))
            words = idx.wordset.words_array()
        b5 = LAUNCHES["sort"] + LAUNCHES["sort_3col"] - n0
        lib = COUNTERS.get("sort.library", 0) - lib0
        assert COUNTERS.get("folds.slog.autofold", 0) > folds0
        got[mode] = (r, states, words, b5, lib)
    default, library = got[None], got["library"]
    assert default[0] == library[0]
    assert _same_tree(default[1], library[1])
    assert np.array_equal(default[2], library[2])
    assert default[3] > 0 and default[4] == 0, default[3:]
    assert library[3] == 0 and library[4] > 0, library[3:]


def test_default_sort_mode_two_slab_build_equals_library_mode(cuda,
                                                              monkeypatch):
    """A canonical K=25 build of two full slabs (2^25 k-mers and more):
    the default sort mode (B5) leaves the library mode's index, count and
    self-query, and launches no library sort."""
    monkeypatch.delenv(sort.SORT_ENV, raising=False)
    rng = np.random.default_rng(2)
    n = (1 << 25) + (1 << 22)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    offsets = np.linspace(0, n, 9).astype(np.int64)
    got = {}
    for mode in (None, "library"):
        n0, lib0 = LAUNCHES["sort"], COUNTERS.get("sort.library", 0)
        mode_ctx = sort.use_sort_mode(mode) if mode else None
        with mode_ctx or contextlib.nullcontext():
            idx = CBL(k=25, prefix_bits=24, canonical=True, device=cuda)
            idx.insert_codes_stream(codes, offsets)
            state = _state(idx)
            hits = idx.query_codes_stream(codes, offsets)
        got[mode] = (state, hits, LAUNCHES["sort"] - n0,
                     COUNTERS.get("sort.library", 0) - lib0)
        del idx
    default, library = got[None], got["library"]
    assert _same_tree(default[0], library[0])
    assert default[1] == library[1] and default[1][0] == default[1][1] > 0
    assert default[2] >= 2 and default[3] == 0, default[2:]
    assert library[2] == 0 and library[3] >= 2, library[2:]
