"""Parity of the port's merge-path sort (kernel B5's module) with `cbl_tpu`.

`cbl_tpu_torch.ops.merge.sort_mergepath_plain` (two-way, four-way and
16-way passes, `mergepath_passes`), the plain F-run partition
`multiway_split_plain` and a block's merge `merge_multi_tile_plain` at
one to three columns against numpy, the CPU dispatch of `sort_mergepath`
and `ops.sort.sort_keys` under both sort modes, against
`torch.sort`, a numpy lexsort and the Pallas kernel
`cbl_tpu.ops.merge_pallas.sort_cols_mergepath` in interpret mode; and the
two-column plain merge against `merge_sorted_cols` in interpret mode with
a payload column.  The same numpy-seeded inputs go to both: `cbl_tpu`
gets uint32 limb columns, the port int64 keys made from them with
`limbs.from_limbs` (column 0, all-ones rows become INT64_MAX) and a plain
widening of the minor uint32 column.  Every comparison is exact integer
equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbl_tpu.ops import merge_pallas
from cbl_tpu_torch.limbs import SENTINEL, from_limbs
from cbl_tpu_torch.ops import merge, sort

torch.set_num_threads(2)


def _limb_cols(n, seed, n_cols, hi, sent_frac):
    """`n_cols` word-limb columns (uint32) plus, for two-column keys, one
    minor uint32 column; sentinel rows are all-ones in every column."""
    r = np.random.default_rng(seed)
    cols = [r.integers(0, hi, size=n).astype(np.uint32)
            for _ in range(n_cols)]
    sent = r.random(n) < sent_frac
    for c in cols:
        c[sent] = 0xFFFFFFFF
    return cols


def _port_keys(cols, two: bool):
    """int64 key columns of uint32 limb columns: the word limbs make
    column 0; with `two`, the last limb column is the minor key."""
    word = cols[:-1] if two else cols
    major = torch.from_numpy(from_limbs(np.stack(word, axis=-1)))
    if not two:
        return major
    minor = cols[-1].astype(np.int64)
    minor[major.numpy() == SENTINEL] = SENTINEL
    return major, torch.from_numpy(minor)


def _as_numpy(keys):
    """Key columns (a tensor, or a sequence of tensors or arrays) as a
    list of numpy arrays."""
    cols = (keys,) if isinstance(keys, torch.Tensor) else keys
    return [np.asarray(c) for c in cols]


def _lexsorted(keys):
    cols = _as_numpy(keys)
    order = np.lexsort(tuple(cols[::-1]))
    return [c[order] for c in cols]


def _jax_sorted(cols, two: bool, t_log: int):
    got = merge_pallas.sort_cols_mergepath(
        tuple(jnp.asarray(c) for c in cols), t_log=t_log, interpret=True)
    return _as_numpy(_port_keys([np.asarray(c) for c in got], two))


def _assert_cols_equal(got, want):
    got = _as_numpy(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_log,t_log", [(10, 10), (13, 10), (14, 11),
                                         (13, 11)])
@pytest.mark.parametrize("two", [False, True], ids=["one-col", "two-col"])
@pytest.mark.parametrize("hi", [7, 1 << 24], ids=["dups", "wide"])
def test_plain_sort_matches_pallas(n_log, t_log, two, hi):
    """5 % sentinels; `hi` = 7 gives heavy duplicates in every column."""
    n = 1 << n_log
    cols = _limb_cols(n, n_log * 10 + two + hi % 5, 3 if two else 2, hi, 0.05)
    keys = _port_keys(cols, two)
    want = _jax_sorted(cols, two, t_log)
    _assert_cols_equal(_lexsorted(keys), want)
    _assert_cols_equal(merge.sort_mergepath_plain(keys, tile=1 << t_log),
                       want)
    _assert_cols_equal(
        merge.sort_mergepath_plain(keys, tile=1 << t_log, ways=2), want)
    _assert_cols_equal(merge.sort_cols_plain(merge.as_cols(keys)), want)
    assert (want[0] == SENTINEL).any()


@pytest.mark.parametrize("n,tile,ways,want", [
    (1 << 25, 2048, 2, 15), (1 << 25, 4096, 4, 8), (1 << 25, 8192, 4, 7),
    ((1 << 26) + (1 << 21), 8192, 4, 8), ((1 << 22) + (1 << 21), 4096, 4, 7),
    (8192, 8192, 4, 1), (8193, 8192, 4, 2), (1, 8192, 4, 1),
    (5 * 8192 + 123, 8192, 4, 3), (1 << 20, 64, 2, 15), (1 << 20, 64, 4, 8),
    # three columns: up to 16 runs a pass
    (1 << 25, 4096, 16, 5), ((1 << 26) + (1 << 21), 4096, 16, 5),
    (4096, 4096, 16, 1), (4097, 4096, 16, 2), (2 * 4096, 4096, 16, 2),
    (2 * 4096 + 1, 4096, 16, 2), (16 * 4096, 4096, 16, 2),
    (16 * 4096 + 1, 4096, 16, 3), (1 << 20, 4096, 16, 3),
    ((1 << 20) + 1, 4096, 16, 4), ((1 << 21) + 3, 4096, 16, 4),
    (1 << 20, 64, 16, 5),
    # one and two columns: 16 runs a pass (4 passes at 2^25 keys, 7 with
    # four-way passes)
    (1 << 25, 8192, 16, 4), ((1 << 26) + (1 << 21), 8192, 16, 5),
    ((1 << 22) + (1 << 21), 4096, 16, 4), (8193, 8192, 16, 2),
    (16 * 8192, 8192, 16, 2), (16 * 8192 + 1, 8192, 16, 3),
    (256 * 8192 + 1, 8192, 16, 4), ((1 << 22) + 1, 4096, 16, 4),
])
def test_pass_list_length(n, tile, ways, want):
    """1 tile sort + one pass a level (two-way), or a pass for every
    log2(ways) levels after one pass of the rest when their number is no
    multiple of log2(ways) (four-way: 7 passes at 2^25 one-column keys,
    where 2048-row tiles and two-way passes made 15; 16-way: 4 there, 5
    at three columns, where four-way passes made 8)."""
    passes = merge.mergepath_passes(n, tile, ways)
    levels = (-(-n // tile) - 1).bit_length()
    per = ways.bit_length() - 1
    assert len(passes) == want == 1 + -(-levels // per)
    assert passes[0] == ("tile_sort", tile)
    run = tile
    for i, (kind, at, fan) in enumerate(passes[1:]):
        assert kind == "merge" and at == run
        first = 1 << (levels % per) if levels % per else ways
        assert fan == (first if i == 0 else ways)
        run *= fan
    assert run >= n and (len(passes) == 1 or run // passes[-1][2] < n)
    for bad in (3, 8, 32):
        with pytest.raises(ValueError, match="ways"):
            merge.mergepath_passes(n, tile, bad)


@pytest.mark.parametrize("n", [2, 1000, 5 * 64 + 23, 6 * 64 + 23,
                               7 * 64 + 23, 4097, 12_345])
@pytest.mark.parametrize("tile", [16, 64, 1024])
@pytest.mark.parametrize("two", [False, True], ids=["one-col", "two-col"])
def test_four_way_passes_equal_two_way(n, tile, two):
    """`sort_mergepath_plain(ways=4)` equals `ways=2`, `torch.sort` and a
    lexsort: last quads of one, two and three runs with a short last run,
    duplicates and 10 % sentinels."""
    cols = _limb_cols(n, n + tile + two, 3 if two else 2, 9, 0.1)
    keys = _port_keys(cols, two)
    got = merge.sort_mergepath_plain(keys, tile=tile, ways=4)
    assert isinstance(got, tuple) == two
    _assert_cols_equal(got, _as_numpy(
        merge.sort_mergepath_plain(keys, tile=tile, ways=2)))
    _assert_cols_equal(got, _lexsorted(keys))
    if not two:
        assert torch.equal(got, torch.sort(keys).values)


def test_default_tiles_follow_the_sources():
    """`SORT_TILES`, `SORT_WAYS` and `MERGE_TILE` are the constants of the
    sources; the runs a tile sort leaves are whole merge tiles; every
    number of columns goes through the multiway passes: 2^25 keys of one
    column in 4 passes (7 with four-way passes), 2^26 + 2^21 in 5 (8),
    2^22 + 2^21 two-column rows in 4 (7), 2^25 three-column rows in 5
    (8)."""
    src = merge._build.SRC_DIR
    sort_cu = (src / "sort.cu").read_text()
    assert "kSortRows = C == 1 ? 1 << 13 : 1 << 12;" in sort_cu
    for c in (1, 2, 3):
        assert f"return cbl::sort_keys<{c}>(" in sort_cu
    assert "constexpr int kWaysLog = 4;" in sort_cu
    assert "const int step = left % W ? left % W : W;" in sort_cu
    assert "quad" not in sort_cu
    assert "kTile = kThreads * kItems;  // 2048" in (
        src / "merge_path.cuh").read_text()
    multiway = (src / "multiway.cuh").read_text()
    assert "constexpr int kMaxFan = 16;" in multiway
    assert "constexpr int kMultiRows = C == 1 ? 2 * kTile : kTile;" in multiway
    assert merge.SORT_TILES == {1: 1 << 13, 2: 1 << 12, 3: 1 << 12}
    assert merge.SORT_WAYS == {1: 16, 2: 16, 3: 16}
    assert all(t % merge.MERGE_TILE == 0 for t in merge.SORT_TILES.values())
    for n, c, want, four_way in (
            (1 << 25, 1, 4, 7), ((1 << 26) + (1 << 21), 1, 5, 8),
            ((1 << 22) + (1 << 21), 2, 4, 7), (1 << 25, 3, 5, 8)):
        tile = merge.SORT_TILES[c]
        assert len(merge.mergepath_passes(n, tile, merge.SORT_WAYS[c])) == \
            want
        assert len(merge.mergepath_passes(n, tile, 4)) == four_way


def test_plain_sort_equal_prefix_runs():
    """Long runs of equal major keys across tiles and runs (the
    reference's "wide values" case)."""
    rng = np.random.default_rng(0)
    n = 1 << 14
    hi = rng.integers(0, 1 << 31, size=n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    hi[: n // 2] = hi[n // 2:]
    got = merge_pallas.sort_cols_mergepath(
        (jnp.asarray(hi), jnp.asarray(lo)), t_log=10, interpret=True)
    keys = (torch.from_numpy(hi.astype(np.int64)),
            torch.from_numpy(lo.astype(np.int64)))
    want = [np.asarray(c).astype(np.int64) for c in got]
    _assert_cols_equal(merge.sort_mergepath_plain(keys, tile=1 << 10), want)
    _assert_cols_equal(merge.sort_mergepath_plain(keys), want)


@pytest.mark.parametrize("mode", sort.SORT_MODES)
@pytest.mark.parametrize("two", [False, True], ids=["one-col", "two-col"])
@pytest.mark.parametrize("n", [0, 1, 2, 1000, 4097, 12_345])
def test_dispatcher_any_length(mode, two, n):
    """`sort_keys` under either mode takes any length (the merge-path
    plain version pads with INT64_MAX rows and cuts them), keeps the
    caller's tensors and returns what it was given."""
    cols = _limb_cols(n, n + two, 3 if two else 2, 50, 0.05)
    keys = _port_keys(cols, two)
    before = [c.copy() for c in _as_numpy(keys)]
    with sort.use_sort_mode(mode):
        assert sort.sort_mode() == mode
        got = sort.sort_keys(keys)
    assert isinstance(got, tuple) == two
    _assert_cols_equal(got, _lexsorted(keys))
    _assert_cols_equal(keys, before)
    if not two:
        assert torch.equal(got, torch.sort(keys).values)


def test_sort_mode_selection(monkeypatch):
    monkeypatch.delenv(sort.SORT_ENV, raising=False)
    assert sort.sort_mode() == "library"
    monkeypatch.setenv(sort.SORT_ENV, "mergepath")
    assert sort.sort_mode() == "mergepath"
    with sort.use_sort_mode("library"):  # the override wins
        assert sort.sort_mode() == "library"
    assert sort.sort_mode() == "mergepath"
    monkeypatch.setenv(sort.SORT_ENV, "bitonic")
    assert sort.sort_mode() == "bitonic"
    monkeypatch.setenv(sort.SORT_ENV, "pallas")
    with pytest.raises(ValueError, match="CBL_TORCH_SORT"):
        sort.sort_mode()
    with pytest.raises(ValueError, match="use_sort_mode"):
        with sort.use_sort_mode("xla"):
            pass


def test_mergepath_mode_walks_the_passes(monkeypatch):
    """On the CPU the mergepath mode runs B5's plain version, never a
    whole-array `torch.sort`: 20_000 rows are 3 tiles of 8192, so a tile
    sort and one pass that merges four runs (a sort of the pairs, then of
    the four)."""
    calls, sorted_shapes = [], []
    real = merge.sort_mergepath_plain
    monkeypatch.setattr(merge, "sort_mergepath_plain",
                        lambda keys: calls.append(1) or real(keys))
    real_sort = merge.sort_cols_plain
    monkeypatch.setattr(
        merge, "sort_cols_plain",
        lambda cols, dim=0: sorted_shapes.append(tuple(cols[0].shape))
        or real_sort(cols, dim))
    x = torch.from_numpy(
        np.random.default_rng(4).integers(0, 99, size=20_000))
    with sort.use_sort_mode("mergepath"):
        got = sort.sort_keys(x)
    assert sorted_shapes == [(4, 8192), (2, 16384), (1, 32768)]
    with sort.use_sort_mode("mergepath"):
        merged = sort.merge_with_unsorted(got, x)
    assert len(calls) == 2
    assert merge.mergepath_passes(20_000, 8192, merge.SORT_WAYS[1]) == [
        ("tile_sort", 8192), ("merge", 8192, 4)]
    assert torch.equal(got, torch.sort(x).values)
    assert torch.equal(merged, torch.sort(torch.cat([x, x])).values)


def test_keys_are_checked():
    x = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="one to 3"):  # three are taken
        sort.sort_keys((x, x, x, x))
    with pytest.raises(ValueError, match="int64"):
        sort.sort_keys(x.to(torch.int32))
    with pytest.raises(ValueError, match="length"):
        sort.sort_keys((x, x[:4]))
    with pytest.raises(ValueError, match="number of columns"):
        merge.merge_sorted(x, (x, x))


@pytest.mark.parametrize("t_log", [10, 11])
def test_two_column_merge_matches_pallas_payload(t_log):
    """A payload column rides as the tie-break key (the sort-join
    pattern): the port's two-column merge against the Pallas merge."""
    rng = np.random.default_rng(5 + t_log)
    na, nb = 1 << 12, 1 << 11
    ka = np.sort(rng.integers(0, 64, size=na).astype(np.uint32))
    kb = np.sort(rng.integers(0, 64, size=nb).astype(np.uint32))
    pa = np.arange(na, dtype=np.int32)
    pb = np.arange(nb, dtype=np.int32) + na
    got = merge_pallas.merge_sorted_cols(
        (jnp.asarray(ka), jnp.asarray(pa)), (jnp.asarray(kb), jnp.asarray(pb)),
        t_log=t_log, interpret=True)
    want = [np.asarray(c).astype(np.int64) for c in got]
    a = tuple(torch.from_numpy(c.astype(np.int64)) for c in (ka, pa))
    b = tuple(torch.from_numpy(c.astype(np.int64)) for c in (kb, pb))
    for fn in (merge.merge_sorted, merge.merge_sorted_plain,
               sort.merge_sorted_pair):
        _assert_cols_equal(fn(a, b), want)
    _assert_cols_equal(sort.cat_cols(a, b)[0],
                       [np.concatenate([ka, kb]).astype(np.int64)])


@pytest.mark.parametrize("mode", sort.SORT_MODES)
def test_two_column_merge_with_unsorted(mode):
    """`merge_with_unsorted` on (word, seqtag) rows with sentinel words
    and an empty side, in both sort modes."""
    rng = np.random.default_rng(11)

    def rows(n):
        w = rng.integers(0, 40, size=n)
        w[rng.random(n) < 0.1] = SENTINEL
        return torch.from_numpy(w), torch.from_numpy(
            rng.integers(0, 1 << 22, size=n))

    a = merge.sort_cols_plain(rows(3000))
    u = rows(1234)
    empty = (torch.empty(0, dtype=torch.int64),) * 2
    with sort.use_sort_mode(mode):
        _assert_cols_equal(sort.merge_with_unsorted(a, u),
                           _lexsorted(sort.cat_cols(a, u)))
        _assert_cols_equal(sort.merge_with_unsorted(empty, u), _lexsorted(u))
        _assert_cols_equal(sort.merge_with_unsorted(a, empty), _as_numpy(a))


# --- three columns: the multiway passes ---------------------------------------


def _three_limb_cols(n, seed, hi, sent_frac, sent_tail=0):
    """Four uint32 limb columns for `cbl_tpu`: all-ones sentinel rows at
    random (`sent_frac`) and as a tail of `sent_tail` rows."""
    cols = _limb_cols(n, seed, 4, hi, sent_frac)
    for c in cols:
        c[n - sent_tail:] = 0xFFFFFFFF
    return cols


def _three_keys(cols):
    """The port's three int64 columns of four limb columns: the first two
    limbs make column 0 (`limbs.from_limbs`), the others columns 1 and 2,
    INT64_MAX in every column of a sentinel row.  Row order is the limbs'."""
    major = from_limbs(np.stack(cols[:2], axis=-1))
    out = [major]
    for c in cols[2:]:
        v = c.astype(np.int64)
        v[major == SENTINEL] = SENTINEL
        out.append(v)
    return tuple(torch.from_numpy(c) for c in out)


# lengths one below, at and above the scaled-down tile (64), the first
# pass's doubled runs (128), a 16-run group (1024) and two groups
_THREE_LENGTHS = [63, 64, 65, 127, 128, 129, 1023, 1024, 1025, 2049]


def _padded_pallas_sorted(cols, n, t_log):
    """`sort_cols_mergepath` of the limb rows in interpret mode, padded
    with all-ones rows to a power of two of at least 1024 (they sort
    last and are cut); -> the sorted limb columns, n rows."""
    rows = max(1024, 1 << max(n - 1, 1).bit_length())
    padded = [np.concatenate([c, np.full(rows - n, 0xFFFFFFFF, np.uint32)])
              for c in cols]
    got = merge_pallas.sort_cols_mergepath(
        tuple(jnp.asarray(c) for c in padded), t_log=min(t_log, 10),
        interpret=True)
    return [np.asarray(c)[:n] for c in got]


@pytest.mark.parametrize("n_cols,n", [
    pytest.param(3, n, id=str(n)) for n in _THREE_LENGTHS] + [
    pytest.param(c, n, id=f"{n}-{c}col") for c in (1, 2)
    for n in _THREE_LENGTHS])
@pytest.mark.parametrize("hi", [2, 1 << 24], ids=["dups", "wide"])
def test_plain_sort_matches_pallas_three_columns(n_cols, n, hi):
    """B5 at one, two and three columns: the plain multiway schedule at a
    tile of 64 rows and 16 runs a pass against numpy's lexsort,
    `torch.sort` (in one stable pass a column) and `cbl_tpu`'s Pallas
    merge sort in interpret mode on the same limb rows; duplicate-heavy
    columns, 5 % sentinels and a sentinel tail of 10 rows."""
    seed = n * 3 + hi % 7 + 100 * (3 - n_cols)
    if n_cols == 3:
        cols = _three_limb_cols(n, seed, hi, 0.05, 10)
        keys = _three_keys(cols)
    else:
        cols = _three_limb_cols(n, seed, hi, 0.05, 10)[:n_cols + 1]
        keys = _port_keys(cols, n_cols == 2)
    want = _lexsorted(keys)
    got = merge.sort_mergepath_plain(keys, tile=64, ways=16)
    _assert_cols_equal(got, want)
    _assert_cols_equal(merge.sort_cols_plain(merge.as_cols(keys)), want)
    _assert_cols_equal(merge.sort_mergepath(keys), want)  # the CPU dispatch
    if n_cols == 1:
        assert torch.equal(got, torch.sort(keys).values)
    if n in (65, 1024, 2049):
        limbs = _padded_pallas_sorted(cols, n, 10)
        _assert_cols_equal(got, _as_numpy(
            _three_keys(limbs) if n_cols == 3
            else _port_keys(limbs, n_cols == 2)))
    assert (want[0][-10:] == SENTINEL).all()


def _tagged_runs(rng, lens, hi, n_cols=3):
    """Sorted runs of `n_cols` columns (column 0 below `hi`, the others
    below 3 and 2) and the stable oracle of their merge: the rows laid end
    to end with their run and their index."""
    highs = (hi, 3, 2)[:n_cols]
    runs = [merge.sort_cols_plain(tuple(
        torch.from_numpy(rng.integers(0, h, size=n)) for h in highs))
        for n in lens]
    cols = [np.concatenate([r[c].numpy() for r in runs])
            for c in range(n_cols)]
    src = np.concatenate([np.full(n, i) for i, n in enumerate(lens)])
    idx = np.concatenate([np.arange(n) for n in lens])
    order = np.lexsort((idx, src) + tuple(cols[::-1]))
    return runs, cols, src, order


# (fan, columns): 16 runs a pass at one to three columns, and the fans of
# a first pass; four runs at one and two columns stand where the four-run
# partition of the earlier four-way pass was tested
_FANS = [pytest.param(f, 3, id=str(f)) for f in (2, 4, 8, 16)] + [
    pytest.param(f, c, id=f"{f}-{c}col")
    for f, c in ((4, 1), (4, 2), (16, 1), (16, 2), (2, 1), (8, 2))]


@pytest.mark.parametrize("fan,n_cols", _FANS)
@pytest.mark.parametrize("hi", [1, 3, 1000], ids=["constant", "3-valued",
                                                 "random"])
@pytest.mark.parametrize("shape", ["full", "short-last", "gaps"])
def test_multiway_split_matches_numpy(fan, n_cols, hi, shape):
    """The F-run split (csrc/multiway.cuh `multiway_split`'s walk, in
    plain Python) at every diagonal of 2 to 16 runs of up to 16 rows of
    one to three columns against a stable numpy sort with run tags: ties
    go by run, then by row.  Runs are full, the last one short, or of
    random lengths with empty ones among them."""
    rng = np.random.default_rng(fan * 100 + hi + len(shape) + 7 * (3 - n_cols))
    run = 16
    lens = {"full": [run] * fan,
            "short-last": [run] * (fan - 1) + [5],
            "gaps": [int(x) for x in rng.integers(0, run + 1, size=fan)]}
    lens = lens[shape]
    if shape == "gaps":
        lens[0] = 0
    runs, _, src, order = _tagged_runs(rng, lens, hi, n_cols)
    for d in range(sum(lens) + 1):
        want = np.bincount(src[order[:d]], minlength=fan)[:fan]
        got = merge.multiway_split_plain(runs, d, run)
        assert got == tuple(int(x) for x in want), (lens, d)
    # a longer top level than the runs need finds the same splits
    for d in (0, sum(lens) // 3, sum(lens)):
        assert merge.multiway_split_plain(runs, d, 4 * run) == \
            merge.multiway_split_plain(runs, d, run)


@pytest.mark.parametrize("fan,lens,n_cols", [
    pytest.param(16, [16] * 15 + [9], 3, id="16-lens0"),
    pytest.param(8, [16, 0, 16, 3, 16, 16, 0, 1], 3, id="8-lens1"),
    pytest.param(2, [16, 16], 3, id="2-lens2"),
    pytest.param(16, [16] * 15 + [9], 1, id="16-lens0-1col"),
    pytest.param(4, [16, 16, 16, 7], 1, id="4-short-last-1col"),
    pytest.param(4, [16, 13, 0, 0], 2, id="4-two-runs-2col"),
    pytest.param(4, [0, 16, 0, 16], 2, id="4-gaps-2col"),
    pytest.param(8, [16, 0, 16, 3, 16, 16, 0, 1], 2, id="8-lens1-2col"),
])
def test_multiway_tiles_make_the_merge(fan, lens, n_cols):
    """Tiles of 8 outputs merged as `merge_multi` merges them (the
    segments between two splits, pairwise level by level) lay end to end
    into the stable sort of the runs, duplicates across tile edges and
    runs too, at one to three columns."""
    rng = np.random.default_rng(fan + len(lens) + 11 * (3 - n_cols))
    runs, cols, _, order = _tagged_runs(rng, lens, 4, n_cols)
    n = sum(lens)
    tiles = [merge.merge_multi_tile_plain(runs, d0, min(d0 + 8, n), 16)
             for d0 in range(0, n, 8)]
    got = [np.concatenate([t[c].numpy() for t in tiles])
           for c in range(n_cols)]
    _assert_cols_equal(got, [c[order] for c in cols])


@pytest.mark.parametrize("n_cols,kind", [
    pytest.param(3, k, id=k) for k in ("equal", "sorted", "reverse",
                                       "small0")] + [
    pytest.param(c, k, id=f"{k}-{c}col") for c in (1, 2)
    for k in ("equal", "sorted", "reverse", "few")])
def test_three_column_schedule_on_skewed_rows(n_cols, kind):
    """The plain multiway schedule (tile 64, 16 runs a pass) on every row
    equal, sorted, reverse-sorted, every column below 3 and column 0 below
    2^20 (as necklace words are), 2049 rows at one to three columns,
    against numpy's lexsort and the CPU dispatch."""
    rng = np.random.default_rng(len(kind) + 10 * (3 - n_cols))
    n = 2049
    cols = [rng.integers(0, 3 if kind == "few" else 1 << 40, size=n)
            for _ in range(n_cols)]
    if kind == "equal":
        cols = [np.full(n, 7) for _ in range(n_cols)]
    elif kind == "small0":
        cols[0] = rng.integers(0, 1 << 20, size=n)
    keys = tuple(torch.from_numpy(c) for c in cols)
    if kind in ("sorted", "reverse"):
        keys = merge.sort_cols_plain(keys)
        if kind == "reverse":
            keys = tuple(c.flip(0).contiguous() for c in keys)
    want = _lexsorted(keys)
    _assert_cols_equal(merge.sort_mergepath_plain(keys, tile=64, ways=16),
                       want)
    _assert_cols_equal(merge.sort_mergepath_plain(keys, tile=64, ways=4),
                       want)
    _assert_cols_equal(merge.sort_mergepath(keys), want)
