"""Parity of the port's merge-path sort (kernel B5's module) with `cbl_tpu`.

`cbl_tpu_torch.ops.merge.sort_mergepath_plain` (two-way and four-way
passes, `mergepath_passes`), the plain four-run partition
`quad_split_plain` against numpy, the CPU dispatch of `sort_mergepath`
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
])
def test_pass_list_length(n, tile, ways, want):
    """1 tile sort + one pass a level (two-way) or a pass for every two
    levels after one two-way pass when their number is odd (four-way): 7
    passes at 2^25 one-column keys, where 2048-row tiles and two-way
    passes made 15."""
    passes = merge.mergepath_passes(n, tile, ways)
    levels = (-(-n // tile) - 1).bit_length()
    assert len(passes) == want == 1 + (levels if ways == 2
                                       else (levels + 1) // 2)
    assert passes[0] == ("tile_sort", tile)
    run = tile
    for i, (kind, at, fan) in enumerate(passes[1:]):
        assert kind == "merge" and at == run
        assert fan == 2 if ways == 2 or (levels % 2 and i == 0) else fan == 4
        run *= fan
    assert run >= n and (len(passes) == 1 or run // passes[-1][2] < n)
    with pytest.raises(ValueError, match="ways"):
        merge.mergepath_passes(n, tile, 3)


def _sorted_runs(rng, lens, hi, two):
    runs = []
    for n in lens:
        cols = [torch.from_numpy(rng.integers(0, hi, size=n))
                for _ in range(2 if two else 1)]
        cols = merge.sort_cols_plain(tuple(cols))
        runs.append(cols if two else cols[0])
    return runs


@pytest.mark.parametrize("hi", [1, 3, 1000], ids=["constant", "3-valued",
                                                 "random"])
@pytest.mark.parametrize("lens", [
    (40,), (40, 40), (40, 40, 40), (40, 40, 40, 40), (40, 40, 40, 7),
    (40, 13), (40, 40, 1), (0, 40, 0, 40), (5, 0, 0, 0),
])
@pytest.mark.parametrize("two", [False, True], ids=["one-col", "two-col"])
def test_quad_split_matches_numpy(hi, lens, two):
    """The nested co-rank at every diagonal of one to four runs (a short
    or empty last run too) against a stable numpy sort of the runs laid
    end to end: ties go A before B before C before D.  A tile merged
    from two such splits is that stretch of the sorted quad."""
    rng = np.random.default_rng(hi + sum(lens) + two)
    runs = _sorted_runs(rng, lens, hi, two)
    cols = [np.concatenate([_as_numpy(r)[c] for r in runs])
            for c in range(2 if two else 1)]
    src = np.concatenate([np.full(n, i) for i, n in enumerate(lens)])
    order = np.lexsort((src,) + tuple(cols[::-1]))  # stable in run order
    n = len(src)
    for d in range(n + 1):
        want = np.bincount(src[order[:d]], minlength=4)[:4]
        assert merge.quad_split_plain(runs, d) == tuple(want), d
    if not two:
        # every run gives all of its rows below the d-th key and none above
        flat = np.sort(cols[0])
        for d in {1, max(n // 3, 1), n}:
            for r, got in zip(runs, merge.quad_split_plain(runs, d)):
                r = _as_numpy(r)[0]
                assert (np.searchsorted(r, flat[d - 1], "left") <= got
                        <= np.searchsorted(r, flat[d - 1], "right"))
    tiles = [merge.merge_quad_tile_plain(runs, d0, min(d0 + 16, n))
             for d0 in range(0, n, 16)]
    got = [np.concatenate([_as_numpy(t)[c] for t in tiles])
           for c in range(len(cols))]
    _assert_cols_equal(got, [c[order] for c in cols])


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
    """`SORT_TILES` and `MERGE_TILE` are the constants of the sources; the
    runs a tile sort leaves are whole merge tiles."""
    src = merge._build.SRC_DIR
    assert "kSortRows = C == 1 ? 1 << 13 : 1 << 12;" in (
        src / "sort.cu").read_text()
    assert "kTile = kThreads * kItems;  // 2048" in (
        src / "merge_path.cuh").read_text()
    assert merge.SORT_TILES == {1: 1 << 13, 2: 1 << 12, 3: 1 << 12}
    assert all(t % merge.MERGE_TILE == 0 for t in merge.SORT_TILES.values())
    assert len(merge.mergepath_passes(1 << 25, merge.SORT_TILES[1])) == 7


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
    sort and one four-way pass (a sort of the pairs, then of the quad)."""
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
    assert merge.mergepath_passes(20_000, 8192) == [
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
