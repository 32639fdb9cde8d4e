"""Parity of the port's bitonic network (kernels B6 and B7's module) with
`cbl_tpu`.

`cbl_tpu_torch.ops.bitonic.bitonic_sort_plain` and `bitonic_merge_plain`
(the networks walked step by step with tensor operations),
`bitonic_sort_passes_plain` (the sort network walked pass by pass as the
kernel schedules it: `network_passes`, `cross_block_rows`) and
`bitonic_merge_tiled_plain` (the merge as its kernel tiles it:
`merge_passes`, `tile_coranks`, tiles of 4 to 1024 rows), the CPU
dispatch of `bitonic_sort` / `bitonic_merge` and the seam's dispatchers
(`ops.sort.sort_keys`, `merge_sorted_pair`, `merge_with_unsorted`) under
every merge and sort mode, against `torch.sort`, a numpy lexsort and the
Pallas kernels `cbl_tpu.ops.sort_pallas.sort_cols_pallas` and
`merge_cols_pallas` in interpret mode.  The same numpy-seeded inputs go
to both: `cbl_tpu` gets uint32 limb columns, the port int64 keys made
from them with `limbs.from_limbs` (column 0, all-ones rows become
INT64_MAX) and a plain widening of the minor uint32 column.  Every
comparison is exact integer equality.  Sizes stay at or below 2^13 rows:
the interpret-mode network is slow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbl_tpu.ops import sort_pallas
from cbl_tpu_torch import CBL
from cbl_tpu_torch.limbs import SENTINEL, from_limbs
from cbl_tpu_torch.ops import bitonic, merge, sort

torch.set_num_threads(2)


def _limb_cols(n, seed, n_cols, hi, sent_frac, sort_rows=False):
    """`n_cols` uint32 columns, sentinel rows all-ones in every column;
    with `sort_rows`, the rows in lexicographic order."""
    r = np.random.default_rng(seed)
    cols = [r.integers(0, hi, size=n).astype(np.uint32)
            for _ in range(n_cols)]
    sent = r.random(n) < sent_frac
    for c in cols:
        c[sent] = 0xFFFFFFFF
    if sort_rows:
        order = np.lexsort(tuple(cols[::-1]))
        cols = [c[order] for c in cols]
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
    cols = (keys,) if isinstance(keys, torch.Tensor) else keys
    return [np.asarray(c) for c in cols]


def _lexsorted(keys):
    cols = _as_numpy(keys)
    order = np.lexsort(tuple(cols[::-1]))
    return [c[order] for c in cols]


def _assert_cols_equal(got, want):
    got = _as_numpy(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _jnp(cols):
    return tuple(jnp.asarray(c) for c in cols)


@pytest.mark.parametrize("n_log,t_log", [(10, 10), (13, 10), (13, 11)])
@pytest.mark.parametrize("two", [False, True], ids=["one-col", "two-col"])
@pytest.mark.parametrize("hi", [7, 1 << 24], ids=["dups", "wide"])
def test_plain_sort_matches_pallas(n_log, t_log, two, hi):
    """B6: 5 % sentinels; `hi` = 7 gives heavy duplicates in every
    column."""
    n = 1 << n_log
    cols = _limb_cols(n, n_log * 10 + two + hi % 5, 3 if two else 2, hi, 0.05)
    keys = _port_keys(cols, two)
    got = sort_pallas.sort_cols_pallas(_jnp(cols), t_log=t_log,
                                       interpret=True)
    want = _as_numpy(_port_keys([np.asarray(c) for c in got], two))
    _assert_cols_equal(_lexsorted(keys), want)
    _assert_cols_equal(bitonic.bitonic_sort_plain(keys), want)
    _assert_cols_equal(bitonic.bitonic_sort(keys), want)
    _assert_cols_equal(bitonic.bitonic_sort_passes_plain(keys, 1 << 6, 2),
                       want)
    _assert_cols_equal(merge.sort_cols_plain(merge.as_cols(keys)), want)
    assert (want[0] == SENTINEL).any()


@pytest.mark.parametrize("na_log,nb_log,t_log", [(12, 12, 10), (13, 11, 10),
                                                 (12, 12, 13)])
@pytest.mark.parametrize("two", [False, True], ids=["one-col", "two-col"])
@pytest.mark.parametrize("hi", [7, 1 << 24], ids=["dups", "wide"])
def test_plain_merge_matches_pallas(na_log, nb_log, t_log, two, hi):
    """B7: two sorted runs with 4 % sentinels each."""
    n_cols = 3 if two else 2
    ca = _limb_cols(1 << na_log, na_log + two, n_cols, hi, 0.04, True)
    cb = _limb_cols(1 << nb_log, nb_log + 50 + two, n_cols, hi, 0.04, True)
    a, b = _port_keys(ca, two), _port_keys(cb, two)
    got = sort_pallas.merge_cols_pallas(_jnp(ca), _jnp(cb), t_log=t_log,
                                        interpret=True)
    want = _as_numpy(_port_keys([np.asarray(c) for c in got], two))
    _assert_cols_equal(_lexsorted(sort.cat_cols(merge.as_cols(a),
                                                merge.as_cols(b))), want)
    _assert_cols_equal(bitonic.bitonic_merge_plain(a, b), want)
    _assert_cols_equal(bitonic.bitonic_merge(a, b), want)
    _assert_cols_equal(bitonic.bitonic_merge_plain(b, a), want)
    _assert_cols_equal(bitonic.bitonic_merge_tiled_plain(a, b, 1 << 6),
                       want)
    _assert_cols_equal(bitonic.bitonic_merge_tiled_plain(b, a, 1 << 2),
                       want)
    assert (want[0] == SENTINEL).any()


def _n_sort_passes(p_log, t_log, fuse):
    """1 tile sort + per stage ceil(d / fuse) cross passes + 1 in-tile."""
    return 1 + sum(-(-d // fuse) + 1 for d in range(1, p_log - t_log + 1))


@pytest.mark.parametrize("p_log,t_log,fuse,want", [
    (25, 12, 8, 32), (25, 13, 9, 28), (25, 12, 1, 105), (24, 13, 9, 25),
    (23, 12, 8, 26), (13, 13, 9, 1), (14, 13, 9, 3), (20, 10, 3, None),
    (16, 6, 2, None), (12, 4, 1, None),
])
def test_sort_pass_list_length(p_log, t_log, fuse, want):
    """The schedule's length is the formula's: 28 passes at 2^25 rows with
    the one-column tile (2^13, nine strides fused), 32 with 2^12 and eight,
    105 with one stride a pass.  Every stride of every stage appears once,
    in descending order inside its stage."""
    passes = bitonic.network_passes(1 << p_log, 1 << t_log, fuse)
    assert len(passes) == _n_sort_passes(p_log, t_log, fuse)
    if want is not None:
        assert len(passes) == want
    assert passes[0] == ("tile", t_log, t_log - 1, 0)
    strides = {}
    for kind, k_log, hi_log, lo_log in passes[1:]:
        assert kind in ("cross", "intile") and hi_log - lo_log < max(
            fuse, t_log)
        assert (kind == "cross") == (lo_log >= t_log)
        strides.setdefault(k_log, []).extend(range(hi_log, lo_log - 1, -1))
    assert strides == {k: list(range(k - 1, -1, -1))
                       for k in range(t_log + 1, p_log + 1)}


@pytest.mark.parametrize("rows_log,t_log,extra,tiles", [
    (25, 13, 0, 4096), (26, 13, 0, 8192), (25, 12, 0, 8192), (13, 13, 0, 1),
    (1, 13, 0, 1), (14, 13, 0, 2), (24, 12, 0, 4096), (25, 12, -1, 8192),
    (12, 4, 1, 257),
])
def test_merge_pass_list_length(rows_log, t_log, extra, tiles):
    """B7: one pass at every size (2^24 + 2^24 keys: 4096 output tiles of
    2^13 rows), its tiles cover the 2^rows_log + extra outputs, the last
    one holding 1 to `tile` of them; with two interleaved runs of equal
    length the tile edges' co-ranks are half the edge, rounded up."""
    n, tile = (1 << rows_log) + extra, 1 << t_log
    assert bitonic.merge_passes(n, tile) == [("tiles", tiles)]
    assert 1 <= n - (tiles - 1) * tile <= tile
    if n <= 1 << 14:
        na = n // 2
        a, b = torch.arange(0, 2 * na, 2), torch.arange(1, 2 * (n - na), 2)
        edges = torch.clamp(torch.arange(tiles + 1) * tile, max=n)
        assert torch.equal(bitonic.tile_coranks(a, b, tile),
                           torch.clamp((edges + 1) // 2, max=na))


@pytest.mark.parametrize("p_log,t_log,fuse", [
    (20, 6, 2), (20, 8, 4), (18, 5, 1), (16, 4, 3), (14, 13, 9),
])
def test_cross_blocks_own_disjoint_closed_rows(p_log, t_log, fuse):
    """In every cross pass each row belongs to exactly one block, and a
    block's rows are closed under the pass's strides (an in-place pass is
    safe only then); slices are contiguous runs of 2^c rows."""
    rows, tile = 1 << p_log, 1 << t_log
    seen = set()
    for kind, _, hi_log, lo_log in bitonic.network_passes(rows, tile, fuse):
        if kind != "cross" or (hi_log, lo_log) in seen:
            continue
        seen.add((hi_log, lo_log))
        f = hi_log - lo_log + 1
        first, idx = bitonic.cross_block_rows(rows, tile, lo_log, f)
        assert idx.shape == (rows // tile, tile)
        assert torch.equal(torch.sort(idx.reshape(-1)).values,
                           torch.arange(rows))
        assert torch.equal(idx[:, 0], first)
        for j_log in range(lo_log, hi_log + 1):
            partner = torch.sort(idx ^ (1 << j_log), dim=1).values
            assert torch.equal(partner, torch.sort(idx, dim=1).values)
        c = t_log - f
        runs = idx.view(-1, 1 << c)
        assert torch.equal(runs - runs[:, :1],
                           torch.arange(1 << c).expand_as(runs))
    assert seen


@pytest.mark.parametrize("n", [2, 3, 100, 1000, 4097, 40_000])
@pytest.mark.parametrize("tile,fuse", [(16, 1), (16, 2), (64, 3), (256, 4),
                                       (1024, 6)])
@pytest.mark.parametrize("two", [False, True], ids=["one-col", "two-col"])
def test_passes_plain_sort_equals_the_network(n, tile, fuse, two):
    """The pass-by-pass plain B6 at small tiles against the step-by-step
    network, `torch.sort` and a lexsort: duplicates, 20 % sentinels, any
    length; the caller's tensors are kept."""
    cols = _limb_cols(n, n + tile + two, 3 if two else 2, 9, 0.2)
    keys = _port_keys(cols, two)
    before = [c.copy() for c in _as_numpy(keys)]
    got = bitonic.bitonic_sort_passes_plain(keys, tile, fuse)
    assert isinstance(got, tuple) == two
    _assert_cols_equal(got, _as_numpy(bitonic.bitonic_sort_plain(keys)))
    _assert_cols_equal(got, _lexsorted(keys))
    _assert_cols_equal(keys, before)
    if not two:
        assert torch.equal(got, torch.sort(keys).values)


@pytest.mark.parametrize("na,nb", [(0, 1), (1, 1), (7, 100), (1000, 37),
                                   (4097, 5000), (3, 40_000)])
@pytest.mark.parametrize("tile", [16, 64, 1024])
@pytest.mark.parametrize("two", [False, True], ids=["one-col", "two-col"])
def test_passes_plain_merge_equals_the_network(na, nb, tile, two):
    """The tiled plain B7 against the step-by-step network and a lexsort
    of both runs."""
    n_cols = 3 if two else 2
    a = _port_keys(_limb_cols(na, na + 1, n_cols, 9, 0.1, True), two)
    b = _port_keys(_limb_cols(nb, nb + 2, n_cols, 9, 0.1, True), two)
    got = bitonic.bitonic_merge_tiled_plain(a, b, tile)
    _assert_cols_equal(got, _as_numpy(bitonic.bitonic_merge_plain(a, b)))
    _assert_cols_equal(got, _lexsorted(
        sort.cat_cols(merge.as_cols(a), merge.as_cols(b))))


def test_default_tiles_follow_the_sources():
    """`TILES` and `fuse_log` are the constants of csrc/bitonic.cuh."""
    src = (bitonic._build.SRC_DIR / "bitonic.cuh").read_text()
    assert "kTileLog = C == 1 ? 13 : 12;" in src
    assert "kFuseLog = kTileLog<C> - 4;" in src
    assert bitonic.TILES == {1: 1 << 13, 2: 1 << 12, 3: 1 << 12}
    assert [bitonic.fuse_log(t) for t in (1 << 13, 1 << 12)] == [9, 8]
    # one sort of 2^25 one-column keys: 28 passes (105 with one stride a
    # pass over tiles of 2^12 rows)
    assert len(bitonic.network_passes(1 << 25, 1 << 13, 9)) == 28


def test_merge_tiles_follow_the_source():
    """B7's output tiles are csrc/bitonic_merge.cu's `kMergeRows`, which
    `MERGE_TILES` mirrors, and its co-rank rule is B3's `corank`."""
    src = (bitonic._build.SRC_DIR / "bitonic_merge.cu").read_text()
    assert "template <int C>\nconstexpr int kMergeTileLog = C == 1 ? 11 : 10;" \
        in src
    assert ("const long long tiles = (na + nb + kMergeRows<C> - 1) / "
            "kMergeRows<C>;") in src
    assert "const long long d0 = (long long)blockIdx.x * T;" in src
    assert "constexpr int T = kMergeRows<C>;" in src
    assert "coranks[g] = corank<C>(a, na, b, nb, d);" in src
    assert bitonic.MERGE_TILES == {1: 1 << 11, 2: 1 << 10, 3: 1 << 10}
    assert bitonic.merge_passes(2 << 24, bitonic.MERGE_TILES[1]) == [
        ("tiles", 1 << 14)]


# (na, nb): na + nb = k * 64 - 1, k * 64 and k * 64 + 1, so an edge of
# every tile from 4 to 64 rows; an empty side; one row
_EDGE_LENGTHS = [(0, 1), (1, 0), (1, 1), (127, 0), (64, 63), (100, 28),
                 (100, 29), (200, 55)]


def _edge_runs(na, nb, kind, two, seed):
    """Two sorted runs of port keys: "dups" (keys < 3, runs of equal rows
    across every tile edge and co-rank split; with `two`, column 0 < 2 and
    a minor column < 3), "one value" (every row of both runs equal), or
    "sentinels" (keys < 40 and a sentinel tail of 30 %); with `two` and
    "sentinels", column 0 < 3 ties across the splits and the minor column
    decides."""
    n_cols = 3 if two else 2
    hi = {"dups": 3, "one value": 1, "sentinels": 40}[kind]
    sent = 0.3 if kind == "sentinels" else 0.0

    def run(n, s):
        cols = _limb_cols(n, s, n_cols, hi, sent)
        if two:
            cols[0][cols[0] != 0xFFFFFFFF] = 0
            cols[1][cols[1] != 0xFFFFFFFF] %= 2 if kind != "sentinels" else 3
            if kind == "sentinels":
                r = np.random.default_rng(s + 7)
                wide = r.integers(0, 1 << 30, size=n).astype(np.uint32)
                cols[2] = np.where(cols[2] == 0xFFFFFFFF, cols[2], wide)
        order = np.lexsort(tuple(cols[::-1]))
        return [c[order] for c in cols]

    return run(na, seed), run(nb, seed + 1)


@pytest.mark.parametrize("na,nb", _EDGE_LENGTHS)
@pytest.mark.parametrize("kind", ["dups", "one value", "sentinels"])
@pytest.mark.parametrize("two", [False, True], ids=["one-col", "two-col"])
def test_tiled_merge_at_tile_edges(na, nb, kind, two):
    """The tiled plain B7 at tiles of 4, 8, 16 and 64 rows, in both orders
    of the runs, against the step-by-step network and a lexsort: lengths
    on and beside the tile edges, an empty side, one row, runs of equal
    rows across tile edges and co-rank splits, sentinel tails."""
    ca, cb = _edge_runs(na, nb, kind, two, na * 3 + nb + two)
    a, b = _port_keys(ca, two), _port_keys(cb, two)
    want = _lexsorted(sort.cat_cols(merge.as_cols(a), merge.as_cols(b)))
    _assert_cols_equal(bitonic.bitonic_merge_plain(a, b), want)
    before = [c.copy() for c in _as_numpy(a) + _as_numpy(b)]
    for tile in (4, 8, 16, 64):
        _assert_cols_equal(bitonic.bitonic_merge_tiled_plain(a, b, tile),
                           want)
        _assert_cols_equal(bitonic.bitonic_merge_tiled_plain(b, a, tile),
                           want)
    _assert_cols_equal(bitonic.bitonic_merge(a, b), want)
    _assert_cols_equal(_as_numpy(a) + _as_numpy(b), before)


@pytest.mark.parametrize("kind", ["dups", "one value", "sentinels"])
@pytest.mark.parametrize("two", [False, True], ids=["one-col", "two-col"])
def test_tiled_merge_matches_pallas_at_tile_edges(kind, two):
    """The tiled plain B7 at tiles of 4 to 64 rows against the
    interpret-mode `merge_cols_pallas`, on 100 + 29 rows (one past an
    edge of every tile) of the edge runs."""
    ca, cb = _edge_runs(100, 29, kind, two, 11 + two)
    a, b = _port_keys(ca, two), _port_keys(cb, two)
    got = sort_pallas.merge_cols_pallas(_jnp(ca), _jnp(cb), t_log=10,
                                        interpret=True)
    want = _as_numpy(_port_keys([np.asarray(c) for c in got], two))
    for tile in (4, 8, 16, 64):
        _assert_cols_equal(bitonic.bitonic_merge_tiled_plain(a, b, tile),
                           want)
    _assert_cols_equal(bitonic.bitonic_merge_plain(a, b), want)


def _rank_rows(*runs):
    """Each run's rows as dense lexicographic ranks over all the runs."""
    rows = np.concatenate([np.stack(r, axis=1) for r in runs])
    _, ranks = np.unique(rows, axis=0, return_inverse=True)
    ranks = ranks.reshape(-1)
    ends = np.cumsum([len(r[0]) for r in runs])
    return np.split(ranks, ends[:-1])


@pytest.mark.parametrize("na,nb", [(0, 5), (5, 0), (1, 1), (100, 29),
                                   (64, 63), (300, 300)])
@pytest.mark.parametrize("tile", [4, 64])
@pytest.mark.parametrize("two", [False, True], ids=["one-col", "two-col"])
def test_tile_coranks_match_searchsorted(na, nb, tile, two):
    """`tile_coranks` against a numpy oracle: A's rows land at i +
    searchsorted(B, A[i], "left") (A before B on ties), and the co-rank
    of edge d is how many of those positions lie below d."""
    ca, cb = _edge_runs(na, nb, "dups", two, na + 5 * nb + tile + two)
    a, b = _port_keys(ca, two), _port_keys(cb, two)
    ra, rb = _rank_rows(_as_numpy(a), _as_numpy(b))
    pos = np.arange(na) + np.searchsorted(rb, ra, side="left")
    tiles = -(-(na + nb) // tile)
    edges = np.minimum(np.arange(tiles + 1) * tile, na + nb)
    want = np.searchsorted(pos, edges, side="left")
    np.testing.assert_array_equal(
        bitonic.tile_coranks(a, b, tile).numpy(), want)


def test_merge_payload_is_the_tie_break_column():
    """A payload column rides as the minor key (the sort-join pattern):
    among equal major keys the rows of both runs interleave by payload."""
    rng = np.random.default_rng(5)
    na = nb = 1 << 12
    ka = np.sort(rng.integers(0, 64, size=na).astype(np.uint32))
    kb = np.sort(rng.integers(0, 64, size=nb).astype(np.uint32))
    pa = rng.permutation(na + nb)[:na].astype(np.int32)
    pb = rng.permutation(na + nb)[:nb].astype(np.int32)
    oa, ob = np.lexsort((pa, ka)), np.lexsort((pb, kb))
    ca, cb = (ka[oa], pa[oa]), (kb[ob], pb[ob])
    got = sort_pallas.merge_cols_pallas(_jnp(ca), _jnp(cb), t_log=10,
                                        interpret=True)
    want = [np.asarray(c).astype(np.int64) for c in got]
    a = tuple(torch.from_numpy(c.astype(np.int64)) for c in ca)
    b = tuple(torch.from_numpy(c.astype(np.int64)) for c in cb)
    _assert_cols_equal(bitonic.bitonic_merge_plain(a, b), want)
    _assert_cols_equal(merge.merge_sorted_plain(a, b), want)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1000, 4096, 4097, 8191])
@pytest.mark.parametrize("two", [False, True], ids=["one-col", "two-col"])
def test_plain_sort_any_length(n, two):
    """Lengths that are no power of two: the direction of every exchange
    comes from the padded index, and the pads are cut.  Against
    `torch.sort` and a lexsort, half sentinels at the odd sizes."""
    cols = _limb_cols(n, n + two, 3 if two else 2, 50, 0.5 * (n % 2))
    keys = _port_keys(cols, two)
    before = [c.copy() for c in _as_numpy(keys)]
    got = bitonic.bitonic_sort_plain(keys)
    assert isinstance(got, tuple) == two
    _assert_cols_equal(got, _lexsorted(keys))
    _assert_cols_equal(keys, before)  # the caller's tensors are not written
    if not two:
        assert torch.equal(got, torch.sort(keys).values)


@pytest.mark.parametrize("na,nb", [
    (0, 0), (0, 1), (1, 0), (1, 1), (2, 5), (1000, 37), (37, 1000),
    (4097, 5000), (3, 8192),
])
@pytest.mark.parametrize("two", [False, True], ids=["one-col", "two-col"])
@pytest.mark.parametrize("mode", sort.MERGE_MODES)
def test_merge_dispatchers_any_length(mode, two, na, nb):
    """`merge_sorted_pair` and `merge_with_unsorted` under every merge
    mode: unequal lengths, no powers of two, empty and one-row sides."""
    n_cols = 3 if two else 2
    a = _port_keys(_limb_cols(na, na + 1, n_cols, 40, 0.1, True), two)
    b = _port_keys(_limb_cols(nb, nb + 2, n_cols, 40, 0.1, True), two)
    u = _port_keys(_limb_cols(nb, nb + 3, n_cols, 40, 0.1), two)
    with sort.use_merge_mode(mode):
        assert sort.merge_mode() == mode
        assert sort.use_merge_combine() == (mode != "sort")
        got = sort.merge_sorted_pair(a, b)
        got_u = sort.merge_with_unsorted(a, u)
    assert isinstance(got, tuple) == two == isinstance(got_u, tuple)
    _assert_cols_equal(got, _lexsorted(
        sort.cat_cols(merge.as_cols(a), merge.as_cols(b))))
    _assert_cols_equal(got_u, _lexsorted(
        sort.cat_cols(merge.as_cols(a), merge.as_cols(u))))


@pytest.mark.parametrize("merge_mode", sort.MERGE_MODES)
@pytest.mark.parametrize("sort_mode", sort.SORT_MODES)
def test_mode_pairs_agree(merge_mode, sort_mode):
    """Every (merge, sort) mode pair gives the library's result."""
    rng = np.random.default_rng(8)
    a = torch.sort(torch.from_numpy(rng.integers(-99, 99, size=3000))).values
    u = torch.from_numpy(rng.integers(-99, 99, size=1234))
    u[::9] = SENTINEL
    with sort.use_merge_mode(merge_mode), sort.use_sort_mode(sort_mode):
        got = sort.merge_with_unsorted(a, u)
        pair = sort.merge_sorted_pair(a, sort.sort_keys(u))
    want = torch.sort(torch.cat([a, u])).values
    assert torch.equal(got, want) and torch.equal(pair, want)


def test_merge_mode_selection(monkeypatch):
    monkeypatch.delenv(sort.MERGE_ENV, raising=False)
    assert sort.merge_mode() == "mergepath" and sort.use_merge_combine()
    monkeypatch.setenv(sort.MERGE_ENV, "bitonic")
    assert sort.merge_mode() == "bitonic" and sort.use_merge_combine()
    with sort.use_merge_mode("sort"):  # the override wins
        assert sort.merge_mode() == "sort" and not sort.use_merge_combine()
        with sort.use_merge_mode("mergepath"):
            assert sort.merge_mode() == "mergepath"
        assert sort.merge_mode() == "sort"
    assert sort.merge_mode() == "bitonic"
    assert sort.sort_mode() == "library"  # the two selectors are apart
    monkeypatch.setenv(sort.MERGE_ENV, "pallas")
    with pytest.raises(ValueError, match="CBL_TORCH_MERGE"):
        sort.merge_mode()
    with pytest.raises(ValueError, match="use_merge_mode"):
        with sort.use_merge_mode("xla"):
            pass
    monkeypatch.setenv(sort.SORT_ENV, "bitonic")
    assert sort.sort_mode() == "bitonic"


def test_bitonic_modes_walk_the_network(monkeypatch):
    """On the CPU the bitonic modes run the plain networks as the kernels
    schedule them (the sort pass by pass, the merge in one tiled pass),
    and never a library sort; the "sort" merge mode runs no merge at
    all."""
    calls = []
    for name in ("bitonic_sort_passes_plain", "bitonic_merge_tiled_plain"):
        real = getattr(bitonic, name)
        monkeypatch.setattr(
            bitonic, name,
            lambda *keys, real=real, name=name: calls.append(name)
            or real(*keys))
    walked = []
    real_walk = bitonic._walk_pass
    monkeypatch.setattr(
        bitonic, "_walk_pass",
        lambda cols, tile, pas: walked.append(pas[0])
        or real_walk(cols, tile, pas))
    real_merge_passes = bitonic.merge_passes
    monkeypatch.setattr(
        bitonic, "merge_passes",
        lambda n, tile: walked.extend(real_merge_passes(n, tile))
        or real_merge_passes(n, tile))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(0, 99, size=5000))
    want = torch.sort(x).values
    want2 = torch.sort(torch.cat([x, x])).values

    def no_library_sort(*args, **kwargs):
        raise AssertionError("a library sort on the bitonic path")

    with sort.use_sort_mode("bitonic"), sort.use_merge_mode("bitonic"), \
            monkeypatch.context() as m:
        m.setattr(torch, "sort", no_library_sort)
        got = sort.sort_keys(x)
        merged = sort.merge_with_unsorted(got, x)
        pair = sort.merge_sorted_pair(got, got)
        two = sort.merge_sorted_pair((got, got), (got, got))
    assert calls == ["bitonic_sort_passes_plain", "bitonic_sort_passes_plain",
                     "bitonic_merge_tiled_plain",
                     "bitonic_merge_tiled_plain",
                     "bitonic_merge_tiled_plain"]
    # 5000 rows fit one sort tile of 8192; two runs of 5000 make 10,000
    # rows: one merge pass over five output tiles of 2048 (ten of 1024
    # with two columns)
    assert walked == ["tile", "tile", ("tiles", 5), ("tiles", 5),
                      ("tiles", 10)]
    assert torch.equal(got, want) and torch.equal(merged, want2)
    assert torch.equal(pair, want2) and torch.equal(two[1], want2)
    calls.clear()
    with sort.use_merge_mode("sort"):
        assert torch.equal(sort.merge_sorted_pair(got, got), want2)
    assert calls == []


def test_keys_are_checked():
    x = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="one to 3"):  # three are taken
        bitonic.bitonic_sort((x, x, x, x))
    with pytest.raises(ValueError, match="int64"):
        bitonic.bitonic_sort(x.to(torch.int32))
    with pytest.raises(ValueError, match="length"):
        bitonic.bitonic_merge(x, (x, x[:4]))
    with pytest.raises(ValueError, match="number of columns"):
        bitonic.bitonic_merge(x, (x, x))
    with pytest.raises(ValueError, match="number of columns"):
        bitonic.bitonic_merge_plain((x, x), x)


def test_merge_mode_of_the_environment(monkeypatch):
    """`CBL_TORCH_MERGE` selects the path of a set operation."""
    rng = np.random.default_rng(3)
    off = np.array([0, 3_000], dtype=np.int64)
    a = rng.integers(0, 4, size=3_000, dtype=np.uint8), off
    b = np.concatenate([a[0][:1_500], a[0][:1_500]]), off
    x, y = CBL(k=25, device="cpu"), CBL(k=25, device="cpu")
    x.insert_codes_stream(*a)
    y.insert_codes_stream(*b)
    results = {}
    for mode in sort.MERGE_MODES:
        monkeypatch.setenv(sort.MERGE_ENV, mode)
        r = x - y
        assert r.wordset._holes == (mode != "sort")
        r.wordset._compact()
        results[mode] = r.wordset.data[: r.count()]
    assert torch.equal(results["sort"], results["bitonic"])
    assert torch.equal(results["sort"], results["mergepath"])
    assert 0 < len(results["sort"]) < x.count()
