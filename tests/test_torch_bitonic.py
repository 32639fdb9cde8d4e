"""Parity of the port's bitonic network (kernels B6 and B7's module) with
`cbl_tpu`.

`cbl_tpu_torch.ops.bitonic.bitonic_sort_plain` and `bitonic_merge_plain`
(the network walked step by step with tensor operations), the CPU
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
    assert (want[0] == SENTINEL).any()


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
    """On the CPU the bitonic modes run the plain networks and never a
    library sort; the "sort" merge mode runs no merge at all."""
    calls = []
    for name in ("bitonic_sort_plain", "bitonic_merge_plain"):
        real = getattr(bitonic, name)
        monkeypatch.setattr(
            bitonic, name,
            lambda *keys, real=real, name=name: calls.append(name)
            or real(*keys))
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
    assert calls == ["bitonic_sort_plain", "bitonic_sort_plain",
                     "bitonic_merge_plain", "bitonic_merge_plain",
                     "bitonic_merge_plain"]
    assert torch.equal(got, want) and torch.equal(merged, want2)
    assert torch.equal(pair, want2) and torch.equal(two[1], want2)
    calls.clear()
    with sort.use_merge_mode("sort"):
        assert torch.equal(sort.merge_sorted_pair(got, got), want2)
    assert calls == []


def test_keys_are_checked():
    x = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="one or two"):
        bitonic.bitonic_sort((x, x, x))
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
