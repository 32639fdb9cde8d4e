"""Parity of the port's merge-path sort (kernel B5's module) with `cbl_tpu`.

`cbl_tpu_torch.ops.merge.sort_mergepath_plain`, the CPU dispatch of
`sort_mergepath` and `ops.sort.sort_keys` under both sort modes, against
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
    _assert_cols_equal(merge.sort_cols_plain(merge.as_cols(keys)), want)
    assert (want[0] == SENTINEL).any()


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
    whole-array `torch.sort`."""
    calls = []
    real = merge.sort_mergepath_plain
    monkeypatch.setattr(merge, "sort_mergepath_plain",
                        lambda keys: calls.append(1) or real(keys))
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 99, size=5000))
    with sort.use_sort_mode("mergepath"):
        got = sort.sort_keys(x)
        merged = sort.merge_with_unsorted(got, x)
    assert len(calls) == 2
    assert torch.equal(got, torch.sort(x).values)
    assert torch.equal(merged, torch.sort(torch.cat([x, x])).values)


def test_keys_are_checked():
    x = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="one or two"):
        sort.sort_keys((x, x, x))
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
