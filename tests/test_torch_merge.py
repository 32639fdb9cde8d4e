"""Parity of the port's merge (kernel B3's module) with `cbl_tpu`.

`cbl_tpu_torch.ops.merge.merge_sorted` (CPU dispatch), its plain version
and the dispatchers of `cbl_tpu_torch.ops.sort` against the Pallas
merge-path kernel `merge_sorted_cols` in interpret mode, at the sizes and
tile logs that tests/test_merge_pallas.py uses.  Limb columns become
int64 keys through `limbs.from_limbs`, so all-ones sentinel rows become
INT64_MAX.  Inputs come from numpy.random.default_rng; every comparison
is exact integer equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbl_tpu.ops import merge_pallas
from cbl_tpu_torch.limbs import SENTINEL, from_limbs
from cbl_tpu_torch.ops import merge, sort

torch.set_num_threads(2)


def _sorted_cols(n, seed, L=2, lo=0, hi=1 << 16, sent_frac=0.04):
    r = np.random.default_rng(seed)
    cols = [r.integers(lo, hi, size=n).astype(np.uint32) for _ in range(L)]
    sent = r.random(n) < sent_frac
    for c in cols:
        c[sent] = 0xFFFFFFFF
    order = np.lexsort(tuple(cols[::-1]))
    return tuple(c[order] for c in cols)


def _check(ca, cb, t_log):
    got_j = merge_pallas.merge_sorted_cols(
        tuple(jnp.asarray(c) for c in ca),
        tuple(jnp.asarray(c) for c in cb),
        t_log=t_log,
        interpret=True,
    )
    want = from_limbs(np.stack([np.asarray(c) for c in got_j], axis=-1))
    a = torch.from_numpy(from_limbs(np.stack(ca, axis=-1)))
    b = torch.from_numpy(from_limbs(np.stack(cb, axis=-1)))
    for got in (merge.merge_sorted(a, b), merge.merge_sorted_plain(a, b),
                sort.merge_sorted_pair(a, b)):
        np.testing.assert_array_equal(got.numpy(), want)
    return want


@pytest.mark.parametrize("na_log,nb_log,t_log", [
    (12, 12, 10), (13, 11, 10), (14, 14, 11), (12, 10, 12),
])
@pytest.mark.parametrize("L", [1, 2])
def test_merge_matches_pallas(na_log, nb_log, t_log, L):
    ca = _sorted_cols(1 << na_log, na_log * 13 + L, L=L)
    cb = _sorted_cols(1 << nb_log, nb_log * 7 + L, L=L)
    want = _check(ca, cb, t_log)
    assert (want == SENTINEL).any()


def test_merge_heavy_duplicates():
    ca = _sorted_cols(1 << 12, 1, L=2, hi=7, sent_frac=0.1)
    cb = _sorted_cols(1 << 12, 2, L=2, hi=7, sent_frac=0.1)
    _check(ca, cb, t_log=10)


def test_merge_skewed_sides():
    ca = _sorted_cols(1 << 14, 3, L=2)
    cb = _sorted_cols(3 * (1 << 8), 4, L=2)  # 768: not a tile multiple
    _check(ca, cb, t_log=10)
    _check(cb, ca, t_log=10)


def test_merge_empty_side():
    ca = _sorted_cols(1 << 12, 5, L=2)
    empty = tuple(np.zeros(0, np.uint32) for _ in range(2))
    _check(ca, empty, t_log=10)
    _check(empty, ca, t_log=10)


def test_merge_with_unsorted_equals_sort():
    rng = np.random.default_rng(9)
    a = torch.sort(torch.from_numpy(rng.integers(0, 50, size=3000))).values
    u = torch.from_numpy(rng.integers(0, 50, size=1234))
    u[::17] = SENTINEL
    want = torch.sort(torch.cat([a, u])).values
    assert torch.equal(sort.merge_with_unsorted(a, u), want)
    assert torch.equal(sort.sort_keys(u), torch.sort(u).values)
