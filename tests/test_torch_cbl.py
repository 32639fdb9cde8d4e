"""Parity of the port's static build+query slice with `cbl_tpu.CBL`.

The same record streams go through `cbl_tpu.CBL` (JAX CPU backend, once
with its defaults and once with its Pallas merge forced on in interpret
mode) and through `cbl_tpu_torch.CBL(device="cpu")`, in plain and
canonical mode, at K=13 (where `cbl_tpu` joins with its payload-tag
kernel) and K=25: the distinct count, (total, positive) for a self-query
and for a query stream that was never inserted, and the set of distinct
words, for a build of one slab and of several.  A JAX-built index is also
carried across with `state.wordset_from_arrays` and queried by the port.
Inputs come from numpy.random.default_rng; every comparison is exact
integer equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cbl_tpu
from cbl_tpu import wordset as jws
from cbl_tpu_torch import CBL, state
from cbl_tpu_torch import wordset as tws
from cbl_tpu_torch.limbs import SENTINEL, from_limbs, to_limbs

torch.set_num_threads(2)


def _streams(k):
    """(insert codes, offsets, query codes, offsets): the query stream
    holds a slice of the insert stream and fresh bases, in records."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=12_000, dtype=np.uint8)
    off = np.array([0, 1_000, 1_010, 5_000, 11_990, 12_000], dtype=np.int64)
    q = np.concatenate([codes[2_000:4_500],
                        rng.integers(0, 4, size=3_000, dtype=np.uint8)])
    qoff = np.array([0, 2_500, 2_520, 5_500], dtype=np.int64)
    return codes, off, q, qoff


def _n_kmers(offsets, k):
    return int(np.maximum(np.diff(offsets) - k + 1, 0).sum())


def _valid_rows(words_u32):
    rows = np.asarray(words_u32)
    return np.unique(rows[~np.all(rows == 0xFFFFFFFF, axis=1)], axis=0)


def _port_rows(idx):
    keys = idx.wordset.data.numpy()
    return np.unique(to_limbs(keys[keys != SENTINEL], idx.cfg.word_limbs),
                     axis=0)


def _jax_results(k, canonical, codes, off, q, qoff):
    idx = cbl_tpu.CBL(k=k, canonical=canonical)
    ps = idx.pack_stream(codes, off)
    idx.insert_codes_stream(ps)
    self_q = idx.query_codes_stream(ps)
    foreign = idx.query_codes_stream(q, qoff)
    return idx, (idx.count(), self_q, foreign)


@pytest.mark.parametrize("jax_merge", ["default", "mergepath-force"])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [13, 25])
def test_slice_matches_jax(monkeypatch, k, canonical, jax_merge):
    codes, off, q, qoff = _streams(k)
    if jax_merge != "default":
        monkeypatch.setenv("CBL_TPU_MERGE_KERNEL", jax_merge)
    jax.clear_caches()
    try:
        jidx, want = _jax_results(k, canonical, codes, off, q, qoff)
        want_rows = _valid_rows(jidx.wordset.data)
    finally:
        jax.clear_caches()
    assert 0 < want[2][1] < want[2][0]  # the foreign query hits and misses

    for slab in (None, 4096):  # one slab, and three
        idx = CBL(k=k, canonical=canonical, device="cpu")
        ps = idx.pack_stream(codes, off, slab=slab)
        assert len(ps.slabs) == (1 if slab is None else 3)
        idx.insert_codes_stream(ps)
        n_dev = idx.count_device()
        self_q = idx.query_codes_stream(ps)
        foreign = idx.query_codes_stream(q, qoff)
        assert (idx.count(), self_q, foreign) == want
        assert int(n_dev) == want[0] == len(idx)
        np.testing.assert_array_equal(_port_rows(idx), want_rows)


@pytest.mark.parametrize("k,prefix_bits", [(7, 10), (25, 24)])
def test_packed_join_count_matches_jax(k, prefix_bits):
    """The join scan alone, on duplicate-heavy sides with sentinel rows:
    the port's scatter-add form against `cbl_tpu`'s reverse cummin and a
    python-set oracle."""
    cfg = cbl_tpu.config.get_config(k=k, prefix_bits=prefix_bits)
    L = cfg.word_limbs
    rng = np.random.default_rng(k)
    vocab = rng.integers(0, 1 << cfg.n_bits, size=300).astype(np.int64)
    data = vocab[rng.integers(0, 200, size=3000)]
    qry = vocab[rng.integers(100, 300, size=2000)]
    data[::97] = SENTINEL
    qry[::89] = SENTINEL
    data = np.sort(data)
    d_rows, q_rows = to_limbs(data, L), to_limbs(qry, L)
    d = jws._shift_tag(jnp.asarray(d_rows), 1)
    q = jws._shift_tag(jnp.asarray(q_rows), 0)
    cat = jnp.concatenate([d, q])
    s = jax.lax.sort(tuple(cat[:, l] for l in range(L)), num_keys=L)
    want = int(jws._packed_join_count(s, L))
    keys = torch.cat([tws._shift_tag(torch.from_numpy(from_limbs(d_rows)), 1),
                      tws._shift_tag(torch.from_numpy(from_limbs(q_rows)), 0)])
    got = int(tws._packed_join_count(torch.sort(keys).values))
    present = set(data[data != SENTINEL].tolist())
    oracle = sum(1 for w in qry.tolist() if w != SENTINEL and w in present)
    assert got == want == oracle > 0


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [13, 25])
def test_jax_index_carried_across(k, canonical):
    codes, off, q, qoff = _streams(k + 1)
    jidx, want = _jax_results(k, canonical, codes, off, q, qoff)
    ws = state.wordset_from_arrays(np.asarray(jidx.wordset.data),
                                   jidx.count(), jidx.cfg, "cpu")
    idx = CBL(k=k, canonical=canonical, device="cpu")
    idx.wordset = ws
    assert idx.count() == want[0]
    assert idx.query_codes_stream(codes, off) == want[1]
    assert idx.query_codes_stream(q, qoff) == want[2]
    np.testing.assert_array_equal(_port_rows(idx),
                                  _valid_rows(jidx.wordset.data))
    words, n = state.wordset_to_arrays(ws)
    assert n == want[0]
    np.testing.assert_array_equal(_valid_rows(words),
                                  _valid_rows(jidx.wordset.data))


def test_lazy_query_and_empty_index():
    codes, off, q, qoff = _streams(25)
    idx = CBL(k=25, device="cpu")
    assert idx.is_empty() and idx.count() == 0
    assert idx.query_codes_stream(q, qoff) == (_n_kmers(qoff, 25), 0)
    ps = idx.pack_stream(codes, off)
    idx.insert_codes_stream(ps)
    t, p = idx.query_codes_stream(ps, lazy=True)
    assert isinstance(t, torch.Tensor) and isinstance(p, torch.Tensor)
    assert int(t) == int(p) == _n_kmers(off, 25)
    assert not idx.is_empty()
    empty = np.zeros(10, dtype=np.uint8)
    assert idx.query_codes_stream(empty, np.array([0, 10])) == (0, 0)


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="slice 6"):
        CBL(k=29, device="cpu")
    CBL(k=27, device="cpu")  # the widest K one int64 key holds
    codes, off, _, _ = _streams(25)
    idx = CBL(k=25, device="cpu")
    idx.insert_codes_stream(codes, off)
    with pytest.raises(NotImplementedError, match="slice 3"):
        idx.insert_codes_stream(codes, off)
    with pytest.raises(NotImplementedError, match="slice 3"):
        idx.remove_codes_stream(codes, off)
    other = CBL(k=25, canonical=True, device="cpu")
    with pytest.raises(ValueError, match="different config"):
        other.query_codes_stream(idx.pack_stream(codes, off))
