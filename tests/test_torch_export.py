"""Parity of the port's export with `cbl_tpu`: words, prefixes, k-mers.

The same numpy-seeded record streams go through `cbl_tpu.CBL` (JAX CPU
backend, its default modes) and `cbl_tpu_torch.CBL(device="cpu")` at
K=13 (one limb), K=25 and K=27, plain and canonical, into four states
that an export must fold first: a static build (duplicate keys), `a - b`
(an index with holes in the port, K > 13), a pending log of inserts and
removes,
and an active sorted log after a `dynamic_round` (K <= 25: the port
refuses rounds at K=27).  Each export runs on a fresh pair in that state
and must give the same array (dtype, shape and bytes), the same
sequence, and leave both word sets in the same state.  The limb helpers
are held against `limbs.to_limbs` / `from_limbs` and `cbl_tpu.limbs`.
"""

import numpy as np
import pytest
import torch

import cbl_tpu
from cbl_tpu import kmer as jkmer
from cbl_tpu import limbs as jlimbs
from cbl_tpu import necklace as jneck
from cbl_tpu_torch import CBL, kmer, limbs, necklace
from cbl_tpu_torch.config import get_config

torch.set_num_threads(2)

CONFIGS = {"k13": (13, False), "k13-canonical": (13, True),
           "k25": (25, False), "k25-canonical": (25, True),
           "k27": (27, False), "k27-canonical": (27, True)}
STATES = ("built", "holes", "pending", "round")
CASES = [(k, c, s) for k, c in CONFIGS.values() for s in STATES
         if not (s == "round" and k > 25)]
CASE_IDS = [f"{name}-{s}" for name, (k, c) in CONFIGS.items()
            for s in STATES if not (s == "round" and k > 25)]
every_case = pytest.mark.parametrize("k,canonical,state", CASES,
                                     ids=CASE_IDS)
BASES = 1500


def _one(codes):
    return codes, np.array([0, len(codes)], dtype=np.int64)


def _build(cls, k, canonical, state):
    """An index of `cls` in `state`, from the same seeded bases."""
    rng = np.random.default_rng(7 * k + canonical)
    codes = rng.integers(0, 4, size=BASES, dtype=np.uint8)
    kw = dict(k=k, canonical=canonical, pending_cap=8192)
    idx = cls(**kw)
    if state == "holes":
        b = cls(**kw)
        idx.insert_codes_stream(*_one(codes[:1000]))
        b.insert_codes_stream(*_one(codes[600:]))
        return idx - b
    idx.insert_codes_stream(*_one(codes))
    if state == "pending":
        idx.insert_codes_stream(*_one(rng.integers(0, 4, size=300,
                                                   dtype=np.uint8)))
        idx.remove_codes_stream(*_one(codes[:200]))
    elif state == "round":
        idx.dynamic_round(_one(rng.integers(0, 4, size=400, dtype=np.uint8)),
                          _one(codes[:300]), _one(codes[500:700]))
    return idx


def _pair(k, canonical, state):
    """(cbl_tpu index, port index) in `state`; the port's state is the one
    the export must fold."""
    j = _build(cbl_tpu.CBL, k, canonical, state)
    t = _build(lambda **kw: CBL(device="cpu", **kw), k, canonical, state)
    tw = t.wordset
    # at K=13 the tag bit of the merge does not fit one limb, so `a - b`
    # is a tagged sort in both packages and leaves no holes
    assert {"built": tw._dups, "holes": tw._holes == (k > 13),
            "pending": tw.n_pending > 0 and tw._pending_rm,
            "round": tw.slog.keys is not None}[state]
    return j, t


def _same_array(got, want, what=""):
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


def _same_state(j, t):
    """Both word sets folded to the same sorted unique keys."""
    jw, tw = j.wordset, t.wordset
    assert (tw.n_pending, tw.slog.keys, tw._holes, tw._dups) == (0, None,
                                                              False, False)
    assert (jw.n_pending, jw._holes, jw._dups) == (0, False, False)
    assert tw.n == jw.n and tw._n_upper == jw._n_upper
    np.testing.assert_array_equal(
        tw.data[: tw.n].numpy(), limbs.from_limbs(np.asarray(jw.data)[: jw.n]))


@every_case
def test_words_array(k, canonical, state):
    j, t = _pair(k, canonical, state)
    got = t.wordset.words_array()
    _same_array(got, j.wordset.words_array())
    assert got.shape[0] == t.count() > 0
    _same_state(j, t)


@every_case
def test_iter_words_chunks(k, canonical, state):
    j, t = _pair(k, canonical, state)
    n = j.wordset.words_array().shape[0]
    want = j.wordset.words_array()
    for chunk in (1, 7, n - 1, n, n + 1, 4096):
        blocks = list(t.wordset.iter_words_chunks(chunk))
        ref = list(j.wordset.iter_words_chunks(chunk))
        assert [b.shape for b in blocks] == [b.shape for b in ref], chunk
        assert all(b.dtype == np.uint32 for b in blocks)
        _same_array(np.concatenate(blocks), want, chunk)
    _same_state(j, t)


@every_case
def test_prefixes(k, canonical, state):
    j, t = _pair(k, canonical, state)
    got = t.wordset.prefixes()
    _same_array(got, j.wordset.prefixes())
    assert np.all(got[1:] >= got[:-1])
    _same_state(j, t)


@every_case
def test_kmers_limbs(k, canonical, state):
    j, t = _pair(k, canonical, state)
    got = t.kmers_limbs()
    _same_array(got, j.kmers_limbs())
    words = t.wordset.words_array()
    _same_array(got, necklace.np_word_to_kmer(words, t.cfg))
    _same_state(j, t)


@every_case
def test_iter_ints(k, canonical, state):
    j, t = _pair(k, canonical, state)
    got = list(t)
    assert got == list(j)
    assert all(type(v) is int for v in got)
    if canonical:
        assert all(kmer.py_is_canonical(v) for v in got[:200])
    _same_state(j, t)


@every_case
def test_iter_nucs(k, canonical, state):
    j, t = _pair(k, canonical, state)
    got = list(t.iter_nucs(chunk_rows=333))
    assert got == list(j.iter_nucs())
    assert all(type(r) is bytes and len(r) == k for r in got)
    _same_state(j, t)


@pytest.mark.parametrize("k", [13, 25, 27])
def test_empty_exports(k):
    j = cbl_tpu.CBL(k=k)
    t = CBL(k=k, device="cpu")
    _same_array(t.wordset.words_array(), j.wordset.words_array())
    _same_array(t.wordset.prefixes(), j.wordset.prefixes())
    _same_array(t.kmers_limbs(), j.kmers_limbs())
    assert list(t.wordset.iter_words_chunks(5)) == []
    assert list(t) == list(j) == [] and list(t.iter_nucs()) == []


@pytest.mark.parametrize("k", [13, 25, 27])
def test_decode_helpers_match(k):
    """`word_to_kmer`, `revert_necklace_pos`, `word_prefix`,
    `np_word_to_kmer`, `unpack_bases` and `np_unpack_bases` against
    `cbl_tpu`'s on random k-mers (all-zero and all-ones ones included)."""
    cfg = get_config(k=k)
    rng = np.random.default_rng(k)
    km = rng.integers(0, 1 << cfg.kmer_bits, size=2000, dtype=np.int64)
    km[:2] = [0, (1 << cfg.kmer_bits) - 1]
    neck, pos = necklace.necklace_pos(torch.from_numpy(km), cfg)
    words = necklace.pack_word(neck, pos, cfg)
    back = necklace.word_to_kmer(words, cfg)
    np.testing.assert_array_equal(back.numpy(), km)
    np.testing.assert_array_equal(
        necklace.revert_necklace_pos(neck, pos, cfg).numpy(), km)
    wl = limbs.to_limbs(words.numpy(), cfg.word_limbs)
    km_l = limbs.to_limbs(km, cfg.kmer_limbs)
    _same_array(necklace.np_word_to_kmer(wl, cfg),
                jneck.np_word_to_kmer(wl, cfg))
    _same_array(necklace.np_word_to_kmer(wl, cfg), km_l)
    prefix = limbs.keys_to_limbs(necklace.word_prefix(words, cfg), 1)
    _same_array(prefix.numpy().view(np.uint32).reshape(-1),
                np.asarray(jneck.word_prefix(wl, cfg)))
    codes = kmer.unpack_bases(torch.from_numpy(km), cfg).numpy()
    _same_array(codes, jkmer.np_unpack_bases(km_l, cfg))
    _same_array(kmer.np_unpack_bases(km_l, cfg), codes)
    assert kmer.decode_codes(codes[:3]) == jkmer.decode_codes(codes[:3])
    for v in km[:50].tolist():
        assert kmer.int_to_codes(v, k).tobytes() == jkmer.int_to_codes(
            v, k).tobytes()
        assert kmer.kmer_to_int(kmer.int_to_codes(v, k)) == v
        assert kmer.py_revcomp(v, k) == jkmer.py_revcomp(v, k)
        assert kmer.py_is_canonical(v) == jkmer.py_is_canonical(v)
        assert kmer.successors(v, k) == jkmer.successors(v, k)
        assert kmer.predecessors(v, k) == jkmer.predecessors(v, k)
        for b in range(4):
            assert kmer.extend_kmer(v, b) == jkmer.extend_kmer(v, b)
            assert kmer.append_kmer(v, b, k) == jkmer.append_kmer(v, b, k)
            assert kmer.prepend_kmer(v, b, k) == jkmer.prepend_kmer(v, b, k)


def _limbs_by_passes(keys, L):
    """The uint64 shift-and-mask conversion (the reference the byte view
    must equal)."""
    u = keys.astype(np.uint64)
    out = np.empty((len(keys), L), dtype=np.uint32)
    for l in range(L):
        out[:, L - 1 - l] = (u >> np.uint64(32 * l)) & np.uint64(0xFFFFFFFF)
    out[keys == limbs.SENTINEL] = np.uint32(0xFFFFFFFF)
    return out


@pytest.mark.parametrize("L", [1, 2])
def test_fast_limb_views_match(L):
    """`keys_to_limbs` (a view of the int64 halves, on the keys' device),
    `to_limbs` and `from_limbs` (the same view on the host) equal the
    uint64 shift-and-mask conversion, sentinels and empty arrays
    included, and the Python-int helpers equal `cbl_tpu.limbs`'."""
    rng = np.random.default_rng(L)
    hi = 0xFFFFFFFF if L == 1 else limbs.SENTINEL  # the sentinel row
    keys = rng.integers(0, hi, size=5000, dtype=np.int64)
    keys[:3] = [0, hi - 1, 1 << 31]
    want = _limbs_by_passes(keys, L)
    got = limbs.keys_to_limbs(torch.from_numpy(keys), L).numpy()
    _same_array(got.view(np.uint32), want)
    _same_array(limbs.keys_to_limbs(torch.from_numpy(keys[:0]), L).numpy()
                .view(np.uint32), want[:0])
    padded = np.concatenate([keys, [limbs.SENTINEL] * 3])
    _same_array(limbs.to_limbs(padded, L), _limbs_by_passes(padded, L))
    _same_array(limbs.from_limbs(_limbs_by_passes(padded, L)), padded)
    _same_array(limbs.from_limbs(want[:0]), keys[:0])
    ints = limbs.to_py_ints(want)
    assert ints == jlimbs.to_py_ints(want) == keys.tolist()
    _same_array(limbs.from_py_ints(ints, L), jlimbs.from_py_ints(ints, L))
    assert limbs.to_py_ints(want[0]) == [ints[0]]
    with pytest.raises(ValueError):  # L from 1 to 4 (wide K) is taken
        limbs.keys_to_limbs(torch.from_numpy(keys), 5)
    if L == 2:  # above INT64_MAX, or INT64_MAX itself, is no key
        for bad in ([0x80000000, 0], [0x7FFFFFFF, 0xFFFFFFFF]):
            with pytest.raises(ValueError):
                limbs.from_limbs(np.array([bad], dtype=np.uint32))
