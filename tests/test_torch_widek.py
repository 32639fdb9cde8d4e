"""Parity of the port at wide K (odd K from 29 to 59) with `cbl_tpu`.

Words of n_bits > 60 are two int64 columns in the port (`limbs`), k-mers
of 2K > 62 bits too, and the sorts and merges take a third column (a
tag, a position or a seqtag).  The same numpy-seeded inputs go through
`cbl_tpu` (JAX CPU backend) and `cbl_tpu_torch` on the CPU at K=29/24
(words of exactly 64 bits: `cbl_tpu` joins and marks with a tag
column), K=31/24 (62-bit k-mers, one column, 68-bit words), K=33/24 (the
first two-column k-mer, B1 wide) and K=59/28 (BASELINE config 3):

- the word pipeline (extraction, reverse complement, canonical form,
  necklace, packing, decoding, prefixes, base codes), plain and
  canonical, on random bases, poly-A, poly-T, (AC)* and records shorter
  than K, against `cbl_tpu`'s eager functions;
- the word set step by step (pending log with a small capacity, folds,
  joins, removes larger than the log, contains masks on both sides of
  `_SORTJOIN_MIN_QUERIES`, set algebra), against `cbl_tpu`'s word set fed
  the same words;
- the index end to end (`CBL` calls, one config a mode: the word
  pipeline test above covers both modes of each), its exports, `.npz` and
  `.cbl` bytes, stats, multi-slab rounds, and the states carried across
  the packages (`state`);
- the three-column plain sorts and merges against numpy's lexsort and,
  thinly, against the interpret-mode Pallas kernels at L+1 columns.

Every comparison is exact integer equality.  Single-slab `dynamic_round`
at K >= 27 runs over the log with a tag column, held against `cbl_tpu` in
`tests/test_torch_slog_tag.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cbl_tpu
from cbl_tpu import kmer as jkmer
from cbl_tpu import limbs as jlimbs
from cbl_tpu import necklace as jneck
from cbl_tpu import wordset as jws
from cbl_tpu.config import get_config as jget_config
from cbl_tpu.ops import merge_pallas, sort_pallas
from cbl_tpu_torch import CBL, interop, kmer, limbs, necklace, state
from cbl_tpu_torch import wordset as tws
from cbl_tpu_torch.config import get_config
from cbl_tpu_torch.limbs import SENTINEL, from_limbs, to_limbs
from cbl_tpu_torch.ops import bitonic, merge, sort

torch.set_num_threads(2)

CONFIGS = [(29, 24), (31, 24), (33, 24), (59, 28)]
CAP = 4096  # pending_cap: a 4096-row slab fits the log, a second folds it
# bases of a build: its slab pads to 8192 k-mers and its index to 8192
# rows, which still hold it with the log's rows after a fold, so that
# `cbl_tpu`'s pipeline programs (slow to trace at wide K) are shared by
# the calls and the tests of one configuration
BUILD_BASES = 5500


def _codes(seed: int, n: int) -> np.ndarray:
    """Random bases with a poly-A, a poly-T and an (AC)* run inside."""
    codes = np.random.default_rng(seed).integers(0, 4, size=n,
                                                 dtype=np.uint8)
    codes[n // 5:n // 5 + 150] = 0  # A
    codes[2 * n // 5:2 * n // 5 + 150] = 2  # T
    codes[3 * n // 5:3 * n // 5 + 150] = np.tile([0, 1], 75)  # (AC)*
    return codes


def _rows(keys, L) -> np.ndarray:
    """Port keys -> [N, L] uint32 limb rows."""
    return to_limbs(keys.numpy() if isinstance(keys, torch.Tensor)
                    else keys, L)


def _same(got: np.ndarray, want) -> None:
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --- the layout --------------------------------------------------------------


@pytest.mark.parametrize("L", [2, 3, 4])
def test_two_column_layout(L):
    """Two int64 columns (column 1 the low 63 bits) from and to
    `cbl_tpu`'s [N, L] limbs, sentinels, Python ints and the helpers on
    rows; a value above 125 bits is no word."""
    rng = np.random.default_rng(L)
    bits = {2: 64, 3: 96, 4: 125}[L]
    vals = [int(x) for x in rng.integers(0, 1 << 62, size=300)]
    vals = [(v << (bits - 62)) ^ int(rng.integers(0, 1 << 62))
            for v in vals] + [0, 1, (1 << bits) - 2, (1 << 63) - 1, 1 << 63]
    rows = jlimbs.from_py_ints(vals, L)
    _same(limbs.from_py_ints(vals, L), rows)
    assert limbs.to_py_ints(rows) == jlimbs.to_py_ints(rows) == vals
    keys = from_limbs(rows, 2)
    assert keys.shape == (2, len(vals)) and (keys >= 0).all()
    assert (keys[0] < 1 << 62).all() and (keys[1] < 1 << 63).all()
    _same(keys, limbs.ints_to_keys(vals, 2))
    padded = np.concatenate([rows, np.full((3, L), 0xFFFFFFFF, np.uint32)])
    back = from_limbs(padded, 2)
    assert (back[:, -3:] == SENTINEL).all()
    _same(to_limbs(back, L), padded)
    _same(limbs.keys_to_limbs(torch.from_numpy(keys), L).numpy()
          .view(np.uint32), rows)
    # lexicographic rows equal numeric order
    t = torch.from_numpy(keys)
    order = np.argsort(np.array(vals, dtype=object), kind="stable")
    s = limbs.stack(merge.sort_cols_plain(limbs.cols(t)))
    assert limbs.to_py_ints(_rows(s, L)) == [vals[i] for i in order]
    assert bool(limbs.rows_lt(t[:, :1], t[:, 1:2])) == (vals[0] < vals[1])
    assert limbs.searchsorted(s, t).tolist() == [
        sorted(vals).index(v) for v in vals]
    if L == 4:  # 126 bits: beyond any word
        with pytest.raises(ValueError, match="125 bits"):
            from_limbs(jlimbs.from_py_ints([1 << 125], 4), 2)


def test_every_config_is_held():
    """Every valid configuration builds; the word's and the k-mer's
    columns follow n_bits and 2K."""
    for k in range(1, 60, 2):
        cfg = get_config(k, min(24, 2 * k - 1))
        limbs.check_config(cfg)
        assert limbs.key_cols(cfg) == (1 if cfg.n_bits <= 60 else 2)
        assert limbs.kmer_cols(cfg) == (1 if 2 * k <= 62 else 2)


# --- the word pipeline -------------------------------------------------------


def _jax_words(stream, n, cfg, canonical):
    jc = jget_config(cfg.k, cfg.prefix_bits)
    km = jkmer.extract_kmers(jnp.asarray(stream), n, jc)
    if canonical:
        km, _ = jkmer.canonicalize(km, jc)
    neck, pos = jneck.necklace_pos(km, jc)
    return km, neck, pos, jneck.pack_word(neck, pos, jc)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k,prefix_bits", CONFIGS)
def test_word_pipeline_matches_jax(k, prefix_bits, canonical):
    """Extraction, canonical form, the necklace (B1's plain version),
    packing, decoding and prefixes, against `cbl_tpu`'s eager functions
    on 2048 k-mers with poly-A, poly-T and (AC)* runs."""
    cfg = get_config(k, prefix_bits)
    jc = jget_config(k, prefix_bits)
    L = cfg.word_limbs
    n = 2048
    codes = _codes(k + canonical, (n + k - 1 + 15) // 16 * 16)
    packed = kmer.np_pack_stream(codes)
    stream = torch.from_numpy(packed.view(np.int32)).to(torch.int64) \
        & 0xFFFFFFFF
    jkm, jn, jp, jw = _jax_words(packed, n, cfg, canonical)
    km = kmer.extract_kmers(stream, n, cfg)
    assert km.dim() == limbs.kmer_cols(cfg)
    rc = kmer.revcomp(km, cfg)
    _same(_rows(rc, L), jkmer.revcomp(jkmer.extract_kmers(
        jnp.asarray(packed), n, jc), jc))
    if canonical:
        km, canon = kmer.canonicalize(km, cfg)
        assert canon.tolist() == np.asarray(jkmer.is_canonical(
            jkmer.extract_kmers(jnp.asarray(packed), n, jc))).tolist()
    _same(_rows(km, L), jkm)
    neck, pos = necklace.necklace_pos_auto(km, cfg)
    _same(_rows(neck, L), jn)
    _same(pos.numpy().astype(np.uint32), jp)
    words = necklace.pack_word(neck, pos, cfg)
    assert words.dim() == limbs.key_cols(cfg)
    _same(_rows(words, L), jw)
    _same(_rows(necklace.word_to_kmer(words, cfg), L),
          jneck.word_to_kmer(jw, jc))
    _same(necklace.np_word_to_kmer(np.asarray(jw), cfg),
          jneck.np_word_to_kmer(np.asarray(jw), jc))
    _same(necklace.word_prefix(words, cfg).numpy().astype(np.uint32),
          jneck.word_prefix(jw, jc))
    _same(kmer.unpack_bases(km, cfg).numpy(),
          jkmer.np_unpack_bases(np.asarray(jkm), jc))
    # python oracle on the special runs
    for i in (n // 5 * 0 + 3, 410, 820, 1230):
        v = limbs.to_py_ints(_rows(km[..., i:i + 1], L))[0]
        assert (limbs.to_py_ints(_rows(neck[..., i:i + 1], L))[0],
                int(pos[i])) == necklace.py_necklace_pos(v, 2 * k)


# --- the word set ------------------------------------------------------------


def _port_words(cfg, codes, canonical=False):
    """[n] or [2, n] word keys of every k-mer of `codes` (one record)."""
    n = len(codes) - cfg.k + 1
    pad = np.zeros((n + cfg.k - 1 + 15) // 16 * 16 + 16, dtype=np.uint8)
    pad[:len(codes)] = codes
    stream = torch.from_numpy(kmer.np_pack_stream(pad).view(np.int32)).to(
        torch.int64) & 0xFFFFFFFF
    km = kmer.extract_kmers(stream, n, cfg)
    if canonical:
        km, _ = kmer.canonicalize(km, cfg)
    return necklace.pack_word(*necklace.necklace_pos(km, cfg), cfg)


def _same_wordset(jw, tw):
    """Both word sets hold the same state: data, pending log, counters."""
    assert (tw.n_pending, tw._pending_rm, tw._n_upper, tw.capacity,
            tw._dups, tw._holes, tw.pending_cap) == (
        jw.n_pending, jw._pending_rm, jw._n_upper, jw.capacity, jw._dups,
        jw._holes, jw.pending_cap)
    _same(tw.data.numpy(), from_limbs(np.asarray(jw.data), tw._cols))
    pend, tags, n_pending, rm = state.pending_to_arrays(tw)
    _same(pend, jw.pending)
    _same(tags, jw.pending_tags)
    assert (tw._n_dev is None) == (jw._n_dev is None)
    if tw._n_dev is not None:
        assert int(tw._n_dev) == int(jw._n_dev)


@pytest.mark.parametrize("k,prefix_bits", CONFIGS)
def test_wordset_steps_match_jax(monkeypatch, k, prefix_bits):
    """The same word batches (plain and canonical) through both word sets,
    the state compared after every step: inserts that fit the log, a
    remove, joins with the log, contains masks with the log on both sides
    of `_SORTJOIN_MIN_QUERIES`, a fold, a remove larger than the log, an
    insert larger than the log, export."""
    cfg = get_config(k, prefix_bits)
    L = cfg.word_limbs
    a = _port_words(cfg, _codes(k, 3000))
    b = _port_words(cfg, _codes(k + 1, 3000), canonical=True)
    big = _port_words(cfg, _codes(k + 2, 6000))
    q = torch.cat([a[..., :1000], b[..., 500:1500], big[..., :800]], dim=-1)
    q[..., 7] = SENTINEL
    jw = jws.DeviceWordSet(jget_config(k, prefix_bits), pending_cap=CAP)
    tw = tws.DeviceWordSet(cfg, "cpu", pending_cap=CAP)

    def step(op, x=None):
        jx = None if x is None else jnp.asarray(_rows(x, L))
        out = []
        for ws, arg in ((jw, jx), (tw, x)):
            fn = getattr(ws, op)
            r = fn() if arg is None else fn(arg)
            if op == "contains_words":
                r = np.asarray(r).tolist()
            out.append(r)
        assert out[0] == out[1], op
        _same_wordset(jw, tw)
        return out[1]

    step("insert_words", a)  # fits the log
    step("insert_words", b)
    step("remove_words", a[..., :1000])
    assert step("count_hits", q) > 0
    for floor in (1 << 17, 1):  # both sides of the sort-join threshold
        monkeypatch.setattr(jws, "_SORTJOIN_MIN_QUERIES", floor)
        monkeypatch.setattr(tws, "_SORTJOIN_MIN_QUERIES", floor)
        hits = step("contains_words", q)
        assert any(hits) and not all(hits) and not hits[7]
    step("flush")
    assert step("count") > 0
    step("remove_words", big)  # larger than the log: at once
    step("insert_words", big)  # larger than the log: merged at once
    assert step("count_hits", q) > 0
    step("contains_words", q)
    _same(tw.words_array(), jw.words_array())
    _same(tw.prefixes(), jw.prefixes())
    chunks = list(tw.iter_words_chunks(1000))
    _same(np.concatenate(chunks), jw.words_array())


# --- the index end to end ----------------------------------------------------


def _pair(k, prefix_bits, canonical, **kw):
    return (cbl_tpu.CBL(k=k, prefix_bits=prefix_bits, canonical=canonical,
                        **kw),
            CBL(k=k, prefix_bits=prefix_bits, canonical=canonical,
                device="cpu", **kw))


def _same_index(j, t):
    _same_wordset(j.wordset, t.wordset)
    assert t.count() == j.count()
    _same(t.wordset.words_array(), j.wordset.words_array())


@pytest.mark.parametrize("k,prefix_bits,canonical", [
    (29, 24, False), (31, 24, True), (33, 24, False), (59, 28, True)])
def test_index_matches_jax(monkeypatch, tmp_path, k, prefix_bits,
                           canonical):
    """`CBL` calls in both packages with a small pending log: a build of
    records (one shorter than K), queries, an insert and a remove through
    the log, contains masks on both sides of `_SORTJOIN_MIN_QUERIES`,
    `insert_seqs` / `remove_seqs`, point operations, exports, stats,
    `.npz` and `.cbl` bytes, and the states carried across."""
    j, t = _pair(k, prefix_bits, canonical, pending_cap=CAP)
    codes = _codes(k, BUILD_BASES)
    off = np.array([0, 2500, 2500 + k - 3, BUILD_BASES], dtype=np.int64)
    q = np.concatenate([codes[1000:2200], _codes(k + 5, 700)])
    qoff = np.array([0, 1200, 1900], dtype=np.int64)
    for idx in (j, t):
        idx.insert_codes_stream(codes, off)
    assert t.query_codes_stream(q, qoff) == j.query_codes_stream(q, qoff)
    _same_index(j, t)
    for idx in (j, t):
        idx.insert_codes_stream(q, qoff)  # into the log
        idx.remove_codes_stream(codes[:600], np.array([0, 600]))
    assert t.query_codes_stream(q, qoff) == j.query_codes_stream(q, qoff)
    _same_wordset(j.wordset, t.wordset)
    for floor in (1 << 17, 1):
        monkeypatch.setattr(jws, "_SORTJOIN_MIN_QUERIES", floor)
        monkeypatch.setattr(tws, "_SORTJOIN_MIN_QUERIES", floor)
        for got, want in zip(t.contains_codes_stream(q, qoff),
                             j.contains_codes_stream(q, qoff),
                             strict=True):
            _same(got, want)
    _same_index(j, t)
    seqs = [codes[:700], q[:1200], codes[:k - 1]]
    for idx in (j, t):
        idx.insert_seqs(seqs)
        idx.remove_seqs(seqs[:1])
    _same_wordset(j.wordset, t.wordset)
    _same(t.kmers_limbs(), j.kmers_limbs())  # both fold and deduplicate
    kms = jlimbs.to_py_ints(j.kmers_limbs()[:5]) + [0, 1, (1 << 2 * k) - 1]
    held = j.contains_kmers(kms).tolist()
    assert t.contains_kmers(kms).tolist() == held
    for idx in (j, t):  # batches of one size: one compile in `cbl_tpu`
        idx.remove_kmers(kms[:2] * 4)
        idx.insert_kmers(kms[-3:] * 2 + kms[-2:])
    held = j.contains_kmers(kms).tolist()
    assert t.contains_kmers(kms).tolist() == held
    _same_index(j, t)
    # the single-k-mer calls on the port: absent, then present
    x = next(v for v, h in zip(kms, held, strict=True) if not h)
    assert t.insert(x) and not t.insert(x)
    assert t.remove(x) and x not in t and kms[-1] in t
    _same(t.kmers_limbs(), j.kmers_limbs())
    assert list(t)[:50] == list(j)[:50]
    assert list(t.iter_nucs(chunk_rows=100))[:300] == list(
        j.iter_nucs())[:300]
    for name in ("prefix_load", "buckets_sizes", "buckets_size_count",
                 "buckets_load_repartition", "buckets_nodes",
                 "buckets_node_count"):
        assert getattr(t, name)() == getattr(j, name)(), name
    # files, both ways
    t.save_to_file(tmp_path / "t.npz")
    j.save_to_file(tmp_path / "j.npz")
    assert (tmp_path / "t.npz").read_bytes() == (tmp_path / "j.npz") \
        .read_bytes()
    back = CBL.load_from_file(tmp_path / "j.npz", device="cpu")
    jback = cbl_tpu.CBL.load_from_file(tmp_path / "t.npz")
    # (a loaded port index also sets its device count; `cbl_tpu` does not)
    _same(back.wordset.data.numpy(), from_limbs(np.asarray(
        jback.wordset.data), 2))
    assert back.count() == jback.count() == j.count()
    interop.save_reference(t, tmp_path / "t.cbl")
    from cbl_tpu import interop as jinterop
    jinterop.save_reference(j, tmp_path / "j.cbl")
    assert (tmp_path / "t.cbl").read_bytes() == (tmp_path / "j.cbl") \
        .read_bytes()
    ref = interop.load_reference(tmp_path / "j.cbl", k=k,
                                 prefix_bits=prefix_bits, device="cpu")
    _same(ref.wordset.words_array(), j.wordset.words_array())
    # the state carried to the port and back
    words, n, st = state.wordset_to_arrays(t.wordset)
    _same(words, np.asarray(j.wordset.data))
    carried = state.wordset_from_arrays(words, n, t.cfg, "cpu", **st)
    _same(carried.words_array(), j.wordset.words_array())


def test_dynamic_rounds_at_wide_k():
    """A single-slab round at K >= 27 runs over the log with a tag column
    (refused until that log was ported; `tests/test_torch_slog_tag.py`
    holds it against `cbl_tpu`): on an empty index it finds every k-mer it
    inserted, and its count equals the separate calls'.  A round over a
    stream of several slabs takes the separate calls and equals
    `cbl_tpu`'s calls on the same streams."""
    codes = _codes(7, BUILD_BASES)  # one slab of 8192 in `cbl_tpu`
    one = (codes, np.array([0, len(codes)], dtype=np.int64))
    half = (codes[2000:5000], np.array([0, 3000], dtype=np.int64))
    for k in (27, 29, 59):
        rounds = CBL(k=k, prefix_bits=24, device="cpu")
        calls = CBL(k=k, prefix_bits=24, device="cpu")
        n = len(codes) - k + 1
        assert rounds.dynamic_round(one, one, half) == (n, n)
        assert rounds.wordset.slog.keys[0].shape[0] == (2 if k == 27 else 3)
        calls.insert_codes_stream(*one)
        calls.remove_codes_stream(*half)
        assert rounds.count() == calls.count() > 0
    j, t = _pair(33, 24, False)
    multi = t.pack_stream(*one, slab=4096)
    assert len(multi.slabs) == 2
    half = (codes[2000:5000], np.array([0, 3000], dtype=np.int64))
    got = t.dynamic_round(multi, one, half)
    j.insert_codes_stream(*one)
    want = j.query_codes_stream(*one)
    j.remove_codes_stream(*half)
    assert got == want == (len(codes) - 32,) * 2
    assert t.count() == j.count()  # (the slabs fill the log otherwise)
    _same(t.wordset.words_array(), j.wordset.words_array())


@pytest.mark.parametrize("k,prefix_bits", [(29, 24), (59, 28)])
def test_set_algebra_at_wide_k(k, prefix_bits):
    """The four operations and `merge` / `intersect` under the nine
    (merge, sort) mode pairs: the port's results equal `cbl_tpu`'s (its
    defaults on the CPU, a sort of both sides and no merge kernel), state
    for state under the port's counterpart ("sort", "library") and word
    for word in the others.  At K=29 the marking operations sort in both
    packages (the word fills its limbs); K=59 runs canonical."""
    codes = _codes(k, BUILD_BASES + 2000)
    a_codes, b_codes = codes[:BUILD_BASES], codes[2000:]
    canonical = k == 59  # as `test_index_matches_jax`
    j_a, t_a = _pair(k, prefix_bits, canonical)
    j_b, t_b = _pair(k, prefix_bits, canonical)
    for (j, t), c in (((j_a, t_a), a_codes), ((j_b, t_b), b_codes)):
        for idx in (j, t):
            idx.insert_codes_stream(c, np.array([0, len(c)]))
    ops = (lambda x, y: x | y, lambda x, y: x & y, lambda x, y: x - y,
           lambda x, y: x ^ y, lambda x, y: type(x).merge([x, y]),
           lambda x, y: type(x).intersect([x, y]))
    want = [op(j_a, j_b) for op in ops]
    # the port's counterpart of `cbl_tpu`'s defaults first: the states are
    # compared before any `count()` tightens `_n_upper`
    pairs = [("sort", "library")] + [
        (m, s) for m in sort.MERGE_MODES for s in sort.SORT_MODES
        if (m, s) != ("sort", "library")]
    for merge_mode, sort_mode in pairs:
        with sort.use_merge_mode(merge_mode), sort.use_sort_mode(sort_mode):
            for op, w in zip(ops, want):
                got = op(t_a, t_b)
                if (merge_mode, sort_mode) == ("sort", "library"):
                    _same_wordset(w.wordset, got.wordset)
                assert got.count() == w.count()
                _same(got.wordset.words_array(), w.wordset.words_array())
    assert 0 < want[1].count() < want[0].count()


@pytest.mark.parametrize("k,prefix_bits", [(29, 24), (31, 24), (59, 28)])
def test_states_carry_both_ways(k, prefix_bits):
    """`cbl_tpu`'s index and pending log (L = 2, 3, 4) carried into the
    port answer as `cbl_tpu` does, and carried back equal its arrays."""
    canonical = k == 31 or k == 59  # as `test_index_matches_jax`
    j, _ = _pair(k, prefix_bits, canonical, pending_cap=CAP)
    codes = _codes(k + 9, BUILD_BASES)
    j.insert_codes_stream(codes, np.array([0, BUILD_BASES]))
    j.remove_codes_stream(codes[:1000], np.array([0, 1000]))
    jw = j.wordset
    assert jw.n_pending > 0
    tw = state.wordset_from_arrays(
        np.asarray(jw.data), int(jw._n_dev),
        get_config(k, prefix_bits), "cpu", holes=jw._holes, dups=jw._dups,
        n_upper=jw._n_upper)
    state.pending_from_arrays(tw, np.asarray(jw.pending),
                              np.asarray(jw.pending_tags), jw.n_pending,
                              jw._pending_rm)
    t = CBL(k=k, prefix_bits=prefix_bits, canonical=canonical, device="cpu",
            pending_cap=CAP)
    t.wordset = tw
    _same_wordset(jw, tw)
    q = (codes[500:2500], np.array([0, 2000]))
    assert t.query_codes_stream(*q) == j.query_codes_stream(*q)
    pend, tags, n_pending, rm = state.pending_to_arrays(tw)
    _same(pend, jw.pending)
    assert (n_pending, rm) == (jw.n_pending, jw._pending_rm)
    assert t.count() == j.count()
    _same_wordset(jw, tw)
    # a log in `cbl_tpu`'s layout for the config (the tag packed into the
    # limbs at K=31, a tag column at K=29 and 59) carried in and back
    n_cols = jw.L + (0 if jws.slog_packed(j.cfg) else 1)
    cols = (np.zeros(4, np.uint32),) * (n_cols - 1) + (
        np.array([1, 2, 3, 5], np.uint32),)
    ws = state.slog_from_arrays(cols, 1, 4, 4, get_config(k, prefix_bits),
                                "cpu")
    assert ws.slog.keys[0].shape == (3, 4) and ws.count() == 1
    back = state.slog_to_arrays(ws)
    assert back[1:] == (1, 4, 4)
    for a, b in zip(back[0], cols, strict=True):
        _same(a, b)


# --- three-column sorts and merges -------------------------------------------


def _cols3(rng, n, hi, sent=0.05):
    cols = [rng.integers(0, hi, size=n) for _ in range(3)]
    s = rng.random(n) < sent
    cols[0][s] = cols[1][s] = SENTINEL
    return tuple(torch.from_numpy(c) for c in cols)


def _lexsorted(cols):
    arrs = [c.numpy() for c in cols]
    order = np.lexsort(tuple(arrs[::-1]))
    return [a[order] for a in arrs]


@pytest.mark.parametrize("n", [1, 5, 4095, 4097, 20_000])
@pytest.mark.parametrize("hi", [3, 1 << 62])
def test_three_column_plain_versions_match_lexsort(n, hi):
    """The sort in each mode, B5's and B6's plain passes, and the merge in
    each mode (B3's and B7's plain versions) at three columns against
    numpy's lexsort."""
    rng = np.random.default_rng(n + hi % 7)
    x = _cols3(rng, n, hi)
    want = _lexsorted(x)
    outs = [merge.sort_mergepath_plain(x, tile=1024),
            bitonic.bitonic_sort_passes_plain(x, tile=1024)]
    for mode in sort.SORT_MODES:
        with sort.use_sort_mode(mode):
            outs.append(sort.sort_keys(x))
    a = merge.sort_cols_plain(tuple(c[: n // 3] for c in x))
    b = merge.sort_cols_plain(tuple(c[n // 3:] for c in x))
    outs.append(bitonic.bitonic_merge_tiled_plain(a, b, tile=256))
    for mode in sort.MERGE_MODES:
        with sort.use_merge_mode(mode):
            outs.append(sort.merge_sorted_pair(a, b))
    for got in outs:
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), w)


def test_three_column_plain_versions_match_pallas():
    """L+1 = 5 uint32 columns (a K=59 word and a tag) through the
    interpret-mode Pallas merge-path sort (one tile) and both Pallas
    merges, against the port's plain versions on the same rows as three
    int64 columns."""
    rng = np.random.default_rng(59)
    n = 1 << 10
    words = jlimbs.from_py_ints(
        [int(x) << 62 | int(y) for x, y in zip(
            rng.integers(0, 37, size=n), rng.integers(0, 5, size=n))], 4)
    tag = rng.integers(0, 3, size=n).astype(np.uint32)
    jcols = tuple(jnp.asarray(words[:, l]) for l in range(4)) + (
        jnp.asarray(tag),)
    keys = from_limbs(words, 2)
    tcols = (torch.from_numpy(keys[0]), torch.from_numpy(keys[1]),
             torch.from_numpy(tag.astype(np.int64)))

    def as_port(jc):
        w = from_limbs(np.stack([np.asarray(c) for c in jc[:4]], axis=1), 2)
        return np.stack([w[0], w[1], np.asarray(jc[4]).astype(np.int64)])

    def port(cols):
        return np.stack([c.numpy() for c in cols])

    want = as_port(merge_pallas.sort_cols_mergepath(jcols, t_log=10,
                                                    interpret=True))
    for got in (merge.sort_mergepath_plain(tcols, tile=256),
                bitonic.bitonic_sort_passes_plain(tcols, tile=256)):
        _same(port(got), want)
    # two sorted runs of 600 and 424 rows
    h = 600
    ta = merge.sort_cols_plain(tuple(c[:h] for c in tcols))
    tb = merge.sort_cols_plain(tuple(c[h:] for c in tcols))
    ja = _to_jax(ta)
    jb = _to_jax(tb)
    _same(as_port(merge_pallas.merge_sorted_cols(ja, jb, t_log=10,
                                                 interpret=True)), want)
    _same(as_port(sort_pallas.merge_cols_pallas(ja, jb, t_log=10,
                                                interpret=True)), want)
    for got in (merge.merge_sorted_plain(ta, tb),
                bitonic.bitonic_merge_tiled_plain(ta, tb, tile=128)):
        _same(port(got), want)


def _to_jax(cols):
    """Three int64 columns (a two-column word and a tag below 2^32) ->
    five uint32 columns (`cbl_tpu`'s four word limbs and the tag)."""
    w = to_limbs(np.stack([cols[0].numpy(), cols[1].numpy()]), 4)
    return tuple(jnp.asarray(w[:, l]) for l in range(4)) + (
        jnp.asarray(cols[2].numpy().astype(np.uint32)),)
