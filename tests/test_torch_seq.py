"""Parity of the port's sequence calls and ordered membership with
`cbl_tpu`.

The same numpy-seeded sequences go through `cbl_tpu.CBL` (JAX CPU
backend, its defaults) and `cbl_tpu_torch.CBL(device="cpu")`, plain and
canonical, at K=25 and K=13: the host helpers of the chunked pipeline
(`_stream_valid`, `_effective_chunk`, `_stream_chunks`), the chunk words
of `_pipeline_fn` against `_pipeline_words`, the states of the word sets
after every `insert_seq(s)` / `remove_seq(s)` (a small `pending_cap`, so
the log fills and folds), and the masks of `contains_seq(s)` /
`contains_codes_stream` element for element with the state they leave
behind: a pending log the call flushes, an active slog, an index with
holes (kept from 2^17 queries up, compacted below), and both sides of
`_SORTJOIN_MIN_QUERIES`, also lowered to 1 on both packages.  The
sort-join kernel runs under every pair of sort and merge modes against
numpy.  Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cbl_tpu
import cbl_tpu.cbl as jcbl
import cbl_tpu.wordset as jws
from cbl_tpu.wordset import DeviceWordSet as JaxWordSet
from cbl_tpu_torch import CBL, state
from cbl_tpu_torch import cbl as tcbl
from cbl_tpu_torch import wordset as tws
from cbl_tpu_torch.limbs import SENTINEL, from_limbs
from cbl_tpu_torch.ops import sort

torch.set_num_threads(2)

CAP = 8192  # pending_cap: two chunks of 4096
CHUNK = 4096
CONFIGS = {"k25": (25, False), "k25-canonical": (25, True),
           "k13": (13, False)}
every_config = pytest.mark.parametrize("k,canonical", list(CONFIGS.values()),
                                       ids=list(CONFIGS))
_ASCII = np.frombuffer(b"ACTG", dtype=np.uint8)


def _pair(k, canonical, chunk=CHUNK, pending_cap=CAP):
    kw = dict(k=k, prefix_bits=24, canonical=canonical, chunk_size=chunk,
              pending_cap=pending_cap)
    return cbl_tpu.CBL(**kw), CBL(device="cpu", **kw)


def _seq(rng, n, pool=None, dirty=False):
    """`n` ASCII bases; with `pool` the first half is a slice of it; with
    `dirty` some are lower case and some N (skipped by both packages)."""
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    if pool is not None:
        s = int(rng.integers(0, len(pool) - n // 2 + 1))
        codes[: n // 2] = pool[s:s + n // 2]
    raw = _ASCII[codes].copy()
    if dirty:
        raw[rng.random(n) < 0.1] += 32
        raw[rng.integers(0, n, size=max(n // 200, 1))] = ord("N")
    return raw.tobytes()


def _same_state(jidx, tidx, what=""):
    """Both word sets hold the same state, bit for bit: `data` row for
    row (holes where they stand), the flags and bounds, the pending log
    and the device count."""
    jw, tw = jidx.wordset, tidx.wordset
    names = ("n_pending", "_pending_rm", "_n_upper", "capacity", "_dups",
             "_holes", "pending_cap")
    assert ({n: getattr(tw, n) for n in names}
            == {n: getattr(jw, n) for n in names}), what
    assert tw.slog.keys is None and jw._slog is None, what
    np.testing.assert_array_equal(tw.data.numpy(),
                                  from_limbs(np.asarray(jw.data)),
                                  err_msg=str(what))
    pend, tags, _, _ = state.pending_to_arrays(tw)
    np.testing.assert_array_equal(pend, np.asarray(jw.pending))
    np.testing.assert_array_equal(tags, np.asarray(jw.pending_tags))
    assert (tw._n_dev is None) == (jw._n_dev is None), what
    if tw._n_dev is not None:
        assert int(tw._n_dev) == int(jw._n_dev), what


def _both(jidx, tidx, op, *args):
    """Call `op` on both indexes; equal results (masks element for
    element) and equal states after it.  -> the port's result."""
    got_j = getattr(jidx, op)(*args)
    got_t = getattr(tidx, op)(*args)
    if isinstance(got_t, list):
        assert len(got_t) == len(got_j), op
        for g, w in zip(got_t, got_j):
            assert g.dtype == np.bool_ and g.shape == np.shape(w), op
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=op)
    elif isinstance(got_t, np.ndarray):
        np.testing.assert_array_equal(got_t, np.asarray(got_j), err_msg=op)
    else:
        assert got_t == got_j, op
    _same_state(jidx, tidx, op)
    return got_t


def _records(rng, k):
    """(codes, offsets) of a multi-record stream with records shorter
    than K inside and at the end."""
    lens = [5000, 7, 3000, k, k - 1, 900, 3]
    codes = rng.integers(0, 4, size=sum(lens), dtype=np.uint8)
    return codes, np.cumsum([0] + lens).astype(np.int64)


@pytest.mark.parametrize("k", [25, 13])
def test_stream_helpers_match(k):
    rng = np.random.default_rng(k)
    codes, off = _records(rng, k)
    for chunk in (4096, 16384, 5000, tcbl.DEFAULT_CHUNK):
        j, t = _pair(k, False, chunk=chunk)
        for total in (0, 1, 4095, 4097, 70_000, 1 << 20):
            assert t._effective_chunk(total) == j._effective_chunk(total)
    j, t = _pair(k, False)
    for o in (off, off[:-1], off[:4], np.array([0, 40], dtype=np.int64)):
        c = codes[: o[-1]]
        np.testing.assert_array_equal(t._stream_valid(c, o),
                                      j._stream_valid(c, o))
        assert (t.pack_stream(c, o).n_kmers == j.pack_stream(c, o).n_kmers
                == max(len(c) - k + 1, 0))
    valid = j._stream_valid(codes, off)
    assert 0 < valid.sum() < len(valid)
    for chunk in (4096, 8192):
        got = list(t._stream_chunks(codes, valid, chunk))
        want = list(j._stream_chunks(codes, valid, chunk))
        assert len(got) == len(want) == -(-len(valid) // chunk)
        for (stream, vbits, n), w in zip(got, want):
            np.testing.assert_array_equal(stream, w[0])
            np.testing.assert_array_equal(vbits, w[1])
            assert n == w[3]


@pytest.mark.parametrize("chunk", [4096, 8192])
@every_config
def test_pipeline_words_match(k, canonical, chunk):
    """`_pipeline_fn` and `_pipeline_words` give the same words, chunk by
    chunk, invalid rows SENTINEL."""
    rng = np.random.default_rng(chunk + k + canonical)
    codes, off = _records(rng, k)
    j, t = _pair(k, canonical, chunk=chunk)
    valid = j._stream_valid(codes, off)
    fn = jcbl._pipeline_fn(j.cfg, canonical, chunk)
    n_sent = 0
    for stream, vbits, _, _ in j._stream_chunks(codes, valid, chunk):
        want = from_limbs(np.asarray(fn(stream, vbits)))
        got = tcbl._pipeline_words(
            torch.from_numpy(stream.astype(np.int64)),
            torch.from_numpy(vbits), chunk, t.cfg, canonical)
        np.testing.assert_array_equal(got.numpy(), want)
        n_sent += int((want == SENTINEL).sum())
    assert n_sent > 0


@every_config
def test_insert_remove_seqs_state_step_by_step(k, canonical):
    """Sequence inserts and removes fill the pending log by whole chunks,
    sentinel rows included, and fold it where `cbl_tpu` does: appends,
    an overflow fold without removes, one with removes, a remove batch
    larger than the log (applied at once) and `count()`."""
    rng = np.random.default_rng(40 + k + canonical)
    pool = rng.integers(0, 4, size=20_000, dtype=np.uint8)
    a, b, c, d = (_seq(rng, 5_000, pool, dirty=True) for _ in range(4))
    short = _seq(rng, k - 1)
    j, t = _pair(k, canonical)
    tw = t.wordset
    _both(j, t, "insert_seq", a)
    assert tw.n_pending == 2 * CHUNK and tw._n_upper == 0
    _both(j, t, "insert_seqs", [b, short, c[:3_000]])  # overflow: fold
    assert tw.n_pending == 2 * CHUNK and tw._n_upper > 0
    _both(j, t, "remove_seq", a[1_000:3_000])  # overflow: fold, append
    assert tw.n_pending == CHUNK and tw._pending_rm
    _both(j, t, "insert_seqs", [d])  # overflow: fold with removes
    _both(j, t, "remove_seqs", [b, c, short, d[:2_000]])  # > the log
    assert tw.n_pending == 0
    _both(j, t, "insert_seqs", [a, b])
    _both(j, t, "remove_seqs", [c[:500]])
    n = _both(j, t, "count")
    assert 0 < n < 3 * 5_000


@every_config
def test_contains_masks_and_states(k, canonical):
    """Masks element for element, records shorter than K and invalid
    bytes included, below the threshold (chunked pipeline) and above it
    (fused slabs), with a pending log that the call flushes."""
    rng = np.random.default_rng(60 + k + canonical)
    j, t = _pair(k, canonical)
    ins = [_seq(rng, 6_000, dirty=True) for _ in range(3)]
    _both(j, t, "insert_seqs", ins[:2])
    qs = [ins[0][:2_000], ins[1][:1_500] + _seq(rng, 1_500, dirty=True),
          _seq(rng, 900), ins[1][3_000:]]
    masks = _both(j, t, "contains_seqs", qs)  # flushes the log
    assert masks[0].all() and 0 < masks[1].sum() < len(masks[1])
    oracle = k == 25  # random 13-mers may meet the index by chance
    assert not (oracle and masks[2].any())
    _both(j, t, "insert_seqs", [ins[2]])
    _both(j, t, "remove_seqs", [ins[0][:3_000]])  # overflow: fold first
    assert t.wordset.n_pending > 0 and t.wordset._pending_rm
    codes = np.concatenate([t._codes_of(s) for s in qs + [ins[2]]]
                           + [np.zeros(k - 2, dtype=np.uint8)])
    lens = [len(t._codes_of(s)) for s in qs + [ins[2]]] + [k - 2]
    off = np.cumsum([0] + lens).astype(np.int64)
    masks = _both(j, t, "contains_codes_stream", codes, off)
    assert t.wordset.n_pending == 0 and len(masks[-1]) == 0
    assert not oracle or (masks[-2].all() and not masks[0][:1_000].any())
    assert _both(j, t, "contains_seq", ins[2]).all() or not oracle
    if (k, canonical) == (25, False):
        return  # its fused slab: test_holes_index_kept_from_threshold_up
    # above the threshold: one fused slab of 2^18 k-mers
    big = np.concatenate([codes, rng.integers(0, 4, size=140_000,
                                              dtype=np.uint8)])
    off_big = np.append(off, len(big))
    assert len(big) - k + 1 >= tws._SORTJOIN_MIN_QUERIES
    masks_big = _both(j, t, "contains_codes_stream", big, off_big)
    for m, m_big in zip(masks, masks_big):
        np.testing.assert_array_equal(m, m_big)


def test_contains_after_rounds_and_threshold_one(monkeypatch):
    """An active sorted log is folded by the contains call; with
    `_SORTJOIN_MIN_QUERIES` at 1 on both packages a small stream takes
    the fused sort-join and a point query the word sort-join, with the
    same masks and states as the default dispatch."""
    rng = np.random.default_rng(7)
    j, t = _pair(25, False)
    one = lambda s: (t._codes_of(s), np.array([0, len(t._codes_of(s))]))
    a, b, c = (_seq(rng, 5_000) for _ in range(3))
    for idx in (j, t):
        idx.insert_codes_stream(*one(a))
        idx.dynamic_round(one(b), one(a), one(c[:2_000]))
    assert t.wordset.slog.keys is not None
    qs = [a[:3_000], b, _seq(rng, 2_000), c]
    want = _both(j, t, "contains_seqs", qs)
    assert t.wordset.slog.keys is None
    assert want[0].all() and want[1].all() and not want[2].any()
    _both(j, t, "remove_seqs", [a[2_000:4_000]])
    codes = t._codes_of(a)
    kmers = [int(v) for v in rng.integers(0, 1 << 50, size=50)]
    kmers += [sum(int(x) << 2 * (24 - i) for i, x in
                  enumerate(codes[p:p + 25])) for p in (0, 2_100, 4_500)]
    monkeypatch.setattr(jws, "_SORTJOIN_MIN_QUERIES", 1)
    monkeypatch.setattr(tws, "_SORTJOIN_MIN_QUERIES", 1)
    point = _both(j, t, "contains_kmers", kmers)  # the log stays
    assert t.wordset.n_pending > 0
    assert point[-3:].tolist() == [True, False, True]
    got = _both(j, t, "contains_seqs", qs)
    assert t.wordset.n_pending == 0
    assert got[1].all() and not got[0][2_000:2_976].any()
    assert got[0][:2_000].all() and got[0][2_976:].all()


def _holes_pair(pool):
    """(jax index, port index) holding the port's `a - b` (an index with
    holes) carried into `cbl_tpu` as it stands; default chunk size."""
    t = {n: CBL(k=25, device="cpu", pending_cap=CAP) for n in "ab"}
    for n, (lo, hi) in zip("ab", ((0, 20_000), (8_000, 30_000))):
        c = pool[lo:hi]
        t[n].insert_codes_stream(c, np.array([0, len(c)]))
    h = t["a"] - t["b"]
    assert h.wordset._holes
    words, n, flags = state.wordset_to_arrays(h.wordset)
    new = JaxWordSet(h.cfg, CAP)
    new.data, new.capacity = jnp.asarray(words), words.shape[0]
    new._holes, new._dups = flags["holes"], flags["dups"]
    new._n_upper = flags["n_upper"]
    new._set_count(jnp.int32(n))
    j = cbl_tpu.CBL(k=25, pending_cap=CAP)
    j.wordset = new
    return j, h


def test_holes_index_kept_from_threshold_up():
    """On an index with holes a contains batch of 2^17 chunk rows or a
    fused slab leaves the holes; a smaller batch compacts first, in both
    packages; the masks agree with a Python set throughout."""
    rng = np.random.default_rng(5)
    pool = rng.integers(0, 4, size=30_000, dtype=np.uint8)
    j, t = _holes_pair(pool)
    _same_state(j, t, "carried")
    data = t.wordset.data
    kmers = lambda lo, hi: {_ASCII[pool[i:i + 25]].tobytes()
                            for i in range(lo, hi - 24)}
    a_minus_b = kmers(0, 20_000) - kmers(8_000, 30_000)
    mid = np.concatenate([pool[:10_000],
                          rng.integers(0, 4, size=90_000, dtype=np.uint8)])
    q = _ASCII[mid].tobytes()
    assert t._effective_chunk(len(q) - 24) == tws._SORTJOIN_MIN_QUERIES
    m = _both(j, t, "contains_seq", q)  # one chunk of 2^17 rows
    assert t.wordset._holes and t.wordset.data is data
    want = [q[i:i + 25] in a_minus_b for i in range(len(q) - 24)]
    assert m.tolist() == want and 0 < sum(want) < len(want)
    big = np.concatenate([mid, rng.integers(0, 4, size=40_000,
                                            dtype=np.uint8)])
    m_big = _both(j, t, "contains_codes_stream", big,
                  np.array([0, len(big)]))[0]  # a fused slab
    assert t.wordset._holes and t.wordset.data is data
    np.testing.assert_array_equal(m_big[: len(m)], m)
    m_small = _both(j, t, "contains_seq", q[:3_000])
    assert not t.wordset._holes  # compacted for the binary search
    np.testing.assert_array_equal(m_small, m[: len(m_small)])


@every_config
def test_short_sequences_and_contains_all(k, canonical):
    rng = np.random.default_rng(80 + k)
    j, t = _pair(k, canonical)
    seq = _seq(rng, 3_000)
    _both(j, t, "insert_seq", seq)
    short = seq[: k - 1]
    for op in ("insert_seq", "remove_seq", "contains_seq", "contains_all"):
        for idx in (j, t):
            with pytest.raises(ValueError, match=(
                    rf"^Sequence size \({k - 1}\) is smaller than K \({k}\)$")):
                getattr(idx, op)(short)
    for idx in (j, t):
        with pytest.raises(ValueError, match="is smaller than K"):
            idx.contains_seqs([seq, short])
    # raw length >= K, fewer than K valid bases: nothing to do, all True
    mostly_n = seq[: k - 3] + b"NNNN"
    _both(j, t, "insert_seq", mostly_n)
    assert _both(j, t, "contains_seq", mostly_n).shape == (0,)
    assert _both(j, t, "contains_all", mostly_n) is True
    assert _both(j, t, "contains_seqs", []) == []
    _both(j, t, "insert_seqs", [short, short])  # dropped
    assert _both(j, t, "contains_all", seq) is True
    other = _seq(rng, 500)
    _both(j, t, "insert_seqs", [other[:200]])  # logged: a log join
    assert _both(j, t, "contains_all", other[:200]) is True
    assert _both(j, t, "contains_all", other) is False
    assert t.wordset.n_pending > 0  # contains_all never flushes


@pytest.mark.parametrize("k", [25, 13])
def test_count_hits(k):
    rng = np.random.default_rng(k)
    j, t = _pair(k, False)
    seq = _seq(rng, 6_000)
    for idx in (j, t):
        idx.insert_seq(seq)
    q = [seq[1_000:4_000] + _seq(rng, 1_000)]
    words = next(t._seqs_words(q))[0]
    jwords = next(j._seqs_words(q))[0]
    assert t.wordset.n_pending > 0
    got = t.wordset.count_hits(words)  # joins index and log
    assert isinstance(got, int)
    assert got == int(t.wordset.count_hits_device(words))
    assert got == j.wordset.count_hits(jwords) >= 3_000 - k + 1


def test_chunk_size_invariance():
    """4096- and 16384-k-mer chunks and the fused stream path build the
    same keys; the 4096 build equals `cbl_tpu`'s state."""
    rng = np.random.default_rng(8)
    seq = _seq(rng, 40_000)
    j, a = _pair(25, False)
    b = CBL(k=25, device="cpu", chunk_size=16384)
    c = CBL(k=25, device="cpu")
    _both(j, a, "insert_seq", seq)
    b.insert_seq(seq)
    codes = c._codes_of(seq)
    c.insert_codes_stream(codes, np.array([0, len(codes)]))
    _both(j, a, "count")
    keys = []
    for idx in (a, b, c):
        ws = idx.wordset
        assert idx.count() == a.count() > 0
        ws._dedup()
        keys.append(ws.data[: ws.n])
    assert torch.equal(keys[0], keys[1]) and torch.equal(keys[0], keys[2])
    assert a._like(a.wordset).chunk == 4096


@pytest.mark.parametrize("merge_mode", sort.MERGE_MODES)
@pytest.mark.parametrize("sort_mode", sort.SORT_MODES)
def test_sortjoin_kernel_modes(sort_mode, merge_mode):
    """`_contains_sortjoin_kernel` on a contiguous index with duplicate
    keys and on one with holes, in every pair of modes (plain versions),
    against numpy, and its sorted rows (`_sortjoin_rows`) against a
    numpy lexsort; queries with duplicates and sentinels."""
    rng = np.random.default_rng(3)
    vocab = rng.integers(0, 1 << 40, size=3_000)
    data = np.sort(np.concatenate([vocab[:2_000], vocab[:300]]))
    data = np.concatenate([data, np.full(1_796, SENTINEL)])
    holes = np.unique(vocab[:2_000])
    holes = np.insert(holes, rng.integers(0, len(holes), size=500), SENTINEL)
    q = vocab[rng.integers(0, 3_000, size=5_000)]
    q[::37] = SENTINEL
    want = np.isin(q, vocab[:2_000]) & (q != SENTINEL)
    with sort.use_sort_mode(sort_mode), sort.use_merge_mode(merge_mode):
        for d, h in ((data, False), (data, True), (holes, True)):
            got = tws._contains_sortjoin_kernel(
                torch.from_numpy(d), torch.from_numpy(q), holes=h)
            np.testing.assert_array_equal(got.numpy(), want)
            words, pos = tws._sortjoin_rows(
                torch.from_numpy(d), torch.from_numpy(q), holes=h)
            w = np.concatenate([d, q])
            p = np.concatenate([np.full(len(d), len(q)), np.arange(len(q))])
            order = np.lexsort((p, w))
            np.testing.assert_array_equal(words.numpy(), w[order])
            np.testing.assert_array_equal(pos.numpy(), p[order])
        empty = tws._contains_sortjoin_kernel(
            torch.from_numpy(data), torch.full((7,), SENTINEL), holes=False)
        assert empty.shape == (7,) and not empty.any()
