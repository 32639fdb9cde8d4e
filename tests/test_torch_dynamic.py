"""Parity of the port's interleaved dynamic rounds with `cbl_tpu`.

The same record streams, made with numpy.random.default_rng, go through
`cbl_tpu.CBL.dynamic_round` (JAX CPU backend) and
`cbl_tpu_torch.CBL(device="cpu").dynamic_round`.  After every round the
two must agree on (total, positive), `count()`, the log's seq and
real-row bounds and the log itself (`cbl_tpu`'s columns converted with
`state.slog_from_arrays`): in plain and canonical mode, on an empty and
on a built index, with queries of the active log between rounds, across
the fold at the seq cap of 62 (with a remove at seq 62) and the
autofold, at K=25 and K=7 (one limb), and after `flush()` with a static
query; one round at K=27, over the log with a tag column
(`tests/test_torch_slog_tag.py` holds that layout).  Every comparison is
exact integer equality.  A fold frees the words it reads off the log
before its compaction sort.
"""

import numpy as np
import pytest
import torch

import cbl_tpu
from cbl_tpu_torch import CBL, state
from cbl_tpu_torch.limbs import from_limbs
from cbl_tpu_torch.wordset import _SLOG_SEQ_MAX

torch.set_num_threads(2)


def _pair(k=25, prefix_bits=24, canonical=False):
    return (cbl_tpu.CBL(k=k, prefix_bits=prefix_bits, canonical=canonical),
            CBL(k=k, prefix_bits=prefix_bits, canonical=canonical,
                device="cpu"))


def _jax_slog(jidx):
    """`cbl_tpu`'s active log as port keys (None when none is active)."""
    jw = jidx.wordset
    if jw._slog is None:
        return None
    cols = tuple(np.asarray(c) for c in jw._slog)
    return state.slog_from_arrays(cols, jw._slog_seq, jw._slog_real,
                                  jw._n_upper, jidx.cfg, "cpu").slog.keys[0]


def _assert_same_state(jidx, tidx):
    jw, tw = jidx.wordset, tidx.wordset
    assert tidx.count() == jidx.count()
    assert (tw.slog.seq, tw.slog.real, tw._n_upper) == (
        jw._slog_seq, jw._slog_real, jw._n_upper)
    want = _jax_slog(jidx)
    if want is None:
        assert tw.slog.keys is None
        np.testing.assert_array_equal(tw.data.numpy(),
                                      from_limbs(np.asarray(jw.data)))
    else:
        assert torch.equal(tw.slog.keys[0], want)


def _rounds(jidx, tidx, rounds):
    """Run (ins, qry, rm) rounds of (codes, offsets) tuples in both and
    compare after each; -> the (total, positive) list."""
    out = []
    for r, (ins, qry, rm) in enumerate(rounds):
        want = jidx.dynamic_round(ins, qry, rm)
        got = tidx.dynamic_round(ins, qry, rm)
        assert got == want, r
        _assert_same_state(jidx, tidx)
        out.append(got)
    return out


def _one(codes):
    return codes, np.array([0, len(codes)], dtype=np.int64)


@pytest.mark.parametrize("canonical", [False, True])
def test_bench_rounds_match_jax(canonical):
    """`bench.py --mode dynamic`'s op stream at a small size, on
    PackedStreams (the sorted-words memo), with a query of the active log
    between rounds and a static query after `flush()`."""
    rng = np.random.default_rng(31 + canonical)
    segs_n, sb = 4, 5_000
    codes = rng.integers(0, 4, size=segs_n * sb, dtype=np.uint8)
    foreign = _one(np.concatenate([codes[2_000:6_000],
                                   rng.integers(0, 4, 3_000, np.uint8)]))
    jidx, tidx = _pair(canonical=canonical)
    streams = []
    for idx in (jidx, tidx):
        off1 = np.array([0, sb], dtype=np.int64)
        off_h = np.array([0, sb // 2], dtype=np.int64)
        streams.append((
            [idx.pack_stream(codes[i * sb:(i + 1) * sb], off1)
             for i in range(segs_n)],
            [idx.pack_stream(codes[i * sb:i * sb + sb // 2], off_h)
             for i in range(segs_n)]))
    for i in range(segs_n):
        res = []
        for idx, (segs, halves) in zip((jidx, tidx), streams):
            res.append(idx.dynamic_round(segs[i], segs[i - 1 if i else 0],
                                         halves[i]))
        assert res[1] == res[0]
        _assert_same_state(jidx, tidx)
        got = tidx.query_codes_stream(*foreign)
        assert got == jidx.query_codes_stream(*foreign)
        assert 0 < got[1] < got[0]
        assert tidx.wordset.slog.keys is not None  # queries never fold
    assert streams[1][0][1]._words  # the memo holds the sorted words
    t, p = tidx.dynamic_round(streams[1][0][0], streams[1][0][1],
                              streams[1][1][0], lazy=True)
    jidx.dynamic_round(streams[0][0][0], streams[0][0][1], streams[0][1][0])
    assert isinstance(p, torch.Tensor) and int(t) > int(p) > 0
    _assert_same_state(jidx, tidx)
    before = tidx.query_codes_stream(streams[1][0][2])
    jidx.wordset.flush()
    tidx.flush()
    assert tidx.wordset.slog.keys is None
    _assert_same_state(jidx, tidx)
    assert tidx.query_codes_stream(streams[1][0][2]) == before == \
        jidx.query_codes_stream(streams[0][0][2])
    assert tidx.query_codes_stream(*foreign) == \
        jidx.query_codes_stream(*foreign)


@pytest.mark.parametrize("canonical", [False, True])
def test_rounds_on_built_index_match_jax(canonical):
    """Rounds entered on an index built by `insert_codes_stream` (its keys
    become seq-0 inserts of the log), then a fold and a second entry."""
    rng = np.random.default_rng(41 + canonical)
    codes = rng.integers(0, 4, size=16_000, dtype=np.uint8)
    jidx, tidx = _pair(canonical=canonical)
    for idx in (jidx, tidx):
        idx.insert_codes_stream(*_one(codes[:6_000]))
    rounds = [
        (_one(codes[6_000:10_000]), _one(codes[3_000:9_000]),
         _one(codes[2_000:4_000])),
        (_one(codes[10_000:16_000]), _one(codes[:16_000]),
         _one(codes[8_000:12_000])),
    ]
    out = _rounds(jidx, tidx, rounds)
    assert all(0 < p < t for t, p in out)
    jidx.wordset.flush()
    tidx.flush()
    _assert_same_state(jidx, tidx)
    _rounds(jidx, tidx, [(_one(codes[:3_000]), _one(codes[:8_000]),
                          _one(codes[5_000:7_000]))])


def test_seq_cap_fold_and_remove_at_max_seq():
    """70 small rounds cross the seq cap of 62: both fold before round 63
    at the same point.  The round that runs at seq 62 removes a target
    word, and later rounds see it absent."""
    rng = np.random.default_rng(100)
    sb, k = 200, 25
    pool = rng.integers(0, 4, size=4 * sb, dtype=np.uint8)
    target = _one(rng.integers(0, 4, size=k, dtype=np.uint8))
    jidx, tidx = _pair()
    for idx in (jidx, tidx):
        idx.insert_codes_stream(*target)
    rounds, seqs = [], []
    for r in range(70):
        s0 = (r * 37) % (3 * sb)
        ins = _one(pool[s0:s0 + sb])
        at_max = r == _SLOG_SEQ_MAX - 1
        rm = target if at_max else _one(pool[s0 // 2:s0 // 2 + sb])
        qry = target if r > _SLOG_SEQ_MAX - 1 else _one(pool[:sb])
        res = _rounds(jidx, tidx, [(ins, qry, rm)])
        rounds.append(res[0])
        seqs.append(tidx.wordset.slog.seq)
        if at_max:
            assert seqs[-1] == _SLOG_SEQ_MAX
    assert max(seqs) == _SLOG_SEQ_MAX and seqs[_SLOG_SEQ_MAX] == 1
    assert all(r == (1, 0) for r in rounds[_SLOG_SEQ_MAX:])


def test_autofold_matches_jax():
    """A remove-heavy workload (removes of absent words) grows the log
    past 4x the live bound: both fold in the same rounds."""
    rng = np.random.default_rng(22)
    sb = 4_000
    codes = rng.integers(0, 4, size=sb, dtype=np.uint8)
    miss = rng.integers(0, 4, size=4 * sb, dtype=np.uint8)
    jidx, tidx = _pair()
    seqs = []
    for _ in range(8):
        _rounds(jidx, tidx, [(_one(codes), _one(codes), _one(miss))])
        seqs.append(tidx.wordset.slog.seq)
    assert any(b <= a for a, b in zip(seqs, seqs[1:]))  # an autofold
    assert tidx.count() == jidx.count() > 0


def test_single_limb_rounds_match_jax():
    """K=7 with 13 prefix bits: 18-bit words, one limb in `cbl_tpu`."""
    rng = np.random.default_rng(55)
    sb = 600
    codes = rng.integers(0, 4, size=3 * sb, dtype=np.uint8)
    jidx, tidx = _pair(k=7, prefix_bits=13)
    assert jidx.cfg.word_limbs == 1
    rounds = []
    for r in range(3):
        q = max(r - 1, 0)
        rounds.append((_one(codes[r * sb:(r + 1) * sb]),
                       _one(codes[q * sb:(q + 1) * sb]),
                       _one(codes[r * sb // 2:r * sb // 2 + sb])))
    _rounds(jidx, tidx, rounds)
    jidx.wordset.flush()
    tidx.flush()
    _assert_same_state(jidx, tidx)


def test_slog_carried_across_from_jax():
    """Two rounds in `cbl_tpu`, the log carried into the port with
    `state.slog_from_arrays`, round 3 in both."""
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=12_000, dtype=np.uint8)
    jidx, tidx = _pair()
    jidx.dynamic_round(_one(codes[:4_000]), _one(codes[:4_000]),
                       _one(codes[1_000:3_000]))
    jidx.dynamic_round(_one(codes[4_000:8_000]), _one(codes[:6_000]),
                       _one(codes[5_000:7_000]))
    jw = jidx.wordset
    tidx.wordset = state.slog_from_arrays(
        tuple(np.asarray(c) for c in jw._slog), jw._slog_seq,
        jw._slog_real, jw._n_upper, jidx.cfg, "cpu")
    _assert_same_state(jidx, tidx)
    _rounds(jidx, tidx, [(_one(codes[8_000:]), _one(codes[2_000:10_000]),
                          _one(codes[:2_000]))])
    cols, seq, real, n_upper = state.slog_to_arrays(tidx.wordset)
    for a, b in zip(cols, jidx.wordset._slog, strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_unported_round_paths_raise():
    """Round paths that were refused once: a K=27 round (refused until the
    log with a tag column was ported) now runs over that log and matches
    `cbl_tpu`'s; rounds over streams of several slabs, or of none
    (refused until the pending log was ported), take the separate calls
    and match `cbl_tpu`'s."""
    codes = np.random.default_rng(3).integers(0, 4, size=9_000,
                                              dtype=np.uint8)
    j27, t27 = _pair(k=27)
    _rounds(j27, t27, [(_one(codes), _one(codes[:6_000]),
                        _one(codes[:3_000]))])
    # the word's column and a tag's
    assert t27.wordset.slog.keys[0].shape[0] == 2
    jidx, idx = _pair()
    multi = idx.pack_stream(*_one(codes), slab=4096)
    assert len(multi.slabs) == 3
    with pytest.raises(TypeError):
        idx.dynamic_round(codes, codes, codes)
    assert idx.wordset.slog.keys is None and idx.count() == 0
    half = _one(codes[2_000:6_000])
    got = idx.dynamic_round(multi, _one(codes), half)
    jidx.insert_codes_stream(*_one(codes))
    want = jidx.query_codes_stream(*_one(codes))
    jidx.remove_codes_stream(*half)
    assert got == want == (len(codes) - 24,) * 2
    assert idx.wordset.slog.keys is None and idx.wordset.n_pending > 0
    # a query stream too short for one k-mer has no slab
    got = idx.dynamic_round(_one(codes[:3_000]), _one(codes[:10]), half)
    jidx.insert_codes_stream(*_one(codes[:3_000]))
    jidx.remove_codes_stream(*half)
    assert got == (0, 0) and idx.wordset.slog.keys is None
    assert idx.query_codes_stream(*_one(codes)) == \
        jidx.query_codes_stream(*_one(codes))
    assert idx.count() == jidx.count() > 0


@pytest.mark.parametrize("k,prefix_bits", [(25, 24), (59, 28)])
def test_the_fold_frees_the_log_words_before_its_sort(k, prefix_bits,
                                                      monkeypatch):
    """The words a fold reads off the whole log (2^27 rows in the
    benchmark's windows) are freed before its compaction sort, where the
    windows' device memory peaks: only their marked copy lives on."""
    import weakref

    from cbl_tpu_torch import wordset as tws

    codes = np.random.default_rng(5).integers(0, 4, size=6_000,
                                              dtype=np.uint8)
    idx = CBL(k=k, prefix_bits=prefix_bits, device="cpu")
    idx.dynamic_round(_one(codes), _one(codes[:3_000]),
                      _one(codes[1_000:4_000]))
    made, alive = [], []
    slog_words, sort_rows = tws.slog_words, tws.sort_rows

    def words(log):
        w = slog_words(log)
        made.append(weakref.ref(w))
        return w

    def sort(rows):
        alive.append([r() is not None for r in made])
        return sort_rows(rows)

    monkeypatch.setattr(tws, "slog_words", words)
    monkeypatch.setattr(tws, "sort_rows", sort)
    idx.flush()
    assert alive == [[False]]
