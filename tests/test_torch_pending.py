"""Step-by-step parity of the port's pending log and separate calls with
`cbl_tpu`.

The same numpy-seeded record streams and k-mers go through `cbl_tpu.CBL`
(JAX CPU backend) and `cbl_tpu_torch.CBL(device="cpu")`, plain and
canonical, at K=25 and K=7 (one limb), with a small `pending_cap` so that
a 4096-row slab fits the log, two fill it and a third overflows it.
After every step (insert into a non-empty index, remove that fits the
log, remove larger than the log, query with a pending log, `flush()`,
`count()`) the two must agree on the call's result and on the whole
state: `data` and the pending log converted with `limbs.from_limbs` /
`state.pending_to_arrays`, `n_pending`, `_pending_rm`, `_n_upper`,
`capacity`, the duplicates flag and the device count.  The core cases
run under both sort modes of the port.  Point operations are also held
against a Python set.  Every comparison is exact integer equality.
"""

import numpy as np
import pytest
import torch

import cbl_tpu
import cbl_tpu.cbl as jcbl
from cbl_tpu_torch import CBL, state
from cbl_tpu_torch import wordset as tws
from cbl_tpu_torch.limbs import SENTINEL, from_limbs, to_limbs
from cbl_tpu_torch.ops import sort

torch.set_num_threads(2)

CAP = 8192  # pending_cap: two 4096-row slabs


@pytest.fixture(params=sort.SORT_MODES)
def sort_mode(request):
    with sort.use_sort_mode(request.param):
        yield request.param


def _pair(k=25, prefix_bits=24, canonical=False, pending_cap=CAP):
    return (cbl_tpu.CBL(k=k, prefix_bits=prefix_bits, canonical=canonical,
                        pending_cap=pending_cap),
            CBL(k=k, prefix_bits=prefix_bits, canonical=canonical,
                device="cpu", pending_cap=pending_cap))


def _assert_same_state(jidx, tidx):
    """Both word sets hold the same state, bit for bit; nothing here
    folds a log or waits for a count that is not already there."""
    jw, tw = jidx.wordset, tidx.wordset
    assert (tw.n_pending, tw._pending_rm, tw._n_upper, tw.capacity,
            tw._dups, tw._holes, tw.pending_cap) == (
        jw.n_pending, jw._pending_rm, jw._n_upper, jw.capacity,
        jw._dups, jw._holes, jw.pending_cap)
    assert (tw.slog.keys is None) == (jw._slog is None)
    if tw.slog.keys is None:
        np.testing.assert_array_equal(tw.data.numpy(),
                                      from_limbs(np.asarray(jw.data)))
    pend, tags, n_pending, pending_rm = state.pending_to_arrays(tw)
    np.testing.assert_array_equal(pend, np.asarray(jw.pending))
    np.testing.assert_array_equal(tags, np.asarray(jw.pending_tags))
    assert (n_pending, pending_rm) == (jw.n_pending, jw._pending_rm)
    assert (tw._n_dev is None) == (jw._n_dev is None)
    if tw._n_dev is not None:
        assert int(tw._n_dev) == int(jw._n_dev)


def _steps(jidx, tidx, steps):
    """Run (op, args...) steps in both, compare each result and the state
    after it; -> the port's results."""
    out = []
    for i, (op, *args) in enumerate(steps):
        res = []
        for idx in (jidx, tidx):
            if op == "ins":
                res.append(idx.insert_codes_stream(*args))
            elif op == "rm":
                res.append(idx.remove_codes_stream(*args))
            elif op == "qry":
                res.append(idx.query_codes_stream(*args))
            elif op == "flush":
                res.append(idx.wordset.flush())
            elif op == "count":
                res.append(idx.count())
            else:
                raise ValueError(op)
        assert res[1] == res[0], (i, op)
        _assert_same_state(jidx, tidx)
        out.append(res[1])
    return out


def _stream(rng, n, pool=None):
    """(codes, offsets) of `n` bases in three records (one shorter than
    any K used here); with `pool`, half the bases are a slice of it."""
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    if pool is not None:
        s = int(rng.integers(0, len(pool) - n // 2 + 1))
        codes[: n // 2] = pool[s:s + n // 2]
    off = np.array([0, n // 3, n // 3 + 5, n], dtype=np.int64)
    return codes, off


@pytest.mark.parametrize("k,prefix_bits,canonical", [
    (25, 24, False), (25, 24, True), (7, 13, False),
])
def test_separate_calls_match_jax(sort_mode, k, prefix_bits, canonical):
    """Build, then insert / query / remove streams against the log: an
    insert that fits the log, queries of index + log with and without
    removes, a fold without removes (the next insert's flush), a fold
    with removes (`count()`), log overflow at a remove (flush first), a
    remove larger than the log (applied at once) and an insert larger
    than the log (merged at once)."""
    rng = np.random.default_rng(k + canonical)
    pool = rng.integers(0, 4, size=20_000, dtype=np.uint8)
    a, b, d, e = (_stream(rng, 3_000, pool) for _ in range(4))
    # c removes part of b; q asks for parts of a, b and c and fresh bases
    c = _stream(rng, 3_000, b[0])
    q = (np.concatenate([a[0][:1_000], b[0][:1_500], c[0][:1_000],
                         rng.integers(0, 4, size=500, dtype=np.uint8)]),
         np.array([0, 1_000, 2_500, 3_500, 4_000], dtype=np.int64))
    big = _stream(rng, 10_000, pool)  # 16384 rows > CAP
    jidx, tidx = _pair(k, prefix_bits, canonical)
    out = _steps(jidx, tidx, [
        ("ins", *a),        # empty index: sorted and adopted
        ("qry", *q),
        ("ins", *b),        # fits the log
        ("qry", *q),        # index + log, inserts only
        ("rm", *c),         # fits beside the insert; the log is full
        ("qry", *q),        # index + log with removes
        ("qry", *b),
        ("count",),         # fold with removes
        ("ins", *d),
        ("ins", *e),        # its flush folds d's log: no removes
        ("rm", *a),
        ("rm", *b),         # does not fit beside e and a: flush, append
        ("qry", *q),
        ("rm", *big),       # larger than the log: flush, remove at once
        ("qry", *q),
        ("ins", *big),      # larger than the log: merged at once
        ("qry", *big),
        ("flush",),
        ("qry", *q),
        ("count",),
    ])
    tw = tidx.wordset
    assert tw.n_pending == 0 and out[-1] > 0
    # the queries saw hits and misses, and the log changed the answers
    assert all(0 < p < t for t, p in (out[1], out[3], out[5]))
    assert out[1][1] < out[3][1] and out[5][1] < out[3][1]
    assert out[16][0] == out[16][1]  # everything just inserted is found


def test_query_never_folds_and_count_does(sort_mode):
    rng = np.random.default_rng(3)
    a, b, c = (_stream(rng, 3_000) for _ in range(3))
    jidx, tidx = _pair()
    _steps(jidx, tidx, [("ins", *a), ("ins", *b), ("rm", *c)])
    tw = tidx.wordset
    data = tw.data
    assert tw.n_pending == 2 * 4096 and tw._pending_rm
    _steps(jidx, tidx, [("qry", *b), ("qry", *c)])
    assert tw.n_pending == 2 * 4096 and tw.data is data
    n_dev = tidx.count_device()  # folds, does not wait
    assert tw.n_pending == 0 and int(n_dev) == jidx.count() == tidx.count()
    _assert_same_state(jidx, tidx)


def _words(rng, cfg, n, vocab=None):
    """[n] distinct-ish word keys below 2^n_bits, some from `vocab`."""
    w = rng.integers(0, 1 << cfg.n_bits, size=n).astype(np.int64)
    if vocab is not None:
        pick = rng.random(n) < 0.5
        w[pick] = vocab[rng.integers(0, len(vocab), size=int(pick.sum()))]
    return w


def _both_words(jidx, tidx, op, keys):
    """Call word-set method `op` on both with the same words."""
    import jax.numpy as jnp

    rows = to_limbs(keys, jidx.cfg.word_limbs)
    got_j = getattr(jidx.wordset, op)(jnp.asarray(rows))
    got_t = getattr(tidx.wordset, op)(torch.from_numpy(keys))
    return got_j, got_t


@pytest.mark.parametrize("k,prefix_bits", [(25, 24), (7, 13)])
def test_append_log_overflow_rules(sort_mode, k, prefix_bits):
    """`_append_log`'s three rules at the word-set level with a 64-row
    log: a batch larger than the log is applied at once (insert: merge;
    remove: the tagged-sort set operation), a batch that does not fit
    beside what is queued folds first, anything else appends."""
    rng = np.random.default_rng(k)
    jidx, tidx = _pair(k, prefix_bits, pending_cap=64)
    cfg = tidx.cfg
    vocab = _words(rng, cfg, 300)
    vocab[::50] = SENTINEL  # blanked rows ride along and are ignored
    for op, n in [("insert_words", 40), ("insert_words", 24),  # fills it
                  ("remove_words", 10),      # overflow: fold (no removes)
                  ("insert_words", 50),      # fits beside the removes
                  ("remove_words", 30),      # overflow: fold with removes
                  ("insert_words", 100),     # > log: flush, merge at once
                  ("remove_words", 200),     # > log: flush, remove at once
                  ("insert_words", 64), ("remove_words", 64)]:
        keys = vocab[rng.integers(0, len(vocab), size=n)]
        _both_words(jidx, tidx, op, keys)
        _assert_same_state(jidx, tidx)
    assert tidx.wordset.n_pending == 64 and tidx.wordset._pending_rm
    assert tidx.count() == jidx.count() > 0
    _assert_same_state(jidx, tidx)


def test_merge_into_ladder(sort_mode):
    """Every branch of `_merge_into`: a fresh index (sorted batch or not),
    merge with duplicates kept (sorted batch or not), and the
    sort-and-compact branch, which needs a batch far longer than its
    `n_new_upper` says; then `insert_rows_bulk` and `_dedup`."""
    import jax.numpy as jnp

    rng = np.random.default_rng(12)
    for first_sorted in (False, True):
        jidx, tidx = _pair()
        cfg, L = tidx.cfg, tidx.cfg.word_limbs
        jw, tw = jidx.wordset, tidx.wordset

        oracle = set()

        def merge_into(keys, n_new_upper, batch_sorted):
            oracle.update(set(keys.tolist()) - {SENTINEL})
            jw._merge_into(jnp.asarray(to_limbs(keys, L)), n_new_upper,
                           batch_sorted=batch_sorted)
            tw._merge_into(torch.from_numpy(keys), n_new_upper,
                           batch_sorted=batch_sorted)
            _assert_same_state(jidx, tidx)

        vocab = _words(rng, cfg, 6000)
        first = vocab[rng.integers(0, 3000, size=4096)]
        first[::40] = SENTINEL
        if first_sorted:
            first = np.sort(first)
        merge_into(first, 4096, first_sorted)               # fresh
        assert tw._dups
        merge_into(vocab[rng.integers(0, 6000, size=2000)], 2000, False)
        merge_into(np.sort(vocab[rng.integers(0, 6000, size=4096)]), 4096,
                   True)
        assert tw._dups and tw.data.shape[0] == 4096 + 2000 + 4096
        # live + batch > 2 * out_cap: compacted in the same step
        long_batch = vocab[rng.integers(0, 6000, size=5 * 8192)]
        merge_into(long_batch, 10, False)
        assert not tw._dups and tw.capacity == tw.data.shape[0] == 16384
        assert tidx.count() == jidx.count() == len(oracle)
        batches = [vocab[rng.integers(0, 6000, size=n)] for n in (700, 900)]
        jw.insert_rows_bulk([jnp.asarray(to_limbs(b, L)) for b in batches])
        tw.insert_rows_bulk([torch.from_numpy(b) for b in batches])
        _assert_same_state(jidx, tidx)
        tw.insert_rows_bulk([])
        jw._dedup()
        tw._dedup()
        _assert_same_state(jidx, tidx)
        assert not tw._dups
        valid = tw.data[tw.data != SENTINEL]
        assert len(torch.unique(valid)) == len(valid) == tidx.count()


def test_holes_branches_raise():
    """The branches that handle an index with holes (sentinel rows between
    the valid keys, as a set operation by merge leaves them), each next to
    `cbl_tpu`'s on the same hand-made state: an insert (one sort, holes
    again), a query by one tagged sort, a query against index and log, a
    membership query (compacts first), a remove at once.  Nothing raises
    any more; an unknown operation does."""
    import jax.numpy as jnp

    rng = np.random.default_rng(17)
    cfg = CBL(k=25, device="cpu").cfg
    keys = np.sort(rng.choice(1 << 40, size=3000, replace=False))
    data = np.full(4096, SENTINEL)
    data[:3000] = keys
    data[rng.random(4096) < 0.3] = SENTINEL  # holes where they fall
    n = int((data != SENTINEL).sum())
    words = np.concatenate([keys[::3], rng.integers(0, 1 << 40, size=500)])
    words[::11] = SENTINEL

    def holes_pair():
        jidx, tidx = _pair(pending_cap=64)
        jw, tw = jidx.wordset, tidx.wordset
        jw.data = jnp.asarray(to_limbs(data, cfg.word_limbs))
        tw.data = torch.from_numpy(data.copy())
        for ws, count in ((jw, jnp.int32(n)), (tw, torch.tensor(n))):
            ws._holes, ws._n_upper, ws.capacity = True, 3000, 4096
            ws._set_count(count)
        _assert_same_state(jidx, tidx)
        return jidx, tidx

    for call in ("merge", "hits", "log hits", "contains", "remove"):
        jidx, tidx = holes_pair()
        if call == "merge":
            jidx.wordset._merge_into(
                jnp.asarray(to_limbs(words, cfg.word_limbs)), len(words))
            tidx.wordset._merge_into(torch.from_numpy(words), len(words))
            assert tidx.wordset._holes and not tidx.wordset._dups
        elif call == "remove":
            _both_words(jidx, tidx, "_remove_now", words)
            assert not tidx.wordset._holes
        elif call == "contains":
            got_j, got_t = _both_words(jidx, tidx, "contains_words", words)
            np.testing.assert_array_equal(got_t.numpy(), np.asarray(got_j))
            present = set(data.tolist()) - {SENTINEL}
            assert got_t.tolist() == [int(w) in present for w in words]
            assert not tidx.wordset._holes  # compacted for the search
        else:
            if call == "log hits":
                _both_words(jidx, tidx, "insert_words", words[:40])
                _both_words(jidx, tidx, "remove_words", words[100:120])
            got_j, got_t = _both_words(jidx, tidx, "count_hits_device",
                                       words)
            assert int(got_t) == int(got_j) > 0
            assert tidx.wordset._holes  # a query never compacts
        _assert_same_state(jidx, tidx)
        assert tidx.count() == jidx.count()
    got, n_got = tws._setop_sort_kernel_packed(
        torch.from_numpy(data), torch.from_numpy(words), "inter", 4096)
    want = np.intersect1d(data, words[words != SENTINEL])
    assert int(n_got) == len(want) > 0
    np.testing.assert_array_equal(got[:len(want)].numpy(), want)
    with pytest.raises(ValueError, match="unknown set operation"):
        tws._setop_sort_kernel_packed(got, got, "nand", 4096)


def _kmers(rng, k, n):
    return [int(v) for v in rng.integers(0, 1 << (2 * k), size=n)]


def _stream_kmers(codes, off, k):
    """The k-mers of a record stream as a set of packed ints (first base
    most significant)."""
    out = set()
    for lo, hi in zip(off[:-1], off[1:]):
        for s in range(int(lo), int(hi) - k + 1):
            v = 0
            for c in codes[s:s + k]:
                v = (v << 2) | int(c)
            out.add(v)
    return out


@pytest.mark.parametrize("k,prefix_bits,canonical", [
    (25, 24, False), (25, 24, True), (7, 13, False),
])
def test_point_ops_match_jax_and_set(sort_mode, k, prefix_bits, canonical):
    """Interleaved `insert_kmers` / `remove_kmers` / `contains_kmers` and
    the single-k-mer calls on a built index, with no fold in between:
    masks equal `cbl_tpu`'s and, in plain mode, a Python set's."""
    rng = np.random.default_rng(k * 2 + canonical)
    jidx, tidx = _pair(k, prefix_bits, canonical, pending_cap=4096)
    base = _stream(rng, 2_000)
    _steps(jidx, tidx, [("ins", *base)])
    data = tidx.wordset.data
    universe = _kmers(rng, k, 400)
    oracle = _stream_kmers(*base, k)
    for step in range(6):
        ins = [universe[i] for i in rng.integers(0, 400, size=60)]
        rem = [universe[i] for i in rng.integers(0, 400, size=40)]
        for idx in (jidx, tidx):
            idx.insert_kmers(ins)
        oracle |= set(ins)
        probe = [universe[i] for i in rng.integers(0, 400, size=150)]
        want = np.asarray(jidx.contains_kmers(probe))
        got = tidx.contains_kmers(probe)
        np.testing.assert_array_equal(got, want)
        if not canonical:
            assert got.tolist() == [v in oracle for v in probe]
        for idx in (jidx, tidx):
            idx.remove_kmers(rem)
        oracle -= set(rem)
        np.testing.assert_array_equal(tidx.contains_kmers(probe),
                                      np.asarray(jidx.contains_kmers(probe)))
        _assert_same_state(jidx, tidx)
    x, y = universe[0], universe[1]
    for call in ("insert", "insert", "remove", "remove", "contains"):
        for v in (x, y):
            assert getattr(tidx, call)(v) == getattr(jidx, call)(v)
    assert (x in tidx) == (x in jidx) and not tidx.contains(x)
    oracle -= {x, y}
    tw = tidx.wordset
    assert tw.data is data and tw.n_pending == 6 * 100 + 8  # never folded
    _assert_same_state(jidx, tidx)
    # a stream query joins the same log; then the fold agrees too
    q = _stream(rng, 2_500, base[0])
    _steps(jidx, tidx, [("qry", *q), ("count",), ("qry", *q)])
    probe = universe[:200]
    np.testing.assert_array_equal(tidx.contains_kmers(probe),
                                  np.asarray(jidx.contains_kmers(probe)))
    if not canonical:
        assert tidx.contains_kmers(probe).tolist() == [
            v in oracle for v in probe]


def test_contains_on_empty_and_sentinels():
    tw = CBL(k=25, device="cpu", pending_cap=64).wordset
    words = torch.tensor([5, SENTINEL, 7], dtype=torch.int64)
    assert tw.contains_words(words).tolist() == [False] * 3
    tw.insert_words(words)
    assert tw.contains_words(words).tolist() == [True, False, True]
    tw.remove_words(words[:1])
    assert tw.contains_words(words).tolist() == [False, False, True]
    assert tw.count() == 1 and tw.contains_words(words).tolist() == [
        False, False, True]


def test_run_ids_keep_sentinel_rows_out_of_valid_runs(monkeypatch):
    """`_run_ids` gives every sentinel row its own position as run id.
    That rests on the sentinels sorting last: a position in the tail lies
    above every valid run's id, so no scatter over run ids mixes a
    sentinel row into a valid run, and the joins count what they count
    with plain running-sum ids."""
    rng = np.random.default_rng(5)
    words = rng.integers(0, 300, size=2_000)
    words[rng.random(2_000) < 0.6] = SENTINEL
    words = torch.sort(torch.from_numpy(words)).values
    valid = words != SENTINEL
    n_valid = int(valid.sum())
    assert 0 < n_valid < 2_000 and bool(valid[:n_valid].all())
    run_id = tws._run_ids(tws._first_of_run(words), valid)
    plain_id = torch.cumsum(tws._first_of_run(words), 0) - 1
    assert torch.equal(run_id[:n_valid], plain_id[:n_valid])
    assert run_id[n_valid:].tolist() == list(range(n_valid, 2_000))
    assert int(run_id[n_valid:].min()) > int(run_id[:n_valid].max())
    # an all-sentinel and a sentinel-free tensor
    for w in (words[n_valid:], words[:n_valid]):
        v = w != SENTINEL
        ids = tws._run_ids(tws._first_of_run(w), v)
        assert len(set(ids[~v].tolist())) == int((~v).sum())

    # the two joins, with the remap and with plain running-sum ids
    data = torch.unique(words)  # sorted, one sentinel last
    data = torch.cat([data, torch.full((700,), SENTINEL)])
    queries = torch.from_numpy(rng.integers(0, 600, size=900))
    queries[::7] = SENTINEL
    log_words = torch.from_numpy(rng.integers(0, 600, size=256))
    log_words[::9] = SENTINEL
    log_tags = (torch.arange(1, 257) << 1) | torch.from_numpy(
        rng.integers(0, 2, size=256))

    def counts():
        return (int(tws._count_hits_merge_kernel(data, queries)),
                int(tws._count_hits_log_merge_kernel(data, log_words,
                                                     log_tags, queries)))

    got = counts()
    monkeypatch.setattr(
        tws, "_run_ids", lambda start, valid: torch.cumsum(start, 0) - 1)
    assert counts() == got
    present = set(data[data != SENTINEL].tolist())
    assert got[0] == sum(int(q) in present for q in queries.tolist())
    for w, t in zip(log_words.tolist(), log_tags.tolist()):
        if w != SENTINEL:
            (present.add if t & 1 else present.discard)(w)
    assert got[1] == sum(int(q) in present for q in queries.tolist())
    assert 0 < got[0] != got[1] > 0


def test_multi_slab_round_takes_the_separate_calls(sort_mode, monkeypatch):
    """A round whose streams hold several slabs (or none) falls back to
    insert, query, remove; `cbl_tpu` packs the same slabs when its slab
    size is set to the port's `slab=` argument."""
    monkeypatch.setattr(jcbl, "_FUSED_SLAB", 4096)
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, size=27_000, dtype=np.uint8)

    def one(c):
        return c, np.array([0, len(c)], dtype=np.int64)

    jidx, tidx = _pair()
    rounds = [(codes[:9_000], codes[:9_000], codes[2_000:5_000]),
              (codes[9_000:18_000], codes[4_000:13_000], codes[:10]),
              (codes[18_000:21_000], codes[:12_000], codes[9_000:18_000])]
    for ins, qry, rm in rounds:
        want = jidx.dynamic_round(*(jidx.pack_stream(*one(c))
                                    for c in (ins, qry, rm)))
        packed = [tidx.pack_stream(*one(c), slab=4096)
                  for c in (ins, qry, rm)]
        assert [len(p.slabs) for p in packed] == [
            -(-max(len(c) - 24, 0) // 4096) for c in (ins, qry, rm)]
        assert tidx.dynamic_round(*packed) == want
        assert 0 < want[1] <= want[0]
        assert tidx.wordset.slog.keys is None
        _assert_same_state(jidx, tidx)
    assert tidx.count() == jidx.count()
    # the same three calls on a second index give the same answers
    other = CBL(k=25, device="cpu", pending_cap=CAP)
    for ins, qry, rm in rounds:
        other.insert_codes_stream(*one(ins))
        got = other.query_codes_stream(*one(qry))
        other.remove_codes_stream(*one(rm))
    assert got == want and other.count() == tidx.count()


def test_slog_and_pending_log_interleaved(sort_mode):
    """Rounds (sorted log), then point inserts and removes (pending log):
    a stream query folds the sorted log and joins the pending log; the
    next round folds the pending log first."""
    rng = np.random.default_rng(33)
    codes = rng.integers(0, 4, size=12_000, dtype=np.uint8)

    def one(c):
        return c, np.array([0, len(c)], dtype=np.int64)

    jidx, tidx = _pair()
    rnd = (one(codes[:4_000]), one(codes[:4_000]), one(codes[1_000:3_000]))
    assert tidx.dynamic_round(*rnd) == jidx.dynamic_round(*rnd)
    kmers = _kmers(rng, 25, 50)
    for idx in (jidx, tidx):
        idx.insert_kmers(kmers)
        idx.remove_kmers(kmers[:20])
    assert tidx.wordset.slog.keys is not None and tidx.wordset.n_pending == 70
    _assert_same_state(jidx, tidx)
    _steps(jidx, tidx, [("qry", *one(codes[:6_000]))])
    assert tidx.wordset.slog.keys is None and tidx.wordset.n_pending == 70
    np.testing.assert_array_equal(tidx.contains_kmers(kmers),
                                  np.asarray(jidx.contains_kmers(kmers)))
    rnd = (one(codes[4_000:8_000]), one(codes[:8_000]),
           one(codes[5_000:7_000]))
    assert tidx.dynamic_round(*rnd) == jidx.dynamic_round(*rnd)
    assert tidx.wordset.n_pending == 0 and tidx.wordset.slog.keys is not None
    _assert_same_state(jidx, tidx)
    # a pending log beside an active sorted log: count() folds both
    for idx in (jidx, tidx):
        idx.insert_kmers(kmers[:5])
    assert tidx.count() == jidx.count()
    _assert_same_state(jidx, tidx)


def test_pending_log_carried_across_from_jax(sort_mode):
    """A mid-log state of `cbl_tpu` (index, pending inserts and removes)
    carried into the port with `state.wordset_from_arrays` and
    `state.pending_from_arrays`, and back; both then answer alike."""
    rng = np.random.default_rng(44)
    pool = rng.integers(0, 4, size=12_000, dtype=np.uint8)
    a, b, c, q = (_stream(rng, 3_000, pool) for _ in range(4))
    jidx, tidx = _pair()
    jidx.insert_codes_stream(*a)
    jidx.insert_codes_stream(*b)
    jidx.remove_codes_stream(*c)
    jw = jidx.wordset
    assert jw.n_pending == CAP and jw._pending_rm
    tw = state.wordset_from_arrays(np.asarray(jw.data), int(jw._n_dev),
                                   jidx.cfg, "cpu")
    state.pending_from_arrays(tw, np.asarray(jw.pending),
                              np.asarray(jw.pending_tags), jw.n_pending,
                              jw._pending_rm)
    tidx.wordset = tw
    assert tw.pending_cap == CAP and tw.pending.dtype == torch.int64
    pend, tags, n_pending, pending_rm = state.pending_to_arrays(tw)
    np.testing.assert_array_equal(pend, np.asarray(jw.pending))
    np.testing.assert_array_equal(tags, np.asarray(jw.pending_tags))
    assert (n_pending, pending_rm) == (CAP, True)
    for stream in (q, b, c):
        assert tidx.query_codes_stream(*stream) == \
            jidx.query_codes_stream(*stream)
    assert tw.n_pending == CAP
    assert tidx.count() == jidx.count()
    assert tidx.query_codes_stream(*q) == jidx.query_codes_stream(*q)
    with pytest.raises(ValueError, match="limbs"):
        state.pending_from_arrays(tw, np.zeros((4, 3), np.uint32),
                                  np.zeros(4, np.uint32), 0, False)
    with pytest.raises(ValueError, match="outside"):
        state.pending_from_arrays(tw, np.zeros((4, 2), np.uint32),
                                  np.zeros(4, np.uint32), 5, False)
