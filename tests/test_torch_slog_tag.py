"""Parity of the port's tag-column sorted log with `cbl_tpu`'s pack=False
slog, and of the seq cap with `cbl_tpu`'s rule.

Where a word and an 8-bit tag do not fit one int64 key, or where
`cbl_tpu` keeps its tag in a column of its own (K=11 and 13), the port's
dynamic rounds keep the log as the word's int64 columns and an int64 tag
column (C = 2 or 3), and kernel B4 scans it in that form.  The same
numpy-seeded inputs go through `cbl_tpu` (JAX CPU backend; its Pallas
scan in interpret mode) and `cbl_tpu_torch` on the CPU:

- the tag-column scan (plain, the CPU dispatch of the kernel's wrapper
  and the kernel's tile protocol) against `cbl_tpu.wordset._slog_scan(
  pack=False)` for L = 1 to 4 word limbs and against
  `slog_scan_counts_pallas(pack=False)` at L = 1 and 2, with runs across
  tiles, sentinel tails, tags above 0xFF and the join's query tag;
- the seq cap: at K=13 `cbl_tpu` keeps a tag column and never folds at
  seq 62, nor does the port (66 rounds, the whole state after each); at
  K=27 neither folds, at K=31 both fold before seq 63 though the port's
  log has a tag column there;
- config 3 (K=59, prefix 28, C = 3), plain and canonical: rounds, an
  autofold, `count()` and a query of the active log, `flush()`;
- the states carried across (`state.slog_from_arrays` /
  `slog_to_arrays`) in each of the three mappings, and a round after.

Every comparison is exact integer equality.  The K=59 streams are
`tests/test_torch_widek.py`'s `BUILD_BASES` long, so that `cbl_tpu`
traces one word pipeline a configuration.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cbl_tpu
from cbl_tpu import wordset as jws
from cbl_tpu.ops.scan_pallas import slog_scan_counts_pallas
from cbl_tpu_torch import CBL, LAUNCHES, state
from cbl_tpu_torch import wordset as tws
from cbl_tpu_torch.config import get_config
from cbl_tpu_torch.limbs import SENTINEL, from_limbs
from cbl_tpu_torch.ops import scan

torch.set_num_threads(2)

U32 = 0xFFFFFFFF
JOIN = SENTINEL  # the port's join query tag; `cbl_tpu`'s is U32
ROUND_QTAG = (5 << 2) | 2
HIGH_QTAG = (70 << 2) | 2  # a round past seq 63: above 0xFF
BUILD_BASES = 5500  # tests/test_torch_widek.py's streams


# --- the tag-column scan ------------------------------------------------------


def _sorted_tag_slog(limbs, tags, sent, bits):
    """(cbl_tpu columns, port columns) of rows with [n, L] uint32 word
    limbs and int64 tags (JOIN for a join query), sorted by (word, tag):
    `cbl_tpu`'s L limbs and uint32 tag column, the port's word columns
    (one up to 60 bits, else two) and int64 tag column."""
    limbs = limbs.copy()
    limbs[sent] = U32
    jtag = np.where((tags == JOIN) | sent, U32, tags).astype(np.uint32)
    jcols = [limbs[:, l] for l in range(limbs.shape[1])] + [jtag]
    order = np.lexsort(jcols[::-1])
    jcols = [c[order] for c in jcols]
    words = from_limbs(limbs[order], 1 if bits <= 60 else 2)
    ttag = np.where(jcols[-1] == U32, SENTINEL, jcols[-1].astype(np.int64))
    tcols = tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in
                  [*words.reshape(-1, len(ttag)), ttag])
    return jcols, tcols


def _vocab(rng, n_words, L, bits):
    """n_words distinct [L] uint32 word limbs of at most `bits` bits."""
    top = bits - 32 * (L - 1)
    v = rng.integers(0, 1 << 32, size=(n_words * 2, L), dtype=np.uint64)
    v[:, 0] &= np.uint64((1 << top) - 1)
    v = np.unique(v.astype(np.uint32), axis=0)
    return v[rng.permutation(len(v))[:n_words]]


def _make_tag_slog(rng, n, L, bits, n_words, sent_frac=0.1):
    """A log over few distinct words (long runs across tiles, one of n / 4
    rows), tags of seqs 0-79 (above 0xFF from seq 64), 5 % join queries
    and a sentinel tail."""
    vocab = _vocab(rng, n_words, L, bits)
    limbs = vocab[rng.integers(0, len(vocab), size=n)]
    limbs[: n // 4] = vocab[0]
    typ = rng.choice([1, 1, 2, 3], size=n)
    tags = (rng.integers(0, 80, size=n) << 2) | typ
    tags[rng.random(n) < 0.05] = JOIN
    sent = np.zeros(n, dtype=bool)
    sent[n - int(n * sent_frac):] = True
    return _sorted_tag_slog(limbs, tags, sent, bits)


def _jax_oracle(jcols, qtag):
    """(hits, live) by `cbl_tpu.wordset._slog_scan(pack=False)`."""
    cols = tuple(jnp.asarray(c) for c in jcols)
    L = len(cols) - 1
    q = np.uint32(U32 if qtag == JOIN else qtag)
    neq, sent, live = jws._slog_scan(cols, L, pack=False)
    hit = (cols[L] == q) & ~sent & live
    run_end = jnp.concatenate([neq, jnp.ones((1,), bool)])
    return (int(jnp.sum(hit.astype(jnp.int32))),
            int(jnp.sum((run_end & ~sent & live).astype(jnp.int32))))


def _ints(pair):
    return tuple(int(x) for x in pair)


# (L, bits): K=11/13-like one-limb words, a one-column 60-bit word (K=27),
# 64 bits (K=29, two columns), three and four limbs (up to K=59's 125)
LAYOUTS = [(1, 31), (2, 60), (2, 64), (3, 96), (4, 125)]


@pytest.mark.parametrize("L,bits", LAYOUTS)
def test_tag_scan_matches_jax_and_pallas(L, bits):
    rng = np.random.default_rng(L * 100 + bits)
    jcols, tcols = _make_tag_slog(rng, 4096, L, bits, n_words=300)
    assert len(tcols) == (2 if bits <= 60 else 3)
    for qtag in (ROUND_QTAG, 1, HIGH_QTAG, JOIN):
        want = _jax_oracle(jcols, qtag)
        assert want[0] > 0 and want[1] > 0
        assert _ints(scan.slog_scan_counts_plain(tcols, qtag)) == want
        for s in (tcols, torch.stack(tcols)):  # a tuple or a [C, N] tensor
            got = scan.slog_scan_tag_counts(s, qtag)
            assert all(x.dtype == torch.int64 and x.dim() == 0 for x in got)
            assert _ints(got) == want
        assert _ints(scan.slog_scan_tiled(tcols, qtag, 64)) == want
        if L <= 2:
            h, lv = slog_scan_counts_pallas(
                tuple(jnp.asarray(c) for c in jcols),
                np.uint32(U32 if qtag == JOIN else qtag), pack=False,
                interpret=True)
            assert (int(h), int(lv)) == want


@pytest.mark.parametrize("n", [1, 2, 1023, 3001])
@pytest.mark.parametrize("L,bits", [(1, 31), (4, 125)])
def test_tag_scan_any_length_matches_jax(L, bits, n):
    """Lengths the Pallas kernel does not take, with and without a
    sentinel tail."""
    rng = np.random.default_rng(n + L)
    for frac in (0.1, 0.0):
        jcols, tcols = _make_tag_slog(rng, n, L, bits,
                                      n_words=max(n // 12, 1),
                                      sent_frac=frac)
        for qtag in (ROUND_QTAG, 1, JOIN):
            want = _jax_oracle(jcols, qtag)
            assert _ints(scan.slog_scan_tag_counts(tcols, qtag)) == want
            assert _ints(scan.slog_scan_tiled(tcols, qtag, 8)) == want


def _tile_case(rng, case, tile, L, bits):
    """(limbs, tags, sent) of a log at a tile-protocol edge, unsorted."""
    k = 150 if tile < 64 else 40
    n = {"k*tile-1": k * tile - 1, "k*tile": k * tile,
         "k*tile+1": k * tile + 1, "one": 1}.get(case, k * tile)
    vocab = _vocab(rng, max(n // 16, 2) + 1, L, bits)
    run_word, vocab = vocab[0], vocab[1:]  # a word of no other row
    limbs = vocab[rng.integers(0, len(vocab), size=n)]
    typ = rng.choice([1, 1, 2, 3], size=n)
    tags = (rng.integers(0, 8, size=n) << 2) | typ
    tags[rng.random(n) < 0.05] = JOIN
    sent = np.zeros(n, dtype=bool)
    if case == "query run":  # one insert, then queries over k - 2 tiles
        run = (k - 2) * tile + 3
        limbs[:run] = run_word
        tags[:run] = np.where(tags[:run] == JOIN, JOIN,
                              (tags[:run] & ~3) | 2)
        tags[0] = 1
    elif case == "tile-edge runs":  # every run ends on a tile edge
        limbs = _vocab(rng, n // tile, L, bits)[np.arange(n) // tile]
    elif case == "sentinels from a tile edge":
        limbs[: 3 * tile] = run_word  # and a run over the first three tiles
        sent[(k // 2) * tile:] = True
    elif case != "one":
        limbs[: n // 3] = run_word
        sent[n - n // 10:] = True
    return limbs, tags, sent


TILE_CASES = ["query run", "tile-edge runs", "sentinels from a tile edge",
              "k*tile-1", "k*tile", "k*tile+1", "one"]


@pytest.mark.parametrize("case", TILE_CASES)
@pytest.mark.parametrize("tile", [8, 64])
@pytest.mark.parametrize("L,bits", [(1, 31), (4, 125)])
def test_tag_tiled_matches_plain_and_jax(L, bits, tile, case):
    """Kernel B4's tile protocol on a tag-column log (`slog_scan_tiled`)
    against the plain version and `cbl_tpu`, with every tile publishing
    before any looks back (the longest walks) and in waves of 5 tiles."""
    rng = np.random.default_rng(tile * 100 + len(case) + L)
    jcols, tcols = _sorted_tag_slog(*_tile_case(rng, case, tile, L, bits),
                                    bits)
    for qtag in (ROUND_QTAG, JOIN):
        want = _jax_oracle(jcols, qtag)
        assert _ints(scan.slog_scan_counts_plain(tcols, qtag)) == want
        for wave in (None, 5):
            got = scan.slog_scan_tiled(tcols, qtag, tile, wave)
            assert _ints(got) == want
        if case == "query run":  # the run is live throughout
            assert want[0] > len(tcols[0]) // 40
    empty = tuple(c[:0] for c in tcols)
    assert _ints(scan.slog_scan_tiled(empty, JOIN, tile)) == (0, 0)


def test_tag_scan_wrapper_checks_and_counts_no_cpu_launch(monkeypatch):
    for name in LAUNCHES:
        monkeypatch.setitem(LAUNCHES, name, 0)
    col = torch.full((8,), SENTINEL, dtype=torch.int64)
    for bad in ((col,), (col,) * 4, (col, col.to(torch.int32)),
                (col, col[:4]), (col, col.reshape(2, 4))):
        with pytest.raises(ValueError):
            scan.slog_scan_tag_counts(bad, JOIN)
    with pytest.raises(ValueError):
        scan.slog_scan_tag_counts((col, col), -1)
    assert _ints(scan.slog_scan_tag_counts((col, col, col), JOIN)) == (0, 0)
    assert _ints(scan.slog_scan_tag_counts(
        torch.empty((2, 0), dtype=torch.int64), JOIN)) == (0, 0)
    assert scan.slog_query_tag((col, col)) == JOIN
    assert scan.slog_query_tag(col) == scan.SLOG_TAG_MAX
    idx = CBL(k=13, prefix_bits=20, device="cpu")
    codes = np.random.default_rng(5).integers(0, 4, size=600, dtype=np.uint8)
    off = np.array([0, 600], dtype=np.int64)
    assert idx.dynamic_round((codes, off), (codes, off),
                             (codes[:300], off // 2)) == (588, 588)
    assert idx.wordset.slog.keys[0].shape[0] == 2  # word and tag columns
    assert not any(LAUNCHES.values())


# --- dynamic rounds -----------------------------------------------------------


def _pair(k, prefix_bits, canonical=False):
    return (cbl_tpu.CBL(k=k, prefix_bits=prefix_bits, canonical=canonical),
            CBL(k=k, prefix_bits=prefix_bits, canonical=canonical,
                device="cpu"))


def _one(codes):
    return codes, np.array([0, len(codes)], dtype=np.int64)


def _jax_cols(jidx):
    return tuple(np.asarray(c) for c in jidx.wordset._slog)


def _assert_same_state(jidx, tidx):
    """Counters, count and the log (`cbl_tpu`'s through
    `state.slog_from_arrays`, and the port's back through
    `slog_to_arrays`), or the folded index."""
    jw, tw = jidx.wordset, tidx.wordset
    assert (tw.slog.seq, tw.slog.real, tw._n_upper) == (
        jw._slog_seq, jw._slog_real, jw._n_upper)
    assert tidx.count() == jidx.count()
    if jw._slog is None:
        assert tw.slog.keys is None
        np.testing.assert_array_equal(
            tw.data.numpy(), from_limbs(np.asarray(jw.data), tw._cols))
        return
    cols = _jax_cols(jidx)
    want = state.slog_from_arrays(cols, jw._slog_seq, jw._slog_real,
                                  jw._n_upper, jidx.cfg, "cpu").slog.keys[0]
    assert torch.equal(tw.slog.keys[0], want)
    back, seq, real, n_upper = state.slog_to_arrays(tw)
    assert (seq, real, n_upper) == (jw._slog_seq, jw._slog_real, jw._n_upper)
    for a, b in zip(back, cols, strict=True):
        np.testing.assert_array_equal(a, b)


def _round_streams(idx, pool, sb):
    """Four one-slab segments and their halves as PackedStreams."""
    segs = [idx.pack_stream(*_one(pool[i * sb:(i + 1) * sb]))
            for i in range(4)]
    halves = [idx.pack_stream(*_one(pool[i * sb + sb // 4:i * sb + sb]))
              for i in range(4)]
    return segs, halves


def test_k13_rounds_run_past_seq_62_as_cbl_tpu(monkeypatch):
    """K=13: `cbl_tpu` keeps a tag column (31-bit words fill their one
    limb) and never folds at seq 62; the port, which could pack a K=13
    word and an 8-bit tag into one key, must not fold there either.  64
    small rounds, the whole state compared after each.  Each round adds
    three padded 4096-row streams to the log, so both packages take
    power-of-two log capacities here (7 instead of 30 steps up to the
    last round's 786,432 rows): `cbl_tpu` traces fewer round programs."""
    pow2 = functools.partial(tws._quantize_cap, frac_log=0)
    for mod in (jws, tws):  # the modules whose rounds call it
        monkeypatch.setattr(mod, "_quantize_cap", pow2)
    cfg = get_config(13, 20)
    assert not tws.slog_tag_in_limbs(cfg) and not tws.slog_packed(cfg)
    pool = np.random.default_rng(13).integers(0, 4, size=1000,
                                              dtype=np.uint8)
    jidx, tidx = _pair(13, 20)
    streams = [_round_streams(idx, pool, 250) for idx in (jidx, tidx)]
    for r in range(64):
        res = [idx.dynamic_round(segs[r % 4], segs[(r + 1) % 4],
                                 halves[(r + 2) % 4])
               for idx, (segs, halves) in zip((jidx, tidx), streams)]
        assert res[1] == res[0], r
        _assert_same_state(jidx, tidx)
        assert tidx.wordset.slog.seq == r + 1
    assert tidx.wordset.slog.keys[0].shape[0] == 2
    jidx.wordset.flush()
    tidx.flush()
    _assert_same_state(jidx, tidx)


@pytest.mark.parametrize("k,capped", [(27, False), (31, True)])
def test_seq_cap_follows_cbl_tpu(k, capped):
    """K=27 (`cbl_tpu`: two limbs and a tag column) runs past seq 62 with
    no fold; K=31 (`cbl_tpu` packs its tag into three limbs) folds before
    seq 63 in both, though the port's log has a tag column (C = 3).  Two
    rounds, then both logs' seq set to 60 (the seq enters only the tags
    and the cap) and four more rounds across the cap, with tags above
    0xFF at K=27."""
    cfg = get_config(k, 24)
    assert tws.slog_tag_in_limbs(cfg) == capped
    assert not tws.slog_packed(cfg)
    pool = np.random.default_rng(k).integers(0, 4, size=1000,
                                             dtype=np.uint8)
    jidx, tidx = _pair(k, 24)
    streams = [_round_streams(idx, pool, 250) for idx in (jidx, tidx)]
    seqs = []
    for r in range(6):
        if r == 2:
            jidx.wordset._slog_seq = tidx.wordset.slog.seq = 60
        res = [idx.dynamic_round(segs[r % 4], segs[(r + 1) % 4],
                                 halves[(r + 2) % 4])
               for idx, (segs, halves) in zip((jidx, tidx), streams)]
        assert res[1] == res[0], r
        _assert_same_state(jidx, tidx)
        seqs.append(tidx.wordset.slog.seq)
    assert seqs == ([1, 2, 61, 62, 1, 2] if capped
                    else [1, 2, 61, 62, 63, 64])
    assert tidx.wordset.slog.keys[0].shape[0] == (2 if k <= 27 else 3)
    if not capped:
        assert int(tidx.wordset.slog.keys[0][-1][
            tidx.wordset.slog.keys[0][0] != SENTINEL].max()) == (64 << 2) | 3
    q = _one(pool[100:700])
    assert tidx.query_codes_stream(*q) == jidx.query_codes_stream(*q)
    jidx.wordset.flush()
    tidx.flush()
    _assert_same_state(jidx, tidx)


@pytest.mark.parametrize("canonical", [False, True])
def test_k59_rounds_match_jax(monkeypatch, canonical):
    """Config 3 (K=59, prefix 28; the port's log has two word columns and
    a tag column): rounds over one-slab streams of `BUILD_BASES` bases,
    with the autofold's hard cap lowered in both packages so that the log
    folds before the fourth round, then `count()` and a query of the
    active log (no fold), the state carried back, and `flush()`."""
    monkeypatch.setattr(jws.DeviceWordSet, "_SLOG_HARD_CAP", 60_000)
    monkeypatch.setattr(tws.SortedLog, "HARD_CAP", 60_000)
    k, sb = 59, BUILD_BASES
    codes = np.random.default_rng(59 + canonical).integers(
        0, 4, size=5 * sb, dtype=np.uint8)
    jidx, tidx = _pair(k, 28, canonical)
    streams = []
    for idx in (jidx, tidx):
        streams.append(
            ([idx.pack_stream(*_one(codes[i * sb:(i + 1) * sb]))
              for i in range(4)],
             [idx.pack_stream(*_one(codes[i * sb + sb // 2:
                                          (i + 1) * sb + sb // 2]))
              for i in range(4)]))
    seqs = []
    for r in range(4):
        res = [idx.dynamic_round(segs[r], segs[max(r - 1, 0)], rm[r])
               for idx, (segs, rm) in zip((jidx, tidx), streams)]
        assert res[1] == res[0], r
        assert 0 < res[1][1] <= res[1][0]
        _assert_same_state(jidx, tidx)
        seqs.append(tidx.wordset.slog.seq)
    assert seqs == [1, 2, 3, 1]  # the autofold at the fourth round's entry
    assert tidx.wordset.slog.keys[0].shape[0] == 3
    assert tidx.count() == jidx.count() > 0
    # a query of the active log (a stream of the rounds: `cbl_tpu` traces
    # no new word pipeline)
    got = tidx.query_codes_stream(streams[1][1][0])
    assert got == jidx.query_codes_stream(streams[0][1][0])
    assert 0 < got[1] < got[0]
    assert tidx.wordset.slog.keys is not None  # queries never fold
    jidx.wordset.flush()
    tidx.flush()
    _assert_same_state(jidx, tidx)
    np.testing.assert_array_equal(tidx.wordset.words_array(),
                                  jidx.wordset.words_array())
    assert tidx.query_codes_stream(streams[1][1][0]) == got


@pytest.mark.parametrize("k,prefix_bits", [(13, 20), (27, 24), (31, 24)])
def test_slog_states_carry_both_ways(k, prefix_bits):
    """`cbl_tpu`'s log in each layout the port meets (a tag column of one
    and two limbs into the port's C = 2 log; the tag packed into three
    limbs into the port's C = 3 log) carried into the port, back equal to
    its columns, then a round in both."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=3_000, dtype=np.uint8)
    jidx = cbl_tpu.CBL(k=k, prefix_bits=prefix_bits)
    jidx.dynamic_round(_one(codes[:2000]), _one(codes[500:2500]),
                       _one(codes[1000:3000]))
    jw = jidx.wordset
    cols = _jax_cols(jidx)
    assert len(cols) == jw.L + (0 if jw._slog_pack else 1)
    tidx = CBL(k=k, prefix_bits=prefix_bits, device="cpu")
    tidx.wordset = state.slog_from_arrays(cols, jw._slog_seq, jw._slog_real,
                                          jw._n_upper, jidx.cfg, "cpu")
    assert tidx.wordset.slog.keys[0].shape[0] == (2 if k <= 27 else 3)
    _assert_same_state(jidx, tidx)
    rnd = (_one(codes[1500:3000]), _one(codes[:3000]), _one(codes[:700]))
    assert tidx.dynamic_round(*rnd) == jidx.dynamic_round(*rnd)
    _assert_same_state(jidx, tidx)
