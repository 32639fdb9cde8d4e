"""Parity of the port's sorted-log key and scan (kernel B4's module) with
`cbl_tpu`.

The same (word, tag) logs, made with numpy.random.default_rng, are held
in `cbl_tpu`'s packed-tag limb columns and in the port's int64 slog keys:
`cbl_tpu_torch.ops.scan.slog_scan_counts` (CPU dispatch) and its plain
version against `cbl_tpu.wordset._slog_scan` and against the Pallas
kernel `slog_scan_counts_pallas` in interpret mode, for L = 1 and 2 limbs,
runs that straddle 1024-row tiles, a sentinel tail, and the join's 0xFF
query tag beside a round's tag.  The key layout's order is held against
the packed limbs' at the extremes of the word and tag ranges.  Every
comparison is exact integer equality.
"""

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
from cbl_tpu_torch.limbs import SENTINEL
from cbl_tpu_torch.ops import scan

torch.set_num_threads(2)

U32 = np.uint32(0xFFFFFFFF)
ROUND_QTAG = (3 << 2) | 2


def _jax_cols(words, tags, sent, L):
    """`cbl_tpu`'s packed-tag columns of (word, tag) rows, through its own
    `_shl8_or`; sentinel rows all-ones."""
    limbs = [((words >> np.uint64(32 * (L - 1 - l))) & np.uint64(0xFFFFFFFF))
             .astype(np.uint32) for l in range(L)]
    cols = [np.array(c) for c in jws._shl8_or(
        tuple(jnp.asarray(c) for c in limbs),
        jnp.asarray(tags.astype(np.uint32)))]
    for c in cols:
        c[sent] = U32
    return cols


def _port_keys(words, tags, sent):
    keys = tws.slog_key(torch.from_numpy(words.astype(np.int64)),
                        torch.from_numpy(tags.astype(np.int64)))
    keys[torch.from_numpy(sent)] = SENTINEL
    return keys


def _make_slog(rng, n, L, n_words):
    """A sorted log over few distinct words (long runs across tiles), with
    insert/query/remove tags of seqs 0-7, some 0xFF join queries and a
    sentinel tail; -> (cbl_tpu columns, port keys), both sorted."""
    top = (1 << (32 * L - 8)) - 2
    vocab = np.sort(rng.choice(top, size=n_words, replace=False))
    vocab[-1] = top  # the largest valid word
    words = vocab[rng.integers(0, n_words, size=n)].astype(np.uint64)
    words[: n // 4] = vocab[n_words // 2]  # one run of n / 4 rows
    typ = rng.choice([1, 1, 2, 3], size=n).astype(np.uint64)
    tags = (rng.integers(0, 8, size=n).astype(np.uint64) << np.uint64(2)) | typ
    tags[rng.random(n) < 0.05] = 0xFF
    sent = np.zeros(n, dtype=bool)
    sent[n - n // 10:] = True
    cols = _jax_cols(words, tags, sent, L)
    order = np.lexsort(cols[::-1])
    cols = [jnp.asarray(c[order]) for c in cols]
    keys = _port_keys(words[order], tags[order], sent[order])
    assert torch.equal(keys, torch.sort(keys).values)  # same order
    return cols, keys


def _jax_oracle(cols, L, qtag):
    neq, sent, live = jws._slog_scan(cols, L, pack=True)
    hit = (jws._slog_tag(cols, L, True) == qtag) & ~sent & live
    run_end = jnp.concatenate([neq, jnp.ones((1,), bool)])
    return (int(jnp.sum(hit.astype(jnp.int32))),
            int(jnp.sum((run_end & ~sent & live).astype(jnp.int32))))


@pytest.mark.parametrize("n", [4096, 16384])
@pytest.mark.parametrize("L", [1, 2])
def test_slog_scan_matches_jax_and_pallas(L, n):
    rng = np.random.default_rng(L * 1000 + n)
    cols, keys = _make_slog(rng, n, L, n_words=max(n // 12, 3))
    for qtag in (ROUND_QTAG, 0xFF):
        want = _jax_oracle(cols, L, np.uint32(qtag))
        h, lv = slog_scan_counts_pallas(tuple(cols), np.uint32(qtag),
                                        pack=True, interpret=True)
        assert (int(h), int(lv)) == want
        for fn in (scan.slog_scan_counts, scan.slog_scan_counts_plain):
            got = fn(keys, qtag)
            assert all(x.dtype == torch.int64 and x.dim() == 0 for x in got)
            assert (int(got[0]), int(got[1])) == want
        assert want[0] > 0 and want[1] > 0


@pytest.mark.parametrize("n", [1, 2, 1023, 3001])
def test_slog_scan_any_length_matches_jax(n):
    """Lengths the Pallas kernel does not take: the plain version against
    `_slog_scan`, with and without a sentinel tail."""
    rng = np.random.default_rng(n)
    cols, keys = _make_slog(rng, n, 2, n_words=max(n // 12, 1))
    for qtag in (ROUND_QTAG, 1, 0xFF):
        want = _jax_oracle(cols, 2, np.uint32(qtag))
        got = scan.slog_scan_counts(keys, qtag)
        assert (int(got[0]), int(got[1])) == want
    got = scan.slog_scan_counts(keys[:0], 0xFF)
    assert (int(got[0]), int(got[1])) == (0, 0)


def test_slog_scan_run_across_tiles_flips():
    """One word run over several 4096-row tiles whose liveness flips deep
    inside: inserted at row 0, removed at row 9000, queried everywhere."""
    n = 20_000
    words = np.full(n, 42, dtype=np.uint64)
    tags = np.full(n, (1 << 2) | 2, dtype=np.uint64)
    tags[0] = 1
    tags[9000] = (1 << 2) | 3
    tags = np.sort(tags)
    sent = np.zeros(n, dtype=bool)
    keys = _port_keys(words, tags, sent)
    cols = [jnp.asarray(c) for c in _jax_cols(words, tags, sent, 2)]
    hits, live = scan.slog_scan_counts(keys, (1 << 2) | 2)
    assert (int(hits), int(live)) == _jax_oracle(cols, 2, np.uint32(6))
    assert (int(hits), int(live)) == (n - 2, 0)


def test_slog_key_order_and_sentinel_match_jax():
    """The key's order equals the packed limbs' (read as unsigned) at the
    ends of the word and tag ranges, and sentinel rows round-trip."""
    words = np.array([0, 1, (1 << 55) - 1, 1 << 55, (1 << 56) - 2],
                     dtype=np.uint64)
    tags = np.array([0, 1, 0x7F, 0xFE, 0xFF], dtype=np.uint64)
    w = np.repeat(words, len(tags))
    t = np.tile(tags, len(words))
    sent = np.zeros(len(w), dtype=bool)
    w = np.append(w, np.uint64(0))
    t = np.append(t, np.uint64(0))
    sent = np.append(sent, True)
    cols = _jax_cols(w, t, sent, 2)
    keys = _port_keys(w, t, sent)
    want = np.lexsort(cols[::-1])
    got = torch.sort(keys, stable=True).indices.numpy()
    np.testing.assert_array_equal(got, want)
    assert int(keys[-1]) == SENTINEL and int(keys.max()) == SENTINEL
    assert int((keys == SENTINEL).sum()) == 1  # word 2^56 - 2, tag 0xFF < it
    np.testing.assert_array_equal(
        tws.slog_word(keys[:-1]).numpy(), w[:-1].astype(np.int64))
    np.testing.assert_array_equal((keys[:-1] & 0xFF).numpy(),
                                  t[:-1].astype(np.int64))
    sk = tws.slog_key(torch.tensor([SENTINEL, 5]), 0xFF)
    assert int(sk[0]) == SENTINEL and int(sk[1]) < SENTINEL


@pytest.mark.parametrize("k,prefix_bits", [(7, 13), (13, 24), (25, 24)])
def test_slog_state_round_trips(k, prefix_bits):
    """`state.slog_to_arrays` gives back the columns `slog_from_arrays`
    took, in `cbl_tpu`'s layout (packed at K=7 and 25, a tag column at
    K=13), and a round of `cbl_tpu` converts to the port's keys."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=3_000, dtype=np.uint8)
    off = np.array([0, 2_000], dtype=np.int64)
    jidx = cbl_tpu.CBL(k=k, prefix_bits=prefix_bits)
    jidx.dynamic_round((codes[:2000], off), (codes[500:2500], off),
                       (codes[1000:3000], off))
    jw = jidx.wordset
    cols = tuple(np.asarray(c) for c in jw._slog)
    assert len(cols) == jw.L + (0 if jw._slog_pack else 1)
    ws = state.slog_from_arrays(cols, jw._slog_seq, jw._slog_real,
                                jw._n_upper, jidx.cfg, "cpu")
    assert ws.count() == jidx.count() > 0
    back, seq, real, n_upper = state.slog_to_arrays(ws)
    assert (seq, real, n_upper) == (jw._slog_seq, jw._slog_real, jw._n_upper)
    for a, b in zip(back, cols, strict=True):
        np.testing.assert_array_equal(a, b)


def test_slog_packed_configs():
    for k in range(1, 28, 2):  # the port holds odd K <= 27
        cfg = get_config(k=k, prefix_bits=min(24, 2 * k - 1))
        assert tws.slog_packed(cfg) == (k <= 25)
        if jws.slog_packed(cbl_tpu.config.get_config(
                k=k, prefix_bits=min(24, 2 * k - 1))):
            assert tws.slog_packed(cfg)  # where cbl_tpu packs, so does the port


def test_slog_scan_wrapper_checks_and_counts_no_cpu_launch(monkeypatch):
    for name in LAUNCHES:
        monkeypatch.setitem(LAUNCHES, name, 0)
    keys = torch.full((8,), SENTINEL, dtype=torch.int64)
    with pytest.raises(ValueError):
        scan.slog_scan_counts(keys.to(torch.int32), 0xFF)
    with pytest.raises(ValueError):
        scan.slog_scan_counts(keys.reshape(2, 4), 0xFF)
    with pytest.raises(ValueError):
        scan.slog_scan_counts(keys, 0x100)
    assert [int(x) for x in scan.slog_scan_counts(keys, 0xFF)] == [0, 0]
    idx = CBL(k=25, device="cpu")
    codes = np.random.default_rng(5).integers(0, 4, size=600, dtype=np.uint8)
    off = np.array([0, 600], dtype=np.int64)
    assert idx.dynamic_round((codes, off), (codes, off), (codes[:300], off // 2)) \
        == (576, 576)
    assert LAUNCHES["slog_scan"] == 0
