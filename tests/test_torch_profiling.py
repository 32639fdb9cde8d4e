"""The port's program spans and counters (`cbl_tpu_torch.profiling`) on
CPU tensors: off by default and then free of records, the span tree of
the calls the benchmark makes, a span at every host read of a device
value, the fold and round counters, and answers that do not depend on
whether recording is on."""

import numpy as np
import pytest
import torch

from cbl_tpu_torch import CBL, PackedStream, profiling
from cbl_tpu_torch.wordset import _SLOG_SEQ_MAX, SortedLog

torch.set_num_threads(2)

CONFIGS = [(25, 24), (59, 28)]


def _streams(idx, n, seed, bases=3000):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        codes = rng.integers(0, 4, bases, dtype=np.uint8)
        out.append(idx.pack_stream(codes, np.array([0, bases])))
    return out


def _reads(idx, n, seed, genome, reads=12, length=150):
    """n streams of `reads` reads of `genome`: few distinct k-mers a
    slab, as in a read stream of one organism."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        starts = rng.integers(0, len(genome) - length, reads)
        codes = np.concatenate([genome[s:s + length] for s in starts])
        out.append(idx.pack_stream(codes, np.arange(reads + 1) * length))
    return out


def _tree(records, root=-1):
    """[(name, children)] of the spans whose parent is `root`."""
    return [(r[0], _tree(records, i)) for i, r in enumerate(records)
            if r[3] == root]


def _delta(before):
    return {k: v - before.get(k, 0) for k, v in profiling.COUNTERS.items()
            if v != before.get(k, 0)}


SORT = ("sort", [("sort", [])])
WORDS = ("words", [])


def test_off_by_default_keeps_nothing_and_counts():
    assert profiling._records is None
    assert profiling.span("words") is profiling.span("sort")  # one no-op
    idx = CBL(k=25, device="cpu")
    a, b, c = _streams(idx, 3, 1)
    before = dict(profiling.COUNTERS)
    idx.insert_codes_stream(a)
    idx.query_codes_stream(b)
    idx.dynamic_round(a, b, c)
    # the query of a slab as large as the index: a probe join (the merge
    # join's bytes pass the probe's from 2^18 rows), its layout built once;
    # four sorts, `torch.sort` on the CPU: the build, the query's, and in
    # the round b's (its memo holds the query's unsorted words) and c's
    assert _delta(before) == {"syncs.query_codes_stream": 1, "rounds": 1,
                              "syncs.dynamic_round": 1,
                              "join.probe": 1, "probe_rows": 4096,
                              "index.search_layout": 1,
                              "sort.library": 4,
                              "slog_rows": idx.wordset.slog.real}
    assert profiling._records is None and profiling._open == []


def test_the_off_path_is_no_generator():
    site = profiling.span("join")
    assert type(site).__name__ == "_NoSpan"
    with site as got:
        assert got is None


@pytest.mark.parametrize("k,pb", CONFIGS)
def test_span_tree_of_the_benchmark_calls(k, pb):
    with profiling.recording() as rec:
        idx = CBL(k=k, prefix_bits=pb, device="cpu")
        a, b, c = _streams(idx, 3, 2)
        idx.insert_codes_stream(a)
        idx.query_codes_stream(b)
        idx.dynamic_round(*_streams(idx, 3, 3))
        idx.count_device()
    assert _tree(rec) == [
        ("cbl.__init__", []),
        ("cbl.insert_codes_stream", [
            ("index", [("index", [])]),  # flush, and the slog's fold
            WORDS, SORT,
            ("index", []),  # the build's distinct count
            ("index", []),  # adopt_built
        ]),
        ("cbl.query_codes_stream", [
            # the probe join: its search layout, then the queries' sort
            WORDS, ("join", [("index", []), SORT]),
            ("sync.query_codes_stream", [])]),
        ("cbl.dynamic_round", [
            WORDS, SORT, WORDS, SORT, WORDS, SORT,
            ("index", []),  # _compact before the log starts
            ("join", []), ("sync.dynamic_round", [])]),
        ("cbl.count_device", []),
    ]
    calls = [r[4] for r in rec]
    tops = [i for i, r in enumerate(rec) if r[3] == -1]
    assert [calls[i] for i in tops] == sorted(set(calls))  # one id a call
    for r in rec:
        if r[3] >= 0:
            assert r[4] == rec[r[3]][4]
            assert rec[r[3]][1] <= r[1] <= r[2] <= rec[r[3]][2]
        assert r[1] <= r[2]


@pytest.mark.parametrize("k,pb", CONFIGS)
def test_span_tree_of_an_autofolding_round(k, pb, monkeypatch):
    """The window's rounds as the benchmark runs them: fresh streams over
    staged slabs of 4096 k-mers, the hard cap lowered to their scale.
    The round that autofolds holds the fold (`index`, its sort inside),
    then the exact count's wait (`sync.n`), the compaction check before
    the new log, and the round's merges and scan (`join`)."""
    monkeypatch.setattr(SortedLog, "HARD_CAP", 1 << 16)
    idx = CBL(k=k, prefix_bits=pb, device="cpu")
    W, S = 3, 8
    genome = np.random.default_rng(8).integers(0, 4, 1200, dtype=np.uint8)
    ins = [ps.slabs for ps in _reads(idx, S, 9, genome)]
    qry = [ps.slabs for ps in _reads(idx, 2, 10, genome)]
    fresh = lambda slabs: PackedStream(idx.cfg, idx.canonical, slabs)
    assert {s[0][0] for s in ins + qry} == {4096}
    for j in range(W):
        idx.insert_codes_stream(fresh(ins[j]))
    for r in range(W, W + 24):
        before = dict(profiling.COUNTERS)
        with profiling.recording() as rec:
            idx.dynamic_round(fresh(ins[r % S]), fresh(qry[r % 2]),
                              fresh(ins[(r - W) % S]), lazy=True)
        d = _delta(before)
        if "folds.slog.autofold" in d:
            break
    else:
        pytest.fail("no round autofolded")
    assert d == {"rounds": 1, "folds.slog.autofold": 1, "syncs.n": 1,
                 "sort.library": 4, "slog_rows": idx.wordset.slog.real}
    assert _tree(rec) == [
        ("cbl.dynamic_round", [
            WORDS, SORT, WORDS, SORT, WORDS, SORT,
            ("index", [SORT]),  # the autofold
            ("sync.n", []),  # the exact count after it
            ("index", []),  # _compact before the new log starts
            ("join", [])]),
    ]


def test_calls_inside_calls_share_their_call_id():
    idx = CBL(k=25, device="cpu")
    rng = np.random.default_rng(4)
    two = [(rng.integers(0, 4, 9000, dtype=np.uint8),
            np.array([0, 9000])) for _ in range(3)]
    idx.insert_codes_stream(*_streams(idx, 1, 5))
    with profiling.recording() as rec:
        idx.dynamic_round(*(idx.pack_stream(c, o, slab=4096)
                            for c, o in two))
    names = [r[0] for r in rec if r[3] == 0]
    assert rec[0][0] == "cbl.dynamic_round"
    assert names[:3] == ["cbl.insert_codes_stream",
                         "cbl.query_codes_stream",
                         "cbl.remove_codes_stream"]
    assert {r[4] for r in rec} == {rec[0][4]}


def _trigger(site):
    """Make the port read a device value at `site`; -> the index."""
    idx = CBL(k=25, device="cpu")
    a, b, c = _streams(idx, 3, 6)
    idx.insert_codes_stream(a)
    if site == "n":
        return lambda: idx.count()
    if site == "count_hits":
        words = b.words(0)[0]
        return lambda: idx.wordset.count_hits(words)
    if site == "count":
        idx.dynamic_round(a, b, c, lazy=True)
        return lambda: idx.count()
    if site == "query_codes_stream":
        return lambda: idx.query_codes_stream(b)
    if site == "dynamic_round":
        return lambda: idx.dynamic_round(a, b, c)
    if site == "host_limbs":
        return lambda: idx.kmers_limbs()
    if site == "contains":
        return lambda: idx.contains_kmers([0, 1, 2])
    raise KeyError(site)


SITES = ["n", "count_hits", "count", "query_codes_stream", "dynamic_round",
         "host_limbs", "contains"]


@pytest.mark.parametrize("site", SITES)
def test_each_host_read_is_a_sync_span(site):
    call = _trigger(site)
    before = dict(profiling.COUNTERS)
    with profiling.recording() as rec:
        call()
    syncs = [r for r in rec if r[0] == f"sync.{site}"]
    assert len(syncs) == 1 and syncs[0][1] <= syncs[0][2]
    assert _delta(before).get(f"syncs.{site}") == 1


def test_lazy_calls_read_nothing_back():
    idx = CBL(k=25, device="cpu")
    a, b, c = _streams(idx, 3, 7)
    idx.insert_codes_stream(a)
    with profiling.recording() as rec:
        idx.query_codes_stream(b, lazy=True)
        idx.dynamic_round(a, b, c, lazy=True)
        idx.count_device()
    assert not [r for r in rec if r[0].startswith("sync.")]


def test_point_operations_read_one_answer():
    idx = CBL(k=25, device="cpu")
    before = dict(profiling.COUNTERS)
    assert idx.insert(12345) and not idx.insert(12345)
    assert idx.remove(12345)
    assert _delta(before)["syncs.contains"] == 3


@pytest.mark.parametrize("k,pb", CONFIGS)
def test_autofolds_of_a_window_are_counted(k, pb, monkeypatch):
    """A window of rounds as the benchmark runs them: insert batch r,
    query, remove batch r - W.  A round that starts a new log after one
    was active folded it first; below the seq cap that fold is the
    autofold's.  The hard cap is lowered to these slabs' scale (2^27
    rows, three 2^24-row slabs a round in the benchmark's windows)."""
    monkeypatch.setattr(SortedLog, "HARD_CAP", 1 << 16)
    idx = CBL(k=k, prefix_bits=pb, device="cpu")
    W, S = 3, 8
    genome = np.random.default_rng(8).integers(0, 4, 1200, dtype=np.uint8)
    ins = _reads(idx, S, 9, genome)
    qry = _reads(idx, 2, 10, genome)
    for j in range(W):
        idx.insert_codes_stream(ins[j])
    ws = idx.wordset
    before = dict(profiling.COUNTERS)
    want, rows = 0, 0
    for r in range(W, W + 24):
        seq = ws.slog.seq
        idx.dynamic_round(ins[r % S], qry[r % 2], ins[(r - W) % S],
                          lazy=True)
        if 0 < seq < _SLOG_SEQ_MAX and ws.slog.seq == 1:
            want += 1
        rows += ws.slog.real
    d = _delta(before)
    assert want >= 3
    assert d["folds.slog.autofold"] == want
    assert d["syncs.n"] == want  # the exact count after each
    assert "folds.slog.seq_cap" not in d
    assert d["rounds"] == 24 and d["slog_rows"] == rows


def test_fold_causes():
    idx = CBL(k=25, device="cpu")
    a, b, c = _streams(idx, 3, 10)
    idx.insert_codes_stream(a)
    before = dict(profiling.COUNTERS)
    idx.dynamic_round(a, b, c, lazy=True)
    idx.wordset.slog.seq = _SLOG_SEQ_MAX
    idx.dynamic_round(a, b, c, lazy=True)  # folds at the seq cap
    assert _delta(before).get("folds.slog.seq_cap") == 1
    idx.insert_kmers([7, 8])  # the pending log beside the slog
    idx.query_codes_stream(b, lazy=True)  # folds the slog
    idx.flush()  # folds the pending log
    idx.dynamic_round(a, b, c, lazy=True)
    idx.flush()
    d = _delta(before)
    assert (d["folds.slog.seq_cap"], d["folds.slog.query"],
            d["folds.slog.flush"], d["folds.pending"]) == (1, 1, 1, 1)
    assert "folds.slog.autofold" not in d


def _session(idx, streams):
    a, b, c, d = streams
    out = [idx.insert_codes_stream(a), idx.query_codes_stream(b)]
    for _ in range(3):
        out.append(idx.dynamic_round(b, c, d))
    out.append(idx.query_codes_stream(c))
    out.append(idx.count())
    out.append(idx.kmers_limbs().tobytes())
    return out


@pytest.mark.parametrize("k,pb", CONFIGS)
def test_answers_do_not_depend_on_recording(k, pb):
    off = CBL(k=k, prefix_bits=pb, device="cpu")
    on = CBL(k=k, prefix_bits=pb, device="cpu")
    want = _session(off, _streams(off, 4, 11))
    with profiling.recording() as rec:
        got = _session(on, _streams(on, 4, 11))
    assert got == want and rec


def test_recording_nests_and_ends():
    with profiling.recording() as outer:
        with profiling.recording() as inner:
            assert inner is outer
            with profiling.span("words"):
                pass
        assert profiling._records is not None
    assert profiling._records is None
    assert [r[0] for r in outer] == ["words"]
    with profiling.span("words"):
        pass
    assert len(outer) == 1


def test_a_span_ends_when_its_block_raises():
    with profiling.recording() as rec:
        with pytest.raises(ValueError):
            with profiling.span("index"):
                raise ValueError("x")
        with profiling.span("join"):
            pass
    assert [(r[0], r[3]) for r in rec] == [("index", -1), ("join", -1)]
    assert rec[0][2] is not None and rec[0][4] != rec[1][4]


def test_spanned_keeps_the_function():
    @profiling.spanned("sort")
    def f(x, y=2):
        """doc"""
        return x + y

    assert f.__name__ == "f" and f.__doc__ == "doc" and f(1) == 3
    with profiling.recording() as rec:
        assert f(1, y=5) == 6
    assert [r[0] for r in rec] == ["sort"]


def test_the_trace_holds_the_program_spans(tmp_path):
    import json

    idx = CBL(k=25, device="cpu")
    a, b = _streams(idx, 2, 12)
    with profiling.trace(str(tmp_path)):
        assert profiling._records is not None
        idx.insert_codes_stream(a)
        idx.query_codes_stream(b)
    assert profiling._records is None
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert {"cbl.insert_codes_stream", "cbl.query_codes_stream", "words",
            "sort", "join", "sync.query_codes_stream"} <= names
