"""The probe join (kernel B8, `ops.probe`; `wordset._count_hits_probe_kernel`),
the join selector, the search layout's upkeep, the export in row blocks
(`CBL.iter_kmers_limbs`) and the bound on a stream's words memo.

The probe's plain route is held to the merge join
(`wordset._count_hits_merge_kernel`) and to the benchmark's plain
reference (`kmerbench.reference.kmers`) on seeded random words: index
sizes around the layout's stride, duplicate index rows, sentinel rows
among the queries and after the index, an empty index, every query
absent, every query present; one and two columns.  The tests marked `gpu`
hold the CUDA kernel to the plain route, up to an index past 2^31 rows;
the file imports no JAX, so on a card without JAX run

    python -m pytest --noconftest -m gpu tests/test_torch_probe.py -q
"""

import numpy as np
import pytest
import torch

from cbl_tpu_torch import CBL, profiling
from cbl_tpu_torch import cbl as tcbl
from cbl_tpu_torch import wordset as tws
from cbl_tpu_torch.limbs import SENTINEL
from cbl_tpu_torch.ops import probe
from kmerbench.reference.kmers import Universe

torch.set_num_threads(2)


def _rows(x: np.ndarray) -> torch.Tensor:
    """[N] or [2, N] int64 rows."""
    return torch.from_numpy(np.ascontiguousarray(x))


def _sorted_rows(vals: np.ndarray) -> np.ndarray:
    """Sort [N] or [2, N] rows lexicographically, column 0 major."""
    if vals.ndim == 1:
        return np.sort(vals)
    return vals[:, np.lexsort(vals[::-1])]


def _words(rng, n, n_cols, vocab):
    """n rows drawn from a vocabulary (so rows repeat and queries hit)."""
    if n_cols == 1:
        return vocab[rng.integers(0, len(vocab), n)]
    return vocab[:, rng.integers(0, vocab.shape[1], n)]


def _vocab(rng, n_cols, size=400):
    if n_cols == 1:
        return rng.integers(0, 1 << 56, size)
    return np.stack([rng.integers(0, 1 << 50, size),
                     rng.integers(0, 1 << 62, size)])


def _with_sentinels(x: np.ndarray, every: int) -> np.ndarray:
    x = x.copy()
    x[..., ::every] = SENTINEL
    return x


def _reference_hits(data: torch.Tensor, q: torch.Tensor) -> int:
    """Valid query rows some valid index row equals, by
    `kmerbench.reference.kmers.Universe`."""
    cols = lambda x: (x,) if x.dim() == 1 else tuple(x)  # noqa: E731
    dv, qv = (x if x.dim() == 1 else x[0] for x in (data, q))
    d = tuple(c[dv != SENTINEL] for c in cols(data))
    qq = tuple(c[qv != SENTINEL] for c in cols(q))
    if qq[0].numel() == 0 or d[0].numel() == 0:
        return 0
    u = Universe([d, qq])
    present = u.empty_set()
    present[u.ids(0)] = True
    return int(present[u.ids(1)].sum())


def _layout(data: torch.Tensor, s: int):
    cols = (data,) if data.dim() == 1 else tuple(data)
    return tuple(c[:: 1 << s].contiguous() for c in cols)


def _cols(x: torch.Tensor) -> tuple:
    return (x,) if x.dim() == 1 else tuple(x)


def _probe(data, s, q):
    """`probe_hits` (the plain route here) on sorted queries, as the join
    hands them over, with the layout of stride 2^s."""
    q = _rows(_sorted_rows(q.numpy()))
    return int(probe.probe_hits(_cols(data), _layout(data, s), s, _cols(q)))


STRIDES = [2, 3, 5]


def _sizes(s):
    step = 1 << s
    return [1, step - 1, step, step + 1, 5 * step - 1, 5 * step + 1, 300]


@pytest.mark.parametrize("n_cols", [1, 2])
@pytest.mark.parametrize("s", STRIDES)
def test_probe_equals_merge_join_and_reference(n_cols, s):
    rng = np.random.default_rng(10 * s + n_cols)
    vocab = _vocab(rng, n_cols)
    for n in _sizes(s):
        data = _sorted_rows(_words(rng, n, n_cols, vocab[..., :250]))
        data = np.concatenate([data, np.full(data.shape[:-1] + (7,),
                                             SENTINEL)], axis=-1)
        q = _with_sentinels(_words(rng, 500, n_cols, vocab), 11)
        d, qt = _rows(data), _rows(q)
        want = _reference_hits(d, qt)
        assert _probe(d, s, qt) == want, n
        assert int(tws._count_hits_merge_kernel(d, qt)) == want, n
        # the join: the queries sorted, then the search
        sample = _layout(d, s)
        got = tws._count_hits_probe_kernel(d, sample, s, qt)
        assert int(got) == want, n


@pytest.mark.parametrize("n_cols", [1, 2])
def test_probe_edges(n_cols):
    rng = np.random.default_rng(3 + n_cols)
    vocab = _vocab(rng, n_cols)
    data = _rows(_sorted_rows(_words(rng, 999, n_cols, vocab[..., :100])))
    present = _rows(_words(rng, 321, n_cols, vocab[..., :100]))
    absent = _rows(_words(rng, 321, n_cols, vocab[..., 100:]))
    for s in STRIDES:
        assert _probe(data, s, present) == 321  # every query present
        assert _probe(data, s, absent) == 0  # every query absent
        only_sentinels = torch.full_like(present, SENTINEL)
        assert _probe(data, s, only_sentinels) == 0
    empty = _cols(data[..., :0])
    assert int(probe.probe_hits_plain(empty, _cols(present))) == 0
    assert int(probe.probe_hits(empty, empty, 2, _cols(present))) == 0
    # every row a duplicate, and the first and last rows queried
    dups = data.repeat_interleave(3, dim=-1)
    ends = torch.cat([data[..., :1], data[..., -1:]], dim=-1)
    assert _probe(dups, 2, ends) == 2


def test_search_layout():
    data = torch.arange(0, 3000, 3)
    (sample,), s = probe.search_layout((data,))
    assert s == probe.STRIDE_LOG == 5
    assert torch.equal(sample, data[::32]) and sample.is_contiguous()
    two = torch.stack([data, data + 1])
    cols, s = probe.search_layout(tuple(two))
    assert all(torch.equal(c, x[::32]) for c, x in zip(cols, two))


@pytest.mark.parametrize("run", [1, 2, 31, 32, 33, 1000])
def test_plain_route_finds_rows_in_runs_of_column_0(run):
    """Two columns whose column 0 repeats in runs of `run` rows: the plain
    route's lower bound on column 1 inside a run, at run lengths around
    its levels, against a set of the index's rows; queries unsorted.
    Then column 0 alone, one column."""
    rng = np.random.default_rng(run)
    n = 40 * run
    # column 1 even, each value twice (duplicate rows) where run > 1
    data = np.stack([np.arange(n) // run * 3, np.arange(n) % run // 2 * 4])
    data = np.concatenate([data, np.full((2, 3), SENTINEL)], axis=-1)
    q = np.stack([rng.integers(-1, n // run * 3 + 2, 2000),
                  rng.integers(-1, 2 * run + 2, 2000)])
    q[:, ::17] = SENTINEL
    rows = {tuple(r) for r in data.T.tolist() if r[0] != SENTINEL}
    want = sum(tuple(r) in rows for r in q.T.tolist())
    got = probe.probe_hits_plain(_cols(_rows(data)), _cols(_rows(q)))
    assert int(got) == want > 0
    one = probe.probe_hits_plain((_rows(data[0]),), (_rows(q[0]),))
    assert int(one) == sum(x in set(data[0][:n].tolist())
                           for x in q[0].tolist())


def test_the_join_selector_follows_the_bytes():
    # a read batch of 2^24 rows: against a bacterial genome's index
    # (8.4M rows live) the merge join, against a human genome's the probe
    batch = 1 << 24
    assert not tws._probe_cheaper(1 << 23, batch)
    assert tws._probe_cheaper(3_117_275_477, batch)
    merge, probe_b = tws._join_bytes(3_117_275_477, batch)
    assert merge == tws._MERGE_JOIN_ROW_BYTES * (3_117_275_477 + batch)
    assert probe_b == batch * (8 + 32 * 30)
    assert probe_b * 40 < merge
    # a batch as large as the index merges from 2^18 rows
    for log in range(18, 33):
        assert not tws._probe_cheaper(1 << log, 1 << log)
    # a small batch against a large index probes, two columns too
    assert tws._probe_cheaper(1 << 20, 1 << 10)
    assert tws._probe_cheaper(1 << 20, 1 << 10, 2)


@pytest.mark.parametrize("k,lens", [
    (25, [150] * 40),  # reads of one length, the host screen's
    (25, [30, 5, 24, 25, 26, 3, 200]),  # records shorter than K
    (13, [7, 7, 7, 500, 1]),  # halos that overlap
    (59, [3000]),  # one record: only the padded tail is blanked
])
def test_packed_slabs_count_their_valid_rows(k, lens):
    """A packed slab's `n_valid` (counted on the host) equals the rows
    that the device's word pipeline leaves valid, over several slabs."""
    rng = np.random.default_rng(k + len(lens))
    offsets = np.concatenate([[0], np.cumsum(lens)])
    codes = rng.integers(0, 4, int(offsets[-1]), dtype=np.uint8)
    idx = CBL(k=k, device="cpu")
    slabs = idx.pack_stream(codes, offsets, slab=4096).slabs
    got = [s.n_valid for s in slabs]
    want = []
    for nk_pad, stream, s_arr, e_arr, _ in slabs:
        words, _ = tcbl._device_words(stream, s_arr, e_arr, nk_pad, idx.cfg,
                                      False)
        w0 = words if words.dim() == 1 else words[0]
        want.append(int((w0 != SENTINEL).sum()))
    assert got == want
    assert sum(want) == sum(max(n - k + 1, 0) for n in lens)


def test_query_hands_each_slab_s_valid_rows_to_the_probe(monkeypatch):
    seen = []
    orig = tws.probe_hits
    monkeypatch.setattr(tws, "probe_hits", lambda *a: seen.append(a[-1])
                        or orig(*a))
    rng = np.random.default_rng(12)
    g = rng.integers(0, 4, 40_000, dtype=np.uint8)
    idx = _index(25, True, g)
    q = g[:9000]
    qoff = np.arange(0, len(q) + 1, 150)
    ps = idx.pack_stream(q, qoff, slab=4096)
    idx.query_codes_stream(ps)
    assert seen == [s.n_valid for s in ps.slabs]
    assert sum(seen) == len(qoff[1:]) * (150 - 25 + 1)


def _index(k, canonical, codes, slab=4096, pending_cap=1024):
    idx = CBL(k=k, canonical=canonical, device="cpu",
              prefix_bits=24 if k <= 31 else 28, pending_cap=pending_cap)
    idx.insert_codes_stream(idx.pack_stream(
        codes, np.array([0, len(codes)]), slab=slab))
    return idx


def _counters(before):
    return {k: v - before.get(k, 0) for k, v in profiling.COUNTERS.items()
            if v != before.get(k, 0)}


@pytest.mark.parametrize("k,canonical", [(25, True), (25, False),
                                         (59, True)])
def test_count_hits_device_takes_the_probe_and_keeps_its_layout(k,
                                                                canonical):
    rng = np.random.default_rng(k)
    g = rng.integers(0, 4, 40_000, dtype=np.uint8)
    idx = _index(k, canonical, g)  # later slabs merge in (_merge_into)
    ws = idx.wordset
    assert ws._dups and ws.n_pending == 0 and ws._search is None
    q = np.concatenate([g[500:2500], rng.integers(0, 4, 2000,
                                                  dtype=np.uint8)])
    qoff = np.array([0, 2000, 4000])
    before = dict(profiling.COUNTERS)
    got = [idx.query_codes_stream(q, qoff) for _ in range(2)]
    d = _counters(before)
    assert d["join.probe"] == 2 and "join.merge" not in d
    assert d["index.search_layout"] == 1 and d["probe_rows"] == 2 * 4096
    # the merge join over the same index gives the same answers
    nk, stream, s_arr, e_arr, _ = idx.pack_stream(q, qoff).slabs[0]
    words, _ = tcbl._device_words(stream, s_arr, e_arr, nk, idx.cfg,
                                  canonical)
    live = ws._live()
    assert int(tws._count_hits_merge_kernel(live, words)) == got[0][1]
    sample, s = ws._search_layout(live)
    assert int(tws._count_hits_probe_kernel(live, sample, s, words)) \
        == got[0][1]
    fresh = CBL(k=k, canonical=canonical, device="cpu",
                prefix_bits=idx.cfg.prefix_bits)
    fresh.insert_codes_stream(g, np.array([0, len(g)]))
    assert got == [fresh.query_codes_stream(q, qoff)] * 2
    assert 0 < got[0][1] < got[0][0]
    # a change of the index drops the layout; the next probe rebuilds it
    more = rng.integers(0, 4, 6_000, dtype=np.uint8)
    idx.insert_codes_stream(more, np.array([0, len(more)]))
    fresh.insert_codes_stream(more, np.array([0, len(more)]))
    idx.flush()
    assert ws._search is None
    before = dict(profiling.COUNTERS)
    assert idx.query_codes_stream(q, qoff) == \
        fresh.query_codes_stream(q, qoff)
    assert _counters(before)["index.search_layout"] == 1


def test_logs_and_holes_keep_their_joins():
    rng = np.random.default_rng(8)
    g = rng.integers(0, 4, 30_000, dtype=np.uint8)
    q = g[:3000]
    one = np.array([0, len(q)])
    idx = _index(25, False, g)
    idx.insert_kmers([12345])  # a pending log
    before = dict(profiling.COUNTERS)
    idx.query_codes_stream(q, one)
    assert _counters(before).get("join.merge") == 1
    b = _index(25, False, g[10_000:])
    holes = idx - b
    assert holes.wordset._holes
    before = dict(profiling.COUNTERS)
    holes.query_codes_stream(q, one)
    d = _counters(before)
    assert d.get("join.merge") == 1 and "join.probe" not in d


@pytest.mark.parametrize("k,canonical", [(13, True), (25, False),
                                         (25, True), (59, True)])
@pytest.mark.parametrize("block", [1, 777, 4096, 1 << 20])
def test_export_in_blocks_equals_kmers_limbs(k, canonical, block):
    rng = np.random.default_rng(k + block)
    g = rng.integers(0, 4, 20_000, dtype=np.uint8)
    g = np.concatenate([g, g[3000:11000]])  # duplicates across slabs
    idx = _index(k, canonical, g)
    idx.flush()
    assert idx.wordset._dups
    before = dict(profiling.COUNTERS)
    blocks = list(idx.iter_kmers_limbs(block))
    n = idx.wordset._n_upper
    assert _counters(before)["syncs.export_blocks"] == len(blocks) \
        == -(-n // block)
    got = np.concatenate([b.cpu().numpy().view(np.uint32) for b in blocks])
    want = idx.kmers_limbs()  # its dedup sort changes the state: after
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(want) == idx.count()


@pytest.mark.parametrize("state", ["holes", "pending", "empty"])
def test_export_in_blocks_of_other_states(state):
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 9_000, dtype=np.uint8)
    if state == "empty":
        idx = CBL(k=25, device="cpu")
    else:
        idx = _index(25, True, g)
    if state == "holes":
        idx = idx - _index(25, True, g[4000:])
        assert idx.wordset._holes
    if state == "pending":
        idx.remove_kmers([int(x) for x in rng.integers(0, 1 << 50, 5)])
        idx.insert_kmers([int(x) for x in rng.integers(0, 1 << 50, 5)])
        assert idx.wordset.n_pending
    got = [b.cpu().numpy().view(np.uint32)
           for b in idx.iter_kmers_limbs(1000)]
    got = np.concatenate(got) if got else np.zeros((0, 2), np.uint32)
    assert np.array_equal(got, idx.kmers_limbs())


@pytest.mark.parametrize("rows", [1, 7, 64, 1000, 1 << 20])
def test_distinct_count_in_blocks(monkeypatch, rows):
    rng = np.random.default_rng(rows)
    for n_cols in (1, 2):
        vocab = _vocab(rng, n_cols, 300)
        data = _rows(_sorted_rows(_words(rng, 2000, n_cols, vocab)))
        data = torch.cat([data, torch.full(data.shape[:-1] + (9,),
                                           SENTINEL)], dim=-1)
        want = len({r for r in zip(*data.reshape(n_cols, -1).tolist())
                    if r[0] != SENTINEL})
        assert int(tws._distinct_count(data)) == want
        monkeypatch.setattr(tws, "_COUNT_ROWS", rows)
        assert int(tws._distinct_count(data)) == want
        monkeypatch.undo()


def test_a_long_stream_memoizes_no_more_than_its_bound(monkeypatch):
    monkeypatch.setattr(tcbl, "_MEMO_ROWS", 3 * 4096)
    rng = np.random.default_rng(2)
    g = rng.integers(0, 4, 30_000, dtype=np.uint8)
    idx = CBL(k=25, device="cpu", pending_cap=1024)
    ps = idx.pack_stream(g, np.array([0, len(g)]), slab=4096)
    assert len(ps.slabs) == 8
    idx.insert_codes_stream(ps)
    assert sorted(ps._words) == [0, 1, 2]
    assert sum(w.shape[-1] for w, _, _ in ps._words.values()) <= 3 * 4096
    # the slabs left out run the word pipeline again; answers are equal
    fresh = CBL(k=25, device="cpu")
    fresh.insert_codes_stream(g, np.array([0, len(g)]))
    assert idx.query_codes_stream(ps) == \
        fresh.query_codes_stream(g, np.array([0, len(g)]))
    assert idx.count() == fresh.count()


# --- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n_cols", [1, 2])
@pytest.mark.parametrize("s", STRIDES + [10])
def test_cuda_probe_equals_plain(cuda, n_cols, s):
    from cbl_tpu_torch.ops import LAUNCHES

    rng = np.random.default_rng(100 * s + n_cols)
    vocab = _vocab(rng, n_cols, 5000)
    for n in _sizes(s) + [1 << 20]:
        data = _sorted_rows(_words(rng, n, n_cols, vocab[..., :3000]))
        data = np.concatenate([data, np.full(data.shape[:-1] + (5,),
                                             SENTINEL)], axis=-1)
        q = _sorted_rows(_with_sentinels(_words(rng, 1 << 14, n_cols,
                                                vocab), 13))
        d, qt = _rows(data), _rows(q)
        want = int(probe.probe_hits_plain(_cols(d), _cols(qt)))
        dc, qc = d.to(cuda), qt.to(cuda)
        n0 = LAUNCHES["probe"]
        got = probe.probe_hits(_cols(dc), _layout(dc, s), s, _cols(qc))
        assert int(got) == want == _reference_hits(d, qt), n
        assert LAUNCHES["probe"] == n0 + 1


@pytest.mark.gpu
def test_cuda_probe_past_2_31_rows(cuda):
    """An index of 2^31 + 2^20 rows (the even numbers below twice that,
    17.2 GB): rows and their positions pass 2^31.  Queries are sorted
    numbers around it, even ones (and only those below the end) hit."""
    n = (1 << 31) + (1 << 20)
    free, _ = torch.cuda.mem_get_info(cuda)
    if free < 8 * n + (4 << 30):
        pytest.skip(f"needs {8 * n + (4 << 30)} bytes of device memory, "
                    f"{free} free")
    data = torch.arange(0, 2 * n, 2, dtype=torch.int64, device=cuda)
    (sample,), s = probe.search_layout((data,))
    assert s == probe.STRIDE_LOG and sample.numel() == -(-n // (1 << s))
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randint(0, 2 * n + 4096, (1 << 20,), device=cuda,
                      generator=gen)
    q[-4:] = torch.tensor([2 * n - 2, 2 * n, (1 << 32) + 2, 0])
    q = torch.sort(q).values
    want = int(((q % 2 == 0) & (q < 2 * n)).sum())
    got = probe.probe_hits((data,), (sample,), s, (q,))
    assert int(got) == want
    assert int(probe.probe_hits_plain((data,), (q,))) == want


@pytest.mark.gpu
def test_cuda_index_over_slabs_probes_like_it_merges(cuda):
    from cbl_tpu_torch.ops import LAUNCHES

    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, 1 << 20, dtype=np.uint8)
    q = np.concatenate([g[1000:41000], rng.integers(0, 4, 40_000,
                                                    dtype=np.uint8)])
    qoff = np.arange(0, len(q) + 1, 100)
    out = []
    for dev in ("cpu", cuda):
        idx = CBL(k=25, canonical=True, device=dev, pending_cap=1 << 14)
        idx.insert_codes_stream(idx.pack_stream(
            g, np.array([0, len(g)]), slab=1 << 16))
        n0 = LAUNCHES["probe"]
        out.append(idx.query_codes_stream(q, qoff))
        if dev != "cpu":
            assert LAUNCHES["probe"] == n0 + 1  # one slab of queries
            blocks = list(idx.iter_kmers_limbs(1 << 18))
            got = np.concatenate([b.cpu().numpy().view(np.uint32)
                                  for b in blocks])
            assert np.array_equal(got, idx.kmers_limbs())
    assert out[0] == out[1] and 0 < out[0][1] < out[0][0]
