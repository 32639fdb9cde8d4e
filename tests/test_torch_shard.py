"""Parity of `cbl_tpu_torch.parallel.ShardedCBL` with `cbl_tpu`'s.

The port runs on a mesh of D shards that all name the CPU
(`[torch.device("cpu")] * D`), `cbl_tpu` on `make_mesh(jax.devices()[:D])`
of `tests/conftest.py`'s eight virtual CPU devices; the same seeded bases
go through both.  Every comparison is exact: the whole sharded state
after each step (every shard's rows with their duplicates and padding,
the boundaries, the counts, the capacity, `_dups`, `_count_upper`, and
while rounds run each shard's log with its seq, real-row bound and
capacity), the answers and masks, the files.

- `_route_sorted` against `cbl_tpu`'s on sorted rows with drops, payloads
  and sentinel rows; the default boundaries for D = 1 to 8 at K=25, 59;
- a D=8 build against `cbl_tpu` and a single index; queries, hit counts,
  ordered masks (`contains_codes_stream`, `contains_seqs`,
  `contains_words`) at D = 8, a D=6 mesh through the word-level paths,
  D = 1's bulk paths;
- bulk removes; under a partition that sends every word to shard 0 the
  port's remove is exact (count 0, a Python set's) where `cbl_tpu`'s
  routing drops words silently (28,672 left: the recorded divergence);
- insert overflow recovery and the sticky corrupt flag; repartition of
  skewed growth; the four set operations, `merge_many`,
  `intersect_many` and misaligned boundaries (a resharded copy);
- dynamic rounds round by round at D = 1 and 8 (K=25, across the seq
  cap), K=13 past seq 62 (a tag column, no cap) and K=59; the mixed API
  after rounds; staged streams and their memo;
- checkpoints both ways, a single-index file through `from_cbl`,
  `from_cbl` / `to_cbl` / `iter_words_chunks`, and `state.
  sharded_from_arrays` carrying `cbl_tpu`'s state (clean, with
  duplicates, with a live log) before more work in both.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from cbl_tpu import CBL as RefCBL
from cbl_tpu.parallel import ShardedCBL as RefSharded
from cbl_tpu.parallel import make_mesh as ref_make_mesh
from cbl_tpu.parallel import shard as ref_shard
from cbl_tpu_torch import CBL, state
from cbl_tpu_torch.config import get_config
from cbl_tpu_torch.limbs import SENTINEL, from_limbs, key_cols, to_limbs
from cbl_tpu_torch.parallel import ShardedCBL, make_mesh
from cbl_tpu_torch.parallel import shard as tshard

torch.set_num_threads(2)

CPU = torch.device("cpu")
U32 = 0xFFFFFFFF


def _meshes(D: int):
    return ref_make_mesh(jax.devices()[:D]), [CPU] * D


def _pair(D: int, k: int = 25, pb: int = 24, canonical: bool = False,
          B: int = 512):
    rmesh, tmesh = _meshes(D)
    return (RefSharded(k=k, prefix_bits=pb, canonical=canonical, mesh=rmesh,
                       batch_per_device=B),
            ShardedCBL(k=k, prefix_bits=pb, canonical=canonical, mesh=tmesh,
                       batch_per_device=B))


def _codes(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)


def _off(codes) -> np.ndarray:
    return np.array([0, len(codes)], dtype=np.int64)


def _keys(limbs_u32: np.ndarray, k: int = 25, pb: int = 24) -> np.ndarray:
    return from_limbs(np.asarray(limbs_u32), key_cols(get_config(k, pb)))


def _ref_arrays(x) -> dict:
    """`cbl_tpu`'s sharded state as `state.sharded_to_arrays` gives the
    port's, read without side effects."""
    counts = (x._counts_host if x._counts_host is not None
              else None if x._counts_dev is None
              else np.asarray(x._counts_dev).astype(np.int64))
    return dict(
        data=np.asarray(x.data), boundaries=np.asarray(x.boundaries, np.uint32),
        counts=counts, dups=x._dups,
        count_upper=x._count_upper,
        boundaries_from_data=x._boundaries_from_data,
        slog=(None if x._slog_dev is None
              else tuple(np.asarray(c) for c in x._slog_dev)),
        slog_seq=x._slog_seq, slog_real=x._slog_real,
        slog_live=(None if x._slog_live_dev is None
                   else int(np.asarray(x._slog_live_dev)[0])))


def _same_state(ref, port, what=""):
    a, b = _ref_arrays(ref), state.sharded_to_arrays(port)
    assert ref.C == port.C, what
    assert set(a) == set(b)
    for key in a:
        if key == "slog" and a[key] is not None:
            assert b[key] is not None and len(a[key]) == len(b[key]), what
            for x, y in zip(a[key], b[key]):
                np.testing.assert_array_equal(x, y, err_msg=f"{what} {key}")
        else:
            np.testing.assert_array_equal(a[key], b[key],
                                          err_msg=f"{what} {key}")


def _same_words(ref, port):
    np.testing.assert_array_equal(port.words_array(), ref.words_array())
    np.testing.assert_array_equal(port.shard_counts, ref.shard_counts)
    assert port.count() == ref.count()


# --- routing and construction -------------------------------------------------


@pytest.mark.parametrize("k,include_sentinels", [
    (25, False), (25, True), (59, False), (59, True)])
def test_route_sorted_matches_cbl_tpu(k, include_sentinels):
    """One shard's send buffer, payload and drop count at D = 5 with
    buckets of 16 rows: skewed runs overflow, boundaries repeat and one is
    the all-ones row."""
    pb = 24 if k == 25 else 28
    cfg = get_config(k, pb)
    rng = np.random.default_rng(k)
    n, D, cap = 96, 5, 16
    L = cfg.word_limbs
    top = cfg.n_bits - 32 * (L - 1)
    limbs = rng.integers(0, 1 << 32, size=(n, L), dtype=np.uint64)
    limbs[:, 0] &= (1 << top) - 1
    limbs[:40, 0] = 0  # a crowded low range: bucket 0 overflows
    limbs = limbs.astype(np.uint32)
    limbs[-7:] = U32  # sentinel rows
    order = np.lexsort(limbs.T[::-1])
    limbs = limbs[order]
    bnd = limbs[[30, 30, 70]].copy()
    bnd = np.concatenate([bnd, np.full((1, L), U32, np.uint32)])
    pos = np.arange(n, dtype=np.uint32)
    send, (ppos,), dropped = ref_shard._route_sorted(
        jax.numpy.asarray(limbs), jax.numpy.asarray(bnd), D, cap,
        payload=(jax.numpy.asarray(pos),),
        include_sentinels=include_sentinels)
    n_cols = key_cols(cfg)
    tsend, (tpos,), tdropped = tshard._route_sorted(
        torch.from_numpy(from_limbs(limbs, n_cols)),
        torch.from_numpy(from_limbs(bnd, n_cols)), cap,
        payload=(torch.arange(n),), include_sentinels=include_sentinels)
    want = np.asarray(send).reshape(D * cap, L)
    got = to_limbs(tsend.reshape(-1, D * cap).squeeze(0).numpy(), L)
    np.testing.assert_array_equal(got, want)
    wpos = np.asarray(ppos).astype(np.int64).reshape(-1)
    wpos[wpos == U32] = SENTINEL
    np.testing.assert_array_equal(tpos.reshape(-1).numpy(), wpos)
    assert int(tdropped) == int(dropped) > 0


@pytest.mark.parametrize("D", range(1, 9))
@pytest.mark.parametrize("k", [25, 59])
def test_default_boundaries(D, k):
    pb = 24 if k == 25 else 28
    rmesh, tmesh = _meshes(D)
    ref = RefSharded(k=k, prefix_bits=pb, mesh=rmesh)
    port = ShardedCBL(k=k, prefix_bits=pb, mesh=tmesh)
    assert port.D == D and port.C == ref.C
    np.testing.assert_array_equal(port.boundary_limbs(),
                                  np.asarray(ref.boundaries, np.uint32))
    assert port.count() == 0
    np.testing.assert_array_equal(port.shard_counts, np.zeros(D))


def test_make_mesh_names_devices():
    assert make_mesh(["cpu", torch.device("cpu")]) == [CPU, CPU]
    with pytest.raises(ValueError, match="at least one"):
        make_mesh([])


# --- bulk build, queries, masks -----------------------------------------------


@pytest.fixture(scope="module")
def built8():
    """A D=8 build of 24,000 bases in both packages, and the words."""
    codes = _codes(24_000, 0)
    ref, port = _pair(8, B=1024)
    ref.insert_codes_stream(codes, _off(codes))
    port.insert_codes_stream(codes, _off(codes))
    return ref, port, codes


def test_d8_build_matches_cbl_tpu_and_single_index(built8):
    ref, port, codes = built8
    _same_state(ref, port, "after the build")  # duplicate rows included
    assert port._dups and port._boundaries_from_data
    single = CBL(k=25, device="cpu")
    single.insert_codes_stream(codes, _off(codes))
    words = port.words_array()
    np.testing.assert_array_equal(words, single.wordset.words_array())
    np.testing.assert_array_equal(words, ref.words_array())
    _same_state(ref, port, "after the export's dedup")
    rows = port.local_shard_rows()
    assert list(rows) == list(range(8))
    for d, r in ref.local_shard_rows().items():
        np.testing.assert_array_equal(rows[d], r)
    np.testing.assert_array_equal(port.shard_balance(), ref.shard_balance())


def _query_stream(codes):
    other = _codes(6_000, 1)
    q = np.concatenate([codes[:5_000], other, codes[9_000:9_030], other[:10]])
    return q, np.array([0, 5_000, 11_000, 11_030, len(q)], dtype=np.int64)


@pytest.mark.parametrize("call", ["query", "count_hits", "contains_stream",
                                  "contains_seqs", "contains_words"])
def test_d8_queries_and_masks(built8, call):
    ref, port, codes = built8
    q, qoff = _query_stream(codes)
    if call == "query":
        got, want = port.query_codes_stream(q, qoff), ref.query_codes_stream(
            q, qoff)
        assert got == want and 0 < got[1] < got[0]
    elif call == "count_hits":
        stored = _single_words(codes)[:1500]  # no export: states unchanged
        miss = stored.copy()
        miss[:, -1] ^= 1
        mixed = np.concatenate([stored, miss])
        got = port.count_hits(_keys(mixed))
        assert got == ref.count_hits(mixed) and 1500 <= got < 3000
    elif call in ("contains_stream", "contains_seqs"):
        if call == "contains_stream":
            got = port.contains_codes_stream(q, qoff)
            want = ref.contains_codes_stream(q, qoff)
        else:
            seqs = [codes[:2_000], _codes(1_500, 2), codes[4_000:5_000],
                    codes[:10]]
            got, want = port.contains_seqs(seqs), ref.contains_seqs(seqs)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert any(g.any() for g in got) and not all(g.all() for g in got)
    else:
        stored = _single_words(codes)[::7]
        miss = stored.copy()
        miss[:, -1] ^= 1
        mixed = np.concatenate([miss[:300], stored, miss[300:]])
        got = port.contains_words(_keys(mixed))
        np.testing.assert_array_equal(got, ref.contains_words(mixed))
        assert got.sum() >= len(stored)
    _same_state(ref, port, call)  # queries change no state


def test_d6_mesh_word_level_paths():
    """A mesh that is not a power of two through the bulk build and the
    word-level insert, remove and contains."""
    codes = _codes(9_000, 55)
    ref, port = _pair(6)
    ref.insert_codes_stream(codes, _off(codes))
    port.insert_codes_stream(codes, _off(codes))
    _same_state(ref, port, "build")
    _same_words(ref, port)  # both drop their duplicates
    extra = ref.words_array()[:64]
    miss = extra.copy()
    miss[:, -1] ^= 1
    both = np.concatenate([extra, miss])
    np.testing.assert_array_equal(port.contains_words(_keys(both)),
                                  ref.contains_words(both))
    ref.remove_words(extra)
    port.remove_words(_keys(extra))
    _same_state(ref, port, "remove_words")
    ref.insert_words(both)
    port.insert_words(torch.from_numpy(_keys(both)))
    _same_state(ref, port, "insert_words")
    seqs = [codes[:2_000], _codes(1_000, 56)]
    for g, w in zip(port.contains_seqs(seqs), ref.contains_seqs(seqs)):
        np.testing.assert_array_equal(g, np.asarray(w))
    _same_words(ref, port)


def test_d1_bulk_paths():
    codes, other = _codes(12_000, 3), _codes(4_000, 4)
    ref, port = _pair(1)
    for x in (ref, port):
        x.insert_codes_stream(codes, _off(codes))
        x.insert_codes_stream(other, _off(other))
    _same_state(ref, port, "inserts")
    q, qoff = _query_stream(codes)
    assert port.query_codes_stream(q, qoff) == ref.query_codes_stream(q, qoff)
    for g, w in zip(port.contains_codes_stream(q, qoff),
                    ref.contains_codes_stream(q, qoff)):
        np.testing.assert_array_equal(g, np.asarray(w))
    for x in (ref, port):
        x.remove_codes_stream(other, _off(other))
    _same_state(ref, port, "remove")
    _same_words(ref, port)


# --- remove, overflow, repartition --------------------------------------------


def test_bulk_remove_matches_cbl_tpu():
    c1, c2 = _codes(20_000, 80), _codes(9_000, 81)
    ref, port = _pair(8, B=1024)
    for x in (ref, port):
        x.insert_codes_stream(c1, _off(c1))
        x.insert_codes_stream(c2, _off(c2))
    _same_state(ref, port, "inserts")
    for x in (ref, port):
        x.remove_codes_stream(c2, _off(c2))
    _same_state(ref, port, "remove c2")
    _same_words(ref, port)
    for x in (ref, port):
        x.remove_codes_stream(c1, _off(c1))
    _same_state(ref, port, "remove c1")
    assert port.count() == ref.count() == 0


def test_remove_under_skew_is_exact():
    """Every word on shard 0 (`insert_words` under boundaries that send
    every word there), then a bulk remove of the same bases: the port's
    count is 0, a Python set's; `cbl_tpu`'s routing drops the overflow of
    its 4096-row buckets silently and leaves 28,672 words."""
    codes = _codes(60_000, 5)
    single = RefCBL(k=25)
    single.insert_codes_stream(codes, _off(codes))
    words = single.wordset.words_array()
    assert len(words) == 59_976
    ref, port = _pair(8)
    ref.boundaries = np.full_like(np.asarray(ref.boundaries), U32)
    port.boundaries = np.full_like(port.boundaries, SENTINEL)
    for x, w in ((ref, words), (port, _keys(words))):
        x._boundaries_from_data = True
        x.insert_words(w)
    _same_state(ref, port, "all on shard 0")
    assert port.shard_counts[0] == 59_976
    for x in (ref, port):
        x.remove_codes_stream(codes, _off(codes))
    oracle = {tuple(r) for r in words} - {
        tuple(r) for r in single.wordset.words_array()}
    assert port.count() == len(oracle) == 0
    assert port.words_array().shape == (0, 2)
    assert ref.count() == 28_672  # cbl_tpu's silent loss (ROADMAP C)
    # half of the bases, from the same skew: the set difference
    half = codes[:30_000]
    port.insert_words(_keys(words))
    port.remove_codes_stream(half, _off(half))
    left = {tuple(r) for r in words} - {tuple(r) for r in _single_words(half)}
    assert port.count() == len(left) > 0
    assert {tuple(r) for r in port.words_array()} == left


def _single_words(codes):
    s = CBL(k=25, device="cpu")
    s.insert_codes_stream(codes, _off(codes))
    return s.wordset.words_array()


def test_insert_overflow_recovers():
    """Boundaries that send every word to shard 0 and a stream that
    overflows its buckets: both packages repartition, re-run with buckets
    twice as large and end with a repartition, to equal states."""
    codes = _codes(60_000, 3)
    ref, port = _pair(8)
    ref.boundaries = np.full_like(np.asarray(ref.boundaries), U32)
    port.boundaries = np.full_like(port.boundaries, SENTINEL)
    ref._boundaries_from_data = port._boundaries_from_data = True
    for x in (ref, port):
        x.insert_codes_stream(codes, _off(codes))
    assert (port.boundaries != SENTINEL).all()  # repartitioned
    _same_state(ref, port, "recovered")
    np.testing.assert_array_equal(port.words_array(), _single_words(codes))
    _same_words(ref, port)
    t, p = port.query_codes_stream(codes[:1000], np.array([0, 1000]))
    assert t == p == 1000 - 24
    bal = port.shard_balance()
    assert bal.max() <= 2 * -(-int(bal.sum()) // 8)


def test_overflow_flag_is_sticky():
    """A drop count left by a committed round is raised by the next
    blocking call, and every call after it raises that the index is
    corrupt."""
    codes = _codes(30_000, 4)
    ref, port = _pair(8)
    for x in (ref, port):
        x.insert_codes_stream(codes, _off(codes))
    ref._dropped_dev = jax.device_put(
        np.ones(8, dtype=np.int32), NamedSharding(ref.mesh, PartitionSpec("d")))
    port._dropped_dev = torch.tensor(1)
    for x in (ref, port):
        with pytest.raises(RuntimeError, match="bucket overflow"):
            x.query_codes_stream(codes[:1000], np.array([0, 1000]))
        with pytest.raises(RuntimeError, match="corrupt"):
            x.query_codes_stream(codes[:1000], np.array([0, 1000]))
    with pytest.raises(RuntimeError, match="corrupt"):
        ref.contains_words(np.zeros((4, 2), dtype=np.uint32))
    with pytest.raises(RuntimeError, match="corrupt"):
        port.contains_words(np.zeros(4, dtype=np.int64))
    with pytest.raises(RuntimeError, match="corrupt"):
        port.dynamic_round(*[(codes[:5000], np.array([0, 5000]))] * 3)


def test_repartition_rebalances_skewed_growth():
    codes = _codes(60_000, 9)
    ref, port = _pair(8)
    for x in (ref, port):
        x.insert_codes_stream(codes, _off(codes))
    skew = np.zeros((30_000, 2), dtype=np.uint32)
    skew[:, 1] = np.arange(30_000, dtype=np.uint32)
    ref.insert_words(skew)
    port.insert_words(np.arange(30_000, dtype=np.int64))
    _same_state(ref, port, "skewed growth")
    bal0 = port.shard_balance()
    total = int(bal0.sum())
    assert bal0.max() > 2 * -(-total // 8)
    before = port.words_array()
    for x in (ref, port):
        x.repartition()
    _same_state(ref, port, "repartitioned")
    bal = port.shard_balance()
    assert int(bal.sum()) == total and bal.max() <= 2 * -(-total // 8)
    np.testing.assert_array_equal(port.words_array(), before)
    assert port.contains_words(_keys(before[:100])).all()


# --- set algebra -------------------------------------------------------------


@pytest.fixture(scope="module")
def operands():
    """(ref, port) pairs a and b of 5,000 bases each, D = 8, and their
    single indexes."""
    out = []
    for seed in (6, 7):
        codes = _codes(5_000, seed)
        ref, port = _pair(8)
        ref.insert_codes_stream(codes, _off(codes))
        port.insert_codes_stream(codes, _off(codes))
        single = CBL(k=25, device="cpu")
        single.insert_codes_stream(codes, _off(codes))
        out.append((ref, port, single))
    return out


@pytest.mark.parametrize("op", ["__or__", "__and__", "__sub__", "__xor__"])
def test_set_operations(operands, op):
    (ra, pa, sa), (rb, pb, sb) = operands
    want = getattr(ra, op)(rb)
    got = getattr(pa, op)(pb)
    _same_state(want, got, op)
    np.testing.assert_array_equal(got.words_array(),
                                  getattr(sa, op)(sb).wordset.words_array())
    _same_words(want, got)


def test_merge_many_and_intersect_many(operands):
    (ra, pa, sa), (rb, pb, sb) = operands
    got, want = (ShardedCBL.merge_many([pa, pb, pa]),
                 RefSharded.merge_many([ra, rb, ra]))
    _same_state(want, got, "merge_many")
    np.testing.assert_array_equal(got.words_array(),
                                  CBL.merge([sa, sb]).wordset.words_array())
    got, want = (ShardedCBL.intersect_many([pa, pb]),
                 RefSharded.intersect_many([ra, rb]))
    _same_state(want, got, "intersect_many")
    assert got.count() == CBL.intersect([sa, sb]).count()
    single = ShardedCBL.merge_many([pa])
    _same_state(RefSharded.merge_many([ra]), single, "merge_many of one")


def test_misaligned_boundaries_reshard():
    c1, c2 = _codes(4_000, 31), _codes(4_000, 32)
    (ra, pa), (rb, pb) = _pair(8), _pair(8)
    for x, c in ((ra, c1), (pa, c1), (rb, c2), (pb, c2)):
        x.insert_codes_stream(c, _off(c))
    assert not np.array_equal(pa.boundaries, pb.boundaries)
    want, got = ra | rb, pa | pb
    _same_state(want, got, "union of misaligned operands")
    _same_words(want, got)
    with pytest.raises(ValueError, match="canonical"):
        pa | ShardedCBL(k=25, canonical=True, mesh=[CPU] * 8)
    with pytest.raises(ValueError, match="meshes"):
        pa | ShardedCBL(k=25, mesh=[CPU] * 4)


# --- dynamic rounds ----------------------------------------------------------


def _run_rounds(ref, port, codes, sb, rounds, order=None):
    """Rounds i = (segment i, the segment before, the first half of i),
    the states compared after each."""
    off, off_h = np.array([0, sb]), np.array([0, sb // 2])
    for i in order if order is not None else range(rounds):
        j = i % (len(codes) // sb)
        seg = codes[j * sb : (j + 1) * sb]
        q0 = codes[max(j - 1, 0) * sb : (max(j - 1, 0) + 1) * sb]
        args = ((seg, off), (q0, off), (seg[: sb // 2], off_h))
        want = ref.dynamic_round(*args)
        got = port.dynamic_round(*args)
        assert got == want, i
        _same_state(ref, port, f"round {i}")
        assert port.count() == ref.count()


@pytest.mark.parametrize("D", [1, 8])
def test_dynamic_rounds_k25(D):
    """Four rounds, then both logs' seq jumped to 60: the rounds at seq 61
    and 62 run, and the next folds first (`cbl_tpu` packs its 8-bit tag at
    K=25) in both."""
    codes = _codes(16_000, 77)
    ref, port = _pair(D)
    _run_rounds(ref, port, codes, 4_000, 4)
    ref._slog_seq = port.slog.seq = 60
    _run_rounds(ref, port, codes, 4_000, 3, order=[0, 1, 2])
    assert port.slog.seq == 1  # folded before seq 63
    assert port.slog.keys is not None
    _same_words(ref, port)
    assert port.slog.keys is None  # the export folded
    single = CBL(k=25, device="cpu")
    np.testing.assert_array_equal(
        port.words_array(), _oracle_rounds(single, codes, 4_000,
                                           [0, 1, 2, 3, 0, 1, 2]))


def _oracle_rounds(single, codes, sb, order):
    off, off_h = np.array([0, sb]), np.array([0, sb // 2])
    for j in order:
        seg = codes[j * sb : (j + 1) * sb]
        single.insert_codes_stream(seg, off)
        single.remove_codes_stream(seg[: sb // 2], off_h)
    return single.wordset.words_array()


@pytest.mark.parametrize("D", [1, 8])
def test_dynamic_rounds_k13_run_past_seq_62(D):
    """K=13: `cbl_tpu` keeps a tag column and never folds at seq 62; nor
    does the port (its log has a tag column there too)."""
    codes = _codes(12_000, 13)
    ref, port = _pair(D, k=13, pb=20)
    _run_rounds(ref, port, codes, 3_000, 2)
    ref._slog_seq = port.slog.seq = 60
    _run_rounds(ref, port, codes, 3_000, 4, order=[2, 3, 0, 1])
    assert port.slog.seq == 64 and port.slog.keys[0].shape[0] == 2
    _same_words(ref, port)


@pytest.mark.parametrize("D", [1, 8])
def test_dynamic_rounds_k59(D):
    """K=59: the log's words are two columns and a tag column (C = 3)."""
    codes = _codes(12_000, 123)
    ref, port = _pair(D, k=59, pb=28)
    _run_rounds(ref, port, codes, 4_000, 3)
    assert port.slog.keys[0].shape[0] == 3
    _same_words(ref, port)


def test_mixed_api_after_rounds():
    """A query, a second round after the fold, set algebra and removes
    after rounds, as `cbl_tpu` runs them."""
    codes = _codes(24_000, 78)
    off = np.array([0, 8_000])
    ref, port = _pair(8)
    for x in (ref, port):
        x.dynamic_round((codes[:8_000], off), (codes[:8_000], off),
                        (codes[4_000:12_000], off))
    _same_state(ref, port, "round")
    q = codes[8_000:16_000]
    assert port.query_codes_stream(q, off) == ref.query_codes_stream(q, off)
    _same_state(ref, port, "query folded the log")
    args = ((codes[16_000:], off), (codes[:8_000], off), (codes[:8_000], off))
    assert port.dynamic_round(*args) == ref.dynamic_round(*args)
    _same_state(ref, port, "second round")
    got, want = port | port, ref | ref
    _same_state(want, got, "union after rounds")
    for x in (ref, port):
        x.remove_codes_stream(codes[:4_000], np.array([0, 4_000]))
    _same_state(ref, port, "remove after rounds")


def test_shard_counts_during_rounds():
    """A fresh index's `shard_balance()` during rounds folds the log and
    counts its words; `cbl_tpu`'s has no counts to read there."""
    codes = _codes(12_000, 79)
    ref, port = _pair(8)
    args = [(codes[i * 4_000 : (i + 1) * 4_000], np.array([0, 4_000]))
            for i in range(3)]
    for x in (ref, port):
        x.dynamic_round(*args)
    _same_state(ref, port, "round")
    n = port.count()  # read off the log's scan
    assert port.slog.keys is not None
    with pytest.raises(TypeError):
        ref.shard_balance()
    bal = port.shard_balance()
    assert port.slog.keys is None and int(bal.sum()) == n
    np.testing.assert_array_equal(port.words_array(), ref.words_array())


def test_staged_streams_and_memo():
    codes = _codes(24_000, 91)
    sb = 8_000
    off = np.array([0, sb])
    ref, port = _pair(8)
    rsegs = [ref.pack_stream(codes[i * sb : (i + 1) * sb], off)
             for i in range(3)]
    psegs = [port.pack_stream(codes[i * sb : (i + 1) * sb], off)
             for i in range(3)]
    for i in range(3):
        j = i - 1 if i else 0
        want = ref.dynamic_round(rsegs[i], rsegs[j], rsegs[0])
        got = port.dynamic_round(psegs[i], psegs[j], psegs[0], lazy=True)
        assert tuple(int(v) for v in got) == want
        assert 0 in psegs[i]._words
        _same_state(ref, port, f"round {i}")
    other = ShardedCBL(k=25, canonical=True, mesh=[CPU] * 8)
    with pytest.raises(ValueError, match="different"):
        other.dynamic_round(psegs[0], psegs[0], psegs[0])


def test_multi_group_round_takes_the_bulk_calls():
    """A stream of several sub-slab groups (D = 1 with sub-slabs capped at
    4096 k-mers) runs the separate calls in both packages."""
    codes = _codes(9_000, 92)
    ref, port = _pair(1)
    for x in (ref, port):
        x._SUB_SLAB_MAX = 4096
    args = ((codes, _off(codes)), (codes[:5_000], np.array([0, 5_000])),
            (codes[:2_000], np.array([0, 2_000])))
    assert port.dynamic_round(*args) == ref.dynamic_round(*args)
    assert port.slog.keys is None
    _same_state(ref, port, "bulk fallback")
    with pytest.raises(ValueError, match="tuples"):
        port.dynamic_round(port.pack_stream(*args[0]), *args[1:])


# --- conversion, export, checkpoints, state ----------------------------------


def test_checkpoints_both_ways(built8, tmp_path):
    ref, port, codes = built8
    ref.save_to_file(tmp_path / "ref.npz")
    port.save_to_file(tmp_path / "port.npz")
    with np.load(tmp_path / "ref.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    rmesh, tmesh = _meshes(8)
    got = ShardedCBL.load_from_file(tmp_path / "ref.npz", mesh=tmesh,
                                    batch_per_device=1024)
    want = RefSharded.load_from_file(tmp_path / "port.npz", mesh=rmesh,
                                     batch_per_device=1024)
    _same_state(want, got, "loaded")
    more = _codes(3_000, 71)
    for x in (want, got):
        x.insert_codes_stream(more, _off(more))
    _same_state(want, got, "insert after the load")
    with pytest.raises(ValueError, match="shards"):
        ShardedCBL.load_from_file(tmp_path / "ref.npz", mesh=[CPU] * 4)


def test_single_index_file_through_from_cbl(tmp_path):
    codes = _codes(6_000, 20)
    single = CBL(k=25, canonical=True, device="cpu")
    single.insert_codes_stream(codes, _off(codes))
    single.save_to_file(tmp_path / "one.npz")
    rmesh, tmesh = _meshes(8)
    got = ShardedCBL.load_from_file(tmp_path / "one.npz", mesh=tmesh,
                                    batch_per_device=512)
    want = RefSharded.load_from_file(tmp_path / "one.npz", mesh=rmesh,
                                     batch_per_device=512)
    assert got.canonical
    _same_state(want, got, "single-index file")
    np.testing.assert_array_equal(got.words_array(),
                                  single.wordset.words_array())


def test_from_cbl_to_cbl_and_chunks():
    codes = _codes(40_000, 12)
    single, rsingle = CBL(k=25, device="cpu"), RefCBL(k=25)
    single.insert_codes_stream(codes, _off(codes))
    rsingle.insert_codes_stream(codes, _off(codes))
    rmesh, tmesh = _meshes(8)
    got = ShardedCBL.from_cbl(single, mesh=tmesh, batch_per_device=1024)
    want = RefSharded.from_cbl(rsingle, mesh=rmesh, batch_per_device=1024)
    _same_state(want, got, "from_cbl")
    back = got.to_cbl()
    np.testing.assert_array_equal(back.wordset.words_array(),
                                  single.wordset.words_array())
    assert back.count() == single.count()
    parts = list(got.iter_words_chunks(chunk_rows=1024))
    want_parts = list(want.iter_words_chunks(chunk_rows=1024))
    assert len(parts) == len(want_parts) > 8
    for p, w in zip(parts, want_parts):
        np.testing.assert_array_equal(p, w)


@pytest.mark.parametrize("when", ["dups", "clean", "live log"])
def test_state_carried_from_cbl_tpu(when):
    """`cbl_tpu`'s state carried into the port by `state.
    sharded_from_arrays`, then a stream insert, a round and a remove in
    both."""
    codes = _codes(16_000, 44)
    rmesh, _ = _meshes(8)
    ref = RefSharded(k=25, mesh=rmesh, batch_per_device=512)
    ref.insert_codes_stream(codes[:8_000], np.array([0, 8_000]))
    off = np.array([0, 4_000])
    if when == "clean":
        ref.words_array()
    elif when == "live log":
        ref.dynamic_round((codes[8_000:12_000], off), (codes[:4_000], off),
                          (codes[:4_000], off))
    port = state.sharded_from_arrays(_ref_arrays(ref), get_config(25, 24),
                                     False, [CPU] * 8, batch_per_device=512)
    _same_state(ref, port, "carried")
    args = ((codes[12_000:], off), (codes[8_000:12_000], off),
            (codes[2_000:6_000], off))
    assert port.dynamic_round(*args) == ref.dynamic_round(*args)
    _same_state(ref, port, "round after the carry")
    for x in (ref, port):
        x.insert_codes_stream(codes, _off(codes))
        x.remove_codes_stream(codes[:3_000], np.array([0, 3_000]))
    _same_state(ref, port, "inserts and removes after the carry")
    _same_words(ref, port)
