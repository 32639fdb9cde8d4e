"""Parity of the port's checkpoints and bucket stats with `cbl_tpu`.

Checkpoints: a CBLX file written by either package (`cbl_tpu.CBL`, JAX
CPU backend, and `cbl_tpu_torch.CBL(device="cpu")`) loads in the other;
every array of the two files is equal (dtype, shape, bytes), and the
loaded indexes agree with the saved ones on the state, the count and
membership, at K=13, K=25 and K=27, plain and canonical, empty too.
Garbage, a version above 1 and a K=31 file raise as `cbl_tpu` does (K=31
with the port's `NotImplementedError`), and the ".npz" suffix rule is the
same.  Stats: the six `CBL` stats methods and `stats.shard_balance`
equal `cbl_tpu`'s value for value, type for type, on indexes with trie
buckets (above 1024 words; a small prefix_bits makes them) and on an
empty one.
"""

import numpy as np
import pytest
import torch

import cbl_tpu
from cbl_tpu import stats as jstats
from cbl_tpu_torch import CBL, serialize, stats
from cbl_tpu_torch.limbs import from_limbs

torch.set_num_threads(2)

CONFIGS = {"k13": (13, False), "k25": (25, False), "k25-canonical": (25, True),
           "k27-canonical": (27, True)}
every_config = pytest.mark.parametrize("k,canonical", list(CONFIGS.values()),
                                       ids=list(CONFIGS))


def _codes(seed, n):
    return np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)


def _pair(k, canonical, prefix_bits=24, codes=None):
    """(cbl_tpu index, port index) of the same bases (a static build,
    duplicate keys in both)."""
    kw = dict(k=k, prefix_bits=prefix_bits, canonical=canonical)
    j, t = cbl_tpu.CBL(**kw), CBL(device="cpu", **kw)
    if codes is not None:
        off = np.array([0, len(codes)], dtype=np.int64)
        j.insert_codes_stream(codes, off)
        t.insert_codes_stream(codes, off)
    return j, t


def _npz(path):
    with np.load(path) as z:
        return {name: z[name] for name in z.files}


def _same_files(a, b):
    fa, fb = _npz(a), _npz(b)
    assert sorted(fa) == sorted(fb) == ["canonical", "k", "magic",
                                        "prefix_bits", "version", "words"]
    for name in fa:
        assert fa[name].dtype == fb[name].dtype, name
        assert fa[name].shape == fb[name].shape, name
        assert fa[name].tobytes() == fb[name].tobytes(), name


def _loaded_state(jl, tl):
    """A loaded index: sorted unique words installed with no kernel, the
    same state in both packages; the port's unsynced count is the file's
    (`cbl_tpu` leaves its device count unset, ROADMAP §C)."""
    jw, tw = jl.wordset, tl.wordset
    state = ("capacity", "_n_upper", "_n_host", "_dups", "_holes",
             "n_pending")
    assert ({n: getattr(tw, n) for n in state}
            == {n: getattr(jw, n) for n in state})
    assert int(tl.count_device()) == tw._n_host == jw._n_host
    np.testing.assert_array_equal(tw.data.numpy(),
                                  from_limbs(np.asarray(jw.data)))


@every_config
def test_checkpoints_load_in_either_package(tmp_path, k, canonical):
    codes = _codes(k + canonical, 3000)
    j, t = _pair(k, canonical, codes=codes)
    t.save_to_file(tmp_path / "port.cblx.npz")
    j.save_to_file(tmp_path / "ref.cblx.npz")
    _same_files(tmp_path / "port.cblx.npz", tmp_path / "ref.cblx.npz")
    for src in ("port", "ref"):
        path = tmp_path / f"{src}.cblx.npz"
        jl = cbl_tpu.CBL.load_from_file(path)
        tl = CBL.load_from_file(path, device="cpu")
        _loaded_state(jl, tl)
        assert tl.is_canonical() == canonical and tl.cfg == t.cfg
        assert tl.count() == jl.count() == t.count() == j.count()
        probe = list(t)[::7] + [int(v) for v in
                                np.random.default_rng(k).integers(
                                    0, 1 << (2 * k), size=50)]
        np.testing.assert_array_equal(tl.contains_kmers(probe),
                                      np.asarray(jl.contains_kmers(probe)))
        assert tl.contains_kmers(probe[:20]).all()
        # the loaded indexes save the same file again
        tl.save_to_file(tmp_path / f"{src}-again.cblx.npz")
        _same_files(tmp_path / f"{src}-again.cblx.npz", path)


@pytest.mark.parametrize("k", [13, 25])
def test_empty_and_logged_checkpoints(tmp_path, k):
    """An empty index, and one with a pending log of inserts and removes
    (the save folds it first), in both packages."""
    j, t = _pair(k, False)
    t.save_to_file(tmp_path / "e-port.npz")
    j.save_to_file(tmp_path / "e-ref.npz")
    _same_files(tmp_path / "e-port.npz", tmp_path / "e-ref.npz")
    tl = CBL.load_from_file(tmp_path / "e-ref.npz", device="cpu")
    assert tl.count() == 0 and tl.wordset.words_array().shape == (
        0, tl.cfg.word_limbs)
    codes = _codes(k, 2000)
    for idx in (j, t):
        idx.insert_codes_stream(codes, np.array([0, len(codes)]))
        idx.insert_kmers([5, 6, 7, 123456])
        idx.remove_kmers([6, 99])
    assert t.wordset.n_pending > 0
    t.save_to_file(tmp_path / "l-port.npz")
    j.save_to_file(tmp_path / "l-ref.npz")
    _same_files(tmp_path / "l-port.npz", tmp_path / "l-ref.npz")
    tl = CBL.load_from_file(tmp_path / "l-port.npz", device="cpu")
    assert tl.contains_kmers([5, 6, 7]).tolist() == [True, False, True]


def test_npz_suffix_rule(tmp_path):
    """A name without ".npz" gets it on save and is found on load."""
    j, t = _pair(25, False, codes=_codes(1, 500))
    t.save_to_file(tmp_path / "port")
    j.save_to_file(str(tmp_path / "ref"))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["port.npz",
                                                          "ref.npz"]
    assert serialize._npz_path(tmp_path / "port") == str(tmp_path /
                                                         "port.npz")
    tl = CBL.load_from_file(tmp_path / "ref", device="cpu")
    jl = cbl_tpu.CBL.load_from_file(tmp_path / "port")
    assert tl.count() == jl.count() == t.count()


def _raises_like(path, exc=ValueError):
    with pytest.raises(exc) as want:
        cbl_tpu.CBL.load_from_file(path)
    with pytest.raises(exc) as got:
        CBL.load_from_file(path, device="cpu")
    return str(got.value), str(want.value)


def test_bad_files_raise(tmp_path):
    garbage = tmp_path / "bad.npz"
    np.savez(garbage, magic=np.array("NOPE"), version=np.array(1))
    got, want = _raises_like(garbage)
    assert got == want and "not a cbl_tpu index file" in got
    j, _ = _pair(25, False, codes=_codes(2, 400))
    j.save_to_file(tmp_path / "v.npz")
    z = _npz(tmp_path / "v.npz")
    z["version"] = np.array(2)
    np.savez(tmp_path / "v2.npz", **z)
    got, want = _raises_like(tmp_path / "v2.npz")
    assert got == want and "unsupported index version 2" in got
    # K=31, refused until wide K was ported: both load it, into one state
    wide = cbl_tpu.CBL(k=31)
    wide.insert_kmers([1, 2, 3])
    wide.save_to_file(tmp_path / "k31.npz")
    got = CBL.load_from_file(tmp_path / "k31.npz", device="cpu")
    want = cbl_tpu.CBL.load_from_file(tmp_path / "k31.npz")
    _loaded_state(want, got)
    assert got.count() == want.count() == 3


def test_load_defaults_to_the_card(tmp_path):
    """`load_from_file` runs on the card unless told otherwise: without
    a CUDA device it raises, never quietly falling back to the CPU."""
    _, t = _pair(13, False, codes=_codes(3, 300))
    t.save_to_file(tmp_path / "x.npz")
    if torch.cuda.is_available():
        assert CBL.load_from_file(tmp_path / "x.npz").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            CBL.load_from_file(tmp_path / "x.npz")


STATS = ("prefix_load", "buckets_sizes", "buckets_size_count",
         "buckets_load_repartition", "buckets_nodes", "buckets_node_count")


def _same_value(got, want, what):
    assert type(got) is type(want), (what, type(got), type(want))
    if isinstance(got, dict):
        assert list(got.items()) == list(want.items()), what
        for a, b in zip(got.items(), want.items()):
            _same_value(a[1], b[1], what)
            assert type(a[0]) is type(b[0]), what
    elif isinstance(got, list):
        assert got == want, what
        for a, b in zip(got, want):
            assert tuple(map(type, a)) == tuple(map(type, b)), what
    else:
        assert got == want, what


@pytest.mark.parametrize("k,prefix_bits,bases,tries", [
    (13, 4, 40_000, True),    # 27-bit suffixes, 4-byte trie paths
    (13, 24, 6_000, False),   # 7-bit suffixes, one-byte paths
    (25, 8, 30_000, True),    # 6-byte paths
    (25, 24, 20_000, False),  # the default: Vec buckets only
    (27, 8, 40_000, True),    # 52-bit suffixes, 7-byte paths
], ids=["k13-pb4", "k13-pb24", "k25-pb8", "k25-pb24", "k27-pb8"])
def test_stats_match(k, prefix_bits, bases, tries):
    """Necklace words crowd the low prefixes, so a small prefix_bits
    makes buckets above THRESHOLD (trie node counts)."""
    codes = _codes(k + prefix_bits, bases)
    j, t = _pair(k, False, prefix_bits=prefix_bits, codes=codes)
    for name in STATS:
        _same_value(getattr(t, name)(), getattr(j, name)(), name)
    for shards in (1, 2, 3, 8):
        got = stats.shard_balance(t, shards)
        want = jstats.shard_balance(j, shards)
        assert got.dtype == want.dtype and np.array_equal(got, want), shards
    sizes = dict(t.buckets_sizes())
    nodes = dict(t.buckets_nodes())
    assert sum(sizes.values()) == t.count()
    trie = [p for p, s in sizes.items() if s > stats.THRESHOLD]
    assert bool(trie) == tries
    for p in sizes:
        assert (nodes[p] == sizes[p]) == (p not in trie)


def test_stats_of_an_empty_index_match():
    j, t = _pair(25, False)
    for name in STATS:
        _same_value(getattr(t, name)(), getattr(j, name)(), name)
    assert np.array_equal(stats.shard_balance(t, 4),
                          jstats.shard_balance(j, 4))
