"""Step-by-step parity of the port's set algebra and holes state with
`cbl_tpu`.

The same numpy-seeded record streams go through `cbl_tpu.CBL` (JAX CPU
backend) and `cbl_tpu_torch.CBL(device="cpu")`, K=25 plain and canonical,
K=7 (one limb) and K=13 (a word that fills its limb, where `cbl_tpu`
takes its unpacked set-operation kernel and never the marking merge).
After every step (the eight operators, `merge`, `intersect`, and the
calls that follow on their results: query with and without a pending
log, insert, remove, `contains_kmers`, `flush`, `count`, `dynamic_round`)
the two must agree on the call's result and on the whole state of every
index involved: `data` row for row (holes where they stand), `_holes`,
`_dups`, `_n_upper`, `capacity`, the pending log and the device count;
counts and answers are also held against Python sets of k-mers.  Every
comparison is exact integer equality.

Three pairings of merge modes, since `cbl_tpu`'s set algebra branches on
its merge kernel: its default on the CPU (one sort of both sides; its
sort path) with the port's "sort"; `CBL_TPU_MERGE_KERNEL=pallas-force`
(the bitonic merge in interpret mode) with "bitonic"; `mergepath-force`
with "mergepath".  `cbl_tpu`'s merge kernels are jitted, so its mode is
fixed at trace time: the fixture clears JAX's caches around each
pairing.
"""

import operator

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cbl_tpu
from cbl_tpu.wordset import DeviceWordSet as JaxWordSet
from cbl_tpu_torch import CBL, state
from cbl_tpu_torch import wordset as tws
from cbl_tpu_torch.limbs import SENTINEL, from_limbs
from cbl_tpu_torch.ops import sort

torch.set_num_threads(2)

CAP = 8192  # pending_cap: two 4096-row slabs
JAX_MERGE_ENV = "CBL_TPU_MERGE_KERNEL"
# the port's merge mode -> cbl_tpu's
PAIRINGS = {"sort": None, "bitonic": "pallas-force",
            "mergepath": "mergepath-force"}
CONFIGS = {"k25": (25, 24, False), "k25-canonical": (25, 24, True),
           "k7": (7, 13, False), "k13": (13, 24, False)}
every_pairing = pytest.mark.parametrize("merge_mode", list(PAIRINGS),
                                        indirect=True)
sort_and_bitonic = pytest.mark.parametrize("merge_mode", ["sort", "bitonic"],
                                           indirect=True)


def _cases(*cases, sort_mode=False):
    """parametrize over "pairing-config" names or, with `sort_mode`,
    "pairing-sortmode-config".  The interpret-mode kernels behind the two
    forced pairings compile slowly, so those run fewer configurations
    than "sort"; what differs between them is only the merge kernel."""
    names = "merge_mode,k,prefix_bits,canonical"
    if sort_mode:
        names = "merge_mode,sort_mode,k,prefix_bits,canonical"
    params = []
    for case in cases:
        *modes, cfg = case.split("-", 2 if sort_mode else 1)
        params.append(pytest.param(*modes, *CONFIGS[cfg], id=case))
    return pytest.mark.parametrize(names, params, indirect=["merge_mode"])


@pytest.fixture(scope="module")
def merge_mode(request):
    """Both packages under one pairing of merge modes; module scope keeps
    the tests of a pairing together, so JAX compiles each kernel once a
    pairing."""
    port_mode, jax_mode = request.param, PAIRINGS[request.param]
    with pytest.MonkeyPatch.context() as mp:
        if jax_mode is None:
            mp.delenv(JAX_MERGE_ENV, raising=False)
        else:
            mp.setenv(JAX_MERGE_ENV, jax_mode)
        jax.clear_caches()
        try:
            with sort.use_merge_mode(port_mode):
                yield port_mode
        finally:
            jax.clear_caches()  # drop the mode's traces for later tests


def _stream(rng, n, pool=None):
    """(codes, offsets) of `n` bases in three records (one shorter than
    any K used here); with `pool`, half the bases are a slice of it."""
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    if pool is not None:
        s = int(rng.integers(0, len(pool) - n // 2 + 1))
        codes[: n // 2] = pool[s:s + n // 2]
    off = np.array([0, n // 3, n // 3 + 5, n], dtype=np.int64)
    return codes, off


def _kmers(codes, off, k, canonical):
    """The k-mers of a record stream in stream order as Python ints (first
    base most significant); canonical: the smaller of a k-mer and its
    reverse complement."""
    out = []
    for lo, hi in zip(off[:-1], off[1:]):
        n = int(hi - lo) - k + 1
        if n <= 0:
            continue
        c = codes[lo:hi].astype(np.uint64)
        v = np.zeros(n, dtype=np.uint64)
        r = np.zeros(n, dtype=np.uint64)
        for j in range(k):
            v = (v << np.uint64(2)) | c[j:j + n]
            r |= (np.uint64(3) - c[j:j + n]) << np.uint64(2 * j)
        out += (np.minimum(v, r) if canonical else v).tolist()
    return out


_BINARY = {"or": operator.or_, "and": operator.and_, "sub": operator.sub,
           "xor": operator.xor}
_INPLACE = {"ior": operator.ior, "iand": operator.iand,
            "isub": operator.isub, "ixor": operator.ixor}


class Pair:
    """Named indexes held three times: in `cbl_tpu`, in the port, and as
    Python sets of k-mers.  `run` applies one step to all three and
    compares."""

    def __init__(self, k, prefix_bits, canonical, pending_cap=CAP):
        self.k, self.canonical = k, canonical
        self.kw = dict(k=k, prefix_bits=prefix_bits, canonical=canonical,
                       pending_cap=pending_cap)
        self.j, self.t, self.sets = {}, {}, {}

    def new(self, name):
        self.j[name] = cbl_tpu.CBL(**self.kw)
        self.t[name] = CBL(device="cpu", **self.kw)
        self.sets[name] = set()

    def kmers(self, stream):
        return _kmers(*stream, self.k, self.canonical)

    def both(self, name, call):
        """`call(index)` on both packages' index `name`; results must be
        equal."""
        want, got = call(self.j[name]), call(self.t[name])
        if isinstance(want, tuple):
            want = tuple(int(x) for x in want)
        assert got == want, (name, got, want)
        return got

    def run(self, op, dst, *args):
        sets = self.sets
        touched = [dst]
        if op in _BINARY:
            x, y = args
            for side in (self.j, self.t):
                side[dst] = _BINARY[op](side[x], side[y])
            sets[dst] = _BINARY[op](sets[x], sets[y])
            touched += [x, y]
        elif op in _INPLACE:
            (y,) = args
            for side in (self.j, self.t):
                side[dst] = _INPLACE[op](side[dst], side[y])
            sets[dst] = _BINARY[op[1:]](sets[dst], sets[y])
            touched += [y]
        elif op in ("merge", "intersect"):
            (names,) = args
            self.j[dst] = getattr(cbl_tpu.CBL, op)([self.j[n] for n in names])
            self.t[dst] = getattr(CBL, op)([self.t[n] for n in names])
            fold = set.union if op == "merge" else set.intersection
            sets[dst] = fold(*(sets[n] for n in names))
            touched += names
        elif op == "ins":
            if dst not in self.t:
                self.new(dst)
            self.both(dst, lambda idx: idx.insert_codes_stream(*args))
            sets[dst] |= set(self.kmers(args))
        elif op == "rm":
            self.both(dst, lambda idx: idx.remove_codes_stream(*args))
            sets[dst] -= set(self.kmers(args))
        elif op == "qry":
            got = self.both(dst, lambda idx: idx.query_codes_stream(*args))
            km = self.kmers(args)
            assert got == (len(km), sum(v in sets[dst] for v in km)), dst
        elif op == "round":
            ins, qry, rm = args
            sets[dst] |= set(self.kmers(ins))
            km = self.kmers(qry)
            want = (len(km), sum(v in sets[dst] for v in km))
            got = self.both(dst, lambda idx: idx.dynamic_round(ins, qry, rm))
            assert got == want, dst
            sets[dst] -= set(self.kmers(rm))
        elif op == "contains":
            (probe,) = args
            want = np.asarray(self.j[dst].contains_kmers(probe))
            got = self.t[dst].contains_kmers(probe)
            np.testing.assert_array_equal(got, want)
            if not self.canonical:
                assert got.tolist() == [v in sets[dst] for v in probe]
        elif op == "flush":
            self.both(dst, lambda idx: idx.wordset.flush())
        elif op == "count":
            assert self.both(dst, lambda idx: idx.count()) == len(sets[dst])
        else:
            raise ValueError(op)
        for name in touched:
            assert_same_state(self.j[name], self.t[name], (op, dst, name))

    def steps(self, steps):
        for step in steps:
            self.run(*step)


def assert_same_state(jidx, tidx, where=None):
    """Both word sets hold the same state, bit for bit; nothing here
    folds a log, compacts, or waits for a count that is not already
    there."""
    jw, tw = jidx.wordset, tidx.wordset
    names = ("_holes", "_dups", "_n_upper", "capacity", "n_pending",
             "_pending_rm", "pending_cap", "_n_host")
    got = {n: getattr(tw, n) for n in names}
    want = {n: getattr(jw, n) for n in names}
    assert got == want, where
    assert (tw.slog.seq, tw.slog.real) == (jw._slog_seq, jw._slog_real), where
    assert (tw.slog.keys is None) == (jw._slog is None), where
    if tw.slog.keys is None:
        np.testing.assert_array_equal(tw.data.numpy(),
                                      from_limbs(np.asarray(jw.data)),
                                      err_msg=str(where))
    pend, tags, _, _ = state.pending_to_arrays(tw)
    np.testing.assert_array_equal(pend, np.asarray(jw.pending))
    np.testing.assert_array_equal(tags, np.asarray(jw.pending_tags))
    if jw._n_dev is not None:
        assert int(tw._n_dev) == int(jw._n_dev), where


def _three_streams(seed, n=3_000):
    """Streams a, b, c cut from one pool so that they share bases pairwise
    and all three (every operation keeps some k-mers and drops some), and
    a query over parts of each and fresh bases."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 4, size=2 * n, dtype=np.uint8)
    off = np.array([0, n // 3, n // 3 + 5, n], dtype=np.int64)
    a = pool[:n], off
    b = pool[n // 2:n // 2 + n], off
    c = np.concatenate([pool[n // 4:n // 4 + n // 2], pool[n:n + n // 2]]), off
    q = (np.concatenate([a[0][:n // 3], b[0][:n // 2], c[0][n // 2:],
                         rng.integers(0, 4, size=n // 4, dtype=np.uint8)]),
         np.array([0, n // 3, n // 3 + n // 2, n // 3 + n,
                   n // 3 + n + n // 4], dtype=np.int64))
    return rng, pool, a, b, c, q


@_cases("sort-library-k25", "sort-library-k25-canonical", "sort-library-k7",
        "sort-library-k13", "sort-mergepath-k25", "sort-bitonic-k25",
        "bitonic-library-k25", "bitonic-library-k13", "bitonic-bitonic-k25",
        "mergepath-library-k25", sort_mode=True)
def test_operators_match_jax(merge_mode, sort_mode, k, prefix_bits,
                             canonical):
    """The four operators, their in-place forms, `merge` and `intersect`,
    each followed by `count()`; operands survive and keep their state.
    `sort_mode` is the port's."""
    _, _, a, b, c, q = _three_streams(k + canonical)
    p = Pair(k, prefix_bits, canonical)
    with sort.use_sort_mode(sort_mode):
        _operator_steps(p, a, b, c, q)
    tw = p.t["i"].wordset
    merged = merge_mode != "sort" and k != 13
    assert tw._holes == merged and p.t["u2"].wordset._dups == (
        merge_mode != "sort")
    assert 0 < len(p.sets["i"]) < len(p.sets["a"]) < len(p.sets["u"])
    assert 0 < len(p.sets["n"]) <= len(p.sets["i"])
    assert p.sets["x"] == p.sets["u"] - p.sets["i"]
    # a copy answers like its source
    assert p.t["m1"].count_device().item() == len(p.sets["x"])


def _operator_steps(p, a, b, c, q):
    p.steps([
        ("ins", "a", *a), ("ins", "b", *b), ("ins", "c", *c),
        ("or", "u", "a", "b"), ("count", "u"),
        ("and", "i", "a", "b"), ("count", "i"),   # dedups a and b
        ("sub", "d", "a", "b"), ("count", "d"),
        ("xor", "x", "a", "b"), ("count", "x"),
        ("or", "u2", "a", "b"), ("count", "u2"),  # operands now deduped
        ("sub", "d2", "c", "b"),                  # c still holds duplicates
        ("qry", "d2", *q), ("count", "d2"),
        ("count", "a"), ("count", "b"), ("count", "c"),
        ("or", "y", "a", "c"),
        ("ior", "y", "b"), ("iand", "y", "u"), ("isub", "y", "d"),
        ("ixor", "y", "c"), ("count", "y"), ("qry", "y", *q),
        ("merge", "m", ["a", "b", "c"]), ("count", "m"),
        ("intersect", "n", ["a", "b", "c"]), ("count", "n"),
        ("merge", "m1", ["x"]), ("intersect", "n1", ["d"]),
        ("count", "m1"), ("count", "n1"),
    ])


@_cases("sort-k13", "bitonic-k25", "bitonic-k7")
def test_follow_on_calls_on_results(merge_mode, k, prefix_bits, canonical):
    """What a caller does with a result (under a merge kernel, an index
    with holes): stream queries with and without a pending log, inserts
    and removes that fit the log or exceed it, folds with and without
    removes, `contains_kmers`, and a dynamic round."""
    rng, pool, a, b, c, q = _three_streams(40 + k + canonical)
    d, e = _stream(rng, 3_000, pool), _stream(rng, 3_000, pool)
    big = _stream(rng, 10_000, pool)  # 16384 rows > CAP
    probe = _kmers(*q, k, canonical)[::7] + [
        int(v) for v in rng.integers(0, 1 << (2 * k), size=50)]
    one = lambda s: (s[0], np.array([0, len(s[0])], dtype=np.int64))
    p = Pair(k, prefix_bits, canonical)
    p.steps([
        ("ins", "a", *a), ("ins", "b", *b), ("ins", "c", *c),
        # h: query as it is, then a log beside it
        ("and", "h", "a", "b"),
        ("qry", "h", *q), ("qry", "h", *a),
        ("ins", "h", *d),            # fits the log
        ("qry", "h", *q),            # index + log
        ("rm", "h", *c),
        ("qry", "h", *q),            # index + log with removes
        ("contains", "h", probe),    # compacts; the log overrides
        ("count", "h"),              # fold with removes
        ("qry", "h", *q),
        # g: a fold without removes into an index with holes
        ("sub", "g", "a", "b"),
        ("ins", "g", *d),
        ("flush", "g"),
        ("qry", "g", *q),
        ("rm", "g", *e), ("flush", "g"),  # fold with removes over holes
        ("count", "g"), ("qry", "g", *q),
    ])
    if k == 7:  # one limb: the holes joins and folds above are its case
        return
    p.steps([
        # s: batches larger than the log are applied at once
        ("xor", "s", "a", "b"),
        ("rm", "s", *big), ("qry", "s", *q),
        ("xor", "s2", "a", "c"),
        ("ins", "s2", *big), ("count", "s2"), ("qry", "s2", *big),
        # r: a round compacts first; then a set operation on a sorted log
        ("sub", "r", "b", "c"),
        ("round", "r", one(d), one(q), one(e)),
        ("round", "r", one(e), one(d), one(a)),
        ("or", "r2", "r", "a"), ("count", "r2"), ("qry", "r2", *q),
        ("contains", "r", probe),
        # chained operations over results of every kind
        ("and", "t1", "h", "g"), ("or", "t2", "t1", "s"),
        ("sub", "t3", "t2", "h"), ("count", "t3"), ("qry", "t3", *q),
        ("merge", "t4", ["t1", "t3", "g"]), ("count", "t4"),
    ])
    assert all(len(p.sets[n]) > 0 for n in ("h", "g", "s2", "r2", "t4"))


@sort_and_bitonic
def test_operations_on_a_pending_log(merge_mode):
    """Operands with unfolded inserts and removes: every operation folds
    them first."""
    rng, pool, a, b, c, q = _three_streams(77)
    d = _stream(rng, 3_000, pool)
    p = Pair(25, 24, False)
    kmers = _kmers(*q, 25, False)[:300]
    p.steps([("ins", "a", *a), ("ins", "b", *b), ("ins", "a", *c),
             ("rm", "b", *d)])
    for idx in (p.j["a"], p.t["a"]):
        idx.insert_kmers(kmers[:200])
        idx.remove_kmers(kmers[100:300])
    p.sets["a"] = (p.sets["a"] | set(kmers[:200])) - set(kmers[100:300])
    assert p.t["a"].wordset.n_pending > 0 < p.t["b"].wordset.n_pending
    p.steps([("xor", "x", "a", "b"), ("count", "x"), ("count", "a"),
             ("ins", "b", *c), ("or", "u", "b", "a"), ("count", "u"),
             ("rm", "a", *d), ("sub", "d", "a", "x"), ("count", "d"),
             ("qry", "d", *q)])
    assert p.t["a"].wordset.n_pending == 0 == p.t["b"].wordset.n_pending


@sort_and_bitonic
def test_empty_operands(merge_mode):
    rng, _, a, _, _, q = _three_streams(5)
    p = Pair(25, 24, False)
    p.new("e")
    p.new("f")
    p.steps([("ins", "a", *a),
             ("or", "u", "a", "e"), ("and", "i", "a", "e"),
             ("sub", "d", "e", "a"), ("xor", "x", "e", "a"),
             ("or", "ee", "e", "f"), ("and", "ie", "e", "f"),
             ("merge", "m", ["e", "a", "f"]), ("intersect", "n", ["e"]),
             ("count", "u"), ("count", "i"), ("count", "d"), ("count", "x"),
             ("count", "ee"), ("count", "ie"), ("count", "m"), ("count", "n"),
             ("qry", "x", *q), ("ins", "i", *a), ("count", "i")])
    assert len(p.sets["x"]) == len(p.sets["a"]) > 0 == len(p.sets["d"])


def test_mismatched_operands_raise():
    """`_check_mode`'s two errors, with `cbl_tpu`'s texts, from every
    operator and from `merge` / `intersect`; an empty list raises."""
    jp = cbl_tpu.CBL(k=25), cbl_tpu.CBL(k=25, canonical=True), \
        cbl_tpu.CBL(k=23)
    tp = CBL(k=25, device="cpu"), CBL(k=25, canonical=True, device="cpu"), \
        CBL(k=23, device="cpu")
    calls = list(_BINARY.values()) + list(_INPLACE.values())
    calls += [lambda x, y: type(x).merge([x, x, y]),
              lambda x, y: type(x).intersect([x, y])]
    for other, text in ((1, "One of the index is canonical"),
                        (2, "Mismatched CBL configurations")):
        for call in calls:
            with pytest.raises(ValueError) as je:
                call(jp[0], jp[other])
            with pytest.raises(ValueError, match=text) as te:
                call(tp[0], tp[other])
            assert str(te.value) == str(je.value)
    for fn in (CBL.merge, CBL.intersect):
        with pytest.raises(ValueError, match="at least one"):
            fn([])
    with pytest.raises(ValueError, match="unknown set operation"):
        x = torch.arange(5, dtype=torch.int64)
        tws._setop_sort_kernel_packed(x, x, "nand", 4096)


@pytest.mark.parametrize("op", ["union", "remove", "diff", "inter", "symdiff"])
@pytest.mark.parametrize("k,prefix_bits", [(25, 24), (7, 13), (13, 24)])
def test_packed_setop_kernel_matches_jax(op, k, prefix_bits):
    """The tagged-sort kernel alone against `cbl_tpu`'s kernel for the
    config: at K=13 that is its unpacked kernel (a tag column), and the
    port's packed key gives the same rows and count."""
    from cbl_tpu.wordset import _setop_kernel_for
    from cbl_tpu_torch.limbs import to_limbs

    idx = CBL(k=k, prefix_bits=prefix_bits, device="cpu")
    cfg = idx.cfg
    jcfg = cbl_tpu.CBL(k=k, prefix_bits=prefix_bits).cfg
    rng = np.random.default_rng(k + len(op))
    vocab = rng.integers(0, 1 << cfg.n_bits, size=6000).astype(np.int64)
    a = np.sort(np.unique(vocab[rng.integers(0, 6000, size=3000)]))
    b = np.unique(vocab[rng.integers(0, 6000, size=3000)])
    if op in ("union", "remove"):  # b may hold duplicates and sentinels
        b = vocab[rng.integers(0, 6000, size=4096)]
        b[::30] = SENTINEL
    pad = lambda v, n: np.concatenate([v, np.full(n - len(v), SENTINEL)])
    a, b = pad(a, 4096), pad(b, 4096)
    L = cfg.word_limbs
    want, n_want = _setop_kernel_for(jcfg)(
        jnp.asarray(to_limbs(a, L)), jnp.asarray(to_limbs(b, L)), op, 8192)
    got, n_got = tws._setop_sort_kernel_packed(
        torch.from_numpy(a), torch.from_numpy(b), op, 8192)
    np.testing.assert_array_equal(got.numpy(), from_limbs(np.asarray(want)))
    assert int(n_got) == int(n_want) > 0


@every_pairing
def test_holes_index_carried_both_ways(merge_mode):
    """A result of `cbl_tpu` (with holes under a merge kernel) carried
    into the port with `state.wordset_from_arrays`, rows, flags and bound
    as they are, and a result of the port carried into `cbl_tpu`: both
    then answer and fold alike."""
    rng, pool, a, b, c, q = _three_streams(91)
    d = _stream(rng, 3_000, pool)
    p = Pair(25, 24, False)
    p.steps([("ins", "a", *a), ("ins", "b", *b), ("sub", "h", "a", "b")])
    holes = merge_mode != "sort"
    for src in ("jax", "port"):
        jw, tw = p.j["h"].wordset, p.t["h"].wordset
        assert jw._holes == tw._holes == holes
        if src == "jax":
            new = state.wordset_from_arrays(
                np.asarray(jw.data), jw.count(), p.t["h"].cfg, "cpu",
                holes=jw._holes, dups=jw._dups, n_upper=jw._n_upper)
            state.pending_from_arrays(new, np.asarray(jw.pending),
                                      np.asarray(jw.pending_tags),
                                      jw.n_pending, jw._pending_rm)
            assert new.n == jw.n  # both now hold the count on the host
            p.t["h2"] = p.t["h"]._like(new)
            p.j["h2"] = p.j["h"]
        else:
            words, n, flags = state.wordset_to_arrays(tw)
            assert flags == dict(holes=holes, dups=False,
                                 n_upper=tw._n_upper)
            new = JaxWordSet(p.j["h"].cfg, CAP)
            new.data, new.capacity = jnp.asarray(words), words.shape[0]
            new._holes, new._dups = flags["holes"], flags["dups"]
            new._n_upper = flags["n_upper"]
            new._set_count(jnp.int32(n))
            assert new.n == tw.n
            p.j["h2"] = p.j["h"]._like()
            p.j["h2"].wordset = new
            p.t["h2"] = p.t["h"]
        p.sets["h2"] = set(p.sets["h"])
        assert_same_state(p.j["h2"], p.t["h2"], src)
        p.steps([("qry", "h2", *q), ("ins", "h2", *d), ("qry", "h2", *q),
                 ("rm", "h2", *c), ("count", "h2"), ("qry", "h2", *q),
                 ("and", "h", "h2", "a")])
    words = np.asarray(p.j["a"].wordset.data)
    with pytest.raises(ValueError, match="ascending"):
        state.wordset_from_arrays(words[::-1].copy(), 1, p.t["a"].cfg, "cpu",
                                  holes=True)
    with pytest.raises(ValueError, match="n_upper"):
        state.wordset_from_arrays(words, 1, p.t["a"].cfg, "cpu", n_upper=3)


@sort_and_bitonic
def test_compact_and_copy_state(merge_mode):
    """`_compact`, `_dedup` and `copy` on results, next to `cbl_tpu`'s."""
    _, _, a, b, _, q = _three_streams(13)
    p = Pair(25, 24, False)
    p.steps([("ins", "a", *a), ("ins", "b", *b), ("xor", "x", "a", "b"),
             ("or", "u", "a", "b")])
    for name, call in (("x", "_compact"), ("u", "_dedup"), ("x", "_dedup")):
        for side in (p.j, p.t):
            getattr(side[name].wordset, call)()
        assert_same_state(p.j[name], p.t[name], (name, call))
    tw = p.t["x"].wordset
    assert not tw._holes and not tw._dups
    valid = tw.data[tw.data != SENTINEL]
    assert torch.equal(valid, torch.unique(valid))
    assert len(valid) == len(p.sets["x"])
    assert bool((tw.data[len(valid):] == SENTINEL).all())
    for side in (p.j, p.t):
        side["xc"] = side["x"]._like() if side is p.j else side["x"]._like(
            side["x"].wordset.copy())
    p.j["xc"].wordset = p.j["x"].wordset.copy()
    p.sets["xc"] = set(p.sets["x"])
    assert_same_state(p.j["xc"], p.t["xc"], "copy")
    p.steps([("ins", "xc", *a), ("count", "xc"), ("count", "x"),
             ("qry", "x", *q)])
    assert len(p.sets["xc"]) > len(p.sets["x"])
