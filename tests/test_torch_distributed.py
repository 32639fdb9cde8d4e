"""Parity of `cbl_tpu_torch.parallel.distributed` with `cbl_tpu`'s.

Ranks run on the CPU with gloo, each a fresh `python -c` process on a
free port with a timeout (`distributed.launch`); every comparison is
exact.

- (a) `host_record_slice` / `slice_codes` and (b) `build_slab_groups`
  with `icap` / `n_groups` (dummy slabs of a short or empty slice)
  against `cbl_tpu`'s;
- (c) `cbl_tpu`'s two processes x 4 CPU devices run its own
  `run_multihost_dryrun_worker` (60,000 bases of `default_rng(7)`, the
  rounds' `default_rng(11)` segments) beside the port's two gloo ranks x
  4 CPU shards running the port's; in both, `_assert_local_shards_match`,
  the query, the rounds and `save_to_file` are wrapped so that each rank
  dumps its state after every step: the boundaries as limbs, the shard
  counts, capacity and bounds, every local shard's rows, each round's log
  and (total, positive), and each checkpoint file.  The dumps must be
  equal step by step, and each rank's files name by name;
- (d) the port's `launch_multihost_dryrun(device="cpu")`;
- (e) at K=59, two ranks' build and rounds against the port's one-process
  `ShardedCBL` with the same D and the agreed boundaries, the exchange of
  `_all_to_all` across ranks against its one-process order, the chunked
  export on every rank, `env://` through `init_distributed()`, and a
  mesh of local devices inside the group, which stays an index of one
  process; (g) on that mesh the one-process calls raise `ValueError`;
- (g) `cbl_tpu` and the port side by side on two processes x 4 CPU
  shards: `insert_words`, `remove_words` and `iter_words_chunks` give
  equal states and words; the calls that `cbl_tpu` cannot run there
  raise in both; its record-stream calls of one process give counts that
  are not the single index's, and the port's refuse;
- (f) a rank that raises, or hangs, makes the launcher raise in time; the
  dryrun's entry points default to the card and raise without one.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
N_PROC = 2


# --- workers: each runs in a spawned rank -----------------------------------


class _Recorder:
    """Writes a rank's state after each step to `out`, numbered in step
    order: `<side>.<pid>.<nn>.<step>.npz`."""

    def __init__(self, out: str, side: str, pid: int):
        self.out, self.side, self.pid, self.n = out, side, pid, 0

    def _path(self, step: str) -> str:
        path = os.path.join(
            self.out, f"{self.side}.{self.pid}.{self.n:02d}.{step}.npz")
        self.n += 1
        return path

    def dump(self, step: str, rows=None, **arrays) -> None:
        for gid, r in (rows or {}).items():
            arrays[f"rows_{gid}"] = r
        np.savez(self._path(step), **arrays)

    def copy(self, step: str, src: str) -> None:
        shutil.copyfile(src, self._path(step))


def _instrument(mod, cls, rec: _Recorder, state, slog) -> None:
    """Wrap a `distributed` module's placement check, query and round and
    its ShardedCBL's `save_to_file` so that each dumps the rank's state."""
    check, query = mod._assert_local_shards_match, mod.multihost_query_stream
    rnd, save = mod.multihost_dynamic_round, cls.save_to_file

    def check_(idx, words, ctx):
        check(idx, words, ctx)
        rec.dump(ctx, **state(idx))

    def query_(idx, *a, **kw):
        t, p = query(idx, *a, **kw)
        rec.dump("query", tp=np.array([t, p]))
        return t, p

    def round_(idx, *a, **kw):
        t, p = rnd(idx, *a, **kw)
        rec.dump("round", tp=np.array([t, p]), **slog(idx))
        return t, p

    def save_(self, path):
        save(self, path)
        rec.copy("file", cls._shard_file(path, rec.pid, N_PROC))

    mod._assert_local_shards_match = check_
    mod.multihost_query_stream = query_
    mod.multihost_dynamic_round = round_
    cls.save_to_file = save_


def _ref_state(idx) -> dict:
    return dict(boundaries=np.asarray(idx.boundaries, np.uint32),
                counts=idx.shard_counts, C=idx.C,
                count_upper=idx._count_upper, dups=idx._dups,
                rows=idx.local_shard_rows())


def _ref_worker(coordinator: str, pid: int, out: str) -> None:
    """`cbl_tpu`'s own dryrun worker, instrumented (cbl_tpu unchanged)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from cbl_tpu.parallel import distributed as d
    from cbl_tpu.parallel.shard import ShardedCBL

    def slog(idx):
        out_ = dict(seq=idx._slog_seq, real=idx._slog_real)
        for j, col in enumerate(idx._slog_dev):
            for s in col.addressable_shards:
                gid = s.index[0].start or 0
                out_[f"slog{j}_{gid}"] = np.asarray(s.data)[0]
        return out_

    _instrument(d, ShardedCBL, _Recorder(out, "ref", pid), _ref_state,
                slog)
    d.run_multihost_dryrun_worker(coordinator, N_PROC, pid)


def _port_state(idx) -> dict:
    return dict(boundaries=idx.boundary_limbs(), counts=idx.shard_counts,
                C=idx.C, count_upper=idx._count_upper, dups=idx._dups,
                rows=idx.local_shard_rows())


def _port_slog(idx) -> dict:
    from cbl_tpu_torch.state import slog_to_arrays
    from cbl_tpu_torch.wordset import DeviceWordSet, SortedLog

    out = dict(seq=idx.slog.seq, real=idx.slog.real)
    for gid, s in zip(idx._local_shard_ids(), idx.slog.keys):
        ws = DeviceWordSet(idx.cfg, s.device, pending_cap=1)
        ws.slog = SortedLog(idx.cfg, [s])
        for j, c in enumerate(slog_to_arrays(ws)[0]):
            out[f"slog{j}_{gid}"] = c
    return out


def _port_worker(coordinator: str, pid: int, out: str) -> None:
    """The port's dryrun worker, instrumented the same way."""
    from cbl_tpu_torch.parallel import distributed as d
    from cbl_tpu_torch.parallel.shard import ShardedCBL

    _instrument(d, ShardedCBL, _Recorder(out, "port", pid), _port_state,
                _port_slog)
    d.run_multihost_dryrun_worker(coordinator, N_PROC, pid,
                                  devices_per_proc=4, device="cpu",
                                  timeout_s=120.0)


def _exchange_cases(rank: int, ranks: int, n: int):
    """Seeded send buffers of every rank (so any rank knows the whole
    exchange): [D, cap] int64, [2, D, cap] int64 and [D, cap] bool."""
    import torch

    D = n * ranks
    rng = np.random.default_rng(5)
    for shape, dtype in (((D, 6), np.int64), ((2, D, 3), np.int64),
                         ((D, 4), np.bool_)):
        allsends = [[torch.from_numpy(
            rng.integers(-9, 10**9, size=shape).astype(dtype))
            for _ in range(n)] for _ in range(ranks)]
        yield allsends[rank], [s for r in allsends for s in r]


def _k59_round(r: int) -> list:
    """Round r's full (insert, query, remove) streams at K=59: 3,000 new
    bases in two records, a query of round max(r-1, 0)'s insert and a
    remove of its own first record."""
    def ins(i):
        c = np.random.default_rng(100 + i).integers(0, 4, size=3000,
                                                    dtype=np.uint8)
        return c, np.array([0, 1000, 3000], dtype=np.int64)

    c, o = ins(r)
    return [(c, o), ins(max(r - 1, 0)), (c[:1000], o[:2].copy())]


def _misc_worker(coordinator: str, pid: int, out: str) -> None:
    """K=59 (prefix 28) on two ranks x 4 CPU shards, joined through
    `env://`: the exchange against its one-process order, a build and
    three rounds with their boundaries, words and (total, positive), then
    which one-process calls raise `ValueError`."""
    import torch
    import torch.distributed as dist

    from cbl_tpu_torch.parallel import distributed as d
    from cbl_tpu_torch.parallel import shard

    torch.set_num_threads(2)
    host, port = coordinator.rsplit(":", 1)
    os.environ.update(MASTER_ADDR=host, MASTER_PORT=port,
                      WORLD_SIZE=str(N_PROC), RANK=str(pid))
    d.init_distributed(device="cpu", timeout_s=120.0)
    res = {"backend": dist.get_backend(), "exchange": []}
    mesh = shard.make_mesh([torch.device("cpu")] * 4, process_group=True)
    for mine, every in _exchange_cases(pid, N_PROC, len(mesh)):
        got = shard._all_to_all(mine, mesh)
        want = shard._all_to_all(every, [torch.device("cpu")] * len(every))
        ids = range(pid * len(mesh), (pid + 1) * len(mesh))
        res["exchange"].append(all(torch.equal(g, want[i])
                                   for g, i in zip(got, ids)))
    rng = np.random.default_rng(59)
    codes = rng.integers(0, 4, size=40_000, dtype=np.uint8)
    offsets = np.array([0, 9_000, 9_050, 25_000, 40_000], dtype=np.int64)
    idx = shard.ShardedCBL(k=59, prefix_bits=28, mesh=mesh)
    lo, hi = d.host_record_slice(offsets, pid, N_PROC)
    d.multihost_insert_stream(idx, *d.slice_codes(codes, offsets, lo, hi))
    arrays = dict(boundaries=idx.boundaries, counts=idx.shard_counts,
                  count=idx.count())
    for gid, rows in idx.local_shard_rows().items():
        arrays[f"build_{gid}"] = rows
    tps = []
    for r in range(3):
        segs = [d.slice_codes(c, o, *d.host_record_slice(o, pid, N_PROC))
                for c, o in _k59_round(r)]
        tps.append(d.multihost_dynamic_round(idx, *segs))
    arrays["tps"] = np.array(tps)
    arrays["live"] = idx.count()
    idx.flush()
    for gid, rows in idx.local_shard_rows().items():
        arrays[f"rounds_{gid}"] = rows
    chunks = list(idx.iter_words_chunks(chunk_rows=1000))
    arrays["chunks"] = np.concatenate(chunks)
    arrays["n_chunks"] = len(chunks)
    np.savez(os.path.join(out, f"misc.{pid}.npz"), **arrays)
    one = (codes[:5000], np.array([0, 5000], dtype=np.int64))
    calls = {
        "contains_codes_stream": lambda: idx.contains_codes_stream(*one),
        "contains_seqs": lambda: idx.contains_seqs(["ACGT" * 20]),
        "words_array": idx.words_array,
        "to_cbl": idx.to_cbl,
        "insert_codes_stream": lambda: idx.insert_codes_stream(*one),
        "remove_codes_stream": lambda: idx.remove_codes_stream(*one),
        "query_codes_stream": lambda: idx.query_codes_stream(*one),
        "pack_stream": lambda: idx.pack_stream(*one),
        "contains_words": lambda: idx.contains_words(
            np.zeros((2, 4), np.int64)),
        "count_hits": lambda: idx.count_hits(np.zeros((2, 4), np.int64)),
    }
    raised = {}
    for name, call in calls.items():
        try:
            call()
            raised[name] = "returned"
        except ValueError as e:
            raised[name] = str(e)
    res["raised"] = raised
    # the mesh is still whole: a query after the refused calls
    res["query"] = list(d.multihost_query_stream(
        idx, *d.slice_codes(codes, offsets, *d.host_record_slice(
            offsets, pid, N_PROC))))
    # rank 1's slice is empty: it stages all-blank dummy slabs only
    empty = (codes[:0], np.zeros(1, dtype=np.int64))
    part = (codes[:9000], offsets[:2].copy()) if pid == 0 else empty
    idx2 = shard.ShardedCBL(k=59, prefix_bits=28, mesh=mesh)
    d.multihost_insert_stream(idx2, *part)
    res["empty_slice"] = [idx2.count(),
                          *d.multihost_query_stream(idx2, *part),
                          *d.multihost_dynamic_round(idx2, part, part, part)]
    idx2.flush()
    res["empty_slice"].append(idx2.count())
    if pid == 0:
        # a plain list of devices inside the group is an index of one
        # process: rank 1 has left the collectives, so one would fail here
        loc = shard.ShardedCBL(k=59, prefix_bits=28,
                               mesh=[torch.device("cpu")] * 2)
        loc.insert_codes_stream(codes, offsets)
        ck = os.path.join(out, "local.npz")
        loc.save_to_file(ck)
        back = shard.ShardedCBL.load_from_file(ck, mesh=loc.mesh)
        res["local"] = dict(ranks=loc._ranks, D=loc.D, count=loc.count(),
                            query=list(loc.query_codes_stream(codes,
                                                              offsets)),
                            file=os.path.exists(ck),
                            back=bool(np.array_equal(back.words_array(),
                                                     loc.words_array())))
        np.save(os.path.join(out, "local_words.npy"), loc.words_array())
    with open(os.path.join(out, f"misc.{pid}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


CALLS_REFUSED = ["contains_words", "count_hits", "contains_codes_stream",
                 "words_array", "to_cbl"]


def _calls_steps(side, pid, out, d, make_index, single, to_keys,
                 state) -> None:
    """(g)'s steps on one side: a build from the ranks' slices, then
    `insert_words` / `remove_words` of the same words on every rank, the
    chunked export, the calls that read every shard into one process,
    and the record-stream calls of one process on the full stream."""
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=60_000, dtype=np.uint8)
    offsets = np.array([0, 20_000, 30_000, 59_989, 60_000], dtype=np.int64)
    idx = make_index()
    d.multihost_insert_stream(idx, *d.slice_codes(
        codes, offsets, *d.host_record_slice(offsets, pid, N_PROC)))
    ref = single()
    ref.insert_codes_stream(codes, offsets)
    other = single()
    other.insert_codes_stream(np.random.default_rng(3).integers(
        0, 4, size=5_000, dtype=np.uint8), np.array([0, 5_000]))
    w_new = other.wordset.words_array()
    w_old = ref.wordset.words_array()[:3_000]
    rec = _Recorder(out, side, pid)
    idx.insert_words(to_keys(w_new))
    rec.dump("insert_words", **state(idx))
    idx.remove_words(to_keys(w_old))
    rec.dump("remove_words", **state(idx))
    chunks = list(idx.iter_words_chunks(chunk_rows=1_000))
    rec.dump("iter_words_chunks", words=np.concatenate(chunks),
             n=len(chunks))
    one = (codes[:5_000], np.array([0, 5_000], dtype=np.int64))
    calls = {
        "contains_words": lambda: idx.contains_words(to_keys(w_new[:100])),
        "count_hits": lambda: idx.count_hits(to_keys(w_new)),
        "contains_codes_stream": lambda: idx.contains_codes_stream(*one),
        "words_array": idx.words_array,
        "to_cbl": idx.to_cbl,
        "insert_codes_stream": lambda: make_index().insert_codes_stream(
            codes, offsets),
        "query_codes_stream": lambda: idx.query_codes_stream(codes,
                                                             offsets),
    }
    res = {"single_count": ref.count(),
           "single_total": 60_000 - 4 * (25 - 1)}
    for name, call in calls.items():
        try:
            got = call()
            res[name] = ["returned", list(got) if isinstance(got, tuple)
                         else None]
        except Exception as e:  # noqa: BLE001 - recorded for the test
            res[name] = ["raised", type(e).__name__, str(e)]
        if name == "insert_codes_stream" and res[name][0] == "returned":
            fresh = make_index()
            fresh.insert_codes_stream(codes, offsets)
            res[name][1] = fresh.count()
    with open(os.path.join(out, f"{side}_calls.{pid}.json"), "w") as f:
        json.dump(res, f)


def _ref_calls_worker(coordinator: str, pid: int, out: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=N_PROC, process_id=pid)
    from cbl_tpu import CBL
    from cbl_tpu.parallel import distributed as d
    from cbl_tpu.parallel.shard import ShardedCBL, make_mesh

    _calls_steps("ref", pid, out, d,
                 lambda: ShardedCBL(k=25, mesh=make_mesh()),
                 lambda: CBL(k=25), lambda w: w, _ref_state)


def _port_calls_worker(coordinator: str, pid: int, out: str) -> None:
    import torch

    from cbl_tpu_torch import CBL
    from cbl_tpu_torch.limbs import from_limbs
    from cbl_tpu_torch.parallel import distributed as d
    from cbl_tpu_torch.parallel.shard import ShardedCBL, make_mesh

    torch.set_num_threads(2)
    d.init_distributed(coordinator, N_PROC, pid, device="cpu",
                       timeout_s=120.0)
    mesh = make_mesh([torch.device("cpu")] * 4, process_group=True)
    _calls_steps("port", pid, out, d,
                 lambda: ShardedCBL(k=25, mesh=mesh),
                 lambda: CBL(k=25, device="cpu"),
                 lambda w: from_limbs(w, 1), _port_state)


def _code(worker: str, out: str) -> str:
    return (f"import sys; sys.path.insert(0, {TESTS!r}); "
            f"from test_torch_distributed import {worker} as w; "
            f"w('{{coordinator}}', {{pid}}, {out!r})")


def _ref_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", CBL_TPU_PLATFORM="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return env


# --- (a), (b): host-side helpers ----------------------------------------------


OFFSETS = {
    "even": np.arange(0, 100_001, 10_000, dtype=np.int64),
    "skewed": np.array([0, 5, 90_000, 90_010, 100_000], dtype=np.int64),
    "one": np.array([0, 777], dtype=np.int64),
    "tiny": np.cumsum([0] + [3, 1, 4, 1, 5, 9, 2, 6] * 5, dtype=np.int64),
}


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 5])
@pytest.mark.parametrize("case", sorted(OFFSETS))
def test_record_slices_match_cbl_tpu(case, n_hosts):
    from cbl_tpu.parallel import distributed as rd

    from cbl_tpu_torch.parallel import distributed as td

    offsets = OFFSETS[case]
    codes = np.random.default_rng(3).integers(0, 4, size=int(offsets[-1]),
                                              dtype=np.uint8)
    covered = []
    for h in range(n_hosts):
        got = td.host_record_slice(offsets, h, n_hosts)
        assert got == rd.host_record_slice(offsets, h, n_hosts)
        c, o = td.slice_codes(codes, offsets, *got)
        rc, ro = rd.slice_codes(codes, offsets, *got)
        np.testing.assert_array_equal(c, rc)
        np.testing.assert_array_equal(o, ro)
        assert o.dtype == ro.dtype == np.int64
        covered.append(c)
    np.testing.assert_array_equal(np.concatenate(covered), codes)


SLAB_CASES = {
    # name: (bases, offsets, nk_sub, rows, icap, n_groups)
    "records": (30_000, [0, 7_000, 7_010, 19_000, 30_000], 4096, 4, None,
                None),
    "short slice": (5_000, [0, 2_000, 5_000], 4096, 4, 64, 3),
    "empty slice": (0, [0], 4096, 4, 64, 2),
    "cut groups": (40_000, [0, 40_000], 4096, 2, 16, 1),
    "short tail record": (9_000, [0, 8_990, 9_000], 4096, 3, 32, None),
}


@pytest.mark.parametrize("case", list(SLAB_CASES))
def test_build_slab_groups_matches_cbl_tpu(case):
    from cbl_tpu import CBL as RefCBL
    from cbl_tpu.parallel import shard as rshard

    from cbl_tpu_torch import CBL
    from cbl_tpu_torch.parallel import shard as tshard

    bases, offsets, nk_sub, rows, icap, n_groups = SLAB_CASES[case]
    codes = np.random.default_rng(9).integers(0, 4, size=bases,
                                              dtype=np.uint8)
    offsets = np.array(offsets, dtype=np.int64)
    want = list(rshard.build_slab_groups(RefCBL(k=25), codes, offsets,
                                         nk_sub, rows, icap=icap,
                                         n_groups=n_groups))
    got = list(tshard.build_slab_groups(CBL(k=25, device="cpu"), codes,
                                        offsets, nk_sub, rows, icap=icap,
                                        n_groups=n_groups))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_build_slab_groups_icap_too_small():
    from cbl_tpu import CBL as RefCBL
    from cbl_tpu.parallel import shard as rshard

    from cbl_tpu_torch import CBL
    from cbl_tpu_torch.parallel import shard as tshard

    codes = np.zeros(6_000, dtype=np.uint8)
    offsets = np.arange(0, 6_001, 100, dtype=np.int64)  # 60 records
    for mod, front in ((rshard, RefCBL(k=25)),
                       (tshard, CBL(k=25, device="cpu"))):
        with pytest.raises(ValueError, match="interval cap"):
            list(mod.build_slab_groups(front, codes, offsets, 8192, 1,
                                       icap=16, n_groups=1))


def test_shard_file_names_match_cbl_tpu():
    from cbl_tpu.parallel.shard import ShardedCBL as RefSharded

    from cbl_tpu_torch.parallel import ShardedCBL

    for i, n in ((0, 1), (0, 2), (1, 2), (3, 7), (12, 100000)):
        assert (ShardedCBL._shard_file("/x/ck.npz", i, n)
                == RefSharded._shard_file("/x/ck.npz", i, n))


# --- (c): the parity run --------------------------------------------------------


@pytest.fixture(scope="module")
def parity_dumps(tmp_path_factory):
    """Both sides' dryruns at once; -> {(side, pid): [(step, npz dict)]}."""
    from concurrent.futures import ThreadPoolExecutor

    from cbl_tpu_torch.parallel.distributed import launch

    out = str(tmp_path_factory.mktemp("mh_parity"))
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(launch, _code("_ref_worker", out), N_PROC, 300,
                          _ref_env())
        port_outs = launch(_code("_port_worker", out), N_PROC, 300)
        ref_outs = ref.result()
    assert "MULTIHOST_OK" in ref_outs[0] and "MULTIHOST_OK" in port_outs[0]
    dumps = {}
    for name in sorted(os.listdir(out)):
        side, pid, _, step, _ = name.split(".")
        with np.load(os.path.join(out, name)) as z:
            arrays = {k: z[k] for k in z.files}
        dumps.setdefault((side, int(pid)), []).append((step, arrays))
    return dumps


STEPS = ["build", "query", "file", "checkpoint", "remove", "query",
         "intersect", "round", "round", "round", "dyn-rounds", "file",
         "dyn-checkpoint"]


@pytest.mark.parametrize("pid", range(N_PROC))
def test_parity_steps_in_order(parity_dumps, pid):
    for side in ("ref", "port"):
        assert [s for s, _ in parity_dumps[(side, pid)]] == STEPS, side


@pytest.mark.parametrize("step", range(len(STEPS)),
                         ids=[f"{i:02d}-{s}" for i, s in enumerate(STEPS)])
def test_parity_state_after_step(parity_dumps, step):
    """Every array of the step's dump equal, rank by rank: the state,
    (total, positive), or the checkpoint file name by name."""
    for pid in range(N_PROC):
        (rname, ref), (pname, port) = (parity_dumps[("ref", pid)][step],
                                       parity_dumps[("port", pid)][step])
        assert rname == pname == STEPS[step]
        assert sorted(ref) == sorted(port), (pid, rname)
        for key in ref:
            if rname == "file":
                assert port[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(port[key], ref[key],
                                          err_msg=f"rank {pid} {rname} {key}")


def test_parity_covers_every_shard(parity_dumps):
    """The ranks' rows are disjoint shards 0-7 and their counts add up."""
    for step in (0, 4, 10):
        gids = []
        for pid in range(N_PROC):
            _, arrays = parity_dumps[("port", pid)][step]
            gids += [int(k[5:]) for k in arrays if k.startswith("rows_")]
            counts = arrays["counts"]
        assert sorted(gids) == list(range(8))
        total = sum(len(parity_dumps[("port", p)][step][1][f"rows_{g}"])
                    for p in range(N_PROC)
                    for g in range(p * 4, p * 4 + 4))
        assert total == int(counts.sum()) > 0


# --- (d): the port's own dryrun -------------------------------------------------


def test_port_dryrun_two_ranks():
    from cbl_tpu_torch.parallel.distributed import launch_multihost_dryrun

    launch_multihost_dryrun(n_proc=2, devices_per_proc=4, bases=60_000,
                            timeout=240, device="cpu")


@pytest.mark.gpu
def test_port_dryrun_two_ranks_on_one_card():
    """The dryrun's defaults on a card: two ranks x 2 shards on the card,
    gloo where they share it (one card), NCCL with a card each; gloo
    takes the CUDA tensors of the exchange and the sums."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cbl_tpu_torch.parallel.distributed import launch_multihost_dryrun

    launch_multihost_dryrun(n_proc=2, devices_per_proc=2, bases=60_000,
                            timeout=300)


# --- (e), (g): K=59, the exchange, env://, the refused calls ---------------------


@pytest.fixture(scope="module")
def misc_run(tmp_path_factory):
    from cbl_tpu_torch.parallel.distributed import launch

    out = str(tmp_path_factory.mktemp("mh_misc"))
    launch(_code("_misc_worker", out), N_PROC, 240)
    res = []
    for pid in range(N_PROC):
        with open(os.path.join(out, f"misc.{pid}.json")) as f:
            info = json.load(f)
        with np.load(os.path.join(out, f"misc.{pid}.npz")) as z:
            info["arrays"] = {k: z[k] for k in z.files}
        res.append(info)
    res[0]["local_words"] = np.load(os.path.join(out, "local_words.npy"))
    return res


def test_env_init_takes_gloo_on_the_cpu(misc_run):
    assert [r["backend"] for r in misc_run] == ["gloo"] * N_PROC


def test_exchange_keeps_global_source_order(misc_run):
    for r in misc_run:
        assert r["exchange"] == [True, True, True]


def test_k59_two_ranks_match_one_process(misc_run):
    """The two ranks' build, (total, positive) of each round and words
    before and after the rounds equal a one-process ShardedCBL on 8 CPU
    shards with the ranks' agreed boundaries, fed the full streams."""
    import torch

    from cbl_tpu_torch.parallel import ShardedCBL

    a0, a1 = (r["arrays"] for r in misc_run)
    np.testing.assert_array_equal(a0["boundaries"], a1["boundaries"])
    np.testing.assert_array_equal(a0["counts"], a1["counts"])
    one = ShardedCBL(k=59, prefix_bits=28, mesh=[torch.device("cpu")] * 8)
    one.boundaries = a0["boundaries"]
    one._boundaries_from_data = True
    rng = np.random.default_rng(59)
    codes = rng.integers(0, 4, size=40_000, dtype=np.uint8)
    offsets = np.array([0, 9_000, 9_050, 25_000, 40_000], dtype=np.int64)
    one.insert_codes_stream(codes, offsets)
    np.testing.assert_array_equal(one.shard_counts, a0["counts"])
    assert int(a0["count"]) == int(a1["count"]) == one.count()
    rows = one.local_shard_rows()
    for g in range(8):
        np.testing.assert_array_equal(
            (a0 if g < 4 else a1)[f"build_{g}"], rows[g])
    tps = [one.dynamic_round(*_k59_round(r)) for r in range(3)]
    for a in (a0, a1):
        np.testing.assert_array_equal(a["tps"], np.array(tps))
        assert int(a["live"]) == one.count()
    one.flush()
    rows = one.local_shard_rows()
    for g in range(8):
        np.testing.assert_array_equal(
            (a0 if g < 4 else a1)[f"rounds_{g}"], rows[g])
    assert tps[0][1] > 0 and sum(len(r) for r in rows.values()) > 0
    # the chunked export: every rank gets every shard's rows in order
    for a in (a0, a1):
        np.testing.assert_array_equal(a["chunks"], one.words_array())
        assert int(a["n_chunks"]) == sum(-(-len(r) // 1000)
                                         for r in rows.values())


def test_a_local_mesh_inside_a_group_is_one_process(misc_run):
    """Rank 0 alone builds an index on a plain list of 2 CPU devices
    after rank 1 has left: no collective runs, it writes one plain file,
    and it equals a one-process index built outside any group."""
    import torch

    from cbl_tpu_torch.parallel import ShardedCBL

    loc = misc_run[0]["local"]
    assert "local" not in misc_run[1]
    one = ShardedCBL(k=59, prefix_bits=28, mesh=[torch.device("cpu")] * 2)
    rng = np.random.default_rng(59)
    codes = rng.integers(0, 4, size=40_000, dtype=np.uint8)
    offsets = np.array([0, 9_000, 9_050, 25_000, 40_000], dtype=np.int64)
    one.insert_codes_stream(codes, offsets)
    assert loc == dict(ranks=1, D=2, count=one.count(),
                       query=list(one.query_codes_stream(codes, offsets)),
                       file=True, back=True)
    np.testing.assert_array_equal(misc_run[0]["local_words"],
                                  one.words_array())


def test_a_rank_with_an_empty_slice(misc_run):
    """Rank 0 holds record 0 (9,000 bases), rank 1 nothing: the build,
    query and a round that inserts, queries and removes the record give
    the single index's answers on both ranks."""
    from cbl_tpu_torch import CBL

    codes = np.random.default_rng(59).integers(0, 4, size=40_000,
                                               dtype=np.uint8)
    single = CBL(k=59, prefix_bits=28, device="cpu")
    single.insert_codes_stream(codes[:9000], np.array([0, 9000]))
    n, nk = single.count(), 9000 - 59 + 1
    assert n > 0
    for r in misc_run:
        assert r["empty_slice"] == [n, nk, nk, nk, nk, 0], r["empty_slice"]


REFUSED = ["contains_codes_stream", "contains_seqs", "words_array",
           "to_cbl", "insert_codes_stream", "remove_codes_stream",
           "query_codes_stream", "pack_stream", "contains_words",
           "count_hits"]


@pytest.mark.parametrize("name", REFUSED)
def test_one_process_calls_raise_on_a_multiprocess_mesh(misc_run, name):
    call = "contains_codes_stream" if name == "contains_seqs" else name
    for r in misc_run:
        msg = r["raised"][name]
        assert msg.startswith(f"{call} runs on a mesh of one process"), msg
        if name.startswith("contains") or name == "count_hits":
            assert "multihost_query_stream" in msg, msg
        # the mesh stays whole: the ranks' query after the refused calls
        # finds every k-mer of the build (the rounds removed new ones)
        assert r["query"] == [39_776, 39_776], r["query"]


# --- (g): the calls of one process, beside cbl_tpu's -------------------------


@pytest.fixture(scope="module")
def calls_run(tmp_path_factory):
    """(g)'s steps in cbl_tpu's two processes and the port's two ranks at
    once; -> {side: ([per rank step dumps], [per rank outcomes])}."""
    from concurrent.futures import ThreadPoolExecutor

    from cbl_tpu_torch.parallel.distributed import launch

    out = str(tmp_path_factory.mktemp("mh_calls"))
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(launch, _code("_ref_calls_worker", out), N_PROC,
                          300, _ref_env())
        launch(_code("_port_calls_worker", out), N_PROC, 300)
        ref.result()
    res = {}
    for side in ("ref", "port"):
        dumps, outcomes = [], []
        for pid in range(N_PROC):
            steps = sorted(n for n in os.listdir(out)
                           if n.startswith(f"{side}.{pid}."))
            loaded = []
            for name in steps:
                with np.load(os.path.join(out, name)) as z:
                    loaded.append((name.split(".")[3],
                                   {k: z[k] for k in z.files}))
            dumps.append(loaded)
            with open(os.path.join(out, f"{side}_calls.{pid}.json")) as f:
                outcomes.append(json.load(f))
        res[side] = (dumps, outcomes)
    return res


@pytest.mark.parametrize("step", ["insert_words", "remove_words",
                                  "iter_words_chunks"])
def test_word_calls_match_cbl_tpu_across_processes(calls_run, step):
    """The same words on every rank: the state after `insert_words` and
    `remove_words` (boundaries, counts, capacity, every local shard's
    rows) and the chunked export equal cbl_tpu's, rank by rank."""
    for pid in range(N_PROC):
        ref = dict(calls_run["ref"][0][pid])[step]
        port = dict(calls_run["port"][0][pid])[step]
        assert sorted(ref) == sorted(port), (pid, step)
        for key in ref:
            np.testing.assert_array_equal(port[key], ref[key],
                                          err_msg=f"rank {pid} {step} {key}")
    if step == "iter_words_chunks":
        words = dict(calls_run["port"][0][0])[step]["words"]
        assert len(words) > 0


@pytest.mark.parametrize("name", CALLS_REFUSED)
def test_calls_cbl_tpu_cannot_run_across_processes(calls_run, name):
    """cbl_tpu raises on these calls on a two-process mesh (it cannot
    read a sharded result that spans another process); the port raises
    ValueError naming the call."""
    for pid in range(N_PROC):
        ref = calls_run["ref"][1][pid][name]
        port = calls_run["port"][1][pid][name]
        assert ref[0] == "raised" and ref[1] == "RuntimeError", ref
        assert "non-addressable" in ref[2], ref
        assert port[:2] == ["raised", "ValueError"], port
        assert port[2].startswith(f"{name} runs on a mesh of one process")


@pytest.mark.parametrize("name", ["insert_codes_stream",
                                  "query_codes_stream"])
def test_record_stream_calls_of_one_process_are_refused(calls_run, name):
    """Every process passing the full stream, cbl_tpu's calls return but
    their counts are not the single index's (each process stages every
    shard's rows as its own); the port's refuse."""
    for pid in range(N_PROC):
        out = calls_run["ref"][1][pid]
        ref = out[name]
        assert ref[0] == "returned", ref
        if name == "insert_codes_stream":
            assert 0 < ref[1] != out["single_count"], (ref, out)
        else:
            assert ref[1][0] != out["single_total"], (ref, out)
        port = calls_run["port"][1][pid][name]
        assert port[:2] == ["raised", "ValueError"], port
        assert port[2].startswith(f"{name} runs on a mesh of one process")


# --- (f): failures reach the launcher ----------------------------------------------


def test_a_failing_rank_fails_the_launch():
    """Rank 1 raises after joining; rank 0 waits in a barrier (gloo's
    timeout 60 s).  The launcher kills rank 0 and raises with rank 1's
    output well before either timeout."""
    from cbl_tpu_torch.parallel.distributed import launch

    code = ("import torch; torch.set_num_threads(1); "
            "import torch.distributed as dist; "
            "from cbl_tpu_torch.parallel.distributed import "
            "init_distributed as i; "
            "i('{coordinator}', 2, {pid}, device='cpu', timeout_s=60.0); "
            "assert {pid} == 0, 'rank {pid} gives up'; dist.barrier()")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed") as err:
        launch(code, 2, timeout=90)
    assert "rank 1 gives up" in str(err.value)
    assert time.monotonic() - t0 < 45


def test_a_hung_rank_times_out():
    from cbl_tpu_torch.parallel.distributed import launch

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="still running after 3 s"):
        launch("import time; time.sleep(60 + {pid})", 2, timeout=3)
    assert time.monotonic() - t0 < 30


def test_launcher_returns_every_output():
    from cbl_tpu_torch.parallel.distributed import launch

    outs = launch("print('rank', {pid}, '{coordinator}'.count(':'))", 3,
                  timeout=60)
    assert [o.split() for o in outs] == [["rank", str(p), "1"]
                                         for p in range(3)]


def test_dryrun_defaults_to_the_card(monkeypatch):
    """With no arguments the dryrun's launcher and worker ask for the
    card: without one both raise before a rank starts or joins."""
    import torch

    from cbl_tpu_torch.parallel import distributed as d

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        d.launch_multihost_dryrun()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        d.run_multihost_dryrun_worker("127.0.0.1:1", 2, 0)


@pytest.mark.parametrize("device,cards,backend", [
    ("cpu", 0, "gloo"), ("cpu", 4, "gloo"), ("cuda", 1, "gloo"),
    ("cuda", 2, "nccl"), ("cuda", 8, "nccl")])
def test_dryrun_backend_from_the_card_count(monkeypatch, device, cards,
                                            backend):
    """Two ranks: gloo where they share a card, NCCL with a card each."""
    import torch

    from cbl_tpu_torch.parallel.distributed import dryrun_backend

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert dryrun_backend(device, 2) == backend


def test_make_mesh_over_a_group_needs_one():
    import torch

    from cbl_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="initialised"):
        make_mesh([torch.device("cpu")] * 2, process_group=True)
    mesh = make_mesh([torch.device("cpu")] * 2)
    assert (mesh.rank, mesh.ranks, len(mesh)) == (0, 1, 2)
    assert make_mesh(mesh) is mesh


def test_init_distributed_needs_the_whole_address():
    from cbl_tpu_torch.parallel.distributed import init_distributed

    with pytest.raises(ValueError, match="num_processes"):
        init_distributed("127.0.0.1:1", device="cpu")
