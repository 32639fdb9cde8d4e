"""Several processes on one global mesh: ranks on `torch.distributed`.

Counterpart of `cbl_tpu/parallel/distributed.py`.  `init_distributed`
joins P processes into one `torch.distributed` group; a `ShardedCBL` on
`make_mesh()` (or on `make_mesh(devices, process_group=True)`) in each
rank then spans the global mesh (the ranks' meshes in rank order,
`shard.py`), its exchange is one `all_to_all_single` and its sums an
`all_reduce`.  The host-side seam is input partitioning: each rank streams
a disjoint, base-balanced slice of the records (`host_record_slice`,
`slice_codes`); set semantics make insert order irrelevant.  Every rank
must stage equal shapes, so the calls below agree on them first:
`cbl_tpu`'s `process_allgather` max is an `all_reduce(MAX)` of a small
int64 tensor (`shard._agree_max`), its `broadcast_one_to_all` a
`broadcast` from rank 0.

The backend is NCCL for a CUDA mesh with one card a rank, gloo for the CPU
and for ranks that share a card (NCCL does not put two ranks on one
device; `dryrun_backend`); gloo takes the CUDA tensors as they are.  No
call switches backends on an error, and every group has a finite
timeout, so a rank that leaves makes the others raise instead of hang.

`run_multihost_dryrun_worker` / `launch_multihost_dryrun` are the
reference's two-process check, against the port's single `CBL` on the
full stream.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .shard import ShardedStream, _agree_max, build_slab_groups

DEFAULT_TIMEOUT_S = 300.0


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     device: str = "cuda") -> None:
    """Join a process group: `coordinator_address` ("host:port", rank 0
    listens there) with `num_processes` and `process_id`, or with no
    arguments the `env://` variables that `torchrun` sets (`MASTER_ADDR`,
    `MASTER_PORT`, `WORLD_SIZE`, `RANK`).  `backend` defaults to NCCL
    for `device` "cuda" and gloo for "cpu"; ranks that share one card
    pass "gloo".  For CUDA the rank's card is `cuda:(LOCAL_RANK % cards)`
    (LOCAL_RANK from the environment, else the rank), as `make_mesh`
    takes it.  A collective that waits longer than `timeout_s` raises."""
    import datetime

    import torch.distributed as dist

    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None:
        init_method, world, rank = "env://", -1, -1
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda') needs a CUDA "
                               "device and none is available")
        local = int(os.environ.get(
            "LOCAL_RANK", rank if rank >= 0 else os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def dryrun_backend(device: str, n_proc: int) -> str:
    """The backend of `n_proc` local ranks on `device`: gloo on the CPU
    and where the ranks outnumber the cards (ranks share a card), else
    NCCL (one card a rank).  Decided from the card count, never from an
    error."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= n_proc else "gloo"


def _n_groups(idx, codes: np.ndarray, nk_sub: int) -> int:
    """The group count of the longest rank's slice (all ranks)."""
    nk = max(len(codes) - idx.cfg.k + 1, 0)
    n_local = (max(nk, 1) + nk_sub - 1) // nk_sub
    d_local = len(idx.mesh)
    mine = (n_local + d_local - 1) // d_local
    return _agree_max([mine], idx.mesh[0], idx._ranks)[0]


def _local_groups(idx, codes, offsets, nk_sub: int, icap: int):
    """This rank's slab groups at the agreed count: all-blank dummies
    where its slice is short or empty."""
    n_groups = _n_groups(idx, codes, nk_sub)
    return list(build_slab_groups(idx._front, codes, offsets, nk_sub,
                                  len(idx.mesh), icap=icap,
                                  n_groups=n_groups))


def multihost_insert_stream(idx, codes: np.ndarray, offsets: np.ndarray,
                            nk_sub: int = 4096, icap: int = 64) -> None:
    """Insert THIS rank's record slice into a global ShardedCBL.

    Every rank calls this with its own (codes, offsets) sub-stream
    (`host_record_slice` + `slice_codes`); each stages uniform sub-slab
    groups for its own shards and all run the same bulk insert steps
    (pipeline -> exchange -> merge).  Shapes are agreed: fixed nk_sub and
    icap, the group count the maximum over the ranks (short ranks stage
    all-blank dummy slabs).  Boundaries come from rank 0's first slab
    (`_agree_boundaries_from_stream`).  A bucket overflow raises at the
    end, as `cbl_tpu`'s does (no re-run)."""
    idx.flush()
    if not idx._boundaries_from_data and idx._ranks > 1 and idx.D > 1:
        _agree_boundaries_from_stream(idx, codes, offsets, nk_sub)
    for nk_sub_, stream, starts, ends in _local_groups(idx, codes, offsets,
                                                       nk_sub, icap):
        idx._insert_group(nk_sub_, idx._put_rows(stream, True),
                          idx._put_rows(starts), idx._put_rows(ends))
    idx._check_dropped()


def multihost_remove_stream(idx, codes: np.ndarray, offsets: np.ndarray,
                            nk_sub: int = 4096, icap: int = 64) -> None:
    """Remove THIS rank's record slice from a global ShardedCBL, the bulk
    remove counterpart of `multihost_insert_stream`.  Exact under any
    partition, as the port's one-process remove: steps that dropped words
    (the drop count summed over the ranks) are all re-run with larger
    buckets by every rank; `cbl_tpu`'s drops them silently."""
    idx.flush()
    groups = _local_groups(idx, codes, offsets, nk_sub, icap)
    idx._remove_rerun(lambda: iter(groups))


def multihost_query_stream(idx, codes: np.ndarray, offsets: np.ndarray,
                           nk_sub: int = 4096, icap: int = 64):
    """(total, positive) over the UNION of all ranks' record slices."""
    idx.flush()
    total = positive = None
    for nk_sub_, stream, starts, ends in _local_groups(idx, codes, offsets,
                                                       nk_sub, icap):
        t, p = idx._query_group(nk_sub_, idx._put_rows(stream, True),
                                idx._put_rows(starts), idx._put_rows(ends))
        total = t if total is None else total + t
        positive = p if positive is None else positive + p
    if total is None:
        return 0, 0
    return idx._reduce_query(total, positive)


def _broadcast_boundaries(idx) -> None:
    """Every rank adopts rank 0's boundaries (one `broadcast`)."""
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(idx.boundaries)).to(
        idx.mesh[0])
    dist.broadcast(t, 0)
    idx.boundaries = t.cpu().numpy()
    idx._boundaries_from_data = True


def _agree_boundaries_from_stream(idx, codes: np.ndarray,
                                  offsets: np.ndarray, nk_sub: int = 4096,
                                  icap: int = 64) -> None:
    """Adopt rank 0's data-quantile boundaries on every rank: each rank
    derives quantiles from its own first sub-slab (one pipeline pass),
    then takes rank 0's by a broadcast, so every rank routes alike."""
    icap = max(icap, 1 << max(4, int(len(offsets) + 2).bit_length()))
    g = next(iter(build_slab_groups(idx._front, codes, offsets, nk_sub, 1,
                                    icap=icap, n_groups=1)))
    idx._maybe_init_boundaries_from_stream(*g)
    _broadcast_boundaries(idx)


def multihost_pack_stream(idx, codes: np.ndarray, offsets: np.ndarray,
                          nk_sub: int = 4096, icap: int = 64):
    """Stage THIS rank's record slice as a SINGLE-group ShardedStream on
    the global mesh, the multi-process counterpart of
    `ShardedCBL.pack_stream` for dynamic rounds.  Shapes are equal on
    every rank: nk_sub is raised until the local slice fits its D_local
    sub-slabs and icap until it holds the slice's record density, then
    both are the maxima over the ranks; short ranks stage all-blank
    dummy slabs."""
    d_local = len(idx.mesh)
    k = idx.cfg.k
    # slabs cover the whole code stream contiguously (records are blank
    # intervals), so the slab count is ceil(nk / nk_sub)
    nk = max(len(codes) - k + 1, 0)
    while -(-max(nk, 1) // nk_sub) > d_local:
        nk_sub *= 2
    icap = max(icap, 1 << max(4, int(len(offsets) + 2).bit_length()))
    nk_sub, icap = _agree_max([nk_sub, icap], idx.mesh[0], idx._ranks)
    (nk_sub_, stream, starts, ends), = build_slab_groups(
        idx._front, codes, offsets, nk_sub, d_local, icap=icap, n_groups=1)
    host0 = (nk_sub_, stream, starts, ends)
    return ShardedStream(idx._stream_key, [
        (nk_sub_, idx._put_rows(stream, True), idx._put_rows(starts),
         idx._put_rows(ends))], host0)


def multihost_dynamic_round(idx, ins, qry, rm, lazy: bool = False):
    """One interleaved insert / count-query / remove round over the
    GLOBAL mesh from per-rank record slices, the multi-process
    counterpart of `ShardedCBL.dynamic_round`.  Each argument is THIS
    rank's (codes, offsets) slice or a stream from `multihost_pack_stream`
    (a re-used stream keeps its sorted-words memo).  Before the partition
    is set, rank 0's data quantiles become every rank's boundaries; the
    round's sums are all-reduced, so every rank holds (total, positive)."""
    ps = [x if isinstance(x, ShardedStream)
          else multihost_pack_stream(idx, *x) for x in (ins, qry, rm)]
    if idx._ranks > 1 and not idx._partition_set():
        idx._maybe_init_boundaries_from_stream(*ps[0]._host0)
        _broadcast_boundaries(idx)
    nv_q, hits = idx.dynamic_round(*ps, lazy=True)
    if lazy:
        return nv_q, hits
    return idx._reduce_query(nv_q, hits)


def _assert_local_shards_match(idx, ref_words: np.ndarray, ctx: str) -> None:
    """Word-level placement: this rank's shards must equal their
    count-delimited slices of the single index's sorted word array
    (shard-major is the global sorted order), so a routing fault that
    keeps the count but misplaces words fails here."""
    counts = idx.shard_counts
    assert int(counts.sum()) == ref_words.shape[0], (
        ctx, int(counts.sum()), ref_words.shape[0])
    starts = np.concatenate([[0], np.cumsum(counts)])
    for gid, rows in idx.local_shard_rows().items():
        expect = ref_words[starts[gid] : starts[gid + 1]]
        np.testing.assert_array_equal(rows, expect,
                                      err_msg=f"{ctx} shard {gid}")


def run_multihost_dryrun_worker(coordinator: str, n_proc: int, pid: int,
                                bases: int = 60_000, k: int = 25,
                                devices_per_proc: int = 4,
                                device: str = "cuda",
                                backend: str | None = None,
                                timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """One rank of the multi-process check: join the group, build ONE
    global ShardedCBL (`devices_per_proc` shards a rank on `device`) from
    per-rank record slices, and hold it to the port's single `CBL` of the
    full stream at word level (exact shard placement) through a query, a
    checkpoint round trip, a remove, an intersection, three staged dynamic
    rounds and a checkpoint after them.  `device` "cuda" (the default:
    rank r on `cuda:(r % cards)`, no card raises) or "cpu"; `backend`
    defaults to `dryrun_backend`."""
    import tempfile

    import torch.distributed as dist

    from ..cbl import CBL
    from .shard import ShardedCBL, make_mesh

    if torch.device(device).type == "cpu":
        torch.set_num_threads(2)  # ranks share the host's cores
    if backend is None:
        backend = dryrun_backend(device, n_proc)
    init_distributed(coordinator, n_proc, pid, backend=backend,
                     timeout_s=timeout_s, device=device)
    try:
        assert dist.get_world_size() == n_proc
        dev = (torch.device("cpu") if torch.device(device).type == "cpu"
               else make_mesh()[0])
        mesh = make_mesh([dev] * devices_per_proc, process_group=True)
        rng = np.random.default_rng(7)
        codes = rng.integers(0, 4, size=bases, dtype=np.uint8)
        offsets = np.array([0, bases // 3, bases // 2, bases - 11, bases],
                           dtype=np.int64)
        lo, hi = host_record_slice(offsets, pid, n_proc)
        codes_l, offsets_l = slice_codes(codes, offsets, lo, hi)

        idx = ShardedCBL(k=k, mesh=mesh)
        multihost_insert_stream(idx, codes_l, offsets_l)
        n = idx.count()
        ref = CBL(k=k, device=dev)
        ref.insert_codes_stream(codes, offsets)
        expect = ref.count()
        assert n == expect, f"multihost count {n} != single index {expect}"
        _assert_local_shards_match(idx, ref.wordset.words_array(), "build")

        total, positive = multihost_query_stream(idx, codes_l, offsets_l)
        nk_expect = sum(max(int(offsets[i + 1] - offsets[i]) - k + 1, 0)
                        for i in range(len(offsets) - 1))
        assert total == nk_expect, (total, nk_expect)
        assert positive == total, (positive, total)

        # checkpoint round trip: one file a rank, no gather
        port = coordinator.rsplit(":", 1)[-1]
        tmp = tempfile.gettempdir()
        ck = os.path.join(tmp, f"cbl_torch_mh_ck_{port}.npz")
        idx.save_to_file(ck)
        back = ShardedCBL.load_from_file(ck, mesh=mesh)
        assert back.count() == n
        _assert_local_shards_match(back, ref.wordset.words_array(),
                                   "checkpoint")

        # remove: every rank removes the FIRST record of its slice
        rm_off = offsets_l[:2].copy()
        multihost_remove_stream(idx, codes_l[: rm_off[1]], rm_off)
        for p in range(n_proc):
            plo, phi = host_record_slice(offsets, p, n_proc)
            sub, sub_off = slice_codes(codes, offsets, plo, phi)
            ref.remove_codes_stream(sub[: sub_off[1]], sub_off[:2])
        assert idx.count() == ref.count(), (idx.count(), ref.count())
        _assert_local_shards_match(idx, ref.wordset.words_array(), "remove")
        t2, p2 = multihost_query_stream(idx, codes_l, offsets_l)
        assert t2 == nk_expect and 0 < p2 < t2, (t2, p2)

        # set algebra across the mesh: the checkpoint copy (the set before
        # the remove) intersected gives the set after it
        inter = idx & back
        assert inter.count() == idx.count()
        _assert_local_shards_match(inter, ref.wordset.words_array(),
                                   "intersect")

        # interleaved rounds across ranks: each rank its slice of the
        # three streams; (total, positive) and the folded placement equal
        # the single index's rounds on the full streams
        rng2 = np.random.default_rng(11)
        segs = []
        for _ in range(3):
            scodes = rng2.integers(0, 4, size=4000, dtype=np.uint8)
            segs.append((scodes, np.arange(0, 4001, 1000, dtype=np.int64)))

        def proc_slice(seg):
            lo_, hi_ = host_record_slice(seg[1], pid, n_proc)
            return slice_codes(seg[0], seg[1], lo_, hi_)

        staged = [multihost_pack_stream(idx, *proc_slice(s)) for s in segs]
        halves = []
        for scodes, soff in segs:
            hoff = soff[: len(soff) // 2 + 1].copy()
            halves.append((scodes[: hoff[-1]], hoff))
        staged_h = [multihost_pack_stream(idx, *proc_slice(h))
                    for h in halves]
        for r in range(3):
            got = multihost_dynamic_round(idx, staged[r],
                                          staged[r - 1 if r else 0],
                                          staged_h[r])
            want = ref.dynamic_round(segs[r], segs[r - 1 if r else 0],
                                     halves[r])
            assert got == tuple(want), (r, got, want)
        assert idx.count() == ref.count(), (idx.count(), ref.count())
        idx.flush()  # the placement check reads the folded shards
        assert idx.count() == ref.count(), (idx.count(), ref.count())
        _assert_local_shards_match(idx, ref.wordset.words_array(),
                                   "dyn-rounds")

        # a checkpoint after the rounds: the save folds; the load matches
        ck2 = os.path.join(tmp, f"cbl_torch_mh_ck2_{port}.npz")
        idx.save_to_file(ck2)
        back2 = ShardedCBL.load_from_file(ck2, mesh=mesh)
        assert back2.count() == ref.count()
        _assert_local_shards_match(back2, ref.wordset.words_array(),
                                   "dyn-checkpoint")
        for base_ in (ck, ck2):  # each rank removes its own file
            f = ShardedCBL._shard_file(base_, pid, n_proc)
            if os.path.exists(f):
                os.remove(f)
        dist.barrier()
        if pid == 0:
            print(f"MULTIHOST_OK n={n} total={total} "
                  f"after_remove={idx.count()}", flush=True)
    finally:
        dist.destroy_process_group()


def launch(code: str, n_proc: int, timeout: float,
           env: dict | None = None) -> list:
    """Run `code` (Python, formatted with `coordinator` and `pid`) in
    `n_proc` fresh processes from the repository root, `python -c`: none
    is forked from a process that touched CUDA.  -> each one's output.
    If one fails, the others are killed and this raises with that one's
    last 3000 characters of output; past `timeout` seconds all are killed
    and it raises too."""
    import socket
    import subprocess
    import sys
    import tempfile
    import time

    with socket.socket() as sock:  # a port that was free a moment ago
        sock.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ if env is None else env)
    logs = [tempfile.TemporaryFile() for _ in range(n_proc)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(coordinator=coordinator,
                                           pid=pid)],
        cwd=repo, env=env, stdout=logs[pid], stderr=subprocess.STDOUT)
        for pid in range(n_proc)]

    def output(pid: int) -> str:
        logs[pid].seek(0)
        return logs[pid].read().decode(errors="replace")

    failed = None
    deadline = time.monotonic() + timeout
    try:
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((pid for pid, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if failed is None and time.monotonic() > deadline:
                failed = "timeout"
            if failed is None:
                time.sleep(0.05)
        if failed is None:
            failed = next((pid for pid, p in enumerate(procs)
                           if p.returncode != 0), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate(timeout=60)
    outs = [output(pid) for pid in range(n_proc)]
    for f in logs:
        f.close()
    if failed == "timeout":
        raise RuntimeError(f"ranks still running after {timeout} s:\n"
                           + "\n".join(o[-3000:] for o in outs))
    if failed is not None:
        raise RuntimeError(
            f"rank {failed} failed (rc {procs[failed].returncode}):\n"
            f"{outs[failed][-3000:]}")
    return outs


def launch_multihost_dryrun(n_proc: int = 2, devices_per_proc: int = 4,
                            bases: int = 60_000, timeout: int = 600,
                            device: str = "cuda",
                            backend: str | None = None) -> None:
    """Spawn `n_proc` local ranks, each with `devices_per_proc` shards on
    `device` ("cuda", the default, or "cpu" when asked for), and run
    `run_multihost_dryrun_worker` in every one.  `backend` defaults to
    `dryrun_backend`: gloo where the ranks share a card.  With no card the
    default raises; it never falls back to the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch_multihost_dryrun(device='cuda') needs a "
                           "CUDA device and none is available; pass "
                           "device='cpu' for the plain tensor path")
    if backend is None:
        backend = dryrun_backend(device, n_proc)
    code = ("from cbl_tpu_torch.parallel.distributed import "
            "run_multihost_dryrun_worker as w; "
            f"w('{{coordinator}}', {n_proc}, {{pid}}, bases={bases}, "
            f"devices_per_proc={devices_per_proc}, device={device!r}, "
            f"backend={backend!r}, timeout_s={float(timeout)})")
    outs = launch(code, n_proc, timeout)
    if "MULTIHOST_OK" not in outs[0]:
        raise RuntimeError(f"rank 0 did not finish:\n{outs[0][-3000:]}")


def host_record_slice(offsets: np.ndarray, host_id: int, n_hosts: int):
    """Assign records to this host, balanced by total bases.

    offsets: [n_records+1] record boundaries of a code stream.  Returns
    (record_lo, record_hi): this host's contiguous record range.  Contiguous
    ranges keep each host's stream a single slice of the input file."""
    total = int(offsets[-1])
    lo_target = total * host_id // n_hosts
    hi_target = total * (host_id + 1) // n_hosts
    record_lo = int(np.searchsorted(offsets[:-1], lo_target, side="left"))
    record_hi = int(np.searchsorted(offsets[:-1], hi_target, side="left"))
    if host_id == n_hosts - 1:
        record_hi = len(offsets) - 1
    return record_lo, record_hi


def slice_codes(codes: np.ndarray, offsets: np.ndarray, record_lo: int,
                record_hi: int):
    """Extract one host's (codes, offsets) sub-stream."""
    lo = int(offsets[record_lo])
    hi = int(offsets[record_hi])
    sub = codes[lo:hi]
    sub_off = offsets[record_lo : record_hi + 1] - lo
    return sub, sub_off.astype(np.int64)
