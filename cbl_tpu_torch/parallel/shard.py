"""The k-mer set partitioned over a mesh of torch devices by word range.

Counterpart of `cbl_tpu/parallel/shard.py`.  Where `cbl_tpu` runs one
`jax.shard_map` program over a 1-D device mesh, this port runs the same
local step on each shard in turn, as eager PyTorch on that shard's
device:

- the mesh is a list of `torch.device`, one per shard (`make_mesh`: every
  CUDA card by default; a device may be named for several shards, as the
  tests name the CPU eight times for `cbl_tpu`'s eight virtual devices);
- a mesh made by `make_mesh(..., process_group=True)` (the default
  devices under an initialised `torch.distributed` group of P > 1 ranks,
  `distributed.init_distributed`) is this rank's part of a global mesh:
  every rank lists as many shards (D_local), and the global mesh is the
  ranks' parts in rank order: D = P D_local shards, rank r holding shards
  r D_local to (r + 1) D_local - 1 (`_local_shard_ids`), as `cbl_tpu`'s
  processes hold their addressable devices; a rank holds no tensor of
  another rank's shard, and the lists below are its local shards.  A plain
  list of devices stays a mesh of one process, also inside a group, as a
  mesh of local devices does in `cbl_tpu`;
- each shard holds one sorted, SENTINEL-padded key tensor on its device
  ([C] keys, or [2, C] rows from K=29, `limbs`), the same layout as
  `DeviceWordSet.data`; the state is a list of D such tensors, and while
  dynamic rounds run, a list of D sorted logs in the port's slog layout
  (`wordset.slog_packed`: one key a row, or the word's columns and a tag
  column);
- the word space is range-partitioned by D-1 boundaries (int64 keys in
  the port's layout; `cbl_tpu`'s [D-1, L] uint32 limbs only in files and
  in `state`), so concatenating the shards in mesh order gives the
  global sorted word order;
- `_route_sorted` turns a shard's sorted rows into a [D, cap] send buffer
  by one gather, and `_all_to_all` is the one place where shards meet:
  destination d receives the concatenation over sources s of
  `sends[s][d]`, moved to `mesh[d]` (`jax.lax.all_to_all(tiled=True)`);
  across ranks that is one `all_to_all_single` of equal splits, and the
  concatenation stays in global source-shard order;
- `cbl_tpu`'s `psum` is a sum of the shards' 0-d tensors on the first
  shard's device (`_total`), across ranks an `all_reduce`; the per-shard
  counts of every rank are an `all_gather` (`_total_host`,
  `cbl_tpu`'s `_gather_counts_fn`).  Both are read only where `cbl_tpu`
  reads them, and every rank runs the same collectives in the same order:
  every shape, cap and capacity comes from agreed values or global counts.

Every local step reuses the single index's code: the word pipeline
(`cbl._device_words`: B1, B2), the sort and merge seam (`ops.sort`: B3 by
default), the word set's kernels (marks, compaction, joins) and its
sorted log (`wordset.SortedLog`: one log a shard, its entry, seq cap,
capacity, tagged batch, merge and scan (B3, B4), commit and fold).  Bucket
sizes, capacities, the quantile boundaries and the slog's bookkeeping
are `cbl_tpu`'s, so boundaries, per-shard counts and rows and the log's
seq, real-row bound and capacity equal `cbl_tpu`'s on the same input.

One intended difference: a bulk remove whose routing overflows a bucket
re-runs its stream with larger buckets (removing twice is a no-op), so it
is exact under any partition; `cbl_tpu`'s drops the overflow silently.
Under ranks the re-run decides on the all-reduced drop count, so every
rank re-runs together.

On a multi-process mesh each rank stages its own records through
`distributed.multihost_*`, the word-level `insert_words` /
`remove_words` take the same words on every rank, `iter_words_chunks`
hands every rank every chunk (one `broadcast` from the owner), and
checkpoints are one file a rank (`_shard_file`).  The calls that read
every shard's rows or masks into one process (`words_array`, `to_cbl`,
`contains_words`, `count_hits`, the ordered masks) raise `ValueError`
there, as `cbl_tpu`'s raise; so do the record-stream calls of one
process, which stage every shard's rows in each process and where
`cbl_tpu` returns counts that are not the single index's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..cbl import CBL, _device_words, _stream_len, host_to_device
from ..config import get_config
from ..kmer import encode_seq
from ..limbs import (
    SENTINEL,
    cols,
    from_limbs,
    ints_to_keys,
    is_valid,
    key_cols,
    major,
    searchsorted,
    sentinel_rows,
    stack,
    to_limbs,
)
from ..ops.sort import sort_keys
from ..serialize import _npz_path
from ..wordset import (
    MIN_CAP,
    SortedLog,
    _contains_kernel,
    _contains_sortjoin_kernel,
    _count_hits_merge_kernel,
    _dedup_sorted_kernel,
    _distinct_count,
    _fit,
    _merge_rows,
    _merge_sortcompact_kernel,
    _next_pow2,
    _out_cap,
    _setop_sort_kernel_packed,
    host_limbs,
    resolve_device,
    slog_key,
    sort_rows,
)

_MAGIC = b"CBLXSHRD"
# `cbl_tpu`'s set operation names -> the port's `_setop_keep` ops
_SETOPS = {"union": "union", "intersection": "inter",
           "difference": "diff", "symmetric_difference": "symdiff"}


def _group_initialised() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _process_group() -> tuple:
    """(rank, ranks) of the initialised `torch.distributed` group, or
    (0, 1) without one."""
    import torch.distributed as dist

    if _group_initialised():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh(list):
    """The shards' devices, one entry a shard (`make_mesh`).  With
    `ranks` > 1 it is rank `rank`'s part of a global mesh of `ranks`
    equal parts in rank order; else a mesh of one process."""

    def __init__(self, devices, rank: int = 0, ranks: int = 1):
        super().__init__(devices)
        self.rank, self.ranks = rank, ranks


def make_mesh(devices=None, process_group: bool | None = None) -> Mesh:
    """The shards' devices: `devices` (torch devices or names; one may
    repeat), or every CUDA card.  With `process_group` the mesh is this
    rank's part of a global mesh over the ranks of the initialised
    `torch.distributed` group, every rank with as many shards: `devices`,
    or one shard on `cuda:(LOCAL_RANK % cards)` (LOCAL_RANK from the
    environment, else the rank).  `process_group` defaults to True for
    the default devices under a group of several ranks (`cbl_tpu`'s
    `make_mesh()` takes every global device) and to False for named
    devices, which stay a mesh of one process; a `Mesh` passed in is
    kept.  With no card the default raises; it never falls back to the
    CPU."""
    if isinstance(devices, Mesh) and process_group is None:
        return devices
    rank, ranks = _process_group()
    if process_group is None:
        process_group = devices is None and ranks > 1
    if process_group and not _group_initialised():
        raise ValueError("a mesh over a process group needs an initialised "
                         "torch.distributed group "
                         "(distributed.init_distributed)")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() shards over the CUDA devices and none is "
                "available; pass devices=[torch.device('cpu')] * D for the "
                "plain tensor path"
            )
        cards = torch.cuda.device_count()
        if process_group:
            local = int(os.environ.get("LOCAL_RANK", rank))
            devices = [torch.device("cuda", local % cards)]
        else:
            devices = [torch.device("cuda", i) for i in range(cards)]
    mesh = [resolve_device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return Mesh(mesh, rank, ranks) if process_group else Mesh(mesh)


def _all_to_all(sends: list, mesh: list) -> list:
    """The exchange: `sends[s]` is source shard s's [..., D, cap] buffer;
    destination d receives [..., D * cap], the concatenation over s of
    `sends[s][..., d, :]`, on `mesh[d]`.  On a mesh over several ranks
    (`Mesh.ranks`) the lists hold a rank's local shards, and one
    `all_to_all_single` of equal splits moves the buffers laid out by
    destination rank; each local destination
    still receives the concatenation over the GLOBAL sources in shard-id
    order.  Under gloo the tensors stay on the card: gloo copies them
    through host memory itself, and explicit pinned copies measured no
    faster on one H100 (`chip_smoke.py` phase 13 (e))."""
    ranks = getattr(mesh, "ranks", 1)
    if ranks == 1:
        D = len(mesh)
        return [
            torch.cat([sends[s][..., d, :].to(mesh[d]) for s in range(D)],
                      dim=-1)
            for d in range(D)
        ]
    import torch.distributed as dist

    n = len(mesh)  # local shards a rank: sources and destinations
    x = torch.stack([s.to(mesh[0]) for s in sends])  # [n, ..., D, cap]
    lead, cap = tuple(x.shape[1:-2]), x.shape[-1]
    nl = len(lead)
    is_bool = x.dtype == torch.bool
    if is_bool:  # gloo moves no bool
        x = x.to(torch.uint8)
    # [n src, ..., ranks, n dst, cap] -> [ranks, n src, ..., n dst, cap]
    x = x.reshape(n, *lead, ranks, n, cap).permute(
        1 + nl, 0, *range(1, 1 + nl), 2 + nl, 3 + nl).contiguous()
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x)  # dim 0: the source rank now
    if is_bool:
        y = y.bool()
    # destination j: [ranks, n src, ..., cap] -> [..., ranks n cap]
    order = (*range(2, 2 + nl), 0, 1, 2 + nl)
    return [y[..., j, :].permute(order).reshape(*lead, ranks * n * cap)
            .to(dev) for j, dev in enumerate(mesh)]


def _total(parts: list, device, ranks: int = 1) -> torch.Tensor:
    """`psum`: the sum of the shards' 0-d tensors (or of equal-shape
    vectors, elementwise) on `device`, int64, unsynced; across `ranks` an
    `all_reduce` of the local sums."""
    s = torch.stack([p.to(device).to(torch.int64) for p in parts]).sum(0)
    if ranks > 1:
        import torch.distributed as dist

        s = s.reshape(-1)
        dist.all_reduce(s)
        s = s.reshape(parts[0].shape)
    return s


def _total_host(parts: list, device, ranks: int = 1) -> np.ndarray:
    """The shards' 0-d counts read into one int64 numpy array of every
    shard of the mesh (across `ranks` an `all_gather`, rank-major:
    `cbl_tpu`'s `_gather_counts_fn`)."""
    local = torch.stack([p.to(device).to(torch.int64) for p in parts])
    if ranks > 1:
        import torch.distributed as dist

        out = [torch.empty_like(local) for _ in range(ranks)]
        dist.all_gather(out, local)
        local = torch.cat(out)
    return local.cpu().numpy()


def _agree_max(values, device, ranks: int) -> list:
    """The elementwise maximum over the ranks of a list of ints (one
    `all_reduce(MAX)` of an int64 tensor on `device`; `cbl_tpu`'s
    `process_allgather` then max)."""
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=device)
    if ranks > 1:
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.cpu().tolist()


def _route_sorted(s: torch.Tensor, bnd: torch.Tensor, cap: int,
                  payload=(), include_sentinels: bool = False):
    """The [D, cap] (or [C, D, cap]) send buffer of SORTED rows `s` ([B] or
    [C, B]) against the D-1 boundary rows `bnd`, as `cbl_tpu`'s
    `_route_sorted`: bucket b holds the rows in [off[b], off[b+1]), where
    off counts the valid rows below each boundary, taken by ONE gather and
    padded with SENTINEL rows.  1-D `payload` columns ride along by the
    same gather (pads SENTINEL).  Rows past `cap` in a bucket are dropped
    and counted.  `include_sentinels` routes SENTINEL rows too, to the
    last bucket.  -> (send, payloads, dropped int64 0-d)."""
    B, D, dev = s.shape[-1], bnd.shape[-1] + 1, s.device
    n_end = (torch.full((1,), B, dtype=torch.int64, device=dev)
             if include_sentinels else is_valid(s).sum().reshape(1))
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    off = torch.cat([zero, searchsorted(s, bnd).to(torch.int64), n_end])
    cnt = off[1:] - off[:-1]
    j = torch.arange(cap, device=dev)
    src = (off[:D, None] + j).clamp(0, B - 1)
    keep = j < cnt.clamp(max=cap)[:, None]
    send = torch.where(keep, s[..., src], SENTINEL)
    outs = tuple(torch.where(keep, p[src], SENTINEL) for p in payload)
    return send, outs, (cnt - cap).clamp(min=0).sum()


def _slog_bounds(bnd: torch.Tensor, packed: bool) -> torch.Tensor:
    """Boundary rows in the log's layout with tag 0, so that a log row
    routes by its word alone (`cbl_tpu` routes packed rows against
    `_shl8_or(boundaries, 0)`): slog keys, or the word's columns and a
    zero tag column."""
    if packed:
        return slog_key(bnd, 0)
    return torch.stack([*cols(bnd), torch.zeros_like(major(bnd))])


def build_slab_groups(front: CBL, codes: np.ndarray, offsets: np.ndarray,
                      nk_sub: int, rows: int, icap: int | None = None,
                      n_groups: int | None = None):
    """Stack uniform sub-slabs (`CBL._fused_slabs(uniform=True)`) into
    groups of `rows` shards: yield (nk_sub, stream [rows, Sw] uint32,
    starts [rows, S] int32, ends [rows, S] int32) numpy arrays; missing
    sub-slabs become all-blank dummies.  `icap` fixes the interval length
    S and `n_groups` the number of groups (pads with all-blank groups, or
    cuts), as `cbl_tpu`'s do, so that every rank stages equal shapes; an
    empty slice then yields dummies only."""
    slabs = list(front._fused_slabs(codes, offsets, slab=nk_sub,
                                    uniform=True))
    drop = nk_sub + 1
    total = n_groups if n_groups is not None else -(-len(slabs) // rows)
    sw = None
    for g0 in range(total):
        group = slabs[g0 * rows : (g0 + 1) * rows]
        cap = icap if icap is not None else max(
            (s[2].shape[0] for s in group), default=16)
        streams, starts, ends = [], [], []
        for _, stream, s_arr, e_arr, _ in group:
            if len(s_arr) > cap:
                raise ValueError(f"interval cap {cap} < {len(s_arr)} "
                                 "intervals; raise icap")
            s_pad = np.full(cap, drop, dtype=np.int32)
            s_pad[: len(s_arr)] = s_arr
            e_pad = np.full(cap, drop, dtype=np.int32)
            e_pad[: len(e_arr)] = e_arr
            streams.append(stream)
            starts.append(s_pad)
            ends.append(e_pad)
            sw = stream.shape[0]  # uniform slabs: one stream width
        while len(streams) < rows:  # an all-blank dummy sub-slab
            streams.append(np.zeros(
                sw if sw is not None else _stream_len(nk_sub, front.cfg.k)
                // 16, dtype=np.uint32))
            s_pad = np.full(cap, drop, dtype=np.int32)
            e_pad = np.full(cap, drop, dtype=np.int32)
            s_pad[0], e_pad[0] = 0, nk_sub
            starts.append(s_pad)
            ends.append(e_pad)
        yield nk_sub, np.stack(streams), np.stack(starts), np.stack(ends)


class ShardedStream:
    """A record stream staged for a ShardedCBL: its sub-slab groups, each
    a list of one tensor a shard on that shard's device, and a memo of a
    one-group stream's sorted words a shard, so that rounds that reuse a
    stream run its pipeline and sort once."""

    def __init__(self, key, groups: list, host0):
        self.key = key  # (cfg, canonical, mesh)
        self.groups = groups  # [(nk_sub, streams, starts, ends)]
        self._host0 = host0  # the first group's numpy arrays
        self._words: dict = {}


class ShardedCBL:
    """A k-mer set partitioned over a mesh of devices by word range.

    The union of the shards is the single index's set, and the shards in
    mesh order give its sorted word order.  `mesh` is a list of devices
    (`make_mesh`), `shard_capacity` a shard's first capacity in rows and
    `batch_per_device` the rows a shard takes a step in the word-level
    calls, as in `cbl_tpu.parallel.ShardedCBL`.  The word-level calls
    (`insert_words`, `remove_words`, `contains_words`, `count_hits`) take
    the port's int64 keys ([N], or [2, N] from K=29; a tensor or a numpy
    array); exports give `cbl_tpu`'s [n, L] uint32 limbs.  Under a process
    group of several ranks, `mesh` is this rank's part of the global mesh
    (see the module's notes) and every rank makes the same calls."""

    _SUB_SLAB_MAX = 1 << 24  # k-mers a shard a bulk step, at most

    def __init__(self, k: int = 25, prefix_bits: int = 24,
                 canonical: bool = False, mesh=None,
                 shard_capacity: int = MIN_CAP,
                 batch_per_device: int = 1 << 14):
        self.cfg = get_config(k=k, prefix_bits=prefix_bits)
        self.canonical = canonical
        self.mesh = make_mesh(mesh)
        self._rank, self._ranks = self.mesh.rank, self.mesh.ranks
        self.D = len(self.mesh) * self._ranks
        if self._ranks > 1:
            n = len(self.mesh)
            hi, neg_lo = _agree_max([n, -n], self.mesh[0], self._ranks)
            if hi != n or -neg_lo != n:
                raise ValueError(
                    f"the ranks' meshes hold {-neg_lo} to {hi} shards; "
                    "every rank must hold as many")
        self.C = shard_capacity
        self.B = batch_per_device
        self.L = self.cfg.word_limbs
        self._cols = key_cols(self.cfg)
        # the host side of the staging: `CBL._fused_slabs` on the CPU
        self._front = CBL(k=k, prefix_bits=prefix_bits, canonical=canonical,
                          device="cpu", pending_cap=1)
        self.data = [sentinel_rows(self.C, self._cols, d) for d in self.mesh]
        # per-shard distinct counts: on the devices (`_counts_dev`) or read
        # (`_counts_host`); `_count_upper` bounds a shard's USED rows (the
        # bulk insert keeps duplicates, `_dups`), so capacity checks never
        # wait for the device
        self._counts_dev = None
        self._counts_host: np.ndarray | None = np.zeros(self.D, dtype=np.int64)
        self._count_upper = 0
        self._dups = False
        # the range partition: uniform top-bit splits until the first
        # insert replaces them by data quantiles (necklace words crowd
        # near zero)
        shard_bits = max((self.D - 1).bit_length(), 0)
        self.boundaries = ints_to_keys(
            [j << (self.cfg.n_bits - shard_bits) for j in range(1, self.D)],
            self._cols)
        self._boundaries_from_data = False
        # a bucket overflow's count, summed on the device and read at the
        # next blocking call; once read non-zero the index stays corrupt
        self._dropped_dev = None
        self._corrupt = False
        # the sorted log of dynamic rounds, one log a shard: while active
        # it REPLACES `data` until `flush` (the single index's contract);
        # its live count is summed over the shards
        self.slog = SortedLog(self.cfg)

    # --- the process group ---------------------------------------------

    @property
    def _multiproc(self) -> bool:
        return self._ranks > 1

    def _local_shard_ids(self) -> list:
        """The global ids of this rank's shards, in mesh order."""
        n = len(self.mesh)
        return list(range(self._rank * n, (self._rank + 1) * n))

    def _single_process(self, what: str, instead: str) -> None:
        """Raise on a multi-process mesh: `what` reads every shard's rows
        or masks into one process (`cbl_tpu` raises there too), or stages
        every shard's rows in each process (`cbl_tpu`'s counts there are
        not the single index's)."""
        if self._multiproc:
            raise ValueError(
                f"{what} runs on a mesh of one process; on a multi-process "
                f"mesh use {instead}")

    # --- boundaries -----------------------------------------------------

    @property
    def boundaries(self) -> np.ndarray:
        """The D-1 boundaries as int64 keys, [D-1] or [2, D-1] (numpy)."""
        return self._bnd

    @boundaries.setter
    def boundaries(self, value) -> None:
        bnd = np.ascontiguousarray(value, dtype=np.int64)
        shape = (self.D - 1,) if self._cols == 1 else (2, self.D - 1)
        if bnd.shape != shape:
            raise ValueError(f"expected boundaries of shape {shape}, got "
                             f"{bnd.shape}")
        self._bnd = bnd
        self._bnd_dev: dict = {}

    def _bnd_on(self, device) -> torch.Tensor:
        t = self._bnd_dev.get(device)
        if t is None:
            t = self._bnd_dev[device] = torch.from_numpy(self._bnd).to(device)
        return t

    def boundary_limbs(self) -> np.ndarray:
        """The boundaries as `cbl_tpu`'s [D-1, L] uint32 limbs."""
        return to_limbs(self._bnd, self.L)

    def _partition_set(self) -> bool:
        """True once the boundaries stay as they are until a repartition:
        one shard, boundaries from data, or rows already placed (host
        state alone: nothing is copied or waited for)."""
        return (self.D == 1 or self._boundaries_from_data
                or self.slog.keys is not None or self._count_upper > 0)

    def _maybe_init_boundaries(self, words) -> None:
        """Quantile boundaries from the first word batch (`words`: keys),
        `cbl_tpu`'s sample: the valid rows in row order, 2^18 of them by
        `default_rng(0).choice` above that, sorted, row (j n) // D."""
        if self._partition_set():
            return
        keys = (words.cpu().numpy() if isinstance(words, torch.Tensor)
                else np.asarray(words))
        sample = keys[..., (keys if keys.ndim == 1 else keys[0]) != SENTINEL]
        n = sample.shape[-1]
        if n < 16 * self.D:
            return  # too small to estimate; keep the defaults
        if n > (1 << 18):
            pick = np.random.default_rng(0).choice(n, size=1 << 18,
                                                   replace=False)
            sample, n = sample[..., pick], 1 << 18
        order = (np.argsort(sample, kind="stable") if sample.ndim == 1
                 else np.lexsort(sample[::-1]))
        sample = sample[..., order]
        self.boundaries = sample[..., [(j * n) // self.D
                                       for j in range(1, self.D)]]
        self._boundaries_from_data = True

    def _maybe_init_boundaries_from_stream(self, nk_sub: int, stream, starts,
                                           ends) -> None:
        """Quantile boundaries from the first sub-slab's words (one more
        pass of the word pipeline, on the first shard's device)."""
        if self._partition_set():
            return
        dev = self.mesh[0]
        words, _ = _device_words(
            host_to_device(stream[0], dev, mask32=True),
            host_to_device(starts[0], dev), host_to_device(ends[0], dev),
            nk_sub, self.cfg, self.canonical)
        self._maybe_init_boundaries(words)

    # --- counts, capacity, dedup ----------------------------------------

    @property
    def shard_counts(self) -> np.ndarray:
        """Exact per-shard distinct counts (waits for the devices, and
        raises on a pending bucket overflow first).  A live round log is
        folded first: its rows are the set.  (`cbl_tpu` reads the counts
        of the rows before the rounds there, or fails where there were
        none.)"""
        self.flush()
        if self._counts_host is None:
            self._check_dropped()
        return self._counts_nocheck()

    @shard_counts.setter
    def shard_counts(self, value) -> None:
        self._counts_host = np.asarray(value).astype(np.int64)
        self._counts_dev = None
        if not self._dups:
            self._count_upper = int(self._counts_host.max())

    def _counts_nocheck(self) -> np.ndarray:
        """The counts without the overflow check, for callers that run
        while a drop count may legitimately be pending."""
        if self._counts_host is None:
            self._counts_host = _total_host(self._counts_dev, self.mesh[0],
                                            self._ranks)
            if not self._dups:
                self._count_upper = int(self._counts_host.max())
        return self._counts_host

    def _set_counts_dev(self, counts: list, upper: int) -> None:
        self._counts_dev = counts
        self._counts_host = None
        self._count_upper = min(upper, self.C)

    def _dedup_now(self) -> None:
        """Drop the duplicate rows of the keep-dups bulk insert (marks and
        one sort a shard) and tighten the used-rows bound."""
        out = [_dedup_sorted_kernel(d, self.C) for d in self.data]
        self.data = [o[0] for o in out]
        self._dups = False
        self._set_counts_dev([o[1] for o in out], self._count_upper)
        self._counts_nocheck()

    def _ensure_clean(self) -> None:
        self.flush()
        if self._dups:
            self._dedup_now()

    def _ensure_capacity(self, incoming_per_shard: int) -> None:
        need = self._count_upper + incoming_per_shard
        if need <= self.C:
            return
        if self._dups:
            self._dedup_now()
            need = self._count_upper + incoming_per_shard
            if need <= self.C:
                return
        # the bound assumes every routed word is new and lands on one
        # shard; read the real counts before paying for growth
        need = int(self._counts_nocheck().max()) + incoming_per_shard
        if need <= self.C:
            return
        new_c = max(self.C * 2, 1 << (need - 1).bit_length())
        self.data = [_fit(d, new_c) for d in self.data]
        self.C = new_c

    def _check_dropped(self) -> None:
        """Raise if a routed word overflowed its bucket since the last
        check; the first such read marks the index corrupt for good."""
        if self._corrupt:
            raise RuntimeError(
                "sharded index is corrupt: an earlier insert dropped words "
                "on bucket overflow; rebuild the index")
        if self._drops_pending() != 0:
            self._corrupt = True
            raise RuntimeError(
                "sharded insert bucket overflow: range partition too "
                "skewed; rebuild with boundaries from representative data")

    def _drops_pending(self) -> int:
        """Read and CONSUME the deferred overflow count (0 when none is
        pending), without marking the index corrupt."""
        if self._dropped_dev is None:
            return 0
        d, self._dropped_dev = self._dropped_dev, None
        return int(d)

    def _add_dropped(self, dropped) -> None:
        self._dropped_dev = (dropped if self._dropped_dev is None
                             else self._dropped_dev + dropped)

    # --- staging ----------------------------------------------------------

    @property
    def _stream_key(self):
        return (self.cfg, self.canonical, tuple(self.mesh), self._ranks)

    def _put_rows(self, rows: np.ndarray, mask32: bool = False) -> list:
        """[D_local, ...] numpy rows (this rank's shards: all D in one
        process) -> one int64 tensor a shard on its device."""
        if rows.shape[0] != len(self.mesh):
            raise ValueError(f"expected rows for {len(self.mesh)} local "
                             f"shards, got {rows.shape[0]}")
        return [host_to_device(rows[d], dev, mask32)
                for d, dev in enumerate(self.mesh)]

    def _nk_sub(self, nk: int) -> int:
        per_dev = (nk + self.D - 1) // self.D
        return min(max(_next_pow2(per_dev), 4096), self._SUB_SLAB_MAX)

    def _sub_slab_groups(self, codes: np.ndarray, offsets: np.ndarray):
        """Yield (nk_sub, stream, starts, ends) groups of D uniform
        sub-slabs (shard d of group g takes the k-mer starts from
        (g D + d) nk_sub), as numpy arrays."""
        nk = max(len(codes) - self.cfg.k + 1, 0)
        if nk == 0:
            return
        yield from build_slab_groups(self._front, codes, offsets,
                                     self._nk_sub(nk), self.D)

    def _n_groups(self, codes: np.ndarray) -> int:
        """How many groups `_sub_slab_groups` yields, without packing."""
        nk = max(len(codes) - self.cfg.k + 1, 0)
        if nk == 0:
            return 0
        n_slabs = -(-nk // self._nk_sub(nk))
        return -(-n_slabs // self.D)

    def pack_stream(self, codes: np.ndarray,
                    offsets: np.ndarray) -> ShardedStream:
        """Stage a record stream's sub-slab groups on the shards once;
        rounds then reuse them and the memo of their sorted words."""
        self._single_process("pack_stream",
                             "distributed.multihost_pack_stream")
        groups, host0 = [], None
        for nk_sub, stream, starts, ends in self._sub_slab_groups(codes,
                                                                  offsets):
            if host0 is None:
                host0 = (nk_sub, stream, starts, ends)
            groups.append((nk_sub, self._put_rows(stream, mask32=True),
                           self._put_rows(starts), self._put_rows(ends)))
        return ShardedStream(self._stream_key, groups, host0)

    def _resolve_sharded_stream(self, x) -> ShardedStream:
        if isinstance(x, ShardedStream):
            if x.key != self._stream_key:
                raise ValueError("ShardedStream built for a different "
                                 "config/mesh")
            return x
        return self.pack_stream(*x)

    def _stream_sorted_words(self, ss: ShardedStream):
        """(sorted words a shard, valid k-mers summed) of a one-group
        stream, through its memo."""
        cached = ss._words.get(0)
        if cached is None:
            nk_sub, streams, starts, ends = ss.groups[0]
            words, n_valid = [], []
            for st, s0, e0 in zip(streams, starts, ends):
                w, nv = _device_words(st, s0, e0, nk_sub, self.cfg,
                                      self.canonical)
                words.append(sort_rows(w))
                n_valid.append(nv)
            cached = ss._words[0] = (words, _total(n_valid, self.mesh[0],
                                                   self._ranks))
        return cached

    # --- the sharded sorted log (interleaved dynamic rounds) --------------

    def flush(self) -> None:
        """Fold an active sorted log back into clean shards (a scatter-max
        and a compaction sort a shard), to `cbl_tpu`'s capacity: the
        log's real-row bound, to the next power of two."""
        if self.slog.keys is None:
            return
        c_out = _out_cap(self.slog.real)
        out = self.slog.fold(c_out)
        self.data = [o[0] for o in out]
        self.C = c_out
        self._dups = False
        self._set_counts_dev([o[1] for o in out], c_out)

    def dynamic_round(self, ins, qry, rm, lazy: bool = False):
        """One interleaved round over the mesh: insert every k-mer of
        `ins`, count-query `qry` (it sees the inserts, not the removes),
        remove every k-mer of `rm`.  Args are ShardedStreams (`pack_stream`)
        or (codes, offsets) tuples; -> (total, positive), unsynced 0-d
        tensors with lazy=True.

        When each stream is one sub-slab group, each shard tags and
        combines its slices of the three PRE-SORTED streams (two merges),
        routes the batch by word (one exchange), sorts what it receives,
        merges it into its log (B3) and scans once (B4); the hits and live
        counts are summed.  Else the separate bulk calls run.  A bucket
        overflow is only summed here and raised by the next blocking call
        (`cbl_tpu`'s deferred check); only the sticky flag is read now."""
        if self._corrupt:
            self._check_dropped()
        if self._multiproc and not self._partition_set():
            raise ValueError("the ranks have not agreed on boundaries: on a "
                             "multi-process mesh use "
                             "distributed.multihost_dynamic_round")
        fallback = (not isinstance(ins, ShardedStream)
                    and self._n_groups(ins[0]) != 1)
        ps = [self._resolve_sharded_stream(x) for x in (ins, qry, rm)]
        if fallback or any(len(p.groups) != 1 for p in ps):
            if not all(isinstance(x, tuple) for x in (ins, qry, rm)):
                raise ValueError("multi-group dynamic_round needs (codes, "
                                 "offsets) tuples (bulk fallback)")
            self.insert_codes_stream(*ins)
            t, p = self.query_codes_stream(*qry)
            self.remove_codes_stream(*rm)
            return t, p
        self._maybe_init_boundaries_from_stream(*ps[0]._host0)
        (w_i, _), (w_q, nv_q), (w_r, _) = (self._stream_sorted_words(p)
                                           for p in ps)
        n_round = sum(w[0].shape[-1] for w in (w_i, w_q, w_r))
        slog = self.slog
        if slog.at_seq_cap():
            self.flush()
        # no autofold (`cbl_tpu`'s sharded log has none); the shards' rows
        # enter as seq-0 inserts, the whole capacity
        entry = None if slog.keys is not None else (
            self.data, min(self._count_upper if not self._dups else self.C,
                           self.C))
        cap_b = max(4096, _next_pow2(max(1, 2 * n_round // self.D)))
        # a shard receives at most D cap_b padded rows, but the round has
        # only n_round real ones
        logs, real, S_out = slog.begin(min(n_round, self.D * cap_b), entry)
        batches = slog.tag(w_i, w_q, w_r)
        if self.D > 1:
            routed = [
                _route_sorted(b, _slog_bounds(self._bnd_on(dev),
                                              slog.packed), cap_b)
                for b, dev in zip(batches, self.mesh)
            ]
            del batches
            recv = _all_to_all([r[0] for r in routed], self.mesh)
            dropped = [r[2] for r in routed]
            del routed
            batches = [sort_rows(r) for r in recv]
            del recv
        out = slog.merge(logs, batches, real, S_out)
        del logs  # the old log goes with the commit
        # the live count, the hits and the drops: one sum (one all_reduce)
        i64 = torch.int64
        live, hits, drops = _total(
            [torch.stack([o[1].to(i64), o[0].to(i64),
                          dropped[i] if self.D > 1
                          else torch.zeros((), dtype=i64, device=o[0].device)])
             for i, o in enumerate(out)], self.mesh[0], self._ranks)
        slog.live = live
        self._counts_host = None
        if self.D > 1:
            self._add_dropped(drops)
        if lazy:
            return nv_q, hits
        t, p = torch.stack([nv_q.to(torch.int64), hits]).tolist()
        return t, p

    # --- word-level operations --------------------------------------------

    def _as_keys(self, words) -> torch.Tensor:
        """int64 keys of the port's layout: [N] or [2, N]."""
        t = (words if isinstance(words, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(words, np.int64)))
        if t.dtype != torch.int64 or t.dim() != (1 if self._cols == 1 else 2):
            raise ValueError(
                f"expected int64 keys of {self._cols} column(s) for "
                f"K={self.cfg.k}, got {t.dtype} {tuple(t.shape)}")
        return t

    def _word_batches(self, words: torch.Tensor):
        """Yield (rows in the batch, one [B] or [2, B] slice a local shard
        on its device): the words in steps of D B rows, SENTINEL padded,
        shard g taking rows g B to (g + 1) B - 1 of a step."""
        step = self.D * self.B
        for start in range(0, words.shape[-1], step):
            batch = words[..., start : start + step]
            buf = sentinel_rows(step, self._cols, batch.device)
            buf[..., : batch.shape[-1]] = batch
            yield batch.shape[-1], [
                buf[..., g * self.B : (g + 1) * self.B].contiguous().to(dev)
                for g, dev in zip(self._local_shard_ids(), self.mesh)
            ]

    def _route_exchange(self, srcs: list, cap: int) -> list:
        """Sort each shard's rows, route them with buckets of `cap` rows
        and exchange: the rows each shard owns, per-source sorted runs."""
        routed = [_route_sorted(sort_rows(w), self._bnd_on(dev), cap)
                  for w, dev in zip(srcs, self.mesh)]
        return _all_to_all([r[0] for r in routed], self.mesh)

    def insert_words(self, words) -> None:
        """Insert keys ([N] or [2, N]; SENTINEL rows ignored): D B rows a
        step, split evenly over the shards, routed to their owners and
        folded with duplicates dropped.  On a multi-process mesh every
        rank passes the same words and stages its own shards' part."""
        self.flush()
        words = self._as_keys(words)
        self._maybe_init_boundaries(words)
        for _, srcs in self._word_batches(words):
            # the worst case: every word of the step lands on one shard
            self._ensure_capacity(self.D * self.B)
            recv = self._route_exchange(srcs, self.B)
            out = [_merge_sortcompact_kernel(d, r, self.C)
                   for d, r in zip(self.data, recv)]
            self.data = [o[0] for o in out]
            self._dups = False  # the fold drops duplicates
            self._set_counts_dev([o[1] for o in out],
                                 self._count_upper + self.D * self.B)

    def remove_words(self, words) -> None:
        """Remove keys (SENTINEL rows and absent words are no-ops), routed
        as `insert_words` routes them (the same words on every rank)."""
        self.flush()
        words = self._as_keys(words)
        for _, srcs in self._word_batches(words):
            recv = self._route_exchange(srcs, self.B)
            out = [_setop_sort_kernel_packed(d, r, "remove", self.C)
                   for d, r in zip(self.data, recv)]
            self.data = [o[0] for o in out]
            self._dups = False  # the marks keep one row a word
            self._set_counts_dev([o[1] for o in out], self._count_upper)

    def _routed_membership(self, srcs: list, n: int, join) -> list:
        """[n] bool a shard in its own row order: each shard sorts its rows
        with their position as a payload, routes them to their owners
        (SENTINEL rows to the last shard, buckets of n rows: nothing
        drops), `join(data, rows)` answers them there, and the answers
        route back and scatter to their positions."""
        sent = []
        for w, dev in zip(srcs, self.mesh):
            pos = torch.arange(n, dtype=torch.int64, device=dev)
            sc = sort_keys((*cols(w), pos))
            send, (ppos,), _ = _route_sorted(
                stack(sc[:-1]), self._bnd_on(dev), n, payload=(sc[-1],),
                include_sentinels=True)
            sent.append((send, ppos.reshape(-1)))
        recv = _all_to_all([s for s, _ in sent], self.mesh)
        hits = [join(d, r).reshape(self.D, n)
                for d, r in zip(self.data, recv)]
        del recv
        back = _all_to_all(hits, self.mesh)
        out = []
        for (_, ppos), b in zip(sent, back):
            real = ppos != SENTINEL
            dest = torch.where(real, ppos, n)
            mask = torch.zeros(n + 1, dtype=torch.bool, device=b.device)
            out.append(mask.scatter_(0, dest, b & real)[:n])
        return out

    def contains_words(self, words) -> np.ndarray:
        """[N] bool numpy: which keys are in the set (SENTINEL rows
        False), in the order given."""
        self._single_process("contains_words",
                             "the counting query multihost_query_stream")
        self._check_dropped()
        self.flush()
        words = self._as_keys(words)
        out = []
        for n, srcs in self._word_batches(words):
            if self.D == 1:
                masks = [_contains_kernel(self.data[0], srcs[0])]
            else:
                masks = self._routed_membership(srcs, self.B,
                                                _contains_kernel)
            out.append(torch.cat([m.to(self.mesh[0]) for m in masks])[:n])
        if not out:
            return np.zeros(0, dtype=bool)
        return torch.cat(out).cpu().numpy()

    def count(self) -> int:
        if self.slog.keys is not None and self.slog.live is not None:
            self._check_dropped()
            return int(self.slog.live)
        return int(self.shard_counts.sum())

    def count_hits(self, words) -> int:
        """Keys of `words` in the set (SENTINEL rows ignored): routed to
        their owners and joined there."""
        self._single_process("count_hits",
                             "the counting query multihost_query_stream")
        self._check_dropped()
        self.flush()
        words = self._as_keys(words)
        total = None
        for _, srcs in self._word_batches(words):
            recv = self._route_exchange(srcs, self.B)
            t = _total([_count_hits_merge_kernel(d, r)
                        for d, r in zip(self.data, recv)], self.mesh[0])
            total = t if total is None else total + t
        return 0 if total is None else int(total)

    # --- set algebra ----------------------------------------------------

    def _like(self, shard_capacity: int = MIN_CAP) -> "ShardedCBL":
        return ShardedCBL(k=self.cfg.k, prefix_bits=self.cfg.prefix_bits,
                          canonical=self.canonical, mesh=self.mesh,
                          shard_capacity=shard_capacity,
                          batch_per_device=self.B)

    def _check_operand(self, other: "ShardedCBL") -> None:
        if self.canonical != other.canonical:
            raise ValueError(
                "One of the index is canonical while the other isn't")
        if self.cfg != other.cfg:
            raise ValueError("Mismatched CBL configurations")
        if self.mesh != other.mesh or self._ranks != other._ranks:
            raise ValueError("sharded indexes on two meshes")

    def _shard_keys(self) -> list:
        """Each shard's valid keys (clean shards), on its device."""
        counts = self.shard_counts
        return [d[..., : int(counts[g])]
                for d, g in zip(self.data, self._local_shard_ids())]

    def _resharded_copy(self, other: "ShardedCBL") -> "ShardedCBL":
        """`other`'s words in a copy on this index's partition (set
        operations need equal boundaries on both sides): each of `other`'s
        clean shards routes its rows by this index's boundaries in ONE
        exchange, with buckets of its whole count (nothing can drop), and
        each destination sorts what it receives.  (`cbl_tpu` inserts the
        words through `insert_words`, D B rows a step, each step a sort of
        a whole shard; the copy holds the same words either way, and a set
        operation reads only those.)"""
        fresh = ShardedCBL(k=self.cfg.k, prefix_bits=self.cfg.prefix_bits,
                           canonical=other.canonical, mesh=self.mesh,
                           batch_per_device=self.B)
        fresh.boundaries = self.boundaries.copy()
        fresh._boundaries_from_data = True
        other._ensure_clean()
        keys = other._shard_keys()
        cap = max(1, int(other.shard_counts.max()))  # global: equal buckets
        routed = [_route_sorted(k, fresh._bnd_on(dev), cap)
                  for k, dev in zip(keys, self.mesh)]
        recv = _all_to_all([r[0] for r in routed], self.mesh)
        del routed
        rows = [sort_rows(r) for r in recv]
        del recv
        counts = _total_host([is_valid(r).sum() for r in rows], self.mesh[0],
                             self._ranks)
        fresh.C = max(MIN_CAP, _next_pow2(int(counts.max())))
        fresh.data = [_fit(r, fresh.C) for r in rows]
        fresh.shard_counts = counts
        return fresh

    def _binary_op(self, other: "ShardedCBL", op: str) -> "ShardedCBL":
        """A set operation shard by shard (equal partitions make every one
        local): one tagged sort, the marks of `wordset._setop_keep` and a
        compaction sort (`_setop_sort_kernel_packed`)."""
        self._check_operand(other)
        self._ensure_clean()
        other._ensure_clean()
        if not np.array_equal(self.boundaries, other.boundaries):
            other = self._resharded_copy(other)
        if op in ("union", "symmetric_difference"):
            need = int((self.shard_counts + other.shard_counts).max())
        else:
            need = int(self.shard_counts.max())
        cout = max(MIN_CAP, 1 << max(need - 1, 1).bit_length())
        out = self._like(cout)
        out.boundaries = self.boundaries.copy()
        out._boundaries_from_data = self._boundaries_from_data
        res = [_setop_sort_kernel_packed(a, b, _SETOPS[op], cout)
               for a, b in zip(self.data, other.data)]
        out.data = [r[0] for r in res]
        out.shard_counts = _total_host([r[1] for r in res], self.mesh[0],
                                       self._ranks)
        return out

    def union(self, other: "ShardedCBL") -> "ShardedCBL":
        return self._binary_op(other, "union")

    def intersection(self, other: "ShardedCBL") -> "ShardedCBL":
        return self._binary_op(other, "intersection")

    def difference(self, other: "ShardedCBL") -> "ShardedCBL":
        return self._binary_op(other, "difference")

    def symmetric_difference(self, other: "ShardedCBL") -> "ShardedCBL":
        return self._binary_op(other, "symmetric_difference")

    __or__ = union
    __and__ = intersection
    __sub__ = difference
    __xor__ = symmetric_difference

    @staticmethod
    def merge_many(sets: list) -> "ShardedCBL":
        """The union of every index of the list: ONE sort of all their
        rows a shard, duplicates marked, and a compaction sort."""
        if not sets:
            raise ValueError("expected at least one index")
        first = sets[0]
        if len(sets) == 1:
            return first.union(first)  # a copy
        aligned = []
        for s in sets:
            first._check_operand(s)
            s._ensure_clean()
            if not np.array_equal(first.boundaries, s.boundaries):
                s = first._resharded_copy(s)
            aligned.append(s)
        need = int(sum(s.shard_counts for s in aligned).max())
        cout = max(MIN_CAP, 1 << max(need - 1, 1).bit_length())
        out = first._like(cout)
        out.boundaries = first.boundaries.copy()
        out._boundaries_from_data = first._boundaries_from_data
        res = []
        for d in range(len(first.mesh)):
            cat = torch.cat([s.data[d] for s in aligned], dim=-1)
            res.append(_merge_sortcompact_kernel(cat, cat[..., :0], cout))
        out.data = [r[0] for r in res]
        out.shard_counts = _total_host([r[1] for r in res], first.mesh[0],
                                       first._ranks)
        return out

    @staticmethod
    def intersect_many(sets: list) -> "ShardedCBL":
        """The intersection of every index, pair by pair from the left."""
        if not sets:
            raise ValueError("expected at least one index")
        out = sets[0]
        for s in sets[1:]:
            out = out.intersection(s)
        return out

    # --- record streams (the bulk path) ----------------------------------

    def _pipeline(self, nk_sub: int, streams, starts, ends) -> list:
        """(words, n_valid) a shard: the word pipeline on its sub-slab."""
        return [_device_words(st, s0, e0, nk_sub, self.cfg, self.canonical)
                for st, s0, e0 in zip(streams, starts, ends)]

    def _bucket_cap(self, nk_sub: int, scale: int) -> int:
        """Rows a source sends a destination in a bulk step: `cbl_tpu`'s
        max(4096, next_pow2(2 nk_sub / D)), times `scale` on a recovery,
        never more than a whole sub-slab."""
        return min(_next_pow2(nk_sub),
                   scale * max(4096, _next_pow2((2 * nk_sub) // self.D)))

    def _routed_batches(self, words: list, cap: int):
        """(the rows each shard owns, dropped) of the shards' words; D = 1
        keeps its words as they are."""
        if self.D == 1:
            return words, None
        routed = [_route_sorted(sort_rows(w), self._bnd_on(dev), cap)
                  for w, dev in zip(words, self.mesh)]
        recv = _all_to_all([r[0] for r in routed], self.mesh)
        return recv, _total([r[2] for r in routed], self.mesh[0],
                            self._ranks)

    def _insert_group(self, nk_sub: int, streams, starts, ends,
                      bucket_scale: int = 1) -> None:
        """One bulk insert step: the word pipeline a shard, a sort, the
        route and the exchange, then a keep-dups fold a shard (a sort that
        adopts the rows for an empty index, else a merge, B3) and its
        adjacency count.  Stays asynchronous: the overflow count adds up
        on the device."""
        bucket_cap = self._bucket_cap(nk_sub, bucket_scale)
        incoming = min(self.D * nk_sub, self.D * bucket_cap)
        if self._count_upper + incoming > self.C:
            self._ensure_capacity(incoming)
        empty = self._count_upper == 0
        words = [w for w, _ in self._pipeline(nk_sub, streams, starts, ends)]
        batches, dropped = self._routed_batches(words, bucket_cap)
        del words
        if empty:
            out = [_fit(sort_rows(b), self.C) for b in batches]
        else:
            out = [_fit(_merge_rows(d, b, keys_sorted=False), self.C)
                   for d, b in zip(self.data, batches)]
        del batches
        self.data = out
        self._dups = True  # keep-dups fold; compacts lazily
        self._set_counts_dev([_distinct_count(s) for s in out],
                             self._count_upper + incoming)
        if dropped is not None:
            self._add_dropped(dropped)

    def insert_codes_stream(self, codes: np.ndarray,
                            offsets: np.ndarray) -> None:
        """Insert every k-mer of a record stream: one bulk step a group of
        D sub-slabs.  A stream whose routing overflowed a bucket is
        recovered without loss: inserting twice is a no-op, so the index
        is repartitioned and the stream re-run with buckets twice as
        large, up to a bucket of a whole sub-slab, which cannot drop; a
        recovered stream ends with a repartition on the full contents."""
        self._single_process("insert_codes_stream",
                             "distributed.multihost_insert_stream")
        self.flush()
        for attempt in range(max(self.D.bit_length(), 1) + 1):
            for nk_sub, stream, starts, ends in self._sub_slab_groups(
                    codes, offsets):
                self._maybe_init_boundaries_from_stream(nk_sub, stream,
                                                        starts, ends)
                self._insert_group(nk_sub, self._put_rows(stream, True),
                                   self._put_rows(starts),
                                   self._put_rows(ends),
                                   bucket_scale=1 << attempt)
            if self.D == 1 or self._drops_pending() == 0:
                if attempt > 0:
                    self.repartition()
                return
            self.repartition()
        self._corrupt = True  # unreachable: the last attempt cannot drop
        raise RuntimeError("sharded insert dropped words after recovery")

    def _remove_group(self, nk_sub: int, streams, starts, ends,
                      bucket_scale: int = 1):
        """One bulk remove step: the pipeline, the route and exchange,
        then a tagged sort, marks and a compaction sort a shard
        (`_setop_sort_kernel_packed` "remove").  -> the step's overflow
        count (None at D = 1)."""
        words = [w for w, _ in self._pipeline(nk_sub, streams, starts, ends)]
        batches, dropped = self._routed_batches(
            words, self._bucket_cap(nk_sub, bucket_scale))
        del words
        out = [_setop_sort_kernel_packed(d, b, "remove", self.C)
               for d, b in zip(self.data, batches)]
        self.data = [o[0] for o in out]
        self._dups = False  # the marks keep one row a word
        self._set_counts_dev([o[1] for o in out], self._count_upper)
        return dropped

    def remove_codes_stream(self, codes: np.ndarray,
                            offsets: np.ndarray) -> None:
        """Remove every k-mer of a record stream: one bulk step a group.
        Exact under any partition: removing twice is a no-op, so a stream
        whose routing overflowed a bucket is re-run with buckets twice as
        large, up to a whole sub-slab (one read of the overflow count a
        stream at D > 1).  `cbl_tpu` drops such words silently."""
        self._single_process("remove_codes_stream",
                             "distributed.multihost_remove_stream")
        self.flush()
        self._remove_rerun(lambda: self._sub_slab_groups(codes, offsets))

    def _remove_rerun(self, groups) -> None:
        """The remove steps of the numpy groups that `groups()` yields
        (this rank's rows), all run again with buckets twice as large
        while one dropped words; the drop count is summed over the ranks,
        so every rank re-runs together."""
        for attempt in range(max(self.D.bit_length(), 1) + 1):
            dropped = None
            for nk_sub, stream, starts, ends in groups():
                d = self._remove_group(nk_sub, self._put_rows(stream, True),
                                       self._put_rows(starts),
                                       self._put_rows(ends),
                                       bucket_scale=1 << attempt)
                if d is not None:
                    dropped = d if dropped is None else dropped + d
            if dropped is None or int(dropped) == 0:
                return
        self._corrupt = True  # unreachable: the last attempt cannot drop
        raise RuntimeError("sharded remove dropped words after recovery")

    def _query_group(self, nk_sub: int, streams, starts, ends):
        """(valid k-mers, hits) of one group, summed, unsynced: the
        pipeline, the route with buckets of a whole sub-slab, a merge join
        a shard (B3)."""
        piped = self._pipeline(nk_sub, streams, starts, ends)
        batches, _ = self._routed_batches([w for w, _ in piped], nk_sub)
        sums = _total([torch.stack([nv.to(torch.int64),
                                    _count_hits_merge_kernel(d, b).to(
                                        torch.int64)])
                       for (_, nv), d, b in zip(piped, self.data, batches)],
                      self.mesh[0], self._ranks)
        return sums[0], sums[1]

    def query_codes_stream(self, codes: np.ndarray, offsets: np.ndarray):
        """(total k-mers, positive k-mers) over a record stream; the
        counters add up on the device and are read once."""
        self._single_process("query_codes_stream",
                             "distributed.multihost_query_stream")
        self._check_dropped()
        self.flush()
        total = positive = None
        for nk_sub, stream, starts, ends in self._sub_slab_groups(codes,
                                                                  offsets):
            t, p = self._query_group(nk_sub, self._put_rows(stream, True),
                                     self._put_rows(starts),
                                     self._put_rows(ends))
            total = t if total is None else total + t
            positive = p if positive is None else positive + p
        if total is None:
            return 0, 0
        return self._reduce_query(total, positive)

    def _reduce_query(self, total, positive) -> tuple:
        """(total, positive) as ints: one read of the two summed 0-d
        tensors (every rank holds the sums)."""
        t, p = torch.stack([total.to(torch.int64),
                            positive.to(torch.int64)]).tolist()
        return t, p

    def contains_codes_stream(self, codes: np.ndarray,
                              offsets: np.ndarray) -> list:
        """A membership mask a record, in sequence order: each shard runs
        the pipeline on its sub-slab and sort-joins there at D = 1; else
        its words route to their owners with their positions, are joined
        there (`_contains_sortjoin_kernel`) and their answers route back.
        The masks cross to the host once."""
        self._single_process("contains_codes_stream",
                             "the counting query multihost_query_stream")
        self._check_dropped()
        self.flush()
        k = self.cfg.k
        nk = max(len(codes) - k + 1, 0)
        parts = []
        for nk_sub, stream, starts, ends in self._sub_slab_groups(codes,
                                                                  offsets):
            words = [w for w, _ in self._pipeline(
                nk_sub, self._put_rows(stream, True), self._put_rows(starts),
                self._put_rows(ends))]
            if self.D == 1:
                masks = [_contains_sortjoin_kernel(self.data[0], words[0],
                                                   False)]
            else:
                masks = self._routed_membership(
                    words, nk_sub,
                    lambda d, q: _contains_sortjoin_kernel(d, q, False))
            parts.extend(m.to(self.mesh[0]) for m in masks)
        flat = (torch.cat(parts).cpu().numpy()[:nk] if parts
                else np.zeros(0, dtype=bool))
        out = []
        for r in range(len(offsets) - 1):
            lo = int(offsets[r])
            hi = max(int(offsets[r + 1]) - k + 1, lo)
            out.append(flat[lo:hi])
        return out

    def contains_seqs(self, seqs) -> list:
        """A membership mask for each sequence (`contains_codes_stream`)."""
        codes_list = [s if isinstance(s, np.ndarray) and s.dtype == np.uint8
                      else encode_seq(s) for s in seqs]
        offsets = np.cumsum([0] + [len(c) for c in codes_list],
                            dtype=np.int64)
        codes = (np.concatenate(codes_list) if codes_list
                 else np.zeros(0, dtype=np.uint8))
        return self.contains_codes_stream(codes, offsets)

    def contains_seq(self, seq) -> np.ndarray:
        return self.contains_seqs([seq])[0]

    # --- conversion, export and checkpoints ------------------------------

    @classmethod
    def from_cbl(cls, cbl: CBL, mesh=None, **kw) -> "ShardedCBL":
        """Distribute a port `CBL`'s words over the mesh (on a multi-process
        mesh every rank passes the same words, as to `insert_words`)."""
        out = cls(k=cbl.cfg.k, prefix_bits=cbl.cfg.prefix_bits,
                  canonical=cbl.canonical, mesh=mesh, **kw)
        keys = cbl.wordset.export_keys()
        if keys.shape[-1]:
            out.insert_words(keys)
        return out

    def to_cbl(self) -> CBL:
        """The words gathered into a port `CBL` on the first shard's
        device."""
        self._single_process("to_cbl", "local_shard_rows or save_to_file")
        self._ensure_clean()
        out = CBL(k=self.cfg.k, prefix_bits=self.cfg.prefix_bits,
                  canonical=self.canonical, device=self.mesh[0])
        keys = torch.cat([k.to(self.mesh[0]) for k in self._shard_keys()],
                         dim=-1)
        if keys.shape[-1]:
            out.wordset.insert_words(keys)
            out.wordset.flush()
        return out

    def local_shard_rows(self) -> dict:
        """{global shard id: its [count, L] uint32 limb rows} of this
        rank's shards (every shard in one process); shard-major
        concatenation over the ranks is the global sorted order."""
        self._ensure_clean()
        return {g: host_limbs(k, self.L)
                for g, k in zip(self._local_shard_ids(), self._shard_keys())}

    def words_array(self) -> np.ndarray:
        """[n, L] uint32 rows in global sorted order."""
        self._single_process("words_array",
                             "iter_words_chunks or local_shard_rows")
        rows = list(self.local_shard_rows().values())
        return np.concatenate(rows) if rows else np.zeros((0, self.L),
                                                          np.uint32)

    def iter_words_chunks(self, chunk_rows: int = 1 << 22):
        """Yield [<= chunk_rows, L] uint32 arrays in global sorted order,
        shard by shard, one chunk's copy at a time.  On a multi-process
        mesh every rank gets every chunk, each a `broadcast` from the rank
        that owns its shard, so every rank must take the whole sequence."""
        self._ensure_clean()
        keys = self._shard_keys()
        if not self._multiproc:
            for k in keys:
                for lo in range(0, k.shape[-1], chunk_rows):
                    yield host_limbs(k[..., lo : lo + chunk_rows], self.L)
            return
        import torch.distributed as dist

        counts, n = self.shard_counts, len(self.mesh)
        for g in range(self.D):
            owner, j = divmod(g, n)
            for lo in range(0, int(counts[g]), chunk_rows):
                m = min(chunk_rows, int(counts[g]) - lo)
                buf = (keys[j][..., lo : lo + m].to(self.mesh[0]).contiguous()
                       if owner == self._rank
                       else sentinel_rows(m, self._cols, self.mesh[0]))
                dist.broadcast(buf, owner)
                yield host_limbs(buf, self.L)

    def shard_balance(self) -> np.ndarray:
        """Words per shard."""
        return self.shard_counts.copy()

    @staticmethod
    def _shard_file(path, process_index: int, process_count: int) -> str:
        """The checkpoint file of one rank: `path` itself in one process,
        else `path.procNNNNN-of-MMMMM.npz`."""
        if process_count == 1:
            return str(path)
        return f"{path}.proc{process_index:05d}-of-{process_count:05d}.npz"

    def save_to_file(self, path) -> None:
        """`cbl_tpu`'s CBLXSHRD checkpoint: each rank writes one file
        (`_shard_file`) with the header, the boundaries as [D-1, L] uint32
        limbs, the global counts and its own shards' live rows
        (`rows_<i>` for the i-th id of `shard_ids`); one process writes
        exactly `path`."""
        local = self.local_shard_rows()  # cleans and reads the counts
        ids = self._local_shard_ids()
        arrs = {
            "magic": np.frombuffer(_MAGIC, dtype=np.uint8),
            "k": np.int64(self.cfg.k),
            "prefix_bits": np.int64(self.cfg.prefix_bits),
            "canonical": np.bool_(self.canonical),
            "n_shards": np.int64(self.D),
            "process_count": np.int64(self._ranks),
            "boundaries": self.boundary_limbs(),
            "shard_ids": np.asarray(ids, dtype=np.int64),
            "counts": self.shard_counts.astype(np.int64),
        }
        for i, g in enumerate(ids):
            arrs[f"rows_{i}"] = local[g]
        fname = self._shard_file(path, self._rank, self._ranks)
        with open(fname, "wb") as f:  # np.savez must not append ".npz"
            np.savez(f, **arrs)

    @classmethod
    def load_from_file(cls, path, mesh=None, **kw) -> "ShardedCBL":
        """A CBLXSHRD checkpoint on a mesh of as many shards and ranks as
        wrote it: each rank reads its own file (`_shard_file`), else
        `path` itself (a checkpoint of one file); a single-index CBLX file
        is distributed by `from_cbl`."""
        mesh = make_mesh(mesh)
        fname = (_npz_path(path) if mesh.ranks == 1
                 else cls._shard_file(path, mesh.rank, mesh.ranks))
        if not os.path.exists(fname):
            fname = _npz_path(path)
        with np.load(fname) as z:
            if "magic" not in z or bytes(z["magic"]) != _MAGIC:
                sharded = None
            else:
                sharded = {name: z[name] for name in z.files}
        if sharded is None:
            return cls.from_cbl(CBL.load_from_file(path, device=mesh[0]),
                                mesh=mesh, **kw)
        z = sharded
        counts = z["counts"].astype(np.int64)
        cap = max(MIN_CAP, 1 << max(int(counts.max()) - 1, 1).bit_length())
        out = cls(k=int(z["k"]), prefix_bits=int(z["prefix_bits"]),
                  canonical=bool(z["canonical"]), mesh=mesh,
                  shard_capacity=cap, **kw)
        if out.D != int(z["n_shards"]):
            raise ValueError(f"checkpoint has {int(z['n_shards'])} shards; "
                             f"mesh has {out.D}")
        if int(z["process_count"]) != out._ranks:
            raise ValueError(
                f"checkpoint written by {int(z['process_count'])} processes; "
                f"running with {out._ranks}")
        ids = out._local_shard_ids()
        if list(z["shard_ids"]) != ids:
            raise ValueError(f"process owns shards {ids} but checkpoint "
                             f"holds {list(z['shard_ids'])}")
        data = []
        for i, dev in enumerate(out.mesh):
            keys = sentinel_rows(cap, out._cols, "cpu")
            rows = z[f"rows_{i}"]
            keys[..., : rows.shape[0]] = torch.from_numpy(
                from_limbs(rows, out._cols))
            data.append(keys.to(dev))
        out.data = data
        out.boundaries = from_limbs(z["boundaries"], out._cols)
        out._boundaries_from_data = True
        out.shard_counts = counts
        return out

    def repartition(self) -> None:
        """Re-balance the range partition to the current contents: the
        D-1 exact global quantiles from the counts' prefix sums (the
        shards in order are the sorted words), then every row moves once
        to its new owner with buckets of total / D + 2 rows, which no
        destination can exceed; a drop raises.  Under ranks each quantile
        row is read by the rank that owns its shard and one `all_gather`
        hands every rank all of them."""
        self.flush()
        if self.D == 1:
            return
        if self._dups:
            self._dedup_now()
        counts = self._counts_nocheck()
        total = int(counts.sum())
        if total >= self.D:
            cum = np.concatenate([[0], np.cumsum(counts)])
            ranks = np.array([(j * total) // self.D
                              for j in range(1, self.D)])
            si = np.searchsorted(cum, ranks, side="right") - 1
            li = ranks - cum[si]
            n = len(self.mesh)
            first = self._rank * n
            mine = [(j, self.data[s - first][..., int(r)])
                    for j, (s, r) in enumerate(zip(si, li))
                    if first <= s < first + n]
            rows = torch.zeros((self._cols, self.D - 1), dtype=torch.int64,
                               device=self.mesh[0])
            for j, row in mine:
                rows[:, j] = row.reshape(-1).to(self.mesh[0])
            if self._multiproc:  # each row from the rank that owns it
                import torch.distributed as dist

                parts = [torch.empty_like(rows) for _ in range(self._ranks)]
                dist.all_gather(parts, rows)
                owner = torch.as_tensor(si // n, device=self.mesh[0])
                rows = torch.stack(parts)[owner, :, torch.arange(
                    self.D - 1, device=self.mesh[0])].T
            bnd = rows.cpu().numpy()
            self.boundaries = bnd[0] if self._cols == 1 else bnd
            self._boundaries_from_data = True
        bucket_cap = max(4096, _next_pow2(total // self.D + 2))
        routed = [_route_sorted(d, self._bnd_on(dev), bucket_cap)
                  for d, dev in zip(self.data, self.mesh)]
        recv = _all_to_all([r[0] for r in routed], self.mesh)
        dropped = _total([r[2] for r in routed], self.mesh[0], self._ranks)
        del routed
        out = [_fit(sort_rows(r), self.C) for r in recv]
        del recv
        self.data = out
        self._dups = False
        n = int(dropped)
        if n != 0:  # unreachable by the rank-range bound; fail loud
            self._corrupt = True
            raise RuntimeError(f"repartition dropped {n} words (bug)")
        self._set_counts_dev([is_valid(o).sum() for o in out],
                             self._count_upper)
