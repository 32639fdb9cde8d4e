"""CBL: the k-mer set facade for the stream, sequence and point operations.

Counterpart of `cbl_tpu/cbl.py`.  A record stream is packed on the host
(16 bases per uint32) and staged on the device once (`pack_stream`).  On
the device each slab of up to 2^25 k-mers runs the record-boundary
blanking (kernel B2), then extract -> (canonicalize) -> necklace -> pack
-> blank in one kernel (B1 from the stream; plain steps on the CPU),
then:
- static: a sort builds an empty index (`insert_codes_stream`; each
  further slab of a long stream merges in, B3) and joins answer
  `query_codes_stream`: merge joins (B3), or probe joins (B8) where the
  index is much larger than the batch (`DeviceWordSet.count_hits_device`);
- separate calls: `insert_codes_stream` into a non-empty index and
  `remove_codes_stream` append to the word set's pending log when the
  batch fits it (else they merge or remove at once), and
  `query_codes_stream` joins index and log without folding;
- dynamic: `dynamic_round(ins, qry, rm)` hands the streams' sorted words
  to the word set (`DeviceWordSet.round_words`), which merges them,
  tagged, into the sorted log (B3) and scans it once (kernel B4) for the
  round's query hits and the distinct count; `flush()` folds the log.
  `wordset.SortedLog` owns the log; this module reads none of its
  state.  Streams of several slabs (or none) take the separate calls
  instead.
- sequences: `insert_seq(s)` / `remove_seq(s)` run a second, chunked
  pipeline (`_pipeline_words`: chunks of up to `chunk_size` k-mers,
  validity packed one bit a k-mer on the host, B1, no blanking scan) and
  hand each chunk's words to the pending log, as `cbl_tpu` does, so the
  log fills and folds where its does;
- ordered membership: `contains_seq(s)` / `contains_codes_stream` flush,
  then answer a mask per record in sequence order: from 2^17 k-mers each
  slab runs B1, B2 and a sort-join with the index (`_fused_contains`,
  B3 by default; an index with holes is joined by one sort and not
  compacted), below that the chunked pipeline and `contains_words`; the
  masks cross to the host once.  `contains_all` is a counting query;
- point operations (`insert`, `remove`, `contains`, `*_kmers`) take
  k-mers as packed integers and run on the same pending log;
- set algebra: `a | b`, `a & b`, `a - b`, `a ^ b`, their in-place forms,
  `CBL.merge([...])` and `CBL.intersect([...])` build a new index from
  indexes of one configuration and never consume an operand
  (`DeviceWordSet.union` and the rest).
- export: `kmers_limbs`, `__iter__` and `iter_nucs` decode the sorted
  words (`DeviceWordSet.export_keys`) on the device and copy them out as
  `cbl_tpu`'s limb rows, packed ints or ASCII; `iter_kmers_limbs` hands
  the same limb rows out in blocks on the device, for an index too large
  to export at once; `save_to_file` /
  `load_from_file` write and read `cbl_tpu`'s CBLX checkpoints
  (`serialize`), `interop` the reference's `.cbl` files, and the stats
  methods (`stats`) report the prefix buckets.
A `PackedStream` owns the memo of its slabs' words (`PackedStream.words`):
it alone decides when they are computed, sorted and kept.
Every sort goes through `ops.sort.sort_keys` (kernel B5 for CUDA
tensors and `torch.sort` for CPU tensors by default; a sort mode set by
`CBL_TORCH_SORT` or `use_sort_mode` picks `torch.sort` ("library"), B5
("mergepath") or kernel B6 ("bitonic") on either device) and every
merge through `ops.sort.merge_sorted_pair` / `merge_with_unsorted`
(kernel B3, kernel B7 under the "bitonic" merge mode, or one sort of both
sides under "sort").

Differences from `cbl_tpu.CBL`:
- `device` is explicit (default "cuda"); "cuda" without a CUDA device
  raises, and `device="cpu"` runs the plain tensor versions of the
  kernels.
- Each call runs as eager PyTorch, not as one compiled program.
- The index partitioned over a mesh of devices is `parallel.ShardedCBL`,
  which runs this module's word pipeline on each shard's slab.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kmer as kmod
from . import necklace, stats
from .config import CBLConfig, get_config
from .limbs import (
    SENTINEL,
    ints_to_keys,
    keys_to_limbs,
    kmer_cols,
    to_py_ints,
)
from .ops.scan import blank_mask
from .profiling import count, span, spanned, sync
from . import wordset as wordset_mod
from .wordset import (
    DEFAULT_PENDING_CAP,
    DeviceWordSet,
    _contains_sortjoin_kernel,
    _distinct_count,
    _next_pow2,
    host_limbs,
    resolve_device,
    sort_rows,
)

DEFAULT_CHUNK = 1 << 19  # k-mers per chunk of the sequence pipeline
_FUSED_SLAB = 1 << 25  # max k-mers per slab
# rows of words a PackedStream's memo holds at most (two full slabs, 512
# MiB at one column): the words of a longer stream, an index build, would
# take as much memory again as the index they build
_MEMO_ROWS = 1 << 26


def _stream_len(chunk: int, k: int) -> int:
    """Padded base-stream length for `chunk` k-mers (multiple of 16)."""
    raw = chunk + k - 1
    return (raw + 15) // 16 * 16


def blank_delta(starts, ends, nk_pad: int):
    """[nk_pad] int32 interval deltas: +1 at each start, -1 at each end.

    starts/ends: int64 endpoints of the blanked intervals of k-mer start
    positions (record-boundary halos, short trailing records, the padded
    tail).  Padding entries use index nk_pad + 1; the delta tensor has two
    spare slots so they (and ends at nk_pad) land outside the slab
    instead of being dropped by the scatter, as `cbl_tpu` drops them.
    """
    delta = torch.zeros(nk_pad + 2, dtype=torch.int32, device=starts.device)
    ones = torch.ones(starts.shape[0], dtype=torch.int32, device=starts.device)
    delta.index_add_(0, starts, ones)
    delta.index_add_(0, ends, -ones)
    return delta[:nk_pad]


def host_to_device(arr: np.ndarray, device, mask32: bool = False):
    """int32/uint32 numpy -> int64 tensor on `device` (the copy moves 4
    bytes per value; uint32 words travel as their int32 view)."""
    t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int32))
    t = t.to(device).to(torch.int64)
    return t & 0xFFFFFFFF if mask32 else t


def _kmer_words(stream, n: int, cfg: CBLConfig, canonical: bool,
                blank=None):
    """Packed stream -> [n] (or [2, n]) int64 words of its first n k-mer
    starts, SENTINEL where `blank` (an [n] int32 mask) is non-zero: on
    CUDA kernel B1 from the stream, one launch, counted in
    `COUNTERS["words.fused"]`; on the CPU extract, (canonicalize),
    necklace, pack (`necklace.stream_words`)."""
    if stream.device.type != "cpu":
        count("words.fused")
    return necklace.stream_words(stream, n, cfg, canonical, blank)


@spanned("words")
def _device_words(stream, starts, ends, nk_pad: int, cfg: CBLConfig,
                  canonical: bool):
    """Packed stream -> ([nk_pad] (or [2, nk_pad]) int64 words, blanked
    rows = SENTINEL; n_valid int32 0-d): the blanking scan (B2), then
    the words (B1, which writes the blanked rows)."""
    mask, n_valid = blank_mask(blank_delta(starts, ends, nk_pad))
    return _kmer_words(stream, nk_pad, cfg, canonical, mask), n_valid


@spanned("words")
def _pipeline_words(stream, validbits, chunk: int, cfg: CBLConfig,
                    canonical: bool):
    """One chunk of the sequence pipeline (`cbl_tpu.cbl._pipeline_fn`):
    packed stream [S/16] (int64 holding uint32 words) and validity bits
    [chunk/8] uint8 (`np.packbits`, first k-mer in the top bit) ->
    [chunk] (or [2, chunk]) int64 words, invalid rows SENTINEL.  Validity
    comes from the host, so there is no blanking scan."""
    words = _kmer_words(stream, chunk, cfg, canonical)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8,
                          device=validbits.device)
    valid = ((validbits[:, None] >> shifts) & 1).bool().reshape(-1)
    return torch.where(valid, words, SENTINEL)


def _fused_contains(stream, starts, ends, nk_pad: int, cfg: CBLConfig,
                    canonical: bool, data: torch.Tensor, holes: bool):
    """[nk_pad] bool membership of a slab's k-mers in k-mer start order,
    blanked rows False (`cbl_tpu.cbl._fused_contains_fn`): the word
    pipeline (B1, B2), then a sort-join with the index (B3 by default)."""
    words, _ = _device_words(stream, starts, ends, nk_pad, cfg, canonical)
    return _contains_sortjoin_kernel(data, words, holes)


def _fused_build(stream, starts, ends, nk_pad, cfg, canonical):
    """-> (sorted words with duplicates, distinct count, n_valid)."""
    words, n_valid = _device_words(stream, starts, ends, nk_pad, cfg,
                                   canonical)
    s = sort_rows(words)
    with span("index"):
        n_dev = _distinct_count(s)
    return s, n_dev, n_valid


def _fused_words_sorted(stream, starts, ends, nk_pad, cfg, canonical):
    """-> (sorted words, n_valid)."""
    words, n_valid = _device_words(stream, starts, ends, nk_pad, cfg,
                                   canonical)
    return sort_rows(words), n_valid


def _unblanked(starts: np.ndarray, ends: np.ndarray, nk_pad: int) -> int:
    """K-mer starts of a slab that its blank intervals [starts, ends)
    (clipped to nk_pad; B2 blanks their union) leave valid."""
    s = np.minimum(starts, nk_pad).astype(np.int64)
    e = np.minimum(ends, nk_pad).astype(np.int64)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.concatenate([[0], np.maximum.accumulate(e)[:-1]])
    return nk_pad - int(np.maximum(e - np.maximum(s, reach), 0).sum())


class Slab(tuple):
    """A staged slab, (nk_pad, stream, starts, ends, n_kmers), that also
    carries `n_valid`: its k-mer starts left unblanked, counted on the
    host when it was packed (`_unblanked`), so that a probe join can
    count its valid rows without a wait for the device."""

    def __new__(cls, fields, n_valid: int):
        slab = super().__new__(cls, fields)
        slab.n_valid = n_valid
        return slab


class PackedStream:
    """A record stream staged on the device: per slab (nk_pad, stream,
    starts, ends, n_kmers).  Build it once with `CBL.pack_stream` and pass
    it to insert and query, which then pay the host-to-device copy once.

    The stream owns the memo of its slabs' words (`words`, and
    `keep_sorted` for an insert's): the necklace transform is a pure
    function of the staged stream, so an insert keeps its sorted words
    and a later query of the same stream merges them with the index
    without a sort, a round sorts them once, and a remove or a query
    against a log keeps the words in stream order.  The memo holds at
    most `_MEMO_ROWS` rows: past them a slab's words are not kept (a slab
    already kept is still replaced)."""

    def __init__(self, cfg: CBLConfig, canonical: bool, slabs: list):
        self.cfg = cfg
        self.canonical = canonical
        self.slabs = slabs
        self._words: dict = {}  # slab -> (words, n_valid, sorted)

    def words(self, i: int, sort: bool = False, keep: bool = True):
        """(words, n_valid int32 0-d, sorted) of slab i: as kept, sorted
        first where `sort` asks and they are not (and kept so); else
        computed (`_device_words`: B2, B1; sorted where `sort` asks) and
        kept where `keep` says."""
        entry = self._words.get(i)
        if entry is None:
            nk_pad, stream, s_arr, e_arr, _ = self.slabs[i]
            compute = _fused_words_sorted if sort else _device_words
            entry = (*compute(stream, s_arr, e_arr, nk_pad, self.cfg,
                              self.canonical), sort)
        elif sort and not entry[2]:
            entry = (sort_rows(entry[0]), entry[1], True)
        else:
            return entry
        if keep:
            self._keep(i, entry)
        return entry

    def keep_sorted(self, i: int, words: torch.Tensor, n_valid) -> None:
        """Keep slab i's sorted words, computed by an insert (an index
        build's may be the index itself: nothing updates it in place)."""
        self._keep(i, (words, n_valid, True))

    def _keep(self, i: int, entry: tuple) -> None:
        held = sum(w.shape[-1] for j, (w, _, _) in self._words.items()
                   if j != i)
        if held + entry[0].shape[-1] <= _MEMO_ROWS:
            self._words[i] = entry

    @property
    def n_kmers(self) -> int:
        return sum(s[4] for s in self.slabs)


class CBL:
    """A dynamic, exact set of k-mers on one device.

    `k` (odd, <= 59), `prefix_bits`, `chunk_size` (k-mers
    a chunk of the sequence pipeline at most) and `pending_cap` (rows of
    the pending log) as in `cbl_tpu.CBL`.
    """

    @spanned("cbl.__init__")
    def __init__(self, k: int = 25, prefix_bits: int = 24,
                 canonical: bool = False, device="cuda",
                 chunk_size: int = DEFAULT_CHUNK,
                 pending_cap: int = DEFAULT_PENDING_CAP):
        self.cfg = get_config(k=k, prefix_bits=prefix_bits)
        self.canonical = canonical
        self.chunk = chunk_size
        self.device = resolve_device(device)
        self.wordset = DeviceWordSet(self.cfg, self.device, pending_cap)

    @classmethod
    def new(cls, k: int = 25, prefix_bits: int = 24, **kw) -> "CBL":
        return cls(k=k, prefix_bits=prefix_bits, canonical=False, **kw)

    @classmethod
    def new_canonical(cls, k: int = 25, prefix_bits: int = 24, **kw) -> "CBL":
        return cls(k=k, prefix_bits=prefix_bits, canonical=True, **kw)

    def _like(self, wordset: DeviceWordSet) -> "CBL":
        """An index of this one's configuration over `wordset`."""
        out = CBL(k=self.cfg.k, prefix_bits=self.cfg.prefix_bits,
                  canonical=self.canonical, device=self.device,
                  chunk_size=self.chunk, pending_cap=wordset.pending_cap)
        out.wordset = wordset
        return out

    def is_canonical(self) -> bool:
        return self.canonical

    def count(self) -> int:
        return self.wordset.count()

    @spanned("cbl.count_device")
    def count_device(self):
        """`count` as an unsynced device 0-d tensor."""
        return self.wordset.count_device()

    def is_empty(self) -> bool:
        return self.wordset.is_empty()

    def __len__(self) -> int:
        return self.count()

    # --- staging ---

    def _blank_intervals(self, offsets, nk: int):
        """[start, end) intervals of k-mer start positions to blank:
        record-boundary halos (k-mers never span records) and a short
        trailing record."""
        k = self.cfg.k
        b = np.asarray(offsets[1:-1], dtype=np.int64)
        starts = np.clip(b - k + 1, 0, nk)
        ends = np.clip(b, 0, nk)
        if len(offsets) >= 2 and offsets[-1] - offsets[-2] < k:
            starts = np.append(starts, max(int(offsets[-2]) - k + 1, 0))
            ends = np.append(ends, nk)
        return starts, ends

    def _fused_slabs(self, codes: np.ndarray, offsets: np.ndarray,
                     slab: int | None = None, uniform: bool = False):
        """Yield (nk_pad, packed stream [uint32], starts, ends, n_kmers)
        per slab, as numpy arrays.  Slab windows are 16-base-aligned views
        of one packed stream with the K-1 halo included; starts/ends are
        int32 blank intervals local to the slab, padded to a power-of-two
        length with the index nk_pad + 1.  `slab` overrides the slab size
        (a power of two >= 4096); `uniform` pads the last slab to the full
        size too (the sharded index stacks a slab a shard,
        `parallel.shard.build_slab_groups`)."""
        k = self.cfg.k
        nk = max(len(codes) - k + 1, 0)
        if nk == 0:
            return
        g_starts, g_ends = self._blank_intervals(offsets, nk)
        slab = _FUSED_SLAB if slab is None else slab
        n_slabs = (nk + slab - 1) // slab
        last_nk = nk - (n_slabs - 1) * slab
        last_pad = slab if uniform else max(_next_pow2(last_nk), 4096)
        total_bases = (n_slabs - 1) * slab + _stream_len(last_pad, k)
        cbuf = np.zeros(total_bases, dtype=np.uint8)
        cbuf[: min(len(codes), total_bases)] = codes[:total_bases]
        packed = kmod.np_pack_stream(cbuf)
        for i in range(n_slabs):
            s0 = i * slab
            nk_pad = slab if i < n_slabs - 1 else last_pad
            nw = _stream_len(nk_pad, k) // 16
            stream = packed[s0 // 16 : s0 // 16 + nw]
            n_here = min(slab, nk - s0)
            ss = np.clip(g_starts - s0, 0, nk_pad)
            ee = np.clip(g_ends - s0, 0, nk_pad)
            if n_here < nk_pad:  # blank the padded tail
                ss = np.append(ss, n_here)
                ee = np.append(ee, nk_pad)
            cap = max(_next_pow2(max(len(ss), 1)), 16)
            drop = nk_pad + 1
            s_arr = np.full(cap, drop, dtype=np.int32)
            s_arr[: len(ss)] = ss
            e_arr = np.full(cap, drop, dtype=np.int32)
            e_arr[: len(ee)] = ee
            yield nk_pad, stream, s_arr, e_arr, n_here

    def pack_stream(self, codes: np.ndarray, offsets: np.ndarray,
                    slab: int | None = None) -> PackedStream:
        """Pack a record stream (uint8 codes, record `offsets` [n+1]) and
        stage it on the device."""
        slabs = [
            Slab((
                nk_pad,
                host_to_device(stream, self.device, mask32=True),
                host_to_device(s_arr, self.device),
                host_to_device(e_arr, self.device),
                n_here,
            ), _unblanked(s_arr, e_arr, nk_pad))
            for nk_pad, stream, s_arr, e_arr, n_here in self._fused_slabs(
                codes, offsets, slab
            )
        ]
        return PackedStream(self.cfg, self.canonical, slabs)

    def _resolve_stream(self, codes, offsets) -> PackedStream:
        if isinstance(codes, PackedStream):
            if (codes.cfg, codes.canonical) != (self.cfg, self.canonical):
                raise ValueError("PackedStream built for a different config")
            if codes.slabs and codes.slabs[0][1].device != self.device:
                raise ValueError("PackedStream staged on another device")
            return codes
        return self.pack_stream(codes, offsets)

    # --- the sequence pipeline: chunks with validity from the host ---

    def _codes_of(self, seq) -> np.ndarray:
        if isinstance(seq, np.ndarray) and seq.dtype == np.uint8:
            return seq
        return kmod.encode_seq(seq)

    def _check_len(self, seq) -> None:
        if len(seq) < self.cfg.k:
            raise ValueError(
                f"Sequence size ({len(seq)}) is smaller than K ({self.cfg.k})"
            )

    def _effective_chunk(self, total_kmers: int) -> int:
        """The chunk for a stream of `total_kmers`: the next power of two,
        at least 4096 and at most `chunk_size`, on a 16-base boundary."""
        if total_kmers <= 0:
            return min(self.chunk, 4096)
        tier = 1 << max(total_kmers - 1, 1).bit_length()
        eff = max(min(self.chunk, tier), 4096)
        return (eff + 15) // 16 * 16

    def _stream_chunks(self, codes: np.ndarray, valid: np.ndarray,
                       chunk: int):
        """Yield (stream [S/16] uint32, validbits [chunk/8] uint8,
        n_kmers) a chunk, as numpy views.  The stream is packed once and
        the validity once with `np.packbits` (one bit a k-mer, which is
        what crosses to the device); chunk windows start on 16-base and
        8-k-mer boundaries."""
        S = _stream_len(chunk, self.cfg.k)
        total = len(valid)
        if total <= 0:
            return
        n_chunks = (total + chunk - 1) // chunk
        cbuf = np.zeros((n_chunks - 1) * chunk + S, dtype=np.uint8)
        cbuf[: len(codes)] = codes[: len(cbuf)]
        packed = kmod.np_pack_stream(cbuf)
        vfull = np.zeros(n_chunks * chunk, dtype=bool)
        vfull[:total] = valid
        vbits_all = np.packbits(vfull)
        nw = S // 16
        for i in range(n_chunks):
            start = i * chunk
            yield (
                packed[start // 16 : start // 16 + nw],
                vbits_all[start // 8 : start // 8 + chunk // 8],
                min(chunk, total - start),
            )

    def _stream_valid(self, codes: np.ndarray,
                      offsets: np.ndarray) -> np.ndarray:
        """Valid-start mask of a concatenated record stream: a k-mer is
        valid when it lies inside one record.  Each interior boundary b
        blanks starts [b-k+1, b), a short trailing record blanks every
        start inside it; the intervals add up as +1/-1 deltas."""
        k = self.cfg.k
        nk = max(len(codes) - k + 1, 0)
        if nk == 0:
            return np.zeros(0, dtype=bool)
        starts, ends = self._blank_intervals(offsets, nk)
        delta = np.zeros(nk + 1, dtype=np.int64)
        np.add.at(delta, starts, 1)
        np.add.at(delta, ends, -1)
        return np.cumsum(delta[:nk]) == 0

    def _stream_words(self, codes: np.ndarray, valid: np.ndarray):
        """Yield ([chunk] words on the device, n_kmers) a chunk
        (`_pipeline_words`)."""
        chunk = self._effective_chunk(len(valid))
        for stream, vbits, n in self._stream_chunks(codes, valid, chunk):
            words = _pipeline_words(
                host_to_device(stream, self.device, mask32=True),
                torch.from_numpy(vbits).to(self.device), chunk, self.cfg,
                self.canonical)
            yield words, n

    def _seqs_words(self, seqs):
        """Concatenate sequences (records shorter than K dropped) into one
        stream and yield its chunks' words; k-mers never span records."""
        k = self.cfg.k
        parts = [c for c in map(self._codes_of, seqs) if len(c) >= k]
        if not parts:
            return
        codes = np.concatenate(parts)
        offsets = np.cumsum([0] + [len(c) for c in parts], dtype=np.int64)
        yield from self._stream_words(codes,
                                      self._stream_valid(codes, offsets))

    # --- insert, remove and query of record streams ---

    @spanned("cbl.insert_codes_stream")
    def insert_codes_stream(self, codes, offsets: np.ndarray | None = None):
        """Insert every k-mer of a record stream (codes and offsets, or a
        PackedStream).  Pending work is folded first.  A slab that meets
        an empty index is sorted and adopted as the index; any other slab
        is sorted and appended to the pending log when it fits beside
        what is queued, else merged into the index (kernel B3)."""
        ws = self.wordset
        ws.flush()
        ps = self._resolve_stream(codes, offsets)
        for i, (nk_pad, stream, s_arr, e_arr, n_here) in enumerate(ps.slabs):
            if ws._n_upper == 0:
                data, n_dev, n_valid = _fused_build(
                    stream, s_arr, e_arr, nk_pad, self.cfg, self.canonical
                )
                ps.keep_sorted(i, data, n_valid)
                ws.adopt_built(data, n_dev, n_here)
                continue
            words, n_valid = _fused_words_sorted(
                stream, s_arr, e_arr, nk_pad, self.cfg, self.canonical
            )
            ps.keep_sorted(i, words, n_valid)
            if words.shape[-1] + ws.n_pending <= ws.pending_cap:
                ws.insert_words(words)
            else:
                ws._merge_into(words, n_new_upper=n_here, batch_sorted=True)

    @spanned("cbl.remove_codes_stream")
    def remove_codes_stream(self, codes, offsets: np.ndarray | None = None):
        """Remove every k-mer of a record stream: one batch for the word
        set's log (`DeviceWordSet.remove_words`)."""
        ps = self._resolve_stream(codes, offsets)
        batches = [ps.words(i)[0] for i in range(len(ps.slabs))]
        if batches:
            self.wordset.remove_words(batches[0] if len(batches) == 1
                                      else torch.cat(batches, dim=-1))

    @spanned("cbl.query_codes_stream")
    def query_codes_stream(self, codes, offsets: np.ndarray | None = None,
                           lazy: bool = False):
        """(total k-mers, k-mers present) over a record stream (codes and
        offsets, or a PackedStream).  The counters add up on the device;
        with lazy=True they come back as unsynced device 0-d tensors,
        otherwise as ints after one sync.  A pending log or an active slog
        is joined as it is, never folded, and an index with holes (a set
        operation's result) is joined by one sort, never compacted.  A
        query against a log keeps its words in the stream's memo; one of a
        clean index uses them where kept and does not keep them."""
        ws = self.wordset
        ps = self._resolve_stream(codes, offsets)
        logged = ws.n_pending > 0 or ws.slog.keys is not None
        total = positive = None
        for i, slab in enumerate(ps.slabs):
            words, t, is_sorted = ps.words(i, keep=logged)
            p = ws.count_hits_device(words, words_sorted=is_sorted,
                                     n_valid=getattr(slab, "n_valid", None))
            total = t if total is None else total + t
            positive = p if positive is None else positive + p
        if total is None:
            zero = torch.zeros((), dtype=torch.int64, device=self.device)
            return (zero, zero) if lazy else (0, 0)
        if lazy:
            return total, positive
        with sync("query_codes_stream"):
            t, p = torch.stack([total.to(torch.int64), positive]).tolist()
        return t, p

    def flush(self) -> None:
        """Fold an active sorted log and the pending log into the static
        index."""
        self.wordset.flush()

    @spanned("cbl.dynamic_round")
    def dynamic_round(self, ins, qry, rm, lazy: bool = False):
        """One interleaved round: insert every k-mer of `ins`, count-query
        `qry` (it sees the inserts, not yet the removes), remove every
        k-mer of `rm`.  Args are PackedStreams or (codes, offsets) tuples.
        Returns (total, positive) ints, or unsynced device 0-d tensors with
        lazy=True.

        Streams of ONE slab each run over the word set's sorted log
        (`DeviceWordSet.round_words`) on their sorted words, which the
        streams keep.  Any other streams take the separate insert, query
        and remove calls."""
        count("rounds")
        streams = [self._resolve_round_stream(x) for x in (ins, qry, rm)]
        if any(len(ps.slabs) != 1 for ps in streams):
            self.insert_codes_stream(streams[0])
            t, p = self.query_codes_stream(streams[1], lazy=lazy)
            self.remove_codes_stream(streams[2])
            return t, p
        (w_i, _, _), (w_q, total, _), (w_r, _, _) = (
            ps.words(0, sort=True) for ps in streams
        )
        positive = self.wordset.round_words(w_i, w_q, w_r)
        if lazy:
            return total, positive
        with sync("dynamic_round"):
            t, p = torch.stack([total.to(torch.int64), positive]).tolist()
        return t, p

    def _resolve_round_stream(self, x) -> PackedStream:
        if isinstance(x, PackedStream):
            return self._resolve_stream(x, None)
        if isinstance(x, tuple):
            return self._resolve_stream(*x)
        raise TypeError(
            "dynamic_round takes PackedStreams or (codes, offsets) tuples"
        )

    # --- sequence operations ---

    def insert_seq(self, seq) -> None:
        self._check_len(seq)
        self.insert_seqs([seq])

    def insert_seqs(self, seqs) -> None:
        """Insert every k-mer of the sequences: each chunk's words,
        sentinel rows included, go to the pending log."""
        for words, _ in self._seqs_words(seqs):
            self.wordset.insert_words(words)

    def remove_seq(self, seq) -> None:
        self._check_len(seq)
        self.remove_seqs([seq])

    def remove_seqs(self, seqs) -> None:
        """Remove every k-mer of the sequences: the chunks' words as one
        batch for the pending log."""
        batches = [w for w, _ in self._seqs_words(seqs)]
        if batches:
            self.wordset.remove_words(torch.cat(batches, dim=-1))

    def contains_seq(self, seq) -> np.ndarray:
        """Membership of each k-mer of `seq`, in sequence order."""
        self._check_len(seq)
        return self.contains_seqs([seq])[0]

    def contains_seqs(self, seqs) -> list:
        """A membership mask for each sequence (`contains_codes_stream`)."""
        for s in seqs:
            self._check_len(s)
        codes_list = [self._codes_of(s) for s in seqs]
        offsets = np.cumsum([0] + [len(c) for c in codes_list],
                            dtype=np.int64)
        codes = (np.concatenate(codes_list) if codes_list
                 else np.zeros(0, dtype=np.uint8))
        return self.contains_codes_stream(codes, offsets)

    def contains_codes_stream(self, codes: np.ndarray,
                              offsets: np.ndarray) -> list:
        """Per-record membership masks of a concatenated code stream:
        record r gets a bool array of its max(len_r - K + 1, 0) k-mers in
        sequence order."""
        k = self.cfg.k
        flat = self._contains_flat(codes, offsets)
        out = []
        for r in range(len(offsets) - 1):
            lo = int(offsets[r])
            hi = max(int(offsets[r + 1]) - k + 1, lo)
            out.append(flat[lo:hi])
        return out

    def _contains_flat(self, codes: np.ndarray,
                       offsets: np.ndarray) -> np.ndarray:
        """[nk] bool over every k-mer start of the stream (starts that
        span records are False), after `flush()`.  From
        `_SORTJOIN_MIN_QUERIES` k-mers each slab of up to 2^25 runs the
        word pipeline and a sort-join with the index (`_fused_contains`);
        a smaller stream takes the chunked pipeline and `contains_words`.
        The masks are joined on the device and copied to the host once."""
        ws = self.wordset
        nk = max(len(codes) - self.cfg.k + 1, 0)
        ws.flush()
        if nk == 0:
            return np.zeros(0, dtype=bool)
        if nk >= wordset_mod._SORTJOIN_MIN_QUERIES:
            data = ws._live()
            masks = [
                _fused_contains(stream, s_arr, e_arr, nk_pad, self.cfg,
                                self.canonical, data, ws._holes)[:n_here]
                for nk_pad, stream, s_arr, e_arr, n_here
                in self.pack_stream(codes, offsets).slabs
            ]
        else:
            masks = [
                ws.contains_words(words)[:n]
                for words, n in self._stream_words(
                    codes, self._stream_valid(codes, offsets))
            ]
        with sync("contains"):
            return torch.cat(masks).cpu().numpy()

    def contains_all(self, seq) -> bool:
        """True when every k-mer of `seq` is present (a counting query,
        no mask)."""
        self._check_len(seq)
        codes = self._codes_of(seq)
        if len(codes) < self.cfg.k:
            return True
        offsets = np.array([0, len(codes)], dtype=np.int64)
        total, positive = self.query_codes_stream(codes, offsets)
        return positive == total

    # --- point operations; k-mers are packed integers (2 bits a base) ---

    def _word_rows_of_kmers(self, kmers_int) -> torch.Tensor:
        """[N] (or [2, N]) words of k-mers given as Python ints (first base
        most significant, up to 118 bits): canonicalize, necklace (plain
        version), pack."""
        kmers = torch.from_numpy(
            ints_to_keys(kmers_int, kmer_cols(self.cfg))).to(self.device)
        if self.canonical:
            kmers, _ = kmod.canonicalize(kmers, self.cfg)
        best, pos = necklace.necklace_pos(kmers, self.cfg)
        return necklace.pack_word(best, pos, self.cfg)

    def contains_kmers(self, kmers_int) -> np.ndarray:
        """[N] bool numpy mask, in the order given; never folds a log."""
        words = self._word_rows_of_kmers(kmers_int)
        found = self.wordset.contains_words(words)
        with sync("contains"):
            return found.cpu().numpy()

    def insert_kmers(self, kmers_int) -> None:
        self.wordset.insert_words(self._word_rows_of_kmers(kmers_int))

    def remove_kmers(self, kmers_int) -> None:
        self.wordset.remove_words(self._word_rows_of_kmers(kmers_int))

    def contains(self, kmer_int: int) -> bool:
        return bool(self.contains_kmers([kmer_int])[0])

    def __contains__(self, kmer_int: int) -> bool:
        return self.contains(kmer_int)

    def insert(self, kmer_int: int) -> bool:
        """True when the k-mer was absent."""
        words = self._word_rows_of_kmers([kmer_int])
        absent = not self._found(words)
        self.wordset.insert_words(words)
        return absent

    def remove(self, kmer_int: int) -> bool:
        """True when the k-mer was present."""
        words = self._word_rows_of_kmers([kmer_int])
        present = self._found(words)
        self.wordset.remove_words(words)
        return present

    def _found(self, words) -> bool:
        """Whether the one word of `words` is in the set (one sync)."""
        found = self.wordset.contains_words(words)
        with sync("contains"):
            return bool(found[0])

    # --- set algebra ---

    def _check_mode(self, other: "CBL") -> None:
        if self.canonical != other.canonical:
            raise ValueError(
                "One of the index is canonical while the other isn't")
        if self.cfg != other.cfg:
            raise ValueError("Mismatched CBL configurations")
        if self.device != other.device:
            raise ValueError(
                f"indexes on two devices: {self.device} and {other.device}")

    def __or__(self, other: "CBL") -> "CBL":
        self._check_mode(other)
        return self._like(self.wordset.union(other.wordset))

    def __ior__(self, other: "CBL") -> "CBL":
        self._check_mode(other)
        self.wordset = self.wordset.union(other.wordset)
        return self

    def __and__(self, other: "CBL") -> "CBL":
        self._check_mode(other)
        return self._like(self.wordset.intersection(other.wordset))

    def __iand__(self, other: "CBL") -> "CBL":
        self._check_mode(other)
        self.wordset = self.wordset.intersection(other.wordset)
        return self

    def __sub__(self, other: "CBL") -> "CBL":
        self._check_mode(other)
        return self._like(self.wordset.difference(other.wordset))

    def __isub__(self, other: "CBL") -> "CBL":
        self._check_mode(other)
        self.wordset = self.wordset.difference(other.wordset)
        return self

    def __xor__(self, other: "CBL") -> "CBL":
        self._check_mode(other)
        return self._like(self.wordset.symmetric_difference(other.wordset))

    def __ixor__(self, other: "CBL") -> "CBL":
        self._check_mode(other)
        self.wordset = self.wordset.symmetric_difference(other.wordset)
        return self

    @classmethod
    def _checked_wordsets(cls, cbls: list) -> list:
        if not cbls:
            raise ValueError("expected at least one index")
        for c in cbls[1:]:
            cbls[0]._check_mode(c)
        return [c.wordset for c in cbls]

    @classmethod
    def merge(cls, cbls: list) -> "CBL":
        """Union of every index of the list."""
        sets = cls._checked_wordsets(cbls)
        return cbls[0]._like(DeviceWordSet.merge_many(sets))

    @classmethod
    def intersect(cls, cbls: list) -> "CBL":
        """Intersection of every index of the list."""
        sets = cls._checked_wordsets(cbls)
        return cbls[0]._like(DeviceWordSet.intersect_many(sets))

    # --- export ---

    @spanned("cbl.kmers_limbs")
    def kmers_limbs(self) -> np.ndarray:
        """[n, L] uint32 k-mer limb rows in ascending word order, decoded
        on the device (`necklace.word_to_kmer`) and copied once."""
        kmers = necklace.word_to_kmer(self.wordset.export_keys(), self.cfg)
        return host_limbs(kmers, self.cfg.kmer_limbs)

    def iter_kmers_limbs(self, block_rows: int = 1 << 26):
        """Yield `kmers_limbs`' rows in blocks, as [m, L] int32 tensors on
        the device (uint32 bits: `.cpu().numpy().view(np.uint32)` on the
        host): the same rows in the same order, decoded `block_rows` rows
        of the word index at a time (`DeviceWordSet.iter_export_blocks`),
        so that no tensor of the index's length is made."""
        L = self.cfg.kmer_limbs
        for keys in self.wordset.iter_export_blocks(block_rows):
            with span("cbl.iter_kmers_limbs"):
                limbs = keys_to_limbs(necklace.word_to_kmer(keys, self.cfg),
                                      L)
            yield limbs

    def __iter__(self):
        """The k-mers as packed Python ints, in ascending word order."""
        yield from to_py_ints(self.kmers_limbs())

    def iter_nucs(self, chunk_rows: int = 1 << 20):
        """Yield the k-mers as ASCII bytes in ascending word order, one
        chunk of words decoded to base codes on the device and copied at
        a time."""
        keys = self.wordset.export_keys()
        for lo in range(0, keys.shape[-1], chunk_rows):
            km = necklace.word_to_kmer(keys[..., lo : lo + chunk_rows],
                                       self.cfg)
            codes = kmod.unpack_bases(km, self.cfg).cpu().numpy()
            for row in kmod.BASE_LOOKUP[codes]:
                yield row.tobytes()

    # --- persistence: `cbl_tpu`'s CBLX checkpoints ---

    def save_to_file(self, path) -> None:
        from . import serialize

        serialize.save(self, path)

    @classmethod
    def load_from_file(cls, path, device=None) -> "CBL":
        """The index of a checkpoint, on `device` (default: the card)."""
        from . import serialize

        return serialize.load(path, device=device)

    # --- repartition stats ---

    def prefix_load(self) -> float:
        return stats.prefix_load(self)

    def buckets_sizes(self):
        return stats.buckets_sizes(self)

    def buckets_size_count(self):
        return stats.buckets_size_count(self)

    def buckets_load_repartition(self):
        return stats.buckets_load_repartition(self)

    def buckets_nodes(self):
        return stats.buckets_nodes(self)

    def buckets_node_count(self):
        return stats.buckets_node_count(self)
