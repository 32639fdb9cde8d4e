"""CBL: the k-mer set facade for the static and dynamic-round paths.

Counterpart of `cbl_tpu/cbl.py` for two paths.  A record stream is packed
on the host (16 bases per uint32) and staged on the device once
(`pack_stream`).  On the device each slab of up to 2^25 k-mers runs
extract -> (canonicalize) -> necklace (kernel B1) -> pack ->
record-boundary blanking (kernel B2), then:
- static: a sort builds an empty index (`insert_codes_stream`) and merge
  joins (kernel B3) answer `query_codes_stream`;
- dynamic: `dynamic_round(ins, qry, rm)` merges three tagged sorted
  streams into the sorted log (B3) and scans it once (kernel B4) for the
  round's query hits and the distinct count; `flush()` folds the log.

Differences from `cbl_tpu.CBL`:
- `device` is explicit (default "cuda"); "cuda" without a CUDA device
  raises, and `device="cpu"` runs the plain tensor versions of the
  kernels.
- Later slabs of a build are merged into the index at once
  (`_merge_sortedbatch_kernel`) instead of going through the pending log.
- Each round runs as eager PyTorch, not as one compiled program.
- Not ported yet: inserting into a non-empty index,
  `remove_codes_stream` and dynamic rounds over streams of several slabs
  (the pending log, ROADMAP slice 3), point operations, set algebra,
  ordered membership, export and serialisation, dynamic rounds at K=27
  and K >= 29 (slice 6).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kmer as kmod
from . import necklace
from .config import CBLConfig, get_config
from .limbs import SENTINEL
from .ops.scan import blank_mask, slog_scan_counts
from .ops.sort import merge_sorted_pair
from .wordset import (
    _SLOG_SEQ_MAX,
    DeviceWordSet,
    _distinct_count,
    _next_pow2,
    _quantize_cap,
    resolve_device,
    slog_key,
    sort_rows,
)

_FUSED_SLAB = 1 << 25  # max k-mers per slab


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


def _device_words(stream, starts, ends, nk_pad: int, cfg: CBLConfig,
                  canonical: bool):
    """Packed stream -> ([nk_pad] int64 words, blanked rows = SENTINEL;
    n_valid int32 0-d)."""
    kmers = kmod.extract_kmers(stream, nk_pad, cfg)
    if canonical:
        kmers, _ = kmod.canonicalize(kmers, cfg)
    best, pos = necklace.necklace_pos_auto(kmers, cfg)
    words = necklace.pack_word(best, pos, cfg)
    mask, n_valid = blank_mask(blank_delta(starts, ends, nk_pad))
    return torch.where(mask.bool(), SENTINEL, words), n_valid


def _fused_build(stream, starts, ends, nk_pad, cfg, canonical):
    """-> (sorted words with duplicates, distinct count, n_valid)."""
    words, n_valid = _device_words(stream, starts, ends, nk_pad, cfg,
                                   canonical)
    s = sort_rows(words)
    return s, _distinct_count(s), n_valid


def _fused_words_sorted(stream, starts, ends, nk_pad, cfg, canonical):
    """-> (sorted words, n_valid)."""
    words, n_valid = _device_words(stream, starts, ends, nk_pad, cfg,
                                   canonical)
    return sort_rows(words), n_valid


def _fused_round_slog(a: torch.Tensor, seq: int, w_i, w_q, w_r,
                      out_cap: int):
    """One interleaved round over the sorted log (`cbl_tpu.cbl.
    _fused_round_slog_fn`): tag the three PRE-SORTED word streams with
    (seq << 2) | {1 insert, 2 query, 3 remove} (each stays sorted;
    sentinel rows stay SENTINEL, at the end), combine them with two small
    merges, merge the batch into the log `a` with one big merge (all B3),
    truncate or pad with SENTINEL to `out_cap` (the caller guarantees
    that only sentinel rows are cut), and scan once (B4).

    The tags make the reference's sequential semantics a property of the
    order: a round's queries sort after its inserts and before its
    removes, and the scan honours only entries at or before each query.
    -> (log [out_cap], positive, live) with int64 0-d counters."""
    base = seq << 2
    b = merge_sorted_pair(slog_key(w_i, base | 1), slog_key(w_q, base | 2))
    b = merge_sorted_pair(b, slog_key(w_r, base | 3))
    merged = merge_sorted_pair(a, b) if a.shape[0] else b
    total = merged.shape[0]
    if total > out_cap:
        merged = merged[:out_cap]
    elif total < out_cap:
        pad = torch.full((out_cap - total,), SENTINEL, dtype=torch.int64,
                         device=merged.device)
        merged = torch.cat([merged, pad])
    positive, live = slog_scan_counts(merged, base | 2)
    return merged, positive, live


class PackedStream:
    """A record stream staged on the device: per slab (nk_pad, stream,
    starts, ends, n_kmers).  Build it once with `CBL.pack_stream` and pass
    it to insert and query, which then pay the host-to-device copy once.

    `_words` memoizes each slab's (sorted words, n_valid): the necklace
    transform is a pure function of the staged stream, so a build fills
    the memo and a later query of the same stream merges the sorted words
    with the index without a sort."""

    def __init__(self, cfg: CBLConfig, canonical: bool, slabs: list):
        self.cfg = cfg
        self.canonical = canonical
        self.slabs = slabs
        self._words: dict = {}


class CBL:
    """An exact set of k-mers (static build+query path) on one device.

    `k` (odd, <= 27 in this port) and `prefix_bits` as in `cbl_tpu.CBL`.
    """

    def __init__(self, k: int = 25, prefix_bits: int = 24,
                 canonical: bool = False, device="cuda"):
        self.cfg = get_config(k=k, prefix_bits=prefix_bits)
        self.canonical = canonical
        self.device = resolve_device(device)
        self.wordset = DeviceWordSet(self.cfg, self.device)

    @classmethod
    def new(cls, k: int = 25, prefix_bits: int = 24, **kw) -> "CBL":
        return cls(k=k, prefix_bits=prefix_bits, canonical=False, **kw)

    @classmethod
    def new_canonical(cls, k: int = 25, prefix_bits: int = 24, **kw) -> "CBL":
        return cls(k=k, prefix_bits=prefix_bits, canonical=True, **kw)

    def is_canonical(self) -> bool:
        return self.canonical

    def count(self) -> int:
        return self.wordset.count()

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
                     slab: int | None = None):
        """Yield (nk_pad, packed stream [uint32], starts, ends, n_kmers)
        per slab, as numpy arrays.  Slab windows are 16-base-aligned views
        of one packed stream with the K-1 halo included; starts/ends are
        int32 blank intervals local to the slab, padded to a power-of-two
        length with the index nk_pad + 1.  `slab` overrides the slab size
        (a power of two >= 4096)."""
        k = self.cfg.k
        nk = max(len(codes) - k + 1, 0)
        if nk == 0:
            return
        g_starts, g_ends = self._blank_intervals(offsets, nk)
        slab = _FUSED_SLAB if slab is None else slab
        n_slabs = (nk + slab - 1) // slab
        last_nk = nk - (n_slabs - 1) * slab
        last_pad = max(_next_pow2(last_nk), 4096)
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

    def _to_device(self, arr: np.ndarray, mask32: bool = False):
        """int32/uint32 numpy -> int64 tensor on the device (the copy moves
        4 bytes per value; uint32 words travel as their int32 view)."""
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int32))
        t = t.to(self.device).to(torch.int64)
        return t & 0xFFFFFFFF if mask32 else t

    def pack_stream(self, codes: np.ndarray, offsets: np.ndarray,
                    slab: int | None = None) -> PackedStream:
        """Pack a record stream (uint8 codes, record `offsets` [n+1]) and
        stage it on the device."""
        slabs = [
            (
                nk_pad,
                self._to_device(stream, mask32=True),
                self._to_device(s_arr),
                self._to_device(e_arr),
                n_here,
            )
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

    # --- build and query ---

    def insert_codes_stream(self, codes, offsets: np.ndarray | None = None):
        """Build the index from every k-mer of a record stream (codes and
        offsets, or a PackedStream).  The index must be empty: the first
        slab's sorted words are adopted, each later slab is sorted and
        merged in (kernel B3)."""
        ws = self.wordset
        if ws._n_upper != 0:
            raise NotImplementedError(
                "insert into a non-empty index needs the pending log "
                "(ROADMAP slice 3); cbl_tpu_torch builds into an empty "
                "index only"
            )
        ps = self._resolve_stream(codes, offsets)
        ws.flush()  # an active slog that never inserted folds to empty
        for i, (nk_pad, stream, s_arr, e_arr, n_here) in enumerate(ps.slabs):
            if i == 0:
                data, n_dev, n_valid = _fused_build(
                    stream, s_arr, e_arr, nk_pad, self.cfg, self.canonical
                )
                # the memo shares `data`: nothing updates it in place
                ps._words[i] = (data, n_valid)
                ws.adopt_built(data, n_dev, n_here)
            else:
                words, n_valid = _fused_words_sorted(
                    stream, s_arr, e_arr, nk_pad, self.cfg, self.canonical
                )
                ps._words[i] = (words, n_valid)
                ws._merge_into(words, n_new_upper=n_here)

    def remove_codes_stream(self, codes, offsets: np.ndarray | None = None):
        raise NotImplementedError(
            "remove_codes_stream needs the pending log (ROADMAP slice 3)"
        )

    def query_codes_stream(self, codes, offsets: np.ndarray | None = None,
                           lazy: bool = False):
        """(total k-mers, k-mers present) over a record stream (codes and
        offsets, or a PackedStream).  The counters add up on the device;
        with lazy=True they come back as unsynced device 0-d tensors,
        otherwise as ints after one sync.  An active slog is joined as it
        is (B3 + B4), never folded."""
        ws = self.wordset
        ps = self._resolve_stream(codes, offsets)
        total = positive = None
        for i, (nk_pad, stream, s_arr, e_arr, _) in enumerate(ps.slabs):
            cached = ps._words.get(i)
            if cached is not None:  # the memo holds sorted words
                t = cached[1]
                p = ws.count_hits_device(cached[0], words_sorted=True)
            else:
                words, t = _device_words(stream, s_arr, e_arr, nk_pad,
                                         self.cfg, self.canonical)
                p = ws.count_hits_device(words)
            total = t if total is None else total + t
            positive = p if positive is None else positive + p
        if total is None:
            zero = torch.zeros((), dtype=torch.int64, device=self.device)
            return (zero, zero) if lazy else (0, 0)
        if lazy:
            return total, positive
        t, p = torch.stack([total.to(torch.int64), positive]).tolist()
        return t, p

    def flush(self) -> None:
        """Fold an active sorted log into the static index."""
        self.wordset.flush()

    def dynamic_round(self, ins, qry, rm, lazy: bool = False):
        """One interleaved round: insert every k-mer of `ins`, count-query
        `qry` (it sees the inserts, not yet the removes), remove every
        k-mer of `rm`, over the sorted log (`_fused_round_slog`).  Args are
        PackedStreams or (codes, offsets) tuples of ONE slab each.
        Returns (total, positive) ints, or unsynced device 0-d tensors with
        lazy=True.

        A round enters on the index as it is (its keys become seq-0
        inserts), folds the log before its seq would pass 62, and commits
        its state only after it was enqueued.  Streams of several slabs
        (or none) raise NotImplementedError: `cbl_tpu` falls back to
        separate insert, query and remove calls there, which need the
        pending log (ROADMAP slice 3).  K=27 raises too: its words leave
        no room for the tag in one int64 key (slice 6)."""
        ws = self.wordset
        if not ws._slog_pack:
            raise NotImplementedError(
                f"dynamic_round at K={self.cfg.k}: the word and its 8-bit "
                "tag do not fit one int64 slog key; the unpacked layout "
                "with a tag column comes with multi-limb keys (ROADMAP "
                "slice 6)"
            )
        streams = [self._resolve_round_stream(x) for x in (ins, qry, rm)]
        for ps in streams:
            if len(ps.slabs) != 1:
                raise NotImplementedError(
                    f"dynamic_round takes streams of one slab, got "
                    f"{len(ps.slabs)}; other streams need the separate "
                    "insert/query/remove calls of the pending log "
                    "(ROADMAP slice 3)"
                )
        (w_i, _), (w_q, total), (w_r, _) = (
            self._sorted_slab_words(ps) for ps in streams
        )
        nk_i, nk_q, nk_r = (w.shape[0] for w in (w_i, w_q, w_r))
        if ws._slog_seq >= _SLOG_SEQ_MAX:
            ws._fold_slog()  # the 8-bit tag caps the round's seq at 62
        ws.maybe_autofold_slog()
        if ws._slog is not None:
            a, a_real = ws._slog, ws._slog_real
        elif ws._n_upper == 0:
            a = torch.empty(0, dtype=torch.int64, device=self.device)
            a_real = 0
        else:
            live = ws._live()
            # the index's keys enter as implicit seq-0 inserts (tag 1)
            a, a_real = slog_key(live, 1), min(ws._n_upper, live.shape[0])
        a_cap = a.shape[0]
        new_real = a_real + nk_i + nk_q + nk_r
        out_cap = a_cap if new_real <= a_cap else _quantize_cap(new_real)
        seq = ws._slog_seq + 1
        merged, positive, live_n = _fused_round_slog(a, seq, w_i, w_q, w_r,
                                                     out_cap)
        # commit state only after the round was enqueued (a failed launch
        # must not advance the log)
        ws._slog = merged
        ws._slog_seq = seq
        ws._slog_real = new_real
        ws._slog_count_dev = live_n  # free by-product of the round's scan
        ws._n_upper = min(ws._n_upper + nk_i, out_cap)
        if lazy:
            return total, positive
        t, p = torch.stack([total.to(torch.int64), positive]).tolist()
        return t, p

    def _sorted_slab_words(self, ps: PackedStream):
        """(sorted words [nk_pad], n_valid) of a one-slab stream through
        the PackedStream memo: a stream whose words were computed before
        (its build, or an earlier round) is never run or sorted again."""
        cached = ps._words.get(0)
        if cached is None:
            nk_pad, stream, s_arr, e_arr, _ = ps.slabs[0]
            cached = _fused_words_sorted(stream, s_arr, e_arr, nk_pad,
                                         self.cfg, self.canonical)
            ps._words[0] = cached
        return cached

    def _resolve_round_stream(self, x) -> PackedStream:
        if isinstance(x, PackedStream):
            return self._resolve_stream(x, None)
        if isinstance(x, tuple):
            return self._resolve_stream(*x)
        raise TypeError(
            "dynamic_round takes PackedStreams or (codes, offsets) tuples"
        )
