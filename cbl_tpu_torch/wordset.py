"""DeviceWordSet: the k-mer word set as one sorted int64 key tensor.

Counterpart of the part of `cbl_tpu/wordset.py` that the static
build+query path uses.  The set is a sorted key tensor padded with
`SENTINEL` keys; after a bulk build it may hold duplicate keys (the
`_dups` state: one sort instead of two), while `_n_dev` counts DISTINCT
keys on the device.  The host keeps only an upper bound on the valid rows
(`_n_upper`), so building never waits for the device.

Queries are merge joins: both sides get a one-bit tag below the word
(data 1, query 0), the two sorted runs are merged by kernel B3, and a
query row is a hit when a data row follows it within its word's run.

Interleaved dynamic rounds keep the set as a (word, tag)-sorted log, the
"slog" (`_slog`, one int64 key per row, see `slog_key`): inserts, queries
and removes of a round are merged in with their tags, and kernel B4 scans
the log once for the round's query hits and the distinct count.  The log
folds back into a sorted `data` tensor on `flush()`, at the tag's seq cap
and under the autofold policy, exactly as in `cbl_tpu`.

Not ported yet: the pending log, point operations, set algebra and
export (ROADMAP slices 3 to 5), and dynamic rounds at K=27 (slice 6).
"""

from __future__ import annotations

import torch

from .config import CBLConfig
from .limbs import SENTINEL, check_config
from .ops.scan import SLOG_TAG_MAX, slog_rows, slog_scan_counts
from .ops.sort import merge_sorted_pair, merge_with_unsorted, sort_keys

MIN_CAP = 4096


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n > 1 else 1


def _quantize_cap(n: int, frac_log: int = 3) -> int:
    """Capacity rounded up to a 1/8-power-of-two step, never below
    MIN_CAP and always a multiple of 4096 (`cbl_tpu.wordset._quantize_cap`:
    the slog's capacity family, on which `_slog_real`, the round's
    truncation and the autofold policy depend)."""
    if n <= MIN_CAP:
        return MIN_CAP
    k = max((n - 1).bit_length() - 1 - frac_log, 12)
    step = 1 << k
    return -(-n // step) * step


def resolve_device(device) -> torch.device:
    """torch.device of `device`; "cuda" needs a CUDA device (no CPU
    fallback) and gets the current device's index."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CBL(device='cuda') needs a CUDA device and none is available; "
            "pass device='cpu' for the plain tensor path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def sort_rows(keys: torch.Tensor) -> torch.Tensor:
    """Sort keys ascending (sentinels last)."""
    return sort_keys(keys)


def _valid_mask(keys: torch.Tensor) -> torch.Tensor:
    """True for non-sentinel keys."""
    return keys != SENTINEL


def _distinct_count(s: torch.Tensor) -> torch.Tensor:
    """Distinct valid keys of a sorted (duplicates adjacent) tensor, as an
    int64 0-d tensor."""
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    return (first & _valid_mask(s)).sum()


def _shift_tag(keys: torch.Tensor, tag: int) -> torch.Tensor:
    """Pack a one-bit operand tag below the word: (key << 1) | tag, which
    keeps sorted keys sorted.  Sentinels stay SENTINEL (a valid key is
    below 2^60, so a shifted one is below 2^61)."""
    return torch.where(keys == SENTINEL, SENTINEL, (keys << 1) | tag)


def _packed_join_count(s: torch.Tensor) -> torch.Tensor:
    """Hits over merged tagged keys: query rows (tag 0) whose word run holds
    a data row (tag 1), as an int64 0-d tensor.

    Runs get ids from a running sum of run starts; a scatter-add counts
    the data rows of each run, and a query row hits when its run's count
    is not zero.  (`cbl_tpu` takes a reverse running minimum of data run
    ids instead; `torch.cummin` on CUDA is a slow scan: 197 ms of a
    215 ms main path at 2^26 keys on an NVIDIA H100 80GB HBM3, 700 W.)
    Sentinel keys are odd, so they count as data, but only in their own
    run, and are masked."""
    is_data = (s & 1) == 1
    word = s >> 1
    run_start = torch.ones_like(s, dtype=torch.bool)
    run_start[1:] = word[1:] != word[:-1]
    run_id = torch.cumsum(run_start, 0) - 1
    data_in_run = torch.zeros(s.shape[0], dtype=torch.int32, device=s.device)
    data_in_run.index_add_(0, run_id, is_data.to(torch.int32))
    hits = ~is_data & (data_in_run[run_id] > 0) & _valid_mask(s)
    return hits.sum()


def _count_hits_merge_kernel(data: torch.Tensor, queries: torch.Tensor):
    """Hits of unsorted `queries` in sorted, contiguous `data`: sort the
    queries, merge (B3), scan."""
    s = merge_with_unsorted(_shift_tag(data, 1), _shift_tag(queries, 0))
    return _packed_join_count(s)


def _count_hits_merge_sorted_kernel(data: torch.Tensor, sorted_queries):
    """`_count_hits_merge_kernel` when the queries are already sorted (the
    stream's words memo after a build): one merge, no sort."""
    s = merge_sorted_pair(_shift_tag(data, 1), _shift_tag(sorted_queries, 0))
    return _packed_join_count(s)


def _merge_sortedbatch_kernel(data: torch.Tensor, batch: torch.Tensor):
    """Fold a sorted batch into the sorted index, keeping duplicates:
    (merged keys, distinct count)."""
    s = merge_sorted_pair(data, batch)
    return s, _distinct_count(s)


# --- the sorted log (slog) of dynamic rounds ---------------------------------
#
# A slog row is one int64 key, key = ((word - 2^55) << 8) | tag.  For
# every word below 2^56 it neither overflows nor changes order: keys sort
# exactly like `cbl_tpu`'s packed-tag limbs (word << 8) | tag read as
# unsigned (the bias only flips the sign bit).  `key >> 8` (arithmetic)
# is the word's run, `key & 0xFF` the tag, and the all-ones word with tag
# 0xFF, `cbl_tpu`'s sentinel row, is INT64_MAX, the port's SENTINEL, so
# sentinel rows need no special case in the merges.  Tags are
# (seq << 2) | typ with typ 1 insert, 2 query, 3 remove; 0xFF tags the
# queries of a slog join.  Query rows of the rounds stay in the log as
# inert rows until a fold.
_SLOG_BIAS = 1 << 55
# rounds run with seq = _slog_seq + 1, so a remove's tag (62 << 2) | 3 =
# 251 stays below 0xFF; at 63 it would pack to 0xFF and be ignored
_SLOG_SEQ_MAX = 62


def slog_packed(cfg: CBLConfig) -> bool:
    """True when a word and its 8-bit tag fit one slog key:
    n_bits + 8 <= 64, odd K <= 25 (`cbl_tpu.wordset.slog_packed`; K=27
    needs its unpacked layout with a tag column, ROADMAP slice 6).

    At n_bits = 56 (K=25) the all-ones word with tag 0xFF would equal the
    sentinel.  No valid word is all-ones: that needs pos = 2^pos_bits - 1,
    and pos < 2K <= 2^pos_bits - 1 because 2K is never a power of two for
    odd K.  Below 56 bits every word is below 2^55 and its keys negative."""
    if cfg.n_bits + 8 > 64:
        return False
    if cfg.n_bits + 8 == 64 and (1 << cfg.pos_bits) - 1 < 2 * cfg.k:
        raise ValueError(
            f"K={cfg.k}: an all-ones word would be a valid word and its "
            "slog query key would equal the sentinel"
        )
    return True


def slog_key(words: torch.Tensor, tag) -> torch.Tensor:
    """Slog keys of word keys with `tag` (an int or an int64 tensor below
    0xFF for a non-sentinel word); SENTINEL words stay SENTINEL."""
    return torch.where(words == SENTINEL, SENTINEL,
                       ((words - _SLOG_BIAS) << 8) | tag)


def slog_word(keys: torch.Tensor) -> torch.Tensor:
    """The word keys of non-sentinel slog keys (the tag dropped)."""
    return (keys >> 8) + _SLOG_BIAS


def _compact_sort_kernel(data: torch.Tensor, out_cap: int):
    """Sort so that sentinels fall to the end, then truncate or pad with
    SENTINEL to out_cap: (keys [out_cap], valid count).  The valid keys
    are unique and at most out_cap."""
    s = sort_keys(data)
    n = _valid_mask(s).sum()
    if out_cap <= s.shape[0]:
        return s[:out_cap], n
    pad = torch.full((out_cap - s.shape[0],), SENTINEL, dtype=torch.int64,
                     device=s.device)
    return torch.cat([s, pad]), n


def _slog_join_count(slog: torch.Tensor, words: torch.Tensor,
                     words_sorted: bool = False):
    """Hits of `words` against a slog without folding it: the queries get
    tag 0xFF (after every entry of their word), one merge (B3), one scan
    (B4).  A query row is a hit when its word is live there."""
    q = slog_key(words, SLOG_TAG_MAX)
    merge = merge_sorted_pair if words_sorted else merge_with_unsorted
    return slog_scan_counts(merge(slog, q), SLOG_TAG_MAX)[0]


def _slog_fold_kernel(slog: torch.Tensor, out_cap: int):
    """Fold a slog to a sorted index: keep the last row of each run whose
    last entry is an insert (as its word), make every other row SENTINEL,
    one compaction sort.  -> (keys [out_cap], distinct count).

    `cbl_tpu` reads that liveness off `_slog_scan`'s running max.  Here
    runs get ids from a running sum of run starts and a scatter-max finds
    each run's last entry row: `torch.cummax` on CUDA is a slow generic
    scan (268 ms of flush() + count() on the 84M-row log of the 32 Mbp
    dynamic workload, NVIDIA H100 80GB HBM3, 700 W).  Sentinel rows are
    never entries, so their run is never live."""
    run_start, _, is_entry, is_insert = slog_rows(slog)
    n = slog.shape[0]
    run_id = torch.cumsum(run_start, 0) - 1
    idx = torch.arange(n, dtype=torch.int64, device=slog.device)
    last = torch.full((n,), -1, dtype=torch.int64, device=slog.device)
    last.scatter_reduce_(0, run_id, torch.where(is_entry, idx, -1), "amax")
    run_live = (last >= 0) & is_insert[last.clamp(min=0)]
    keep = run_live[run_id]
    keep[:-1] &= run_start[1:]  # one row per run: its last
    return _compact_sort_kernel(
        torch.where(keep, slog_word(slog), SENTINEL), out_cap
    )


class DeviceWordSet:
    """A set of packed words as a sorted int64 tensor on one device."""

    def __init__(self, cfg: CBLConfig, device: torch.device):
        check_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.data = torch.full((MIN_CAP,), SENTINEL, dtype=torch.int64,
                               device=self.device)
        self._n_dev = None  # distinct count, device 0-d tensor (None = 0)
        self._n_host: int | None = 0
        self._n_upper = 0  # host upper bound on valid rows of `data`
        self.capacity = MIN_CAP
        # `data` is sorted and contiguous (valid keys, then sentinels); with
        # `_dups` it may hold duplicate keys
        self._dups = False
        # sorted-log state (dynamic rounds): while `_slog` is set it
        # REPLACES `data` as the set (data was merged into it on entry)
        # until `_fold_slog` runs.  `_slog_real` is a host upper bound on
        # its non-sentinel rows; capacities and the autofold depend only
        # on it, so rounds never wait for the device.
        self._slog: torch.Tensor | None = None
        self._slog_seq = 0
        self._slog_count_dev = None
        self._slog_real = 0
        self._slog_pack = slog_packed(cfg)

    @property
    def n(self) -> int:
        """Exact distinct count (waits for the device if one is pending)."""
        if self._n_host is None:
            self._n_host = int(self._n_dev)
            if not self._dups:
                self._n_upper = self._n_host
        return self._n_host

    def _live(self) -> torch.Tensor:
        """The prefix of `data` that can hold every valid key."""
        eff = min(self.data.shape[0], _next_pow2(max(self._n_upper, 1)))
        return self.data[:eff]

    def adopt_built(self, data: torch.Tensor, n_dev, n_upper: int) -> None:
        """Take a fused build's result: `data` sorted ascending, valid keys
        first (duplicates allowed), sentinel padded; `n_dev` = device count
        of DISTINCT keys; `n_upper` bounds the valid keys."""
        if self._n_upper != 0 or self._slog is not None:
            raise ValueError("adopt_built needs an empty word set")
        self.data = data
        self.capacity = data.shape[0]
        self._dups = True
        self._set_count(n_dev)
        self._n_upper = min(n_upper, self.capacity)

    def _merge_into(self, batch: torch.Tensor, n_new_upper: int) -> None:
        """Fold a SORTED batch into the set (keeping duplicates)."""
        if self._n_upper == 0:
            self.data, n_dev = batch, _distinct_count(batch)
        else:
            self.data, n_dev = _merge_sortedbatch_kernel(self._live(), batch)
        self.capacity = self.data.shape[0]
        self._dups = True
        self._n_dev = n_dev
        self._n_host = None
        self._n_upper += n_new_upper

    def _set_count(self, n_dev) -> None:
        self._n_dev = n_dev
        self._n_host = None
        self._n_upper = min(self._n_upper, self.capacity)

    def flush(self) -> None:
        """Fold an active slog into `data` (the port has no pending log)."""
        self._fold_slog()

    def _fold_slog(self) -> None:
        """Collapse an active slog into a clean sorted `data` (one
        compaction sort).  No-op when no slog is active."""
        if self._slog is None:
            return
        slog = self._slog
        self._slog = None
        self._slog_seq = 0
        self._slog_count_dev = None
        self._slog_real = 0
        out_cap = max(_next_pow2(max(self._n_upper, 1)), MIN_CAP)
        self.data, n_dev = _slog_fold_kernel(slog, out_cap)
        self.capacity = out_cap
        self._dups = False
        self._set_count(n_dev)

    # autofold policy (`cbl_tpu`'s, kept identical so that both fold in
    # the same rounds): the slog holds dead rows (overwritten inserts,
    # removes, query rows) that every later merge and scan pays for; fold
    # when its real-row bound exceeds FOLD_MULT x the live-set power-of-two
    # bound, or the hard cap (which bounds `cbl_tpu`'s int32 scan marker;
    # the port's marker is int64)
    _SLOG_FOLD_MULT = 4
    _SLOG_HARD_CAP = 1 << 27

    def maybe_autofold_slog(self) -> None:
        if self._slog is None:
            return
        live_cap = max(_next_pow2(max(self._n_upper, 1)), MIN_CAP)
        if (
            self._slog_real > self._SLOG_FOLD_MULT * live_cap
            or self._slog_real > self._SLOG_HARD_CAP
        ):
            self._fold_slog()
            # one scalar sync tightens _n_upper to the exact live count
            # (the fold's output has no duplicates); folds are rare
            _ = self.n

    def count(self) -> int:
        if self._slog is not None:
            return int(self._slog_count())
        return self.n

    def _slog_count(self):
        if self._slog_count_dev is None:
            # distinct live words: runs whose last entry is an insert
            self._slog_count_dev = slog_scan_counts(self._slog,
                                                    SLOG_TAG_MAX)[1]
        return self._slog_count_dev

    def count_device(self):
        """The distinct count as an unsynced device 0-d tensor; an active
        slog is counted by a scan (B4), not folded."""
        if self._slog is not None:
            return self._slog_count()
        if self._n_dev is None:
            return torch.zeros((), dtype=torch.int64, device=self.device)
        return self._n_dev

    def count_hits_device(self, words: torch.Tensor,
                          words_sorted: bool = False):
        """Stored words among `words` (SENTINEL rows ignored), as an
        unsynced int64 0-d tensor: a merge join with the index, or with an
        active slog without folding it.  `words_sorted` skips the sort of
        the query side."""
        if self._slog is not None:
            return _slog_join_count(self._slog, words, words_sorted)
        if words_sorted:
            return _count_hits_merge_sorted_kernel(self._live(), words)
        return _count_hits_merge_kernel(self._live(), words)

    def is_empty(self) -> bool:
        return self.count() == 0
