"""DeviceWordSet: the k-mer word set as one sorted tensor of int64 keys.

Counterpart of `cbl_tpu/wordset.py`.  The set is a sorted key tensor
padded with `SENTINEL` rows: [N] int64 keys for n_bits <= 60 (odd K <=
27), [2, N] two-column rows for wider words (K from 29 to 59; `limbs`),
and every function below takes either shape in one body (row slices
`x[..., a:b]`, `torch.where`, `limbs.first_of_run`).  After a bulk
build it may hold duplicate keys (the `_dups` state: one sort instead of
two), while `_n_dev` counts DISTINCT keys on the device.  The host keeps only an upper bound on the valid rows
(`_n_upper`), so building never waits for the device.

Queries of a clean index take one of two joins, whichever the bytes it
must move say (`_probe_cheaper`).  A merge join: both sides get a
one-bit tag below the word (data 1, query 0; `_shift_tag`: packed into
the key's low bit for one column, a third column for two), the two
sorted runs are merged by kernel B3, and a query row is a hit when a data
row follows it within its word's run; it moves every index row, a batch
as large as the index or larger pays for that.  A probe join: the sorted
queries are searched in the index (kernel B8, `ops.probe`) through a
sample of its rows built once when the index changes (`_search`): a few
sectors a query, nothing of the index's length, for an index much larger
than the batch.

Interleaved dynamic rounds keep the set as a (word, tag)-sorted log, the
"slog" (one int64 key a row where the word and an 8-bit tag fit one, see
`slog_key`; else the word's columns and a tag column, see
`slog_tagged`): inserts, queries and removes of a round are merged in
with their tags, and kernel B4 scans the log once for the round's query
hits and the distinct count.  `SortedLog` owns the log: its keys (one
tensor a shard), seq, real-row bound and live count, and every rule of
it (entry, seq cap, capacity, the round's merges and scan, commit, join,
count, fold); this module alone reads or writes them.  A word set runs a
round with `DeviceWordSet.round_words`, and the sharded index
(`parallel.ShardedCBL`) through the same object, its exchange between
tagging and merging.  The log folds back into a sorted `data` tensor on
`flush()`, at `cbl_tpu`'s seq cap (`slog_tag_in_limbs`) and under the
autofold policy, exactly as in `cbl_tpu`.

Separate insert and remove calls go through the pending log, as in
`cbl_tpu`: `pending` holds appended words and `pending_tags` their
(seq << 1) | op (1 insert, 0 remove), so a small batch costs an append and
not a merge with the whole index.  The log is sorted by (word, seqtag),
the word's columns and one more (the 23-bit seqtag does not fit beside a
56-bit word in one int64), and folds into `data` with last-write-wins on
`flush()`,
`count()` and overflow; queries join index and log without folding.

Set algebra (`union`, `intersection`, `difference`,
`symmetric_difference`, `merge_many`, `intersect_many`) never consumes its
operands.  Under a merge kernel (`ops.sort.use_merge_combine`) two
contiguous operands are combined by ONE merge: a union keeps duplicate
keys (`_dups`), and a marking operation makes the rows it drops SENTINEL
where they stand, which leaves the "holes" state (`_holes`: valid keys
ascending and unique, sentinel rows between them) with no compaction
sort.  Sort joins, folds and further merges take holes as they are; what
needs a contiguous prefix (a merge join, a dynamic round, the binary
search of a contains batch below `_SORTJOIN_MIN_QUERIES`) compacts first
(`_compact`, one sort).  In the "sort" merge mode every operation is a
tagged sort, adjacency marks and a compaction sort.

Ordered membership (`contains_words`) answers a batch of 2^17 queries or
more by a sort-join with the query position as a column after the word's
(`_contains_sortjoin_kernel`), which takes holes as they are, and a
smaller batch by a binary search of the compacted index
(`limbs.searchsorted`: `torch.searchsorted` for one column, a
lexicographic search for two).

Export (`words_array`, `iter_words_chunks`, `prefixes`) flushes,
compacts and drops duplicates first, as `cbl_tpu` does, and hands the
first n keys out as `cbl_tpu`'s [n, L] uint32 limb rows, laid out on the
device and copied once (`host_limbs`).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CBLConfig
from .limbs import (
    SENTINEL,
    check_config,
    cols,
    first_of_run,
    is_valid,
    key_cols,
    keys_to_limbs,
    major,
    rows_eq,
    searchsorted,
    sentinel_rows,
    stack,
)
from .necklace import word_prefix
from .ops.probe import probe_hits, search_layout
from .ops.scan import slog_counts, slog_is_packed, slog_query_tag, slog_rows
from .ops.sort import (
    cat_cols,
    merge_sorted_pair,
    merge_with_unsorted,
    sort_keys,
    use_merge_combine,
)
from .profiling import count, spanned, sync

MIN_CAP = 4096
DEFAULT_PENDING_CAP = 1 << 21
# seqtag of a query row in a log join: above every (seq << 1) | op, so a
# query sorts after every log entry of its word (`cbl_tpu`'s uint32 max)
_QUERY_SEQTAG = 0xFFFFFFFF


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n > 1 else 1


def _out_cap(upper: int) -> int:
    """The capacity of a compacted index of at most `upper` keys."""
    return max(MIN_CAP, _next_pow2(upper))


def _quantize_cap(n: int, frac_log: int = 3) -> int:
    """Capacity rounded up to a 1/8-power-of-two step, never below
    MIN_CAP and always a multiple of 4096 (`cbl_tpu.wordset._quantize_cap`:
    the slog's capacity family, on which `SortedLog.real`, the round's
    truncation and the autofold policy depend)."""
    if n <= MIN_CAP:
        return MIN_CAP
    k = max((n - 1).bit_length() - 1 - frac_log, 12)
    step = 1 << k
    return -(-n // step) * step


def host_limbs(keys: torch.Tensor, L: int) -> np.ndarray:
    """[N] (or [2, N]) int64 keys of valid words -> [N, L] uint32 limb
    rows on the host, laid out on the keys' device (`limbs.keys_to_limbs`) and
    copied once into pageable memory."""
    limbs = keys_to_limbs(keys, L)
    with sync("host_limbs"):
        return limbs.cpu().numpy().view(np.uint32)


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


# The sort and merge seam (`ops.sort`) takes a packed key tensor or a
# tuple of columns; word keys ([N] or [C, N]) cross it as `cols(keys)` and
# come back by `stack`, which copies nothing when a kernel made them.


@spanned("sort")
def sort_rows(keys: torch.Tensor) -> torch.Tensor:
    """Sort [N] or [C, N] keys ascending (sentinels last)."""
    return stack(sort_keys(cols(keys)))


def _merge_rows(sorted_keys: torch.Tensor, keys: torch.Tensor,
                keys_sorted: bool = True) -> torch.Tensor:
    """Merge sorted [N] or [C, N] keys with more keys, sorted or not."""
    merge = merge_sorted_pair if keys_sorted else merge_with_unsorted
    return stack(merge(cols(sorted_keys), cols(keys)))


# True for non-sentinel rows; True where a sorted row differs from the one
# before it (one column or two)
_valid_mask = is_valid
_first_of_run = first_of_run


# rows a distinct count reads at once: `sum` of a boolean mask casts it to
# int64 first, 8 bytes a row, so a count over a whole index of 3.1e9 rows
# would take 25 GB beside it
_COUNT_ROWS = 1 << 28


def _new_keys(s: torch.Tensor, lo: int, rows: int) -> torch.Tensor:
    """[<= rows] bool over rows lo .. lo + rows - 1 of a sorted tensor:
    True where a valid key differs from the row before it, across the
    block's first edge too."""
    blk = s[..., lo : lo + rows]
    new = _first_of_run(blk) & _valid_mask(blk)
    if lo:
        new[:1] &= ~rows_eq(s[..., lo - 1 : lo], blk[..., :1])
    return new


def _distinct_count(s: torch.Tensor) -> torch.Tensor:
    """Distinct valid keys of a sorted (duplicates adjacent) tensor, as an
    int64 0-d tensor, `_COUNT_ROWS` rows at a time."""
    total = None
    for lo in range(0, max(s.shape[-1], 1), _COUNT_ROWS):
        c = _new_keys(s, lo, _COUNT_ROWS).sum()
        total = c if total is None else total + c
    return total


def _run_ids(run_start: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """A run id per row of a sorted tensor, for the scatters that reduce
    over runs: a running sum of run starts.  Sentinel rows sort last and
    form ONE run, millions of rows long in an index padded to its
    capacity, and a scatter would pile that many atomic updates onto one
    address (17 ms instead of 3 for an `index_add_` over 2^26 rows with
    47 million sentinels, NVIDIA H100 80GB HBM3, 700 W).  Each of them
    gets its own position as id instead: it lies beyond every valid run's
    id, and nothing reads a sentinel row's result."""
    run_id = torch.cumsum(run_start, 0) - 1
    pos = torch.arange(run_start.shape[0], dtype=torch.int64,
                       device=run_start.device)
    return torch.where(valid, run_id, pos)


def _shift_tag(keys: torch.Tensor, tag: int):
    """Put a one-bit operand tag below the word, which keeps sorted rows
    sorted.  One column: (key << 1) | tag, packed; sentinels stay SENTINEL
    (a valid key is below 2^60, so a shifted one is below 2^61).  Two
    columns: the tag as a third column, a tuple of columns (`cbl_tpu`'s
    tag column; column 0 of a shifted K=59 word could reach INT64_MAX)."""
    if keys.dim() == 1:
        return torch.where(keys == SENTINEL, SENTINEL, (keys << 1) | tag)
    return (keys[0], keys[1], torch.full_like(keys[1], tag))


def _untag(s):
    """(words, tag == 1, valid) of sorted rows tagged by `_shift_tag`: a
    packed key tensor, or a tuple of columns with the tag last."""
    if isinstance(s, torch.Tensor):
        return s >> 1, (s & 1) == 1, s != SENTINEL
    words = stack(s[:-1])
    return words, s[-1] == 1, _valid_mask(words)


def _query_hits(run_start: torch.Tensor, valid: torch.Tensor,
                is_data: torch.Tensor):
    """(hit [n], run_id [n]) over sorted join rows: a valid query row hits
    when its word's run holds a data row.

    Runs get ids from a running sum of run starts (`_run_ids`); a
    scatter-add counts the data rows of each run, and a query row hits
    when its run's count is not zero.  (`cbl_tpu` takes running minima
    and maxima of data run ids instead; `torch.cummin` on CUDA is a slow
    scan: 197 ms of a 215 ms main path at 2^26 keys on an NVIDIA H100
    80GB HBM3, 700 W.)"""
    run_id = _run_ids(run_start, valid)
    data_in_run = torch.zeros(run_start.shape[0], dtype=torch.int32,
                              device=run_start.device)
    data_in_run.index_add_(0, run_id, is_data.to(torch.int32))
    return ~is_data & (data_in_run[run_id] > 0) & valid, run_id


def _packed_join_count(s) -> torch.Tensor:
    """Hits over merged tagged rows: query rows (tag 0) whose word run
    holds a data row (tag 1), as an int64 0-d tensor.  Packed sentinel
    keys are odd, so they count as data, but only in their own runs
    (`_run_ids`), and are masked."""
    words, is_data, valid = _untag(s)
    hits, _ = _query_hits(_first_of_run(words), valid, is_data)
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


# What a join of Q query rows with an index of N rows moves through
# device memory, in bytes a row of 8-byte keys (`_probe_cheaper`).  Both
# joins sort the queries first; that sort is left out of both.
#
# The merge join (`_count_hits_merge_kernel`), a row of index and queries
# alike: the tag shift 58 (`==`, `<<`, `|`, `where`), B3 16 (one read, one
# write), the untag 50 (`>>`, `&`, `==`, `!=`), the run starts 20, the hit
# scan 110 (`_run_ids`' cumsum, arange and where, the scatter-add and its
# gather, the masks and the sum).
_MERGE_JOIN_ROW_BYTES = 58 + 16 + 50 + 20 + 110
# The probe join (`_count_hits_probe_kernel`), a query row: the row read
# once, then one 32-byte sector a level of a binary search over the
# index, the last two levels in one sector.  Reckoned with nothing
# cached, as for an index far larger than the L2; B8's sample and block
# windows let caches serve the upper levels, which this does not credit,
# so against an index that fits the L2 the rule favours the merge join.
_SECTOR_BYTES = 32


def _join_bytes(n_index: int, n_queries: int, n_cols: int = 1) -> tuple:
    """(merge join bytes, probe join bytes) of a join of `n_queries` rows
    with an index of `n_index` rows of `n_cols` key columns (above)."""
    merge = _MERGE_JOIN_ROW_BYTES * n_cols * (n_index + n_queries)
    levels = max((max(n_index, 1) - 1).bit_length() - 2, 0)
    probe = n_queries * n_cols * (8 + _SECTOR_BYTES * levels)
    return merge, probe


def _probe_cheaper(n_index: int, n_queries: int, n_cols: int = 1) -> bool:
    """True when the probe join moves fewer bytes than the merge join
    (`_join_bytes`).  At a batch of 2^24 rows the probe wins from an index
    of 2^25 rows: a read batch against a bacterial genome's index (8.4M
    rows) merges, against a human genome's (3.1e9) it probes.

    Provisional: the byte counts are reckoned from the joins' operations,
    not fitted to timings, and the timings disagree with them.  On an
    H100 (`chip_smoke.py`'s `join_sweep`: a 2^24-row batch of sorted
    words, one column) the probe join is the faster at every index size
    from 2^16 to 2^29 rows: 0.19 against 2.18 ms at 2^16, 0.25 against
    2.90 at 2^23, 0.27 against 3.82 at 2^24, 0.71 against 60.6 at 2^29.
    The merge join of a clean index stays only while the benchmark cell
    `k25_p24.query_reads` lists B3 among the kernels its window must
    launch; once it does not, B8 becomes the one join of a clean index
    and this rule goes."""
    merge, probe = _join_bytes(n_index, n_queries, n_cols)
    return probe < merge


def _count_hits_probe_kernel(data: torch.Tensor, sample: tuple,
                             stride_log: int, queries: torch.Tensor,
                             queries_sorted: bool = False,
                             n_valid: int | None = None):
    """Hits of `queries` in sorted, contiguous `data` (duplicates allowed)
    through its search layout (`ops.probe.search_layout`: the columns
    `sample` of every 2^stride_log-th row): sort the queries, then one
    search a row (kernel B8; `n_valid` the queries' valid rows, for its
    counters).  No tensor of the index's length is made."""
    if not queries_sorted:
        queries = sort_rows(queries)
    return probe_hits(cols(data), sample, stride_log, cols(queries),
                      n_valid)


def _merge_sortedbatch_kernel(data: torch.Tensor, batch: torch.Tensor):
    """Fold a sorted batch into the sorted index, keeping duplicates:
    (merged keys, distinct count)."""
    s = _merge_rows(data, batch)
    return s, _distinct_count(s)


def _merge_keepdups_kernel(data: torch.Tensor, batch: torch.Tensor):
    """`_merge_sortedbatch_kernel` for an unsorted batch: sort it, then
    one merge."""
    s = _merge_rows(data, batch, keys_sorted=False)
    return s, _distinct_count(s)


def _build_sorted_kernel(batch: torch.Tensor):
    """Sort a fresh batch and count its distinct keys (insert into an
    empty index)."""
    s = sort_rows(batch)
    return s, _distinct_count(s)


def _compact_marked(words: torch.Tensor, keep: torch.Tensor, out_cap: int):
    """Make every row that is not kept SENTINEL, compact by one sort, fit
    to out_cap: (keys [out_cap], kept count).  Neither `words` nor the
    marked rows are held past their use: a fold passes the words of a
    whole log (2^27 rows) as a temporary, freed before the sort."""
    marked = torch.where(keep, words, SENTINEL)
    del words
    s = sort_rows(marked)
    del marked
    return _fit(s, out_cap), keep.sum()


def _dedup_sorted_kernel(data: torch.Tensor, out_cap: int):
    """Drop the duplicates of a sorted tensor (valid keys first): mark
    them SENTINEL, one sort, fit to out_cap."""
    return _compact_marked(data, _valid_mask(data) & _first_of_run(data),
                           out_cap)


def _merge_sortcompact_kernel(data: torch.Tensor, batch: torch.Tensor,
                              out_cap: int):
    """Union of the index and a batch without duplicates: one sort of
    both, duplicates and sentinels marked, one compaction sort."""
    s = sort_rows(torch.cat([data, batch], dim=-1))
    return _compact_marked(s, _valid_mask(s) & _first_of_run(s), out_cap)


def _setop_keep(s, op: str):
    """(words, keep) over sorted tagged rows (`_shift_tag`) with tag 1
    for a-rows and 0 for b-rows: b-rows come first among equal words, so
    "the key before me holds my word" tells an a-row that its word is in
    b.  Which rows an operation keeps:
      union    the first row of each word (b may hold duplicates)
      remove   (alias diff) a-rows that start their word's run: a minus b
               (b may hold duplicates and sentinels; duplicates in a drop)
      inter    a-rows with a row of their word before them (no duplicates)
      symdiff  rows alone in their word's run (no duplicates)"""
    word, is_a, valid = _untag(s)
    first = _first_of_run(word)
    if op == "union":
        keep = first
    elif op in ("remove", "diff"):
        keep = is_a & first
    elif op == "inter":
        keep = is_a & ~first
    elif op == "symdiff":
        keep = first.clone()
        keep[:-1] &= first[1:]
    else:
        raise ValueError(f"unknown set operation {op!r}")
    return word, keep & valid


def _setop_sort_kernel_packed(a: torch.Tensor, b: torch.Tensor, op: str,
                              out_cap: int):
    """A binary set operation (`_setop_keep`) as one tagged sort,
    adjacency marks and a compaction sort (`cbl_tpu`'s kernel of the same
    name): (keys [out_cap], kept count).  Neither side needs to be sorted
    or contiguous.  (`cbl_tpu` also has an unpacked variant with a tag
    column for words that fill their uint32 limbs, K=13 and K=29; here a
    one-column key always has the spare bit and two columns always take
    the tag column, so this one body serves both.)"""
    s = sort_keys(cat_cols(_shift_tag(a, 1), _shift_tag(b, 0)))
    return _compact_marked(*_setop_keep(s, op), out_cap)


def _union_merge_kernel(a: torch.Tensor, b: torch.Tensor):
    """Union of two sorted, contiguous operands in ONE merge, duplicate
    keys kept (a `_dups` state): (merged keys, distinct count)."""
    s = _merge_rows(a, b)
    return s, _distinct_count(s)


def _setop_merge_kernel(a: torch.Tensor, b: torch.Tensor, op: str):
    """inter / diff / symdiff of two sorted, contiguous operands in ONE
    merge of the tagged runs (shifted keys stay sorted) and adjacency
    marks; rows that are not kept become SENTINEL where they stand, so
    the result has holes and no compaction sort is paid:
    (keys [|a| + |b|], kept count)."""
    s = merge_sorted_pair(_shift_tag(b, 0), _shift_tag(a, 1))
    word, keep = _setop_keep(s, op)
    return torch.where(keep, word, SENTINEL), keep.sum()


def _merge_sortmark_kernel(data: torch.Tensor, batch: torch.Tensor):
    """Union of an index with holes and a batch in ONE sort: duplicates
    become SENTINEL where they stand, which leaves holes again:
    (keys [|data| + |batch|], distinct count)."""
    s = sort_rows(torch.cat([data, batch], dim=-1))
    keep = _valid_mask(s) & _first_of_run(s)
    return torch.where(keep, s, SENTINEL), keep.sum()


def _count_hits_kernel_packed(data: torch.Tensor, queries: torch.Tensor):
    """Hits of `queries` in `data` by one tagged sort of both: the join
    for an index with holes (or in any order)."""
    s = sort_keys(cat_cols(_shift_tag(data, 1), _shift_tag(queries, 0)))
    return _packed_join_count(s)


def _contains_kernel(data: torch.Tensor, queries: torch.Tensor):
    """[Q] bool: which queries are rows of sorted, contiguous `data`
    (duplicates allowed); SENTINEL queries are False.  `limbs.searchsorted`
    (`torch.searchsorted`, or a lexicographic binary search for two
    columns) stands for `cbl_tpu`'s hand-rolled binary search (plain XLA
    there, no kernel) and for its radix-window table, which answers the
    same question."""
    n = data.shape[-1]
    idx = searchsorted(data, queries)
    found = rows_eq(data[..., idx.clamp(max=n - 1)], queries)
    return (idx < n) & found & _valid_mask(queries)


# --- the pending log ---------------------------------------------------------
#
# Appended rows carry seqtag = (seq << 1) | op with seq = 1 + the row's
# place in the log and op 1 insert, 0 remove; index rows count as seqtag 1
# (an insert before every log entry).  Sorted by (word, seqtag), the last
# row of a word's run decides whether the word is in the set.  SENTINEL
# words (blanked k-mers, unused slots) are ignored everywhere.


def _fold_keep_mask(words, seqtag: torch.Tensor):
    """Last-write-wins over (word, seqtag)-sorted rows: keep the LAST row
    of each word's run when its op bit says insert (which also drops
    duplicates); never a SENTINEL row."""
    last_of_run = torch.ones_like(seqtag, dtype=torch.bool)
    last_of_run[:-1] = _first_of_run(words)[1:]
    return _valid_mask(words) & last_of_run & ((seqtag & 1) == 1)


def _index_cols(data: torch.Tensor):
    """The index as (word, seqtag) rows: seqtag 1 everywhere, so sorted
    `data` is sorted in every column."""
    return (*cols(data), torch.ones_like(major(data)))


def _log_cols(pending: torch.Tensor, tags: torch.Tensor):
    """The log as (word, seqtag) rows."""
    return (*cols(pending), tags)


def _fold_log_kernel(data: torch.Tensor, pending: torch.Tensor,
                     tags: torch.Tensor, out_cap: int):
    """Fold a log of inserts and removes into the index with one sort of
    index and log by (word, seqtag): (keys [out_cap], distinct count).
    `data` may be in any order."""
    s = sort_keys(cat_cols(_index_cols(data), _log_cols(pending, tags)))
    words = stack(s[:-1])
    return _compact_marked(words, _fold_keep_mask(words, s[-1]), out_cap)


def _fold_log_merge_kernel(data: torch.Tensor, pending: torch.Tensor,
                           tags: torch.Tensor, out_cap: int):
    """`_fold_log_kernel` for sorted, contiguous `data`: sort only the
    log, then one merge (B3 on two or three columns)."""
    s = merge_with_unsorted(_index_cols(data), _log_cols(pending, tags))
    words = stack(s[:-1])
    return _compact_marked(words, _fold_keep_mask(words, s[-1]), out_cap)


def _last_entry_of_runs(run_start: torch.Tensor, valid: torch.Tensor,
                        is_entry: torch.Tensor):
    """(run_id [n], last [n]) over sorted rows: each row's run id
    (`_run_ids`), and per run id the row of the run's last entry (-1 when
    it has none).

    `cbl_tpu` finds the latest entry at or before each row with `cummax`
    scans.  `torch.cummax` on CUDA is a slow generic scan (268 ms over 84M
    rows on an NVIDIA H100 80GB HBM3, 700 W), and the rows that ask sort
    after every entry of their word, so the run's last entry is the one
    they need: a scatter-max over run ids finds it."""
    n = run_start.shape[0]
    run_id = _run_ids(run_start, valid)
    idx = torch.arange(n, dtype=torch.int64, device=run_start.device)
    last = torch.full((n,), -1, dtype=torch.int64, device=run_start.device)
    last.scatter_reduce_(0, run_id, torch.where(is_entry, idx, -1), "amax")
    return run_id, last


def _log_join_count(words, seqtag: torch.Tensor):
    """Hits over (word, seqtag)-sorted rows of index, log and queries: a
    query row (seqtag `_QUERY_SEQTAG`, last in its word's run) hits when
    the run's last entry has the insert bit.  int64 0-d tensor."""
    valid = _valid_mask(words)
    is_query = seqtag == _QUERY_SEQTAG
    run_id, last = _last_entry_of_runs(_first_of_run(words), valid,
                                       ~is_query & valid)
    run_live = (last >= 0) & ((seqtag[last.clamp(min=0)] & 1) == 1)
    return (is_query & valid & run_live[run_id]).sum()


def _query_cols(queries: torch.Tensor):
    return (*cols(queries), torch.full_like(major(queries), _QUERY_SEQTAG))


def _count_hits_log_kernel(data, pending, tags, queries):
    """Hits of `queries` against `data` and the pending log WITHOUT
    folding: one sort of all three by (word, seqtag).  `data` may hold
    holes."""
    s = sort_keys(cat_cols(_index_cols(data), _log_cols(pending, tags),
                           _query_cols(queries)))
    return _log_join_count(stack(s[:-1]), s[-1])


def _count_hits_log_merge_kernel(data, pending, tags, queries):
    """`_count_hits_log_kernel` for sorted, contiguous `data`: sort log
    and queries by (word, seqtag), then one merge with the index (two or
    three columns)."""
    s = merge_with_unsorted(_index_cols(data), cat_cols(
        _log_cols(pending, tags), _query_cols(queries)))
    return _log_join_count(stack(s[:-1]), s[-1])


# a contains batch of this many queries or more joins by a sort and
# leaves an index with holes as it is; a smaller one compacts and searches
# (`cbl_tpu`'s threshold, which decides when an index is compacted; read
# at call time)
_SORTJOIN_MIN_QUERIES = 1 << 17
# data rows of the sort-join scatter their (false) answers over this many
# spare slots past the queries, so that no slot takes millions of stores
_SORTJOIN_SPILL = 1 << 16


def _sortjoin_rows(data: torch.Tensor, queries: torch.Tensor,
                   holes: bool):
    """The sort-join's rows, sorted: (word, position) rows, the word's
    columns and one more, data rows at position Q, query rows at their
    index, so that a word's data rows sort after its queries.  For a
    contiguous index (`holes` False) the queries are sorted and merged
    with it (B3, B7 under the "bitonic" merge mode); else one sort of
    both sides."""
    n_q = queries.shape[-1]
    d = (*cols(data), torch.full_like(major(data), n_q))
    q = (*cols(queries), torch.arange(n_q, dtype=torch.int64,
                                      device=queries.device))
    if holes:
        return sort_keys(cat_cols(d, q))
    return merge_with_unsorted(d, q)


def _contains_sortjoin_kernel(data: torch.Tensor, queries: torch.Tensor,
                              holes: bool) -> torch.Tensor:
    """[Q] bool: which queries are keys of `data`, in query order;
    SENTINEL queries are False.  Duplicate keys in `data` are tolerated,
    and so are holes when `holes` is True; nothing is compacted.

    A query row of the sorted rows (`_sortjoin_rows`) hits when its
    word's run holds a data row (`_query_hits`), and a scatter by
    position puts the answers back in query order, where `cbl_tpu` sorts
    by position once more."""
    n_q = queries.shape[-1]
    rows = _sortjoin_rows(data, queries, holes)
    words, pos = stack(rows[:-1]), rows[-1]
    is_data = pos == n_q
    hit, run_id = _query_hits(_first_of_run(words), _valid_mask(words),
                              is_data)
    dest = torch.where(is_data, n_q + (run_id & (_SORTJOIN_SPILL - 1)), pos)
    out = torch.zeros(n_q + _SORTJOIN_SPILL, dtype=torch.bool,
                      device=queries.device)
    return out.scatter_(0, dest, hit)[:n_q]


_QPOS_BITS = 31  # query positions ride below the seqtag in column 1


def _pending_override_kernel(pending, tags, queries):
    """What the unfolded log says about each query: (has [Q] bool, present
    [Q] bool).  `has` marks queries whose word the log mentions, `present`
    its last logged op (True = insert).

    One sort of log and queries by (word, seqtag, query position), the
    last two packed into the column after the word's as
    (seqtag << 31) | position; the run's
    last entry decides; a one-column sort by position restores the query
    order (log rows carry position Q and fall off the end)."""
    n_log, n_q = pending.shape[-1], queries.shape[-1]
    if n_q >= 1 << _QPOS_BITS:
        raise ValueError(f"{n_q} queries do not fit {_QPOS_BITS} bits")
    dev = queries.device
    seqtag = torch.cat([tags, torch.full_like(major(queries),
                                              _QUERY_SEQTAG)])
    qpos = torch.cat([
        torch.full((n_log,), n_q, dtype=torch.int64, device=dev),
        torch.arange(n_q, dtype=torch.int64, device=dev),
    ])
    rows = sort_keys((*cols(torch.cat([pending, queries], dim=-1)),
                      (seqtag << _QPOS_BITS) | qpos))
    words, minor = stack(rows[:-1]), rows[-1]
    seqtag = minor >> _QPOS_BITS
    valid = _valid_mask(words)
    run_id, last = _last_entry_of_runs(_first_of_run(words), valid,
                                       (seqtag != _QUERY_SEQTAG) & valid)
    run_has = last >= 0
    run_present = run_has & ((seqtag[last.clamp(min=0)] & 1) == 1)
    answer = (run_has[run_id].to(torch.int64) << 1) | run_present[run_id]
    qpos = minor & ((1 << _QPOS_BITS) - 1)
    ordered = sort_keys((qpos << 2) | answer)[:n_q]
    return (ordered & 2) != 0, (ordered & 1) != 0


# --- the sorted log (slog) of dynamic rounds ---------------------------------
#
# Rows carry the tag (seq << 2) | typ, typ 1 insert, 2 query, 3 remove,
# and sort by (word, tag).  Query rows of the rounds stay in the log as
# inert rows until a fold.  The log has one of two layouts:
#
# - packed (`slog_packed`): one int64 key a row, key = ((word - 2^55) << 8)
#   | tag.  For every word below 2^56 it neither overflows nor changes
#   order: keys sort exactly like `cbl_tpu`'s packed-tag limbs (word << 8)
#   | tag read as unsigned (the bias only flips the sign bit).  `key >> 8`
#   (arithmetic) is the word's run, `key & 0xFF` the tag, and the all-ones
#   word with tag 0xFF, `cbl_tpu`'s sentinel row, is INT64_MAX, the port's
#   SENTINEL, so sentinel rows need no special case in the merges.  0xFF
#   tags the queries of a slog join;
# - tag column (every other config): a [C, N] int64 tensor, the word's one
#   or two columns and then the tag, C = 2 or 3 (`cbl_tpu`'s pack=False,
#   L word limbs and a tag column).  The tag has no 8-bit limit;
#   INT64_MAX, `cbl_tpu`'s 0xFFFFFFFF, tags join queries and sentinel
#   rows, which are INT64_MAX in every column.
#
# The seq cap is `cbl_tpu`'s, whatever the port's layout: it folds before
# seq 63 where it packs its tag into the word limbs (`slog_tag_in_limbs`);
# rounds run with seq = `SortedLog.seq` + 1, so a remove's tag
# (62 << 2) | 3 = 251 stays below 0xFF, and at 63 it would pack to 0xFF
# and be ignored.
_SLOG_BIAS = 1 << 55
_SLOG_SEQ_MAX = 62


def slog_tag_in_limbs(cfg: CBLConfig) -> bool:
    """`cbl_tpu.wordset.slog_packed`: True where `cbl_tpu` packs the 8-bit
    tag into the word's uint32 limbs, n_bits + 8 <= 32 L (odd K 1-9,
    15-25, 31-39 and 45-55).  Its rounds fold before seq 63 there, and so
    do the port's, whatever the port's own layout."""
    return cfg.n_bits + 8 <= 32 * cfg.word_limbs


def slog_packed(cfg: CBLConfig) -> bool:
    """True when the port's slog is one int64 key a row: the word and its
    8-bit tag fit one (n_bits + 8 <= 64) and `cbl_tpu` packs its tag too
    (`slog_tag_in_limbs`), odd K 1-9 and 15-25.  At K=11 and 13 the key
    would fit, but `cbl_tpu` keeps a tag column and runs past seq 62, where
    an 8-bit tag cannot go; those K, and K >= 27, take the tag column.

    At n_bits = 56 (K=25) the all-ones word with tag 0xFF would equal the
    sentinel.  No valid word is all-ones: that needs pos = 2^pos_bits - 1,
    and pos < 2K <= 2^pos_bits - 1 because 2K is never a power of two for
    odd K.  Below 56 bits every word is below 2^55 and its keys negative."""
    if cfg.n_bits + 8 > 64 or not slog_tag_in_limbs(cfg):
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


def slog_tagged(words: torch.Tensor, tag, packed: bool) -> torch.Tensor:
    """Slog rows of [N] or [2, N] word keys with `tag` (an int or an int64
    tensor): packed keys (`slog_key`), or the word's columns and a tag
    column, [C, N]; sentinel words stay sentinel rows."""
    if packed:
        return slog_key(words, tag)
    tags = torch.where(_valid_mask(words),
                       torch.as_tensor(tag, device=words.device), SENTINEL)
    return torch.stack([*cols(words), tags])


def slog_words(slog: torch.Tensor) -> torch.Tensor:
    """The word keys of a slog's non-sentinel rows, [N] or [2, N]."""
    if slog_is_packed(slog):
        return slog_word(slog)
    return stack(cols(slog)[:-1])


def _fit(s: torch.Tensor, out_cap: int) -> torch.Tensor:
    """Truncate, or pad with SENTINEL rows, to out_cap rows."""
    n = s.shape[-1]
    if out_cap <= n:
        return s[..., :out_cap]
    pad = sentinel_rows(out_cap - n, len(cols(s)), s.device)
    return torch.cat([s, pad], dim=-1)


def _slog_fold_kernel(slog: torch.Tensor, out_cap: int):
    """Fold a slog to a sorted index: keep the last row of each run whose
    last entry is an insert (as its word), make every other row SENTINEL,
    one compaction sort.  -> (keys [out_cap], distinct count).

    `cbl_tpu` reads that liveness off `_slog_scan`'s running max; here a
    scatter-max finds each run's last entry (`_last_entry_of_runs`: 24 ms
    instead of 270 for flush() + count() on the 84M-row log of the 32 Mbp
    dynamic workload, NVIDIA H100 80GB HBM3, 700 W).  Sentinel rows are
    never entries, so their runs are never live."""
    run_start, _, is_entry, is_insert, _ = slog_rows(slog)
    run_id, last = _last_entry_of_runs(run_start, _valid_mask(slog), is_entry)
    run_live = (last >= 0) & is_insert[last.clamp(min=0)]
    keep = run_live[run_id]
    keep[:-1] &= run_start[1:]  # one row per run: its last
    return _compact_marked(slog_words(slog), keep, out_cap)


def _merge_slog(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two sorted slogs of one layout (B3, or B7 under "bitonic")."""
    return stack(merge_sorted_pair(cols(a), cols(b)))


@spanned("join")
def _fused_round_slog(slog: "SortedLog", logs: list, ins, qry, rm,
                      real: int, out_cap: int) -> list:
    """One interleaved round over the sorted log of one device
    (`cbl_tpu.cbl._fused_round_slog_fn`): `SortedLog.tag`, then
    `SortedLog.merge`, with no exchange between them."""
    return slog.merge(logs, slog.tag(ins, qry, rm), real, out_cap)


class SortedLog:
    """The sorted log of dynamic rounds, and the one owner of its state
    and rules.

    `keys` holds one log a shard ([S] packed keys or [C, S] rows, every
    shard's of capacity S; a word set is one shard), or None while no log
    is active; while one is, it REPLACES the index as the set, until
    `fold`.  `seq` (the last round's) and `real` (a host bound on a
    shard's non-sentinel rows, on which capacities and the autofold
    depend, so rounds never wait for the device) are shared by the
    shards; `live` is the distinct live words, an int64 0-d tensor (the
    round's scan gives it for free), or None where not yet counted.
    `packed` is the layout (one key a row, `slog_packed`, or a tag
    column) and `capped` whether rounds fold before seq 63
    (`slog_tag_in_limbs`, where `cbl_tpu` does).

    A round is `begin` (the index entered where no log is active, the
    capacity), `tag` (each shard's three sorted streams tagged and
    combined; a sharded index exchanges the batches here) and `merge`
    (merged into each log, fit, scanned once, then committed)."""

    # autofold policy (`cbl_tpu`'s, kept identical so that both fold in
    # the same rounds): the log holds dead rows (overwritten inserts,
    # removes, query rows) that every later merge and scan pays for; fold
    # when its real-row bound exceeds FOLD_MULT x the live-set
    # power-of-two bound, or the hard cap (which bounds `cbl_tpu`'s int32
    # scan marker; the port's marker is int64)
    FOLD_MULT = 4
    HARD_CAP = 1 << 27

    def __init__(self, cfg: CBLConfig, keys: list | None = None,
                 seq: int = 0, real: int = 0, live=None):
        self.packed = slog_packed(cfg)
        self.capped = slog_tag_in_limbs(cfg)
        self.keys = keys
        self.seq = seq
        self.real = real
        self.live = live

    def at_seq_cap(self) -> bool:
        """True when the next round would pass seq 62 where `cbl_tpu`'s
        8-bit tag caps it: the log must fold first."""
        return self.capped and self.seq >= _SLOG_SEQ_MAX

    def autofold_due(self, live_cap: int) -> bool:
        """The autofold policy, for a set whose live keys a compacted
        index of `live_cap` rows holds."""
        return self.keys is not None and (
            self.real > self.FOLD_MULT * live_cap
            or self.real > self.HARD_CAP)

    def begin(self, added: int, entry: tuple | None = None) -> tuple:
        """(logs, real, out_cap) of the next round, nothing committed: the
        active logs and their bound, or where no log is active `entry`,
        (the index's keys a shard, sorted; their real-row bound), whose
        keys enter as implicit seq-0 inserts (tag 1); the bound grown by
        the round's `added` rows, and the capacity kept while it holds
        them, else the bound quantized (`_quantize_cap`)."""
        if self.keys is not None:
            logs, real = self.keys, self.real
        else:
            keys, real = entry
            logs = [slog_tagged(k, 1, self.packed) for k in keys]
        real += added
        cap = logs[0].shape[-1]
        return logs, real, cap if real <= cap else _quantize_cap(real)

    def tag(self, ins: list, qry: list, rm: list) -> list:
        """Each shard's three PRE-SORTED word streams tagged with
        (seq << 2) | {1 insert, 2 query, 3 remove} for the next seq
        (`slog_tagged` in the log's layout: each stays sorted, sentinel
        rows stay sentinel, at the end) and combined by two small merges
        into one sorted batch a shard.

        The tags make the reference's sequential semantics a property of
        the order: a round's queries sort after its inserts and before its
        removes, and the scan honours only entries at or before each
        query."""
        base = (self.seq + 1) << 2
        out = []
        for w_i, w_q, w_r in zip(ins, qry, rm):
            b = _merge_slog(slog_tagged(w_i, base | 1, self.packed),
                            slog_tagged(w_q, base | 2, self.packed))
            out.append(_merge_slog(b, slog_tagged(w_r, base | 3,
                                                  self.packed)))
        return out

    def merge(self, logs: list, batches: list, real: int,
              out_cap: int) -> list:
        """Merge each shard's sorted batch into its log with one big merge
        (an empty log adopts it), truncate or pad with sentinel rows to
        `out_cap` (`begin` ensures that only sentinel rows are cut) and
        scan once (B4 in the log's form); then commit the logs, the seq
        and `real`, only now that the round was enqueued (a failed launch
        must not advance the log).  -> [(positive, live)] a shard, int64
        0-d counters; the caller keeps the live count (`live`), summed
        over its shards."""
        qtag = ((self.seq + 1) << 2) | 2
        keys, out = [], []
        for a, b in zip(logs, batches):
            keys.append(_fit(_merge_slog(a, b) if a.shape[-1] else b,
                             out_cap))
            out.append(slog_counts(keys[-1], qtag))
        self.keys = keys
        self.seq += 1
        self.real = real
        return out

    def join_count(self, words: torch.Tensor, words_sorted: bool = False):
        """Hits of `words` against a log of one shard without folding it:
        the queries get the join's tag (after every entry of their word),
        one merge (B3), one scan (B4).  A query row is a hit when its word
        is live there."""
        log = self.keys[0]
        qtag = slog_query_tag(log)
        q = slog_tagged(words, qtag, self.packed)
        merge = merge_sorted_pair if words_sorted else merge_with_unsorted
        return slog_counts(stack(merge(cols(log), cols(q))), qtag)[0]

    def count(self) -> torch.Tensor:
        """The distinct live words of a log of one shard: the last round's
        by-product, else one scan (B4) of the runs whose last entry is an
        insert."""
        if self.live is None:
            log = self.keys[0]
            self.live = slog_counts(log, slog_query_tag(log))[1]
        return self.live

    def fold(self, out_cap: int) -> list:
        """End the log: each shard's folded to a sorted index of `out_cap`
        rows (`_slog_fold_kernel`) -> [(keys, distinct count)] a shard."""
        logs, self.keys = self.keys, None
        self.seq, self.real, self.live = 0, 0, None
        return [_slog_fold_kernel(s, out_cap) for s in logs]


class DeviceWordSet:
    """A dynamic set of packed words as a sorted int64 tensor on one
    device ([N] keys, or [2, N] rows at wide K), with a pending log of
    unfolded inserts and removes."""

    def __init__(self, cfg: CBLConfig, device: torch.device,
                 pending_cap: int = DEFAULT_PENDING_CAP):
        check_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self._cols = key_cols(cfg)
        self.data = sentinel_rows(MIN_CAP, self._cols, self.device)
        self._n_dev = None  # distinct count, device 0-d tensor (None = 0)
        self._n_host: int | None = 0
        self._n_upper = 0  # host upper bound on valid rows of `data`
        self.capacity = MIN_CAP
        # `data` is sorted and contiguous (valid keys, then sentinels); with
        # `_dups` it may hold duplicate keys.  With `_holes`, sentinel rows
        # may stand between the valid keys (still ascending and unique) and
        # the whole tensor is live; `_compact()` makes it contiguous again
        self._dups = False
        self._holes = False
        # the pending log: appended words, their (seq << 1) | op tags, the
        # rows in use, and whether a remove is among them
        self.pending_cap = pending_cap
        self.n_pending = 0
        self._pending_rm = False
        self._reset_pending()
        # the sorted log of dynamic rounds (one shard's): while active it
        # REPLACES `data` as the set (data entered it) until `_fold_slog`
        self.slog = SortedLog(cfg)

    @property
    def data(self) -> torch.Tensor:
        """The index tensor.  Every assignment drops the probe join's
        search layout, which is built again from the new index when a
        probe needs it (`_search_layout`)."""
        return self._data

    @data.setter
    def data(self, value: torch.Tensor) -> None:
        self._data = value
        self._search = None

    @spanned("index")
    def _search_layout(self, live: torch.Tensor) -> tuple:
        """(sample, stride log) of the live index for the probe join,
        built once for each index (and live length) and kept."""
        n = live.shape[-1]
        if self._search is None or self._search[0] != n:
            count("index.search_layout")
            self._search = (n, *search_layout(cols(live)))
        return self._search[1:]

    def _reset_pending(self) -> None:
        self.pending = sentinel_rows(self.pending_cap, self._cols,
                                     self.device)
        self.pending_tags = torch.zeros(self.pending_cap, dtype=torch.int64,
                                        device=self.device)
        self.n_pending = 0
        self._pending_rm = False

    @property
    def n(self) -> int:
        """Exact distinct count (waits for the device if one is pending)."""
        if self._n_host is None:
            with sync("n"):
                self._n_host = int(self._n_dev)
            if not self._dups:
                self._n_upper = self._n_host
        return self._n_host

    def _live(self) -> torch.Tensor:
        """The prefix of `data` that can hold every valid key."""
        if self._holes:
            return self.data
        eff = min(self.data.shape[-1], _next_pow2(max(self._n_upper, 1)))
        return self.data[..., :eff]

    def _live_cap(self) -> int:
        """The capacity a compacted index of `_n_upper` keys gets."""
        return _out_cap(self._n_upper)

    @spanned("index")
    def _compact(self) -> None:
        """Make an index with holes contiguous again (one sort)."""
        if not self._holes:
            return
        out_cap = self._live_cap()
        self.data, n_dev = _compact_marked(self.data, _valid_mask(self.data),
                                           out_cap)
        self.capacity = out_cap
        self._holes = False
        self._set_count(n_dev)

    @spanned("index")
    def _dedup(self) -> None:
        """Drop the duplicate keys a bulk build or a union by merge left
        behind (one sort).  Intersection and symmetric difference need it
        of both operands: their adjacency marks count rows."""
        if not self._dups:
            return
        self.flush()
        n = self.n  # one sync: the exact count sizes the result
        out_cap = _out_cap(n)
        self.data, n_dev = _dedup_sorted_kernel(self._live(), out_cap)
        self.capacity = out_cap
        self._dups = False
        self._holes = False
        self._set_count(n_dev)
        self._n_upper = n

    @spanned("index")
    def adopt_built(self, data: torch.Tensor, n_dev, n_upper: int) -> None:
        """Take a fused build's result: `data` sorted ascending, valid keys
        first (duplicates allowed), sentinel padded; `n_dev` = device count
        of DISTINCT keys; `n_upper` bounds the valid keys.  Row counts are
        Python ints and the count an int64 tensor: 64 bits, so an index
        may pass 2^31 rows."""
        if self._n_upper != 0 or self.slog.keys is not None or self.n_pending:
            raise ValueError("adopt_built needs an empty word set")
        self.data = data
        self.capacity = data.shape[-1]
        self._holes = False
        self._dups = True
        self._set_count(n_dev)
        self._n_upper = min(n_upper, self.capacity)

    # --- insert path ---

    def insert_words(self, words: torch.Tensor) -> None:
        """Queue [N] (or [2, N]) words for insertion (SENTINEL rows are
        ignored)."""
        self._append_log(words, tag=1)

    def remove_words(self, words: torch.Tensor) -> None:
        """Queue [N] (or [2, N]) words for removal (folds with the
        pending log)."""
        self._append_log(words, tag=0)

    def _append_log(self, words: torch.Tensor, tag: int) -> None:
        """Append a batch with op `tag`.  A batch larger than the log is
        applied at once; a batch that does not fit beside what is queued
        folds the log first."""
        n = words.shape[-1]
        if n > self.pending_cap:
            self.flush()
            if tag == 1:
                self._merge_into(words, n_new_upper=n)
            else:
                self._remove_now(words)
            return
        if self.n_pending + n > self.pending_cap:
            self.flush()
        if tag == 0:
            self._pending_rm = True
        off = self.n_pending
        seq = torch.arange(off + 1, off + n + 1, dtype=torch.int64,
                           device=self.device)
        # in place: the log's buffers belong to this word set alone
        self.pending_tags[off:off + n] = (seq << 1) | tag
        self.pending[..., off:off + n] = words
        self.n_pending += n

    def insert_rows_bulk(self, rows_list: list) -> None:
        """Fold a stream's word batches in ONE merge.  Part of the word
        set's interface for callers that hold word batches (in `cbl_tpu`
        the measurement scripts); no entry point of `CBL` calls it."""
        if not rows_list:
            return
        self.flush()
        rows = (rows_list[0] if len(rows_list) == 1
                else torch.cat(rows_list, dim=-1))
        self._merge_into(rows, n_new_upper=rows.shape[-1])

    def _pending_prefix(self):
        """The next-power-of-two prefix of the log that holds every row in
        use (few shapes, and a lightly filled log costs a small sort)."""
        eff = min(_next_pow2(self.n_pending), self.pending_cap)
        return self.pending[..., :eff], self.pending_tags[:eff]

    @spanned("index")
    def flush(self) -> None:
        """Fold an active slog, then the pending log, into `data`."""
        self._fold_slog()
        if self.n_pending == 0:
            return
        count("folds.pending")
        n_pend = self.n_pending
        rows, tags = self._pending_prefix()
        had_rm = self._pending_rm
        self._reset_pending()  # fresh buffers: `rows` and `tags` stay whole
        if not had_rm:
            self._merge_into(rows, n_new_upper=n_pend)
            return
        # inserts and removes: one last-write-wins fold (holes and
        # duplicate keys in `data` are tolerated, everything is sorted
        # again)
        out_cap = _out_cap(self._n_upper + n_pend)
        if self._n_upper == 0 and not self._holes:
            fold, data = _fold_log_kernel, self.data[..., :0]
        elif self._holes:
            fold, data = _fold_log_kernel, self.data
        else:
            fold, data = _fold_log_merge_kernel, self._live()
        self.data, n_dev = fold(data, rows, tags, out_cap)
        self.capacity = out_cap
        self._holes = False
        self._dups = False
        self._set_count(n_dev)
        self._n_upper = min(self._n_upper + n_pend, out_cap)

    @spanned("index")
    def _merge_into(self, rows: torch.Tensor, n_new_upper: int,
                    batch_sorted: bool = False) -> None:
        """Fold a batch of words into `data`; `batch_sorted` skips the
        batch's sort.  A stream of many slabs comes here once a slab: the
        index grows by a merge (B3) into a tensor of index + batch rows,
        duplicates kept.  Rows are counted in 64 bits throughout (Python
        ints, int64 tensors and B3's `long long` co-ranks), so the index
        may pass 2^31 rows (a human genome's 3.1e9)."""
        out_cap = _out_cap(self._n_upper + n_new_upper)
        if self._n_upper == 0 and not self._holes:
            # fresh index: one sort of the batch, duplicates kept
            if batch_sorted:
                self.data, n_dev = rows, _distinct_count(rows)
            else:
                self.data, n_dev = _build_sorted_kernel(rows)
            self.capacity = self.data.shape[-1]
            self._dups = True
        elif self._holes:
            # not monotone: one sort of index and batch, duplicates marked
            # where they stand (holes again)
            self.data, n_dev = _merge_sortmark_kernel(self.data, rows)
            self.capacity = self.data.shape[-1]
            self._dups = False
        elif self._live().shape[-1] + rows.shape[-1] <= 2 * out_cap:
            # sort only the batch and merge; duplicates are kept, so the
            # tensor stays monotone
            kern = (_merge_sortedbatch_kernel if batch_sorted
                    else _merge_keepdups_kernel)
            self.data, n_dev = kern(self._live(), rows)
            self.capacity = self.data.shape[-1]
            self._dups = True
        else:
            # duplicates and padding would pass one half: compact in the
            # same step (two sorts), back to the live size
            self.data, n_dev = _merge_sortcompact_kernel(self._live(), rows,
                                                         out_cap)
            self.capacity = out_cap
            self._holes = False
            self._dups = False
        self._n_dev = n_dev
        self._n_host = None
        self._n_upper = min(self._n_upper + n_new_upper, out_cap)

    def _set_count(self, n_dev) -> None:
        self._n_dev = n_dev
        self._n_host = None
        self._n_upper = min(self._n_upper, self.capacity)

    @spanned("index")
    def _fold_slog(self, cause: str = "flush") -> None:
        """Collapse an active slog into a clean sorted `data` (one
        compaction sort).  No-op when no slog is active.  `cause` names
        the fold in `COUNTERS` (`folds.slog.<cause>`)."""
        if self.slog.keys is None:
            return
        count("folds.slog." + cause)
        out_cap = self._live_cap()
        [(self.data, n_dev)] = self.slog.fold(out_cap)
        self.capacity = out_cap
        self._holes = False
        self._dups = False
        self._set_count(n_dev)

    def round_words(self, w_i: torch.Tensor, w_q: torch.Tensor,
                    w_r: torch.Tensor) -> torch.Tensor:
        """One interleaved round over the sorted log on three PRE-SORTED
        word batches ([N] or [2, N], sentinel rows at the end): insert
        `w_i`, count-query `w_q` (it sees the inserts, not yet the
        removes), remove `w_r`.  -> the query's hits, an unsynced int64
        0-d tensor.

        A pending log is folded first; the slog folds before its seq would
        pass 62 where `cbl_tpu` does (`SortedLog.at_seq_cap`), and under
        the autofold policy, after which one wait for the exact count
        tightens `_n_upper` (the fold's output has no duplicates; rounds
        of three 2^24-row slabs pass the hard cap every third round, and
        this wait is then for every round in flight).  Where no log is
        active the index, compacted, enters as a sorted run of seq-0
        inserts; the round's merges and scan run under `join`
        (`_fused_round_slog`), and the log commits after them."""
        slog = self.slog
        if self.n_pending > 0:
            self.flush()
        if slog.at_seq_cap():
            self._fold_slog("seq_cap")
        if slog.autofold_due(self._live_cap()):
            self._fold_slog("autofold")
            _ = self.n  # the exact count tightens _n_upper
        entry = None
        if slog.keys is None:
            self._compact()  # the index's keys enter the log as a sorted run
            keys = self._live() if self._n_upper else self.data[..., :0]
            entry = ([keys], min(self._n_upper, keys.shape[-1]))
        logs, real, out_cap = slog.begin(
            sum(w.shape[-1] for w in (w_i, w_q, w_r)), entry)
        [(positive, live)] = _fused_round_slog(
            slog, logs, [w_i], [w_q], [w_r], real, out_cap)
        slog.live = live  # free by-product of the round's scan
        self._n_upper = min(self._n_upper + w_i.shape[-1], out_cap)
        count("slog_rows", real)
        return positive

    # --- queries and removal ---

    @spanned("join")
    def count_hits_device(self, words: torch.Tensor,
                          words_sorted: bool = False,
                          n_valid: int | None = None):
        """Stored words among `words` (SENTINEL rows ignored), as an
        unsynced int64 0-d tensor.  A clean index (no log, no holes) takes
        one of two joins, by the bytes each must move (`_probe_cheaper`):
        the merge join (B3 over the tagged index and queries) when the
        batch is not much smaller than the index, else the probe join
        (the sorted queries searched in the index, kernel B8, through a
        search layout built once for each index).  With a pending log the
        query merges with index and log (last write wins), with an active
        slog with the slog; an index with holes joins by one tagged sort.
        A query never folds a log, except the slog when both logs are
        active, and never compacts an index with holes.  `words_sorted`
        skips the sort of the query side; `n_valid`, the valid rows of
        `words` where the host knows them, goes to B8's counters.
        `COUNTERS` counts each call's join: "join.probe" (and
        "probe_rows", the rows it searched) or "join.merge" (every
        other)."""
        if self.slog.keys is not None:
            if self.n_pending == 0:
                count("join.merge")
                return self.slog.join_count(words, words_sorted)
            # rare: rounds and separate calls mixed
            self._fold_slog("query")
        if self.n_pending > 0:
            count("join.merge")
            log_join = (_count_hits_log_kernel if self._holes
                        else _count_hits_log_merge_kernel)
            return log_join(self._live(), *self._pending_prefix(), words)
        if self._holes:
            # one tagged sort of index and queries, sorted or not
            count("join.merge")
            return _count_hits_kernel_packed(self.data, words)
        live = self._live()
        if _probe_cheaper(live.shape[-1], words.shape[-1], self._cols):
            count("join.probe")
            count("probe_rows", words.shape[-1])
            sample, s = self._search_layout(live)
            return _count_hits_probe_kernel(live, sample, s, words,
                                            words_sorted, n_valid)
        count("join.merge")
        if words_sorted:
            return _count_hits_merge_sorted_kernel(live, words)
        return _count_hits_merge_kernel(live, words)

    def count_hits(self, words: torch.Tensor) -> int:
        """`count_hits_device`, waited for."""
        hits = self.count_hits_device(words)
        with sync("count_hits"):
            return int(hits)

    def contains_words(self, words: torch.Tensor) -> torch.Tensor:
        """[N] bool on the device (N query rows); SENTINEL rows are
        False.  With a
        pending log, the log's last op per word overrides the index's
        answer: a point query never forces a fold."""
        self._fold_slog("query")
        base = self._contains_base(words)
        if self.n_pending == 0:
            return base
        has, present = _pending_override_kernel(*self._pending_prefix(),
                                                words)
        return torch.where(has, present, base) & _valid_mask(words)

    def _contains_base(self, words: torch.Tensor) -> torch.Tensor:
        if words.shape[-1] >= _SORTJOIN_MIN_QUERIES:
            return _contains_sortjoin_kernel(self._live(), words,
                                             self._holes)
        self._compact()  # the binary search needs a contiguous index
        return _contains_kernel(self._live(), words)

    def _remove_now(self, words: torch.Tensor) -> None:
        """Remove a batch at once (batches larger than the log)."""
        out_cap = self._live_cap()
        self.data, n_dev = _setop_sort_kernel_packed(
            self._live(), words, "remove", out_cap)
        self.capacity = out_cap
        self._holes = False
        self._dups = False  # remove keeps the first key of each run
        self._set_count(n_dev)

    def count(self) -> int:
        if self.slog.keys is not None and self.n_pending == 0:
            live = self.slog.count()
            with sync("count"):
                return int(live)
        self.flush()
        return self.n

    def count_device(self):
        """The distinct count as an unsynced device 0-d tensor.  The
        pending log is folded (enqueued, never waited for); an active slog
        alone is counted by a scan (B4), not folded."""
        if self.slog.keys is not None and self.n_pending == 0:
            return self.slog.count()
        self.flush()
        if self._n_dev is None:
            return torch.zeros((), dtype=torch.int64, device=self.device)
        return self._n_dev

    def is_empty(self) -> bool:
        return self.count() == 0

    # --- set algebra ---
    #
    # Operands survive every operation.  `cbl_tpu` copies an operand
    # before a kernel that donates its buffer; no kernel of the port
    # writes into a tensor it was given (B3, B6 and B7 only read their
    # inputs, and the marks go through `torch.where` into a new tensor),
    # so the operands' `data` is passed as it is.

    def _new(self) -> "DeviceWordSet":
        return DeviceWordSet(self.cfg, self.device, self.pending_cap)

    def _merge_setop_ready(self, other: "DeviceWordSet") -> bool:
        """True under a merge kernel, after making both operands
        contiguous: the operation then runs as ONE merge and adjacency
        marks in place of a tagged sort of both."""
        if not use_merge_combine():
            return False
        self._compact()
        other._compact()
        return True

    def union(self, other: "DeviceWordSet") -> "DeviceWordSet":
        self.flush()
        other.flush()
        out = self._new()
        if self._merge_setop_ready(other):
            data, n_dev = _union_merge_kernel(self._live(), other._live())
            out.data, out.capacity = data, data.shape[-1]
            out._n_upper = data.shape[-1]
            out._dups = True  # both copies of a shared key stay
        else:
            cap = _out_cap(self.n + other.n)
            data, n_dev = _merge_sortcompact_kernel(self._live(),
                                                    other._live(), cap)
            out.data, out.capacity = data, cap
            out._n_upper = cap
        out._set_count(n_dev)
        return out

    def _marking_setop(self, other: "DeviceWordSet", op: str,
                       cap_bound: int) -> "DeviceWordSet":
        out = self._new()
        # `cbl_tpu` takes the merge only where the tag bit fits the word's
        # uint32 limbs (not at K=13); the same rule here keeps the states
        # of the two packages equal
        cfg = self.cfg
        if (cfg.n_bits <= 32 * cfg.word_limbs - 2
                and self._merge_setop_ready(other)):
            data, n_dev = _setop_merge_kernel(self._live(), other._live(), op)
            out.data, out.capacity = data, data.shape[-1]
            out._n_upper = min(cap_bound, data.shape[-1])
            out._holes = True  # compacted when something needs it
        else:
            cap = _out_cap(cap_bound)
            data, n_dev = _setop_sort_kernel_packed(self._live(),
                                                    other._live(), op, cap)
            out.data, out.capacity = data, cap
            out._n_upper = cap
        out._set_count(n_dev)
        return out

    def intersection(self, other: "DeviceWordSet") -> "DeviceWordSet":
        self.flush()
        other.flush()
        self._dedup()
        other._dedup()
        return self._marking_setop(other, "inter", min(self.n, other.n))

    def difference(self, other: "DeviceWordSet") -> "DeviceWordSet":
        self.flush()
        other.flush()
        return self._marking_setop(other, "diff", self.n)

    def symmetric_difference(self, other: "DeviceWordSet") -> "DeviceWordSet":
        self.flush()
        other.flush()
        self._dedup()
        other._dedup()
        return self._marking_setop(other, "symdiff", self.n + other.n)

    @staticmethod
    def merge_many(sets: list) -> "DeviceWordSet":
        """Union of every set in ONE sort of all their keys, duplicates
        marked, and a compaction sort."""
        if not sets:
            raise ValueError("merge_many needs at least one set")
        if len(sets) == 1:
            return sets[0].copy()
        for s in sets:
            s.flush()
        cap = _out_cap(sum(s.n for s in sets))
        cat = torch.cat([s._live() for s in sets], dim=-1)
        out = sets[0]._new()
        out.data, n_dev = _merge_sortcompact_kernel(cat, cat[..., :0], cap)
        out.capacity = cap
        out._n_upper = cap
        out._set_count(n_dev)
        return out

    @staticmethod
    def intersect_many(sets: list) -> "DeviceWordSet":
        """Intersection of every set, pair by pair from the left."""
        if not sets:
            raise ValueError("intersect_many needs at least one set")
        if len(sets) == 1:
            return sets[0].copy()
        out = sets[0].intersection(sets[1])
        for s in sets[2:]:
            out = out.intersection(s)
        return out

    def copy(self) -> "DeviceWordSet":
        """A set of the same keys (the pending log folded first).  It
        shares the live tensor with this one: nothing updates `data` in
        place."""
        self.flush()
        out = self._new()
        out.data = self._live()
        out.capacity = out.data.shape[-1]
        out._holes = self._holes
        out._dups = self._dups
        n = self.n
        out._n_dev, out._n_host = self._n_dev, n
        out._n_upper = max(n, self._n_upper if self._dups else 0)
        return out

    # --- export ---

    def export_keys(self) -> torch.Tensor:
        """The n keys of the set, ascending and unique, as a view of
        `data` on the device: the logs are folded, holes compacted and
        duplicates dropped first (`cbl_tpu`'s export preamble)."""
        self.flush()
        self._compact()
        self._dedup()
        return self.data[..., : self.n]

    def iter_export_blocks(self, block_rows: int = 1 << 26):
        """Yield the set's keys, ascending and unique, in blocks: the rows
        and order of `export_keys`, read `block_rows` rows of the index
        at a time.  The logs are folded and holes compacted first; the
        duplicates a build keeps are dropped block by block (a row equal
        to the one before it, across block edges too), so no tensor of
        the index's length is made, where `export_keys`' dedup sorts the
        whole index.  A block is a new tensor on the device, fewer rows
        where duplicates fell; each costs one wait for the device."""
        if block_rows < 1:
            raise ValueError(f"block_rows={block_rows}: need at least 1")
        self.flush()
        self._compact()
        live = self._live()
        n = min(live.shape[-1], self._n_upper)  # valid rows lie below
        for lo in range(0, n, block_rows):
            keep = _new_keys(live, lo, block_rows)
            with sync("export_blocks"):
                out = live[..., lo : lo + block_rows][..., keep]
            yield out

    def words_array(self) -> np.ndarray:
        """[n, L] uint32 host array in ascending word order."""
        return host_limbs(self.export_keys(), self.cfg.word_limbs)

    def iter_words_chunks(self, chunk_rows: int = 1 << 22):
        """Yield [<= chunk_rows, L] uint32 host arrays in ascending word
        order: slices of the keys on the device, one chunk's copy at a
        time, so the host never holds more than a chunk."""
        keys = self.export_keys()
        L = self.cfg.word_limbs
        for lo in range(0, keys.shape[-1], chunk_rows):
            yield host_limbs(keys[..., lo : lo + chunk_rows], L)

    def prefixes(self) -> np.ndarray:
        """Sorted [n] uint32 prefix (word >> SUFFIX_BITS) of each word."""
        prefix = word_prefix(self.export_keys(), self.cfg)
        return host_limbs(prefix, 1).reshape(-1)
