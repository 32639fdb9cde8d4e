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

Not ported yet: the pending log, point operations, dynamic rounds, set
algebra and export (ROADMAP slices 2 to 5).
"""

from __future__ import annotations

import torch

from .config import CBLConfig
from .limbs import SENTINEL, check_config
from .ops.sort import merge_sorted_pair, merge_with_unsorted, sort_keys

MIN_CAP = 4096


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n > 1 else 1


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
        # `data` is sorted and contiguous (valid keys, then sentinels); with
        # `_dups` it may hold duplicate keys
        self._dups = False

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
        if self._n_upper != 0:
            raise ValueError("adopt_built needs an empty word set")
        self.data = data
        self._dups = True
        self._n_dev = n_dev
        self._n_host = None
        self._n_upper = min(n_upper, data.shape[0])

    def _merge_into(self, batch: torch.Tensor, n_new_upper: int) -> None:
        """Fold a SORTED batch into the set (keeping duplicates)."""
        if self._n_upper == 0:
            self.data, n_dev = batch, _distinct_count(batch)
        else:
            self.data, n_dev = _merge_sortedbatch_kernel(self._live(), batch)
        self._dups = True
        self._n_dev = n_dev
        self._n_host = None
        self._n_upper += n_new_upper

    def count(self) -> int:
        return self.n

    def count_device(self):
        """The distinct count as an unsynced device 0-d tensor."""
        if self._n_dev is None:
            return torch.zeros((), dtype=torch.int64, device=self.device)
        return self._n_dev

    def is_empty(self) -> bool:
        return self.count() == 0
