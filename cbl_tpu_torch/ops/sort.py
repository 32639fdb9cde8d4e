"""The seam where the sort and merge kernels plug in.

Counterpart of the dispatchers in `cbl_tpu/ops/sort_pallas.py`
(`_sort_mode`, `sort_cols_auto`, `merge_with_unsorted`,
`merge_sorted_pair`).  Keys are one int64 column (a 1-D tensor) or two (a
tuple of two), ordered lexicographically with column 0 major (see
`ops.merge`).

The sort has two modes:
- "library" (the default, as `xla` is `cbl_tpu`'s): `torch.sort`; for two
  columns, two stable passes;
- "mergepath": kernel B5 for CUDA tensors at every size (it runs or the
  call raises; there is no way back to `torch.sort`), and B5's plain
  version for CPU tensors.
The mode is read at every `sort_keys` call: `use_sort_mode` overrides the
environment variable `CBL_TORCH_SORT`.  `cbl_tpu`'s 2^20-row engage floor,
its `-force` modes and tile knobs are tuning for its own device and are
not carried over.

Merges go through `ops.merge.merge_sorted`, which launches kernel B3 for
every CUDA merge (no size floor, no mode).
"""

from __future__ import annotations

import contextlib
import os

import torch

from .merge import (
    _like,
    as_cols,
    merge_sorted,
    sort_cols_plain,
    sort_mergepath,
)

SORT_ENV = "CBL_TORCH_SORT"
SORT_MODES = ("library", "mergepath")
_override: str | None = None


def _check_mode(mode: str, where: str) -> str:
    if mode not in SORT_MODES:
        raise ValueError(f"{where}={mode!r}: expected one of {SORT_MODES}")
    return mode


def sort_mode() -> str:
    """The sort mode in force: the `use_sort_mode` override, else the
    environment variable `CBL_TORCH_SORT`, else "library"."""
    if _override is not None:
        return _override
    return _check_mode(os.environ.get(SORT_ENV, "library"), SORT_ENV)


@contextlib.contextmanager
def use_sort_mode(mode: str):
    """Run the block under sort mode `mode`, whatever the environment."""
    global _override
    _check_mode(mode, "use_sort_mode")
    before, _override = _override, mode
    try:
        yield
    finally:
        _override = before


def sort_keys(keys):
    """Sort keys ascending (one column or two, lexicographic)."""
    if sort_mode() == "mergepath":
        return sort_mergepath(keys)
    return _like(keys, sort_cols_plain(as_cols(keys)))


def merge_sorted_pair(sorted_a, sorted_b):
    """Merge two sorted key runs; equals `sort_keys` of their
    concatenation."""
    return merge_sorted(sorted_a, sorted_b)


def merge_with_unsorted(sorted_keys, unsorted_keys):
    """Sort only the unsorted side, then merge the two runs."""
    return merge_sorted(sorted_keys, sort_keys(unsorted_keys))


def cat_cols(*parts):
    """Concatenate two-column key runs column by column."""
    return tuple(torch.cat(cs) for cs in zip(*parts, strict=True))
