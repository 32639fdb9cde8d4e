"""The seam where the sort and merge kernels plug in.

Counterpart of the dispatchers in `cbl_tpu/ops/sort_pallas.py`
(`_sort_mode`, `_merge_mode`, `sort_cols_auto`, `merge_with_unsorted`,
`merge_sorted_pair`, `use_merge_combine`).  Keys are one int64 column (a
1-D tensor) or one to three (a tuple of 1-D tensors), ordered
lexicographically with column 0 major (see `ops.merge`).

The sort has three modes:
- "library": `torch.sort`; for C columns, C stable passes, the last
  column first (the default for CPU tensors, as `xla` is `cbl_tpu`'s);
- "mergepath": kernel B5 for CUDA tensors (their default: keys only, no
  index, no passes per column), its plain version for CPU tensors;
- "bitonic": kernel B6 for CUDA tensors, its plain version for CPU tensors.
The merge of two sorted runs has three modes:
- "mergepath" (the default, as in `cbl_tpu`): kernel B3;
- "bitonic": kernel B7 (`cbl_tpu`'s `pallas`);
- "sort": no merge kernel, one `sort_keys` of the concatenation
  (`cbl_tpu`'s `xla`); set algebra then takes its sort path
  (`use_merge_combine`).
On CUDA a kernel mode engages at every size (the kernel runs or the call
raises; there is no way back to `torch.sort`); on the CPU it runs the
kernel's plain version.  A mode is read at every call: `use_sort_mode` /
`use_merge_mode` override the environment variables `CBL_TORCH_SORT` /
`CBL_TORCH_MERGE`; with neither, the sort's default follows the device
of the keys (`sort_mode`).  `profiling.COUNTERS["sort.<mode>"]` counts
the sorts each mode ran.  `cbl_tpu`'s row floors, its `-force` modes and
tile knobs are tuning for its own device and are not carried over.
"""

from __future__ import annotations

import contextlib
import os

import torch

from ..profiling import count, spanned
from .bitonic import bitonic_merge, bitonic_sort
from .merge import (
    _like,
    as_cols,
    merge_sorted,
    sort_cols_plain,
    sort_mergepath,
)

SORT_ENV = "CBL_TORCH_SORT"
SORT_MODES = ("library", "mergepath", "bitonic")
MERGE_ENV = "CBL_TORCH_MERGE"
MERGE_MODES = ("mergepath", "bitonic", "sort")
# the `use_*_mode` overrides, by environment variable
_override: dict = {SORT_ENV: None, MERGE_ENV: None}


def _check_mode(mode: str, modes: tuple, where: str) -> str:
    if mode not in modes:
        raise ValueError(f"{where}={mode!r}: expected one of {modes}")
    return mode


def _mode(env: str, modes: tuple, default: str) -> str:
    if _override[env] is not None:
        return _override[env]
    return _check_mode(os.environ.get(env, default), modes, env)


@contextlib.contextmanager
def _use_mode(env: str, modes: tuple, mode: str, where: str):
    _check_mode(mode, modes, where)
    before, _override[env] = _override[env], mode
    try:
        yield
    finally:
        _override[env] = before


def sort_mode(device=None) -> str:
    """The sort mode in force for keys on `device` (a torch device or its
    name; None stands for the CPU): the `use_sort_mode` override, else
    the environment variable `CBL_TORCH_SORT`, else "mergepath" (B5) on a
    CUDA device and "library" elsewhere."""
    cuda = device is not None and torch.device(device).type == "cuda"
    return _mode(SORT_ENV, SORT_MODES, "mergepath" if cuda else "library")


def use_sort_mode(mode: str):
    """Run the block under sort mode `mode`, whatever the environment."""
    return _use_mode(SORT_ENV, SORT_MODES, mode, "use_sort_mode")


def merge_mode() -> str:
    """The merge mode in force: the `use_merge_mode` override, else the
    environment variable `CBL_TORCH_MERGE`, else "mergepath"."""
    return _mode(MERGE_ENV, MERGE_MODES, MERGE_MODES[0])


def use_merge_mode(mode: str):
    """Run the block under merge mode `mode`, whatever the environment."""
    return _use_mode(MERGE_ENV, MERGE_MODES, mode, "use_merge_mode")


def use_merge_combine() -> bool:
    """True when two sorted runs are combined by a merge kernel (B3 or
    B7): callers then keep layouts a merge can use (sorted, contiguous
    operands; compaction put off)."""
    return merge_mode() != "sort"


@spanned("sort")
def sort_keys(keys):
    """Sort keys ascending (one to three columns, lexicographic) in the
    sort mode in force for their device, counted in
    `COUNTERS["sort.<mode>"]`."""
    cols = as_cols(keys)
    mode = sort_mode(cols[0].device)
    count("sort." + mode)
    if mode == "mergepath":
        return sort_mergepath(keys)
    if mode == "bitonic":
        return bitonic_sort(keys)
    return _like(keys, sort_cols_plain(cols))


def merge_sorted_pair(sorted_a, sorted_b):
    """Merge two sorted key runs; equals `sort_keys` of their
    concatenation (which is what the "sort" merge mode does)."""
    mode = merge_mode()
    if mode == "mergepath":
        return merge_sorted(sorted_a, sorted_b)
    if mode == "bitonic":
        return bitonic_merge(sorted_a, sorted_b)
    return sort_keys(cat_cols(sorted_a, sorted_b))


def merge_with_unsorted(sorted_keys, unsorted_keys):
    """Sort only the unsorted side, then merge the two runs; in the "sort"
    merge mode, one sort of both."""
    if use_merge_combine():
        unsorted_keys = sort_keys(unsorted_keys)
    return merge_sorted_pair(sorted_keys, unsorted_keys)


def cat_cols(*parts):
    """Concatenate key runs column by column: a tensor for tensors, a
    tuple of columns for tuples."""
    return _like(parts[0], tuple(torch.cat(cs) for cs in zip(
        *map(as_cols, parts), strict=True)))
