"""The seam where the merge kernel plugs in.

Counterpart of the dispatchers in `cbl_tpu/ops/sort_pallas.py`
(`sort_cols_auto`, `merge_with_unsorted`, `merge_sorted_pair`), on 1-D
int64 key tensors.  The sort is `torch.sort`, as `cbl_tpu` uses
`lax.sort` there.  Merges go through `ops.merge.merge_sorted`, which
launches kernel B3 for every CUDA merge (no size floor).
"""

from __future__ import annotations

import torch

from .merge import merge_sorted


def sort_keys(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(keys).values


def merge_sorted_pair(sorted_a: torch.Tensor, sorted_b: torch.Tensor):
    """Merge two sorted key tensors; equals `sort_keys(cat([a, b]))`."""
    return merge_sorted(sorted_a, sorted_b)


def merge_with_unsorted(sorted_keys: torch.Tensor, unsorted_keys: torch.Tensor):
    """Sort only the unsorted side, then merge the two runs."""
    return merge_sorted(sorted_keys, sort_keys(unsorted_keys))
