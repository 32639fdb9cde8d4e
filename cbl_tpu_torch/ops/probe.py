"""Kernel B8: the probe join's search of a sorted index.

The index is sorted rows of one or two int64 columns (a 1-D tensor or a
tuple of two), ordered lexicographically with column 0 major, and may
hold duplicate rows and trailing SENTINEL rows.  Its search layout
(`search_layout`) is a sorted sample of every 2^s-th row, skew-free
whatever the words' distribution; the word set builds it once when its
index changes.  `probe_hits` counts the query rows, sorted ascending,
that some index row equals (SENTINEL query rows never), as an int64 0-d
tensor.  The kernel takes 256 rows a block: the block's first and last
rows are placed in the sample by a 33-way warp search, each row then by
a binary search of the sample between those two places, and last by a
lower-bound search of the 2^s - 1 index rows after its sample entry.

`probe_hits_plain` answers the same count by `torch.searchsorted` over
the index itself, without the sample (the CPU's route, and the plain
search the tests hold the kernel to); for CUDA tensors `probe_hits`
launches `csrc/probe.cu`, whatever the size.
"""

from __future__ import annotations

import ctypes

import torch

from ..limbs import SENTINEL
from . import _build
from .merge import _col_ptrs, as_cols

# a sample row every 2^5 rows: 256 bytes of one column, which a search
# crosses in three dependent 32-byte sectors; the sample is 1/32 of the
# index (780 MB beside a human genome's 25 GB)
STRIDE_LOG = 5


def search_layout(cols: tuple) -> tuple:
    """(sample, s) of sorted index columns: the columns of rows 0, 2^s,
    2 * 2^s, ... (s = STRIDE_LOG), copied out contiguous."""
    return tuple(c[:: 1 << STRIDE_LOG].contiguous()
                 for c in as_cols(cols)), STRIDE_LOG


def probe_hits_plain(data, queries) -> torch.Tensor:
    """Hits of the query rows (in any order) in the sorted index, by
    `torch.searchsorted` on column 0; with two columns, a lower bound on
    column 1 inside each row's run of equal column 0 finds it."""
    d, q = as_cols(data), as_cols(queries)
    n = d[0].shape[0]
    if n == 0 or q[0].shape[0] == 0:
        return torch.zeros((), dtype=torch.int64, device=q[0].device)
    lo = torch.searchsorted(d[0], q[0])
    if len(d) == 2:
        hi = torch.searchsorted(d[0], q[0], right=True)
        for _ in range(int((hi - lo).max()).bit_length()):
            mid = (lo + hi) >> 1
            less = d[1][mid.clamp(max=n - 1)] < q[1]
            active = lo < hi
            lo = torch.where(active & less, mid + 1, lo)
            hi = torch.where(active & ~less, mid, hi)
    at = lo.clamp(max=n - 1)
    hit = (lo < n) & (q[0] != SENTINEL)
    for dc, qc in zip(d, q):
        hit &= dc[at] == qc
    return hit.sum()


def probe_hits(data, sample, s: int, queries,
               n_valid: int | None = None) -> torch.Tensor:
    """`probe_hits_plain` on the CPU; on CUDA, kernel B8.  The queries
    must be sorted.  `n_valid` is how many query rows are not SENTINEL,
    where the caller knows it without a wait for the device (a packed
    slab's unblanked k-mer starts).  Counted in `LAUNCHES`: "probe" a
    launch, "probe_rows" the query rows handed to it, "probe_valid_rows"
    `n_valid` (0 where it is not given)."""
    cd, cs, cq = as_cols(data), as_cols(sample), as_cols(queries)
    if not len(cd) == len(cs) == len(cq) <= 2:
        raise ValueError("index, sample and queries need one or two columns "
                         "each, as many each")
    if cq[0].device.type == "cpu":
        return probe_hits_plain(data, queries)
    _build.check_cuda(*cd, *cs, *cq)
    dev = cq[0].device
    hits = torch.empty((), dtype=torch.int64, device=dev)
    pd, ps, pq = _col_ptrs(cd), _col_ptrs(cs), _col_ptrs(cq)
    nq = cq[0].shape[0]
    err = _build.library().cbl_probe_hits(
        pd, ctypes.c_longlong(cd[0].shape[0]), ps,
        ctypes.c_longlong(cs[0].shape[0]), ctypes.c_int(s), pq,
        ctypes.c_longlong(nq), ctypes.c_int(len(cq)),
        ctypes.c_void_p(hits.data_ptr()), _build.stream_handle(dev))
    _build.check_error(err, "probe")
    _build.LAUNCHES["probe"] += 1
    _build.LAUNCHES["probe_rows"] += nq
    _build.LAUNCHES["probe_valid_rows"] += n_valid or 0
    return hits
