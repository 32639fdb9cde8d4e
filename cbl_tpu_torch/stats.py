"""Repartition and load statistics of the prefix buckets.

Counterpart of `cbl_tpu/stats.py`, with the same return types and
orders.  These stats tune PREFIX_BITS and measure the balance of a
prefix-space partition across shards.

A bucket is the run of words that share a prefix (word >> SUFFIX_BITS).
Node counts follow the reference's structural accounting: a bucket of at
most THRESHOLD words is a "vec" whose node count is its length; a larger
one is a 256-ary trie over the big-endian bytes of its suffixes, whose
node count is 1 (the root) + the number of distinct byte prefixes of its
suffixes at depths 1 .. BYTES - 1.

`cbl_tpu` counts a trie with a Python loop over every bucket.  Here one
vectorised pass over the sorted keys does it: two adjacent suffixes of a
bucket share their first BYTES - 1 - b bytes, where b is the byte of the
highest bit in which they differ, so they differ at b of the depths
1 .. BYTES - 1.  A trie bucket's node count is then BYTES (the root and
the path of its first suffix) + the sum of b over its adjacent pairs.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .limbs import shift_right
from .necklace import word_prefix
from .wordset import _first_of_run

THRESHOLD = 1024  # the reference's vec -> trie threshold


def _buckets(cbl, nodes: bool = False):
    """(prefixes [B] uint32, sizes [B] int64[, node counts [B] int64]) of
    the non-empty buckets in ascending prefix order, computed on the
    index's device."""
    cfg = cbl.cfg
    keys = cbl.wordset.export_keys()
    pref = word_prefix(keys, cfg)
    first = _first_of_run(pref)
    starts = torch.nonzero(first).reshape(-1)
    ends = torch.cat([starts[1:], starts.new_tensor([keys.shape[-1]])
                      ])[: starts.shape[0]]
    sizes = ends - starts
    out = [pref[starts].cpu().numpy().astype(np.uint32),
           sizes.cpu().numpy()]
    if nodes:
        nbytes = (cfg.suffix_bits + 7) // 8
        # within a bucket: the suffixes' xor, one column or two
        diff = keys[..., 1:] ^ keys[..., :-1]
        b = torch.zeros_like(pref[1:])
        for m in range(1, nbytes):
            if diff.dim() == 1:
                b += (diff >> (8 * m)) != 0
            else:
                b += (shift_right(diff, 8 * m, 2) != 0).any(0)
        b[first[1:]] = 0  # a pair across two buckets
        bucket = torch.cumsum(first, 0)[1:] - 1
        pair_sum = torch.zeros_like(sizes).index_add_(0, bucket, b)
        trie = nbytes + pair_sum
        out.append(torch.where(sizes > THRESHOLD, trie, sizes).cpu().numpy())
    return out


def prefix_load(cbl) -> float:
    """Share of the 2^PREFIX_BITS buckets that hold a word."""
    uniq, _ = _buckets(cbl)
    return len(uniq) / float(1 << cbl.cfg.prefix_bits)


def buckets_sizes(cbl):
    """[(prefix, bucket size)] in ascending prefix order."""
    uniq, sizes = _buckets(cbl)
    return list(zip(uniq.tolist(), sizes.tolist()))


def buckets_size_count(cbl) -> dict[int, int]:
    """{bucket size: number of buckets}, ascending sizes."""
    _, sizes = _buckets(cbl)
    return dict(sorted(Counter(sizes.tolist()).items()))


def buckets_load_repartition(cbl) -> dict[int, float]:
    """{bucket size: share of the words in buckets of that size}."""
    sc = buckets_size_count(cbl)
    total = sum(s * c for s, c in sc.items())
    return {s: (s * c) / total for s, c in sc.items()}


def buckets_nodes(cbl):
    """[(prefix, node count)] in ascending prefix order."""
    uniq, _, nodes = _buckets(cbl, nodes=True)
    return list(zip(uniq.tolist(), nodes.tolist()))


def buckets_node_count(cbl) -> dict[int, int]:
    """{node count: number of buckets}, ascending node counts."""
    return dict(sorted(Counter(n for _, n in buckets_nodes(cbl)).items()))


def shard_balance(cbl, num_shards: int) -> np.ndarray:
    """Words owned by each prefix-space shard (the top bits of the
    prefix pick the shard)."""
    prefixes = cbl.wordset.prefixes()
    shard_bits = max((num_shards - 1).bit_length(), 0)
    owners = prefixes >> np.uint32(cbl.cfg.prefix_bits - shard_bits)
    return np.bincount(owners.astype(np.int64), minlength=num_shards)
