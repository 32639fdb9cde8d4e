"""The multi-device check of one process: `dryrun_multichip`.

Counterpart of `__graft_entry__.dryrun_multichip`, step for step: one
sharded update step on tiny shapes (a routed insert, membership, ordered
membership, a union, a checkpoint round trip and a routed remove), then
`_dryrun_at_scale`: at least `kmers_per_shard` k-mers a shard of
repeat-rich records (`bench.make_genome_corpus`, seed 5, records of
65,536 bases, queries of 8,192) through insert, growth, a mixed query, a
dynamic round, a remove, a repartition, set algebra and a checkpoint,
each count checked against a single `CBL` on the mesh's first device.

    python -c "from cbl_tpu_torch.parallel.dryrun import dryrun_multichip as d; d(4)"
    python -c "from cbl_tpu_torch.parallel.dryrun import dryrun_multichip as d; d(4, ['cpu'], 1 << 12)"

The shards go on the CUDA cards in turn by default (4 shards on one card
are 4 shards of that card); there is no CPU fallback.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from ..cbl import CBL
from ..limbs import from_limbs, key_cols
from .shard import ShardedCBL, make_mesh

KMERS_PER_SHARD = 1 << 20  # the reference's CBL_TPU_DRYRUN_KMERS_PER_DEV


def check(ok: bool, what) -> None:
    """An assert that `python -O` keeps."""
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(n_shards: int, devices=None,
                     kmers_per_shard: int = KMERS_PER_SHARD) -> dict:
    """Run the check on `n_shards` shards placed on `devices` in turn
    (default: `make_mesh()`'s cards); raise on the first miss.  -> the
    small step's count, the at-scale final count and the k-mers driven."""
    devices = list(make_mesh() if devices is None else devices)
    mesh = make_mesh([devices[i % len(devices)] for i in range(n_shards)])
    idx = ShardedCBL(k=25, prefix_bits=24, canonical=True, mesh=mesh,
                     batch_per_device=256)
    # one full update step on tiny shapes: route + merge + count
    rng = np.random.default_rng(0)
    seq_codes = rng.integers(0, 4, size=2048, dtype=np.uint8)
    offsets = np.array([0, 1024, 2048], dtype=np.int64)
    idx.insert_codes_stream(seq_codes, offsets)
    n = idx.count()
    check(n > 0, "sharded insert produced an empty index")
    # membership over the mesh (routed queries, results returned in order)
    words = from_limbs(idx.words_array()[:512], key_cols(idx.cfg))
    check(bool(np.all(idx.contains_words(words))),
           "sharded contains failed on inserted words")
    # ordered membership (route + join + route back + un-bucket)
    masks = idx.contains_codes_stream(seq_codes, offsets)
    check(all(bool(np.all(m)) for m in masks), "ordered contains failed")
    # aligned-partition union (collective set algebra)
    check(idx.union(idx).count() == n, "union with itself")
    # sharded checkpoint round-trip (one file, no host gather)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "dryrun.npz")
        idx.save_to_file(p)
        back = ShardedCBL.load_from_file(p, mesh=mesh)
        check(back.count() == n, "checkpoint round-trip count mismatch")
    # bulk routed remove: drop the second record, count must shrink exactly
    ref_first = ShardedCBL(k=25, prefix_bits=24, canonical=True, mesh=mesh,
                           batch_per_device=256)
    ref_first.boundaries = idx.boundaries.copy()
    ref_first._boundaries_from_data = True
    ref_first.insert_codes_stream(seq_codes[:1024],
                                  np.array([0, 1024], dtype=np.int64))
    idx.remove_codes_stream(seq_codes[1024:],
                            np.array([0, 1024], dtype=np.int64))
    only_first = ref_first.difference(ref_first.difference(idx))
    check(idx.count() < n and only_first.count() <= ref_first.count(),
           (idx.count(), n, only_first.count(), ref_first.count()))

    big_n, big_total = _dryrun_at_scale(mesh, kmers_per_shard)
    print(f"dryrun_multichip OK: {n_shards} shards on {len(set(mesh))} "
          f"device(s), {n} k-mers small + {big_total} k-mers at scale "
          f"({big_n} distinct, >={kmers_per_shard}/shard), contains/union/"
          "checkpoint/remove/dynamic/repartition verified")
    return {"small": n, "distinct": big_n, "kmers": big_total}


def _dryrun_at_scale(mesh, kmers_per_shard: int):
    """The at-scale half: repeat-rich (necklace-skewed) multi-record data
    driven through insert -> growth insert -> query (mixed hits/misses)
    -> dynamic round -> remove -> repartition -> algebra -> sharded
    checkpoint, every count checked against a single index.  Exercises
    capacity growth, the duplicate rows of the bulk insert and their
    dedup, quantile boundaries on skewed data and the bucket-overflow
    accounting at realistic skew (any drop raises)."""
    from ..bench import make_genome_corpus  # the bench's own corpus

    n_shards = len(mesh)
    bases = kmers_per_shard * n_shards + 24
    codes, off_i, codes_q, off_q = make_genome_corpus(
        bases, seed=5, read_len=65_536, qread_len=8_192
    )
    half_rec = len(off_i) // 2
    off_a, start_b = off_i[: half_rec + 1], int(off_i[half_rec])
    off_b = (off_i[half_rec:] - start_b).astype(np.int64)

    idx = ShardedCBL(k=25, mesh=mesh, batch_per_device=1 << 14)
    idx.insert_codes_stream(codes[: int(off_a[-1])], off_a)
    # second half: merges into a non-empty index -> capacity growth +
    # duplicate-row pressure (repeat-rich reads re-insert shared k-mers)
    idx.insert_codes_stream(codes[start_b:], off_b)
    n_all = idx.count()

    single = CBL(k=25, device=mesh[0])
    single.insert_codes_stream(codes, off_i)
    check(n_all == single.count(), (n_all, single.count()))

    tq, pq = idx.query_codes_stream(codes_q, off_q)
    want = single.query_codes_stream(codes_q, off_q)
    check((tq, pq) == want, ((tq, pq), want))
    check(0 < pq < tq, (pq, tq))  # genuinely mixed hits and misses

    # one at-scale interleaved dynamic round (sharded sorted log)
    rl = int(off_i[1])
    d_off = np.array([0, rl], dtype=np.int64)
    streams = ((codes[:rl], d_off), (codes_q[:rl], d_off),
               (codes[rl // 2:rl + rl // 2], d_off))
    want = single.dynamic_round(*streams)
    got = idx.dynamic_round(*streams)
    check(got == want, (got, want))
    check(idx.count() == single.count(), (idx.count(), single.count()))

    # remove the first-half records again
    idx.remove_codes_stream(codes[: int(off_a[-1])], off_a)
    single.remove_codes_stream(codes[: int(off_a[-1])], off_a)
    check(idx.count() == single.count(), (idx.count(), single.count()))

    # re-balance the range partition to the current contents: zero lost
    # words, exact global order, <=2x balance
    idx.repartition()
    bal = idx.shard_balance()
    check(int(bal.sum()) == single.count() == idx.count(),
           (bal, single.count()))
    check(bal.max() <= 2 * max(1, -(-int(bal.sum()) // n_shards)), bal)
    np.testing.assert_array_equal(idx.words_array(),
                                  single.wordset.words_array())

    # algebra at scale (on the re-routed state): A ∪ A == A, A ∩ A == A
    u = idx.union(idx)
    check(u.count() == idx.count(), "union at scale")
    check(idx.intersection(u).count() == idx.count(),
           "intersection at scale")

    # sharded checkpoint round-trip at scale
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "dryrun_big.npz")
        idx.save_to_file(p)
        back = ShardedCBL.load_from_file(p, mesh=mesh)
        check(back.count() == idx.count(), "checkpoint at scale")
    total_kmers = (len(codes) - 24) + (len(codes_q) - 24 * (len(off_q) - 1))
    return idx.count(), total_kmers
