"""Partition re-balancing and lossless overflow recovery.

Twin of `examples/repartition_recovery.py`.  The sharded index
range-partitions the necklace word space by data quantiles frozen at the
first insert.  When later data skews the load, two mechanisms keep it
healthy:

1. `ShardedCBL.repartition()` recomputes exact global-quantile
   boundaries from the sorted shards and moves every word once to its
   new owner (a destination receives exactly its rank range, so nothing
   can drop).
2. Insert streams recover from a routing-bucket overflow: inserts are
   idempotent, so the stream repartitions and re-runs itself with
   buckets twice as large instead of corrupting the index.

    python -m cbl_tpu_torch.examples.repartition_recovery
        [--device cuda] [--shards N]

The mesh is every CUDA card (`make_mesh()`), or `--shards` shards on
`--device`.
"""

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    from cbl_tpu_torch.limbs import SENTINEL
    from cbl_tpu_torch.parallel import ShardedCBL, make_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--bases", type=int, default=200_000)
    ap.add_argument("--skew", type=int, default=100_000)
    args = ap.parse_args(argv)
    if args.shards is None and args.device == "cuda":
        mesh = make_mesh()
    else:
        mesh = make_mesh([args.device] * (args.shards or 1))

    rng = np.random.default_rng(0)
    idx = ShardedCBL(k=25, mesh=mesh)
    print(f"mesh: {idx.D} device(s)")

    # 1) a normal build: boundaries from the first batch's quantiles
    codes = rng.integers(0, 4, size=args.bases, dtype=np.uint8)
    offsets = np.array([0, len(codes)], dtype=np.int64)
    idx.insert_codes_stream(codes, offsets)
    print(f"built {idx.count()} k-mers; balance {idx.shard_balance().tolist()}")

    # 2) skewed growth: tiny-valued words all land on shard 0
    idx.insert_words(np.arange(args.skew, dtype=np.int64))
    print(f"after skewed growth: balance {idx.shard_balance().tolist()}")

    # 3) one re-balance restores the quantile partition
    t0 = time.time()
    idx.repartition()
    print(f"repartitioned in {time.time()-t0:.2f}s; "
          f"balance {idx.shard_balance().tolist()}")

    # 4) pathological boundaries and a big stream: the insert recovers on
    #    its own (repartition and an idempotent re-run), no word lost
    bad = ShardedCBL(k=25, mesh=mesh)
    bad.boundaries = np.full_like(bad.boundaries, SENTINEL)
    bad._boundaries_from_data = True  # freeze the bad partition
    bad.insert_codes_stream(codes, offsets)
    print(f"overflow recovery: {bad.count()} k-mers "
          f"(= {idx.count() - args.skew} expected), "
          f"balance {bad.shard_balance().tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
