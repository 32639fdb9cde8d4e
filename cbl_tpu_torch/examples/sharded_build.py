"""Sharded build, query and checkpoint.

Twin of `examples/sharded_build.py`: the necklace word space is
range-partitioned over a mesh of devices, k-mers are routed to their
owner shards with one exchange a slab group, and counts are summed.
Without an input file it makes 2,000,000 random bases in records of
10,000.

    python -m cbl_tpu_torch.examples.sharded_build [reads.fa]
        [--device cuda] [--shards N]

The mesh is every CUDA card (`make_mesh()`), or `--shards` shards on
`--device`.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np


def main(argv=None) -> int:
    from cbl_tpu_torch.io import parse_fastx
    from cbl_tpu_torch.parallel import ShardedCBL, make_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=None)
    args = ap.parse_args(argv)
    if args.shards is None and args.device == "cuda":
        mesh = make_mesh()
    else:
        mesh = make_mesh([args.device] * (args.shards or 1))

    if args.input:
        codes, offsets = parse_fastx(args.input)
    else:
        rng = np.random.default_rng(0)
        codes = rng.integers(0, 4, size=2_000_000, dtype=np.uint8)
        offsets = np.arange(0, len(codes) + 1, 10_000, dtype=np.int64)

    idx = ShardedCBL(k=25, canonical=True, mesh=mesh)
    print(f"devices: {idx.D}", file=sys.stderr)
    t0 = time.time()
    idx.insert_codes_stream(codes, offsets)
    n = idx.count()
    print(f"built {n} distinct 25-mers in {time.time()-t0:.2f}s; "
          f"shard balance {idx.shard_balance().tolist()}", file=sys.stderr)

    total, positive = idx.query_codes_stream(codes, offsets)
    print(f"self-query: {positive}/{total} positive", file=sys.stderr)

    masks = idx.contains_seqs([codes[:1000], codes[5000:5600]])
    print(f"ordered masks: {[int(m.sum()) for m in masks]} hits",
          file=sys.stderr)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sharded_example.npz")
        idx.save_to_file(path)
        back = ShardedCBL.load_from_file(path, mesh=mesh)
    if back.count() != n:
        raise RuntimeError(f"checkpoint round-trip: {back.count()} != {n}")
    print("checkpoint round-trip OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
