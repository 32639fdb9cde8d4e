"""Interleaved insert/query/remove rounds over the sorted log.

Twin of `examples/dynamic_rounds.py`: round i inserts segment i, queries
the previous segment (it sees the inserts, not this round's removes) and
removes the first half of segment i, each as one `CBL.dynamic_round`;
the rounds' counts stay on the device until one sync at the end.

    python -m cbl_tpu_torch.examples.dynamic_rounds [rounds] [seg_bases]
"""

import argparse
import sys
import time

import numpy as np
import torch

from cbl_tpu_torch import CBL


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rounds", type=int, nargs="?", default=8)
    ap.add_argument("seg_bases", type=int, nargs="?", default=1_000_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    k, rounds, seg_bases = 25, args.rounds, args.seg_bases

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=rounds * seg_bases, dtype=np.uint8)
    off = np.array([0, seg_bases], dtype=np.int64)
    off_h = np.array([0, seg_bases // 2], dtype=np.int64)

    idx = CBL(k=k, device=args.device)
    segs = [
        idx.pack_stream(codes[i * seg_bases : (i + 1) * seg_bases], off)
        for i in range(rounds)
    ]
    halves = [
        idx.pack_stream(
            codes[i * seg_bases : i * seg_bases + seg_bases // 2], off_h
        )
        for i in range(rounds)
    ]
    if idx.device.type == "cuda":
        torch.cuda.synchronize(idx.device)

    t0 = time.time()
    pos_dev = None
    ops = 0
    for i in range(rounds):
        _, p = idx.dynamic_round(
            segs[i], segs[i - 1 if i else 0], halves[i], lazy=True
        )
        pos_dev = p if pos_dev is None else pos_dev + p
        ops += 2 * (seg_bases - k + 1) + seg_bases // 2 - k + 1
    n, positive = torch.stack(
        [idx.count_device().long(), pos_dev.long()]).tolist()
    dt = time.time() - t0
    print(
        f"{rounds} rounds / {ops} k-mer ops in {dt:.3f}s "
        f"({ops/dt/1e6:.1f}M ops/s): {n} distinct k-mers live, "
        f"{positive} positive queries"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
