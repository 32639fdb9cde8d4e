"""Necklace microbenchmark: ns per necklace.

Twin of `examples/bench_necklace_throughput.py`: N random W-bit k-mers
(W = 2K) through `necklace.necklace_pos_auto`, kernel B1 on the card (the
two-column form from K=33), its plain version on the CPU; one warm-up
call, then one timed call ending in a sync.

    python -m cbl_tpu_torch.examples.bench_necklace_throughput [n] [k]
"""

import argparse
import sys
import time

import torch

from cbl_tpu_torch import necklace
from cbl_tpu_torch.config import get_config
from cbl_tpu_torch.limbs import LOW_BITS, kmer_cols, low_mask
from cbl_tpu_torch.wordset import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=10_000_000)
    ap.add_argument("k", type=int, nargs="?", default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n, k = args.n, args.k
    dev = resolve_device(args.device)
    cfg = get_config(k=k, prefix_bits=24)
    W = cfg.kmer_bits
    gen = torch.Generator(device=dev).manual_seed(42)
    if kmer_cols(cfg) == 1:
        x = torch.randint(0, 1 << W, (n,), generator=gen, device=dev)
    else:  # column 0 the high W - 63 bits, column 1 the low 63
        x = torch.stack([
            torch.randint(0, 1 << (W - LOW_BITS), (n,), generator=gen,
                          device=dev),
            torch.randint(-(1 << 63), (1 << 63) - 1, (n,), generator=gen,
                          device=dev) & low_mask(LOW_BITS),
        ])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    necklace.necklace_pos_auto(x, cfg)  # warm-up (and the kernels' build)
    sync()
    t0 = time.time()
    necklace.necklace_pos_auto(x, cfg)
    sync()
    dt = time.time() - t0
    print(f"{n} necklaces (K={k}, {W} bits) in {dt:.4f}s "
          f"= {dt / n * 1e9:.3f} ns/necklace = {n / dt / 1e6:.1f}M/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
