"""The flagship forward step on one card: `entry()` and `python -m
cbl_tpu_torch.entry`.

Counterpart of `__graft_entry__.py`'s `entry()` and its `__main__`.
`forward(codes, valid, index)` takes one chunk of 2^14 k-mers through the
word pipeline and answers membership against a device-resident index:
`kmer.pack_stream` -> the canonical words (K=25, prefix 24; on a CUDA
tensor kernel B1 from the stream, which extracts, canonicalizes,
rotates and packs; on the CPU `extract_kmers` -> `canonicalize` ->
`necklace_pos` -> `pack_word`) -> the rows `valid` leaves out made
SENTINEL -> `wordset._contains_kernel`.  It makes no host sync (no `.item()`, no
copy to the host, no branch on a tensor's value), the port's
counterpart of the reference's "jittable", and on a CUDA tensor it
launches B1 exactly once.

    python -m cbl_tpu_torch.entry                  # the card, then dryrun_multichip(8)
    python -m cbl_tpu_torch.entry 2 --device cpu --kmers-per-shard 4096

The command runs `forward` once on the reference's args (an index of
sentinels, so every answer is False), prints the device, the mask's rows
and its hits, then runs `parallel.dryrun_multichip(n_shards)`; it exits
non-zero on any failed check, and with 2 where the device is missing.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import kmer as kmod
from .cbl import _kmer_words
from .config import get_config
from .limbs import SENTINEL, from_limbs, key_cols
from .parallel.dryrun import KMERS_PER_SHARD, dryrun_multichip
from .wordset import _contains_kernel, resolve_device

CFG = get_config(k=25, prefix_bits=24)
CHUNK = 1 << 14  # k-mers a forward step
STREAM_LEN = (CHUNK + CFG.k - 1 + 15) // 16 * 16  # 16,416 codes
INDEX_ROWS = 1 << 15  # the reference's all-sentinel index


def words(codes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[STREAM_LEN] uint8 codes, [CHUNK] bool -> [CHUNK] int64 canonical
    necklace words of the chunk's k-mers, SENTINEL where `valid` is
    False."""
    stream = kmod.pack_stream(codes)
    return torch.where(valid, _kmer_words(stream, CHUNK, CFG, canonical=True),
                       SENTINEL)


def forward(codes: torch.Tensor, valid: torch.Tensor,
            index: torch.Tensor) -> torch.Tensor:
    """[CHUNK] bool: which valid k-mers of the chunk are rows of `index`
    (sorted, contiguous int64 keys of any length)."""
    return _contains_kernel(index, words(codes, valid))


def reference_arrays():
    """The reference's numpy args, from `default_rng(0)` in its order:
    codes [STREAM_LEN] uint8, valid [CHUNK] bool (all True), index
    [INDEX_ROWS, L] uint32 limbs of all-ones sentinel rows."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=STREAM_LEN, dtype=np.uint8)
    valid = np.ones(CHUNK, dtype=bool)
    index = np.full((INDEX_ROWS, CFG.word_limbs), 0xFFFFFFFF, dtype=np.uint32)
    return codes, valid, index


def args_from_arrays(codes: np.ndarray, valid: np.ndarray,
                     index_u32: np.ndarray, device):
    """The reference's numpy args -> the port's tensors on `device`: the
    index's [n, L] uint32 limbs become int64 keys (all-ones rows
    SENTINEL).  "cuda" without a card raises."""
    dev = resolve_device(device)
    index = np.ascontiguousarray(from_limbs(index_u32, key_cols(CFG)))
    return (torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(dev),
            torch.from_numpy(np.ascontiguousarray(valid, bool)).to(dev),
            torch.from_numpy(index).to(dev))


def entry(device=None):
    """(forward, args): the reference's shapes and seed, the args on
    `device` (default the card; no CPU fallback)."""
    return forward, args_from_arrays(*reference_arrays(),
                                     "cuda" if device is None else device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cbl_tpu_torch.entry",
        description="Run the flagship forward step once, then "
                    "dryrun_multichip(n_shards).")
    p.add_argument("n_shards", nargs="?", type=int, default=8,
                   help="shards of the dryrun's mesh (default 8)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the args and the shards live (default cuda)")
    p.add_argument("--kmers-per-shard", type=int, default=KMERS_PER_SHARD,
                   help="k-mers a shard in the dryrun's at-scale part "
                        f"(default {KMERS_PER_SHARD})")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        fn, fargs = entry(args.device)
    except RuntimeError as e:
        print(f"cbl_tpu_torch.entry: {e}", file=sys.stderr)
        return 2
    mask = fn(*fargs)
    hits = int(mask.sum())
    dev = fargs[0].device
    print(f"entry() runs on {dev}: mask {tuple(mask.shape)} {mask.dtype}, "
          f"{hits} hits", flush=True)
    if tuple(mask.shape) != (CHUNK,) or mask.dtype != torch.bool or hits:
        print("cbl_tpu_torch.entry: the all-sentinel index must answer "
              f"False on all {CHUNK} rows", file=sys.stderr)
        return 1
    out = dryrun_multichip(args.n_shards,
                           None if dev.type == "cuda" else [dev],
                           args.kmers_per_shard)
    print(f"dryrun_multichip({args.n_shards}) on {dev.type}: {out}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
