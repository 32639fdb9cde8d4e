"""The one traffic generator: a configuration's genome, a mix's read sets
(`traffic/<mix>.json`) and a seed -> the host arrays that a cell stages
before its window.

Every array comes from one `numpy.random.default_rng(seed)`, drawn in a
fixed order, so one seed gives the same bases every time, and every seed
gives the same sizes and the same number of sequencing errors: only the
bases and the read positions differ.  A record stream is a pair (codes,
offsets): uint8 2-bit base codes and int64 record bounds.

- The genome: `config["genome_bases"]` i.i.d. uniform bases, one record
  (a complete bacterial chromosome).
- Each entry of the mix's `"reads"` (name -> parameters) is `count`
  batches of `reads` reads of `read_bases` bases, one record a read.  The
  first round(`from_genome` x `reads`) reads of a batch are copied from
  the genome at uniform positions, forward strand; the rest are uniform
  random bases (reads of another organism: next to none of their k-mers is
  in the genome).  Then round(`errors` x bases) substitutions are placed
  at uniform positions of the batch.

The result is {"genome": stream, <read set name>: [stream, ...], ...}.
"""

from __future__ import annotations

import numpy as np


def rng_of(seed: int) -> np.random.Generator:
    if seed < 0:
        raise ValueError(f"--seed must be a whole number >= 0, not {seed}")
    return np.random.default_rng(seed)


def records(codes: np.ndarray, length: int):
    """Codes cut into records of `length` bases -> a record stream."""
    return codes, np.arange(0, len(codes) + 1, length, dtype=np.int64)


def concat(streams: list):
    """Record streams -> one stream with every record kept apart."""
    codes = np.concatenate([c for c, _ in streams])
    lens = np.concatenate([np.diff(o) for _, o in streams])
    return codes, np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


def read_batch(rng, genome: np.ndarray, reads: int, read_bases: int,
               from_genome: float, errors: float):
    """One batch of reads (see the module docstring) -> a record stream."""
    own = int(round(reads * from_genome))
    starts = rng.integers(0, len(genome) - read_bases + 1, size=own)
    codes = np.empty((reads, read_bases), dtype=np.uint8)
    codes[:own] = genome[starts[:, None] + np.arange(read_bases)]
    codes[own:] = rng.integers(0, 4, size=(reads - own, read_bases),
                               dtype=np.uint8)
    codes = codes.reshape(-1)
    n_err = int(round(errors * len(codes)))
    at = rng.integers(0, len(codes), size=n_err)
    codes[at] = (codes[at] + rng.integers(1, 4, size=n_err,
                                          dtype=np.uint8)) % 4
    return records(codes, read_bases)


def make_traffic(mix: dict, config: dict, seed: int) -> dict:
    """The cell's host arrays for `seed` (see the module docstring)."""
    rng = rng_of(seed)
    bases = config["genome_bases"]
    genome = rng.integers(0, 4, size=bases, dtype=np.uint8)
    out = {"genome": records(genome, bases)}
    for name, p in mix["reads"].items():
        out[name] = [read_batch(rng, genome, p["reads"], p["read_bases"],
                                p["from_genome"], p["errors"])
                     for _ in range(p["count"])]
    return out
