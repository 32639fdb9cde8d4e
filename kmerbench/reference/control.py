"""The control: the reference put in the program's place, with one
guarantee of the configuration broken.

Both configurations promise exact set semantics.  The control keeps each
k-mer as a `bits`-bit fingerprint (32 by default, half the width of a
K=25 k-mer), as an approximate k-mer set does to halve its memory: the
step that would tempt a change that trades exactness for space.
Fingerprints collide, so counts drift and the k-mers cannot be listed
back.  A run with the control in place has to come out not correct
(`kmerbench/tests/test_kmerbench_control.py`); otherwise the comparison
could not see such a change.
"""

from __future__ import annotations

import contextlib

import torch

from .kmers import kmer_cols


def fingerprint(cols: tuple, bits: int) -> torch.Tensor:
    """[N] int64 fingerprints below 2^bits: each column's bits folded by
    XOR into `bits`-bit pieces, the second column rotated first."""
    mask = (1 << bits) - 1
    out = None
    for i, c in enumerate(cols):
        f = torch.zeros_like(c)
        for s in range(0, 63, bits):
            f ^= (c >> s) & mask
        if i:
            f = ((f << 7) | (f >> (bits - 7))) & mask
        out = f if out is None else out ^ f
    return out


def _member(sorted_keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    if sorted_keys.numel() == 0:
        return torch.zeros_like(q, dtype=torch.bool)
    i = torch.searchsorted(sorted_keys, q).clamp(max=sorted_keys.numel() - 1)
    return sorted_keys[i] == q


class _FingerprintSet:
    """The methods of `cbl_tpu_torch.CBL` that the loops call, over a
    sorted set of fingerprints."""

    def __init__(self, device):
        self.device = device
        self.keys = torch.zeros(0, dtype=torch.int64, device=device)

    def insert_codes_stream(self, fp) -> None:
        self.keys = torch.unique(torch.cat([self.keys, fp]))

    def count_device(self):
        return torch.tensor(self.keys.numel(), device=self.device)

    def query_codes_stream(self, fp, lazy: bool = True):
        total = torch.tensor(fp.numel(), device=self.device)
        return total, _member(self.keys, fp).sum()

    def dynamic_round(self, ins, qry, rm, lazy: bool = True):
        self.insert_codes_stream(ins)
        out = self.query_codes_stream(qry)
        self.keys = self.keys[~_member(torch.unique(rm), self.keys)]
        return out


class ControlSystem:
    """`system.PortSystem`'s methods over sets of fingerprints."""

    def __init__(self, config: dict, device, bits: int = 32):
        self.k = config["k"]
        self.canonical = config["canonical"]
        self.device = device
        self.bits = bits

    def launches(self) -> dict:
        return {}

    def counters(self) -> dict:
        return {}

    def recording(self):
        """No program, so no span is recorded."""
        return contextlib.nullcontext([])

    def stage(self, stream):
        codes, offsets = stream
        cols = kmer_cols(codes, offsets, self.k, self.canonical, self.device)
        return fingerprint(cols, self.bits)

    def stream(self, fp):
        return fp

    def new_index(self):
        return _FingerprintSet(self.device)

    def export(self, index) -> tuple:
        return (index.keys,)  # fingerprints: the k-mers are lost
