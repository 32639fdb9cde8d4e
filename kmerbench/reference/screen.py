"""The plain reference of a screen against a genome whose k-mers do not
fit the device at once (`loops/screen.py`): the answers of
`loops/query.py`'s reference, one `Universe` over the genome and the
batches, worked in blocks.

- The genome's k-mers (`kmers.kmer_cols`) are made a block of `BLOCK`
  k-mer starts at a time, with the K - 1 bases after the block.
- The k-mers are split by value into `PARTS` ranges of their top bits
  (`part_of`); `GROUPS` passes over the genome each keep the ranges of
  one group, and each range's distinct k-mers are worked out alone
  (`kmers.unique_inverse`): a range holds a 1 / PARTS share of the index.
- A batch's k-mers are split the same way and looked up in their range's
  distinct k-mers: a hit when the range holds the k-mer.
- The program's export, split the same way (`split`), is compared range
  by range (`export_wrong`): 0 iff it holds exactly the distinct k-mers.

Plain PyTorch, independent of the program, as `kmers` is.
"""

from __future__ import annotations

import numpy as np
import torch

from .kmers import cat_cols, kmer_cols, n_cols, rows_differ, unique_inverse

PARTS = 32
GROUPS = 2
BLOCK = 1 << 26


def top_bits(k: int) -> int:
    """Bits of column 0 of a k-mer (`kmers.kmer_cols`)."""
    return 2 * k if n_cols(k) == 1 else 2 * (k - 31)


def part_of(cols: tuple, k: int, parts: int = PARTS) -> torch.Tensor:
    """The value range of each k-mer: the top log2(parts) bits of column
    0 (all of them where column 0 is narrower)."""
    shift = max(top_bits(k) - (parts.bit_length() - 1), 0)
    return (cols[0] >> shift).clamp(max=parts - 1)


def split(cols: tuple, k: int, parts: int = PARTS,
          keep=range(PARTS)) -> dict:
    """{range: the k-mers of `cols` in it} for the ranges in `keep`."""
    pid = part_of(cols, k, parts)
    out = {}
    for p in keep:
        sel = pid == p
        out[p] = tuple(c[sel] for c in cols)
    return out


def stream_blocks(stream, k: int, block: int = BLOCK):
    """Each block of `block` k-mer starts of a record stream as a record
    stream of its own: its codes with the K - 1 bases after the block,
    its record bounds clipped to them."""
    codes, offsets = stream
    offsets = np.asarray(offsets, dtype=np.int64)
    n_pos = max(len(codes) - k + 1, 0)
    for s in range(0, n_pos, block):
        e = min(s + block, n_pos) + k - 1
        yield codes[s:e], np.unique(np.clip(offsets, s, e)) - s


def _empty(k: int, device) -> tuple:
    return tuple(torch.zeros(0, dtype=torch.int64, device=device)
                 for _ in range(n_cols(k)))


def distinct_parts(genome, k: int, canonical: bool, device,
                   parts: int = PARTS, groups: int = GROUPS,
                   block: int = BLOCK) -> list:
    """The genome's distinct k-mers, sorted, one cols tuple a value
    range."""
    out = [None] * parts
    per = -(-parts // groups)
    for g in range(groups):
        mine = range(g * per, min((g + 1) * per, parts))
        raw = {p: [] for p in mine}
        for piece in stream_blocks(genome, k, block):
            cols = kmer_cols(*piece, k, canonical, device)
            for p, c in split(cols, k, parts, mine).items():
                raw[p].append(c)
            del cols
        for p in mine:
            rows = cat_cols(raw.pop(p)) if raw[p] else _empty(k, device)
            out[p] = unique_inverse(rows)[0]
            del rows
    return out


def _hits(keys: tuple, q: tuple) -> int:
    """Rows of q that the sorted distinct rows `keys` hold."""
    if q[0].numel() == 0 or keys[0].numel() == 0:
        return 0
    if len(keys) == 1:
        i = torch.searchsorted(keys[0], q[0]).clamp(max=keys[0].numel() - 1)
        return int((keys[0][i] == q[0]).sum())
    from .kmers import Universe

    u = Universe([keys, q])
    present = u.empty_set()
    present[u.ids(0)] = True
    return int(present[u.ids(1)].sum())


def batch_answers(keys: list, batches: list, k: int, canonical: bool,
                  device, parts: int = PARTS) -> list:
    """(k-mers, hits) of each batch against the ranges' distinct k-mers."""
    answers = []
    for b in batches:
        cols = kmer_cols(*b, k, canonical, device)
        hits = sum(_hits(keys[p], q)
                   for p, q in split(cols, k, parts, range(parts)).items())
        answers.append((cols[0].shape[0], hits))
    return answers


def screen_reference(genome, batches: list, k: int, canonical: bool,
                     device, parts: int = PARTS, groups: int = GROUPS,
                     block: int = BLOCK) -> dict:
    """`loops/query.py`'s reference in blocks: {"answers", "distinct",
    "kmer_parts"} (the distinct k-mers, a cols tuple a range)."""
    keys = distinct_parts(genome, k, canonical, device, parts, groups, block)
    return {"answers": batch_answers(keys, batches, k, canonical, device,
                                     parts),
            "distinct": sum(c[0].shape[0] for c in keys),
            "kmer_parts": keys}


def export_wrong(got: list, want: list, k: int) -> int:
    """`kmers.rows_differ` range by range: `got` holds each range's
    exported k-mers as a list of cols tuples, `want` its distinct
    k-mers."""
    total = 0
    for pieces, keys in zip(got, want, strict=True):
        rows = cat_cols(pieces) if pieces else _empty(k, keys[0].device)
        if len(rows) != len(keys):  # another layout: no row matches
            total += rows[0].shape[0] + keys[0].shape[0]
            continue
        if len(rows) == 1 and rows[0].shape == keys[0].shape and \
                torch.equal(torch.sort(rows[0]).values, keys[0]):
            continue  # the same rows: `keys` is sorted and distinct
        total += rows_differ(rows, keys)
    return total


def limbs_to_cols(limbs: torch.Tensor, k: int) -> tuple:
    """`kmers.limbs_to_cols` for [N, L] int32 limbs on the device (uint32
    bits, big-endian limbs of 2K-bit k-mers)."""
    a = limbs.to(torch.int64) & 0xFFFFFFFF
    L = a.shape[1]
    if a.shape[0] == 0:
        return _empty(k, limbs.device)
    if k <= 16:
        return (a[:, L - 1],)
    if n_cols(k) == 1:
        return ((a[:, L - 2] << 32) | a[:, L - 1],)
    l3, l2, l1 = a[:, L - 1], a[:, L - 2], a[:, L - 3]
    l0 = a[:, 0] if L == 4 else torch.zeros_like(l3)
    lo = ((l2 & 0x3FFFFFFF) << 32) | l3
    hi = (l0 << 34) | (l1 << 2) | (l2 >> 30)
    return hi, lo
