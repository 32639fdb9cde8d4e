"""The reference's `.cbl` index files (bincode varint format).

Counterpart of `cbl_tpu/interop.py`; every byte written equals
`cbl_tpu`'s.  The reference serialises a `CBL` as a bool `canonical`
followed by its word set as a map `prefix: u32 -> TrieVec` in ascending
prefix order.  A bucket is either a Vec of little-endian SlicedInt byte
strings (one length byte, then the suffix bytes) or a serialized 256-ary
trie over the big-endian suffix bytes (a node is its set byte values,
then its children).  The format has **no K/PREFIX_BITS header**: the
caller supplies the constants the file was built with (the reader checks
the suffix width where it can).

- `load_reference(path, k, prefix_bits, device)` reads a file into a CBL
  on `device` (default: the card): the words go to the pending log as
  int64 keys (two columns at K >= 29) and are folded (the build sort).
- `save_reference(cbl, path)` writes buckets of <= 1024 suffixes in Vec
  form and larger ones in Trie form, the container the reference itself
  holds at that size (THRESHOLD = 1024).

bincode varint scheme (unsigned): < 251 one byte; 0xFB + u16 LE;
0xFC + u32 LE; 0xFD + u64 LE.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from .config import get_config
from .limbs import from_limbs, key_cols


# --- varint primitives ---


def _write_varint(buf: io.BytesIO, v: int) -> None:
    if v < 251:
        buf.write(bytes([v]))
    elif v <= 0xFFFF:
        buf.write(b"\xfb" + v.to_bytes(2, "little"))
    elif v <= 0xFFFFFFFF:
        buf.write(b"\xfc" + v.to_bytes(4, "little"))
    else:
        buf.write(b"\xfd" + v.to_bytes(8, "little"))


def _varint_bytes_u16(vals: np.ndarray) -> bytes:
    """Batch varint encoding for values < 2^16 (covers trie byte indices
    and suffix-length prefixes): one byte below 251, else 0xFB + u16 LE.
    Same bytes as `_write_varint`, vectorized."""
    vals = np.asarray(vals, dtype=np.uint32)
    small = vals < 251
    lens = np.where(small, 1, 3)
    off = np.concatenate([[0], np.cumsum(lens)])
    out = np.zeros(int(off[-1]), dtype=np.uint8)
    out[off[:-1][small]] = vals[small]
    big_off = off[:-1][~small]
    big_vals = vals[~small]
    out[big_off] = 0xFB
    out[big_off + 1] = big_vals & 0xFF
    out[big_off + 2] = big_vals >> 8
    return out.tobytes()


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("truncated reference index file")
        self.pos += n
        return b

    def varint(self) -> int:
        tag = self.take(1)[0]
        if tag < 251:
            return tag
        size = {0xFB: 2, 0xFC: 4, 0xFD: 8, 0xFE: 16}[tag]
        return int.from_bytes(self.take(size), "little")

    def eof(self) -> bool:
        return self.pos == len(self.data)


# --- vectorized word <-> (prefix, suffix-bytes) converters ---


def _split_prefix_suffix(rows: np.ndarray, cfg) -> tuple:
    """[n, L] big-endian uint32 limb rows -> ([n] uint32 prefixes,
    [n, nbytes] BIG-endian suffix byte rows), in vectorized numpy."""
    n, L = rows.shape
    s = cfg.suffix_bits
    nbytes = (s + 7) // 8
    # prefix = word >> suffix_bits (< 2^32 by config invariant)
    j, r = divmod(s, 32)
    lo = rows[:, L - 1 - j]
    if r:
        lo = lo >> np.uint32(r)
        if L - 2 - j >= 0:
            lo = lo | (rows[:, L - 2 - j] << np.uint32(32 - r))
    prefix = lo.astype(np.uint32)
    # suffix = low suffix_bits as big-endian bytes: the tail of the full
    # 4L-byte big-endian word, top byte masked where prefix bits share it
    full = np.ascontiguousarray(rows.astype(">u4")).view(np.uint8).reshape(
        n, 4 * L
    )
    sufb = full[:, 4 * L - nbytes :].copy()
    top_bits = s - 8 * (nbytes - 1)
    if top_bits < 8:
        sufb[:, 0] &= np.uint8((1 << top_bits) - 1)
    return prefix, sufb


def _assemble_words(prefix: np.ndarray, sufb: np.ndarray, cfg) -> np.ndarray:
    """Inverse of `_split_prefix_suffix`: ([n] prefixes, [n, nbytes]
    big-endian suffix bytes) -> [n, L] big-endian uint32 limb rows."""
    n, nbytes = sufb.shape
    L = cfg.word_limbs
    s = cfg.suffix_bits
    full = np.zeros((n, 4 * L), dtype=np.uint8)
    full[:, 4 * L - nbytes :] = sufb
    limbs_ = full.view(">u4").astype(np.uint32).reshape(n, L)
    j, r = divmod(s, 32)
    p64 = prefix.astype(np.uint64) << np.uint64(r)
    limbs_[:, L - 1 - j] |= (p64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if L - 2 - j >= 0:
        limbs_[:, L - 2 - j] |= (p64 >> np.uint64(32)).astype(np.uint32)
    return limbs_


# --- trie bucket decode (variant 1) ---


def _read_trie_node(r: _Reader, depth: int, nbytes: int, prefix_bytes: tuple,
                    out: list) -> None:
    """TrieNode { bv: TinyBitvector (seq of set indices), children: Vec<Trie> }
    (`src/trie.rs:53-57`); big-endian byte path = sorted order."""
    count = r.varint()
    indices = [r.varint() for _ in range(count)]
    n_children = r.varint()
    if depth == nbytes - 1:
        if n_children:
            raise ValueError("reference trie: leaf with children")
        for idx in indices:
            out.append(prefix_bytes + (idx,))
        return
    if n_children != len(indices):
        raise ValueError("reference trie: children/bitvector mismatch")
    for idx in indices:
        _read_trie_node(r, depth + 1, nbytes, prefix_bytes + (idx,), out)


# --- public API ---


def load_reference(path, k: int, prefix_bits: int = 24, device=None):
    """Read a reference-binary index file into a CBL on `device` (default:
    the card); k / prefix_bits must be the constants the file was built
    with."""
    from .cbl import CBL

    cfg = get_config(k=k, prefix_bits=prefix_bits)
    nbytes = (cfg.suffix_bits + 7) // 8
    with open(path, "rb") as f:
        r = _Reader(f.read())

    canonical = bool(r.take(1)[0])
    n_buckets = r.varint()
    buf = np.frombuffer(r.data, dtype=np.uint8)
    # Vec buckets accumulate as (prefix, count, block byte offset) ints —
    # the suffix bytes of ALL such buckets are gathered in ONE vectorized
    # pass at the end (per-bucket numpy allocations dominated load time
    # at 10^6 buckets)
    vec_prefix: list[int] = []
    vec_n: list[int] = []
    vec_start: list[int] = []
    pref_parts: list[np.ndarray] = []
    sufb_parts: list[np.ndarray] = []
    last_prefix = -1
    rec = 1 + nbytes  # per-suffix record: 1-byte length varint + LE bytes
    for _ in range(n_buckets):
        prefix = r.varint()
        if prefix <= last_prefix:
            raise ValueError("reference index: prefixes not ascending")
        last_prefix = prefix
        variant = r.varint()
        if variant == 0:  # Vec(Vec<SlicedInt>)
            n = r.varint()
            vec_prefix.append(prefix)
            vec_n.append(n)
            vec_start.append(r.pos)
            r.take(n * rec)  # bounds-checked skip
        elif variant == 1:  # Trie(Trie, usize)
            paths: list[tuple] = []
            _read_trie_node(r, 0, nbytes, (), paths)
            stored = r.varint()  # element count (`src/trievec/mod.rs:8-12`)
            if stored != len(paths):
                raise ValueError(
                    f"reference trie bucket {prefix}: stored element count "
                    f"{stored} != {len(paths)} decoded leaves — corrupted "
                    "or truncated index file"
                )
            pref_parts.append(np.full(len(paths), prefix, dtype=np.uint32))
            sufb_parts.append(np.array(paths, dtype=np.uint8).reshape(
                len(paths), nbytes
            ))
        else:
            raise ValueError(f"reference index: unknown bucket variant {variant}")
    if not r.eof():
        raise ValueError("reference index: trailing bytes")

    if vec_n:
        n_arr = np.asarray(vec_n, dtype=np.int64)
        s_arr = np.asarray(vec_start, dtype=np.int64)
        total = int(n_arr.sum())
        if total:
            # segmented arange: suffix j of bucket i starts at
            # s_i + j*rec; one fancy gather decodes every Vec bucket
            seg = np.arange(total, dtype=np.int64) - np.repeat(
                np.concatenate([[0], np.cumsum(n_arr)[:-1]]), n_arr
            )
            starts = np.repeat(s_arr, n_arr) + seg * rec
            block = buf[starts[:, None] + np.arange(rec, dtype=np.int64)]
            if not np.all(block[:, 0] == nbytes):
                blen = int(block[block[:, 0] != nbytes][0, 0])
                raise ValueError(
                    f"suffix width {blen}B != expected {nbytes}B — "
                    f"wrong K/PREFIX_BITS for this file?"
                )
            pref_parts.append(np.repeat(
                np.asarray(vec_prefix, dtype=np.uint32), n_arr
            ))
            sufb_parts.append(block[:, 1:][:, ::-1])  # LE -> BE rows

    kw = {} if device is None else {"device": device}
    cbl = CBL(k=k, prefix_bits=prefix_bits, canonical=canonical, **kw)
    if pref_parts:
        rows = _assemble_words(
            np.concatenate(pref_parts), np.concatenate(sufb_parts), cfg
        )
        if rows.shape[0]:
            keys = torch.from_numpy(from_limbs(rows, key_cols(cfg)))
            cbl.wordset.insert_words(keys.to(cbl.device))
            cbl.wordset.flush()
    return cbl


TRIE_THRESHOLD = 1024  # the reference's vec -> trie threshold


def _write_trie_node(buf, rows: np.ndarray, depth: int,
                     nbytes: int) -> None:
    """Serialize one TrieNode { bv: TinyBitvector (seq of set byte values),
    children: Vec<Trie> } (`reference/src/trie.rs:53-57`,
    `src/bitvector/tiny/mod.rs:97-110`).  `rows` are the big-endian suffix
    byte rows of this subtree, sorted, sharing bytes [0, depth)."""
    vals, starts = np.unique(rows[:, depth], return_index=True)
    _write_varint(buf, len(vals))
    buf.write(_varint_bytes_u16(vals))
    if depth == nbytes - 1:
        _write_varint(buf, 0)  # leaves hold the last byte; no children
        return
    _write_varint(buf, len(vals))
    bounds = list(starts) + [rows.shape[0]]
    for i in range(len(vals)):
        _write_trie_node(buf, rows[bounds[i] : bounds[i + 1]], depth + 1,
                         nbytes)


def _varint_sizes_u32(vals: np.ndarray) -> np.ndarray:
    """Encoded byte length of varint(v) for v < 2^32."""
    return np.where(vals < 251, 1, np.where(vals <= 0xFFFF, 3, 5))


def _scatter_varints(out: np.ndarray, off: np.ndarray,
                     vals: np.ndarray) -> None:
    """Write varint(vals[i]) into out starting at off[i] (vals < 2^32);
    byte-identical to `_write_varint`."""
    vals = vals.astype(np.int64)
    small = vals < 251
    mid = ~small & (vals <= 0xFFFF)
    big = vals > 0xFFFF
    out[off[small]] = vals[small]
    mo, mv = off[mid], vals[mid]
    out[mo] = 0xFB
    out[mo + 1] = mv & 0xFF
    out[mo + 2] = (mv >> 8) & 0xFF
    bo, bv = off[big], vals[big]
    out[bo] = 0xFC
    for j in range(4):
        out[bo + 1 + j] = (bv >> (8 * j)) & 0xFF


def _encode_vec_run(prefixes: np.ndarray, counts: np.ndarray,
                    sufb: np.ndarray, nbytes: int) -> np.ndarray:
    """Encode a run of consecutive Vec buckets in one vectorized pass:
    per bucket [varint prefix][variant 0][varint count][count fixed-size
    suffix records].  `sufb` = the runs' concatenated big-endian suffix
    byte rows."""
    rec = 1 + nbytes
    counts = counts.astype(np.int64)
    hp = _varint_sizes_u32(prefixes).astype(np.int64)
    hn = _varint_sizes_u32(counts)
    sizes = hp + 1 + hn + counts * rec
    off = np.concatenate([[0], np.cumsum(sizes)])
    out = np.zeros(int(off[-1]), dtype=np.uint8)
    o = off[:-1]
    _scatter_varints(out, o, prefixes)
    # the variant byte at o + hp stays 0 (Vec)
    _scatter_varints(out, o + hp + 1, counts)
    total = int(counts.sum())
    if total:
        seg = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
        )
        sstart = np.repeat(o + hp + 1 + hn, counts) + seg * rec
        out[sstart] = nbytes
        out[sstart[:, None] + 1 + np.arange(nbytes, dtype=np.int64)] = (
            sufb[:, ::-1]  # BE rows -> LE bytes
        )
    return out


def _encode_trie_bucket(buf, prefix: int, sufb: np.ndarray,
                        nbytes: int) -> None:
    """One `prefix -> TrieOrVec` map entry in Trie form (a bucket of more
    than TRIE_THRESHOLD suffixes).  `sufb` = the bucket's sorted
    [m, nbytes] big-endian suffix byte rows."""
    _write_varint(buf, prefix)
    _write_varint(buf, 1)  # Trie(Trie, usize) variant
    # suffixes ascend within a bucket, so big-endian byte rows are
    # already in trie (DFS) order
    _write_trie_node(buf, sufb, 0, nbytes)
    _write_varint(buf, sufb.shape[0])


def _write_buckets(f, prefixes: np.ndarray, bounds: np.ndarray,
                   sufb: np.ndarray, nbytes: int) -> None:
    """Write the map entries of the ascending `prefixes`; bucket i's
    sorted big-endian suffix byte rows are sufb[bounds[i]:bounds[i+1]].
    Each Trie bucket ends the maximal run of Vec buckets before it, which
    is encoded in one vectorized pass."""
    sizes = np.diff(bounds)
    n = len(prefixes)
    i = 0
    for t in [*np.flatnonzero(sizes > TRIE_THRESHOLD).tolist(), n]:
        if i < t:
            f.write(_encode_vec_run(
                prefixes[i:t].astype(np.int64), sizes[i:t],
                sufb[bounds[i] : bounds[t]], nbytes,
            ).tobytes())
        if t < n:
            buf = io.BytesIO()
            _encode_trie_bucket(buf, int(prefixes[t]),
                                sufb[bounds[t] : bounds[t + 1]], nbytes)
            f.write(buf.getvalue())
        i = t + 1


def save_reference(cbl, path, chunk_rows: int = 1 << 22) -> None:
    """Write an index file loadable by the reference binary compiled with
    the same K/PREFIX_BITS.  Ascending prefix order; buckets above the
    reference's vec->trie threshold are written in Trie form (variant 1),
    the rest in Vec form (variant 0) — mirroring `TrieOrVec` serde
    (`reference/src/trievec/mod.rs:8-12`).

    Streams the index in `chunk_rows` device->host chunks (prefix groups
    straddling a chunk boundary are carried into the next chunk), so peak
    host memory is bounded by the chunk, not the index; runs of Vec
    buckets are encoded by vectorized numpy passes."""
    cfg = cbl.cfg
    nbytes = (cfg.suffix_bits + 7) // 8
    with open(path, "wb") as f:
        f.write(bytes([1 if cbl.canonical else 0]))
        # bucket count — distinct prefixes (cheap first pass: device-side
        # prefixes export is [n] u32)
        prefixes_sorted = cbl.wordset.prefixes()
        n_buckets = (
            int(np.sum(prefixes_sorted[1:] != prefixes_sorted[:-1])) + 1
            if prefixes_sorted.shape[0] else 0
        )
        buf = io.BytesIO()
        _write_varint(buf, n_buckets)
        f.write(buf.getvalue())
        carry_p, carry_b = None, None
        for words in cbl.wordset.iter_words_chunks(chunk_rows):
            pref, sufb = _split_prefix_suffix(words, cfg)
            if carry_p is not None:
                pref = np.concatenate([carry_p, pref])
                sufb = np.concatenate([carry_b, sufb])
            # hold back the last group — it may continue in the next chunk
            vals, starts = np.unique(pref, return_index=True)
            bounds = np.concatenate([starts, [pref.shape[0]]]).astype(
                np.int64
            )
            emit = len(vals) - 1
            _write_buckets(f, vals[:emit], bounds[: emit + 1], sufb, nbytes)
            carry_p = pref[bounds[emit] :]
            carry_b = sufb[bounds[emit] :]
        if carry_p is not None and carry_p.shape[0]:
            _write_buckets(f, carry_p[:1],
                           np.array([0, carry_p.shape[0]], dtype=np.int64),
                           carry_b, nbytes)
