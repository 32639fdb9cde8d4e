"""Packed words as int64 keys: one column, or two at wide K.

`cbl_tpu` holds a packed word as L big-endian uint32 limbs (limb 0 most
significant) because the TPU has no 64-bit integers.  PyTorch on the CPU
has no `<`, shifts, `cummax` or `searchsorted` for unsigned types, so
this port holds words as non-negative int64 columns instead:

- n_bits <= 60 (odd K <= 27): ONE int64 key,
  key = sum(limb_l << 32 * (L - 1 - l)), a [N] tensor;
- n_bits > 60 (odd K from 29 to 59): TWO int64 columns, column 0 major:
  column 1 holds the low 63 bits, column 0 the rest (at most 62 bits, at
  K=59 with its 125-bit words), a [2, N] tensor.

Column c of a [2, N] tensor is its row c, contiguous; the word set hands
the sort and merge kernels a tuple of those rows (`ops.sort`) and gets
its [2, N] tensor back from `stack`.  Row slices `keys[..., a:b]`,
`torch.where(mask, keys, SENTINEL)`, `torch.cat(parts, -1)` and
`keys.shape[-1]` read alike for both shapes, so each word-set function
keeps one body.  The helpers below (`cols`, `stack`, `is_valid`,
`first_of_run`, `rows_eq`, `rows_lt`, `searchsorted`) take either shape.

A SENTINEL row (an empty slot, `cbl_tpu`'s all-ones row) is `INT64_MAX`
in every column, so it sorts after every valid word.  Column 0 of a valid
word is below 2^62 (or, with one column, below 2^60), so the sentinel
test reads column 0 alone.  (Column 1 is 63 bits wide, not 62, for that
reason: at K=59 a 62-bit column 1 would leave 63 bits to column 0, and
the poly-T k-mer's all-ones necklace would fill them: a valid word read
as a sentinel.)

A k-mer of W = 2K bits is one int64 for W <= 62 (K <= 31) and two
columns of the same layout above (K >= 33, W up to 118).

int64 `>>` is arithmetic; every value here stays non-negative, so it acts
as a logical shift.  `<<` wraps past bit 63 as on unsigned integers.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CBLConfig

SENTINEL = (1 << 63) - 1
MAX_KEY_BITS = 60  # n_bits of K=27: the widest one-column word
MAX_KMER_BITS = 62  # 2K of K=31: the widest one-column k-mer
LOW_BITS = 63  # bits of column 1 in the two-column layout
_LOW = (1 << LOW_BITS) - 1
_M32 = 0xFFFFFFFF


def check_config(cfg: CBLConfig) -> None:
    """Refuse a configuration whose words do not fit two int64 columns
    (none does: a valid `CBLConfig` has n_bits <= 125)."""
    if cfg.n_bits > LOW_BITS + 62:
        raise NotImplementedError(
            f"K={cfg.k} packs {cfg.n_bits}-bit words; cbl_tpu_torch holds "
            f"at most {LOW_BITS + 62} bits in two int64 columns"
        )


def key_cols(cfg: CBLConfig) -> int:
    """int64 columns of a packed word: 1 for n_bits <= 60, else 2."""
    return 1 if cfg.n_bits <= MAX_KEY_BITS else 2


def kmer_cols(cfg: CBLConfig) -> int:
    """int64 columns of a k-mer: 1 for 2K <= 62, else 2."""
    return 1 if cfg.kmer_bits <= MAX_KMER_BITS else 2


def low_mask(bits: int) -> int:
    """Python int with the low `bits` bits set."""
    return (1 << bits) - 1


# --- rows of one or more columns ---------------------------------------------


def cols(keys: torch.Tensor) -> tuple:
    """The columns of keys: an [N] tensor is one, a [C, N] tensor C (its
    rows, as the sort and merge kernels take them, `ops.sort`)."""
    return (keys,) if keys.dim() == 1 else tuple(keys.unbind(0))


def stack(columns) -> torch.Tensor:
    """Columns -> an [N] tensor for one, a [C, N] tensor for more.  Columns
    that are rows of one tensor at one stride, as the sort and merge
    kernels return them (`ops.merge`), give a view of it, not a copy."""
    columns = tuple(columns)
    if len(columns) == 1:
        return columns[0]
    c0, n, size = columns[0], columns[0].shape[0], columns[0].element_size()
    step = (columns[1].data_ptr() - c0.data_ptr()) // size
    storage = c0.untyped_storage().data_ptr()
    if step >= n and all(
            c.untyped_storage().data_ptr() == storage and c.stride() == (1,)
            and c.data_ptr() == c0.data_ptr() + i * step * size
            for i, c in enumerate(columns)):
        return c0.as_strided((len(columns), n), (step, 1))
    return torch.stack(columns)


def major(keys: torch.Tensor) -> torch.Tensor:
    """Column 0 of [N] or [C, N] keys."""
    return keys if keys.dim() == 1 else keys[0]


def is_valid(keys) -> torch.Tensor:
    """True for non-sentinel rows (column 0 alone decides)."""
    return major(keys) != SENTINEL


def rows_eq(a, b) -> torch.Tensor:
    """a == b row by row, every column."""
    out = None
    for x, y in zip(cols(a), cols(b), strict=True):
        e = x == y
        out = e if out is None else out & e
    return out


def rows_lt(a, b) -> torch.Tensor:
    """a < b row by row, lexicographic, column 0 major."""
    ca, cb = cols(a), cols(b)
    lt = ca[-1] < cb[-1]
    for x, y in zip(reversed(ca[:-1]), reversed(cb[:-1])):
        lt = (x < y) | ((x == y) & lt)
    return lt


def first_of_run(keys) -> torch.Tensor:
    """True where a row differs from the one before it (and at row 0);
    `keys` a tensor or a tuple of columns."""
    cs = cols(keys) if isinstance(keys, torch.Tensor) else tuple(keys)
    first = torch.ones(cs[0].shape[0], dtype=torch.bool, device=cs[0].device)
    if cs[0].shape[0] > 1:
        ne = cs[0][1:] != cs[0][:-1]
        for c in cs[1:]:
            ne |= c[1:] != c[:-1]
        first[1:] = ne
    return first


def sentinel_rows(n: int, n_cols: int, device) -> torch.Tensor:
    """n SENTINEL rows of n_cols columns."""
    shape = (n,) if n_cols == 1 else (n_cols, n)
    return torch.full(shape, SENTINEL, dtype=torch.int64, device=device)


def searchsorted(data: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Lower-bound index of each query row in the sorted rows `data`
    (`torch.searchsorted` for one column).  Two columns: a lexicographic
    binary search, every query's search a step at a time together
    (`cbl_tpu.wordset._searchsorted_kernel`)."""
    if data.dim() == 1:
        return torch.searchsorted(data, queries)
    n = data.shape[-1]
    lo = torch.zeros(queries.shape[-1], dtype=torch.int64,
                     device=queries.device)
    if n == 0:
        return lo
    hi = torch.full_like(lo, n)
    for _ in range(n.bit_length()):
        active = lo < hi
        mid = (lo + hi) >> 1
        less = rows_lt(data[:, mid.clamp(max=n - 1)], queries)
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


# --- two-column arithmetic (values of up to 125 bits) ------------------------


def _hi_lo(x: torch.Tensor):
    """(column 0 or None, column 1) of a one- or two-column value."""
    return (None, x) if x.dim() == 1 else (x[0], x[1])


def shift_left(x: torch.Tensor, s: int, n_cols: int) -> torch.Tensor:
    """x << s (0 < s < 63) as an n_cols-column value; the caller knows it
    fits."""
    hi, lo = _hi_lo(x)
    new_lo = (lo & low_mask(LOW_BITS - s)) << s
    if n_cols == 1:
        return new_lo
    up = lo >> (LOW_BITS - s)
    return torch.stack([up if hi is None else (hi << s) | up, new_lo])


def shift_right(x: torch.Tensor, s: int, n_cols: int) -> torch.Tensor:
    """x >> s (s >= 0) as an n_cols-column value."""
    hi, lo = _hi_lo(x)
    if hi is None:
        new_lo, new_hi = lo >> s, None
    elif s >= LOW_BITS:
        new_lo, new_hi = hi >> (s - LOW_BITS), None
    else:
        new_lo = (lo >> s) | ((hi & low_mask(s)) << (LOW_BITS - s))
        new_hi = hi >> s
    if n_cols == 1:
        return new_lo
    if new_hi is None:
        new_hi = torch.zeros_like(new_lo)
    return torch.stack([new_hi, new_lo])


def rotate_right_var(x: torch.Tensor, s: torch.Tensor, W: int):
    """Rotate the W-bit two-column values x (63 < W <= 126) right by
    per-row amounts s in [0, W): (x >> s) | (x << (W - s)) masked."""
    hi, lo = x[0], x[1]
    hmask = low_mask(W - LOW_BITS)

    def shr(s):  # s in [0, W]
        big = s >= LOW_BITS
        a = torch.clamp(s, max=LOW_BITS - 1)
        b = torch.clamp(s - LOW_BITS, min=0)
        below = torch.bitwise_left_shift(torch.ones_like(a), a) - 1
        lo_small = (lo >> a) | ((hi & below) << (LOW_BITS - a))
        return (torch.where(big, 0, hi >> a),
                torch.where(big, hi >> b, lo_small))

    def shl(s):  # s in [0, W], masked to W bits
        big = s >= LOW_BITS
        a = torch.clamp(s, max=LOW_BITS - 1)
        b = torch.clamp(s - LOW_BITS, min=0)
        hi_small = ((hi << a) | (lo >> (LOW_BITS - a))) & hmask
        return (torch.where(big, (lo << b) & hmask, hi_small),
                torch.where(big, 0, (lo << a) & _LOW))

    rh, rl = shr(s)
    lh, ll = shl(W - s)
    return torch.stack([rh | lh, rl | ll])


def chunks32(x: torch.Tensor) -> list:
    """The four 32-bit pieces of a two-column value, least significant
    first (bits [0, 32), [32, 64), [64, 96), [96, 128))."""
    hi, lo = x[0], x[1]
    return [lo & _M32, ((lo >> 32) | ((hi & 1) << 31)) & _M32,
            (hi >> 1) & _M32, (hi >> 33) & _M32]


def place(w: torch.Tensor, a: int, lo: int, width: int):
    """The part of values w (below 2^32) whose bit 0 lands at bit `a` of a
    wider value, inside that value's column of bits [lo, lo + width):
    shifted into place, or None when no bit of w falls there.  The caller
    masks the column to its width."""
    rel = a - lo
    if rel >= width or rel <= -32:
        return None
    if rel >= 0:
        return (w & low_mask(width - rel)) << rel
    return w >> -rel


def column_ranges(bits: int) -> list:
    """(first bit, width) of each int64 column of a `bits`-bit value,
    column 0 first."""
    if bits <= MAX_KMER_BITS:
        return [(0, bits)]
    return [(LOW_BITS, bits - LOW_BITS), (0, LOW_BITS)]


def from_chunks(chunks: list, shr: int, bits: int) -> torch.Tensor:
    """(sum chunk_i << 32 i) >> shr, masked to `bits` bits, in the column
    layout of a `bits`-bit value (`column_ranges`)."""
    out = []
    for lo, width in column_ranges(bits):
        val = None
        for i, c in enumerate(chunks):
            part = place(c, 32 * i - shr, lo, width)
            if part is not None:
                val = part if val is None else val | part
        out.append(val & low_mask(width))
    return stack(out)


# --- uint32 limb rows (cbl_tpu's layout) -------------------------------------


def _check_limbs(L: int) -> None:
    if L not in (1, 2, 3, 4):
        raise ValueError(f"L must be 1 to 4, got {L}")


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 of the same bits."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def keys_to_limbs(keys: torch.Tensor, L: int) -> torch.Tensor:
    """[N] or [2, N] int64 keys -> [N, L] int32 big-endian limbs on the
    keys' device, to be read as uint32 (`.view(np.uint32)` on the host).
    One column and L <= 2: the halves of each little-endian int64, high
    half first for L = 2, the low half for L = 1 (one copy, no
    arithmetic); SENTINEL becomes (0x7FFFFFFF, 0xFFFFFFFF) there, and
    `to_limbs` makes it all ones.  Otherwise the value's 32-bit pieces
    (`chunks32`), which expects valid rows only."""
    _check_limbs(L)
    if keys.dim() == 1 and L <= 2:
        halves = keys.contiguous().view(torch.int32).view(-1, 2)
        return halves[:, :1].contiguous() if L == 1 else halves.flip(1)
    if keys.dim() == 1:
        keys = torch.stack([torch.zeros_like(keys), keys])
    pieces = chunks32(keys)[:L]
    return torch.stack([_wrap32(p) for p in reversed(pieces)], dim=1)


def from_limbs(rows: np.ndarray, n_cols: int | None = None) -> np.ndarray:
    """[N, L] uint32 big-endian limbs -> int64 keys of `n_cols` columns,
    [N] or [2, N] (all-ones rows -> SENTINEL); `n_cols` defaults to 1 for
    L <= 2, else 2 (`key_cols` of the config gives it).  One column: the
    rows' halves swapped (as `keys_to_limbs`, backwards) and read as
    int64 for L = 2, which requires L <= 2 and non-sentinel values below
    2^63 - 1.  Two columns: non-sentinel values below 2^125."""
    rows = np.require(rows, dtype=np.uint32, requirements=["C", "W"])
    if rows.ndim != 2:
        raise ValueError(f"expected [N, L] uint32 limbs, got {rows.shape}")
    L = rows.shape[1]
    _check_limbs(L)
    if n_cols is None:
        n_cols = 1 if L <= 2 else 2
    if n_cols == 2:
        return _from_limbs2(rows)
    if L > 2:
        raise ValueError(f"{L} limbs do not fit one int64 column")
    if L == 1:
        keys = rows[:, 0].astype(np.int64)
        all_ones = 0xFFFFFFFF
    else:
        halves = torch.from_numpy(rows.view(np.int32)).flip(1)
        keys = halves.numpy().view(np.int64).reshape(-1)
        all_ones = -1
        # every other row must read as a key in [0, INT64_MAX)
        if keys.shape[0] and (keys.min() < -1 or keys.max() == SENTINEL):
            raise ValueError("a non-sentinel row does not fit below "
                             "INT64_MAX")
    keys[keys == all_ones] = SENTINEL
    return keys


def _from_limbs2(rows: np.ndarray) -> np.ndarray:
    """`from_limbs` into two columns: [2, N] int64."""
    L = rows.shape[1]
    u = rows.astype(np.uint64)
    sent = np.all(rows == np.uint32(0xFFFFFFFF), axis=1)
    lo64 = u[:, L - 1]
    if L >= 2:
        lo64 = (u[:, L - 2] << np.uint64(32)) | lo64
    hi64 = np.zeros_like(lo64)
    if L >= 3:
        hi64 = u[:, L - 3]
    if L == 4:
        hi64 = (u[:, 0] << np.uint64(32)) | hi64
    if np.any((hi64[~sent] >> np.uint64(61)) != 0):
        raise ValueError("a non-sentinel row does not fit 125 bits")
    out = np.empty((2, rows.shape[0]), dtype=np.int64)
    out[1] = (lo64 & np.uint64(_LOW)).astype(np.int64)
    out[0] = ((lo64 >> np.uint64(63)) | (hi64 << np.uint64(1))).astype(
        np.int64)
    out[:, sent] = SENTINEL
    return out


def to_limbs(keys: np.ndarray, L: int) -> np.ndarray:
    """[N] or [2, N] int64 keys -> [N, L] uint32 big-endian limbs
    (SENTINEL -> all-ones rows, as `cbl_tpu` stores empty slots), by
    `keys_to_limbs` on the host."""
    keys = np.require(keys, dtype=np.int64, requirements=["C", "W"])
    out = keys_to_limbs(torch.from_numpy(keys), L).numpy().view(np.uint32)
    out[(keys if keys.ndim == 1 else keys[0]) == SENTINEL] = np.uint32(
        0xFFFFFFFF)
    return out


def ints_to_keys(values, n_cols: int) -> np.ndarray:
    """Python ints (below 2^125) -> int64 keys of n_cols columns, [N] or
    [2, N]."""
    v = [int(x) for x in values]
    if n_cols == 1:
        return np.asarray(v, dtype=np.int64).reshape(-1)
    return np.asarray([[x >> LOW_BITS for x in v], [x & _LOW for x in v]],
                      dtype=np.int64).reshape(2, -1)


def from_py_ints(values, limbs: int) -> np.ndarray:
    """[N] Python ints -> [N, L] uint32 big-endian limbs (L = 1 to 4)."""
    _check_limbs(limbs)
    if limbs <= 2:
        v = np.asarray([int(x) for x in values], dtype=np.uint64)
        out = np.empty((len(v), limbs), dtype=np.uint32)
        out[:, limbs - 1] = (v & 0xFFFFFFFF).astype(np.uint32)
        if limbs == 2:
            out[:, 0] = (v >> np.uint64(32)).astype(np.uint32)
        return out
    out = np.zeros((len(values), limbs), dtype=np.uint32)
    for i, v in enumerate(values):
        v = int(v)
        for l in range(limbs - 1, -1, -1):
            out[i, l] = v & 0xFFFFFFFF
            v >>= 32
    return out


def to_py_ints(arr: np.ndarray) -> list[int]:
    """[N, L] uint32 limbs (L = 1 to 4; one row may come as [L]) -> [N]
    Python ints."""
    arr = np.asarray(arr, dtype=np.uint32)
    if arr.ndim == 1:
        arr = arr[None, :]
    L = arr.shape[1]
    _check_limbs(L)
    if L == 1:
        return arr[:, 0].tolist()
    low = ((arr[:, L - 2].astype(np.uint64) << np.uint64(32))
           | arr[:, L - 1]).tolist()
    if L == 2:
        return low
    high = arr[:, 0].astype(np.uint64)
    if L == 4:
        high = (high << np.uint64(32)) | arr[:, 1]
    return [(h << 64) | x for h, x in zip(high.tolist(), low)]
